"""sidedelta — the per-request sparse side delta of multi-tenant serving.

  delta[b, s, c] = sum_k x[b, s, rows[a, k]] * vals[a, k] * scale[a]
                   over adapter a = ids[b]'s entries in column c

(zeros when ids[b] < 0). Tables come in the column-sorted layout of
``ops.sidedelta_table``: rows/vals (A, K), colptr (A, m + 1) with
colptr[a, m] the valid count, scale (A,) for int8 values.

Port of ``repro/kernels/sidedelta.py:sidedelta_rows``. On CUDA tensors the
wrapper launches the hand-written kernel ``csrc/sidedelta.cu`` (its note
says what bounds it and how the design answers) by the rule of
``kernel_path``: decode (S == 1) and small calls (under 32 tokens of one
request, 64 of several) walk the table once per row, one warp a column;
larger calls (prefill, training, dx) group the requests by adapter (``group_by_adapter``), transpose x to
token-minor order (``token_minor``) and walk each adapter's table once per
tile of 128 of its tokens. On CPU tensors it computes
``sidedelta_plain``, the gather / multiply / index_add_ version of the
same function, which the tests and ``chip_smoke.py`` hold the kernel
against.

For multi-adapter training, ``sidedelta_train`` makes the delta
differentiable in x and in the table's f32 values (the reference
differentiates its XLA twin ``_sidedelta_xla`` instead):

  dx[b, s, r]  = the same kernel over the transposed (row-sorted) table,
                 with dy in place of x
  dvals[a, k]  = sum over requests b of adapter a, and rows s, of
                 x[b, s, rows[a, k]] * dy[b, s, col(k)]

``sidedelta_dvals`` launches ``csrc/sidedelta_grad.cu`` for the second on
CUDA tensors and computes ``sidedelta_dvals_plain`` on CPU tensors. Both
gradients read one grouping of the requests and one token-minor dy.

``sidedelta_cost`` and ``dvals_cost`` give the work each kernel does
(``kernels.counting``; the bounds of ``chip_smoke.py``). An autotuned plan
cache (``install_plan_cache``, filled by ``analysis/autotune.py`` from
measured times) maps a call's class (B, S, n, m, K, x itemsize) to the
path ``kernel_path`` returns before its static rule; nothing installs one
by default.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.counting import counted, uncounted

_X_DTYPES = (torch.float32, torch.bfloat16)
_ROW_DTYPES = (torch.int32, torch.int16)
_VAL_DTYPES = (torch.float32, torch.int8)


def sidedelta_plain(x: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
                    colptr: torch.Tensor, ids: torch.Tensor,
                    scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: per request, gather x at the adapter's valid rows,
    multiply by its dequantized values and index_add_ into the columns."""
    B, S, n = x.shape
    m = colptr.shape[-1] - 1
    out = torch.zeros((B, S, m), dtype=torch.float32, device=x.device)
    counts = torch.diff(colptr.long(), dim=-1)                 # (A, m)
    for b, a in enumerate(ids.tolist()):
        if a < 0:
            continue
        valid = int(colptr[a, m])
        col = torch.repeat_interleave(
            torch.arange(m, device=x.device), counts[a])        # (valid,)
        v = vals[a, :valid].float()
        if scale is not None:
            v = v * scale[a].float()
        xs = x[b].float()[:, rows[a, :valid].long()] * v        # (S, valid)
        out[b].index_add_(1, col, xs)
    return out


def _check(x, rows, vals, colptr, ids, scale) -> None:
    if x.ndim != 3:
        raise ValueError(f"x must be (B, S, n), got {tuple(x.shape)}")
    if rows.ndim != 2 or vals.shape != rows.shape:
        raise ValueError(f"rows/vals must be (A, K) alike, got "
                         f"{tuple(rows.shape)} / {tuple(vals.shape)}")
    A = rows.shape[0]
    if colptr.ndim != 2 or colptr.shape[0] != A or colptr.dtype != torch.int32:
        raise ValueError(f"colptr must be (A, m + 1) int32, got "
                         f"{tuple(colptr.shape)} {colptr.dtype}")
    if ids.shape != (x.shape[0],) or ids.dtype != torch.int32:
        raise ValueError(f"ids must be (B,) int32, got {tuple(ids.shape)} "
                         f"{ids.dtype}")
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"x dtype {x.dtype} not in {_X_DTYPES}")
    if rows.dtype not in _ROW_DTYPES:
        raise TypeError(f"rows dtype {rows.dtype} not in {_ROW_DTYPES}")
    if vals.dtype not in _VAL_DTYPES:
        raise TypeError(f"vals dtype {vals.dtype} not in {_VAL_DTYPES}")
    if vals.dtype == torch.int8 and scale is None:
        raise ValueError("int8 vals need a per-adapter scale")
    if scale is not None and (scale.shape != (A,)
                              or scale.dtype != torch.float32):
        raise ValueError(f"scale must be (A,) f32, got {tuple(scale.shape)} "
                         f"{scale.dtype}")


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {   # the C signatures of csrc/sidedelta.cu, stream last
    "sidedelta_launch": [_P, _I, _P, _I, _P, _I] + [_P] * 4 + [_I] * 5
                        + [_L, _P],
    "sidedelta_tokens_launch": [_P, _I, _P, _I, _P, _I] + [_P] * 5
                               + [_I] * 5 + [_L, _I, _P],
}
TILE = 128      # tokens a CTA of the token-minor path walks a table for
ROWS_BELOW = (32, 64)   # calls of fewer tokens (B * S) take the rows path:
                        # one request, several (which may carry several
                        # adapters, a table walk a tile each)


def _fn(name: str):
    fn = getattr(build.load("sidedelta"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def static_path(B: int, S: int) -> str:
    """The static rule: "rows" (a table walk per row) for decode (S == 1)
    and for calls of fewer tokens than ROWS_BELOW gives, where it measured
    faster on the H100; "tokens" (token-minor, a table walk per adapter
    and tile of 128 tokens) otherwise."""
    below = ROWS_BELOW[0] if B == 1 else ROWS_BELOW[1]
    return "rows" if S == 1 or B * S < below else "tokens"


def grid_fits(B: int, S: int, m: int) -> bool:
    """Both paths' grids hold the call (the limits the wrapper checks)."""
    return -(-m // 8) <= 65535 and S <= 65535 and B * S <= 65535 * TILE


# ---------------------------------------------------------------------------
# The autotuned plan cache: ``analysis/autotune.py`` measures both paths
# per call class and installs the winners here; ``kernel_path`` consults
# it before the static rule. Entries are checked at lookup (a path name,
# and grids that hold the class), so a stale or hand-edited cache falls
# back to the rule instead of reaching a launch.
# ---------------------------------------------------------------------------

PATHS = ("rows", "tokens")
PlanKey = Tuple[int, int, int, int, int, int]     # B, S, n, m, K, itemsize

_PLAN_CACHE: Dict[PlanKey, str] = {}
plan_cache_stats = {"hits": 0, "misses": 0, "rejected": 0}


def plan_cache_key(B: int, S: int, n: int, m: int, K: int,
                   x_itemsize: int = 2) -> PlanKey:
    """One call class = one cache entry: B requests of S rows, an (n, m)
    leaf, tables K entries wide, x of ``x_itemsize`` bytes."""
    return (int(B), int(S), int(n), int(m), int(K), int(x_itemsize))


def plan_is_valid(key: PlanKey, path) -> bool:
    """A usable entry: a path's name, at a class whose grids fit."""
    B, S, _, m = key[:4]
    return path in PATHS and grid_fits(B, S, m)


def install_plan_cache(plans: Dict[PlanKey, str],
                       replace: bool = False) -> int:
    """Merge autotuned paths into the cache; returns entries installed."""
    global _PLAN_CACHE
    if replace:
        _PLAN_CACHE = {}
    for key, path in plans.items():
        _PLAN_CACHE[tuple(int(x) for x in key)] = path
    return len(_PLAN_CACHE)


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()
    for k in plan_cache_stats:
        plan_cache_stats[k] = 0


def plan_cache() -> Dict[PlanKey, str]:
    return dict(_PLAN_CACHE)


def kernel_path(B: int, S: int, n: Optional[int] = None,
                m: Optional[int] = None, K: Optional[int] = None,
                x_itemsize: int = 2) -> str:
    """The path the wrapper takes for B requests of S rows: the plan
    cache's entry for the class (B, S, n, m, K, x_itemsize) when one is
    installed and valid, else ``static_path``. Without the leaf's (n, m,
    K), or with no cache installed (the default), only the static rule
    answers, and nothing is counted."""
    if n is not None and _PLAN_CACHE:
        key = plan_cache_key(B, S, n, m, K, x_itemsize)
        if key in _PLAN_CACHE:
            cached = _PLAN_CACHE[key]
            if plan_is_valid(key, cached):
                plan_cache_stats["hits"] += 1
                return cached
            plan_cache_stats["rejected"] += 1
        plan_cache_stats["misses"] += 1
    return static_path(B, S)


def group_by_adapter(ids: torch.Tensor, A: int):
    """The requests grouped by adapter: (order, rptr). order (B,) int32
    lists the requests by a stable sort of their adapter ids, those outside
    [0, A) last; rptr (A + 2,) int32 puts adapter a's requests at
    [rptr[a], rptr[a + 1]) of that order, and a == A those outside."""
    key = torch.where((ids >= 0) & (ids < A), ids, A)
    order = torch.argsort(key, stable=True).to(torch.int32)
    rptr = torch.searchsorted(key[order], torch.arange(
        A + 2, dtype=key.dtype, device=ids.device)).to(torch.int32)
    return order, rptr


def token_minor(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """x (B, S, n) -> (n, B * S) in x's dtype, the requests taken in
    ``order``: each row of the result holds one feature of every token.
    The rows lie a multiple of 4 elements apart (contiguous when B * S is
    one), so the kernel loads 4 tokens at once."""
    B, S, n = x.shape
    T = B * S
    xT = torch.empty((n, -(-T // 4) * 4), dtype=x.dtype,
                     device=x.device)[:, :T]
    return xT.copy_(x.index_select(0, order).reshape(T, n).t())


def sidedelta_cost(x: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
                   colptr: torch.Tensor, ids: torch.Tensor,
                   scale: Optional[torch.Tensor] = None,
                   grouped=None) -> dict:
    """The work of one ``sidedelta`` call on this run's tables: x and ids
    read once, each adapter a request uses read once (its valid entries,
    its column offsets, an int8 table's scale), the f32 output written;
    a multiply and an add for each valid entry of each request's adapter,
    on every row (f32)."""
    B, S, _ = x.shape
    A = rows.shape[0]
    m = colptr.shape[-1] - 1
    valid = colptr[:, m].tolist()
    req = [a for a in ids.tolist() if 0 <= a < A]
    entry = rows.element_size() + vals.element_size()
    table = sum(valid[a] * entry + (m + 1) * 4 + (4 if scale is not None
                                                  else 0)
                for a in set(req))
    return {"flops": float(sum(2 * S * valid[a] for a in req)),
            "bf16_flops": 0.0,
            "bytes_accessed": float(x.numel() * x.element_size()
                                    + ids.numel() * 4 + table
                                    + B * S * m * 4)}


def sidedelta(x: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
              colptr: torch.Tensor, ids: torch.Tensor,
              scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched per-request sparse delta, (B, S, m) f32. CPU tensors take
    ``sidedelta_plain``; CUDA tensors launch the kernel or raise."""
    return _sidedelta(x, rows, vals, colptr, ids, scale)


@counted(sidedelta_cost, "sidedelta")
def _sidedelta(x, rows, vals, colptr, ids, scale=None, grouped=None):
    """``sidedelta``; ``grouped`` = (order, rptr, xT) from
    ``group_by_adapter`` and ``token_minor`` when the caller has them."""
    _check(x, rows, vals, colptr, ids, scale)
    B, S, n = x.shape
    A, K = rows.shape
    m = colptr.shape[1] - 1
    path = kernel_path(B, S, n, m, K, x.element_size())
    if x.device.type == "cpu":
        return sidedelta_plain(x, rows, vals, colptr, ids, scale)
    if x.device.type != "cuda":
        raise RuntimeError(f"sidedelta runs on cuda or cpu, not {x.device}")
    tensors = [x, rows, vals, colptr, ids] + ([scale] if scale is not None
                                              else [])
    for t in tensors:
        if t.device != x.device:
            raise RuntimeError(f"sidedelta operands on {t.device} and "
                               f"{x.device}")
        if not t.is_contiguous():
            raise ValueError("sidedelta operands must be contiguous")
    if not grid_fits(B, S, m):
        raise ValueError(f"sidedelta grid too large for m={m}, B={B}, S={S}")
    if path == "tokens":
        return _launch_tokens(x, rows, vals, colptr, ids, scale, grouped)
    return _launch_rows(x, rows, vals, colptr, ids, scale)


def _flags(x, rows, vals, colptr, scale):
    return (int(x.dtype == torch.bfloat16), rows.data_ptr(),
            int(rows.dtype == torch.int16), vals.data_ptr(),
            int(vals.dtype == torch.int8), colptr.data_ptr(),
            scale.data_ptr() if scale is not None else None)


def _launch_rows(x, rows, vals, colptr, ids, scale=None):
    """The rows path on checked CUDA operands."""
    B, S, n = x.shape
    A, K = rows.shape
    m = colptr.shape[1] - 1
    out = torch.empty((B, S, m), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    _check_launch(_fn("sidedelta_launch")(
        x.data_ptr(), *_flags(x, rows, vals, colptr, scale), ids.data_ptr(),
        out.data_ptr(), B, S, n, m, A, K,
        torch.cuda.current_stream(x.device).cuda_stream))
    return out


def _launch_tokens(x, rows, vals, colptr, ids, scale=None, grouped=None):
    """The token-minor path on checked CUDA operands."""
    B, S, n = x.shape
    A, K = rows.shape
    m = colptr.shape[1] - 1
    out = torch.empty((B, S, m), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    order, rptr, xT = grouped or (*group_by_adapter(ids, A), None)
    if xT is None:
        xT = token_minor(x, order)
    _check_launch(_fn("sidedelta_tokens_launch")(
        xT.data_ptr(), *_flags(x, rows, vals, colptr, scale), rptr.data_ptr(),
        order.data_ptr(), out.data_ptr(), B, S, n, m, A, K, xT.stride(0),
        torch.cuda.current_stream(x.device).cuda_stream))
    return out


def _check_launch(err: int) -> None:
    if err:
        raise RuntimeError(f"sidedelta launch failed: cudaError {err}")
    sidedelta.launches += 1


sidedelta.launches = 0      # kernel launches (CUDA tensors only)


# ---------------------------------------------------------------------------
# The gradient with respect to the values, and the differentiable delta
# ---------------------------------------------------------------------------

def sidedelta_dvals_plain(x: torch.Tensor, dy: torch.Tensor,
                          rows: torch.Tensor, colptr: torch.Tensor,
                          ids: torch.Tensor) -> torch.Tensor:
    """The plain version: per request, gather x at the adapter's valid rows
    and dy at their columns, multiply and sum over the request's rows (64
    rows at a time, to bound the (rows, K) temporaries)."""
    chunk = 64
    B, S, n = x.shape
    A, K = rows.shape
    m = colptr.shape[-1] - 1
    out = torch.zeros((A, K), dtype=torch.float32, device=x.device)
    counts = torch.diff(colptr.long(), dim=-1)                 # (A, m)
    for b, a in enumerate(ids.tolist()):
        if a < 0:
            continue
        valid = int(colptr[a, m])
        col = torch.repeat_interleave(
            torch.arange(m, device=x.device), counts[a])        # (valid,)
        row = rows[a, :valid].long()
        for s0 in range(0, S, chunk):
            xs = x[b, s0:s0 + chunk].float()[:, row]
            out[a, :valid] += (xs * dy[b, s0:s0 + chunk].float()[:, col]
                               ).sum(0)
    return out


def dvals_cost(x: torch.Tensor, dy: torch.Tensor, rows: torch.Tensor,
               colptr: torch.Tensor, ids: torch.Tensor, grouped=None) -> dict:
    """The work of one ``sidedelta_dvals`` call: x and dy read once, every
    table entry's row read and its f32 gradient written, the column
    offsets read; a multiply and an add for each valid entry of each
    request's adapter, on every row (f32)."""
    S = x.shape[1]
    A, K = rows.shape
    m = colptr.shape[-1] - 1
    valid = colptr[:, m].tolist()
    flops = sum(2 * S * valid[a] for a in ids.tolist() if 0 <= a < A)
    return {"flops": float(flops), "bf16_flops": 0.0,
            "bytes_accessed": float(x.numel() * x.element_size()
                                    + dy.numel() * dy.element_size()
                                    + A * K * (rows.element_size() + 4)
                                    + A * (m + 1) * 4)}


def _check_dvals(x, dy, rows, colptr, ids) -> None:
    if x.ndim != 3 or dy.ndim != 3 or dy.shape[:2] != x.shape[:2]:
        raise ValueError(f"x (B, S, n) and dy (B, S, m) expected, got "
                         f"{tuple(x.shape)} / {tuple(dy.shape)}")
    if x.dtype not in _X_DTYPES or dy.dtype != torch.float32:
        raise TypeError(f"x must be f32 or bf16 and dy f32, got {x.dtype} "
                        f"/ {dy.dtype}")
    if rows.ndim != 2 or rows.dtype != torch.int32:
        raise ValueError(f"rows must be (A, K) int32, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if (colptr.shape != (rows.shape[0], dy.shape[2] + 1)
            or colptr.dtype != torch.int32):
        raise ValueError(f"colptr must be (A, m + 1) int32, got "
                         f"{tuple(colptr.shape)} {colptr.dtype}")
    if ids.shape != (x.shape[0],) or ids.dtype != torch.int32:
        raise ValueError(f"ids must be (B,) int32, got {tuple(ids.shape)} "
                         f"{ids.dtype}")


def _dvals_lib() -> ctypes.CDLL:
    lib = build.load("sidedelta_grad")
    fn = lib.sidedelta_dvals_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i, ll, p, ll, p, p, p, p, i, i, i, ll, i, p]
        fn.restype = ctypes.c_int
    return lib


DVALS_VEC = {torch.bfloat16: 8, torch.float32: 4}   # x tokens a vector


def dvals_width(xT: torch.Tensor, dyT: torch.Tensor, S: int) -> int:
    """The dvals kernel instance for token-minor xT (n, T) and dyT (m, T):
    DVALS_VEC[xT.dtype] tokens a 16-byte vector when every adapter's first
    token (a multiple of S) and every row start of both can be a vector's
    start: S and both row strides multiples of the vector, both addresses
    of 16 bytes; else 1 (one token a lane)."""
    vec = DVALS_VEC[xT.dtype]
    ok = (S % vec == 0 and xT.stride(0) % vec == 0 and dyT.stride(0) % 4 == 0
          and xT.data_ptr() % 16 == 0 and dyT.data_ptr() % 16 == 0)
    return vec if ok else 1


def _launch_dvals(xT, dyT, rows, colptr, rptr, S, out) -> torch.Tensor:
    """The dvals kernel alone on grouped, token-minor CUDA operands (as
    ``_sidedelta_dvals`` prepares them; tokens at unit stride, as
    ``token_minor`` lays them out): fills ``out`` (A, K) f32, which must
    arrive zero-filled; returns it."""
    A, K = rows.shape
    vec = dvals_width(xT, dyT, S)
    err = _dvals_lib().sidedelta_dvals_launch(
        xT.data_ptr(), int(xT.dtype == torch.bfloat16), xT.stride(0),
        dyT.data_ptr(), dyT.stride(0), rows.data_ptr(), colptr.data_ptr(),
        rptr.data_ptr(), out.data_ptr(), A, dyT.shape[0], S, K, vec,
        torch.cuda.current_stream(out.device).cuda_stream)
    if err:
        raise RuntimeError(f"sidedelta_dvals launch failed: cudaError {err}")
    sidedelta_dvals.launches += 1
    if vec == 1:
        sidedelta_dvals.unaligned_launches += 1
    return out


def sidedelta_dvals(x: torch.Tensor, dy: torch.Tensor, rows: torch.Tensor,
                    colptr: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """d(loss)/d(vals) of ``sidedelta(x, rows, vals, colptr, ids)`` given
    dy = d(loss)/d(out), (A, K) f32 in the table's column-sorted order
    (zeros past each valid count). CPU tensors take
    ``sidedelta_dvals_plain``; CUDA tensors launch the kernel or raise.

    On the card the requests are first grouped by adapter
    (``group_by_adapter``) and x and dy transposed to token-minor (n, B*S)
    and (m, B*S) (``token_minor``), so the kernel's gathers read
    consecutive tokens, 16 bytes a lane where ``dvals_width`` allows (S a
    multiple of 8 for bf16 x, 4 for f32), one token a lane otherwise
    (counted in ``sidedelta_dvals.unaligned_launches``)."""
    return _sidedelta_dvals(x, dy, rows, colptr, ids)


@counted(dvals_cost, "sidedelta_dvals")
def _sidedelta_dvals(x, dy, rows, colptr, ids, grouped=None):
    """``sidedelta_dvals``; ``grouped`` = (order, rptr, dyT) from
    ``group_by_adapter`` and ``token_minor`` when the caller has them."""
    _check_dvals(x, dy, rows, colptr, ids)
    if x.device.type == "cpu":
        return sidedelta_dvals_plain(x, dy, rows, colptr, ids)
    if x.device.type != "cuda":
        raise RuntimeError(f"sidedelta_dvals runs on cuda or cpu, not "
                           f"{x.device}")
    for t in (dy, rows, colptr, ids):
        if t.device != x.device:
            raise RuntimeError(f"sidedelta_dvals operands on {t.device} and "
                               f"{x.device}")
    B, S, _ = x.shape
    A, K = rows.shape
    if A > 65535:
        raise ValueError(f"sidedelta_dvals grid too large for A={A}")
    out = torch.zeros((A, K), dtype=torch.float32, device=x.device)
    if out.numel() == 0 or B * S == 0:
        return out
    order, rptr, dyT = grouped or (*group_by_adapter(ids, A), None)
    if dyT is None:
        dyT = token_minor(dy, order)
    return _launch_dvals(token_minor(x, order), dyT, rows.contiguous(),
                         colptr.contiguous(), rptr, S, out)


# kernel launches (CUDA tensors only), and those of the one-token instance
# for operands that do not allow vectors (dvals_width)
sidedelta_dvals.launches = sidedelta_dvals.unaligned_launches = 0


class _SideDelta(torch.autograd.Function):
    """sidedelta with f32 column-sorted values, differentiable in x and in
    the values; dx runs the forward kernel over the transposed table."""

    @staticmethod
    def forward(ctx, x, vals, rows, colptr, t_rows, t_ptr, t_perm, ids):
        x = x.contiguous()
        ctx.save_for_backward(x, vals, rows, colptr, t_rows, t_ptr, t_perm,
                              ids)
        return sidedelta(x, rows, vals, colptr, ids)

    @staticmethod
    def backward(ctx, dy):
        x, vals, rows, colptr, t_rows, t_ptr, t_perm, ids = ctx.saved_tensors
        dy = dy.float().contiguous()
        dx = dvals = None
        grouped = None
        if dy.device.type == "cuda":    # one grouping and dyT for both
            with uncounted():           # the kernels' own preparation
                order, rptr = group_by_adapter(ids, rows.shape[0])
                grouped = (order, rptr, token_minor(dy, order))
        if ctx.needs_input_grad[0]:
            vals_t = vals.gather(1, t_perm.long())
            # f32 here, cast to x's dtype as the reference's f32 twin casts
            # its cotangent; autograd adds it to the base matmul's dx
            dx = _sidedelta(dy, t_rows, vals_t, t_ptr, ids,
                            grouped=grouped).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dvals = _sidedelta_dvals(x, dy, rows, colptr, ids, grouped)
        return dx, dvals, None, None, None, None, None, None


def sidedelta_train(x: torch.Tensor, vals: torch.Tensor, rows: torch.Tensor,
                    colptr: torch.Tensor, perm: torch.Tensor,
                    t_rows: torch.Tensor, t_ptr: torch.Tensor,
                    t_perm: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The side delta over trainable f32 values ``vals`` (A, K) in the
    pack's own order, with the layout of ``ops.sidedelta_table(...,
    trainable=True)`` (one layer's slice). Differentiable in x and vals:
    the gather into the kernel's column order is plain torch, and its
    gradient scatters dvals back to the pack's order."""
    vs = vals.gather(1, perm.long())
    return _SideDelta.apply(x, vs, rows, colptr, t_rows, t_ptr, t_perm, ids)
