"""sparse_adamw — the fused AdamW step over packed SHiRA values.

  m  = b1 * m_prev + (1 - b1) * g
  u  = b2 * u_prev + (1 - b2) * g * g
  v' = v - lr * ((m / c1) / (sqrt(u / c2) + eps) + wd * v)

with c1 = 1 - b1^t, c2 = 1 - b2^t. Two entry points, ports of
``repro/kernels/sparse_adamw.py``:

  sparse_adamw       one (K,) vector (``sparse_adamw_blocks``), the
                     single-adapter ``Trainer``'s update of one leaf
  sparse_adamw_rows  (R, K) rows (``sparse_adamw_rows``), the multi-adapter
                     trainer's update of one leaf for all adapters at once;
                     moments stored f32, bf16, or int8 with per-row scales
                     (nu in the sqrt domain), always returned f32

``scalars`` is the sequence [lr, b1, b2, eps, wd, c1, c2] of f32 values
(``kernels.ops._adamw_scalars`` computes it as the JAX wrapper does). On
CUDA tensors the wrappers launch ``csrc/sparse_adamw.cu``; on CPU tensors
they compute the plain versions below, the same f32 operations rounded one
by one, which the tests and ``chip_smoke.py`` hold the kernel against (on
the card PyTorch divides by a scalar through its reciprocal, so the two
agree to the last bit of some elements, not bit for bit).

The kernel is bound by the bytes it moves (28 an element with f32
moments, 24 bf16, 22 int8), so both entry points run one streaming body
over the R * K elements as one flat range: each thread takes a vector of
consecutive elements in 16-byte accesses, and a persistent grid keeps
enough loads in flight to fill the memory system. A vector needs every
pointer aligned to its bytes (``vector_width``): whole tensors always are;
a view at another offset takes the one-element instance of the same
kernel, counted apart in ``unaligned_launches``. ``sparse_adamw_cost`` and
``sparse_adamw_rows_cost`` give the work each entry point does
(``kernels.counting``).
"""
from __future__ import annotations

import ctypes
from typing import Iterable, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.counting import counted

_MOMENT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
Out = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _adamw_math(v, g, m_prev, u_prev, scalars) -> Out:
    """The update from f32 moments, each operation rounded in f32. Every
    scalar is an f32 value (a Python float that f32 holds exactly), so
    ``1 - b1`` is formed in f32 as the kernel forms it."""
    lr, b1, b2, eps, wd, c1, c2 = (torch.tensor(s, dtype=torch.float32)
                                   for s in scalars)
    m = b1 * m_prev + (1 - b1) * g
    u = b2 * u_prev + (1 - b2) * g * g
    delta = (m / c1) / (torch.sqrt(u / c2) + eps) + wd * v
    return v - lr * delta, m, u


def sparse_adamw_plain(v, g, mu, nu, scalars) -> Out:
    return _adamw_math(v, g, mu, nu, scalars)


def sparse_adamw_rows_plain(v, g, mu, nu, mu_scale, nu_scale,
                            scalars) -> Out:
    """Decodes the moments as the kernel does (int8: q * scale, nu squared
    back from the sqrt domain), then the same update."""
    if mu.dtype == torch.int8:
        m_prev = mu.float() * mu_scale[:, None]
        ru = nu.float() * nu_scale[:, None]
        u_prev = ru * ru
    else:
        m_prev, u_prev = mu.float(), nu.float()
    return _adamw_math(v, g, m_prev, u_prev, scalars)


def sparse_adamw_cost(v, g, mu, nu, scalars) -> dict:
    """The work of one ``sparse_adamw`` call: v, g and both f32 moments
    read, v', m and u written (28 bytes an element); 15 f32 operations an
    element."""
    return {"flops": float(15 * v.numel()), "bf16_flops": 0.0,
            "bytes_accessed": float(28 * v.numel())}


def sparse_adamw_rows_cost(v, g, mu, nu, mu_scale, nu_scale,
                           scalars) -> dict:
    """The work of one ``sparse_adamw_rows`` call: v and g read and v', m
    and u written in f32, both moments read in their stored type; 15 f32
    operations an element."""
    return {"flops": float(15 * v.numel()), "bf16_flops": 0.0,
            "bytes_accessed": float(v.numel()
                                    * (20 + 2 * mu.element_size()))}


def _check(v, g, mu, nu, mu_scale, nu_scale, ndim: int) -> None:
    if v.ndim != ndim or any(t.shape != v.shape for t in (g, mu, nu)):
        raise ValueError(f"values/grads/moments must be {ndim}-D alike, got "
                         f"{[tuple(t.shape) for t in (v, g, mu, nu)]}")
    if v.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"values and grads must be f32, got {v.dtype} / "
                        f"{g.dtype}")
    if mu.dtype != nu.dtype or mu.dtype not in _MOMENT_DTYPES:
        raise TypeError(f"moments must share a dtype of {list(_MOMENT_DTYPES)}"
                        f", got {mu.dtype} / {nu.dtype}")
    if ndim == 1 and mu.dtype != torch.float32:
        raise TypeError("sparse_adamw takes f32 moments")
    scaled = mu.dtype == torch.int8
    for s in (mu_scale, nu_scale):
        if scaled and (s is None or s.shape != v.shape[:1]
                       or s.dtype != torch.float32):
            raise ValueError("int8 moments need (R,) f32 mu_scale/nu_scale")
        if not scaled and s is not None:
            raise ValueError("per-row scales go with int8 moments only")


_P, _LL, _F, _I = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                   ctypes.c_int)
_ARGTYPES = {   # the C signatures of csrc/sparse_adamw.cu, stream last
    "sparse_adamw": [_P] * 7 + [_LL, _I] + [_F] * 7 + [_P],
    "sparse_adamw_rows": [_P] * 6 + [_I] + [_P] * 3 + [_LL] * 2 + [_I]
                         + [_F] * 7 + [_P],
}


def vector_width(tensors: Iterable[torch.Tensor], vec: int) -> int:
    """The kernel instance for these operands: ``vec`` elements a vector
    when every tensor's address is a multiple of a vector's bytes (at most
    16: wider vectors load as 16-byte words), else 1. The kernel indexes
    every operand by one flat element index, so each must be aligned."""
    ok = all(t.data_ptr() % min(16, vec * t.element_size()) == 0
             for t in tensors)
    return vec if ok else 1


def _launch(wrapper, streamed, scales, head, scalars) -> None:
    """Launch ``wrapper``'s kernel. ``streamed``: the tensors it indexes
    element by element (v, g, mu, nu, then the outputs); ``scales``: int8
    moments' per-row scales; ``head``: the C arguments before ``vec``,
    ``scalars`` those after it."""
    name = wrapper.__name__
    dev = streamed[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{name} runs on cuda or cpu, not {dev}")
    for t in [*streamed, *scales]:
        if t.device != dev:
            raise RuntimeError(f"{name} operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} operands must be contiguous")
    lib = build.load("sparse_adamw")
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    vec = vector_width(streamed, lib.sparse_adamw_vec())
    err = fn(*head, vec, *(float(s) for s in scalars),
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    wrapper.launches += 1
    if vec == 1:
        wrapper.unaligned_launches += 1


@counted(sparse_adamw_cost, "sparse_adamw_blocks")
def sparse_adamw(v: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                 nu: torch.Tensor, scalars: Sequence[float]) -> Out:
    """One packed (K,) vector: returns (v', m, u), all f32 (K,). CPU
    tensors take ``sparse_adamw_plain``; CUDA tensors launch the kernel or
    raise."""
    _check(v, g, mu, nu, None, None, 1)
    if v.device.type == "cpu":
        return sparse_adamw_plain(v, g, mu, nu, scalars)
    outs = [torch.empty_like(v) for _ in range(3)]
    if v.numel():
        streamed = [v, g, mu, nu, *outs]
        _launch(sparse_adamw, streamed, [],
                [*(t.data_ptr() for t in streamed), v.numel()], scalars)
    return tuple(outs)


@counted(sparse_adamw_rows_cost, "sparse_adamw_rows")
def sparse_adamw_rows(v: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                      nu: torch.Tensor, mu_scale: Optional[torch.Tensor],
                      nu_scale: Optional[torch.Tensor],
                      scalars: Sequence[float]) -> Out:
    """(R, K) rows: v, g f32; mu, nu f32, bf16, or int8 with (R,) f32
    scales. Returns (v', m, u), all f32 (R, K). CPU tensors take
    ``sparse_adamw_rows_plain``; CUDA tensors launch the kernel or raise."""
    _check(v, g, mu, nu, mu_scale, nu_scale, 2)
    if v.device.type == "cpu":
        return sparse_adamw_rows_plain(v, g, mu, nu, mu_scale, nu_scale,
                                       scalars)
    r, k = v.shape
    outs = [torch.empty_like(v) for _ in range(3)]
    if v.numel():
        scales = [s for s in (mu_scale, nu_scale) if s is not None]
        ptr = lambda t: None if t is None else t.data_ptr()
        _launch(sparse_adamw_rows, [v, g, mu, nu, *outs], scales,
                [*(t.data_ptr() for t in (v, g, mu, nu)), ptr(mu_scale),
                 ptr(nu_scale), _MOMENT_DTYPES[mu.dtype],
                 *(t.data_ptr() for t in outs), r, k], scalars)
    return tuple(outs)


# kernel launches (CUDA tensors only), and those of the one-element
# instance for operands not aligned to a vector
sparse_adamw.launches = sparse_adamw.unaligned_launches = 0
sparse_adamw_rows.launches = sparse_adamw_rows.unaligned_launches = 0
