"""scatter_apply — the rapid switch: W <- W + alpha * scatter(vals), in place.

Port of ``repro/kernels/scatter_apply.py:scatter_apply_tiles``. The update
is one ``AdapterPack`` leaf's entries as they are: (..., k) int32 flat
indices into each trailing (n, m) matrix of a (..., n, m) f32 weight, and
their (..., k) f32 values, in a pack's merged form: each row's indices
strictly ascend, apart from trailing padding entries (index 0, value 0),
which change nothing. On CUDA tensors the wrapper launches
``csrc/scatter_apply.cu`` (one entry a thread on a flat grid over every
layer's entries, 16 warps an SM; any number of layers), whose threads
assert that form: a row with a repeated index would lose an update, so it
traps, and the next synchronization raises "device-side assert
triggered". ``ordered=False`` takes unique indices in any order,
unchecked. On CPU tensors it computes ``scatter_apply_plain``, an
index_add_ with the same rounding, which the tests and ``chip_smoke.py``
hold the kernel against. Both update ``w`` in place: the full-width base
does not fit on the card twice. ``scatter_apply_cost`` gives the work the
kernel does (``kernels.counting``): its bytes are W's 32-byte sectors
that the entries touch (``sector_bytes``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.counting import counted, plain_device


def scatter_apply_plain(w: torch.Tensor, idx: torch.Tensor,
                        vals: torch.Tensor, alpha: float) -> torch.Tensor:
    """The plain version, in place: the product alpha * vals and the sum
    are each rounded in f32; repeated indices are summed."""
    n, m = w.shape[-2:]
    nl = w.numel() // (n * m)
    layer = torch.arange(nl, device=w.device)[:, None] * (n * m)
    flat = (layer + idx.reshape(nl, -1).long()).reshape(-1)
    w.view(-1).index_add_(0, flat, vals.reshape(-1) * alpha)
    return w


def sector_bytes(w: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor):
    """(bytes, sectors) that scatter_apply(w, idx, vals) must move: the
    index and value of every entry read once, and each 32-byte sector of W
    that holds an applied entry (value not 0, index inside its matrix) read
    and written once, counted from the indices at W's own addresses."""
    n, m = w.shape[-2:]
    nl, k = idx.numel() // idx.shape[-1], idx.shape[-1]
    i = idx.reshape(nl, k).long()
    keep = (vals.reshape(nl, k) != 0) & (i >= 0) & (i < n * m)
    first = w.data_ptr() % 32 // 4      # W's first element within a sector
    flat = (torch.arange(nl, device=i.device)[:, None] * (n * m) + i
            + first)[keep]
    sectors = int(torch.unique(flat // 8).numel())
    return nl * k * 8 + 64 * sectors, sectors


def scatter_apply_cost(w: torch.Tensor, idx: torch.Tensor,
                       vals: torch.Tensor, alpha: float = 1.0, *,
                       ordered: bool = True) -> dict:
    """The work of one ``scatter_apply`` call: ``sector_bytes`` on this
    call's entries (the bound counts no operations). On "meta" tensors
    (the dry run), whose entries are unknown, each entry gets a sector of
    its own: the most the call can move."""
    if w.device.type == "meta":
        nk = idx.numel()
        return {"flops": 0.0, "bf16_flops": 0.0,
                "bytes_accessed": float(nk * 8 + 64 * nk)}
    nbytes, _ = sector_bytes(w, idx, vals)
    return {"flops": 0.0, "bf16_flops": 0.0, "bytes_accessed": float(nbytes)}


def _check(w, idx, vals) -> None:
    if w.dtype != torch.float32 or w.ndim < 2:
        raise TypeError(f"w must be (..., n, m) f32, got {tuple(w.shape)} "
                        f"{w.dtype}")
    if (idx.dtype != torch.int32 or vals.dtype != torch.float32
            or vals.shape != idx.shape or idx.shape[:-1] != w.shape[:-2]):
        raise ValueError(
            f"idx/vals must be (..., k) int32/f32 with w's leading dims "
            f"{tuple(w.shape[:-2])}, got {tuple(idx.shape)} {idx.dtype} / "
            f"{tuple(vals.shape)} {vals.dtype}")
    if not w.is_contiguous():
        raise ValueError("scatter_apply updates a contiguous w in place")


def _lib() -> ctypes.CDLL:
    lib = build.load("scatter_apply")
    fn = lib.scatter_apply_launch
    if fn.argtypes is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, ll, ll, ctypes.c_float, ctypes.c_int,
                       p]
        fn.restype = ctypes.c_int
    return lib


@counted(scatter_apply_cost, "scatter_apply")
def scatter_apply(w: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                  alpha: float = 1.0, *, ordered: bool = True
                  ) -> torch.Tensor:
    """w += alpha * scatter(vals at idx) per trailing (n, m) matrix, in
    place; returns w. CPU tensors take ``scatter_apply_plain`` (so do
    "meta" ones under ``counting.on_meta()``, the dry run's); CUDA tensors
    launch the kernel or raise. The kernel asserts that the rows
    are merged unless ``ordered`` is False."""
    _check(w, idx, vals)
    if plain_device(w.device):
        return scatter_apply_plain(w, idx, vals, alpha)
    if w.device.type != "cuda":
        raise RuntimeError(f"scatter_apply runs on cuda or cpu, not "
                           f"{w.device}")
    for t in (idx, vals):
        if t.device != w.device:
            raise RuntimeError(f"scatter_apply operands on {t.device} and "
                               f"{w.device}")
        if not t.is_contiguous():
            raise ValueError("scatter_apply operands must be contiguous")
    if idx.numel() == 0:
        return w
    n, m = w.shape[-2:]
    nl, k = idx.numel() // idx.shape[-1], idx.shape[-1]
    err = _lib().scatter_apply_launch(
        w.data_ptr(), idx.data_ptr(), vals.data_ptr(), nl, k, n * m,
        float(alpha), int(ordered),
        torch.cuda.current_stream(w.device).cuda_stream)
    if err:
        raise RuntimeError(f"scatter_apply launch failed: cudaError {err}")
    scatter_apply.launches += 1
    return w


scatter_apply.launches = 0  # kernel launches (CUDA tensors only)
