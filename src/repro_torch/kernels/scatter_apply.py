"""scatter_apply — the rapid switch: W <- W + alpha * scatter(vals), in place.

Port of ``repro/kernels/scatter_apply.py:scatter_apply_tiles``. The update
is one ``AdapterPack`` leaf's entries as they are: (..., k) int32 flat
indices into each trailing (n, m) matrix of a (..., n, m) f32 weight, and
their (..., k) f32 values. Indices are unique within each matrix apart from
padding entries of value 0, which change nothing. On CUDA tensors the
wrapper launches ``csrc/scatter_apply.cu`` (one entry a thread on a flat
grid over every layer's entries, 16 warps an SM; any number of layers, any
index order, fastest for ascending indices); on CPU tensors it computes
``scatter_apply_plain``, an index_add_ with the same rounding, which the
tests and ``chip_smoke.py`` hold the kernel against.
Both update ``w`` in place: the full-width base does not fit on the card
twice.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def scatter_apply_plain(w: torch.Tensor, idx: torch.Tensor,
                        vals: torch.Tensor, alpha: float) -> torch.Tensor:
    """The plain version, in place: the product alpha * vals and the sum
    are each rounded in f32."""
    n, m = w.shape[-2:]
    nl = w.numel() // (n * m)
    layer = torch.arange(nl, device=w.device)[:, None] * (n * m)
    flat = (layer + idx.reshape(nl, -1).long()).reshape(-1)
    w.view(-1).index_add_(0, flat, vals.reshape(-1) * alpha)
    return w


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
        fn.argtypes = [p, p, p, ll, ll, ll, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def scatter_apply(w: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                  alpha: float = 1.0) -> torch.Tensor:
    """w += alpha * scatter(vals at idx) per trailing (n, m) matrix, in
    place; returns w. CPU tensors take ``scatter_apply_plain``; CUDA
    tensors launch the kernel or raise."""
    _check(w, idx, vals)
    if w.device.type == "cpu":
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
        float(alpha), torch.cuda.current_stream(w.device).cuda_stream)
    if err:
        raise RuntimeError(f"scatter_apply launch failed: cudaError {err}")
    scatter_apply.launches += 1
    return w


scatter_apply.launches = 0  # kernel launches (CUDA tensors only)
