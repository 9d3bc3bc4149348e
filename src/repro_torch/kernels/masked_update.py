"""masked_update — the dense-mask apply: W <- W + alpha * (M ⊙ V), in place.

Port of ``repro/kernels/masked_update.py:masked_update_tiles``: the apply
of a dense (mask, delta) pair, which is what hook-mode SHiRA training
produces; ``runtime.Trainer`` runs it once a step for each target leaf,
with V the AdamW direction and alpha = -lr. W is a contiguous (..., n, m)
leaf, f32 or bf16; M has W's shape, bool/uint8 (the port's masks) or f32
(the reference's, from ``bridge``); V has W's shape, f32. The sum is taken
in f32, each product and the sum rounded on their own, and cast to W's
dtype.

On CUDA tensors the wrapper launches ``csrc/masked_update.cu`` (one
launch for the whole leaf, stacked layers included); on CPU tensors it
computes ``masked_update_plain``, which the tests and ``chip_smoke.py``
hold the kernel against bit for bit. Both update ``w`` in place, as the
Pallas kernel aliases its output to W. ``masked_update_cost`` gives the
work the kernel does (``kernels.counting``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.counting import counted

_W_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_M_DTYPES = {torch.bool: 0, torch.uint8: 0, torch.float32: 1}


def masked_update_plain(w: torch.Tensor, mask: torch.Tensor,
                        vals: torch.Tensor, alpha: float) -> torch.Tensor:
    """The plain version, in place: (w + (alpha * m) * v) in f32, each
    operation rounded on its own, cast to w's dtype."""
    out = w.float() + (alpha * mask.float()) * vals
    return w.copy_(out)


def written_sectors(w: torch.Tensor, mask: torch.Tensor) -> int:
    """The 32-byte sectors of W (from its first element) that hold a
    masked entry: those the update writes."""
    per = 32 // w.element_size()        # W entries a 32-byte sector
    flat = mask.reshape(-1)
    chunk = per << 24
    sectors = 0
    for lo in range(0, flat.numel(), chunk):  # bounded temporaries
        part = flat[lo:lo + chunk]
        if part.numel() % per:
            part = torch.cat([part, part.new_zeros(per - part.numel() % per)])
        sectors += int(part.reshape(-1, per).ne(0).any(1).sum())
    return sectors


def masked_update_cost(w: torch.Tensor, mask: torch.Tensor,
                       vals: torch.Tensor, alpha: float = 1.0) -> dict:
    """The work of one ``masked_update`` call: W, M and V read whole (a NaN
    in V or a -0 in W changes W off the mask too), and only the 32-byte
    sectors of W that hold a masked entry written, counted on this call's
    mask (the update is in place); a multiply, a multiply and an add an
    element (f32)."""
    n = w.numel()
    return {"flops": float(3 * n), "bf16_flops": 0.0,
            "bytes_accessed": float(n * (w.element_size()
                                         + mask.element_size() + 4)
                                    + 32 * written_sectors(w, mask))}


def _check(w, mask, vals) -> None:
    if w.dtype not in _W_DTYPES or w.ndim < 2:
        raise TypeError(f"w must be (..., n, m) f32 or bf16, got "
                        f"{tuple(w.shape)} {w.dtype}")
    if mask.dtype not in _M_DTYPES or vals.dtype != torch.float32:
        raise TypeError(f"mask must be bool, uint8 or f32 and vals f32, got "
                        f"{mask.dtype} / {vals.dtype}")
    if mask.shape != w.shape or vals.shape != w.shape:
        raise ValueError(f"mask and vals must have w's shape "
                         f"{tuple(w.shape)}, got {tuple(mask.shape)} / "
                         f"{tuple(vals.shape)}")
    if not w.is_contiguous():
        raise ValueError("masked_update updates a contiguous w in place")


def _lib() -> ctypes.CDLL:
    lib = build.load("masked_update")
    fn = lib.masked_update_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, ctypes.c_longlong, i, i, i, ctypes.c_float,
                       p]
        fn.restype = ctypes.c_int
    return lib


@counted(masked_update_cost, "masked_update")
def masked_update(w: torch.Tensor, mask: torch.Tensor, vals: torch.Tensor,
                  alpha: float = 1.0) -> torch.Tensor:
    """w += alpha * (mask * vals), in place; returns w. CPU tensors take
    ``masked_update_plain``; CUDA tensors launch the kernel or raise."""
    _check(w, mask, vals)
    if w.device.type == "cpu":
        return masked_update_plain(w, mask, vals, alpha)
    if w.device.type != "cuda":
        raise RuntimeError(f"masked_update runs on cuda or cpu, not "
                           f"{w.device}")
    for t in (mask, vals):
        if t.device != w.device:
            raise RuntimeError(f"masked_update operands on {t.device} and "
                               f"{w.device}")
        if not t.is_contiguous():
            raise ValueError("masked_update operands must be contiguous")
    if w.numel() == 0:
        return w
    vec = int(all(t.data_ptr() % 16 == 0 for t in (w, mask, vals)))
    err = _lib().masked_update_launch(
        w.data_ptr(), mask.data_ptr(), vals.data_ptr(), w.numel(),
        _W_DTYPES[w.dtype], _M_DTYPES[mask.dtype], vec, float(alpha),
        torch.cuda.current_stream(w.device).cuda_stream)
    if err:
        raise RuntimeError(f"masked_update launch failed: cudaError {err}")
    masked_update.launches += 1
    return w


masked_update.launches = 0  # kernel launches (CUDA tensors only)
