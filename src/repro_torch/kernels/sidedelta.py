"""sidedelta — the per-request sparse side delta of multi-tenant serving.

  delta[b, s, c] = sum_k x[b, s, rows[a, k]] * vals[a, k] * scale[a]
                   over adapter a = ids[b]'s entries in column c

(zeros when ids[b] < 0). Tables come in the column-sorted layout of
``ops.sidedelta_table``: rows/vals (A, K), colptr (A, m + 1) with
colptr[a, m] the valid count, scale (A,) for int8 values.

Port of ``repro/kernels/sidedelta.py:sidedelta_rows``. On CUDA tensors the
wrapper launches the hand-written kernel ``csrc/sidedelta.cu`` (its note
says what bounds it and how the design answers); on CPU tensors it computes
``sidedelta_plain``, the gather / multiply / index_add_ version of the same
function, which the tests and ``chip_smoke.py`` hold the kernel against.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

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


def _lib() -> ctypes.CDLL:
    lib = build.load("sidedelta")
    fn = lib.sidedelta_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, i, p, i, p, p, p, p, i, i, i, i, i,
                       ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
    return lib


def sidedelta(x: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
              colptr: torch.Tensor, ids: torch.Tensor,
              scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched per-request sparse delta, (B, S, m) f32. CPU tensors take
    ``sidedelta_plain``; CUDA tensors launch the kernel or raise."""
    _check(x, rows, vals, colptr, ids, scale)
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
    B, S, n = x.shape
    A, K = rows.shape
    m = colptr.shape[1] - 1
    if -(-m // 8) > 65535 or -(-S // 8) > 65535:
        raise ValueError(f"sidedelta grid too large for m={m}, S={S}")
    out = torch.empty((B, S, m), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    err = _lib().sidedelta_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), rows.data_ptr(),
        int(rows.dtype == torch.int16), vals.data_ptr(),
        int(vals.dtype == torch.int8), colptr.data_ptr(),
        scale.data_ptr() if scale is not None else None, ids.data_ptr(),
        out.data_ptr(), B, S, n, m, A, K,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"sidedelta launch failed: cudaError {err}")
    sidedelta.launches += 1
    return out


sidedelta.launches = 0      # kernel launches (CUDA tensors only)
