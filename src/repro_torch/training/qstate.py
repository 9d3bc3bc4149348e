"""Quantized optimizer-moment storage for the multi-adapter trainer.

Port of ``repro/training/qstate.py``. With A adapters resident, the two f32
moments cost 8 bytes per packed value; storing them between steps as bf16
(4 bytes) or int8 with per-row scales (~2 bytes) stops them bounding the
adapters a card holds.

  "f32"   plain f32; the default and the oracle of the others
  "bf16"  a rounding cast (bf16 keeps f32's exponent range, no scales)
  "int8"  symmetric per-row quantization, one f32 scale per (adapter,
          layer) row: mu as q = rint(m / s), s = amax|m| / 127; nu, which
          is non-negative with a squared range, in the sqrt domain:
          q = rint(sqrt(nu) / s), s = amax(sqrt(nu)) / 127. All-zero rows
          take scale 1 and decode to exact zeros.

``torch.round`` rounds half to even, as ``jnp.rint`` does. The fused
update kernel (``kernels.sparse_adamw.sparse_adamw_rows``) decodes inline
and returns f32 moments, which ``encode`` re-compresses.
"""
from __future__ import annotations

import torch

MOMENT_MODES = ("f32", "bf16", "int8")


def storage_dtype(mode: str) -> torch.dtype:
    return {"f32": torch.float32, "bf16": torch.bfloat16,
            "int8": torch.int8}[mode]


def _row_scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))


def encode(moment: torch.Tensor, mode: str, sqrt_domain: bool = False):
    """f32 moment (..., K) -> (stored, scale (...,) or None)."""
    if mode == "f32":
        return moment, None
    if mode == "bf16":
        return moment.to(torch.bfloat16), None
    if mode != "int8":
        raise ValueError(f"unknown moment mode {mode!r}")
    x = torch.sqrt(moment) if sqrt_domain else moment
    scale = _row_scale(x.abs().amax(dim=-1))
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def decode(stored: torch.Tensor, scale, mode: str,
           sqrt_domain: bool = False) -> torch.Tensor:
    """Inverse of ``encode``: the reference path's dequant (the fused
    kernel does the same math inline)."""
    if mode == "f32":
        return stored
    if mode == "bf16":
        return stored.float()
    x = stored.float() * scale[..., None]
    return x * x if sqrt_domain else x


def moment_bytes_per_value(mode: str, k: int) -> float:
    """Persistent bytes per packed value for BOTH moments, amortizing the
    per-row f32 scales over a K-length row (int8 only)."""
    per = {"f32": 4.0, "bf16": 2.0, "int8": 1.0}[mode]
    scales = (2 * 4.0 / max(k, 1)) if mode == "int8" else 0.0
    return 2 * per + scales
