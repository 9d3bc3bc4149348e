"""Kernel entry points and their registration-time layouts.

Port of ``repro/kernels/ops.py`` for the serving path. The reference's
host pre-passes are numpy and pad every adapter table with (row 0, col 0,
value 0) entries; here they are torch on the tables' own device (the
full-width adapters hold ~139M entries each) and lay the tables out for the
Hopper sidedelta kernel:

  sidedelta_table  per-adapter entries sorted by column, duplicates summed,
                   with per-column offsets; padding lies past each
                   adapter's valid count, where the kernel never reads
  quantize_table   symmetric int8 values with a per-adapter scale

They run once per adapter (or per fused state) at registration, never per
batch. ``scatter_apply`` takes a pack's entries as they are and needs no
layout.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.scatter_apply import scatter_apply  # noqa: F401
from repro_torch.kernels.sidedelta import sidedelta  # noqa: F401


def quantize_table(vals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of (..., K) value tables, one scale per
    row. Returns (q int8, scale f32 (...,)) with q * scale ~= vals; the
    scale is 1 for an all-zero row, so empty slots dequantize to zeros.
    Rounds as ``repro.kernels.ops.quantize_table`` does: the scale is
    amax / 127 rounded once to f32, q = rint(vals / scale)."""
    vals = vals.float()
    amax = vals.abs().amax(dim=-1) if vals.shape[-1] else torch.zeros(
        vals.shape[:-1], device=vals.device)
    scale = torch.where(amax > 0, amax.double() / 127.0,
                        torch.ones_like(amax, dtype=torch.float64)).float()
    q = torch.round(vals / scale[..., None]).clamp_(-127, 127)
    return q.to(torch.int8), scale


def _sorted_unique(idx: torch.Tensor, vals: torch.Tensor, key_of):
    """Flatten (nl, k) entries to one key per entry (``key_of(layer, idx)``,
    layer-major), sort, and sum the values of equal keys. Returns (keys,
    summed f32 values). The summation is a registration-time pre-pass."""
    nl, k = idx.shape
    layer = torch.arange(nl, device=idx.device)[:, None].expand(nl, k)
    key = key_of(layer.long(), idx.long()).reshape(-1)
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    acc = torch.zeros(uniq.shape, dtype=torch.float32, device=idx.device)
    acc.index_add_(0, inv, vals.reshape(-1).float())
    return uniq, acc


def _check_entries(idx: torch.Tensor, vals: torch.Tensor, nm: int) -> None:
    if idx.ndim != 2 or vals.shape != idx.shape:
        raise ValueError(f"entries must be (nl, k) alike, got "
                         f"{tuple(idx.shape)} / {tuple(vals.shape)}")
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= nm):
        raise ValueError(f"flat indices outside [0, {nm})")


def sidedelta_table(slots: Sequence[Optional[Tuple[torch.Tensor,
                                                   torch.Tensor]]],
                    nl: int, n: int, m: int, *, int8: bool = False,
                    device=None) -> dict:
    """Device table of one weight leaf (nl stacked (n, m) matrices) for A
    adapter slots. ``slots[a]`` is (flat_idx (nl, k), vals (nl, k)) or None
    for a slot without entries on this leaf.

    Returns {"rows" (nl, A, K), "vals" (nl, A, K), "colptr" (nl, A, m + 1)
    int32[, "scale" (nl, A) f32]}: each (layer, slot) holds its entries
    sorted by column then row, duplicates summed, colptr[..., c] the first
    entry of column c and colptr[..., m] the valid count. K is the largest
    valid count; the rest is padding the kernel never reads. Values are f32, or int8 with a per-(layer, slot) scale when
    ``int8`` (rows then int16 where n and m fit, as in the reference)."""
    A = max(len(slots), 1)
    present = [s for s in slots if s is not None]
    if device is None:
        device = present[0][0].device if present else "cpu"
    built: List[Optional[tuple]] = []
    kmax = 1
    for s in slots:
        if s is None:
            built.append(None)
            continue
        idx, vals = (t.to(device) for t in s)
        idx = idx.reshape(nl, -1)
        vals = vals.reshape(nl, -1)
        _check_entries(idx, vals, n * m)
        # key = (layer, column, row), so the sort is column-major per layer
        uniq, acc = _sorted_unique(
            idx, vals, lambda layer, i: (layer * m + i % m) * n + i // m)
        row = uniq % n
        layer_col = uniq // n
        layer = layer_col // m
        counts = torch.bincount(layer, minlength=nl)
        kmax = max(kmax, int(counts.max()) if counts.numel() else 0)
        built.append((row, layer_col, layer, counts, acc))

    idx_dt = (torch.int16 if int8 and n < 2 ** 15 and m < 2 ** 15
              else torch.int32)
    rows_t = torch.zeros((nl, A, kmax), dtype=idx_dt, device=device)
    vals_t = torch.zeros((nl, A, kmax), dtype=torch.float32, device=device)
    colptr = torch.zeros((nl, A, m + 1), dtype=torch.int32, device=device)
    for a, b in enumerate(built):
        if b is None:
            continue
        row, layer_col, layer, counts, acc = b
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.arange(row.numel(), device=device) - starts[layer]
        rows_t[layer, a, pos] = row.to(idx_dt)
        vals_t[layer, a, pos] = acc
        per_col = torch.bincount(layer_col, minlength=nl * m).reshape(nl, m)
        colptr[:, a, 1:] = torch.cumsum(per_col, 1).to(torch.int32)
    table = {"rows": rows_t, "colptr": colptr}
    if int8:
        table["vals"], table["scale"] = quantize_table(vals_t)
    else:
        table["vals"] = vals_t
    return table
