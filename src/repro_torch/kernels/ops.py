"""Kernel entry points and their registration-time layouts.

Port of ``repro/kernels/ops.py``. The reference's host pre-passes are numpy
and pad every adapter table with (row 0, col 0, value 0) entries; here they
are torch on the tables' own device (the full-width adapters hold ~139M
entries each) and lay the tables out for the Hopper sidedelta kernels:

  sidedelta_table  per-adapter entries sorted by column, duplicates summed,
                   with per-column offsets; padding lies past each
                   adapter's valid count, where the kernel never reads.
                   Trainable tables also carry the permutation from the
                   pack's order and the row-sorted (transposed) table of
                   the gradient
  quantize_table   symmetric int8 values with a per-adapter scale

They run once per adapter (or per fused state, or per trainer) at
registration, never per batch. ``scatter_apply`` takes a pack's entries as
they are and needs no layout; so does ``masked_update``, the dense-mask
apply of hook-mode training, which updates w in place (the reference's
returns the aliased output). ``sparse_adamw`` and ``sparse_adamw_batched``
are the optimizer's entry points: they compute the step's f32 scalars as
the reference's wrappers do and launch the fused update.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import sparse_adamw as _adamw
from repro_torch.kernels.masked_update import masked_update  # noqa: F401
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


def _offsets(counts: torch.Tensor) -> torch.Tensor:
    """(nl, c) counts -> (nl, c + 1) offsets starting at 0."""
    return torch.nn.functional.pad(torch.cumsum(counts, 1), (1, 0))


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32)


def _trainable_table(slots: Sequence[torch.Tensor], nl: int, n: int,
                     m: int) -> dict:
    """The layout of ``sidedelta_table(..., trainable=True)``; see there."""
    ks = {tuple(s.reshape(nl, -1).shape) for s in slots}
    if len(ks) != 1:
        raise ValueError(f"trainable slots must share one (nl, k) shape, "
                         f"got {sorted(ks)}")
    k = ks.pop()[1]
    device = slots[0].device
    base = torch.arange(nl, device=device)[:, None] * k
    out = {name: [] for name in ("rows", "colptr", "perm", "t_rows", "t_ptr",
                                 "t_perm")}
    for s in slots:
        idx = s.reshape(nl, k).long()
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n * m):
            raise ValueError(f"flat indices outside [0, {n * m})")
        layer = torch.arange(nl, device=device)[:, None]
        row, col = idx // m, idx % m
        # column-major keys per layer: the forward's column-sorted order
        key, order = torch.sort(((layer * m + col) * n + row).reshape(-1))
        if bool((key[1:] == key[:-1]).any()):
            raise ValueError("trainable entries repeat a coordinate: their "
                             "values could not be told apart")
        # position of each pack entry in the column-sorted order
        pos = torch.empty_like(order)
        pos[order] = torch.arange(order.numel(), device=device)
        out["rows"].append(_i32((key % n).reshape(nl, k)))
        out["perm"].append(_i32(order.reshape(nl, k) - base))
        per_col = torch.bincount(key // n, minlength=nl * m).reshape(nl, m)
        out["colptr"].append(_i32(_offsets(per_col)))
        # row-major keys: the transposed table that dx runs over
        key_t, order_t = torch.sort(((layer * n + row) * m + col).reshape(-1))
        out["t_rows"].append(_i32((key_t % m).reshape(nl, k)))
        out["t_perm"].append(_i32(pos[order_t].reshape(nl, k) - base))
        per_row = torch.bincount(key_t // m, minlength=nl * n).reshape(nl, n)
        out["t_ptr"].append(_i32(_offsets(per_row)))
        del key, order, pos, key_t, order_t
    return {name: torch.stack(v, dim=1) for name, v in out.items()}


def sidedelta_table(slots: Sequence, nl: int, n: int, m: int, *,
                    int8: bool = False, trainable: bool = False,
                    device=None) -> dict:
    """Device table of one weight leaf (nl stacked (n, m) matrices) for A
    adapter slots. ``slots[a]`` is (flat_idx (nl, k), vals (nl, k)) or None
    for a slot without entries on this leaf. With ``int8`` a slot may also
    be (flat_idx (nl, k), vals_q (nl, k) int8, scale float): values already
    quantized (an int8 pack from the adapter store), kept as they are with
    that scale instead of being quantized again.

    Returns {"rows" (nl, A, K), "vals" (nl, A, K), "colptr" (nl, A, m + 1)
    int32[, "scale" (nl, A) f32]}: each (layer, slot) holds its entries
    sorted by column then row, duplicates summed, colptr[..., c] the first
    entry of column c and colptr[..., m] the valid count. K is the largest
    valid count; the rest is padding the kernel never reads. Values are
    f32, or int8 with a per-(layer, slot) scale when ``int8`` (rows then
    int16 where n and m fit, as in the reference).

    ``trainable=True`` lays out a multi-adapter trainer's tables, whose
    values are the trained packs' own: ``slots[a]`` is then just flat_idx
    (nl, k), every slot with the same k and no coordinate twice in a matrix
    (rand masks draw without replacement; a repeat raises, since its values
    could not be trained apart). The table holds no values: "rows" and
    "colptr" as above, "perm" (nl, A, k) the pack index of each
    column-sorted entry (values in the kernel's order are
    ``vals.gather(-1, perm)``), and the transposed, row-sorted table that
    the gradient with respect to x runs over: "t_rows" (nl, A, k) the
    entries' columns, "t_ptr" (nl, A, n + 1) and "t_perm" (nl, A, k), the
    column-sorted position of each row-sorted entry. All int32.
    """
    if trainable:
        if int8 or not slots or any(s is None for s in slots):
            raise ValueError("trainable tables are f32 with every slot given")
        return _trainable_table([s.to(device) if device is not None else s
                                 for s in slots], nl, n, m)
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
        direct = len(s) == 3
        if direct and not int8:
            raise ValueError("quantized slots need int8 tables")
        idx, vals = (t.to(device) for t in s[:2])
        idx = idx.reshape(nl, -1)
        vals = vals.reshape(nl, -1)
        _check_entries(idx, vals, n * m)
        # key = (layer, column, row), so the sort is column-major per layer
        uniq, acc = _sorted_unique(
            idx, vals, lambda layer, i: (layer * m + i % m) * n + i // m)
        if direct and acc.numel() and float(acc.abs().max()) > 127:
            # f32 sums of int8 values are exact; only padding repeats
            raise ValueError("quantized duplicate entries sum past int8")
        row = uniq % n
        layer_col = uniq // n
        layer = layer_col // m
        counts = torch.bincount(layer, minlength=nl)
        kmax = max(kmax, int(counts.max()) if counts.numel() else 0)
        built.append((row, layer_col, layer, counts, acc,
                      float(s[2]) if direct else None))

    idx_dt = (torch.int16 if int8 and n < 2 ** 15 and m < 2 ** 15
              else torch.int32)
    rows_t = torch.zeros((nl, A, kmax), dtype=idx_dt, device=device)
    vals_t = torch.zeros((nl, A, kmax), dtype=torch.float32, device=device)
    colptr = torch.zeros((nl, A, m + 1), dtype=torch.int32, device=device)
    direct_slots = []
    for a, b in enumerate(built):
        if b is None:
            continue
        row, layer_col, layer, counts, acc, scale = b
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.arange(row.numel(), device=device) - starts[layer]
        rows_t[layer, a, pos] = row.to(idx_dt)
        vals_t[layer, a, pos] = acc
        per_col = torch.bincount(layer_col, minlength=nl * m).reshape(nl, m)
        colptr[:, a, 1:] = torch.cumsum(per_col, 1).to(torch.int32)
        if scale is not None:
            direct_slots.append((a, scale))
    table = {"rows": rows_t, "colptr": colptr}
    if int8:
        table["vals"], table["scale"] = quantize_table(vals_t)
        for a, scale in direct_slots:
            table["vals"][:, a] = vals_t[:, a].to(torch.int8)
            table["scale"][:, a] = scale
    else:
        table["vals"] = vals_t
    return table


# ---------------------------------------------------------------------------
# sparse_adamw
# ---------------------------------------------------------------------------

def _adamw_scalars(step: int, lr, b1, b2, eps, wd) -> List[float]:
    """[lr, b1, b2, eps, wd, 1 - b1^t, 1 - b2^t] as the reference's
    ``_adamw_scalars`` forms them: every value rounded to f32, and the bias
    corrections computed in f32 from the f32 betas (not in Python's
    float64, which differs in the last bits)."""
    f = np.float32
    t = f(step)
    return [float(f(lr)), float(f(b1)), float(f(b2)), float(f(eps)),
            float(f(wd)), float(f(1) - f(b1) ** t), float(f(1) - f(b2) ** t)]


def sparse_adamw(values, grads, mu, nu, step: int, *, lr=1e-3, b1=0.9,
                 b2=0.999, eps=1e-8, wd=0.0):
    """Fused AdamW over one packed (K,) vector at the 1-based ``step``.
    Returns (values, mu, nu), f32. Unlike the reference, K is not padded
    to a block multiple: the kernel masks its tail."""
    return _adamw.sparse_adamw(values, grads, mu, nu,
                               _adamw_scalars(step, lr, b1, b2, eps, wd))


def sparse_adamw_batched(values, grads, mu, nu, step: int, *, lr, b1=0.9,
                         b2=0.999, eps=1e-8, wd=0.0, mu_scale=None,
                         nu_scale=None):
    """Fused AdamW over (R, K) row-stacked packed values, one launch for
    every (adapter, layer) row of a leaf. ``mu``/``nu`` are stored f32,
    bf16, or int8 with per-row ``mu_scale``/``nu_scale`` (nu in the sqrt
    domain, see ``training.qstate``); the moments come back f32 and the
    caller re-encodes them."""
    return _adamw.sparse_adamw_rows(values, grads, mu, nu, mu_scale,
                                    nu_scale,
                                    _adamw_scalars(step, lr, b1, b2, eps, wd))
