"""Multi-adapter fusion for SHiRA (paper §3.2): fused packs and the index
overlap that says why naive addition works.

Port of ``fuse_packs`` and ``index_overlap`` of ``repro/core/fusion.py``.
The merge runs in torch on the packs' own device, since full-width packs
hold ~139M entries; it gives the reference's entries exactly (ascending
unique indices per matrix, values summed in pack order, rows padded with
index 0 and value 0).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.adapters import AdapterPack


def index_overlap(p1: AdapterPack, p2: AdapterPack) -> Dict[str, float]:
    """Fraction of shared nonzero coordinates per target path."""
    out = {}
    for path in p1.entries:
        if path not in p2.entries:
            continue
        i1 = p1.entries[path][0].cpu().numpy()
        i2 = p2.entries[path][0].cpu().numpy()
        i1 = i1.reshape(-1, i1.shape[-1])
        i2 = i2.reshape(-1, i2.shape[-1])
        fr = [np.intersect1d(a, b).size / max(min(a.size, b.size), 1)
              for a, b in zip(i1, i2)]
        out[path] = float(np.mean(fr))
    return out


def fuse_packs(packs: List[AdapterPack],
               weights: Optional[List[float]] = None,
               name: str = "fused") -> AdapterPack:
    """One pack equal to sum_i w_i * alpha_i * S_i, duplicate coordinates
    merged (so loading it equals loading all of them)."""
    weights = weights or [1.0] * len(packs)
    entries = {}
    paths: List[str] = []           # union over packs, first-seen order
    for p in packs:
        paths.extend(k for k in p.entries if k not in paths)
    for path in paths:
        idx_list, val_list = [], []
        for p, w in zip(packs, weights):
            if path not in p.entries:
                continue
            i, v = p.entries[path]
            idx_list.append(i)
            val_list.append(v.float() * float(np.float32(w * p.alpha)))
        lead = tuple(idx_list[0].shape[:-1])
        nl = int(np.prod(lead)) if lead else 1
        device = idx_list[0].device
        cat_i = torch.cat([i.reshape(nl, -1).long() for i in idx_list], 1)
        cat_v = torch.cat([v.reshape(nl, -1) for v in val_list], 1)
        span = int(cat_i.max()) + 1 if cat_i.numel() else 1
        layer = torch.arange(nl, device=device)[:, None]
        key = (layer * span + cat_i).reshape(-1)
        # stable sort keeps pack order among equal keys, so the sums run in
        # the order np.add.at takes them
        key_s, order = torch.sort(key, stable=True)
        v_s = cat_v.reshape(-1)[order]
        uniq, inv = torch.unique_consecutive(key_s, return_inverse=True)
        acc = torch.zeros(uniq.shape, dtype=torch.float32, device=device)
        acc.index_add_(0, inv, v_s)
        row = uniq // span
        counts = torch.bincount(row, minlength=nl)
        k = int(counts.max())
        pos = torch.arange(uniq.numel(), device=device) - (
            torch.cumsum(counts, 0) - counts)[row]
        mi = torch.zeros((nl, k), dtype=torch.int32, device=device)
        mv = torch.zeros((nl, k), dtype=torch.float32, device=device)
        mi[row, pos] = (uniq % span).to(torch.int32)
        mv[row, pos] = acc
        entries[path] = (mi.reshape(lead + (k,)), mv.reshape(lead + (k,)))
    return AdapterPack(name=name, entries=entries, alpha=1.0)
