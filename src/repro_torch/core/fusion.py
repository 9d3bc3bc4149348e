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

from repro_torch.core.adapters import AdapterPack, merge_rows


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
               name: str = "fused",
               only: Optional[List[str]] = None) -> AdapterPack:
    """One pack equal to sum_i w_i * alpha_i * S_i, duplicate coordinates
    merged (so loading it equals loading all of them). ``only`` restricts
    it to those paths (a table build fuses one path at a time, so that one
    path's merged entries are alive at once, not a whole pack's)."""
    weights = weights or [1.0] * len(packs)
    entries = {}
    paths: List[str] = []           # union over packs, first-seen order
    for p in packs:
        paths.extend(k for k in p.entries if k not in paths
                     and (only is None or k in only))
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
        mi, mv = merge_rows(
            torch.cat([i.reshape(nl, -1) for i in idx_list], 1),
            torch.cat([v.reshape(nl, -1) for v in val_list], 1))
        k = mi.shape[-1]
        entries[path] = (mi.reshape(lead + (k,)), mv.reshape(lead + (k,)))
    return AdapterPack(name=name, entries=entries, alpha=1.0)
