"""SHiRA adapters: init, the packed adapter (``AdapterPack``) and the rapid
switch that applies one to a deployed base.

Port of the SHiRA path of ``repro/core/adapters.py``. LoRA, DoRA,
``materialize`` and ``pack_from_delta`` wait (ROADMAP A2, A4).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import AdapterConfig
from repro_torch.core import masks as M
from repro_torch.kernels.ops import scatter_apply


def init_adapter(gen: torch.Generator, params, acfg: AdapterConfig):
    """(trainable, aux) for a SHiRA adapter: zero values (..., K) at every
    target leaf and {"indices": packed indices}; None elsewhere."""
    if acfg.kind != "shira":
        raise NotImplementedError(
            f"adapter kind {acfg.kind!r} is not ported (ROADMAP A2)")
    idx = M.make_packed_indices(params, acfg, gen)
    values = M.map_leaves(
        lambda _, i: torch.zeros(i.shape, dtype=torch.float32,
                                 device=i.device), idx)
    return values, {"indices": idx}


@dataclass
class AdapterPack:
    """Sparse weights + indices, per target path: entries[path] = (flat
    indices (..., K) int32, values (..., K) f32). Loading one overwrites
    only its 1-2% of entries. Indices are unique within each matrix, and
    ascending where the pack's builder sorts them (``rand`` masks,
    ``fuse_packs``); rows shorter than K are padded with index 0 and
    value 0."""

    name: str
    entries: Dict[str, Tuple[torch.Tensor, torch.Tensor]]
    alpha: float = 1.0

    def num_params(self) -> int:
        return int(sum(v.numel() for _, v in self.entries.values()))

    def nbytes(self) -> int:
        return int(sum(i.numel() * i.element_size()
                       + v.numel() * v.element_size()
                       for i, v in self.entries.values()))


def pack_from_shira(name: str, trainable, aux, alpha: float = 1.0
                    ) -> AdapterPack:
    vals = dict(M.iter_leaves(trainable))
    entries = {p: (i, vals[p]) for p, i in M.iter_leaves(aux["indices"])}
    return AdapterPack(name=name, entries=entries, alpha=alpha)


def apply_pack(params, pack: AdapterPack, alpha: Optional[float] = None,
               sign: float = 1.0):
    """W += sign * alpha * S at the pack's indices (load / unload).

    Unlike the reference, which returns a new tree, this updates the
    weights IN PLACE through the ``scatter_apply`` kernel (its plain version
    for CPU tensors) and returns the same tree: the full-width base does not
    fit on the card twice. Paths the tree lacks are ignored, as there."""
    a = (pack.alpha if alpha is None else alpha) * sign
    for path, w in M.iter_leaves(params):
        if path in pack.entries:
            idx, vals = pack.entries[path]
            scatter_apply(w, idx, vals.float(), alpha=a)
    return params
