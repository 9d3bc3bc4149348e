"""SHiRA adapters: init, the packed adapter (``AdapterPack``), the rapid
switch that applies one to a deployed base, ``materialize``, the effective
weights of packed training, and ``pack_from_delta``, the export of
hook-mode training.

Port of the SHiRA paths of ``repro/core/adapters.py``, every mask
strategy. LoRA, DoRA and SHiRA-masked DoRA wait (ROADMAP A2).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import AdapterConfig
from repro_torch.core import masks as M
from repro_torch.kernels.ops import scatter_apply

SHIRA_KEY = "shira.base"


def init_adapter(gen: Optional[torch.Generator], params,
                 acfg: AdapterConfig, calib_grads=None):
    """(trainable, aux) for a SHiRA adapter: zero values (..., K) at every
    target leaf and {"indices": packed indices}; None elsewhere. ``gen``
    draws ``rand`` masks; ``calib_grads`` (a tree aligned with ``params``)
    scores ``grad`` and ``snip`` masks."""
    if acfg.kind != "shira":
        raise NotImplementedError(
            f"adapter kind {acfg.kind!r} is not ported (ROADMAP A2)")
    idx = M.make_packed_indices(params, acfg, gen, calib_grads)
    values = M.map_leaves(
        lambda _, i: torch.zeros(i.shape, dtype=torch.float32,
                                 device=i.device), idx)
    return values, {"indices": idx}


@dataclass
class AdapterPack:
    """Sparse weights + indices, per target path: entries[path] = (flat
    indices (..., K) int32, values (..., K) f32). Loading one overwrites
    only its 1-2% of entries. Indices are unique within each matrix, and
    ascending where the pack's builder sorts them (every mask of the
    port, ``pack_from_delta``, ``fuse_packs``); rows shorter than K are
    padded with index 0 and value 0."""

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


def pack_from_delta(name: str, base, tuned, acfg: AdapterConfig,
                    alpha: float = 1.0) -> AdapterPack:
    """S = W_new - W at its K largest magnitudes per matrix (K = the mask
    budget; paper App. G): the export of hook-mode training, whose weights
    were updated in place. Indices ascend within each matrix; of equal
    magnitudes the lower index is kept, as the reference's ``lax.top_k``
    keeps it. Where fewer than K entries moved, the rest are entries with
    delta 0, whichever the tie rule picks."""
    old = dict(M.iter_leaves(base))
    entries = {}
    for path, w_new in M.iter_leaves(tuned):
        if not M.is_target(path, w_new, acfg.target_modules):
            continue
        *lead, n, m = w_new.shape
        k = M.budget(n, m, acfg.sparsity)
        df = w_new.float().reshape(-1, n * m)
        bf = old[path].float().reshape(-1, n * m)
        idx, val = [], []
        for r in range(df.shape[0]):    # one matrix's delta alive at a time
            d = df[r] - bf[r]
            i = M.topk_indices(d.abs(), k)
            idx.append(i)
            val.append(d[i.long()])
            del d
        entries[path] = (torch.stack(idx).reshape(tuple(lead) + (k,)),
                         torch.stack(val).reshape(tuple(lead) + (k,)))
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


# ---------------------------------------------------------------------------
# materialize: W_eff = W + alpha * scatter(values), for packed training
# ---------------------------------------------------------------------------

class _Materialize(torch.autograd.Function):
    """One matrix: the forward clones w and adds alpha * values at idx in
    place through the ``scatter_apply`` kernel; the backward gathers the
    dense gradient at idx (what autodiff of the reference's scatter
    computes)."""

    @staticmethod
    def forward(ctx, w, idx, vals, alpha):
        ctx.save_for_backward(idx)
        ctx.alpha = alpha
        return scatter_apply(w.detach().clone(), idx, vals.detach().float(),
                             alpha=alpha)

    @staticmethod
    def backward(ctx, dw):
        (idx,) = ctx.saved_tensors
        dvals = M.gather_packed(dw.float(), idx)
        return None, None, dvals * ctx.alpha, None


def shira_weight(base: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                 alpha: float) -> dict:
    """A weight leaf as a lazy SHiRA bundle: ``models.layers.pdot``
    materializes it per call (``materialize_leaf``). Every tensor carries
    the leaf's leading layer dims, so slicing a stacked layer slices it."""
    return {SHIRA_KEY: base, "shira.idx": idx, "shira.vals": vals,
            "shira.alpha": float(alpha)}


def materialize_leaf(w: dict) -> torch.Tensor:
    """The effective (n, m) matrix of one layer's SHiRA bundle, f32,
    differentiable in the values."""
    return _Materialize.apply(w[SHIRA_KEY], w["shira.idx"], w["shira.vals"],
                              w["shira.alpha"])


def materialize(params, trainable, aux, acfg: AdapterConfig,
                alpha: Optional[float] = None):
    """The effective parameter tree for forward passes: W + alpha * S at
    every target leaf (alpha defaults to ``acfg.alpha``).

    Unlike the reference, which builds the whole effective tree, the
    target leaves become lazy ``shira_weight`` bundles: each matrix is
    materialized where a layer uses it, so inside ``lm.train_loss``'s
    checkpointed layers only one layer's effective weights are alive. At
    starcoder2-7b's full width the six adapted leaves hold 6.94 B entries;
    an effective copy of them all, and its dense gradient, would not fit
    beside the base on one 80 GB card."""
    if acfg.kind != "shira":
        raise NotImplementedError(
            f"materialize is ported for SHiRA, not kind={acfg.kind!r} "
            "(ROADMAP A2)")
    if trainable is None:
        return params
    a = acfg.alpha if alpha is None else alpha
    vals = dict(M.iter_leaves(trainable))
    idx = dict(M.iter_leaves(aux["indices"]))
    return M.map_leaves(
        lambda p, w: shira_weight(w, idx[p], vals[p], a) if p in idx else w,
        params)
