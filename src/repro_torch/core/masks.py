"""SHiRA masks: the five strategies of the paper's section 3.1, in packed
and dense form, and the packed gather / scatter.

Port of ``repro/core/masks.py``. A mask selects the 1-2% of entries of each
*target* weight that are trainable, as packed flat indices (..., K) int32
over the trailing (n, m) dims, or (``make_dense_masks``, hook-mode
training) as a dense mask of the weight's shape. Leaves with more than two
dims (stacked layers) get an exact per-matrix budget K.

Strategies (``AdapterConfig.mask``):
  struct  evenly spaced rows + columns + the main diagonal (numpy, a copy
          of the reference's arithmetic)
  rand    K entries uniform without replacement, from a ``torch.Generator``
          (the reference draws from ``jax.random``: other entries)
  wm      top-K |W|
  grad    top-K |g| of a calibration gradient
  snip    top-K |W * g| (SNIP saliency)

Top-K keeps the reference's tie rule (``lax.top_k``: of equal scores the
lower index wins), so it selects the same set as the reference on the same
numbers. Each row of packed indices is ascending, where the reference lists
top-K indices by descending score: a switch (``scatter_apply``) walks W in
memory order, which the card serves much faster than random order
(PERF.md). Packs of the two packages compare as sets, not byte for byte.

The dense mask is bool, one byte an entry, where the reference's is f32:
the same 0/1 values in a quarter of the bytes.

Parameter trees are nested dicts and lists of tensors; a leaf's path is
its keys and list indices joined by "/", as ``repro.core.masks.path_str``
writes them (e.g. "stages/0/mlp/w_up").
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import AdapterConfig


def iter_leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator[
        Tuple[str, torch.Tensor]]:
    """(path, tensor) for every tensor leaf, in the tree's own order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from iter_leaves(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from iter_leaves(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def map_leaves(fn: Callable, tree, prefix: Tuple[str, ...] = ()):
    """Rebuild a tree with ``fn(path, leaf)`` at every tensor leaf."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v, prefix + (str(i),))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn("/".join(prefix), tree)


def leaf_name(path: str) -> str:
    return path.split("/")[-1]


def is_target(path: str, leaf, target_modules: Tuple[str, ...]) -> bool:
    return (isinstance(leaf, torch.Tensor) and leaf.ndim >= 2
            and leaf_name(path) in target_modules)


def map_targets(fn: Callable, params, target_modules: Tuple[str, ...]):
    """The tree with ``fn(path, leaf)`` at target leaves, None elsewhere."""
    return map_leaves(lambda p, x: fn(p, x)
                      if is_target(p, x, target_modules) else None, params)


def target_paths(params, target_modules) -> List[str]:
    return sorted(p for p, x in iter_leaves(params)
                  if is_target(p, x, target_modules))


def budget(n: int, m: int, sparsity: float) -> int:
    return max(1, int(round((1.0 - sparsity) * n * m)))


def _struct_indices(n: int, m: int, cfg: AdapterConfig) -> np.ndarray:
    """Evenly spaced rows + cols + main diagonal (the high-rank part),
    ascending: the reference's ``_struct_indices``, as numpy."""
    rows = np.unique(np.linspace(0, n - 1, max(cfg.struct_rows, 1))
                     .astype(np.int64))
    cols = np.unique(np.linspace(0, m - 1, max(cfg.struct_cols, 1))
                     .astype(np.int64))
    d = min(n, m)
    return np.unique(np.concatenate([
        (rows[:, None] * m + np.arange(m)[None]).reshape(-1),
        (cols[:, None] + m * np.arange(n)[None]).reshape(-1),
        np.arange(d) * m + np.arange(d)]))


def topk_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest of a 1-D score, as ascending int32 flat indices. Of
    equal scores at the k-th place the lower indices are taken, as
    ``lax.top_k`` takes them, so the set equals the reference's."""
    kth = torch.topk(score, k, sorted=False).values.min()
    sel = score > kth
    need = k - int(sel.sum())
    if need > 0:
        sel[torch.nonzero(score == kth).flatten()[:need]] = True
    return torch.nonzero(sel).flatten().to(torch.int32)


def _leaf_indices(w: torch.Tensor, g: Optional[torch.Tensor],
                  cfg: AdapterConfig, gen) -> torch.Tensor:
    *lead, n, m = w.shape
    nl = int(np.prod(lead))
    if cfg.mask == "struct":
        idx = torch.from_numpy(_struct_indices(n, m, cfg)).to(
            w.device, torch.int32)
        return idx.expand(tuple(lead) + idx.shape).contiguous()
    if cfg.mask not in ("rand", "wm", "grad", "snip"):
        raise ValueError(f"unknown mask strategy {cfg.mask!r}")
    if cfg.mask in ("grad", "snip") and g is None:
        raise ValueError(f"mask={cfg.mask!r} needs calibration grads")
    k = budget(n, m, cfg.sparsity)
    wf = w.reshape(nl, n * m)
    rows = []
    # one matrix at a time: a full-width w_up score is 85M entries
    for r in range(nl):
        if cfg.mask == "rand":
            rows.append(torch.randperm(n * m, generator=gen,
                                       device=w.device)[:k].sort().values
                        .to(torch.int32))
            continue
        if cfg.mask == "wm":
            score = wf[r].float().abs()
        else:
            gr = g.reshape(nl, n * m)[r].float()
            score = gr.abs() if cfg.mask == "grad" else (gr * wf[r].float()
                                                         ).abs()
        rows.append(topk_indices(score, k))
        del score
    return torch.stack(rows).reshape(tuple(lead) + (k,))


def make_packed_indices(params, cfg: AdapterConfig,
                        gen: Optional[torch.Generator] = None, grads=None):
    """Tree of packed indices: target leaves -> int32 (..., K) flat indices
    over the trailing (n, m), each row ascending; None elsewhere. ``rand``
    draws from ``gen`` (on the leaves' device); ``grad`` and ``snip`` score
    with ``grads``, a tree of calibration gradients aligned with
    ``params``, and raise ``ValueError`` without it, as the reference
    does."""
    g = dict(iter_leaves(grads)) if grads is not None else {}
    if cfg.mask == "rand" and gen is None:
        raise ValueError("mask='rand' draws from a torch.Generator")
    return map_leaves(
        lambda p, w: _leaf_indices(w, g.get(p), cfg, gen)
        if is_target(p, w, cfg.target_modules) else None, params)


def dense_mask_from_indices(w: torch.Tensor, idx: torch.Tensor
                            ) -> torch.Tensor:
    """(..., n, m) weight + (..., K) flat indices -> bool mask of w's
    shape (the reference's is f32 0/1)."""
    *lead, n, m = w.shape
    nl = int(np.prod(lead))
    mask = torch.zeros((nl, n * m), dtype=torch.bool, device=w.device)
    mask.scatter_(1, idx.reshape(nl, -1).long(), True)
    return mask.reshape(w.shape)


def make_dense_masks(params, cfg: AdapterConfig,
                     gen: Optional[torch.Generator] = None, grads=None):
    """Tree of bool masks of each target leaf's shape; None elsewhere."""
    idx = dict(iter_leaves(make_packed_indices(params, cfg, gen, grads)))
    return map_leaves(lambda p, w: dense_mask_from_indices(w, idx[p])
                      if p in idx else None, params)


def mask_grads(grads, masks, freeze_others: bool = True):
    """Hadamard gradient masking (paper Fig. 2(b), App. C): g * M at
    target leaves; ``freeze_others`` zeroes the other leaves' gradients,
    so only the masked 1-2% of the model trains (the packed mode's
    semantics)."""
    m = dict(iter_leaves(masks))
    return map_leaves(
        lambda p, g: g * m[p].to(g.dtype) if p in m
        else torch.zeros_like(g) if freeze_others else g, grads)


def mask_sparsity(masks) -> Dict[str, float]:
    """path -> the fraction of entries the mask keeps."""
    return {p: int(torch.count_nonzero(m)) / m.numel()
            for p, m in iter_leaves(masks)}


def gather_packed(w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """w (..., n, m), idx (..., K) -> values (..., K)."""
    *lead, n, m = w.shape
    wf = w.reshape(-1, n * m)
    idxf = idx.reshape(wf.shape[0], -1).long()
    return torch.gather(wf, 1, idxf).reshape(idx.shape)


def scatter_packed_add(w: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                       alpha: float = 1.0) -> torch.Tensor:
    """w (..., n, m) + alpha * scatter(val at idx), as a new tensor: the
    plain functional form. The switch path goes through the in-place
    ``scatter_apply`` kernel instead (``core.adapters.apply_pack``)."""
    *lead, n, m = w.shape
    wf = w.reshape(-1, n * m).clone()
    idxf = idx.reshape(wf.shape[0], -1).long()
    vf = val.reshape(wf.shape[0], -1).to(w.dtype) * alpha
    wf.scatter_add_(1, idxf, vf)
    return wf.reshape(w.shape)


def scatter_packed_set(w: torch.Tensor, idx: torch.Tensor,
                       val: torch.Tensor) -> torch.Tensor:
    """w (..., n, m) with val written at idx, as a new tensor."""
    *lead, n, m = w.shape
    wf = w.reshape(-1, n * m).clone()
    idxf = idx.reshape(wf.shape[0], -1).long()
    wf.scatter_(1, idxf, val.reshape(wf.shape[0], -1).to(w.dtype))
    return wf.reshape(w.shape)
