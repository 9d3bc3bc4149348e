"""SHiRA masks in packed form, and the packed gather / scatter.

Port of the ``rand`` strategy and the packed helpers of
``repro/core/masks.py``. A mask selects the 1-2% of entries of each
*target* weight that are trainable, stored as packed flat indices
(..., K) int32 over the trailing (n, m) dims; leaves with more than two
dims (stacked layers) get an exact per-matrix budget K. The ``struct``,
``wm``, ``grad`` and ``snip`` strategies wait (ROADMAP A2): their
``lax.top_k`` tie order has no exact torch counterpart.

Parameter trees are nested dicts and lists of tensors; a leaf's path is
its keys and list indices joined by "/", as ``repro.core.masks.path_str``
writes them (e.g. "stages/0/mlp/w_up").
"""
from __future__ import annotations

from typing import Callable, Iterator, Tuple

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


def budget(n: int, m: int, sparsity: float) -> int:
    return max(1, int(round((1.0 - sparsity) * n * m)))


def make_packed_indices(params, cfg: AdapterConfig, gen: torch.Generator):
    """Tree of packed indices: target leaves -> int32 (..., K) flat indices
    over the trailing (n, m), drawn uniformly without replacement per
    matrix from ``gen`` (on the leaves' device); None elsewhere. Each row
    is ascending, so a switch (``scatter_apply``) walks W in memory order,
    which the card serves much faster than random order (PERF.md)."""
    if cfg.mask != "rand":
        raise NotImplementedError(
            f"mask {cfg.mask!r} is not ported (ROADMAP A2); use 'rand'")

    def per_leaf(path, w):
        if not is_target(path, w, cfg.target_modules):
            return None
        *lead, n, m = w.shape
        k = budget(n, m, cfg.sparsity)
        nl = 1
        for d in lead:
            nl *= d
        idx = torch.stack([
            torch.randperm(n * m, generator=gen, device=w.device)[:k]
            .sort().values for _ in range(nl)]).to(torch.int32)
        return idx.reshape(tuple(lead) + (k,))

    return map_leaves(per_leaf, params)


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
