"""Cross weights and adapters over from the JAX package through numpy.

``jax.random`` draws cannot be reproduced in torch, so a comparison of the
two packages runs both on the same numbers: the JAX tree or pack is turned
into numpy arrays (``jax.tree.map(np.asarray, tree)``) and handed to these
functions: a base, a LoRA / DoRA factor tree (``params_from_numpy``, for
``runtime.Trainer(trainable0=...)``), SHiRA indices, a pack, a hook-mode
state. Caches cross both ways: a JAX cache tree given as numpy becomes
the port's (``params_from_numpy`` maps each cache NamedTuple to the
port's of the same fields: ``KVCache``, ``MambaCache``, ``QuantKV``, a
hybrid stage's {"mamba", "attn"} dict of them as it stands), and
``tree_to_numpy`` gives any port tree back as numpy for the JAX package.
Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.adapters import AdapterPack
from repro_torch.core.masks import iter_leaves, map_leaves
from repro_torch.models.attention import KVCache
from repro_torch.models.mamba2 import MambaCache
from repro_torch.serving.kvcache import QuantKV

# the port's cache NamedTuples, by their fields
_CACHES = {t._fields: t for t in (KVCache, MambaCache, QuantKV)}


def params_from_numpy(tree, device="cuda"):
    """A nested dict/list/tuple of numpy arrays -> the same structure of
    torch tensors on ``device`` (f32 stays f32, int32 stays int32), None
    kept. The stacked (L, ...) layer leaves keep their leading dim. Any
    trainable tree crosses so too: the JAX package's LoRA, DoRA and
    SHiRA-DoRA factors ({"A", "B"[, "m"]} a target leaf, None elsewhere)
    are what ``Trainer(trainable0=...)`` takes, since their ``A`` draws
    (seeded by Python's per-process ``hash``) cannot be made again."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if hasattr(tree, "_fields"):        # a cache NamedTuple
        return _CACHES.get(tree._fields, type(tree))(
            *(params_from_numpy(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    if tree is None:
        return None
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def tree_to_numpy(tree):
    """A nested dict/list/tuple/NamedTuple of torch tensors -> the same
    structure of numpy arrays on the host (bf16 as f32, which numpy lacks;
    every other dtype kept), None kept: a port tree, caches included, for
    the JAX package (``jax.tree.map(jnp.asarray, ...)``)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_numpy(v) for v in tree)
    if tree is None:
        return None
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def pack_from_numpy(name: str, entries: Dict[str, Tuple[np.ndarray,
                                                        np.ndarray]],
                    alpha: float = 1.0, device="cuda") -> AdapterPack:
    """An ``AdapterPack`` from a JAX pack's entries given as numpy
    (path -> (flat indices (..., K), values (..., K)))."""
    return AdapterPack(
        name=name,
        entries={p: (params_from_numpy(i, device).to(torch.int32),
                     params_from_numpy(v, device).to(torch.float32))
                 for p, (i, v) in entries.items()},
        alpha=alpha)


def adapter_from_numpy(indices_tree, device="cuda"):
    """A SHiRA adapter's (zero values, aux) from the JAX package's packed
    indices given as numpy (``jax.tree.map(np.asarray, aux["indices"])``,
    None at leaves that are not targets): what ``core.init_adapter``
    returns, on the JAX draws. ``runtime.Trainer(aux=...)`` and
    ``training.MultiAdapterTrainer(auxes=...)`` take the aux, so both
    packages train the same entries."""
    idx = map_leaves(lambda _, i: i.to(torch.int32),
                     params_from_numpy(indices_tree, device))
    values = map_leaves(lambda _, i: torch.zeros(i.shape, dtype=torch.float32,
                                                 device=i.device), idx)
    return values, {"indices": idx}


def hook_state_from_numpy(state, masks, device="cuda") -> dict:
    """A JAX hook-mode ``Trainer`` state given as numpy ({"trainable",
    "mu", "nu", "step"}, whole trees) as the port's hook-mode state: the
    weights whole, the moments at the target leaves of ``masks`` only (the
    reference's are exactly 0 elsewhere), the step an int. The port's
    trainer then takes the same step from it as the JAX one."""
    targets = {p for p, _ in iter_leaves(masks)}
    moment = lambda t: map_leaves(
        lambda p, x: x if p in targets else None,
        params_from_numpy(t, device))
    return {"trainable": params_from_numpy(state["trainable"], device),
            "mu": moment(state["mu"]), "nu": moment(state["nu"]),
            "step": int(state["step"])}
