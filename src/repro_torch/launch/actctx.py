"""Sharding hints the launch layer hands the model.

Port of ``repro/launch/actctx.py``. The model code is mesh-agnostic; a
step builder installs hints here before it runs the model. The hints the
port's model reads:

  "tp"           a ``launch.sharding.TPLayout``: the mesh and the leaf
                 specs. With it set, every family runs its TP/FSDP
                 forward on local shards (``models.layers``,
                 ``attention``, ``mamba2``, ``blocks``, ``moe``, ``lm``).
  "moe_ep_mesh"  (mesh, ep): expert-parallel MoE dispatch over the
                 ``model`` axis (``models.moe._moe_ffn_ep``) when the
                 expert count divides ep.
  "kv_seq"       a ``launch.sharding.SeqLayout``: the serving caches hold
                 this rank's shard of the KV sequence (KV heads that do
                 not divide ``model``, or a batch below the dp size);
                 ``models.attention``'s prefill writes the rank's rows and
                 its decode merges the ranks' softmaxes.

The reference's "act" and "loss_act" hints are installed too
(``launch.steps.sharding_hints_for``) and read by nothing: they constrain
GSPMD's layout, and the port lays its shards out itself.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

_SPECS: Dict[str, object] = {}


def set_sharding(name: str, sharding) -> None:
    if sharding is None:
        _SPECS.pop(name, None)
    else:
        _SPECS[name] = sharding


def hint(name: str) -> Optional[object]:
    """The installed hint ``name``, or None."""
    return _SPECS.get(name)


@contextlib.contextmanager
def sharding_hints(**kw):
    prev = dict(_SPECS)
    for k, v in kw.items():
        set_sharding(k, v)
    try:
        yield
    finally:
        _SPECS.clear()
        _SPECS.update(prev)


@contextlib.contextmanager
def act_sharding(sharding, **kw):
    with sharding_hints(act=sharding, **kw):
        yield


def shard_as(x, name: str):
    """The identity. The reference constrains ``x`` to the hint's sharding
    for GSPMD; the port's tensors are already the local shards its
    collectives lay out, so there is nothing to constrain."""
    return x


def shard_act(x):
    """The identity, as ``shard_as``: the residual stream of a TP rank is
    its whole (local batch, seq, d_model) activation."""
    return x
