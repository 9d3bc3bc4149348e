"""Step functions on one rank or over a mesh, and abstract inputs for the
dry run.

Port of ``repro/launch/steps.py``. Each (arch x shape) cell runs one of:
  train_*   -> make_train_step / make_shira_train_step
  prefill_* -> make_prefill_step   (encoder archs: make_encode_step)
  decode_*  -> make_decode_step    (one token against a full cache)

Where the reference hands shardings to ``jit`` and lets GSPMD insert the
collectives, a port step given a ``mesh`` runs on this rank's shards
(``launch.sharding.local_shard``) with the hints that make the model's
TP/FSDP forward and expert-parallel dispatch issue them
(``sharding_hints_for``), then:
  * the gradients are meaned over the dp axes: summed over each dp axis
    the leaf is not sharded on (an FSDP leaf's reduce-scatter has already
    summed over ``data``), divided by the dp size; for packed SHiRA that
    is the packed values only;
  * the global gradient norm (the clip) sums each leaf's squared norm
    once: sharded leaves all-reduced over the axes they are sharded on,
    replicated leaves counted once;
  * AdamW is ``optim.adamw_update``, as the reference's steps use
    ``adamw_update``.
Every family has the TP forward: dense GQA, MoE with GQA or MLA
attention, Mamba2, the hybrid, and the vision and audio families. Where
the cache spec shards the KV *sequence* (KV heads that do not divide
``model``, or a batch below the dp size: ``sharding.kv_cache_spec``), the
serving steps install the "kv_seq" hint: each rank's cache holds its rows
of the sequence, and decode merges the ranks' softmaxes
(``models.attention``; an MLA cache's latent rows too). A Mamba2 state
has no sequence: a batch below the dp size is served whole on every
data rank.

``abstract_*`` build "meta" tensors of the global shapes (no data, no
memory); ``local_meta`` cuts them to a rank's shard shapes, so the dry run
runs rank 0's step on the meta device over an abstract mesh.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import (AdapterConfig, ModelConfig, ShapeSpec,
                                      TrainConfig)
from repro_torch.core import adapters as A
from repro_torch.core.masks import budget, is_target, iter_leaves, map_leaves
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as shd
from repro_torch.launch.actctx import sharding_hints
from repro_torch.launch.mesh import axis_size, dp_axes
from repro_torch.launch.sharding import P
from repro_torch.models import lm
from repro_torch.models.layers import cast_compute
from repro_torch.optim.adamw import AdamWState, adamw_update, lr_schedule

# ---------------------------------------------------------------------------
# Hints, gradient sync, the sharded norm
# ---------------------------------------------------------------------------

def _dp_size(mesh) -> int:
    return math.prod(axis_size(mesh, a) for a in dp_axes(mesh))


def _batch_axes(shape: Optional[ShapeSpec], mesh):
    if shape is None:
        return dp_axes(mesh)
    dp = _dp_size(mesh)
    return dp_axes(mesh) if (shape.global_batch % dp == 0
                             and shape.global_batch >= dp) else None


def act_spec_for(cfg: ModelConfig, shape: ShapeSpec, mesh) -> P:
    return P(_batch_axes(shape, mesh), None, "model")


def sharding_hints_for(cfg: ModelConfig, shape: Optional[ShapeSpec], mesh
                       ) -> dict:
    """All hints for one cell (``launch.actctx``): the reference's "act"
    and "loss_act" specs, "tp" (the mesh and the leaf specs), and
    "moe_ep_mesh" where the expert count divides ``model``."""
    b = _batch_axes(shape, mesh)
    hints: Dict[str, Any] = {"act": P(b, None, "model"),
                             "loss_act": P(b, None),
                             "tp": shd.TPLayout(cfg, mesh)}
    if cfg.moe and cfg.moe.num_experts % axis_size(mesh, "model") == 0:
        hints["moe_ep_mesh"] = (mesh, axis_size(mesh, "model"))
    return hints


def sync_grads(grads: Dict[str, torch.Tensor], specs: Dict[str, P], mesh
               ) -> Dict[str, torch.Tensor]:
    """The dp mean of each gradient: summed over each dp axis its spec
    does not shard it on, then divided by the dp size."""
    dp, n = dp_axes(mesh), _dp_size(mesh)
    out = {}
    for p, g in grads.items():
        axes = tuple(a for a in dp if a not in specs[p].axes())
        g = M.all_reduce(mesh, g, axes, "sum")
        out[p] = g / n if n > 1 else g
    return out


def sharded_global_norm(grads: Dict[str, torch.Tensor], specs: Dict[str, P],
                        mesh) -> torch.Tensor:
    """sqrt of the sum of every leaf's squared norm, each leaf once: the
    local squares of the leaves sharded on the same axes summed, then
    all-reduced over those axes; replicated leaves are not summed over
    ranks."""
    groups: Dict[tuple, list] = {}
    for p, g in grads.items():
        ax = tuple(a for a in specs[p].axes() if axis_size(mesh, a) > 1)
        groups.setdefault(ax, []).append(torch.sum(torch.square(g.float())))
    total = None
    for ax, sq in groups.items():
        s = M.all_reduce(mesh, torch.stack(sq).sum(), ax, "sum")
        total = s if total is None else total + s
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


def _value_and_grad(loss_of, trainable, batch, n_micro: int = 1):
    """(mean loss, {path: f32 grad}, mean "ce" and "aux") of ``loss_of(tree,
    batch)`` over the trainable tree's tensor leaves, accumulated over
    ``n_micro`` contiguous slices of the batch (the reference's scan). A
    tree with no tensor leaf (a pack that adapts no leaf) gives no
    gradient, and its loss is computed without autograd; a leaf the loss
    does not read gets a zero gradient."""
    leaves = [(p, t.detach().requires_grad_(True))
              for p, t in iter_leaves(trainable)]
    live = dict(leaves)
    tree = map_leaves(lambda p, _: live[p], trainable)
    xs = [t for _, t in leaves]
    if n_micro == 1:
        micro = [batch]
    else:
        micro = [{k: v.reshape((n_micro, v.shape[0] // n_micro)
                               + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()} for i in range(n_micro)]
    sums, acc = None, None
    for mb in micro:
        with torch.set_grad_enabled(bool(xs)):
            loss, m = loss_of(tree, mb)
        gs = torch.autograd.grad(loss, xs, allow_unused=True) if xs else []
        # a leaf the loss never reads (an audio model's token embedding)
        # gets a zero gradient, as autodiff in the reference gives it
        gs = [torch.zeros(x.shape, device=x.device) if g is None
              else g.float() for g, x in zip(gs, xs)]
        acc = gs if acc is None else [a + g for a, g in zip(acc, gs)]
        vals = [loss.detach(), m["ce"].detach(), m["aux"].detach()]
        sums = vals if sums is None else [a + v for a, v in zip(sums, vals)]
    if n_micro > 1:
        acc = [g / n_micro for g in acc]
        sums = [v / n_micro for v in sums]
    return sums[0], {p: g for (p, _), g in zip(leaves, acc)}, {
        "ce": sums[1], "aux": sums[2]}


def _finish(state, grads, specs, mesh, tcfg, lr, loss, parts):
    """Sync, clip and step: the new state and the metrics (the loss, its
    cross-entropy and MoE aux terms, meaned over the dp ranks)."""
    gnorm = None
    if mesh is not None:
        grads = sync_grads(grads, specs, mesh)
        gnorm = sharded_global_norm(grads, specs, mesh)
        loss, ce, aux = M.all_reduce(
            mesh, torch.stack([loss, parts["ce"], parts["aux"]]),
            dp_axes(mesh), "mean").unbind()
        parts = {"ce": ce, "aux": aux}
    tree = map_leaves(lambda p, _: grads[p], state["trainable"])
    new_t, opt, om = adamw_update(
        tree, AdamWState(state["step"], state["mu"], state["nu"]),
        state["trainable"], tcfg, lr, gnorm=gnorm)
    return ({"trainable": new_t, "mu": opt.mu, "nu": opt.nu,
             "step": opt.step},
            {"loss": loss, "grad_norm": om["grad_norm"], **parts})


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                    pspecs=None) -> Callable:
    """Full-finetune step: ``train_step(state, batch) -> (state,
    metrics)``; ``tcfg.microbatch`` > 1 accumulates the gradient over that
    many slices of the batch. With ``mesh``, ``state`` holds this rank's
    shards of the leaves ``pspecs`` (``param_specs`` of the global tree)
    lays out and ``batch`` its dp shard."""
    schedule = lr_schedule(tcfg)
    n_micro = max(tcfg.microbatch, 1)
    specs = dict(iter_leaves(pspecs)) if mesh is not None else {}
    hints = {} if mesh is None else sharding_hints_for(cfg, None, mesh)

    def loss_of(params, batch):
        return lm.train_loss(cast_compute(params), cfg, batch)

    def train_step(state, batch):
        lr = schedule(state["step"])
        with sharding_hints(**hints):
            loss, grads, parts = _value_and_grad(loss_of, state["trainable"],
                                                 batch, n_micro)
        return _finish(state, grads, specs, mesh, tcfg, lr, loss, parts)

    return train_step


def value_specs(pspecs, indices) -> Dict[str, P]:
    """The spec of each packed leaf of the shard-local values, (..., DPC,
    TPC, Ks): its weight's entries (the leading dims', then n's and m's),
    then None."""
    w = dict(iter_leaves(pspecs))
    out = {}
    for p, i in iter_leaves(indices):
        s = list(w[p]) + [None] * (i.ndim - 1 - len(w[p]))
        out[p] = P(*s, None)
    return out


def make_shira_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                          acfg: AdapterConfig, mesh=None,
                          pspecs=None) -> Callable:
    """Packed-SHiRA step: ``train_step(state, batch, base, indices)``, the
    trainable leaves the packed values, the base frozen.

    Without a mesh the indices are (..., K) per target leaf
    (``core.adapters.materialize``). With ``mesh`` they are shard-local,
    (..., DPC, TPC, Ks) globally, this rank holding its (..., 1, 1, Ks)
    (``core.adapters.materialize_sharded``, ``split_packed``), and
    ``base`` holds this rank's shards of the leaves ``pspecs`` lays out:
    the scatter is local and the only gradient traffic left is the packed
    values' dp mean. Padding entries of a split (index 0 past the first
    place) keep a zero gradient, so they stay 0. ``tcfg.microbatch`` > 1
    accumulates over slices of the batch as ``make_train_step`` does (the
    reference's packed step has no microbatching): on one rank, slices
    equal to a mesh's data shards give the mesh's objective, each shard's
    MoE aux its own."""
    schedule = lr_schedule(tcfg)
    n_micro = max(tcfg.microbatch, 1)
    hints = {} if mesh is None else sharding_hints_for(cfg, None, mesh)

    def train_step(state, batch, base, indices):
        lr = schedule(state["step"])

        def loss_of(values, b):
            if mesh is not None:
                eff = A.materialize_sharded(base, values, indices,
                                            alpha=1.0)
            else:
                eff = A.materialize(base, values, {"indices": indices},
                                    acfg, alpha=1.0)
            return lm.train_loss(eff, cfg, b)

        with sharding_hints(**hints):
            loss, grads, parts = _value_and_grad(loss_of, state["trainable"],
                                                 batch, n_micro)
        specs = {}
        if mesh is not None:
            idx = dict(iter_leaves(indices))
            grads = {p: g.masked_fill(A.padding_mask(idx[p]), 0.0)
                     for p, g in grads.items()}
            specs = value_specs(pspecs, indices)
        return _finish(state, grads, specs, mesh, tcfg, lr, loss, parts)

    return train_step


def _serve_hints(cfg: ModelConfig, mesh, shape: Optional[ShapeSpec],
                 cache: bool = True) -> dict:
    if mesh is None:
        return {}
    scfg = cfg.replace(fsdp=False)
    hints = sharding_hints_for(scfg, shape, mesh)
    if cache:
        shape = shape or ShapeSpec("step", 1, _dp_size(mesh), "decode")
        seq = shd.SeqLayout(mesh, shd.kv_seq_axes(
            scfg, shd.cache_specs(scfg, shape, mesh)))
        if seq.n > 1:
            hints["kv_seq"] = seq
    return hints


def make_prefill_step(cfg: ModelConfig, cache_size: int, mesh=None,
                      shape: Optional[ShapeSpec] = None) -> Callable:
    """``prefill_step(params, batch) -> (last logits, caches)``. With
    ``mesh``: this rank's serving shards (``serve_param_shardings``) and
    batch shard (the whole batch where ``shape``'s is below the dp size);
    the cache holds the rank's shard of it as ``kv_cache_spec`` lays it
    out, by KV heads or by sequence (``cache_size`` rows over the
    sequence's ranks)."""
    hints = _serve_hints(cfg, mesh, shape)

    def prefill_step(params, batch):
        with sharding_hints(**hints), torch.no_grad():
            return lm.prefill(params, cfg, batch, cache_size)
    return prefill_step


def make_encode_step(cfg: ModelConfig, mesh=None,
                     shape: Optional[ShapeSpec] = None) -> Callable:
    hints = _serve_hints(cfg, mesh, shape, cache=False)

    def encode_step(params, batch):
        with sharding_hints(**hints), torch.no_grad():
            return lm.encode(params, cfg, batch)
    return encode_step


def make_decode_step(cfg: ModelConfig, mesh=None,
                     shape: Optional[ShapeSpec] = None) -> Callable:
    """``decode_step(params, caches, tokens, pos) -> (logits, caches)``,
    the caches written in place; with ``mesh`` as ``make_prefill_step``."""
    hints = _serve_hints(cfg, mesh, shape)

    def decode_step(params, caches, tokens, pos):
        with sharding_hints(**hints), torch.no_grad():
            return lm.decode_step(params, cfg, tokens, caches, pos)
    return decode_step


# ---------------------------------------------------------------------------
# Abstract values ("meta" tensors) and spec trees
# ---------------------------------------------------------------------------

def _dtype_of(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def abstract_params(cfg: ModelConfig, dtype=torch.float32):
    p = lm.init_params(cfg, 0, device="meta")
    dt = _dtype_of(dtype)
    if dt != torch.float32:
        p = map_leaves(lambda _, t: t.to(dt), p)
    return p


def abstract_train_state(cfg: ModelConfig):
    p = abstract_params(cfg)
    return {"trainable": p, "mu": p, "nu": p, "step": 0}


def abstract_batch(cfg: ModelConfig, shape: ShapeSpec,
                   with_labels: bool = True) -> Dict[str, torch.Tensor]:
    n, s = shape.global_batch, shape.seq_len
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    out: Dict[str, torch.Tensor] = {}
    if cfg.modality == "audio":
        out["frame_embeds"] = meta((n, s, cfg.d_model), torch.float32)
    elif cfg.modality == "vision":
        p = cfg.num_prefix_embeds
        out["tokens"] = meta((n, s - p), torch.int32)
        out["patch_embeds"] = meta((n, p, cfg.d_model), torch.float32)
    else:
        out["tokens"] = meta((n, s), torch.int32)
    if with_labels:
        lbl_s = s - cfg.num_prefix_embeds if cfg.modality == "vision" else s
        out["labels"] = meta((n, lbl_s), torch.int32)
    return out


def abstract_cache(cfg: ModelConfig, bsz: int, cache_size: int):
    return lm.init_cache(cfg, bsz, cache_size, device="meta")


def abstract_shira(cfg: ModelConfig, acfg: AdapterConfig):
    """Abstract (values, indices) trees of the packed-SHiRA step: (...,
    K) per target leaf."""
    p = abstract_params(cfg)

    def per_leaf(path, leaf):
        if not is_target(path, leaf, acfg.target_modules):
            return None
        *lead, n, m = leaf.shape
        return torch.empty(tuple(lead) + (budget(n, m, acfg.sparsity),),
                           dtype=torch.int32, device="meta")

    idx = map_leaves(per_leaf, p)
    values = map_leaves(lambda _, i: torch.empty(i.shape, device="meta"),
                        idx)
    return values, idx


def abstract_shira_sharded(cfg: ModelConfig, acfg: AdapterConfig, mesh):
    """Shard-local packed adapter: (L, DPC, TPC, Ks) per 3-D target leaf,
    Ks the budget of one (n/DPC, m/TPC) tile. Returns (values, indices,
    pspecs, value specs)."""
    p = abstract_params(cfg)
    pspecs = shd.param_specs(p, cfg, mesh)
    specs = dict(iter_leaves(pspecs))

    def per_leaf(path, leaf):
        if not is_target(path, leaf, acfg.target_modules) or leaf.ndim != 3:
            return None
        L, n, m = leaf.shape
        dpc, tpc = shd.tile_counts(specs[path], 3, mesh)
        ks = budget(n // dpc, m // tpc, acfg.sparsity)
        return torch.empty((L, dpc, tpc, ks), dtype=torch.int32,
                           device="meta")

    idx = map_leaves(per_leaf, p)
    values = map_leaves(lambda _, i: torch.empty(i.shape, device="meta"),
                        idx)
    return values, idx, pspecs, value_specs(pspecs, idx)


def local_meta(tree, spec_tree, mesh):
    """The "meta" shards of a rank: each leaf at ``local_shape``."""
    return shd._tree_map(
        lambda _, t, s: torch.empty(shd.local_shape(tuple(t.shape), s, mesh),
                                    dtype=t.dtype, device="meta"),
        tree, spec_tree)


def train_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """(state specs, batch specs) of a train cell."""
    p = abstract_params(cfg)
    pspec = shd.param_specs(p, cfg, mesh)
    state_spec = {"trainable": pspec, "mu": pspec, "nu": pspec, "step": P()}
    bspec = shd.sanitize_tree(shd.batch_spec(cfg, shape, mesh),
                              abstract_batch(cfg, shape), mesh)
    return state_spec, bspec


def serve_param_shardings(cfg: ModelConfig, mesh):
    """No FSDP at serving time: weights replicated over data, TP over
    model."""
    serve_cfg = cfg.replace(fsdp=False)
    p = abstract_params(serve_cfg, dtype=torch.bfloat16)
    return shd.param_specs(p, serve_cfg, mesh)


def decode_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """(param specs, cache specs, token spec) of a decode cell."""
    pspec = serve_param_shardings(cfg, mesh)
    cshape = abstract_cache(cfg, shape.global_batch, shape.seq_len)
    cspec = shd.sanitize_tree(shd.cache_specs(cfg, shape, mesh), cshape,
                              mesh)
    b_ax, _ = shd.cache_batch_axes(cfg, shape, mesh)
    tok = shd.sanitize_spec(P(b_ax, None), (shape.global_batch, 1), mesh)
    return pspec, cspec, tok
