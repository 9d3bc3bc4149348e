"""The trainer: SHiRA finetuning of one adapter, packed (the paper's
App. D) or hook mode (App. C).

Port of ``repro/runtime/trainer.py`` for SHiRA, every mask strategy.

Packed (``adapter.packed``): the trainable tree is the (..., K) packed
values of every target leaf; the forward runs the base through
``core.adapters.materialize`` (each layer's effective weights made inside
its checkpoint, through the ``scatter_apply`` kernel); the update clips the
gradients by their global norm and launches the fused ``sparse_adamw``
kernel once per leaf.

Hook mode (``packed=False``): the trainable tree is the model's weights,
the target leaves copied from the base (which is kept, for the export) and
updated in place; a dense bool mask per target leaf. A step takes dense
f32 gradients of the target leaves only, masks and clips them, runs the
reference's dense AdamW direction (``optim.adamw_direction_``) with dense
moments, and launches the ``masked_update`` kernel once per target leaf:
W + (-lr) * (M ⊙ U). With weight decay 0 (the default) the reference's
gradients, moments and direction are exactly 0 off the mask and at every
other leaf, so this is its update, bit for bit: it keeps no state for the
other leaves. With weight decay the reference decays every weight, masked
or not, and its adapter is no longer sparse: hook mode raises for it.
``export_pack`` runs ``core.pack_from_delta``; ``publish`` pushes the
exported pack into an ``AdapterStore`` as its next version.

On CPU tensors the kernel wrappers compute their plain versions. LoRA,
DoRA and full finetuning wait (ROADMAP A2); so do checkpointing,
preemption recovery and the straggler monitor (A8): their options raise.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from repro_torch import core
from repro_torch.analysis import trace
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.masks import is_target, iter_leaves, map_leaves
from repro_torch.data import batch_iterator
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.optim import (adamw_direction_, adamw_init, global_norm,
                               lr_schedule)
from repro_torch.optim.adamw import clip_scale


@dataclass
class TrainerConfig:
    """The reference's host-loop settings that the port reads; its
    checkpoint cadence and retention wait with ``ckpt_dir`` (A8)."""
    ckpt_dir: Optional[str] = None
    log_every: int = 10


def check_packed_shira(run: RunConfig) -> None:
    a = run.adapter
    if a.kind != "shira" or not a.packed:
        raise NotImplementedError(
            f"the port trains packed SHiRA only, not kind={a.kind!r} "
            f"packed={a.packed} (ROADMAP A2)")


def check_shira(run: RunConfig) -> None:
    a = run.adapter
    if a.kind != "shira":
        raise NotImplementedError(
            f"the port trains SHiRA, not kind={a.kind!r} (ROADMAP A2)")
    if not a.packed and run.train.weight_decay:
        raise NotImplementedError(
            "hook-mode SHiRA with weight_decay > 0: the reference decays "
            "every weight, masked or not, so its adapter is no longer "
            "sparse and masked_update cannot express it (ROADMAP A2)")


def dense_grads(params, cfg: ModelConfig, batch: dict,
                target_modules) -> tuple:
    """(loss, metrics, gradients) of ``lm.train_loss`` on a device batch,
    with dense f32 gradients of the target leaves only ({path: tensor of
    the leaf's shape}); the other leaves get none. Each layer of a stacked
    (L, n, m) leaf is differentiated as a leaf of its own whose ``.grad``
    is preset to that layer of one f32 buffer, into which autograd
    accumulates in place: no stacked gradient is built per layer. These
    are also the calibration gradients of the ``grad`` and ``snip``
    masks."""
    grads = {}

    def leaf(path, w):
        if not is_target(path, w, target_modules):
            return w
        g = grads[path] = torch.zeros(w.shape, dtype=torch.float32,
                                      device=w.device)
        pairs = [(w, g)] if w.ndim == 2 else list(zip(w, g))
        views = []
        for x, gl in pairs:
            views.append(x.detach().requires_grad_(True))
            views[-1].grad = gl
        return views[0] if w.ndim == 2 else lm.LayerList(views)

    tree = map_leaves(leaf, params)
    loss, metrics = lm.train_loss(tree, cfg, batch)
    loss.backward()
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def device_batch(batch, device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``: tokens and labels int64 (for
    indexing), everything else as it is."""
    return {k: torch.from_numpy(v).to(device, torch.int64)
            if k in ("tokens", "labels") else torch.from_numpy(v).to(device)
            for k, v in batch.items()}


class Trainer:
    """SHiRA finetuning of one adapter, packed or hook mode.

    The base comes from ``lm.init_params(cfg, seed=init_key)`` unless
    ``base_params`` is given; the mask from ``core.init_adapter`` (packed)
    or ``core.make_dense_masks`` (hook mode) over the base, with a
    generator seeded with ``init_key`` on the base's device for ``rand``
    masks and ``calib_grads`` (a tree of the target leaves' gradients,
    ``dense_grads``) for ``grad`` and ``snip``. ``aux`` ({"indices":
    tree}, packed) is the hook of ``bridge``, which carries the JAX
    package's indices across: its ``jax.random`` draws cannot be made in
    torch. The base is never written."""

    def __init__(self, run: RunConfig, tcfg: TrainerConfig = TrainerConfig(),
                 init_key: int = 0, base_params=None, aux=None,
                 calib_grads=None, device="cuda"):
        check_shira(run)
        if tcfg.ckpt_dir is not None:
            raise NotImplementedError("checkpointing waits (ROADMAP A8)")
        self.run, self.tcfg = run, tcfg
        self.cfg, self.acfg = run.model, run.adapter
        self.hook_mode = not self.acfg.packed
        self.base = (base_params if base_params is not None
                     else lm.init_params(self.cfg, seed=init_key,
                                         device=device))
        self.device = next(iter(self.base["embed"].values())).device
        gen = torch.Generator(device=self.device)
        gen.manual_seed(init_key)
        t0 = time.perf_counter()
        self.aux = self.masks = None
        if self.hook_mode:
            self.masks = core.make_dense_masks(self.base, self.acfg, gen,
                                               calib_grads)
        else:
            self.aux = (aux if aux is not None else core.init_adapter(
                gen, self.base, self.acfg, calib_grads)[1])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.mask_seconds = time.perf_counter() - t0   # building the mask
        self.schedule = lr_schedule(run.train)

    # -- state ---------------------------------------------------------------

    def init_state(self) -> Dict[str, Any]:
        if self.hook_mode:
            masks = dict(iter_leaves(self.masks))
            moments = lambda: map_leaves(
                lambda p, w: torch.zeros(w.shape, dtype=torch.float32,
                                         device=w.device)
                if p in masks else None, self.base)
            return {"trainable": map_leaves(
                lambda p, w: w.clone() if p in masks else w, self.base),
                "mu": moments(), "nu": moments(), "step": 0}
        trainable = map_leaves(
            lambda _, i: torch.zeros(i.shape, dtype=torch.float32,
                                     device=i.device), self.aux["indices"])
        opt = adamw_init(trainable)
        return {"trainable": trainable, "mu": opt.mu, "nu": opt.nu,
                "step": 0}

    # -- one step ------------------------------------------------------------

    def loss_and_grads(self, trainable, batch: dict) -> tuple:
        """(loss, metrics, gradients) of the packed values ``trainable`` on
        a device batch; gradients in ``iter_leaves`` order, before
        clipping."""
        leaves = [(p, v.detach().requires_grad_(True))
                  for p, v in iter_leaves(trainable)]
        lookup = dict(leaves)
        tree = map_leaves(lambda p, _: lookup[p], trainable)
        eff = core.materialize(self.base, tree, self.aux, self.acfg,
                               alpha=1.0)
        loss, metrics = lm.train_loss(eff, self.cfg, batch)
        grads = torch.autograd.grad(loss, [v for _, v in leaves])
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, dict(zip(lookup, grads))

    def hook_step(self, state: dict, batch: dict) -> tuple:
        """One hook-mode step: the target leaves of ``state["trainable"]``
        and the moments are updated in place."""
        tc = self.run.train
        lr = self.schedule(state["step"])
        loss, metrics, grads = dense_grads(state["trainable"], self.cfg,
                                           batch, self.acfg.target_modules)
        masks = dict(iter_leaves(self.masks))
        for p, g in grads.items():
            g.mul_(masks[p])
        gnorm = global_norm(grads)
        if tc.grad_clip > 0:
            scale = clip_scale(gnorm, tc.grad_clip)
            for g in grads.values():
                g.mul_(scale)
        step = state["step"] + 1
        mu, nu = dict(iter_leaves(state["mu"])), dict(iter_leaves(state["nu"]))
        w = dict(iter_leaves(state["trainable"]))
        for p in list(grads):
            u = adamw_direction_(grads.pop(p), mu[p], nu[p], step, tc)
            ops.masked_update(w[p], masks[p], u, -lr)
            del u                   # free this leaf's buffer before the next
        return {**state, "step": step}, {**metrics, "grad_norm": gnorm,
                                          "loss": loss, "lr": lr}

    def step(self, state: dict, batch: dict) -> tuple:
        """One optimizer step on a device batch; returns (new state,
        metrics as tensors)."""
        if self.hook_mode:
            return self.hook_step(state, batch)
        tc = self.run.train
        lr = self.schedule(state["step"])
        loss, metrics, grads = self.loss_and_grads(state["trainable"], batch)
        gnorm = global_norm(grads)
        if tc.grad_clip > 0:
            scale = clip_scale(gnorm, tc.grad_clip)
            grads = {p: g * scale for p, g in grads.items()}
        step = state["step"] + 1
        mu, nu = dict(iter_leaves(state["mu"])), dict(iter_leaves(state["nu"]))
        new = {}
        for p, v in iter_leaves(state["trainable"]):
            out = ops.sparse_adamw(
                v.reshape(-1), grads[p].reshape(-1), mu[p].reshape(-1),
                nu[p].reshape(-1), step, lr=lr, b1=tc.beta1, b2=tc.beta2,
                eps=tc.eps, wd=tc.weight_decay)
            new[p] = [t.reshape(v.shape) for t in out]
        pick = lambda i: map_leaves(lambda p, _: new[p][i],
                                    state["trainable"])
        new_state = {"trainable": pick(0), "mu": pick(1), "nu": pick(2),
                     "step": step}
        return new_state, {**metrics, "grad_norm": gnorm, "loss": loss,
                           "lr": lr}

    # -- host loop -----------------------------------------------------------

    def fit(self, steps: int, batches: Optional[Iterator] = None,
            state: Optional[dict] = None,
            fault_injector: Optional[Callable[[int], None]] = None,
            log: Optional[Callable[[str], None]] = print) -> Dict[str, Any]:
        if fault_injector is not None:
            raise NotImplementedError("fault injection and preemption "
                                      "recovery wait (ROADMAP A8)")
        if batches is None:
            batches = batch_iterator(self.cfg, self.run.shape,
                                     seed=self.run.train.seed)
        state = state or self.init_state()
        history = []
        it = iter(batches)
        for s in range(steps):
            batch = device_batch(next(it), self.device)
            t0 = time.perf_counter()
            state, metrics = self.step(state, batch)
            rec = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            rec["step_ms"] = dt * 1e3
            history.append(rec)
            if log and (s % self.tcfg.log_every == 0 or s == steps - 1):
                log(f"[trainer] step {s:5d} loss={rec['loss']:.4f} "
                    f"lr={rec['lr']:.2e} {dt * 1e3:.0f}ms")
        return {"state": state, "history": history}

    # -- adapter export ------------------------------------------------------

    def export_pack(self, state, name: str = "adapter") -> core.AdapterPack:
        if self.hook_mode:
            return core.pack_from_delta(name, self.base, state["trainable"],
                                        self.acfg)
        return core.pack_from_shira(name, state["trainable"], self.aux)

    def publish(self, store, state, name: str = "adapter", *,
                values: str = "f32") -> str:
        """Export the current adapter and push it into ``store`` as its
        next version (``name@v``, ``AdapterStore.publish``): live serving
        engines resolve the bare name to it from their next submit, which
        is the hot swap. Returns the versioned id. The reference also
        snapshots the pack into the trainer's checkpoint; checkpoints wait
        (ROADMAP A8), and a trainer given one raises when it is built."""
        pack = self.export_pack(state, name)
        with trace.span("publish.swap", cat="train", name=name):
            return store.publish(pack, values=values)
