"""The trainer: adapter-aware, preemption-safe, checkpointed train loop.

Port of ``repro/runtime/trainer.py``. One Trainer serves every mode:

  adapter.kind == "none"           full finetuning: the trainable tree is
                                   a copy of the base, every leaf trained
                                   on its dense gradient
  adapter.kind == "shira", packed  the paper's App. D: the trainable tree
                                   is the (..., K) packed values of every
                                   target leaf
  adapter.kind == "shira", hook    the paper's App. C: the trainable tree
                                   is the model's weights, gradients
                                   Hadamard-masked
  lora, dora, shira-dora           the factor trees ({"A", "B"[, "m"]} a
                                   target leaf; SHiRA-DoRA also a mask)

The forward runs the base through ``core.adapters.materialize``, whose
bundles make each layer's effective weights inside its checkpoint (SHiRA
through the ``scatter_apply`` kernel, and SHiRA-DoRA's masked delta too).
Every non-hook update follows the reference's ``adamw_update``: the
gradients clipped by their global norm, then the fused ``sparse_adamw``
kernel launched once per flattened leaf (weight decay included), or, for
full finetuning, once per matrix of a stacked leaf, in place.

Hook mode: the target leaves are copied from the base (which is kept, for
the export) and updated in place, a dense bool mask per target leaf. A
step takes dense f32 gradients of the target leaves only, masks and clips
them, runs the reference's dense AdamW direction
(``optim.adamw_direction_``) with dense moments, and launches the
``masked_update`` kernel once per target leaf: W + (-lr) * (M ⊙ U). With
weight decay 0 (the default) the reference's gradients, moments and
direction are exactly 0 off the mask and at every other leaf, so this is
its update, bit for bit, and it keeps no state for the other leaves. With
weight decay the reference decays every weight, masked or not (its
moments there stay 0, so its update is p - lr * (0 + wd * p)): then every
leaf is copied, and each is decayed in plain torch before the masked
update (``hook_step`` says in which rounding order).

The host loop (``fit``) is the reference's: checkpoints every
``ckpt_every`` steps and at the end (``CheckpointManager``, keep-K),
resume from the latest committed step, a ``fault_injector(step)`` called
before each step, recovery from ``SimulatedPreemption`` by restoring the
latest checkpoint and re-reading the batches from its step (or a restart
from scratch without one), and a ``StragglerMonitor`` fed each step's
time. ``export_pack`` exports a SHiRA adapter; ``publish`` pushes it into
an ``AdapterStore`` as its next version, and into the step's checkpoint
directory when the trainer checkpoints. On CPU tensors the kernel
wrappers compute their plain versions.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from repro_torch import core
from repro_torch.analysis import trace
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.adapters import FACTOR_KINDS, map_entries
from repro_torch.core.masks import is_target, iter_leaves, map_leaves
from repro_torch.data import batch_iterator
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.optim import (adamw_direction_, adamw_init, global_norm,
                               lr_schedule)
from repro_torch.optim.adamw import clip_scale
from repro_torch.runtime.ft import SimulatedPreemption, StragglerMonitor


@dataclass
class TrainerConfig:
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    adapter_only_ckpt: bool = True   # the reference's field; neither
                                     # package's trainer reads it


def dense_grads(params, cfg: ModelConfig, batch: dict,
                target_modules=None) -> tuple:
    """(loss, metrics, gradients) of ``lm.train_loss`` on a device batch,
    with dense f32 gradients ({path: tensor of the leaf's shape}) of the
    target leaves only, or of every leaf when ``target_modules`` is None
    (full finetuning); the other leaves get none. Each layer of a stacked
    (L, n, m) leaf is differentiated as a leaf of its own whose ``.grad``
    is preset to that layer of one f32 buffer, into which autograd
    accumulates in place: no stacked gradient is built per layer. These
    are also the calibration gradients of the ``grad`` and ``snip``
    masks."""
    grads = {}

    def leaf(path, w):
        if target_modules is not None and not is_target(path, w,
                                                        target_modules):
            return w
        g = grads[path] = torch.zeros(w.shape, dtype=torch.float32,
                                      device=w.device)
        pairs = [(w, g)] if w.ndim < 3 else list(zip(w, g))
        views = []
        for x, gl in pairs:
            views.append(x.detach().requires_grad_(True))
            views[-1].grad = gl
        return views[0] if w.ndim < 3 else lm.LayerList(views)

    tree = map_leaves(leaf, params)
    loss, metrics = lm.train_loss(tree, cfg, batch)
    loss.backward()
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def device_batch(batch, device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``: tokens and labels int64 (for
    indexing), everything else as it is (a vision batch's patch_embeds
    and an audio batch's frame_embeds stay f32)."""
    return {k: torch.from_numpy(v).to(device, torch.int64)
            if k in ("tokens", "labels") else torch.from_numpy(v).to(device)
            for k, v in batch.items()}


class Trainer:
    """Finetuning of one adapter, of any kind (the module docstring).

    The base comes from ``lm.init_params(cfg, seed=init_key)`` unless
    ``base_params`` is given; the adapter from ``core.init_adapter`` (or
    ``core.make_dense_masks`` in hook mode) over the base, with a
    generator seeded with ``init_key`` on the base's device for ``rand``
    masks and LoRA factors, and ``calib_grads`` (a tree of the target
    leaves' gradients, ``dense_grads``) for ``grad`` and ``snip``. ``aux``
    ({"indices": tree}, packed SHiRA and SHiRA-DoRA) and ``trainable0``
    (the factor tree of LoRA, DoRA and SHiRA-DoRA) are the hooks of
    ``bridge``, which carries the JAX package's draws across: its
    ``jax.random`` draws cannot be made in torch. A fresh Trainer on the
    same ``init_key`` draws the same adapter, so a resumed process
    trains the entries its checkpoint holds. The base is never written."""

    def __init__(self, run: RunConfig, tcfg: TrainerConfig = TrainerConfig(),
                 init_key: int = 0, base_params=None, aux=None,
                 calib_grads=None, trainable0=None, device="cuda"):
        self.run, self.tcfg = run, tcfg
        self.cfg, self.acfg = run.model, run.adapter
        kind = self.acfg.kind
        if kind not in ("none", "shira") + FACTOR_KINDS:
            raise ValueError(f"unknown adapter kind {kind!r}")
        self.hook_mode = kind == "shira" and not self.acfg.packed
        # hook mode with weight decay decays every leaf (module docstring)
        self.decay_all = self.hook_mode and bool(run.train.weight_decay)
        self.base = (base_params if base_params is not None
                     else lm.init_params(self.cfg, seed=init_key,
                                         device=device))
        self.device = next(iter(self.base["embed"].values())).device
        gen = torch.Generator(device=self.device)
        gen.manual_seed(init_key)
        t0 = time.perf_counter()
        self.masks = None
        if self.hook_mode:
            self.masks = core.make_dense_masks(self.base, self.acfg, gen,
                                               calib_grads)
        need_aux = kind == "shira" and not self.hook_mode or \
            kind == "shira-dora"
        need_t = kind in FACTOR_KINDS
        if (need_aux and aux is None) or (need_t and trainable0 is None):
            drawn, drawn_aux = core.init_adapter(gen, self.base, self.acfg,
                                                 calib_grads)
            aux = drawn_aux if aux is None else aux
            trainable0 = drawn if trainable0 is None else trainable0
        self.aux = aux if need_aux else None
        self.trainable0 = trainable0 if need_t else None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.mask_seconds = time.perf_counter() - t0   # building the adapter
        self.schedule = lr_schedule(run.train)
        self.monitor = StragglerMonitor(n_hosts=1)
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir, tcfg.keep)
                     if tcfg.ckpt_dir else None)

    # -- state ---------------------------------------------------------------

    def init_state(self) -> Dict[str, Any]:
        kind = self.acfg.kind
        if self.hook_mode:
            masks = dict(iter_leaves(self.masks))
            moments = lambda: map_leaves(
                lambda p, w: torch.zeros(w.shape, dtype=torch.float32,
                                         device=w.device)
                if p in masks else None, self.base)
            return {"trainable": map_leaves(
                lambda p, w: w.clone() if p in masks or self.decay_all
                else w, self.base),
                "mu": moments(), "nu": moments(), "step": 0}
        if kind == "none":
            trainable = map_leaves(lambda _, w: w.clone(), self.base)
        elif kind == "shira":
            trainable = map_leaves(
                lambda _, i: torch.zeros(i.shape, dtype=torch.float32,
                                         device=i.device),
                self.aux["indices"])
        else:
            trainable = map_leaves(lambda _, t: t.clone(), self.trainable0)
        opt = adamw_init(trainable)
        return {"trainable": trainable, "mu": opt.mu, "nu": opt.nu,
                "step": 0}

    # -- one step ------------------------------------------------------------

    def loss_and_grads(self, trainable, batch: dict) -> tuple:
        """(loss, metrics, gradients) of the adapter's trainable tree on a
        device batch (full finetuning: of every weight, ``dense_grads``);
        gradients by path, before clipping."""
        if self.acfg.kind == "none":
            return dense_grads(trainable, self.cfg, batch)
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
        """One hook-mode step: the leaves of ``state["trainable"]`` and the
        moments are updated in place."""
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
        if self.decay_all:
            # The reference's update is p - lr * (u + wd * p), rounded
            # once, with u = 0 off the mask and at every other leaf. Here
            # every leaf is first decayed in one add, p + (-(lr * wd)) * p
            # (the factor rounded to f32), and masked_update then adds
            # -lr * u at the mask: on the mask (p - lr*wd*p) - lr*u, two
            # roundings where the reference has one; elsewhere the same
            # value up to the rounding of lr * wd.
            for x in w.values():
                x.add_(x, alpha=-(lr * tc.weight_decay))
        for p in list(grads):
            u = adamw_direction_(grads.pop(p), mu[p], nu[p], step, tc)
            ops.masked_update(w[p], masks[p], u, -lr)
            del u                   # free this leaf's buffer before the next
        return {**state, "step": step}, {**metrics, "grad_norm": gnorm,
                                          "loss": loss, "lr": lr}

    def _adamw(self, v, g, mu, nu, step: int, lr: float) -> list:
        """One leaf's AdamW step through the ``sparse_adamw`` kernel: one
        launch on the flattened leaf, whose outputs are new tensors; for
        full finetuning one launch per matrix of a stacked leaf, written
        back in place (three new outputs of a whole (L, 4608, 18432) leaf
        would not fit beside the model, its copy, moments and
        gradients)."""
        tc = self.run.train
        kw = dict(lr=lr, b1=tc.beta1, b2=tc.beta2, eps=tc.eps,
                  wd=tc.weight_decay)
        if self.acfg.kind != "none":
            out = ops.sparse_adamw(v.reshape(-1), g.reshape(-1),
                                   mu.reshape(-1), nu.reshape(-1), step, **kw)
            return [t.reshape(v.shape) for t in out]
        for part in (zip(v, g, mu, nu) if v.ndim >= 3 else [(v, g, mu, nu)]):
            out = ops.sparse_adamw(*(t.reshape(-1) for t in part), step, **kw)
            for dst, src in zip((part[0], part[2], part[3]), out):
                dst.copy_(src.reshape(dst.shape))
        return [v, mu, nu]

    def step(self, state: dict, batch: dict) -> tuple:
        """One optimizer step on a device batch; returns (new state,
        metrics as tensors). Hook mode and full finetuning update the
        state's tensors in place (the reference donates its state)."""
        if self.hook_mode:
            return self.hook_step(state, batch)
        tc = self.run.train
        lr = self.schedule(state["step"])
        loss, metrics, grads = self.loss_and_grads(state["trainable"], batch)
        gnorm = global_norm(grads)
        if tc.grad_clip > 0:
            scale = clip_scale(gnorm, tc.grad_clip)
            for g in grads.values():
                g.mul_(scale)
        step = state["step"] + 1
        mu, nu = dict(iter_leaves(state["mu"])), dict(iter_leaves(state["nu"]))
        new = {p: self._adamw(v, grads.pop(p), mu[p], nu[p], step, lr)
               for p, v in iter_leaves(state["trainable"])}
        pick = lambda i: map_leaves(lambda p, _: new[p][i],
                                    state["trainable"])
        new_state = {"trainable": pick(0), "mu": pick(1), "nu": pick(2),
                     "step": step}
        return new_state, {**metrics, "grad_norm": gnorm, "loss": loss,
                           "lr": lr}

    # -- host loop -----------------------------------------------------------

    def _batches(self, start_step: int = 0) -> Iterator:
        return batch_iterator(self.cfg, self.run.shape,
                              seed=self.run.train.seed, start_step=start_step)

    def fit(self, steps: int, batches: Optional[Iterator] = None,
            state: Optional[dict] = None, resume: bool = True,
            fault_injector: Optional[Callable[[int], None]] = None,
            log: Optional[Callable[[str], None]] = print) -> Dict[str, Any]:
        """Train until step ``steps``: from the latest committed checkpoint
        when ``resume`` and the trainer checkpoints (skipping the batches
        it consumed), else from ``state`` or ``init_state()``. Returns
        {"state", "history"}; each history record holds the step's metrics
        and its "step_ms"."""
        if batches is None:
            batches = self._batches()
        state = state or self.init_state()
        start = 0
        if resume and self.ckpt and self.ckpt.latest_step() is not None:
            restored = self.ckpt.restore({"state": state})
            state, start = restored["state"], restored["step"]
            if log:
                log(f"[trainer] resumed from step {start}")
        history = []
        it = iter(batches)
        # skip the batches already consumed, deterministically, on resume
        for _ in range(start):
            next(it)
        s = start
        while s < steps:
            batch = device_batch(next(it), self.device)
            t0 = time.perf_counter()
            try:
                if fault_injector is not None:
                    fault_injector(s)
                state, metrics = self.step(state, batch)
                rec = {k: float(v) for k, v in metrics.items()}
            except SimulatedPreemption:
                if not self.ckpt or self.ckpt.latest_step() is None:
                    state = self.init_state()       # restart from scratch
                    it, s = iter(self._batches()), 0
                    if log:
                        log("[trainer] preempted, no checkpoint: restarting")
                    continue
                restored = self.ckpt.restore({"state": state})
                state, s = restored["state"], restored["step"]
                it = iter(self._batches(start_step=s))
                if log:
                    log(f"[trainer] preempted: restored step {s}")
                continue
            dt = time.perf_counter() - t0
            self.monitor.record(0, dt)
            rec["step_ms"] = dt * 1e3
            history.append(rec)
            if log and (s % self.tcfg.log_every == 0 or s == steps - 1):
                log(f"[trainer] step {s:5d} loss={rec['loss']:.4f} "
                    f"lr={rec['lr']:.2e} {dt * 1e3:.0f}ms")
            s += 1
            if self.ckpt and (s % self.tcfg.ckpt_every == 0 or s == steps):
                self.ckpt.save(s, {"state": state},
                               meta={"arch": self.cfg.name})
        return {"state": state, "history": history}

    # -- adapter export ------------------------------------------------------

    def export_pack(self, state, name: str = "adapter") -> core.AdapterPack:
        if self.acfg.kind == "shira" and not self.hook_mode:
            return core.pack_from_shira(name, state["trainable"], self.aux)
        if self.hook_mode:
            return core.pack_from_delta(name, self.base, state["trainable"],
                                        self.acfg)
        raise ValueError(f"pack export is for SHiRA; kind={self.acfg.kind}")

    def publish(self, store, state, name: str = "adapter", *,
                step: Optional[int] = None, values: str = "f32") -> str:
        """Export the current adapter and push it into ``store`` as its
        next version (``name@v``, ``AdapterStore.publish``): live serving
        engines resolve the bare name to it from their next submit, which
        is the hot swap. When the trainer checkpoints, the versioned pack
        is also snapshotted into the step's directory (``step``, default
        the state's), committed by the next ``ckpt.save``. Returns the
        versioned id."""
        pack = self.export_pack(state, name)
        with trace.span("publish.swap", cat="train", name=name):
            vid = store.publish(pack, values=values)
            if self.ckpt is not None:
                s = int(state["step"]) if step is None else step
                self.ckpt.save_adapter(s, map_entries(pack, name=vid),
                                       values=values)
        return vid
