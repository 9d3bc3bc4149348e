"""MultiAdapterTrainer: A packed-SHiRA adapters finetuned together.

Port of ``repro/training/multi.py``. Serving already batches per-request
adapters through the ``sidedelta`` side term (one shared base matmul plus a
sparse correction per request, routed by adapter id); this trainer runs the
training forward through the same machinery, so A adapters' batches share
every base-weight matmul:

  * the packed trainables are (A, ..., K) value trees;
  * the step batch concatenates each adapter's batch, with an ``ids``
    row -> adapter vector; the target leaves become trainable side-delta
    bundles (``layers.trainable_sidedelta_weight``) over the values, whose
    gradients come from the sidedelta kernels (``sidedelta_train``: dx
    through the forward kernel over the transposed table, dvals through
    ``csrc/sidedelta_grad.cu``);
  * the loss is the SUM of per-adapter mean NLLs, so adapter a's gradients
    are what its own single-adapter run would get;
  * gradients are clipped per adapter (``optim.batched_global_norm``) and
    one ``sparse_adamw_rows`` launch per leaf updates all A adapters, with
    the moments stored f32, bf16 or int8 between steps
    (``training.qstate``; the kernel decodes them inline).

Contract (``tests/test_torch_multiadapter.py``): under f32 compute, adapter
a of ``MultiAdapterTrainer(run, names, init_key=k)`` fed ``TaskSpec(a)``
tracks ``Trainer(run, init_key=k + a)`` fed the same stream, step for step,
within float-summation-order tolerance. ``publish`` pushes the trained
packs into an ``AdapterStore`` as new versions, which live engines swap in.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import core
from repro_torch.analysis import trace
from repro_torch.configs.base import RunConfig
from repro_torch.core.masks import iter_leaves, map_leaves
from repro_torch.data import TaskSpec, make_batch
from repro_torch.kernels import ops, ref
from repro_torch.models import lm
from repro_torch.models.layers import (rms_norm, token_nll,
                                       trainable_sidedelta_weight)
from repro_torch.optim import batched_global_norm, lr_schedule
from repro_torch.optim.adamw import clip_scale
from repro_torch.runtime.trainer import (TrainerConfig, check_packed_shira,
                                         device_batch)
from repro_torch.training import qstate


def multi_batch_iterator(cfg, shape, seed: int, tasks: Sequence[TaskSpec],
                         start_step: int = 0) -> Iterator[Dict[str, Any]]:
    """Concatenation of ``len(tasks)`` per-adapter streams + row->adapter
    ids. Row block ``a`` of every batch equals what ``batch_iterator(cfg,
    shape, seed, task=tasks[a])`` yields at the same step."""
    A = len(tasks)
    ids = np.repeat(np.arange(A, dtype=np.int32), shape.global_batch)
    step = start_step
    while True:
        parts = [make_batch(cfg, shape, seed, step, t) for t in tasks]
        batch = {k: np.concatenate([p[k] for p in parts], axis=0)
                 for k in parts[0]}
        batch["ids"] = ids
        yield batch
        step += 1


class MultiAdapterTrainer:
    """Concurrent packed-SHiRA finetuning of ``len(names)`` adapters.

    Args:
      run: the shared RunConfig (``run.adapter`` packed SHiRA).
      names: adapter names; adapter ``a`` draws its indices from a
        generator seeded ``init_key + a``, as its single-adapter twin
        ``Trainer(run, init_key=init_key + a)`` does.
      moments: optimizer-moment storage, "f32" (default), "bf16", "int8".
      fused: update through the ``sparse_adamw_rows`` kernel (default);
        False runs ``kernels.ref.sparse_adamw_rows_ref``, the reference's
        inline math, which the tests hold the kernel path against.
      base_params: the base tree (default ``lm.init_params(cfg,
        seed=init_key)``); it is never written.
      auxes: one {"indices": tree} per adapter instead of drawing them:
        the hook of ``bridge.adapter_from_numpy``, which carries the JAX
        package's indices across.
    """

    def __init__(self, run: RunConfig, names: Sequence[str],
                 tcfg: TrainerConfig = TrainerConfig(), *, init_key: int = 0,
                 base_params=None, moments: str = "f32", fused: bool = True,
                 auxes: Optional[List[dict]] = None, device="cuda"):
        check_packed_shira(run)
        if moments not in qstate.MOMENT_MODES:
            raise ValueError(f"moments={moments!r} not in "
                             f"{qstate.MOMENT_MODES}")
        self.run, self.tcfg = run, tcfg
        self.cfg, self.acfg = run.model, run.adapter
        self.names = list(names)
        self.A = len(self.names)
        self.moments, self.fused = moments, fused
        self.base = (base_params if base_params is not None
                     else lm.init_params(self.cfg, seed=init_key,
                                         device=device))
        self.device = next(iter(self.base["embed"].values())).device
        if auxes is None:
            auxes = []
            for a in range(self.A):
                gen = torch.Generator(device=self.device)
                gen.manual_seed(init_key + a)
                auxes.append(core.init_adapter(gen, self.base, self.acfg)[1])
        self.auxes = auxes
        idx = [dict(iter_leaves(aux["indices"])) for aux in auxes]
        weights = dict(iter_leaves(self.base))
        # the trainable side-delta tables, built once: (lead..., A, .)
        self.tables = {}
        for path in idx[0]:
            *lead, n, m = weights[path].shape
            nl = int(np.prod(lead, dtype=np.int64))
            t = ops.sidedelta_table([i[path].reshape(nl, -1) for i in idx],
                                    nl, n, m, trainable=True)
            self.tables[path] = {k: v.reshape(*lead, *v.shape[1:])
                                 for k, v in t.items()}
        self._ids = torch.arange(self.A, dtype=torch.int32,
                                 device=self.device).repeat_interleave(
                                     run.shape.global_batch)
        self.schedule = lr_schedule(run.train)

    # -- state ---------------------------------------------------------------

    def init_state(self) -> Dict[str, Any]:
        """{"values", "mu", "nu", "mu_scale", "nu_scale"}: dicts from each
        target path to its (A, ..., K) tensor (scales (A, ...) for int8
        moments, else None), and "step"."""
        state: Dict[str, Any] = {k: {} for k in ("values", "mu", "nu",
                                                 "mu_scale", "nu_scale")}
        for path, t in self.tables.items():
            shape = (self.A,) + tuple(t["perm"].shape[:-2]) + (
                t["perm"].shape[-1],)
            zeros = lambda: torch.zeros(shape, dtype=torch.float32,
                                        device=self.device)
            state["values"][path] = zeros()
            state["mu"][path], state["mu_scale"][path] = qstate.encode(
                zeros(), self.moments)
            state["nu"][path], state["nu_scale"][path] = qstate.encode(
                zeros(), self.moments, sqrt_domain=True)
        state["step"] = 0
        return state

    # -- forward -------------------------------------------------------------

    def _wrapped_params(self, values: Dict[str, torch.Tensor]):
        """The base tree with every target leaf a trainable side-delta
        bundle over the (A, ..., K) values, moved to (..., A, K) so that
        slicing a stacked layer slices the bundle."""
        def leaf(path, w):
            if path not in self.tables:
                return w
            lead = tuple(w.shape[:-2])
            return trainable_sidedelta_weight(
                w, values[path].movedim(0, -2), self.tables[path],
                self._ids.expand(lead + tuple(self._ids.shape)))

        return map_leaves(leaf, self.base)

    def _per_adapter_loss(self, params, batch) -> torch.Tensor:
        """(A,) mean NLL per adapter: ``lm.chunked_loss``'s math with the
        sum routed one-hot by each row's adapter, so every adapter's loss
        is normalized over its own rows only."""
        cfg, A = self.cfg, self.A
        if cfg.modality != "text":
            raise NotImplementedError("multi-adapter training routes by "
                                      "token rows; text modality only")
        h, prefix_len = lm.embed_inputs(params, cfg, batch)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for sp, (_, n) in zip(params["stages"], lm.stage_plan(cfg)):
            h, aux = lm._stage_train(sp, cfg, h, aux, prefix_len, n)
        h = rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
        B, S, _ = h.shape
        adapters = torch.arange(A, device=h.device)

        def chunk(logits, lc, ac):
            onehot = (ac[:, None] == adapters[None, :]).float()  # (c, A)
            return token_nll(logits, lc) @ onehot, onehot.sum(0)

        parts = lm._loss_chunks(params, cfg, h, chunk,
                                batch["labels"].reshape(B * S),
                                batch["ids"].repeat_interleave(S))
        sums = torch.stack([p[0] for p in parts]).sum(0)
        counts = torch.stack([p[1] for p in parts]).sum(0)
        return sums / torch.clamp(counts, min=1.0)

    # -- one step ------------------------------------------------------------

    def _update_leaf(self, v, g, m, u, ms, us, step: int, lr: float):
        tc = self.run.train
        K = v.shape[-1]
        R = v.numel() // K
        row = lambda x: x.reshape(R, K)
        sc = lambda x: None if x is None else x.reshape(R)
        kw = dict(lr=lr, b1=tc.beta1, b2=tc.beta2, eps=tc.eps,
                  wd=tc.weight_decay)
        if self.fused:
            out = ops.sparse_adamw_batched(row(v), row(g), row(m), row(u),
                                           step, mu_scale=sc(ms),
                                           nu_scale=sc(us), **kw)
        else:   # the reference's inline math: the kernel path's oracle
            out = ref.sparse_adamw_rows_ref(row(v), row(g), row(m), row(u),
                                            sc(ms), sc(us), step,
                                            mode=self.moments, **kw)
        v2, m2, u2 = (t.reshape(v.shape) for t in out)
        m_st, ms2 = qstate.encode(m2, self.moments)
        u_st, us2 = qstate.encode(u2, self.moments, sqrt_domain=True)
        return v2, m_st, u_st, ms2, us2

    def loss_and_grads(self, values: Dict[str, torch.Tensor],
                       batch: dict) -> tuple:
        """((A,) per-adapter losses, gradients of the (A, ..., K) values by
        path) on a device batch, before clipping."""
        values = {p: v.detach().requires_grad_(True)
                  for p, v in values.items()}
        losses = self._per_adapter_loss(self._wrapped_params(values), batch)
        grads = torch.autograd.grad(losses.sum(), list(values.values()))
        return losses.detach(), dict(zip(values, grads))

    def step(self, state: dict, batch: dict) -> tuple:
        """One optimizer step of every adapter on a device batch; returns
        (new state, metrics as tensors)."""
        tc = self.run.train
        lr = self.schedule(state["step"])
        losses, grads = self.loss_and_grads(state["values"], batch)
        gnorm = batched_global_norm(grads, self.A)               # (A,)
        if tc.grad_clip > 0:
            scale = clip_scale(gnorm, tc.grad_clip)
            grads = {p: g * scale.reshape((self.A,) + (1,) * (g.ndim - 1))
                     for p, g in grads.items()}
        step = state["step"] + 1
        new = {k: {} for k in ("values", "mu", "nu", "mu_scale",
                               "nu_scale")}
        for p, v in state["values"].items():
            out = self._update_leaf(v, grads[p], state["mu"][p],
                                    state["nu"][p], state["mu_scale"][p],
                                    state["nu_scale"][p], step, lr)
            for k, t in zip(new, out):
                new[k][p] = t
        new["step"] = step
        return new, {"losses": losses, "loss": losses.mean(),
                     "grad_norm": gnorm, "lr": lr}

    # -- host loop -----------------------------------------------------------

    def fit(self, steps: int, batches: Optional[Iterator] = None,
            state: Optional[dict] = None,
            log: Optional[Callable[[str], None]] = print) -> Dict[str, Any]:
        if batches is None:
            batches = multi_batch_iterator(
                self.cfg, self.run.shape, self.run.train.seed,
                [TaskSpec(a) for a in range(self.A)])
        state = state or self.init_state()
        it = iter(batches)
        history = []
        for s in range(steps):
            batch = device_batch(next(it), self.device)
            t0 = time.perf_counter()
            state, metrics = self.step(state, batch)
            losses = metrics["losses"].tolist()
            dt = time.perf_counter() - t0
            rec = {"loss": float(metrics["loss"]), "lr": metrics["lr"],
                   "step_ms": dt * 1e3}
            rec.update({f"loss:{n}": v for n, v in zip(self.names, losses)})
            history.append(rec)
            if log and (s % self.tcfg.log_every == 0 or s == steps - 1):
                per = " ".join(f"{n}={v:.4f}"
                               for n, v in zip(self.names, losses))
                log(f"[multi] step {s:5d} {per} {dt * 1e3:.0f}ms")
        return {"state": state, "history": history}

    # -- export --------------------------------------------------------------

    def export_packs(self, state) -> List[core.AdapterPack]:
        return [core.pack_from_shira(
                    name, map_leaves(lambda p, _: state["values"][p][a],
                                     self.auxes[a]["indices"]),
                    self.auxes[a])
                for a, name in enumerate(self.names)]

    def publish(self, store, state, *, ckpt=None,
                values: str = "f32") -> List[str]:
        """Push every adapter's current values into ``store`` as its next
        version (``name@v``); live engines move new requests to them from
        their next submit. Returns the versioned ids. Snapshots into a
        checkpoint (``ckpt``) wait (ROADMAP A8)."""
        if ckpt is not None:
            raise NotImplementedError("checkpoint snapshots of published "
                                      "packs wait (ROADMAP A8)")
        vids = []
        for pack in self.export_packs(state):
            with trace.span("publish.swap", cat="train", name=pack.name):
                vids.append(store.publish(pack, values=values))
        return vids
