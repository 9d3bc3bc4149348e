"""The trainers and ``launch.train`` on zamba2-2.7b's smoke config (2
groups of 2 Mamba2 layers and the shared attention block) against the JAX
package.

The base is drawn by the JAX package and crosses over through
repro_torch.bridge. The default targets meet ``out_proj`` of every mamba
layer ((g, k, 2 d_model, d_model) stacked) and the shared block's seven
unstacked leaves, each used at all g sites, so their gradients sum over
the sites. In f32:
  - the gradients of a step, at nonzero adapter values, against jax.grad
    of the reference's own loss functions: the Trainer's packed values
    (``core.materialize`` + ``lm.train_loss``) and the multi-adapter
    trainer's (A, ..., K) values (its per-adapter loss over side-delta
    bundles, the reference's ``sidedelta_backend("xla")``), to GRAD_TOL =
    1e-4 of each leaf's largest, the shared leaves included;
  - 3 steps of the Trainer (packed SHiRA, ``wm`` masks) and of the
    MultiAdapterTrainer (3 adapters, numpy ``rand`` indices) track the
    JAX trainers' losses and trained values to rtol = atol = 5e-3, the JAX
    package's trainer tolerance;
  - hook mode covers the (g, k) leaves: 3 steps track the JAX hook-mode
    Trainer's losses to the same tolerance;
  - ``launch.train`` trains on the CPU as a user runs it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import AdapterConfig as JAdapterConfig
from repro.configs import RunConfig as JRunConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.runtime import Trainer as JTrainer
from repro.training import MultiAdapterTrainer as JMulti
from repro.training.multi import TaskSpec, multi_batch_iterator
from repro_torch import bridge
from repro_torch.configs import (AdapterConfig, RunConfig, ShapeSpec,
                                 TrainConfig, get_smoke_config)
from repro_torch.core.masks import iter_leaves
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as TL
from repro_torch.runtime import Trainer
from repro_torch.runtime.trainer import device_batch
from repro_torch.training import MultiAdapterTrainer

from test_torch_moe import TRAJ_TOL, _np
from test_torch_moe_train import _flat, _scatter
from test_torch_multiadapter import np_init_adapter
from test_torch_zamba import ARCH, GRAD_TOL

SHARED = ("shared_attn/attn/wq", "shared_attn/attn/wk", "shared_attn/attn/wv",
          "shared_attn/attn/wo", "shared_attn/mlp/w_up",
          "shared_attn/mlp/w_gate", "shared_attn/mlp/w_down")
OUT_PROJ = "stages/0/mixer/out_proj"
NAMES = ["a0", "a1", "a2"]


def _runs(mask, packed=True):
    adapter = dict(kind="shira", mask=mask, sparsity=0.9, packed=packed)
    train = dict(learning_rate=1e-2, total_steps=5, warmup_steps=2)
    jrun = JRunConfig(model=j_smoke(ARCH), shape=JShapeSpec("t", 40, 2,
                                                             "train"),
                      adapter=JAdapterConfig(**adapter),
                      train=JTrainConfig(**train))
    trun = RunConfig(model=get_smoke_config(ARCH),
                     shape=ShapeSpec("t", 40, 2, "train"),
                     adapter=AdapterConfig(**adapter),
                     train=TrainConfig(**train))
    return jrun, trun


_BASE = []


def base():
    """(JAX base, numpy base), built once."""
    if not _BASE:
        jbase = JLM.init_params(j_smoke(ARCH), jax.random.PRNGKey(0))
        _BASE.extend([jbase, _np(jbase)])
    return _BASE


def _track(got, want, keys):
    for k in keys:
        np.testing.assert_allclose([h[k] for h in got],
                                   [float(h[k]) for h in want], **TRAJ_TOL)


def _grads_close(got, want):
    assert set(got) == set(want)
    assert set(SHARED) | {OUT_PROJ} <= set(got)
    for p, g in want.items():
        top = float(np.abs(g).max())
        assert top > 0, p
        np.testing.assert_allclose(got[p], g, rtol=0, atol=GRAD_TOL * top,
                                   err_msg=p)


def test_trainer_gradient_matches_jax_grad():
    """The Trainer's gradient of its packed values (out_proj's (g, k, K)
    and the shared leaves' (K,), summed over the g sites) at nonzero
    values, against jax.grad of materialize + train_loss on the same
    indices."""
    jrun, trun = _runs("rand")
    jbase, np_base = base()
    _, jaux = np_init_adapter(jax.random.PRNGKey(3), jbase, jrun.adapter)
    rng = np.random.default_rng(5)
    vals = jax.tree.map(lambda i: (0.05 * rng.standard_normal(i.shape)
                                   ).astype(np.float32), _np(jaux["indices"]))
    batch = next(multi_batch_iterator(jrun.model, jrun.shape, 0,
                                      [TaskSpec(0)]))
    batch = {k: v for k, v in batch.items() if k != "ids"}
    with JL.compute_precision(jnp.float32):
        def jloss(t):
            eff = jcore.materialize(jbase, t, jaux, jrun.adapter, alpha=1.0)
            return JLM.train_loss(eff, jrun.model, {
                k: jnp.asarray(v) for k, v in batch.items()})[0]
        jl, jg = jax.jit(jax.value_and_grad(jloss))(
            jax.tree.map(jnp.asarray, vals))
    with TL.compute_precision(torch.float32):
        tt = Trainer(trun, base_params=bridge.params_from_numpy(np_base,
                                                                "cpu"),
                     aux=bridge.adapter_from_numpy(_np(jaux["indices"]),
                                                   "cpu")[1], device="cpu")
        tl, _, tg = tt.loss_and_grads(bridge.params_from_numpy(vals, "cpu"),
                                      device_batch(batch, "cpu"))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _grads_close({p: g.numpy() for p, g in tg.items()}, _flat(jg))


def test_multi_adapter_gradient_matches_jax_grad():
    """The multi-adapter trainer's gradient of its (A, ..., K) values at
    nonzero values against jax.grad of the reference's per-adapter loss
    sum (side-delta bundles on out_proj and on the shared leaves at every
    site), and the per-adapter losses."""
    jrun, trun = _runs("rand")
    jbase, np_base = base()
    with JL.compute_precision(jnp.float32), pytest.MonkeyPatch.context() \
            as mp:
        mp.setattr(jcore, "init_adapter", np_init_adapter)
        jm = JMulti(jrun, NAMES, init_key=0, base_params=jbase)
    rng = np.random.default_rng(6)
    vals = {p: (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            for p, v in _flat(jm.init_state()["values"]).items()}
    batch = next(multi_batch_iterator(
        jrun.model, jrun.shape, 0, [TaskSpec(a) for a in range(3)]))
    jv = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(vals[jcore.masks.path_str(p)]),
        jm.init_state()["values"])
    with JL.compute_precision(jnp.float32):
        def jloss(v):
            with JL.sidedelta_backend("xla"):
                losses, _ = jm._per_adapter_loss(jm._wrapped_params(v), {
                    k: jnp.asarray(x) for k, x in batch.items()})
            return jnp.sum(losses), losses
        (_, jlosses), jg = jax.jit(jax.value_and_grad(jloss,
                                                      has_aux=True))(jv)
    auxes = [bridge.adapter_from_numpy(_np(x["indices"]), "cpu")[1]
             for x in jm.auxes]
    with TL.compute_precision(torch.float32):
        tm = MultiAdapterTrainer(trun, NAMES, base_params=bridge.
                                 params_from_numpy(np_base, "cpu"),
                                 auxes=auxes, device="cpu")
        tlosses, tg, aux = tm.loss_and_grads(
            {p: torch.from_numpy(v) for p, v in vals.items()},
            device_batch(batch, "cpu"))
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses),
                               rtol=1e-5, atol=1e-5)
    assert float(aux) == 0.0
    _grads_close({p: g.numpy() for p, g in tg.items()}, _flat(jg))


def test_trainer_tracks_jax():
    """3 packed-SHiRA steps on wm masks over out_proj and the shared
    leaves: losses (aux 0) and the trained weights, compared scattered
    into the base (the packages list a matrix's indices in other
    orders)."""
    jrun, trun = _runs("wm")
    jbase, np_base = base()
    with JL.compute_precision(jnp.float32):
        jt = JTrainer(jrun, init_key=0, base_params=jbase)
        ref = jt.fit(3, log=None)
    with TL.compute_precision(torch.float32):
        tt = Trainer(trun, base_params=bridge.params_from_numpy(np_base,
                                                                "cpu"),
                     device="cpu")
        out = tt.fit(3, log=None)
    tidx = {p: i.numpy() for p, i in iter_leaves(tt.aux["indices"])}
    assert set(tidx) == set(SHARED) | {OUT_PROJ}
    _track(out["history"], ref["history"], ("loss", "aux"))
    got = {p: x.detach().numpy()
           for p, x in iter_leaves(out["state"]["trainable"])}
    assert all(np.abs(got[p]).max() > 1e-3 for p in (OUT_PROJ,) + SHARED)
    base_, jidx = _flat(np_base), _flat(jt.aux["indices"])
    jvals = _flat(ref["state"]["trainable"])
    for p, v in got.items():
        np.testing.assert_allclose(_scatter(base_[p], tidx[p], v),
                                   _scatter(base_[p], jidx[p], jvals[p]),
                                   **TRAJ_TOL)


def test_multi_adapter_trainer_tracks_jax():
    """3 adapters, 3 steps, rand indices drawn with numpy and shared: the
    per-adapter losses and the trained values (the same indices, in the
    same order)."""
    jrun, trun = _runs("rand")
    jbase, np_base = base()
    with JL.compute_precision(jnp.float32), pytest.MonkeyPatch.context() \
            as mp:
        mp.setattr(jcore, "init_adapter", np_init_adapter)
        jm = JMulti(jrun, NAMES, init_key=0, base_params=jbase)
        jout = jm.fit(3, log=None)
    auxes = [bridge.adapter_from_numpy(_np(x["indices"]), "cpu")[1]
             for x in jm.auxes]
    with TL.compute_precision(torch.float32):
        tm = MultiAdapterTrainer(trun, NAMES, base_params=bridge.
                                 params_from_numpy(np_base, "cpu"),
                                 auxes=auxes, device="cpu")
        tout = tm.fit(3, log=None)
    _track(tout["history"], jout["history"], [f"loss:{n}" for n in NAMES])
    want = _flat(jout["state"]["values"])
    got = {p: v.detach().numpy() for p, v in tout["state"]["values"].items()}
    assert set(got) == set(want) == set(SHARED) | {OUT_PROJ}
    for p, v in got.items():
        assert np.abs(v).max() > 1e-3
        np.testing.assert_allclose(v, want[p], **TRAJ_TOL)


def test_hook_mode_tracks_jax():
    """Hook mode (wm masks, packed=False) differentiates each group's
    (k, n, m) stack of out_proj as a leaf of its own and the shared
    leaves whole: 3 steps' losses track the JAX hook-mode Trainer's."""
    jrun, trun = _runs("wm", packed=False)
    jbase, np_base = base()
    with JL.compute_precision(jnp.float32):
        ref = JTrainer(jrun, init_key=0, base_params=jbase).fit(3, log=None)
    with TL.compute_precision(torch.float32):
        tt = Trainer(trun, base_params=bridge.params_from_numpy(np_base,
                                                                "cpu"),
                     device="cpu")
        out = tt.fit(3, log=None)
    assert {p for p, _ in iter_leaves(tt.masks)} == set(SHARED) | {OUT_PROJ}
    _track(out["history"], ref["history"], ("loss",))


def test_launch_train():
    out = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--adapter", "shira-rand", "--steps", "2", "--seq",
                       "40", "--batch", "2"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert out["trained_values"] > 0
