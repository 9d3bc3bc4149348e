"""repro_torch.training.MultiAdapterTrainer against the JAX package's, and
against the port's own single-adapter Trainer.

The JAX trainer draws the base, and every adapter's rand indices are drawn
with numpy from the adapter's init key (``np_init_adapter`` stands in for
the JAX ``init_adapter`` while the JAX trainer is built: the JAX rand mask
salts its draws with Python's per-process string hash, so it would draw
other indices in every process); they cross over through
repro_torch.bridge (``auxes=``). Both packages run in f32, the
JAX one with its defaults: the fused update in Pallas interpret mode and
the side delta differentiated through its XLA twin; the port's kernel
wrappers compute their plain versions on these CPU tensors. Loss histories
and final packed values agree to rtol = atol = 5e-3, the JAX package's own
tolerance for this contract (tests/test_multiadapter.py); measured, they
agree to ~2e-7. Adapter a also tracks the port's Trainer(init a) on task a
to 5e-3. The int8 moments are held in test_torch_multiadapter_int8.py.
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
from repro.training import MultiAdapterTrainer as JMulti
from repro_torch import bridge
from repro_torch.configs import (AdapterConfig, RunConfig, ShapeSpec,
                                 TrainConfig, get_smoke_config)
from repro_torch.data import TaskSpec, batch_iterator
from repro_torch.models import layers as TL
from repro_torch.runtime import Trainer
from repro_torch.training import MultiAdapterTrainer, multi_batch_iterator
from test_torch_switching import np_indices

STEPS = 4
TOL = dict(rtol=5e-3, atol=5e-3)


def _runs():
    common = dict(adapter=dict(kind="shira", mask="rand", sparsity=0.95),
                  train=dict(learning_rate=1e-2, total_steps=STEPS,
                             warmup_steps=2))
    jrun = JRunConfig(model=j_smoke("starcoder2-7b"),
                      shape=JShapeSpec("tiny", 8, 4, "train"),
                      adapter=JAdapterConfig(**common["adapter"]),
                      train=JTrainConfig(**common["train"]))
    trun = RunConfig(model=get_smoke_config("starcoder2-7b"),
                     shape=ShapeSpec("tiny", 8, 4, "train"),
                     adapter=AdapterConfig(**common["adapter"]),
                     train=TrainConfig(**common["train"]))
    return jrun, trun


@pytest.fixture(scope="module")
def jbase():
    """One random base for every JAX run here (jitted: the eager init
    dispatches op by op)."""
    return jax.jit(JLM.init_params, static_argnums=0)(
        _runs()[0].model, jax.random.PRNGKey(0))


def np_init_adapter(key, params, acfg, calib_grads=None):
    """The JAX ``init_adapter`` of a rand-mask SHiRA adapter, its indices
    drawn with numpy from the key's seed (``PRNGKey(s)`` holds [0, s])."""
    seed = int(np.asarray(jax.random.key_data(key)).reshape(-1)[-1])
    idx = np_indices(params, acfg.sparsity, np.random.default_rng(seed),
                     acfg.target_modules)
    tree = jax.tree_util.tree_map_with_path(
        lambda p, w: jnp.asarray(idx[jcore.masks.path_str(p)])
        if jcore.masks.path_str(p) in idx else None, params)
    values = jax.tree.map(lambda i: None if i is None
                          else jnp.zeros(i.shape, jnp.float32), tree,
                          is_leaf=lambda x: x is None)
    return values, {"indices": tree}


def _pair(jbase, moments, A):
    """The JAX run and the port's run on its base and indices."""
    jrun, trun = _runs()
    names = [f"a{a}" for a in range(A)]
    with JL.compute_precision(jnp.float32), pytest.MonkeyPatch.context() \
            as mp:
        mp.setattr(jcore, "init_adapter", np_init_adapter)
        jm = JMulti(jrun, names, init_key=0, moments=moments,
                    base_params=jbase)
        jout = jm.fit(STEPS, log=None)
    base = bridge.params_from_numpy(jax.tree.map(np.asarray, jm.base), "cpu")
    auxes = [bridge.adapter_from_numpy(
        jax.tree.map(np.asarray, x["indices"]), "cpu")[1] for x in jm.auxes]
    with TL.compute_precision(torch.float32):
        tm = MultiAdapterTrainer(trun, names, base_params=base, auxes=auxes,
                                 moments=moments, device="cpu")
        tout = tm.fit(STEPS, log=None)
    return trun, jm, jout, tm, tout


@pytest.fixture(scope="module")
def f32_run(jbase):
    return _pair(jbase, "f32", 3)


def _check_vs_jax(jm, jout, tm, tout):
    for n in tm.names:
        np.testing.assert_allclose(
            [h[f"loss:{n}"] for h in tout["history"]],
            [h[f"loss:{n}"] for h in jout["history"]], **TOL)
    for pack, jpack in zip(tm.export_packs(tout["state"]),
                           jm.export_packs(jout["state"])):
        assert pack.name == jpack.name
        assert set(pack.entries) == set(jpack.entries)
        for path, (idx, v) in pack.entries.items():
            np.testing.assert_array_equal(
                idx.numpy(), np.asarray(jpack.entries[path][0]))
            np.testing.assert_allclose(
                v.numpy(), np.asarray(jpack.entries[path][1]), **TOL)


def _check_vs_trainer(trun, tm, tout, tol):
    with TL.compute_precision(torch.float32):
        for a, pack in enumerate(tm.export_packs(tout["state"])):
            tr = Trainer(trun, base_params=tm.base, aux=tm.auxes[a],
                         device="cpu")
            ref = tr.fit(STEPS, log=None, batches=batch_iterator(
                trun.model, trun.shape, seed=trun.train.seed,
                task=TaskSpec(a)))
            np.testing.assert_allclose(
                [h[f"loss:{pack.name}"] for h in tout["history"]],
                [h["loss"] for h in ref["history"]], **TOL)
            ref_pack = tr.export_pack(ref["state"], pack.name)
            for path, (_, v) in pack.entries.items():
                np.testing.assert_allclose(
                    v.numpy(), ref_pack.entries[path][1].numpy(), **tol)


def test_three_adapters_match_jax_multi_trainer(f32_run):
    _, jm, jout, tm, tout = f32_run
    _check_vs_jax(jm, jout, tm, tout)


def test_every_adapter_learns():
    """On a batch seen again at every step, each adapter's loss falls (on
    the stream, 4 steps at this size are within the batches' spread)."""
    _, trun = _runs()
    with TL.compute_precision(torch.float32):
        mt = MultiAdapterTrainer(trun, ["a0", "a1"], device="cpu")
        batch = next(multi_batch_iterator(trun.model, trun.shape, 0,
                                          [TaskSpec(0), TaskSpec(1)]))
        hist = mt.fit(6, batches=iter([batch] * 6), log=None)["history"]
    for n in mt.names:
        assert hist[-1][f"loss:{n}"] < hist[0][f"loss:{n}"] - 0.05, hist


def test_three_adapters_track_single_adapter_trainers(f32_run):
    trun, _, _, tm, tout = f32_run
    _check_vs_trainer(trun, tm, tout, TOL)


def test_rejects_unported_and_bad_options():
    _, trun = _runs()
    lora = RunConfig(model=trun.model, shape=trun.shape,
                     adapter=AdapterConfig(kind="lora"))
    with pytest.raises(NotImplementedError, match="A2"):
        MultiAdapterTrainer(lora, ["a0"], device="cpu")
    with pytest.raises(ValueError, match="moments"):
        MultiAdapterTrainer(trun, ["a0"], moments="fp4", device="cpu")
    mt = MultiAdapterTrainer(trun, ["a0"], device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        mt.publish(None, None, ckpt=object())
