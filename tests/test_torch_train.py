"""Packed SHiRA training in repro_torch against repro on the same weights,
indices and batches.

The JAX smoke config's base (jax.random init) and its adapter's ``wm``
indices cross over through repro_torch.bridge (the ``wm`` mask is a top-K
of the weights, the same in every process, where the JAX rand mask salts
its draws with Python's per-process string hash); batches come from each
package's own synthetic pipeline (bit-identical, test_torch_data.py). Both
run in f32 (``compute_precision(float32)``). The loss agrees to 1e-5
relative and its gradient with respect to the packed values to 1e-4 of the
largest entry: the same f32 products summed in another order, through two
layers and the chunked loss. Trainer runs agree to rtol = atol = 5e-3, the
JAX package's own tolerance for trainer trajectories
(tests/test_multiadapter.py), since AdamW's normalised step amplifies the
last-bit differences of near-zero gradients. On the CPU the port's kernel
wrappers compute their plain versions (scatter_apply in materialize,
sparse_adamw in the update).
"""
import os
import subprocess
import sys
from pathlib import Path

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
from repro.data import batch_iterator as j_batches
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.runtime import Trainer as JTrainer
from repro_torch import bridge
from repro_torch import core as tcore
from repro_torch.configs import (AdapterConfig, RunConfig, ShapeSpec,
                                 TrainConfig, get_smoke_config)
from repro_torch.core.masks import iter_leaves
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.runtime import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]
STEPS, LR = 4, 1e-2
TRAJ_TOL = 5e-3


def _runs(sparsity=0.95):
    jrun = JRunConfig(model=j_smoke("starcoder2-7b"),
                      shape=JShapeSpec("tiny", 8, 4, "train"),
                      adapter=JAdapterConfig(kind="shira", mask="wm",
                                             sparsity=sparsity),
                      train=JTrainConfig(learning_rate=LR,
                                         total_steps=STEPS, warmup_steps=2))
    trun = RunConfig(model=get_smoke_config("starcoder2-7b"),
                     shape=ShapeSpec("tiny", 8, 4, "train"),
                     adapter=AdapterConfig(kind="shira", mask="wm",
                                           sparsity=sparsity),
                     train=TrainConfig(learning_rate=LR, total_steps=STEPS,
                                       warmup_steps=2))
    return jrun, trun


@pytest.fixture(scope="module")
def setup():
    jrun, trun = _runs()
    jbase = JLM.init_params(jrun.model, jax.random.PRNGKey(0))
    _, jaux = jcore.init_adapter(jax.random.PRNGKey(0), jbase, jrun.adapter)
    np_base = jax.tree.map(np.asarray, jbase)
    np_idx = jax.tree.map(np.asarray, jaux["indices"])
    return jrun, trun, jbase, jaux, np_base, np_idx


def _port_trainer(trun, np_base, np_idx, **kw):
    return Trainer(trun, TrainerConfig(),
                   base_params=bridge.params_from_numpy(np_base, "cpu"),
                   aux=bridge.adapter_from_numpy(np_idx, "cpu")[1],
                   device="cpu", **kw)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 5, 17)).astype(np.float32) * 3
    labels = rng.integers(0, 17, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                None if m is None else jnp.asarray(m))
        got = TL.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels),
                               None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.fixture(scope="module")
def grad_case(setup):
    """Nonzero packed values, a batch, and the JAX loss and value
    gradients through ``core.materialize`` (computed once for every remat
    policy of the port)."""
    jrun, trun, jbase, jaux, np_base, np_idx = setup
    rng = np.random.default_rng(1)
    np_vals = jax.tree.map(
        lambda i: (0.05 * rng.standard_normal(i.shape)).astype(np.float32),
        np_idx)
    batch = next(j_batches(jrun.model, jrun.shape, seed=3))
    with JL.compute_precision(jnp.float32):
        def jloss(vals):
            eff = jcore.materialize(jbase, vals, jaux, jrun.adapter,
                                    alpha=1.0)
            return JLM.train_loss(eff, jrun.model, {
                k: jnp.asarray(v) for k, v in batch.items()})[0]
        loss, grads = jax.jit(jax.value_and_grad(jloss))(
            jax.tree.map(jnp.asarray, np_vals))
    flat = {jcore.masks.path_str(p): np.asarray(g) for p, g in
            jax.tree_util.tree_flatten_with_path(grads)[0]}
    return np_vals, batch, float(loss), flat


@pytest.mark.parametrize("remat", ["full", "none"])
def test_train_loss_and_value_grads_match_jax(setup, grad_case, remat):
    _, trun, _, _, np_base, np_idx = setup
    np_vals, batch, want, jgrads = grad_case
    cfg = trun.model.replace(remat=remat)
    base = bridge.params_from_numpy(np_base, "cpu")
    _, aux = bridge.adapter_from_numpy(np_idx, "cpu")
    vals = bridge.params_from_numpy(np_vals, "cpu")
    leaves = [v.requires_grad_(True) for _, v in iter_leaves(vals)]
    with TL.compute_precision(torch.float32):
        eff = tcore.materialize(base, vals, aux, trun.adapter, alpha=1.0)
        got, metrics = TLM.train_loss(eff, cfg, {
            k: torch.from_numpy(v).long() for k, v in batch.items()})
        grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-5)
    assert float(metrics["ce"].detach()) == float(got.detach())
    paths = [p for p, _ in iter_leaves(vals)]
    assert sorted(paths) == sorted(jgrads)
    for p, g in zip(paths, grads):
        scale = np.abs(jgrads[p]).max()
        np.testing.assert_allclose(g.numpy(), jgrads[p], rtol=1e-4,
                                   atol=1e-4 * scale)


def test_trainer_matches_jax_trainer(setup):
    jrun, trun, jbase, jaux, np_base, np_idx = setup
    with JL.compute_precision(jnp.float32):
        jt = JTrainer(jrun, init_key=0, base_params=jbase)
        ref = jt.fit(STEPS, log=None)
    with TL.compute_precision(torch.float32):
        tt = _port_trainer(trun, np_base, np_idx)
        out = tt.fit(STEPS, log=None)
    np.testing.assert_allclose([h["loss"] for h in out["history"]],
                               [h["loss"] for h in ref["history"]],
                               rtol=TRAJ_TOL, atol=TRAJ_TOL)
    np.testing.assert_allclose([h["lr"] for h in out["history"]],
                               [h["lr"] for h in ref["history"]], rtol=1e-6)
    pack = tt.export_pack(out["state"], "a")
    jpack = jt.export_pack(ref["state"], "a")
    assert set(pack.entries) == set(jpack.entries)
    for path, (idx, v) in pack.entries.items():
        np.testing.assert_array_equal(idx.numpy(),
                                      np.asarray(jpack.entries[path][0]))
        np.testing.assert_allclose(v.numpy(), np.asarray(
            jpack.entries[path][1]), rtol=TRAJ_TOL, atol=TRAJ_TOL)
    # the run learns: loss falls over the steps
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0], losses


def test_export_pack_loads_like_materialize(setup):
    """The exported pack, loaded into a base copy by apply_pack, serves the
    logits of the materialized tree it was trained through."""
    jrun, trun, _, _, np_base, np_idx = setup
    with TL.compute_precision(torch.float32):
        tt = _port_trainer(trun, np_base, np_idx)
        state = tt.fit(2, log=None)["state"]
        pack = tt.export_pack(state, "a")
        toks = torch.from_numpy(np.random.default_rng(2).integers(
            0, trun.model.vocab_size, (2, 6)))
        eff = tcore.materialize(tt.base, state["trainable"], tt.aux,
                                trun.adapter, alpha=1.0)
        want, _ = TLM.prefill(eff, trun.model, {"tokens": toks}, 8)
        loaded = tcore.apply_pack(
            bridge.params_from_numpy(np_base, "cpu"), pack)
        got, _ = TLM.prefill(loaded, trun.model, {"tokens": toks}, 8)
    assert any(float(v.abs().max()) > 0 for _, v in pack.entries.values())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_unported_options_raise(setup, tmp_path):
    """The training options that raised until they were ported now run:
    the adapter kinds, checkpoints and fault injection, and the "dots"
    remat policy (held against "full" and the JAX package in
    tests/test_torch_archs.py); an unknown remat policy raises."""
    _, trun, _, _, np_base, np_idx = setup
    bad = RunConfig(model=trun.model.replace(remat="some"),
                    shape=trun.shape, adapter=trun.adapter,
                    train=trun.train)
    tt = _port_trainer(bad, np_base, np_idx)
    with pytest.raises(ValueError, match="remat"):
        tt.fit(1, log=None)
    assert tlaunch.parse_adapter("lora").kind == "lora"
    tt = Trainer(trun, TrainerConfig(ckpt_dir=str(tmp_path)),
                 base_params=bridge.params_from_numpy(np_base, "cpu"),
                 aux=bridge.adapter_from_numpy(np_idx, "cpu")[1],
                 device="cpu")
    seen = []
    tt.fit(1, fault_injector=seen.append, log=None)
    assert seen == [0] and tt.ckpt.steps() == [1]
    lora = RunConfig(model=trun.model, shape=trun.shape,
                     adapter=AdapterConfig(kind="lora"))
    assert Trainer(lora, device="cpu").trainable0 is not None


def test_train_cli_smoke_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "starcoder2-7b", "--smoke", "--device", "cpu", "--adapter",
         "shira-rand", "--steps", "3", "--seq", "16", "--batch", "2"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("[train]")]
    assert len(line) == 1 and "adapter=shira-rand loss" in line[0], \
        proc.stdout
