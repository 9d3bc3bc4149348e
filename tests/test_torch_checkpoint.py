"""Checkpoints and preemption recovery in repro_torch against repro
(tests/test_ft.py is the checklist).

The port writes the reference's on-disk format (one .npz per tree keyed
by the reference's path_str, bf16 as its uint16 view, the .json manifest,
meta.json and the COMMITTED marker), so a checkpoint written by either
package restores in the other: both directions are held here bit for bit.
Preemption recovery is held as the reference holds its own: the resumed
run's last loss within 1e-6 of a clean run's (tests/test_ft.py). The port's
clean run tracks the JAX Trainer's clean run on the same weights and
indices (bridged through numpy) to rtol = atol = 5e-3, the trainer-parity
tolerance of tests/test_torch_train.py: the two packages sum f32 products
in another order, and AdamW's normalised step amplifies the last bits.
"""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.checkpoint import CheckpointManager as JManager
from repro.configs import AdapterConfig as JAdapterConfig
from repro.configs import RunConfig as JRunConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.runtime import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager, restore_tree, save_tree
from repro_torch.configs import (AdapterConfig, RunConfig, ShapeSpec,
                                 TrainConfig, get_smoke_config)
from repro_torch.core.masks import iter_leaves
from repro_torch.hub import AdapterStore
from repro_torch.models import layers as TL
from repro_torch.runtime import SimulatedPreemption, Trainer, TrainerConfig
from repro_torch.training import MultiAdapterTrainer

STEPS, TRAJ_TOL, RESUME_TOL = 6, 5e-3, 1e-6


def _runs(mask="wm"):
    adapter = dict(kind="shira", mask=mask, sparsity=0.95)
    train = dict(learning_rate=5e-3, total_steps=20, warmup_steps=2)
    jrun = JRunConfig(model=j_smoke("starcoder2-7b"),
                      shape=JShapeSpec("tiny", 16, 2, "train"),
                      adapter=JAdapterConfig(**adapter),
                      train=JTrainConfig(**train))
    trun = RunConfig(model=get_smoke_config("starcoder2-7b"),
                     shape=ShapeSpec("tiny", 16, 2, "train"),
                     adapter=AdapterConfig(**adapter),
                     train=TrainConfig(**train))
    return jrun, trun


@pytest.fixture(scope="module")
def jax_side():
    """The JAX base and wm indices as numpy, and a JAX Trainer on them."""
    jrun, trun = _runs()
    jbase = jax.jit(JLM.init_params, static_argnums=0)(
        jrun.model, jax.random.PRNGKey(0))
    jt = JTrainer(jrun, JTrainerConfig(log_every=1000), init_key=0,
                  base_params=jbase)
    return (jrun, trun, jt, jax.tree.map(np.asarray, jbase),
            jax.tree.map(np.asarray, jt.aux["indices"]))


def _port(trun, np_base, np_idx, ckpt_dir=None, **kw):
    return Trainer(trun, TrainerConfig(ckpt_dir=ckpt_dir, log_every=1000,
                                       **kw),
                   base_params=bridge.params_from_numpy(np_base, "cpu"),
                   aux=bridge.adapter_from_numpy(np_idx, "cpu")[1],
                   device="cpu")


def _flat_jax(tree):
    return {jcore.masks.path_str(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_port(tree):
    out = {p: x.numpy() for p, x in iter_leaves(
        {k: v for k, v in tree.items() if k != "step"})}
    out["step"] = np.asarray(tree["step"], np.int32)
    return out


def test_checkpoint_keep_k_and_commit_marker(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"x": torch.arange(4.0)}
    for s in (10, 20, 30, 40):
        mgr.save(s, {"state": tree}, meta={"arch": "t"})
    assert mgr.steps() == [30, 40]
    os.makedirs(tmp_path / "step_00000099")   # uncommitted: invisible
    assert mgr.latest_step() == 40
    assert sorted(os.listdir(tmp_path / "step_00000040")) == [
        "COMMITTED", "meta.json", "state.json", "state.npz"]
    out = mgr.restore({"state": {"x": torch.zeros(4)}})
    assert out["step"] == 40 and torch.equal(out["state"]["x"],
                                             torch.arange(4.0))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({"state": tree})


def test_checkpoint_restore_dtype_and_shape_guard(tmp_path):
    w = torch.linspace(-3, 3, 16).reshape(4, 4)
    tree = {"w": w, "h": w.to(torch.bfloat16), "n": [torch.arange(3)],
            "step": 7}
    save_tree(tree, str(tmp_path))
    with np.load(tmp_path / "state.npz") as data:
        assert data["h"].dtype == np.uint16      # bf16 as its uint16 view
        assert data["step"].dtype == np.int32 and data["step"].shape == ()
        assert sorted(data.files) == ["h", "n/0", "step", "w"]
    tpl = {"w": torch.zeros(4, 4), "h": torch.zeros(4, 4,
                                                    dtype=torch.bfloat16),
           "n": [torch.zeros(3, dtype=torch.int64)], "step": 0}
    out = restore_tree(tpl, str(tmp_path))
    assert torch.equal(out["w"], w) and out["step"] == 7
    assert out["h"].dtype == torch.bfloat16 and torch.equal(
        out["h"], w.to(torch.bfloat16))
    assert isinstance(out["n"], list) and torch.equal(out["n"][0],
                                                      torch.arange(3))
    # restore onto another device than the writer's: the template's, or
    # the one asked for (the counterpart of the reference's re-mesh)
    meta = restore_tree(tpl, str(tmp_path), device="meta")
    assert meta["w"].device.type == "meta" and meta["w"].shape == (4, 4)
    with pytest.raises(ValueError):
        restore_tree({"w": torch.zeros(2, 2)}, str(tmp_path))
    with pytest.raises(KeyError):
        restore_tree({"nope": torch.zeros(4, 4)}, str(tmp_path))


def test_orphan_uncommitted_dirs_are_pruned(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    # a save_adapter whose committing save never ran (a preemption between)
    os.makedirs(tmp_path / "step_00000005")
    (tmp_path / "step_00000005" / "adapter_a.shpk").write_bytes(b"x")
    os.makedirs(tmp_path / "step_00000050")         # newer: in progress
    for s in (10, 20, 30):
        mgr.save(s, {"state": {"x": torch.ones(2)}})
    assert mgr.steps() == [20, 30]
    assert not (tmp_path / "step_00000005").exists()
    assert not (tmp_path / "step_00000010").exists()
    assert (tmp_path / "step_00000050").exists()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_read_across_packages(jax_side, tmp_path, writer):
    """A Trainer state and a bf16 tree written by one package restore in
    the other, bit for bit."""
    jrun, trun, jt, np_base, np_idx = jax_side
    rng = np.random.default_rng(0)
    jstate = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(x.dtype))
        if x.ndim else jnp.asarray(5, x.dtype), jt.init_state())
    want = _flat_jax(jstate)
    half = rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16)
    tt = _port(trun, np_base, np_idx)
    d = str(tmp_path)
    if writer == "jax":
        JManager(d).save(3, {"state": jstate,
                             "aux": {"h": jnp.asarray(half)}})
        out = CheckpointManager(d).restore(
            {"state": tt.init_state(),
             "aux": {"h": torch.zeros(3, 5, dtype=torch.bfloat16)}})
        got = _flat_port(out["state"])
        h = out["aux"]["h"].view(torch.int16).numpy().view(np.uint16)
        assert out["state"]["step"] == 5 and isinstance(
            out["state"]["step"], int)
    else:
        pstate = bridge.params_from_numpy(jax.tree.map(np.asarray, jstate),
                                          "cpu")
        pstate["step"] = int(pstate["step"])
        CheckpointManager(d).save(3, {"state": pstate, "aux": {
            "h": torch.from_numpy(half.view(np.int16)).view(
                torch.bfloat16)}})
        out = JManager(d).restore({"state": jt.init_state(),
                                   "aux": {"h": jnp.zeros((3, 5),
                                                          jnp.bfloat16)}})
        got = _flat_jax(out["state"])
        h = np.asarray(out["aux"]["h"]).view(np.uint16)
    assert out["step"] == 3
    assert set(got) == set(want) and len(want) > 4
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    np.testing.assert_array_equal(h, half.view(np.uint16))


def test_save_and_restore_adapter(jax_side, tmp_path):
    jrun, trun, jt, np_base, np_idx = jax_side
    tt = _port(trun, np_base, np_idx, ckpt_dir=str(tmp_path))
    state = tt.fit(2, log=None)["state"]
    store = AdapterStore(str(tmp_path / "store"))
    vid = tt.publish(store, state, "a")
    assert vid == "a@1" and tt.ckpt.adapters(2) == ["a@1"]
    want = tt.export_pack(state, "a")
    for mgr in (tt.ckpt, JManager(str(tmp_path))):   # either package reads
        got = mgr.restore_adapter("a@1", step=2)
        for p, (i, v) in want.entries.items():
            np.testing.assert_array_equal(np.asarray(got.entries[p][0]),
                                          i.numpy())
            np.testing.assert_array_equal(np.asarray(got.entries[p][1]),
                                          v.numpy())
    assert tt.ckpt.adapters(9) == []


def _preempt_at(step):
    hits = {"n": 0}

    def injector(s):
        if s == step and hits["n"] == 0:
            hits["n"] += 1
            raise SimulatedPreemption()
    return injector, hits


def test_preemption_recovery_is_deterministic(jax_side, tmp_path):
    jrun, trun, jt, np_base, np_idx = jax_side
    with TL.compute_precision(torch.float32):
        clean = _port(trun, np_base, np_idx, str(tmp_path / "a"),
                      ckpt_every=2).fit(STEPS, log=None)
        injector, hits = _preempt_at(3)
        logs = []
        tt = _port(trun, np_base, np_idx, str(tmp_path / "b"), ckpt_every=2,
                   keep=2)
        resumed = tt.fit(STEPS, fault_injector=injector, log=logs.append)
    assert hits["n"] == 1
    assert [m for m in logs if "preempted" in m] == [
        "[trainer] preempted: restored step 2"]
    assert tt.ckpt.steps() == [4, 6]
    assert abs(clean["history"][-1]["loss"]
               - resumed["history"][-1]["loss"]) < RESUME_TOL
    # the port's clean run tracks the JAX Trainer's on the same indices
    with JL.compute_precision(jnp.float32):
        ref = JTrainer(jrun, JTrainerConfig(log_every=1000), init_key=0,
                       base_params=jax.tree.map(jnp.asarray, np_base)
                       ).fit(STEPS, log=None)
    np.testing.assert_allclose([h["loss"] for h in clean["history"]],
                               [h["loss"] for h in ref["history"]],
                               rtol=TRAJ_TOL, atol=TRAJ_TOL)
    # without a checkpoint a preempted run restarts from scratch
    injector, hits = _preempt_at(1)
    logs = []
    with TL.compute_precision(torch.float32):
        again = _port(trun, np_base, np_idx).fit(
            3, fault_injector=injector, log=logs.append)
    assert "[trainer] preempted, no checkpoint: restarting" in logs
    np.testing.assert_allclose(again["history"][-1]["loss"],
                               clean["history"][2]["loss"], atol=RESUME_TOL)


def test_resume_across_a_fresh_trainer(tmp_path):
    """A new process (a fresh Trainer on the same init_key) draws the same
    rand mask, resumes at the latest committed step and takes only the
    steps left; its last loss equals an uninterrupted run's. The straggler
    monitor records every step taken."""
    _, trun = _runs(mask="rand")
    cfg = TrainerConfig(ckpt_dir=str(tmp_path / "r"), ckpt_every=2,
                        log_every=1000)
    with TL.compute_precision(torch.float32):
        base = Trainer(trun, device="cpu").base
        first = Trainer(trun, cfg, base_params=base, device="cpu")
        first.fit(4, log=None)
        second = Trainer(trun, cfg, base_params=base, device="cpu")
        for (p, a), (q, b) in zip(iter_leaves(first.aux),
                                  iter_leaves(second.aux)):
            assert p == q and torch.equal(a, b)
        seen = []
        second.monitor.record = lambda host, dt: seen.append((host, dt))
        logs = []
        out = second.fit(STEPS, log=logs.append)
        whole = Trainer(trun, TrainerConfig(log_every=1000),
                        base_params=base, device="cpu").fit(STEPS, log=None)
    assert "[trainer] resumed from step 4" in logs
    assert len(out["history"]) == 2 and out["state"]["step"] == STEPS
    assert [h for h, _ in seen] == [0, 0] and all(dt > 0 for _, dt in seen)
    assert abs(out["history"][-1]["loss"]
               - whole["history"][-1]["loss"]) < RESUME_TOL
    assert second.ckpt.steps() == [2, 4, 6]


def test_straggler_monitor_records_each_step(jax_side):
    _, trun, _, np_base, np_idx = jax_side
    tt = _port(trun, np_base, np_idx)
    tt.fit(3, log=None)
    assert set(tt.monitor.ewma) == {0} and tt.monitor.ewma[0] > 0
    assert tt.monitor.end_step().healthy


def test_multi_adapter_publish_snapshots_into_a_checkpoint(tmp_path):
    _, trun = _runs(mask="rand")
    mt = MultiAdapterTrainer(trun, ["a0", "a1"], device="cpu")
    out = mt.fit(2, log=None)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    store = AdapterStore(str(tmp_path / "store"))
    vids = mt.publish(store, out["state"], ckpt=mgr)
    assert vids == ["a0@1", "a1@1"] and mgr.adapters(2) == vids
    assert mgr.steps() == []                 # not committed until a save
    mgr.save(2, {"state": out["state"]})
    assert mgr.steps() == [2]
    for vid, want in zip(vids, mt.export_packs(out["state"])):
        got = mgr.restore_adapter(vid)
        assert got.name == vid
        for p, (i, v) in want.entries.items():
            assert torch.equal(got.entries[p][0], i)
            assert torch.equal(got.entries[p][1], v)
    assert mt.publish(store, out["state"], ckpt=mgr, step=7) == [
        "a0@2", "a1@2"] and mgr.adapters(7) == ["a0@2", "a1@2"]
