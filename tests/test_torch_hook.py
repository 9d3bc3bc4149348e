"""Hook-mode SHiRA training (paper App. C) in repro_torch against repro.

The JAX smoke config's base (jax.random init) crosses over through
repro_torch.bridge; both packages build their own ``wm`` masks (a top-K of
|W|, the same entries in both) and run in f32 (``compute_precision``). The
JAX hook-mode Trainer reaches no Pallas kernel; the port's step takes
dense gradients of the target leaves, the reference's AdamW direction, and
the ``masked_update`` kernel's plain version on these CPU tensors.

Tolerances: dense gradients agree to 1e-4 of each leaf's largest entry
(the same f32 products summed in another order); loss and lr trajectories,
and the trained weights at the mask's entries, to rtol = atol = 5e-3, the
packed trainer's tolerance (tests/test_torch_train.py), since AdamW's
normalised step amplifies the last-bit differences of near-zero
gradients. One step from the same state (lr > 0: the schedule runs two
steps past the trajectory) moves the masked weights by the same lr * U to
1e-4 of lr, and the moments agree to 1e-4 of each leaf's largest, the
gradients' tolerance. Off the mask the weights keep their bits. Exported
packs are compared by the delta they apply: their top-K ties among entries
that did not move may list other indices. The port's hook and packed runs on one
mask agree to 2e-3, the reference's own claim
(tests/test_training.py::test_hook_vs_packed_equivalence).
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
from repro.core import switching as jswitching
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
from repro_torch.runtime import Trainer
from repro_torch.runtime.trainer import dense_grads, device_batch

STEPS, LR, SPARSITY = 3, 1e-2, 0.9
TRAJ_TOL = 5e-3
STEP_TOL = 1e-4     # one step from one state: the gradients' tolerance
HOOK_VS_PACKED = 2e-3


def _runs(packed=False, wd=0.0):
    adapter = dict(kind="shira", mask="wm", sparsity=SPARSITY,
                   packed=packed)
    train = dict(learning_rate=LR, total_steps=STEPS + 2, warmup_steps=2,
                 weight_decay=wd)
    jrun = JRunConfig(model=j_smoke("starcoder2-7b"),
                      shape=JShapeSpec("tiny", 8, 4, "train"),
                      adapter=JAdapterConfig(**adapter),
                      train=JTrainConfig(**train))
    trun = RunConfig(model=get_smoke_config("starcoder2-7b"),
                     shape=ShapeSpec("tiny", 8, 4, "train"),
                     adapter=AdapterConfig(**adapter),
                     train=TrainConfig(**train))
    return jrun, trun


def _flat(tree):
    return {jcore.masks.path_str(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def runs():
    """3 hook-mode steps in each package from one base, and the JAX
    state as numpy after them."""
    jrun, trun = _runs()
    jbase = jax.jit(JLM.init_params, static_argnums=0)(
        jrun.model, jax.random.PRNGKey(0))
    np_base = jax.tree.map(np.asarray, jbase)
    with JL.compute_precision(jnp.float32):
        jt = JTrainer(jrun, init_key=0, base_params=jbase)
        ref = jt.fit(STEPS, log=None)
    np_state = jax.tree.map(np.asarray, ref["state"])
    with TL.compute_precision(torch.float32):
        tt = Trainer(trun, base_params=bridge.params_from_numpy(np_base,
                                                                "cpu"),
                     device="cpu")
        out = tt.fit(STEPS, log=None)
    return jt, ref, np_state, np_base, tt, out


def test_hook_trainer_matches_jax_trainer(runs):
    jt, ref, np_state, np_base, tt, out = runs
    np.testing.assert_allclose([h["loss"] for h in out["history"]],
                               [h["loss"] for h in ref["history"]],
                               rtol=TRAJ_TOL, atol=TRAJ_TOL)
    np.testing.assert_allclose([h["lr"] for h in out["history"]],
                               [h["lr"] for h in ref["history"]], rtol=1e-6)
    jmasks = _flat(jt.masks)
    masks = dict(iter_leaves(tt.masks))
    assert set(masks) == set(jmasks)
    jw, base = _flat(np_state["trainable"]), _flat(np_base)
    w = dict(iter_leaves(out["state"]["trainable"]))
    base_t = dict(iter_leaves(tt.base))
    assert set(w) == set(jw)
    for p, x in w.items():
        if p not in masks:              # not a target: the base's tensor
            assert x is base_t[p]
            continue
        m = masks[p].numpy()
        np.testing.assert_array_equal(m.astype(np.float32), jmasks[p])
        np.testing.assert_array_equal(x.numpy()[~m], base[p][~m])
        np.testing.assert_array_equal(jw[p][~m], base[p][~m])
        np.testing.assert_allclose(x.numpy()[m], jw[p][m], rtol=TRAJ_TOL,
                                   atol=TRAJ_TOL, err_msg=p)
        assert (x.numpy()[m] != base[p][m]).mean() > 0.9, p
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0], losses


def _dense_delta(pack, shapes):
    out = {}
    for p, (idx, val) in pack.entries.items():
        idx, val = np.asarray(idx), np.asarray(val)
        *lead, n, m = shapes[p]
        d = np.zeros((idx.size // idx.shape[-1], n * m), np.float32)
        np.put_along_axis(d, idx.reshape(d.shape[0], -1).astype(np.int64),
                          val.reshape(d.shape[0], -1), axis=1)
        out[p] = d.reshape(shapes[p])
    return out


def test_export_pack_matches_jax_by_delta(runs):
    jt, ref, np_state, np_base, tt, out = runs
    shapes = {p: x.shape for p, x in _flat(np_base).items()}
    pack = tt.export_pack(out["state"], "a")
    jpack = jt.export_pack(ref["state"], "a")
    assert set(pack.entries) == set(jpack.entries)
    got, want = _dense_delta(pack, shapes), _dense_delta(jpack, shapes)
    for p, (idx, val) in pack.entries.items():
        assert idx.dtype == torch.int32 and val.dtype == torch.float32
        rows = idx.reshape(-1, idx.shape[-1])
        assert bool((rows[:, 1:] > rows[:, :-1]).all())    # ascending
        np.testing.assert_array_equal(got[p] != 0, want[p] != 0, err_msg=p)
        np.testing.assert_allclose(got[p], want[p], rtol=TRAJ_TOL,
                                   atol=TRAJ_TOL, err_msg=p)
    # the pack loads onto the base as the trained weights
    loaded = tcore.apply_pack(bridge.params_from_numpy(np_base, "cpu"), pack)
    for p, w in iter_leaves(out["state"]["trainable"]):
        np.testing.assert_allclose(dict(iter_leaves(loaded))[p].numpy(),
                                   w.numpy(), rtol=0, atol=1e-6, err_msg=p)
    frac = tcore.changed_fraction(tt.base, out["state"]["trainable"])
    assert frac == pytest.approx(jswitching.changed_fraction(
        np_base, np_state["trainable"]), rel=1e-3)
    assert 0 < frac <= 1 - SPARSITY


def test_one_step_from_the_jax_state(runs):
    """Both packages take the same fourth step, at lr > 0, from the JAX
    state."""
    jt, _, np_state, _, tt, _ = runs
    lr = tt.schedule(STEPS)
    assert lr > 0
    batch = next(j_batches(jt.cfg, jt.run.shape, seed=7))
    state = bridge.hook_state_from_numpy(np_state, tt.masks, "cpu")
    with JL.compute_precision(jnp.float32):
        jnew, jm = jt._step_fn(jax.tree.map(jnp.array, np_state),  # copies
                               {k: jnp.asarray(v) for k, v in batch.items()})
    with TL.compute_precision(torch.float32):
        new, m = tt.step(state, device_batch(batch, "cpu"))
    assert new["step"] == int(jnew["step"]) == STEPS + 1
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    masks = dict(iter_leaves(tt.masks))
    w0, jw = _flat(np_state["trainable"]), _flat(jnew["trainable"])
    for p, w in iter_leaves(new["trainable"]):
        x = w.numpy()
        if p not in masks:
            np.testing.assert_array_equal(x, w0[p], err_msg=p)
            np.testing.assert_array_equal(jw[p], w0[p], err_msg=p)
            continue
        on = masks[p].numpy()
        np.testing.assert_array_equal(x[~on], w0[p][~on], err_msg=p)
        np.testing.assert_array_equal(jw[p][~on], w0[p][~on], err_msg=p)
        jstep = jw[p][on] - w0[p][on]
        assert (jstep != 0).mean() > 0.9, p        # the step moves W
        np.testing.assert_allclose(x[on], jw[p][on], rtol=0,
                                   atol=STEP_TOL * lr, err_msg=p)
    for key in ("mu", "nu"):
        want = _flat(jnew[key])
        assert {p for p, _ in iter_leaves(new[key])} == set(masks)
        for p, x in iter_leaves(new[key]):
            scale = np.abs(want[p]).max()
            np.testing.assert_allclose(x.numpy(), want[p], rtol=STEP_TOL,
                                       atol=STEP_TOL * scale,
                                       err_msg=f"{key} {p}")


def test_dense_grads_match_jax():
    """The hook step's (and the grad/snip masks') dense gradients of the
    target leaves, against ``jax.grad`` of the reference loss."""
    jrun, trun = _runs()
    jbase = jax.jit(JLM.init_params, static_argnums=0)(
        jrun.model, jax.random.PRNGKey(1))
    batch = next(j_batches(jrun.model, jrun.shape, seed=3))
    with JL.compute_precision(jnp.float32):
        jg = _flat(jax.jit(jax.grad(lambda p: JLM.train_loss(
            p, jrun.model, {k: jnp.asarray(v)
                            for k, v in batch.items()})[0]))(jbase))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jbase), "cpu")
    with TL.compute_precision(torch.float32):
        _, _, grads = dense_grads(params, trun.model,
                                  device_batch(batch, "cpu"),
                                  trun.adapter.target_modules)
    assert set(grads) == {p for p in jg if p.rsplit("/", 1)[-1]
                          in trun.adapter.target_modules}
    for p, g in grads.items():
        scale = np.abs(jg[p]).max()
        np.testing.assert_allclose(g.numpy(), jg[p], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=p)
    assert all(not x.requires_grad for _, x in iter_leaves(params))


def test_hook_and_packed_agree():
    """App. C == App. D on one mask, in the port alone."""
    _, hook_run = _runs(packed=False)
    _, packed_run = _runs(packed=True)
    hist, packs = [], []
    with TL.compute_precision(torch.float32):
        for run in (hook_run, packed_run):
            t = Trainer(run, device="cpu")
            out = t.fit(STEPS, log=None)
            hist.append([h["loss"] for h in out["history"]])
            packs.append(t.export_pack(out["state"]))
    np.testing.assert_allclose(hist[0], hist[1], rtol=HOOK_VS_PACKED,
                               atol=HOOK_VS_PACKED)
    shapes = {p: x.shape for p, x in iter_leaves(t.base)}
    hook, packed = (_dense_delta(p, shapes) for p in packs)
    for p in packed:
        np.testing.assert_allclose(hook[p], packed[p], rtol=HOOK_VS_PACKED,
                                   atol=HOOK_VS_PACKED, err_msg=p)


@pytest.mark.parametrize("mask", ["grad", "snip"])
def test_calibrated_masks_train(mask):
    """grad and snip masks from one batch's calibration gradients, in
    hook mode and packed; without the gradients the Trainer raises."""
    _, run = _runs()
    from repro_torch.models import lm as TLM
    from repro_torch.data import batch_iterator
    base = TLM.init_params(run.model, seed=0, device="cpu")
    batch = device_batch(next(batch_iterator(run.model, run.shape, seed=1)),
                         "cpu")
    calib = dense_grads(base, run.model, batch,
                        run.adapter.target_modules)[2]
    for packed in (False, True):
        r = RunConfig(model=run.model, shape=run.shape,
                      adapter=AdapterConfig(kind="shira", mask=mask,
                                            sparsity=SPARSITY, packed=packed),
                      train=run.train)
        with pytest.raises(ValueError, match="calibration grads"):
            Trainer(r, base_params=base, device="cpu")
        t = Trainer(r, base_params=base, calib_grads=calib, device="cpu")
        out = t.fit(1, log=None)
        pack = t.export_pack(out["state"])
        assert all(np.isfinite(v.numpy()).all()
                   for _, v in pack.entries.values())


def test_weight_decay_raises_in_hook_mode():
    """Hook mode with weight decay no longer raises: the reference decays
    every weight, masked or not, so the trainable tree copies every leaf
    (its steps are held against the reference in
    tests/test_torch_trainer_kinds.py); packed mode decays its values."""
    _, run = _runs(wd=0.1)
    t = Trainer(run, device="cpu")
    assert t.decay_all
    state = t.init_state()
    base = dict(iter_leaves(t.base))
    assert all(w is not base[p] for p, w in iter_leaves(state["trainable"]))
    out = t.fit(1, state=state, log=None)
    assert not torch.equal(dict(iter_leaves(out["state"]["trainable"]))[
        "embed/emb"], base["embed/emb"])
    _, packed = _runs(packed=True, wd=0.1)
    assert not Trainer(packed, device="cpu").decay_all


@pytest.mark.parametrize("adapter", ["shira", "shira-wm", "shira-struct",
                                     "shira-wm-hook"])
def test_train_cli_adapters(adapter):
    cfg = tlaunch.parse_adapter(adapter)
    assert cfg.mask == ("struct" if "struct" in adapter else "wm")
    assert cfg.packed == (not adapter.endswith("-hook"))
    stats = tlaunch.main(["--arch", "starcoder2-7b", "--smoke", "--device",
                          "cpu", "--adapter", adapter, "--steps", "2",
                          "--seq", "8", "--batch", "2"])
    assert len(stats["losses"]) == 2
    assert all(np.isfinite(stats["losses"])) and stats["trained_values"] > 0


def test_train_cli_rejects():
    for spec in ("none", "lora", "dora", "shira-dora"):     # ported kinds
        assert tlaunch.parse_adapter(spec).kind == spec
    with pytest.raises(ValueError):
        tlaunch.parse_adapter("adapter")
    with pytest.raises(ValueError, match="calibration grads"):
        tlaunch.main(["--arch", "starcoder2-7b", "--smoke", "--device", "cpu",
                      "--adapter", "shira-snip-hook", "--steps", "1"])
