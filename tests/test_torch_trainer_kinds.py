"""Trainer runs of the adapter kinds beyond SHiRA in repro_torch against
repro: full finetuning, LoRA, DoRA and SHiRA-masked DoRA, and hook mode
with weight decay.

The JAX smoke config's base, the JAX Trainer's adapter factors and its wm
indices cross over through numpy (``bridge.params_from_numpy``,
``Trainer(trainable0=, aux=)``): the reference seeds each leaf's LoRA
``A`` with Python's per-process ``hash`` of the path, which no other
process can redraw. Both packages run in f32 (``compute_precision``).

Tolerances: Trainer losses and trained tensors to rtol = atol = 5e-3, the
trainer-parity tolerance of tests/test_torch_train.py (AdamW's normalised
step amplifies the last bits of near-zero gradients). One hook-mode step
with weight decay from the JAX state: every weight of every leaf within
1e-6 of the largest weight, the decay and the masked direction rounded in
another order (``Trainer.hook_step``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import batch_iterator as j_batches
from repro.models import layers as JL
from repro.runtime import Trainer as JTrainer
from repro_torch import bridge
from repro_torch.core.masks import iter_leaves
from repro_torch.models import layers as TL
from repro_torch.runtime import Trainer
from repro_torch.runtime.trainer import device_batch
from test_torch_adapters_kinds import KINDS, STEPS, _flat, _runs, base  # noqa: F401

TRAJ_TOL, WD_TOL = 5e-3, 1e-6


@pytest.mark.parametrize("kind", ["none"] + KINDS)
def test_trainer_matches_jax_trainer(base, kind):
    jbase, np_base = base
    jrun, trun = _runs(kind)
    jt = JTrainer(jrun, init_key=0, base_params=jbase)
    # numpy copies first: the JAX step donates its state's buffers
    t0 = (None if jt.trainable0 is None or kind == "none" else
          bridge.params_from_numpy(jax.tree.map(np.asarray, jt.trainable0),
                                   "cpu"))
    aux = (None if jt.aux is None else bridge.adapter_from_numpy(
        jax.tree.map(np.asarray, jt.aux["indices"]), "cpu")[1])
    with JL.compute_precision(jnp.float32):
        ref = jt.fit(STEPS, log=None)
    with TL.compute_precision(torch.float32):
        tt = Trainer(trun, base_params=bridge.params_from_numpy(np_base,
                                                                "cpu"),
                     trainable0=t0, aux=aux, device="cpu")
        out = tt.fit(STEPS, log=None)
    np.testing.assert_allclose([h["loss"] for h in out["history"]],
                               [h["loss"] for h in ref["history"]],
                               rtol=TRAJ_TOL, atol=TRAJ_TOL)
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0], losses
    want = _flat(ref["state"]["trainable"])
    got = dict(iter_leaves(out["state"]["trainable"]))
    assert set(got) == set(want)
    for p, x in got.items():
        np.testing.assert_allclose(x.numpy(), want[p], rtol=TRAJ_TOL,
                                   atol=TRAJ_TOL, err_msg=p)
    if kind == "none":      # full finetuning moves every leaf; base kept
        base_t = dict(iter_leaves(tt.base))
        assert all(not torch.equal(x, base_t[p]) for p, x in got.items())
        np.testing.assert_array_equal(base_t["embed/emb"].numpy(),
                                      np_base["embed"]["emb"])
    with pytest.raises(ValueError, match="SHiRA"):
        tt.export_pack(out["state"])
    with pytest.raises(ValueError, match="SHiRA"):
        jt.export_pack(ref["state"])


def test_hook_mode_weight_decay_one_step_from_jax_state(base):
    """The reference decays every weight, masked or not; one step from the
    same (JAX) state, every weight of every leaf within 1e-6 of the
    largest weight."""
    jbase, np_base = base
    jrun, trun = _runs("shira", packed=False, wd=0.1)
    with JL.compute_precision(jnp.float32):
        jt = JTrainer(jrun, init_key=0, base_params=jbase)
        ref = jt.fit(2, log=None)
    np_state = jax.tree.map(np.asarray, ref["state"])
    batch = next(j_batches(jrun.model, jrun.shape, seed=7))
    with JL.compute_precision(jnp.float32):
        jnew, _ = jt._step_fn(jax.tree.map(jnp.array, np_state),
                              {k: jnp.asarray(v) for k, v in batch.items()})
    with TL.compute_precision(torch.float32):
        tt = Trainer(trun, base_params=bridge.params_from_numpy(np_base,
                                                                "cpu"),
                     device="cpu")
        assert tt.decay_all
        state = bridge.hook_state_from_numpy(np_state, tt.masks, "cpu")
        new, m = tt.step(state, device_batch(batch, "cpu"))
    w0, want = _flat(np_state["trainable"]), _flat(jnew["trainable"])
    got = dict(iter_leaves(new["trainable"]))
    assert set(got) == set(want)
    top = max(np.abs(x).max() for x in want.values())
    masks = dict(iter_leaves(tt.masks))
    for p, x in got.items():
        np.testing.assert_allclose(x.numpy(), want[p], rtol=0,
                                   atol=WD_TOL * top, err_msg=p)
        off = ~masks[p].numpy() if p in masks else np.ones(x.shape, bool)
        off &= w0[p] != 0                   # zero-initialised biases stay 0
        if off.any():                       # decayed off the mask too
            assert (want[p][off] != w0[p][off]).mean() > 0.9, p
            assert (x.numpy()[off] != w0[p][off]).mean() > 0.9, p
    # the base is never written
    np.testing.assert_array_equal(dict(iter_leaves(tt.base))[
        "embed/emb"].numpy(), np_base["embed"]["emb"])
