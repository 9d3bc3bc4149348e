"""The Trainer and the MultiAdapterTrainer on granite-moe-1b-a400m's
smoke config against the JAX package's trainers.

The base is drawn by the JAX package and crosses over through
repro_torch.bridge; masks are ``wm`` (a top-K of |W|, the same in both
packages) or ``rand`` indices drawn with numpy and shared. In f32, 3
steps: losses, the MoE aux and the trained values track the JAX trainers
to rtol = atol = 5e-3, the JAX package's trainer tolerance. Expert
leaves (L, E, n, m) as targets train in packed and hook mode as the
reference's do; a MultiAdapterTrainer on them raises a ValueError naming
the leaf (its side deltas cannot serve the experts' batched products).
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
from repro_torch import bridge
from repro_torch.configs import (AdapterConfig, RunConfig, ShapeSpec,
                                 TrainConfig, get_smoke_config)
from repro_torch.core.masks import iter_leaves
from repro_torch.models import layers as TL
from repro_torch.runtime import Trainer
from repro_torch.training import MultiAdapterTrainer

from test_torch_moe import ARCH, EXPERT_TARGETS, TRAJ_TOL, _np
from test_torch_multiadapter import np_init_adapter


def _train_runs(targets=None, packed=True, mask="wm"):
    adapter = dict(kind="shira", mask=mask, sparsity=0.9, packed=packed)
    if targets:
        adapter["target_modules"] = targets
    train = dict(learning_rate=1e-2, total_steps=5, warmup_steps=2)
    jrun = JRunConfig(model=j_smoke(ARCH), shape=JShapeSpec("t", 8, 4,
                                                            "train"),
                      adapter=JAdapterConfig(**adapter),
                      train=JTrainConfig(**train))
    trun = RunConfig(model=get_smoke_config(ARCH),
                     shape=ShapeSpec("t", 8, 4, "train"),
                     adapter=AdapterConfig(**adapter),
                     train=TrainConfig(**train))
    return jrun, trun


@pytest.mark.parametrize("targets,packed", [
    (None, True), (EXPERT_TARGETS, True), (EXPERT_TARGETS, False)],
    ids=["packed", "packed-experts", "hook-experts"])
def test_trainer_tracks_jax(targets, packed):
    """3 steps of the Trainer (wm masks, built alike in both packages):
    the default targets, expert leaves packed, and expert leaves in hook
    mode, whose trained weights also agree."""
    jrun, trun = _train_runs(targets, packed)
    jbase = JLM.init_params(jrun.model, jax.random.PRNGKey(0))
    np_base = _np(jbase)
    with JL.compute_precision(jnp.float32):
        jt = JTrainer(jrun, init_key=0, base_params=jbase)
        ref = jt.fit(3, log=None)
    with TL.compute_precision(torch.float32):
        tt = Trainer(trun, base_params=bridge.params_from_numpy(np_base,
                                                                "cpu"),
                     device="cpu")
        out = tt.fit(3, log=None)
    np.testing.assert_allclose([h["loss"] for h in out["history"]],
                               [h["loss"] for h in ref["history"]],
                               **TRAJ_TOL)
    np.testing.assert_allclose([h["aux"] for h in out["history"]],
                               [float(h["aux"]) for h in ref["history"]],
                               **TRAJ_TOL)
    if targets:
        jflat = _flat(ref["state"]["trainable"])
        got = {p: x.numpy() for p, x in iter_leaves(out["state"]["trainable"])
               if "experts_w" in p}
        assert len(got) == 3 * jrun.model.num_layers // 2
        if packed:     # the two packages list a matrix's indices in other
            base = _flat(np_base)      # orders: compare the trained leaves
            tidx = {p: i.numpy() for p, i in iter_leaves(tt.aux["indices"])}
            jidx = _flat(jt.aux["indices"])
            got = {p: _scatter(base[p], tidx[p], v) for p, v in got.items()}
            jflat = {p: _scatter(base[p], jidx[p], jflat[p]) for p in got}
        for p, x in got.items():
            assert x.ndim == 4, x.shape
            np.testing.assert_allclose(x, jflat[p], **TRAJ_TOL)


def _flat(tree):
    return {jcore.masks.path_str(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _scatter(w, idx, vals):
    """w (..., n, m) plus vals at the packed flat indices (..., K)."""
    *lead, n, m = w.shape
    out = w.reshape(-1, n * m).copy()
    rows = np.arange(out.shape[0])[:, None]
    out[rows, idx.reshape(out.shape[0], -1)] += vals.reshape(out.shape[0], -1)
    return out.reshape(w.shape)


def test_multi_adapter_trainer_refuses_expert_side_deltas():
    """A MultiAdapterTrainer on expert targets would serve them as side
    deltas, which the experts' batched products do not take: a
    ValueError names the leaf (the reference fails in its forward)."""
    _, trun = _train_runs(EXPERT_TARGETS, mask="rand")
    with TL.compute_precision(torch.float32):
        tm = MultiAdapterTrainer(trun, ["a0", "a1"], device="cpu")
        with pytest.raises(ValueError, match="experts_w_"):
            tm.fit(1, log=None)


def test_multi_adapter_trainer_tracks_jax():
    """3 adapters, 3 steps, rand indices drawn with numpy and shared: the
    per-adapter losses and the aux over the combined batch track the JAX
    MultiAdapterTrainer, and so do the trained values."""
    jrun, trun = _train_runs(mask="rand")
    names = ["a0", "a1", "a2"]
    jbase = JLM.init_params(jrun.model, jax.random.PRNGKey(0))
    with JL.compute_precision(jnp.float32), pytest.MonkeyPatch.context() \
            as mp:
        mp.setattr(jcore, "init_adapter", np_init_adapter)
        jm = JMulti(jrun, names, init_key=0, base_params=jbase)
        jout = jm.fit(3, log=None)
    base = bridge.params_from_numpy(_np(jm.base), "cpu")
    auxes = [bridge.adapter_from_numpy(_np(x["indices"]), "cpu")[1]
             for x in jm.auxes]
    with TL.compute_precision(torch.float32):
        tm = MultiAdapterTrainer(trun, names, base_params=base, auxes=auxes,
                                 device="cpu")
        tout = tm.fit(3, log=None)
    for n in names:
        np.testing.assert_allclose(
            [h[f"loss:{n}"] for h in tout["history"]],
            [float(h[f"loss:{n}"]) for h in jout["history"]], **TRAJ_TOL)
    aux = [h["aux"] for h in tout["history"]]
    assert all(a > 0.5 for a in aux), aux
    jvals = _np(jout["state"]["values"])
    flat = {jcore.masks.path_str(p): x for p, x in
            jax.tree_util.tree_flatten_with_path(jvals)[0]}
    for p, v in tout["state"]["values"].items():
        np.testing.assert_allclose(v.numpy(), flat[p], **TRAJ_TOL)
