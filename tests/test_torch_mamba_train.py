"""The trainers and ``launch.train`` on mamba2-780m's smoke config against
the JAX package.

The base is drawn by the JAX package and crosses over through
repro_torch.bridge. The default targets meet one leaf of the Mamba2
mixer, ``out_proj`` (the in-projections are ``in_z``/``in_x``/``in_bc``/
``in_dt``, no target). In f32, 3 steps: the Trainer (packed SHiRA on
``wm`` masks, a top-K of |W| built alike in both packages) and the
MultiAdapterTrainer (3 adapters, ``rand`` indices drawn with numpy and
shared, side deltas on ``out_proj`` inside the mixer) track the JAX
trainers' losses and trained values to rtol = atol = 5e-3, the JAX
package's trainer tolerance; the loss has no aux term (the family has no
router) and the trained values moved. ``launch.train`` trains on the CPU
as a user runs it.
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
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as TL
from repro_torch.runtime import Trainer
from repro_torch.training import MultiAdapterTrainer

from test_torch_moe import TRAJ_TOL, _np
from test_torch_moe_train import _flat, _scatter
from test_torch_multiadapter import np_init_adapter

ARCH = "mamba2-780m"
LAYERS = 2


def _runs(mask):
    adapter = dict(kind="shira", mask=mask, sparsity=0.9)
    train = dict(learning_rate=1e-2, total_steps=5, warmup_steps=2)
    model = dict(num_layers=LAYERS)
    jrun = JRunConfig(model=j_smoke(ARCH).replace(**model),
                      shape=JShapeSpec("t", 40, 2, "train"),
                      adapter=JAdapterConfig(**adapter),
                      train=JTrainConfig(**train))
    trun = RunConfig(model=get_smoke_config(ARCH).replace(**model),
                     shape=ShapeSpec("t", 40, 2, "train"),
                     adapter=AdapterConfig(**adapter),
                     train=TrainConfig(**train))
    return jrun, trun


def _track(got, want, keys):
    for k in keys:
        np.testing.assert_allclose([h[k] for h in got],
                                   [float(h[k]) for h in want], **TRAJ_TOL)


def test_trainer_tracks_jax():
    """3 packed-SHiRA steps on wm masks over out_proj: losses (aux 0) and
    the trained weights, compared scattered into the base (the packages
    list a matrix's indices in other orders)."""
    jrun, trun = _runs("wm")
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
    tidx = {p: i.numpy() for p, i in iter_leaves(tt.aux["indices"])}
    assert [p.rsplit("/", 1)[-1] for p in tidx] == ["out_proj"]
    _track(out["history"], ref["history"], ("loss", "aux"))
    assert all(h["aux"] == 0.0 for h in out["history"])
    got = {p: x.detach().numpy()
           for p, x in iter_leaves(out["state"]["trainable"])}
    assert np.abs(got["stages/0/mixer/out_proj"]).max() > 1e-3
    base, jidx = _flat(np_base), _flat(jt.aux["indices"])
    jvals = _flat(ref["state"]["trainable"])
    for p, v in got.items():
        np.testing.assert_allclose(_scatter(base[p], tidx[p], v),
                                   _scatter(base[p], jidx[p], jvals[p]),
                                   **TRAJ_TOL)


def test_multi_adapter_trainer_tracks_jax():
    """3 adapters, 3 steps, rand indices drawn with numpy and shared: the
    per-adapter losses and the trained values (the same indices, in the
    same order)."""
    jrun, trun = _runs("rand")
    names = ["a0", "a1", "a2"]
    jbase = JLM.init_params(jrun.model, jax.random.PRNGKey(0))
    with JL.compute_precision(jnp.float32), pytest.MonkeyPatch.context() \
            as mp:
        mp.setattr(jcore, "init_adapter", np_init_adapter)
        jm = JMulti(jrun, names, init_key=0, base_params=jbase)
        jout = jm.fit(3, log=None)
    auxes = [bridge.adapter_from_numpy(_np(x["indices"]), "cpu")[1]
             for x in jm.auxes]
    with TL.compute_precision(torch.float32):
        tm = MultiAdapterTrainer(trun, names, base_params=bridge.
                                 params_from_numpy(_np(jm.base), "cpu"),
                                 auxes=auxes, device="cpu")
        tout = tm.fit(3, log=None)
    _track(tout["history"], jout["history"], [f"loss:{n}" for n in names])
    want = _flat(jout["state"]["values"])
    got = {p: v.detach().numpy() for p, v in tout["state"]["values"].items()}
    assert set(got) == set(want) == {"stages/0/mixer/out_proj"}
    for p, v in got.items():
        assert np.abs(v).max() > 1e-3
        np.testing.assert_allclose(v, want[p], **TRAJ_TOL)


def test_launch_train():
    out = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--adapter", "shira-rand", "--steps", "2", "--seq",
                       "40", "--batch", "2"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert out["trained_values"] > 0
