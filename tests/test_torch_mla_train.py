"""The trainers and the launch CLIs on deepseek-v2-lite-16b's smoke config
(MLA attention through ``mla_train``, shared experts, one first dense
layer) against the JAX package.

The base is drawn by the JAX package and crosses over through
repro_torch.bridge. In f32, 3 steps: the Trainer (packed SHiRA, ``wm``
masks over the default targets, ``w_dkv``, ``w_uk`` and ``w_uv``
included) and the MultiAdapterTrainer (3 adapters, ``rand`` indices
drawn with numpy and shared, side deltas on those leaves too) track the
JAX trainers' losses and MoE aux to rtol = atol = 5e-3, the JAX
package's trainer tolerance. ``launch.serve`` runs its four modes and
``launch.train`` trains on the CPU, as a user runs them.
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
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as TL
from repro_torch.runtime import Trainer
from repro_torch.training import MultiAdapterTrainer

from test_torch_moe import TRAJ_TOL, _np
from test_torch_multiadapter import np_init_adapter

ARCH = "deepseek-v2-lite-16b"


def _runs(mask):
    adapter = dict(kind="shira", mask=mask, sparsity=0.9)
    train = dict(learning_rate=1e-2, total_steps=5, warmup_steps=2)
    jrun = JRunConfig(model=j_smoke(ARCH), shape=JShapeSpec("t", 8, 2,
                                                            "train"),
                      adapter=JAdapterConfig(**adapter),
                      train=JTrainConfig(**train))
    trun = RunConfig(model=get_smoke_config(ARCH),
                     shape=ShapeSpec("t", 8, 2, "train"),
                     adapter=AdapterConfig(**adapter),
                     train=TrainConfig(**train))
    return jrun, trun


def _track(got, want, keys):
    for k in keys:
        np.testing.assert_allclose([h[k] for h in got],
                                   [float(h[k]) for h in want], **TRAJ_TOL)


def test_trainer_tracks_jax():
    """3 packed-SHiRA steps on wm masks (built alike in both packages):
    losses and aux."""
    jrun, trun = _runs("wm")
    jbase = JLM.init_params(jrun.model, jax.random.PRNGKey(0))
    with JL.compute_precision(jnp.float32):
        ref = JTrainer(jrun, init_key=0, base_params=jbase).fit(3, log=None)
    with TL.compute_precision(torch.float32):
        tt = Trainer(trun, base_params=bridge.params_from_numpy(_np(jbase),
                                                                "cpu"),
                     device="cpu")
        out = tt.fit(3, log=None)
    paths = set(tt.aux["indices"]["stages"][1]["attn"])
    assert {"w_dkv", "w_uk", "w_uv", "wq", "wo"} <= paths
    _track(out["history"], ref["history"], ("loss", "aux"))


def test_multi_adapter_trainer_tracks_jax():
    """3 adapters, 3 steps, rand indices drawn with numpy and shared: the
    per-adapter losses (the aux over the combined batch is in each)."""
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


@pytest.mark.parametrize("mode", [[], ["--fuse"], ["--multi-tenant"],
                                  ["--multi-tenant", "--int8"]],
                         ids=["sequential", "fuse", "multi-tenant",
                              "multi-tenant-int8"])
def test_launch_serve_modes(mode):
    stats = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--adapters", "3", "--tokens", "3", "--batch", "2",
                         "--prompt-len", "5", "--batches", "2"] + mode)
    out = stats["last_out"]
    assert out.shape == (2, 3)
    assert 0 <= int(out.min()) and int(out.max()) < 128


def test_launch_train():
    out = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--adapter", "shira-rand", "--steps", "2", "--seq",
                       "8", "--batch", "2"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
