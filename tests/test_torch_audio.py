"""hubert-xlarge, the audio encoder, in the port against the JAX package, at
its smoke config (2 layers, 4 heads of 16, bidirectional, an untied head
of 32 classes); frame embeddings in, no decode.

Weights are drawn by the JAX package and cross over through
repro_torch.bridge (the untied head with them); frames and packs are
numpy draws. In f32:
  - ``make_batch``'s audio batches are bit-equal to the reference's;
  - ``lm.encode`` agrees with the reference's to 1e-5, its attention
    through ``flash_prefill_blocks`` (non-causal, once a layer), and after
    a ``SwitchEngine`` switch, whose weights are bit-equal to the JAX
    engine's; it refuses the SSM, hybrid, MLA and MoE plans;
  - ``train_loss`` agrees to 5e-3, and 2 ``Trainer`` steps (packed SHiRA,
    ``wm`` masks) track the JAX Trainer's losses to 5e-3;
  - the serve CLI exits with the reference's message, the lane and paged
    engines refuse the model with the reference's ``ValueError``, and the
    multi-adapter trainer refuses it at its first step, as the
    reference's do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import AdapterConfig as JAdapterConfig
from repro.configs import RunConfig as JRunConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.core import switching as jsw
from repro.data import make_batch as j_make_batch
from repro.hub import PagedServingEngine as JPaged
from repro.hub import ServingEngine as JServing
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.runtime import Trainer as JTrainer
from repro.training import MultiAdapterTrainer as JMulti
from repro_torch import bridge
from repro_torch.configs import (AdapterConfig, RunConfig, ShapeSpec,
                                 TrainConfig, get_smoke_config)
from repro_torch.core import switching as tsw
from repro_torch.core.masks import iter_leaves
from repro_torch.data import make_batch
from repro_torch.hub import PagedServingEngine, ServingEngine
from repro_torch.launch import serve
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.runtime import Trainer
from repro_torch.training import MultiAdapterTrainer

from test_torch_mla_serving import np_packs
from test_torch_switching import _leaves_equal, _to_port

ARCH = "hubert-xlarge"
TARGETS = ("wq", "wk", "wv", "wo", "w_up", "w_down")
F32_TOL = 1e-5
LOSS_TOL = 5e-3
REFUSAL = "encoder-only archs have no decode serving path"

_SETUP = []


def setup():
    """(JAX cfg, port cfg, JAX params, numpy params), built once."""
    if not _SETUP:
        jcfg, tcfg = j_smoke(ARCH), get_smoke_config(ARCH)
        with JL.compute_precision(jnp.float32):
            jp = jax.jit(JLM.init_params, static_argnums=0)(
                jcfg, jax.random.PRNGKey(0))
        _SETUP.extend([jcfg, tcfg, jp, jax.tree.map(np.asarray, jp)])
    return _SETUP


def _tparams(np_params):
    return bridge.params_from_numpy(np_params, "cpu")


def _f32():
    return JL.compute_precision(jnp.float32), TL.compute_precision(
        torch.float32)


def _frames(B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, 64)).astype(np.float32)


def _close(port, want, tol=F32_TOL):
    if isinstance(port, torch.Tensor):
        port = port.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("seq,batch,seed,step", [(40, 2, 0, 0),
                                                 (130, 3, 7, 5)])
def test_make_batch_audio_is_bit_identical(seq, batch, seed, step):
    got = make_batch(get_smoke_config(ARCH), ShapeSpec("t", seq, batch,
                                                       "train"), seed, step)
    want = j_make_batch(j_smoke(ARCH), JShapeSpec("t", seq, batch, "train"),
                        seed, step)
    assert got.keys() == want.keys() == {"frame_embeds", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_bridge_carries_the_untied_head():
    """The port's tree is the reference's, leaf for leaf: the untied
    (d_model, padded vocab) head crosses over; paligemma's tied one has
    no head leaf."""
    jcfg, tcfg, jp, np_params = setup()
    tp = _tparams(np_params)
    assert tuple(tp["unembed"]["lm_head"].shape) == (64, 256)
    _leaves_equal(tp, jp)
    mine = TLM.init_params(tcfg, seed=0, device="cpu")
    assert ({p: tuple(x.shape) for p, x in iter_leaves(mine)}
            == {p: tuple(x.shape) for p, x in iter_leaves(tp)})
    tied = TLM.init_params(get_smoke_config("paligemma-3b"), device="cpu")
    assert "unembed" not in tied and tied["embed"]["emb"].shape == (512, 64)


@pytest.mark.parametrize("S", [16, 21])
def test_encode_matches_jax(S, monkeypatch):
    """Frame logits (B, S, padded vocab) to 1e-5; each layer's attention
    went through flash_prefill_blocks, bidirectionally."""
    jcfg, tcfg, jp, np_params = setup()
    fe = _frames(2, S, S)
    calls = []
    kernel = TA.flash_prefill_blocks

    def spy(q, k, v, causal=True):
        calls.append(causal)
        return kernel(q, k, v, causal=causal)
    monkeypatch.setattr(TA, "flash_prefill_blocks", spy)
    a, b = _f32()
    with a, b:
        want = jax.jit(lambda p, f: JLM.encode(p, jcfg, {
            "frame_embeds": f}))(jp, jnp.asarray(fe))
        got = TLM.encode(_tparams(np_params), tcfg,
                         {"frame_embeds": torch.from_numpy(fe)})
    assert got.shape == (2, S, 256) and not got.requires_grad
    _close(got, want)
    assert calls == [False] * tcfg.num_layers


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b",
                                  "deepseek-v2-lite-16b",
                                  "granite-moe-1b-a400m"])
def test_encode_refuses_other_plans(arch):
    """``lm.encode`` runs one dense GQA stage, the plan of every
    encoder-only config; SSM, hybrid, MLA and MoE plans raise."""
    with pytest.raises(NotImplementedError, match="one dense GQA stage"):
        TLM.encode({}, get_smoke_config(arch), {})


def test_switch_then_encode_matches_jax():
    """A pack switched in by each package's SwitchEngine: bit-equal
    weights, encode logits to 1e-5; unloaded, the base back."""
    jcfg, tcfg, jp, np_params = setup()
    jpack = np_packs(jp, 1, targets=TARGETS)[0]
    je, te = jsw.SwitchEngine(jp), tsw.SwitchEngine(_tparams(np_params))
    jst, tst = je.switch(jpack), te.switch(_to_port(jpack))
    assert tst.entries_written == jst.entries_written > 0
    _leaves_equal(te.params, je.params)
    fe = _frames(2, 16, 3)
    a, b = _f32()
    with a, b:
        want = JLM.encode(je.params, jcfg, {"frame_embeds": jnp.asarray(fe)})
        got = TLM.encode(te.params, tcfg, {"frame_embeds": torch.from_numpy(
            fe)})
        base = TLM.encode(_tparams(np_params), tcfg,
                          {"frame_embeds": torch.from_numpy(fe)})
    _close(got, want)
    assert float((got - base).abs().max()) > 1e-3
    te.unload()
    _leaves_equal(te.params, jp, atol=1e-5)


def test_train_loss_matches_jax():
    jcfg, tcfg, jp, np_params = setup()
    nb = make_batch(tcfg, ShapeSpec("t", 24, 2, "train"), 0, 0)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    tb["labels"] = tb["labels"].long()
    a, b = _f32()
    with a, b:
        jl, _ = jax.jit(lambda p, bb: JLM.train_loss(p, jcfg, bb))(jp, jb)
        tl, tm = TLM.train_loss(_tparams(np_params), tcfg, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert float(tm["aux"]) == 0


def _runs():
    adapter = dict(kind="shira", mask="wm", sparsity=0.9)
    train = dict(learning_rate=1e-2, total_steps=4, warmup_steps=1)
    shape = ("t", 24, 2, "train")
    return (JRunConfig(model=j_smoke(ARCH), shape=JShapeSpec(*shape),
                       adapter=JAdapterConfig(**adapter),
                       train=JTrainConfig(**train)),
            RunConfig(model=get_smoke_config(ARCH), shape=ShapeSpec(*shape),
                      adapter=AdapterConfig(**adapter),
                      train=TrainConfig(**train)))


def test_trainer_tracks_jax():
    """2 packed-SHiRA steps on wm masks over make_batch's audio batches:
    the JAX Trainer's losses to 5e-3; the trained values moved."""
    jrun, trun = _runs()
    jcfg, tcfg, jp, np_params = setup()
    with JL.compute_precision(jnp.float32):
        ref = JTrainer(jrun, init_key=0, base_params=jp).fit(2, log=None)
    with TL.compute_precision(torch.float32):
        out = Trainer(trun, base_params=_tparams(np_params),
                      device="cpu").fit(2, log=None)
    np.testing.assert_allclose([h["loss"] for h in out["history"]],
                               [float(h["loss"]) for h in ref["history"]],
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    vals = [v for _, v in iter_leaves(out["state"]["trainable"])]
    assert len(vals) == len(TARGETS)           # each stacked over 2 layers
    assert max(float(v.abs().max()) for v in vals) > 1e-3


def test_serve_cli_exits():
    """``launch.serve --arch hubert-xlarge`` exits with the reference's
    message before building anything."""
    with pytest.raises(SystemExit, match=REFUSAL):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])


def test_engines_refuse():
    jcfg, tcfg, jp, np_params = setup()
    tp = _tparams(np_params)
    for make in (lambda: JServing(jcfg, jp, interpret=False),
                 lambda: JPaged(jcfg, jp, num_pages=8, page_size=4),
                 lambda: ServingEngine(tcfg, tp),
                 lambda: PagedServingEngine(tcfg, tp, num_pages=8,
                                            page_size=4)):
        with pytest.raises(ValueError, match=REFUSAL):
            make()


def test_multi_adapter_trainer_refuses():
    """Both packages' multi-adapter trainers refuse the audio batch at
    their first step: they route token rows, text only."""
    jrun, trun = _runs()
    trun = RunConfig(model=trun.model, shape=trun.shape,
                     adapter=AdapterConfig(kind="shira", mask="rand",
                                           sparsity=0.9), train=trun.train)
    jrun = JRunConfig(model=jrun.model, shape=jrun.shape,
                      adapter=JAdapterConfig(kind="shira", mask="rand",
                                             sparsity=0.9), train=jrun.train)
    jcfg, tcfg, jp, np_params = setup()
    with pytest.raises(NotImplementedError, match="text modality only"):
        MultiAdapterTrainer(trun, ["a0", "a1"],
                            base_params=_tparams(np_params),
                            device="cpu").fit(1, log=None)
    with pytest.raises(NotImplementedError, match="text modality only"):
        JMulti(jrun, ["a0", "a1"], base_params=jp).fit(1, log=None)
