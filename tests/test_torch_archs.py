"""The port's registry and model entry points on every ported architecture
against the JAX package.

Configs: ``get_config`` / ``get_smoke_config`` return the reference's
values for granite-moe-1b-a400m, deepseek-v2-lite-16b (its ``mla``
compared as a dict), mamba2-780m and zamba2-2.7b (their ``ssm`` so too),
deepseek-coder-33b, granite-34b, qwen1.5-32b, paligemma-3b and
hubert-xlarge (every field, ``fsdp`` included); an unknown id raises
``KeyError``.

Entry points: ``train_loss`` (loss and MoE aux), ``prefill`` and
``decode_step``, on the smoke configs of the three dense archs,
granite-moe, deepseek-v2-lite-16b (MLA attention, shared experts, a
first dense layer), mamba2-780m (Mamba2 blocks) and zamba2-2.7b (Mamba2
groups and the shared attention block), and on a GQA variant of
granite-moe with shared experts and a first dense layer; JAX weights cross over through ``bridge``, tokens are
numpy draws. In f32 every logit agrees to 1e-5 (f32 sums in another
order). The paged entry points are held in test_torch_archs_paged.py,
remat="dots" and the launch CLIs in test_torch_remat.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.core.masks import path_str
from repro.models import layers as JL
from repro.models import lm as JLM
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.masks import iter_leaves
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM

from test_torch_moe import variant

NEW = ["granite-moe-1b-a400m", "deepseek-coder-33b", "granite-34b",
       "qwen1.5-32b", "deepseek-v2-lite-16b", "mamba2-780m", "zamba2-2.7b",
       "paligemma-3b", "hubert-xlarge"]
CASES = ["granite-moe-1b-a400m", "moe-variant", "deepseek-coder-33b",
         "granite-34b", "qwen1.5-32b", "deepseek-v2-lite-16b"]
MODELS = CASES + ["mamba2-780m", "zamba2-2.7b"]   # CASES: the paged ones
F32_TOL = 1e-5
B, S, STEPS = 2, 8, 2


def _fields(cfg):
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for sub in ("moe", "mla", "ssm"):
        if out.get(sub) is not None:
            out[sub] = dataclasses.asdict(out[sub])
    return out


@pytest.mark.parametrize("arch", NEW)
def test_configs_match_reference(arch):
    for jget, tget in ((j_config, get_config), (j_smoke, get_smoke_config)):
        t, j = _fields(tget(arch)), _fields(jget(arch))
        assert {k: j[k] for k in t} == t
        assert set(j) == set(t)
        assert tget(arch).padded_vocab == jget(arch).padded_vocab


def _cfgs(case):
    if case == "moe-variant":
        j, t = j_smoke(CASES[0]), get_smoke_config(CASES[0])
        return variant(j, type(j.moe)), variant(t, type(t.moe))
    return j_smoke(case), get_smoke_config(case)


_SETUP = {}


def setup(case):
    """(JAX cfg, port cfg, JAX params, port params, tokens), built once a
    case."""
    if case not in _SETUP:
        jcfg, tcfg = _cfgs(case)
        jp = jax.jit(JLM.init_params, static_argnums=0)(
            jcfg, jax.random.PRNGKey(0))
        tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        toks = np.random.default_rng(1).integers(
            0, jcfg.vocab_size, (B, S + STEPS)).astype(np.int32)
        _SETUP[case] = jcfg, tcfg, jp, tp, toks
    return _SETUP[case]


def _close(port, ref, tol=F32_TOL):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def _f32():
    return JL.compute_precision(jnp.float32), TL.compute_precision(
        torch.float32)


@pytest.mark.parametrize("case", MODELS)
def test_init_params_tree_matches(case):
    jcfg, tcfg, jp, _, _ = setup(case)
    mine = TLM.init_params(tcfg, seed=0, device="cpu")
    want = {path_str(p): tuple(x.shape)
            for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert {p: tuple(x.shape) for p, x in iter_leaves(mine)} == want


@pytest.mark.parametrize("case", MODELS)
def test_train_loss_matches_jax(case):
    jcfg, tcfg, jp, tp, toks = setup(case)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks),
          "labels": torch.from_numpy(toks).long()}
    a, b = _f32()
    with a, b:
        jl, jm = jax.jit(lambda p, bb: JLM.train_loss(p, jcfg, bb))(jp, jb)
        tl, tm = TLM.train_loss(tp, tcfg, tb)
    _close(float(tl), float(jl))
    _close(float(tm["aux"]), float(jm["aux"]))
    _close(float(tm["ce"]), float(jm["ce"]))
    assert (float(tm["aux"]) > 0) == (tcfg.family == "moe")


@pytest.mark.parametrize("case", MODELS)
def test_prefill_decode_match_jax(case):
    jcfg, tcfg, jp, tp, toks = setup(case)
    cs = S + STEPS + 4
    a, b = _f32()
    # the JAX calls jitted, the position traced: one compile a case
    decode_fn = jax.jit(lambda p, t, c, pos: JLM.decode_step(p, jcfg, t, c,
                                                             pos))
    with a, b:
        jlog, jc = jax.jit(lambda p, t: JLM.prefill(p, jcfg, {"tokens": t},
                                                    cs))(
            jp, jnp.asarray(toks[:, :S]))
        tlog, tc = TLM.prefill(tp, tcfg, {"tokens": torch.from_numpy(
            toks[:, :S])}, cs)
        _close(tlog, jlog)
        for i in range(STEPS):
            t = toks[:, S + i:S + i + 1]
            jlog, jc = decode_fn(jp, jnp.asarray(t), jc, jnp.int32(S + i))
            tlog, tc = TLM.decode_step(tp, tcfg, torch.from_numpy(t), tc,
                                       S + i)
            _close(tlog, jlog)
