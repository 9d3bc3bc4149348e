"""repro_torch.models.lm against repro.models.lm on the same weights.

The JAX smoke config's parameters (jax.random init) cross over through
numpy with repro_torch.bridge; tokens are numpy draws. f32 logits agree to
1e-4 (two layers of f32 matmuls summed in another order). At the default
bf16 compute dtype the two frameworks round activations at the same places
but accumulate in their own order, so single bf16 roundings (2^-8
relative) flip and propagate; logits, up to ~0.6 here, agree to 1e-2
(3.2e-3 measured).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core.masks import path_str
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import lm as JLM
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.masks import iter_leaves
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM

F32_TOL = 1e-4
BF16_TOL = 1e-2
B, S, STEPS = 2, 8, 3


@pytest.fixture(scope="module")
def setup():
    jcfg = j_smoke("starcoder2-7b")
    tcfg = t_smoke("starcoder2-7b")
    jparams = JLM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, toks


def test_config_copy_matches():
    j, t = j_smoke("starcoder2-7b"), t_smoke("starcoder2-7b")
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "act", "qkv_bias", "rope_theta", "norm_eps",
              "padded_vocab", "resolved_head_dim"):
        assert getattr(j, f) == getattr(t, f), f


def test_init_params_tree_matches(setup):
    jcfg, tcfg, jparams, _, _ = setup
    mine = TLM.init_params(tcfg, seed=0, device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tl = dict(iter_leaves(mine))
    assert {path_str(p): tuple(x.shape) for p, x in jl} == {
        p: tuple(x.shape) for p, x in tl.items()}


def _run(jcfg, tcfg, jparams, tparams, toks, vector_pos):
    cs = S + STEPS + 4
    jlog, jc = JLM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :S])},
                           cs)
    tlog, tc = TLM.prefill(tparams, tcfg, {"tokens": torch.from_numpy(
        toks[:, :S])}, cs)
    out = [(tlog, jlog)]
    for i in range(STEPS):
        pos = S + i
        jp = jnp.full((B,), pos, jnp.int32) if vector_pos else pos
        tp = torch.full((B,), pos, dtype=torch.int32) if vector_pos else pos
        jlog, jc = JLM.decode_step(jparams, jcfg,
                                   jnp.asarray(toks[:, S + i:S + i + 1]), jc,
                                   jp)
        tlog, tc = TLM.decode_step(tparams, tcfg, torch.from_numpy(
            toks[:, S + i:S + i + 1]), tc, tp)
        out.append((tlog, jlog))
    return out


@pytest.mark.parametrize("vector_pos", [False, True])
def test_prefill_decode_f32(setup, vector_pos):
    jcfg, tcfg, jparams, tparams, toks = setup
    with JL.compute_precision(jnp.float32), TL.compute_precision(
            torch.float32):
        for port, ref in _run(jcfg, tcfg, jparams, tparams, toks,
                              vector_pos):
            np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                                       atol=F32_TOL, rtol=F32_TOL)


def test_prefill_decode_bf16(setup):
    jcfg, tcfg, jparams, tparams, toks = setup
    for port, ref in _run(jcfg, tcfg, jparams, tparams, toks, False):
        assert port.dtype == torch.float32
        np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                                   atol=BF16_TOL)


def test_other_families_raise():
    """MoE plans (dense first layers, then MoE), with GQA or MLA
    attention, the SSM plan (one mamba stage), the hybrid plan (one
    hybrid stage) and the vision and audio families' dense plan; a dense
    config without attention still raises."""
    from repro_torch.configs import get_config
    assert TLM.stage_plan(get_config("mamba2-780m")) == [("mamba", 48)]
    assert TLM.stage_plan(t_smoke("mamba2-780m")) == [("mamba", 4)]
    assert TLM.stage_plan(get_config("zamba2-2.7b")) == [("hybrid", 54)]
    assert TLM.stage_plan(get_config("paligemma-3b")) == [("dense", 18)]
    assert TLM.stage_plan(get_config("hubert-xlarge")) == [("dense", 48)]
    dense = t_smoke("starcoder2-7b")
    moe = t_smoke("granite-moe-1b-a400m")
    assert TLM.stage_plan(moe) == [("moe", 2)]
    first = moe.replace(moe=dataclasses.replace(moe.moe,
                                                first_dense_layers=1))
    assert TLM.stage_plan(first) == [("dense_first", 1), ("moe", 1)]
    assert TLM.stage_plan(moe.replace(attn_type="mla")) == [("moe", 2)]
    for family in ("vlm", "audio"):
        assert TLM.stage_plan(dense.replace(family=family)) == [("dense", 2)]
        with pytest.raises(NotImplementedError, match="stage plan"):
            TLM.stage_plan(dense.replace(family=family, attn_type="none"))
    with pytest.raises(NotImplementedError, match="stage plan"):
        TLM.stage_plan(dense.replace(attn_type="none"))


@pytest.mark.parametrize("sq,q_chunk,prefix", [(8, 4, 0), (10, 4, 0),
                                               (6, 16, 0), (10, 4, 3),
                                               (11, 4, 0)])
def test_chunked_attention(sq, q_chunk, prefix):
    """The q-chunk loop (chunks of q_chunk and a shorter last one) against
    the reference's scan (which shrinks q_chunk to a divisor of Sq: one
    row a chunk at Sq = 11), f32; a prefix-LM prefix is visible to every
    query."""
    rng = np.random.default_rng(sq)
    q = rng.standard_normal((2, sq, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, sq, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, sq, 2, 8)).astype(np.float32)
    with JL.compute_precision(jnp.float32), TL.compute_precision(
            torch.float32):
        ref = JA.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   q_chunk=q_chunk, prefix_len=prefix)
        port = TA.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                    q_chunk=q_chunk, prefix_len=prefix)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("repeat_kv", [False, True])
def test_padded_heads_prefill_decode_f32(repeat_kv):
    """Head-group padding (zero dead heads) and kv repetition change
    nothing in the model function; both packages agree on it."""
    pad = dict(pad_heads_to=8, pad_kv_to=4, attn_repeat_kv=repeat_kv)
    jcfg = j_smoke("starcoder2-7b").replace(**pad)
    tcfg = t_smoke("starcoder2-7b").replace(**pad)
    assert TA.padded_heads(tcfg) == JA.padded_heads(jcfg) == (8, 4)
    for tm, jm in zip(TA._pad_masks(tcfg), JA._pad_masks(jcfg)):
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    jparams = JLM.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    with JL.compute_precision(jnp.float32), TL.compute_precision(
            torch.float32):
        for port, ref in _run(jcfg, tcfg, jparams, tparams, toks, True):
            np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                                       atol=F32_TOL, rtol=F32_TOL)


def test_init_cache_matches_jax():
    jcfg, tcfg = j_smoke("starcoder2-7b"), t_smoke("starcoder2-7b")
    jc = JLM.init_cache(jcfg, 3, 12)
    tc = TLM.init_cache(tcfg, 3, 12, device="cpu")
    assert len(jc) == len(tc) == 1
    for j, t in zip(jc[0], tc[0]):
        assert tuple(t.shape) == j.shape and t.dtype == torch.bfloat16
        assert not t.any()
