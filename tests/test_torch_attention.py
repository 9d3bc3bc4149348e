"""The port's attention layers against the JAX model on bridged weights.

``gqa_prefill`` (through ``flash_prefill``), ``gqa_decode`` with scalar and
per-request positions (through ``flash_decode``), ``gqa_decode_paged``
(through ``flash_decode_paged``, no gather) and ``gqa_prefill_chunk``
(gather, then plain attention, as the reference) against the JAX
functions (``_attend_block`` math) on the smoke config's GQA weights, f32
within 1e-5: outputs and the caches or page pools they write.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import attention as JA
from repro.models import layers as JL
from repro.serving import kvcache as JKV
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.serving import kvcache as TKV


@pytest.fixture(scope="module")
def attn_setup():
    cfg = j_smoke("starcoder2-7b")
    jp = JA.init_gqa(jax.random.PRNGKey(0), cfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, t_smoke("starcoder2-7b"), jp, tp


def _x(rng, *shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _f32(fn):
    with JL.compute_precision(jnp.float32), TL.compute_precision(
            torch.float32):
        return fn()


def _allclose(port, want):
    np.testing.assert_allclose(port.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_gqa_prefill_matches_jax(attn_setup):
    jcfg, tcfg, jp, tp = attn_setup
    jx, tx = _x(np.random.default_rng(0), 2, 11, jcfg.d_model)

    def run():
        jo, jc = JA.gqa_prefill(jp, jcfg, jx, 16)
        to, tc = TA.gqa_prefill(tp, tcfg, tx, 16)
        _allclose(to, jo)
        _allclose(tc.k, jc.k)
        _allclose(tc.v, jc.v)
    _f32(run)


@pytest.mark.parametrize("vector", [False, True])
def test_gqa_decode_matches_jax(attn_setup, vector):
    jcfg, tcfg, jp, tp = attn_setup
    rng = np.random.default_rng(1)
    B, S = 3, 12
    jk, tk = _x(rng, B, S, 2, 16)
    jv, tv = _x(rng, B, S, 2, 16)
    jx, tx = _x(rng, B, 1, jcfg.d_model)
    pos = np.array([4, 0, 11], np.int32) if vector else 7

    def run():
        jo, jc = JA.gqa_decode(jp, jcfg, jx, JA.KVCache(jk, jv),
                               jnp.asarray(pos))
        tc = TA.KVCache(tk.clone(), tv.clone())
        to, tc = TA.gqa_decode(tp, tcfg, tx, tc,
                               torch.from_numpy(pos) if vector else pos)
        _allclose(to, jo)
        _allclose(tc.k, jc.k)
        _allclose(tc.v, jc.v)
    _f32(run)


def test_gqa_decode_paged_matches_jax(attn_setup):
    jcfg, tcfg, jp, tp = attn_setup
    rng = np.random.default_rng(2)
    B, P, page, nblk = 3, 10, 4, 3
    jkp, tkp = _x(rng, P, page, 2, 16)
    jvp, tvp = _x(rng, P, page, 2, 16)
    jx, tx = _x(rng, B, 1, jcfg.d_model)
    bt = np.array([[3, 7, 1], [5, 2, 0], [0, 0, 0]], np.int32)
    pos = np.array([9, 6, 0], np.int32)       # the last lane idle

    def run():
        jo, jc = JA.gqa_decode_paged(jp, jcfg, jx, JA.KVCache(jkp, jvp),
                                     jnp.asarray(bt), jnp.asarray(pos))
        tc = TA.KVCache(tkp.clone(), tvp.clone())
        to, tc = TA.gqa_decode_paged(tp, tcfg, tx, tc, torch.from_numpy(bt),
                                     torch.from_numpy(pos))
        _allclose(to, jo)
        _allclose(tc.k, jc.k)
        _allclose(tc.v, jc.v)
    _f32(run)


@pytest.mark.parametrize("start,valid,C", [(0, 4, 4), (4, 3, 4), (5, 5, 5)])
def test_gqa_prefill_chunk_matches_jax(attn_setup, start, valid, C):
    """One paged prefill chunk (padded when valid < C) against the JAX
    gather-then-attend path."""
    jcfg, tcfg, jp, tp = attn_setup
    rng = np.random.default_rng(start + C)
    P, page, nblk = 8, 4, 3
    jkp, tkp = _x(rng, P, page, 2, 16)
    jvp, tvp = _x(rng, P, page, 2, 16)
    jx, tx = _x(rng, 1, C, jcfg.d_model)
    bt = np.array([[6, 2, 4]], np.int32)
    kv_len = start + valid

    def run():
        jo, jc = JA.gqa_prefill_chunk(jp, jcfg, jx, JA.KVCache(jkp, jvp),
                                      jnp.asarray(bt), start, kv_len)
        tc = TA.KVCache(tkp.clone(), tvp.clone())
        to, tc = TA.gqa_prefill_chunk(tp, tcfg, tx, tc, torch.from_numpy(bt),
                                      start, kv_len)
        _allclose(to[:, :valid], jo[:, :valid])
        # pages the chunk may write (scratch page 0 takes the padding)
        for p in (6, 2, 4):
            _allclose(tc.k[p], jc.k[p])
            _allclose(tc.v[p], jc.v[p])
    _f32(run)


@pytest.mark.parametrize("S,C", [(48, 16), (20, 8)])
def test_gqa_prefill_chunk_equals_gqa_prefill_in_bf16(attn_setup, S, C):
    """In bf16 the paged chunks (plain attention after a gather) give the
    same bits as one whole-prompt gqa_prefill (flash_prefill's plain
    version on the CPU): both keep p in f32, so the lane and paged engines
    prefill alike. Rounding p to bf16, as the reference's _attend_block
    does, changes about half the outputs by a bf16 ulp."""
    _, tcfg, _, tp = attn_setup
    rng = np.random.default_rng(S)
    x = torch.from_numpy(rng.standard_normal(
        (1, S, tcfg.d_model)).astype(np.float32)).bfloat16()
    page = 4
    P = -(-S // page) + 1
    KV, D = TA.padded_heads(tcfg)[1], tcfg.resolved_head_dim
    cache = TA.KVCache(*(TKV.pool_zeros(P, page, (KV, D), torch.bfloat16,
                                        "cpu") for _ in range(2)))
    bt = torch.arange(1, P, dtype=torch.int32)[None]
    want, whole = TA.gqa_prefill(tp, tcfg, x, S)
    outs = []
    for s in range(0, S, C):
        o, cache = TA.gqa_prefill_chunk(tp, tcfg, x[:, s:s + C], cache, bt,
                                        s, min(S, s + C))
        outs.append(o[:, :min(C, S - s)])
    assert want.dtype == torch.bfloat16
    assert torch.equal(torch.cat(outs, 1), want)
    assert torch.equal(TKV.paged_gather(cache.k, bt)[:, :S], whole.k[:, :S])


def test_paged_gather_matches_jax():
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((6, 4, 2, 3)).astype(np.float32)
    bt = np.array([[5, 1], [0, 3]], np.int32)
    np.testing.assert_array_equal(
        TKV.paged_gather(torch.from_numpy(pool), torch.from_numpy(bt)).numpy(),
        np.asarray(JKV.paged_gather(jnp.asarray(pool), jnp.asarray(bt))))
