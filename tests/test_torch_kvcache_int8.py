"""int8 KV pages in the port against ``repro.serving.kvcache``'s
``QuantKV`` and the JAX paged engine with ``quant_kv=True``.

The quantizer's codes and bf16 scales, and the dequantized bf16 values,
are bit-equal to the reference's (ties at .5 round to even, all-zero rows,
clips at +-127); an int8 pool written, gathered and copied page by page
equals the reference's; ``gqa_decode_paged`` on int8 pools (the int8
instance of ``flash_decode_paged``; on the CPU its plain version) equals
the reference's within 1e-5 in f32; ``PagedServingEngine(quant_kv=True)``
gives the JAX engine's tokens through copy-on-write prefix sharing, in KV
bytes that ``cache_bytes`` counts. Paged decode with ``attn_repeat_kv``
runs on the unrepeated pools and equals the reference's repeated path.
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
from repro_torch.kernels.flash_decode import flash_decode_paged
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.serving import kvcache as TKV

from test_torch_paged import (_jax_waves, _port_engine, _run,  # noqa: F401
                              reference, setup)


def bits(x):
    """The raw bits of a bf16 / int8 / f32 array of either package."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.int32 if x.dtype == torch.float32 else
                              np.int8)
    a = np.asarray(x)
    return a.view(np.int16 if a.dtype.itemsize == 2 else
                  np.int32 if a.dtype.itemsize == 4 else np.int8)


def edge_rows(rng, d=16):
    """Rows whose codes tie at .5 (scales 1 and 2: exact), an all-zero
    row, rows clipped at +-127, and random rows at several magnitudes."""
    tie = np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -3.5, 4.5,
                    126.5, -126.5, 0.0, 64.5, -64.5, 5.5], np.float32)
    rows = [tie[:d], -tie[:d], 2 * tie[:d], np.zeros(d, np.float32),
            np.full(d, 7.25, np.float32), np.full(d, -3e-3, np.float32)]
    rows += list(rng.standard_normal((10, d)).astype(np.float32)
                 * np.float32([[1e-3], [0.1], [1], [3], [10], [100], [1e4],
                               [1e-6], [2], [0.5]]))
    return np.stack(rows)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_dequantize_bit_equal(dtype):
    rng = np.random.default_rng(0)
    x = np.concatenate([edge_rows(rng)[None], rng.standard_normal(
        (1, 16, 16)).astype(np.float32) * 4])          # (2, 16 rows, 16)
    x = x.reshape(2, 4, 4, 16)                         # (B, S, KV, D)
    tx = torch.from_numpy(x)
    jx = jnp.asarray(x)
    if dtype == "bf16":
        tx, jx = tx.bfloat16(), jx.astype(jnp.bfloat16)
        np.testing.assert_array_equal(bits(tx), bits(jx))
    tq, jq = TKV.quantize_kv(tx), JKV.quantize_kv(jx)
    assert tq.codes.dtype == torch.int8 and tq.scales.dtype == torch.bfloat16
    assert tuple(tq.scales.shape) == (2, 4, 4, 1)
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(bits(tq.scales), bits(jq.scales))
    np.testing.assert_array_equal(bits(TKV.dequantize_kv(tq)),
                                  bits(JKV.dequantize_kv(jq)))
    codes = tq.codes.numpy().reshape(-1, 16)
    assert (codes[0, 1:4] == [0, 2, 2]).all()          # half to even
    assert (codes[3] == 0).all() and codes.max() == 127
    assert codes.min() == -127


def test_cache_bytes_and_contiguous_update():
    shape = (2, 3, 7, 4, 128)
    assert TKV.cache_bytes(shape, True) == JKV.cache_bytes(shape, True)
    assert TKV.cache_bytes(shape, False) == JKV.cache_bytes(shape, False)
    assert TKV.cache_bytes(shape, True) / TKV.cache_bytes(shape, False) \
        == 130 / 256
    rng = np.random.default_rng(1)
    new = rng.standard_normal((2, 3, 1, 4, 8)).astype(np.float32)
    tc = TKV.quant_cache_zeros((2, 3, 7, 4, 8), device="cpu")
    jc = JKV.quant_cache_zeros((2, 3, 7, 4, 8))
    TKV.update_quant_cache(tc, torch.from_numpy(new), 5, seq_axis=2)
    jc = JKV.update_quant_cache(jc, jnp.asarray(new), 5, seq_axis=2)
    for t, j in zip(tc, jc):
        np.testing.assert_array_equal(bits(t), bits(j))
    with pytest.raises(ValueError, match="seq_axis"):
        TKV.update_quant_cache(tc, torch.from_numpy(new), 5, seq_axis=5)


def test_quant_pool_write_gather_copy():
    """As the reference's own pool test (tests/test_paged.py:157-168), and
    a second request whose invalid row lands in the scratch page, then a
    page copied (codes and scales)."""
    P, page, tail = 5, 2, (3, 8)
    tpool = TKV.pool_zeros(P, page, tail, torch.float32, device="cpu",
                           quant=True)
    jpool = JKV.pool_zeros(P, page, tail, jnp.float32, quant=True)
    assert isinstance(tpool, TKV.QuantKV)
    new = np.random.default_rng(1).standard_normal(
        (2, 2) + tail).astype(np.float32)
    bt = np.array([[2, 4], [3, 1]], np.int32)
    pos = np.array([[0, 1], [2, 3]])
    valid = np.array([[True, True], [True, False]])
    TKV.paged_write(tpool, torch.from_numpy(new), torch.from_numpy(bt),
                    torch.from_numpy(pos), torch.from_numpy(valid))
    jpool = jax.jit(JKV.paged_write)(jpool, jnp.asarray(new),
                                     jnp.asarray(bt), jnp.asarray(pos),
                                     jnp.asarray(valid))
    for t, j in zip(tpool, jpool):
        np.testing.assert_array_equal(bits(t), bits(j))
    out = TKV.paged_gather(tpool, torch.from_numpy(bt))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, 4) + tail
    np.testing.assert_array_equal(
        bits(out), bits(jax.jit(JKV.paged_gather)(jpool, jnp.asarray(bt))))
    np.testing.assert_array_equal(
        bits(out[0, :2]),
        bits(JKV.dequantize_kv(JKV.quantize_kv(jnp.asarray(new[0])))))
    TKV.copy_page(tpool, 2, 4)
    jpool = jax.jit(JKV.copy_page)(jpool, 2, 4)
    for t, j in zip(tpool, jpool):
        np.testing.assert_array_equal(bits(t), bits(j))
    assert torch.equal(tpool.codes[4], tpool.codes[2])


def _decode_both(jcfg, tcfg, jp, tp, quant, dtype, seed=0, B=3, P=12,
                 page=4):
    """One ``gqa_decode_paged`` of each package on the same pools (random
    rows written through a shuffled table first), compute dtype
    ``dtype``: (port output, reference output, port pools, reference
    pools)."""
    rng = np.random.default_rng(seed)
    KV, D = TA.padded_heads(tcfg)[1], tcfg.resolved_head_dim
    nblk = 3
    bt = (rng.permutation(P - 1)[:B * nblk] + 1).reshape(B, nblk).astype(
        np.int32)
    pos = np.array([1, 6, 11])[:B]
    fill = rng.standard_normal((B, page * nblk, KV, D)).astype(np.float32)
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    allpos = np.tile(np.arange(page * nblk), (B, 1))
    valid = allpos < pos[:, None]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    with JL.compute_precision(jdt), TL.compute_precision(dtype):
        tc, jc = [], []
        for _ in range(2):
            t = TKV.pool_zeros(P, page, (KV, D), dtype, device="cpu",
                               quant=quant)
            j = JKV.pool_zeros(P, page, (KV, D), jdt, quant=quant)
            TKV.paged_write(t, torch.from_numpy(fill).to(dtype),
                            torch.from_numpy(bt), torch.from_numpy(allpos),
                            torch.from_numpy(valid))
            j = jax.jit(JKV.paged_write)(j, jnp.asarray(fill).astype(jdt),
                                         jnp.asarray(bt), jnp.asarray(allpos),
                                         jnp.asarray(valid))
            tc.append(t)
            jc.append(j)
        to, tcache = TA.gqa_decode_paged(
            tp, tcfg, torch.from_numpy(x).to(dtype), TA.KVCache(*tc),
            torch.from_numpy(bt), torch.from_numpy(pos))
        # traced in the compute-precision scope: one compile, where eager
        # JAX would compile op by op
        jo, jcache = jax.jit(JA.gqa_decode_paged, static_argnums=1)(
            jp, jcfg, jnp.asarray(x).astype(jdt), JA.KVCache(*jc),
            jnp.asarray(bt), jnp.asarray(pos))
    return to, jo, tcache, jcache


def _gqa(cfg_kw):
    jcfg = j_smoke("starcoder2-7b").replace(**cfg_kw)
    tcfg = t_smoke("starcoder2-7b").replace(**cfg_kw)
    jp = jax.jit(JA.init_gqa, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def test_int8_decode_matches_reference():
    """f32: the plain version of the int8 instance (f32 q against the
    pages dequantized to bf16) is the reference's arithmetic, within
    1e-5; the row written by the decode is the reference's, bit for
    bit."""
    to, jo, tcache, jcache = _decode_both(*_gqa({}), True, torch.float32)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=1e-5)
    for t, j in zip(tcache, jcache):
        for a, b in zip(t, j):
            np.testing.assert_array_equal(bits(a), bits(b))


def test_int8_kernel_wrapper_checks():
    q = torch.zeros(2, 2, 3, 16)
    codes = torch.zeros(5, 4, 2, 16, dtype=torch.int8)
    scales = torch.zeros(5, 4, 2, 1, dtype=torch.bfloat16)
    bt = torch.ones(2, 3, dtype=torch.int32)
    out = flash_decode_paged(q, (codes, scales), (codes, scales), bt, 4)
    assert out.shape == q.shape and out.dtype == q.dtype
    with pytest.raises(TypeError, match="int8 codes"):
        flash_decode_paged(q, (codes.float(), scales), (codes, scales), bt, 4)
    with pytest.raises(ValueError, match="scales"):
        flash_decode_paged(q, (codes, scales[..., :1, :]), (codes, scales),
                           bt, 4)
    with pytest.raises(TypeError, match="pair"):
        flash_decode_paged(q, (codes, scales), codes, bt, 4)


@pytest.mark.parametrize("pools", ["bf16", "int8"])
def test_paged_decode_with_repeat_kv(pools):
    """attn_repeat_kv with padded heads (as tests/test_torch_lm.py builds
    them): the port's kernel reads the unrepeated pools, the reference
    repeats the gathered pages. int8 pools in f32 give the reference's
    output within 1e-5. bf16 pools (bf16 compute) are within 2e-2: the
    reference rounds p to bf16 before p . v, the port's decode keeps p in
    f32 (an accepted difference); a wrong head would be off by the
    output's own size. Repeating changes nothing in the port: with and
    without it the outputs are bit-equal."""
    pad = dict(pad_heads_to=8, pad_kv_to=4)
    quant = pools == "int8"
    dtype = torch.float32 if quant else torch.bfloat16
    to, jo, tcache, jcache = _decode_both(*_gqa({**pad,
                                                 "attn_repeat_kv": True}),
                                          quant, dtype)
    plain, *_ = _decode_both(*_gqa({**pad, "attn_repeat_kv": False}), quant,
                             dtype)
    assert torch.equal(to, plain)
    got, want = to.float().numpy(), np.asarray(jo, np.float32)
    tol = 1e-5 if quant else 2e-2
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    assert np.abs(want).max() > 10 * tol
    for t, j in zip(tcache, jcache):
        for a, b in zip(TKV.leaves(t), jax.tree.leaves(j)):
            np.testing.assert_array_equal(bits(a), bits(b))


def test_paged_engine_quant_kv_tokens_equal_reference(setup):
    """f32, 2 layers: prefix pages shared and copied on write, the same
    tokens as the JAX engine with quant_kv=True, the same page counters;
    the first token of each request equals the fixed batch's with f32
    caches (the reference's own bar, tests/test_paged.py:299-315); the KV
    bytes are codes and scales."""
    jcfg, *_, refs = setup
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, jcfg.vocab_size, 8).astype(np.int32)
    pa = np.concatenate([prefix, [7, 11]]).astype(np.int32)
    pb = np.concatenate([prefix, [13, 3]]).astype(np.int32)
    pc = rng.integers(0, jcfg.vocab_size, 13).astype(np.int32)
    kw = dict(slots=2, num_pages=32, page_size=4, max_len=20, chunk_size=4)
    waves = [[(pa, None, 4)], [(pb, "a0", 4), (pb, None, 4)],
             [(pa, None, 4), (pc, "a1", 5)]]
    want, jpe = _jax_waves(setup, waves, quant_kv=True, **kw)
    pe = _port_engine(setup, quant_kv=True, **kw)
    got = []
    for wave in waves:
        got += _run(pe, *zip(*wave))
    for f, w in zip(got, want):
        np.testing.assert_array_equal(f.result(), w)
    assert pe.pool.prefix_hits >= 2 and pe.pool.cow_copies >= 1
    assert (pe.pool.prefix_hits, pe.pool.cow_copies) == (
        jpe.pool.prefix_hits, jpe.pool.cow_copies)
    for f, (p, a, n) in zip(got, [r for w in waves for r in w]):
        assert int(f.result()[0]) == int(reference(refs["f32"], p, a, n)[0])
    assert pe.kv_cache_bytes() == sum(x.nbytes for x in
                                      jax.tree.leaves(jpe.caches))
    full = _port_engine(setup, **kw)             # f32 pools, 4 B an entry
    D = jcfg.resolved_head_dim
    assert pe.kv_cache_bytes() / full.kv_cache_bytes() == (D + 2) / (4 * D)
    assert pe.page_bytes() * 32 == pe.kv_cache_bytes()
