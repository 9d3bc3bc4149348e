"""Paged KV in the port: PagePool policy, the pool primitives, and
PagedServingEngine against repro.hub.PagedServingEngine.

The JAX package's bars (``tests/test_paged.py``), held on the port: paged
decode is token-for-token identical to the fixed batch (mixed lengths, an
adapter stack, int8 tables), and parity holds across page / prompt /
chunk boundaries (COW, prefix sharing and chunked admission are in
``test_torch_paged_cow.py``). Engine tokens are compared with the JAX engine
(``interpret=False``, f32) and with the port's fixed-batch
``MultiTenantEngine.generate`` on bridged weights and numpy-drawn packs
(``test_torch_hub_serving.np_packs``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.hub import PagedServingEngine as JPaged
from repro.models import layers as JL
from repro.serving import kvcache as JKV
from repro_torch.hub import PagedServingEngine
from repro_torch.models import layers as TL
from repro_torch.serving import MultiTenantEngine
from repro_torch.serving.kvcache import (PagePool, copy_page, paged_gather,
                                         paged_write, pages_for, pool_zeros)

from test_torch_hub_serving import bridged_setup


@pytest.fixture(scope="module")
def setup():
    jcfg, jparams, jpacks, tcfg, tparams, tpacks = bridged_setup(2)
    refs = {}
    for dt in ("f32", "int8"):
        mt = MultiTenantEngine(tcfg, tparams, table_dtype=dt)
        for p in tpacks:
            mt.register(p)
        refs[dt] = mt
    return jcfg, jparams, jpacks, tcfg, tparams, tpacks, refs


def _prompt(key, n, cfg):
    return np.array(jax.random.randint(key, (n,), 0, cfg.vocab_size))


def reference(mt, prompt, name, tokens):
    """The port's fixed batch for one request, f32."""
    with TL.compute_precision(torch.float32):
        out, _ = mt.generate({"tokens": torch.from_numpy(
            np.asarray(prompt)[None].astype(np.int64))}, [name], tokens)
    return out[0].numpy()


def _port_engine(setup, **kw):
    """A port engine with f32 pools, as the JAX engines under f32 have."""
    _, _, _, tcfg, tparams, tpacks, _ = setup
    with TL.compute_precision(torch.float32):
        pe = PagedServingEngine(tcfg, tparams, **kw)
    for p in tpacks:
        pe.register(p)
    return pe


def _run(pe, prompts, names, lens):
    with TL.compute_precision(torch.float32):
        futs = [pe.submit(p, n, max_tokens=t)
                for p, n, t in zip(prompts, names, lens)]
        pe.run()
    return futs


def _jax_tokens(setup, prompts, names, lens, **kw):
    """The JAX paged engine's (tokens, engine) for one wave of requests."""
    return _jax_waves(setup, [list(zip(prompts, names, lens))], **kw)


def _jax_waves(setup, waves, **kw):
    """Run waves of (prompt, adapter, max_tokens) one after another on one
    JAX paged engine (interpret=False, f32): (tokens of each wave, engine),
    so later waves meet the prefix pages earlier ones registered."""
    jcfg, jparams, jpacks, *_ = setup
    out = []
    with JL.compute_precision(jnp.float32):
        pe = JPaged(jcfg, jparams, interpret=False, **kw)
        for p in jpacks:
            pe.register(p)
        for wave in waves:
            futs = [pe.submit(p, n, max_tokens=t) for p, n, t in wave]
            pe.run()
            out += [np.asarray(f.result()) for f in futs]
    return out, pe


# ---------------------------------------------------------------------------
# PagePool policy (pure host): the same sequences on both pools
# ---------------------------------------------------------------------------

def test_pool_alloc_release_refcounts():
    for cls in (PagePool, JKV.PagePool):
        pool = cls(6, 4)
        assert pool.free_pages() == 5          # page 0 is pinned scratch
        a = pool.alloc(3)
        assert 0 not in a and len(set(a)) == 3 and pool.used_pages() == 3
        pool.share(a[0])
        assert pool.is_shared(a[0]) and not pool.is_shared(a[1])
        pool.release(a)
        assert pool.free_pages() == 4          # a[0] kept by the share
        pool.release([a[0]])
        assert pool.free_pages() == 5
        with pytest.raises(MemoryError):
            pool.alloc(6)
    assert PagePool(6, 4).alloc(3) == JKV.PagePool(6, 4).alloc(3)


def test_pool_prefix_match_cap_and_salt():
    p = 4
    toks = np.arange(10, dtype=np.int32)
    got = []
    for cls in (PagePool, JKV.PagePool):
        pool = cls(10, p)
        pages = pool.alloc(pages_for(len(toks), p))     # 3 pages
        pool.register_prefix(toks, pages, salt=b"a0")
        assert pool.registered_prefixes() == 3          # 2 full + 1 partial
        n, shared = pool.match_prefix(toks, salt=b"a0")
        assert n == 9 and shared == pages               # capped at L - 1
        pool.release(shared)
        assert pool.match_prefix(toks, salt=b"a1") == (0, [])
        other = np.concatenate([toks[:8], [99, 98]]).astype(np.int32)
        n, shared = pool.match_prefix(other, salt=b"a0")
        assert n == 8 and shared == pages[:2]
        pool.release(shared)
        n, shared = pool.match_prefix(toks[:4], salt=b"a0")
        assert n == 3 and shared == pages[:1]
        pool.release(shared)
        assert pool.match_prefix(toks[:1], salt=b"a0") == (0, [])
        got.append((list(pool.refs), pool.prefix_hits,
                    pool.prefix_shared_tokens))
    assert got[0] == got[1]


def test_pool_lru_eviction_frees_cold_prefixes():
    for cls in (PagePool, JKV.PagePool):
        pool = cls(6, 2)
        t1, t2 = np.asarray([1, 2], np.int32), np.asarray([3, 4], np.int32)
        pg1, pg2 = pool.alloc(1), pool.alloc(1)
        pool.register_prefix(t1, pg1)
        pool.register_prefix(t2, pg2)
        pool.release(pg1)
        pool.release(pg2)                      # only registry refs remain
        assert pool.free_pages() == 3 and pool.can_alloc(5)
        _, sh = pool.match_prefix(np.asarray([3, 4, 5], np.int32))
        pool.release(sh)                       # touch t2: t1 is the LRU
        assert len(pool.alloc(4)) == 4 and pool.evictions == 1
        assert pool.registered_prefixes() == 1
        assert pool.match_prefix(np.asarray([1, 2, 9], np.int32)) == (0, [])


# ---------------------------------------------------------------------------
# Device primitives
# ---------------------------------------------------------------------------

def test_paged_write_gather_copy_roundtrip():
    """paged_write (invalid rows to scratch page 0), paged_gather and the
    layer-stacked copy_page against the JAX primitives."""
    P, page, tail = 5, 4, (2, 3)
    rng = np.random.default_rng(0)
    new = rng.standard_normal((2, 3) + tail).astype(np.float32)
    bt = np.array([[1, 2], [3, 4]], np.int32)
    positions = np.array([[0, 1, 5], [2, 3, 9]])
    valid = np.array([[True, True, True], [True, True, False]])
    jpool = JKV.paged_write(JKV.pool_zeros(P, page, tail, jnp.float32),
                            jnp.asarray(new), jnp.asarray(bt),
                            jnp.asarray(positions), jnp.asarray(valid))
    tpool = pool_zeros(P, page, tail, torch.float32, device="cpu")
    paged_write(tpool, torch.from_numpy(new), torch.from_numpy(bt),
                torch.from_numpy(positions), torch.from_numpy(valid))
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    np.testing.assert_array_equal(tpool[0, 0].numpy(), new[1, 2])  # scratch
    np.testing.assert_array_equal(
        paged_gather(tpool, torch.from_numpy(bt)).numpy(),
        np.asarray(JKV.paged_gather(jpool, jnp.asarray(bt))))
    x = rng.standard_normal((3, 5, 2, 4)).astype(np.float32)  # (L, P, ...)
    tx = torch.from_numpy(x.copy())
    copy_page([tx], 4, 1, page_axis=1)
    np.testing.assert_array_equal(
        tx.numpy(), np.asarray(JKV.copy_page(jnp.asarray(x), 4, 1,
                                             page_axis=1)))


# ---------------------------------------------------------------------------
# Paged engine: parity, COW, chunked admission
# ---------------------------------------------------------------------------

def test_paged_engine_matches_jax_and_fixed_batch(setup):
    """Mixed lengths, an adapter stack, chunked prefill (test_paged.py:250)."""
    jcfg, *_, refs = setup
    B, S = 4, 9
    lens = [4, 2, 5, 3]
    names = ["a0", None, ("a0", "a1"), "a1"]
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                         jcfg.vocab_size))
    kw = dict(slots=2, num_pages=24, page_size=4, max_len=20, chunk_size=4)
    want, _ = _jax_tokens(setup, toks, names, lens, **kw)
    pe = _port_engine(setup, **kw)
    futs = _run(pe, toks, names, lens)
    with TL.compute_precision(torch.float32):
        fixed, _ = refs["f32"].generate({"tokens": torch.from_numpy(toks)},
                                        names, max(lens))
    for i, f in enumerate(futs):
        assert f.done()
        np.testing.assert_array_equal(f.result(), want[i], err_msg=f"{i}")
        np.testing.assert_array_equal(f.result(), fixed[i, :lens[i]].numpy())
    assert pe.tokens_out == sum(lens)
    assert pe.prefill_chunks >= B * (S // 4)   # chunked, not one-shot
    assert pe.pool.free_pages() > 0
    assert pe.kv_cache_bytes() == pe.page_bytes() * 24


def test_paged_engine_int8_tables_parity(setup):
    jcfg, *_, refs = setup
    toks = _prompt(jax.random.PRNGKey(6), 7, jcfg)
    kw = dict(slots=2, num_pages=16, page_size=4, max_len=16, chunk_size=4,
              table_dtype="int8")
    want, _ = _jax_tokens(setup, [toks], ["a0"], [4], **kw)
    fut, = _run(_port_engine(setup, **kw), [toks], ["a0"], [4])
    np.testing.assert_array_equal(fut.result(), want[0])
    np.testing.assert_array_equal(fut.result(),
                                  reference(refs["int8"], toks, "a0", 4))


@pytest.mark.parametrize("page_size,plen,chunk,max_tokens", [
    (4, 8, 4, 3),     # everything page/chunk aligned
    (4, 7, 3, 2),     # partial tail page, chunk != page
    (3, 10, 5, 1),    # chunk > page, max_tokens == 1 (no decode step)
    (2, 2, 4, 4),     # prompt smaller than one chunk
])
def test_paged_engine_boundary_sweep(setup, page_size, plen, chunk,
                                     max_tokens):
    """The JAX package's deterministic boundary cases (test_paged.py:466):
    token parity with the JAX engine and the fixed batch."""
    jcfg, *_, refs = setup
    toks = _prompt(jax.random.PRNGKey(plen), plen, jcfg)
    kw = dict(slots=1, num_pages=24, page_size=page_size, max_len=16,
              chunk_size=chunk)
    want, _ = _jax_tokens(setup, [toks], ["a0"], [max_tokens], **kw)
    fut, = _run(_port_engine(setup, **kw), [toks], ["a0"], [max_tokens])
    np.testing.assert_array_equal(fut.result(), want[0])
    np.testing.assert_array_equal(
        fut.result(), reference(refs["f32"], toks, "a0", max_tokens))
