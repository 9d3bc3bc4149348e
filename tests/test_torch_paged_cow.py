"""The paged engine's copy-on-write prefix sharing and chunked admission,
against repro.hub.PagedServingEngine (``tests/test_paged.py:317-430``).

Shared prompt pages diverge on their first write with no contamination and
are never shared across adapters; chunked prefill never stalls a live lane;
admission is gated on free pages, not lanes; and an exactly sized cache is
accepted by both engines. Tokens equal the JAX engine's (``interpret=False``,
f32) and the port's fixed batch, and the page counters equal the JAX
engine's. Weights, packs and helpers are ``test_torch_paged``'s.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.hub import PagedServingEngine, ServingEngine
from repro_torch.models import layers as TL

from test_torch_paged import (_jax_tokens, _jax_waves, _port_engine,  # noqa: F401
                              _prompt, _run, reference, setup)


def test_paged_cow_prefix_sharing_no_contamination(setup):
    jcfg, *_, refs = setup
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, jcfg.vocab_size, 8).astype(np.int32)
    pa = np.concatenate([prefix, [7, 11]]).astype(np.int32)
    pb = np.concatenate([prefix, [13, 3]]).astype(np.int32)
    wa = reference(refs["f32"], pa, None, 4)
    wb = reference(refs["f32"], pb, None, 4)
    kw = dict(slots=2, num_pages=32, page_size=4, max_len=16, chunk_size=4)
    (ja, jb, ja2), jpe = _jax_waves(setup, [[(pa, None, 4)], [(pb, None, 4)],
                                            [(pa, None, 4)]], **kw)
    pe = _port_engine(setup, **kw)
    fa, = _run(pe, [pa], [None], [4])          # registers pa's prefix pages
    assert pe.pool.registered_prefixes() >= 3
    fb, = _run(pe, [pb], [None], [4])
    assert pe.pool.prefix_hits == 1
    assert pe.pool.prefix_shared_tokens >= len(prefix)
    assert pe.pool.cow_copies >= 1             # divergent tail copied
    np.testing.assert_array_equal(fa.result(), wa)
    np.testing.assert_array_equal(fb.result(), wb)
    fa2, = _run(pe, [pa], [None], [4])         # shared pages unmutated
    assert pe.pool.prefix_hits == 2
    np.testing.assert_array_equal(fa2.result(), wa)
    for f, j in ((fa, ja), (fb, jb), (fa2, ja2)):
        np.testing.assert_array_equal(f.result(), j)
    assert (pe.pool.prefix_hits, pe.pool.cow_copies) == (
        jpe.pool.prefix_hits, jpe.pool.cow_copies)


def test_paged_prefix_not_shared_across_adapters(setup):
    jcfg, *_, refs = setup
    toks = _prompt(jax.random.PRNGKey(14), 9, jcfg)
    kw = dict(slots=2, num_pages=32, page_size=4, max_len=16, chunk_size=4)
    want, jpe = _jax_waves(setup, [[(toks, None, 4)], [(toks, "a0", 4)],
                                   [(toks, "a0", 4)]], **kw)
    pe = _port_engine(setup, **kw)
    f0, = _run(pe, [toks], [None], [4])
    f1, = _run(pe, [toks], ["a0"], [4])
    assert pe.pool.prefix_hits == 0            # another tenant: no sharing
    np.testing.assert_array_equal(f0.result(),
                                  reference(refs["f32"], toks, None, 4))
    np.testing.assert_array_equal(f1.result(),
                                  reference(refs["f32"], toks, "a0", 4))
    f2, = _run(pe, [toks], ["a0"], [4])
    assert pe.pool.prefix_hits == 1 == jpe.pool.prefix_hits
    np.testing.assert_array_equal(f2.result(), f1.result())
    for f, j in zip((f0, f1, f2), want):
        np.testing.assert_array_equal(f.result(), j)


def test_paged_chunked_prefill_no_decode_stall(setup):
    """While a long prompt trickles in chunk by chunk, a live lane emits
    one token per engine step."""
    jcfg, *_, refs = setup
    short = _prompt(jax.random.PRNGKey(9), 4, jcfg)
    long = _prompt(jax.random.PRNGKey(10), 20, jcfg)
    pe = _port_engine(setup, slots=2, num_pages=32, page_size=4, max_len=32,
                      chunk_size=4)
    with TL.compute_precision(torch.float32):
        fs = pe.submit(short, None, max_tokens=24)
        while not fs.tokens:
            pe.step()
        fl = pe.submit(long, None, max_tokens=2)
        while fl.first_token_step is None:
            before = len(fs.tokens)
            assert pe.step()
            assert len(fs.tokens) - before == 1, "live lane stalled"
            assert not fs.done()
        assert fl.first_token_step - fl.submitted_step >= len(long) // 4 - 1
        pe.run()
    np.testing.assert_array_equal(fl.result(),
                                  reference(refs["f32"], long, None, 2))
    want, _ = _jax_tokens(setup, [short, long], [None, None], [24, 2],
                          slots=2, num_pages=32, page_size=4, max_len=32,
                          chunk_size=4)
    np.testing.assert_array_equal(fs.result(), want[0])
    np.testing.assert_array_equal(fl.result(), want[1])


def test_paged_admission_gated_on_pages_not_lanes(setup):
    jcfg, *_, refs = setup
    pe = _port_engine(setup, slots=4, num_pages=9, page_size=4, max_len=16,
                      chunk_size=4)
    prompts = [_prompt(jax.random.fold_in(jax.random.PRNGKey(11), i), 12,
                       jcfg) for i in range(3)]
    with TL.compute_precision(torch.float32):
        futs = [pe.submit(p, None, max_tokens=5) for p in prompts]
        pe.step()                              # each request needs 4 pages
        assert sum(a is not None for a in pe._active) == 2
        assert len(pe._queue) == 1 and pe.pool.free_pages() == 0
        pe.run()
    want, jpe = _jax_tokens(setup, prompts, [None] * 3, [5] * 3, slots=4,
                            num_pages=9, page_size=4, max_len=16,
                            chunk_size=4)
    for f, p, j in zip(futs, prompts, want):
        np.testing.assert_array_equal(f.result(),
                                      reference(refs["f32"], p, None, 5))
        np.testing.assert_array_equal(f.result(), j)
    assert pe.peak_used_pages <= 8 and pe.peak_resident == 2
    assert (pe.peak_used_pages, pe.peak_resident) == (jpe.peak_used_pages,
                                                      jpe.peak_resident)
    with pytest.raises(ValueError, match="KV rows"):
        pe.submit(np.zeros(30, np.int32), None, max_tokens=8)


def test_lane_and_paged_exact_fit_boundary(setup):
    """need = prompt + max_tokens - 1: an exactly sized cache is accepted,
    one row less is rejected, in both engines."""
    jcfg, _, _, tcfg, tparams, _, refs = setup
    toks = _prompt(jax.random.PRNGKey(13), 6, jcfg)
    want = reference(refs["f32"], toks, None, 5)
    with TL.compute_precision(torch.float32):
        se = ServingEngine(tcfg, tparams, slots=1, cache_size=10)
        fut = se.submit(toks, None, max_tokens=5)   # needs exactly 10 rows
        se.run()
        np.testing.assert_array_equal(fut.result(), want)
        with pytest.raises(ValueError, match="cache slots"):
            ServingEngine(tcfg, tparams, slots=1, cache_size=9).submit(
                toks, None, max_tokens=5)
        pe = PagedServingEngine(tcfg, tparams, slots=1, num_pages=8,
                                page_size=5, max_len=10, chunk_size=5)
        pf = pe.submit(toks, None, max_tokens=5)    # 10 rows = max_len
        pe.run()
    np.testing.assert_array_equal(pf.result(), want)


def test_lane_and_paged_engines_token_equal_in_bf16(setup):
    """In the serving dtype the two engines prefill with the same numerics
    (the paged chunk's plain attention keeps p in f32, as flash_prefill
    does for lane admission), so a trace with a shared prefix (COW), a
    prompt over three chunks, an adapter stack and the base model gives
    the same tokens from both."""
    jcfg, _, _, tcfg, tparams, tpacks, _ = setup
    rng = np.random.default_rng(9)
    tok = lambda n: rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
    prefix = tok(9)
    trace = [(np.concatenate([prefix, tok(3)]), "a0"),
             (np.concatenate([prefix, tok(5)]), "a0"), (tok(11), "a1"),
             (tok(7), ("a0", "a1")), (tok(6), None)]
    se = ServingEngine(tcfg, tparams, slots=2, cache_size=24)
    pe = PagedServingEngine(tcfg, tparams, slots=2, num_pages=24,
                            page_size=4, max_len=20, chunk_size=4)
    assert se.caches[0].k.dtype == pe.caches[0].k.dtype == torch.bfloat16
    for e in (se, pe):
        for p in tpacks:
            e.register(p)
    lane = [se.submit(p, a, max_tokens=6) for p, a in trace]
    se.run()
    paged = [pe.submit(*trace[0], max_tokens=6)]
    pe.run()                          # registers the shared prefix pages
    paged += [pe.submit(p, a, max_tokens=6) for p, a in trace[1:]]
    pe.run()
    assert pe.pool.prefix_hits >= 1 and pe.pool.cow_copies >= 1
    for f, g in zip(lane, paged):
        np.testing.assert_array_equal(f.result(), g.result())
