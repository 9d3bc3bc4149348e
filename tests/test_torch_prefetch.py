"""The port's async prefetch pipeline against repro.hub's.

``tests/test_prefetch.py``'s cases, held against the JAX package where it
has the same thing to say:
  * the store: a miss then a hit, one disk read for duplicate prefetches
    (the counters the JAX store reports on the same sequence), the
    in-flight pin against eviction, the eviction race under threads,
    cancel of a sole versus a shared load, the staging tier;
  * ``MultiTenantEngine``: background tables equal the synchronous ones bit
    for bit, stale builds are discarded, additive versus structural
    ``ids_covered``, the deferred fused transition, and ``slot_pad``
    against the JAX engine's padded tables (the two packages lay tables
    out differently, so each slot is compared as the dense delta it
    holds);
  * the engines: ``async_prefetch=True`` gives the tokens of the
    synchronous path (and, for the lane engine, of the JAX engine with
    async prefetch) on a mixed cold/hot trace, int8 tables on the paged
    engine, and a cancelled queued request releases its pins.
Packs are drawn with numpy from a seed.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.hub import AdapterStore as JStore
from repro.hub import ServingEngine as JServingEngine
from repro.models import layers as JL
from repro.serving import MultiTenantEngine as JMT
from repro_torch.core.switching import FusedLRU
from repro_torch.hub import (AdapterStore, PagedServingEngine, QuantPack,
                             RequestShed, ServingEngine)
from repro_torch.models import layers as TL
from repro_torch.serving import MultiTenantEngine

from test_torch_hub_serving import bridged_setup
from test_torch_packio import _packs, _synth


def wait_for(pred, timeout=20.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise TimeoutError("condition not met")
        time.sleep(0.005)


def cold_stores(tmp_path, n=4, values="f32", **kw):
    """(JAX store, port store) holding the same n packs, none resident."""
    jstore = JStore(str(tmp_path / "j"), **kw)
    store = AdapterStore(str(tmp_path / "t"), **kw)
    for i in range(n):
        jp, tp = _packs(_synth(name=f"t{i}", seed=i), name=f"t{i}")
        for s, p in ((jstore, jp), (store, tp)):
            s.add(p, values=values)
            s.evict(f"t{i}")
    return jstore, store


def _counters(s):
    return (s.loads, s.prefetch_hits, s.prefetch_misses, s.evictions,
            s.resident_names(), s.inflight_names())


# ---------------------------------------------------------------------------
# Store: prefetch handles, pins, tiers
# ---------------------------------------------------------------------------

def test_prefetch_miss_then_hit(tmp_path):
    for s in cold_stores(tmp_path):
        h = s.prefetch("t0")
        assert h.cold
        p = h.result()
        assert p.name == "t0" and s.is_resident("t0")
        h2 = s.prefetch("t0")
        assert h2.done() and not h2.cold
        np.testing.assert_array_equal(np.asarray(p.entries["embed/emb"][1]),
                                      np.asarray(h2.result()
                                                 .entries["embed/emb"][1]))
    jstore, store = cold_stores(tmp_path / "again")
    for s in (jstore, store):
        s.prefetch("t0").result()
        s.prefetch("t0").result()
    assert _counters(store) == _counters(jstore)
    assert store.prefetch_misses == 1 and store.prefetch_hits == 1
    jstore.shutdown()
    store.shutdown()


def test_prefetch_dedup_single_disk_load(tmp_path):
    jstore, store = cold_stores(tmp_path)
    for s in (jstore, store):
        packs = [h.result() for h in [s.prefetch("t1") for _ in range(4)]]
        assert all(p.name == "t1" for p in packs)
        s.shutdown()
    assert store.loads == jstore.loads == 1
    # whether a later submit counts as a hit or a miss depends on whether
    # the first load has landed by then: only their sum is fixed
    for s in (jstore, store):
        assert s.prefetch_hits + s.prefetch_misses == 4
        assert s.prefetch_misses >= 1
        assert s.resident_names() == ["t1"] and s.inflight_names() == []


def test_inflight_pin_blocks_eviction(tmp_path):
    """LRU pressure and an explicit evict never drop a pack that an
    outstanding handle is about to hand over; the same sequence on both
    stores."""
    one = _packs(_synth(name="t0"))[1].nbytes()
    for s in cold_stores(tmp_path, budget_bytes=int(one * 1.5)):
        h = s.prefetch("t0")
        wait_for(h.done)
        for i in (1, 2, 3):
            s.get(f"t{i}")
        assert s.is_resident("t0") and not s.evict("t0")
        assert "t0" in s.inflight_names()
        assert h.result().name == "t0"
        assert "t0" not in s.inflight_names()
        s.get("t1")
        s.get("t2")
        assert not s.is_resident("t0") and s.evictions > 0
        s.shutdown()
    jstore, store = cold_stores(tmp_path / "again",
                                budget_bytes=int(one * 1.5))
    for s in (jstore, store):
        h = s.prefetch("t0")
        wait_for(h.done)
        for i in (1, 2, 3):
            s.get(f"t{i}")
        h.result()
        s.get("t1")
        s.shutdown()
    assert _counters(store) == _counters(jstore)


def test_eviction_race_concurrent_prefetch(tmp_path):
    """Four threads prefetch under a budget of 2.5 packs: every handle
    comes back with its own pack, and no pin is left."""
    n = 6
    one = _packs(_synth(name="t0"))[1].nbytes()
    _, store = cold_stores(tmp_path, n=n, budget_bytes=int(one * 2.5),
                           workers=3)
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(30):
                name = f"t{rng.integers(n)}"
                p = store.prefetch(name).result()
                if p.name != name:
                    errors.append(f"got {p.name} for {name}")
        except Exception as e:          # noqa: BLE001 - surface in main
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    store.shutdown()
    assert store.inflight_names() == []


def test_prefetch_cancel_sole_vs_shared(tmp_path):
    for s in cold_stores(tmp_path):
        h1, h2 = s.prefetch("t2"), s.prefetch("t2")
        h1.cancel()                        # h2 still wants the load
        assert h2.result().name == "t2"
        s.prefetch("t3").cancel()
        s.shutdown()
        assert s.inflight_names() == []
        assert s.get("t3").name == "t3"


def test_staging_tier_caches_dequant(tmp_path):
    """An int8 pack is staged dequantized on the worker, and a get hits
    the staged form, on both stores; the port's staged values are the JAX
    store's."""
    jstore, store = cold_stores(tmp_path, n=2, values="int8",
                                staging_bytes=1 << 20)
    got = []
    for s in (jstore, store):
        p = s.prefetch("t0", dequantize=True).result()
        assert not isinstance(p, QuantPack)
        assert s.staged_names() == ["t0"]
        before = s.staging_hits
        got.append(s.get("t0"))
        assert s.staging_hits == before + 1
        s.shutdown()
    for path, (ji, jv) in got[0].entries.items():
        ti, tv = got[1].entries[path]
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_staging_tier_evicts_past_its_budget(tmp_path):
    """The port stages f32 packs as well (their pinned copies on a card):
    past ``staging_bytes`` the least recent is evicted, never a pack a
    handle still holds."""
    one = _packs(_synth(name="t0"))[1].nbytes()
    _, store = cold_stores(tmp_path, n=3, staging_bytes=int(one * 1.5))
    h = store.prefetch("t0", dequantize=True)
    wait_for(h.done)
    store.get("t1")                        # t0 is pinned by h: t0 stays
    assert store.staged_names() == ["t0", "t1"]
    h.result()
    store.get("t2")
    assert store.staged_names() == ["t2"]
    assert store.staged_bytes() <= store.staging_bytes
    store.shutdown()


# ---------------------------------------------------------------------------
# Engine: background table builds, slot_pad
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    return bridged_setup(3)


def assert_tables_equal(ta, tb):
    assert sorted(ta) == sorted(tb)
    for path in ta:
        assert sorted(ta[path]) == sorted(tb[path])
        for k in ta[path]:
            assert torch.equal(ta[path][k], tb[path][k]), (path, k)


def test_async_build_matches_sync_tables(setup):
    *_, tcfg, tparams, tpacks = setup
    sync, eng = MultiTenantEngine(tcfg, tparams), \
        MultiTenantEngine(tcfg, tparams)
    for p in tpacks:
        sync.register(p)
        eng.register(p)
    sync._ensure_tables()
    assert eng.kick_async_build()
    wait_for(lambda: eng._build_fut is None or eng._build_fut[1].done())
    assert eng.poll_async_build()
    assert eng.async_adopted == 1 and not eng._dirty
    assert eng._slots == sync._slots
    assert_tables_equal(eng._tables, sync._tables)
    eng.shutdown()


def test_async_build_stale_discarded(setup):
    *_, tcfg, tparams, tpacks = setup
    eng = MultiTenantEngine(tcfg, tparams)
    eng.register(tpacks[0])
    eng.kick_async_build()
    wait_for(lambda: eng._build_fut[1].done())
    eng.register(tpacks[1])                # the epoch moved on: stale
    eng.poll_async_build()
    assert eng.async_stale == 1 and eng._dirty
    eng._ensure_tables()
    assert tpacks[1].name in eng._slots
    eng.shutdown()


def test_async_build_failure_raises(setup):
    """A background build that raised is counted in ``async_failed`` and
    raised where it is polled and where serving waits for it, with a
    ``prefetch.h2d_failed`` instant: never replaced by a quiet synchronous
    rebuild."""
    from repro_torch.analysis import trace
    *_, tcfg, tparams, tpacks = setup
    eng = MultiTenantEngine(tcfg, tparams)
    eng.register(tpacks[0])
    real = eng._build_tables

    def boom(*args):
        raise RuntimeError("out of memory on the side stream")
    eng._build_tables = boom
    tr = trace.install(trace.Tracer())
    try:
        eng.kick_async_build()
        wait_for(lambda: eng._build_fut[1].done())
        with pytest.raises(RuntimeError, match="side stream"):
            eng.poll_async_build()
        assert eng.async_failed == 1 and eng._dirty
        eng.kick_async_build()             # serving waits for this one
        with pytest.raises(RuntimeError, match="side stream"):
            eng._ensure_tables()
        assert eng.async_failed == 2 and eng._dirty
        assert eng.async_adopted == 0 and eng._build_fut is None
    finally:
        trace.uninstall()
    assert [e["name"] for e in tr.events()].count(
        "prefetch.h2d_failed") == 2
    eng._build_tables = real
    eng._ensure_tables()
    assert not eng._dirty and tpacks[0].name in eng._slots
    eng.shutdown()


def test_ids_covered_additive_vs_structural(setup):
    *_, tcfg, tparams, tpacks = setup
    eng = MultiTenantEngine(tcfg, tparams)
    eng.register(tpacks[0])
    eng.ids_for([tpacks[0].name])
    assert eng.ids_covered([tpacks[0].name])
    eng.register(tpacks[1])                # additive: old rows stay right
    assert eng.ids_covered([tpacks[0].name])
    assert not eng.ids_covered([tpacks[1].name])
    eng.register(tpacks[0])                # re-register: structural
    assert not eng.ids_covered([tpacks[0].name])
    eng.shutdown()


def test_deferred_transition_applies_at_adoption(setup):
    *_, tcfg, tparams, tpacks = setup
    hot = [tpacks[0].name] * 4 + [tpacks[1].name]
    params = [jax.tree.map(lambda x: x.clone(), tparams) for _ in range(2)]
    sync = MultiTenantEngine(tcfg, params[0],
                             scheduler=FusedLRU(promote_at=0.3))
    eng = MultiTenantEngine(tcfg, params[1],
                            scheduler=FusedLRU(promote_at=0.3))
    for p in tpacks[:2]:
        sync.register(p)
        eng.register(p)
    sync.schedule(hot)                     # promotes a0 at once
    sync._ensure_tables()
    assert sync.fused == tpacks[0].name
    eng.schedule(hot, defer=True)          # keeps the decision
    assert eng.fused is None and eng._pending is not None
    assert eng.kick_async_build()
    wait_for(lambda: eng._build_fut[1].done())
    assert eng.poll_async_build()
    assert eng.fused == tpacks[0].name and eng._pending is None
    assert eng.async_adopted == 1
    assert eng._slots == sync._slots
    assert_tables_equal(eng._tables, sync._tables)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(
            params[0])[0], jax.tree.leaves(params[1])):
        assert torch.equal(a, b), path    # the same fused base
    eng.shutdown()
    sync.shutdown()


def _dense_port(t, lead_i, slot, n, m):
    rows, colptr, vals = (t[k].reshape((-1,) + t[k].shape[-2:])[lead_i, slot]
                          for k in ("rows", "colptr", "vals"))
    cnt = int(colptr[-1])
    cols = torch.searchsorted(colptr, torch.arange(cnt), right=True) - 1
    d = np.zeros((n, m), np.float32)
    np.add.at(d, (rows[:cnt].long().numpy(), cols.numpy()),
              vals[:cnt].float().numpy())
    return d


def _dense_jax(t, lead_i, slot, n, m):
    rows, cols, vals = (np.asarray(t[k]).reshape(
        (-1,) + np.asarray(t[k]).shape[-2:])[lead_i, slot]
        for k in ("rows", "cols", "vals"))
    d = np.zeros((n, m), np.float32)
    np.add.at(d, (rows, cols), vals.astype(np.float32))
    return d


def test_slot_pad_keeps_shapes_and_values(setup):
    """slot_pad=4 with two adapters: the port's tables keep the exact
    tables' slots and add two empty ones, the JAX engine's padded tables
    hold the same delta in every slot, and a third adapter keeps the
    shapes."""
    jcfg, jparams, jpacks, tcfg, tparams, tpacks = setup
    exact = MultiTenantEngine(tcfg, tparams)
    padded = MultiTenantEngine(tcfg, tparams, slot_pad=4)
    jeng = JMT(jcfg, jparams, slot_pad=4, interpret=False)
    for jp, tp in zip(jpacks[:2], tpacks[:2]):
        exact.register(tp)
        padded.register(tp)
        jeng.register(jp)
    for e in (exact, padded, jeng):
        e._ensure_tables()
    assert exact._slots == padded._slots == jeng._slots
    for path, t in exact._tables.items():
        tp, tj = padded._tables[path], jeng._tables[path]
        assert tp["vals"].shape[-2] == 4 == tj["vals"].shape[-2]
        assert t["vals"].shape[-2] == 2
        for k in t:
            assert torch.equal(tp[k][..., :2, :], t[k])
        assert not tp["vals"][..., 2:, :].any()
        assert not tp["colptr"][..., 2:, :].any()
        *lead, n, m = padded._shapes[path]
        for li in range(int(np.prod(lead)) if lead else 1):
            for slot in range(4):
                np.testing.assert_array_equal(
                    _dense_port(tp, li, slot, n, m),
                    _dense_jax(tj, li, slot, n, m), err_msg=(path, slot))
    padded.register(tpacks[2])
    padded._ensure_tables()
    assert padded._tables[path]["vals"].shape[-2] == 4
    for e in (exact, padded, jeng):
        e.shutdown()


# ---------------------------------------------------------------------------
# Serving: async against sync on a mixed cold/hot trace
# ---------------------------------------------------------------------------

def _stores(tmp_path, tpacks, values, tags=("sync", "async")):
    out = []
    for tag in tags:
        store = AdapterStore(str(tmp_path / f"store-{tag}"))
        for p in tpacks:
            store.add(p, values=values)
            store.evict(p.name)
        out.append(store)
    return out


def _trace(vocab, rng, adapters):
    return [(rng.integers(0, vocab, 5 + (i % 3)).astype(np.int32), a,
             4 + (i % 2)) for i, a in enumerate(adapters)]


def _run(engine, reqs):
    futs = [engine.submit(p, a, max_tokens=t) for p, a, t in reqs]
    engine.run()
    engine.shutdown(include_store=True)
    return futs


def test_lane_async_parity_mixed_cold_hot(tmp_path, setup):
    """Hot a0 (registered first), cold singles, base traffic and a cold
    stack: sync and async port engines and the JAX async engine emit the
    same tokens."""
    jcfg, jparams, jpacks, tcfg, tparams, tpacks = setup
    adapters = ["a0", "a1", None, ("a1", "a2"), "a0", "a2"]
    reqs = _trace(tcfg.vocab_size, np.random.default_rng(0), adapters)
    results = {}
    with TL.compute_precision(torch.float32):
        for mode, store in zip((False, True),
                               _stores(tmp_path, tpacks, "f32")):
            srv = ServingEngine(tcfg, tparams, slots=2, cache_size=32,
                                store=store, async_prefetch=mode, slot_pad=4)
            srv.register("a0")
            results[mode] = _run(srv, reqs)
            assert srv.engine._tables[next(iter(srv.engine._tables))][
                "vals"].shape[-2] == 4
            if mode:
                assert srv.engine.async_builds >= 1
    jstore = JStore(str(tmp_path / "j"))
    for p in jpacks:
        jstore.add(p)
        jstore.evict(p.name)
    with JL.compute_precision(jnp.float32):
        jsrv = JServingEngine(jcfg, jparams, slots=2, cache_size=32,
                              store=jstore, async_prefetch=True, slot_pad=4,
                              interpret=False)
        jsrv.register("a0")
        jfuts = [jsrv.submit(p, a, max_tokens=t) for p, a, t in reqs]
        jsrv.run()
        jsrv.shutdown(include_store=True)
    for fs, fa, fj in zip(results[False], results[True], jfuts):
        assert fs.done() and fa.done()
        np.testing.assert_array_equal(fs.result(), fa.result())
        np.testing.assert_array_equal(fa.result(), np.asarray(fj.result()))
    cold = [f.cold for f in results[True]]
    assert cold[1] and cold[3] and not cold[0] and not cold[2]


def test_paged_async_parity_mixed_cold_hot_int8(tmp_path, setup):
    *_, tcfg, tparams, tpacks = setup
    adapters = ["a0", "a1", None, "a2", "a1", "a0"]
    reqs = _trace(tcfg.vocab_size, np.random.default_rng(1), adapters)
    results = {}
    with TL.compute_precision(torch.float32):
        for mode, store in zip((False, True),
                               _stores(tmp_path, tpacks, "int8")):
            srv = PagedServingEngine(tcfg, tparams, slots=2, num_pages=41,
                                     page_size=2, max_len=16, chunk_size=4,
                                     store=store, table_dtype="int8",
                                     async_prefetch=mode, slot_pad=4)
            srv.register("a0")
            results[mode] = _run(srv, reqs)
    for fs, fa in zip(results[False], results[True]):
        assert fs.done() and fa.done()
        np.testing.assert_array_equal(fs.result(), fa.result())
    cold = [f.cold for f in results[True]]
    assert cold[1] and cold[3] and not cold[0] and not cold[2]


def test_async_cancel_queued_request(tmp_path, setup):
    *_, tcfg, tparams, tpacks = setup
    rng = np.random.default_rng(2)
    store = _stores(tmp_path, tpacks, "f32", tags=("solo",))[0]
    with TL.compute_precision(torch.float32):
        srv = ServingEngine(tcfg, tparams, slots=1, cache_size=32,
                            store=store, async_prefetch=True, slot_pad=4)
        srv.register("a0")
        keep = srv.submit(rng.integers(0, tcfg.vocab_size, 5), "a0",
                          max_tokens=3)
        dead = srv.submit(rng.integers(0, tcfg.vocab_size, 5), "a1",
                          max_tokens=3)
        assert srv.cancel(dead)
        srv.run()
        srv.shutdown(include_store=True)
    assert keep.done() and len(keep.result()) == 3
    assert dead.cancelled
    with pytest.raises(RequestShed, match="cancelled"):
        dead.result()
    assert store.inflight_names() == []
