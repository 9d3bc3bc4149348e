"""The serving fault model of the port against ``repro.runtime.faults``.

``tests/test_faults.py`` (and ``tests/test_ft.py:76-130``) are the
checklist. Each case runs on both packages, the JAX store and engines
(``interpret=False``, f32) and the port's, on bridged weights and numpy
packs, and the outcomes must be equal: which futures finish and with
which tokens, which fail and with which typed error, the degraded flags,
the counters, the quarantine list, and what the injector counted. The
draws of ``FaultInjector`` are held equal over 1,000 (site, key,
attempt), so a plan injects the same faults in both packages.
"""
import hashlib
import threading
import time
from concurrent import futures
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutTimeoutError
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.adapters import AdapterPack as JPack
from repro.hub import AdapterStore as JStore
from repro.hub import PagedServingEngine as JPaged
from repro.hub import ServingEngine as JServing
from repro.models import layers as JL
from repro.runtime import faults as jfaults
from repro.runtime import ft as jft
from repro_torch.core.adapters import map_entries
from repro_torch.hub import AdapterStore, PagedServingEngine, ServingEngine
from repro_torch.models import layers as TL
from repro_torch.runtime import faults, ft
from repro_torch.serving import MultiTenantEngine

from test_torch_hub_serving import bridged_setup, np_packs


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    """Every test leaves both switchboards clean."""
    yield
    faults.uninstall()
    jfaults.uninstall()


def draw(seed, site, key, n):
    """The injector's stateless draw, written out, so that a test can
    search for a seed with the fail / succeed pattern it wants."""
    digest = hashlib.sha256(f"{seed}:{site}:{key}:{n}".encode()).digest()
    return int.from_bytes(digest[:4], "big") / 2.0 ** 32


def find_seed(site, key, pattern, p):
    """The smallest seed whose first draws fail (True) exactly as
    ``pattern`` at probability ``p``."""
    for seed in range(10_000):
        if all((draw(seed, site, key, i) < p) == want
               for i, want in enumerate(pattern)):
            return seed
    raise AssertionError("no seed found")


@pytest.fixture(scope="module")
def pkgs():
    """Both packages' serving stacks, as namespaces the cases drive
    alike: the smoke starcoder2-7b with f32 weights from jax.random, and
    three numpy packs strong enough that each adapter gives other tokens
    than the base model."""
    jcfg, jparams, _, tcfg, tparams, _ = bridged_setup(0)
    jpacks, tpacks = np_packs(tparams, 3, scale=0.5)
    jax_ns = SimpleNamespace(
        name="jax", faults=jfaults, Store=JStore, packs=jpacks,
        precision=lambda: JL.compute_precision(jnp.float32),
        renamed=lambda i, n: JPack(n, jpacks[i].entries, jpacks[i].alpha),
        engine=lambda kind, **kw: (JServing(jcfg, jparams, interpret=False,
                                            **kw) if kind == "lane"
                                   else JPaged(jcfg, jparams, interpret=False,
                                               **kw)))
    port_ns = SimpleNamespace(
        name="port", faults=faults, Store=AdapterStore, packs=tpacks,
        precision=lambda: TL.compute_precision(torch.float32),
        renamed=lambda i, n: map_entries(tpacks[i], name=n),
        engine=lambda kind, **kw: (ServingEngine(tcfg, tparams, **kw)
                                   if kind == "lane"
                                   else PagedServingEngine(tcfg, tparams,
                                                           **kw)))
    return {"jax": jax_ns, "port": port_ns, "tcfg": tcfg, "tparams": tparams,
            "tpacks": tpacks}


def prompt(seed=5, n=6):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.int32)


def outcome(fut):
    """A future's terminal state, comparable across the packages."""
    if fut.error is not None:
        return (type(fut.error).__name__, getattr(fut.error, "reason", None))
    if not fut.done():
        return ("in flight",)
    return ("ok", fut.result().tolist(), fut.degraded, fut.degraded_from)


def counters(eng):
    h = eng.health()
    return {k: h[k] for k in ("shed", "degraded", "poisoned", "failed",
                              "quarantined", "queued", "active")}


def on_both(pkgs, case, tmp_path, reference=True):
    """Run ``case(k, root)`` on each package; the outcomes must be equal.
    Returns the port's. Without ``reference`` only the port runs (a case
    that holds the port to itself, where the JAX engines' compiles would
    only cost time)."""
    got = {}
    for name in ("jax", "port") if reference else ("port",):
        k = pkgs[name]
        with k.precision():
            got[name] = case(k, str(tmp_path / name))
        k.faults.uninstall()
    assert got["port"] == got.get("jax", got["port"])
    return got["port"]


# ---------------------------------------------------------------------------
# The injector: draws, payload corruption, one-shot poison and preemption
# ---------------------------------------------------------------------------

def test_injector_draws_equal_the_reference():
    """1,000 draws over four sites and a few keys, each (site, key) drawn
    repeatedly so that the attempt counts up, equal in both packages."""
    plan = dict(seed=3, disk_fail_p=0.5, corrupt_p=1.0)
    a = faults.FaultInjector(faults.FaultPlan(**plan))
    b = jfaults.FaultInjector(jfaults.FaultPlan(**plan))
    rng = np.random.default_rng(0)
    sites = ("disk", "corrupt", "worker", "build")
    keys = ("t0", "a1@2", "/x/p.shpk", "tables", "adapter_3")
    calls = [(sites[i], keys[j]) for i, j in
             zip(rng.integers(0, 4, 1000), rng.integers(0, 5, 1000))]
    da = [a._draw(s, k) for s, k in calls]
    assert da == [b._draw(s, k) for s, k in calls]
    assert max(a._attempts.values()) > 40      # deep attempt counts too
    seen = {}
    for (s, k), d in zip(calls, da):           # sha256(seed:site:key:n)
        n = seen[s, k] = seen.get((s, k), -1) + 1
        assert d == draw(3, s, k, n)
    payload = b"0123456789" * 20
    ca = a.corrupt_payload("/x/p.shpk", payload)
    assert ca == b.corrupt_payload("/x/p.shpk", payload) != payload
    assert sum(x != y for x, y in zip(ca, payload)) == 1
    assert a.counts == b.counts == {"corrupt": 1}


def test_uninstalled_hooks_are_noops():
    assert not faults.enabled() and faults.active() is None
    payload = b"abc"
    assert faults.corrupt_payload("/p", payload) is payload
    assert faults.poison_logits(123) is None
    faults.on_disk_read("t0")
    faults.on_worker("t0")
    faults.on_table_build()
    faults.on_engine_step(99)


def test_poison_and_preempt_fire_once_at_first_reachable_step():
    got = []
    for F, SP in ((faults, ft.SimulatedPreemption),
                  (jfaults, jft.SimulatedPreemption)):
        inj = F.FaultInjector(F.FaultPlan(poison_step=5, poison_slot=2,
                                          preempt_step=7))
        seq = [inj.poison_logits(s) for s in (4, 6, 7)]
        inj.on_engine_step(6)
        with pytest.raises(SP):
            inj.on_engine_step(9)
        inj.on_engine_step(10)                 # a rebuilt engine survives
        got.append((seq, inj.counts))
    assert got[0] == got[1] == ([None, 2, None], {"poison": 1,
                                                  "preempt": 1})
    assert faults.SimulatedPreemption is ft.SimulatedPreemption


# ---------------------------------------------------------------------------
# The store: retry -> quarantine -> fail fast, worker death, shutdown
# ---------------------------------------------------------------------------

def cold_store(k, root, n=3, **kw):
    store = k.Store(root, **kw)
    for p in k.packs[:n]:
        store.add(p)
        store.evict(p.name)
    return store


def wedge_pool(store, gate):
    """The store's single worker, parked on ``gate``: every prefetch
    submitted after this queues behind it."""
    with store._lock:
        store._pool = ThreadPoolExecutor(max_workers=1)
    store._pool.submit(gate.wait)


def store_retry_then_success(k, root):
    store = cold_store(k, root, load_retries=2, retry_backoff_s=0.001)
    seed = find_seed("disk", "a0", (True, False), p=0.5)
    inj = k.faults.install(k.faults.FaultPlan(seed=seed, disk_fail_p=0.5))
    name = store.get("a0").name
    return name, store.retries, dict(inj.counts), store.quarantined()


def store_quarantine_then_fail_fast(k, root):
    store = cold_store(k, root, load_retries=1, retry_backoff_s=0.001)
    inj = k.faults.install(k.faults.FaultPlan(seed=0, disk_fail_p=1.0))
    errs = []
    for call in (store.get, store.get, store.prefetch):
        try:
            call("a0")
        except Exception as e:
            errs.append(type(e).__name__)
    out = [errs, dict(inj.counts), store.load_failures, store.quarantined()]
    k.faults.uninstall()
    out += [store.clear_quarantine("a0"), store.clear_quarantine("a0"),
            store.get("a0").name]
    return out


def store_corrupt_file_quarantines(k, root):
    """A real flipped payload byte, no injector: crc32 rejects it, the
    retries run out, the pack is quarantined; the repaired file loads
    after a clear."""
    store = cold_store(k, root, n=2, load_retries=1, retry_backoff_s=0.001)
    path = store._paths["a0"]
    good = open(path, "rb").read()
    raw = bytearray(good)
    raw[-1] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    try:
        store.get("a0")
        err = None
    except Exception as e:
        err = type(e).__name__
    out = [err, store.retries, store.quarantined(), store.get("a1").name]
    open(path, "wb").write(good)
    store.clear_quarantine("a0")
    return out + [store.get("a0").name]


def store_injected_corruption(k, root):
    store = cold_store(k, root, n=1, load_retries=0)
    inj = k.faults.install(k.faults.FaultPlan(seed=0, corrupt_p=1.0))
    try:
        store.get("a0")
        err = None
    except Exception as e:
        err = type(e).__name__
    return err, dict(inj.counts), store.quarantined()


def store_worker_death(k, root):
    """A dead prefetch worker is a typed StoreError and releases the
    eviction pin."""
    store = cold_store(k, root)
    k.faults.install(k.faults.FaultPlan(seed=0, worker_death_p=1.0))
    h = store.prefetch("a0")
    try:
        h.result()
        err = None
    except Exception as e:
        err = type(e).__name__
    pins = store.inflight_names()
    k.faults.uninstall()
    out = [err, pins, store.get("a0").name, store.evict("a0")]
    store.shutdown()
    return out


def store_timeout_keeps_handle(k, root):
    store = cold_store(k, root, workers=1)
    gate = threading.Event()
    wedge_pool(store, gate)
    h = store.prefetch("a0")
    with pytest.raises(FutTimeoutError):
        h.result(timeout=0.05)
    pinned = "a0" in store.inflight_names()
    gate.set()
    out = [pinned, h.result(timeout=20.0).name, store.inflight_names()]
    store.shutdown()
    return out


def store_shutdown_no_wait(k, root):
    store = cold_store(k, root, workers=1)
    gate = threading.Event()
    wedge_pool(store, gate)
    hs = [store.prefetch(f"a{i}") for i in range(3)]
    store.shutdown(wait=False)
    gate.set()
    store.shutdown(wait=False)                 # idempotent
    store.shutdown()                           # and either mode after
    names = [h.result(timeout=20.0).name for h in hs]
    out = [names, store.inflight_names(), store._inflight_bytes]
    h = store.prefetch("a0")                   # no new pool: a sync load
    return out + [h.result().name, store._pool is None]


STORE_CASES = {
    "retry_then_success": (store_retry_then_success,
                           ("a0", 1, {"disk_fail": 1}, [])),
    "quarantine_then_fail_fast": (
        store_quarantine_then_fail_fast,
        [["StoreError", "AdapterUnavailable", "AdapterUnavailable"],
         {"disk_fail": 2}, 1, ["a0"], True, False, "a0"]),
    "corrupt_file_quarantines": (store_corrupt_file_quarantines,
                                 ["StoreError", 1, ["a0"], "a1", "a0"]),
    "injected_corruption": (store_injected_corruption,
                            ("StoreError", {"corrupt": 1}, ["a0"])),
    "worker_death": (store_worker_death, ["StoreError", [], "a0", True]),
    "timeout_keeps_handle": (store_timeout_keeps_handle, [True, "a0", []]),
    "shutdown_no_wait": (store_shutdown_no_wait,
                         [["a0", "a1", "a2"], [], 0, "a0", True]),
}


@pytest.mark.parametrize("case", list(STORE_CASES))
def test_store_ladder(pkgs, tmp_path, case):
    fn, want = STORE_CASES[case]
    assert on_both(pkgs, fn, tmp_path) == want


# ---------------------------------------------------------------------------
# The engines: shedding, the fallback ladder, the poisoned slot, table
# build back-off, crash recovery
# ---------------------------------------------------------------------------

def store_of(k, root, **kw):
    store = k.Store(root, **kw)
    for p in k.packs:
        store.add(p)
    return store


def lane(k, store, **kw):
    return k.engine("lane", slots=2, cache_size=24, store=store, **kw)


def paged(k, store, **kw):
    return k.engine("paged", slots=2, num_pages=24, page_size=4,
                    chunk_size=4, store=store, **kw)


ENGINES = {"lane": lane, "paged": paged}


def bounded_queue(k, root, make):
    eng = make(k, store_of(k, root), max_queue=2)
    futs = [eng.submit(prompt(), "a0", max_tokens=2) for _ in range(3)]
    at_submit = outcome(futs[2])               # shed at the door
    eng.run()
    return at_submit, [outcome(f) for f in futs], counters(eng)


def queue_deadline(k, root, make):
    eng = make(k, store_of(k, root))
    keep = eng.submit(prompt(), "a0", max_tokens=2)
    doomed = eng.submit(prompt(6), "a1", max_tokens=2, deadline_s=1e-6)
    time.sleep(0.01)
    eng.run()
    return outcome(keep), outcome(doomed), counters(eng)


def fallback_previous(k, root, make):
    """p@2 quarantined: a request for p is served by p@1, flagged."""
    store = k.Store(root)
    vids = [store.publish(k.renamed(i, "p")) for i in (0, 1)]
    eng = make(k, store)
    toks = prompt()
    want = eng.submit(toks, "p@1", max_tokens=3)
    eng.run()
    store.quarantine("p@2", reason="test")
    got = eng.submit(toks, "p", max_tokens=3)
    eng.run()
    return vids, outcome(want), outcome(got), counters(eng)


def fallback_base_and_none(k, root, make):
    store = store_of(k, root)
    eng = make(k, store)
    toks = prompt()
    base = eng.submit(toks, None, max_tokens=3)
    eng.run()
    store.quarantine("a0", reason="test")     # unversioned: no prior rung
    got = eng.submit(toks, "a0", max_tokens=3)
    eng.run()
    strict = make(k, store, fallback="none")
    failed = strict.submit(toks, "a0", max_tokens=3)
    return (outcome(base), outcome(got), counters(eng), outcome(failed),
            counters(strict))


def prefetch_failure_degrades(k, root, make):
    """With async prefetch, a prefetch whose worker dies walks the ladder
    in the queue (here to the base model), and the request serves."""
    store = store_of(k, root)
    for p in k.packs:
        store.evict(p.name)
    eng = make(k, store, async_prefetch=True)
    base = eng.submit(prompt(), None, max_tokens=3)
    eng.run()
    inj = k.faults.install(k.faults.FaultPlan(seed=0, worker_death_p=1.0))
    got = eng.submit(prompt(), "a1", max_tokens=3)
    eng.run()
    k.faults.uninstall()
    eng.shutdown(include_store=True)
    return (outcome(base), outcome(got), dict(inj.counts), counters(eng),
            store.inflight_names())


def nan_guard_parity(k, root, make):
    """The guard's path gives the plain argmax's tokens when nothing is
    poisoned."""
    outs = []
    for guard in (False, True):
        eng = make(k, store_of(k, f"{root}-{guard}"), nan_guard=guard)
        futs = [eng.submit(prompt(), a, max_tokens=4) for a in ("a0", None)]
        eng.run()
        outs.append([outcome(f) for f in futs])
    assert outs[0] == outs[1]
    return outs[1]


def poisoned_slot(k, root, make):
    """A poisoned slot fails only its request; the survivor keeps the
    fault-free tokens, and the slot serves again."""
    eng = make(k, store_of(k, root), nan_guard=True)
    toks = prompt()
    ref = [eng.submit(toks, a, max_tokens=6) for a in ("a0", "a1")]
    eng.run()
    inj = k.faults.install(k.faults.FaultPlan(
        poison_step=eng.step_count + 2, poison_slot=0))
    victim = eng.submit(toks, "a0", max_tokens=6)
    other = eng.submit(toks, "a1", max_tokens=6)
    eng.run()
    k.faults.uninstall()
    again = eng.submit(toks, "a0", max_tokens=6)
    eng.run()
    assert outcome(other) == outcome(ref[1])
    assert outcome(again) == outcome(ref[0])
    return (outcome(victim), dict(inj.counts), counters(eng))


def build_backoff(k, root, make):
    """A table build that fails (a simulated out-of-memory) backs off and
    retries; the request's tokens are the fault-free ones."""
    toks = prompt()
    eng = make(k, store_of(k, f"{root}-ref"))
    ref = eng.submit(toks, "a0", max_tokens=3)
    eng.run()
    seed = find_seed("build", "tables", (True, False), p=0.5)
    eng = make(k, store_of(k, f"{root}-inj"))
    inj = k.faults.install(k.faults.FaultPlan(seed=seed, build_fail_p=0.5))
    fut = eng.submit(toks, "a0", max_tokens=3)
    eng.run()
    k.faults.uninstall()
    assert inj.counts["build_fail"] >= 1
    assert outcome(fut) == outcome(ref)
    return outcome(fut), dict(inj.counts)


def crash_recovery(k, root, make):
    """A SimulatedPreemption kills the loop mid-run; an engine rebuilt over
    the same store replays the requests to the uninterrupted tokens."""
    store = store_of(k, root)
    spec = [("a0", 4), ("a1", 3), (None, 2)]
    eng = make(k, store)
    ref = [eng.submit(prompt(), a, max_tokens=n) for a, n in spec]
    eng.run()
    eng = make(k, store)
    futs = [eng.submit(prompt(), a, max_tokens=n) for a, n in spec]
    k.faults.install(k.faults.FaultPlan(preempt_step=eng.step_count + 2))
    with pytest.raises(Exception) as died:
        eng.run()
    k.faults.uninstall()
    unfinished = sum(not f.done() for f in futs)
    rebuilt = make(k, store)
    futs = [rebuilt.submit(prompt(), a, max_tokens=n) for a, n in spec]
    rebuilt.run()
    assert [outcome(f) for f in futs] == [outcome(f) for f in ref]
    return type(died.value).__name__, unfinished > 0, [outcome(f)
                                                       for f in futs]


ENGINE_CASES = {
    "bounded_queue": bounded_queue, "queue_deadline": queue_deadline,
    "fallback_previous": fallback_previous,
    "fallback_base_and_none": fallback_base_and_none,
    "prefetch_failure_degrades": prefetch_failure_degrades,
    "nan_guard_parity": nan_guard_parity, "poisoned_slot": poisoned_slot,
    "build_backoff": build_backoff, "crash_recovery": crash_recovery,
}


# held to themselves only: their outcome is a token equality the case
# asserts inside, and the JAX engines' compiles would cost most of the
# file's time
PORT_ONLY = {("nan_guard_parity", "lane"), ("crash_recovery", "lane"),
             ("queue_deadline", "paged"), ("fallback_previous", "paged")}


@pytest.mark.parametrize("case,kind", [(c, "lane") for c in ENGINE_CASES]
                         + [("poisoned_slot", "paged"),
                            ("fallback_previous", "paged"),
                            ("queue_deadline", "paged")])
def test_engine_ladder(pkgs, tmp_path, case, kind):
    got = on_both(pkgs, lambda k, root: ENGINE_CASES[case](
        k, root, ENGINES[kind]), tmp_path,
        reference=(case, kind) not in PORT_ONLY)
    if case == "bounded_queue":
        assert got[0] == ("RequestShed", "queue_full")
        assert [o[0] for o in got[1]] == ["ok", "ok", "RequestShed"]
        assert got[2]["shed"] == 1
    elif case == "queue_deadline":
        assert got[0][0] == "ok" and got[1] == ("RequestShed", "deadline")
        assert got[2]["shed"] == 1
    elif case == "fallback_previous":
        vids, want, degraded, cnt = got
        assert vids == ["p@1", "p@2"] and cnt["degraded"] == 1
        assert degraded == want[:2] + (True, "p")
    elif case == "fallback_base_and_none":
        base, deg, cnt, failed, strict = got
        assert deg == base[:2] + (True, "a0")
        assert failed == ("AdapterUnavailable", None)
        assert strict["failed"] == 1 and cnt["quarantined"] == ["a0"]
    elif case == "prefetch_failure_degrades":
        base, deg, counts, cnt, pins = got
        assert deg == base[:2] + (True, "a1") and counts["worker_death"] >= 1
        assert cnt["degraded"] == 1 and pins == []
    elif case == "poisoned_slot":
        assert got[0] == ("SlotPoisoned", None) and got[1] == {"poison": 1}
        assert got[2]["poisoned"] == 1 and got[2]["failed"] == 1
    elif case == "crash_recovery":
        assert got[:2] == ("SimulatedPreemption", True)


def test_background_build_failure_backs_off(pkgs):
    """The port's async table build (a side stream on the card): an
    injected TableBuildError in the background leaves the tables as they
    were and is counted in ``async_backoffs``, never raised; the next kick
    builds again and is adopted."""
    from repro_torch.analysis import trace
    tcfg, tparams, tpacks = pkgs["tcfg"], pkgs["tparams"], pkgs["tpacks"]
    eng = MultiTenantEngine(tcfg, tparams)
    eng.register(tpacks[0])
    eng._ensure_tables()
    old = eng._tables
    eng.register(tpacks[1])
    tr = trace.install(trace.Tracer())
    inj = faults.install(faults.FaultPlan(seed=0, build_fail_p=1.0))
    try:
        eng.kick_async_build()
        futures.wait([eng._build_fut[1]])
        assert not eng.poll_async_build()
        assert eng.async_backoffs == 1 and eng.async_failed == 0
        assert eng._tables is old and eng._dirty
        faults.uninstall()
        eng.kick_async_build()
        futures.wait([eng._build_fut[1]])
        assert eng.poll_async_build() and eng.async_adopted == 1
    finally:
        trace.uninstall()
        eng.shutdown()
    assert inj.counts == {"build_fail": 1}
    names = [e["name"] for e in tr.events()]
    assert names.count("fault.build_backoff") == 1
    assert "prefetch.h2d_failed" not in names
    assert tpacks[1].name in eng._slots


def test_sync_build_failure_keeps_old_tables(pkgs):
    tcfg, tparams, tpacks = pkgs["tcfg"], pkgs["tparams"], pkgs["tpacks"]
    eng = MultiTenantEngine(tcfg, tparams)
    eng.register(tpacks[0])
    eng._ensure_tables()
    old = eng._tables
    eng.register(tpacks[1])
    faults.install(faults.FaultPlan(seed=0, build_fail_p=1.0))
    with pytest.raises(faults.TableBuildError):
        eng._ensure_tables()
    assert eng._tables is old and eng._dirty


# ---------------------------------------------------------------------------
# Watchdog and health
# ---------------------------------------------------------------------------

def test_watchdog_ewma_and_stall():
    snaps = []
    for W in (faults.EngineWatchdog, jfaults.EngineWatchdog):
        now = [100.0]
        wd = W(alpha=0.5, stall_ratio=10.0, min_stall_s=0.5,
               clock=lambda: now[0])
        seen = [wd.stalled()]
        wd.record(0.010)
        wd.record(0.030)
        assert wd.ewma_s == pytest.approx(0.020)
        seen.append(wd.stalled())
        now[0] += 0.3
        seen.append(wd.stalled())
        now[0] += 0.4
        seen.append(wd.stalled())
        snaps.append((seen, wd.snapshot()))
    assert snaps[0] == snaps[1]
    assert snaps[0][0] == [False, False, False, True]
    assert snaps[0][1]["steps"] == 2
    assert snaps[0][1]["since_last_step_s"] == pytest.approx(0.7)


def test_engine_health_snapshot(pkgs, tmp_path):
    def case(k, root):
        eng = lane(k, store_of(k, root))
        eng.submit(prompt(), "a0", max_tokens=2)
        eng.run()
        h = eng.health()
        assert h["watchdog"]["steps"] == eng.step_count > 0
        assert h["watchdog"]["ewma_step_s"] > 0
        assert not h["watchdog"]["stalled"]
        return {k: v for k, v in h.items() if k != "watchdog"}
    got = on_both(pkgs, case, tmp_path, reference=False)
    assert got["queued"] == got["active"] == 0 and got["tokens_out"] == 2
    assert got["quarantined"] == []


def test_serve_future_timeout_and_typed_result(pkgs, tmp_path):
    k = pkgs["port"]
    with k.precision():
        eng = lane(k, store_of(k, str(tmp_path)))
        fut = eng.submit(prompt(), "a0", max_tokens=2)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="in flight"):
            fut.result(timeout=0.05)           # bounded wait, no driver
        assert time.monotonic() - t0 < 5.0
        eng.run()
        assert len(fut.result(timeout=1.0)) == 2


# ---------------------------------------------------------------------------
# runtime.ft: the straggler monitor and the bounded barrier
# ---------------------------------------------------------------------------

def test_straggler_monitor_flags_and_rebalances():
    plans = []
    for F in (ft, jft):
        mon = F.StragglerMonitor(n_hosts=8, z_thresh=2.0, min_ratio=1.2)
        for _ in range(10):
            for h in range(8):
                mon.record(h, 1.0 if h != 3 else 3.0)  # host 3 is 3x slower
            rep = mon.end_step()
        assert rep.stragglers == [3] and not rep.healthy
        plan = mon.rebalance_plan(rep, shards_per_host=4)
        assert sum(plan.values()) == 32 and plan[3] < plan[0]
        plans.append((plan, rep.fleet_mean, rep.fleet_std))
    assert plans[0] == plans[1]


def test_straggler_monitor_quiet_on_healthy_fleet():
    for F in (ft, jft):
        mon = F.StragglerMonitor(n_hosts=8)
        rng = np.random.RandomState(0)
        for _ in range(10):
            for h in range(8):
                mon.record(h, 1.0 + rng.rand() * 0.05)
            rep = mon.end_step()
        assert rep.healthy


def test_bounded_barrier():
    for F in (ft, jft):
        b = F.BoundedBarrier(timeout_s=10.0, grace_ratio=5.0)
        assert not b.should_abort(waited_s=2.0, fleet_mean_step_s=1.0)
        assert b.should_abort(waited_s=6.0, fleet_mean_step_s=1.0)
        assert b.should_abort(waited_s=11.0, fleet_mean_step_s=100.0)
