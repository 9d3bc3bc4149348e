"""repro_torch.analysis.trace against the reference's tracer contract.

The tracer is the port's own copy of ``repro/analysis/trace.py``; these are
``tests/test_observability.py``'s tracer cases run on it (nesting and args,
the ring buffer, JSONL and chrome export, the no-op and its cost when
tracing is off), and the end-to-end case: a traced run of the port's
``PagedServingEngine`` at smoke size, whose JSONL goes through the JAX
package's ``repro.analysis.replay``. Its top-level spans must cover at
least 90% of the run's wall time (``benchmarks/check_replay.py``'s gate)
and ``step_timeline`` must rebuild the engine's steps one by one.
"""
import json
import time
import timeit

import numpy as np
import pytest

from repro.analysis import replay
from repro_torch.analysis import trace
from repro_torch.configs import get_smoke_config
from repro_torch.hub import PagedServingEngine
from repro_torch.launch import serve
from repro_torch.models import lm


@pytest.fixture(autouse=True)
def _clean_tracer():
    trace.uninstall()
    yield
    trace.uninstall()


def test_span_nesting_and_args():
    tr = trace.install()
    with trace.span("outer", cat="t", a=1):
        time.sleep(0.001)
        with trace.span("inner", cat="t") as sp:
            sp.set(found=42)
        trace.instant("marker", cat="t", note="x")
        trace.counter("gauge", 7.0, cat="t")
    by = {e["name"]: e for e in tr.events()}
    assert by["outer"]["depth"] == 0 and by["inner"]["depth"] == 1
    assert by["outer"]["args"] == {"a": 1}
    assert by["inner"]["args"] == {"found": 42}
    assert by["marker"]["ph"] == "i" and by["gauge"]["ph"] == "C"
    assert by["gauge"]["args"]["value"] == 7.0
    o, i = by["outer"], by["inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    assert o["dur"] >= 1000.0          # the 1 ms sleep, in microseconds


def test_ring_buffer_drops_oldest():
    tr = trace.install(trace.Tracer(capacity=4))
    for k in range(10):
        trace.instant(f"e{k}")
    assert len(tr) == 4 and tr.dropped == 6
    assert [e["name"] for e in tr.events()] == ["e6", "e7", "e8", "e9"]


def test_jsonl_and_chrome_export(tmp_path):
    tr = trace.install()
    with trace.span("work", cat="c", k=1):
        trace.instant("tick")
    loaded = replay.load_trace(tr.to_jsonl(str(tmp_path / "t.jsonl")))
    assert [e["name"] for e in loaded] == [e["name"] for e in tr.events()]
    chrome = json.load(open(tr.to_chrome(str(tmp_path / "t.json"))))
    phs = {e["name"]: e for e in chrome["traceEvents"]}
    assert phs["work"]["ph"] == "X" and "dur" in phs["work"]
    assert phs["tick"]["ph"] == "i" and phs["tick"]["s"] == "t"


def test_disabled_tracing_is_noop():
    assert not trace.enabled()
    s1, s2 = trace.span("x", arg=1), trace.span("y")
    assert s1 is s2                        # one shared null span
    with s1 as s:
        assert s.set(a=1) is s
    trace.instant("z")
    trace.counter("c", 1.0)
    assert len(trace.install()) == 0


def test_disabled_call_cost_is_negligible():
    """Off, a span costs about 100 ns; the bound of 20 us a call is the
    reference's, far under 1% of a decode step."""
    def hot():
        with trace.span("step", engine="paged"):
            pass
    per_call = min(timeit.repeat(hot, number=1000, repeat=5)) / 1000
    assert per_call < 20e-6, f"disabled span() costs {per_call * 1e6:.1f}us"


def test_worker_threads_get_their_own_tid_and_depth():
    """Spans of another thread nest on their own: a worker's span inside
    the serving thread's open span is depth 0 on tid 1."""
    import threading
    tr = trace.install()
    with trace.span("decode"):
        t = threading.Thread(target=lambda: trace.span("prefetch.disk",
                                                       cat="store")
                             .__enter__().__exit__(None, None, None))
        t.start()
        t.join()
    by = {e["name"]: e for e in tr.events()}
    assert by["decode"]["tid"] == 0 and by["prefetch.disk"]["tid"] == 1
    assert by["prefetch.disk"]["depth"] == 0


def test_traced_paged_run_coverage_and_timeline(tmp_path):
    cfg = get_smoke_config("starcoder2-7b")
    params = lm.init_params(cfg, seed=0, device="cpu")
    packs = serve.make_adapters(cfg, params, 2)
    engine = PagedServingEngine(cfg, params, slots=2, num_pages=33,
                                page_size=2, max_len=24, chunk_size=4)
    for p in packs:
        engine.register(p)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(3, 8)))
               for _ in range(5)]
    engine.submit(prompts[0], packs[0].name, max_tokens=2)
    engine.run()                           # tables built before the trace

    tr = trace.install()
    futs = [engine.submit(p, packs[i % 2].name, max_tokens=3)
            for i, p in enumerate(prompts)]
    wall = engine.run()
    trace.uninstall()
    assert all(f.done() and len(f.result()) == 3 for f in futs)
    names = {e["name"] for e in tr.events()}
    assert {"step", "admit", "prefill_chunk", "decode",
            "free_pages", "resident"} <= names
    assert all(e["dur"] >= 0 for e in tr.events())
    assert not any(tr._depths.values())    # every span closed

    events = replay.load_trace(tr.to_jsonl(str(tmp_path / "paged.jsonl")))
    att = replay.attribute(events, wall_us=wall * 1e6)
    assert att["coverage"] >= 0.90, \
        f"spans cover only {att['coverage']:.1%} of run() wall"
    tl = replay.step_timeline(events)
    counted = [r for r in tl if r["step"] is not None]
    assert [r["step"] for r in counted] == \
        list(range(counted[0]["step"], counted[0]["step"] + len(counted)))
    assert counted[-1]["step"] == engine.step_count
    assert any("decode" in r["phases"] for r in counted)
    assert any("prefill_chunk" in r["phases"] for r in counted)
