"""repro_torch.analysis.replay against the JAX package's repro.analysis.replay.

The port's replay is a copy of the reference's, so every public function
must return the reference's value exactly (dict equality: the same float
arithmetic in the same order) on the same events:
  * ``tests/test_observability.py``'s synthetic event sets (and one with
    worker-thread spans), one parametrised case each;
  * a traced smoke-size ``PagedServingEngine`` run (the run of
    ``tests/test_torch_trace.py``), through the tracer object;
  * a lane-engine run with async prefetch from a store of cold packs,
    whose worker spans carry tids 1+, through its JSONL, with the
    synchronous run's trace as ``verify_overlap``'s baseline.
``join_costs`` and ``modelled_us`` are held with ``HW`` given explicitly:
the port's default is the H100, the reference's a TPU.
"""
import numpy as np
import pytest
import torch

from repro.analysis import replay as J
from repro.analysis.roofline import HW as JHW
from repro_torch.analysis import replay as T
from repro_torch.analysis import trace
from repro_torch.analysis.roofline import HW as THW
from repro_torch.configs import get_smoke_config
from repro_torch.hub import AdapterStore, PagedServingEngine, ServingEngine
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.models import lm

COSTS = {"decode": {"flops": 1e9, "bytes_accessed": 1e6},
         "prefill_chunk": {"flops": 4e11, "bytes_accessed": 3e9},
         "step": {"flops": 0.0, "bytes_accessed": 0.0},
         "absent": {"flops": 2e9}}


@pytest.fixture(autouse=True)
def _clean_tracer():
    trace.uninstall()
    yield
    trace.uninstall()


def _ev(name, ts, dur, depth=0, cat="serving", tid=None, **args):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "depth": depth, "args": args}
    if tid is not None:
        e["tid"] = tid
    return e


SYNTHETIC = {
    "attribute": [_ev("step", 0, 100, step=1), _ev("decode", 10, 60,
                                                    depth=1)],
    "timeline": [_ev("step", 0, 100, step=1), _ev("decode", 10, 60, depth=1),
                 _ev("step", 120, 80, step=2),
                 _ev("prefill_chunk", 125, 30, depth=1)],
    "what_if": [_ev("decode", 0, 60), _ev("table_rebuild", 60, 30)],
    "join_costs": [_ev("decode", 0, 1000), _ev("decode", 1000, 3000)],
    "workers": [_ev("step", 0, 100, step=1), _ev("decode", 5, 70, depth=1),
                _ev("disk_load", 75, 20, depth=1),
                _ev("prefetch.disk", 10, 40, tid=1, cat="store"),
                _ev("prefetch.h2d", 30, 50, tid=2, cat="tables"),
                _ev("step", 100, 50, step=2),
                _ev("table_rebuild", 101, 30, depth=1),
                {"ph": "i", "name": "mark", "cat": "t", "ts": 40.0,
                 "args": {}},
                {"ph": "C", "name": "gauge", "cat": "t", "ts": 45.0,
                 "args": {"value": 3.0}}],
}


def everything(mod, hw, source, *, wall_us=None, baseline=None):
    """Every public function of a replay module on one trace."""
    out = {"load_trace": mod.load_trace(source)}
    events = out["load_trace"]
    out["spans"] = mod.spans(events)
    out["main_spans"] = mod.main_spans(events)
    out["span_tid"] = [mod.span_tid(e) for e in events]
    out["attribute"] = mod.attribute(events)
    out["attribute_wall"] = mod.attribute(events, wall_us=wall_us or 250.0)
    out["step_timeline"] = mod.step_timeline(events)
    out["critical_path"] = mod.critical_path(events)
    out["critical_path_2"] = mod.critical_path(events, top=2)
    out["what_if"] = mod.what_if(events, overlap=("table_rebuild",),
                                 under="decode")
    out["what_if_scaled"] = mod.what_if(
        events, overlap=("table_rebuild", "disk_load"), under="decode",
        scale={"decode": 0.5, "step": 2.0}, wall_us=wall_us)
    out["verify_overlap"] = mod.verify_overlap(events)
    out["verify_overlap_names"] = mod.verify_overlap(
        events, async_names=("prefetch.disk",), under=("decode",))
    if baseline is not None:
        out["verify_overlap_baseline"] = mod.verify_overlap(
            events, baseline=baseline)
    out["modelled_us"] = {k: mod.modelled_us(c, hw) for k, c in COSTS.items()}
    out["join_costs"] = mod.join_costs(events, COSTS, hw)
    return out


def assert_same(source, **kw):
    got = everything(T, THW(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9),
                     source, **kw)
    want = everything(J, JHW(), source, **kw)
    assert got == want
    # the port's default HW is the H100's, the same as given explicitly
    assert T.join_costs(got["load_trace"], COSTS) == J.join_costs(
        got["load_trace"], COSTS, JHW(peak_flops=989e12, hbm_bw=3.35e12,
                                      ici_bw=450e9))
    return got


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_synthetic_traces_replay_as_the_reference(name):
    got = assert_same(SYNTHETIC[name], baseline=SYNTHETIC["what_if"])
    if name == "attribute":       # the reference test's own numbers
        att = T.attribute(SYNTHETIC[name], wall_us=200.0)
        assert att["by_name"] == {"step": 40.0, "decode": 60.0}
        assert att["coverage"] == 0.5
    if name == "workers":
        assert got["verify_overlap"]["async_spans"] == 2


def test_empty_trace_replays_as_the_reference():
    assert T.attribute([]) == J.attribute([])
    assert T.attribute([], wall_us=5.0) == J.attribute([], wall_us=5.0)


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke_config("starcoder2-7b")
    params = lm.init_params(cfg, seed=0, device="cpu")
    return cfg, params, serve.make_adapters(cfg, params, 3)


def test_traced_paged_run_replays_as_the_reference(smoke):
    cfg, params, packs = smoke
    engine = PagedServingEngine(cfg, params, slots=2, num_pages=33,
                                page_size=2, max_len=24, chunk_size=4)
    for p in packs[:2]:
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
    assert all(f.done() for f in futs)
    got = assert_same(tr, wall_us=wall * 1e6)
    assert got["attribute_wall"]["coverage"] >= 0.90
    assert {"step", "admit", "prefill_chunk", "decode"} <= {
        s["name"] for s in got["spans"]}


def _store_run(tmp_path, cfg, params, packs, async_prefetch):
    """A traced lane-engine run: adapter_0 registered hot, the others cold
    in a store; returns the tracer."""
    store = AdapterStore(str(tmp_path / f"store{int(async_prefetch)}"))
    for p in packs:
        store.add(p)
        store.evict(p.name)
    rng = np.random.default_rng(3)
    adapters = ["adapter_0", "adapter_1", None, "adapter_2", "adapter_1",
                "adapter_0"]
    with TL.compute_precision(torch.float32):
        srv = ServingEngine(cfg, params, slots=2, cache_size=32, store=store,
                            async_prefetch=async_prefetch)
        srv.register("adapter_0")
        tr = trace.install()
        futs = [srv.submit(rng.integers(0, cfg.vocab_size, 5), a,
                           max_tokens=3) for a in adapters]
        srv.run()
        trace.uninstall()
        srv.shutdown(include_store=True)
    assert all(f.done() for f in futs)
    return tr


def test_async_prefetch_run_replays_as_the_reference(tmp_path, smoke):
    cfg, params, packs = smoke
    sync = _store_run(tmp_path, cfg, params, packs, False)
    tr = _store_run(tmp_path, cfg, params, packs, True)
    path = tr.to_jsonl(str(tmp_path / "async.jsonl"))
    base = sync.to_jsonl(str(tmp_path / "sync.jsonl"))
    got = assert_same(path, baseline=base)
    assert any(T.span_tid(s) != 0 for s in got["spans"])
    assert got["verify_overlap"]["async_spans"] > 0
    assert got["verify_overlap_baseline"] == J.verify_overlap(
        J.load_trace(path), baseline=J.load_trace(base))


def test_chip_smoke_gates_coverage_on_the_port_spans():
    """chip_smoke.py's replay gate leaves the harness's own spans (cat
    "harness": its publish and per-step drains) out of both the covered
    time and the wall, so a gap in the engine's spans still shows."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    events = [_ev("step", 0, 100, step=1), _ev("decode", 10, 60, depth=1),
              _ev("drain", 100, 50, cat="harness"),
              _ev("publish", 150, 40, cat="harness"),
              _ev("store.write", 160, 20, depth=1, cat="store"),
              _ev("prefetch.disk", 120, 60, tid=1, cat="store"),
              _ev("step", 250, 50, step=2)]      # 190..250 unexplained
    port, held = cs.port_events(events)
    assert held == 90
    assert [e["name"] for e in port] == ["step", "decode", "store.write",
                                         "prefetch.disk", "step"]
    wall = 300
    got = T.attribute(port, wall_us=wall - held)
    assert got["covered_us"] == 150 and got["coverage"] == 150 / 210
    # counted as covered, the harness's spans would hide most of the gap
    assert T.attribute(events, wall_us=wall)["coverage"] == 240 / 300
