"""Replay cost model over serving traces: attribution, timelines, what-if.

The port's copy of ``repro/analysis/replay.py``, function for function and
in the same float arithmetic, so a trace of either package replays to the
same numbers; its default ``HW`` is the port's (an H100). Input is a trace
captured by ``analysis/trace.py`` — the in-memory event list, a
``Tracer``, or a JSONL file it exported. The engines emit one
top-level ``step`` span per scheduling step with nested ``admit`` /
``prefill_chunk`` / ``decode`` / ``cow_copy`` / ``table_rebuild`` /
``fuse`` spans, so a serving run's wall clock decomposes into a per-step
timeline this module reconstructs and explains:

  * ``attribute(events)`` — where did the wall time go? Computes each
    span's SELF time (duration minus enclosed child spans, so nothing is
    double counted), sums it by span name and category, and reports the
    fraction of the observed window covered by top-level spans. The
    serving engines' coverage is the contract: >= 90% of a traced run's
    wall time must land in spans (pinned by tests) or the trace is lying
    about where time goes.
  * ``step_timeline(events)`` — the per-step record: every ``step`` span
    with its nested phases, reproducing the engine's scheduling loop
    tick by tick (step indices come from the span args, not guesswork).
  * ``critical_path(events)`` — the top-level spans ordered by self-time
    contribution; in a single-threaded host loop the critical path IS
    the serial span sequence, so this ranks what to attack first.
  * ``what_if(events, overlap=..., under=..., scale=...)`` — replay the
    timeline under a hypothesis: spans named in ``overlap`` are assumed
    to run concurrently with (hidden under) the ``under`` phase — e.g.
    "what if H2D table uploads overlapped decode" — and ``scale``
    multiplies a phase's self time (e.g. a kernel made 2x faster).
    Returns baseline vs replayed wall and the savings.
  * ``join_costs(events, costs, hw)`` — join measured span times with
    ``analysis/profile.py`` cost extraction (``program_cost`` /
    ``cost_summary`` dicts): each phase gets a roofline model time
    ``max(flops/peak, bytes/bw)`` and the measured/model ratio — >> 1
    means the phase is host-bound, not device-bound.
  * ``verify_overlap(events, ...)`` — close the async-prefetch loop:
    given a trace of the *async* pipeline (worker-thread
    ``prefetch.disk`` / ``prefetch.h2d`` spans recorded with
    ``tid != 0``), compare the hiding the serial what-if predicts
    (async work fully hidden under the serving thread's ``under``
    phases) against the hiding actually realized (measured temporal
    intersection of worker spans with the serving thread's ``under``
    intervals). CI gates ``realized_frac >= 0.5``.

Threads: events carry a ``tid`` (0 = the serving loop, workers 1+;
missing = 0 for pre-async traces). Self-time interval stacks are built
per tid — a worker span overlapping a serving-thread span is
concurrency, not nesting. The serial quantities (coverage, what-if
replay, critical path) are computed over the serving thread's spans
only; worker time is reported separately (``attribute()["async_by_name"]``).

All times are microseconds (the tracer's unit).
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

from repro_torch.analysis.roofline import HW

TraceLike = Union[str, Sequence[Dict[str, Any]], "object"]


def load_trace(source: TraceLike) -> List[Dict[str, Any]]:
    """Events (ts order) from a JSONL path, a Tracer, or an event list."""
    if hasattr(source, "events"):                 # a Tracer
        return list(source.events())
    if isinstance(source, str):
        events = []
        with open(source) as f:
            for line in f:
                line = line.strip()
                if line:
                    events.append(json.loads(line))
    else:
        events = list(source)
    return sorted(events, key=lambda e: e.get("ts", 0.0))


def spans(events: Iterable[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Complete spans only (ph == "X"), in ts order."""
    return sorted((e for e in events if e.get("ph") == "X"),
                  key=lambda e: (e["ts"], -e.get("dur", 0.0)))


def span_tid(e: Dict[str, Any]) -> int:
    """Recording thread of an event; 0 (the serving loop) for traces
    captured before the tracer recorded tids."""
    return int(e.get("tid", 0))


def main_spans(events: Iterable[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Serving-thread spans only (tid 0), in ts order."""
    return [s for s in spans(events) if span_tid(s) == 0]


def _self_times(sps: List[Dict[str, Any]]) -> List[float]:
    """Per-span self time: duration minus enclosed child spans.

    Within one thread spans nest strictly (a child's interval lies
    inside its parent's), so an interval stack recovers the tree without
    trusting the recorded depth. Stacks are kept per tid: a worker
    thread's prefetch span overlapping a serving-thread span is
    concurrency, not parenthood."""
    child = [0.0] * len(sps)
    stacks: Dict[int, List[int]] = {}      # tid -> open-span indices
    for i, s in enumerate(sps):
        stack = stacks.setdefault(span_tid(s), [])
        while stack and sps[stack[-1]]["ts"] + sps[stack[-1]]["dur"] \
                <= s["ts"] + 1e-9:
            stack.pop()
        if stack:
            child[stack[-1]] += s["dur"]
        stack.append(i)
    return [max(s["dur"] - c, 0.0) for s, c in zip(sps, child)]


def attribute(events: TraceLike,
              wall_us: Optional[float] = None) -> Dict[str, Any]:
    """Wall-time attribution: self time by span name/category + coverage.

    ``wall_us`` is the window to measure coverage against; when omitted
    it is the observed event window (first ts to last ts+dur). Coverage
    counts the serving thread's (tid 0) TOP-LEVEL spans only (depth 0):
    nested spans are already inside their parents' intervals, and
    worker-thread spans run concurrently with the wall clock rather
    than consuming it — their self time is reported separately in
    ``async_by_name``."""
    events = load_trace(events)
    sps = spans(events)
    if not sps:
        return {"wall_us": float(wall_us or 0.0), "covered_us": 0.0,
                "coverage": 0.0, "by_name": {}, "by_cat": {},
                "async_by_name": {}, "spans": 0}
    selfs = _self_times(sps)
    by_name: Dict[str, float] = {}
    by_cat: Dict[str, float] = {}
    async_by_name: Dict[str, float] = {}
    for s, st in zip(sps, selfs):
        if span_tid(s) == 0:
            by_name[s["name"]] = by_name.get(s["name"], 0.0) + st
            by_cat[s["cat"]] = by_cat.get(s["cat"], 0.0) + st
        else:
            async_by_name[s["name"]] = async_by_name.get(s["name"], 0.0) + st
    covered = sum(s["dur"] for s in sps
                  if s.get("depth", 0) == 0 and span_tid(s) == 0)
    if wall_us is None:
        t0 = min(e["ts"] for e in events)
        t1 = max(e["ts"] + e.get("dur", 0.0) for e in events)
        wall_us = max(t1 - t0, 1e-9)
    return {"wall_us": float(wall_us), "covered_us": float(covered),
            "coverage": float(covered / max(wall_us, 1e-9)),
            "by_name": by_name, "by_cat": by_cat,
            "async_by_name": async_by_name, "spans": len(sps)}


def step_timeline(events: TraceLike) -> List[Dict[str, Any]]:
    """Per-step reconstruction of the engine loop.

    Returns one record per ``step`` span, in step order::

        {"step": k, "ts": ..., "dur": ..., "phases": {"decode": us, ...},
         "events": [nested span/instant dicts]}

    The step index comes from the span's recorded args (the engines
    stamp ``step=self.step_count``)."""
    events = load_trace(events)
    steps = [e for e in spans(events) if e["name"] == "step"]
    out = []
    for s in steps:
        lo, hi = s["ts"], s["ts"] + s["dur"]
        # a worker-thread prefetch span may fall inside the step's window
        # temporally, but it is not part of the step's serial work
        inner = [e for e in events
                 if lo - 1e-9 <= e["ts"] and e["ts"] + e.get("dur", 0.0)
                 <= hi + 1e-9 and e is not s and e.get("ph") != "C"
                 and span_tid(e) == 0]
        phases: Dict[str, float] = {}
        for e in inner:
            if e.get("ph") == "X":
                phases[e["name"]] = phases.get(e["name"], 0.0) + e["dur"]
        out.append({"step": s["args"].get("step"), "ts": s["ts"],
                    "dur": s["dur"], "phases": phases, "events": inner})
    out.sort(key=lambda r: (r["step"] is None, r["step"], r["ts"]))
    return out


def critical_path(events: TraceLike, top: int = 10) -> List[Dict[str, Any]]:
    """Phases ranked by total self time — the serial loop's critical path."""
    att = attribute(events)
    ranked = sorted(att["by_name"].items(), key=lambda kv: -kv[1])
    total = sum(att["by_name"].values()) or 1.0
    return [{"name": n, "self_us": v, "frac": v / total}
            for n, v in ranked[:top]]


def what_if(events: TraceLike, *, overlap: Sequence[str] = (),
            under: str = "decode",
            scale: Optional[Dict[str, float]] = None,
            wall_us: Optional[float] = None) -> Dict[str, float]:
    """Replay the trace under a hypothesis.

    ``overlap`` names phases assumed to run concurrently with the
    ``under`` phase (async dispatch): their self time is hidden up to
    the ``under`` phase's own (scaled) self time — you cannot hide 40ms
    of uploads under 10ms of decode. ``scale`` multiplies named phases'
    self times (e.g. ``{"decode": 0.5}`` = a 2x faster decode step).
    Uncovered wall (host time outside any span) is carried through
    unchanged. The replay is a serial model of the serving thread, so
    only tid-0 spans participate — worker-thread prefetch spans are
    already off the critical path. Returns ``{"baseline_us",
    "replayed_us", "saved_us", "hidden_us", "speedup"}``."""
    events = load_trace(events)
    sps = main_spans(events)
    selfs = _self_times(sps)
    scale = scale or {}
    by_name: Dict[str, float] = {}
    for s, st in zip(sps, selfs):
        by_name[s["name"]] = by_name.get(s["name"], 0.0) + st
    att = attribute(events, wall_us=wall_us)
    baseline = att["wall_us"]
    uncovered = max(baseline - sum(by_name.values()), 0.0)
    scaled = {n: v * float(scale.get(n, 1.0)) for n, v in by_name.items()}
    over = sum(v for n, v in scaled.items() if n in set(overlap))
    budget = scaled.get(under, 0.0)
    hidden = min(over, budget)
    replayed = sum(scaled.values()) - hidden + uncovered
    return {"baseline_us": float(baseline), "replayed_us": float(replayed),
            "saved_us": float(baseline - replayed), "hidden_us": float(hidden),
            "speedup": float(baseline / max(replayed, 1e-9))}


def _merge_intervals(ivals: List[List[float]]) -> List[List[float]]:
    """Union of [lo, hi) intervals, sorted and non-overlapping."""
    out: List[List[float]] = []
    for lo, hi in sorted(ivals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _intersect_us(lo: float, hi: float,
                  merged: List[List[float]]) -> float:
    """Length of [lo, hi) covered by a merged interval list."""
    got = 0.0
    for a, b in merged:
        if b <= lo:
            continue
        if a >= hi:
            break
        got += min(b, hi) - max(a, lo)
    return got


def verify_overlap(events: TraceLike, *,
                   async_names: Optional[Sequence[str]] = None,
                   under: Sequence[str] = ("decode", "prefill_chunk",
                                           "admit"),
                   baseline: Optional[TraceLike] = None,
                   serial_names: Sequence[str] = ("disk_load",
                                                  "table_rebuild"),
                   serial_under: str = "decode") -> Dict[str, Any]:
    """Did the async prefetch pipeline realize the hiding the what-if
    predicted?

    ``events`` is a trace of the *async* pipeline: adapter disk loads
    and device-table builds run on worker threads, so their spans
    (``prefetch.disk``, ``prefetch.h2d``) carry ``tid != 0``.

      * **predicted** hiding is what the serial replay model promises:
        with ``baseline`` (a pre-change synchronous trace, e.g. the
        archived ``TRACE_slo_load.sync.jsonl``), it is
        ``what_if(baseline, overlap=serial_names, under=serial_under)
        ["hidden_us"]`` — the serial ``disk_load``/``table_rebuild``
        self time hideable under decode. Without a baseline it is the
        self-contained bound ``min(async worker time, under budget)``:
        every microsecond of worker time could have hidden under the
        serving thread's ``under`` phases.
      * **measured** hiding is the realized temporal intersection of
        the worker spans with the serving thread's ``under`` intervals
        — time the async work actually ran concurrently with decode
        instead of stalling it.

    ``realized_frac = measured / predicted`` is the contract CI gates
    (>= 0.5): a pipeline that silently serializes (the serving thread
    blocking on every load) measures ~0 overlap and trips the gate even
    though end-to-end numbers may hide it in noise. When there is
    nothing to hide (``predicted == 0``) the fraction is vacuously 1.0;
    ``async_spans == 0`` means the pipeline never ran — callers should
    treat that as its own failure when async serving was expected."""
    events = load_trace(events)
    sps = spans(events)
    selfs = _self_times(sps)
    under = tuple(under)
    workers = [(s, st) for s, st in zip(sps, selfs) if span_tid(s) != 0
               and (async_names is None or s["name"] in set(async_names))]
    async_by_name: Dict[str, float] = {}
    for s, st in workers:
        async_by_name[s["name"]] = async_by_name.get(s["name"], 0.0) + st
    async_us = sum(async_by_name.values())
    under_sps = [s for s in sps if span_tid(s) == 0 and s["name"] in under]
    under_us = sum(st for s, st in zip(sps, selfs)
                   if span_tid(s) == 0 and s["name"] in under)
    merged = _merge_intervals([[s["ts"], s["ts"] + s["dur"]]
                               for s in under_sps])
    # measured hiding: worker-span *durations* against the under windows
    # (a worker span's wall time is concurrent whether or not it nests
    # other worker spans, so full dur — not self — is what overlaps)
    measured = sum(_intersect_us(s["ts"], s["ts"] + s["dur"], merged)
                   for s, _ in workers
                   if s.get("depth", 0) == 0 or span_tid(s) != 0)
    if baseline is not None:
        predicted = what_if(load_trace(baseline), overlap=serial_names,
                            under=serial_under)["hidden_us"]
    else:
        predicted = min(async_us, under_us)
    realized = measured / predicted if predicted > 1e-9 else 1.0
    return {"async_us": float(async_us), "under_us": float(under_us),
            "predicted_hidden_us": float(predicted),
            "measured_hidden_us": float(measured),
            "realized_frac": float(realized),
            "async_spans": len(workers),
            "async_by_name": async_by_name, "under": list(under)}


# ---------------------------------------------------------------------------
# Joining traces with analysis/profile.py cost extraction
# ---------------------------------------------------------------------------

def modelled_us(cost: Dict[str, float], hw: Optional[HW] = None) -> float:
    """Roofline time (microseconds) for one execution of a program whose
    cost dict (``analysis.profile.program_cost`` / ``cost_summary``) is
    ``cost``: max of the compute and memory terms."""
    hw = hw or HW()
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes_accessed", 0.0))
    return max(flops / hw.peak_flops, nbytes / hw.hbm_bw) * 1e6


def join_costs(events: TraceLike, costs: Dict[str, Dict[str, float]],
               hw: Optional[HW] = None) -> Dict[str, Dict[str, float]]:
    """Per-phase measured vs modelled time.

    ``costs`` maps a span name (e.g. ``"decode"``) to the cost dict of
    the program that span launches. Returns, per phase::

        {"count", "measured_us_total", "measured_us_mean",
         "model_us", "ratio"}       # ratio >> 1: host/dispatch-bound

    The per-op timeline: multiply a phase's model_us by its count to get
    the device-time floor for the whole run; the gap to measured self
    time is host overhead the what-if replay can target."""
    events = load_trace(events)
    sps = spans(events)
    selfs = _self_times(sps)
    agg: Dict[str, List[float]] = {}
    for s, st in zip(sps, selfs):
        agg.setdefault(s["name"], []).append(st)
    out: Dict[str, Dict[str, float]] = {}
    for name, cost in costs.items():
        samples = agg.get(name, [])
        model = modelled_us(cost, hw)
        total = sum(samples)
        mean = total / len(samples) if samples else 0.0
        out[name] = {"count": float(len(samples)),
                     "measured_us_total": total,
                     "measured_us_mean": mean,
                     "model_us": model,
                     "ratio": mean / model if model > 0 else float("inf")}
    return out
