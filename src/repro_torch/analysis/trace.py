"""Low-overhead host-side tracer: spans, instants, counters.

The port's own copy of ``repro/analysis/trace.py`` (standard library
only), event for event, so that the port's replay cost model
(``repro_torch.analysis.replay``) and the reference's read a trace of
either package. The
engines, the adapter store, the switch and the trainers call
``trace.span(...)`` / ``trace.instant(...)`` / ``trace.counter(...)`` at
the phases the replay cost model attributes time to. Tracing is OFF by
default, and each hook is then one module-global load and a singleton
return.

    from repro_torch.analysis import trace
    tr = trace.install()            # or trace.install(Tracer(capacity=...))
    ... serve ...
    trace.uninstall()
    tr.to_jsonl("run.trace.jsonl")          # one event per line
    tr.to_chrome("run.trace.json")          # chrome://tracing / Perfetto

Event model:

  * ``span(name, cat=..., **args)``: a context manager timing a phase,
    recorded on exit as ``{"ph": "X", "name", "cat", "ts", "dur",
    "depth", "tid", "args"}``, ``ts``/``dur`` in microseconds from the
    tracer's epoch; ``depth`` is the nesting level at entry within the
    recording thread; ``.set(**kw)`` attaches args found mid-span.
  * ``instant(name, **args)``: a zero-duration marker (``"ph": "i"``).
  * ``counter(name, value)``: a sampled gauge (``"ph": "C"``).

Threads: tid 0 is the thread that called ``install()`` (the serving
loop); the store's prefetch workers and the engine's table-build worker
get 1, 2, ... in first-seen order, and nesting is tracked per thread.

Spans read the host clock and never synchronize the card: a span closes
when its host code returns, which for work queued on the card is before
the card has done it (``src/repro_torch/README.md`` lists the spans
where that matters). The buffer is a bounded ring: past ``capacity``
events the oldest are dropped and ``tracer.dropped`` counts them.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["Tracer", "install", "uninstall", "active", "enabled",
           "span", "instant", "counter"]


class _NullSpan:
    """Singleton returned by ``span()`` when tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw):
        return self


_NULL = _NullSpan()
_tracer: Optional["Tracer"] = None


class _Span:
    __slots__ = ("_tr", "name", "cat", "args", "_t0", "_depth", "_tid")

    def __init__(self, tr: "Tracer", name: str, cat: str, args: dict):
        self._tr = tr
        self.name = name
        self.cat = cat
        self.args = args

    def set(self, **kw):
        """Attach args discovered while the span is open."""
        self.args.update(kw)
        return self

    def __enter__(self):
        tr = self._tr
        self._tid = tr._tid()
        self._depth = tr._enter_depth()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        tr = self._tr
        tr._exit_depth()
        tr._push({"ph": "X", "name": self.name, "cat": self.cat,
                  "ts": (self._t0 - tr.epoch) * 1e6,
                  "dur": (t1 - self._t0) * 1e6,
                  "depth": self._depth, "tid": self._tid,
                  "args": self.args})
        return False


class Tracer:
    """Bounded in-memory event ring with JSONL / Chrome export."""

    def __init__(self, capacity: int = 1 << 16):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.epoch = time.perf_counter()
        self._buf: "deque[Dict[str, Any]]" = deque()
        self.dropped = 0
        # per-thread small tids (0 = the installing/serving thread; workers
        # get 1, 2, ... first-seen) and per-thread nesting depth — prefetch
        # workers record concurrently with the serving loop
        self._lock = threading.Lock()
        self._tids: Dict[int, int] = {threading.get_ident(): 0}
        self._depths: Dict[int, int] = {}

    # -- recording -----------------------------------------------------

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def _enter_depth(self) -> int:
        ident = threading.get_ident()
        d = self._depths.get(ident, 0)
        self._depths[ident] = d + 1
        return d

    def _exit_depth(self) -> None:
        ident = threading.get_ident()
        self._depths[ident] = max(self._depths.get(ident, 1) - 1, 0)

    def _push(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._buf) >= self.capacity:
                self._buf.popleft()
                self.dropped += 1
            self._buf.append(ev)

    def span(self, name: str, cat: str = "serving",
             args: Optional[dict] = None) -> _Span:
        return _Span(self, name, cat, dict(args or {}))

    def instant(self, name: str, cat: str = "serving",
                args: Optional[dict] = None) -> None:
        self._push({"ph": "i", "name": name, "cat": cat,
                    "ts": (time.perf_counter() - self.epoch) * 1e6,
                    "dur": 0.0,
                    "depth": self._depths.get(threading.get_ident(), 0),
                    "tid": self._tid(), "args": dict(args or {})})

    def counter(self, name: str, value: float,
                cat: str = "serving") -> None:
        self._push({"ph": "C", "name": name, "cat": cat,
                    "ts": (time.perf_counter() - self.epoch) * 1e6,
                    "dur": 0.0,
                    "depth": self._depths.get(threading.get_ident(), 0),
                    "tid": self._tid(), "args": {"value": float(value)}})

    # -- access / export ----------------------------------------------

    def __len__(self) -> int:
        return len(self._buf)

    def events(self) -> List[Dict[str, Any]]:
        """All buffered events in timestamp order."""
        return sorted(self._buf, key=lambda e: e["ts"])

    def clear(self) -> None:
        self._buf.clear()
        self.dropped = 0
        self._depths.clear()

    def to_jsonl(self, path: str) -> str:
        """One event object per line — the replay cost model's input."""
        with open(path, "w") as f:
            for ev in self.events():
                f.write(json.dumps(ev, sort_keys=True))
                f.write("\n")
        return path

    def to_chrome(self, path: str) -> str:
        """Chrome trace-event JSON (load in chrome://tracing / Perfetto)."""
        out = []
        for ev in self.events():
            ce = {"name": ev["name"], "cat": ev["cat"] or "serving",
                  "ph": ev["ph"], "ts": ev["ts"], "pid": 0,
                  "tid": ev.get("tid", 0), "args": ev["args"]}
            if ev["ph"] == "X":
                ce["dur"] = ev["dur"]
            if ev["ph"] == "i":
                ce["s"] = "t"
            out.append(ce)
        with open(path, "w") as f:
            json.dump({"traceEvents": out}, f)
        return path

    def summary(self) -> Dict[str, Any]:
        by_name: Dict[str, float] = {}
        n_spans = 0
        for ev in self._buf:
            if ev["ph"] == "X":
                n_spans += 1
                by_name[ev["name"]] = by_name.get(ev["name"], 0.0) + ev["dur"]
        return {"events": len(self._buf), "spans": n_spans,
                "dropped": self.dropped, "dur_us_by_name": by_name}


# ---------------------------------------------------------------------------
# Module-level switchboard (what the instrumentation hooks call).
# ---------------------------------------------------------------------------

def install(tracer: Optional[Tracer] = None) -> Tracer:
    """Install (and return) the active tracer. Hooks record into it until
    ``uninstall()``."""
    global _tracer
    _tracer = tracer if tracer is not None else Tracer()
    return _tracer


def uninstall() -> Optional[Tracer]:
    """Disable tracing; returns the tracer that was active (if any)."""
    global _tracer
    tr, _tracer = _tracer, None
    return tr


def active() -> Optional[Tracer]:
    return _tracer


def enabled() -> bool:
    return _tracer is not None


def span(name: str, /, cat: str = "serving", **args):
    """Time a phase. No-op (returns a shared null context) when tracing
    is off — safe to leave in hot serving loops. ``name``/``cat`` are
    positional-only so span args may themselves be called ``name``."""
    t = _tracer
    if t is None:
        return _NULL
    return t.span(name, cat, args)


def instant(name: str, /, cat: str = "serving", **args) -> None:
    t = _tracer
    if t is not None:
        t.instant(name, cat, args)


def counter(name: str, value: float, cat: str = "serving") -> None:
    t = _tracer
    if t is not None:
        t.counter(name, value, cat)
