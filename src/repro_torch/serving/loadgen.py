"""Heavy-traffic load generator for the serving engines.

The port's own copy of ``repro/serving/loadgen.py`` (numpy only): the same
seed gives the same schedule, request for request. Real multi-adapter
traffic is nothing like a fixed batch: adapter popularity is Zipf (a few
hot adapters, a long cold tail), arrivals are Poisson at best and bursty
in practice, and overload happens. This module synthesizes such traffic
and drives a request-level engine (``ServingEngine`` /
``PagedServingEngine``, anything with ``submit``/``step``/``pending``)
through it in wall-clock time:

  * **Arrivals**: per-``Phase`` Poisson processes (exponential gaps at
    ``rate_rps``). ``burst > 1`` clumps arrivals: a fraction ``1 - 1/burst``
    of gaps collapse to zero and the survivors stretch by ``burst``, which
    keeps the mean rate. Chain phases to model overload:
    ``[Phase(5, 2), Phase(5, 20), Phase(5, 2)]`` is a 10x spike.
  * **Adapter popularity**: Zipf(``zipf_s``) over the adapter list.
  * **Prompts**: random tokens, optionally opening with a shared system
    prefix (COW prefix sharing in the paged engine).

``run()`` submits each request when its arrival time comes due and steps
the engine in between, so queue wait is real and TTFT and latency are
submit-to-token wall clock. When the engine is idle and the next arrival
is in the future, it jumps virtual time forward instead of sleeping.

Goodput: a request meets the SLO when its end-to-end latency is within
``slo_ms``; goodput is the tokens of SLO-met requests per second of wall
clock. Requests that end with a typed error (``runtime.faults``) count as
failed (``shed`` the ``RequestShed`` subset) and give no latency sample.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Phase", "GenRequest", "LoadGen", "LoadReport", "run",
           "zipf_probs"]


@dataclass(frozen=True)
class Phase:
    """One traffic regime: ``duration_s`` of arrivals at ``rate_rps``."""
    duration_s: float
    rate_rps: float
    burst: float = 1.0        # > 1: clumped arrivals, same mean rate


@dataclass
class GenRequest:
    rid: int
    t: float                  # arrival time, seconds from trace start
    adapter: Any              # tenant (name, stack tuple, or None)
    prompt: np.ndarray        # int32 token ids
    max_tokens: int
    phase: int                # index of the generating phase


def zipf_probs(n: int, s: float = 1.1) -> np.ndarray:
    """P(adapter rank i) ~ 1/(i+1)^s, normalized."""
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    return w / w.sum()


@dataclass
class LoadGen:
    """Deterministic (seeded) trace synthesizer."""

    adapters: Sequence[Any]
    vocab: int
    seed: int = 0
    zipf_s: float = 1.1
    phases: Sequence[Phase] = (Phase(1.0, 8.0),)
    prompt_len: Tuple[int, int] = (4, 12)     # inclusive range
    max_tokens: Tuple[int, int] = (2, 8)      # inclusive range
    shared_prefix: int = 0                    # shared system-prompt tokens
    base_frac: float = 0.0                    # fraction of base-model traffic

    def schedule(self) -> List[GenRequest]:
        rng = np.random.default_rng(self.seed)
        probs = zipf_probs(len(self.adapters), self.zipf_s)
        prefix = rng.integers(0, self.vocab, self.shared_prefix,
                              dtype=np.int32)
        reqs: List[GenRequest] = []
        t = 0.0
        for pi, ph in enumerate(self.phases):
            end = t + ph.duration_s
            while True:
                if ph.burst > 1.0 and rng.random() < 1.0 - 1.0 / ph.burst:
                    gap = 0.0                      # clump into the burst
                else:
                    gap = rng.exponential(max(ph.burst, 1.0) / ph.rate_rps)
                if t + gap >= end:
                    break
                t += gap
                if self.base_frac > 0 and rng.random() < self.base_frac:
                    adapter = None
                else:
                    adapter = self.adapters[
                        rng.choice(len(self.adapters), p=probs)]
                plen = int(rng.integers(self.prompt_len[0],
                                        self.prompt_len[1] + 1))
                body = rng.integers(0, self.vocab, plen, dtype=np.int32)
                prompt = np.concatenate([prefix, body]) if self.shared_prefix \
                    else body
                reqs.append(GenRequest(
                    rid=len(reqs), t=t, adapter=adapter, prompt=prompt,
                    max_tokens=int(rng.integers(self.max_tokens[0],
                                                self.max_tokens[1] + 1)),
                    phase=pi))
            t = end
        return reqs


@dataclass
class LoadReport:
    """Raw per-request samples and aggregates; percentiles are left to
    the reader of the samples."""

    wall_s: float
    offered: int
    completed: int
    tokens_out: int
    steps: int
    slo_ms: Optional[float]
    latencies_ms: List[float] = field(default_factory=list)
    ttfts_ms: List[float] = field(default_factory=list)
    # TTFT split by the engine's cold stamp (``fut.cold``: the adapter was
    # neither engine-registered nor store-resident at submit) — the async
    # prefetch pipeline is judged on the cold tail specifically
    ttfts_cold_ms: List[float] = field(default_factory=list)
    ttfts_warm_ms: List[float] = field(default_factory=list)
    slo_met: int = 0
    goodput_tokens: int = 0
    per_phase_latencies_ms: Dict[int, List[float]] = field(
        default_factory=dict)
    # fault-tolerance accounting (runtime/faults.py): requests that ended
    # with a typed error never contribute latency/goodput samples —
    # ``failed`` counts all of them, ``shed`` the RequestShed subset, and
    # ``errors_by_type`` names each terminal error class. ``degraded``
    # requests completed (they count toward latency/goodput) but were
    # served below what they asked for.
    failed: int = 0
    shed: int = 0
    degraded: int = 0
    errors_by_type: Dict[str, int] = field(default_factory=dict)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_out / max(self.wall_s, 1e-9)

    @property
    def goodput_tok_s(self) -> float:
        return self.goodput_tokens / max(self.wall_s, 1e-9)

    @property
    def slo_violation_rate(self) -> float:
        done = max(self.completed, 1)
        return (self.completed - self.slo_met) / done

    @property
    def shed_rate(self) -> float:
        return self.shed / max(self.offered, 1)

    @property
    def degraded_rate(self) -> float:
        return self.degraded / max(self.offered, 1)


def run(engine, requests: Sequence[GenRequest], *,
        slo_ms: Optional[float] = None,
        deadline_s: Optional[float] = None,
        max_steps: int = 1_000_000) -> LoadReport:
    """Drive ``engine`` through the trace in wall-clock time.

    The engine contract is the request API shared by the lane and paged
    engines: ``submit(prompt, adapter, max_tokens) -> future`` (with
    ``submit_time``/``ttft``/``finish_time`` stamps), ``step()``,
    ``pending()``. ``deadline_s`` forwards a per-request queue deadline
    to engines that support shedding. Returns the filled
    ``LoadReport``."""
    reqs = sorted(requests, key=lambda r: r.t)
    futs: List[Tuple[GenRequest, Any]] = []
    kw = {} if deadline_s is None else {"deadline_s": deadline_s}
    t0 = time.perf_counter()
    i, steps = 0, 0
    while i < len(reqs) or engine.pending():
        now = time.perf_counter() - t0
        if (i < len(reqs) and not engine.pending()
                and reqs[i].t > now):
            # idle gap: jump virtual time to the next arrival
            t0 -= reqs[i].t - now
            now = reqs[i].t
        while i < len(reqs) and reqs[i].t <= now:
            r = reqs[i]
            futs.append((r, engine.submit(r.prompt, r.adapter,
                                          max_tokens=r.max_tokens, **kw)))
            i += 1
        if engine.pending():
            engine.step()
            steps += 1
            if steps >= max_steps:
                raise RuntimeError(f"load run exceeded {max_steps} steps "
                                   f"with {engine.pending()} in flight")
    wall = time.perf_counter() - t0

    rep = LoadReport(wall_s=wall, offered=len(reqs), completed=0,
                     tokens_out=0, steps=steps, slo_ms=slo_ms)
    for r, f in futs:
        if not f.done():
            continue
        err = getattr(f, "error", None)
        if err is not None or getattr(f, "cancelled", False):
            # typed terminal failure: no latency/goodput sample
            rep.failed += 1
            kind = type(err).__name__ if err is not None else "Cancelled"
            rep.errors_by_type[kind] = rep.errors_by_type.get(kind, 0) + 1
            if kind in ("RequestShed", "Cancelled"):
                rep.shed += 1
            continue
        rep.completed += 1
        rep.tokens_out += len(f.tokens)
        if getattr(f, "degraded", False):
            rep.degraded += 1
        lat_ms = (f.finish_time - f.submit_time) * 1e3 \
            if f.finish_time is not None else float("nan")
        rep.latencies_ms.append(lat_ms)
        rep.per_phase_latencies_ms.setdefault(r.phase, []).append(lat_ms)
        if f.ttft is not None:
            rep.ttfts_ms.append(f.ttft * 1e3)
            (rep.ttfts_cold_ms if getattr(f, "cold", False)
             else rep.ttfts_warm_ms).append(f.ttft * 1e3)
        if slo_ms is None or lat_ms <= slo_ms:
            rep.slo_met += 1
            rep.goodput_tokens += len(f.tokens)
    return rep
