"""Serving fault model: typed errors, deterministic injection, watchdog.

The port's own copy of ``repro/runtime/faults.py``, the failure model of
the adapter-serving path (``hub.AdapterStore``, the hub engines,
``serving.MultiTenantEngine``), in three parts.

**1. Error taxonomy.** Every failure the serving stack can surface to a
request is a subclass of :class:`ServingError`: :class:`StoreError` (a
pack could not be loaded: I/O, a corrupt payload, a dead prefetch worker;
``.name`` the adapter), :class:`AdapterUnavailable` (quarantined after
repeated load failures, fail-fast until ``AdapterStore.clear_quarantine``),
:class:`RequestShed` (admission rejected or expired it: a full queue, a
queue deadline), :class:`SlotPoisoned` (non-finite logits on its decode
slot; only that slot is quarantined) and :class:`TableBuildError` (a
side-delta table build failed; the engines back off and retry).

**2. Deterministic fault injection.** A :class:`FaultInjector` built from
a seeded :class:`FaultPlan` is installed module-wide, the tracer's
null-object switchboard: with no injector installed every hook is one
module-global load and a return. Decisions are stateless draws,
``sha256(seed, site, key, attempt)``, so a given (adapter, attempt) fails
alike whatever the thread schedule, and the port draws what the reference
draws for the same plan. Hook points:

  ``on_disk_read(name)``     ``AdapterStore._load``: latency and
                             :class:`InjectedIOError`
  ``corrupt_payload(...)``   ``hub.packio.load_pack``: flips a payload byte
                             so the real crc32 check rejects it
  ``on_worker(name)``        ``AdapterStore._prefetch_job``: a prefetch
                             worker's death (:class:`WorkerDeath`)
  ``on_table_build()``       ``MultiTenantEngine``'s table builds, the
                             synchronous and the background one
                             (:class:`TableBuildError`)
  ``poison_logits(step)``    the hub engines' decode: NaN one live slot's
                             logits at the chosen step
  ``on_engine_step(step)``   the hub engines' ``step()``: raise
                             ``SimulatedPreemption`` (crash recovery)

Injected events land in the trace as ``fault.*`` instants (cat ``fault``).

**3. Watchdog.** :class:`EngineWatchdog` keeps an EWMA of one engine
loop's step time and flags a stall when the gap since the last completed
step exceeds ``stall_ratio`` x the EWMA (with an absolute floor). The hub
engines export it through ``health()`` with their shed, degraded,
poisoned and failed counters and the store's quarantine list.

The degradation ladder (retry -> quarantine -> fallback -> shed) is the
reference's, described in ``src/repro/runtime/README.md``.
"""
from __future__ import annotations

import hashlib
import time
import zlib
from dataclasses import dataclass, field
from threading import Lock
from typing import Dict, Optional

from repro_torch.analysis import trace
from repro_torch.runtime.ft import SimulatedPreemption  # noqa: F401 (re-export)

__all__ = [
    "ServingError", "StoreError", "AdapterUnavailable", "RequestShed",
    "SlotPoisoned", "TableBuildError", "InjectedIOError", "WorkerDeath",
    "FaultPlan", "FaultInjector", "EngineWatchdog", "SimulatedPreemption",
    "install", "uninstall", "active", "enabled",
    "on_disk_read", "corrupt_payload", "on_worker", "on_table_build",
    "poison_logits", "on_engine_step",
]


# ---------------------------------------------------------------------------
# Error taxonomy
# ---------------------------------------------------------------------------

class ServingError(RuntimeError):
    """Base of every typed serving failure a request can observe."""


class StoreError(ServingError):
    """An adapter pack failed to load (I/O, corruption, worker death)."""

    def __init__(self, msg: str, name: Optional[str] = None):
        super().__init__(msg)
        self.name = name


class AdapterUnavailable(ServingError):
    """The adapter is quarantined (or otherwise unservable) right now."""

    def __init__(self, msg: str, name: Optional[str] = None):
        super().__init__(msg)
        self.name = name


class RequestShed(ServingError):
    """Admission control rejected/expired the request (never silent)."""

    def __init__(self, msg: str, rid: Optional[int] = None,
                 reason: str = ""):
        super().__init__(msg)
        self.rid = rid
        self.reason = reason


class SlotPoisoned(ServingError):
    """Non-finite logits on this request's slot; the slot was quarantined."""

    def __init__(self, msg: str, rid: Optional[int] = None,
                 step: Optional[int] = None):
        super().__init__(msg)
        self.rid = rid
        self.step = step


class TableBuildError(ServingError):
    """Device table build failed (e.g. simulated OOM); retried next step."""


class InjectedIOError(OSError):
    """Injected disk-read failure (looks like a real I/O error to the
    store's retry ladder)."""


class WorkerDeath(RuntimeError):
    """Injected prefetch-worker death (a *raw* error on purpose: the
    handle/typing layer must convert it to ``StoreError``)."""


# ---------------------------------------------------------------------------
# Deterministic fault injection
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FaultPlan:
    """Seeded description of what to inject, all off by default.

    Probabilities are per *draw* (one disk read, one worker job, one
    table build); draws are stateless hashes of (seed, site, key,
    attempt), so the plan reproduces exactly across runs and thread
    schedules. ``poison_step`` poisons the logits of ONE live slot
    (``poison_slot``-th live lane, modulo the live count) at that
    engine step; ``preempt_step`` raises ``SimulatedPreemption`` out of
    ``step()`` — the crash-recovery tests' kill switch."""

    seed: int = 0
    disk_fail_p: float = 0.0        # P[disk read raises InjectedIOError]
    corrupt_p: float = 0.0          # P[payload byte flipped before crc32]
    io_latency_s: float = 0.0       # injected latency per disk read
    worker_death_p: float = 0.0     # P[prefetch worker dies mid-job]
    build_fail_p: float = 0.0       # P[table build raises TableBuildError]
    poison_step: Optional[int] = None
    poison_slot: int = 0
    preempt_step: Optional[int] = None


class FaultInjector:
    """Executes a :class:`FaultPlan`; install via ``faults.install``.

    Thread-safe. ``counts`` tallies injected events by kind (what the
    chaos bench reports)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.counts: Dict[str, int] = {}
        self._attempts: Dict[tuple, int] = {}   # (site, key) -> draw count
        self._poison_fired = False
        self._preempt_fired = False
        self._lock = Lock()

    # -- deterministic draws -------------------------------------------

    def _draw(self, site: str, key: str) -> float:
        """Uniform [0, 1) from (seed, site, key, attempt#) — independent
        of thread scheduling; a retried key gets a fresh draw. sha256,
        not crc32: crc is linear, so draws for consecutive attempts
        would differ by a XOR *constant* — correlated enough that a
        retry could never succeed where the first attempt failed."""
        with self._lock:
            n = self._attempts.get((site, key), 0)
            self._attempts[(site, key)] = n + 1
        digest = hashlib.sha256(
            f"{self.plan.seed}:{site}:{key}:{n}".encode()).digest()
        return int.from_bytes(digest[:4], "big") / 2.0 ** 32

    def _count(self, kind: str) -> None:
        with self._lock:
            self.counts[kind] = self.counts.get(kind, 0) + 1
        trace.instant(f"fault.{kind}", cat="fault")

    # -- hook bodies ---------------------------------------------------

    def on_disk_read(self, name: str) -> None:
        if self.plan.io_latency_s > 0:
            self._count("io_latency")
            time.sleep(self.plan.io_latency_s)
        if self.plan.disk_fail_p > 0 \
                and self._draw("disk", name) < self.plan.disk_fail_p:
            self._count("disk_fail")
            raise InjectedIOError(f"injected disk-read failure for "
                                  f"adapter {name!r}")

    def corrupt_payload(self, path: str, payload: bytes) -> bytes:
        if self.plan.corrupt_p > 0 and payload \
                and self._draw("corrupt", path) < self.plan.corrupt_p:
            self._count("corrupt")
            pos = zlib.crc32(path.encode()) % len(payload)
            flipped = bytearray(payload)
            flipped[pos] ^= 0xFF
            return bytes(flipped)
        return payload

    def on_worker(self, name: str) -> None:
        if self.plan.worker_death_p > 0 \
                and self._draw("worker", name) < self.plan.worker_death_p:
            self._count("worker_death")
            raise WorkerDeath(f"injected prefetch-worker death loading "
                              f"{name!r}")

    def on_table_build(self) -> None:
        if self.plan.build_fail_p > 0 \
                and self._draw("build", "tables") < self.plan.build_fail_p:
            self._count("build_fail")
            raise TableBuildError("injected device-table build failure "
                                  "(simulated OOM)")

    def poison_logits(self, step: int) -> Optional[int]:
        """Fires ONCE, at the first decode whose step reaches
        ``poison_step`` (an exact-step match would silently miss when
        that step had no live decode)."""
        if self.plan.poison_step is None or step < self.plan.poison_step \
                or self._poison_fired:
            return None
        self._poison_fired = True
        self._count("poison")
        return self.plan.poison_slot

    def on_engine_step(self, step: int) -> None:
        """Fires ONCE, at the first engine step reaching
        ``preempt_step`` — a rebuilt engine restarting from step 0 is
        not re-killed by the same injector."""
        if self.plan.preempt_step is None or step < self.plan.preempt_step \
                or self._preempt_fired:
            return
        self._preempt_fired = True
        self._count("preempt")
        raise SimulatedPreemption(f"injected preemption at engine "
                                  f"step {step}")


# ---------------------------------------------------------------------------
# Module-level switchboard (the hooks the serving path calls)
# ---------------------------------------------------------------------------

_injector: Optional[FaultInjector] = None


def install(plan_or_injector) -> FaultInjector:
    """Install (and return) the active injector. Hooks fire until
    ``uninstall()``. Accepts a ``FaultPlan`` or a ``FaultInjector``."""
    global _injector
    if isinstance(plan_or_injector, FaultPlan):
        plan_or_injector = FaultInjector(plan_or_injector)
    _injector = plan_or_injector
    return _injector


def uninstall() -> Optional[FaultInjector]:
    """Disable injection; returns the injector that was active (if any)."""
    global _injector
    inj, _injector = _injector, None
    return inj


def active() -> Optional[FaultInjector]:
    return _injector


def enabled() -> bool:
    return _injector is not None


def on_disk_read(name: str) -> None:
    inj = _injector
    if inj is not None:
        inj.on_disk_read(name)


def corrupt_payload(path: str, payload: bytes) -> bytes:
    inj = _injector
    if inj is None:
        return payload
    return inj.corrupt_payload(path, payload)


def on_worker(name: str) -> None:
    inj = _injector
    if inj is not None:
        inj.on_worker(name)


def on_table_build() -> None:
    inj = _injector
    if inj is not None:
        inj.on_table_build()


def poison_logits(step: int) -> Optional[int]:
    inj = _injector
    if inj is None:
        return None
    return inj.poison_logits(step)


def on_engine_step(step: int) -> None:
    inj = _injector
    if inj is not None:
        inj.on_engine_step(step)


# ---------------------------------------------------------------------------
# Engine watchdog
# ---------------------------------------------------------------------------

@dataclass
class EngineWatchdog:
    """EWMA step-stall detector for one serving loop — the single-engine
    reuse of ``ft.StragglerMonitor``'s shape (EWMA + a ratio guard so
    tiny variance never false-positives).

    The engine calls ``record(seconds)`` after every completed step;
    ``snapshot(now)`` exports the health view: the loop is *stalled*
    when the time since the last completed step exceeds
    ``max(stall_ratio * ewma, min_stall_s)``. ``clock`` is injectable
    for deterministic tests."""

    alpha: float = 0.3
    stall_ratio: float = 10.0
    min_stall_s: float = 1.0
    clock: "object" = time.monotonic
    steps: int = 0
    ewma_s: Optional[float] = None
    last_step_s: Optional[float] = None
    last_end_t: Optional[float] = field(default=None, repr=False)

    def record(self, seconds: float) -> None:
        self.steps += 1
        self.last_step_s = seconds
        self.ewma_s = (seconds if self.ewma_s is None
                       else self.alpha * seconds
                       + (1 - self.alpha) * self.ewma_s)
        self.last_end_t = self.clock()

    def since_last_step(self, now: Optional[float] = None) -> float:
        if self.last_end_t is None:
            return 0.0
        return max((self.clock() if now is None else now)
                   - self.last_end_t, 0.0)

    def stalled(self, now: Optional[float] = None) -> bool:
        if self.ewma_s is None:
            return False
        gap = self.since_last_step(now)
        return gap > max(self.stall_ratio * self.ewma_s, self.min_stall_s)

    def snapshot(self, now: Optional[float] = None) -> Dict[str, object]:
        return {"steps": self.steps, "ewma_step_s": self.ewma_s,
                "last_step_s": self.last_step_s,
                "since_last_step_s": self.since_last_step(now),
                "stalled": self.stalled(now)}
