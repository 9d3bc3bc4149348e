"""Fault-tolerance primitives: straggler detection, preemption, elasticity.

The port's own copy of ``repro/runtime/ft.py`` (it imports nothing of the
JAX package). These are host-level mechanisms: the coordinator-side logic
consumes per-host step timings and decides

  * stragglers: hosts whose EWMA step time z-scores out of the fleet
    distribution, flagged for data re-assignment or replacement;
  * a bounded-staleness barrier: how long to wait for lagging hosts before
    declaring them failed (and restarting from the last checkpoint);
  * preemption: ``SimulatedPreemption``, which fault injection raises to
    emulate a node loss (``runtime.faults.on_engine_step`` in serving).

All of it is deterministic and dependency-free, and is tested with
synthetic clocks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class SimulatedPreemption(RuntimeError):
    """Raised by fault injectors in tests/examples to emulate a node loss."""


@dataclass
class StragglerReport:
    step: int
    host_ewma: Dict[int, float]
    stragglers: List[int]
    fleet_mean: float
    fleet_std: float

    @property
    def healthy(self) -> bool:
        return not self.stragglers


class StragglerMonitor:
    """EWMA per-host step-time tracker with z-score straggler flagging.

    A host is a straggler when its EWMA step time exceeds
    ``fleet_mean + z_thresh * fleet_std`` AND is ``min_ratio`` x the fleet
    mean (the second guard avoids flagging noise when variance is tiny).
    """

    def __init__(self, n_hosts: int, alpha: float = 0.3,
                 z_thresh: float = 3.0, min_ratio: float = 1.3):
        self.n_hosts = n_hosts
        self.alpha = alpha
        self.z_thresh = z_thresh
        self.min_ratio = min_ratio
        self.ewma: Dict[int, float] = {}
        self.step = 0

    def record(self, host: int, seconds: float) -> None:
        prev = self.ewma.get(host)
        self.ewma[host] = (seconds if prev is None
                           else self.alpha * seconds + (1 - self.alpha) * prev)

    def end_step(self) -> StragglerReport:
        self.step += 1
        vals = list(self.ewma.values())
        mean = sum(vals) / max(len(vals), 1)
        var = sum((v - mean) ** 2 for v in vals) / max(len(vals), 1)
        std = math.sqrt(var)
        stragglers = [h for h, v in self.ewma.items()
                      if v > mean + self.z_thresh * std
                      and v > self.min_ratio * mean]
        return StragglerReport(self.step, dict(self.ewma), sorted(stragglers),
                               mean, std)

    def rebalance_plan(self, report: StragglerReport,
                       shards_per_host: int) -> Dict[int, int]:
        """Propose data-shard counts per host inversely proportional to the
        EWMA step time (straggler mitigation by work re-assignment)."""
        if not report.host_ewma:
            return {}
        inv = {h: 1.0 / max(v, 1e-9) for h, v in report.host_ewma.items()}
        total_inv = sum(inv.values())
        total_shards = shards_per_host * len(inv)
        plan = {h: max(1, round(total_shards * w / total_inv))
                for h, w in inv.items()}
        # fix rounding drift deterministically
        drift = total_shards - sum(plan.values())
        for h in sorted(plan, key=lambda x: -inv[x]):
            if drift == 0:
                break
            plan[h] += 1 if drift > 0 else -1
            drift += -1 if drift > 0 else 1
        return plan


@dataclass
class BoundedBarrier:
    """Decide whether to keep waiting for lagging hosts or declare failure."""

    timeout_s: float = 300.0
    grace_ratio: float = 5.0      # wait up to grace_ratio * fleet mean step

    def should_abort(self, waited_s: float, fleet_mean_step_s: float) -> bool:
        return (waited_s > self.timeout_s
                or waited_s > self.grace_ratio * max(fleet_mean_step_s, 1e-3))
