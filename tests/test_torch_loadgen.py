"""The port's load generator against ``repro.serving.loadgen``.

The same seed must give the same trace, request for request (arrival
time, adapter, prompt, max_tokens, phase), so that the SLO and chaos runs
of the two packages offer the same traffic; ``LoadReport``'s rates are
held on a hand-made report, and ``run`` on a scripted engine gives the
reference driver's counts.
"""
import time

import numpy as np
import pytest

from repro.serving import loadgen as J
from repro_torch.serving import loadgen as T
from repro_torch.runtime.faults import RequestShed, SlotPoisoned

CONFIGS = {
    "default": dict(adapters=["a0", "a1", "a2"], vocab=256),
    "chaos": dict(adapters=["a0", "a1", "a2", "a3"], vocab=49152, seed=0,
                  zipf_s=1.1, prompt_len=(64, 512), max_tokens=(8, 32),
                  shared_prefix=64,
                  phases=((10.0, 0.3, 3.0), (10.0, 1.2, 3.0),
                          (10.0, 0.3, 3.0))),
    "base_and_stacks": dict(adapters=["a0", ("a0", "a1"), "a2@3"], vocab=97,
                            seed=11, zipf_s=0.7, base_frac=0.25,
                            phases=((2.0, 20.0, 1.0), (1.0, 50.0, 4.0))),
}


def _gen(mod, cfg):
    kw = dict(cfg)
    if "phases" in kw:
        kw["phases"] = [mod.Phase(*p) for p in kw["phases"]]
    return mod.LoadGen(**kw)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_schedule_equals_the_reference(name):
    got = _gen(T, CONFIGS[name]).schedule()
    want = _gen(J, CONFIGS[name]).schedule()
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.rid, g.t, g.adapter, g.max_tokens, g.phase) == (
            w.rid, w.t, w.adapter, w.max_tokens, w.phase)
        assert g.prompt.dtype == w.prompt.dtype == np.int32
        np.testing.assert_array_equal(g.prompt, w.prompt)
    if CONFIGS[name].get("shared_prefix"):
        n = CONFIGS[name]["shared_prefix"]
        assert all((r.prompt[:n] == got[0].prompt[:n]).all() for r in got)


def test_zipf_probs_equal():
    for n, s in ((1, 1.1), (4, 1.1), (50, 0.7)):
        np.testing.assert_array_equal(T.zipf_probs(n, s), J.zipf_probs(n, s))
        assert T.zipf_probs(n, s).sum() == pytest.approx(1.0)


def test_report_rates_on_a_hand_made_report():
    for mod in (T, J):
        rep = mod.LoadReport(wall_s=4.0, offered=10, completed=6,
                             tokens_out=120, steps=50, slo_ms=100.0,
                             slo_met=4, goodput_tokens=80, failed=4, shed=3,
                             degraded=2)
        assert rep.tokens_per_s == 30.0
        assert rep.goodput_tok_s == 20.0
        assert rep.slo_violation_rate == pytest.approx(2 / 6)
        assert rep.shed_rate == 0.3 and rep.degraded_rate == 0.2
    empty = T.LoadReport(wall_s=0.0, offered=0, completed=0, tokens_out=0,
                         steps=0, slo_ms=None)
    assert empty.shed_rate == empty.slo_violation_rate == 0.0


class _Fut:
    def __init__(self, rid, max_tokens):
        self.rid, self.max_tokens = rid, max_tokens
        self.tokens, self.error, self.cancelled = [], None, False
        self.degraded, self.cold = rid % 5 == 0, rid % 3 == 0
        self.submit_time = self.finish_time = self.ttft = None
        self._done = False

    def done(self):
        return self._done


class _Engine:
    """Scripted: one token a step for each open request; request 3 is
    shed at submit, request 4 is poisoned after its first token."""

    def __init__(self, clock):
        self.clock, self.open, self.n = clock, [], 0

    def submit(self, prompt, adapter, max_tokens, deadline_s=None):
        f = _Fut(self.n, max_tokens)
        self.n += 1
        f.submit_time = self.clock()
        if f.rid == 3:
            f.error, f._done = RequestShed("shed", rid=3,
                                           reason="queue_full"), True
        else:
            self.open.append(f)
        return f

    def pending(self):
        return len(self.open)

    def step(self):
        for f in list(self.open):
            f.tokens.append(7)
            if f.ttft is None:
                f.ttft = self.clock() - f.submit_time
            if f.rid == 4:
                f.error = SlotPoisoned("nan", rid=4)
            if f.rid == 4 or len(f.tokens) >= f.max_tokens:
                f.finish_time, f._done = self.clock(), True
                self.open.remove(f)


def test_run_counts_equal_the_reference():
    reqs = _gen(T, CONFIGS["base_and_stacks"]).schedule()[:12]
    reports = [mod.run(_Engine(time.perf_counter), reqs, slo_ms=1e6,
                       deadline_s=5.0) for mod in (T, J)]
    # (the step count follows the wall clock: the driver steps a busy
    # engine until the next arrival is due)
    keys = ("offered", "completed", "tokens_out", "slo_met",
            "goodput_tokens", "failed", "shed", "degraded",
            "errors_by_type")
    got, want = ({k: getattr(r, k) for k in keys} for r in reports)
    assert got == want
    assert got["offered"] == 12 and got["completed"] == 10
    assert got["errors_by_type"] == {"RequestShed": 1, "SlotPoisoned": 1}
    assert got["shed"] == 1 and len(reports[0].ttfts_ms) == 10
    assert (len(reports[0].ttfts_cold_ms) + len(reports[0].ttfts_warm_ms)
            == 10)
