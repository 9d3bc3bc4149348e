"""repro_torch.analysis.autotune and sidedelta's plan cache, against the
contract of ``tests/test_observability.py``'s autotune cases.

The reference tunes a Pallas tile plan (bm, kc); the port tunes the path
``kernel_path`` picks ("rows" or "tokens"), keyed by the call class (B, S,
n, m, K, x itemsize). Ported cases: a cache hit changes the plan (and the
output stays the function's), invalid entries are rejected back to the
static rule and counted, the save / load / install round trip, and
``observe()`` recording classes most-requested first. The port's own:
``observe()`` under a smoke multi-tenant ``generate`` and a paged run
records the classes those engines plan (on the CPU: the wrapper asks
``kernel_path`` before it takes its plain version), no cache is installed
by default, and ``measure_plan`` refuses the CPU (a plain version's time
says nothing of a path).
"""
import importlib
import json

import numpy as np
import pytest
import torch

from repro_torch.analysis import autotune
from repro_torch.configs import get_smoke_config
from repro_torch.hub import PagedServingEngine
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.serving import MultiTenantEngine

SD = importlib.import_module("repro_torch.kernels.sidedelta")


@pytest.fixture(autouse=True)
def _clean_cache():
    SD.clear_plan_cache()
    autotune.clear_observed()
    yield
    SD.clear_plan_cache()
    autotune.clear_observed()


def test_no_cache_by_default():
    assert SD.plan_cache() == {}
    for B, S in ((8, 1), (8, 16), (1, 31), (1, 32), (2, 40)):
        assert SD.kernel_path(B, S, 64, 128, 50, 2) == SD.static_path(B, S)


def test_plan_cache_hit_changes_path_with_parity():
    B, S, n, m, K = 2, 40, 64, 96, 300
    static = SD.kernel_path(B, S, n, m, K, 4)
    # no cache installed: the static rule, no lookup counted
    assert static == "tokens" and SD.plan_cache_stats["misses"] == 0
    key = SD.plan_cache_key(B, S, n, m, K, 4)
    inputs = autotune.class_inputs(key, device="cpu")
    want = SD._sidedelta(*inputs)

    SD.install_plan_cache({key: "rows"})
    assert SD.kernel_path(B, S, n, m, K, 4) == "rows"     # the hit
    assert SD.plan_cache_stats["hits"] == 1
    assert autotune.run_plan(key, "rows", inputs).equal(want)
    assert SD.plan_cache() == {key: "rows"}                # restored
    assert SD.kernel_path(B, S, n, m, K, 2) == static      # another class
    assert SD.plan_cache_stats["misses"] == 1

    SD.clear_plan_cache()
    assert SD.kernel_path(B, S, n, m, K, 4) == static      # and clears back


@pytest.mark.parametrize("bad", ["columns", "", 3, None, ("rows",)])
def test_plan_cache_rejects_invalid_entries(bad):
    B, S, n, m, K = 8, 1, 64, 96, 30
    key = SD.plan_cache_key(B, S, n, m, K)
    SD.install_plan_cache({key: bad})
    assert SD.kernel_path(B, S, n, m, K) == SD.static_path(B, S)
    assert SD.plan_cache_stats == {"hits": 0, "misses": 1, "rejected": 1}


def test_plan_cache_rejects_a_class_whose_grid_does_not_fit():
    # m past 65535 column groups of 8: neither path's grid holds it
    B, S, n, m, K = 1, 4, 16, 8 * 65536, 10
    key = SD.plan_cache_key(B, S, n, m, K)
    assert not SD.grid_fits(B, S, m)
    assert autotune.candidates(key) == []
    SD.install_plan_cache({key: "tokens"})
    assert SD.kernel_path(B, S, n, m, K) == SD.static_path(B, S) == "rows"
    assert SD.plan_cache_stats["rejected"] == 1


def test_kernel_path_random_sweep_with_hostile_cache():
    rng = np.random.default_rng(0)
    for _ in range(200):
        B, S = int(rng.integers(1, 300)), int(rng.integers(1, 70000))
        m = int(rng.integers(1, 700000))
        key = SD.plan_cache_key(B, S, 8, m, 5)
        entry = ["rows", "tokens", "bogus"][int(rng.integers(0, 3))]
        SD.clear_plan_cache()
        SD.install_plan_cache({key: entry})
        path = SD.kernel_path(*key)
        assert path in SD.PATHS
        if path != SD.static_path(B, S):
            assert SD.plan_is_valid(key, path) and path == entry


def test_autotune_save_load_install_roundtrip(tmp_path):
    key = SD.plan_cache_key(8, 16, 4608, 18432, 1698693)
    plans = {key: "rows"}
    path = autotune.save_cache(plans, str(tmp_path / "sub" / "plans.json"),
                               meta={"host": "test"})
    doc = json.load(open(path))
    assert doc["plans"] == {"8,16,4608,18432,1698693,2": "rows"}
    loaded = autotune.load_cache(path)
    assert loaded == {key: "rows"}
    assert autotune.install(loaded) == 1
    assert SD.plan_cache() == {key: "rows"}
    assert SD.kernel_path(8, 16, 4608, 18432, 1698693) == "rows"
    assert autotune.maybe_install_file(str(tmp_path / "absent.json")) == 0


def test_observe_records_shape_classes():
    with autotune.observe():
        SD.kernel_path(4, 16, 256, 256, 300)
        SD.kernel_path(4, 16, 256, 256, 300)
        SD.kernel_path(1, 1, 64, 64, 80, 4)
        SD.kernel_path(1, 1)                 # no class: not recorded
    shapes = autotune.observed_shapes()
    assert shapes[0] == SD.plan_cache_key(4, 16, 256, 256, 300)
    assert shapes == [SD.plan_cache_key(4, 16, 256, 256, 300),
                      SD.plan_cache_key(1, 1, 64, 64, 80, 4)]
    assert SD.kernel_path is not None and "recording" not in \
        SD.kernel_path.__name__               # restored after
    autotune.clear_observed()
    assert autotune.observed_shapes() == []


def test_candidates_and_measure_plan_refuses_the_cpu():
    key = SD.plan_cache_key(1, 40, 64, 96, 30)
    assert autotune.candidates(key) == ["tokens", "rows"]
    key = SD.plan_cache_key(8, 1, 64, 96, 30)
    assert autotune.candidates(key) == ["rows", "tokens"]
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.measure_plan(key, "rows", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.autotune([key], device="cpu")


def test_full_width_classes():
    keys = autotune.full_width_classes("starcoder2-7b")
    assert len(keys) == 14
    assert {k[2:4] for k in keys} == {(4608, 18432), (18432, 4608)}
    assert {k[:2] for k in keys} == {(8, 1), (8, 16), (8, 256), (1, 4),
                                     (1, 8), (1, 16), (1, 32)}
    assert all(k[4] == round(0.02 * 4608 * 18432) and k[5] == 2
               for k in keys)


def test_observe_records_the_engines_classes():
    cfg = get_smoke_config("starcoder2-7b")
    params = lm.init_params(cfg, seed=0, device="cpu")
    packs = serve.make_adapters(cfg, params, 3, multi_tenant=True)
    engine = MultiTenantEngine(cfg, params)
    for p in packs:
        engine.register(p)
    B, P, T = 4, 6, 3
    names = [packs[i % 3].name for i in range(B)]
    toks = torch.randint(0, cfg.vocab_size, (B, P),
                         generator=torch.Generator().manual_seed(0))
    with autotune.observe():
        engine.generate({"tokens": toks}, names, T)
    seen = set(autotune.observed_shapes())
    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.resolved_head_dim
    mats = {"wq": (d, cfg.num_heads * hd), "wk": (d, cfg.num_kv_heads * hd),
            "wv": (d, cfg.num_kv_heads * hd), "wo": (cfg.num_heads * hd, d),
            "w_up": (d, f), "w_down": (f, d)}
    want = set()
    for path, t in engine._tables.items():
        n, m = mats[path.split("/")[-1]]
        assert t["colptr"].shape[-1] == m + 1
        for S in (P, 1):                     # the prefill, then decode
            want.add(SD.plan_cache_key(B, S, n, m, t["rows"].shape[-1], 2))
    assert seen == want
    engine.close()

    autotune.clear_observed()
    pe = PagedServingEngine(cfg, params, slots=4, num_pages=64, page_size=2,
                            max_len=P + T + 2, chunk_size=4)
    for p in packs:
        pe.register(p)
    rng = np.random.default_rng(0)
    with autotune.observe():
        for i in range(B):
            pe.submit(rng.integers(0, cfg.vocab_size, P), packs[i % 3].name,
                      max_tokens=T)
        pe.run()
    pe.shutdown()
    calls = {k[:2] for k in autotune.observed_shapes()}
    assert (4, 1) in calls                       # decode over the 4 lanes
    assert (1, 4) in calls                       # chunks of 4 rows
    assert {k[2:4] for k in autotune.observed_shapes()} == set(mats.values())
