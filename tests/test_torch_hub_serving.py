"""repro_torch.hub.ServingEngine (the lane engine) against repro.hub.

The parity bar of the JAX package (``tests/test_hub.py``): continuous
batching reproduces the fixed-batch multi-tenant engine token for token on
the same trace, with fewer lanes than requests, mixed request lengths and
an adapter stack. Here the port's lane engine must equal both the JAX
``ServingEngine(cfg, params, interpret=False)`` and the port's own
``MultiTenantEngine.generate``, in f32 on bridged weights and packs. Also:
EOS slot recycling, validation, lazy registration from a store (f32, and
int8 packs into int8 tables against the JAX store path), and
``serve --continuous`` on the CPU.

Packs are drawn with numpy from a seed (``np_packs``) and built into both
packages' ``AdapterPack``s: the JAX package's own rand masks salt their
draws with Python's per-process string hash, so they change from one
process to the next.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core.adapters import AdapterPack as JPack
from repro.core.masks import budget
from repro.hub import AdapterStore as JStore
from repro.hub import ServingEngine as JServingEngine
from repro.models import layers as JL
from repro.models import lm as JLM
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.masks import iter_leaves
from repro_torch.core.switching import FusedLRU
from repro_torch.hub import AdapterStore, RequestShed, ServingEngine
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.serving import MultiTenantEngine

TARGETS = ("wq", "wk", "wv", "wo", "w_up", "w_down")


def np_packs(tparams, n, seed=7, scale=0.05):
    """n rand-mask packs at sparsity 0.98 over the target leaves, drawn
    with numpy: (JAX packs, port packs) of the same entries."""
    rng = np.random.default_rng(seed)
    jpacks, tpacks = [], []
    for i in range(n):
        entries = {}
        for path, w in iter_leaves(tparams):
            if path.rsplit("/", 1)[-1] not in TARGETS:
                continue
            *lead, r, c = w.shape
            k = budget(r, c, 0.98)
            idx = np.stack([np.sort(rng.choice(r * c, k, replace=False))
                            for _ in range(int(np.prod(lead)))])
            val = scale * rng.standard_normal(idx.shape)
            entries[path] = (idx.astype(np.int32).reshape(tuple(lead) + (k,)),
                             val.astype(np.float32).reshape(tuple(lead)
                                                            + (k,)))
        jpacks.append(JPack(f"a{i}", {p: (jnp.asarray(a), jnp.asarray(b))
                                      for p, (a, b) in entries.items()}))
        tpacks.append(bridge.pack_from_numpy(f"a{i}", entries, device="cpu"))
    return jpacks, tpacks


def bridged_setup(n):
    """(JAX cfg, JAX params, JAX packs, port cfg, port params, port packs)
    on the smoke config, f32 weights from jax.random, n numpy packs."""
    jcfg = j_smoke("starcoder2-7b")
    with JL.compute_precision(jnp.float32):
        jparams = JLM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    jpacks, tpacks = np_packs(tparams, n)
    return jcfg, jparams, jpacks, t_smoke("starcoder2-7b"), tparams, tpacks


@pytest.fixture(scope="module")
def setup():
    return bridged_setup(3)


def _f32():
    return TL.compute_precision(torch.float32)


def _jax_run(jcfg, jparams, jpacks, prompts, names, lens, slots, cs,
             **kw):
    with JL.compute_precision(jnp.float32):
        se = JServingEngine(jcfg, jparams, slots=slots, cache_size=cs,
                            interpret=False, **kw)
        if "store" not in kw:
            for p in jpacks:
                se.register(p)
        futs = [se.submit(p, n, max_tokens=t)
                for p, n, t in zip(prompts, names, lens)]
        se.run()
        return [np.asarray(f.result()) for f in futs]


def _port_run(tcfg, tparams, tpacks, prompts, names, lens, slots, cs,
              **kw):
    with _f32():
        se = ServingEngine(tcfg, tparams, slots=slots, cache_size=cs, **kw)
        if "store" not in kw:
            for p in tpacks:
                se.register(p)
        futs = [se.submit(p, n, max_tokens=t)
                for p, n, t in zip(prompts, names, lens)]
        se.run()
        return [f.result() for f in futs], se


def test_lane_engine_matches_jax_and_fixed_batch(setup):
    """The tests/test_hub.py:256 trace: 5 requests on 2 lanes, mixed
    lengths, an adapter stack."""
    jcfg, jparams, jpacks, tcfg, tparams, tpacks = setup
    B, S = 5, 8
    lens = [4, 2, 4, 3, 1]
    names = ["a0", "a2", None, ("a0", "a1"), "a0"]
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                         jcfg.vocab_size))
    cs = S + max(lens) + 8
    want = _jax_run(jcfg, jparams, jpacks, toks, names, lens, 2, cs)
    got, se = _port_run(tcfg, tparams, tpacks, toks, names, lens, 2, cs)
    with _f32():
        mt = MultiTenantEngine(tcfg, tparams)
        for p in tpacks:
            mt.register(p)
        fixed, _ = mt.generate({"tokens": torch.from_numpy(toks)}, names,
                               max(lens))
    for i in range(B):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"req {i}")
        np.testing.assert_array_equal(got[i], fixed[i, :lens[i]].numpy())
    assert se.tokens_out == sum(lens) and se.pending() == 0
    # 5 requests through 2 lanes: some decode steps ran with a lane idle
    assert se.step_count >= max(lens) and se.decode_slot_waste > 0


def test_lane_engine_eos_recycles_slot(setup):
    jcfg, _, _, tcfg, tparams, tpacks = setup
    toks = np.array(jax.random.randint(jax.random.PRNGKey(2), (8,), 0,
                                         jcfg.vocab_size))
    full, _ = _port_run(tcfg, tparams, tpacks[:1], [toks], ["a0"], [4], 1, 32)
    full = full[0]
    with _f32():
        se = ServingEngine(tcfg, tparams, slots=1, cache_size=32)
        se.register(tpacks[0])
        f1 = se.submit(toks, "a0", max_tokens=4, eos_id=int(full[1]))
        f2 = se.submit(toks, "a0", max_tokens=2)
        se.run()
    assert len(f1.result()) == 2 and int(f1.result()[1]) == int(full[1])
    np.testing.assert_array_equal(f2.result(), full[:2])


def test_lane_engine_validation(setup):
    _, _, _, tcfg, tparams, tpacks = setup
    se = ServingEngine(tcfg, tparams, slots=2, cache_size=16)
    se.register(tpacks[0])
    with pytest.raises(KeyError, match="unregistered"):
        se.submit(np.zeros(4, np.int32), "nope", max_tokens=2)
    with pytest.raises(ValueError, match="cache slots"):
        se.submit(np.zeros(12, np.int32), "a0", max_tokens=8)
    with pytest.raises(ValueError, match="max_tokens"):
        se.submit(np.zeros(4, np.int32), "a0", max_tokens=0)
    fut = se.submit(np.zeros(4, np.int32), "a0", max_tokens=2)
    with pytest.raises(RuntimeError, match="in flight"):
        fut.result()
    late = se.submit(np.zeros(4, np.int32), None, max_tokens=2)
    assert se.cancel(late) and not se.cancel(late)
    with pytest.raises(RequestShed, match="cancelled"):
        late.result()


@pytest.mark.parametrize("values", ["f32", "int8"])
def test_lane_engine_via_store_lazy_registration(tmp_path, setup, values):
    """submit() registers adapters it has never seen from the store; int8
    packs build int8 tables from the store's own quantization, as the JAX
    engine does, so the tokens match the JAX engine's."""
    jcfg, jparams, jpacks, tcfg, tparams, tpacks = setup
    table = "int8" if values == "int8" else "f32"
    jstore = JStore(str(tmp_path / "j"))
    store = AdapterStore(str(tmp_path / "t"))
    for jp, tp in zip(jpacks, tpacks):
        jstore.add(jp, values=values)
        store.add(tp, values=values)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(4), (3, 8), 0,
                                         jcfg.vocab_size))
    names, lens = ["a1", "a2", "a1"], [3, 3, 2]
    want = _jax_run(jcfg, jparams, jpacks, toks, names, lens, 2, 24,
                    store=jstore, table_dtype=table)
    got, se = _port_run(tcfg, tparams, tpacks, toks, names, lens, 2, 24,
                        store=store, table_dtype=table)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert store.loads == 2 and sorted(se.engine.packs) == ["a1", "a2"]


def test_lane_scheduler_sees_live_lanes_only(setup):
    """Idle lanes are not base traffic: 2 live a0 requests on 4 lanes are
    100% a0, so the scheduler fuses it; tokens still match the unfused
    engine."""
    jcfg, _, _, tcfg, _, tpacks = setup
    tparams = bridge.params_from_numpy(jax.tree.map(
        np.asarray, JLM.init_params(jcfg, jax.random.PRNGKey(0))),
        device="cpu")                  # fusion updates weights in place
    toks = np.array(jax.random.randint(jax.random.PRNGKey(5), (2, 8), 0,
                                         jcfg.vocab_size))
    sched = FusedLRU(promote_at=0.9, decay=0.0)
    got, se = _port_run(tcfg, tparams, tpacks, toks, ["a0", "a0"], [3, 3], 4,
                        24, scheduler=sched)
    assert sched.share.get("a0", 0.0) == pytest.approx(1.0)
    assert se.engine.fused == "a0"
    se.engine.close()                  # un-fuse: the base is back
    plain, _ = _port_run(tcfg, tparams, tpacks, toks, ["a0", "a0"], [3, 3],
                         4, 24)
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, p)


@pytest.mark.parametrize("extra", [[], ["--int8"]])
def test_serve_continuous_cpu(extra):
    stats = serve.main(["--smoke", "--device", "cpu", "--continuous",
                        "--requests", "6", "--slots", "2", "--tokens", "3",
                        "--prompt-len", "6", "--adapters", "3"] + extra)
    assert stats["done"] == stats["requests"] == 6
    assert stats["tokens_out"] == 18 and stats["store_loads"] >= 1
    for out in stats["outs"]:
        assert out.shape == (3,) and 0 <= out.min() and out.max() < 256
