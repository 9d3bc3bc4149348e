"""The port's personalization loop against repro's: versioned publish and
the hot swap, unregister/resolve, and the trainers' publish.

``tests/test_personalization.py``'s cases, each run on both packages:
  * ``split_version``/``versioned_id``/``prior_version`` on the same ids;
  * the store's ``publish``, newest-wins ``resolve``, ``versions``,
    ``latest_version``, ``pin_use`` and ``register_file``, the same
    sequence on the JAX store and the port's;
  * the hot swap under load, lane and paged engines, synchronous and with
    async prefetch: a publish mid-stream moves new submits to ``p@2``
    while the request in flight finishes on ``p@1``; ``p@1`` leaves the
    engine and the store's resident tier only once drained; the tokens of
    every request equal the JAX engine's on the same sequence (f32,
    ``interpret=False``: the JAX interpret path needs ``pl.load``, gone in
    jax 0.9.0); with a ``FusedLRU`` the retired version is un-fused
    first, and closing the engine restores the base;
  * ``MultiTenantEngine.unregister``/``resolve`` against the JAX engine's;
  * ``Trainer.publish`` and ``MultiAdapterTrainer.publish``: the published
    ``name@v`` packs hold the JAX trainers' exported values.
Packs are drawn with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import switching as jsw
from repro.core.adapters import AdapterPack as JPack
from repro.hub import AdapterStore as JStore
from repro.hub import PagedServingEngine as JPaged
from repro.hub import ServingEngine as JServing
from repro.hub.packio import save_pack as j_save
from repro.models import layers as JL
from repro.serving import MultiTenantEngine as JMT
from repro_torch.analysis import trace
from repro_torch.core import switching as tsw
from repro_torch.core.adapters import AdapterPack
from repro_torch.core.masks import iter_leaves
from repro_torch.hub import AdapterStore, PagedServingEngine, ServingEngine
from repro_torch.models import layers as TL
from repro_torch.serving import MultiTenantEngine

from test_torch_hub_serving import bridged_setup
from test_torch_packio import _packs, _synth


@pytest.fixture(scope="module")
def setup():
    return bridged_setup(2)


def test_split_version():
    for name in ("p@3", "p", "p@x", "a@b@2", "@2", "p@1", "p@0"):
        assert tsw.split_version(name) == jsw.split_version(name)
        assert tsw.prior_version(name) == jsw.prior_version(name)
    assert tsw.split_version("a@b@2") == ("a@b", 2)
    assert tsw.versioned_id("p", 4) == jsw.versioned_id("p", 4) == "p@4"


def _store_script(s, packs, tmp_path, pfx):
    """The JAX test's store sequence; returns what it observed."""
    out = [s.resolve("p")]
    out += [s.publish(packs[0]), s.publish(packs[1])]
    out += [s.resolve("p"), s.resolve("p@1"), s.latest_version("p"),
            s.versions("p"), "p" in s, "p@1" in s, "p@3" in s]
    out.append(np.asarray(s.get("p").entries["embed/emb"][1]).tolist())
    out.append(s.publish(packs[2]))           # "p@1" publishes p's next
    s.get("p@1")
    out += [s.pin_use("p"), s.evict("p@3"), s.is_resident("p@3")]
    s.get("p@3")
    out += [s.evict("p@3")]
    s.unpin_use("p@3")
    out += [s.evict("p@3"), s.is_resident("p@3"), s.get("p").name]
    f = str(tmp_path / f"{pfx}-q5.shpk")
    j_save(_packs(_synth(name="q@5", seed=3), name="q@5")[0], f)
    s.register_file(f)
    out += [s.latest_version("q"), s.resolve("q")]
    s.shutdown()
    return out


def test_store_publish_resolve_versions_pins(tmp_path):
    ents = [_synth(name="p", seed=i) for i in range(3)]
    names = ["p", "p", "p@1"]
    jpacks = [_packs(e, name=n)[0] for e, n in zip(ents, names)]
    tpacks = [_packs(e, name=n)[1] for e, n in zip(ents, names)]
    want = _store_script(JStore(str(tmp_path / "j")), jpacks, tmp_path, "j")
    got = _store_script(AdapterStore(str(tmp_path / "t")), tpacks, tmp_path,
                        "t")
    assert got == want
    assert got[1:3] == ["p@1", "p@2"] and got[-2:] == [5, "q@5"]


def test_store_publish_emits_instant(tmp_path):
    tr = trace.install()
    try:
        AdapterStore(str(tmp_path)).publish(_packs(_synth(), name="p")[1])
    finally:
        trace.uninstall()
    ev = [e for e in tr.events() if e["name"] == "store.publish"]
    assert len(ev) == 1 and ev[0]["args"] == {"name": "p@1"}


# ---------------------------------------------------------------------------
# Hot swap under load
# ---------------------------------------------------------------------------

def _versions(jpacks, tpacks):
    """v1, v2 of adapter "p" from two numpy packs, in both packages."""
    j = [JPack("p", p.entries, p.alpha) for p in jpacks]
    t = [AdapterPack("p", p.entries, p.alpha) for p in tpacks]
    return j, t


def _hot_swap(Engine, cfg, params, v1, v2, t1, t2, root, store_cls, **kw):
    """The JAX test's sequence; returns (tokens of f1..f4, observations)."""
    store = store_cls(str(root))
    assert store.publish(v1) == "p@1"
    eng = Engine(cfg, params, slots=2, store=store, **kw)
    f1 = eng.submit(t1, "p", max_tokens=12)
    obs = [f1.adapter]
    for _ in range(4):
        eng.step()
    obs.append(f1.done())
    obs.append(store.publish(v2))
    f2 = eng.submit(t2, "p", max_tokens=8)
    obs.append(f2.adapter)
    eng.step()
    obs += ["p@1" in eng.engine.packs, eng._vpins.get("p@1", 0)]
    eng.run()
    obs += ["p@1" in eng.engine.packs, "p@2" in eng.engine.packs,
            store.is_resident("p@1"), dict(eng._vpins)]
    f3 = eng.submit(t1, "p@1", max_tokens=12)
    f4 = eng.submit(t2, "p", max_tokens=8)
    f5 = eng.submit(t2, "p", max_tokens=8)     # 2 slots: f5 queues
    obs += [f3.adapter, eng.cancel(f5), f5.cancelled]
    eng.run()
    obs += [dict(eng._vpins), "p@1" in eng.engine.packs,
            store.inflight_names()]
    eng.shutdown(include_store=True)
    toks = [np.asarray(f.result()).tolist() for f in (f1, f2, f3, f4)]
    return toks, obs, eng


ENGINES = [
    pytest.param(ServingEngine, JServing, dict(cache_size=64), id="lane"),
    pytest.param(PagedServingEngine, JPaged,
                 dict(num_pages=32, page_size=8), id="paged"),
]


@pytest.fixture(scope="module")
def jax_hot_swap(setup, tmp_path_factory):
    """The JAX engines' tokens and observations, once per engine kind."""
    jcfg, jparams, jpacks, *_ = setup
    (v1, v2), _ = _versions(jpacks, setup[5])
    rng = np.random.default_rng(0)
    t1 = rng.integers(1, jcfg.vocab_size, (6,))
    t2 = rng.integers(1, jcfg.vocab_size, (5,))
    out = {}
    with JL.compute_precision(jnp.float32):
        for (_, J, kw), kind in ((p.values, p.id) for p in ENGINES):
            root = tmp_path_factory.mktemp(f"jax-{kind}")
            out[kind] = _hot_swap(J, jcfg, jparams, v1, v2, t1, t2, root,
                                  JStore, interpret=False, **kw)[:2]
    return out, t1, t2


@pytest.mark.parametrize("async_prefetch", [False, True],
                         ids=["sync", "async"])
@pytest.mark.parametrize("Engine,JEngine,kw", ENGINES)
def test_hot_swap_under_load(tmp_path, setup, jax_hot_swap, Engine, JEngine,
                             kw, async_prefetch):
    *_, tcfg, tparams, tpacks = setup
    kind = "lane" if Engine is ServingEngine else "paged"
    (want, want_obs), t1, t2 = jax_hot_swap[0][kind], *jax_hot_swap[1:]
    _, (v1, v2) = _versions(setup[2], tpacks)
    with TL.compute_precision(torch.float32):
        got, obs, eng = _hot_swap(Engine, tcfg, tparams, v1, v2, t1, t2,
                                  tmp_path, AdapterStore,
                                  async_prefetch=async_prefetch, **kw)
    assert got == want                     # every request, through the swap
    assert obs == want_obs
    assert obs[:4] == ["p@1", False, "p@2", "p@2"]
    assert obs[4:6] == [True, 1]           # p@1 pinned by the request on it
    assert obs[6:10] == [False, True, False, {}]   # drained, then retired
    assert got[2] == got[0]                # p@1 again: the same tokens
    assert obs[-3:] == [{}, False, []]


def test_hot_swap_retires_a_fused_version(tmp_path, setup, jax_hot_swap):
    """With a FusedLRU that fuses p@1 at once, retiring it must demote it
    first: every request's tokens are the unfused JAX engine's, and
    closing the engine returns the base within the round trip's 1e-5."""
    *_, tcfg, tparams, tpacks = setup
    (want, _), t1, t2 = jax_hot_swap[0]["lane"], *jax_hot_swap[1:]
    _, (v1, v2) = _versions(setup[2], tpacks)
    for async_prefetch in (False, True):
        params = jax.tree.map(lambda x: x.clone(), tparams)
        sched = tsw.FusedLRU(promote_at=0.3, decay=0.0)
        tr = trace.install()
        try:
            with TL.compute_precision(torch.float32):
                got, obs, eng = _hot_swap(
                    ServingEngine, tcfg, params, v1, v2, t1, t2,
                    tmp_path / str(async_prefetch), AdapterStore,
                    cache_size=64, scheduler=sched,
                    async_prefetch=async_prefetch)
        finally:
            trace.uninstall()
        names = [e["name"] for e in tr.events()]
        assert "fuse" in names and "unfuse" in names
        assert names.count("hotswap.evict") == 2      # after f1, after f3
        assert got == want
        eng.engine.close()
        for (p, a), (_, b) in zip(iter_leaves(params), iter_leaves(tparams)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                       err_msg=p)


def test_multitenant_unregister_and_resolve(tmp_path, setup):
    jcfg, jparams, jpacks, tcfg, tparams, tpacks = setup
    outs = []
    for MT, Store, packs, params, pk in (
            (JMT, JStore, jpacks, jparams, JPack),
            (MultiTenantEngine, AdapterStore, tpacks, tparams, AdapterPack)):
        store = Store(str(tmp_path / MT.__module__))
        vid = store.publish(pk("p", packs[0].entries, packs[0].alpha))
        kw = {"interpret": False} if MT is JMT else {}
        eng = MT(jcfg if MT is JMT else tcfg, params, store=store, **kw)
        assert eng.resolve("p") == vid == "p@1"
        assert eng.resolve(("p", "q")) == ("p@1", "q")
        assert eng.resolve(None) is None
        for p in packs:
            eng.register(p)
        toks = np.random.default_rng(1).integers(1, jcfg.vocab_size, (2, 5))
        ctx = (JL.compute_precision(jnp.float32) if MT is JMT
               else TL.compute_precision(torch.float32))
        with ctx:
            batch = ({"tokens": jnp.asarray(toks)} if MT is JMT
                     else {"tokens": torch.from_numpy(toks)})
            out0, _ = eng.generate(batch, ["a0", "a1"], 4)
            assert eng.unregister("a0") and not eng.unregister("a0")
            assert "a0" not in eng.packs
            with pytest.raises(KeyError):
                eng.ids_for(["a0"])
            out1, _ = eng.generate(batch, ["a1", "a1"], 4)
        np.testing.assert_array_equal(np.asarray(out1[1]),
                                      np.asarray(out0[1]))
        outs.append((np.asarray(out0), np.asarray(out1)))
        eng.shutdown()
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The trainers' publish
# ---------------------------------------------------------------------------

def _held(store, vid, jpack, tol):
    """The published pack's entries against the JAX export's."""
    pub = store.get(vid)
    assert pub.name == vid and set(pub.entries) == set(jpack.entries)
    for path, (idx, v) in pub.entries.items():
        np.testing.assert_array_equal(idx.numpy(),
                                      np.asarray(jpack.entries[path][0]))
        np.testing.assert_allclose(v.numpy(), np.asarray(
            jpack.entries[path][1]), rtol=tol, atol=tol)
    return pub


def test_trainer_publish_matches_jax_export(tmp_path):
    from repro.runtime import Trainer as JTrainer
    from test_torch_train import STEPS, TRAJ_TOL, _port_trainer, _runs
    from repro import core as jcore
    from repro.models import lm as JLM
    jrun, trun = _runs()
    jbase = jax.jit(JLM.init_params, static_argnums=0)(
        jrun.model, jax.random.PRNGKey(0))
    _, jaux = jcore.init_adapter(jax.random.PRNGKey(0), jbase, jrun.adapter)
    with JL.compute_precision(jnp.float32):
        jt = JTrainer(jrun, init_key=0, base_params=jbase)
        ref = jt.fit(STEPS, log=None)
    with TL.compute_precision(torch.float32):
        tt = _port_trainer(trun, jax.tree.map(np.asarray, jbase),
                           jax.tree.map(np.asarray, jaux["indices"]))
        out = tt.fit(STEPS, log=None)
    store = AdapterStore(str(tmp_path / "t"))
    tr = trace.install()
    try:
        vids = [tt.publish(store, out["state"], "a") for _ in range(2)]
    finally:
        trace.uninstall()
    assert vids == ["a@1", "a@2"] and store.resolve("a") == "a@2"
    assert [e["name"] for e in tr.events()
            if e["ph"] == "X"] == ["publish.swap"] * 2
    pub = _held(store, "a@2", jt.export_pack(ref["state"], "a"), TRAJ_TOL)
    own = tt.export_pack(out["state"], "a")
    for path, (i, v) in own.entries.items():     # f32: stored bit-exact
        assert torch.equal(pub.entries[path][0], i)
        assert torch.equal(pub.entries[path][1], v)


def test_multi_adapter_trainer_publish_matches_jax_export(tmp_path):
    from test_torch_multiadapter import TOL, _pair, _runs
    from repro.models import lm as JLM
    jbase = jax.jit(JLM.init_params, static_argnums=0)(
        _runs()[0].model, jax.random.PRNGKey(0))
    _, jm, jout, tm, tout = _pair(jbase, "f32", 2)
    store = AdapterStore(str(tmp_path / "t"))
    vids = tm.publish(store, tout["state"])
    assert vids == ["a0@1", "a1@1"]
    assert tm.publish(store, tout["state"]) == ["a0@2", "a1@2"]
    for vid, jpack in zip(vids, jm.export_packs(jout["state"])):
        _held(store, vid, jpack, TOL["atol"])
    with pytest.raises(NotImplementedError, match="A8"):
        tm.publish(store, tout["state"], ckpt=object())
