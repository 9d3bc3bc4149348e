"""Rapid switching, fusion and the fused-state scheduler of repro_torch
against repro.core on the same weights and packs.

Weights are made by the JAX package and cross over through
repro_torch.bridge. Packs are drawn with numpy from a seed (``_np_packs``):
the JAX package's own rand masks salt their draws with Python's
per-process string hash, so they would change from one process to the
next. The switch adds
alpha * vals at unique indices with the reference's rounding, so loaded
weights are bit-equal; unloading restores the base to 1e-5, the tolerance
of the JAX package's own round-trip test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_smoke_config as j_smoke
from repro.core import fusion as jfusion
from repro.core import masks as JM
from repro.core import switching as jsw
from repro.models import lm as JLM
from repro_torch import bridge
from repro_torch import core as tcore
from repro_torch.configs import AdapterConfig
from repro_torch.core import fusion as tfusion
from repro_torch.core import masks as TM
from repro_torch.core import switching as tsw
from repro_torch.core.masks import iter_leaves

TARGETS = ("wq", "wk", "wv", "wo", "w_up", "w_down")


def np_indices(params, sparsity, rng, targets=TARGETS):
    """{path: (..., K) int32} of a rand mask over the target leaves of a
    JAX parameter tree, drawn with numpy (unique, unsorted, as the JAX
    rand mask leaves them)."""
    out = {}
    for p, w in jax.tree_util.tree_flatten_with_path(params)[0]:
        path = JM.path_str(p)
        if path.rsplit("/", 1)[-1] not in targets or w.ndim < 2:
            continue
        *lead, r, c = w.shape
        k = JM.budget(r, c, sparsity)
        idx = np.stack([rng.choice(r * c, k, replace=False)
                        for _ in range(int(np.prod(lead)))])
        out[path] = idx.astype(np.int32).reshape(tuple(lead) + (k,))
    return out


def _np_packs(params, n, seed=7, scale=0.05):
    """n JAX packs at sparsity 0.98 over the target leaves, indices and
    values drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    packs = []
    for i in range(n):
        entries = {
            path: (jnp.asarray(idx), jnp.asarray(
                (scale * rng.standard_normal(idx.shape)).astype(np.float32)))
            for path, idx in np_indices(params, 0.98, rng).items()}
        packs.append(jcore.AdapterPack(f"a{i}", entries))
    return packs


def _to_port(pack):
    return bridge.pack_from_numpy(
        pack.name, {k: (np.asarray(i), np.asarray(v))
                    for k, (i, v) in pack.entries.items()},
        alpha=pack.alpha, device="cpu")


@pytest.fixture(scope="module")
def setup():
    cfg = j_smoke("starcoder2-7b")
    jparams = JLM.init_params(cfg, jax.random.PRNGKey(0))
    jpacks = _np_packs(jparams, 3)
    return jparams, jpacks


def _tparams(jparams):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


def _leaves_equal(tparams, jparams, atol=0.0):
    flat = {JM.path_str(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    port = dict(iter_leaves(tparams))
    assert set(flat) == set(port)
    for k, v in flat.items():
        if atol:
            np.testing.assert_allclose(port[k].numpy(), v, atol=atol,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(port[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("alpha,sign", [(None, 1.0), (0.5, 1.0),
                                        (None, -1.0)])
def test_apply_pack_matches_jax(setup, alpha, sign):
    jparams, jpacks = setup
    tparams = _tparams(jparams)
    out = tcore.apply_pack(tparams, _to_port(jpacks[0]), alpha=alpha,
                           sign=sign)
    assert out is tparams                       # in place
    _leaves_equal(tparams, jcore.apply_pack(jparams, jpacks[0], alpha=alpha,
                                            sign=sign))


def test_switch_unload_matches_jax(setup):
    jparams, jpacks = setup
    tparams = _tparams(jparams)
    tpacks = [_to_port(p) for p in jpacks]
    je, te = jsw.SwitchEngine(jparams), tsw.SwitchEngine(tparams)
    for jp, tp in zip(jpacks, tpacks):
        jst, tst = je.switch(jp), te.switch(tp)
        assert (tst.name, tst.entries_written, tst.bytes_written,
                tst.weight_bytes_total) == (
            jst.name, jst.entries_written, jst.bytes_written,
            jst.weight_bytes_total)
        _leaves_equal(te.params, je.params, atol=1e-6)
    te.unload()
    assert te.active == [] and te.unload() is None
    _leaves_equal(te.params, jparams, atol=1e-5)


def test_load_fused_matches_jax(setup):
    jparams, jpacks = setup
    te = tsw.SwitchEngine(_tparams(jparams))
    je = jsw.SwitchEngine(jparams)
    w = [1.0, 0.5, -0.25]
    je.load_fused(jpacks, w)
    stats = te.load_fused([_to_port(p) for p in jpacks], w)
    assert [s.name for s in stats] == ["a0", "a1", "a2"]
    _leaves_equal(te.params, je.params, atol=1e-6)
    while te.active:
        te.unload()
    _leaves_equal(te.params, jparams, atol=1e-5)


@pytest.mark.parametrize("weights", [None, [1.0, -1.0], [0.5, 2.0, -1.0]])
def test_fuse_packs_entries_equal(setup, weights):
    _, jpacks = setup
    packs = jpacks[:len(weights)] if weights else jpacks
    jf = jfusion.fuse_packs(packs, weights=weights, name="f")
    tf = tfusion.fuse_packs([_to_port(p) for p in packs], weights=weights,
                            name="f")
    assert list(tf.entries) == list(jf.entries)
    for path, (ji, jv) in jf.entries.items():
        ti, tv = tf.entries[path]
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_index_overlap_matches_jax(setup):
    _, jpacks = setup
    assert (tfusion.index_overlap(_to_port(jpacks[0]), _to_port(jpacks[1]))
            == jfusion.index_overlap(jpacks[0], jpacks[1]))


def test_gather_scatter_packed_match_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((2, 3, 8, 12)).astype(np.float32)
    idx = np.stack([rng.choice(96, 10, replace=False)
                    for _ in range(6)]).reshape(2, 3, 10).astype(np.int32)
    val = rng.standard_normal((2, 3, 10)).astype(np.float32)
    tw, ti, tv = (torch.from_numpy(a) for a in (w, idx, val))
    np.testing.assert_array_equal(
        TM.gather_packed(tw, ti).numpy(),
        np.asarray(JM.gather_packed(jnp.asarray(w), jnp.asarray(idx))))
    np.testing.assert_array_equal(
        TM.scatter_packed_add(tw, ti, tv, 0.5).numpy(),
        np.asarray(JM.scatter_packed_add(jnp.asarray(w), jnp.asarray(idx),
                                         jnp.asarray(val), 0.5)))


def test_make_packed_indices_rand():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    cfg = get_smoke_config("starcoder2-7b")
    params = lm.init_params(cfg, seed=0, device="cpu")
    acfg = AdapterConfig(kind="shira", mask="rand", sparsity=0.98,
                         target_modules=TARGETS)
    gen = torch.Generator().manual_seed(0)
    idx = dict(iter_leaves(TM.make_packed_indices(params, acfg, gen)))
    shapes = {p: tuple(x.shape) for p, x in iter_leaves(params)}
    assert {p.rsplit("/", 1)[-1] for p in idx} == set(TARGETS)
    for p, i in idx.items():
        *lead, n, m = shapes[p]
        assert i.shape == tuple(lead) + (TM.budget(n, m, 0.98),)
        assert i.dtype == torch.int32
        for row in i.reshape(-1, i.shape[-1]):
            assert bool((row[1:] > row[:-1]).all())    # ascending, unique
            assert 0 <= int(row.min()) and int(row.max()) < n * m
    with pytest.raises(ValueError, match="unknown mask"):
        TM.make_packed_indices(params, AdapterConfig(mask="top"), gen)


def test_fused_lru_matches_jax():
    """Same decisions on the same traffic, stacks and capacity included."""
    rng = np.random.default_rng(5)
    pool = ["a", "b", "c", None, ("a", "b"), ("c", "b")]
    for capacity in (1, 2):
        js = jsw.FusedLRU(capacity=capacity, max_idle=3)
        ts = tsw.FusedLRU(capacity=capacity, max_idle=3)
        for step in range(40):
            hot = pool[(step // 8) % len(pool)]
            names = [hot if rng.random() < 0.7 else
                     pool[rng.integers(len(pool))] for _ in range(6)]
            jd, td = js.observe(names), ts.observe(names)
            assert (td.promote, td.demote) == (jd.promote, jd.demote)
            assert ts.fused == js.fused
            assert ts.share == pytest.approx(js.share)


@pytest.mark.parametrize("name", [None, "a", ("b", "a"), ("a", "a"), ()])
def test_tenant_helpers_match_jax(name):
    assert tsw.normalize_tenant(name) == jsw.normalize_tenant(name)
    t = jsw.normalize_tenant(name)
    assert tsw.tenant_members(t) == jsw.tenant_members(t)
    assert tsw.tenant_key(t) == jsw.tenant_key(t)
