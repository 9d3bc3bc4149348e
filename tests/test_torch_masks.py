"""The SHiRA mask strategies and dense-mask helpers of repro_torch.core.masks
against repro.core.masks on the same weights and calibration gradients.

The JAX smoke config's weights (jax.random init) and its calibration
gradients (``jax.grad`` of the reference loss on one batch, f32) cross
over through repro_torch.bridge. ``struct`` is index arithmetic and ``wm``,
``grad`` and ``snip`` are top-K selections, so the port must select the
same entries, compared as sets: the port lists each row ascending where
the reference lists top-K by descending score. For the top-K masks the
test first asserts that its scores have a gap between the K-th and the
(K+1)-th of every matrix, so no tie decides a selection; ties are held
separately, against ``lax.top_k`` itself. The dense helpers are equal to
the reference on the same indices (the port's masks are bool, the
reference's f32 0/1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import AdapterConfig as JAdapterConfig
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.core import masks as JM
from repro.data import batch_iterator as j_batches
from repro.models import layers as JL
from repro.models import lm as JLM
from repro_torch import bridge
from repro_torch.configs import AdapterConfig
from repro_torch.core import masks as TM
from repro_torch.core.masks import iter_leaves

SPARSITY = 0.9
SHAPE = JShapeSpec("tiny", 8, 4, "train")


@pytest.fixture(scope="module")
def setup():
    cfg = j_smoke("starcoder2-7b")
    jparams = JLM.init_params(cfg, jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in next(j_batches(
        cfg, SHAPE, seed=3)).items()}
    with JL.compute_precision(jnp.float32):
        jgrads = jax.jit(jax.grad(
            lambda p: JLM.train_loss(p, cfg, batch)[0]))(jparams)
    np_params = jax.tree.map(np.asarray, jparams)
    np_grads = jax.tree.map(np.asarray, jgrads)
    return (jparams, jgrads, bridge.params_from_numpy(np_params, "cpu"),
            bridge.params_from_numpy(np_grads, "cpu"))


def _flat(tree):
    return {JM.path_str(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _scores(kind, w, g):
    w = w.astype(np.float32)
    return {"wm": np.abs(w), "grad": np.abs(g),
            "snip": np.abs(g.astype(np.float32) * w)}[kind]


def _same_sets(jidx, tidx):
    assert set(jidx) == set(tidx)
    for p, ji in jidx.items():
        ti = tidx[p].numpy()
        assert ti.shape == ji.shape and ti.dtype == np.int32, p
        for jr, tr in zip(ji.reshape(-1, ji.shape[-1]),
                          ti.reshape(-1, ti.shape[-1])):
            assert (np.diff(tr) > 0).all(), p          # ascending, unique
            np.testing.assert_array_equal(np.sort(jr), tr, err_msg=p)


def test_struct_mask_matches_jax(setup):
    jparams, _, tparams, _ = setup
    acfg = dict(kind="shira", mask="struct", struct_rows=3, struct_cols=5)
    jidx = JM.make_packed_indices(jparams, JAdapterConfig(**acfg),
                                  jax.random.PRNGKey(0))
    tidx = TM.make_packed_indices(tparams, AdapterConfig(**acfg))
    _same_sets(_flat(jidx), dict(iter_leaves(tidx)))


@pytest.mark.parametrize("kind", ["wm", "grad", "snip"])
def test_topk_masks_match_jax(setup, kind):
    jparams, jgrads, tparams, tgrads = setup
    jw, jg = _flat(jparams), _flat(jgrads)
    jcfg = JAdapterConfig(kind="shira", mask=kind, sparsity=SPARSITY)
    tcfg = AdapterConfig(kind="shira", mask=kind, sparsity=SPARSITY)
    jidx = _flat(JM.make_packed_indices(jparams, jcfg, jax.random.PRNGKey(0),
                                        jgrads))
    assert set(jidx) == {p for p in jw
                         if p.rsplit("/", 1)[-1] in tcfg.target_modules}
    for p, ji in jidx.items():              # no tie at the K-th place
        *lead, n, m = jw[p].shape
        k = ji.shape[-1]
        for s in _scores(kind, jw[p], jg[p]).reshape(-1, n * m):
            top = np.sort(s)[::-1]
            assert top[k - 1] > top[k], (p, k)
    tidx = TM.make_packed_indices(tparams, tcfg, grads=tgrads)
    _same_sets(jidx, dict(iter_leaves(tidx)))


def test_topk_ties_follow_lax_top_k():
    """Of equal scores at the K-th place the lower indices are taken."""
    rng = np.random.default_rng(0)
    s = rng.integers(0, 5, size=997).astype(np.float32)
    for k in (1, 10, 200, 333, 996):
        _, j = jax.lax.top_k(jnp.asarray(s), k)
        t = TM.topk_indices(torch.from_numpy(s), k).numpy()
        np.testing.assert_array_equal(np.sort(np.asarray(j)), t)


def test_grad_masks_need_calibration_grads(setup):
    _, _, tparams, _ = setup
    for kind in ("grad", "snip"):
        with pytest.raises(ValueError, match="calibration grads"):
            TM.make_packed_indices(tparams, AdapterConfig(mask=kind))
        with pytest.raises(ValueError, match="calibration grads"):
            TM.make_dense_masks(tparams, AdapterConfig(mask=kind))
    with pytest.raises(ValueError, match="torch.Generator"):
        TM.make_packed_indices(tparams, AdapterConfig(mask="rand"))


def test_dense_masks_match_jax(setup):
    jparams, _, tparams, _ = setup
    acfg = dict(kind="shira", mask="wm", sparsity=SPARSITY)
    jm = _flat(JM.make_dense_masks(jparams, JAdapterConfig(**acfg),
                                   jax.random.PRNGKey(0)))
    tm = dict(iter_leaves(TM.make_dense_masks(tparams,
                                              AdapterConfig(**acfg))))
    assert set(jm) == set(tm)
    for p, m in jm.items():
        assert tm[p].dtype == torch.bool
        np.testing.assert_array_equal(tm[p].numpy().astype(np.float32), m)
    js = JM.mask_sparsity(JM.make_dense_masks(jparams, JAdapterConfig(**acfg),
                                              jax.random.PRNGKey(0)))
    ts = TM.mask_sparsity(TM.make_dense_masks(tparams,
                                              AdapterConfig(**acfg)))
    assert set(js) == set(ts)
    for p in js:
        assert ts[p] == pytest.approx(js[p], rel=1e-6)


def test_dense_mask_from_indices_and_scatter_set_match_jax():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((2, 3, 8, 12)).astype(np.float32)
    idx = np.stack([rng.choice(96, 10, replace=False)
                    for _ in range(6)]).reshape(2, 3, 10).astype(np.int32)
    val = rng.standard_normal((2, 3, 10)).astype(np.float32)
    tw, ti, tv = (torch.from_numpy(a) for a in (w, idx, val))
    np.testing.assert_array_equal(
        TM.dense_mask_from_indices(tw, ti).numpy().astype(np.float32),
        np.asarray(JM.dense_mask_from_indices(jnp.asarray(w),
                                              jnp.asarray(idx))))
    np.testing.assert_array_equal(
        TM.scatter_packed_set(tw, ti, tv).numpy(),
        np.asarray(JM.scatter_packed_set(jnp.asarray(w), jnp.asarray(idx),
                                         jnp.asarray(val))))


@pytest.mark.parametrize("freeze_others", [True, False])
def test_mask_grads_match_jax(setup, freeze_others):
    jparams, jgrads, tparams, tgrads = setup
    acfg = dict(kind="shira", mask="wm", sparsity=SPARSITY)
    jmasks = JM.make_dense_masks(jparams, JAdapterConfig(**acfg),
                                 jax.random.PRNGKey(0))
    for masks in (TM.make_dense_masks(tparams, AdapterConfig(**acfg)),
                  bridge.params_from_numpy(jax.tree.map(np.asarray, jmasks),
                                           "cpu")):
        want = _flat(JM.mask_grads(jgrads, jmasks, freeze_others))
        got = dict(iter_leaves(TM.mask_grads(tgrads, masks, freeze_others)))
        assert set(got) == set(want)
        for p, g in want.items():
            np.testing.assert_array_equal(got[p].numpy(), g, err_msg=p)
