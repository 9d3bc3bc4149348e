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


# ---------------------------------------------------------------------------
# C3: repeated indices within one matrix, merged where a pack enters
# ---------------------------------------------------------------------------
# The reference sums a repeated index (``ref.scatter_apply_ref`` adds with
# ``.at[].add``); the port's kernel gives each entry one thread and no
# atomics, so a pack must reach it merged. The tolerance of a merged load
# against the reference's unmerged one is one ulp of the largest result:
# the kernel adds W + (a + b) where the reference adds (W + a) + b.

def _repeat_rows(rng, nl, nm, k):
    """nl rows of k ascending indices in [0, nm), then every third entry
    takes the index of an earlier one (adjacent and two apart), row 0
    begins at index 0 and repeats it beside the padding (index 0, value
    0) that ends every row."""
    idx = np.stack([np.sort(rng.choice(nm, k, replace=False))
                    for _ in range(nl)])
    pos = np.arange(2, k, 3)
    idx[:, pos] = idx[:, np.where(pos % 2 == 0, pos - 1, pos - 2)]
    idx[0, 0] = 0
    val = rng.standard_normal((nl, k)).astype(np.float32)
    tail_i, tail_v = np.zeros((nl, 3), np.int64), np.zeros((nl, 3),
                                                          np.float32)
    tail_v[0, 0] = 0.5
    return (np.concatenate([idx, tail_i], 1).astype(np.int32),
            np.concatenate([val, tail_v], 1))


def _ref_apply(w, idx, val, alpha=1.0):
    """The JAX oracle, one matrix at a time, on the unmerged entries."""
    from repro.kernels import ref as jref
    return np.stack([np.asarray(jref.scatter_apply_ref(
        jnp.asarray(w[i]), jnp.asarray(idx[i]), jnp.asarray(val[i]), alpha))
        for i in range(w.shape[0])])


def _one_ulp(x):
    mx = np.float32(np.abs(x).max())
    return float(np.nextafter(mx, np.float32(np.inf)) - mx)


def _held_to_ref(pack, path, w, idx, val):
    got = torch.from_numpy(w.copy())
    tcore.apply_pack({path: got}, pack)
    want = _ref_apply(w, idx, val)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=_one_ulp(want))


def _merged_rows_ok(i):
    """Every row strictly ascending, then only padding."""
    for row in i.reshape(-1, i.shape[-1]):
        nz = np.flatnonzero(row)
        end = nz[-1] + 1 if nz.size else 1
        assert (np.diff(row[:end]) > 0).all() and not row[end:].any()


def test_hand_built_pack_with_repeats_is_merged():
    rng = np.random.default_rng(0)
    n, m = 24, 40
    idx, val = _repeat_rows(rng, 3, n * m, 90)
    w = rng.standard_normal((3, n, m)).astype(np.float32)
    pack = tcore.AdapterPack("rep", {"w": (torch.from_numpy(idx),
                                           torch.from_numpy(val))})
    mi, mv = pack.entries["w"]
    assert mi.dtype == torch.int32 and mv.dtype == torch.float32
    assert mi.shape[-1] < idx.shape[-1] and not pack.unordered
    _merged_rows_ok(mi.numpy())
    assert TM_merged(mi, mv)
    _held_to_ref(pack, "w", w, idx, val)
    # the store's and the engine's doors see merged packs too
    from repro_torch.hub import AdapterStore
    store = AdapterStore(root=None)
    store.add(tcore.AdapterPack("h", {"w": (torch.from_numpy(idx),
                                            torch.from_numpy(val))}))
    assert torch.equal(store.get("h").entries["w"][0], mi)


def TM_merged(i, v):
    from repro_torch.core.adapters import merged_form
    return merged_form(i.reshape(-1, i.shape[-1]), v.reshape(-1, v.shape[-1]))


def test_shpk_with_repeats_is_merged_on_load(tmp_path):
    """A file written with repeats (by the JAX package, whose packs keep
    them) loads merged, and applies as the reference applies it."""
    from repro.hub.packio import save_pack as j_save
    from repro_torch.hub import AdapterStore, load_pack
    rng = np.random.default_rng(1)
    n, m = 16, 32
    idx, val = _repeat_rows(rng, 2, n * m, 60)
    w = rng.standard_normal((2, n, m)).astype(np.float32)
    f = j_save(jcore.AdapterPack("rep", {"w": (jnp.asarray(idx),
                                               jnp.asarray(val))}),
               str(tmp_path / "rep.shpk"))
    store = AdapterStore(str(tmp_path / "s"))
    for pack in (load_pack(f), store.get(store.register_file(f))):
        _merged_rows_ok(pack.entries["w"][0].numpy())
        _held_to_ref(pack, "w", w, idx, val)


def test_pack_without_repeats_passes_unchanged():
    rng = np.random.default_rng(2)
    asc = torch.from_numpy(np.sort(rng.choice(500, 40, replace=False))
                           .astype(np.int32))[None]
    shuf = asc[:, torch.from_numpy(rng.permutation(40))]
    vals = torch.from_numpy(rng.standard_normal((1, 40)).astype(np.float32))
    padded = torch.nn.functional.pad(asc, (0, 5))
    pvals = torch.nn.functional.pad(vals, (0, 5))
    pack = tcore.AdapterPack("u", {"a": (asc, vals), "s": (shuf, vals),
                                   "p": (padded, pvals)})
    for path, (i, v) in (("a", (asc, vals)), ("s", (shuf, vals)),
                         ("p", (padded, pvals))):
        assert pack.entries[path][0] is i and pack.entries[path][1] is v
    # unique but unsorted: kept, and its scatter is not asked to assert
    # an order (the reference's rand masks leave indices unsorted); the
    # note is by path, and copies of the pack keep it
    assert pack.unordered == {"s"}
    moved = tcore.adapters.map_entries(pack, lambda t: t.clone(), name="m")
    assert moved.unordered == {"s"}
    seen = {}
    real = tcore.adapters.scatter_apply

    def spy(w, idx, vals, alpha=1.0, *, ordered=True):
        seen[int(idx.shape[-1]), bool(idx[0, 0] == shuf[0, 0])] = ordered
        return real(w, idx, vals, alpha, ordered=ordered)
    mp = pytest.MonkeyPatch()
    mp.setattr(tcore.adapters, "scatter_apply", spy)
    try:
        for pk in (pack, moved):
            seen.clear()
            tcore.apply_pack({p: torch.zeros(1, 20, 25) for p in "asp"}, pk)
            assert sorted(seen.values()) == [False, True, True]
            assert seen[40, True] is False
    finally:
        mp.undo()


def _kernel_rule(i, v):
    """scatter_apply.cu's per-entry assertion, entry by entry, as the
    kernel's threads check it: True when no thread would trap."""
    for row_i, row_v in zip(i, v):
        for j in range(1, len(row_i)):
            if row_i[j] == 0 and row_v[j] == 0:
                continue
            prev_pad = j >= 2 and row_i[j - 1] == 0 and row_v[j - 1] == 0
            if not (row_i[j] > row_i[j - 1] and not prev_pad):
                return False
    return True


def test_kernel_assertion_rule_is_merged_form():
    """The kernel's local rule (each entry against the one before it) and
    the host's vectorized ``merged_form`` accept the same rows, on random
    rows of few distinct indices, zeros and padding."""
    from repro_torch.core.adapters import merged_form
    rng = np.random.default_rng(3)
    agree = accepted = 0
    for _ in range(3000):
        k = int(rng.integers(1, 7))
        i = rng.integers(0, 4, (1, k))
        if rng.random() < 0.5:
            i = np.sort(i, axis=1)
        v = rng.choice([0.0, 0.0, 1.5, -2.0], (1, k)).astype(np.float32)
        host = bool(merged_form(torch.from_numpy(i), torch.from_numpy(v)))
        assert host == _kernel_rule(i, v), (i, v)
        agree += 1
        accepted += host
    assert agree == 3000 and 0 < accepted < 3000


def _kernel_apply(w, idx, val, alpha=1.0):
    """scatter_apply.cu's arithmetic, entry by entry: W + (alpha * v),
    each rounded in f32, and an entry of value 0 (padding) skipped."""
    w = w.copy()
    for r in range(w.shape[0]):
        flat = w[r].reshape(-1)
        for i, v in zip(idx[r], val[r]):
            if v != 0:
                flat[i] = np.float32(flat[i] + np.float32(alpha * v))
    return w


def test_signed_zero_at_padding_is_the_only_difference():
    """The accepted difference: the kernel skips value-0 entries, so W's
    -0.0 under a padding entry stays -0.0, where the reference adds +0.0
    and gives +0.0. The plain version (index_add_ over every entry) equals
    the reference bit for bit; the kernel's rule differs from it only in
    those signed zeros."""
    from repro_torch.kernels.scatter_apply import scatter_apply_plain
    rng = np.random.default_rng(4)
    n, m = 8, 16
    w = rng.standard_normal((2, n, m)).astype(np.float32)
    w[:, 0, 0] = -0.0                     # under the padding of both rows
    w[0, 1, 3] = -0.0                     # under no entry
    idx = np.array([[5, 9, 40, 0, 0], [0, 3, 7, 60, 0]], np.int32)
    val = np.array([[0.5, -1.0, 2.0, 0.0, 0.0],
                    [0.0, 1.0, 0.25, -0.5, 0.0]], np.float32)
    plain = scatter_apply_plain(torch.from_numpy(w.copy()),
                                torch.from_numpy(idx), torch.from_numpy(val),
                                1.0).numpy()
    want = _ref_apply(w, idx, val)
    assert (plain.view(np.uint32) == want.view(np.uint32)).all()
    got = _kernel_apply(w, idx, val)
    np.testing.assert_array_equal(got, want)          # equal as numbers
    diff = got.view(np.uint32) != want.view(np.uint32)
    assert sorted(zip(*np.nonzero(diff))) == [(0, 0, 0), (1, 0, 0)]
    assert np.signbit(got[diff]).all() and not np.signbit(want[diff]).any()
