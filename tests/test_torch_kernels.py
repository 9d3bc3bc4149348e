"""The port's kernel modules on the CPU: each wrapper computes its plain
version there, held against the JAX package on the same numpy inputs.

sidedelta: repro.kernels.ops.sidedelta(interpret=False), the compiled
(XLA) formulation of the Pallas tile plan; its interpret path needs
pl.load, which this jax no longer has. Its gradients (dx, and dvals of the
trainable tables) against jax.grad of the XLA twin, the path the JAX
multi-adapter trainer differentiates. scatter_apply: ref.scatter_apply_ref
and core.masks.scatter_packed_add. f32 results agree to 1e-5: the same
products, summed in another order. sparse_adamw and sparse_adamw_batched:
the JAX wrappers in Pallas interpret mode (which this jax still runs) and
the ref.py oracles, to rtol = atol = 1e-6, the JAX package's own tolerance
for the same comparison (tests/test_multiadapter.py): XLA on the CPU may
fuse a product and a sum into one rounding, and the oracles take 1 - b1 in
Python's float64, so moments that nearly cancel (b1 * m + (1 - b1) * g)
differ in their last bits (2.4e-7 absolute at most here). The kernels
themselves run only on the card; chip_smoke.py holds them against these
plain versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import masks as JM
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.training import qstate as jq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.scatter_apply import scatter_apply
from repro_torch.kernels.sidedelta import (dvals_width, group_by_adapter,
                                           sidedelta, sidedelta_dvals,
                                           sidedelta_dvals_plain,
                                           sidedelta_plain, sidedelta_train,
                                           token_minor)
from repro_torch.kernels.sparse_adamw import sparse_adamw_rows, vector_width
from repro_torch.models import layers as TL
from repro_torch.training import qstate as tq

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _entries(rng, A, n, m, K):
    idx = np.stack([rng.choice(n * m, K, replace=False) for _ in range(A)])
    return idx.astype(np.int32), rng.standard_normal((A, K)).astype(
        np.float32)


def _jax_tables(idx, vals, m, int8):
    A, K = idx.shape
    rows, cols, v = (np.stack(t) for t in zip(
        *(jops.sidedelta_table(idx[a], vals[a], m, max(K, 1))
          for a in range(A))))
    scale = None
    if int8:
        q, s = zip(*(jops.quantize_table(x) for x in v))
        v, scale = np.stack(q), jnp.asarray(np.array(s, np.float32))
    if K == 0:
        rows, cols, v = rows[:, :0], cols[:, :0], v[:, :0]
    return jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(v), scale


def _port_table(idx, vals, n, m, int8):
    A = idx.shape[0]
    t = tops.sidedelta_table([(_t(idx[a][None]), _t(vals[a][None]))
                              for a in range(A)], 1, n, m, int8=int8)
    return {k: v[0] for k, v in t.items()}


@pytest.mark.parametrize("B,S,n,m,A,K,ids", [
    (3, 1, 16, 24, 2, 20, [1, -1, 0]),          # decode, one base request
    (2, 5, 40, 300, 3, 600, [2, 2]),             # columns straddle 128-tiles
    (4, 9, 33, 257, 2, 400, [-1, 0, 1, 0]),      # S > 8: two row groups
    (2, 3, 16, 24, 2, 0, [0, 1]),                # K = 0: zeros
    (2, 2, 16, 24, 3, 10, [-1, -1]),             # all base
    (3, 70, 24, 40, 2, 120, [1, -1, 1]),         # two requests on one
])                                               # adapter, a base one
@pytest.mark.parametrize("int8", [False, True])
def test_sidedelta_plain_matches_jax(B, S, n, m, A, K, ids, int8):
    rng = np.random.default_rng(B * 100 + K)
    x = rng.standard_normal((B, S, n)).astype(np.float32)
    idx, vals = _entries(rng, A, n, m, K)
    ids = np.array(ids, np.int32)
    jr, jc, jv, js = _jax_tables(idx, vals, m, int8)
    ref = jops.sidedelta(jnp.asarray(x), jr, jc, jv, jnp.asarray(ids), m=m,
                         scale=js, interpret=False, bm=128, kc=128)
    t = _port_table(idx, vals, n, m, int8)
    port = sidedelta(_t(x), t["rows"], t["vals"], t["colptr"], _t(ids),
                     scale=t.get("scale"))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_sidedelta_bf16_activations():
    rng = np.random.default_rng(11)
    B, S, n, m, A, K = 2, 3, 32, 48, 2, 100
    x = rng.standard_normal((B, S, n)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    idx, vals = _entries(rng, A, n, m, K)
    ids = np.array([0, 1], np.int32)
    jr, jc, jv, _ = _jax_tables(idx, vals, m, False)
    ref = jops.sidedelta(jnp.asarray(xb.float().numpy(), jnp.bfloat16), jr,
                         jc, jv, jnp.asarray(ids), m=m, interpret=False)
    t = _port_table(idx, vals, n, m, False)
    port = sidedelta(xb, t["rows"], t["vals"], t["colptr"], _t(ids))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("int8", [False, True])
def test_sidedelta_ref_matches_jax_ref(int8):
    rng = np.random.default_rng(12)
    B, S, n, m, A, K = 3, 2, 20, 30, 2, 50
    x = rng.standard_normal((B, S, n)).astype(np.float32)
    idx, vals = _entries(rng, A, n, m, K)
    ids = np.array([1, -1, 0], np.int32)
    rows, cols = idx // m, idx % m
    if int8:
        q, s = zip(*(jops.quantize_table(v) for v in vals))
        q, s = np.stack(q), np.array(s, np.float32)
        ref = jref.sidedelta_int8_ref(*(jnp.asarray(a) for a in (
            x, rows, cols, q, s, ids)), m)
        port = tref.sidedelta_int8_ref(*(_t(a) for a in (
            x, rows, cols, q, s, ids)), m)
    else:
        ref = jref.sidedelta_ref(*(jnp.asarray(a) for a in (
            x, rows, cols, vals, ids)), m)
        port = tref.sidedelta_ref(*(_t(a) for a in (
            x, rows, cols, vals, ids)), m)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_sidedelta_table_layout():
    """Entries sorted by column then row, duplicates summed, padding past
    the valid count, and padding changes nothing."""
    n, m = 4, 5
    # (row, col): (3,1) (0,0) (2,1) (0,0) dup, plus fuse_packs-style
    # padding: index 0 with value 0
    idx = torch.tensor([[3 * m + 1, 0, 2 * m + 1, 0, 0, 0]])
    vals = torch.tensor([[1.0, 2.0, 3.0, 4.0, 0.0, 0.0]])
    t = tops.sidedelta_table([(idx, vals), None], 1, n, m)
    assert t["rows"].shape == (1, 2, 3)
    assert t["colptr"][0, 0].tolist() == [0, 1, 3, 3, 3, 3]
    assert t["rows"][0, 0].tolist() == [0, 2, 3]
    assert t["vals"][0, 0].tolist() == [6.0, 3.0, 1.0]
    assert t["colptr"][0, 1].tolist() == [0] * (m + 1)   # empty slot
    x = torch.randn(2, 1, n)
    ids = torch.tensor([0, 1], dtype=torch.int32)
    # slot padding past the valid count, as a wider table would hold
    padded = {k: F.pad(t[k], (0, 5)) for k in ("rows", "vals")}
    a = sidedelta(x, padded["rows"][0], padded["vals"][0], t["colptr"][0],
                  ids)
    b = sidedelta(x, t["rows"][0], t["vals"][0], t["colptr"][0], ids)
    assert torch.equal(a, b)


def test_sidedelta_table_rejects_out_of_range():
    with pytest.raises(ValueError, match="outside"):
        tops.sidedelta_table([(torch.tensor([[20]]), torch.ones(1, 1))],
                             1, 4, 5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_table_matches_jax(seed):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal((3, 257)) * 10 ** rng.uniform(-3, 1)).astype(
        np.float32)
    v[2] = 0.0                                     # empty row: scale 1
    q, s = tops.quantize_table(_t(v))
    for r in range(3):
        jq, js = jops.quantize_table(v[r])
        np.testing.assert_array_equal(q[r].numpy(), jq)
        assert float(s[r]) == np.float32(js)


def test_sidedelta_wrapper_checks():
    x = torch.zeros(2, 1, 4)
    rows = torch.zeros(1, 3, dtype=torch.int32)
    vals = torch.zeros(1, 3)
    colptr = torch.zeros(1, 6, dtype=torch.int32)
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="ids"):
        sidedelta(x, rows, vals, colptr, ids.long())
    with pytest.raises(TypeError, match="x dtype"):
        sidedelta(x.half(), rows, vals, colptr, ids)
    with pytest.raises(ValueError, match="scale"):
        sidedelta(x, rows, vals.to(torch.int8), colptr, ids)


@pytest.mark.parametrize("alpha", [1.0, 0.75, -1.0])
def test_scatter_apply_plain_matches_ref(alpha):
    """Bit-equal to ref.scatter_apply_ref in f32: one product and one sum,
    each rounded."""
    rng = np.random.default_rng(3)
    n, m = 64, 96
    w = rng.standard_normal((n, m)).astype(np.float32)
    idx = np.unique(rng.integers(0, n * m, 500)).astype(np.int32)
    vals = rng.standard_normal(idx.shape).astype(np.float32)
    ref = jref.scatter_apply_ref(jnp.asarray(w), jnp.asarray(idx),
                                 jnp.asarray(vals), alpha)
    port = scatter_apply(_t(w), _t(idx), _t(vals), alpha)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        tref.scatter_apply_ref(_t(w), _t(idx), _t(vals), alpha).numpy(),
        np.asarray(ref))


def test_scatter_apply_load_unload_restores():
    """Load then unload on a stacked leaf restores the base to 1e-5 (the
    JAX test's tolerance); matches scatter_packed_add after the load."""
    rng = np.random.default_rng(4)
    L, n, m, K = 3, 48, 80, 400
    w = rng.standard_normal((L, n, m)).astype(np.float32)
    idx = np.stack([rng.choice(n * m, K, replace=False)
                    for _ in range(L)]).astype(np.int32)
    vals = rng.standard_normal((L, K)).astype(np.float32)
    tw = _t(w)
    ti, tv = _t(idx), _t(vals)
    scatter_apply(tw, ti, tv, 1.0)
    loaded = JM.scatter_packed_add(jnp.asarray(w), jnp.asarray(idx),
                                   jnp.asarray(vals), 1.0)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(loaded))
    scatter_apply(tw, ti, tv, -1.0)
    np.testing.assert_allclose(tw.numpy(), w, atol=1e-5)


def test_scatter_apply_padding_is_a_no_op():
    """A pack leaf's rows padded with (index 0, value 0), as fuse_packs
    pads them, beside a real entry at index 0: each layer of the stacked
    weight gets exactly its own entries."""
    idx = torch.tensor([[5, 0, 1, 0], [2, 0, 0, 0]], dtype=torch.int32)
    vals = torch.tensor([[1.0, 2.0, 3.0, 0.0], [0.5, 0.0, 0.0, 0.0]])
    w = torch.arange(16, dtype=torch.float32).reshape(2, 2, 4)
    want = w.clone().reshape(2, 8)
    want[0, 5] += 1.0
    want[0, 0] += 2.0
    want[0, 1] += 3.0
    want[1, 2] += 0.5
    scatter_apply(w, idx, vals, 1.0)
    assert torch.equal(w.reshape(2, 8), want)


def test_scatter_apply_wrapper_checks():
    w = torch.zeros(2, 3, 4)
    idx = torch.zeros(2, 5, dtype=torch.int32)
    vals = torch.zeros(2, 5)
    with pytest.raises(TypeError, match="f32"):
        scatter_apply(w.to(torch.bfloat16), idx, vals)
    with pytest.raises(ValueError, match="int32"):
        scatter_apply(w, idx.long(), vals)
    with pytest.raises(ValueError, match="leading dims"):
        scatter_apply(w, idx[:1], vals[:1])
    with pytest.raises(ValueError, match="contiguous"):
        scatter_apply(w.transpose(1, 2), idx, vals)


@pytest.mark.parametrize("L,n,m,K", [
    (37, 12, 30, 307),      # k odd: layer boundaries anywhere in a block
    (70001, 2, 4, 3),       # more layers than a CUDA grid dimension holds
])
def test_scatter_apply_many_layers_odd_k(L, n, m, K):
    """The kernel walks the flat L * K entries and finds each entry's layer
    from its position; the wrapper takes any number of layers. Bit-equal
    to the reference's scatter_packed_add."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((L, n, m)).astype(np.float32)
    idx = np.argsort(rng.random((L, n * m)), axis=1)[:, :K]
    idx = np.sort(idx, axis=1).astype(np.int32)
    vals = rng.standard_normal((L, K)).astype(np.float32)
    got = scatter_apply(_t(w), _t(idx), _t(vals), 0.5)
    want = JM.scatter_packed_add(jnp.asarray(w), jnp.asarray(idx),
                                 jnp.asarray(vals), 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scatter_bytes_counts_touched_sectors():
    """scatter_apply's bound (``sector_bytes``, which its ``cost()`` and
    chip_smoke.py's bounds count), on a pattern counted by hand: 8 B an
    entry, and 64 B (read and written) for each 32-byte sector of W that
    holds an applied entry; entries of value 0 and indices outside the
    matrix touch nothing; sectors follow W's own address, so a view one
    element in shifts them."""
    from repro_torch.kernels.scatter_apply import sector_bytes
    cs = _chip_smoke()
    idx = torch.tensor([[7, 8, 31, 40], [8, 3, 0, 5]], dtype=torch.int32)
    vals = torch.tensor([[1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 0.0, 1.0]])
    w = torch.zeros(2, 4, 8)        # 32 elements a layer, 4 sectors
    assert w.data_ptr() % 32 == 0
    # layer 0: 7 -> sector 0, 8 -> 1, 31 -> 3, 40 outside; layer 1 (from
    # element 32, sector 4): 8 -> 5, 3 and 5 -> 4, 0 has value 0
    assert sector_bytes(w, idx, vals) == (8 * 8 + 5 * 64, 5)
    shifted = torch.zeros(65)[1:].reshape(2, 4, 8)
    # one element in: layer 0 at 8, 9, 32 -> sectors 1, 1, 4; layer 1 at
    # 41, 36, 38 -> sectors 5, 4, 4 (sector 4 straddles the two layers and
    # counts once)
    assert sector_bytes(shifted, idx, vals) == (8 * 8 + 3 * 64, 3)
    b = cs.bound(*sector_bytes(w, idx, vals)[:1], 0)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(384 / cs.card_hw().hbm_bw * 1e3)


def test_wrappers_run_on_cuda_or_cpu_only():
    """No silent path for other devices: a wrapper computes its plain
    version only for CPU tensors, and a tensor elsewhere raises (CUDA
    tensors launch the kernel, which needs the card)."""
    meta = torch.device("meta")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        sidedelta(torch.zeros(2, 1, 4, device=meta),
                  torch.zeros(1, 3, dtype=torch.int32, device=meta),
                  torch.zeros(1, 3, device=meta),
                  torch.zeros(1, 6, dtype=torch.int32, device=meta),
                  torch.zeros(2, dtype=torch.int32, device=meta))
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        scatter_apply(torch.zeros(2, 2, device=meta),
                      torch.zeros(1, dtype=torch.int32, device=meta),
                      torch.zeros(1, device=meta))


# ---------------------------------------------------------------------------
# sidedelta gradients (trainable f32 tables)
# ---------------------------------------------------------------------------

ADAMW_TOL = dict(rtol=1e-6, atol=1e-6)


def _train_table(idx, n, m):
    t = tops.sidedelta_table([_t(idx[a][None]) for a in range(len(idx))], 1,
                             n, m, trainable=True)
    return {k: v[0] for k, v in t.items()}


@pytest.mark.parametrize("B,S,n,m,A,K,ids", [
    (3, 1, 16, 24, 2, 20, [1, -1, 0]),          # decode-shaped, a base row
    (4, 9, 33, 257, 2, 400, [0, 1, 1, 0]),       # S > 8, adapters interleaved
    (2, 5, 40, 30, 3, 300, [2, 2]),              # adapters without requests
    (4, 40, 20, 36, 3, 150, [2, 0, 2, 1]),       # S = 40, interleaved
])
def test_sidedelta_grads_match_jax_xla_twin(B, S, n, m, A, K, ids):
    """dx and dvals (in the pack's order) of the differentiable delta
    against jax.grad of the reference's XLA twin, on the same cotangent."""
    rng = np.random.default_rng(K + S)
    x = rng.standard_normal((B, S, n)).astype(np.float32)
    idx, vals = _entries(rng, A, n, m, K)
    dy = rng.standard_normal((B, S, m)).astype(np.float32)
    ids = np.array(ids, np.int32)

    def f(x_, v_):
        out = jops.sidedelta(x_, jnp.asarray(idx // m), jnp.asarray(idx % m),
                             v_, jnp.asarray(ids), m=m, interpret="xla")
        return jnp.sum(out * jnp.asarray(dy))
    jdx, jdv = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(vals))
    t = _train_table(idx, n, m)
    tx, tv = _t(x).requires_grad_(True), _t(vals).requires_grad_(True)
    out = sidedelta_train(tx, tv, t["rows"], t["colptr"], t["perm"],
                          t["t_rows"], t["t_ptr"], t["t_perm"], _t(ids))
    dx, dv = torch.autograd.grad(out, (tx, tv), _t(dy))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), atol=TOL)


def test_sidedelta_pdot_bundle_grads_match_jax():
    """Through the layers: a trainable bundle's pdot (base matmul + delta)
    against the JAX pdot on a side-delta bundle under
    sidedelta_backend("xla"), in f32; grads of x, the values, not of the
    base."""
    rng = np.random.default_rng(21)
    B, S, n, m, A, K = 3, 4, 24, 40, 2, 120
    x = rng.standard_normal((B, S, n)).astype(np.float32)
    w = rng.standard_normal((n, m)).astype(np.float32)
    idx, vals = _entries(rng, A, n, m, K)
    ids = np.array([1, 0, -1], np.int32)
    dy = rng.standard_normal((B, S, m)).astype(np.float32)

    def f(x_, v_):
        with JL.sidedelta_backend("xla"):
            bw = JL.sidedelta_weight(jnp.asarray(w), jnp.asarray(idx // m),
                                     jnp.asarray(idx % m), v_,
                                     jnp.asarray(ids))
            return jnp.sum(JL.pdot(x_, bw) * jnp.asarray(dy))
    with JL.compute_precision(jnp.float32):
        jdx, jdv = jax.grad(f, argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(vals))
    t = _train_table(idx, n, m)
    tx, tv = _t(x).requires_grad_(True), _t(vals).requires_grad_(True)
    with TL.compute_precision(torch.float32):
        y = TL.pdot(tx, TL.trainable_sidedelta_weight(_t(w), tv, t,
                                                      _t(ids)))
    dx, dv = torch.autograd.grad(y, (tx, tv), _t(dy))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_sidedelta_dvals_plain_matches_ref(xdt):
    """The wrapper's plain version (column-sorted order) against the dense
    oracle on the coordinate layout, bf16 x as the trainer passes it."""
    rng = np.random.default_rng(31)
    B, S, n, m, A, K = 4, 70, 20, 30, 3, 90      # S spans two row chunks
    x = _t(rng.standard_normal((B, S, n)).astype(np.float32)).to(xdt)
    dy = _t(rng.standard_normal((B, S, m)).astype(np.float32))
    idx, _ = _entries(rng, A, n, m, K)
    ids = _t(np.array([2, 0, -1, 2], np.int32))
    t = _train_table(idx, n, m)
    got = sidedelta_dvals(x, dy, t["rows"], t["colptr"], ids)
    want = tref.sidedelta_dvals_ref(x, dy, _t(idx // m), _t(idx % m), ids)
    perm = t["perm"].long()
    np.testing.assert_allclose(got.numpy(), want.gather(1, perm).numpy(),
                               atol=1e-4)
    assert float(got[1].abs().max()) == 0.0       # adapter 1: no requests


def test_grouping_permutes_and_restores_rows():
    """The token-minor layout that the card's S > 1 sidedelta path and
    dvals read, built on CPU tensors: the grouping sorts requests by
    adapter (stable, ids outside [0, A) last), rptr bounds each adapter's
    requests, and the kernels' arithmetic over xT and dyT, written back
    through ``order``, gives the plain versions (the forward bit for bit
    up to summation order, to 1e-5; dvals to 1e-4 as above)."""
    rng = np.random.default_rng(41)
    B, S, n, m, A, K = 7, 6, 20, 30, 3, 90
    order, rptr = group_by_adapter(_t(np.array([5, 0, -2], np.int32)), A)
    assert order.tolist() == [1, 0, 2] and rptr.tolist() == [0, 1, 1, 1, 3]
    ids = _t(np.array([2, -1, 0, 2, -1, 0, 2], np.int32))
    order, rptr = group_by_adapter(ids, A)
    assert order.dtype == torch.int32 and rptr.dtype == torch.int32
    assert order.tolist() == [2, 5, 0, 3, 6, 1, 4]
    assert rptr.tolist() == [0, 2, 2, 5, 7]
    x = _t(rng.standard_normal((B, S, n)).astype(np.float32)).to(
        torch.bfloat16)
    xT = token_minor(x, order)
    assert xT.shape == (n, B * S) and xT.dtype == torch.bfloat16
    assert xT.stride(0) % 4 == 0 and xT.stride(1) == 1
    back = torch.empty_like(x)
    back[order.long()] = xT.t().reshape(B, S, n)
    assert torch.equal(back, x)                     # exact, every element
    # the forward as the tokens kernel computes it: per adapter, its
    # tokens' range of xT, then each token written to its request's row
    idx, vals = _entries(rng, A, n, m, K)
    t = _port_table(idx, vals, n, m, False)
    outT = torch.zeros((m, B * S))
    for a in range(A):
        t0, t1 = int(rptr[a]) * S, int(rptr[a + 1]) * S
        k = int(t["colptr"][a, m])
        col = torch.repeat_interleave(torch.arange(m),
                                      torch.diff(t["colptr"][a].long()))
        prod = xT[t["rows"][a, :k].long(), t0:t1].float() * t["vals"][a, :k,
                                                                      None]
        outT[:, t0:t1].index_add_(0, col, prod)
    tok = torch.arange(B * S)
    out = torch.empty((B * S, m))
    out[order.long()[tok // S] * S + tok % S] = outT.t()
    want = sidedelta_plain(x, t["rows"], t["vals"], t["colptr"], ids)
    np.testing.assert_allclose(out.reshape(B, S, m).numpy(), want.numpy(),
                               atol=TOL, rtol=TOL)
    # dvals from the same grouping: adapter a's tokens of xT and dyT
    dy = _t(rng.standard_normal((B, S, m)).astype(np.float32))
    dyT = token_minor(dy, order)
    tt = _train_table(idx, n, m)
    dv = torch.zeros((A, K))
    for a in range(A):
        t0, t1 = int(rptr[a]) * S, int(rptr[a + 1]) * S
        col = torch.repeat_interleave(torch.arange(m),
                                      torch.diff(tt["colptr"][a].long()))
        dv[a] = (xT[tt["rows"][a].long(), t0:t1].float()
                 * dyT[col, t0:t1]).sum(1)
    np.testing.assert_allclose(dv.numpy(), sidedelta_dvals_plain(
        x, dy, tt["rows"], tt["colptr"], ids).numpy(), atol=1e-4)


@pytest.mark.parametrize("xdt,vec", [(torch.bfloat16, 8),
                                     (torch.float32, 4)])
def test_dvals_width_needs_whole_vectors(xdt, vec):
    """The dvals kernel's instance rule on CPU tensors: vectors of ``vec``
    tokens when S (so every adapter's first token), both row strides and
    both addresses allow them, the one-token instance otherwise. Each S
    below is laid out by token_minor as the wrapper lays it out."""
    B, n, m = 3, 5, 7
    order = torch.arange(B, dtype=torch.int32)
    for S in range(1, 2 * vec + 2):
        xT = token_minor(torch.zeros(B, S, n, dtype=xdt), order)
        dyT = token_minor(torch.zeros(B, S, m), order)
        assert dvals_width(xT, dyT, S) == (vec if S % vec == 0 else 1), S
    S, T = vec, B * vec
    xT = token_minor(torch.zeros(B, S, n, dtype=xdt), order)
    dyT = token_minor(torch.zeros(B, S, m), order)
    assert dvals_width(xT, dyT, S) == vec
    # a row stride that is not a multiple of the vector
    wide = torch.zeros(n, T + 1, dtype=xdt)[:, :T]
    assert dvals_width(wide, dyT, S) == 1
    assert dvals_width(xT, torch.zeros(m, T + 2)[:, :T], S) == 1
    # addresses one element past a vector's start
    assert dvals_width(torch.zeros(n * T + 1, dtype=xdt)[1:].view(n, T),
                       dyT, S) == 1
    assert dvals_width(xT, torch.zeros(m * T + 1)[1:].view(m, T), S) == 1


def test_trainable_table_rejects_repeats_and_ragged_slots():
    with pytest.raises(ValueError, match="repeat"):
        tops.sidedelta_table([torch.tensor([[3, 7, 3]])], 1, 4, 5,
                             trainable=True)
    with pytest.raises(ValueError, match="share"):
        tops.sidedelta_table([torch.tensor([[3, 7]]), torch.tensor([[1]])],
                             1, 4, 5, trainable=True)
    with pytest.raises(ValueError, match="f32"):
        tops.sidedelta_table([torch.tensor([[3]])], 1, 4, 5, int8=True,
                             trainable=True)


def test_sidedelta_dvals_wrapper_checks():
    x = torch.zeros(2, 1, 4)
    dy = torch.zeros(2, 1, 5)
    rows = torch.zeros(1, 3, dtype=torch.int32)
    colptr = torch.zeros(1, 6, dtype=torch.int32)
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError, match="dy f32"):
        sidedelta_dvals(x, dy.double(), rows, colptr, ids)
    with pytest.raises(ValueError, match="colptr"):
        sidedelta_dvals(x, dy, rows, colptr[:, :5], ids)
    meta = torch.device("meta")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        sidedelta_dvals(*(t.to(meta) for t in (x, dy, rows, colptr, ids)))


# ---------------------------------------------------------------------------
# sparse_adamw
# ---------------------------------------------------------------------------

def _adamw_inputs(rng, shape):
    v = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    m = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    u = (np.abs(rng.standard_normal(shape)) * 0.01).astype(np.float32)
    return v, g, m, u


@pytest.mark.parametrize("step,wd", [(1, 0.0), (7, 0.1)])
def test_sparse_adamw_plain_matches_jax(step, wd):
    """K = 3000, not a multiple of the reference's 2048 block: the port
    masks its tail, the reference pads."""
    rng = np.random.default_rng(step)
    v, g, m, u = _adamw_inputs(rng, (3000,))
    kw = dict(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, wd=wd)
    want = jops.sparse_adamw(*(jnp.asarray(a) for a in (v, g, m, u)),
                             jnp.int32(step), interpret=True, **kw)
    got = tops.sparse_adamw(*(_t(a) for a in (v, g, m, u)), step, **kw)
    oracle = tref.sparse_adamw_ref(*(_t(a) for a in (v, g, m, u)),
                                   step=step, **kw)
    joracle = jref.sparse_adamw_ref(*(jnp.asarray(a) for a in (v, g, m, u)),
                                    step=step, **kw)
    for a, b, o, jo in zip(got, want, oracle, joracle):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **ADAMW_TOL)
        np.testing.assert_allclose(a.numpy(), o.numpy(), **ADAMW_TOL)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **ADAMW_TOL)


@pytest.mark.parametrize("mode,K", [
    pytest.param(mode, K, id=mode if K == 2100 else f"{mode}-K{K}")
    for mode in ("f32", "bf16", "int8") for K in (2100, 1, 3, 7, 13)])
def test_sparse_adamw_batched_plain_matches_jax(mode, K):
    """(R, K) rows with f32, bf16 or int8 moments, against the JAX wrapper
    in interpret mode (which pads K to its block) and against the row
    reference. K = 1, 3, 7 and 13 are the shapes where the kernel's flat
    vectors of 4 elements hold a row boundary or several rows; int8 rows
    carry distinct scales."""
    rng = np.random.default_rng(5)
    v, g, m, u = _adamw_inputs(rng, (6, K))
    m *= np.linspace(1, 4, 6, dtype=np.float32)[:, None]
    jm, jms = jq.encode(jnp.asarray(m), mode)
    ju, jus = jq.encode(jnp.asarray(u), mode, sqrt_domain=True)
    tm, tms = tq.encode(_t(m), mode)
    tu, tus = tq.encode(_t(u), mode, sqrt_domain=True)
    if mode == "int8":
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.05)
    for step in (1, 4):
        want = jops.sparse_adamw_batched(
            jnp.asarray(v), jnp.asarray(g), jm, ju, jnp.int32(step),
            lr=jnp.float32(1e-2), mu_scale=jms, nu_scale=jus,
            interpret=True, **kw)
        got = tops.sparse_adamw_batched(_t(v), _t(g), tm, tu, step, lr=1e-2,
                                        mu_scale=tms, nu_scale=tus, **kw)
        oracle = tref.sparse_adamw_rows_ref(_t(v), _t(g), tm, tu, tms, tus,
                                            step, lr=1e-2, mode=mode, **kw)
        for a, b, o in zip(got, want, oracle):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       **ADAMW_TOL)
            np.testing.assert_allclose(a.numpy(), o.numpy(), **ADAMW_TOL)


def test_sparse_adamw_wrapper_checks():
    v = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="int8 moments need"):
        sparse_adamw_rows(v, v, v.to(torch.int8), v.to(torch.int8), None,
                          None, [0.0] * 7)
    with pytest.raises(ValueError, match="int8 moments only"):
        sparse_adamw_rows(v, v, v, v, torch.ones(2), torch.ones(2),
                          [0.0] * 7)
    with pytest.raises(TypeError, match="f32"):
        tops.sparse_adamw(v[0].half(), v[0], v[0], v[0], 1)
    with pytest.raises(TypeError, match="f32 moments"):
        tops.sparse_adamw(v[0], v[0], v[0].bfloat16(), v[0].bfloat16(), 1)
    meta = torch.device("meta")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        tops.sparse_adamw(*(v[0].to(meta) for _ in range(4)), 1)


# the element offset at which each operand type is aligned to a vector of
# 4 or 8 elements: f32 at 16 bytes either way, bf16 and int8 moments at
# 4 or 8 elements' bytes
_ALIGNED_EVERY = {(torch.float32, 4): 4, (torch.float32, 8): 4,
                  (torch.bfloat16, 4): 4, (torch.bfloat16, 8): 8,
                  (torch.int8, 4): 4, (torch.int8, 8): 8}


@pytest.mark.parametrize("mt", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("vec", [4, 8])
def test_sparse_adamw_vector_width_needs_every_pointer_aligned(mt, vec):
    """The wrapper's choice of kernel instance on CPU tensors sliced at
    element offsets 0..8: the vector instance only when every operand's
    address is aligned to a vector, else the one-element instance."""
    f32 = torch.zeros(64)           # CPU allocations are 64-byte aligned
    mom = torch.zeros(64, dtype=mt)
    assert f32.data_ptr() % 64 == 0 and mom.data_ptr() % 64 == 0
    whole = [f32, f32, mom, mom, f32, f32, f32]
    assert vector_width(whole, vec) == vec
    for off in range(9):
        fo, mo = f32[off:], mom[off:]
        f_ok = off % _ALIGNED_EVERY[torch.float32, vec] == 0
        m_ok = off % _ALIGNED_EVERY[mt, vec] == 0
        want = lambda ok: vec if ok else 1
        assert vector_width([fo, fo, mo, mo, fo, fo, fo], vec) == \
            want(f_ok and m_ok)
        assert vector_width([f32, f32, mo, mo, f32, f32, f32], vec) == \
            want(m_ok)
        for i in (0, 1, 4, 5, 6):   # any one f32 operand, output too
            ops_ = list(whole)
            ops_[i] = fo
            assert vector_width(ops_, vec) == want(f_ok)


def test_sparse_adamw_rows_takes_any_row_count():
    """The kernel runs R * K elements as one flat range: no grid limit on
    R (a (70000, 2) call reaches the device check, not a row cap)."""
    meta = torch.device("meta")
    v = torch.zeros(70000, 2, device=meta)
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        sparse_adamw_rows(v, v, v, v, None, None, [0.0] * 7)


def test_adamw_scalars_are_f32_like_the_reference():
    """lr, betas and the bias corrections as the reference's wrapper forms
    them in f32 (1 - b1^t from the f32 beta, not Python's float64)."""
    got = tops._adamw_scalars(3, 1e-2, 0.9, 0.999, 1e-8, 0.1)
    want = np.asarray(jops._adamw_scalars(jnp.int32(3), 1e-2, 0.9, 0.999,
                                          1e-8, 0.1))[:7]
    np.testing.assert_allclose(got, want, rtol=1e-7)
    assert all(float(np.float32(s)) == s for s in got)
