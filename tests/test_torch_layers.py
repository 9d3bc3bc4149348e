"""repro_torch.models.layers against repro.models.layers on the same inputs.

Inputs are numpy draws from a fixed seed, handed to both packages. The JAX
side runs under compute_precision(float32); the port under
compute_precision(torch.float32). Tolerance 1e-5: the same f32 math, with
sums taken in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import layers as JL
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as TL

TOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("shape", [(3, 16), (2, 5, 16)])
def test_pdot(shape):
    rng = _rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((16, 24)).astype(np.float32)
    with JL.compute_precision(jnp.float32), TL.compute_precision(
            torch.float32):
        _close(TL.pdot(_t(x), _t(w)), JL.pdot(jnp.asarray(x), jnp.asarray(w)))


def test_pdot_bf16_default_dtype():
    """Default compute dtype is bf16 in both packages."""
    rng = _rng(2)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    w = rng.standard_normal((32, 8)).astype(np.float32)
    port = TL.pdot(_t(x), _t(w))
    ref = JL.pdot(jnp.asarray(x), jnp.asarray(w))
    assert port.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    # bf16 output rounding: half an ulp of bf16 at |y| <~ 30
    _close(port, np.asarray(ref, np.float32), tol=0.125)


@pytest.mark.parametrize("int8", [False, True])
def test_pdot_sidedelta_bundle(int8):
    """The side-delta branch: x @ base + per-request sparse delta."""
    rng = _rng(3)
    B, S, n, m, A, K = 3, 2, 16, 24, 2, 20
    x = rng.standard_normal((B, S, n)).astype(np.float32)
    base = rng.standard_normal((n, m)).astype(np.float32)
    ids = np.array([1, -1, 0], np.int32)
    idx = np.stack([rng.choice(n * m, K, replace=False) for _ in range(A)])
    vals = rng.standard_normal((A, K)).astype(np.float32)
    jr, jc, jv = zip(*(jops.sidedelta_table(idx[a], vals[a], m, K)
                       for a in range(A)))
    jr, jc, jv = (np.stack(t) for t in (jr, jc, jv))
    jscale = None
    if int8:
        q, s = zip(*(jops.quantize_table(v) for v in jv))
        jv, jscale = np.stack(q), jnp.asarray(np.array(s, np.float32))
    table = tops.sidedelta_table(
        [(_t(idx[a][None]), _t(vals[a][None])) for a in range(A)], 1, n, m,
        int8=int8)
    with JL.compute_precision(jnp.float32), JL.sidedelta_backend(False), \
            TL.compute_precision(torch.float32):
        ref = JL.pdot(jnp.asarray(x), JL.sidedelta_weight(
            jnp.asarray(base), jnp.asarray(jr), jnp.asarray(jc),
            jnp.asarray(jv), jnp.asarray(ids), scale=jscale))
        port = TL.pdot(_t(x), TL.sidedelta_weight(
            _t(base), table["rows"][0], table["vals"][0],
            table["colptr"][0], _t(ids),
            scale=table["scale"][0] if int8 else None))
    _close(port, ref)


def test_rms_norm():
    rng = _rng(4)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32) * 3
    s = rng.standard_normal((32,)).astype(np.float32)
    with JL.compute_precision(jnp.float32), TL.compute_precision(
            torch.float32):
        _close(TL.rms_norm(_t(x), _t(s), 1e-5),
               JL.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5))


@pytest.mark.parametrize("pos_shape", ["seq", "batch"])
def test_apply_rope(pos_shape):
    rng = _rng(5)
    B, S, H, D = 2, 6, 3, 16
    x = rng.standard_normal((B, S, H, D)).astype(np.float32)
    pos = (np.arange(S) + 3 if pos_shape == "seq"
           else rng.integers(0, 100, (B, S))).astype(np.int32)
    _close(TL.apply_rope(_t(x), _t(pos), 10_000.0),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0),
           tol=TOL)


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_mlp(act):
    rng = _rng(6)
    d, f = 16, 40
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    p = {"w_up": rng.standard_normal((d, f)).astype(np.float32) * 0.2,
         "w_down": rng.standard_normal((f, d)).astype(np.float32) * 0.2}
    if act == "silu":
        p["w_gate"] = rng.standard_normal((d, f)).astype(np.float32) * 0.2
    with JL.compute_precision(jnp.float32), TL.compute_precision(
            torch.float32):
        _close(TL.mlp({k: _t(v) for k, v in p.items()}, _t(x), act),
               JL.mlp({k: jnp.asarray(v) for k, v in p.items()},
                      jnp.asarray(x), act))


def test_embed():
    rng = _rng(7)
    emb = rng.standard_normal((50, 8)).astype(np.float32)
    tok = rng.integers(0, 50, (3, 4)).astype(np.int32)
    with JL.compute_precision(jnp.float32), TL.compute_precision(
            torch.float32):
        _close(TL.embed({"emb": _t(emb)}, _t(tok)),
               JL.embed({"emb": jnp.asarray(emb)}, jnp.asarray(tok)))


@pytest.mark.parametrize("softcap,logical", [(0.0, 0), (0.0, 40), (5.0, 40)])
def test_unembed(softcap, logical):
    rng = _rng(8)
    h = rng.standard_normal((3, 16)).astype(np.float32)
    w = rng.standard_normal((16, 48)).astype(np.float32)
    with JL.compute_precision(jnp.float32), TL.compute_precision(
            torch.float32):
        port = TL.unembed({"lm_head": _t(w)}, _t(h), softcap=softcap,
                          logical_vocab=logical)
        ref = JL.unembed({"lm_head": jnp.asarray(w)}, jnp.asarray(h),
                         softcap=softcap, logical_vocab=logical)
    assert port.dtype == torch.float32
    _close(port, ref)


def test_cast_compute():
    rng = _rng(9)
    tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal((4,)).astype(np.float32),
            "stack": [rng.standard_normal((2, 3, 4)).astype(np.float32),
                      np.arange(6, dtype=np.int32).reshape(2, 3)]}
    ref = JL.cast_compute({"w": jnp.asarray(tree["w"]),
                           "b": jnp.asarray(tree["b"]),
                           "stack": [jnp.asarray(a) for a in tree["stack"]]})
    port = TL.cast_compute({"w": _t(tree["w"]), "b": _t(tree["b"]),
                            "stack": [_t(a) for a in tree["stack"]]})
    assert port["w"].dtype == torch.bfloat16 and ref["w"].dtype == jnp.bfloat16
    assert port["b"].dtype == torch.float32 and ref["b"].dtype == jnp.float32
    assert port["stack"][1].dtype == torch.int32
    np.testing.assert_array_equal(port["stack"][0].float().numpy(),
                                  np.asarray(ref["stack"][0], np.float32))
