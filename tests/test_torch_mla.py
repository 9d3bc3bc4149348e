"""The port's MLA functions (``models/attention.py``) against the JAX
package's, on deepseek-v2-lite-16b's smoke config and a variant with a
low-rank query (``q_lora_rank`` > 0: ``wq_a``, ``q_norm``, ``wq_b``).

Weights are drawn by ``repro.models.attention.init_mla`` and cross over
through ``bridge``; inputs are numpy draws. In f32 every output, cache
and page pool agrees within 1e-5; in bf16 within BF16_TOL (a few bf16
roundings of values near 1, the tolerance of the port's other bf16
checks). The absorbed decode equals ``mla_train``'s last row, the
reference's own identity, here in f32. The paged functions are held in
test_torch_mla_paged.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import attention as JA
from repro.models import layers as JL
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL

ARCH = "deepseek-v2-lite-16b"
F32_TOL = 1e-5
BF16_TOL = 2e-2
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
B, S = 2, 9


def configs(name):
    """(JAX config, port config): the smoke config, or its variant with
    a 24-wide low-rank query."""
    j, t = j_smoke(ARCH), t_smoke(ARCH)
    if name == "q_lora":
        j = j.replace(mla=dataclasses.replace(j.mla, q_lora_rank=24))
        t = t.replace(mla=dataclasses.replace(t.mla, q_lora_rank=24))
    return j, t


_SETUP = {}


def setup(name):
    if name not in _SETUP:
        jcfg, tcfg = configs(name)
        jp = JA.init_mla(jax.random.PRNGKey(0), jcfg)
        tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        _SETUP[name] = jcfg, tcfg, jp, tp
    return _SETUP[name]


def _x(rng, *shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _prec(dtype):
    jd, td = DTYPES[dtype]
    return JL.compute_precision(jd), TL.compute_precision(td)


def _close(port, want, dtype="f32"):
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    if isinstance(port, torch.Tensor):
        port = port.float().numpy()
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _shapes(tree):
    from repro.core.masks import path_str
    return {path_str(p): tuple(x.shape)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", ["lite", "q_lora"])
def test_init_mla_tree_matches(name):
    """The parameter tree and shapes, alone and stacked over 3 layers."""
    from repro_torch.core.masks import iter_leaves
    jcfg, tcfg, jp, _ = setup(name)
    gen = torch.Generator().manual_seed(0)
    want = _shapes(jp)
    got = {p: tuple(x.shape) for p, x in iter_leaves(
        TA.init_mla(gen, tcfg, device="cpu"))}
    assert got == want
    assert ("wq_a" in got) == (name == "q_lora")
    stacked = {p: tuple(x.shape) for p, x in iter_leaves(
        TA.init_mla(gen, tcfg, lead=(3,), device="cpu"))}
    assert stacked == {p: (3,) + s for p, s in want.items()}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["lite", "q_lora"])
def test_projections_match(name, dtype):
    """_mla_q, _mla_ckv and _mla_expand_kv: q split and roped, the
    latents normed and k_rope roped as one head, the expanded K/V."""
    jcfg, tcfg, jp, tp = setup(name)
    rng = np.random.default_rng(1)
    jx, tx = _x(rng, B, S, jcfg.d_model)
    pos = np.arange(S, dtype=np.int32) + 3
    a, b = _prec(dtype)
    with a, b:
        jq = JA._mla_q(jp, jcfg, jx, jnp.asarray(pos))
        tq = TA._mla_q(tp, tcfg, tx, torch.from_numpy(pos))
        jc = JA._mla_ckv(jp, jcfg, jx, jnp.asarray(pos))
        tc = TA._mla_ckv(tp, tcfg, tx, torch.from_numpy(pos))
        jkv = JA._mla_expand_kv(jp, jcfg, *jc)
        tkv = TA._mla_expand_kv(tp, tcfg, *tc)
    for t, j in zip(tq + tc + tkv, jq + jc + jkv):
        assert tuple(t.shape) == tuple(j.shape)
        assert t.dtype == DTYPES[dtype][1]
        _close(t, j, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["lite", "q_lora"])
def test_train_and_prefill_match(name, dtype):
    """mla_train (q chunks of 4 over 9 rows, causal) and mla_prefill: the
    output and the latent cache (c_kv, k_rope) it writes."""
    jcfg, tcfg, jp, tp = setup(name)
    jx, tx = _x(np.random.default_rng(2), B, S, jcfg.d_model)
    a, b = _prec(dtype)
    with a, b:
        _close(TA.mla_train(tp, tcfg, tx, q_chunk=3),
               JA.mla_train(jp, jcfg, jx, q_chunk=3), dtype)
        jo, jc = JA.mla_prefill(jp, jcfg, jx, S + 3)
        to, tc = TA.mla_prefill(tp, tcfg, tx, S + 3)
    _close(to, jo, dtype)
    assert tuple(tc.k.shape) == (B, S + 3, jcfg.mla.kv_lora_rank)
    assert tuple(tc.v.shape) == (B, S + 3, jcfg.mla.qk_rope_head_dim)
    _close(tc.k, jc.k, dtype)
    _close(tc.v, jc.v, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "per-req"])
def test_decode_matches(vector, dtype):
    """The absorbed decode on a random latent cache, a scalar position or
    (B,) per-request positions: output and the written cache."""
    jcfg, tcfg, jp, tp = setup("lite")
    m = jcfg.mla
    rng = np.random.default_rng(3)
    Bd, Sc = 3, 12
    cc = rng.standard_normal((Bd, Sc, m.kv_lora_rank)).astype(np.float32)
    cr = rng.standard_normal((Bd, Sc, m.qk_rope_head_dim)).astype(np.float32)
    jx, tx = _x(rng, Bd, 1, jcfg.d_model)
    pos = np.array([4, 0, 11], np.int32) if vector else 7
    a, b = _prec(dtype)
    jd, td = DTYPES[dtype]
    with a, b:
        jo, jcache = JA.mla_decode(jp, jcfg, jx, JA.KVCache(
            jnp.asarray(cc, jd), jnp.asarray(cr, jd)), jnp.asarray(pos))
        tcache = TA.KVCache(torch.from_numpy(cc).to(td),
                            torch.from_numpy(cr).to(td))
        to, tcache = TA.mla_decode(tp, tcfg, tx, tcache,
                                   torch.from_numpy(pos) if vector else pos)
    _close(to, jo, dtype)
    _close(tcache.k, jcache.k, dtype)
    _close(tcache.v, jcache.v, dtype)


@pytest.mark.parametrize("name", ["lite", "q_lora"])
def test_absorbed_decode_equals_train_last_row(name):
    """The reference's absorption identity in the port, f32: prefill S
    rows, decode row S absorbed, and it equals mla_train's row S over
    S + 1 rows (expanded K/V)."""
    _, tcfg, _, tp = setup(name)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B, S + 1, tcfg.d_model)).astype(np.float32))
    with TL.compute_precision(torch.float32):
        full = TA.mla_train(tp, tcfg, x)
        _, cache = TA.mla_prefill(tp, tcfg, x[:, :S], S + 2)
        dec, _ = TA.mla_decode(tp, tcfg, x[:, S:S + 1], cache, S)
    _close(dec, full[:, S:])
