"""The port's Mamba2 mixer (``models/mamba2.py``) against the JAX
package's, on mamba2-780m's smoke config (d_model 128, 4 heads of 64,
d_state 16, chunk 32).

Weights are drawn by ``repro.models.mamba2.init_mamba`` and cross over
through ``bridge``; inputs are numpy draws. Tolerances (rtol = atol):
  F32_TOL   1e-5 on every output and cache of the mixer's functions in
            f32 (the recurrence over chunks sums in another order than
            the reference's associative scan; einsums contract in
            another order), and on a 2-layer model's loss;
  BF16_TOL  2e-2 in bf16 (a few bf16 roundings of values near 1, the
            tolerance of the port's other bf16 checks);
  GRAD_TOL  1e-4 of each leaf's largest gradient, the 2-layer model's
            ``train_loss`` gradient in f32;
  NAIVE_TOL 1e-4 for ``ssd_chunked`` against a float64 step-by-step
            recurrence (the reference's own oracle, tests/test_models.py,
            copied; the reference holds its SSD to it at 5e-2 / 1e-3).
The SSD output does not depend on the chunk size (tests/test_property.py's
property, at F32_TOL here). Prompts of 1 and 2 tokens, shorter than the
conv window, prefill in the port (its zero-padded windows) and then
decode to the reference's decode run token by token from zero caches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core.masks import path_str
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.models import mamba2 as JM
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.masks import iter_leaves
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.models import mamba2 as TM

ARCH = "mamba2-780m"
F32_TOL = 1e-5
BF16_TOL = 2e-2
GRAD_TOL = 1e-4
NAIVE_TOL = 1e-4
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
B, S = 2, 45            # S: one full chunk of 32 and a part of one

_SETUP = []


def setup():
    """(JAX cfg, port cfg, JAX mixer params, port mixer params)."""
    if not _SETUP:
        jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
        jp = JM.init_mamba(jax.random.PRNGKey(0), jcfg)
        tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        _SETUP.extend([jcfg, tcfg, jp, tp])
    return _SETUP


def _x(rng, *shape, scale=1.0):
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _prec(dtype):
    jd, td = DTYPES[dtype]
    return JL.compute_precision(jd), TL.compute_precision(td)


def _close(port, want, dtype="f32", tol=None):
    tol = tol or (F32_TOL if dtype == "f32" else BF16_TOL)
    if isinstance(port, torch.Tensor):
        port = port.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _shapes(tree):
    return {path_str(p): tuple(x.shape)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_init_mamba_tree_matches():
    """The parameter tree and shapes, alone and stacked over 3 layers;
    A_log, D and the conv biases are the reference's constants, dt_bias
    the inverse softplus of a dt in [dt_min, dt_max]."""
    jcfg, tcfg, jp, _ = setup()
    gen = torch.Generator().manual_seed(0)
    got = TM.init_mamba(gen, tcfg, device="cpu")
    assert {p: tuple(x.shape) for p, x in iter_leaves(got)} == _shapes(jp)
    stacked = {p: tuple(x.shape) for p, x in iter_leaves(
        TM.init_mamba(gen, tcfg, lead=(3,), device="cpu"))}
    assert stacked == {p: (3,) + s for p, s in _shapes(jp).items()}
    for k in ("A_log", "D", "conv_x_b", "conv_bc_b"):
        _close(got[k], jp[k])
    dt = TM._softplus(got["dt_bias"])
    s = tcfg.ssm
    assert float(dt.min()) >= s.dt_min * 0.999
    assert float(dt.max()) <= s.dt_max * 1.001


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_parts_match(dtype):
    """_project (softplus dt), _causal_conv, _gated_out and _conv_step."""
    jcfg, tcfg, jp, tp = setup()
    rng = np.random.default_rng(1)
    ju, tu = _x(rng, B, S, jcfg.d_model)
    d_inner, H, bc = JM.dims(jcfg)
    a, b = _prec(dtype)
    with a, b:
        jd = JL.compute_dtype()
        jout = JM._project(jp, jcfg, ju.astype(jd))
        tout = TM._project(tp, tcfg, tu.to(TL.compute_dtype()))
        for t, j in zip(tout, jout):
            assert t.dtype == (torch.float32 if t is tout[-1]
                               else DTYPES[dtype][1])
            _close(t, j, dtype)
        jx, tx = _x(rng, B, S, d_inner)
        _close(TM._causal_conv(tx.to(TL.compute_dtype()), tp["conv_x_w"],
                               tp["conv_x_b"]),
               JM._causal_conv(jx.astype(jd), jp["conv_x_w"],
                               jp["conv_x_b"]), dtype)
        jz, tz = _x(rng, B, S, d_inner)
        _close(TM._gated_out(tp, tcfg, tx.to(TL.compute_dtype()),
                             tz.to(TL.compute_dtype())),
               JM._gated_out(jp, jcfg, jx.astype(jd), jz.astype(jd)),
               dtype)
        jw, tw = _x(rng, B, jcfg.ssm.d_conv - 1, bc)
        jn, tn = _x(rng, B, 1, bc)
        jo, jwin = JM._conv_step(jw.astype(jd), jn.astype(jd),
                                 jp["conv_bc_w"], jp["conv_bc_b"])
        to, twin = TM._conv_step(tw.to(TL.compute_dtype()),
                                 tn.to(TL.compute_dtype()), tp["conv_bc_w"],
                                 tp["conv_bc_b"])
    _close(to, jo, dtype)
    _close(twin, jwin, dtype)


def _ssd_inputs(seed, b, s, h, p, g, n, dt_scale=0.5):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h, p).astype(np.float32)
    dt = (rng.rand(b, s, h) * dt_scale + 0.01).astype(np.float32)
    A = (-(rng.rand(h) + 0.1)).astype(np.float32)
    Bm = rng.randn(b, s, g, n).astype(np.float32)
    Cm = rng.randn(b, s, g, n).astype(np.float32)
    return x, dt, A, Bm, Cm


def ssd_naive(x, dt, Ah, B, C, state=None):
    """Step-by-step linear recurrence oracle for SSD, in float64 (the
    reference's tests/test_models.py oracle, with an initial state)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    Bh = np.repeat(np.asarray(B, np.float64), hg, axis=2)
    Ch = np.repeat(np.asarray(C, np.float64), hg, axis=2)
    xf = np.asarray(x, np.float64)
    dtf = np.asarray(dt, np.float64)
    state = (np.zeros((b, h, p, n)) if state is None
             else np.asarray(state, np.float64))
    ys = np.zeros((b, s, h, p))
    for t in range(s):
        dA = np.exp(dtf[:, t] * np.asarray(Ah, np.float64)[None])
        state = state * dA[..., None, None] + \
            (xf[:, t] * dtf[:, t][..., None])[..., None] * \
            Bh[:, t][:, :, None, :]
        ys[:, t] = np.einsum("bhpn,bhn->bhp", state, Ch[:, t])
    return ys, state


@pytest.mark.parametrize("s,chunk,init", [(32, 8, False), (40, 16, False),
                                          (45, 16, True), (7, 32, True),
                                          (64, 64, False)])
def test_ssd_chunked_matches(s, chunk, init):
    """f32: the reference's ssd_chunked (pads to a chunk multiple when s
    is not one; an initial state carried in) and the float64 oracle."""
    b, h, p, g, n = 2, 4, 8, 2, 16
    x, dt, A, Bm, Cm = _ssd_inputs(0, b, s, h, p, g, n)
    st = (np.random.RandomState(3).randn(b, h, p, n).astype(np.float32)
          if init else None)
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else torch.from_numpy(a)
    with JL.compute_precision(jnp.float32), TL.compute_precision(
            torch.float32):
        jy, jf = JM.ssd_chunked(j(x), j(dt), j(A), j(Bm), j(Cm), chunk,
                                initial_state=j(st))
        ty, tf = TM.ssd_chunked(t(x), t(dt), t(A), t(Bm), t(Cm), chunk,
                                initial_state=t(st))
    assert tuple(ty.shape) == (b, s, h, p) and tf.dtype == torch.float32
    _close(ty, jy)
    _close(tf, jf)
    ny, nf = ssd_naive(x, dt, A, Bm, Cm, st)
    _close(ty, ny, tol=NAIVE_TOL)
    _close(tf, nf, tol=NAIVE_TOL)


@pytest.mark.parametrize("seed,s,chunk", [(0, 32, 8), (1, 48, 16),
                                          (2, 96, 32), (3, 80, 16)])
def test_ssd_chunk_size_invariance(seed, s, chunk):
    """The SSD output does not depend on the chunk size: ``chunk`` against
    one chunk of all s positions (tests/test_property.py's property)."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in _ssd_inputs(
        seed, 1, s, 2, 4, 1, 8, dt_scale=0.3))
    with TL.compute_precision(torch.float32):
        y1, f1 = TM.ssd_chunked(x, dt, A, Bm, Cm, chunk)
        y2, f2 = TM.ssd_chunked(x, dt, A, Bm, Cm, s)
    _close(y1, y2.numpy())
    _close(f1, f2.numpy())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_train_prefill_match(dtype):
    """mamba_train and mamba_prefill (its output, final state and conv
    windows) on S = 45, not a chunk multiple."""
    jcfg, tcfg, jp, tp = setup()
    rng = np.random.default_rng(2)
    ju, tu = _x(rng, B, S, jcfg.d_model)
    a, b = _prec(dtype)
    with a, b:
        jd = JL.compute_dtype()
        jy = JM.mamba_train(jp, jcfg, ju.astype(jd))
        ty = TM.mamba_train(tp, tcfg, tu.to(TL.compute_dtype()))
        jo, jc = JM.mamba_prefill(jp, jcfg, ju.astype(jd))
        to, tc = TM.mamba_prefill(tp, tcfg, tu.to(TL.compute_dtype()))
    assert ty.dtype == DTYPES[dtype][1]
    _close(ty, jy, dtype)
    _close(to, jo, dtype)
    assert tc.ssm.dtype == torch.float32
    assert tc.conv_x.dtype == tc.conv_bc.dtype == DTYPES[dtype][1]
    for t, j in zip(tc, jc):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_after_prefill_matches(dtype):
    """Four mamba_decode steps after mamba_prefill: outputs, the state and
    windows written in place into the port's cache; in f32 each step's
    output equals mamba_train's row at that position."""
    jcfg, tcfg, jp, tp = setup()
    rng = np.random.default_rng(3)
    steps = 4
    ju, tu = _x(rng, B, S + steps, jcfg.d_model)
    a, b = _prec(dtype)
    with a, b:
        jd = JL.compute_dtype()
        td = TL.compute_dtype()
        _, jc = JM.mamba_prefill(jp, jcfg, ju[:, :S].astype(jd))
        _, tc = TM.mamba_prefill(tp, tcfg, tu[:, :S].to(td))
        full = TM.mamba_train(tp, tcfg, tu.to(td))
        for i in range(steps):
            jo, jc = JM.mamba_decode(jp, jcfg, ju[:, S + i:S + i + 1].astype(
                jd), jc, S + i)
            ssm = tc.ssm
            to, tc2 = TM.mamba_decode(tp, tcfg, tu[:, S + i:S + i + 1].to(td),
                                      tc, S + i)
            assert tc2 is tc and tc.ssm is ssm          # in place
            _close(to, jo, dtype)
            for t, j in zip(tc, jc):
                _close(t, j, dtype)
            if dtype == "f32":
                _close(to[:, 0], full[:, S + i].numpy())


def _model(layers):
    jcfg = j_smoke(ARCH).replace(num_layers=layers)
    tcfg = t_smoke(ARCH).replace(num_layers=layers)
    with JL.compute_precision(jnp.float32):
        jp = JLM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


def test_train_loss_gradient_matches():
    """A 2-layer model in f32: ``train_loss`` and its gradient in every
    leaf (the mixers' projections, conv, A_log, D, dt_bias, norms and the
    tied embedding) against jax.grad of the reference's."""
    jcfg, tcfg, jp, tp = _model(2)
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks),
          "labels": torch.from_numpy(toks).long()}
    for _, x in iter_leaves(tp):
        x.requires_grad_(True)
    with JL.compute_precision(jnp.float32), TL.compute_precision(
            torch.float32):
        (jl, _), jg = jax.value_and_grad(
            lambda p: JLM.train_loss(p, jcfg, jb), has_aux=True)(jp)
        tl, tm = TLM.train_loss(tp, tcfg, tb)
        tl.backward()
    _close(float(tl.detach()), float(jl))
    assert float(tm["aux"]) == 0.0
    want = {path_str(p): np.asarray(g)
            for p, g in jax.tree_util.tree_flatten_with_path(jg)[0]}
    got = dict(iter_leaves(tp))
    assert set(got) == set(want)
    for p, g in want.items():
        top = float(np.abs(g).max())
        np.testing.assert_allclose(got[p].grad.numpy(), g, rtol=0,
                                   atol=GRAD_TOL * max(top, 1e-30),
                                   err_msg=p)


@pytest.mark.parametrize("plen", [1, 2])
def test_short_prompt_prefill_then_decode(plen):
    """A prompt of 1 or 2 tokens (shorter than d_conv - 1 = 3): the port
    prefills it (conv windows padded in front with zeros) and decodes 3
    tokens; each step's logits equal the reference's decode_step run
    token by token from init_cache zeros, and so do the caches. (The
    reference's own prefill of such a prompt leaves a short window, and
    its first decode step raises.)"""
    jcfg, tcfg, jp, tp = _model(2)
    steps = 3
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, plen + steps)).astype(np.int32)
    with JL.compute_precision(jnp.float32), TL.compute_precision(
            torch.float32):
        jc = JLM.init_cache(jcfg, 2, plen + steps)
        want = []
        for i in range(plen + steps):
            jlog, jc = JLM.decode_step(jp, jcfg, jnp.asarray(
                toks[:, i:i + 1]), jc, i)
            want.append(jlog)
        tlog, tc = TLM.prefill(tp, tcfg, {"tokens": torch.from_numpy(
            toks[:, :plen])}, plen + steps)
        _close(tlog, want[plen - 1])
        for i in range(plen, plen + steps):
            tlog, tc = TLM.decode_step(tp, tcfg, torch.from_numpy(
                toks[:, i:i + 1]), tc, i)
            _close(tlog, want[i])
    for t, j in zip(tc[0], jc[0]):
        _close(t, j)
