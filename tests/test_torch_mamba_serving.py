"""Serving mamba2-780m's smoke config (4 Mamba2 layers, d_model 128) in
the port against the JAX package.

Weights are drawn by the JAX package and cross over through
repro_torch.bridge; packs are numpy draws on ``out_proj``, the one
default target among the mixer's leaves (the reference's own Mamba test
targets it: tests/test_multitenant.py), and every test that serves them
checks that an adapter changes the output, so a side delta that touched
nothing would fail. In f32:
  - ``lm.prefill`` / ``decode_step`` logits and caches equal the
    reference's to 1e-5; ``init_cache`` and ``cache_batch_axes`` have
    its shapes, dtypes and axes;
  - the multi-tenant engine's tokens equal the JAX switch-per-request
    reference's, unfused and with a hot adapter fused;
  - the lane engine gives each request its fixed-batch tokens (the port
    of tests/test_hub.py's Mamba test), in f32 and bf16, prompts of 1
    and 2 tokens included;
  - the paged engine refuses the family with ``NotImplementedError``
    naming "paged", as the reference's does (tests/test_paged.py);
  - ``SwitchEngine`` loads and unloads the packs on the (L, 256, 128)
    ``out_proj`` leaf bit for bit as the JAX one does;
  - ``launch.serve`` runs its four modes and ``--continuous``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import switching as jsw
from repro.hub import PagedServingEngine as JPaged
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.serving.multitenant import switch_per_request_reference
from repro_torch import bridge
from repro_torch.core import FusedLRU
from repro_torch.core import switching as tsw
from repro_torch.hub import PagedServingEngine, ServingEngine
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.models.mamba2 import MambaCache
from repro_torch.serving import MultiTenantEngine
from repro_torch.serving.multitenant import \
    switch_per_request_reference as port_switch_reference

from test_torch_mamba import ARCH, F32_TOL, _close, _model
from test_torch_mla_serving import np_packs
from test_torch_switching import _leaves_equal, _to_port

TARGETS = ("out_proj",)
T = 4

_SETUP = []


def setup():
    """(JAX cfg, port cfg, JAX params, numpy params, JAX packs, port
    packs), 2 layers, built once."""
    if not _SETUP:
        jcfg, tcfg, jp, _ = _model(2)
        jpacks = np_packs(jp, 3, targets=TARGETS)
        _SETUP.extend([jcfg, tcfg, jp, jax.tree.map(np.asarray, jp), jpacks,
                       [_to_port(p) for p in jpacks]])
    return _SETUP


def _tparams(np_params):
    """Port params of their own: fusion updates them in place."""
    return bridge.params_from_numpy(np_params, "cpu")


def test_prefill_decode_and_caches_match():
    """f32, S = 37 (a chunk of 32 and a part): prefill logits and the
    stacked MambaCache, then 3 decode steps written in place; init_cache
    and cache_batch_axes as the reference's."""
    jcfg, tcfg, jp, np_params, _, _ = setup()
    tp = _tparams(np_params)
    S, steps = 37, 3
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, S + steps)).astype(np.int32)
    with JL.compute_precision(jnp.float32), TL.compute_precision(
            torch.float32):
        jlog, jc = JLM.prefill(jp, jcfg, {"tokens": jnp.asarray(
            toks[:, :S])}, S + steps)
        tlog, tc = TLM.prefill(tp, tcfg, {"tokens": torch.from_numpy(
            toks[:, :S])}, S + steps)
        _close(tlog, jlog)
        (stage,) = tc
        assert isinstance(stage, MambaCache)
        for i in range(steps):
            t = toks[:, S + i:S + i + 1]
            jlog, jc = JLM.decode_step(jp, jcfg, jnp.asarray(t), jc, S + i)
            tlog, tc2 = TLM.decode_step(tp, tcfg, torch.from_numpy(t), tc,
                                        S + i)
            assert tc2 is tc and tc[0].ssm is stage.ssm     # in place
            _close(tlog, jlog)
        for t, j in zip(tc[0], jc[0]):
            _close(t, j)
        for bsz in (1, 3):
            jz, tz = JLM.init_cache(jcfg, bsz, 16), TLM.init_cache(
                tcfg, bsz, 16, device="cpu")
            assert len(tz) == len(jz) == 1
            for t, j in zip(tz[0], jz[0]):
                assert tuple(t.shape) == tuple(j.shape)
                assert str(t.dtype).split(".")[-1] == str(j.dtype)
                assert not bool(t.any())
    jax_axes = JLM.cache_batch_axes(jcfg)
    assert TLM.cache_batch_axes(tcfg) == [MambaCache(*jax_axes[0])] == [
        MambaCache(1, 1, 1)]


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "hot"])
def test_multitenant_matches_switch_per_request(fused):
    """Three adapters and the base in one batch, f32: the tokens of the
    JAX switch-per-request reference; with a FusedLRU the hot adapter is
    fused into out_proj. The adapters change the last logits."""
    jcfg, tcfg, jp, np_params, jpacks, tpacks = setup()
    names = ["a0", "a1", "a2", None]
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (4, 8)).astype(np.int32)
    assert {p.rsplit("/", 1)[-1] for p in jpacks[0].entries} == {"out_proj"}
    with JL.compute_precision(jnp.float32), TL.compute_precision(
            torch.float32):
        want, want_logits, _ = switch_per_request_reference(
            jcfg, jp, jpacks, toks, names, T)
        sched = FusedLRU(promote_at=0.1, demote_at=0.0) if fused else None
        eng = MultiTenantEngine(tcfg, _tparams(np_params), scheduler=sched)
        for p in tpacks:
            eng.register(p)
        got, _ = eng.generate({"tokens": torch.from_numpy(toks)}, names, T)
        _, base_logits, _ = port_switch_reference(
            tcfg, _tparams(np_params), tpacks, torch.from_numpy(toks),
            [None] * 4, T)
    assert (eng.fused == "a0") == fused
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    moved = np.abs(np.asarray(want_logits) - base_logits.numpy()).max(-1)
    assert (moved[:3] > 1e-3).all() and moved[3] <= F32_TOL


def _trace(cfg):
    rng = np.random.default_rng(6)
    return [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), a)
            for n, a in ((5, "a0"), (1, "a1"), (9, None), (2, ("a0", "a1")),
                         (40, "a1"), (3, "a2"), (11, "a0"))]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lanes_match_fixed_batch(dtype):
    """Two lanes over 7 requests (prompts of 1..40 tokens: shorter than
    the conv window, and past a chunk of 32; an adapter stack; the base):
    each request's tokens equal its own MultiTenantEngine.generate tokens
    in the same compute dtype, the state spliced into its lane at
    admission and idle lanes decoding beside it. The cache holds the f32
    state and the windows in the compute dtype, whatever the prompt."""
    jcfg, tcfg, _, np_params, _, tpacks = setup()
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    tparams = _tparams(np_params)
    trace = _trace(tcfg)
    with TL.compute_precision(td):
        mt = MultiTenantEngine(tcfg, tparams)
        for p in tpacks:
            mt.register(p)
        want = [mt.generate({"tokens": torch.from_numpy(p[None].astype(
            np.int64))}, [a], T)[0][0].numpy() for p, a in trace]
        eng = ServingEngine(tcfg, tparams, slots=2, cache_size=48)
        for p in tpacks:
            eng.register(p)
        futs = [eng.submit(p, a, max_tokens=T) for p, a in trace]
        eng.run()
        first = torch.from_numpy(np.stack([trace[0][0]] * 2))
        _, logits, _ = port_switch_reference(
            tcfg, _tparams(np_params), tpacks, first, ["a0", None], T)
    for i, (f, w) in enumerate(zip(futs, want)):
        np.testing.assert_array_equal(f.result(), w, err_msg=f"{i}")
    assert float((logits[0] - logits[1]).abs().max()) > 1e-3
    s = tcfg.ssm
    d_inner = s.expand * tcfg.d_model
    L, H = tcfg.num_layers, d_inner // s.head_dim
    assert eng.kv_cache_bytes() == L * 2 * (
        H * s.head_dim * s.d_state * 4
        + (s.d_conv - 1) * (d_inner + 2 * s.d_state) * td.itemsize)


def test_paged_engine_refuses():
    """PagedServingEngine refuses the family, as the reference's does;
    so do the paged entry points."""
    jcfg, tcfg, jp, np_params, _, _ = setup()
    with pytest.raises(NotImplementedError, match="paged"):
        JPaged(jcfg, jp, num_pages=8, page_size=4)
    tparams = _tparams(np_params)
    with pytest.raises(NotImplementedError, match="paged"):
        PagedServingEngine(tcfg, tparams, num_pages=8, page_size=4)
    with pytest.raises(NotImplementedError, match="paged"):
        TLM.init_paged_cache(tcfg, 8, 4, device="cpu", quant=True)
    with pytest.raises(NotImplementedError, match="paged"):
        TLM.prefill_chunk(tparams, tcfg, torch.zeros((1, 4), dtype=torch.long),
                          [], torch.zeros((1, 2), dtype=torch.int32), 0, 4)


def test_switch_engine_load_unload_bit_exact():
    """Each pack switched in over out_proj, then unloaded: every leaf
    bit-equal to the JAX SwitchEngine's at each step, the base back
    within 1e-5 (the JAX package's own round-trip tolerance)."""
    _, _, jp, np_params, jpacks, tpacks = setup()
    je, te = jsw.SwitchEngine(jp), tsw.SwitchEngine(_tparams(np_params))
    for jpk, tpk in zip(jpacks, tpacks):
        jst, tst = je.switch(jpk), te.switch(tpk)
        assert tst.entries_written == jst.entries_written > 0
        _leaves_equal(te.params, je.params)
    te.unload()
    je.unload()
    _leaves_equal(te.params, je.params)
    _leaves_equal(te.params, jp, atol=1e-5)


@pytest.mark.parametrize("mode", [[], ["--fuse"], ["--multi-tenant"],
                                  ["--multi-tenant", "--int8"],
                                  ["--continuous"]],
                         ids=["sequential", "fuse", "multi-tenant",
                              "multi-tenant-int8", "continuous"])
def test_launch_serve_modes(mode):
    """``launch.serve --arch mamba2-780m --smoke --device cpu`` in each
    mode: every request served, tokens in range."""
    stats = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--adapters", "3", "--tokens", "3", "--batch", "2",
                        "--prompt-len", "5", "--batches", "2",
                        "--requests", "3"] + mode)
    outs = stats["outs"] if mode == ["--continuous"] else [stats["last_out"]]
    if mode == ["--continuous"]:
        assert stats["done"] == stats["requests"] == 3
    else:
        assert outs[0].shape == (2, 3)
    for o in outs:
        o = np.asarray(o)
        assert 0 <= int(o.min()) and int(o.max()) < 256
