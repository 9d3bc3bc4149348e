"""Serving zamba2-2.7b's smoke config (2 groups of 2 Mamba2 layers and
the shared attention block) and its head_dim-80 variant in the port
against the JAX package.

Weights are drawn by the JAX package and cross over through
repro_torch.bridge; packs are numpy draws at sparsity 0.98 over the
default targets the hybrid has: the (g, k, 2 d_model, d_model)
``out_proj`` of every mamba layer, and the shared block's seven
unstacked leaves (wq wk wv wo w_up w_gate w_down), one entry set each
that serves all g sites. Every test that serves them checks that an
adapter changes the output, so a side delta that touched nothing would
fail. In f32:
  - the multi-tenant engine's tokens equal the JAX switch-per-request
    reference's (the reference's sidedelta interpret path is gone in jax
    0.9.0), unfused and with a hot adapter fused, and its side-delta
    tables carry lead (g, k) on out_proj and none on the shared leaves;
  - the lane engine gives each request its fixed-batch tokens, in f32 and
    bf16, prompts of 1 and 2 tokens included; its cache is the nested
    {"mamba", "attn"} tree, every leaf counted;
  - the paged engine refuses the family with ``NotImplementedError``
    naming "paged", as the reference's does;
  - ``SwitchEngine`` loads and unloads the packs bit for bit as the JAX
    one does, the shared leaves once;
  - ``launch.serve --arch zamba2-2.7b`` runs its four modes and
    ``--continuous``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import switching as jsw
from repro.hub import PagedServingEngine as JPaged
from repro.models import layers as JL
from repro.serving.multitenant import switch_per_request_reference
from repro_torch import bridge
from repro_torch.core import FusedLRU
from repro_torch.core import switching as tsw
from repro_torch.hub import PagedServingEngine, ServingEngine
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.serving import MultiTenantEngine
from repro_torch.serving.kvcache import leaves
from repro_torch.serving.multitenant import \
    switch_per_request_reference as port_switch_reference

from test_torch_mla_serving import np_packs
from test_torch_switching import _leaves_equal, _to_port
from test_torch_zamba import ARCH, CASES, F32_TOL, setup

TARGETS = ("out_proj", "wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down")
T = 4

_PACKS = {}


def packs(case):
    """(JAX packs, port packs) of 3 adapters, built once a case."""
    if case not in _PACKS:
        jpacks = np_packs(setup(case)[2], 3, targets=TARGETS)
        _PACKS[case] = jpacks, [_to_port(p) for p in jpacks]
    return _PACKS[case]


def _tparams(np_params):
    """Port params of their own: fusion updates them in place."""
    return bridge.params_from_numpy(np_params, "cpu")


def test_packs_cover_the_hybrid_targets():
    """The packs hold out_proj's (g, k, K) entries and the shared block's
    seven (K,) entry sets; w_fuse is no target."""
    jcfg, _, _, _ = setup("smoke")
    jpacks, tpacks = packs("smoke")
    g, k = jcfg.num_layers // jcfg.hybrid_attn_every, jcfg.hybrid_attn_every
    ent = tpacks[0].entries
    assert ent["stages/0/mixer/out_proj"][0].shape[:2] == (g, k)
    shared = {p for p in ent if p.startswith("shared_attn/")}
    assert {p.rsplit("/", 1)[-1] for p in shared} == set(TARGETS[1:])
    assert all(ent[p][0].ndim == 1 for p in shared)
    assert len(ent) == 8


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "hot"])
@pytest.mark.parametrize("case", CASES)
def test_multitenant_matches_switch_per_request(case, fused):
    """Three adapters and the base in one batch, f32: the tokens of the
    JAX switch-per-request reference; with a FusedLRU the hot adapter is
    fused into out_proj and the shared leaves. The side-delta tables
    carry lead (g, k) on out_proj, none on the shared leaves. The
    adapters change the last logits."""
    jcfg, tcfg, jp, np_params = setup(case)
    jpacks, tpacks = packs(case)
    names = ["a0", "a1", "a2", None]
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (4, 8)).astype(np.int32)
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
    g, k = tcfg.num_layers // tcfg.hybrid_attn_every, tcfg.hybrid_attn_every
    tables = eng._tables
    assert tables["stages/0/mixer/out_proj"]["rows"].shape[:2] == (g, k)
    assert tables["shared_attn/attn/wq"]["rows"].ndim == 2      # (A, K)


def _trace(cfg):
    rng = np.random.default_rng(6)
    return [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), a)
            for n, a in ((5, "a0"), (1, "a1"), (9, None), (2, ("a0", "a1")),
                         (40, "a1"), (3, "a2"), (11, "a0"))]


@pytest.mark.parametrize("dtype,case", [("f32", "smoke"), ("bf16", "smoke"),
                                        ("f32", "d80")])
def test_lanes_match_fixed_batch(dtype, case):
    """Two lanes over 7 requests (prompts of 1..40 tokens: shorter than
    the conv window, and past a chunk of 32; an adapter stack; the base):
    each request's tokens equal its own MultiTenantEngine.generate tokens
    in the same compute dtype, the nested cache spliced into its lane at
    admission (mamba leaves along axis 2, the shared block's KV along
    axis 1) and idle lanes decoding beside it."""
    _, tcfg, _, np_params = setup(case)
    _, tpacks = packs(case)
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    tparams = _tparams(np_params)
    trace = _trace(tcfg)
    cs = 48
    with TL.compute_precision(td):
        mt = MultiTenantEngine(tcfg, tparams)
        for p in tpacks:
            mt.register(p)
        want = [mt.generate({"tokens": torch.from_numpy(p[None].astype(
            np.int64))}, [a], T)[0][0].numpy() for p, a in trace]
        eng = ServingEngine(tcfg, tparams, slots=2, cache_size=cs)
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
    (stage,) = eng.caches
    assert set(stage) == {"mamba", "attn"}
    s = tcfg.ssm
    d_inner = s.expand * tcfg.d_model
    L, H = tcfg.num_layers, d_inner // s.head_dim
    g = L // tcfg.hybrid_attn_every
    kv = g * 2 * 2 * cs * tcfg.num_kv_heads * tcfg.resolved_head_dim
    assert eng.kv_cache_bytes() == L * 2 * (
        H * s.head_dim * s.d_state * 4
        + (s.d_conv - 1) * (d_inner + 2 * s.d_state) * td.itemsize) \
        + kv * td.itemsize
    assert len(leaves(eng.caches)) == 5


def test_paged_engine_refuses():
    """PagedServingEngine refuses the family, as the reference's does."""
    jcfg, tcfg, jp, np_params = setup("smoke")
    with pytest.raises(NotImplementedError, match="paged"):
        JPaged(jcfg, jp, num_pages=8, page_size=4)
    with pytest.raises(NotImplementedError, match="paged"):
        PagedServingEngine(tcfg, _tparams(np_params), num_pages=8,
                           page_size=4)


def test_switch_engine_load_unload_bit_exact():
    """Each pack switched in (out_proj's (g, k) stack and the shared
    leaves), then unloaded: every leaf bit-equal to the JAX
    SwitchEngine's at each step, the base back within 1e-5."""
    _, _, jp, np_params = setup("smoke")
    jpacks, tpacks = packs("smoke")
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
    """``launch.serve --arch zamba2-2.7b --smoke --device cpu`` in each
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
