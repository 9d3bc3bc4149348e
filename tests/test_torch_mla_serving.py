"""Serving deepseek-v2-lite-16b's smoke config (MLA attention, shared
experts, one first dense layer) in the port against the JAX package.

Weights are drawn by the JAX package and cross over through
repro_torch.bridge; packs are numpy draws over the multi-tenant targets
of the reference's own MLA test (tests/test_multitenant.py: every
default target but ``w_uk``/``w_uv``). In f32 the multi-tenant engine's
tokens equal the JAX package's switch-per-request reference (unfused, and
with a hot adapter fused); a pack on ``w_uk`` or ``w_uv`` is refused with
the reference's ``ValueError`` by both packages, given directly or
through a store. The
lane and paged engines give each request its fixed-batch tokens, with the
latents in the compute dtype's caches and pages (f32, and bf16 against a
bf16 fixed batch). With int8 latent pages the paged engine gives the JAX
paged engine's tokens (quant_kv=True) in the bytes ``cache_bytes``
counts: (rank + 2) + (rope + 2) a token and layer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.hub import PagedServingEngine as JPaged
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.serving import MultiTenantEngine as JMulti
from repro.serving.multitenant import switch_per_request_reference
from repro_torch import bridge
from repro_torch.core import FusedLRU
from repro_torch.hub import AdapterStore, PagedServingEngine, ServingEngine
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.serving import MultiTenantEngine
from repro_torch.serving.kvcache import cache_bytes

from test_torch_mla import configs
from test_torch_switching import _to_port, np_indices

MT_TARGETS = ("wq", "wq_a", "wq_b", "wo", "w_up", "w_gate", "w_down",
              "w_dkv")
T = 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def np_packs(params, n, targets=MT_TARGETS, seed=7, scale=0.05):
    """n JAX packs at sparsity 0.98 over ``targets``, indices and values
    drawn with numpy."""
    rng = np.random.default_rng(seed)
    return [jcore.AdapterPack(f"a{i}", {
        path: (jnp.asarray(idx), jnp.asarray(
            (scale * rng.standard_normal(idx.shape)).astype(np.float32)))
        for path, idx in np_indices(params, 0.98, rng, targets).items()})
        for i in range(n)]


_SETUP = []


def setup():
    """(JAX cfg, port cfg, JAX params, numpy params, JAX packs, port
    packs), built once."""
    if not _SETUP:
        jcfg, tcfg = configs("lite")
        with JL.compute_precision(jnp.float32):
            jp = jax.jit(JLM.init_params, static_argnums=0)(
                jcfg, jax.random.PRNGKey(0))
        jpacks = np_packs(jp, 3)
        _SETUP.extend([jcfg, tcfg, jp, _np(jp), jpacks,
                       [_to_port(p) for p in jpacks]])
    return _SETUP


def _tparams(np_params):
    """Port params of their own: fusion updates them in place."""
    return bridge.params_from_numpy(np_params, "cpu")


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "hot"])
def test_multitenant_matches_switch_per_request(fused):
    """Three adapters and the base in one batch, f32: the tokens of the
    JAX switch-per-request reference; with a FusedLRU the hot adapter is
    fused into the base (w_dkv, wq, wo, the shared experts and the first
    dense layer switched in place)."""
    jcfg, tcfg, jp, np_params, jpacks, tpacks = setup()
    names = ["a0", "a1", "a2", None]
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (4, 8)).astype(np.int32)
    paths = set(jpacks[0].entries)
    assert {p.rsplit("/", 1)[-1] for p in paths} >= {"w_dkv", "wo"}
    assert any("moe/shared/w_up" in p for p in paths)
    with JL.compute_precision(jnp.float32), TL.compute_precision(
            torch.float32):
        want, _, _ = switch_per_request_reference(jcfg, jp, jpacks, toks,
                                                  names, T)
        sched = FusedLRU(promote_at=0.1, demote_at=0.0) if fused else None
        eng = MultiTenantEngine(tcfg, _tparams(np_params), scheduler=sched)
        for p in tpacks:
            eng.register(p)
        got, _ = eng.generate({"tokens": torch.from_numpy(toks)}, names, T)
    assert (eng.fused == "a0") == fused
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("leaf", ["w_uk", "w_uv"])
def test_register_refuses_absorbed_leaves(leaf, tmp_path):
    """A pack on MLA's absorbed-decode weights: the reference's
    ValueError, from both packages, the port's also for a pack loaded
    through a store; the multi-tenant make_adapters leaves them out, the
    sequential one keeps them."""
    jcfg, tcfg, jp, np_params, _, _ = setup()
    (jpack,) = np_packs(jp, 1, targets=("wo", leaf))
    with pytest.raises(ValueError, match=leaf):
        JMulti(jcfg, jp, interpret=False).register(jpack)
    tparams = _tparams(np_params)
    with pytest.raises(ValueError, match=leaf):
        MultiTenantEngine(tcfg, tparams).register(_to_port(jpack))
    store = AdapterStore(str(tmp_path))
    store.add(_to_port(jpack))
    with pytest.raises(ValueError, match=leaf):
        MultiTenantEngine(tcfg, tparams, store=store).register("a0")
    leaves = lambda packs: {p.rsplit("/", 1)[-1] for p in packs[0].entries}
    assert leaf in leaves(serve.make_adapters(tcfg, tparams, 1))
    mt = leaves(serve.make_adapters(tcfg, tparams, 1, multi_tenant=True))
    assert leaf not in mt and {"w_dkv", "wq", "wo"} <= mt


def _trace(cfg):
    rng = np.random.default_rng(6)
    return [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), a)
            for n, a in ((5, "a0"), (9, None), (3, ("a0", "a1")), (7, "a1"),
                         (11, "a0"))]


def _fixed(tcfg, tparams, tpacks, trace, dtype):
    with TL.compute_precision(dtype):
        mt = MultiTenantEngine(tcfg, tparams)
        for p in tpacks:
            mt.register(p)
        return [mt.generate({"tokens": torch.from_numpy(p[None].astype(
            np.int64))}, [a], T)[0][0].numpy() for p, a in trace]


def _engine(kind, tcfg, tparams, tpacks, **kw):
    eng = (ServingEngine(tcfg, tparams, slots=2, cache_size=24)
           if kind == "lanes" else
           PagedServingEngine(tcfg, tparams, slots=2, num_pages=24,
                              page_size=4, chunk_size=4, **kw))
    for p in tpacks:
        eng.register(p)
    return eng


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["lanes", "pages"])
def test_engines_match_fixed_batch(kind, dtype):
    """Each request's tokens equal its own fixed-batch tokens in the same
    compute dtype (latent caches and pages in it): prompts of several
    lengths, an adapter stack and the base model; the KV bytes are
    (rank + rope) a token and layer in that dtype."""
    jcfg, tcfg, _, np_params, _, tpacks = setup()
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    tparams = _tparams(np_params)
    trace = _trace(tcfg)
    want = _fixed(tcfg, tparams, tpacks, trace, td)
    with TL.compute_precision(td):
        eng = _engine(kind, tcfg, tparams, tpacks)
        futs = [eng.submit(p, a, max_tokens=T) for p, a in trace]
        eng.run()
    for i, (f, w) in enumerate(zip(futs, want)):
        np.testing.assert_array_equal(f.result(), w, err_msg=f"{i}")
    m = tcfg.mla
    rows = 2 * 24 if kind == "lanes" else 24 * 4
    assert eng.kv_cache_bytes() == (tcfg.num_layers * rows * td.itemsize
                                    * (m.kv_lora_rank + m.qk_rope_head_dim))


def test_int8_latent_pages_match_jax_engine():
    """f32 compute, int8 latent pages: the JAX paged engine's tokens with
    quant_kv=True, in (rank + 2) + (rope + 2) bytes a token and layer.
    How many requests keep the fixed batch's first token is not held: the
    chunks attend to their own latents quantized, and at this size the
    JAX engine's first token of request 1 differs from its fixed batch's
    as the port's does."""
    jcfg, tcfg, jp, np_params, jpacks, tpacks = setup()
    trace = _trace(tcfg)
    kw = dict(slots=2, num_pages=24, page_size=4, chunk_size=4)
    with JL.compute_precision(jnp.float32):
        jpe = JPaged(jcfg, jp, interpret=False, quant_kv=True, **kw)
        for p in jpacks:
            jpe.register(p)
        jfuts = [jpe.submit(p, a, max_tokens=T) for p, a in trace]
        jpe.run()
    with TL.compute_precision(torch.float32):
        pe = _engine("pages", tcfg, _tparams(np_params), tpacks,
                     quant_kv=True)
        futs = [pe.submit(p, a, max_tokens=T) for p, a in trace]
        pe.run()
    for i, (f, j) in enumerate(zip(futs, jfuts)):
        np.testing.assert_array_equal(f.result(), np.asarray(j.result()),
                                      err_msg=f"{i}")
    m = tcfg.mla
    L = tcfg.num_layers
    assert pe.kv_cache_bytes() == sum(
        cache_bytes((L, 24, 4, d), True)
        for d in (m.kv_lora_rank, m.qk_rope_head_dim))
    assert pe.kv_cache_bytes() == L * 24 * 4 * (m.kv_lora_rank + 2
                                                + m.qk_rope_head_dim + 2)
