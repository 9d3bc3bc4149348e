"""paligemma-3b, the vision prefix, in the port against the JAX package, at
its smoke config (2 layers, 4 heads of 16 over one KV head, 16 patch
embeddings prepended as a prefix-LM prefix).

Weights are drawn by the JAX package and cross over through
repro_torch.bridge; tokens, patch embeddings and packs are numpy draws
(packs at sparsity 0.98 over the default targets a gelu block has: wq wk
wv wo w_up w_down); the JAX side delta runs with ``interpret=False``
(its interpret path needs ``pl.load``, gone in jax 0.9.0). In f32:
  - ``make_batch``'s vision batches are bit-equal to the reference's,
    ``seq_len <= num_prefix_embeds`` (no text) included;
  - ``embed_inputs`` prepends the patches; ``chunked_attention``'s
    prefix-LM mask, the prefill, two decode steps and ``encode`` agree to
    1e-5, and ``train_loss`` (the text suffix only) to 5e-3;
  - ``serving_cache_size`` and ``greedy_decode`` count the prefix rows
    (``ModelConfig.prefix_rows``);
  - ``MultiTenantEngine.generate`` gives the JAX engine's tokens, unfused
    and with a hot adapter fused, the side delta on the prefix rows too;
  - the reference's ``switch_per_request_reference`` raises ``KeyError``
    on the family (it prefills tokens alone), where the port's, given
    the patch embeddings, gives the reference's ``greedy_decode`` after a
    JAX ``SwitchEngine`` switch, request by request;
  - the lane engine gives the JAX lane engine's tokens, each request
    admitted with zero patch embeddings, and its fixed-batch tokens;
  - the paged engine refuses the family in both packages;
  - ``launch.serve --arch paligemma-3b`` runs its four modes and
    ``--continuous``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.core import switching as jsw
from repro.core.switching import FusedLRU as JFusedLRU
from repro.data import make_batch as j_make_batch
from repro.hub import PagedServingEngine as JPaged
from repro.hub import ServingEngine as JServing
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.serving import MultiTenantEngine as JMulti
from repro.serving import multitenant as JMT
from repro_torch import bridge
from repro_torch.configs import ShapeSpec, get_smoke_config
from repro_torch.core import FusedLRU
from repro_torch.data import make_batch
from repro_torch.hub import PagedServingEngine, ServingEngine
from repro_torch.launch import serve
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.serving import MultiTenantEngine
from repro_torch.serving import multitenant as TMT

from test_torch_mla_serving import np_packs
from test_torch_switching import _to_port

ARCH = "paligemma-3b"
TARGETS = ("wq", "wk", "wv", "wo", "w_up", "w_down")
F32_TOL = 1e-5
LOSS_TOL = 5e-3
T = 4

_SETUP = []


def setup():
    """(JAX cfg, port cfg, JAX params, numpy params, JAX packs, port
    packs), built once."""
    if not _SETUP:
        jcfg, tcfg = j_smoke(ARCH), get_smoke_config(ARCH)
        with JL.compute_precision(jnp.float32):
            jp = jax.jit(JLM.init_params, static_argnums=0)(
                jcfg, jax.random.PRNGKey(0))
        jpacks = np_packs(jp, 3, targets=TARGETS)
        _SETUP.extend([jcfg, tcfg, jp, jax.tree.map(np.asarray, jp), jpacks,
                       [_to_port(p) for p in jpacks]])
    return _SETUP


def _tparams(np_params):
    """Port params of their own: fusion updates them in place."""
    return bridge.params_from_numpy(np_params, "cpu")


def _f32():
    return JL.compute_precision(jnp.float32), TL.compute_precision(
        torch.float32)


def _inputs(cfg, B, S, seed):
    """(tokens (B, S) int32, patch embeddings (B, P, d_model) f32)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            rng.standard_normal((B, cfg.num_prefix_embeds, cfg.d_model))
            .astype(np.float32))


def _batches(toks, patches):
    return ({"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(
        patches)}, {"tokens": torch.from_numpy(toks),
                    "patch_embeds": torch.from_numpy(patches)})


def _close(port, want, tol=F32_TOL):
    if isinstance(port, torch.Tensor):
        port = port.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("seq,batch,step", [(40, 2, 0), (100, 3, 5),
                                            (16, 2, 1), (9, 1, 2)])
def test_make_batch_vision_is_bit_identical(seq, batch, step):
    """Text of seq - 16 tokens after 16 patch embeddings; at seq <= 16
    no text, as the reference's stream gives."""
    got = make_batch(get_smoke_config(ARCH), ShapeSpec("t", seq, batch,
                                                       "train"), 3, step)
    want = j_make_batch(j_smoke(ARCH), JShapeSpec("t", seq, batch, "train"),
                        3, step)
    assert got.keys() == want.keys() == {"tokens", "labels", "patch_embeds"}
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    assert got["tokens"].shape == (batch, max(seq - 16, 0))


def test_embed_inputs_prepends_the_patches():
    jcfg, tcfg, jp, np_params = setup()[:4]
    toks, patches = _inputs(tcfg, 2, 6, 0)
    jb, tb = _batches(toks, patches)
    a, b = _f32()
    with a, b:
        jh, jn = JLM.embed_inputs(jp, jcfg, jb)
        th, tn = TLM.embed_inputs(_tparams(np_params), tcfg, tb)
    assert tn == jn == 16 and th.shape == (2, 22, 64)
    np.testing.assert_array_equal(th[:, :16].numpy(), patches)
    _close(th, jh, 0)


@pytest.mark.parametrize("sq,q_chunk", [(24, 512), (24, 5), (21, 8)])
def test_prefix_lm_mask_matches_reference(sq, q_chunk):
    """chunked_attention with paligemma's 16-row prefix (one KV head, 4
    query heads of 16), chunks that start inside and past the prefix:
    every prefix key is visible to every query, later keys causally."""
    rng = np.random.default_rng(sq)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in (
        (2, sq, 4, 16), (2, sq, 1, 16), (2, sq, 1, 16)))
    a, b = _f32()
    with a, b:
        want = JA.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                    causal=True, prefix_len=16,
                                    q_chunk=q_chunk if sq % q_chunk == 0
                                    else sq)
        got = TA.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                   causal=True, prefix_len=16,
                                   q_chunk=q_chunk)
    _close(got, want)
    no_prefix = TA.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                     causal=True, q_chunk=q_chunk)
    assert float((got - no_prefix).abs()[:, :15].max()) > 1e-3


def test_prefill_decode_match_jax():
    """Prefill of 16 patches + 8 tokens, then 2 decode steps at positions
    24 and 25, f32: logits to 1e-5."""
    jcfg, tcfg, jp, np_params = setup()[:4]
    tp = _tparams(np_params)
    toks, patches = _inputs(tcfg, 2, 10, 1)
    jb, tb = _batches(toks[:, :8], patches)
    cs = TMT.serving_cache_size(tcfg, 8, 4)
    a, b = _f32()
    decode_fn = jax.jit(lambda p, t, c, pos: JLM.decode_step(p, jcfg, t, c,
                                                             pos))
    with a, b:
        jlog, jc = jax.jit(lambda p, bb: JLM.prefill(p, jcfg, bb, cs))(jp, jb)
        tlog, tc = TLM.prefill(tp, tcfg, tb, cs)
        _close(tlog, jlog)
        for i in range(2):
            t = toks[:, 8 + i:9 + i]
            jlog, jc = decode_fn(jp, jnp.asarray(t), jc, jnp.int32(24 + i))
            tlog, tc = TLM.decode_step(tp, tcfg, torch.from_numpy(t), tc,
                                       24 + i)
            _close(tlog, jlog)


def test_encode_matches_jax():
    """``lm.encode`` on a vision batch (16 patches + 8 tokens), f32: the
    full-sequence logits to 1e-5; the prefix keeps the plain chunked
    attention, as in prefill."""
    jcfg, tcfg, jp, np_params = setup()[:4]
    toks, patches = _inputs(tcfg, 2, 8, 2)
    jb, tb = _batches(toks, patches)
    a, b = _f32()
    with a, b:
        want = jax.jit(lambda p, bb: JLM.encode(p, jcfg, bb))(jp, jb)
        got = TLM.encode(_tparams(np_params), tcfg, tb)
    assert got.shape == (2, 24, 512) and not got.requires_grad
    _close(got, want)


def test_train_loss_matches_jax():
    """A make_batch vision batch (16 patches, 24 text tokens): the loss
    over the text suffix only."""
    jcfg, tcfg, jp, np_params = setup()[:4]
    nb = make_batch(tcfg, ShapeSpec("t", 40, 2, "train"), 0, 0)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    tb["labels"] = tb["labels"].long()
    a, b = _f32()
    with a, b:
        jl, _ = jax.jit(lambda p, bb: JLM.train_loss(p, jcfg, bb))(jp, jb)
        tl, tm = TLM.train_loss(_tparams(np_params), tcfg, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert float(tm["aux"]) == 0


def test_serving_cache_size_and_positions():
    """The prefix's rows count in the cache and in the first decode
    position, as the reference's ``greedy_decode`` counts them."""
    jcfg, tcfg = setup()[:2]
    text_t, text_j = (get_smoke_config("starcoder2-7b"),
                      j_smoke("starcoder2-7b"))
    assert tcfg.prefix_rows == 16 and text_t.prefix_rows == 0
    assert get_smoke_config("hubert-xlarge").prefix_rows == 0
    for prompt, tokens in ((8, 4), (1, 16)):
        assert (TMT.serving_cache_size(tcfg, prompt, tokens)
                == JMT.serving_cache_size(jcfg, prompt, tokens)
                == prompt + 16 + tokens + 8)
        assert (TMT.serving_cache_size(text_t, prompt, tokens)
                == JMT.serving_cache_size(text_j, prompt, tokens))
    seen = []
    TMT.greedy_decode(tcfg, {"tokens": torch.zeros((1, 5), dtype=torch.long)},
                      3, lambda b: (torch.zeros((1, 8)), None),
                      lambda t, c, pos: (seen.append(pos),
                                         (torch.zeros((1, 8)), None))[1])
    assert seen == [21, 22]


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "hot"])
def test_multitenant_matches_jax_engine(fused):
    """Three adapters and the base in one batch with its own patch
    embeddings a request, f32: the JAX MultiTenantEngine's tokens; with
    a FusedLRU the hot adapter is fused. The adapters change the last
    logits, and the port's switch-per-request (the adapter on every row,
    prefix rows included) gives the same tokens."""
    jcfg, tcfg, jp, np_params, jpacks, tpacks = setup()
    names = ["a0", "a1", "a2", None]
    toks, patches = _inputs(tcfg, 4, 6, 2)
    jb, tb = _batches(toks, patches)
    a, b = _f32()
    with a, b:
        js = JFusedLRU(promote_at=0.1, demote_at=0.0) if fused else None
        je = JMulti(jcfg, jp, scheduler=js, interpret=False)
        for p in jpacks:
            je.register(p)
        want, _ = je.generate(jb, names, T)
        ts = FusedLRU(promote_at=0.1, demote_at=0.0) if fused else None
        eng = MultiTenantEngine(tcfg, _tparams(np_params), scheduler=ts)
        for p in tpacks:
            eng.register(p)
        got, _ = eng.generate(tb, names, T)
        ref, logits, _ = TMT.switch_per_request_reference(
            tcfg, _tparams(np_params), tpacks, tb["tokens"], names, T,
            tb["patch_embeds"])
        _, base_logits, _ = TMT.switch_per_request_reference(
            tcfg, _tparams(np_params), tpacks, tb["tokens"], [None] * 4, T,
            tb["patch_embeds"])
    assert (eng.fused == "a0") == (je.fused == "a0") == fused
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ref.numpy(), np.asarray(want))
    moved = (logits - base_logits).abs().amax(-1)
    assert bool((moved[:3] > 1e-3).all()) and float(moved[3]) <= F32_TOL


def test_switch_per_request_reference_with_patches():
    """The reference's switch-per-request prefills {"tokens"} alone and
    raises KeyError('patch_embeds') on a vision model; the port's, given
    the patch embeddings, gives what the reference's own greedy_decode
    does after a JAX SwitchEngine switch, one request at a time."""
    jcfg, tcfg, jp, np_params, jpacks, tpacks = setup()
    names = ["a1", None, "a2"]
    toks, patches = _inputs(tcfg, 3, 5, 3)
    cs = JMT.serving_cache_size(jcfg, 5, T)
    a, b = _f32()
    with a, b:
        with pytest.raises(KeyError, match="patch_embeds"):
            JMT.switch_per_request_reference(jcfg, jp, jpacks, toks, names,
                                             T)
        je = jsw.SwitchEngine(jp)
        by_name = {p.name: p for p in jpacks}
        prefill = jax.jit(lambda p, bb: JLM.prefill(p, jcfg, bb, cs))
        decode = jax.jit(lambda p, t, c, pos: JLM.decode_step(p, jcfg, t, c,
                                                              pos))
        want = []
        for r, name in enumerate(names):
            while je.active:
                je.unload()
            if name is not None:
                je.load(by_name[name])
            seq, _ = JMT.greedy_decode(
                jcfg, {"tokens": jnp.asarray(toks[r:r + 1]),
                       "patch_embeds": jnp.asarray(patches[r:r + 1])}, T,
                lambda bb: prefill(je.params, bb),
                lambda t, c, pos: decode(je.params, t, c, pos))
            want.append(np.asarray(seq)[0])
        got, _, _ = TMT.switch_per_request_reference(
            tcfg, _tparams(np_params), tpacks, torch.from_numpy(toks), names,
            T, torch.from_numpy(patches))
    np.testing.assert_array_equal(got.numpy(), np.stack(want))


def _trace(cfg):
    rng = np.random.default_rng(6)
    return [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), a)
            for n, a in ((5, "a0"), (5, "a1"), (5, None), (5, "a2"),
                         (5, "a0"))]


def test_lanes_match_jax_engine_and_fixed_batch():
    """Two lanes over 5 requests (prompts of 5 tokens after the 16-row
    prefix; three adapters and the base), f32: the JAX lane
    engine's tokens, each request admitted with zero patch embeddings,
    and each request's own fixed-batch tokens with zero patches."""
    jcfg, tcfg, jp, np_params, jpacks, tpacks = setup()
    trace = _trace(tcfg)
    cs = 48
    a, b = _f32()
    with a, b:
        je = JServing(jcfg, jp, slots=2, cache_size=cs, interpret=False)
        for p in jpacks:
            je.register(p)
        jf = [je.submit(p, n, max_tokens=T) for p, n in trace]
        je.run()
        tparams = _tparams(np_params)
        eng = ServingEngine(tcfg, tparams, slots=2, cache_size=cs)
        for p in tpacks:
            eng.register(p)
        tf = [eng.submit(p, n, max_tokens=T) for p, n in trace]
        eng.run()
        mt = MultiTenantEngine(tcfg, tparams)
        for p in tpacks:
            mt.register(p)
        zeros = torch.zeros((1, 16, tcfg.d_model))
        fixed = [mt.generate({"tokens": torch.from_numpy(p[None].astype(
            np.int64)), "patch_embeds": zeros}, [n], T)[0][0].numpy()
            for p, n in trace]
    for i, (f, g, w) in enumerate(zip(tf, jf, fixed)):
        np.testing.assert_array_equal(f.result(), g.result(), err_msg=f"{i}")
        np.testing.assert_array_equal(f.result(), w, err_msg=f"{i}")
    with pytest.raises(ValueError, match="cache slots"):
        eng.submit(np.zeros(cs - 16 - T + 2, np.int32), None, max_tokens=T)


def test_paged_engine_refuses():
    """The paged engine (and the paged cache) refuse the vision family, as
    the reference's do: its prefix is not token-addressed."""
    jcfg, tcfg, jp, np_params = setup()[:4]
    with pytest.raises(NotImplementedError, match="vlm prefixes"):
        JPaged(jcfg, jp, num_pages=8, page_size=4)
    with pytest.raises(NotImplementedError, match="vlm prefixes"):
        PagedServingEngine(tcfg, _tparams(np_params), num_pages=8,
                           page_size=4)
    with pytest.raises(NotImplementedError, match="vlm prefixes"):
        TLM.init_paged_cache(tcfg, 8, 4, device="cpu")


@pytest.mark.parametrize("mode", [[], ["--fuse"], ["--multi-tenant"],
                                  ["--multi-tenant", "--int8"],
                                  ["--continuous"]],
                         ids=["sequential", "fuse", "multi-tenant",
                              "multi-tenant-int8", "continuous"])
def test_launch_serve_modes(mode):
    """``launch.serve --arch paligemma-3b --smoke --device cpu`` in each
    mode, zero patch embeddings before each prompt: every request
    served, tokens in range."""
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
        assert 0 <= int(o.min()) and int(o.max()) < 512
