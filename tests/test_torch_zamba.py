"""zamba2-2.7b, the hybrid (groups of Mamba2 layers and one shared
attention block), in the port against the JAX package.

Two configs: zamba2's smoke config (4 layers in 2 groups of 2, d_model
128, 4 heads of 32) and a variant of it with head_dim 80 (d_model 160, 2
heads of 80), so that the shared block's attention runs at zamba2's own
head size, the flash kernels' D = 80. Weights are drawn by the JAX
package and cross over through ``bridge``, as do the caches, both ways;
inputs are numpy draws.
Tolerances, rtol = atol, all in f32:
  F32_TOL  1e-5 on the shared block's outputs and caches, the model's
           prefill and decode logits and caches, and ``train_loss``
           (f32 sums in another order: the SSD recurrence, einsums);
  GRAD_TOL 1e-4 of each leaf's largest gradient (``train_loss``'s
           gradient in every leaf, the shared block's summed over its
           sites, against jax.grad).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.core.masks import path_str
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models import lm as JLM
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.masks import iter_leaves
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.models.attention import KVCache
from repro_torch.models.mamba2 import MambaCache

ARCH = "zamba2-2.7b"
F32_TOL = 1e-5
GRAD_TOL = 1e-4
CASES = ["smoke", "d80"]
B, S, STEPS = 2, 37, 3          # S: a chunk of 32 and a part


def variant(cfg):
    """The smoke config with head_dim 80: d_model 160, 2 heads of 80."""
    return cfg.replace(d_model=160, num_heads=2, num_kv_heads=2)


def cfgs(case):
    j, t = j_smoke(ARCH), get_smoke_config(ARCH)
    return (variant(j), variant(t)) if case == "d80" else (j, t)


_SETUP = {}


def setup(case):
    """(JAX cfg, port cfg, JAX params, numpy params), built once a case."""
    if case not in _SETUP:
        jcfg, tcfg = cfgs(case)
        with JL.compute_precision(jnp.float32):
            jp = jax.jit(JLM.init_params, static_argnums=0)(
                jcfg, jax.random.PRNGKey(0))
        _SETUP[case] = jcfg, tcfg, jp, jax.tree.map(np.asarray, jp)
    return _SETUP[case]


def tparams(np_params):
    return bridge.params_from_numpy(np_params, "cpu")


def _close(port, want, tol=F32_TOL):
    if isinstance(port, torch.Tensor):
        port = port.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _f32():
    return JL.compute_precision(jnp.float32), TL.compute_precision(
        torch.float32)


def _caches_close(tc, jc):
    """The nested hybrid caches: {"mamba": MambaCache (g, k, B, ...),
    "attn": KVCache (g, B, S, KV, D)}, shapes and values."""
    assert len(tc) == len(jc) == 1
    assert isinstance(tc[0]["mamba"], MambaCache)
    assert isinstance(tc[0]["attn"], KVCache)
    for key in ("mamba", "attn"):
        for t, j in zip(tc[0][key], jc[0][key]):
            assert tuple(t.shape) == tuple(j.shape), key
            _close(t, j)


def test_config_and_registry():
    """The config equals the reference's, field by field, hybrid_attn_every
    included; the D = 80 variant's head_dim is 80; the full config's
    shared block is 32 heads of 80."""
    import dataclasses
    for tget, jget in ((get_config, j_config), (get_smoke_config, j_smoke)):
        t, j = tget(ARCH), jget(ARCH)
        for f in dataclasses.fields(t):
            a, b = getattr(t, f.name), getattr(j, f.name)
            if f.name == "ssm":
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name
    assert variant(get_smoke_config(ARCH)).resolved_head_dim == 80
    full = get_config(ARCH)
    assert (full.resolved_head_dim, full.num_heads, full.num_layers,
            full.hybrid_attn_every) == (80, 32, 54, 6)
    assert TLM.stage_plan(full) == [("hybrid", 54)]


@pytest.mark.parametrize("case", CASES)
def test_init_params_tree_matches(case):
    """The parameter tree and shapes: mamba leaves stacked (g, k, ...), the
    shared block's leaves and w_fuse unstacked."""
    jcfg, tcfg, jp, _ = setup(case)
    mine = TLM.init_params(tcfg, seed=0, device="cpu")
    want = {path_str(p): tuple(x.shape)
            for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {p: tuple(x.shape) for p, x in iter_leaves(mine)}
    assert got == want
    g, k = tcfg.num_layers // tcfg.hybrid_attn_every, tcfg.hybrid_attn_every
    assert got["stages/0/mixer/out_proj"][:2] == (g, k)
    assert got["shared_attn/w_fuse"] == (2 * tcfg.d_model, tcfg.d_model)


@pytest.mark.parametrize("case", CASES)
def test_shared_block_matches(case):
    """shared_attn_train, _prefill (output and KV cache) and one _decode
    step, on the model's shared weights and numpy h and emb."""
    jcfg, tcfg, jp, np_params = setup(case)
    tp = tparams(np_params)["shared_attn"]
    rng = np.random.default_rng(3)
    h = rng.standard_normal((B, S + 1, jcfg.d_model)).astype(np.float32)
    e = rng.standard_normal((B, S + 1, jcfg.d_model)).astype(np.float32)
    jh, je = jnp.asarray(h), jnp.asarray(e)
    th, te = torch.from_numpy(h), torch.from_numpy(e)
    a, b = _f32()
    with a, b:
        # the JAX calls jitted, inside the f32 scope
        jtrain = jax.jit(lambda p, x, y: JB.shared_attn_train(p, jcfg, x, y))
        jpre = jax.jit(lambda p, x, y: JB.shared_attn_prefill(p, jcfg, x, y,
                                                              S + 4))
        jdec = jax.jit(lambda p, x, y, c: JB.shared_attn_decode(p, jcfg, x,
                                                                y, c, S))
        _close(TB.shared_attn_train(tp, tcfg, th, te),
               jtrain(jp["shared_attn"], jh, je))
        jo, jc = jpre(jp["shared_attn"], jh[:, :S], je[:, :S])
        to, tc = TB.shared_attn_prefill(tp, tcfg, th[:, :S], te[:, :S],
                                        S + 4)
        _close(to, jo)
        for t, j in zip(tc, jc):
            _close(t, j)
        jo, jc = jdec(jp["shared_attn"], jh[:, S:], je[:, S:], jc)
        to, _ = TB.shared_attn_decode(tp, tcfg, th[:, S:], te[:, S:], tc, S)
        _close(to, jo)
        for t, j in zip(tc, jc):            # written in place
            _close(t, j)


@pytest.mark.parametrize("vector_pos", [False, True],
                         ids=["scalar-pos", "vector-pos"])
@pytest.mark.parametrize("case", CASES)
def test_prefill_decode_match(case, vector_pos):
    """Prefill logits and the nested caches, then 3 decode steps written in
    place, at a scalar pos or a (B,) pos (request 1 three positions
    behind request 0)."""
    jcfg, tcfg, jp, np_params = setup(case)
    tp = tparams(np_params)
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    cs = S + STEPS + 2
    a, b = _f32()
    decode_fn = jax.jit(lambda p, t, c, pos: JLM.decode_step(p, jcfg, t, c,
                                                             pos))
    with a, b:
        jlog, jc = jax.jit(lambda p, t: JLM.prefill(p, jcfg, {"tokens": t},
                                                    cs))(
            jp, jnp.asarray(toks[:, :S]))
        tlog, tc = TLM.prefill(tp, tcfg, {"tokens": torch.from_numpy(
            toks[:, :S])}, cs)
        _close(tlog, jlog)
        _caches_close(tc, jc)
        ssm = tc[0]["mamba"].ssm
        for i in range(STEPS):
            t = toks[:, S + i:S + i + 1]
            pos = np.array([S + i, S + i - 3], np.int32) if vector_pos \
                else S + i
            jlog, jc = decode_fn(jp, jnp.asarray(t), jc, jnp.asarray(pos))
            tlog, tc2 = TLM.decode_step(
                tp, tcfg, torch.from_numpy(t), tc,
                torch.from_numpy(pos) if vector_pos else pos)
            assert tc2 is tc and tc[0]["mamba"].ssm is ssm   # in place
            _close(tlog, jlog)
        _caches_close(tc, jc)


@pytest.mark.parametrize("case", CASES)
def test_caches_cross_both_ways(case):
    """The nested caches through ``bridge``: the JAX prefill's caches
    become the port's types (``params_from_numpy``), and the port's
    prefill caches go back as numpy (``tree_to_numpy``); a decode step
    from either side's caches gives the same logits in both packages."""
    jcfg, tcfg, jp, np_params = setup(case)
    tp = tparams(np_params)
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (B, 9)).astype(np.int32)
    cs, t = 12, toks[:, 8:9]
    a, b = _f32()
    with a, b:
        _, jc = JLM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :8])},
                            cs)
        _, tc = TLM.prefill(tp, tcfg, {"tokens": torch.from_numpy(
            toks[:, :8])}, cs)
        crossed = bridge.params_from_numpy(jax.tree.map(np.asarray, jc),
                                           "cpu")
        assert isinstance(crossed[0]["mamba"], MambaCache)
        assert isinstance(crossed[0]["attn"], KVCache)
        back = jax.tree.map(jnp.asarray, bridge.tree_to_numpy(tc))
        jlog, _ = JLM.decode_step(jp, jcfg, jnp.asarray(t), back, 8)
        tlog, _ = TLM.decode_step(tp, tcfg, torch.from_numpy(t), crossed, 8)
    _close(tlog, jlog)


@pytest.mark.parametrize("case", CASES)
def test_init_cache_and_axes(case):
    """init_cache's nested zeros have the reference's shapes and dtypes;
    cache_batch_axes names batch axis 2 for the (g, k, B, ...) mamba
    leaves and 1 for the (g, B, S, KV, D) attention leaves."""
    jcfg, tcfg, _, _ = setup(case)
    for bsz in (1, 3):
        jz, tz = JLM.init_cache(jcfg, bsz, 16), TLM.init_cache(
            tcfg, bsz, 16, device="cpu")
        for key in ("mamba", "attn"):
            for t, j in zip(tz[0][key], jz[0][key]):
                assert tuple(t.shape) == tuple(j.shape)
                assert str(t.dtype).split(".")[-1] == str(j.dtype)
                assert not bool(t.any())
    (jax_axes,) = JLM.cache_batch_axes(jcfg)
    (axes,) = TLM.cache_batch_axes(tcfg)
    assert axes == {"mamba": MambaCache(*jax_axes["mamba"]),
                    "attn": KVCache(*jax_axes["attn"])}
    assert axes == {"mamba": MambaCache(2, 2, 2), "attn": KVCache(1, 1)}


@pytest.mark.parametrize("case", CASES)
def test_train_loss_gradient_matches(case):
    """train_loss and its gradient in every leaf (the mamba stacks, the
    shared block's leaves summed over their sites, w_fuse, the
    embeddings) against jax.grad of the reference's."""
    jcfg, tcfg, jp, np_params = setup(case)
    tp = tparams(np_params)
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks),
          "labels": torch.from_numpy(toks).long()}
    for _, x in iter_leaves(tp):
        x.requires_grad_(True)
    a, b = _f32()
    with a, b:
        (jl, _), jg = jax.jit(jax.value_and_grad(
            lambda p: JLM.train_loss(p, jcfg, jb), has_aux=True))(jp)
        tl, tm = TLM.train_loss(tp, tcfg, tb)
        tl.backward()
    _close(float(tl.detach()), float(jl))
    assert float(tm["aux"]) == 0.0
    want = {path_str(p): np.asarray(g)
            for p, g in jax.tree_util.tree_flatten_with_path(jg)[0]}
    got = dict(iter_leaves(tp))
    assert set(got) == set(want)
    assert "shared_attn/attn/wq" in want and "shared_attn/w_fuse" in want
    for p, g in want.items():
        top = float(np.abs(g).max())
        np.testing.assert_allclose(got[p].grad.numpy(), g, rtol=0,
                                   atol=GRAD_TOL * max(top, 1e-30),
                                   err_msg=p)


def test_decode_refuses_block_tables():
    """decode_step refuses block tables for the hybrid, with the
    reference's message; the paged caches refuse too."""
    jcfg, tcfg, jp, np_params = setup("smoke")
    tp = tparams(np_params)
    caches = TLM.init_cache(tcfg, 1, 8, device="cpu")
    bt = torch.zeros((1, 2), dtype=torch.int32)
    tok = torch.zeros((1, 1), dtype=torch.long)
    with pytest.raises(NotImplementedError,
                       match="paged decode covers attention caches only"):
        JLM.decode_step(jp, jcfg, jnp.zeros((1, 1), jnp.int32),
                        JLM.init_cache(jcfg, 1, 8), 0,
                        block_tables=jnp.zeros((1, 2), jnp.int32))
    with pytest.raises(NotImplementedError,
                       match="paged decode covers attention caches only"):
        TLM.decode_step(tp, tcfg, tok, caches,
                        torch.zeros(1, dtype=torch.int32), block_tables=bt)
    with pytest.raises(NotImplementedError, match="paged"):
        TLM.init_paged_cache(tcfg, 8, 4, device="cpu")


def test_groups_must_divide_layers():
    """A hybrid stack whose layers are no multiple of hybrid_attn_every
    is refused, as the reference's assert does."""
    with pytest.raises(ValueError, match="hybrid_attn_every"):
        TLM.init_params(get_smoke_config(ARCH).replace(num_layers=3),
                        device="cpu")
