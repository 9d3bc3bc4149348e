"""Serving granite-moe-1b-a400m's smoke config and its GQA variant (shared
experts, a first dense layer) in the port against the JAX package.

Weights are drawn by the JAX package and cross over through
repro_torch.bridge; packs are numpy draws (``_np_packs``). In f32 the
multi-tenant engine's tokens equal the JAX package's switch-per-request
reference, shared experts with a side delta on ``moe/shared/w_up``
included (their flattened (B*S, d) call site recovers the request axis),
and the lane and paged engines give each request its own fixed-batch
tokens: every call here has at most 512 tokens, so no routing choice is
dropped and a request's routes do not depend on its batch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import lm as JLM
from repro.serving.multitenant import switch_per_request_reference
from repro_torch import bridge
from repro_torch.models import layers as TL
from repro_torch.serving import MultiTenantEngine

from test_torch_moe import _np, configs
from test_torch_switching import _np_packs, _to_port


@pytest.mark.parametrize("name", ["granite-moe", "variant"])
def test_multitenant_matches_switch_per_request(name):
    """Tokens of three adapters and the base in one batch equal the JAX
    switch-per-request reference; on the variant the packs put side
    deltas on the shared experts' and the first dense layer's w_up."""
    jcfg, tcfg = configs(name)
    B, S, T = 4, 8, 3
    names = ["a0", "a1", "a2", None]
    with JL.compute_precision(jnp.float32), TL.compute_precision(
            torch.float32):
        params = jax.jit(JLM.init_params, static_argnums=0)(
            jcfg, jax.random.PRNGKey(0))
        packs = _np_packs(params, 3)
        if name == "variant":
            assert any("moe/shared/w_up" in p for p in packs[0].entries)
        toks = np.random.default_rng(2).integers(
            0, jcfg.vocab_size, (B, S)).astype(np.int32)
        want, _, _ = switch_per_request_reference(jcfg, params, packs, toks,
                                                  names, T)
        eng = MultiTenantEngine(tcfg, bridge.params_from_numpy(
            _np(params), "cpu"))
        for p in packs:
            eng.register(_to_port(p))
        got, _ = eng.generate({"tokens": torch.from_numpy(toks)}, names, T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("engine", ["lanes", "pages"])
def test_engines_match_fixed_batch(engine):
    """The lane and paged engines over the variant (shared experts with
    side deltas, a first dense layer): each request's tokens equal its
    own fixed-batch tokens (every call here is drop-free), with prompts
    of several lengths, an adapter stack and the base model."""
    from repro_torch.hub import PagedServingEngine, ServingEngine
    jcfg, tcfg = configs("variant")
    params = jax.jit(JLM.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    packs = [_to_port(p) for p in _np_packs(params, 2)]
    tparams = bridge.params_from_numpy(_np(params), "cpu")
    rng = np.random.default_rng(6)
    trace = [(rng.integers(0, tcfg.vocab_size, n).astype(np.int32), a)
             for n, a in ((5, "a0"), (9, None), (3, ("a0", "a1")), (7, "a1"),
                          (11, "a0"))]
    T = 4
    with TL.compute_precision(torch.float32):
        mt = MultiTenantEngine(tcfg, tparams)
        for p in packs:
            mt.register(p)
        want = [mt.generate({"tokens": torch.from_numpy(p[None].astype(
            np.int64))}, [a], T)[0][0].numpy() for p, a in trace]
        eng = (ServingEngine(tcfg, tparams, slots=2, cache_size=24)
               if engine == "lanes" else
               PagedServingEngine(tcfg, tparams, slots=2, num_pages=24,
                                  page_size=4, chunk_size=4))
        for p in packs:
            eng.register(p)
        futs = [eng.submit(p, a, max_tokens=T) for p, a in trace]
        eng.run()
    for i, (f, w) in enumerate(zip(futs, want)):
        np.testing.assert_array_equal(f.result(), w, err_msg=f"{i}")
