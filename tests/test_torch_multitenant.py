"""repro_torch.serving.MultiTenantEngine against the JAX engine
(``MultiTenantEngine(cfg, params, interpret=False)``, the compiled XLA
side delta) on the same weights, packs and prompts, in f32.

Greedy tokens must be equal and last-step logits agree to 1e-4: the side
delta is summed in another order (per column here, per one-hot tile
there). The port's engine is also held against its own sequential
reference, which serves each request alone after a rapid switch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core.switching import FusedLRU as JFusedLRU
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.serving import MultiTenantEngine as JEngine
from repro.serving.multitenant import greedy_decode as j_greedy
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.switching import FusedLRU
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.serving import MultiTenantEngine
from repro_torch.serving.multitenant import (greedy_decode,
                                             switch_per_request_reference)

from test_torch_switching import _np_packs, _to_port

TOL = 1e-4
S, T = 8, 4


@pytest.fixture(scope="module")
def setup():
    with JL.compute_precision(jnp.float32):
        cfg = j_smoke("starcoder2-7b")
        params = JLM.init_params(cfg, jax.random.PRNGKey(0))
        packs = _np_packs(params, 3)
    return cfg, params, packs


def _jax_run(cfg, params, packs, toks, names, table_dtype, scheduler):
    with JL.compute_precision(jnp.float32):
        eng = JEngine(cfg, params, interpret=False, table_dtype=table_dtype,
                      scheduler=scheduler)
        for p in packs:
            eng.register(p)
        batch = {"tokens": jnp.asarray(toks)}
        out, _ = eng.generate(batch, names, T)
        p = eng.wrapped_params(eng.ids_for(names))
        _, logits = j_greedy(cfg, batch, T,
                             lambda b: eng._prefill(p, b, S + T + 8),
                             lambda t, c, pos: eng._decode(p, t, c, pos))
        return np.asarray(out), np.asarray(logits, np.float32), eng.fused


def _port_engine(params, packs, table_dtype, scheduler):
    cfg = t_smoke("starcoder2-7b")
    eng = MultiTenantEngine(cfg, bridge.params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu"),
        table_dtype=table_dtype, scheduler=scheduler)
    for p in packs:
        eng.register(_to_port(p))
    return cfg, eng


def _port_run(params, packs, toks, names, table_dtype, scheduler):
    with TL.compute_precision(torch.float32):
        cfg, eng = _port_engine(params, packs, table_dtype, scheduler)
        batch = {"tokens": torch.from_numpy(toks)}
        out, _ = eng.generate(batch, names, T)
        p = eng.wrapped_params(eng.ids_for(names))
        _, logits = greedy_decode(
            cfg, batch, T, lambda b: TLM.prefill(p, cfg, b, S + T + 8),
            lambda t, c, pos: TLM.decode_step(p, cfg, t, c, pos))
        return out.numpy(), logits.numpy(), eng


CASES = {
    "mixed": (["a0", "a2", None, "a1", "a0"], "f32", False),
    "stack": ([("a0", "a1"), "a2", None, ("a1", "a0")], "f32", False),
    "int8": (["a0", "a2", None, "a1", "a0"], "int8", False),
    "fused_hot_int8": (["a0", "a0", "a0", "a1", None], "int8", True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax_engine(setup, case):
    cfg, params, packs = setup
    names, table_dtype, fuse = CASES[case]
    toks = np.random.default_rng(len(case)).integers(
        0, cfg.vocab_size, (len(names), S)).astype(np.int32)
    # a promotion at the first batch: a0's share 0.5 * 3/5 >= 0.3
    sched = (lambda cls: cls(promote_at=0.3, demote_at=0.1)) if fuse else (
        lambda cls: None)
    j_out, j_logits, j_fused = _jax_run(cfg, params, packs, toks, names,
                                        table_dtype, sched(JFusedLRU))
    t_out, t_logits, eng = _port_run(params, packs, toks, names,
                                     table_dtype, sched(FusedLRU))
    assert eng.fused == j_fused == ("a0" if fuse else None)
    np.testing.assert_array_equal(t_out, j_out)
    np.testing.assert_allclose(t_logits, j_logits, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("fuse", [False, True])
def test_engine_matches_switch_reference(setup, fuse):
    """Batched side deltas equal serving each request alone after a rapid
    switch; the fused engine's close() restores the shared base."""
    cfg, params, packs = setup
    names = ["a0", "a2", None, "a1", "a0"]
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (len(names), S)).astype(np.int32))
    with TL.compute_precision(torch.float32):
        tcfg, eng = _port_engine(params, packs, "f32", None)
        base = {k: v.clone() for k, v in eng.shared["stages"][0]["mlp"]
                .items()}
        if fuse:
            eng._promote("a0")
        out, _ = eng.generate({"tokens": toks}, names, T)
        eng.close()
        for k, v in base.items():
            torch.testing.assert_close(eng.shared["stages"][0]["mlp"][k], v,
                                       atol=1e-5, rtol=0)
        ref, _, _ = switch_per_request_reference(
            tcfg, eng.shared, [_to_port(p) for p in packs], toks, names, T)
    assert eng.fuse_transitions == (2 if fuse else 0)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


def test_table_nbytes_int8_smaller(setup):
    _, params, packs = setup
    _, f32 = _port_engine(params, packs, "f32", None)
    _, int8 = _port_engine(params, packs, "int8", None)
    a, b = f32.table_nbytes(), int8.table_nbytes()
    assert b["vals"] * 4 == a["vals"] and b["rows"] * 2 == a["rows"]
    assert b["total"] < a["total"]


def test_unknown_adapter_rejected(setup):
    _, params, packs = setup
    _, eng = _port_engine(params, packs, "f32", None)
    with pytest.raises(KeyError, match="zz"):
        eng.ids_for(["a0", "zz"])
    with pytest.raises(ValueError, match="table_dtype"):
        MultiTenantEngine(t_smoke("starcoder2-7b"), eng.shared,
                          table_dtype="f16")


def test_reregister_fused_adapter_demotes_first(setup):
    """Replacing a fused adapter un-fuses the old delta, so the base comes
    back clean and the scheduler may promote the new pack."""
    _, params, packs = setup
    _, eng = _port_engine(params, packs, "f32", FusedLRU(promote_at=0.3))
    base = eng.shared["stages"][0]["mlp"]["w_up"].clone()
    eng.schedule(["a0"] * 4)
    assert eng.fused == "a0" and eng.scheduler.fused == "a0"
    eng.register(_to_port(packs[0]))
    assert eng.fused is None and eng.scheduler.fused is None
    torch.testing.assert_close(eng.shared["stages"][0]["mlp"]["w_up"], base,
                               atol=1e-5, rtol=0)


def test_idle_stack_is_retired(setup):
    _, params, packs = setup
    _, eng = _port_engine(params, packs, "f32", None)
    eng.ids_for([("a0", "a1"), None])
    assert ("a0", "a1") in eng._slots
    for _ in range(eng.stack_ttl + 1):
        eng.ids_for([None])
    assert ("a0", "a1") not in eng._stacks
    assert ("a0", "a1") not in eng._slots
