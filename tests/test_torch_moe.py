"""repro_torch.models.moe and the MoE model against repro on the same
numbers.

Weights are drawn by the JAX package and cross over through
repro_torch.bridge; activations are numpy draws from a seed. In f32
(``compute_precision``) the FFN's output and aux loss agree to 1e-5 (f32
products summed in another order), and the routes (top_i) and the
capacity slots are equal exactly: with drops (T = 1100 tokens, capacity
factor 0.5), on planted ties in the router's logits (bf16 and f32), with
shared experts and behind a first dense layer. The reference's routes are
recorded from its own ``lax.top_k`` calls, and its slots follow
``repro/models/moe.py``'s loop over choices.

Expert leaves (L, E, n, m) as targets behave as the reference's: packs
load and unload, and the multi-tenant engine refuses them at register
(the reference registers them and fails in ``generate``). Serving is
held in test_torch_moe_serving.py, the trainers in
test_torch_moe_train.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import AdapterConfig as JAdapterConfig
from repro.configs import get_smoke_config as j_smoke
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.models import moe as JMOE
from repro.serving import MultiTenantEngine as JEngine
from repro_torch import bridge
from repro_torch import core as tcore
from repro_torch.configs import AdapterConfig, get_smoke_config
from repro_torch.core.masks import iter_leaves
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from repro_torch.serving import MultiTenantEngine


ARCH = "granite-moe-1b-a400m"
F32_TOL = 1e-5
BF16_TOL = 2e-2            # y in bf16: a few bf16 roundings of ~1 values
TRAJ_TOL = dict(rtol=5e-3, atol=5e-3)
EXPERT_TARGETS = ("wq", "experts_w_up", "experts_w_gate", "experts_w_down")


def variant(pkg_cfg, moe_cls):
    """The GQA variant of the smoke config: two shared experts and one
    first dense layer of its own width (deepseek-v2-lite's MoE layout
    without MLA)."""
    return pkg_cfg.replace(moe=moe_cls(
        num_experts=4, top_k=2, d_ff=32, num_shared=2, first_dense_layers=1,
        first_dense_d_ff=48, capacity_factor=1.25))


def configs(name):
    """(JAX config, port config) of a case."""
    j, t = j_smoke(ARCH), get_smoke_config(ARCH)
    if name == "variant":
        return (variant(j, type(j.moe)), variant(t, type(t.moe)))
    if name == "drops":
        return (j.replace(moe=dataclasses.replace(j.moe, capacity_factor=0.5)),
                t.replace(moe=dataclasses.replace(t.moe, capacity_factor=0.5)))
    return j, t


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def ref_slots(top_i, E, capacity):
    """The reference's slots, (k, T): repro/models/moe.py's loop over
    choices, in numpy."""
    counts = np.zeros(E, np.int64)
    slots = []
    for j in range(top_i.shape[1]):
        e_j = top_i[:, j]
        oh = np.eye(E, dtype=np.int64)[e_j]
        pos = np.take_along_axis(np.cumsum(oh, 0) - oh, e_j[:, None],
                                 1)[:, 0] + counts[e_j]
        counts += oh.sum(0)
        slots.append(np.where(pos < capacity, pos, capacity))
    return np.stack(slots)


def _ref_moe(jp, jcfg, x, monkeypatch):
    """The reference's (y, aux, top_i), its routes the output of the
    ``lax.top_k`` call it makes, returned from the jitted call."""
    real = jax.lax.top_k

    def run(p, xx):
        seen = []

        def record(v, k):
            out = real(v, k)
            seen.append(out[1])
            return out
        monkeypatch.setattr(jax.lax, "top_k", record)
        y, aux = JMOE.moe_ffn(p, jcfg, xx)
        monkeypatch.setattr(jax.lax, "top_k", real)
        assert len(seen) == 1
        return y, aux, seen[0]
    y, aux, top_i = jax.jit(run)(jp, jnp.asarray(x))
    return np.asarray(y, np.float32), float(aux), np.asarray(top_i)


def _port_moe(tp, tcfg, x):
    xt = torch.from_numpy(x.copy())
    with TMOE.count_drops() as drops:
        y, aux = TMOE.moe_ffn(tp, tcfg, xt)
    T = x.shape[0] * x.shape[1]
    logits = TL.dense(xt.reshape(T, -1), tp["w_router"]).float()
    _, top_i, slots, _ = TMOE.route(logits, tcfg.moe.top_k,
                                    TMOE.expert_capacity(tcfg.moe, T))
    return (y.float().numpy(), float(aux), top_i.numpy(), slots.numpy(),
            int(sum(drops)))


def planted_ties(jp, d, rng, B, S):
    """A router whose columns repeat (0 = 3, 1 = 2) with entries in
    {-0.5, 0, 0.5}, and integer activations in [-2, 2]: every logit is a
    multiple of 0.5 below 128, exact in bf16 and f32 in both packages,
    and every token's probabilities tie in pairs."""
    w = rng.choice([-0.5, 0.0, 0.5], (d, 2)).astype(np.float32)
    jp = dict(jp, w_router=jnp.asarray(w[:, [0, 1, 1, 0]]))
    x = rng.integers(-2, 3, (B, S, d)).astype(np.float32)
    return jp, x


def _moe_case(case, monkeypatch):
    rng = np.random.default_rng(0)
    jcfg, tcfg = configs("variant" if case in ("shared", "first_dense")
                         else case)
    d = jcfg.d_model
    if case == "first_dense":
        # the MoE layer's own input: the output of the first dense layer
        params = jax.jit(JLM.init_params, static_argnums=0)(
            jcfg, jax.random.PRNGKey(0))
        h = jnp.asarray(rng.standard_normal((2, 8, d)).astype(np.float32))
        first = jax.tree.map(lambda a: a[0], params["stages"][0])
        h, _ = jax.jit(lambda p, hh: JB.dense_block_train(p, jcfg, hh))(
            first, h)
        moe_layer = jax.tree.map(lambda a: a[0], params["stages"][1])
        x = np.asarray(JL.rms_norm(h, moe_layer["mlp_norm"]["scale"],
                                   jcfg.norm_eps), np.float32)
        jp = moe_layer["moe"]
    else:
        jp = jax.jit(JMOE.init_moe, static_argnums=1)(jax.random.PRNGKey(1),
                                                      jcfg)
        B, S = (2, 550) if case == "drops" else (2, 8)
        if case.startswith("ties"):
            jp, x = planted_ties(jp, d, rng, B, 4 * S)
        else:
            x = rng.standard_normal((B, S, d)).astype(np.float32)
    return jcfg, tcfg, jp, bridge.params_from_numpy(_np(jp), "cpu"), x


@pytest.mark.parametrize("case", ["drops", "ties-f32", "ties-bf16", "shared",
                                  "first_dense"])
def test_moe_ffn_matches_jax(case, monkeypatch):
    bf16 = case == "ties-bf16"
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    with JL.compute_precision(jdt), TL.compute_precision(tdt):
        jcfg, tcfg, jp, tp, x = _moe_case(case, monkeypatch)
        y_ref, aux_ref, top_ref = _ref_moe(jp, jcfg, x, monkeypatch)
        y, aux, top_i, slots, dropped = _port_moe(tp, tcfg, x)
    T = x.shape[0] * x.shape[1]
    capacity = TMOE.expert_capacity(tcfg.moe, T)
    want_slots = ref_slots(top_ref, jcfg.moe.num_experts, capacity)
    np.testing.assert_array_equal(top_i, top_ref)
    np.testing.assert_array_equal(slots, want_slots)
    assert dropped == int((want_slots == capacity).sum())
    assert (dropped > 0) == (case == "drops"), dropped
    tol = BF16_TOL if bf16 else F32_TOL
    np.testing.assert_allclose(y, y_ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(aux, aux_ref, rtol=F32_TOL)
    if case.startswith("ties"):
        # a token's two choices that tie (experts 0 and 3, or 1 and 2)
        # list the lower index first
        tied = top_i[:, 0] + top_i[:, 1] == 3
        assert tied.sum() > 10, tied.sum()
        assert (top_i[tied, 0] < top_i[tied, 1]).all()


def test_top_k_tie_order_is_lax_top_k():
    """Planted ties, several ways: the port's top_k gives lax.top_k's
    values and indices (the lower index first among equals)."""
    rng = np.random.default_rng(3)
    probs = rng.choice([0.1, 0.2, 0.3], (64, 32)).astype(np.float32)
    probs[0] = 0.25
    for k in (1, 2, 8, 32):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = TMOE.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("T", [1, 7, 100, 512, 513, 1100, 2048, 4100])
def test_capacity_is_the_reference_formula(T):
    """Python's round (half to even) of the reference's float: T = 4100 at
    cf 1.25, k 8, E 32 gives 1281.25; 100 at cf 0.5, k 2, E 4 gives 25;
    T = 1100 at cf 0.5 gives 275 against the 512 floor."""
    for m in (get_smoke_config(ARCH).moe, configs("drops")[1].moe,
              dataclasses.replace(get_smoke_config(ARCH).moe, num_experts=32,
                                  top_k=8)):
        want = int(max(round(m.capacity_factor * T * m.top_k
                             / m.num_experts), min(T, 512)))
        assert TMOE.expert_capacity(m, T) == want
    assert TMOE.expert_capacity(configs("drops")[1].moe, 1100) == 512


def test_flattened_token_side_delta():
    """A side-delta bundle at a flattened (B*S, d) call site (the shared
    experts') gives the (B, S, d) call's rows; T % B != 0 raises."""
    rng = np.random.default_rng(5)
    B, S, n, m, A, K = 3, 4, 16, 12, 2, 9
    base = torch.from_numpy(rng.standard_normal((n, m)).astype(np.float32))
    packs = [tcore.AdapterPack(f"a{a}", {"w": (
        torch.from_numpy(np.sort(rng.choice(n * m, K, replace=False))
                         .astype(np.int32)),
        torch.from_numpy(rng.standard_normal(K).astype(np.float32)))})
        for a in range(A)]
    from repro_torch.kernels.ops import sidedelta_table
    t = sidedelta_table([(p.entries["w"][0][None], p.entries["w"][1][None])
                         for p in packs], 1, n, m)
    w = TL.sidedelta_weight(base, t["rows"][0], t["vals"][0],
                            t["colptr"][0],
                            torch.tensor([1, -1, 0], dtype=torch.int32))
    x = torch.from_numpy(rng.standard_normal((B, S, n)).astype(np.float32))
    with TL.compute_precision(torch.float32):
        want = TL.pdot(x, w)
        got = TL.pdot(x.reshape(B * S, n), w)
        np.testing.assert_array_equal(got.numpy(), want.reshape(B * S, m)
                                      .numpy())
        with pytest.raises(ValueError, match="divisible"):
            TL.pdot(x.reshape(B * S, n)[:-1], w)


# ---------------------------------------------------------------------------
# Expert leaves as targets
# ---------------------------------------------------------------------------

def test_expert_packs_switch_and_refuse_side_deltas():
    """Packs on the (L, E, n, m) expert leaves: (L, E, K) indices from
    init_adapter in both packages; SwitchEngine.load gives the JAX
    apply_pack's weights and unload restores the base; the multi-tenant
    engine refuses the pack at register with a ValueError naming the
    leaf, where the reference registers it and fails in generate."""
    jcfg, tcfg = configs("granite-moe")
    acfg = dict(kind="shira", mask="wm", sparsity=0.9,
                target_modules=EXPERT_TARGETS)
    jparams = jax.jit(JLM.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    np_params = _np(jparams)
    _, jaux = jcore.init_adapter(jax.random.PRNGKey(0), jparams,
                                 JAdapterConfig(**acfg))
    tparams = bridge.params_from_numpy(np_params, "cpu")
    _, taux = tcore.init_adapter(None, tparams, AdapterConfig(**acfg))
    shapes = {p: tuple(i.shape) for p, i in iter_leaves(taux["indices"])}
    E = jcfg.moe.num_experts
    assert shapes["stages/0/moe/experts_w_up"][:2] == (2, E)
    jshapes = {jcore.masks.path_str(p): i.shape for p, i in
               jax.tree_util.tree_flatten_with_path(jaux["indices"])[0]}
    assert jshapes == shapes
    rng = np.random.default_rng(4)
    entries = {p: (np.asarray(i), (0.05 * rng.standard_normal(i.shape))
                   .astype(np.float32))
               for p, i in iter_leaves(taux["indices"])}
    jpack = jcore.AdapterPack("e", {p: (jnp.asarray(i), jnp.asarray(v))
                                    for p, (i, v) in entries.items()})
    want = _np(jcore.apply_pack(jparams, jpack))
    tpack = bridge.pack_from_numpy("e", entries, device="cpu")
    eng = tcore.SwitchEngine(tparams)
    eng.load(tpack)
    wflat = {jcore.masks.path_str(p): x for p, x in
             jax.tree_util.tree_flatten_with_path(want)[0]}
    for p, x in iter_leaves(eng.params):
        np.testing.assert_array_equal(x.numpy(), wflat[p], err_msg=p)
    eng.unload()
    for p, x in iter_leaves(eng.params):
        base = {jcore.masks.path_str(q): y for q, y in
                jax.tree_util.tree_flatten_with_path(np_params)[0]}[p]
        np.testing.assert_allclose(x.numpy(), base, atol=1e-5, err_msg=p)

    mt = MultiTenantEngine(tcfg, bridge.params_from_numpy(np_params, "cpu"))
    with pytest.raises(ValueError, match="experts_w_"):
        mt.register(tpack)
    jeng = JEngine(jcfg, jparams, interpret=False)
    jeng.register(jpack)
    toks = jnp.zeros((1, 4), jnp.int32)
    with pytest.raises(AttributeError, match="astype"):
        jeng.generate({"tokens": toks}, ["e"], 2)


@pytest.mark.parametrize("case", ["drops", "ties-bf16"])
def test_record_routes_holds_each_calls_routing(case, monkeypatch):
    """``record_routes`` keeps each call's router input, weight, logits
    and chosen experts: the experts the reference chose, the logits the
    router's product of the recorded input and weight; the dense and the
    expert-parallel dispatch record the same; nothing is recorded outside
    the context."""
    from repro_torch.launch.actctx import sharding_hints
    from repro_torch.launch.mesh import abstract_mesh
    bf16 = case == "ties-bf16"
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    with JL.compute_precision(jdt), TL.compute_precision(tdt):
        jcfg, tcfg, jp, tp, x = _moe_case(case, monkeypatch)
        _, _, top_ref = _ref_moe(jp, jcfg, x, monkeypatch)
        xt = torch.from_numpy(x.copy())
        with TMOE.record_routes() as calls:
            TMOE.moe_ffn(tp, tcfg, xt)
            with sharding_hints(moe_ep_mesh=(abstract_mesh(
                    (1, 1), ("data", "model")), 1)):
                TMOE.moe_ffn(tp, tcfg, xt)
        TMOE.moe_ffn(tp, tcfg, xt)
    assert len(calls) == 2
    T = x.shape[0] * x.shape[1]
    for c in calls:
        assert c["x"].dtype == tdt and c["x"].shape == (T, jcfg.d_model)
        np.testing.assert_array_equal(c["top_i"].numpy(), top_ref)
        with TL.compute_precision(tdt):
            want = TL.dense(c["x"], c["w"]).float()
        assert torch.equal(c["logits"], want)
        assert torch.equal(c["x"], xt.reshape(T, -1).to(tdt))
