"""The adapter kinds beyond SHiRA in repro_torch against repro: LoRA, DoRA
and SHiRA-masked DoRA (materialize and its gradients, %C), the LoRA fuse
(``LoraEngine``), the training CLI's adapter specs, and the trainers'
refusals. Their Trainer runs, full finetuning's and hook mode with weight
decay are in tests/test_torch_trainer_kinds.py.

The JAX smoke config's base, its adapter factors and its wm indices cross
over through numpy (``bridge.params_from_numpy``, ``Trainer(trainable0=,
aux=)``): the reference seeds each leaf's LoRA ``A`` with Python's
per-process ``hash`` of the path, which no other process can redraw. Both
packages run in f32 (``compute_precision``).

Tolerances: the effective weights agree to 1e-6 (f32: the same products
in another order); the gradients of A, B and m to 1e-5 of each leaf's
largest (through two layers and the chunked loss); the fused weights to
1e-6 and the unfused to 1e-5 of the largest (the reference's restore
tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import AdapterConfig as JAdapterConfig
from repro.configs import RunConfig as JRunConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.data import batch_iterator as j_batches
from repro.launch import train as jlaunch
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.training import MultiAdapterTrainer as JMulti
from repro_torch import bridge
from repro_torch import core as tcore
from repro_torch.configs import (AdapterConfig, RunConfig, ShapeSpec,
                                 TrainConfig, get_smoke_config)
from repro_torch.core.adapters import bundle_layers
from repro_torch.core.masks import iter_leaves
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.runtime.trainer import device_batch
from repro_torch.training import MultiAdapterTrainer

KINDS = ["lora", "dora", "shira-dora"]
STEPS, LR = 3, 1e-2
EFF_TOL, GRAD_TOL = 1e-6, 1e-5


def _adapter(kind, **kw):
    return dict(kind=kind, mask="wm", sparsity=0.95, rank=4, **kw)


def _runs(kind, packed=True, wd=0.0):
    adapter = _adapter(kind, packed=packed)
    train = dict(learning_rate=LR, total_steps=STEPS + 2, warmup_steps=2,
                 weight_decay=wd)
    jrun = JRunConfig(model=j_smoke("starcoder2-7b"),
                      shape=JShapeSpec("tiny", 8, 4, "train"),
                      adapter=JAdapterConfig(**adapter),
                      train=JTrainConfig(**train))
    trun = RunConfig(model=get_smoke_config("starcoder2-7b"),
                     shape=ShapeSpec("tiny", 8, 4, "train"),
                     adapter=AdapterConfig(**adapter),
                     train=TrainConfig(**train))
    return jrun, trun


def _flat(tree):
    return {jcore.masks.path_str(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def base():
    jbase = jax.jit(JLM.init_params, static_argnums=0)(
        j_smoke("starcoder2-7b"), jax.random.PRNGKey(0))
    return jbase, jax.tree.map(np.asarray, jbase)


def _factors(jbase, kind):
    """The JAX adapter tree of ``kind`` (its paths and shapes), with every
    factor drawn from numpy over the sorted leaf paths, as numpy: A at its
    init's scale (normal / sqrt(n)), B nonzero, m off the base's column
    norm. The reference's own A draws are salted by Python's per-process
    ``hash`` of the path, so they differ from process to process; these
    are the same in every process."""
    jrun, trun = _runs(kind)
    t, aux = jcore.init_adapter(jax.random.PRNGKey(0), jbase, jrun.adapter)
    init = _flat(t)
    rng = np.random.default_rng(1)
    drawn = {}
    for p in sorted(init):
        x = init[p]
        noise = 0.05 * rng.standard_normal(x.shape)
        if p.endswith("/A"):
            drawn[p] = rng.standard_normal(x.shape) / np.sqrt(x.shape[-2])
        elif p.endswith("/B"):
            drawn[p] = noise
        else:                               # m: the column norm, moved
            drawn[p] = x + noise
        drawn[p] = drawn[p].astype(np.float32)
    t = jax.tree_util.tree_map_with_path(
        lambda p, _: drawn[jcore.masks.path_str(p)], t)
    return jrun, trun, t, aux


def _port_eff(trun, np_base, t, aux):
    base = bridge.params_from_numpy(np_base, "cpu")
    paux = (None if aux is None else bridge.adapter_from_numpy(
        jax.tree.map(np.asarray, aux["indices"]), "cpu")[1])
    eff = tcore.materialize(base, bridge.params_from_numpy(t, "cpu"), paux,
                            trun.adapter, alpha=1.0)
    return base, paux, eff


@pytest.mark.parametrize("kind", KINDS)
def test_materialize_matches_jax(base, kind):
    jbase, np_base = base
    jrun, trun, t, aux = _factors(jbase, kind)
    want = _flat(jcore.materialize(jbase, jax.tree.map(jnp.asarray, t), aux,
                                   jrun.adapter, alpha=1.0))
    _, _, eff = _port_eff(trun, np_base, t, aux)
    nb = 0
    for p, w in iter_leaves(bridge.params_from_numpy(np_base, "cpu")):
        node = eff
        for k in p.split("/"):
            node = node[int(k)] if isinstance(node, list) else node[k]
        if tcore.adapters.is_bundle(node):
            nb += 1
            got = torch.stack(list(bundle_layers(node))).reshape(w.shape)
        else:
            got = node
        np.testing.assert_allclose(got.numpy(), want[p], rtol=0,
                                   atol=EFF_TOL, err_msg=p)
    assert nb == 6     # the smoke model's targets: wq wk wv wo w_up w_down


@pytest.mark.parametrize("kind", KINDS)
def test_factor_grads_match_jax(base, kind):
    jbase, np_base = base
    jrun, trun, t, aux = _factors(jbase, kind)
    batch = next(j_batches(jrun.model, jrun.shape, seed=3))
    with JL.compute_precision(jnp.float32):
        def jloss(tt):
            eff = jcore.materialize(jbase, tt, aux, jrun.adapter, alpha=1.0)
            return JLM.train_loss(eff, jrun.model, {
                k: jnp.asarray(v) for k, v in batch.items()})[0]
        loss, grads = jax.jit(jax.value_and_grad(jloss))(
            jax.tree.map(jnp.asarray, t))
    want = _flat(grads)
    tb = bridge.params_from_numpy(t, "cpu")
    leaves = [(p, v.requires_grad_(True)) for p, v in iter_leaves(tb)]
    paux = (None if aux is None else bridge.adapter_from_numpy(
        jax.tree.map(np.asarray, aux["indices"]), "cpu")[1])
    with TL.compute_precision(torch.float32):
        eff = tcore.materialize(bridge.params_from_numpy(np_base, "cpu"), tb,
                                paux, trun.adapter, alpha=1.0)
        got, _ = TLM.train_loss(eff, trun.model, device_batch(batch, "cpu"))
        g = torch.autograd.grad(got, [v for _, v in leaves])
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    assert sorted(p for p, _ in leaves) == sorted(want)
    names = {p.rsplit("/", 1)[1] for p, _ in leaves}
    assert names == ({"A", "B"} if kind == "lora" else {"A", "B", "m"})
    for (p, _), gp in zip(leaves, g):
        scale = np.abs(want[p]).max()
        assert scale > 0, p
        np.testing.assert_allclose(gp.numpy(), want[p], rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=p)


def test_shira_dora_changes_only_masked_entries(base):
    """%C of SHiRA-DoRA stays sparse (tests/test_adapters.py); LoRA's
    covers the targets."""
    jbase, np_base = base
    for kind, ok in (("shira-dora", lambda c: c < 0.2),
                     ("lora", lambda c: c > 0.5)):
        jrun, trun, t, aux = _factors(jbase, kind)
        pbase, _, eff = _port_eff(trun, np_base, t, aux)
        c = tcore.changed_fraction(pbase, eff)
        jeff = jcore.materialize(jbase, jax.tree.map(jnp.asarray, t), aux,
                                 jrun.adapter)
        assert c == pytest.approx(jcore.switching.changed_fraction(
            jbase, jeff), abs=1e-3), kind
        assert ok(c), (kind, c)


def test_lora_engine_fuse_matches_jax_and_keeps_structure():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 8, 6)).astype(np.float32)
    a = rng.standard_normal((3, 8, 2)).astype(np.float32)
    b = rng.standard_normal((3, 2, 6)).astype(np.float32)
    tree = lambda x, y: {"stages": ({"wq": x}, {"wq": y}), "aux": [y]}
    lora = {"stages/0/wq": {"A": a, "B": b}}
    jeng = jcore.LoraEngine(tree(jnp.asarray(w), jnp.ones((4, 4))))
    jeng.fuse({k: {n: jnp.asarray(x) for n, x in v.items()}
               for k, v in lora.items()}, scale=0.5)
    params = tree(torch.from_numpy(w.copy()), torch.ones(4, 4))
    eng = tcore.LoraEngine(params)
    assert eng.fuse({k: {n: torch.from_numpy(x) for n, x in v.items()}
                     for k, v in lora.items()}, scale=0.5) >= 0
    assert eng.params is params                      # in place
    assert isinstance(eng.params["stages"], tuple)
    assert isinstance(eng.params["aux"], list)
    np.testing.assert_allclose(eng.params["stages"][0]["wq"].numpy(),
                               np.asarray(jeng.params["stages"][0]["wq"]),
                               rtol=0, atol=1e-6)
    assert torch.equal(eng.params["stages"][1]["wq"], torch.ones(4, 4))
    eng.unfuse()
    assert eng.active is None and eng.unfuse() == 0.0
    np.testing.assert_allclose(eng.params["stages"][0]["wq"].numpy(), w,
                               rtol=0, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("spec", ["none", "lora", "dora", "shira-dora",
                                  "shira-dora-rand", "shira", "shira-rand",
                                  "shira-struct-hook", "nope"])
def test_parse_adapter_every_spec(spec):
    if spec == "nope":
        for parse in (jlaunch.parse_adapter, tlaunch.parse_adapter):
            with pytest.raises(ValueError):
                parse(spec)
        return
    want = jlaunch.parse_adapter(spec)
    got = tlaunch.parse_adapter(spec)
    for f in ("kind", "mask", "rank", "packed", "sparsity"):
        assert getattr(got, f) == getattr(want, f), (spec, f)


@pytest.mark.parametrize("kind", ["lora", "shira-hook"])
def test_multi_adapter_trainer_refuses_in_both_packages(kind):
    kw = (dict(kind="shira", packed=False) if kind == "shira-hook"
          else dict(kind=kind))
    jrun, trun = _runs("shira")
    for multi, run, cfg in (
            (JMulti, jrun, JAdapterConfig(**kw)),
            (MultiAdapterTrainer, trun, AdapterConfig(**kw))):
        other = type(run)(model=run.model, shape=run.shape, adapter=cfg,
                          train=run.train)
        with pytest.raises(ValueError, match="packed-SHiRA only"):
            multi(other, ["a0"], **({"device": "cpu"}
                                    if multi is MultiAdapterTrainer else {}))
