"""remat="dots" in the port against "full" and the JAX package, and the
launch entry points on the architectures since the MoE slice.

remat="dots" keeps the outputs of the 2-D-weight products and recomputes
the rest; the loss and the gradients of packed SHiRA values (through
``core.materialize``'s ``_Materialize``) and of a multi-adapter trainer's
values (through ``sidedelta_train``) equal remat="full"'s to 1e-6 of the
largest, and the JAX package's "dots" within 1e-6, in f32 (losses ~5 and
gradients ~1e-2 here: the two frameworks' sums in another order differ by
under 5e-7 in the loss and ~1e-8 in a gradient). ``launch.serve`` (with
``--layers``) and ``launch.train`` take the ids ported since the MoE
slice with ``--smoke --device cpu``; for hubert-xlarge, encoder only,
the serve CLI exits with the reference's message.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import AdapterConfig as JAdapterConfig
from repro.core.masks import path_str
from repro.models import layers as JL
from repro.models import lm as JLM
from repro_torch import bridge
from repro_torch import core as tcore
from repro_torch.configs import (AdapterConfig, RunConfig, ShapeSpec,
                                 TrainConfig, get_smoke_config)
from repro_torch.core.masks import iter_leaves
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.training import MultiAdapterTrainer

from test_torch_archs import NEW, setup

DOTS_TOL = 1e-6


def _max_rel(a, b):
    return float(np.abs(a - b).max()) / float(np.abs(b).max())


@pytest.mark.parametrize("case", ["granite-moe-1b-a400m", "moe-variant",
                                  "granite-34b"])
def test_remat_dots_packed_shira(case):
    """Loss and packed-value gradients through materialize: dots equals
    full in the port, and the JAX package's dots."""
    jcfg, tcfg, jp, tp, toks = setup(case)
    acfg = dict(kind="shira", mask="wm", sparsity=0.9)
    _, jaux = jcore.init_adapter(jax.random.PRNGKey(0), jp,
                                 JAdapterConfig(**acfg))
    rng = np.random.default_rng(2)
    np_vals = jax.tree.map(
        lambda i: (0.05 * rng.standard_normal(i.shape)).astype(np.float32),
        jax.tree.map(np.asarray, jaux["indices"]))
    batch = {"tokens": toks, "labels": toks}
    with JL.compute_precision(jnp.float32):
        def jloss(vals):
            eff = jcore.materialize(jp, vals, jaux, JAdapterConfig(**acfg),
                                    alpha=1.0)
            return JLM.train_loss(eff, jcfg.replace(remat="dots"), {
                k: jnp.asarray(v) for k, v in batch.items()})[0]
        jl, jg = jax.jit(jax.value_and_grad(jloss))(
            jax.tree.map(jnp.asarray, np_vals))
    jg = {path_str(p): np.asarray(g) for p, g in
          jax.tree_util.tree_flatten_with_path(jg)[0]}
    taux = bridge.adapter_from_numpy(jax.tree.map(np.asarray,
                                                  jaux["indices"]), "cpu")[1]
    out = {}
    for remat in ("full", "dots"):
        vals = bridge.params_from_numpy(np_vals, "cpu")
        leaves = [(p, v.requires_grad_(True)) for p, v in iter_leaves(vals)]
        with TL.compute_precision(torch.float32):
            eff = tcore.materialize(tp, vals, taux, AdapterConfig(**acfg),
                                    alpha=1.0)
            loss, _ = TLM.train_loss(eff, tcfg.replace(remat=remat), {
                "tokens": torch.from_numpy(toks),
                "labels": torch.from_numpy(toks).long()})
            grads = torch.autograd.grad(loss, [v for _, v in leaves])
        out[remat] = float(loss), {p: g.numpy() for (p, _), g in
                                   zip(leaves, grads)}
    (lf, gf), (ld, gd) = out["full"], out["dots"]
    assert abs(ld - lf) <= DOTS_TOL * abs(lf)
    assert abs(ld - float(jl)) <= DOTS_TOL
    for p in gf:
        assert _max_rel(gd[p], gf[p]) <= DOTS_TOL, p
        np.testing.assert_allclose(gd[p], jg[p], rtol=0, atol=DOTS_TOL,
                                   err_msg=p)


def test_remat_dots_multi_adapter():
    """A multi-adapter trainer's losses, aux and value gradients (the
    trainable side delta's custom backward) under dots equal full's."""
    _, tcfg, _, tp, _ = setup("moe-variant")
    out = {}
    for remat in ("full", "dots"):
        run = RunConfig(model=tcfg.replace(remat=remat),
                        shape=ShapeSpec("t", 8, 2, "train"),
                        adapter=AdapterConfig(kind="shira", mask="rand",
                                              sparsity=0.9),
                        train=TrainConfig(learning_rate=1e-2))
        with TL.compute_precision(torch.float32):
            mt = MultiAdapterTrainer(run, ["a", "b"], base_params=tp,
                                     device="cpu", init_key=3)
            from repro_torch.runtime.trainer import device_batch
            from repro_torch.training import multi_batch_iterator
            from repro_torch.data import TaskSpec
            batch = device_batch(next(multi_batch_iterator(
                run.model, run.shape, 0, [TaskSpec(0), TaskSpec(1)])), "cpu")
            vals = {p: v + 0.05 for p, v in mt.init_state()["values"].items()}
            out[remat] = mt.loss_and_grads(vals, batch)
    (lf, gf, af), (ld, gd, ad) = out["full"], out["dots"]
    np.testing.assert_allclose(ld.numpy(), lf.numpy(), rtol=DOTS_TOL)
    np.testing.assert_allclose(float(ad), float(af), rtol=DOTS_TOL)
    assert any("moe/shared" in p for p in gf)
    for p in gf:
        assert _max_rel(gd[p].numpy(), gf[p].numpy()) <= DOTS_TOL, p


@pytest.mark.parametrize("arch", NEW)
def test_launch_serve_and_train_take_the_new_archs(arch):
    # one layer, or a hybrid model's one group; an encoder-only model has
    # no decode path (the CLI exits, as the reference's does), and a
    # vision model's --seq counts its patch prefix
    cfg = get_smoke_config(arch)
    layers = cfg.hybrid_attn_every or 1
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--multi-tenant",
            "--adapters", "2", "--tokens", "2", "--batch", "2",
            "--prompt-len", "4", "--batches", "1", "--layers", str(layers)]
    if cfg.encoder_only:
        with pytest.raises(SystemExit, match="encoder-only"):
            tserve.main(argv)
    else:
        assert tserve.main(argv)["last_out"].shape == (2, 2)
    out = ttrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--adapter", "shira-rand", "--steps", "1", "--seq",
                       str(8 + cfg.num_prefix_embeds), "--batch", "2"])
    assert np.isfinite(out["losses"]).all()
