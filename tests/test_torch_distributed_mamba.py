"""The TP forward of Mamba2 (mamba2-780m's smoke config: 4 SSD heads of
64, one B/C group) and of the hybrid (zamba2-2.7b's: 8 heads of 32, a
shared GQA block of 4 heads after every 2 mamba layers) on gloo ranks,
against the JAX package's unsharded steps on the same bridged weights
(the harness of test_torch_distributed.py):

  * the fsdp full-finetune step of both on (2, 2), and zamba2's packed
    SHiRA step (its 4-D mamba stacks and its 2-D shared leaves split into
    tiles as the 3-D stacks are): f32 losses, grad norms and updated
    values within 1e-5 over 2 steps;
  * prefill of 5 tokens and 12 greedy decode steps: both on (1, 4) (batch
    2 and 1), the heads and channels split (the state and conv windows of
    the rank's heads), the gated norm's sum of squares all-reduced; zamba2
    on (4, 1) with batch 1, its mamba layers served whole on every data
    rank and its shared block's 32-row cache cut over ``data`` (8 rows a
    rank), merged by its log-sum-exp: tokens equal the JAX run's, logits
    within 1e-4;
  * one Mamba2 layer's collectives, forward and backward on an abstract
    (1, 4) mesh, counted by hand.
"""
import numpy as np
import pytest
import torch

from test_torch_distributed import (SEQ_CACHE, _check_train, _job_key, _ok,
                                    run_cases)
from repro_torch.analysis.profile import collective_bytes
from repro_torch.configs import get_smoke_config
from repro_torch.core.masks import iter_leaves
from repro_torch.launch import sharding as shd
from repro_torch.launch.actctx import sharding_hints
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM

MB = ("mamba2-780m", {})
MB_FSDP = ("mamba2-780m", {"fsdp": True})
ZB = ("zamba2-2.7b", {})
ZB_FSDP = ("zamba2-2.7b", {"fsdp": True})
TRAIN = [("mb_full_fsdp", MB_FSDP, "full", (2, 2)),
         ("zb_full_fsdp", ZB_FSDP, "full", (2, 2)),
         ("zb_shira", ZB, "shira", (2, 2))]
# zamba2 at batch 1 on both meshes: one JAX reference serves the two
SERVE = (("mb@1x4", MB, (1, 4), 2), ("zb@1x4", ZB, (1, 4), 1),
         ("zb@4x1", ZB, (4, 1), 1))
STEPS = 2
VECTOR_POS = ("zb@4x1",)
# zamba2's full finetune: its embedding's gradient reaches 1.4e-6 (the
# token path and each shared block's concat input), within a few eps of
# TCFG's 1e-6, where AdamW's m / (sqrt(v) + eps) turns f32 sums taken in
# another order into steps a percent of lr apart; eps 1e-4 keeps the step
# linear in such a gradient, on both sides
TRAIN_TCFG = {"zb_full_fsdp": {"eps": 1e-4}}


@pytest.fixture(scope="module")
def runs():
    return run_cases(TRAIN, (), 4, seq=SERVE, vector_pos=VECTOR_POS,
                     tcfg=TRAIN_TCFG, steps=STEPS)


@pytest.mark.parametrize("case", TRAIN, ids=lambda c: _job_key(c[0], c[3]))
def test_mamba_step_matches_jax(runs, case):
    refs, res = runs
    name, _, _, mesh = case
    _check_train(refs[name], _ok(res, _job_key(name, mesh)),
                 _job_key(name, mesh))


@pytest.mark.parametrize("case", SERVE, ids=lambda c: c[0])
def test_mamba_prefill_decode_match_jax(runs, case):
    """mamba2 holds no KV cache; zamba2's shared block holds the whole
    sequence on (1, 4) and a quarter of it on (4, 1)."""
    refs, res = runs
    key, spec, mesh, batch = case
    toks, logits = refs[key]
    r = _ok(res, key)
    want = None if spec is MB else (
        SEQ_CACHE // mesh[0] if batch < mesh[0] else SEQ_CACHE)
    assert r["cache_rows"] == want, r["cache_rows"]
    if mesh[1] > 1 or want != SEQ_CACHE and want is not None:
        assert r["coll"]["by_kind_count"].get("all-reduce", 0) > 0
    np.testing.assert_array_equal(r["tokens"], toks)
    np.testing.assert_allclose(r["logits"], logits, atol=1e-4, rtol=0)


def test_one_mamba_layer_counts_by_hand():
    """One Mamba2 block, forward and backward, f32, B 2 x S 8 on (1, 4):
    forward, the gated norm's sum of squares (B, S, 1) and out_proj's
    partial sums (B, S, d); backward, the sum of squares' gradient, du
    into the column-parallel in_z/in_x/in_dt, dB/dC (B, S, 2 g n) into the
    replicated in_bc and conv_bc, and the replicated per-head A_log, D,
    dt_bias (H,) and the norm's scale (d_inner,), each used in its slice:
    nine all-reduces over 4 ranks."""
    cfg = get_smoke_config("mamba2-780m").replace(num_layers=1)
    mesh = abstract_mesh((1, 4), ("data", "model"))
    params = TLM.init_params(cfg, 0, device="cpu")
    local = shd.shard_tree(params, shd.param_specs(params, cfg, mesh), mesh)
    layer = TLM.layer_slice(local["stages"][0], 0)
    for _, t in iter_leaves(layer):
        t.requires_grad_(True)
    B, S, d = 2, 8, cfg.d_model
    x = torch.randn(B, S, d, requires_grad=True)

    def run():
        with TL.compute_precision(torch.float32), \
                sharding_hints(tp=shd.TPLayout(cfg, mesh)):
            h, _ = TB.mamba_block_train(layer, cfg, x)
            h.sum().backward()
    got = collective_bytes(run)
    s = cfg.ssm
    d_inner = s.expand * d
    H = d_inner // s.head_dim
    R = 4 * (2 * B * S + 2 * B * S * d + B * S * 2 * s.n_groups * s.d_state
             + 3 * H + d_inner)
    assert got["by_kind_count"] == {"all-reduce": 9}
    assert got["by_kind_bytes"]["all-reduce"] == int(2 * R * 3 / 4)
