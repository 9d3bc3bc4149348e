"""The TP forward of MLA (deepseek-v2-lite-16b's smoke config: 4 heads,
a 32-wide latent, 2 MoE layers of 4 experts behind a dense layer, one
shared expert) on gloo ranks, against the JAX package's unsharded steps
on the same bridged weights (the harness of test_torch_distributed.py):

  * the fsdp full-finetune step on (2, 2) (experts parallel over
    ``model``, every matrix's FSDP dim gathered over ``data``) against
    the JAX ``make_train_step`` with two microbatches, the mesh's data
    shards, so that each shard's MoE aux is its own: f32 losses, grad
    norms and updated values within 1e-5 over 2 steps (deepseek's packed
    SHiRA step on the mesh is held at full width by chip_smoke.py);
  * prefill of 5 tokens into a 32-row latent cache and 12 greedy decode
    steps (the matrix-absorbed decode): on (1, 4), its heads split and its
    latent's rank dim split (8 columns a rank); on (4, 1) with batch 1, the
    cache's sequence over ``data`` (8 rows a rank, positions as (B,)
    tensors), merged by each rank's log-sum-exp; on (2, 2) with batch 1,
    both: tokens equal the JAX run's, logits within 1e-4;
  * one MLA decode layer's collectives on an abstract mesh, counted by
    hand: on (1, 4) q_eff and q_rope gathered over the heads, the partial
    scores all-reduced over the rank dim, the latent output gathered, wo's
    and w_down's partial sums; on (2, 2) with batch 1 the two
    log-sum-exp merge all-reduces over ``data`` as well.
"""
import numpy as np
import pytest
import torch

from test_torch_distributed import (SEQ_CACHE, SEQ_PROMPT, SEQ_STEPS, TCFG,
                                    _check_train, _job_key, _ok, run_cases)
from repro_torch.analysis.profile import collective_bytes
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps as S
from repro_torch.launch.actctx import sharding_hints
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM

DS = ("deepseek-v2-lite-16b", {})
DS_FSDP = ("deepseek-v2-lite-16b", {"fsdp": True})
TRAIN = [("ds_full_fsdp", DS_FSDP, "full", (2, 2))]
REF_TCFG = {"ds_full_fsdp": {**TCFG, "microbatch": 2}}
STEPS = 2
# (key, spec, mesh, batch): SEQ_PROMPT tokens into SEQ_CACHE rows,
# SEQ_STEPS decode steps
SERVE = (("mla@1x4", DS, (1, 4), 2), ("mla@4x1", DS, (4, 1), 1),
         ("mla@2x2", DS, (2, 2), 1))
VECTOR_POS = ("mla@4x1",)


@pytest.fixture(scope="module")
def runs():
    return run_cases(TRAIN, (), 4, seq=SERVE, ref_tcfg=REF_TCFG,
                     vector_pos=VECTOR_POS, steps=STEPS)


@pytest.mark.parametrize("case", TRAIN, ids=lambda c: _job_key(c[0], c[3]))
def test_mla_step_matches_jax(runs, case):
    refs, res = runs
    name, _, _, mesh = case
    _check_train(refs[name], _ok(res, _job_key(name, mesh)),
                 _job_key(name, mesh))


@pytest.mark.parametrize("case", SERVE, ids=lambda c: c[0])
def test_mla_prefill_decode_match_jax(runs, case):
    """The latent cache holds the rank's columns (1, 4), its rows (4, 1),
    or both (2, 2); the decode equals the JAX package's unsharded one."""
    refs, res = runs
    key, _, mesh, _ = case
    toks, logits = refs[key]
    r = _ok(res, key)
    rows = SEQ_CACHE // mesh[0] if case[3] < mesh[0] else SEQ_CACHE
    assert r["cache_rows"] == rows, r["cache_rows"]
    assert r["coll"]["by_kind_count"].get("all-reduce", 0) > 0
    np.testing.assert_array_equal(r["tokens"], toks)
    np.testing.assert_allclose(r["logits"], logits, atol=1e-4, rtol=0)
    assert SEQ_PROMPT + SEQ_STEPS < SEQ_CACHE


@pytest.mark.parametrize("mesh_shape,B", [((1, 4), 2), ((2, 2), 1)])
def test_one_mla_decode_layer_counts_by_hand(mesh_shape, B):
    """deepseek's dense layer (MLA and an MLP of 64), a 32-row cache, f32.
    On (1, 4): all-gathers of q_eff (B, 1, H, rank) and q_rope (B, 1, H,
    rope) over the heads and of the latent output (B, 1, H, rank) over the
    rank dim; all-reduces of the partial scores (B, H, 1, 32) and of wo's
    and w_down's (B, 1, d) partial sums. On (2, 2) with batch 1 the cache's
    16 rows a rank (the sequence over ``data``) add the merge's max of lse
    (B, 1, H) and weighted sum (B, 1, H, rank / 2 + 1), over 2 ranks."""
    cfg = get_smoke_config("deepseek-v2-lite-16b").replace(num_layers=1)
    m = cfg.mla
    mesh = abstract_mesh(mesh_shape, ("data", "model"))
    tp = mesh_shape[1]
    shape = ShapeSpec("d", 32, B, "decode")
    hints = S._serve_hints(cfg, mesh, shape)
    seq = mesh_shape[0] if B < mesh_shape[0] else 1
    assert ("kv_seq" in hints) == (seq > 1)
    params = TLM.init_params(cfg, 0, device="cpu")
    local = shd.shard_tree(params, S.serve_param_shardings(cfg, mesh), mesh)
    layer = TLM.layer_slice(local["stages"][0], 0)
    rl, n = m.kv_lora_rank // tp, 32 // seq
    cache = TA.KVCache(torch.zeros(B, n, rl),
                       torch.zeros(B, n, m.qk_rope_head_dim))
    h = torch.randn(B, 1, cfg.d_model)

    def run():
        with TL.compute_precision(torch.float32), sharding_hints(**hints):
            TB.block_decode(layer, cfg, h, cache, 9)
    got = collective_bytes(run)
    H, f = cfg.num_heads, (tp - 1) / tp
    gather = B * H * (2 * m.kv_lora_rank + m.qk_rope_head_dim) * 4
    reduce = (B * H * n + 2 * B * cfg.d_model) * 4
    want = {"all-gather": int(gather * f), "all-reduce": int(2 * reduce * f)}
    count = {"all-gather": 3, "all-reduce": 3}
    if seq > 1:
        merge = B * H * (1 + rl + 1) * 4
        want["all-reduce"] = int(2 * (reduce * f + merge * (seq - 1) / seq))
        count["all-reduce"] = 5
    assert got["by_kind_count"] == count
    assert got["by_kind_bytes"] == want
