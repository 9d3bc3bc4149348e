"""Collective bytes and the dry run.

  * ``analysis.profile.ring_bytes`` is the reference's ring model
    (``repro.analysis.hlo._ring_bytes``) on the same (kind, bytes, group);
  * one TP block (starcoder2's smoke config, forward and backward on an
    abstract (1, 4) mesh: 4 q heads one a rank, its 2 KV heads replicated)
    issues the all-reduces worked out by hand, and one FSDP block on
    (4, 1) the all-gathers and reduce-scatters of its six matrices; one
    sequence-sharded decode layer on (1, 4) (q gathered, the softmaxes
    merged over ``model``) and on (4, 1) (merged over ``data``) the
    gather and all-reduces worked out by hand;
  * ``launch.dryrun.lower_cell`` on smoke configs over an abstract (2, 2)
    mesh writes the reference's record fields, its per-rank memory equals
    the bytes of the shards ``local_shard`` cuts, the families whose TP
    forward came last (MLA, Mamba2, the hybrid, vision, audio) record a
    cost too; the production 16 x 16 ``decode_32k`` and ``prefill_32k``
    cells of starcoder2-7b and granite-34b, whose caches shard the
    sequence, record a cost; the CLI writes its records.
"""
import json
import os

import pytest
import torch

from repro.analysis.hlo import _ring_bytes
from repro_torch.analysis.profile import collective_bytes, ring_bytes
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.masks import iter_leaves
from repro_torch.launch import dryrun as D
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps as S
from repro_torch.launch.actctx import sharding_hints
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM

RECORD = {"arch", "shape", "mesh", "axes", "kind", "adapter", "variant",
          "tags", "lower_s", "compile_s", "memory", "cost", "cost_xla_raw",
          "collectives", "ok"}


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
@pytest.mark.parametrize("group", [2, 4, 16, 32])
def test_ring_model_matches_reference(kind, group):
    for nbytes in (0, 1, 4096, 123_456_789):
        assert ring_bytes(kind, nbytes, group) == _ring_bytes(kind, nbytes,
                                                              group)


def _block(cfg, mesh, B=2, S=8):
    params = TLM.init_params(cfg, 0, device="cpu")
    specs = shd.param_specs(params, cfg, mesh)
    local = shd.shard_tree(params, specs, mesh)
    layer = TLM.layer_slice(local["stages"][0], 0)
    for _, t in iter_leaves(layer):
        t.requires_grad_(True)
    x = torch.randn(B, S, cfg.d_model, requires_grad=True)

    def run():
        with TL.compute_precision(torch.float32), \
                sharding_hints(tp=shd.TPLayout(cfg, mesh)):
            h, _ = TB.block_train(layer, cfg, x)
            h.sum().backward()
    return run


def test_one_tp_block_counts_by_hand():
    cfg = get_smoke_config("starcoder2-7b").replace(num_layers=1)
    mesh = abstract_mesh((1, 4), ("data", "model"))
    got = collective_bytes(_block(cfg, mesh))
    R = 2 * 8 * cfg.d_model * 4                 # one (B, S, d) f32 tensor
    Rk = 2 * 8 * cfg.num_kv_heads * cfg.resolved_head_dim * 4
    # forward: wo's and w_down's partial sums; backward: dx into the
    # column-parallel wq and w_up, and the replicated k and v, whose
    # gradient each rank sees from its own q head only
    assert got["by_kind_count"] == {"all-reduce": 6}
    assert got["by_kind_bytes"]["all-reduce"] == int(
        2 * (4 * R + 2 * Rk) * 3 / 4)
    assert got["total_bytes"] == got["by_kind_bytes"]["all-reduce"]
    assert got["pod_axis_bytes"] == 0


def test_one_fsdp_block_counts_by_hand():
    cfg = get_smoke_config("starcoder2-7b").replace(num_layers=1, fsdp=True)
    mesh = abstract_mesh((4, 1), ("data", "model"))
    got = collective_bytes(_block(cfg, mesh))
    d, hd = cfg.d_model, cfg.resolved_head_dim
    mats = [d * cfg.num_heads * hd, d * cfg.num_kv_heads * hd,
            d * cfg.num_kv_heads * hd, cfg.num_heads * hd * d,
            d * cfg.d_ff, cfg.d_ff * d]
    W = 4 * sum(mats)                           # f32 bytes, gathered
    assert got["by_kind_count"] == {"all-gather": 6, "reduce-scatter": 6}
    assert got["by_kind_bytes"]["all-gather"] == int(W * 3 / 4)
    assert got["by_kind_bytes"]["reduce-scatter"] == int(W / 4 * 3)


@pytest.mark.parametrize("mesh_shape", [(1, 4), (4, 1)])
def test_one_sequence_sharded_decode_layer_counts_by_hand(mesh_shape):
    """starcoder2's smoke config (4 q heads, 2 KV heads), batch 2, a
    32-row cache: on (1, 4) the sequence over ``model`` (its KV heads do
    not divide 4): q all-gathered over ``model``, the max of lse and the
    weighted sum all-reduced over it, wo's and w_down's partial sums; on
    (4, 1) the sequence over ``data`` (the batch is below the dp size):
    the two merge all-reduces alone."""
    cfg = get_smoke_config("starcoder2-7b").replace(num_layers=1)
    mesh = abstract_mesh(mesh_shape, ("data", "model"))
    B, n = 2, 4
    shape = ShapeSpec("d", 32, B, "decode")
    hints = S._serve_hints(cfg, mesh, shape)
    assert hints["kv_seq"].n == n
    params = TLM.init_params(cfg, 0, device="cpu")
    local = shd.shard_tree(params, S.serve_param_shardings(cfg, mesh), mesh)
    layer = TLM.layer_slice(local["stages"][0], 0)
    hd, KV = cfg.resolved_head_dim, cfg.num_kv_heads
    G = cfg.num_heads // KV
    cache = TA.KVCache(torch.zeros(B, 32 // n, KV, hd),
                       torch.zeros(B, 32 // n, KV, hd))
    h = torch.randn(B, 1, cfg.d_model)

    def run():
        with TL.compute_precision(torch.float32), sharding_hints(**hints):
            TB.block_decode(layer, cfg, h, cache, 9)
    got = collective_bytes(run)
    lse = B * KV * G * 4                        # f32 bytes
    merged = B * KV * G * (hd + 1) * 4          # w * out and w
    reduce = lse + merged
    want = {"all-reduce": int(2 * reduce * (n - 1) / n)}
    if mesh_shape == (1, 4):
        rows = 2 * B * cfg.d_model * 4          # wo's and w_down's sums
        want["all-reduce"] = int(2 * (reduce + rows) * (n - 1) / n)
        want["all-gather"] = int(B * cfg.num_heads * hd * 4 * (n - 1) / n)
    assert got["by_kind_bytes"] == want
    assert got["by_kind_count"] == ({"all-reduce": 4, "all-gather": 1}
                                    if mesh_shape == (1, 4)
                                    else {"all-reduce": 2})


def test_pod_axis_bytes_count_the_pod_link():
    mesh = abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    from repro_torch.launch import mesh as M
    got = collective_bytes(lambda: M.all_reduce(
        mesh, torch.zeros(256), ("pod", "data")))
    assert got["by_kind_count"] == {"all-reduce": 2}
    assert got["pod_axis_bytes"] == int(2 * 1024 * 1 / 2)


@pytest.mark.parametrize("arch", ["starcoder2-7b", "granite-moe-1b-a400m",
                                  "qwen1.5-32b"])
@pytest.mark.parametrize("kind,adapter", [("train", "none"),
                                          ("train", "shira"),
                                          ("prefill", "none"),
                                          ("decode", "none")])
def test_lower_cell_records_cost_on_tp_families(arch, kind, adapter):
    cfg = get_smoke_config(arch)
    mesh = abstract_mesh((2, 2), ("data", "model"))
    rec = D.lower_cell(arch, ShapeSpec("t", 32, 4, kind), mesh,
                       adapter=adapter, cfg=cfg)
    assert RECORD <= set(rec) and rec["ok"]
    assert rec["cost"]["flops"] > 0 and rec["cost"]["ops_without_cost"] == 0
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["cost_xla_raw"] is None       # no compiler's own count
    assert rec["memory"]["per_rank_gb"] > 0
    if kind == "train" and adapter == "none":
        # the memory is the bytes of the shards a rank holds
        params = TLM.init_params(cfg, 0, device="cpu")
        local = shd.shard_tree(params, shd.param_specs(params, cfg, mesh),
                               mesh)
        nb = sum(t.numel() * t.element_size() for _, t in iter_leaves(local))
        assert rec["memory"]["params_bytes"] == nb
        assert rec["memory"]["opt_state_bytes"] == 2 * nb


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b",
                                  "deepseek-v2-lite-16b", "paligemma-3b",
                                  "hubert-xlarge"])
def test_lower_cell_null_cost_without_tp_forward(arch):
    """No cell's cost is null any more: the train and prefill cells of
    the five families that once had no TP forward run rank 0's step on
    "meta" and record a cost (every op counted) and collectives."""
    cfg = get_smoke_config(arch)
    mesh = abstract_mesh((2, 2), ("data", "model"))
    for kind in ("train", "prefill"):
        rec = D.lower_cell(arch, ShapeSpec("t", 300, 4, kind), mesh,
                           cfg=cfg)
        assert RECORD <= set(rec) and rec["ok"] and "reason" not in rec
        assert rec["cost"]["flops"] > 0
        assert rec["cost"]["ops_without_cost"] == 0
        assert rec["collectives"]["total_bytes"] > 0
        assert rec["memory"]["per_rank_gb"] > 0


@pytest.mark.parametrize("arch", ["starcoder2-7b", "granite-34b"])
@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
def test_lower_cell_records_cost_on_sequence_sharded_cache(arch, shape):
    """The production 16 x 16 cells: 4 KV heads (starcoder2-7b) and 1
    (granite-34b) shard the cache's sequence over ``model``; rank 0's step
    runs on "meta" with its 2048 rows and records its cost."""
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh()
    rec = D.lower_cell(arch, shape, mesh)
    assert RECORD <= set(rec) and rec["ok"] and "reason" not in rec
    assert rec["cost"]["flops"] > 0 and rec["cost"]["ops_without_cost"] == 0
    assert rec["collectives"]["by_kind_count"]["all-reduce"] > 0


def test_cli_writes_records(tmp_path):
    out = tmp_path / "dryrun.json"
    D.main(["--arch", "mamba2-780m,starcoder2-7b", "--shape",
            "decode_32k,long_500k", "--mesh", "both", "--out", str(out)])
    recs = json.loads(out.read_text())
    # mamba2: decode_32k and long_500k (batch 1: served whole on every
    # data rank); starcoder2: decode_32k (its 4 KV heads shard the
    # sequence on 16-way TP); on both meshes, each with a cost
    assert len(recs) == 6 and all(r["ok"] for r in recs)
    assert all(RECORD <= set(r) for r in recs)
    assert all(r["cost"] is not None and r["cost"]["flops"] > 0
               for r in recs)
    assert {tuple(r["mesh"]) for r in recs} == {(16, 16), (2, 16, 16)}
    assert D.DEFAULT_OUT.startswith("build" + os.sep) or \
        D.DEFAULT_OUT.startswith("build/")
