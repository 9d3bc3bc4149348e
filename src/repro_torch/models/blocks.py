"""The dense transformer block (pre-norm GQA attention + MLP).

Port of the dense block of ``repro/models/blocks.py``. MoE, MLA, Mamba2 and
the zamba2 shared-attention block wait (ROADMAP A9).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import init_mlp, init_rms_norm, mlp, rms_norm


def init_dense_block(gen: torch.Generator, cfg: ModelConfig, *, lead=(),
                     device="cuda") -> dict:
    """Parameters of ``lead`` stacked dense blocks (leading dims first)."""
    if cfg.attn_type != "gqa":
        raise NotImplementedError(
            f"attn_type {cfg.attn_type!r} is not ported (ROADMAP A9)")
    return {
        "attn_norm": init_rms_norm(cfg.d_model, lead=lead, device=device),
        "attn": attn.init_gqa(gen, cfg, lead=lead, device=device),
        "mlp_norm": init_rms_norm(cfg.d_model, lead=lead, device=device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, lead=lead,
                        device=device),
    }


def dense_block_train(params, cfg: ModelConfig, h, *, prefix_len=0,
                      aux=None):
    x = rms_norm(h, params["attn_norm"]["scale"], cfg.norm_eps)
    h = h + attn.gqa_train(params["attn"], cfg, x, prefix_len=prefix_len)
    x = rms_norm(h, params["mlp_norm"]["scale"], cfg.norm_eps)
    h = h + mlp(params["mlp"], x, cfg.act)
    return h, aux


def dense_block_prefill(params, cfg: ModelConfig, h, cache_size, *,
                        prefix_len=0):
    x = rms_norm(h, params["attn_norm"]["scale"], cfg.norm_eps)
    a, cache = attn.gqa_prefill(params["attn"], cfg, x, cache_size,
                                prefix_len=prefix_len)
    h = h + a
    x = rms_norm(h, params["mlp_norm"]["scale"], cfg.norm_eps)
    h = h + mlp(params["mlp"], x, cfg.act)
    return h, cache


def dense_block_decode(params, cfg: ModelConfig, h, cache, pos,
                       block_tables=None):
    """One decode step; with ``block_tables`` the cache is a page pool
    (``attention.gqa_decode_paged``)."""
    x = rms_norm(h, params["attn_norm"]["scale"], cfg.norm_eps)
    if block_tables is not None:
        a, cache = attn.gqa_decode_paged(params["attn"], cfg, x, cache,
                                         block_tables, pos)
    else:
        a, cache = attn.gqa_decode(params["attn"], cfg, x, cache, pos)
    h = h + a
    x = rms_norm(h, params["mlp_norm"]["scale"], cfg.norm_eps)
    h = h + mlp(params["mlp"], x, cfg.act)
    return h, cache


def dense_block_prefill_chunk(params, cfg: ModelConfig, h, cache,
                              block_tables, start, kv_len):
    """Paged chunk prefill: like dense_block_prefill but writing one chunk
    of positions [start, kv_len) through a block table."""
    x = rms_norm(h, params["attn_norm"]["scale"], cfg.norm_eps)
    a, cache = attn.gqa_prefill_chunk(params["attn"], cfg, x, cache,
                                      block_tables, start, kv_len)
    h = h + a
    x = rms_norm(h, params["mlp_norm"]["scale"], cfg.norm_eps)
    h = h + mlp(params["mlp"], x, cfg.act)
    return h, cache
