"""Causal LM assembly for the dense family: embeddings, a stack of dense
blocks, final norm and unembedding.

Port of ``repro/models/lm.py``. The parameter tree has the reference's
structure and shapes: layer parameters are stacked along a leading (L,)
dim in ``params["stages"][0]``. The reference's ``lax.scan`` over that
stack is a Python loop over the same stacked tensors here; the KV cache is
stacked the same way, ``KVCache`` of (L, B, S_max, KV, D), and written in
place.

Entry points:
  init_params(cfg, seed, device)                  -> params
  prefill(params, cfg, batch, cache_size)         -> (last_logits, caches)
  decode_step(params, cfg, tokens, caches, pos)   -> (logits, caches)
  init_cache(cfg, batch, cache_size, device)      -> caches (zeros)
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models.attention import KVCache, padded_heads
from repro_torch.models.layers import (compute_dtype, embed, init_embedding,
                                       init_rms_norm, normal_init, rms_norm,
                                       unembed)


def stage_plan(cfg: ModelConfig) -> List[Tuple[str, int]]:
    if cfg.family == "dense" and cfg.modality == "text":
        return [("dense", cfg.num_layers)]
    raise NotImplementedError(
        f"family {cfg.family!r} / modality {cfg.modality!r} is not ported "
        "(ROADMAP A9, other families)")


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (side-delta bundles too:
    every entry carries the leading layer dim)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"
                ) -> Dict[str, Any]:
    """Random parameters from a seeded ``torch.Generator`` on ``device``.
    The tree and shapes equal ``repro.models.lm.init_params``'s; the draws
    do not (tests cross weights over with ``repro_torch.bridge``)."""
    plan = stage_plan(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params: Dict[str, Any] = {
        "embed": init_embedding(gen, cfg.padded_vocab, cfg.d_model, device),
        "final_norm": init_rms_norm(cfg.d_model, device=device),
        "stages": [B.init_dense_block(gen, cfg, lead=(n,), device=device)
                   for _, n in plan],
    }
    if not cfg.tie_embeddings:
        params["unembed"] = {"lm_head": normal_init(
            gen, (cfg.d_model, cfg.padded_vocab), 0.02, device)}
    return params


def embed_inputs(params, cfg: ModelConfig, batch) -> Tuple[torch.Tensor, int]:
    """Returns (h, prefix_len): token embeddings, no prefix (text models;
    ``stage_plan`` rejects the other modalities)."""
    return embed(params["embed"], batch["tokens"]), 0


def _logits(params, cfg: ModelConfig, h):
    tie = params["embed"]["emb"] if cfg.tie_embeddings else None
    return unembed(params.get("unembed"), h, tie_to=tie,
                   softcap=cfg.logit_softcap, logical_vocab=cfg.vocab_size)


def prefill(params, cfg: ModelConfig, batch, cache_size: int):
    h, prefix_len = embed_inputs(params, cfg, batch)
    caches = []
    for sp, (_, n) in zip(params["stages"], stage_plan(cfg)):
        ks, vs = [], []
        for i in range(n):
            h, c = B.dense_block_prefill(layer_slice(sp, i), cfg, h,
                                         cache_size, prefix_len=prefix_len)
            ks.append(c.k)
            vs.append(c.v)
        caches.append(KVCache(torch.stack(ks), torch.stack(vs)))
    h = rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    return _logits(params, cfg, h[:, -1]), caches


def decode_step(params, cfg: ModelConfig, tokens, caches, pos):
    """tokens: (B, 1) int; pos: int cache index shared by the batch, or a
    (B,) tensor of per-request indices. Returns (logits (B, V), caches);
    the caches are updated in place."""
    h = embed(params["embed"], tokens)
    for sp, cache, (_, n) in zip(params["stages"], caches, stage_plan(cfg)):
        for i in range(n):
            h, _ = B.dense_block_decode(layer_slice(sp, i), cfg, h,
                                        KVCache(cache.k[i], cache.v[i]), pos)
    h = rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    return _logits(params, cfg, h[:, 0]), caches


def init_cache(cfg: ModelConfig, bsz: int, cache_size: int, device="cuda"):
    hd = cfg.resolved_head_dim
    kv = padded_heads(cfg)[1]
    return [KVCache(*(torch.zeros((n, bsz, cache_size, kv, hd),
                                  dtype=compute_dtype(), device=device)
                      for _ in range(2)))
            for _, n in stage_plan(cfg)]
