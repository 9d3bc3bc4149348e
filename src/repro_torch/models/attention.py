"""GQA attention: training, and prefill and decode against a contiguous KV
cache.

Port of the GQA part of ``repro/models/attention.py``. The math is plain
torch, as the reference's is jnp: scores and softmax in f32 from
compute-dtype operands, probabilities cast back to the compute dtype for
the value product. The decode path writes the new K/V into the cache in
place (the reference returns an updated copy). MLA and the paged paths
wait (ROADMAP A6, A9).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (apply_rope, compute_dtype, dense,
                                       glorot)

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, KV, D), or (L, B, S_max, KV, D) stacked
    v: torch.Tensor


def _attend_block(q, k, v, q_pos, k_pos, causal, prefix_len, kv_len=None):
    """q: (B, qc, H, D); k, v: (B, Sk, KV, D); q_pos (qc,) or (B, qc);
    k_pos (Sk,); kv_len None, a scalar or (B,). Returns (B, qc, H, D)."""
    B, qc, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    cd = compute_dtype()
    qg = q.reshape(B, qc, KV, G, D)
    # 1 / sqrt(D) rounded in f32, as the reference computes it
    scale = float(np.float32(1.0) / np.sqrt(np.float32(D)))
    # compute-dtype operands, f32 products and sums
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(cd).float(),
                          k.to(cd).float()) * scale
    qp = q_pos if q_pos.ndim == 2 else q_pos[None]    # (B|1, qc)
    mask = torch.ones((qp.shape[0], qc, Sk), dtype=torch.bool,
                      device=q.device)
    if causal:
        cm = qp[:, :, None] >= k_pos[None, None, :]
        if prefix_len > 0:
            cm = cm | (k_pos[None, None, :] < prefix_len)
        mask = mask & cm
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=q.device)
        kl = kl[:, None, None] if kl.ndim == 1 else kl
        mask = mask & (k_pos[None, None, :] < kl)
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(cd)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(cd))
    return out.reshape(B, qc, H, v.shape[-1])


def chunked_attention(q, k, v, *, causal=True, q_offset=0, prefix_len=0,
                      q_chunk=512, kv_len=None):
    """Attention over q-chunks, so one chunk row of scores is live at a
    time. q: (B, Sq, H, D)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    k_pos = torch.arange(Sk, device=q.device)
    if Sq <= q_chunk:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        return _attend_block(q, k, v, q_pos, k_pos, causal, prefix_len,
                             kv_len)
    while Sq % q_chunk:  # shrink to the nearest divisor of Sq
        q_chunk -= 1
    outs = []
    for i in range(Sq // q_chunk):
        q_pos = q_offset + i * q_chunk + torch.arange(q_chunk,
                                                      device=q.device)
        outs.append(_attend_block(q[:, i * q_chunk:(i + 1) * q_chunk], k, v,
                                  q_pos, k_pos, causal, prefix_len, kv_len))
    return torch.cat(outs, dim=1)


def padded_heads(cfg: ModelConfig) -> Tuple[int, int]:
    """(H', KV') after optional head-group padding."""
    H = cfg.pad_heads_to or cfg.num_heads
    KV = cfg.pad_kv_to or cfg.num_kv_heads
    if H % KV:
        raise ValueError(f"padded heads {H} not a multiple of kv heads {KV}")
    return H, KV


def _pad_masks(cfg: ModelConfig, device="cpu"):
    """(q_head_real (H',), kv_head_real (KV',)) boolean masks."""
    Hp, KVp = padded_heads(cfg)
    H, KV = cfg.num_heads, cfg.num_kv_heads
    G, Gp = H // KV, Hp // KVp
    kv_real = torch.arange(KVp, device=device) < KV
    grp = torch.arange(Hp, device=device) // Gp
    slot = torch.arange(Hp, device=device) % Gp
    q_real = (grp < KV) & (slot < G)
    return q_real, kv_real


def init_gqa(gen: torch.Generator, cfg: ModelConfig, *, lead=(),
             device="cuda") -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    Hp, KVp = padded_heads(cfg)
    lead = tuple(lead)
    p = {
        "wq": glorot(gen, lead + (d, Hp * hd), device),
        "wk": glorot(gen, lead + (d, KVp * hd), device),
        "wv": glorot(gen, lead + (d, KVp * hd), device),
        "wo": glorot(gen, lead + (Hp * hd, d), device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", Hp), ("bk", KVp), ("bv", KVp)):
            p[name] = torch.zeros(lead + (width * hd,), dtype=torch.float32,
                                  device=device)
    if Hp != cfg.num_heads or KVp != cfg.num_kv_heads:
        q_real, kv_real = _pad_masks(cfg, device)
        qm = torch.repeat_interleave(q_real, hd).float()
        km = torch.repeat_interleave(kv_real, hd).float()
        p["wq"] *= qm
        p["wk"] *= km
        p["wv"] *= km
        p["wo"] *= qm[:, None]
        if cfg.qkv_bias:
            p["bq"] *= qm
            p["bk"] *= km
            p["bv"] *= km
    return p


def _gqa_qkv(params, cfg: ModelConfig, x, positions):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    Hp, KVp = padded_heads(cfg)
    q = dense(x, params["wq"], params.get("bq")).reshape(B, S, Hp, hd)
    k = dense(x, params["wk"], params.get("bk")).reshape(B, S, KVp, hd)
    v = dense(x, params["wv"], params.get("bv")).reshape(B, S, KVp, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _maybe_repeat_kv(cfg: ModelConfig, t):
    """(B, S, KV', D) -> (B, S, H', D) when attn_repeat_kv."""
    if not cfg.attn_repeat_kv:
        return t
    Hp, KVp = padded_heads(cfg)
    return torch.repeat_interleave(t, Hp // KVp, dim=2)


def gqa_train(params, cfg: ModelConfig, x, *, prefix_len=0, q_chunk=512):
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    q, k, v = _gqa_qkv(params, cfg, x, positions)
    out = chunked_attention(q, _maybe_repeat_kv(cfg, k),
                            _maybe_repeat_kv(cfg, v), causal=cfg.causal,
                            prefix_len=prefix_len, q_chunk=q_chunk)
    return dense(out.reshape(B, S, -1), params["wo"])


def gqa_prefill(params, cfg: ModelConfig, x, cache_size: int, *,
                prefix_len=0, q_chunk=512) -> Tuple[torch.Tensor, KVCache]:
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    q, k, v = _gqa_qkv(params, cfg, x, positions)
    out = chunked_attention(q, _maybe_repeat_kv(cfg, k),
                            _maybe_repeat_kv(cfg, v), causal=cfg.causal,
                            prefix_len=prefix_len, q_chunk=q_chunk)
    hd = cfg.resolved_head_dim
    KV = padded_heads(cfg)[1]
    cd = compute_dtype()
    ck = torch.zeros((B, cache_size, KV, hd), dtype=cd, device=x.device)
    cv = torch.zeros((B, cache_size, KV, hd), dtype=cd, device=x.device)
    ck[:, :S] = k.to(cd)
    cv[:, :S] = v.to(cd)
    return dense(out.reshape(B, S, -1), params["wo"]), KVCache(ck, cv)


def _decode_positions(pos, B: int, device) -> Tuple[torch.Tensor, bool]:
    """pos is a scalar (whole batch at one index) or a (B,) vector of
    per-request indices. Returns (positions (1,)|(B, 1), is_vector)."""
    if isinstance(pos, int):
        return torch.full((1,), pos, device=device), False
    p = torch.as_tensor(pos, device=device)
    if p.ndim == 0:
        return p.reshape(1), False
    if p.shape != (B,):
        raise ValueError(f"decode positions {tuple(p.shape)} for batch {B}")
    return p[:, None], True


def gqa_decode(params, cfg: ModelConfig, x, cache: KVCache, pos
               ) -> Tuple[torch.Tensor, KVCache]:
    """x: (B, 1, d); pos: scalar index where the new token lands, or (B,)
    per-request indices. Writes the cache in place and returns it."""
    B = x.shape[0]
    positions, vector = _decode_positions(pos, B, x.device)
    q, k, v = _gqa_qkv(params, cfg, x, positions)
    cd = compute_dtype()
    if vector:
        b = torch.arange(B, device=x.device)
        cache.k[b, positions[:, 0]] = k.to(cd)[:, 0]
        cache.v[b, positions[:, 0]] = v.to(cd)[:, 0]
    else:
        p = pos if isinstance(pos, int) else int(pos)
        cache.k[:, p:p + 1] = k.to(cd)
        cache.v[:, p:p + 1] = v.to(cd)
    kv_len = positions[:, 0] + 1 if vector else positions[0] + 1
    out = _attend_block(q, _maybe_repeat_kv(cfg, cache.k),
                        _maybe_repeat_kv(cfg, cache.v), positions,
                        torch.arange(cache.k.shape[1], device=x.device),
                        causal=True, prefix_len=0, kv_len=kv_len)
    return dense(out.reshape(B, 1, -1), params["wo"]), cache
