"""GQA and MLA attention: training, prefill and decode against a
contiguous KV cache, and the paged paths over a page pool.

Port of ``repro/models/attention.py``. Training keeps the
reference's plain math (``chunked_attention``: scores and softmax in f32
from compute-dtype operands, probabilities cast back to the compute dtype
for the value product). Serving sends attention through the port's
attention kernels, where the reference's model never calls its Pallas ones:
  gqa_prefill       ``flash_prefill_blocks``, causal or bidirectional as
                    the config, when there is no prefix (starcoder2-7b's
                    case, and lane admission), else ``chunked_attention``
                    (paligemma-3b's patch prefix)
  gqa_encode        the same with no cache (``lm.encode``; hubert-xlarge's
                    bidirectional attention)
  gqa_decode        ``flash_decode_blocks`` with kv_len = pos + 1, a scalar
                    or (B,) per-request lengths
  gqa_decode_paged  writes through the block table, then
                    ``flash_decode_paged`` on the pools, with no gather
                    (int8 ``QuantKV`` pools too: the row is quantized as
                    it is written, and the kernel's int8 instance
                    dequantizes the rows it reads; with ``attn_repeat_kv``
                    on the unrepeated pools, which gives each query head
                    the KV head the repeat would)
  gqa_prefill_chunk a query offset, which no TPU kernel computes: the
                    reference gathers the pages and does jnp math, and so
                    does this port in plain torch
The kernels keep the probabilities in f32 where ``_attend_block`` rounds
them to the compute dtype: equal in f32, a bf16 rounding apart in bf16.
``gqa_prefill_chunk`` keeps them in f32 as the kernels do, so the lane and
paged engines prefill with the same numerics.
Caches are written in place (the reference returns updated copies).

Under the launch layer's "tp" hint (``launch.sharding.TPLayout``) the GQA
train, prefill and decode paths run on one rank's heads: wq/wk/wv local
columns (``_gqa_qkv_tp``), each local q head with its own KV head, the
cache holding the rank's KV heads, wo row-parallel (``_out_proj``). The
MLA paths run on the rank's heads too: wq, w_uk and w_uv column-parallel,
w_dkv replicated (c_kv and k_rope through ``copy_to``), wo row-parallel,
the latent cache holding the rank's columns of the rank dim; the absorbed
decode all-gathers q over the heads and all-reduces the partial scores
over the rank dim (``_mla_decode_tp``). The paged paths have no TP form:
they stay single-rank.

Under the "kv_seq" hint as well (``launch.sharding.SeqLayout``: KV heads
that do not divide ``model``, or a batch below the dp size) each rank's
cache holds its shard of the sequence, ``cache_size / n`` rows from
``offset`` = the rank's row-major index over the hint's axes times that
length, the cut ``local_shard`` makes. ``gqa_prefill`` attends the whole
prompt as above and writes the rows it holds; ``gqa_decode`` writes the
new row on the rank that holds its position, attends its shard with
kv_len clamp(pos + 1 - offset, 0, local length) on the log-sum-exp
instance of ``flash_decode_blocks`` and merges the ranks
(``launch.mesh.softmax_merge``); ``mla_prefill`` and ``mla_decode`` do the
same over their latent rows, the softmax in plain torch. Where the q
heads are split over ``model`` but the KV heads are not (the cache holds
every KV head), each rank all-gathers q over ``model``, attends every
head over its shard, merges and keeps its own heads for the row-parallel
wo (the gather-q case).

MLA (DeepSeek-V2's multi-head latent attention) is plain torch, as the
reference's is plain jnp: no TPU kernel computes it (the attention
kernels take one head size for K and V, and MLA's are 192/128 expanded,
576/512 absorbed). Its cache holds the latents only, c_kv (rank) and the
roped k_rope (rope_dim) a token, in ``KVCache.k`` and ``KVCache.v``:
  mla_train, mla_prefill  expand per-head K/V from the latents through
                    ``dense`` (compute-dtype ``w_uk``/``w_uv``), then
                    ``chunked_attention``
  mla_decode, mla_decode_paged  matrix absorption: the raw f32
                    ``w_uk``/``w_uv`` reshaped to (rank, H, .), q_nope
                    taken into the latent space, scores over
                    [c_kv | k_rope], softmax and both products in f32,
                    scale 1 / sqrt(qk_nope + qk_rope); positions <= pos
                    attended (the paged path on the gathered latents)
  mla_prefill_chunk gathers the latent pages, expands them, and
                    ``_attend_block`` with the probabilities rounded to the
                    compute dtype, as ``mla_prefill``: the lane and paged
                    engines prefill with the same numerics
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_decode import (flash_decode_blocks,
                                              flash_decode_paged)
from repro_torch.kernels.flash_prefill import flash_prefill_blocks
from repro_torch.launch import mesh as MESH
from repro_torch.launch.actctx import hint
from repro_torch.models.layers import (apply_rope, compute_dtype, dense,
                                       glorot, init_rms_norm, rms_norm,
                                       tp_column, tp_layout, tp_row)

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, KV, D), or (L, B, S_max, KV, D) stacked
    v: torch.Tensor  # [MLA: c_kv (..., S_max, rank), k_rope (..., rope)]


def _attend_block(q, k, v, q_pos, k_pos, causal, prefix_len, kv_len=None,
                  f32_probs=False):
    """q: (B, qc, H, D); k, v: (B, Sk, KV, D); q_pos (qc,) or (B, qc);
    k_pos (Sk,); kv_len None, a scalar or (B,). Returns (B, qc, H, D) in
    the compute dtype. The probabilities are rounded to the compute dtype
    before the value product, as the reference does, unless ``f32_probs``
    (the attention kernels' numerics)."""
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
    probs = torch.softmax(scores, dim=-1)
    if f32_probs:
        out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(cd).float())
    else:
        out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(cd), v.to(cd))
    return out.to(cd).reshape(B, qc, H, v.shape[-1])


def chunked_attention(q, k, v, *, causal=True, q_offset=0, prefix_len=0,
                      q_chunk=512, kv_len=None):
    """Attention over q-chunks, so one chunk row of scores is live at a
    time. q: (B, Sq, H, D). Chunks of ``q_chunk`` rows and a shorter last
    one: each query row's attention is its own, so the rows equal the
    reference's, whose scan needs equal chunks and so shrinks ``q_chunk``
    to a divisor of Sq (one row a chunk for a prime Sq)."""
    Sk = k.shape[1]
    k_pos = torch.arange(Sk, device=q.device)
    outs = []
    for i in range(0, q.shape[1], q_chunk):
        qc = q[:, i:i + q_chunk]
        q_pos = q_offset + i + torch.arange(qc.shape[1], device=q.device)
        outs.append(_attend_block(qc, k, v, q_pos, k_pos, causal,
                                  prefix_len, kv_len))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


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


def _gqa_qkv(params, cfg: ModelConfig, x, positions, all_kv=False):
    """q, k, v; under the "tp" hint this rank's heads, and with ``all_kv``
    k and v as the rank computes them (every KV head where wk/wv are
    replicated: what a sequence-sharded cache holds), not picked for its q
    heads."""
    tp = tp_layout()
    if tp is not None:
        return _gqa_qkv_tp(params, cfg, x, positions, tp, all_kv)
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
    """(B, S, KV', D) -> (B, S, H', D) when attn_repeat_kv. Under the
    "tp" hint K and V already come grouped for the rank's heads
    (``_local_kv``)."""
    if not cfg.attn_repeat_kv or tp_layout() is not None:
        return t
    Hp, KVp = padded_heads(cfg)
    return torch.repeat_interleave(t, Hp // KVp, dim=2)


def _gqa_qkv_tp(params, cfg: ModelConfig, x, positions, tp,
                all_kv=False):
    """q, k, v for this rank's heads under the "tp" hint. wq/wk/wv are
    column-parallel unless the head guard replicates them. Sharded, their
    input goes through ``copy_to``; a replicated wk/wv beside a sharded
    wq gives every KV head, whose gradient each rank sees only from its
    own q heads, so k and v go through ``copy_to`` instead. Each local q
    head then meets its KV head h // G (``_local_kv``)."""
    B, S, d = x.shape
    hd = cfg.resolved_head_dim
    Hp, KVp = padded_heads(cfg)
    wq, sq = tp.weight(params["wq"], "wq", (d, Hp * hd))
    wk, sk = tp.weight(params["wk"], "wk", (d, KVp * hd))
    wv, _ = tp.weight(params["wv"], "wv", (d, KVp * hd))
    q_sh, kv_sh = tp.sharded(sq, -1), tp.sharded(sk, -1)
    xq = MESH.copy_to(tp.mesh, x, "model") if q_sh else x
    xkv = xq if kv_sh else x
    q = dense(xq, wq, params.get("bq")).reshape(B, S, -1, hd)
    k = dense(xkv, wk, params.get("bk")).reshape(B, S, -1, hd)
    v = dense(xkv, wv, params.get("bv")).reshape(B, S, -1, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if q_sh and not kv_sh:
        k = MESH.copy_to(tp.mesh, k, "model")
        v = MESH.copy_to(tp.mesh, v, "model")
    if not all_kv:
        k, v = _pick_kv(cfg, tp, q.shape[2], k), _pick_kv(cfg, tp,
                                                          q.shape[2], v)
    return q, k, v


def _head_split(cfg: ModelConfig, tp) -> Tuple[bool, bool]:
    """(q heads split over ``model``, KV heads split over ``model``)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    Hp, KVp = padded_heads(cfg)
    return (tp.sharded(tp.spec("wq", (d, Hp * hd)), -1),
            tp.sharded(tp.spec("wk", (d, KVp * hd)), -1))


def _pick_kv(cfg: ModelConfig, tp, hl: int, t):
    """The KV heads of ``t`` (B, S, kvl, D) that this rank's ``hl`` q heads
    attend (``_local_kv``)."""
    sel = _local_kv(cfg, tp, hl, t.shape[2], *_head_split(cfg, tp))
    if sel is None:
        return t
    return t.index_select(2, torch.tensor(sel, device=t.device))


def _local_kv(cfg: ModelConfig, tp, hl: int, kvl: int, q_sh: bool,
              kv_sh: bool):
    """The KV heads (local indices) this rank's ``hl`` q heads attend, so
    that local q head j meets entry j // (hl / len): global q head h meets
    KV head h // G. None when that is the local KV heads as they are."""
    Hp, KVp = padded_heads(cfg)
    G = Hp // KVp
    h0 = tp.rank * hl if q_sh else 0
    off = tp.rank * kvl if kv_sh else 0
    ids = [(h0 + j) // G - off for j in range(hl)]
    if hl % G == 0 and h0 % G == 0:
        sel = ids[::G]
    elif min(ids) == max(ids):
        sel = ids[:1]
    else:
        sel = ids
    return None if sel == list(range(kvl)) else sel


def _out_proj(params, cfg: ModelConfig, o):
    """o @ wo; under the "tp" hint row-parallel (an all-reduce of the
    heads' partial sums over ``model``) unless the head guard replicates
    wo."""
    tp = tp_layout()
    if tp is None:
        return dense(o, params["wo"])
    Hp, _ = padded_heads(cfg)
    d = cfg.d_model
    return tp_row(o, params["wo"], "wo", (Hp * cfg.resolved_head_dim, d), tp)


def gqa_train(params, cfg: ModelConfig, x, *, prefix_len=0, q_chunk=512):
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    q, k, v = _gqa_qkv(params, cfg, x, positions)
    out = chunked_attention(q, _maybe_repeat_kv(cfg, k),
                            _maybe_repeat_kv(cfg, v), causal=cfg.causal,
                            prefix_len=prefix_len, q_chunk=q_chunk)
    return _out_proj(params, cfg, out.reshape(B, S, -1))


def _serve_attention(cfg: ModelConfig, q, k, v, prefix_len, q_chunk):
    """A whole sequence's attention outside training: the kernel where
    there is no prefix, the plain chunked path with one."""
    kr, vr = _maybe_repeat_kv(cfg, k), _maybe_repeat_kv(cfg, v)
    if prefix_len == 0:
        return flash_prefill_blocks(q, kr, vr, causal=cfg.causal)
    return chunked_attention(q, kr, vr, causal=cfg.causal,
                             prefix_len=prefix_len, q_chunk=q_chunk)


def gqa_encode(params, cfg: ModelConfig, x, *, prefix_len=0, q_chunk=512):
    """``gqa_prefill`` with no cache."""
    B, S, _ = x.shape
    q, k, v = _gqa_qkv(params, cfg, x, torch.arange(S, device=x.device))
    out = _serve_attention(cfg, q, k, v, prefix_len, q_chunk)
    return _out_proj(params, cfg, out.reshape(B, S, -1))


def seq_layout():
    """The installed "kv_seq" hint (``launch.sharding.SeqLayout``), or
    None."""
    return hint("kv_seq")


def gqa_prefill(params, cfg: ModelConfig, x, cache_size: int, *,
                prefix_len=0, q_chunk=512) -> Tuple[torch.Tensor, KVCache]:
    """The whole prompt's attention, and a cache of ``cache_size`` rows
    holding its K/V; under the "kv_seq" hint this rank's rows of it."""
    B, S, _ = x.shape
    seq = seq_layout()
    q, k, v = _gqa_qkv(params, cfg, x, torch.arange(S, device=x.device),
                       all_kv=seq is not None)
    kc, vc, start = k, v, 0
    if seq is not None:     # k, v as the cache holds them; q's heads' pick
        tp = tp_layout()
        k, v = _pick_kv(cfg, tp, q.shape[2], k), _pick_kv(cfg, tp,
                                                          q.shape[2], v)
        cache_size = seq.local_len(cache_size)
        start = min(seq.offset(cache_size), S)
    out = _serve_attention(cfg, q, k, v, prefix_len, q_chunk)
    hd = cfg.resolved_head_dim
    KV = kc.shape[2]        # this rank's KV heads under the "tp" hint
    cd = compute_dtype()
    ck = torch.zeros((B, cache_size, KV, hd), dtype=cd, device=x.device)
    cv = torch.zeros((B, cache_size, KV, hd), dtype=cd, device=x.device)
    rows = min(S - start, cache_size)
    ck[:, :rows] = kc[:, start:start + rows].to(cd)
    cv[:, :rows] = vc[:, start:start + rows].to(cd)
    return _out_proj(params, cfg, out.reshape(B, S, -1)), KVCache(ck, cv)


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


def _flash_decode(cfg: ModelConfig, q, ck, cv, kv_len):
    """q: (B, 1, H', D) against the contiguous cache (B, S, KV', D):
    ``flash_decode_blocks`` on q grouped as (B, KV, G, D)."""
    B, _, H, D = q.shape
    k, v = _maybe_repeat_kv(cfg, ck), _maybe_repeat_kv(cfg, cv)
    KV = k.shape[2]
    out = flash_decode_blocks(q.to(k.dtype).reshape(B, KV, H // KV, D), k,
                              v, kv_len)
    return out.reshape(B, 1, H, D)


def gqa_decode(params, cfg: ModelConfig, x, cache: KVCache, pos
               ) -> Tuple[torch.Tensor, KVCache]:
    """x: (B, 1, d); pos: scalar index where the new token lands, or (B,)
    per-request indices. Writes the cache in place and returns it."""
    B = x.shape[0]
    positions, vector = _decode_positions(pos, B, x.device)
    seq = seq_layout()
    if seq is not None:
        return _gqa_decode_seq(params, cfg, x, cache, pos, positions, vector,
                               seq)
    q, k, v = _gqa_qkv(params, cfg, x, positions)
    cd = compute_dtype()
    if vector:
        b = torch.arange(B, device=x.device)
        cache.k[b, positions[:, 0]] = k.to(cd)[:, 0]
        cache.v[b, positions[:, 0]] = v.to(cd)[:, 0]
        kv_len = positions[:, 0] + 1
    else:
        p = pos if isinstance(pos, int) else int(pos)
        cache.k[:, p:p + 1] = k.to(cd)
        cache.v[:, p:p + 1] = v.to(cd)
        kv_len = p + 1
    out = _flash_decode(cfg, q, cache.k, cache.v, kv_len)
    return _out_proj(params, cfg, out.reshape(B, 1, -1)), cache


def _write_shard(pairs, pos, positions, vector: bool, off: int):
    """One decode step's rows into caches that hold the positions [off,
    off + n) of the sequence, in place (off 0 and n the whole cache where
    it is not sequence-sharded): each (cache (B, n, ...), row (B, 1, ...))
    pair's row lands on the rank that holds its position, at the (B, 1)
    per-request ``positions`` or at the shared index ``pos``. Returns the
    rank's kv_len, clamp(pos + 1 - off, 0, n): a (B,) tensor or an int."""
    cd = compute_dtype()
    n = pairs[0][0].shape[1]
    if vector:
        p = positions[:, 0]
        b = torch.arange(p.shape[0], device=p.device)
        at = (p - off).clamp(0, n - 1)
        mine = (p >= off) & (p < off + n)
        for c, t in pairs:
            m = mine.reshape((-1,) + (1,) * (c.ndim - 2))
            c[b, at] = torch.where(m, t.to(cd)[:, 0], c[b, at])
        return (p + 1 - off).clamp(0, n)
    p = (pos if isinstance(pos, int) else int(pos)) - off
    if 0 <= p < n:
        for c, t in pairs:
            c[:, p:p + 1] = t.to(cd)
    return min(max(p + 1, 0), n)


def _gqa_decode_seq(params, cfg: ModelConfig, x, cache: KVCache, pos,
                    positions, vector: bool, seq):
    """``gqa_decode`` on a cache that holds this rank's shard of the
    sequence (the "kv_seq" hint): the rank that holds the position writes
    the row, every rank attends its shard on the log-sum-exp instance, the
    ranks' softmaxes merge over the hint's axes (in f32, rounded to the
    compute dtype once); the gather-q case (q heads split over ``model``,
    KV heads not) attends every head and keeps the rank's own."""
    B = x.shape[0]
    q, k, v = _gqa_qkv(params, cfg, x, positions, all_kv=True)
    cd = compute_dtype()
    kv_len = _write_shard(((cache.k, k), (cache.v, v)), pos, positions,
                          vector, seq.offset(cache.k.shape[1]))
    tp = tp_layout()
    q_sh, kv_sh = _head_split(cfg, tp)
    gather = q_sh and not kv_sh
    hl = q.shape[2]
    if gather:
        q = MESH.all_gather(tp.mesh, q, "model", dim=2)
    H, D = q.shape[2], q.shape[3]
    KV = cache.k.shape[2]
    q = q.to(cache.k.dtype).reshape(B, KV, H // KV, D).contiguous()
    out, lse = flash_decode_blocks(q, cache.k, cache.v, kv_len, lse=True)
    out = MESH.softmax_merge(seq.mesh, out, lse, seq.axes).reshape(
        B, 1, H, D)
    if gather:
        out = out[:, :, tp.rank * hl:(tp.rank + 1) * hl]
    return _out_proj(params, cfg, out.to(cd).reshape(B, 1, -1)), cache


# ---------------------------------------------------------------------------
# Paged GQA: the cache is a page pool (P, page, KV, D) per layer plus
# per-request block tables (B, nblk), see repro_torch.serving.kvcache.
# ---------------------------------------------------------------------------

def _paged_kv_mod():
    from repro_torch.serving import kvcache  # deferred: serving imports models
    return kvcache


def gqa_decode_paged(params, cfg: ModelConfig, x, cache: KVCache,
                     block_tables, pos) -> Tuple[torch.Tensor, KVCache]:
    """x: (B, 1, d); cache: page pools (P, page, KV, D), or int8
    ``QuantKV`` pools; block_tables: (B, nblk) int32; pos: (B,)
    per-request write index. Writes the new row through the table in place
    (quantized, into int8 pools), then ``flash_decode_paged`` reads the
    pools through it, with no gather. q goes to the kernel in the pools'
    dtype, or for int8 pools in the compute dtype. With ``attn_repeat_kv``
    the kernel reads the unrepeated pools: query head i of group i // G
    meets KV head i // G, the head the repeat gives it."""
    KVC = _paged_kv_mod()
    B = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device)
    positions = pos[:, None]                                # (B, 1)
    q, k, v = _gqa_qkv(params, cfg, x, positions)
    valid = torch.ones((B, 1), dtype=torch.bool, device=x.device)
    KVC.paged_write(cache.k, k, block_tables, positions, valid)
    KVC.paged_write(cache.v, v, block_tables, positions, valid)
    H, D = q.shape[2], q.shape[3]
    quant = isinstance(cache.k, KVC.QuantKV)
    KV = (cache.k.codes if quant else cache.k).shape[2]
    qd = compute_dtype() if quant else cache.k.dtype
    out = flash_decode_paged(
        q.to(qd).reshape(B, KV, H // KV, D), cache.k, cache.v,
        block_tables.to(torch.int32).contiguous(), pos + 1)
    return dense(out.reshape(B, 1, -1), params["wo"]), cache


def gqa_prefill_chunk(params, cfg: ModelConfig, x, cache: KVCache,
                      block_tables, start, kv_len
                      ) -> Tuple[torch.Tensor, KVCache]:
    """One chunk of a paged prefill. x: (B, C, d), rows at absolute
    positions ``start + i``; rows at positions >= ``kv_len`` are padding
    (their K/V land in the scratch page, their outputs are garbage the
    caller discards). ``kv_len`` is the total valid length including this
    chunk. The query offset is plain torch, as in the reference: gather the
    pages (dequantized, from int8 pools), then ``_attend_block`` with the
    probabilities kept in f32, as ``flash_prefill`` keeps them for the
    lane engine."""
    KVC = _paged_kv_mod()
    B, C, _ = x.shape
    positions = start + torch.arange(C, device=x.device)   # (C,)
    q, k, v = _gqa_qkv(params, cfg, x, positions)
    posg = positions[None].expand(B, C)
    valid = posg < kv_len
    KVC.paged_write(cache.k, k, block_tables, posg, valid)
    KVC.paged_write(cache.v, v, block_tables, posg, valid)
    kk = KVC.paged_gather(cache.k, block_tables)
    vv = KVC.paged_gather(cache.v, block_tables)
    out = _attend_block(q, _maybe_repeat_kv(cfg, kk),
                        _maybe_repeat_kv(cfg, vv), positions,
                        torch.arange(kk.shape[1], device=x.device),
                        causal=cfg.causal, prefix_len=0, kv_len=kv_len,
                        f32_probs=True)
    return dense(out.reshape(B, C, -1), params["wo"]), cache


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ModelConfig, *, lead=(),
             device="cuda") -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    lead = tuple(lead)
    p = {
        "w_dkv": glorot(gen, lead + (d, m.kv_lora_rank + m.qk_rope_head_dim),
                        device),
        "kv_norm": init_rms_norm(m.kv_lora_rank, lead=lead, device=device),
        "w_uk": glorot(gen, lead + (m.kv_lora_rank, H * m.qk_nope_head_dim),
                       device),
        "w_uv": glorot(gen, lead + (m.kv_lora_rank, H * m.v_head_dim),
                       device),
        "wo": glorot(gen, lead + (H * m.v_head_dim, d), device),
    }
    if m.q_lora_rank:
        p["wq_a"] = glorot(gen, lead + (d, m.q_lora_rank), device)
        p["q_norm"] = init_rms_norm(m.q_lora_rank, lead=lead, device=device)
        p["wq_b"] = glorot(gen, lead + (m.q_lora_rank, H * qk_dim), device)
    else:
        p["wq"] = glorot(gen, lead + (d, H * qk_dim), device)
    return p


def _mla_split(cfg: ModelConfig, tp) -> Tuple[bool, bool]:
    """Under the "tp" hint: (the heads split over ``model``: wq, w_uk,
    w_uv column-parallel and wo row-parallel, all by the same heads; the
    latent cache's rank dim split over ``model``, as ``kv_cache_spec``
    lays it out)."""
    m = cfg.mla
    H = cfg.num_heads
    heads = tp.sharded(tp.spec("w_uk", (m.kv_lora_rank,
                                        H * m.qk_nope_head_dim)), -1)
    if heads and H % tp.tp:
        raise ValueError(f"{cfg.name}: {H} MLA heads split over a model "
                         f"axis of {tp.tp} would cut a head")
    return heads, tp.tp > 1 and m.kv_lora_rank % tp.tp == 0


def _mla_col(params, name: str, x, shape, tp, gather: bool = False):
    """x @ params[name]; under the "tp" hint column-parallel (the rank's
    columns, x through ``copy_to``), all-gathered over ``model`` with
    ``gather``."""
    if tp is None:
        return dense(x, params[name])
    y, col = tp_column(x, params[name], name, shape, tp)
    if col and gather:
        y = MESH.gather_from(tp.mesh, y, "model", -1)
    return y


def _mla_q(params, cfg: ModelConfig, x, positions):
    """(q_nope (B, S, H, nope), q_rope (B, S, H, rope) roped), in the
    compute dtype; under the "tp" hint the rank's heads."""
    m = cfg.mla
    B, S, d = x.shape
    tp = tp_layout()
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    H = cfg.num_heads
    if m.q_lora_rank:
        qa = _mla_col(params, "wq_a", x, (d, m.q_lora_rank), tp,
                      gather=True)
        qa = rms_norm(qa, params["q_norm"]["scale"], cfg.norm_eps)
        q = _mla_col(params, "wq_b", qa, (m.q_lora_rank, H * qk), tp)
    else:
        q = _mla_col(params, "wq", x, (d, H * qk), tp)
    q = q.reshape(B, S, -1, qk)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim],
                                 dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_ckv(params, cfg: ModelConfig, x, positions):
    """(c_kv (B, S, rank) normed, k_rope (B, S, rope) roped as one head),
    in the compute dtype. Under the "tp" hint every rank computes both
    whole (``w_dkv`` is replicated over ``model``); where the heads are
    split, each rank's heads use them, so they go through ``copy_to``."""
    m = cfg.mla
    tp = tp_layout()
    w = params["w_dkv"]
    if tp is not None:
        w, _ = tp.weight(w, "w_dkv", (cfg.d_model,
                                      m.kv_lora_rank + m.qk_rope_head_dim))
    ckv_full = dense(x, w)
    c_kv, k_rope = torch.split(ckv_full, [m.kv_lora_rank,
                                          m.qk_rope_head_dim], dim=-1)
    c_kv = rms_norm(c_kv, params["kv_norm"]["scale"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    if tp is not None and _mla_split(cfg, tp)[0]:
        c_kv = MESH.copy_to(tp.mesh, c_kv, "model")
        k_rope = MESH.copy_to(tp.mesh, k_rope, "model")
    return c_kv, k_rope


def _mla_up(params, cfg: ModelConfig, name: str, head_dim: int):
    """The raw ``w_uk``/``w_uv`` leaf, (rank, H * head_dim); under the
    "tp" hint the rank's heads' columns, FSDP rows gathered."""
    w = params[name]
    tp = tp_layout()
    if tp is None:
        return w
    return tp.weight(w, name, (cfg.mla.kv_lora_rank,
                               cfg.num_heads * head_dim))[0]


def _mla_expand_kv(params, cfg: ModelConfig, c_kv, k_rope):
    """Per-head K (B, S, H, nope + rope) and V (B, S, H, v) from the
    latents (train, prefill and chunk paths); under the "tp" hint the
    rank's heads."""
    m = cfg.mla
    B, S = c_kv.shape[:2]
    k_nope = dense(c_kv, _mla_up(params, cfg, "w_uk", m.qk_nope_head_dim))
    k_nope = k_nope.reshape(B, S, -1, m.qk_nope_head_dim)
    v = dense(c_kv, _mla_up(params, cfg, "w_uv", m.v_head_dim))
    v = v.reshape(B, S, -1, m.v_head_dim)
    k_rope_b = k_rope[:, :, None, :].expand(B, S, v.shape[2],
                                            m.qk_rope_head_dim)
    return torch.cat([k_nope, k_rope_b], dim=-1), v


def _mla_out(params, cfg: ModelConfig, o):
    """o @ wo; under the "tp" hint row-parallel over the heads."""
    tp = tp_layout()
    if tp is None:
        return dense(o, params["wo"])
    return tp_row(o, params["wo"], "wo",
                  (cfg.num_heads * cfg.mla.v_head_dim, cfg.d_model), tp)


def mla_train(params, cfg: ModelConfig, x, *, q_chunk=512, prefix_len=0):
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    q_nope, q_rope = _mla_q(params, cfg, x, positions)
    c_kv, k_rope = _mla_ckv(params, cfg, x, positions)
    k, v = _mla_expand_kv(params, cfg, c_kv, k_rope)
    out = chunked_attention(torch.cat([q_nope, q_rope], dim=-1), k, v,
                            causal=cfg.causal, q_chunk=q_chunk,
                            prefix_len=prefix_len)
    return _mla_out(params, cfg, out.reshape(B, S, -1))


def _mla_cache_cols(cfg: ModelConfig, c_kv):
    """The latent columns this rank's cache holds: all of them, or under
    the "tp" hint with the rank dim split its slice."""
    tp = tp_layout()
    if tp is None or not _mla_split(cfg, tp)[1]:
        return c_kv
    rl = cfg.mla.kv_lora_rank // tp.tp
    return c_kv[..., tp.rank * rl:(tp.rank + 1) * rl]


def mla_prefill(params, cfg: ModelConfig, x, cache_size: int, *,
                q_chunk=512) -> Tuple[torch.Tensor, KVCache]:
    """The prompt's attention and a latent cache of ``cache_size`` rows;
    under the "tp" hint the rank's heads and its latent columns, under the
    "kv_seq" hint the rows of the sequence the rank holds."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    q_nope, q_rope = _mla_q(params, cfg, x, positions)
    c_kv, k_rope = _mla_ckv(params, cfg, x, positions)
    k, v = _mla_expand_kv(params, cfg, c_kv, k_rope)
    out = chunked_attention(torch.cat([q_nope, q_rope], dim=-1), k, v,
                            causal=True, q_chunk=q_chunk)
    seq, start = seq_layout(), 0
    if seq is not None:
        cache_size = seq.local_len(cache_size)
        start = min(seq.offset(cache_size), S)
    c_kv = _mla_cache_cols(cfg, c_kv)
    cd = compute_dtype()
    cc = torch.zeros((B, cache_size, c_kv.shape[-1]), dtype=cd,
                     device=x.device)
    cr = torch.zeros((B, cache_size, k_rope.shape[-1]), dtype=cd,
                     device=x.device)
    rows = min(S - start, cache_size)
    cc[:, :rows] = c_kv[:, start:start + rows].to(cd)
    cr[:, :rows] = k_rope[:, start:start + rows].to(cd)
    return _mla_out(params, cfg, out.reshape(B, S, -1)), KVCache(cc, cr)


def _mla_q_eff(params, cfg: ModelConfig, q_nope):
    """q_nope (B, 1, H, nope) taken into the latent space through the raw
    f32 w_uk (rank, H, nope): (B, 1, H, rank), f32 (the rank's heads
    under the "tp" hint)."""
    m = cfg.mla
    w_uk = _mla_up(params, cfg, "w_uk", m.qk_nope_head_dim).reshape(
        m.kv_lora_rank, -1, m.qk_nope_head_dim)
    return torch.einsum("bqhn,rhn->bqhr", q_nope.float(), w_uk.float())


def _mla_scale(cfg: ModelConfig) -> float:
    """1 / sqrt(qk_nope + qk_rope), rounded in f32."""
    m = cfg.mla
    return float(np.float32(1.0) / np.sqrt(
        np.float32(m.qk_nope_head_dim + m.qk_rope_head_dim)))


def _mla_latent_probs(cfg: ModelConfig, q_eff, q_rope, cc, cr, last):
    """Softmax of q_eff . c_kv + q_rope . k_rope, f32, scaled by
    1 / sqrt(qk_nope + qk_rope) rounded in f32, over positions <= ``last``
    (a scalar or (B, 1, 1, 1)): (B, H, 1, S)."""
    scores = (torch.einsum("bqhr,bsr->bhqs", q_eff, cc.float())
              + torch.einsum("bqhd,bsd->bhqs", q_rope.float(),
                             cr.float())) * _mla_scale(cfg)
    valid = torch.arange(cc.shape[1], device=cc.device)[
        None, None, None, :] <= last
    return torch.softmax(scores.masked_fill(~valid, NEG_INF), dim=-1)


def _mla_latent_out(params, cfg: ModelConfig, probs, cc):
    """probs . c_kv, then out of the latent space through the raw f32
    w_uv (rank, H, v): (B, 1, H, v) in the compute dtype."""
    out_lat = torch.einsum("bhqs,bsr->bqhr", probs, cc.float())
    return _mla_uv(params, cfg, out_lat)


def _mla_uv(params, cfg: ModelConfig, out_lat):
    """(B, 1, H, rank) f32 latents out through the raw f32 w_uv: (B, 1,
    H, v) in the compute dtype."""
    m = cfg.mla
    w_uv = _mla_up(params, cfg, "w_uv", m.v_head_dim).reshape(
        m.kv_lora_rank, -1, m.v_head_dim)
    return torch.einsum("bqhr,rhv->bqhv", out_lat,
                        w_uv.float()).to(compute_dtype())


def _mla_absorbed(params, cfg: ModelConfig, q_nope, q_rope, cc, cr, last):
    """The matrix-absorbed single-query attention over the latents cc
    (B, S, rank) and cr (B, S, rope), then ``wo``."""
    B = q_nope.shape[0]
    q_eff = _mla_q_eff(params, cfg, q_nope)
    probs = _mla_latent_probs(cfg, q_eff, q_rope, cc, cr, last)
    out = _mla_latent_out(params, cfg, probs, cc)
    return dense(out.reshape(B, 1, -1), params["wo"])


def _mla_write(cache: KVCache, c_kv, k_rope, pos, positions,
               vector: bool):
    """One decode step's latents into the contiguous cache, in place: at
    the (B, 1) per-request ``positions``, or at the shared index ``pos``."""
    cd = compute_dtype()
    if vector:
        b = torch.arange(c_kv.shape[0], device=c_kv.device)
        cache.k[b, positions[:, 0]] = c_kv.to(cd)[:, 0]
        cache.v[b, positions[:, 0]] = k_rope.to(cd)[:, 0]
    else:
        p = pos if isinstance(pos, int) else int(pos)
        cache.k[:, p:p + 1] = c_kv.to(cd)
        cache.v[:, p:p + 1] = k_rope.to(cd)


def mla_decode(params, cfg: ModelConfig, x, cache: KVCache, pos
               ) -> Tuple[torch.Tensor, KVCache]:
    """Matrix-absorbed decode. x: (B, 1, d); cache.k = c_kv (B, S, rank),
    cache.v = k_rope (B, S, rope); pos a scalar or (B,) per-request
    indices. Writes the cache in place and returns it. Under the "tp"
    hint, ``_mla_decode_tp``."""
    B = x.shape[0]
    positions, vector = _decode_positions(pos, B, x.device)
    q_nope, q_rope = _mla_q(params, cfg, x, positions)
    c_kv, k_rope = _mla_ckv(params, cfg, x, positions)
    tp = tp_layout()
    if tp is not None:
        return _mla_decode_tp(params, cfg, tp, q_nope, q_rope, c_kv, k_rope,
                              cache, pos, positions, vector), cache
    _mla_write(cache, c_kv, k_rope, pos, positions, vector)
    last = positions[:, 0, None, None, None] if vector else positions[0]
    return _mla_absorbed(params, cfg, q_nope, q_rope, cache.k, cache.v,
                         last), cache


def _mla_decode_tp(params, cfg: ModelConfig, tp, q_nope, q_rope, c_kv,
                   k_rope, cache: KVCache, pos, positions, vector: bool):
    """The absorbed decode on one rank's shards: its heads of wq, w_uk,
    w_uv and wo, its columns of the latent cache's rank dim (``model``),
    and under the "kv_seq" hint its rows of the sequence. The scores
    contract over the rank dim, which the cache splits, while the weights
    split heads: q_eff and q_rope are all-gathered over ``model`` (every
    head), each rank scores its latent columns and the partial scores are
    all-reduced over ``model`` in f32, so every rank takes the same
    softmax; its partial probs . c_kv is all-gathered over the rank dim,
    and the rank keeps its own heads for w_uv and the row-parallel wo.
    Over a sequence-sharded cache each rank's softmax covers its rows,
    and the ranks' latent outputs merge by their log-sum-exp
    (``launch.mesh.softmax_merge``) before w_uv."""
    B = q_nope.shape[0]
    heads, cols = _mla_split(cfg, tp)
    seq = seq_layout()
    n = cache.k.shape[1]
    off = seq.offset(n) if seq is not None else 0
    _write_shard(((cache.k, _mla_cache_cols(cfg, c_kv)), (cache.v, k_rope)),
                 pos, positions, vector, off)
    q_eff = _mla_q_eff(params, cfg, q_nope)               # (B, 1, hl, r)
    hl = q_eff.shape[2]
    if heads:
        q_eff = MESH.all_gather(tp.mesh, q_eff, "model", dim=2)
        q_rope = MESH.all_gather(tp.mesh, q_rope, "model", dim=2)
    rl = cache.k.shape[-1]
    if cols:
        q_eff = q_eff[..., tp.rank * rl:(tp.rank + 1) * rl]
    nope = torch.einsum("bqhr,bsr->bhqs", q_eff, cache.k.float())
    if cols:
        nope = MESH.all_reduce(tp.mesh, nope, "model")
    scores = (nope + torch.einsum("bqhd,bsd->bhqs", q_rope.float(),
                                  cache.v.float())) * _mla_scale(cfg)
    last = positions[:, 0, None, None, None] if vector else positions[0]
    valid = off + torch.arange(n, device=scores.device)[
        None, None, None, :] <= last                       # (B|1,1,1,n)
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out_lat = torch.einsum("bhqs,bsr->bqhr", probs, cache.k.float())
    if seq is not None:
        lse = torch.logsumexp(scores, dim=-1).transpose(1, 2)  # (B, 1, H)
        lse = lse.masked_fill(~valid.any(-1), float("-inf"))
        out_lat = MESH.softmax_merge(seq.mesh, out_lat, lse, seq.axes)
    if cols:
        out_lat = MESH.all_gather(tp.mesh, out_lat, "model", dim=-1)
    if heads:
        out_lat = out_lat[:, :, tp.rank * hl:(tp.rank + 1) * hl]
    out = _mla_uv(params, cfg, out_lat)
    return _mla_out(params, cfg, out.reshape(B, 1, -1))


def _mla_page_write(cache: KVCache, c_kv, k_rope, block_tables, positions,
                    valid) -> None:
    """Latent rows into their pages, in place (quantized, into int8
    ``QuantKV`` pools: one scale a latent row and one a rope row)."""
    KVC = _paged_kv_mod()
    KVC.paged_write(cache.k, c_kv, block_tables, positions, valid)
    KVC.paged_write(cache.v, k_rope, block_tables, positions, valid)


def mla_decode_paged(params, cfg: ModelConfig, x, cache: KVCache,
                     block_tables, pos) -> Tuple[torch.Tensor, KVCache]:
    """Matrix-absorbed paged decode: cache.k pools c_kv (P, page, rank),
    cache.v pools k_rope (P, page, rope), bf16/f32 or int8 ``QuantKV``;
    the new row written through the table, then the absorbed attention
    on the gathered (dequantized) latents."""
    KVC = _paged_kv_mod()
    B = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device)
    positions = pos[:, None]
    q_nope, q_rope = _mla_q(params, cfg, x, positions)
    c_kv, k_rope = _mla_ckv(params, cfg, x, positions)
    valid = torch.ones((B, 1), dtype=torch.bool, device=x.device)
    _mla_page_write(cache, c_kv, k_rope, block_tables, positions, valid)
    cc = KVC.paged_gather(cache.k, block_tables)          # (B, S_max, rank)
    cr = KVC.paged_gather(cache.v, block_tables)
    return _mla_absorbed(params, cfg, q_nope, q_rope, cc, cr,
                         pos[:, None, None, None]), cache


def mla_prefill_chunk(params, cfg: ModelConfig, x, cache: KVCache,
                      block_tables, start, kv_len
                      ) -> Tuple[torch.Tensor, KVCache]:
    """One chunk of a paged MLA prefill: write the chunk's latents, then
    attend with per-head K/V expanded from the gathered latent view."""
    KVC = _paged_kv_mod()
    B, C, _ = x.shape
    positions = start + torch.arange(C, device=x.device)
    q_nope, q_rope = _mla_q(params, cfg, x, positions)
    c_kv, k_rope = _mla_ckv(params, cfg, x, positions)
    posg = positions[None].expand(B, C)
    _mla_page_write(cache, c_kv, k_rope, block_tables, posg, posg < kv_len)
    k, v = _mla_expand_kv(params, cfg,
                          KVC.paged_gather(cache.k, block_tables),
                          KVC.paged_gather(cache.v, block_tables))
    out = _attend_block(torch.cat([q_nope, q_rope], dim=-1), k, v,
                        positions, torch.arange(k.shape[1], device=x.device),
                        causal=True, prefix_len=0, kv_len=kv_len)
    return dense(out.reshape(B, C, -1), params["wo"]), cache
