"""LM assembly for every family: embeddings (with the vision and audio
stubs), stages of stacked blocks, final norm and unembedding.

Port of ``repro/models/lm.py``. A model is a list of stages, each a
homogeneous stack of blocks:

  dense family    -> [("dense", L)]  (the vlm and audio families too)
  moe family      -> [("dense_first", first_dense)] + [("moe", rest)]
  ssm family      -> [("mamba", L)]
  hybrid (zamba2) -> [("hybrid", L)]  groups of ``hybrid_attn_every`` mamba
                     layers, each followed by the shared attention block

The parameter tree has the reference's structure and shapes: each
stage's layer parameters are stacked along a leading (L,) dim in
``params["stages"][i]``. The reference's ``lax.scan`` over that stack is
a Python loop over the same stacked tensors here; the KV cache is stacked
the same way, one ``KVCache`` of (L, B, S_max, KV, D) a stage (MLA: the
latents c_kv (L, B, S_max, rank) and k_rope (L, B, S_max, rope); a mamba
stage a ``MambaCache`` of the f32 state (L, B, H, P, N) and the conv
windows (L, B, d_conv - 1, C)), and written in place. A stage's kind
picks its block functions (``blocks.block_fns``). A hybrid stage's mamba
leaves are stacked (g, k, ...) over its g groups of k layers, and its one
shared block (``params["shared_attn"]``, no stacked dims) is fed
``concat(hidden, embedding)`` after each group; its cache is the
reference's nested {"mamba": MambaCache (g, k, B, ...), "attn": KVCache
(g, B, S_max, KV, D)}. ``layer_slice`` and ``_layer_cache`` take one
leading dim off, so a hybrid stage slices the group, then the layer. The
paged entry points cover the dense and MoE families and refuse the
others, as the reference's do. Under the launch layer's "tp" hint
(``launch.sharding.TPLayout``; every family) the parameters are one
rank's shards: the embedding is vocab-parallel (or d-sharded, the
reference's fallback), the blocks tensor-parallel, the vision and audio
stubs replicated activations, the loss a vocab-parallel cross-entropy,
the serving logits gathered. In training, ``jax.checkpoint`` around
the scanned layer becomes ``torch.utils.checkpoint`` around each layer
(a hybrid stage's around each group, as the reference's), under
``cfg.remat`` ("full", "dots" or "none"), and around each chunk of the
loss; MoE stages add their load-balance aux, and ``train_loss`` adds
0.01 of it to the loss. A vision batch's ``patch_embeds`` are a
prefix-LM prefix before its tokens (its loss counts the text only); an
audio batch's ``frame_embeds`` replace the token embeddings.

Entry points:
  init_params(cfg, seed, device)                  -> params
  train_loss(params, cfg, batch)                  -> (loss, metrics)
  encode(params, cfg, batch)                      -> logits (B, S, V), no
                                                     cache (encoder only)
  prefill(params, cfg, batch, cache_size)         -> (last_logits, caches)
  decode_step(params, cfg, tokens, caches, pos[, block_tables])
                                                  -> (logits, caches)
  prefill_chunk(params, cfg, tokens, caches, block_tables, start, valid)
                                                  -> (last_logits, caches)
  init_cache(cfg, batch, cache_size, device)      -> caches (zeros)
  init_paged_cache(cfg, num_pages, page_size, device, quant)
                                                  -> page pools (zeros; int8
                                                     QuantKV with quant)
  cache_batch_axes(cfg)                           -> batch axis per leaf
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models.attention import KVCache, padded_heads
from repro_torch.models.mamba2 import MambaCache
from repro_torch.models.mamba2 import dims as mamba_dims
from repro_torch.models.layers import (compute_dtype, embed, embed_tp,
                                       init_embedding, init_rms_norm,
                                       normal_init, rms_norm, tp_layout,
                                       tp_logits, tp_unembed_weight,
                                       token_nll, unembed,
                                       vocab_parallel_nll)
from repro_torch.launch import mesh as MESH


def stage_plan(cfg: ModelConfig) -> List[Tuple[str, int]]:
    if cfg.family == "ssm":
        return [("mamba", cfg.num_layers)]
    if cfg.family == "hybrid":
        return [("hybrid", cfg.num_layers)]
    if cfg.attn_type in ("gqa", "mla"):
        if cfg.family in ("dense", "vlm", "audio"):
            return [("dense", cfg.num_layers)]
        if cfg.family == "moe":
            # a config cut to its first dense layers has no MoE stage (the
            # reference's plan keeps an empty one, which its scan skips)
            fd = cfg.moe.first_dense_layers
            rest = cfg.num_layers - fd
            return ([("dense_first", fd)] if fd else []) + (
                [("moe", rest)] if rest else [])
    raise NotImplementedError(
        f"family {cfg.family!r} / attn_type {cfg.attn_type!r} has no "
        f"stage plan")


def _groups(cfg: ModelConfig, n: int) -> Tuple[int, int]:
    """(g, k): a hybrid stage of ``n`` layers as g groups of k mamba
    layers."""
    k = cfg.hybrid_attn_every
    if k < 1 or n % k:
        raise ValueError(f"layers {n} % hybrid_attn_every {k} != 0")
    return n // k, k


def _init_stage(gen, cfg: ModelConfig, kind: str, n: int, device):
    if kind == "hybrid":
        return B.init_mamba_block(gen, cfg, lead=_groups(cfg, n),
                                  device=device)
    if kind == "mamba":
        return B.init_mamba_block(gen, cfg, lead=(n,), device=device)
    if kind == "moe":
        return B.init_moe_block(gen, cfg, lead=(n,), device=device)
    d_ff = cfg.moe.first_dense_d_ff if kind == "dense_first" else None
    return B.init_dense_block(gen, cfg, d_ff=d_ff, lead=(n,), device=device)


class LayerList(list):
    """One stacked (L, ...) leaf given as its L layers, each its own tensor:
    hook-mode training differentiates each layer's weight as a leaf of its
    own (``runtime.trainer.dense_grads``)."""


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (side-delta and SHiRA
    bundles too: every tensor carries the leading layer dim; a bundle's
    plain numbers pass through; a ``LayerList`` gives its i-th entry).
    Of a hybrid stage's (g, k, ...) tree it gives group ``i``, whose
    layers a second call slices."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, (torch.Tensor, LayerList)):
        return tree[i]
    return tree


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"
                ) -> Dict[str, Any]:
    """Random parameters from a seeded ``torch.Generator`` on ``device``.
    The tree and shapes equal ``repro.models.lm.init_params``'s; the draws
    do not (tests cross weights over with ``repro_torch.bridge``)."""
    plan = stage_plan(cfg)
    # "meta" (the dry run's abstract parameters) draws nothing: a CPU
    # generator stands in
    meta = torch.device(device).type == "meta"
    gen = torch.Generator(device="cpu" if meta else device)
    gen.manual_seed(seed)
    params: Dict[str, Any] = {
        "embed": init_embedding(gen, cfg.padded_vocab, cfg.d_model, device),
        "final_norm": init_rms_norm(cfg.d_model, device=device),
        "stages": [_init_stage(gen, cfg, kind, n, device)
                   for kind, n in plan],
    }
    if not cfg.tie_embeddings:
        params["unembed"] = {"lm_head": normal_init(
            gen, (cfg.d_model, cfg.padded_vocab), 0.02, device)}
    if cfg.family == "hybrid":
        params["shared_attn"] = B.init_shared_attn(gen, cfg, device)
    return params


def embed_inputs(params, cfg: ModelConfig, batch) -> Tuple[torch.Tensor, int]:
    """Returns (h, prefix_len): the token embeddings (text); the frame
    embeddings in the compute dtype (audio); or the patch embeddings in
    the compute dtype prepended to the token embeddings, the patches
    being the prefix (vision)."""
    if cfg.modality == "audio":
        return batch["frame_embeds"].to(compute_dtype()), 0
    h = _embed(params, cfg, batch["tokens"])
    if cfg.modality == "vision":
        patches = batch["patch_embeds"].to(device=h.device,
                                           dtype=compute_dtype())
        return torch.cat([patches, h], dim=1), patches.shape[1]
    return h, 0


def _embed(params, cfg: ModelConfig, tokens):
    tp = tp_layout()
    if tp is None:
        return embed(params["embed"], tokens)
    return embed_tp(params["embed"], tokens, cfg.padded_vocab, cfg.d_model,
                    tp)


def _tp_unembed(params, cfg: ModelConfig, tp):
    tie = params["embed"] if cfg.tie_embeddings else None
    return tp_unembed_weight(params.get("unembed"), tie, cfg.padded_vocab,
                             cfg.d_model, tp)


def _logits(params, cfg: ModelConfig, h):
    """Serving logits (..., padded vocab); under the "tp" hint the rank's
    vocabulary columns, all-gathered over ``model``."""
    tp = tp_layout()
    if tp is not None:
        w, v0, vp = _tp_unembed(params, cfg, tp)
        logits = tp_logits(h, w, v0, cfg.logit_softcap, cfg.vocab_size)
        if vp:
            logits = MESH.all_gather(tp.mesh, logits, "model", -1)
        return logits
    tie = params["embed"]["emb"] if cfg.tie_embeddings else None
    return unembed(params.get("unembed"), h, tie_to=tie,
                   softcap=cfg.logit_softcap, logical_vocab=cfg.vocab_size)


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------

# The reference's "dots" policy (``dots_with_no_batch_dims_saveable``)
# keeps the products without a batch dimension: here the 2-D-weight
# products of ``pdot``, which reach the dispatcher as ``mm``/``addmm``.
# Batched products (attention, experts) and everything else recompute.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn, cfg: ModelConfig):
    """remat="full" (the default) recomputes ``fn`` in backward; "dots"
    keeps its matmul outputs and recomputes the rest; "none" keeps its
    activations."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _dots_policy)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=ctx)
    if cfg.remat != "full":
        raise ValueError(f"remat must be 'full', 'dots' or 'none', got "
                         f"{cfg.remat!r}")
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


def _stage_train(stage_params, kind: str, cfg: ModelConfig, h, aux,
                 prefix_len, n: int, shared=None):
    """The ``n`` stacked layers of one stage of ``kind``, each
    (re)materialized under ``cfg.remat``: the layer's weights, SHiRA
    bundles included, are sliced outside and used inside, so in backward
    only one layer's effective weights are alive at a time. A layer's FFN
    (dense or MoE) is its parameters' own (``blocks``). A hybrid stage
    runs its groups, each (re)materialized whole as the reference's scan
    body is: k mamba layers, then the ``shared`` block fed the stage's
    input as the embedding stream."""
    if kind == "hybrid":
        emb = h
        g, k = _groups(cfg, n)

        def group(gp, hh):
            for i in range(k):
                hh, _ = B.mamba_block_train(layer_slice(gp, i), cfg, hh)
            return B.shared_attn_train(shared, cfg, hh, emb)

        group = _maybe_remat(group, cfg)
        for j in range(g):
            h = group(layer_slice(stage_params, j), h)
        return h, aux
    train_fn = B.block_fns(kind)[0]

    def body(lp, hh, ax):
        return train_fn(lp, cfg, hh, prefix_len=prefix_len, aux=ax)

    body = _maybe_remat(body, cfg)
    for i in range(n):
        h, aux = body(layer_slice(stage_params, i), h, aux)
    return h, aux


def _pick_chunk(total: int, target: int = 32_768) -> int:
    c = min(total, target)
    while total % c:
        c -= 1
    return c


def _loss_chunks(params, cfg: ModelConfig, h, chunk_fn, *xs):
    """Run ``chunk_fn(logits, *x_chunks)`` over row chunks of the flattened
    hidden states under a checkpoint, so one chunk's (rows, padded vocab)
    logits are alive at a time; returns the per-chunk results."""
    Bq, S, d = h.shape
    T = Bq * S
    hf = h.reshape(T, d)
    tie = params["embed"]["emb"] if cfg.tie_embeddings else None
    un = params.get("unembed")
    c = _pick_chunk(T)

    def body(hc, *xc):
        logits = unembed(un, hc, tie_to=tie, softcap=cfg.logit_softcap,
                         logical_vocab=cfg.vocab_size)
        return chunk_fn(logits, *xc)

    return [checkpoint(body, hf[i:i + c], *(x[i:i + c] for x in xs),
                       use_reentrant=False)
            for i in range(0, T, c)]


def _loss_chunks_tp(params, cfg: ModelConfig, h, tp, labels, mf):
    """``_loss_chunks`` of the masked NLL sum under the "tp" hint: the
    unembedding gathered once (FSDP), each chunk's logits over this
    rank's vocabulary columns and the vocab-parallel NLL
    (``layers.vocab_parallel_nll``), or over the whole vocabulary where
    the unembedding is not vocab-parallel."""
    Bq, S, d = h.shape
    T = Bq * S
    hf = h.reshape(T, d)
    w, v0, vp = _tp_unembed(params, cfg, tp)
    c = _pick_chunk(T)

    def body(hc, lc, mc, ww):
        if vp:
            hc = MESH.copy_to(tp.mesh, hc, "model")
        logits = tp_logits(hc, ww, v0, cfg.logit_softcap, cfg.vocab_size)
        nll = (vocab_parallel_nll(logits, lc, v0, tp.mesh) if vp
               else token_nll(logits, lc))
        return (nll * mc).sum()

    return [checkpoint(body, hf[i:i + c], labels[i:i + c], mf[i:i + c], w,
                       use_reentrant=False)
            for i in range(0, T, c)]


def chunked_loss(params, cfg: ModelConfig, h, labels,
                 loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL; never materialises the full (T, vocab) logits."""
    T = h.shape[0] * h.shape[1]
    mf = (torch.ones((T,), dtype=torch.float32, device=h.device)
          if loss_mask is None else loss_mask.reshape(T).float())
    tp = tp_layout()
    if tp is not None:
        parts = _loss_chunks_tp(params, cfg, h, tp, labels.reshape(T), mf)
        return torch.stack(parts).sum() / torch.clamp(mf.sum(), min=1.0)
    parts = _loss_chunks(params, cfg, h,
                         lambda lg, lc, mc: (token_nll(lg, lc) * mc).sum(),
                         labels.reshape(T), mf)
    return torch.stack(parts).sum() / torch.clamp(mf.sum(), min=1.0)


def train_loss(params, cfg: ModelConfig, batch) -> Tuple[torch.Tensor, Dict]:
    h, prefix_len = embed_inputs(params, cfg, batch)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for sp, (kind, n) in zip(params["stages"], stage_plan(cfg)):
        h, aux = _stage_train(sp, kind, cfg, h, aux, prefix_len, n,
                              shared=params.get("shared_attn"))
    h = rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    h = h[:, prefix_len:]               # a vision loss is over the text
    ce = chunked_loss(params, cfg, h, batch["labels"],
                      batch.get("loss_mask"))
    return with_aux(cfg, ce, aux), {"ce": ce, "aux": aux}


@torch.no_grad()
def encode(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Encoder-only serving (hubert): full-sequence logits (B, S, padded
    vocab), no cache. It runs one dense GQA stage, the plan of every
    encoder-only config, each block's attention through
    ``blocks.block_encode`` (``flash_prefill_blocks``, bidirectional for
    hubert); another plan raises."""
    plan = stage_plan(cfg)
    if cfg.attn_type != "gqa" or plan != [("dense", cfg.num_layers)]:
        raise NotImplementedError(
            f"lm.encode runs one dense GQA stage; {cfg.name} plans {plan} "
            f"with attn_type {cfg.attn_type!r}")
    h, prefix_len = embed_inputs(params, cfg, batch)
    sp = params["stages"][0]
    for i in range(cfg.num_layers):
        h = B.block_encode(layer_slice(sp, i), cfg, h, prefix_len=prefix_len)
    h = rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    return _logits(params, cfg, h)


def with_aux(cfg: ModelConfig, loss, aux):
    """The training loss: an MoE model adds 0.01 of its load-balance
    aux."""
    if cfg.family == "moe" or (cfg.moe and cfg.moe.num_experts):
        return loss + 0.01 * aux
    return loss


# ---------------------------------------------------------------------------
# Serve
# ---------------------------------------------------------------------------

def _stacked(caches):
    """Caches of one type (KVCache, MambaCache), each field stacked over
    the list."""
    return type(caches[0])(*(torch.stack(f) for f in zip(*caches)))


def _hybrid_prefill(sp, cfg: ModelConfig, h, cache_size, n, shared):
    """A hybrid stage's prefill: per group, k mamba layers then the shared
    block; returns (h, the stage's nested cache)."""
    emb = h
    g, k = _groups(cfg, n)
    mamba, attn = [], []
    for j in range(g):
        gp = layer_slice(sp, j)
        layers = []
        for i in range(k):
            h, c = B.mamba_block_prefill(layer_slice(gp, i), cfg, h,
                                         cache_size)
            layers.append(c)
        mamba.append(_stacked(layers))
        h, c = B.shared_attn_prefill(shared, cfg, h, emb, cache_size)
        attn.append(c)
    return h, {"mamba": _stacked(mamba), "attn": _stacked(attn)}


def _hybrid_decode(sp, cfg: ModelConfig, h, cache, n, pos, shared):
    """A hybrid stage's decode step, its nested cache written in place:
    per group, k mamba layers then the shared block."""
    emb = h
    g, k = _groups(cfg, n)
    for j in range(g):
        gp, mc = layer_slice(sp, j), _layer_cache(cache["mamba"], j)
        for i in range(k):
            h, _ = B.mamba_block_decode(layer_slice(gp, i), cfg, h,
                                        _layer_cache(mc, i), pos)
        h, _ = B.shared_attn_decode(shared, cfg, h, emb,
                                    _layer_cache(cache["attn"], j), pos)
    return h


def prefill(params, cfg: ModelConfig, batch, cache_size: int):
    h, prefix_len = embed_inputs(params, cfg, batch)
    caches = []
    for sp, (kind, n) in zip(params["stages"], stage_plan(cfg)):
        if kind == "hybrid":
            h, c = _hybrid_prefill(sp, cfg, h, cache_size, n,
                                   params["shared_attn"])
            caches.append(c)
            continue
        prefill_fn = B.block_fns(kind)[1]
        layers = []
        for i in range(n):
            h, c = prefill_fn(layer_slice(sp, i), cfg, h, cache_size,
                              prefix_len=prefix_len)
            layers.append(c)
        # a stage's cache is its block's cache type (KVCache, MambaCache),
        # each field stacked over the layers
        caches.append(_stacked(layers))
    h = rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    return _logits(params, cfg, h[:, -1]), caches


def decode_step(params, cfg: ModelConfig, tokens, caches, pos,
                block_tables=None):
    """tokens: (B, 1) int; pos: int cache index shared by the batch, or a
    (B,) tensor of per-request indices. With ``block_tables`` ((B, nblk)
    int32) the caches are page pools (``init_paged_cache``) and ``pos`` is
    the (B,) per-request write index. Returns (logits (B, V), caches); the
    caches are updated in place. A hybrid model refuses block tables, as
    the reference's does."""
    if block_tables is not None and cfg.family == "hybrid":
        raise NotImplementedError("paged decode covers attention caches only")
    h = _embed(params, cfg, tokens)
    for sp, cache, (kind, n) in zip(params["stages"], caches,
                                    stage_plan(cfg)):
        if kind == "hybrid":
            h = _hybrid_decode(sp, cfg, h, cache, n, pos,
                               params["shared_attn"])
            continue
        decode_fn = B.block_fns(kind)[2]
        for i in range(n):
            h, _ = decode_fn(layer_slice(sp, i), cfg, h,
                             _layer_cache(cache, i), pos,
                             block_tables=block_tables)
    h = rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    return _logits(params, cfg, h[:, 0]), caches


def prefill_chunk(params, cfg: ModelConfig, tokens, caches, block_tables,
                  start: int, valid: int):
    """One chunk of a paged prefill. tokens: (B, C) int, columns at
    absolute positions ``start + i``; ``valid`` counts the real tokens
    (padding columns write to the scratch page and are masked out of
    attention). Returns (logits of the last real token (B, V), caches),
    the pools written in place."""
    if cfg.family not in ("dense", "moe") or cfg.modality != "text":
        raise NotImplementedError(
            "chunked paged prefill covers dense/moe text models")
    h = embed(params["embed"], tokens)
    kv_len = start + valid
    for sp, cache, (_, n) in zip(params["stages"], caches, stage_plan(cfg)):
        for i in range(n):
            h, _ = B.block_prefill_chunk(
                layer_slice(sp, i), cfg, h, _layer_cache(cache, i),
                block_tables, start, kv_len)
    h = rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    return _logits(params, cfg, h[:, valid - 1]), caches


def _layer_cache(cache, i: int):
    """Layer ``i`` of a stacked cache (a ``KVCache`` or a
    ``MambaCache``): each tensor's i-th entry, a view (an int8 pool, a
    ``QuantKV`` of stacked codes and scales, gives both). Of a hybrid
    stage's (g, k, B, ...) mamba leaves it gives group ``i``."""
    pick = lambda x: type(x)(*(t[i] for t in x)) if isinstance(
        x, tuple) else x[i]
    return type(cache)(*(pick(x) for x in cache))


def kv_tails(cfg: ModelConfig) -> KVCache:
    """The per-token tail of each cache leaf: (KV', D) for K and V, or
    MLA's latents, (rank,) for c_kv and (rope,) for k_rope."""
    if cfg.attn_type == "mla":
        m = cfg.mla
        return KVCache((m.kv_lora_rank,), (m.qk_rope_head_dim,))
    tail = (padded_heads(cfg)[1], cfg.resolved_head_dim)
    return KVCache(tail, tail)


def _kv_zeros(cfg: ModelConfig, rows: Tuple[int, int], device,
              quant: bool = False):
    """One stacked KVCache per stage: (L, *rows, *tail) zeros in the
    compute dtype, or with ``quant`` int8 ``QuantKV`` leaves (codes of
    that shape and bf16 scales (L, *rows, *tail[:-1], 1))."""
    if quant:
        # deferred: repro_torch.serving imports the models
        from repro_torch.serving.kvcache import quant_cache_zeros
        zeros = lambda shape: quant_cache_zeros(shape, device)
    else:
        zeros = lambda shape: torch.zeros(shape, dtype=compute_dtype(),
                                          device=device)
    return [KVCache(*(zeros((n,) + tuple(rows) + t) for t in kv_tails(cfg)))
            for _, n in stage_plan(cfg)]


def _mamba_zeros(cfg: ModelConfig, lead, bsz: int, device) -> MambaCache:
    """A mamba stage's cache: the f32 state (*lead, bsz, H, P, N) and the
    conv windows (*lead, bsz, d_conv - 1, C) in the compute dtype, zeros;
    ``lead`` is (L,), or a hybrid stage's (g, k)."""
    d_inner, n_heads, bc_dim = mamba_dims(cfg)
    s = cfg.ssm
    lead = tuple(lead)
    win = lambda c: torch.zeros(lead + (bsz, s.d_conv - 1, c),
                                dtype=compute_dtype(), device=device)
    return MambaCache(
        ssm=torch.zeros(lead + (bsz, n_heads, s.head_dim, s.d_state),
                        dtype=torch.float32, device=device),
        conv_x=win(d_inner), conv_bc=win(bc_dim))


def init_cache(cfg: ModelConfig, bsz: int, cache_size: int, device="cuda"):
    """Zero caches, one a stage: a KV stripe of ``cache_size`` rows a
    request, a mamba stage's O(1) state (``cache_size`` unused), or a
    hybrid stage's {"mamba": state (g, k, ...), "attn": the shared block's
    KV stripe at each of its g sites}."""
    if cfg.family == "ssm":
        return [_mamba_zeros(cfg, (n,), bsz, device)
                for _, n in stage_plan(cfg)]
    if cfg.family == "hybrid":
        out = []
        for _, n in stage_plan(cfg):
            g, k = _groups(cfg, n)
            out.append({"mamba": _mamba_zeros(cfg, (g, k), bsz, device),
                        "attn": KVCache(*(torch.zeros(
                            (g, bsz, cache_size) + t, dtype=compute_dtype(),
                            device=device) for t in kv_tails(cfg)))})
        return out
    return _kv_zeros(cfg, (bsz, cache_size), device)


def cache_batch_axes(cfg: ModelConfig):
    """Per stage, a cache tuple of the batch axis of each leaf: a dense or
    MoE stage's KV leaf is (L, B, S, KV, D), an MLA stage's (L, B, S,
    rank) and (L, B, S, rope), a mamba stage's (L, B, ...), so 1; a hybrid
    stage's mamba leaves (g, k, B, ...), 2, and its attention leaves
    (g, B, S, KV, D), 1. Lane splicing reads this metadata, not the
    shapes."""
    axes = {"mamba": MambaCache(1, 1, 1), "dense": KVCache(1, 1),
            "hybrid": {"mamba": MambaCache(2, 2, 2), "attn": KVCache(1, 1)}}
    return [axes.get(kind, axes["dense"]) for kind, _ in stage_plan(cfg)]


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device="cuda", quant: bool = False):
    """One page pool per stage, stacked over layers: (L, num_pages,
    page_size, *tail) zeros in the compute dtype (``kv_tails``: (KV, D),
    or MLA's (rank,) and (rope,)), or with ``quant`` int8 ``QuantKV``
    pools (codes of that shape and bf16 scales (L, num_pages, page_size,
    *tail[:-1], 1): one a head, or one a latent row and one a rope row).
    One (B, nblk) block table drives the whole stack. The other families
    refuse, with the reference's message."""
    if cfg.family not in ("dense", "moe") or cfg.modality != "text":
        raise NotImplementedError(
            "paged KV covers dense/moe text models; ssm/hybrid state is O(1) "
            "per request and vlm prefixes are not token-addressed")
    return _kv_zeros(cfg, (num_pages, page_size), device, quant)
