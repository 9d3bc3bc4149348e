"""The blocks: pre-norm GQA or MLA attention with a dense MLP or an MoE
FFN, and the Mamba2 block (norm + SSD mixer, no FFN).

Port of the dense, MoE and Mamba2 blocks of ``repro/models/blocks.py``.
A transformer block's FFN is its parameters' own: a dense block has
``mlp``, an MoE block ``moe``, so one function of each entry point
(``block_train``, ``block_encode``, ``block_prefill``, ``block_decode``,
``block_prefill_chunk``) serves both, where the reference has a
``dense_block_*`` and a ``moe_block_*`` of each. The attention is the
config's ``attn_type``: "gqa", or "mla" (deepseek-v2-lite-16b). A stage's
kind picks its functions (``block_fns``): "mamba" the ``mamba_block_*``
ones (mamba2-780m, ``attn_type="none"``), every other kind the
transformer's. zamba2's shared block (``init_shared_attn``,
``shared_attn_*``) is one dense GQA block whose weights serve every site
of the hybrid stack, fed ``concat(hidden, embedding)`` through
``w_fuse``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models.layers import (dense, glorot, init_mlp,
                                       init_rms_norm, mlp, rms_norm,
                                       tp_layout)
from repro_torch.models.moe import init_moe, moe_ffn


def _mla(cfg: ModelConfig) -> bool:
    if cfg.attn_type not in ("gqa", "mla"):
        raise NotImplementedError(
            f"attn_type {cfg.attn_type!r} has no transformer block")
    return cfg.attn_type == "mla"


def _init_block(gen: torch.Generator, cfg: ModelConfig, lead, device,
                ffn: str, make_ffn) -> dict:
    init = attn.init_mla if _mla(cfg) else attn.init_gqa
    return {
        "attn_norm": init_rms_norm(cfg.d_model, lead=lead, device=device),
        "attn": init(gen, cfg, lead=lead, device=device),
        "mlp_norm": init_rms_norm(cfg.d_model, lead=lead, device=device),
        ffn: make_ffn(),
    }


def init_dense_block(gen: torch.Generator, cfg: ModelConfig, *,
                     d_ff: Optional[int] = None, lead=(),
                     device="cuda") -> dict:
    """Parameters of ``lead`` stacked dense blocks (leading dims first);
    ``d_ff`` overrides the config's (an MoE model's first dense layers)."""
    return _init_block(gen, cfg, lead, device, "mlp", lambda: init_mlp(
        gen, cfg.d_model, d_ff or cfg.d_ff, cfg.act, lead=lead,
        device=device))


def init_moe_block(gen: torch.Generator, cfg: ModelConfig, *, lead=(),
                   device="cuda") -> dict:
    """Parameters of ``lead`` stacked MoE blocks."""
    return _init_block(gen, cfg, lead, device, "moe", lambda: init_moe(
        gen, cfg, lead=lead, device=device))


def _ffn(params, cfg: ModelConfig, h):
    """h + the block's FFN of its normed input, and the MoE aux loss (None
    for a dense block)."""
    x = rms_norm(h, params["mlp_norm"]["scale"], cfg.norm_eps)
    if "moe" in params:
        y, lb = moe_ffn(params["moe"], cfg, x)
        return h + y, lb
    return h + mlp(params["mlp"], x, cfg.act, dense_d_ff(cfg)), None


def dense_d_ff(cfg: ModelConfig) -> int:
    """The hidden width of a dense block's MLP: an MoE model's first dense
    layers take ``first_dense_d_ff`` (``lm._init_stage``)."""
    if cfg.family == "moe" and cfg.moe.first_dense_d_ff:
        return cfg.moe.first_dense_d_ff
    return cfg.d_ff


def block_train(params, cfg: ModelConfig, h, *, prefix_len=0, aux=None):
    x = rms_norm(h, params["attn_norm"]["scale"], cfg.norm_eps)
    fn = attn.mla_train if _mla(cfg) else attn.gqa_train
    h = h + fn(params["attn"], cfg, x, prefix_len=prefix_len)
    h, lb = _ffn(params, cfg, h)
    if lb is not None:
        aux = lb if aux is None else aux + lb
    return h, aux


def block_encode(params, cfg: ModelConfig, h, *, prefix_len=0):
    """A full-sequence GQA block with no cache (``lm.encode``)."""
    x = rms_norm(h, params["attn_norm"]["scale"], cfg.norm_eps)
    h = h + attn.gqa_encode(params["attn"], cfg, x, prefix_len=prefix_len)
    return _ffn(params, cfg, h)[0]


def block_prefill(params, cfg: ModelConfig, h, cache_size, *, prefix_len=0):
    x = rms_norm(h, params["attn_norm"]["scale"], cfg.norm_eps)
    if _mla(cfg):
        a, cache = attn.mla_prefill(params["attn"], cfg, x, cache_size)
    else:
        a, cache = attn.gqa_prefill(params["attn"], cfg, x, cache_size,
                                    prefix_len=prefix_len)
    return _ffn(params, cfg, h + a)[0], cache


def block_decode(params, cfg: ModelConfig, h, cache, pos,
                 block_tables=None):
    """One decode step; with ``block_tables`` the cache is a page pool
    (``attention.gqa_decode_paged`` / ``mla_decode_paged``)."""
    x = rms_norm(h, params["attn_norm"]["scale"], cfg.norm_eps)
    mla = _mla(cfg)
    if block_tables is not None:
        fn = attn.mla_decode_paged if mla else attn.gqa_decode_paged
        a, cache = fn(params["attn"], cfg, x, cache, block_tables, pos)
    else:
        fn = attn.mla_decode if mla else attn.gqa_decode
        a, cache = fn(params["attn"], cfg, x, cache, pos)
    return _ffn(params, cfg, h + a)[0], cache


def block_prefill_chunk(params, cfg: ModelConfig, h, cache, block_tables,
                        start, kv_len):
    """Paged chunk prefill: like ``block_prefill`` but writing one chunk
    of positions [start, kv_len) through a block table."""
    x = rms_norm(h, params["attn_norm"]["scale"], cfg.norm_eps)
    fn = attn.mla_prefill_chunk if _mla(cfg) else attn.gqa_prefill_chunk
    a, cache = fn(params["attn"], cfg, x, cache, block_tables, start,
                  kv_len)
    return _ffn(params, cfg, h + a)[0], cache


# ---------------------------------------------------------------------------
# Mamba2 block (norm + SSD mixer, no FFN: mamba2-780m)
# ---------------------------------------------------------------------------

def init_mamba_block(gen: torch.Generator, cfg: ModelConfig, *, lead=(),
                     device="cuda") -> dict:
    """Parameters of ``lead`` stacked Mamba2 blocks."""
    return {"norm": init_rms_norm(cfg.d_model, lead=lead, device=device),
            "mixer": mamba2.init_mamba(gen, cfg, lead=lead, device=device)}


def mamba_block_train(params, cfg: ModelConfig, h, *, prefix_len=0,
                      aux=None):
    x = rms_norm(h, params["norm"]["scale"], cfg.norm_eps)
    return h + mamba2.mamba_train(params["mixer"], cfg, x), aux


def mamba_block_prefill(params, cfg: ModelConfig, h, cache_size, *,
                        prefix_len=0):
    """``cache_size`` is unused: the state is O(1) a request."""
    x = rms_norm(h, params["norm"]["scale"], cfg.norm_eps)
    y, cache = mamba2.mamba_prefill(params["mixer"], cfg, x)
    return h + y, cache


def mamba_block_decode(params, cfg: ModelConfig, h, cache, pos,
                       block_tables=None):
    """The state is O(1) a request: paging does not apply, and
    ``block_tables`` only keeps the signature uniform (``lm`` refuses a
    paged cache for this family)."""
    del block_tables
    x = rms_norm(h, params["norm"]["scale"], cfg.norm_eps)
    y, cache = mamba2.mamba_decode(params["mixer"], cfg, x, cache, pos)
    return h + y, cache


# ---------------------------------------------------------------------------
# zamba2's shared attention block: ONE set of weights applied at several
# depth sites. Its input is concat(hidden, initial embedding) fused down to
# d_model by w_fuse; the block body's output replaces only its own input's
# share of the residual stream.
# ---------------------------------------------------------------------------

def init_shared_attn(gen: torch.Generator, cfg: ModelConfig,
                     device="cuda") -> dict:
    """A dense block (GQA attention and MLP, no stacked dims) plus
    ``w_fuse`` (2 d_model, d_model), glorot."""
    p = init_dense_block(gen, cfg, device=device)
    p["w_fuse"] = glorot(gen, (2 * cfg.d_model, cfg.d_model), device)
    return p


def _fuse(params, h, emb):
    """u = concat(h, emb) . w_fuse (a side-delta or SHiRA bundle too).
    Under the "tp" hint ``w_fuse`` is replicated over ``model`` (its FSDP
    rows gathered): every rank computes u whole, and the block's
    column-parallel projections take it through ``copy_to``."""
    w = params["w_fuse"]
    tp = tp_layout()
    if tp is not None:
        w, _ = tp.weight(w, "w_fuse", (2 * h.shape[-1], h.shape[-1]))
    return dense(torch.cat([h, emb], dim=-1), w)


def shared_attn_train(params, cfg: ModelConfig, h, emb):
    u = _fuse(params, h, emb)
    out, _ = block_train(params, cfg, u)
    return h + (out - u)            # the residual of the block body only


def shared_attn_prefill(params, cfg: ModelConfig, h, emb, cache_size):
    u = _fuse(params, h, emb)
    out, cache = block_prefill(params, cfg, u, cache_size)
    return h + (out - u), cache


def shared_attn_decode(params, cfg: ModelConfig, h, emb, cache, pos):
    u = _fuse(params, h, emb)
    out, cache = block_decode(params, cfg, u, cache, pos)
    return h + (out - u), cache


def block_fns(kind: str):
    """(train, prefill, decode) of a stage's blocks: the Mamba2 block's
    for a "mamba" stage, the transformer block's for the others."""
    if kind == "mamba":
        return mamba_block_train, mamba_block_prefill, mamba_block_decode
    return block_train, block_prefill, block_decode
