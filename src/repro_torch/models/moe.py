"""Mixture-of-Experts FFN with capacity-based token dispatch.

Port of the single-program dispatch of ``repro/models/moe.py``
(``_moe_ffn_dense``). Tokens are routed top-k, given a slot in their
expert's capacity buffer by their place in the flattened routing order
(choice-major: every token's first choice, then every second choice),
scattered into an (E, C, d) buffer, run through a batched expert SwiGLU
(``torch.bmm``) and combined back, weighted by the renormalised router
probabilities. Choices past an expert's capacity go to a trash row and
are dropped. Shared experts (DeepSeek-V2 style) are one dense SwiGLU of
hidden dim ``num_shared * d_ff`` over every token.

Numerics follow the reference: router logits are ``pdot`` output cast to
f32; ``up`` and ``gate`` are f32 products of compute-dtype operands,
``silu(gate) * up`` is rounded to the compute dtype, ``down`` returns it;
the combine adds each choice in the compute dtype, in choice order; the
load-balance aux loss is f32. ``top_k`` keeps ``lax.top_k``'s tie rule
(of equal probabilities the lower expert comes first).

The capacity is ``max(round(cf * T * k / E), min(T, 512))`` over the T
tokens of one call, so a call of at most 512 tokens drops nothing; above
that a request's routing depends on the rest of its batch, as in the
reference. ``count_drops`` collects the dropped choices of each call.

The reference's expert-parallel dispatch (``shard_map``) waits for the
port's torch.distributed work (ROADMAP A10).
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.adapters import is_bundle, materialize_leaf
from repro_torch.models.layers import (compute_dtype, dense, glorot,
                                       init_mlp, is_sidedelta, mlp)

EXPERT_LEAVES = ("experts_w_up", "experts_w_gate", "experts_w_down")

_DROPS: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def count_drops():
    """Collect each ``moe_ffn`` call's dropped routing choices (a 0-d
    int64 tensor a call, on the call's device) into the yielded list; a
    checkpoint's recompute in backward (the same routes) is not
    counted."""
    global _DROPS
    prev, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = prev


def init_moe(gen: torch.Generator, cfg: ModelConfig, *, lead=(),
             device="cuda") -> dict:
    """Parameters of ``lead`` stacked MoE FFNs: the router (d, E) and the
    experts' (E, d, ff) / (E, ff, d) weights, glorot over their trailing
    two dims, and the shared experts' SwiGLU if the config has them."""
    m = cfg.moe
    d, E, ff = cfg.d_model, m.num_experts, m.d_ff
    lead = tuple(lead)
    p = {
        "w_router": glorot(gen, lead + (d, E), device),
        "experts_w_up": glorot(gen, lead + (E, d, ff), device),
        "experts_w_gate": glorot(gen, lead + (E, d, ff), device),
        "experts_w_down": glorot(gen, lead + (E, ff, d), device),
    }
    if m.num_shared:
        p["shared"] = init_mlp(gen, d, m.num_shared * ff, "silu", lead=lead,
                               device=device)
    return p


def _expert_weight(p: dict, name: str) -> torch.Tensor:
    """An expert leaf in the compute dtype; a packed-SHiRA or LoRA-kind
    bundle is materialized first, as ``pdot`` does."""
    w = p[name]
    if is_sidedelta(w):
        raise ValueError(f"side deltas on the expert leaf {name!r} are not "
                         "supported (the batched expert products take "
                         "plain weights)")
    if is_bundle(w):
        w = materialize_leaf(w)
    return w.to(compute_dtype())


def _expert_ffn(p: dict, buf: torch.Tensor) -> torch.Tensor:
    """buf: (E, C, d) -> (E, C, d), a batched SwiGLU over the experts."""
    cd = compute_dtype()
    x = buf.to(cd).float()
    up = torch.bmm(x, _expert_weight(p, "experts_w_up").float())
    gate = torch.bmm(x, _expert_weight(p, "experts_w_gate").float())
    h = (F.silu(gate) * up).to(cd)
    return torch.bmm(h, _expert_weight(p, "experts_w_down"))


def expert_capacity(m, T: int) -> int:
    """Slots an expert has in a call of T tokens: the capacity factor's
    share with a floor of min(T, 512), so a call of at most 512 tokens
    drops nothing. Python's ``round`` (half to even) of the reference's
    float, computed in the reference's order."""
    return int(max(round(m.capacity_factor * T * m.top_k / m.num_experts),
                   min(T, 512)))


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, largest first; of equal values the lower
    index comes first (``lax.top_k``'s order, which ``torch.topk`` does
    not promise)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(logits: torch.Tensor, k: int, capacity: int):
    """Routing of T tokens: (top_p (T, k) renormalised, top_i (T, k),
    slots (k, T), probs (T, E)). A choice's slot is the number of choices
    of its expert before it in choice-major order (the reference's cumsum
    of one-hots, choice after choice): a stable sort of the k*T choices by
    expert keeps that order within each expert, so the slot is the
    choice's rank in the sort less its expert's first rank. A choice past
    ``capacity`` gets the trash slot ``capacity``."""
    E = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k(probs, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    experts, order = torch.sort(top_i.T.reshape(-1), stable=True)
    first = torch.searchsorted(experts, torch.arange(
        E, dtype=experts.dtype, device=experts.device))
    rank = torch.arange(order.numel(), device=order.device)
    pos = torch.empty_like(rank).index_put_((order,), rank - first[experts])
    slots = torch.clamp(pos, max=capacity)
    return top_p, top_i, slots.reshape(k, -1), probs


def moe_ffn(params: dict, cfg: ModelConfig, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d). Returns (y (B, S, d) in the compute dtype, the f32
    load-balance aux loss E * sum_e f_e * P_e)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    k, E = m.top_k, m.num_experts
    cd = compute_dtype()
    xf = x.reshape(T, d)

    logits = dense(xf, params["w_router"]).float()             # (T, E)
    capacity = expert_capacity(m, T)
    top_p, top_i, slots, probs = route(logits, k, capacity)

    me = probs.mean(0)                                         # (E,)
    ce = F.one_hot(top_i, E).float().sum(1).mean(0) / k        # (E,)
    aux = E * torch.sum(me * ce)

    # dispatch: real slots hold one token each, so assigning them is the
    # reference's add into zeros; the trash row is dropped
    buf = torch.zeros((E, capacity + 1, d), dtype=cd, device=x.device)
    buf[top_i.T.reshape(-1), slots.reshape(-1)] = xf.to(cd).repeat(k, 1)
    out = _expert_ffn(params, buf[:, :capacity])
    out = torch.cat([out, torch.zeros((E, 1, d), dtype=cd,
                                      device=x.device)], dim=1)

    # combine: each choice's slot, weighted by its router probability, in
    # choice order in the compute dtype
    kept = top_p.T * (slots < capacity)                        # (k, T)
    got = out[top_i.T, slots] * kept.to(cd)[..., None]         # (k, T, d)
    y = torch.zeros((T, d), dtype=cd, device=x.device)
    for j in range(k):
        y = y + got[j]
    if _DROPS is not None and torch._C._current_autograd_node() is None:
        _DROPS.append((slots == capacity).sum())   # not in a recompute
    if m.num_shared:
        y = y + mlp(params["shared"], xf, act="silu")
    return y.reshape(B, S, d), aux
