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
reference. ``count_drops`` collects the dropped choices of each call,
``record_routes`` each call's router input, logits and chosen experts.

Under the launch layer's "moe_ep_mesh" hint (mesh, ep), when ep divides
the expert count, dispatch is expert-parallel (``_moe_ffn_ep``, the
reference's ``shard_map`` path): the activations are replicated over
``model``, so each ``model`` rank routes its data shard's tokens to its
E / ep local experts, with the capacity of its local token count, and one
all-reduce over ``model`` merges the partial outputs; the aux loss is
meaned over the dp axes. Under the "tp" hint the router, expert and
shared-expert leaves are the rank's shards (FSDP leaves gathered, the
shared experts' MLP tensor-parallel).
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.adapters import is_bundle, materialize_leaf
from repro_torch.launch import mesh as MESH
from repro_torch.launch.actctx import hint
from repro_torch.models.layers import (compute_dtype, dense, glorot,
                                       init_mlp, is_sidedelta, mlp,
                                       tp_layout)

EXPERT_LEAVES = ("experts_w_up", "experts_w_gate", "experts_w_down")

_DROPS: Optional[List[torch.Tensor]] = None
_ROUTES: Optional[List[dict]] = None


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


@contextlib.contextmanager
def record_routes():
    """Collect each ``moe_ffn`` call's routing into the yielded list, a
    dict a call: the router's input ``x`` (T, d) in the compute dtype, its
    weight ``w`` (d, E), the f32 ``logits`` (T, E) and the chosen experts
    ``top_i`` (T, k), detached. A checkpoint's recompute in backward is
    not recorded."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = prev


def _record(xf, w, logits, top_i) -> None:
    if _ROUTES is not None and torch._C._current_autograd_node() is None:
        _ROUTES.append({"x": xf.detach().to(compute_dtype()),
                        "w": w.detach(), "logits": logits.detach(),
                        "top_i": top_i.detach()})


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


def _tp_weights(params: dict, cfg: ModelConfig) -> dict:
    """Under the "tp" hint: the router and expert leaves with their FSDP
    dims gathered (the expert dim stays as the spec splits it)."""
    tp = tp_layout()
    if tp is None:
        return params
    m = cfg.moe
    d, E, ff = cfg.d_model, m.num_experts, m.d_ff
    shapes = {"w_router": (d, E), "experts_w_up": (E, d, ff),
              "experts_w_gate": (E, d, ff), "experts_w_down": (E, ff, d)}
    out = dict(params)
    for name, shape in shapes.items():
        out[name] = tp.weight(params[name], name, shape)[0]
    return out


def _shared(params: dict, cfg: ModelConfig, xf: torch.Tensor):
    return mlp(params["shared"], xf, act="silu",
               d_ff=cfg.moe.num_shared * cfg.moe.d_ff)


def moe_ffn(params: dict, cfg: ModelConfig, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d). Returns (y (B, S, d) in the compute dtype, the f32
    load-balance aux loss E * sum_e f_e * P_e). Expert-parallel under the
    "moe_ep_mesh" hint when its ep divides the expert count."""
    ep = hint("moe_ep_mesh")
    if ep is not None and cfg.moe.num_experts % ep[1] == 0:
        return _moe_ffn_ep(params, cfg, x, ep[0])
    params = _tp_weights(params, cfg)
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    k, E = m.top_k, m.num_experts
    cd = compute_dtype()
    xf = x.reshape(T, d)

    logits = dense(xf, params["w_router"]).float()             # (T, E)
    capacity = expert_capacity(m, T)
    top_p, top_i, slots, probs = route(logits, k, capacity)
    _record(xf, params["w_router"], logits, top_i)

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
        y = y + _shared(params, cfg, xf)
    return y.reshape(B, S, d), aux


def _moe_ffn_ep(params: dict, cfg: ModelConfig, x: torch.Tensor, mesh
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel dispatch on one ``model`` rank: x (B_local, S, d),
    replicated over ``model``; the expert leaves hold this rank's E / ep
    experts. Routing is the dense dispatch's on the local tokens (the
    capacity of the local count), so a drop-free call equals it; choices
    of other ranks' experts are left to them, and the partial outputs are
    summed over ``model``. The gradient: every rank routes the same tokens,
    so the router sees its whole gradient from the aux loss on each rank,
    but the combine weights and the dispatched tokens only from the local
    experts: both go through ``copy_to``. The aux loss is meaned over the
    dp axes (forward only: each rank's own aux carries its gradient)."""
    params = _tp_weights(params, cfg)
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    k, E = m.top_k, m.num_experts
    e_l = E // MESH.axis_size(mesh, "model")
    first = mesh.coord("model") * e_l
    cd = compute_dtype()
    xf = x.reshape(T, d)

    logits = dense(xf, params["w_router"]).float()
    capacity = expert_capacity(m, T)
    top_p, top_i, slots, probs = route(logits, k, capacity)
    _record(xf, params["w_router"], logits, top_i)
    me = probs.mean(0)
    ce = F.one_hot(top_i, E).float().sum(1).mean(0) / k
    aux = MESH.mean_from(mesh, E * torch.sum(me * ce), MESH.dp_axes(mesh))

    top_p = MESH.copy_to(mesh, top_p, "model")
    xc = MESH.copy_to(mesh, xf, "model").to(cd)
    le = top_i.T - first                                       # (k, T)
    mine = (le >= 0) & (le < e_l)
    le = le.clamp(0, e_l - 1)
    slot = torch.where(mine, slots, torch.full_like(slots, capacity))
    buf = torch.zeros((e_l, capacity + 1, d), dtype=cd, device=x.device)
    buf[le.reshape(-1), slot.reshape(-1)] = xc.repeat(k, 1)
    out = _expert_ffn(params, buf[:, :capacity])
    out = torch.cat([out, torch.zeros((e_l, 1, d), dtype=cd,
                                      device=x.device)], dim=1)
    kept = top_p.T * (slot < capacity)                         # (k, T)
    got = out[le, slot] * kept.to(cd)[..., None]
    y = torch.zeros((T, d), dtype=cd, device=x.device)
    for j in range(k):
        y = y + got[j]
    y = MESH.reduce_from(mesh, y, "model")
    if _DROPS is not None and torch._C._current_autograd_node() is None:
        _DROPS.append((mine & (slots == capacity)).sum())
    if m.num_shared:
        y = y + _shared(params, cfg, xf)
    return y.reshape(B, S, d), aux
