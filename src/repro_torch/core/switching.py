"""Rapid adapter switching (paper §3.2, App. A/B) and the fused-state
scheduler of multi-tenant serving.

Port of ``SwitchEngine``, ``SwitchStats``, ``FusedLRU`` and the tenant
helpers of ``repro/core/switching.py``, with its versioned ids
(``split_version``, ``versioned_id``, ``prior_version``) and trace events
(``switch.load``/``switch.unload`` spans, ``sched.promote``/``sched.demote``
instants). Loading a SHiRA pack writes only the pack's 1-2% of entries
through the ``scatter_apply`` kernel, in place; unloading subtracts them
back. ``LoraEngine`` is the LoRA fuse / unfuse the paper compares it with
(App. A), in place one layer at a time. ``changed_fraction`` is the %C of
the paper's Table 2.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.analysis import trace
from repro_torch.core.adapters import (AdapterPack, apply_pack, bundle_layers,
                                       is_bundle, map_entries)
from repro_torch.core.masks import iter_leaves

# A tenant names the base model (None), one adapter ("a0"), or an adapter
# *stack* (("a0", "lang_de")): several adapters applied together.
Tenant = Union[None, str, Tuple[str, ...]]


def normalize_tenant(name) -> Tenant:
    """Canonical tenant key: None | str | sorted tuple (len >= 2). Stacks
    are additive, so order inside a stack is irrelevant."""
    if name is None or isinstance(name, str):
        return name
    members = sorted(set(name))
    if not members:
        return None
    return members[0] if len(members) == 1 else tuple(members)


def tenant_members(name: Tenant) -> List[str]:
    if name is None:
        return []
    return [name] if isinstance(name, str) else list(name)


def tenant_key(name: Tenant) -> str:
    """Stable string key for sorting/labelling mixed str|tuple tenants."""
    return "" if name is None else "+".join(tenant_members(name))


def split_version(name: str) -> Tuple[str, Optional[int]]:
    """Parse a versioned adapter id: ``"persona@3" -> ("persona", 3)``.
    Unversioned ids (no ``@``, or a suffix that is not a number: ``@`` is
    legal in plain names) come back as ``(name, None)``.
    ``AdapterStore.publish`` numbers each base name's versions from 1,
    bare names resolve to the newest, and a serving request keeps the
    concrete ``name@v`` it resolved to at submit."""
    base, sep, v = name.rpartition("@")
    if sep and base and v.isdigit():
        return base, int(v)
    return name, None


def versioned_id(base: str, version: int) -> str:
    """The id of one published version of an adapter."""
    return f"{base}@{int(version)}"


def prior_version(name: str) -> Optional[str]:
    """The version before a versioned id (``"persona@3" -> "persona@2"``);
    None for ``@1`` and for unversioned names."""
    base, v = split_version(name)
    if v is None or v <= 1:
        return None
    return versioned_id(base, v - 1)


@dataclass
class SwitchStats:
    name: str
    seconds: float
    entries_written: int
    bytes_written: int
    weight_bytes_total: int


def _tree_bytes(tree) -> int:
    return int(sum(x.numel() * x.element_size()
                   for _, x in iter_leaves(tree)))


def synchronize(tree) -> None:
    """Wait for the device work queued on the tree's card, if it has one."""
    leaf = next((x for _, x in iter_leaves(tree)), None)
    if leaf is not None and leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


class SwitchEngine:
    """Holds deployed params; one active adapter (or fused set) at a time.
    The tree is updated in place, so the engine owns it while adapters are
    loaded; unloading everything restores the base to within f32
    rounding. ``SwitchStats.seconds`` covers all of ``apply_pack`` to
    completion: the scatter kernel reads the pack's entries as they are."""

    def __init__(self, params):
        self.params = params
        self.active: List[AdapterPack] = []
        self.history: List[SwitchStats] = []

    def _apply(self, pack: AdapterPack, sign: float) -> float:
        synchronize(self.params)
        t0 = time.perf_counter()
        apply_pack(self.params, pack, sign=sign)
        synchronize(self.params)
        return time.perf_counter() - t0

    def load(self, pack: AdapterPack) -> SwitchStats:
        with trace.span("switch.load", cat="switch", name=pack.name,
                        bytes=pack.nbytes()):
            dt = self._apply(pack, +1.0)
        self.active.append(pack)
        st = SwitchStats(pack.name, dt, pack.num_params(), pack.nbytes(),
                         _tree_bytes(self.params))
        self.history.append(st)
        return st

    def unload(self) -> Optional[SwitchStats]:
        if not self.active:
            return None
        pack = self.active.pop()
        with trace.span("switch.unload", cat="switch", name=pack.name,
                        bytes=pack.nbytes()):
            dt = self._apply(pack, -1.0)
        st = SwitchStats("-" + pack.name, dt, pack.num_params(),
                         pack.nbytes(), _tree_bytes(self.params))
        self.history.append(st)
        return st

    def switch(self, pack: AdapterPack) -> SwitchStats:
        """unload current -> load new; the paper's rapid-switch operation."""
        while self.active:
            self.unload()
        return self.load(pack)

    def load_fused(self, packs: List[AdapterPack],
                   weights: Optional[List[float]] = None
                   ) -> List[SwitchStats]:
        """Multi-adapter fusion by naive addition (paper Fig. 3(b))."""
        weights = weights or [1.0] * len(packs)
        return [self.load(map_entries(p, alpha=p.alpha * w))
                for p, w in zip(packs, weights)]


class LoraEngine:
    """The fuse/unfuse pipeline the paper compares against (App. A):
    W += scale * A @ B at every target, dense in every entry.

    Unlike the reference, which builds each fused leaf anew from one
    einsum over the stacked leaf (a (32, 4608, 18432) f32 delta is
    10.9 GB), this updates the tree IN PLACE, one (n, m) matrix at a time:
    one f32 GEMM whose epilogue adds into W (``addmm_``; the port's weights
    are f32), so no delta is allocated. The tree's structure, tuples and lists included, is the
    caller's own. Unfusing adds -scale * A @ B back, which restores the
    base to within f32 rounding."""

    def __init__(self, params):
        self.params = params
        self.active = None

    def fuse(self, lora: Dict[str, dict], scale: float) -> float:
        """lora: path -> {"A" (..., n, r), "B" (..., r, m)}; returns the
        seconds to completion."""
        synchronize(self.params)
        t0 = time.perf_counter()
        for path, w in iter_leaves(self.params):
            if path not in lora:
                continue
            *_, n, m = w.shape
            a = lora[path]["A"].float().reshape(-1, n, lora[path]["A"]
                                                .shape[-1])
            b = lora[path]["B"].float().reshape(a.shape[0], -1, m)
            for wl, al, bl in zip(w.view(-1, n, m), a, b):
                wl.addmm_(al, bl, alpha=scale)
        synchronize(self.params)
        self.active = (lora, scale)
        return time.perf_counter() - t0

    def unfuse(self) -> float:
        if self.active is None:
            return 0.0
        lora, scale = self.active
        t = self.fuse(lora, -scale)
        self.active = None
        return t


@dataclass
class FusedDecision:
    """One scheduling step: fuse ``promote`` into the shared base (after
    un-fusing ``demote``), or leave things alone (both None)."""

    promote: Optional[Tenant] = None
    demote: Optional[Tenant] = None


class FusedLRU:
    """LRU fused-state scheduler for multi-tenant serving.

    The multi-tenant engine serves every request off ONE shared base plus a
    per-request sparse side delta. When one tenant dominates the traffic it
    is cheaper to fuse it into the base (one sparse scatter) so its
    requests skip the side delta; the others are then served with diff
    packs. This object only decides WHO is fused.

    Policy: an exponential moving average of each tenant's share of batch
    traffic plus a recency stamp. A tenant is promoted when its share
    crosses ``promote_at``; the fused tenant is demoted when its share
    decays below ``demote_at`` or it has been unused for ``max_idle``
    steps. One tenant is fused at a time; ``capacity`` bounds how many
    adapters a promotable stack may hold. Ties in share are broken by the
    tenant's "a+b" key, never by dict order.
    """

    def __init__(self, promote_at: float = 0.5, demote_at: float = 0.2,
                 decay: float = 0.5, max_idle: int = 8, capacity: int = 1):
        if not 0.0 <= demote_at <= promote_at <= 1.0:
            raise ValueError("need 0 <= demote_at <= promote_at <= 1")
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.promote_at = promote_at
        self.demote_at = demote_at
        self.decay = decay
        self.max_idle = max_idle
        self.capacity = capacity
        self.share: Dict[Tenant, float] = {}
        self.last_used: Dict[Tenant, int] = {}
        self.step = 0
        self.fused: Optional[Tenant] = None

    def observe(self, names: Sequence) -> FusedDecision:
        """Record one batch of per-request tenants and return the
        promotion/demotion to apply before serving it."""
        self.step += 1
        n = max(len(names), 1)
        counts: Dict[Tenant, int] = {}
        for name in names:
            name = normalize_tenant(name)
            if name is not None:
                counts[name] = counts.get(name, 0) + 1
                self.last_used[name] = self.step
        for name in set(counts) | set(self.share):
            frac = counts.get(name, 0) / n
            self.share[name] = (self.decay * self.share.get(name, 0.0)
                                + (1.0 - self.decay) * frac)
        # prune decayed-out idle tenants
        idle_limit = self.step - self.max_idle
        for name in [n_ for n_, s in self.share.items()
                     if n_ != self.fused and s < 1e-4
                     and self.last_used.get(n_, 0) < idle_limit]:
            del self.share[name]
            self.last_used.pop(name, None)

        decision = FusedDecision()
        if self.fused is not None:
            idle = self.step - self.last_used.get(self.fused, 0)
            if (self.share.get(self.fused, 0.0) < self.demote_at
                    or idle >= self.max_idle):
                decision.demote = self.fused
        eligible = [name for name in self.share
                    if len(tenant_members(name)) <= self.capacity]
        hot = min(eligible, key=lambda m: (-self.share[m], tenant_key(m)),
                  default=None)
        if (hot is not None and hot != self.fused
                and self.share[hot] >= self.promote_at):
            if self.fused is not None:
                decision.demote = self.fused
            decision.promote = hot
        if decision.promote:
            trace.instant("sched.promote", cat="switch",
                          tenant=tenant_key(decision.promote))
            self.fused = decision.promote
        elif decision.demote:
            trace.instant("sched.demote", cat="switch",
                          tenant=tenant_key(decision.demote))
            self.fused = None
        return decision


def _leaves_or_bundles(tree):
    """Tensor leaves in ``iter_leaves`` order, with each lazy adapter
    bundle (``core.adapters.materialize``) as one leaf."""
    if is_bundle(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves_or_bundles(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves_or_bundles(v)
    elif tree is not None:
        yield tree


def changed_fraction(base, switched) -> float:
    """%C of the paper's tables: the fraction of weights that differ from
    the base, over every leaf of two trees of one structure. ``switched``
    may be a lazily materialized tree, whose bundles are compared layer
    by layer (``bundle_layers``). Stacked leaves are compared one (n, m)
    matrix at a time, so no comparison of a whole leaf (an MoE stage's
    experts: billions of entries) is held at once. The per-leaf counts
    stay on the device and are read once."""
    a = [x for _, x in iter_leaves(base)]
    b = list(_leaves_or_bundles(switched))
    if len(a) != len(b):
        raise ValueError("changed_fraction compares trees of one structure")
    if not a:
        return 0.0
    counts = []
    for x, y in zip(a, b):
        mats = lambda t: t.reshape((-1,) + tuple(t.shape[-2:])) \
            if t.ndim > 2 else [t]
        ys = bundle_layers(y) if is_bundle(y) else mats(y)
        counts += [torch.count_nonzero(torch.ne(xl, yl))
                   for xl, yl in zip(mats(x), ys)]
    return int(torch.stack(counts).sum()) / max(sum(x.numel() for x in a), 1)
