"""Multi-tenant SHiRA serving: per-request adapters in ONE batch.

Port of ``repro/serving/multitenant.py``. The engine keeps one shared copy
of the base weights and applies every request's SHiRA pack as a batched
sparse side term in the forward pass:

  y[b] = x[b] @ W_shared  +  x[b] @ dW_{adapter(b)}

computed by the ``sidedelta`` kernel from per-adapter tables
(``kernels.ops.sidedelta_table``); the served tree replaces each adapted
weight by a ``layers.sidedelta_weight`` bundle. With a ``FusedLRU``
scheduler the hot tenant is fused into the shared base by the
``scatter_apply`` kernel (the paper's rapid switch), the other tenants are
served with diff packs (their delta minus the fused one) and base requests
with the negated fused pack. Tenants may be adapter stacks (tuples of
names), whose side pack is the merged sum.

Tables hold f32 values, or int8 values with a per-(layer, adapter) scale
(``table_dtype="int8"``, row indices int16 where the dims fit). With an
``AdapterStore`` attached (``store=``), ``register`` also takes an adapter
id, and an int8 store pack (``QuantPack``) keeps its own quantization in
int8 tables. The shared tree is updated in place by fusion; ``close``
un-fuses and returns it to the base. Async table builds, ``slot_pad``,
fault injection and tracing wait (ROADMAP A5, A8).
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import torch

from repro_torch.core.adapters import AdapterPack, apply_pack
from repro_torch.core.fusion import fuse_packs
from repro_torch.core.masks import iter_leaves, map_leaves
from repro_torch.core.switching import (FusedLRU, SwitchEngine, Tenant,
                                        normalize_tenant, synchronize,
                                        tenant_key, tenant_members)
from repro_torch.kernels.ops import sidedelta_table
from repro_torch.models import lm
from repro_torch.models.layers import sidedelta_weight

BASE = None            # the "no adapter" tenant in a names list
_BASE_SLOT = "__base__"


def greedy_decode(cfg, batch, tokens: int, prefill, decode):
    """The serving decode loop, shared by the engine and the sequential
    reference. prefill(batch) -> (logits, caches); decode(tok, caches, pos)
    -> (logits, caches). Returns (greedy tokens (B, tokens) int32, last-step
    logits (B, V)), after the device has finished."""
    pos0 = batch["tokens"].shape[1]
    logits, caches = prefill(batch)
    nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
    outs = [nxt]
    for i in range(tokens - 1):
        logits, caches = decode(nxt, caches, pos0 + i)
        nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
        outs.append(nxt)
    if logits.is_cuda:
        torch.cuda.synchronize(logits.device)
    return torch.cat(outs, dim=1), logits


def serving_cache_size(cfg, prompt_len: int, tokens: int) -> int:
    """KV-cache slots for a serve call: prompt + generated + slack."""
    return prompt_len + tokens + 8


def switch_per_request_reference(cfg, params, packs, toks, names,
                                 tokens: int):
    """Ground truth: serve each request ALONE after rapid-switching
    (``SwitchEngine``) to its adapter. toks: (B, S) int tensor; names:
    per-request adapter name or None. Returns (greedy tokens (B, tokens)
    int32, last-step logits (B, V) f32, seconds). ``params`` is switched in
    place and unloaded again at the end."""
    B, S = toks.shape
    cs = serving_cache_size(cfg, S, tokens)
    by_name = {p.name: p for p in packs}
    engine = SwitchEngine(params)
    out, last = [], []
    t0 = time.perf_counter()
    for b, name in enumerate(names):
        while engine.active:
            engine.unload()
        if name is not None:
            engine.load(by_name[name])
        seq, logits = greedy_decode(
            cfg, {"tokens": toks[b:b + 1]}, tokens,
            lambda bb: lm.prefill(engine.params, cfg, bb, cs),
            lambda t, c, pos: lm.decode_step(engine.params, cfg, t, c, pos))
        out.append(seq[0])
        last.append(logits.float()[0])
    dt = time.perf_counter() - t0
    while engine.active:
        engine.unload()
    return torch.stack(out), torch.stack(last), dt


class MultiTenantEngine:
    """Serves mixed-adapter batches off one shared base parameter tree.

    A request's tenant is ``None`` (base model), one adapter name, or an
    adapter stack (a tuple of names applied together). With a
    ``FusedLRU(capacity>1)`` a hot stack is fused as a group."""

    def __init__(self, cfg, params, *, scheduler: Optional[FusedLRU] = None,
                 store=None, table_dtype: str = "f32"):
        if table_dtype not in ("f32", "int8"):
            raise ValueError(f"table_dtype must be 'f32' or 'int8', got "
                             f"{table_dtype!r}")
        self.cfg = cfg
        self.shared = params                 # base (+ the fused packs, if any)
        self.packs: Dict[str, AdapterPack] = {}
        self._qpacks: Dict[str, object] = {}  # name -> int8 QuantPack
        self._qtables: Dict[str, dict] = {}   # name -> its int8_tables()
        self.scheduler = scheduler
        self.store = store
        self.table_dtype = table_dtype
        self.fused: Optional[Tenant] = None
        self.fuse_transitions = 0            # promote/demote scatter count
        self._shapes = {p: tuple(x.shape) for p, x in iter_leaves(params)}
        self._device = next(x for _, x in iter_leaves(params)).device
        self._tables: Dict[str, dict] = {}
        self._slots: Dict[Tenant, int] = {}
        self._stacks: Dict[Tenant, int] = {}  # multi-adapter tenant -> use
        self._batch_no = 0
        self.stack_ttl = 64                  # drop stacks idle this many calls
        self._dirty = False

    # ------------------------------------------------------------------
    # Registration / side-delta tables
    # ------------------------------------------------------------------

    def register(self, pack) -> None:
        """Register an ``AdapterPack``, an int8 ``QuantPack``, or (with a
        store attached) an adapter id, which the store loads."""
        if isinstance(pack, str):
            if self.store is None:
                raise ValueError(f"adapter named by id {pack!r} but no "
                                 "AdapterStore attached")
            # int8 tables build straight from the store's quantized form
            pack = (self.store.get_raw(pack) if self.table_dtype == "int8"
                    else self.store.get(pack))
        qp = None
        if hasattr(pack, "int8_tables"):     # a hub.packio.QuantPack
            qp, pack = pack, pack.dequantize()
        for path in pack.entries:
            if path not in self._shapes:
                raise KeyError(f"adapter {pack.name!r} targets unknown "
                               f"weight {path!r}")
        if pack.name in tenant_members(self.fused):
            # un-fuse the OLD delta before replacing the pack
            self._demote()
            if self.scheduler is not None and pack.name in tenant_members(
                    self.scheduler.fused):
                self.scheduler.fused = None
        self.packs[pack.name] = pack
        self._qpacks.pop(pack.name, None)
        self._qtables.pop(pack.name, None)
        if qp is not None:
            self._qpacks[pack.name] = qp
        self._dirty = True

    def resolve(self, name):
        """A tenant's ids through the attached store; the identity while
        versioned ids wait (ROADMAP A7)."""
        return name

    def _side_packs(self) -> Dict[Tenant, AdapterPack]:
        """What each tenant's side delta must be, given the fused state."""
        fused_m = tenant_members(self.fused)
        out = {}
        for t in set(self.packs) | set(self._stacks):
            if t == self.fused:
                continue                     # fused tenant rides the base
            members = tenant_members(t)
            if not fused_m and len(members) == 1:
                out[t] = self.packs[members[0]]
            else:
                parts = ([self.packs[m] for m in members]
                         + [self.packs[f] for f in fused_m])
                weights = [1.0] * len(members) + [-1.0] * len(fused_m)
                out[t] = fuse_packs(
                    parts, weights=weights,
                    name=(tenant_key(t) +
                          (f"-minus-{tenant_key(self.fused)}" if fused_m
                           else "")))
        if fused_m:                          # base traffic must un-see it
            out[_BASE_SLOT] = fuse_packs(
                [self.packs[f] for f in fused_m],
                weights=[-1.0] * len(fused_m),
                name=f"-{tenant_key(self.fused)}")
        return out

    def _rebuild(self) -> None:
        self._tables = {}                    # free the old tables first
        side = self._side_packs()
        order = sorted(side, key=lambda t: t if isinstance(t, str)
                       else tenant_key(t))
        self._slots = {name: i for i, name in enumerate(order)}
        paths = sorted({p for pk in side.values() for p in pk.entries})
        int8 = self.table_dtype == "int8"
        # a plain single-adapter tenant registered from an int8 store pack
        # keeps the store's values and per-path scale (one rounding)
        direct = {}
        for name in order:
            if (int8 and isinstance(name, str) and name in self._qpacks
                    and side[name] is self.packs[name]):
                if name not in self._qtables:   # decode the gap streams once
                    self._qtables[name] = self._qpacks[name].int8_tables()
                direct[name] = self._qtables[name]
        for path in paths:
            *lead, n, m = self._shapes[path]
            nl = 1
            for d in lead:
                nl *= d
            slots = []
            for name in order:
                pk = side[name]
                if path not in pk.entries:
                    slots.append(None)
                    continue
                if name in direct and path in direct[name]:
                    idx, vq, scale = direct[name][path]
                    slots.append((torch.from_numpy(idx).reshape(nl, -1),
                                  torch.from_numpy(vq.copy()).reshape(nl, -1),
                                  scale * self._qpacks[name].alpha))
                    continue
                idx, val = pk.entries[path]
                slots.append((idx.reshape(nl, -1),
                              val.float().reshape(nl, -1) * pk.alpha))
            table = sidedelta_table(slots, nl, n, m, int8=int8,
                                    device=self._device)
            self._tables[path] = {k: v.reshape(tuple(lead) + v.shape[1:])
                                  for k, v in table.items()}
        self._dirty = False

    def _ensure_tables(self) -> None:
        if self._dirty:
            self._rebuild()

    def table_nbytes(self) -> Dict[str, int]:
        """Device-side adapter-table bytes by component."""
        self._ensure_tables()
        out = {"rows": 0, "vals": 0, "colptr": 0, "scale": 0}
        for t in self._tables.values():
            for k in out:
                if k in t:
                    out[k] += t[k].numel() * t[k].element_size()
        out["total"] = sum(out.values())
        return out

    # ------------------------------------------------------------------
    # Fused-state transitions (the scheduler's promote/demote)
    # ------------------------------------------------------------------

    def _demote(self) -> None:
        if self.fused is None:
            return
        for m in tenant_members(self.fused):
            apply_pack(self.shared, self.packs[m], sign=-1.0)
        self.fused = None
        self.fuse_transitions += 1
        self._dirty = True

    def _promote(self, tenant: Tenant) -> None:
        tenant = normalize_tenant(tenant)
        if tenant == self.fused or tenant is None:
            return
        self._demote()
        for m in tenant_members(tenant):
            apply_pack(self.shared, self.packs[m], sign=+1.0)
        self.fused = tenant
        self.fuse_transitions += 1
        self._dirty = True

    def schedule(self, names: Sequence) -> None:
        """Consult the scheduler for this batch's traffic and apply its
        promote/demote before serving."""
        if self.scheduler is None:
            return
        d = self.scheduler.observe([normalize_tenant(n) for n in names])
        if d.promote is not None:
            self._promote(d.promote)
        elif d.demote is not None:
            self._demote()

    def close(self) -> None:
        """Un-fuse, so the shared tree holds the base weights again."""
        self._demote()
        synchronize(self.shared)

    # ------------------------------------------------------------------
    # Forward passes
    # ------------------------------------------------------------------

    def ids_for(self, names: Sequence) -> torch.Tensor:
        norm = [normalize_tenant(n) for n in names]
        self._batch_no += 1
        for t in norm:
            for m in tenant_members(t):
                if m not in self.packs:
                    raise KeyError(f"request names unregistered adapter "
                                   f"{m!r}")
            if t is not None and not isinstance(t, str):
                if t not in self._stacks:
                    self._dirty = True       # new stack: needs a slot
                self._stacks[t] = self._batch_no
        # retire stacks that left the traffic mix
        for t in [t for t, used in self._stacks.items()
                  if t != self.fused
                  and self._batch_no - used > self.stack_ttl]:
            del self._stacks[t]
            self._dirty = True
        self._ensure_tables()
        ids = []
        for t in norm:
            if t == self.fused or (t is BASE and self.fused is None):
                ids.append(-1)               # pure shared base
            elif t is BASE:
                ids.append(self._slots[_BASE_SLOT])
            else:
                ids.append(self._slots[t])
        return torch.tensor(ids, dtype=torch.int32, device=self._device)

    def wrapped_params(self, ids: torch.Tensor):
        """The shared tree with side-delta bundles at every adapted weight."""
        self._ensure_tables()

        def bundle(path, w):
            t = self._tables.get(path)
            if t is None:
                return w
            lead = tuple(w.shape[:-2])
            return sidedelta_weight(w, t["rows"], t["vals"], t["colptr"],
                                    ids.expand(lead + tuple(ids.shape)),
                                    scale=t.get("scale"))

        return map_leaves(bundle, self.shared)

    def prefill(self, batch, names: Sequence[Optional[str]],
                cache_size: int):
        p = self.wrapped_params(self.ids_for(names))
        return lm.prefill(p, self.cfg, batch, cache_size)

    def decode_step(self, tokens, caches, pos,
                    names: Sequence[Optional[str]]):
        p = self.wrapped_params(self.ids_for(names))
        return lm.decode_step(p, self.cfg, tokens, caches, pos)

    def generate(self, batch, names: Sequence[Optional[str]], tokens: int,
                 cache_size: Optional[int] = None):
        """Greedy-decode ``tokens`` tokens for a mixed-adapter batch.
        Returns (out_tokens (B, tokens) int32, seconds)."""
        cs = cache_size or serving_cache_size(
            self.cfg, batch["tokens"].shape[1], tokens)
        self.schedule(names)
        p = self.wrapped_params(self.ids_for(names))
        t0 = time.perf_counter()
        out, _ = greedy_decode(
            self.cfg, batch, tokens,
            lambda b: lm.prefill(p, self.cfg, b, cs),
            lambda t, c, pos: lm.decode_step(p, self.cfg, t, c, pos))
        return out, time.perf_counter() - t0
