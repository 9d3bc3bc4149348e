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
id, ``resolve`` maps bare names to their newest published version, and
an int8 store pack (``QuantPack``) keeps its own quantization in int8
tables. ``unregister`` retires an adapter (un-fusing it first). The
shared tree is updated in place by fusion; ``close`` un-fuses and returns
it to the base. Registered packs live on the engine's device.

``slot_pad`` rounds the tables' adapter axis up to a multiple of itself;
the padded slots hold no entries. Background builds
(``kick_async_build`` / ``poll_async_build``) rebuild the tables on a
worker thread, on a side CUDA stream, while serving goes on off the old
tables for tenants they still cover (``ids_covered``); a deferred
``FusedLRU`` decision (``schedule(defer=True)``) is applied when its
tables are adopted; a build that raised is counted in ``async_failed``
and raises where it is polled. Spans: ``table_rebuild`` (serving thread),
``prefetch.h2d`` (the build worker), ``prefetch.stall``, ``fuse`` and
``unfuse``. Fault injection waits (ROADMAP A8).
"""
from __future__ import annotations

import contextlib
import time
from concurrent import futures
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.analysis import trace
from repro_torch.core.adapters import AdapterPack, apply_pack, pack_to
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
                 store=None, table_dtype: str = "f32", slot_pad: int = 1):
        if table_dtype not in ("f32", "int8"):
            raise ValueError(f"table_dtype must be 'f32' or 'int8', got "
                             f"{table_dtype!r}")
        if slot_pad < 1:
            raise ValueError(f"slot_pad must be >= 1, got {slot_pad}")
        self.cfg = cfg
        self.shared = params                 # base (+ the fused packs, if any)
        self.packs: Dict[str, AdapterPack] = {}
        self._qpacks: Dict[str, object] = {}  # name -> int8 QuantPack
        self._qtables: Dict[str, dict] = {}   # name -> its int8_tables()
        self.scheduler = scheduler
        self.store = store
        self.table_dtype = table_dtype
        self.slot_pad = slot_pad             # tables' adapter-axis bucket
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
        self._structural = False             # old table rows invalid too
        self._epoch = 0                      # bumps when tables go stale
        self._side = None                    # CUDA stream of background work
        self._build_pool: Optional[ThreadPoolExecutor] = None
        self._build_fut = None               # (epoch, Future, decision|None)
        self._pending = None                 # deferred FusedDecision
        self.async_builds = 0                # background builds submitted
        self.async_adopted = 0               # adopted (saved a sync rebuild)
        self.async_stale = 0                 # discarded (state moved on)
        self.async_failed = 0                # raised (and re-raised here)

    # ------------------------------------------------------------------
    # Streams: background uploads and builds run on a side stream
    # ------------------------------------------------------------------

    def _on_side(self):
        """A context that makes the side stream current (CUDA only)."""
        if self._device.type != "cuda":
            return contextlib.nullcontext()
        if self._side is None:
            self._side = torch.cuda.Stream(self._device)
        return torch.cuda.stream(self._side)

    def _join_side(self) -> None:
        """Order the serving stream after the side stream's work so far."""
        if self._side is not None:
            torch.cuda.current_stream(self._device).wait_stream(self._side)

    def _used_here(self, tensors) -> None:
        """Tensors made on the side stream and read on the serving stream:
        the allocator must not reuse them until the serving stream is done
        with them."""
        if self._side is not None:
            cur = torch.cuda.current_stream(self._device)
            for t in tensors:
                t.record_stream(cur)

    # ------------------------------------------------------------------
    # Registration / side-delta tables
    # ------------------------------------------------------------------

    def register(self, pack, background: bool = False) -> None:
        """Register an ``AdapterPack``, an int8 ``QuantPack``, or (with a
        store attached) an adapter id, which the store loads. The pack is
        copied to the engine's device; with ``background`` the copy runs
        on the side stream (from pinned memory without blocking), ordered
        before the next table build and before any fuse of it."""
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
        if background and self._device.type == "cuda":
            with self._on_side():
                pack = pack_to(pack, self._device, non_blocking=True)
            self._used_here([t for e in pack.entries.values() for t in e])
        else:
            pack = pack_to(pack, self._device)
        brand_new = pack.name not in self.packs
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
        self._mark_dirty(additive=brand_new)

    def unregister(self, name: str) -> bool:
        """Drop a registered adapter (a superseded ``name@v`` whose requests
        have drained). A fused adapter, alone or in the fused stack, is
        demoted first, so the shared base holds clean weights again. The
        other tenants' table rows stay valid until the rebuild (additive
        dirt). Returns False if the name is not registered."""
        if name not in self.packs:
            return False
        if name in tenant_members(self.fused):
            self._demote()
            if (self.scheduler is not None
                    and name in tenant_members(self.scheduler.fused)):
                self.scheduler.fused = None
        del self.packs[name]
        self._qpacks.pop(name, None)
        self._qtables.pop(name, None)
        for t in [t for t in self._stacks if name in tenant_members(t)]:
            del self._stacks[t]
        if self.scheduler is not None:
            for t in [t for t in self.scheduler.share
                      if name in tenant_members(t)]:
                self.scheduler.share.pop(t, None)
                self.scheduler.last_used.pop(t, None)
        self._mark_dirty(additive=True)
        return True

    def resolve(self, name):
        """A tenant's ids through the attached store's versioned-id
        resolution (a bare name -> its newest ``name@v``); the identity
        without a store."""
        if self.store is None:
            return name
        members = tenant_members(name)
        if not members:
            return name
        resolved = tuple(self.store.resolve(m) for m in members)
        if resolved == tuple(members):
            return name
        return resolved[0] if isinstance(name, str) else resolved

    def _mark_dirty(self, additive: bool = False) -> None:
        """The tables no longer match the tenant/fused state; the epoch
        bump makes any background build begun before now stale. Additive
        dirt only adds (or drops) tenants, so the current rows stay right
        for the tenants they cover; any other change (re-register, a
        fused transition) is structural."""
        self._dirty = True
        self._epoch += 1
        if not additive:
            self._structural = True

    @staticmethod
    def _side_packs(packs, stacks, fused) -> Dict[Any, Any]:
        """What each tenant's side delta must be, given the fused state,
        from explicit (possibly snapshotted) state: a registered pack as it
        is, or a (packs, weights, name) recipe for ``fuse_packs``, which
        ``_build_tables`` fuses one path at a time."""
        fused_m = tenant_members(fused)
        out = {}
        for t in set(packs) | set(stacks):
            if t == fused:
                continue                     # fused tenant rides the base
            members = tenant_members(t)
            if not fused_m and len(members) == 1:
                out[t] = packs[members[0]]
            else:
                out[t] = ([packs[m] for m in members]
                          + [packs[f] for f in fused_m],
                          [1.0] * len(members) + [-1.0] * len(fused_m),
                          tenant_key(t) + (f"-minus-{tenant_key(fused)}"
                                           if fused_m else ""))
        if fused_m:                          # base traffic must un-see it
            out[_BASE_SLOT] = ([packs[f] for f in fused_m],
                               [-1.0] * len(fused_m),
                               f"-{tenant_key(fused)}")
        return out

    @staticmethod
    def _side_entry(recipe, path):
        """One path's (idx, f32 values times alpha) of a side delta, or
        None where it does not target the path."""
        if isinstance(recipe, tuple):
            parts, weights, name = recipe
            if not any(path in p.entries for p in parts):
                return None
            recipe = fuse_packs(parts, weights=weights, name=name,
                                only=[path])
        if path not in recipe.entries:
            return None
        idx, val = recipe.entries[path]
        return idx, val.float() * recipe.alpha

    def _build_tables(self, side, packs, qpacks):
        """Pack side deltas into device tables, from the given snapshot
        only, so the synchronous and the background build give the same
        tables from the same state. Returns (slots, tables, meta)."""
        order = sorted(side, key=lambda t: t if isinstance(t, str)
                       else tenant_key(t))
        slots = {name: i for i, name in enumerate(order)}
        A = -(-max(len(order), 1) // self.slot_pad) * self.slot_pad
        paths = sorted({p for r in side.values()
                        for pk in (r[0] if isinstance(r, tuple) else [r])
                        for p in pk.entries})
        int8 = self.table_dtype == "int8"
        # a plain single-adapter tenant registered from an int8 store pack
        # keeps the store's values and per-path scale (one rounding)
        direct = {}
        for name in order:
            if (int8 and isinstance(name, str) and name in qpacks
                    and side[name] is packs.get(name)):
                if name not in self._qtables:   # decode the gap streams once
                    self._qtables[name] = qpacks[name].int8_tables()
                direct[name] = (self._qtables[name], qpacks[name].alpha)
        tables = {}
        for path in paths:
            *lead, n, m = self._shapes[path]
            nl = 1
            for d in lead:
                nl *= d
            slot_list = []
            for name in order:
                if name in direct and path in direct[name][0]:
                    idx, vq, scale = direct[name][0][path]
                    slot_list.append(
                        (torch.from_numpy(idx).reshape(nl, -1),
                         torch.from_numpy(vq.copy()).reshape(nl, -1),
                         scale * direct[name][1]))
                    continue
                entry = self._side_entry(side[name], path)
                slot_list.append(None if entry is None else
                                 (entry[0].reshape(nl, -1),
                                  entry[1].reshape(nl, -1)))
            slot_list += [None] * (A - len(order))   # slot_pad: empty slots
            table = sidedelta_table(slot_list, nl, n, m, int8=int8,
                                    device=self._device)
            del slot_list
            tables[path] = {k: v.reshape(tuple(lead) + v.shape[1:])
                            for k, v in table.items()}
        meta = {"tenants": len(side), "paths": len(tables),
                "bytes": sum(x.numel() * x.element_size()
                             for t in tables.values() for x in t.values())}
        return slots, tables, meta

    def _rebuild(self) -> None:
        """Synchronous table rebuild on the serving thread: the fallback
        when no background build matches the current state."""
        self._tables = {}                    # free the old tables first
        self._join_side()
        with trace.span("table_rebuild", cat="tables") as sp:
            side = self._side_packs(self.packs, self._stacks, self.fused)
            self._slots, self._tables, meta = self._build_tables(
                side, self.packs, self._qpacks)
            sp.set(**meta)
        self._dirty = False
        self._structural = False

    # ------------------------------------------------------------------
    # Background table builds
    # ------------------------------------------------------------------

    def tables_ready(self) -> bool:
        """True when serving needs no synchronous rebuild: the tables are
        clean, or a finished background build was adopted."""
        if self._dirty:
            self.poll_async_build()
        return not self._dirty

    def kick_async_build(self) -> bool:
        """Start rebuilding the tables on the build worker (a side CUDA
        stream), for the state as it is now, or for the state after a
        deferred fused transition. A later ``_mark_dirty`` makes the build
        stale, and ``poll_async_build`` discards it. Returns True when the
        tables are clean or a matching build is in flight, False when a
        stale one still runs (kick again next step)."""
        if not self._dirty and self._pending is None:
            return True
        if self._build_fut is not None:
            ep, fut, trans = self._build_fut
            if not fut.done():
                return ep == self._epoch and trans is self._pending
            self.poll_async_build()
            if not self._dirty and self._pending is None:
                return True
        epoch, pending = self._epoch, self._pending
        packs, qpacks = dict(self.packs), dict(self._qpacks)
        stacks, fused = dict(self._stacks), self.fused
        if pending is not None:
            fused = (normalize_tenant(pending.promote)
                     if pending.promote is not None else None)
        if self._build_pool is None:
            self._build_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="shira-tables")

        def job():
            with trace.span("prefetch.h2d", cat="tables") as sp, \
                    self._on_side():
                side = self._side_packs(packs, stacks, fused)
                slots, tables, meta = self._build_tables(side, packs, qpacks)
                # the worker waits for its own stream, never the serving
                # thread; the snapshot's packs outlive every read of them
                if self._side is not None:
                    self._side.synchronize()
                sp.set(**meta)
            return slots, tables

        self._build_fut = (epoch, self._build_pool.submit(job), pending)
        self.async_builds += 1
        return True

    def _adopt(self, slots, tables) -> None:
        self._join_side()
        self._used_here([x for t in tables.values() for x in t.values()])
        self._slots, self._tables = slots, tables
        self._dirty = False
        self._structural = False
        self.async_adopted += 1

    def poll_async_build(self) -> bool:
        """Adopt a finished background build if it still matches the
        engine's state, or discard it. A build for a deferred transition
        applies its fuse/unfuse scatter (on the serving stream, after the
        decode steps queued before it) as its tables are adopted. Never
        blocks. Returns True when the tables are clean after the poll. A
        build that raised (out of device memory, say) is counted in
        ``async_failed`` and its error raised here: a failure on the card
        never turns into a quiet synchronous rebuild."""
        if self._build_fut is None:
            return not self._dirty
        ep, fut, trans = self._build_fut
        if not fut.done():
            return not self._dirty
        self._build_fut = None
        try:
            slots, tables = fut.result()
        except Exception:
            self.async_failed += 1
            trace.instant("prefetch.h2d_failed", cat="tables")
            raise
        if ep != self._epoch or trans is not self._pending:
            self.async_stale += 1
        elif trans is not None:
            if trans.promote is not None:
                self._promote(trans.promote)
            elif trans.demote is not None:
                self._demote()
            self._pending = None
            self._adopt(slots, tables)
        elif self._dirty:
            self._adopt(slots, tables)
        else:
            self.async_stale += 1
        return not self._dirty

    def _ensure_tables(self) -> None:
        """Make the tables serve-ready: adopt a finished background build,
        wait for a matching one in flight (``prefetch.stall``), or rebuild
        on this thread. Every path builds the same tables from the same
        state."""
        if not self._dirty:
            return
        if not self.poll_async_build():
            if (self._build_fut is not None
                    and self._build_fut[0] == self._epoch):
                with trace.span("prefetch.stall", cat="tables"):
                    futures.wait([self._build_fut[1]])
                self.poll_async_build()
        if self._dirty:
            self._rebuild()

    def shutdown(self) -> None:
        """Join the background build worker."""
        pool, self._build_pool = self._build_pool, None
        if pool is not None:
            pool.shutdown(wait=True)

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
        self._join_side()
        with trace.span("unfuse", cat="switch",
                        tenant=tenant_key(self.fused)):
            for m in tenant_members(self.fused):
                apply_pack(self.shared, self.packs[m], sign=-1.0)
        self.fused = None
        self.fuse_transitions += 1
        self._mark_dirty()

    def _promote(self, tenant: Tenant) -> None:
        tenant = normalize_tenant(tenant)
        if tenant == self.fused or tenant is None:
            return
        self._demote()
        self._join_side()
        with trace.span("fuse", cat="switch", tenant=tenant_key(tenant)):
            for m in tenant_members(tenant):
                apply_pack(self.shared, self.packs[m], sign=+1.0)
        self.fused = tenant
        self.fuse_transitions += 1
        self._mark_dirty()

    def schedule(self, names: Sequence, defer: bool = False) -> None:
        """Consult the scheduler for this batch's traffic and apply its
        promote/demote before serving. With ``defer`` (the async serving
        engines) the decision is kept, serving goes on in the current
        fused state, and the transition is applied when the tables built
        for the state after it are adopted (``poll_async_build``)."""
        if self.scheduler is None:
            return
        d = self.scheduler.observe([normalize_tenant(n) for n in names])
        if d.promote is None and d.demote is None:
            return
        if defer:
            self._pending = d
            return
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

    def ids_covered(self, names: Sequence) -> bool:
        """True when the current tables still serve these tenants right
        though a rebuild is pending: only additive changes happened since
        they were built, and every tenant named has a slot."""
        if not self._dirty:
            return True
        if self._structural:
            return False
        for t in (normalize_tenant(n) for n in names):
            if t is None:
                if self.fused is not None and _BASE_SLOT not in self._slots:
                    return False
            elif t != self.fused and t not in self._slots:
                return False
        return True

    def ids_for(self, names: Sequence, stale_ok: bool = False
                ) -> torch.Tensor:
        norm = [normalize_tenant(n) for n in names]
        self._batch_no += 1
        for t in norm:
            for m in tenant_members(t):
                if m not in self.packs:
                    raise KeyError(f"request names unregistered adapter "
                                   f"{m!r}")
            if t is not None and not isinstance(t, str):
                if t not in self._stacks:
                    self._mark_dirty(additive=True)  # new stack: a slot
                self._stacks[t] = self._batch_no
        # retire stacks that left the traffic mix
        for t in [t for t, used in self._stacks.items()
                  if t != self.fused
                  and self._batch_no - used > self.stack_ttl]:
            del self._stacks[t]
            self._mark_dirty(additive=True)
        if not (stale_ok and self.ids_covered(norm)):
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

    def wrapped_params(self, ids: torch.Tensor, stale_ok: bool = False):
        """The shared tree with side-delta bundles at every adapted weight.
        ``stale_ok`` trusts the caller's ``ids_for(..., stale_ok=True)``
        and skips the rebuild."""
        if not stale_ok:
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
