"""Request-level serving: continuous batching over lanes or over pages.

Port of ``repro/hub/serving.py``'s synchronous path. Two engines share one
request API (``submit`` -> ``ServeFuture``; ``step()``/``run()`` drive the
loop; greedy decode; per-request adapters routed through
``MultiTenantEngine``'s side-delta tables, loaded lazily from an attached
``AdapterStore``):

**ServingEngine**, the lane engine. ``slots`` decode lanes share one decode
step and one contiguous cache; every lane owns a ``cache_size`` KV stripe.
Admission prefills the request at batch 1 (``flash_prefill``) and splices
its cache into the lane's row along the batch axis that
``lm.cache_batch_axes`` names. Every live lane then decodes in one step at
its own position: ``flash_decode`` with per-request lengths, which stops
at each lane's length. A lane is busy for its request's whole lifetime.

**PagedServingEngine**, the paged engine (dense text models). KV memory is
one page pool per layer stack (``lm.init_paged_cache``); each request owns
a block table, so resident bytes track actual tokens:
  - admission is gated on free pages, not free lanes (FIFO);
  - prompt prefixes are shared copy-on-write: registered per page boundary
    after prefill, salted by the request's adapter stack, and a shared page
    is copied (``copy_page``) before its first divergent write
    (``_ensure_writable``);
  - prompts prefill in ``chunk_size`` slices, one chunk per engine step,
    interleaved with the decode of live lanes, which runs
    ``flash_decode_paged`` on the pools through the block tables.
The reference pads the last chunk to one static shape for its jit trace;
eager torch runs the chunk's real length, with the same result for every
real row.

Greedy decode throughout, so both engines are token-for-token identical to
the fixed-batch ``MultiTenantEngine.generate`` for the same prompt and
adapter (the tests hold them to the JAX engines as well).

Not ported, and so not options here: async adapter prefetch and
background table builds, ``slot_pad`` (ROADMAP A5); the degradation
ladder, bounded queues, deadlines, the NaN guard and fault injection (A8);
versioned hot swap (A7); int8 KV pages (A6); tracing (A10). A request
whose adapter fails to load fails with its typed ``StoreError``.
"""
from __future__ import annotations

import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.switching import (FusedLRU, Tenant, normalize_tenant,
                                        tenant_members)
from repro_torch.hub.packio import PackFormatError
from repro_torch.models import lm
from repro_torch.models.attention import KVCache
from repro_torch.runtime.faults import RequestShed, StoreError
from repro_torch.serving.kvcache import PagePool, copy_page, pages_for
from repro_torch.serving.multitenant import MultiTenantEngine


class ServeFuture:
    """Resolves when the request's final token is generated, or fails with
    the request's typed terminal error (``runtime.faults``: ``StoreError``
    when its adapter could not be loaded, ``RequestShed`` when it was
    cancelled in the queue)."""

    def __init__(self, rid: int, adapter: Tenant, max_tokens: int):
        self.rid = rid
        self.adapter = adapter
        self.max_tokens = max_tokens
        self.tokens: List[int] = []
        self.submitted_step: Optional[int] = None
        self.finished_step: Optional[int] = None
        self.submit_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self.ttft: Optional[float] = None     # seconds to first token
        self.first_token_step: Optional[int] = None
        self.cancelled = False
        self.error: Optional[Exception] = None   # typed terminal failure
        self._done = False

    def done(self) -> bool:
        return self._done

    def result(self) -> np.ndarray:
        """The generated tokens. A cancelled or failed request raises its
        typed terminal error."""
        if self.error is not None:
            raise self.error
        if self.cancelled:
            raise RuntimeError(f"request {self.rid} was cancelled")
        if not self._done:
            raise RuntimeError(f"request {self.rid} still in flight "
                               f"({len(self.tokens)}/{self.max_tokens} tokens)"
                               " — drive the engine with step()/run()")
        return np.asarray(self.tokens, np.int32)


class _Pending:
    def __init__(self, fut: ServeFuture, prompt: np.ndarray,
                 eos_id: Optional[int]):
        self.fut = fut
        self.prompt = prompt
        self.eos_id = eos_id


def _slot_insert(big: KVCache, small: KVCache, slot: int,
                 axes: KVCache) -> None:
    """Splice a batch-1 cache into lane ``slot`` of the shared cache, in
    place, along each leaf's batch axis (``lm.cache_batch_axes``)."""
    for bg, sm, ax in zip(big, small, axes):
        bg.select(ax, slot).copy_(sm.select(ax, 0))


def _prefix_salt(adapter: Tenant) -> bytes:
    """Prefix-registry namespace for one request's adapter stack: identical
    tokens under different adapters must never share KV pages."""
    return repr(adapter).encode()


def _resolve_adapter(engine: MultiTenantEngine, adapter: Tenant) -> Tenant:
    """Normalize and validate a request's tenant, lazily registering
    members from the attached AdapterStore."""
    adapter = normalize_tenant(engine.resolve(normalize_tenant(adapter)))
    for m in tenant_members(adapter):
        if m not in engine.packs:
            store = engine.store
            if store is not None and m in store:
                engine.register(m)       # lazy: pull it from the store
            else:
                raise KeyError(f"request names unregistered adapter {m!r}")
    return adapter


class _EngineCommon:
    """Request bookkeeping shared by the lane and paged engines."""

    def _init_common(self, cfg, params, slots, scheduler, store,
                     table_dtype) -> None:
        if cfg.encoder_only:
            raise ValueError("encoder-only archs have no decode serving path")
        self.cfg = cfg
        self.slots = slots
        self.engine = MultiTenantEngine(cfg, params, scheduler=scheduler,
                                        store=store, table_dtype=table_dtype)
        self.device = self.engine._device
        self._pos = np.zeros((slots,), np.int32)      # next cache write index
        self._last = np.zeros((slots,), np.int32)     # last generated token
        self._queue: deque = deque()
        self._rid = 0
        self.step_count = 0
        self.tokens_out = 0
        self.decode_slot_waste = 0    # idle-lane decode steps (utilization)

    def register(self, pack) -> None:
        self.engine.register(pack)

    def _new_future(self, adapter, max_tokens: int):
        """A queued request's future with its adapter resolved (and loaded,
        on the synchronous path). Returns (future, ok); a failed load
        leaves the typed ``StoreError`` on the future."""
        t_sub = time.perf_counter()   # arrival precedes the adapter load
        fut = ServeFuture(self._rid, normalize_tenant(adapter), max_tokens)
        self._rid += 1
        fut.submit_time = t_sub
        try:
            fut.adapter = _resolve_adapter(self.engine, adapter)
        except (OSError, PackFormatError) as e:
            self._fail_fut(fut, StoreError(
                f"failed to load adapter {adapter!r}: {e}", name=str(adapter)))
            return fut, False
        return fut, True

    def _fail_fut(self, fut: ServeFuture, err: Exception) -> None:
        fut.error = err
        fut._done = True

    def _resolve_future(self, fut: ServeFuture) -> None:
        fut.finished_step = self.step_count
        fut.finish_time = time.perf_counter()
        fut._done = True

    def cancel(self, fut: ServeFuture) -> bool:
        """Abort a still-queued request; admitted requests cannot be
        cancelled. Its future fails with ``RequestShed``."""
        for p in self._queue:
            if p.fut is fut:
                self._queue.remove(p)
                fut.cancelled = True
                self._fail_fut(fut, RequestShed(
                    f"request {fut.rid} was cancelled", rid=fut.rid,
                    reason="cancelled"))
                return True
        return False

    def pending(self) -> int:
        return len(self._queue) + sum(p is not None for p in self._active)

    def kv_cache_bytes(self) -> int:
        return sum(int(x.numel() * x.element_size())
                   for c in self.caches for x in c)

    def _emit(self, slot: int, token: int) -> None:
        """Record one generated token. ``_pos`` always points at the cache
        index the next decode step writes to."""
        p = self._active[slot]
        p.fut.tokens.append(int(token))
        self.tokens_out += 1
        if len(p.fut.tokens) == 1:
            p.fut.first_token_step = self.step_count
            p.fut.ttft = time.perf_counter() - p.fut.submit_time
        self._last[slot] = token
        if (len(p.fut.tokens) >= p.fut.max_tokens
                or (p.eos_id is not None and int(token) == p.eos_id)):
            self._finish(slot)

    def _decode(self, live: List[int], block_tables=None) -> None:
        """One decode step over every lane; emits the live lanes' tokens.
        Idle lanes decode too (their output is discarded): their ``_pos``
        stays 0 until they go live, and ``block_tables`` points them at
        the scratch page."""
        self.decode_slot_waste += self.slots - len(live)
        live_set = set(live)
        names = [self._active[s].fut.adapter if s in live_set else None
                 for s in range(self.slots)]
        # the scheduler sees only live lanes: idle slots are not base
        # traffic, and counting them would dilute every tenant's share
        self.engine.schedule([names[s] for s in live])
        wp = self.engine.wrapped_params(self.engine.ids_for(names))
        toks = torch.from_numpy(self._last[:, None].copy()).to(self.device)
        logits, _ = lm.decode_step(
            wp, self.cfg, toks, self.caches,
            torch.from_numpy(self._pos.copy()).to(self.device),
            block_tables=block_tables)
        nxt = torch.argmax(logits, -1).cpu().numpy()
        for s in live:
            self._pos[s] += 1          # this step's KV landed at _pos[s]
            self._emit(s, int(nxt[s]))

    def run(self, max_steps: int = 100_000) -> float:
        """Drive step() until every queued request resolved; returns
        wall-clock seconds."""
        t0 = time.perf_counter()
        for _ in range(max_steps):
            if not self.step() and not self._queue \
                    and all(p is None for p in self._active):
                break
        else:
            raise RuntimeError(f"run() hit max_steps={max_steps} with "
                               f"{self.pending()} requests in flight")
        return time.perf_counter() - t0


class ServingEngine(_EngineCommon):
    """Continuous-batching front end over the multi-tenant side-delta path,
    one contiguous KV stripe per lane."""

    def __init__(self, cfg, params, *, slots: int = 4, cache_size: int = 128,
                 scheduler: Optional[FusedLRU] = None, store=None,
                 table_dtype: str = "f32"):
        self._init_common(cfg, params, slots, scheduler, store, table_dtype)
        self.cache_size = cache_size
        self.caches = lm.init_cache(cfg, slots, cache_size,
                                    device=self.device)
        self._axes = lm.cache_batch_axes(cfg)
        self._active: List[Optional[_Pending]] = [None] * slots

    def submit(self, prompt_tokens, adapter: Tenant = None,
               max_tokens: int = 16,
               eos_id: Optional[int] = None) -> ServeFuture:
        """Queue one request; returns its future. ``adapter`` is a
        registered (or store) adapter id, a stack of ids, or None for the
        base model."""
        if max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        prompt = np.asarray(prompt_tokens, np.int32).reshape(-1)
        # the final generated token is returned but never written back to
        # the cache, so a request needs one slot less than prompt+max_tokens
        need = prompt.shape[0] + max_tokens - 1
        if need > self.cache_size:
            raise ValueError(f"prompt ({prompt.shape[0]}) + max_tokens "
                             f"({max_tokens}) needs {need} cache slots, "
                             f"engine has {self.cache_size}")
        fut, ok = self._new_future(adapter, max_tokens)
        if ok:
            self._queue.append(_Pending(fut, prompt, eos_id))
        return fut

    def _finish(self, slot: int) -> None:
        self._resolve_future(self._active[slot].fut)
        self._active[slot] = None
        self._pos[slot] = 0
        self._last[slot] = 0

    def _admit(self, slot: int, p: _Pending) -> None:
        wp = self.engine.wrapped_params(self.engine.ids_for([p.fut.adapter]))
        batch = {"tokens": torch.from_numpy(p.prompt[None].copy()).to(
            self.device)}
        logits, c1 = lm.prefill(wp, self.cfg, batch, self.cache_size)
        for big, small, ax in zip(self.caches, c1, self._axes):
            _slot_insert(big, small, slot, ax)
        self._active[slot] = p
        p.fut.submitted_step = self.step_count
        self._pos[slot] = p.prompt.shape[0]
        self._emit(slot, int(torch.argmax(logits[0])))

    def step(self) -> bool:
        """Admit queued requests into free lanes, then run one decode step
        over every occupied lane. Returns False when fully drained."""
        for slot in range(self.slots):
            if self._active[slot] is None and self._queue:
                self._admit(slot, self._queue.popleft())
        live = [s for s in range(self.slots) if self._active[s] is not None]
        if not live:
            return bool(self._queue)
        self.step_count += 1
        self._decode(live)
        return True


# ---------------------------------------------------------------------------
# Paged engine
# ---------------------------------------------------------------------------

class _PagedRequest:
    __slots__ = ("fut", "prompt", "eos_id", "need", "nblk", "state", "done",
                 "pages", "reserve")

    def __init__(self, fut: ServeFuture, prompt: np.ndarray,
                 eos_id: Optional[int], need: int, nblk: int):
        self.fut = fut
        self.prompt = prompt
        self.eos_id = eos_id
        self.need = need          # KV rows this request may write
        self.nblk = nblk          # block-table entries it needs
        self.state = "prefill"
        self.done = 0             # prompt tokens already in the cache
        self.pages: List[int] = []     # block-table pages (1 ref each)
        self.reserve: List[int] = []   # preallocated COW spares


class PagedServingEngine(_EngineCommon):
    """Continuous batching over a paged KV pool with COW prefix sharing and
    chunked-prefill admission. Dense text models only."""

    def __init__(self, cfg, params, *, slots: int = 4, num_pages: int = 64,
                 page_size: int = 8, max_len: Optional[int] = None,
                 chunk_size: Optional[int] = None,
                 scheduler: Optional[FusedLRU] = None, store=None,
                 table_dtype: str = "f32"):
        self._init_common(cfg, params, slots, scheduler, store, table_dtype)
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_len = max_len or (num_pages - 1) * page_size
        self.max_blocks = pages_for(self.max_len, page_size)
        self.chunk_size = chunk_size or page_size
        self.pool = PagePool(num_pages, page_size)
        self.caches = lm.init_paged_cache(cfg, num_pages, page_size,
                                          device=self.device)
        self._bt = np.zeros((slots, self.max_blocks), np.int32)
        self._active: List[Optional[_PagedRequest]] = [None] * slots
        self.prefill_chunks = 0
        self.peak_resident = 0        # max concurrently admitted requests
        self.peak_used_pages = 0      # incl. evictable registry-only pages
        self.peak_ws_pages = 0        # pages pinned by admitted requests

    def page_bytes(self) -> int:
        """Device bytes of ONE physical page across the whole layer stack."""
        return self.kv_cache_bytes() // self.num_pages

    def submit(self, prompt_tokens, adapter: Tenant = None,
               max_tokens: int = 16,
               eos_id: Optional[int] = None) -> ServeFuture:
        if max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        prompt = np.asarray(prompt_tokens, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        # the final generated token is never written back: one row less
        need = prompt.shape[0] + max_tokens - 1
        if need > self.max_len:
            raise ValueError(f"prompt ({prompt.shape[0]}) + max_tokens "
                             f"({max_tokens}) needs {need} KV rows, engine "
                             f"caps requests at {self.max_len}")
        nblk = pages_for(need, self.page_size)
        if nblk > self.num_pages - 1:
            raise ValueError(f"request needs {nblk} pages, pool has "
                             f"{self.num_pages - 1}")
        fut, ok = self._new_future(adapter, max_tokens)
        if ok:
            self._queue.append(_PagedRequest(fut, prompt, eos_id, need,
                                             nblk))
        return fut

    # ------------------------------------------------------------------
    # Page plumbing
    # ------------------------------------------------------------------

    def _try_admit(self, slot: int, r: _PagedRequest) -> bool:
        """Map the request into ``slot`` if the pool can cover its pages:
        unshared blocks, plus a COW reserve for the boundary page (when the
        prefix match ends inside a shared page) and for the prompt tail
        (prefix registration re-shares it, so the first decode write must
        copy). Takes no pages on failure."""
        p = self.page_size
        L_ = r.prompt.shape[0]
        shared_len, shared = self.pool.match_prefix(
            r.prompt, salt=_prefix_salt(r.fut.adapter))
        cow = int(shared_len < len(shared) * p)
        cow += int(r.need > L_ and L_ % p != 0)
        n_owned = r.nblk - len(shared)
        if not self.pool.can_alloc(n_owned + cow):
            self.pool.release(shared)
            return False
        fresh = self.pool.alloc(n_owned + cow)
        owned, r.reserve = fresh[:n_owned], fresh[n_owned:]
        row = list(shared) + owned
        r.pages = list(row)
        self._bt[slot, :] = 0
        self._bt[slot, :len(row)] = row
        r.state = "prefill"
        r.done = shared_len
        self._active[slot] = r
        r.fut.submitted_step = self.step_count
        return True

    def _ensure_writable(self, slot: int, lo: int, hi: int) -> None:
        """COW every shared page under write range [lo, hi)."""
        p = self.page_size
        r = self._active[slot]
        for blk in range(lo // p, (hi - 1) // p + 1):
            pg = int(self._bt[slot, blk])
            if not self.pool.is_shared(pg):
                continue
            dst = r.reserve.pop() if r.reserve else self.pool.alloc(1)[0]
            copy_page([x for c in self.caches for x in c], pg, dst,
                      page_axis=1)
            self._bt[slot, blk] = dst
            r.pages[r.pages.index(pg)] = dst
            self.pool.release([pg])
            self.pool.cow_copies += 1

    def _finish(self, slot: int) -> None:
        r = self._active[slot]
        self._resolve_future(r.fut)
        self.pool.release(r.pages + r.reserve)
        r.pages, r.reserve = [], []
        self._active[slot] = None
        self._bt[slot, :] = 0
        self._pos[slot] = 0
        self._last[slot] = 0

    def _prefill_step(self, slot: int) -> None:
        r = self._active[slot]
        L_ = r.prompt.shape[0]
        lo = r.done
        hi = min(L_, lo + self.chunk_size)
        self._ensure_writable(slot, lo, hi)
        toks = torch.from_numpy(r.prompt[None, lo:hi].copy()).to(self.device)
        wp = self.engine.wrapped_params(self.engine.ids_for([r.fut.adapter]))
        logits, _ = lm.prefill_chunk(
            wp, self.cfg, toks, self.caches,
            torch.from_numpy(self._bt[slot:slot + 1].copy()).to(self.device),
            lo, hi - lo)
        r.done = hi
        self.prefill_chunks += 1
        if hi == L_:
            # registry refs re-share the prompt pages (incl. the pristine
            # partial tail); the COW reserve covers the first decode write
            self.pool.register_prefix(
                r.prompt, [int(x) for x in
                           self._bt[slot, :pages_for(L_, self.page_size)]],
                salt=_prefix_salt(r.fut.adapter))
            r.state = "live"
            self._pos[slot] = L_
            self._emit(slot, int(torch.argmax(logits[0])))

    def step(self) -> bool:
        """FIFO-admit while pages last, run ONE prefill chunk, then one
        decode step over every live lane. Returns False when drained."""
        for slot in range(self.slots):
            if self._active[slot] is None and self._queue:
                if not self._try_admit(slot, self._queue[0]):
                    break
                self._queue.popleft()
        pf = [s for s in range(self.slots) if self._active[s] is not None
              and self._active[s].state == "prefill"]
        live = [s for s in range(self.slots) if self._active[s] is not None
                and self._active[s].state == "live"]
        self.peak_resident = max(self.peak_resident, len(pf) + len(live))
        self.peak_used_pages = max(self.peak_used_pages,
                                   self.pool.used_pages())
        # working set = distinct pages pinned by admitted requests (block
        # tables, shared prefixes counted once, COW reserves); registry-only
        # pages are an LRU cache, reclaimable on demand
        ws = set()
        for s in pf + live:
            ws.update(int(x) for x in self._bt[s] if x)
            ws.update(self._active[s].reserve)
        self.peak_ws_pages = max(self.peak_ws_pages, len(ws))
        if not pf and not live:
            return bool(self._queue)
        self.step_count += 1
        if pf:
            self._prefill_step(pf[0])
        if live:
            for s in live:
                self._ensure_writable(s, int(self._pos[s]),
                                      int(self._pos[s]) + 1)
            # idle and still-prefilling lanes decode against the scratch
            # page
            mask = np.isin(np.arange(self.slots), live)
            bt = np.where(mask[:, None], self._bt, 0).astype(np.int32)
            self._decode(live, torch.from_numpy(bt).to(self.device))
        return True
