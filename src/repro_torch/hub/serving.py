"""Request-level serving: continuous batching over lanes or over pages.

Port of ``repro/hub/serving.py``. Two engines share one request API
(``submit`` -> ``ServeFuture``; ``step()``/``run()`` drive the loop;
greedy decode; per-request adapters routed through
``MultiTenantEngine``'s side-delta tables, loaded lazily from an attached
``AdapterStore``):

**ServingEngine**, the lane engine. ``slots`` decode lanes share one decode
step and one contiguous cache; every lane owns a ``cache_size`` KV stripe.
Admission prefills the request at batch 1 (``flash_prefill``) and splices
its cache into the lane's row along the batch axis that
``lm.cache_batch_axes`` names. Every live lane then decodes in one step at
its own position: ``flash_decode`` with per-request lengths, which stops
at each lane's length. A lane is busy for its request's whole lifetime.
A vision model's request is admitted with zero patch embeddings before
its prompt, as the reference's; they hold ``num_prefix_embeds`` of the
lane's rows.

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

**Versioned hot swap.** A request keeps the adapter version it resolved
to at submit (``name@v``, through the store's newest-wins ``resolve``):
the engine counts the requests on each version (``_vpins``) and pins it
in the store. When the last request on a version the store has
superseded drains, ``_evict_stale`` unregisters it (un-fusing it first
if it is fused) and evicts it from the store's resident tier
(``hotswap.evict``).

**Async adapter prefetch** (``async_prefetch=True``): a cold request's
adapter starts loading when it is queued, the disk read on the store's
workers and the table build on the engine's build worker (a side CUDA
stream), while the live lanes decode. The request is admitted once its
packs are registered; hot tenants keep decoding off the old tables while
a rebuild runs, and ``FusedLRU`` transitions wait for their tables. With
nothing live to hide behind, the engine blocks on the head request
(``prefetch.stall``). Token output is the same on every path. With the
flag off (the default) the engines load synchronously at submit.
``slot_pad`` passes to ``MultiTenantEngine``.

**int8 KV pages** (``PagedServingEngine(quant_kv=True)``): the pools are
``QuantKV`` (int8 codes and one bf16 scale per row and head,
``serving.kvcache``), 130 bytes a row and head where bf16 takes 256, and
``kv_cache_bytes`` / ``page_bytes`` count codes and scales. Decode runs
the int8 instance of ``flash_decode_paged``.

**Fault tolerance** (``runtime.faults``; the reference's ladder,
``src/repro/runtime/README.md``). A request whose adapter cannot be loaded
(``StoreError`` after the store's retries, ``AdapterUnavailable`` for a
quarantined pack), at submit or when its prefetch fails, walks the
``fallback`` ladder: ``"previous"`` serves ``name@v-1`` (then older
versions, then the base model), ``"base"`` the base model, ``"none"``
fails it; an adapter stack falls straight to the base. A request served
below what it asked for is flagged ``fut.degraded`` (``degraded_from``:
what it asked for) and keeps decoding. ``max_queue`` sheds a submit to a
full queue, and ``submit(deadline_s=)`` a request still queued that long
after its submit (checked every step), both with ``RequestShed``.
``nan_guard`` tests each live slot's logits for finiteness on the device,
read back with the argmax in one copy, and fails only a slot whose logits
are not finite (``SlotPoisoned``), while the batch decodes on. A
``TableBuildError`` leaves the old tables standing: the admission, the
chunk or the decode is retried next step. ``health()`` reports the
watchdog (``EngineWatchdog``, fed every step), the queue, the lanes, the
counters and the store's quarantine list. With no injector and the guard
off, the decode step does what it did before.

Spans: ``step``, ``admit``, ``decode``, ``prefill_chunk``, ``cow_copy``,
``prefetch.stall``; counters ``free_pages`` and ``resident``; instants
``hotswap.evict``, ``prefetch.hit``, ``prefetch.cancel``,
``shed.queue_full``, ``shed.deadline``, ``degrade``, ``slot.poison``,
``fault.build_backoff``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.analysis import trace
from repro_torch.core.switching import (FusedLRU, Tenant, normalize_tenant,
                                        prior_version, split_version,
                                        tenant_members)
from repro_torch.models import lm
from repro_torch.runtime import faults
from repro_torch.runtime.faults import (AdapterUnavailable, EngineWatchdog,
                                        RequestShed, ServingError,
                                        SlotPoisoned, StoreError,
                                        TableBuildError)
from repro_torch.serving.kvcache import PagePool, copy_page, leaves, pages_for
from repro_torch.serving.multitenant import MultiTenantEngine

_NO_FALLBACK = object()     # the degradation ladder is exhausted


class ServeFuture:
    """Resolves when the request's final token is generated, or fails with
    the request's typed terminal error (``runtime.faults``: ``RequestShed``
    when admission shed it or it was cancelled, ``SlotPoisoned`` when its
    decode slot was quarantined, ``StoreError`` / ``AdapterUnavailable``
    when its adapter could not be served and the fallback ladder was
    exhausted). ``degraded`` marks a request the ladder served below what
    it asked for; ``degraded_from`` is what it asked for."""

    def __init__(self, rid: int, adapter: Tenant, max_tokens: int):
        self.rid = rid
        self.adapter = adapter
        self.max_tokens = max_tokens
        self.tokens: List[int] = []
        self.submitted_step: Optional[int] = None
        self.finished_step: Optional[int] = None
        self.submit_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self.deadline_s: Optional[float] = None  # queue-time budget (shed)
        self.ttft: Optional[float] = None     # seconds to first token
        self.first_token_step: Optional[int] = None
        self.cold = False     # adapter needed a disk load at submit time
        self.cancelled = False
        self.error: Optional[Exception] = None   # typed terminal failure
        self.degraded = False                    # served below what it asked
        self.degraded_from: Optional[Tenant] = None
        self._done = False
        self._event = threading.Event()

    def done(self) -> bool:
        return self._done

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """The generated tokens. A cancelled or failed request raises its
        typed terminal error. ``timeout`` waits that long for a terminal
        state (another thread drives the engine); by default it does not
        wait."""
        if timeout is not None and not self._done:
            self._event.wait(timeout)
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
                 eos_id: Optional[int], handles=None):
        self.fut = fut
        self.prompt = prompt
        self.eos_id = eos_id
        self.handles = handles or []   # in-flight store prefetches


def _slot_insert(big, small, slot: int, axes) -> None:
    """Splice a batch-1 cache into lane ``slot`` of the shared cache, in
    place, along each leaf's batch axis (``lm.cache_batch_axes``): a
    stage's ``KVCache`` or ``MambaCache``, or a hybrid stage's
    {"mamba", "attn"} dict of them."""
    if isinstance(big, dict):
        for key in big:
            _slot_insert(big[key], small[key], slot, axes[key])
        return
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
                     table_dtype, async_prefetch, slot_pad, max_queue,
                     fallback, nan_guard) -> None:
        if fallback not in ("previous", "base", "none"):
            raise ValueError(f"unknown fallback policy {fallback!r} "
                             "(previous | base | none)")
        if cfg.encoder_only:
            raise ValueError("encoder-only archs have no decode serving path")
        self.cfg = cfg
        self.slots = slots
        self.async_prefetch = async_prefetch
        self.engine = MultiTenantEngine(cfg, params, scheduler=scheduler,
                                        store=store, table_dtype=table_dtype,
                                        slot_pad=slot_pad)
        self.device = self.engine._device
        self._pos = np.zeros((slots,), np.int32)      # next cache write index
        self._last = np.zeros((slots,), np.int32)     # last generated token
        self._queue: deque = deque()
        self._rid = 0
        self._vpins: Dict[str, int] = {}   # name@v -> in-flight requests
        self.step_count = 0
        self.tokens_out = 0
        self.decode_slot_waste = 0    # idle-lane decode steps (utilization)
        self.max_queue = max_queue
        self.fallback = fallback
        self.nan_guard = nan_guard
        self.watchdog = EngineWatchdog()
        self.shed = 0          # requests rejected or expired by admission
        self.degraded = 0      # requests served below what they asked for
        self.poisoned = 0      # slots quarantined on non-finite logits
        self.failed = 0        # requests ended with a typed error

    def register(self, pack) -> None:
        self.engine.register(pack)

    def _new_future(self, adapter, max_tokens: int,
                    deadline_s: Optional[float]):
        """A queued request's future with its adapter resolved to concrete
        versions and (synchronous path) loaded, or its prefetches started
        (async path); an adapter that cannot be served walks the fallback
        ladder. Returns (future, handles, ok); when not ok the future
        carries its typed error (a full queue's ``RequestShed``, or the
        load's error once the ladder is exhausted)."""
        t_sub = time.perf_counter()   # arrival precedes the adapter load
        fut = ServeFuture(self._rid, normalize_tenant(adapter), max_tokens)
        self._rid += 1
        fut.submit_time = t_sub
        fut.deadline_s = deadline_s
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            self.shed += 1
            trace.instant("shed.queue_full", cat="serving", rid=fut.rid)
            self._fail_fut(fut, RequestShed(
                f"request {fut.rid} shed (queue_full: "
                f"{len(self._queue)} >= {self.max_queue})", rid=fut.rid,
                reason="queue_full"), count_failed=False)
            return fut, [], False
        try:
            adapter, handles, cold = self._prepare_adapter(adapter)
        except (StoreError, AdapterUnavailable) as e:
            prepared = self._degrade_submit(fut, adapter, e)
            if prepared is None:
                return fut, [], False
            adapter, handles, cold = prepared
        fut.adapter, fut.cold = adapter, cold
        self._pin_versions(fut)
        return fut, handles, True

    def _fail_fut(self, fut: ServeFuture, err: Exception,
                  count_failed: bool = True) -> None:
        """Terminal failure: the typed error on the future, its versions
        unpinned, waiters released."""
        fut.error = err
        fut._done = True
        fut._event.set()
        if count_failed:
            self.failed += 1
        self._unpin_versions(fut)

    def _resolve_future(self, fut: ServeFuture) -> None:
        fut.finished_step = self.step_count
        fut.finish_time = time.perf_counter()
        fut._done = True
        fut._event.set()
        self._unpin_versions(fut)

    # -- fault tolerance: the degradation ladder, shedding, health -------

    def _fallback_candidate(self, cand: Tenant):
        """The next rung below ``cand``, or ``_NO_FALLBACK`` when there is
        none. ``None`` (the base model) is a rung: it always serves."""
        if self.fallback == "none" or cand is None:
            return _NO_FALLBACK
        members = tenant_members(normalize_tenant(cand))
        if len(members) == 1 and self.fallback == "previous":
            prev = prior_version(self.engine.resolve(members[0]))
            store = self.engine.store
            while prev is not None:
                if prev in self.engine.packs or (
                        store is not None and prev in store
                        and prev not in store.quarantined()):
                    return prev
                prev = prior_version(prev)
        return None            # the base model: the ladder's floor

    def _degrade(self, fut: ServeFuture, orig: Tenant, err: ServingError):
        """Walk the ladder down from ``orig``: the prepared (adapter,
        handles, cold) of the first rung that loads, flagged on the future
        with a ``degrade`` instant, or None when the ladder is
        exhausted."""
        cand = self._fallback_candidate(orig)
        while cand is not _NO_FALLBACK:
            try:
                prepared = self._prepare_adapter(cand)
            except (StoreError, AdapterUnavailable):
                cand = self._fallback_candidate(cand)
                continue
            fut.degraded = True
            if fut.degraded_from is None:
                fut.degraded_from = normalize_tenant(orig)
            self.degraded += 1
            trace.instant("degrade", cat="serving", rid=fut.rid,
                          to=repr(prepared[0]), err=type(err).__name__)
            return prepared
        return None

    def _degrade_submit(self, fut: ServeFuture, orig: Tenant,
                        err: ServingError):
        """The ladder at submit (the synchronous path's load failed):
        the prepared rung, or None after failing the future typed."""
        prepared = self._degrade(fut, orig, err)
        if prepared is None:
            self._fail_fut(fut, err)
        return prepared

    def _degrade_queued(self, p, err: ServingError) -> bool:
        """The ladder for a queued request whose prefetch failed: release
        the dead handles, then re-pin and prefetch the rung that loads.
        False when the ladder is exhausted: the request left the queue
        with its typed error."""
        for h in p.handles:
            h.release()
        p.handles = []
        self._unpin_versions(p.fut)
        prepared = self._degrade(p.fut, p.fut.adapter, err)
        if prepared is not None:
            p.fut.adapter, p.handles, _ = prepared
            self._pin_versions(p.fut)
            return True
        try:
            self._queue.remove(p)
        except ValueError:
            pass
        self._fail_fut(p.fut, err)
        return False

    def _expired(self, fut: ServeFuture, now: Optional[float] = None) -> bool:
        return (fut.deadline_s is not None
                and ((now or time.perf_counter()) - fut.submit_time)
                > fut.deadline_s)

    def _shed_queued(self, p, reason: str) -> None:
        """Take a queued request off the queue with a typed
        ``RequestShed``, its prefetches cancelled."""
        try:
            self._queue.remove(p)
        except ValueError:
            pass
        for h in p.handles:
            h.cancel()
        p.handles = []
        self.shed += 1
        trace.instant(f"shed.{reason}", cat="serving", rid=p.fut.rid)
        self._fail_fut(p.fut, RequestShed(
            f"request {p.fut.rid} shed ({reason})", rid=p.fut.rid,
            reason=reason), count_failed=False)

    def _shed_expired(self) -> None:
        """Shed every queued request past its deadline (every step, so
        that none is parked in the queue unseen)."""
        now = time.perf_counter()
        for p in [p for p in self._queue if self._expired(p.fut, now)]:
            self._shed_queued(p, "deadline")

    def health(self) -> Dict[str, Any]:
        """Liveness and degradation: the watchdog's stall view, the queue
        and the occupied lanes, the fault counters, the store's
        quarantine list."""
        store = self.engine.store
        return {
            "watchdog": self.watchdog.snapshot(),
            "queued": len(self._queue),
            "active": sum(a is not None for a in self._active),
            "step_count": self.step_count,
            "tokens_out": self.tokens_out,
            "shed": self.shed,
            "degraded": self.degraded,
            "poisoned": self.poisoned,
            "failed": self.failed,
            "quarantined": store.quarantined() if store is not None else [],
        }

    def _next_tokens(self, logits: torch.Tensor, live: List[int]):
        """Greedy tokens (B,) as numpy, and the live slots whose logits are
        not finite (with ``nan_guard``). An injected poison NaNs one live
        slot's logits first. With no injector and the guard off this is
        the plain argmax; otherwise finiteness is tested on the device and
        read back with the argmax, in one copy."""
        pslot = faults.poison_logits(self.step_count)
        if pslot is None and not self.nan_guard:
            return torch.argmax(logits, -1).cpu().numpy(), ()
        lg = logits.float().clone()
        if pslot is not None and live:
            lg[live[pslot % len(live)]] = float("nan")
        nxt = torch.nan_to_num(lg, nan=0.0, posinf=0.0,
                               neginf=0.0).argmax(-1)
        nxt, finite = torch.stack(
            [nxt, torch.isfinite(lg).all(-1).long()]).cpu().numpy()
        bad = (tuple(s for s in live if not finite[s]) if self.nan_guard
               else ())
        return nxt, bad

    # -- versioned hot swap ---------------------------------------------

    def _pin_versions(self, fut) -> None:
        store = self.engine.store
        fut._vpins = []
        if store is None:
            return
        for m in tenant_members(fut.adapter):
            if split_version(m)[1] is None:
                continue                 # unversioned: nothing to retire
            store.pin_use(m)
            self._vpins[m] = self._vpins.get(m, 0) + 1
            fut._vpins.append(m)

    def _unpin_versions(self, fut) -> None:
        store = self.engine.store
        for m in getattr(fut, "_vpins", ()):
            left = self._vpins.get(m, 0) - 1
            if left > 0:
                self._vpins[m] = left
            else:
                self._vpins.pop(m, None)
            store.unpin_use(m)
        fut._vpins = []
        self._evict_stale()

    def _evict_stale(self) -> None:
        """Retire every registered ``name@v`` that the store has superseded
        and no in-flight request is pinned to."""
        store = self.engine.store
        if store is None:
            return
        for name in list(self.engine.packs):
            base, v = split_version(name)
            if v is None:
                continue
            latest = store.latest_version(base)
            if latest is None or latest <= v or self._vpins.get(name, 0):
                continue
            self.engine.unregister(name)
            store.evict(name)
            trace.instant("hotswap.evict", cat="store", name=name,
                          superseded_by=latest)

    # -- async prefetch pipeline ----------------------------------------

    def _prepare_adapter(self, adapter):
        """Resolve a request's tenant to concrete versions at arrival (a
        publish later never moves it), then register its packs (sync) or
        start their prefetches (async). Returns (adapter, handles, cold)."""
        adapter = normalize_tenant(self.engine.resolve(
            normalize_tenant(adapter)))
        store = self.engine.store
        members = tenant_members(adapter)
        cold = any(m not in self.engine.packs
                   and not (store is not None and store.is_resident(m))
                   for m in members)
        if not self.async_prefetch:
            return _resolve_adapter(self.engine, adapter), [], cold
        handles = []
        for m in members:
            if m in self.engine.packs:
                trace.instant("prefetch.hit", cat="store", name=m,
                              tier="tables")
                continue
            if store is None or m not in store:
                raise KeyError(f"request names unregistered adapter {m!r}")
            handles.append(store.prefetch(
                m, dequantize=self.engine.table_dtype != "int8"))
        return adapter, handles, cold

    def _register_landed(self, p) -> bool:
        """Register a queued request's landed prefetches. A failed load
        walks the request down the fallback ladder (it then waits on the
        rung's prefetches); False when the ladder is exhausted and the
        request left the queue with its typed error."""
        try:
            for h in p.handles:
                self.engine.register(h.result(), background=True)
            p.handles = []
            return True
        except ServingError as e:
            return self._degrade_queued(p, e)

    def _drain_prefetches(self) -> None:
        """Register every queued request whose prefetches have landed, and
        keep a background table build going. Never blocks."""
        if not self.async_prefetch:
            return
        for p in list(self._queue):
            if p.handles and all(h.done() for h in p.handles):
                self._register_landed(p)
        self.engine.kick_async_build()

    def _stall_for_head(self) -> None:
        """No live decode to hide behind: block on the head request's
        prefetches (``prefetch.stall``, the time async could not hide)."""
        p = self._queue[0]
        with trace.span("prefetch.stall", cat="store", rid=p.fut.rid):
            # a failed load leaves the head on a fallback's prefetches,
            # which it waits on too, or takes it off the queue
            while p.handles and self._register_landed(p):
                pass
        self.engine.kick_async_build()

    def _admittable(self, p, had_live: bool) -> bool:
        """FIFO admission gate: a request past its deadline is shed here;
        with the async pipeline its packs are registered, and while a
        rebuild is pending the current tables cover its tenant or nothing
        live would wait on the rebuild."""
        if self._expired(p.fut):
            self._shed_queued(p, "deadline")
            return False
        if not self.async_prefetch:
            return True
        if p.handles:
            return False              # disk load still in flight
        if self.engine.tables_ready():
            return True
        if self.engine.ids_covered([p.fut.adapter]):
            return True
        return not had_live

    def _step_head(self) -> bool:
        """The part of a step before admission: the injected preemption,
        the deadline sheds and the async pipeline. Returns whether a
        request was live when the step began."""
        faults.on_engine_step(self.step_count)
        self._shed_expired()
        self._drain_prefetches()
        had_live = any(a is not None for a in self._active)
        if self.async_prefetch and not had_live and self._queue \
                and self._queue[0].handles:
            self._stall_for_head()
        return had_live

    def cancel(self, fut: ServeFuture) -> bool:
        """Abort a still-queued request: its prefetches are cancelled (a
        disk read not yet started is skipped) and its version pins
        released. Admitted requests cannot be cancelled. Its future fails
        with ``RequestShed``."""
        for p in self._queue:
            if p.fut is fut:
                self._queue.remove(p)
                for h in p.handles:
                    h.cancel()
                p.handles = []
                fut.cancelled = True
                trace.instant("prefetch.cancel", cat="store", rid=fut.rid)
                self._fail_fut(fut, RequestShed(
                    f"request {fut.rid} was cancelled", rid=fut.rid,
                    reason="cancelled"), count_failed=False)
                return True
        return False

    def shutdown(self, include_store: bool = False) -> None:
        """Join the engine's build worker, and the store's prefetch pool
        too with ``include_store`` (stores may be shared)."""
        self.engine.shutdown()
        if include_store and self.engine.store is not None:
            self.engine.store.shutdown()

    def pending(self) -> int:
        return len(self._queue) + sum(p is not None for p in self._active)

    def kv_cache_bytes(self) -> int:
        """Device bytes of the KV cache (an int8 pool's codes and
        scales)."""
        return sum(int(x.numel() * x.element_size())
                   for x in leaves(self.caches))

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

    def _decode(self, live: List[int], block_tables=None) -> bool:
        """One decode step over every lane; emits the live lanes' tokens,
        or quarantines a lane whose logits are not finite (``nan_guard``).
        Idle lanes decode too (their output is discarded): their ``_pos``
        stays 0 until they go live, and ``block_tables`` points them at
        the scratch page. False when a table build failed: nothing was
        emitted and no position moved, and the decode runs again next
        step."""
        self.decode_slot_waste += self.slots - len(live)
        live_set = set(live)
        names = [self._active[s].fut.adapter if s in live_set else None
                 for s in range(self.slots)]
        # the scheduler sees only live lanes: idle slots are not base
        # traffic, and counting them would dilute every tenant's share
        self.engine.schedule([names[s] for s in live],
                             defer=self.async_prefetch)
        try:
            with trace.span("decode", live=len(live)):
                stale = self.async_prefetch
                ids = self.engine.ids_for(names, stale_ok=stale)
                wp = self.engine.wrapped_params(ids, stale_ok=stale)
                toks = torch.from_numpy(self._last[:, None].copy()).to(
                    self.device)
                logits, _ = lm.decode_step(
                    wp, self.cfg, toks, self.caches,
                    torch.from_numpy(self._pos.copy()).to(self.device),
                    block_tables=block_tables)
                nxt, bad = self._next_tokens(logits, live)
        except TableBuildError:
            trace.instant("fault.build_backoff", cat="tables")
            return False
        for s in live:
            self._pos[s] += 1          # this step's KV landed at _pos[s]
            if s in bad:
                self._poison(s)
            else:
                self._emit(s, int(nxt[s]))
        return True

    def _poison_future(self, slot: int, fut: ServeFuture) -> None:
        """Fail the request on a quarantined slot with ``SlotPoisoned``."""
        self.poisoned += 1
        trace.instant("slot.poison", cat="serving", rid=fut.rid, slot=slot,
                      step=self.step_count)
        self._fail_fut(fut, SlotPoisoned(
            f"request {fut.rid} poisoned: non-finite logits on slot {slot} "
            f"at step {self.step_count}", rid=fut.rid, step=self.step_count))

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
                 table_dtype: str = "f32", async_prefetch: bool = False,
                 slot_pad: int = 1, max_queue: Optional[int] = None,
                 fallback: str = "previous", nan_guard: bool = False):
        self._init_common(cfg, params, slots, scheduler, store, table_dtype,
                          async_prefetch, slot_pad, max_queue, fallback,
                          nan_guard)
        self.cache_size = cache_size
        self.caches = lm.init_cache(cfg, slots, cache_size,
                                    device=self.device)
        self._axes = lm.cache_batch_axes(cfg)
        self._active: List[Optional[_Pending]] = [None] * slots

    def submit(self, prompt_tokens, adapter: Tenant = None,
               max_tokens: int = 16, eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None) -> ServeFuture:
        """Queue one request; returns its future. ``adapter`` is a
        registered (or store) adapter id, a stack of ids, or None for the
        base model. ``deadline_s`` bounds the time it may wait in the
        queue; past it, it is shed with ``RequestShed``, as it is at once
        when a bounded queue (``max_queue``) is full."""
        if max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        prompt = np.asarray(prompt_tokens, np.int32).reshape(-1)
        # the final generated token is returned but never written back to
        # the cache, so a request needs one slot less than prompt+max_tokens
        # (and a vision model's prefix rows besides)
        need = prompt.shape[0] + self.cfg.prefix_rows + max_tokens - 1
        if need > self.cache_size:
            raise ValueError(f"prompt ({prompt.shape[0]}) + max_tokens "
                             f"({max_tokens}) needs {need} cache slots, "
                             f"engine has {self.cache_size}")
        fut, handles, ok = self._new_future(adapter, max_tokens, deadline_s)
        if ok:
            self._queue.append(_Pending(fut, prompt, eos_id, handles))
        return fut

    def _free_lane(self, slot: int) -> None:
        self._active[slot] = None
        self._pos[slot] = 0
        self._last[slot] = 0

    def _finish(self, slot: int) -> None:
        self._resolve_future(self._active[slot].fut)
        self._free_lane(slot)

    def _poison(self, slot: int) -> None:
        """Quarantine one lane whose logits went non-finite: its request
        fails typed and the lane is freed; the batch decodes on."""
        fut = self._active[slot].fut
        self._free_lane(slot)
        self._poison_future(slot, fut)

    def _admit(self, slot: int, p: _Pending) -> None:
        with trace.span("admit", rid=p.fut.rid, slot=slot,
                        prompt=int(p.prompt.shape[0])):
            stale = self.async_prefetch
            ids = self.engine.ids_for([p.fut.adapter], stale_ok=stale)
            wp = self.engine.wrapped_params(ids, stale_ok=stale)
            batch = {"tokens": torch.from_numpy(p.prompt[None].copy()).to(
                self.device)}
            if self.cfg.prefix_rows:            # zero patch embeddings
                batch["patch_embeds"] = torch.zeros(
                    (1, self.cfg.prefix_rows, self.cfg.d_model),
                    device=self.device)
            logits, c1 = lm.prefill(wp, self.cfg, batch, self.cache_size)
            for big, small, ax in zip(self.caches, c1, self._axes):
                _slot_insert(big, small, slot, ax)
            self._active[slot] = p
            p.fut.submitted_step = self.step_count
            self._pos[slot] = p.prompt.shape[0] + self.cfg.prefix_rows
            self._emit(slot, int(torch.argmax(logits[0])))

    def step(self) -> bool:
        """Admit queued requests into free lanes, then run one decode step
        over every occupied lane. Returns False when fully drained."""
        with trace.span("step", engine="lane") as sp:
            t0 = time.perf_counter()
            had_live = self._step_head()
            for slot in range(self.slots):
                if self._active[slot] is None and self._queue:
                    if not self._admittable(self._queue[0], had_live):
                        break          # FIFO: the head's load is landing
                    p = self._queue.popleft()
                    try:
                        self._admit(slot, p)
                    except TableBuildError:
                        # the build failed: back at the head, retried on
                        # the next step's build
                        self._queue.appendleft(p)
                        trace.instant("fault.build_backoff", cat="tables")
                        break
            live = [s for s in range(self.slots)
                    if self._active[s] is not None]
            if not live:
                return bool(self._queue)
            self.step_count += 1
            sp.set(step=self.step_count, live=len(live))
            if self._decode(live):
                self.watchdog.record(time.perf_counter() - t0)
            return True


# ---------------------------------------------------------------------------
# Paged engine
# ---------------------------------------------------------------------------

class _PagedRequest:
    __slots__ = ("fut", "prompt", "eos_id", "need", "nblk", "state", "done",
                 "pages", "reserve", "handles")

    def __init__(self, fut: ServeFuture, prompt: np.ndarray,
                 eos_id: Optional[int], need: int, nblk: int, handles=None):
        self.fut = fut
        self.prompt = prompt
        self.eos_id = eos_id
        self.need = need          # KV rows this request may write
        self.nblk = nblk          # block-table entries it needs
        self.state = "prefill"
        self.done = 0             # prompt tokens already in the cache
        self.pages: List[int] = []     # block-table pages (1 ref each)
        self.reserve: List[int] = []   # preallocated COW spares
        self.handles = handles or []   # in-flight store prefetches


class PagedServingEngine(_EngineCommon):
    """Continuous batching over a paged KV pool with COW prefix sharing and
    chunked-prefill admission. Dense text models only."""

    def __init__(self, cfg, params, *, slots: int = 4, num_pages: int = 64,
                 page_size: int = 8, max_len: Optional[int] = None,
                 chunk_size: Optional[int] = None,
                 scheduler: Optional[FusedLRU] = None, store=None,
                 table_dtype: str = "f32", quant_kv: bool = False,
                 async_prefetch: bool = False, slot_pad: int = 1,
                 max_queue: Optional[int] = None,
                 fallback: str = "previous", nan_guard: bool = False):
        self._init_common(cfg, params, slots, scheduler, store, table_dtype,
                          async_prefetch, slot_pad, max_queue, fallback,
                          nan_guard)
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_len = max_len or (num_pages - 1) * page_size
        self.max_blocks = pages_for(self.max_len, page_size)
        self.chunk_size = chunk_size or page_size
        self.pool = PagePool(num_pages, page_size)
        self.caches = lm.init_paged_cache(cfg, num_pages, page_size,
                                          device=self.device, quant=quant_kv)
        self._bt = np.zeros((slots, self.max_blocks), np.int32)
        self._active: List[Optional[_PagedRequest]] = [None] * slots
        self.prefill_chunks = 0
        self.peak_resident = 0        # max concurrently admitted requests
        self.peak_used_pages = 0      # incl. evictable registry-only pages
        self.peak_ws_pages = 0        # pages pinned by admitted requests

    def page_bytes(self) -> int:
        """Device bytes of ONE physical page across the whole layer stack
        (codes and scales, for int8 pages)."""
        return self.kv_cache_bytes() // self.num_pages

    def submit(self, prompt_tokens, adapter: Tenant = None,
               max_tokens: int = 16, eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None) -> ServeFuture:
        """Queue one request, as ``ServingEngine.submit``."""
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
        fut, handles, ok = self._new_future(adapter, max_tokens, deadline_s)
        if ok:
            self._queue.append(_PagedRequest(fut, prompt, eos_id, need,
                                             nblk, handles))
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
        with trace.span("admit", rid=r.fut.rid, slot=slot,
                        prompt=int(L_)) as sp:
            shared_len, shared = self.pool.match_prefix(
                r.prompt, salt=_prefix_salt(r.fut.adapter))
            cow = int(shared_len < len(shared) * p)
            cow += int(r.need > L_ and L_ % p != 0)
            n_owned = r.nblk - len(shared)
            if not self.pool.can_alloc(n_owned + cow):
                self.pool.release(shared)
                sp.set(admitted=False)
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
            sp.set(admitted=True, shared_len=int(shared_len),
                   pages=len(row), reserve=len(r.reserve))
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
            with trace.span("cow_copy", cat="pages", slot=slot, src=pg,
                            dst=int(dst)):
                copy_page(self.caches, pg, dst, page_axis=1)
            self._bt[slot, blk] = dst
            r.pages[r.pages.index(pg)] = dst
            self.pool.release([pg])
            self.pool.cow_copies += 1

    def _free_slot(self, slot: int) -> None:
        r = self._active[slot]
        self.pool.release(r.pages + r.reserve)
        r.pages, r.reserve = [], []
        self._active[slot] = None
        self._bt[slot, :] = 0
        self._pos[slot] = 0
        self._last[slot] = 0

    def _finish(self, slot: int) -> None:
        self._resolve_future(self._active[slot].fut)
        self._free_slot(slot)

    def _poison(self, slot: int) -> None:
        """Quarantine one slot whose logits went non-finite: its request
        fails typed and its pages are freed; the batch decodes on."""
        fut = self._active[slot].fut
        self._free_slot(slot)
        self._poison_future(slot, fut)

    def _prefill_step(self, slot: int) -> None:
        r = self._active[slot]
        L_ = r.prompt.shape[0]
        lo = r.done
        hi = min(L_, lo + self.chunk_size)
        with trace.span("prefill_chunk", slot=slot, lo=int(lo), hi=int(hi)):
            self._ensure_writable(slot, lo, hi)
            toks = torch.from_numpy(r.prompt[None, lo:hi].copy()).to(
                self.device)
            stale = self.async_prefetch
            ids = self.engine.ids_for([r.fut.adapter], stale_ok=stale)
            wp = self.engine.wrapped_params(ids, stale_ok=stale)
            logits, _ = lm.prefill_chunk(
                wp, self.cfg, toks, self.caches,
                torch.from_numpy(self._bt[slot:slot + 1].copy()).to(
                    self.device), lo, hi - lo)
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
        with trace.span("step", engine="paged") as sp:
            t0 = time.perf_counter()
            had_live = self._step_head()
            for slot in range(self.slots):
                if self._active[slot] is None and self._queue:
                    if not self._admittable(self._queue[0], had_live):
                        break          # FIFO: the head's load is landing
                    if not self._try_admit(slot, self._queue[0]):
                        break
                    self._queue.popleft()
            pf = [s for s in range(self.slots) if self._active[s] is not None
                  and self._active[s].state == "prefill"]
            live = [s for s in range(self.slots)
                    if self._active[s] is not None
                    and self._active[s].state == "live"]
            self.peak_resident = max(self.peak_resident, len(pf) + len(live))
            self.peak_used_pages = max(self.peak_used_pages,
                                       self.pool.used_pages())
            # working set = distinct pages pinned by admitted requests
            # (block tables, shared prefixes counted once, COW reserves);
            # registry-only pages are an LRU cache, reclaimable on demand
            ws = set()
            for s in pf + live:
                ws.update(int(x) for x in self._bt[s] if x)
                ws.update(self._active[s].reserve)
            self.peak_ws_pages = max(self.peak_ws_pages, len(ws))
            if not pf and not live:
                return bool(self._queue)
            self.step_count += 1
            sp.set(step=self.step_count, prefill=len(pf), live=len(live))
            trace.counter("free_pages", self.pool.free_pages(), cat="pages")
            trace.counter("resident", len(pf) + len(live))
            if pf:
                try:
                    self._prefill_step(pf[0])
                except TableBuildError:
                    # the chunk was not applied (r.done as it was): it
                    # runs again next step against a new build
                    trace.instant("fault.build_backoff", cat="tables")
            if live:
                for s in live:
                    self._ensure_writable(s, int(self._pos[s]),
                                          int(self._pos[s]) + 1)
                # idle and still-prefilling lanes decode against the
                # scratch page
                mask = np.isin(np.arange(self.slots), live)
                bt = np.where(mask[:, None], self._bt, 0).astype(np.int32)
                if not self._decode(live,
                                    torch.from_numpy(bt).to(self.device)):
                    return True
            self.watchdog.record(time.perf_counter() - t0)
            return True
