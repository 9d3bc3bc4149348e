"""AdapterStore: the adapter registry the serving engines load through.

Port of ``repro/hub/store.py``. A store maps adapter ids to ``.shpk`` pack
files on disk (``hub.packio``) and keeps a bounded working set in host
memory; engines ask it by name and get back an immutable ``AdapterPack``:

  store = AdapterStore(root, budget_bytes=64 << 20)
  store.add(pack, values="int8")        # serialize + register
  store.register_file("a0.shpk")        # register an existing file (lazy)
  store.publish(pack)                   # the next version: "a0@1", "a0@2"
  engine.register(store.get("a0"))      # or engine.register("a0")

Tiers, each LRU under its own budget:

  * disk: the registered files (never dropped);
  * resident (``budget_bytes``): the form the file stores, f32 packs as
    ``AdapterPack``, int8 packs as their ~2-byte-an-entry ``QuantPack``
    (``get`` dequantizes, ``get_raw`` does not). Packs added with
    ``pin=True``, kept in memory by a store with no root, or pinned by an
    outstanding prefetch or a serving engine's version pin
    (``pin_use``), are never evicted;
  * staging (``staging_bytes``, off by default): upload-ready f32 packs
    in pinned host memory (``Tensor.pin_memory``), which the engines copy
    to the card without a pageable bounce. An int8 pack is staged
    dequantized, as the reference stages it; unlike the reference, an f32
    pack is staged too, as its pinned copy. Pinning runs where the pack
    is loaded (on a prefetch worker under ``prefetch``), never in the
    serving loop, and evicting a staged pack frees its pinned buffers.

Versioned ids: ``publish`` registers a pack as ``name@v`` (v counts up
per base name), ``resolve`` maps a bare name to its newest version, and
an id with a version resolves to itself, which is how serving requests
keep the version they arrived on through a hot swap.

Async prefetch: ``prefetch(name)`` starts the disk load (and the staging)
on a small worker pool and returns a ``PrefetchHandle`` at once. While a
handle is outstanding its adapter is pinned against eviction; duplicate
prefetches share one disk read, and ``get``/``get_raw`` join a load in
flight. Worker loads record ``prefetch.disk`` spans, synchronous ones
``disk_load``; submits emit ``prefetch.hit``/``prefetch.miss`` and a
``store.inflight_bytes`` counter; evictions ``store.evict`` and
``store.stage_evict``; ``publish`` a ``store.publish`` instant.

A failed load raises the port's ``StoreError`` (from a handle's
``result`` too, never the worker's raw exception). Retries and
quarantine wait (ROADMAP A8): ``quarantine`` raises
``NotImplementedError``, and a load is tried once.

Thread-safety: one reentrant lock guards the tiers' bookkeeping; disk
reads, dequantization and pinning run outside it.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from concurrent.futures import CancelledError, Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutTimeoutError
from typing import Dict, List, Optional, Union

import torch

from repro_torch.analysis import trace
from repro_torch.core.adapters import AdapterPack, map_entries
from repro_torch.core.switching import split_version, versioned_id
from repro_torch.hub.packio import (PackFormatError, QuantPack, load_pack,
                                    peek_pack, quantize_pack, save_pack)
from repro_torch.runtime.faults import ServingError, StoreError


def pinned(pack: AdapterPack) -> AdapterPack:
    """The pack's entries copied into pinned host memory (the same
    values; already pinned entries are kept)."""
    return map_entries(pack, lambda t: t if t.is_pinned()
                       else t.cpu().pin_memory())


class PrefetchHandle:
    """An in-flight (or already satisfied) adapter load.

    ``result()`` blocks until the load lands and returns the pack in the
    requested form; ``done()`` polls. ``cancel()`` abandons interest (the
    disk read is skipped if it has not started and no other handle shares
    it). Exactly one of ``result`` / ``cancel`` / ``release`` drops the
    handle's eviction pin; all are idempotent. ``cold`` records whether
    the adapter was not resident at submit."""

    __slots__ = ("store", "name", "cold", "dequantize", "_fut", "_released")

    def __init__(self, store: "AdapterStore", name: str, cold: bool,
                 dequantize: bool, fut: Optional[Future]):
        self.store = store
        self.name = name
        self.cold = cold
        self.dequantize = dequantize
        self._fut = fut                    # None = was resident at submit
        self._released = False

    def done(self) -> bool:
        return self._fut is None or self._fut.done()

    def result(self, timeout: Optional[float] = None) \
            -> Union[AdapterPack, QuantPack]:
        """The loaded pack (the stored form, or f32 when the handle was
        made with ``dequantize=True``). The pin is released on success and
        on failure; a worker's failure comes back as ``StoreError``. On a
        ``timeout`` the ``TimeoutError`` is raised with the pin held and
        the handle stays usable."""
        if self._fut is not None:
            try:
                self._fut.result(timeout=timeout)
            except CancelledError:
                pass          # another handle's cancel raced us: load below
            except FutTimeoutError:
                raise
            except ServingError:
                self.release()
                raise
            except Exception as e:
                self.release()
                raise StoreError(f"prefetch of adapter {self.name!r} "
                                 f"failed: {e}", name=self.name) from e
        try:
            # read through the tiers: LRU recency is kept and a staged
            # form is reused; the pin guarantees residency
            if self.dequantize:
                return self.store.get(self.name)
            return self.store.get_raw(self.name)
        finally:
            self.release()

    def cancel(self) -> bool:
        """Abandon the prefetch. True when the disk read was skipped."""
        skipped = False
        if self._fut is not None and not self._released:
            skipped = self.store._cancel_inflight(self.name, self._fut)
        self.release()
        return skipped

    def release(self) -> None:
        """Drop the eviction pin without consuming the result."""
        if not self._released:
            self._released = True
            self.store._unpin_inflight(self.name)


class AdapterStore:
    def __init__(self, root: Optional[str] = None,
                 budget_bytes: Optional[int] = None,
                 staging_bytes: Optional[int] = None,
                 workers: int = 2):
        self.root = root
        if root is not None:
            os.makedirs(root, exist_ok=True)
        self.budget_bytes = budget_bytes
        self.staging_bytes = staging_bytes
        self.workers = max(int(workers), 1)
        self._paths: Dict[str, Optional[str]] = {}    # id -> file (None = mem)
        self._latest: Dict[str, int] = {}             # base name -> newest v
        self._pinned: set = set()
        # id -> resident AdapterPack | QuantPack, LRU order (oldest first)
        self._resident: "OrderedDict[str, Union[AdapterPack, QuantPack]]" \
            = OrderedDict()
        # id -> pinned f32 AdapterPack, LRU order
        self._staging: "OrderedDict[str, AdapterPack]" = OrderedDict()
        self._lock = threading.RLock()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._inflight: Dict[str, int] = {}           # eviction pins (refcnt)
        self._futs: Dict[str, Future] = {}            # one load per id
        self._fut_est: Dict[str, int] = {}            # submit-time bytes
        self._inflight_bytes = 0
        self._shutdown = False
        self.loads = 0                                # disk loads (cache miss)
        self.evictions = 0
        self.staging_hits = 0
        self.prefetch_hits = 0                        # submit found resident
        self.prefetch_misses = 0                      # submit went to disk

    # ------------------------------------------------------------------
    # Registration
    # ------------------------------------------------------------------

    def add(self, pack: AdapterPack, values: str = "f32",
            pin: bool = False) -> str:
        """Serialize ``pack`` into the store's root (or keep it in memory if
        the store has no root) and register it. Returns the adapter id."""
        if self.root is None:
            if values == "bf16":
                raise ValueError("bf16 pack storage needs a file-backed "
                                 "store (root=None holds f32 or int8)")
            form = quantize_pack(pack) if values == "int8" else pack
            with self._lock:
                self._paths[pack.name] = None
                self._pinned.add(pack.name)           # nothing to reload from
                self._note_version(pack.name)
                self._admit(pack.name, form)
            return pack.name
        path = os.path.join(self.root, f"{pack.name}.shpk")
        save_pack(pack, path, values=values)
        with self._lock:
            self._paths[pack.name] = path
            if pin:
                self._pinned.add(pack.name)
            self._note_version(pack.name)
            self._resident.pop(pack.name, None)       # re-add replaces
            self._staging.pop(pack.name, None)
        return pack.name

    def register_file(self, path: str, name: Optional[str] = None,
                      pin: bool = False) -> str:
        """Register an existing pack file without reading its payload."""
        name = name or peek_pack(path)["name"]
        with self._lock:
            self._paths[name] = path
            if pin:
                self._pinned.add(name)
            self._note_version(name)
            self._resident.pop(name, None)
            self._staging.pop(name, None)
        return name

    # ------------------------------------------------------------------
    # Versioned publish / newest-wins resolution
    # ------------------------------------------------------------------

    def _note_version(self, name: str) -> None:
        # caller holds self._lock
        base, v = split_version(name)
        if v is not None and v > self._latest.get(base, 0):
            self._latest[base] = v

    def publish(self, pack: AdapterPack, values: str = "f32",
                pin: bool = False) -> str:
        """Register ``pack`` as the next version of its base name; returns
        the id ``name@v``. A pack whose name already carries a version
        publishes the next version of its base name."""
        base, _ = split_version(pack.name)
        with self._lock:
            v = self._latest.get(base, 0) + 1
            self._latest[base] = v            # reserve against racing publish
        vid = versioned_id(base, v)
        self.add(map_entries(pack, name=vid), values=values, pin=pin)
        trace.instant("store.publish", cat="store", name=vid)
        return vid

    def resolve(self, name: str) -> str:
        """A bare name with published versions -> ``name@latest``; an id
        with a version, or a name never published, comes back as it is."""
        base, v = split_version(name)
        if v is not None:
            return name
        with self._lock:
            latest = self._latest.get(name)
        return versioned_id(name, latest) if latest else name

    def latest_version(self, base: str) -> Optional[int]:
        with self._lock:
            return self._latest.get(base)

    def versions(self, base: str) -> List[str]:
        """Registered versioned ids of ``base``, oldest first."""
        with self._lock:
            vs = [(v, n) for n in self._paths
                  for b, v in [split_version(n)] if b == base and v]
        return [n for _, n in sorted(vs)]

    def pin_use(self, name: str) -> str:
        """Counted eviction pin for a version an engine serves from (the
        pin prefetch handles hold). Returns the concrete id pinned; pass
        it to ``unpin_use`` when the last request on it drains."""
        name = self.resolve(name)
        self._pin_inflight(name)
        return name

    def unpin_use(self, name: str) -> None:
        self._unpin_inflight(name)

    def quarantine(self, name: str, reason: str = "manual") -> None:
        raise NotImplementedError("AdapterStore quarantine and the load-retry "
                                  "ladder are not ported (ROADMAP A8)")

    # ------------------------------------------------------------------
    # Lookup
    # ------------------------------------------------------------------

    def names(self) -> List[str]:
        return sorted(self._paths)

    def __contains__(self, name: str) -> bool:
        return name in self._paths or name in self._latest

    def is_resident(self, name: str) -> bool:
        """Resident-tier hit test, without an LRU touch."""
        name = self.resolve(name)
        with self._lock:
            return name in self._resident

    def get(self, name: str) -> AdapterPack:
        """Immutable f32 pack; loads from disk (evicting LRU residents past
        the byte budget) on a miss. With a staging tier, the staged pinned
        form (int8 packs dequantize into it once)."""
        name = self.resolve(name)
        with self._lock:
            staged = self._staging.get(name)
            if staged is not None:
                self._staging.move_to_end(name)
                self.staging_hits += 1
                if name in self._resident:
                    self._resident.move_to_end(name)
                return staged
        form = self.get_raw(name)
        if isinstance(form, QuantPack) or self.staging_bytes is not None:
            return self._stage(name, form)
        return form

    def get_raw(self, name: str) -> Union[AdapterPack, QuantPack]:
        """The resident form as stored: an int8 pack comes back as its
        ``QuantPack`` (what ``MultiTenantEngine(table_dtype="int8")``
        builds its tables from), f32 and bf16 packs as ``AdapterPack``.
        Joins a load of the same id in flight."""
        name = self.resolve(name)
        if name not in self._paths:
            raise KeyError(f"unknown adapter {name!r}; registered: "
                           f"{self.names()}")
        with self._lock:
            form = self._resident.get(name)
            if form is not None:
                self._resident.move_to_end(name)
                return form
            fut = self._futs.get(name)
        if fut is not None:
            try:
                return fut.result()
            except (CancelledError, Exception):
                pass                  # cancelled or failed: load here
            with self._lock:
                form = self._resident.get(name)
                if form is not None:
                    self._resident.move_to_end(name)
                    return form
        # pinned, so a worker's admit cannot evict it before we return it
        self._pin_inflight(name)
        try:
            return self._load(name, span="disk_load")
        finally:
            self._unpin_inflight(name)

    # ------------------------------------------------------------------
    # Async prefetch
    # ------------------------------------------------------------------

    def prefetch(self, name: str, dequantize: bool = False) \
            -> PrefetchHandle:
        """Start loading ``name`` in the background; returns at once. A
        resident pack is a hit (the handle is done). Otherwise the disk
        read, and with ``dequantize`` the staging of the f32 form, run on
        the worker pool (a ``prefetch.disk`` span on the worker's tid).
        The adapter is pinned against eviction until the handle is
        released."""
        name = self.resolve(name)
        if name not in self._paths:
            raise KeyError(f"unknown adapter {name!r}; registered: "
                           f"{self.names()}")
        with self._lock:
            self._pin_inflight(name)
            if name in self._resident:
                self._resident.move_to_end(name)
                self.prefetch_hits += 1
                trace.instant("prefetch.hit", cat="store", name=name)
                return PrefetchHandle(self, name, cold=False,
                                      dequantize=dequantize, fut=None)
            self.prefetch_misses += 1
            trace.instant("prefetch.miss", cat="store", name=name)
            fut = self._futs.get(name)
            if fut is None and not self._shutdown:
                path = self._paths[name]
                assert path is not None, f"in-memory pack {name!r} lost"
                try:
                    est = os.path.getsize(path)
                except OSError:
                    est = 0
                self._inflight_bytes += est
                self._fut_est[name] = est
                trace.counter("store.inflight_bytes", self._inflight_bytes,
                              cat="store")
                if self._pool is None:
                    self._pool = ThreadPoolExecutor(
                        max_workers=self.workers,
                        thread_name_prefix="shira-prefetch")
                fut = self._pool.submit(self._prefetch_job, name,
                                        dequantize, est)
                self._futs[name] = fut
            # a shut-down store hands back a workerless handle: result()
            # then loads synchronously through the same tiers
            return PrefetchHandle(self, name, cold=True,
                                  dequantize=dequantize, fut=fut)

    def _prefetch_job(self, name: str, dequantize: bool, est: int):
        try:
            form = self._load(name, span="prefetch.disk")
            if dequantize and (isinstance(form, QuantPack)
                               or self.staging_bytes is not None):
                self._stage(name, form, span="prefetch.decode")
            return form
        finally:
            with self._lock:
                self._futs.pop(name, None)
                self._fut_est.pop(name, None)
                self._inflight_bytes -= est
                trace.counter("store.inflight_bytes", self._inflight_bytes,
                              cat="store")

    def _cancel_inflight(self, name: str, fut: Future) -> bool:
        """Cancel a load that has not started, when this is its only pin;
        balances the books the skipped job would have."""
        with self._lock:
            if self._inflight.get(name, 0) > 1:
                return False          # someone else still wants this load
            if self._futs.get(name) is not fut or not fut.cancel():
                return False
            self._futs.pop(name, None)
            self._inflight_bytes -= self._fut_est.pop(name, 0)
            trace.counter("store.inflight_bytes", self._inflight_bytes,
                          cat="store")
            return True

    def shutdown(self, wait: bool = True) -> None:
        """Retire the worker pool; idempotent. ``wait=True`` lets every
        submitted load finish; ``wait=False`` cancels the loads that have
        not started. Later ``prefetch`` calls return workerless handles,
        which load on ``result()``."""
        with self._lock:
            self._shutdown = True
            pool, self._pool = self._pool, None
            if not wait:
                for name, fut in list(self._futs.items()):
                    if fut.cancel():
                        self._futs.pop(name, None)
                        self._inflight_bytes -= self._fut_est.pop(name, 0)
                        trace.counter("store.inflight_bytes",
                                      self._inflight_bytes, cat="store")
        if pool is not None:
            pool.shutdown(wait=wait)

    # ------------------------------------------------------------------
    # Residency accounting
    # ------------------------------------------------------------------

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(f.nbytes() for f in self._resident.values())

    def resident_names(self) -> List[str]:
        """LRU order, oldest first."""
        with self._lock:
            return list(self._resident)

    def staged_bytes(self) -> int:
        with self._lock:
            return sum(p.nbytes() for p in self._staging.values())

    def staged_names(self) -> List[str]:
        with self._lock:
            return list(self._staging)

    def inflight_names(self) -> List[str]:
        """Adapters pinned by outstanding loads, handles or engines."""
        with self._lock:
            return sorted(self._inflight)

    def _pin_inflight(self, name: str) -> None:
        with self._lock:
            self._inflight[name] = self._inflight.get(name, 0) + 1

    def _unpin_inflight(self, name: str) -> None:
        with self._lock:
            n = self._inflight.get(name, 0) - 1
            if n <= 0:
                self._inflight.pop(name, None)
            else:
                self._inflight[name] = n

    def _load(self, name: str, span: str) -> Union[AdapterPack, QuantPack]:
        """One disk load into the resident tier; a failed read raises
        ``StoreError``."""
        path = self._paths[name]
        assert path is not None, f"in-memory pack {name!r} lost"
        try:
            with trace.span(span, cat="store", name=name) as sp:
                form = load_pack(path, dequantize=False)
                sp.set(bytes=form.nbytes())
        except (OSError, PackFormatError) as e:
            raise StoreError(f"failed to load adapter {name!r}: {e}",
                             name=name) from e
        with self._lock:
            self.loads += 1
            self._admit(name, form)
        return form

    def _stage(self, name: str, form, span: str = "dequant") -> AdapterPack:
        """The f32 form of ``form`` through the staging tier: dequantized
        (int8) and, with a tier configured, pinned and cached."""
        with self._lock:
            staged = self._staging.get(name)
            if staged is not None:
                self._staging.move_to_end(name)
                self.staging_hits += 1
                return staged
        with trace.span(span, cat="store", name=name):
            pack = form.dequantize() if isinstance(form, QuantPack) else form
            if self.staging_bytes is None:
                return pack
            if torch.cuda.is_available():
                pack = pinned(pack)
        with self._lock:
            self._staging[name] = pack
            self._staging.move_to_end(name)
            while self.staged_bytes() > self.staging_bytes:
                victim = next((n for n in self._staging
                               if n != name and n not in self._inflight),
                              None)
                if victim is None:
                    break
                del self._staging[victim]          # frees its pinned buffers
                trace.instant("store.stage_evict", cat="store", name=victim)
        return pack

    def _admit(self, name: str, form) -> None:
        with self._lock:
            self._resident[name] = form
            self._resident.move_to_end(name)
            if self.budget_bytes is None:
                return
            while self.resident_bytes() > self.budget_bytes:
                # never the newcomer, pinned packs, or packs a load, a
                # handle or an engine's version pin holds
                victim = next((n for n in self._resident
                               if n != name and n not in self._pinned
                               and n not in self._inflight), None)
                if victim is None:
                    break
                del self._resident[victim]
                self._staging.pop(victim, None)
                self.evictions += 1
                trace.instant("store.evict", cat="store", name=victim)

    def evict(self, name: str) -> bool:
        """Drop a resident form explicitly (the file stays registered).
        Refused while a load, a handle or an engine pins the adapter."""
        name = self.resolve(name)
        with self._lock:
            if (name in self._resident
                    and self._paths.get(name) is not None
                    and name not in self._inflight):
                del self._resident[name]
                self._staging.pop(name, None)
                self.evictions += 1
                return True
            return False
