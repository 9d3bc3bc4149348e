"""KV-cache memory: int8 quantization and the paged page-pool layout.

Port of ``repro/serving/kvcache.py``. Two layers:

**Quantization** (``QuantKV``): per-(token, head) absmax int8 codes and
bf16 scales, 130 bytes a row and head of 128 where bf16 takes 256, so the
same memory holds 1.97x the tokens. ``quantize_kv`` divides by the f32
scale, rounds half to even and clips to +-127 before the scale is stored
as bf16; ``dequantize_kv`` multiplies in f32 and rounds the product to
bf16. Codes and scales are bit for bit the reference's. A ``QuantKV`` is a
contiguous cache (``quant_cache_zeros``, ``update_quant_cache``) or the
element type of int8 pages.

**Paged layout**: serving does not give every request a contiguous
``cache_size`` stripe. One global page pool per layer stack,
(num_pages, page_size, heads, d) tensors (a ``QuantKV`` for int8 pages),
is shared by all requests, and each request owns a *block table* mapping
its logical KV blocks to physical pages:

  token position t  ->  page  block_table[t // page_size]
                        row   t %  page_size

Device-side primitives (torch, in place where the reference returns
copies):

  paged_gather(pool, block_tables)       -> contiguous (B, S_max, ...) copy
                                            (int8 pools dequantized to bf16)
  paged_write(pool, new, block_tables, positions, valid)  -> scatter rows
                                            (int8 pools quantize them)
  copy_page(pool, src, dst)              -> clone one physical page (COW),
                                            codes and scales alike

Host-side policy (``PagePool``): page refcounts, the free list, and a
refcounted prefix registry for copy-on-write prefix sharing, salted by
whatever shaped the forward pass (the engine salts with the adapter
stack). Shared pages are immutable: a writer holding a page with refcount
> 1 copies it into a fresh page first. Registry entries are evicted LRU
when the free list runs dry. Page 0 is a pinned scratch page: padded or
invalid writes land there and null block-table entries point at it.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.flash_decode import (dequantize_rows,  # noqa: F401
                                              paged_gather)


class QuantKV(NamedTuple):
    codes: torch.Tensor   # int8, the shape of the bf16 tensor
    scales: torch.Tensor  # bf16, shape[:-1] + (1,): one per (..., token, head)


def quantize_kv(x: torch.Tensor) -> QuantKV:
    """x: (..., D) -> int8 codes and a per-row absmax scale."""
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    codes = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return QuantKV(codes, scale.to(torch.bfloat16))


def dequantize_kv(q: QuantKV) -> torch.Tensor:
    return dequantize_rows(q.codes, q.scales)


def quant_cache_zeros(shape: Tuple[int, ...], device="cuda") -> QuantKV:
    return QuantKV(torch.zeros(shape, dtype=torch.int8, device=device),
                   torch.zeros(tuple(shape[:-1]) + (1,), dtype=torch.bfloat16,
                               device=device))


def update_quant_cache(cache: QuantKV, new: torch.Tensor, pos,
                       seq_axis: int = 1) -> QuantKV:
    """Write ``new`` (one new token's rows) at sequence position ``pos`` of
    the cache's ``seq_axis``, in place; returns the cache."""
    qn = quantize_kv(new)
    nd = cache.codes.ndim
    if not -nd <= seq_axis < nd:
        raise ValueError(f"seq_axis {seq_axis} out of range for cache rank "
                         f"{nd}")
    seq_axis %= nd
    p = int(pos)
    for dst, src in zip(cache, qn):
        dst.narrow(seq_axis, p, src.shape[seq_axis]).copy_(src)
    return cache


def cache_bytes(shape: Tuple[int, ...], quant: bool) -> int:
    n = int(np.prod(shape, dtype=np.int64))
    rows = n // shape[-1]
    return n + rows * 2 if quant else n * 2


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a cache tree: a tensor, a ``QuantKV``, a ``KVCache``,
    a ``MambaCache``, a hybrid stage's {"mamba", "attn"} dict, or a list
    of them, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [t for x in tree for t in leaves(x)]


# ---------------------------------------------------------------------------
# Paged device primitives. A "pool" is a tensor (P, page, *tail) or a
# QuantKV whose codes have that shape; block tables are (B, nblk) int32
# physical page ids (0 = the scratch page).
# ---------------------------------------------------------------------------

def pool_zeros(num_pages: int, page_size: int, tail: Tuple[int, ...],
               dtype, device="cuda", quant: bool = False):
    """A zero pool (num_pages, page_size, *tail) of ``dtype``, or with
    ``quant`` an int8 ``QuantKV`` pool of that shape."""
    shape = (num_pages, page_size) + tuple(tail)
    if quant:
        return quant_cache_zeros(shape, device)
    return torch.zeros(shape, dtype=dtype, device=device)


def _write_coords(block_tables: torch.Tensor, positions: torch.Tensor,
                  valid: torch.Tensor, page_size: int):
    """(page_id, row) scatter coordinates; invalid rows target scratch 0."""
    nblk = block_tables.shape[1]
    blk = torch.clamp(positions // page_size, 0, nblk - 1).long()
    pages = torch.gather(block_tables.long(), 1, blk)
    pages = torch.where(valid, pages, torch.zeros_like(pages))
    rows = torch.where(valid, positions % page_size,
                       torch.zeros_like(positions)).long()
    return pages, rows


def paged_write(pool, new: torch.Tensor, block_tables: torch.Tensor,
                positions: torch.Tensor, valid: torch.Tensor):
    """Scatter token rows into their pages, in place (a ``QuantKV`` pool
    takes them quantized). new: (B, C, *tail); positions: (B, C) absolute
    token indices; valid: (B, C) bool, False rows land in the scratch page
    (padding, idle lanes). Returns pool."""
    B, C = positions.shape
    quant = isinstance(pool, QuantKV)
    pages, rows = _write_coords(block_tables, positions, valid,
                                (pool.codes if quant else pool).shape[1])
    pg, rw = pages.reshape(-1), rows.reshape(-1)
    if quant:
        for dst, src in zip(pool, quantize_kv(new)):
            dst[pg, rw] = src.reshape((B * C,) + tuple(src.shape[2:]))
        return pool
    pool[pg, rw] = new.to(pool.dtype).reshape((B * C,) + tuple(new.shape[2:]))
    return pool


def copy_page(pool, src: int, dst: int, page_axis: int = 0):
    """Clone physical page ``src`` into ``dst`` (the device half of COW), in
    place, on one pool, a ``QuantKV`` (codes and scales), or a list/tuple of
    them. ``page_axis`` is the physical-page axis of every tensor (the
    serving caches carry a leading layer-stack dim, so theirs is 1)."""
    for t in leaves(pool):
        t.select(page_axis, dst).copy_(t.select(page_axis, src))
    return pool


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` KV rows."""
    return max(0, -(-tokens // page_size))


# ---------------------------------------------------------------------------
# Host-side page accounting: refcounts, free list, prefix registry.
# ---------------------------------------------------------------------------

def _digest(tokens: np.ndarray, salt: bytes = b"") -> bytes:
    return hashlib.sha1(salt + np.ascontiguousarray(
        np.asarray(tokens, np.int32)).tobytes()).digest()


class PagePool:
    """Refcounted physical-page allocator with a COW prefix registry.

    Pure host-side metadata: the device pools live in the engine's caches;
    this class only decides which physical page each logical block maps
    to. Page 0 is reserved scratch and never allocated. Every holder of a
    page (a request's block table, or the prefix registry) owns one
    reference; a page with ``refs > 1`` is shared and therefore immutable.
    Pages return to the free list when their last reference drops."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is scratch)")
        self.num_pages = num_pages
        self.page_size = page_size
        self.refs = np.zeros(num_pages, np.int32)
        self.refs[0] = 1                       # scratch, pinned forever
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        # prefix digest -> (page_id, fill). Insertion order is the LRU.
        self._prefix: "OrderedDict[bytes, Tuple[int, int]]" = OrderedDict()
        self.prefix_hits = 0
        self.prefix_shared_tokens = 0
        self.cow_copies = 0
        self.evictions = 0

    # -- allocation ----------------------------------------------------

    def free_pages(self) -> int:
        return len(self._free)

    def used_pages(self) -> int:
        return self.num_pages - 1 - len(self._free)

    def _evictable(self) -> List[bytes]:
        return [k for k, (pg, _) in self._prefix.items()
                if self.refs[pg] == 1]

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free) + len(self._evictable())

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` fresh pages (refcount 1 each), evicting cold prefix
        registry entries LRU-first if the free list runs dry."""
        while len(self._free) < n:
            for key in self._evictable():       # LRU = insertion order
                pg, _ = self._prefix.pop(key)
                self._decref(pg)
                self.evictions += 1
                break
            else:
                raise MemoryError(
                    f"page pool exhausted: want {n}, "
                    f"{len(self._free)} free, 0 evictable")
        out = [self._free.pop() for _ in range(n)]
        for pg in out:
            self.refs[pg] = 1
        return out

    def _decref(self, page: int) -> None:
        if self.refs[page] <= 0:
            raise RuntimeError(f"page {page} released with no reference")
        self.refs[page] -= 1
        if self.refs[page] == 0:
            self._free.append(page)

    def release(self, pages: Sequence[int]) -> None:
        """Drop one reference per page (request finished / COW replaced)."""
        for pg in pages:
            self._decref(int(pg))

    def share(self, page: int) -> int:
        self.refs[page] += 1
        return page

    def is_shared(self, page: int) -> bool:
        return bool(self.refs[page] > 1)

    # -- prefix registry ----------------------------------------------

    def match_prefix(self, tokens: np.ndarray,
                     salt: bytes = b"") -> Tuple[int, List[int]]:
        """Longest registered prefix of ``tokens``: (shared_len, pages).

        The caller receives one reference per returned page. Full pages
        chain from position 0; the final partial page matches only an
        entry covering exactly the same tokens. ``salt`` namespaces the
        lookup. The match is capped at ``len(tokens) - 1`` so at least one
        prompt token runs through the model (its logits seed decoding);
        when the cap lands inside a shared page, that page stays shared
        and the first divergent write COWs it."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        p, L = self.page_size, len(tokens)
        shared: List[int] = []
        matched = 0
        for i in range(L // p):
            ent = self._lookup(_digest(tokens[:(i + 1) * p], salt), p)
            if ent is None:
                break
            shared.append(ent)
            matched = (i + 1) * p
        else:
            r = L - (L // p) * p
            if r:
                ent = self._lookup(_digest(tokens, salt), r)
                if ent is not None:
                    shared.append(ent)
                    matched = L
        shared_len = min(matched, L - 1)
        while shared and (len(shared) - 1) * p >= shared_len:
            shared.pop()                         # page past the cap: useless
        shared_len = min(shared_len, len(shared) * p)
        for pg in shared:
            self.share(pg)
        if shared:
            self.prefix_hits += 1
            self.prefix_shared_tokens += shared_len
        return shared_len, shared

    def _lookup(self, key: bytes, fill: int) -> Optional[int]:
        ent = self._prefix.get(key)
        if ent is None or ent[1] != fill:
            return None
        self._prefix.move_to_end(key)            # LRU touch
        return ent[0]

    def register_prefix(self, tokens: np.ndarray, pages: Sequence[int],
                        salt: bytes = b"") -> None:
        """Register a prefilled prompt's pages for future sharing.
        ``pages[i]`` must hold tokens ``[i*p, min((i+1)*p, len))``, the
        request's block-table prefix right after prefill, before any decode
        write. The registry takes one reference per newly registered
        page."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        p, L = self.page_size, len(tokens)
        for i, pg in enumerate(pages):
            end = min((i + 1) * p, L)
            if end <= i * p:
                break
            key = _digest(tokens[:end], salt)
            if key in self._prefix:
                continue
            self._prefix[key] = (int(pg), end - i * p)
            self.share(int(pg))

    def registered_prefixes(self) -> int:
        return len(self._prefix)
