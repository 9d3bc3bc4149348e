"""flash_decode — single-query GQA decode attention over a KV cache.

  out[b, h, g] = softmax(q[b, h, g] . K[b, :kv_len[b], h] / sqrt(D))
                 @ V[b, :kv_len[b], h]

Ports of ``repro/kernels/flash_decode.py``: ``flash_decode_blocks`` over a
contiguous (B, S, KV, D) cache and ``flash_decode_paged`` over a
(P, page, KV, D) page pool addressed through (B, nblk) block tables. q and
the output are (B, KV, G, D), the reference's layout. ``kv_len`` is a
scalar shared by the batch (the reference's entry) or (B,) per-request
lengths, which the lane engine needs. Positions >= kv_len[b]
are masked, so a paged table's scratch entries (page 0) and unwritten page
tails contribute nothing. A request of kv_len 0 gets zeros here, where the
reference would average the whole masked cache.

``flash_decode_blocks(..., lse=True)`` is the log-sum-exp instance that
sequence-sharded serving needs (each rank attends its shard of the cache,
then ``launch.mesh.softmax_merge`` merges the ranks): it returns the
output in f32 whatever q's dtype, and beside it lse = m + log(l), the
softmax's max plus the log of its sum, f32 (B, KV, G); a request of
kv_len 0 (a shard that holds none of its positions) gets zeros and lse
-inf. On the card it takes D in ``LSE_DIMS`` (64, 80, 128 and 256, the
head dims that serve sequence-sharded). Its launches are counted in
``flash_decode_blocks.lse_launches`` besides ``launches``.

On CUDA tensors the wrappers launch ``csrc/flash_decode.cu`` (its note says
what bounds it, bytes, and how the design answers): split-K, for a
contiguous cache and a page pool alike, in one launch, a CTA per (split,
KV head and group of 16 query heads, request). ``decode_plan`` picks the
splits a request from the shapes (B, KV, G, the cache's S or a table's
nblk * page) and the card's SM count (read once): ``PER_SM`` CTAs an SM
over the batch, two for caches of at most 1,536 positions and one for
longer ones, no more than fit an SM (``ctas_per_sm``), at least
``MIN_SPLITS`` and never more than S has 64-row tiles; f32 q on a short
cache aims at ``F32_PER_SM`` (``plan_per_sm``). On the device each
split takes an even share, in whole tiles, of its request's kv_len
(``split_rows``), so neither wrapper reads kv_len or the block tables on
the host, and splits past a short request's tiles exit at once. A CTA
loops over its tiles with the next tiles' K and V rows in flight while one
is scored (a pool's CTA looks up each position's page in the block table,
so any page size works), and writes f32 partials to scratch that the
wrapper allocates; the last CTA of each row of the grid merges them with
all of its threads, in two levels (chunks of ``CHUNK`` splits first) where
one would take many rounds of loads.
``flash_decode_paged`` also reads int8 page pools, the reference's
``QuantKV`` pages (``serving/kvcache.py``): pass each pool as a (codes,
scales) pair, codes (P, page, KV, D) int8 and scales (P, page, KV, 1)
bf16. Each entry is attended as ``dequantize_rows`` gives it, bf16 of the
f32 product code * scale, with q in the compute dtype (bf16 on the tensor
cores, f32 on FMA), and the kernel dequantizes the rows it reads into
shared memory (the int8 instance, counted apart in
``flash_decode_paged.int8_launches`` besides ``launches``).
On CPU tensors they compute the plain versions, which follow the TPU
kernel's arithmetic (f32 scores with 1/sqrt(D) rounded in f32, p kept in
f32, f32 accumulation, output divided by max(l, 1e-30) and cast to q's
dtype) in one dense softmax instead of an online one. The tests and
``chip_smoke.py`` hold the kernels against them. ``flash_decode_cost`` and
``flash_decode_paged_cost`` give the work each function needs
(``kernels.counting``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.counting import counted, plain_device

_DTYPES = (torch.float32, torch.bfloat16)
_DIMS = (16, 32, 64, 80, 128, 256)  # contiguous caches (80: zamba2's
                                    # shared attention block; 256:
                                    # paligemma-3b)
_PAGED_DIMS = (16, 32, 64, 128)     # page pools: no path pages D = 80 or
                                    # 256 (the paged engine refuses the
                                    # hybrid and vision families)
LSE_DIMS = (64, 80, 128, 256)      # the log-sum-exp instance: the head
                                    # dims that serve sequence-sharded
                                    # (granite-moe; zamba2's shared block;
                                    # dense GQA; paligemma-3b)
SPLIT = 64                  # positions per tile (kSplit)
GROUP = 16                  # query heads a CTA (kGroup)
PER_SM = (2, 1)             # CTAs a plan aims at on each SM, for caches of
LONG = 24                   # at most LONG tiles (1,536 positions) and for
                            # longer ones
F32_PER_SM = 8              # ... and with f32 q, for caches of at most LONG
MIN_SPLITS = 4              # the splits a plan gives a request at least
                            # (where S has the tiles), for batches of mixed
                            # lengths
CHUNK = 8                   # splits the merge's first level takes (kChunk)
_TICKETS = {}               # (device, stream) -> the merge's int32 tickets
_SMS = {}                   # device index -> its SM count


def softmax_scale(d: int) -> float:
    """1 / sqrt(D) rounded in f32, as the reference computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def decode_lengths(kv_len, batch: int, device) -> torch.Tensor:
    """A scalar length (int or 0-d tensor) or (B,) lengths -> (B,) int32 on
    ``device``."""
    if isinstance(kv_len, int):         # a fill, not a host-to-device copy
        return torch.full((batch,), kv_len, dtype=torch.int32, device=device)
    kl = torch.as_tensor(kv_len, device=device)
    if kl.ndim == 0:
        return kl.to(torch.int32).expand(batch).contiguous()
    if kl.shape != (batch,):
        raise ValueError(f"kv_len {tuple(kl.shape)} for batch {batch}")
    return kl.to(torch.int32).contiguous()


def _attend_plain(q, k, v, kv_len, lse: bool = False):
    """q (B, KV, G, D); k, v (B, S, KV, D); kv_len (B,). The masked softmax
    of the kernel in f32, dense: the output in q's dtype, or with ``lse``
    (the output in f32, lse (B, KV, G) f32: -inf where kv_len is 0)."""
    S = k.shape[1]
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float())
    s = s * softmax_scale(q.shape[-1])
    mask = (torch.arange(S, device=q.device)[None, :]
            < kv_len.to(q.device).long()[:, None])[:, None, None, :]
    s = s.masked_fill(~mask, -1e30)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float()) / l.clamp(min=1e-30)
    if lse:     # an empty row: -1e30 + log(0) = -inf
        return out, (m + torch.log(l))[..., 0]
    return out.to(q.dtype)


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kv_len: torch.Tensor, lse: bool = False):
    """The plain version of ``flash_decode_blocks`` (with ``lse``, of its
    log-sum-exp instance: (out f32, lse f32))."""
    return _attend_plain(q, k, v, kv_len, lse)


def dequantize_rows(codes: torch.Tensor, scales: torch.Tensor
                    ) -> torch.Tensor:
    """int8 codes times their bf16 scales (broadcast over the last dim),
    the product in f32 rounded to bf16: the reference's ``dequantize_kv``."""
    return (codes.float() * scales.float()).to(torch.bfloat16)


def paged_gather(pool, block_tables: torch.Tensor) -> torch.Tensor:
    """The contiguous view of each request's pages: pool (P, page, *tail),
    or an int8 (codes, scales) pool, block_tables (B, nblk) int ->
    (B, nblk * page, *tail), in table order, in the pool's dtype (an int8
    pool dequantized to bf16, as the reference's ``paged_gather``)."""
    if isinstance(pool, tuple):
        codes, scales = pool
        return dequantize_rows(paged_gather(codes, block_tables),
                               paged_gather(scales, block_tables))
    B, nblk = block_tables.shape
    x = pool[block_tables.reshape(-1).long()]
    return x.reshape((B, nblk * pool.shape[1]) + tuple(pool.shape[2:]))


def flash_decode_paged_plain(q: torch.Tensor, k_pool, v_pool,
                             block_tables: torch.Tensor,
                             kv_len: torch.Tensor) -> torch.Tensor:
    """The plain version of ``flash_decode_paged``: gather each request's
    pages (dequantized, for int8 pools), then the contiguous plain
    version."""
    return _attend_plain(q, paged_gather(k_pool, block_tables),
                         paged_gather(v_pool, block_tables), kv_len)


def _decode_cost(q, kv_len, row_bytes: int, extra_bytes: int) -> dict:
    """q read and the output written, each request's ``kv_len`` rows of K
    and V read (``row_bytes`` a row and KV head); q . k and p . v once a
    row, at q's rate."""
    B, KV, G, D = q.shape
    # a dry run's "meta" q carries an int length: count it on the host
    dev = "cpu" if q.device.type == "meta" else q.device
    rows = int(decode_lengths(kv_len, B, dev).sum())
    ops = float(4 * rows * KV * G * D)
    bf16 = q.dtype == torch.bfloat16
    return {"flops": 0.0 if bf16 else ops, "bf16_flops": ops if bf16 else 0.0,
            "bytes_accessed": float(2 * q.numel() * q.element_size()
                                    + 2 * rows * KV * row_bytes
                                    + extra_bytes + B * 4)}


def flash_decode_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_len, lse: bool = False) -> dict:
    """The work of one ``flash_decode_blocks`` call on this call's
    lengths; the log-sum-exp instance writes its output in f32 and lse
    (B, KV, G) f32 besides."""
    extra = 0
    if lse:
        B, KV, G, D = q.shape
        extra = B * KV * G * (D * (4 - q.element_size()) + 4)
    return _decode_cost(q, kv_len, q.shape[-1] * q.element_size(), extra)


def flash_decode_paged_cost(q: torch.Tensor, k_pool, v_pool,
                            block_tables: torch.Tensor, kv_len) -> dict:
    """The work of one ``flash_decode_paged`` call on this call's lengths:
    an int8 pool's rows are D codes and a bf16 scale; the block tables
    read once."""
    D = q.shape[-1]
    row = D + 2 if isinstance(k_pool, tuple) else D * q.element_size()
    return _decode_cost(q, kv_len, row, block_tables.numel() * 4)


def _check_q8(q, k, v) -> None:
    """The int8 route: q (B, KV, G, D) f32 or bf16; k and v (codes,
    scales) pairs of (P, page, KV, D) int8 and (P, page, KV, 1) bf16."""
    if q.ndim != 4:
        raise ValueError(f"q must be (B, KV, G, D), got {tuple(q.shape)}")
    B, KV, G, D = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be one of {_DTYPES}, got {q.dtype}")
    for name, pool in (("k_pool", k), ("v_pool", v)):
        if not isinstance(pool, tuple) or len(pool) != 2:
            raise TypeError(f"{name} must be a (codes, scales) pair")
        codes, scales = pool
        if codes.dtype != torch.int8 or scales.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be int8 codes and bf16 scales, got "
                            f"{codes.dtype} / {scales.dtype}")
        if (codes.ndim != 4 or codes.shape[2:] != (KV, D)
                or codes.shape != k[0].shape
                or scales.shape != codes.shape[:3] + (1,)):
            raise ValueError(f"{name} must be (P, page, {KV}, {D}) codes and "
                             f"(P, page, {KV}, 1) scales, got "
                             f"{tuple(codes.shape)} / {tuple(scales.shape)}")


def _check(q, k, v, what: str) -> None:
    if q.ndim != 4:
        raise ValueError(f"q must be (B, KV, G, D), got {tuple(q.shape)}")
    B, KV, G, D = q.shape
    if k.ndim != 4 or v.shape != k.shape or k.shape[2:] != (KV, D):
        raise ValueError(f"{what} must be (*, *, {KV}, {D}) alike, got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of {_DTYPES}, got "
                        f"{q.dtype} / {k.dtype} / {v.dtype}")


def _check_cuda(name, tensors, dims=_DIMS) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{name} runs on cuda or cpu, not {dev}")
    for t in tensors:
        if t.device != dev:
            raise RuntimeError(f"{name} operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} operands must be contiguous")
    B, KV, G, D = tensors[0].shape
    if D not in dims:
        raise ValueError(f"{name} takes D in {dims}, got D={D}")
    if B > 65535 or KV * -(-G // GROUP) > 65535:
        raise ValueError(f"{name} grid too large for B={B}, KV={KV}, G={G}")


_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
_ARGTYPES = {   # the C signatures of csrc/flash_decode.cu, stream last
    "flash_decode_launch": [_P] * 3 + [_I] + [_P] * 4 + [_I] * 6 + [_F, _P],
    "flash_decode_lse_launch": [_P] * 3 + [_I] + [_P] * 5 + [_I] * 6
                               + [_F, _P],
    "flash_decode_paged_launch": [_P] * 3 + [_I] + [_P] * 5 + [_I] * 7
                                 + [_F, _P],
    "flash_decode_paged_q8_launch": [_P] * 5 + [ctypes.c_longlong, _I]
                                    + [_P] * 5 + [_I] * 7 + [_F, _P],
}


def _fn(name: str):
    fn = getattr(build.load("flash_decode"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _tickets(device, stream: int, n: int) -> torch.Tensor:
    """The merge's tickets for launches on ``stream``: int32 zeros that
    each launch leaves zero, kept per (device, stream) so that two streams
    never share one."""
    key = (device, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return t


def _check_launch(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _check_aligned(name: str, tensors) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} copies q/k/v in 16-byte chunks: they must "
                         f"be 16-byte aligned")


def decode_plan(B: int, KV: int, G: int, S: int, sms: int,
                per_sm: int) -> int:
    """The splits a request of a (B, KV, G) decode over caches that can
    hold S positions, so that the grid (nsplit, KV * ceil(G / 16), B) puts
    ``per_sm`` CTAs on each of ``sms`` SMs (``plan_per_sm``), at least
    MIN_SPLITS and at most one a 64-row tile of S. It never looks at
    kv_len, so one grid serves every length."""
    tiles = max(1, -(-S // SPLIT))
    units = B * KV * -(-G // GROUP)
    return max(1, min(tiles, max(MIN_SPLITS, per_sm * sms // max(1, units))))


def plan_per_sm(S: int, D: int, bf16: bool, q8: bool = False) -> int:
    """The CTAs an SM a plan aims at, for the kernel instance that q of
    ``bf16`` (else f32) and head dim D takes over caches that can hold S
    positions (``q8``: int8 pools). PER_SM's: two for caches of at most
    LONG tiles, whose batches mix lengths (the lanes' 1,056 and 1,312
    rows) and whose splits are short, one for longer ones, where a split's
    share of the merge costs more than a second CTA an SM gains; never
    more than fit an SM (``ctas_per_sm``: one at D = 256). f32 q on a
    short cache: F32_PER_SM, more and shorter splits than fit at once,
    since the FMA work, not the merge, bounds an f32 tile."""
    if -(-S // SPLIT) > LONG:
        return min(PER_SM[1], ctas_per_sm(D, bf16, q8))
    if not bf16:
        return F32_PER_SM
    return min(PER_SM[0], ctas_per_sm(D, bf16, q8))


def ctas_per_sm(D: int, bf16: bool, q8: bool = False) -> int:
    """How many of the kernel's CTAs fit an SM's 228 KB of shared memory
    (1 KB of it reserved a CTA): its ring of stages of 64 K and V rows
    (``csrc/flash_decode.cu``'s ``stages``), q, p and the softmax's sums,
    as ``run_split`` sizes them. One at D = 256."""
    q8_stage = 2 * SPLIT * D + 2 * SPLIT * 4 + 2 * SPLIT  # codes, scales
    if bf16:
        stages = 4 if q8 or D <= 80 else 3
        tile = 2 * 2 * SPLIT * (D + 8)
        smem = (stages * q8_stage + tile if q8 else stages * tile) + 2 * (
            GROUP * (D + 8) + 2 * GROUP * (SPLIT + 8)) + 4 * 2 * 4 * GROUP
    else:
        stages = 2 if q8 else (3 if D <= 64 else 2 if D <= 80 else 1)
        tile = 4 * 2 * SPLIT * (D + 4)
        smem = (stages * q8_stage + tile if q8 else stages * tile) + 4 * (
            GROUP * D + GROUP * (SPLIT + 4) + 3 * GROUP)
    return max(1, (228 << 10) // (smem + 1024))


def split_rows(kv_len: int, nsplit: int) -> list:
    """The positions [t0, t1) that each working split of a request of
    ``kv_len`` positions attends, as the kernel deals them: its
    nt = ceil(kv_len / 64) tiles evenly over nwork = min(nt, nsplit)
    splits in whole tiles; splits past nwork take none (and exit)."""
    nt = -(-kv_len // SPLIT)
    nwork = min(nt, nsplit)
    return [(s * nt // nwork * SPLIT, min((s + 1) * nt // nwork * SPLIT,
                                          kv_len)) for s in range(nwork)]


def part_stride(G: int, D: int) -> int:
    """f32 floats of one split's partials in the scratch, for a CTA's
    min(G, 16) query heads: acc (G, D), then m and l (G,) each, padded to
    a multiple of 4 (16-byte blocks)."""
    return -(-min(G, GROUP) * (D + 2) // 4) * 4


def ticket_stride(nsplit: int) -> int:
    """The merge's int32 tickets for each CTA row of the grid: one for
    each chunk of 8 splits, whose last CTA merges the chunk, and one for
    the row, whose last chunk merger writes the output."""
    return -(-nsplit // CHUNK) + 1


def sm_count(device) -> int:
    """The SM count of ``device``, read once."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def decode_splits(q: torch.Tensor, S: int, sms: int,
                  q8: bool = False) -> int:
    """The splits a request that a wrapper's launch for q (B, KV, G, D)
    over caches that can hold S positions (``q8``: int8 pools) on ``sms``
    SMs takes: ``decode_plan`` with the kernel's CTAs an SM."""
    B, KV, G, D = q.shape
    return decode_plan(B, KV, G, S, sms,
                       plan_per_sm(S, D, q.dtype == torch.bfloat16, q8))


def _partials(q: torch.Tensor, S: int, sms: int, q8: bool = False):
    """(nsplit, f32 scratch for the splits' partials or None) for caches
    that can hold S positions (``q8``: int8 pools), on ``sms`` SMs: a
    block of ``part_stride(G, D)`` floats for each split of each CTA row
    of the grid."""
    B, KV, G, D = q.shape
    nsplit = decode_splits(q, S, sms, q8)
    ny = KV * -(-G // GROUP)
    part = (torch.empty(B * ny * nsplit * part_stride(G, D),
                        dtype=torch.float32, device=q.device)
            if nsplit > 1 else None)
    return nsplit, part


@counted(flash_decode_cost, "flash_decode", dots=True)
def flash_decode_blocks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len, lse: bool = False):
    """q: (B, KV, G, D); k/v: (B, S, KV, D); kv_len a scalar or (B,), 0
    allowed. Returns (B, KV, G, D) in q's dtype; with ``lse`` the
    log-sum-exp instance's (out f32, lse (B, KV, G) f32). S is not
    padded: the kernel stops at each length. CPU tensors take
    ``flash_decode_plain``; CUDA tensors launch the kernel or raise
    ("meta" tensors under ``counting.on_meta()``, the dry run's, the plain
    version too)."""
    _check(q, k, v, "k/v")
    kv_len = decode_lengths(kv_len, q.shape[0], q.device)
    if k.shape[0] != q.shape[0]:
        raise ValueError(f"k batch {k.shape[0]} != q batch {q.shape[0]}")
    if plain_device(q.device):
        return flash_decode_plain(q, k, v, kv_len, lse)
    _check_cuda("flash_decode", (q, k, v, kv_len), LSE_DIMS if lse else _DIMS)
    _check_aligned("flash_decode", (q, k, v))
    B, KV, G, D = q.shape
    S = k.shape[1]
    out = torch.empty(q.shape, dtype=torch.float32 if lse else q.dtype,
                      device=q.device)
    lse_out = (torch.empty((B, KV, G), dtype=torch.float32, device=q.device)
               if lse else None)
    if out.numel() == 0:
        return (out, lse_out) if lse else out
    nsplit, part = _partials(q, S, sm_count(q.device))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            int(q.dtype == torch.bfloat16), kv_len.data_ptr(), out.data_ptr())
    tail = (part.data_ptr() if part is not None else None,
            _tickets(q.device, stream, B * KV * -(-G // GROUP)
                     * ticket_stride(nsplit)).data_ptr(), B, KV, G, D, S,
            nsplit, softmax_scale(D), stream)
    if lse:
        _check_launch("flash_decode", _fn("flash_decode_lse_launch")(
            *head, lse_out.data_ptr(), *tail))
        flash_decode_blocks.lse_launches += 1
        flash_decode_blocks.launches += 1
        return out, lse_out
    _check_launch("flash_decode", _fn("flash_decode_launch")(*head, *tail))
    flash_decode_blocks.launches += 1
    return out


flash_decode_blocks.launches = 0    # kernel launches (CUDA tensors only)
flash_decode_blocks.lse_launches = 0  # of them, the log-sum-exp instance


@counted(flash_decode_paged_cost, "flash_decode_paged", dots=True)
def flash_decode_paged(q: torch.Tensor, k_pool, v_pool,
                       block_tables: torch.Tensor, kv_len) -> torch.Tensor:
    """q: (B, KV, G, D); k_pool/v_pool: (P, page, KV, D) physical pages in
    q's dtype, or int8 pools as (codes, scales) pairs; block_tables:
    (B, nblk) int32 (entry 0 = scratch page); kv_len a scalar or (B,).
    Returns (B, KV, G, D) in q's dtype. CPU tensors take
    ``flash_decode_paged_plain``; CUDA tensors launch the kernel or
    raise."""
    q8 = isinstance(k_pool, tuple)
    if q8:
        _check_q8(q, k_pool, v_pool)
    else:
        _check(q, k_pool, v_pool, "k_pool/v_pool")
    kv_len = decode_lengths(kv_len, q.shape[0], q.device)
    if (block_tables.ndim != 2 or block_tables.shape[0] != q.shape[0]
            or block_tables.dtype != torch.int32):
        raise ValueError(f"block_tables must be (B, nblk) int32, got "
                         f"{tuple(block_tables.shape)} {block_tables.dtype}")
    if q.device.type == "cpu":
        return flash_decode_paged_plain(q, k_pool, v_pool, block_tables,
                                        kv_len)
    pools = (*k_pool, *v_pool) if q8 else (k_pool, v_pool)
    _check_cuda("flash_decode_paged", (q, *pools, block_tables, kv_len),
                _PAGED_DIMS)
    _check_aligned("flash_decode_paged",
                   (q, k_pool[0], v_pool[0]) if q8 else (q, k_pool, v_pool))
    if q8 and (k_pool[1].data_ptr() % 4 or v_pool[1].data_ptr() % 4):
        raise ValueError("flash_decode_paged copies int8 pools' scales in "
                         "4-byte words: they must be 4-byte aligned")
    B, KV, G, D = q.shape
    page = pools[0].shape[1]
    nblk = block_tables.shape[1]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    nsplit, part = _partials(q, page * nblk, sm_count(q.device), q8)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (int(q.dtype == torch.bfloat16), kv_len.data_ptr(),
              block_tables.data_ptr(), out.data_ptr(),
              part.data_ptr() if part is not None else None,
              _tickets(q.device, stream, B * KV * -(-G // GROUP)
                       * ticket_stride(nsplit)).data_ptr(), B, KV, G, D,
              page, nblk, nsplit, softmax_scale(D), stream)
    if q8:
        _check_launch("flash_decode_paged", _fn(
            "flash_decode_paged_q8_launch")(
                q.data_ptr(), k_pool[0].data_ptr(), k_pool[1].data_ptr(),
                v_pool[0].data_ptr(), v_pool[1].data_ptr(),
                k_pool[1].numel(), *common))
        flash_decode_paged.int8_launches += 1
    else:
        _check_launch("flash_decode_paged", _fn("flash_decode_paged_launch")(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *common))
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0     # kernel launches (CUDA tensors only)
flash_decode_paged.int8_launches = 0  # of them, the int8-pool instance
