"""flash_decode's plan: the splits a request gets and the rows each takes.

``decode_plan`` sizes the kernel's grid (nsplit, KV * ceil(G / 16), B)
from the shapes B, KV, G, the cache's width S and the SM count;
``split_rows`` is the kernel's own dealing of a request's kv_len over its
splits, in whole 64-row tiles. These tests hold the plan's contracts on
plain loops: every position below kv_len falls in exactly one split, the
scratch ``_partials`` sizes holds every working split, the grid never
depends on kv_len; and a long cache split as the plan splits it, each
split attended alone by the plain version's log-sum-exp instance and
merged by the weighting ``launch.mesh.softmax_merge`` applies across
ranks (at once, or in chunks of 8 splits first, as the kernel merges),
gives the JAX package's ``flash_decode_ref`` within 1e-5.
"""
import inspect
import itertools

import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels.flash_decode import (CHUNK, F32_PER_SM, GROUP,
                                              LONG, MIN_SPLITS, PER_SM, SPLIT,
                                              _partials, ctas_per_sm,
                                              decode_plan,
                                              flash_decode_plain, part_stride,
                                              plan_per_sm, split_rows,
                                              ticket_stride)

WIDTHS = [1, 2, 63, 64, 65, 127, 128, 129, 700, 1056, 1312, 4096, 5120,
          8191, 8192, 32768, 65535, 65536]
SMS = [132, 114]        # an H100 SXM's SMs, and a PCIe card's
GS = [1, 9, 48]         # query heads a KV head: one group of 16, three
PER_SMS = [1, 2, 8]     # CTAs an SM a plan aims at


def _lengths(S):
    return sorted({n for n in (0, 1, 63, 64, 65, S - 1, S) if 0 <= n <= S})


@pytest.mark.parametrize("S", WIDTHS)
@pytest.mark.parametrize("sms", SMS)
def test_plan_covers_every_position_once(S, sms):
    """For B and KV from 1 to 8 (and G in GS, per_sm in PER_SMS): nsplit in
    [1, ceil(S / 64)]; for each kv_len the working splits tile
    [0, kv_len) without gap or overlap, each starts on a tile and holds
    whole tiles (the last ends at kv_len), no more than nsplit of them,
    and their tile counts differ by one at most."""
    tiles = max(1, -(-S // SPLIT))
    for B, KV, G, per_sm in itertools.product(range(1, 9), range(1, 9), GS,
                                              PER_SMS):
        nsplit = decode_plan(B, KV, G, S, sms, per_sm)
        assert 1 <= nsplit <= tiles
        for n in _lengths(S):
            rows = split_rows(n, nsplit)
            assert len(rows) == min(-(-n // SPLIT), nsplit)
            at = 0
            for t0, t1 in rows:
                assert t0 == at and t0 % SPLIT == 0 and t1 > t0
                at = t1
            assert at == n
            got = np.zeros(n, np.int64)
            for t0, t1 in rows:
                got[t0:t1] += 1
            assert (got == 1).all()
            sizes = [-(-(t1 - t0) // SPLIT) for t0, t1 in rows]
            assert not sizes or max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("sms", SMS)
def test_grid_never_depends_on_kv_len(sms):
    """The plan takes no length: its inputs are the shapes B, KV, G, S,
    the SM count and the CTAs an SM it aims at, and the grid
    (nsplit, KV * ceil(G / 16), B) it gives fills per_sm CTAs an SM where
    S has the tiles for it (never more), and gives a request MIN_SPLITS
    splits at least, where S has the tiles."""
    for fn in (decode_plan, plan_per_sm):
        assert not {"kv_len", "lengths", "block_tables"} & set(
            inspect.signature(fn).parameters)
    for B, KV, G, per_sm in itertools.product(range(1, 9), range(1, 9), GS,
                                              PER_SMS):
        for S in WIDTHS:
            nsplit = decode_plan(B, KV, G, S, sms, per_sm)
            rows = KV * -(-G // GROUP) * B  # the grid's y * z
            ctas = nsplit * rows
            tiles = max(1, -(-S // SPLIT))
            assert nsplit >= min(MIN_SPLITS, tiles)
            if MIN_SPLITS < nsplit < tiles:
                assert ctas <= per_sm * sms < ctas + rows
            elif nsplit < tiles:
                assert nsplit == MIN_SPLITS
            else:
                assert nsplit == tiles
            for n in _lengths(S):
                assert len(split_rows(n, nsplit)) <= nsplit


@pytest.mark.parametrize("B,KV,G,D,S", [
    (8, 4, 9, 128, 1056), (1, 2, 1, 80, 32768), (8, 1, 8, 256, 8192),
    (2, 1, 48, 128, 4096), (1, 4, 9, 128, 32768), (8, 4, 9, 128, 5120),
    (1, 2, 4, 16, 64), (3, 2, 5, 64, 65)])
def test_partials_size_the_plan(B, KV, G, D, S):
    """``_partials`` returns the plan's nsplit and scratch of a block of
    part_stride(G, D) floats (16-byte blocks that hold a CTA's
    min(G, 16) heads' acc, m and l) for each split of each of the grid's
    B * KV * ceil(G / 16) CTA rows, none where one split covers every
    length; every working split's block of the last row lies inside."""
    q = torch.empty((B, KV, G, D))
    gc = min(G, GROUP)
    for sms in SMS:
        nsplit, part = _partials(q, S, sms)
        assert nsplit == decode_plan(B, KV, G, S, sms,
                                     plan_per_sm(S, D, bf16=False))
        stride = part_stride(G, D)
        assert stride % 4 == 0 and gc * (D + 2) <= stride < gc * (D + 2) + 4
        if nsplit == 1:
            assert part is None
            continue
        rows = B * KV * -(-G // GROUP)
        assert part.dtype == torch.float32
        assert part.numel() == rows * nsplit * stride
        for n in _lengths(S):
            nwork = len(split_rows(n, nsplit))
            last = (rows - 1) * nsplit + max(nwork - 1, 0)
            assert (last + 1) * stride <= part.numel()


@pytest.mark.parametrize("D", [16, 32, 64, 80, 128, 256])
def test_ctas_per_sm_fit_the_shared_memory(D):
    """``ctas_per_sm`` counts at least one CTA an SM (one at D = 256, two
    at D = 80 and 128), and ``plan_per_sm`` never aims at more of them
    an SM, but for f32 q on short caches (F32_PER_SM): one CTA an SM past
    LONG tiles, two up to it."""
    for bf16, q8 in ((True, False), (False, False), (True, True),
                     (False, True)):
        n = ctas_per_sm(D, bf16, q8)
        assert n >= 1
        assert plan_per_sm(LONG * SPLIT + 1, D, bf16, q8) == min(PER_SM[1],
                                                                 n)
        short = plan_per_sm(LONG * SPLIT, D, bf16, q8)
        assert short == (min(PER_SM[0], n) if bf16 else F32_PER_SM)
        for B, KV, G, S in ((1, 2, 1, 32768), (8, 1, 8, 8192),
                            (8, 4, 9, 1056)):
            units = B * KV * -(-G // GROUP)
            per_sm = plan_per_sm(S, D, bf16, q8)
            nsplit = decode_plan(B, KV, G, S, 132, per_sm)
            if bf16 and nsplit > MIN_SPLITS:
                assert units * nsplit <= n * 132
    assert ctas_per_sm(256, True) == 1 and ctas_per_sm(128, True) == 2
    assert ctas_per_sm(128, False) == 2 and ctas_per_sm(80, True) == 2


@pytest.mark.parametrize("nsplit", [1, 2, 7, 8, 9, 16, 17, 66, 132, 512])
def test_merge_tickets_cover_every_chunk(nsplit):
    """The merge's tickets a CTA row: one for each chunk of CHUNK splits
    that any kv_len's working splits can fill, and one for the row."""
    assert ticket_stride(nsplit) == -(-nsplit // CHUNK) + 1
    for nwork in range(1, nsplit + 1):
        chunks = -(-nwork // CHUNK)
        assert chunks <= ticket_stride(nsplit) - 1
        sizes = [min(CHUNK, nwork - c * CHUNK) for c in range(chunks)]
        assert sum(sizes) == nwork and min(sizes) >= 1


def _merge(parts):
    """``launch.mesh.softmax_merge``'s weighting over (out, lse) pairs:
    w = exp(lse - max lse), then sum w * out / sum w."""
    top = torch.stack([l for _, l in parts]).amax(0)
    top = torch.where(torch.isinf(top), torch.zeros_like(top), top)
    ws = [torch.exp(l - top)[..., None] for _, l in parts]
    return sum(w * o for w, (o, _) in zip(ws, parts)) / sum(ws).clamp(
        min=1e-30)


def _merge_lse(parts):
    """A chunk's merge as one (out, lse) pair: the merged output and
    max lse + log(sum of the weights)."""
    top = torch.stack([l for _, l in parts]).amax(0)
    ws = sum(torch.exp(l - top) for _, l in parts)
    return _merge(parts), top + torch.log(ws)


@pytest.mark.parametrize("B,KV,G,D,S", [(1, 2, 1, 16, 4096),
                                        (2, 1, 8, 32, 2048)])
@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("chunked", [False, True])
def test_plan_split_merge_matches_reference(B, KV, G, D, S, sms, full,
                                            chunked):
    """A long cache split as the plan splits it (sms 132: a tile a split;
    8: several), each split's (out, lse) from the plain version's
    log-sum-exp instance on its rows alone, empty splits as kv_len 0,
    merged by log-sum-exp weights (``chunked``: the working splits in
    chunks of CHUNK first, each chunk's merge an (out, lse) pair, then
    the chunks, as the kernel merges): the JAX reference within 1e-5, for
    a full kv_len and for 130, which leaves the last splits empty."""
    rng = np.random.RandomState(S + sms)
    q, k, v = (rng.randn(*s).astype(np.float32) for s in (
        (B, KV, G, D), (B, S, KV, D), (B, S, KV, D)))
    n = S if full else 130
    nsplit = decode_plan(B, KV, G, S, sms, plan_per_sm(S, D, bf16=False))
    rows = split_rows(n, nsplit)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    parts = [flash_decode_plain(tq, tk[:, t0:t1], tv[:, t0:t1],
                                torch.full((B,), t1 - t0, dtype=torch.int32),
                                lse=True) for t0, t1 in rows]
    empty = nsplit - len(rows)
    assert empty > 0 if not full else empty == 0
    if chunked:
        parts = [_merge_lse(parts[c:c + CHUNK])
                 for c in range(0, len(parts), CHUNK)]
    parts += [flash_decode_plain(tq, tk[:, :1], tv[:, :1],
                                 torch.zeros(B, dtype=torch.int32), lse=True)
              for _ in range(empty)]
    got = _merge(parts)
    assert got.shape == (B, KV, G, D) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jref.flash_decode_ref(q, k, v, n), np.float32), atol=1e-5, rtol=1e-5)
