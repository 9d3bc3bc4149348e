"""The port's attention kernels' plain versions against the JAX package.

``flash_decode_blocks``, ``flash_decode_paged`` and ``flash_prefill_blocks``
compute their plain versions on CPU tensors; these are held against the
JAX Pallas kernels in interpret mode (``repro.kernels.ops.flash_decode``,
``flash_decode.flash_decode_paged``, ``ops.flash_prefill``) and against the
reference oracles, on the same numpy inputs: f32 within 1e-5, bf16 within
5e-2 (the JAX package's own tolerances, ``tests/test_kernels.py``). The
attention layers that call them are held against the JAX model in
``test_torch_attention.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_decode import flash_decode_paged as j_paged
from repro_torch.kernels import ref
from repro_torch.kernels.flash_decode import (flash_decode_blocks,
                                              flash_decode_paged)
from repro_torch.kernels.flash_prefill import flash_prefill_blocks

TOL = {"f32": 1e-5, "bf16": 5e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _pair(a: np.ndarray, dt: str):
    """The same numbers as a JAX array and a torch tensor of dtype ``dt``
    (bf16 rounds once, in JAX, and the bits cross over)."""
    j = jnp.asarray(a, JDT[dt])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dt])


def _close(port, want, dt):
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dt], rtol=TOL[dt])


DECODE_SHAPES = [(1, 1, 1, 64, 512, 256), (2, 2, 4, 64, 1024, 512),
                 (2, 1, 8, 128, 768, 256), (2, 2, 9, 32, 300, 100),
                 # granite-34b's grouping: one KV head for 48 query heads
                 (2, 1, 48, 128, 256, 128),
                 # zamba2's shared block: heads of 80, G = 1
                 (2, 4, 1, 80, 300, 100),
                 # paligemma-3b: 8 heads of 256 over one KV head
                 (2, 1, 8, 256, 300, 100)]


@pytest.mark.parametrize("B,KV,G,D,S,sb", DECODE_SHAPES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_decode_matches_jax(B, KV, G, D, S, sb, dt):
    rng = np.random.RandomState(4)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng.randn(*s), dt) for s in (
        (B, KV, G, D), (B, S, KV, D), (B, S, KV, D)))
    kv_len = S - 100
    port = flash_decode_blocks(tq, tk, tv, kv_len)
    assert port.dtype == TDT[dt] and port.shape == (B, KV, G, D)
    _close(port, jops.flash_decode(jq, jk, jv, kv_len, sb=sb,
                                   interpret=True), dt)
    _close(port, jref.flash_decode_ref(jq, jk, jv, kv_len), dt)
    _close(ref.flash_decode_ref(tq, tk, tv, kv_len),
           jref.flash_decode_ref(jq, jk, jv, kv_len), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_decode_per_request_lengths(dt):
    """(B,) kv_len, which the lane engine needs, equals the scalar entry
    (the reference's) row by row, in both packages."""
    rng = np.random.RandomState(7)
    B, KV, G, D, S = 4, 2, 9, 32, 96
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng.randn(*s), dt) for s in (
        (B, KV, G, D), (B, S, KV, D), (B, S, KV, D)))
    lens = [1, 17, 64, 96]
    port = flash_decode_blocks(tq, tk, tv, torch.tensor(lens, dtype=torch.int32))
    for b, n in enumerate(lens):
        alone = flash_decode_blocks(tq[b:b + 1], tk[b:b + 1], tv[b:b + 1], n)
        np.testing.assert_array_equal(port[b:b + 1].float().numpy(),
                                      alone.float().numpy())
        _close(port[b:b + 1], jops.flash_decode(
            jq[b:b + 1], jk[b:b + 1], jv[b:b + 1], n, sb=32,
            interpret=True), dt)


LSE_SHAPES = [(2, 2, 9, 64, 300), (1, 1, 48, 128, 256),
              (2, 4, 1, 80, 130)]


def _scores_f32(q, k):
    """The reference's f32 scores (``flash_decode_ref``'s), as numpy."""
    D = q.shape[-1]
    scale = 1.0 / jnp.sqrt(jnp.asarray(D, jnp.float32))
    return np.asarray(jnp.einsum("bhgd,bshd->bhgs", jnp.asarray(q),
                                 jnp.asarray(k)) * scale, np.float64)


@pytest.mark.parametrize("B,KV,G,D,S", LSE_SHAPES)
def test_flash_decode_lse_matches_logsumexp(B, KV, G, D, S):
    """The log-sum-exp instance's plain version: its lse within 1e-6 of a
    numpy logsumexp of the reference's f32 scores over each request's
    kv_len positions, its f32 output the reference's within 1e-5."""
    rng = np.random.RandomState(9)
    q, k, v = (rng.randn(*s).astype(np.float32) for s in (
        (B, KV, G, D), (B, S, KV, D), (B, S, KV, D)))
    lens = np.linspace(1, S, B).round().astype(np.int32)
    out, lse = flash_decode_blocks(*(torch.from_numpy(a) for a in (q, k, v)),
                                   torch.from_numpy(lens), lse=True)
    assert out.dtype == lse.dtype == torch.float32
    assert lse.shape == (B, KV, G)
    sc = _scores_f32(q, k)
    for b, n in enumerate(lens):
        x = sc[b, ..., :n]
        m = x.max(-1)
        want = m + np.log(np.exp(x - m[..., None]).sum(-1))
        np.testing.assert_allclose(lse[b].numpy(), want, atol=1e-6, rtol=0)
        _close(out[b:b + 1], jref.flash_decode_ref(
            q[b:b + 1], k[b:b + 1], v[b:b + 1], int(n)), "f32")


def _merge(parts):
    """The ranks' merge of ``launch.mesh.softmax_merge``, over a list of
    (out, lse) pairs: the max lse, each weighted by exp(lse - max)."""
    top = torch.stack([l for _, l in parts]).amax(0)
    top = torch.where(torch.isinf(top), torch.zeros_like(top), top)
    ws = [torch.exp(l - top)[..., None] for _, l in parts]
    num = sum(w * o for w, (o, _) in zip(ws, parts))
    return num / sum(ws).clamp(min=1e-30), ws


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_four_shards_merge_to_the_unsharded_output(dt):
    """A 256-row cache cut into four 64-row shards, as sequence-sharded
    decode cuts it, each attended with kv_len clamp(L - offset, 0, 64):
    the merged f32 outputs within 1e-6 of the unsharded call's f32
    output; a request of length 70 leaves shards 2 and 3 empty (zeros,
    lse -inf, weight 0, no NaN)."""
    rng = np.random.RandomState(11)
    B, KV, G, D, S, n = 3, 2, 4, 32, 256, 4
    q, k, v = (_pair(rng.randn(*s), dt)[1] for s in (
        (B, KV, G, D), (B, S, KV, D), (B, S, KV, D)))
    lens = torch.tensor([256, 70, 129], dtype=torch.int32)
    whole, whole_lse = flash_decode_blocks(q, k, v, lens, lse=True)
    sh = S // n
    parts = []
    for i in range(n):
        kl = (lens - i * sh).clamp(0, sh)
        parts.append(flash_decode_blocks(
            q, k[:, i * sh:(i + 1) * sh].contiguous(),
            v[:, i * sh:(i + 1) * sh].contiguous(), kl, lse=True))
    got, ws = _merge(parts)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-6, rtol=0)
    for i in (2, 3):                # request 1 (70 rows) holds none there
        o, l = parts[i]
        assert bool(torch.isneginf(l[1]).all())
        assert not bool(o[1].any()) and not bool(ws[i][1].any())
    top = torch.stack([l for _, l in parts]).amax(0)
    merged_lse = top + torch.log(sum(ws)[..., 0])
    np.testing.assert_allclose(merged_lse.numpy(), whole_lse.numpy(),
                               atol=1e-5, rtol=0)


def test_empty_shard_gives_zero_and_minus_inf():
    """kv_len 0 for every request (a rank that holds none of the
    positions): zeros and lse -inf, and the merge with it alone is 0."""
    q = torch.randn(2, 1, 3, 16)
    k = torch.randn(2, 8, 1, 16)
    out, lse = flash_decode_blocks(q, k, k, 0, lse=True)
    assert not bool(out.any()) and bool(torch.isneginf(lse).all())
    got, ws = _merge([(out, lse), (out, lse)])
    assert not bool(got.any()) and not bool(torch.isnan(got).any())


def _paged_case(G, dt, page, nblk, lens):
    """A shuffled pool of pages; table entries past each request's pages
    are the scratch page 0 (masked by kv_len), as the paged engine lays
    them out; an idle lane decodes against the scratch page with kv_len 1
    and stays finite."""
    rng = np.random.RandomState(3)
    B, KV, D = 3, 2, 16
    P = 1 + B * nblk
    pages = rng.permutation(np.arange(1, P)).astype(np.int32)
    bt = pages.reshape(B, nblk).copy()
    lens = np.array(lens, np.int32)
    for b, n in enumerate(lens):
        bt[b, -(-n // page):] = 0
    bt[2] = 0                                   # an idle lane
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng.randn(*s), dt) for s in (
        (B, KV, G, D), (P, page, KV, D), (P, page, KV, D)))
    tbt, tlen = torch.from_numpy(bt), torch.from_numpy(lens)
    port = flash_decode_paged(tq, tk, tv, tbt, tlen)
    assert torch.isfinite(port.float()).all()
    _close(port, j_paged(jq, jk, jv, jnp.asarray(bt), jnp.asarray(lens),
                         interpret=True), dt)
    _close(port, ref.flash_decode_paged_ref(tq, tk, tv, tbt, tlen), dt)


@pytest.mark.parametrize("G", [2, 9, 48])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_decode_paged_matches_jax(G, dt):
    """Pages of 4, a table 24 positions wide; G = 48 is granite-34b's
    grouping, which the paged kernel takes as the contiguous one does."""
    _paged_case(G, dt, 4, 6, [7, 21, 1])


@pytest.mark.parametrize("G", [9, 48])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_decode_paged_pages_straddle_splits(G, dt):
    """Pages of 12 in a table 108 positions wide: the kernel's 64-position
    splits end inside a page (64 = 5 pages + 4 rows), and request lengths
    end inside pages on both sides of a split."""
    _paged_case(G, dt, 12, 9, [70, 100, 1])


PREFILL_SHAPES = [(2, 13, 6, 2, 16), (1, 40, 18, 2, 32),
                  # several 64-row tiles with a ragged tail, G = 9, D = 128
                  (1, 150, 18, 2, 128),
                  # zamba2's shared block: heads of 80, G = 1, row 63 of
                  # two full tiles and a ragged third
                  (1, 130, 4, 4, 80),
                  # hubert-xlarge's encoder: 16 heads of 80, G = 1
                  (1, 32, 16, 16, 80)]


@pytest.mark.parametrize("B,S,H,KV,D", PREFILL_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_prefill_matches_jax(B, S, H, KV, D, causal, dt):
    """Causal at unaligned lengths (the reference pads, the port masks);
    bidirectional at a kv length that is a multiple of the reference's kv
    block, the only case where the two define the same function."""
    rng = np.random.RandomState(S)
    Skv = S if causal else 16 * (-(-S // 16))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng.randn(*s), dt) for s in (
        (B, S, H, D), (B, Skv, KV, D), (B, Skv, KV, D)))
    port = flash_prefill_blocks(tq, tk, tv, causal=causal)
    assert port.dtype == TDT[dt] and port.shape == (B, S, H, D)
    _close(port, jops.flash_prefill(jq, jk, jv, bq=8, bkv=16, causal=causal,
                                    interpret=True), dt)
    _close(port, jref.flash_prefill_ref(jq, jk, jv, causal=causal), dt)
    _close(ref.flash_prefill_ref(tq, tk, tv, causal=causal),
           jref.flash_prefill_ref(jq, jk, jv, causal=causal), dt)


def test_wrappers_validate_inputs():
    q = torch.zeros((2, 2, 3, 16))
    k = torch.zeros((2, 8, 2, 16))
    with pytest.raises(ValueError, match="kv_len"):
        flash_decode_blocks(q, k, k, torch.tensor([1, 2, 3], dtype=torch.int32))
    with pytest.raises(TypeError, match="dtype"):
        flash_decode_blocks(q.bfloat16(), k, k, 4)
    with pytest.raises(ValueError, match="block_tables"):
        flash_decode_paged(q, k, k, torch.zeros((2, 3), dtype=torch.int64), 4)
    with pytest.raises(ValueError, match="do not fit"):
        flash_prefill_blocks(torch.zeros((2, 8, 3, 16)), k, k)
