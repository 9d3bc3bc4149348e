"""The port's paged MLA paths against the JAX package's, on
deepseek-v2-lite-16b's smoke config: ``mla_decode_paged`` (the new row
written through a block table with a scratch entry, the absorbed decode
on the gathered latents) and two chunks of ``mla_prefill_chunk`` (the
second padded), on f32 / bf16 pools and on int8 ``QuantKV`` pools (one
bf16 scale a latent row and one a rope row): outputs within 1e-5 in f32
and BF16_TOL in bf16, pools equal (int8 codes bit for bit).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import layers as JL
from repro.serving import kvcache as JKV
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.serving import kvcache as TKV

from test_torch_mla import DTYPES, _close, _prec, _x, setup


def _pools(cfg, P, page, jd, td, quant, rng):
    """JAX and port page pools (c_kv, k_rope) of equal contents: random
    rows, or their int8 codes and scales."""
    m = cfg.mla
    out = []
    for tail in ((m.kv_lora_rank,), (m.qk_rope_head_dim,)):
        x = rng.standard_normal((P, page) + tail).astype(np.float32)
        if quant:
            q = JKV.quantize_kv(jnp.asarray(x))
            codes, scales = np.asarray(q.codes), np.asarray(q.scales)
            out.append((q, TKV.QuantKV(
                torch.from_numpy(codes.copy()),
                torch.from_numpy(scales.view(np.int16).copy()).view(
                    torch.bfloat16))))
        else:
            out.append((jnp.asarray(x, jd), torch.from_numpy(x).to(td)))
    return JA.KVCache(out[0][0], out[1][0]), TA.KVCache(out[0][1],
                                                        out[1][1])


def _leaves_close(t, j, dtype):
    for a, b in zip(TKV.leaves(t), jax.tree.leaves(j)):
        if a.dtype == torch.int8:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            _close(a, b, dtype)


@pytest.mark.parametrize("quant", [False, True], ids=["pools", "int8-pools"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_paged_matches(dtype, quant):
    """mla_decode_paged through a block table with a scratch entry: the
    new row written through the table (quantized into int8 pools), the
    absorbed attention on the gathered latents."""
    jcfg, tcfg, jp, tp = setup("lite")
    rng = np.random.default_rng(4)
    P, page = 8, 4
    jd, td = DTYPES[dtype]
    jpool, tpool = _pools(jcfg, P, page, jd, td, quant, rng)
    bt = np.array([[5, 2, 7], [1, 6, 0], [3, 4, 0]], np.int32)
    pos = np.array([9, 6, 2], np.int32)
    jx, tx = _x(rng, 3, 1, jcfg.d_model)
    a, b = _prec(dtype)
    with a, b:
        jo, jc = JA.mla_decode_paged(jp, jcfg, jx, jpool, jnp.asarray(bt),
                                     jnp.asarray(pos))
        to, tc = TA.mla_decode_paged(tp, tcfg, tx, tpool,
                                     torch.from_numpy(bt),
                                     torch.from_numpy(pos))
    _close(to, jo, dtype)
    _leaves_close(tc, jc, dtype)


@pytest.mark.parametrize("quant", [False, True], ids=["pools", "int8-pools"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_chunk_matches(dtype, quant):
    """Two chunks of mla_prefill_chunk through one block table, the
    second padded (its padding rows write to the scratch page)."""
    jcfg, tcfg, jp, tp = setup("lite")
    rng = np.random.default_rng(5)
    P, page, C = 8, 4, 4
    jd, td = DTYPES[dtype]
    jc, tc = _pools(jcfg, P, page, jd, td, quant, rng)
    bt = np.array([[5, 2, 7], [1, 6, 3]], np.int32)
    xs = rng.standard_normal((2, C, jcfg.d_model)).astype(np.float32)
    a, b = _prec(dtype)
    with a, b:
        for start, valid in ((0, C), (C, 3)):
            x = np.zeros_like(xs)
            x[:, :valid] = rng.standard_normal(
                (2, valid, jcfg.d_model)).astype(np.float32)
            jo, jc = JA.mla_prefill_chunk(jp, jcfg, jnp.asarray(x), jc,
                                          jnp.asarray(bt), start,
                                          start + valid)
            to, tc = TA.mla_prefill_chunk(tp, tcfg, torch.from_numpy(x), tc,
                                          torch.from_numpy(bt), start,
                                          start + valid)
            _close(to[:, :valid], jo[:, :valid], dtype)
            _leaves_close(tc, jc, dtype)
