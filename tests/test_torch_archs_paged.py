"""Paged prefill and decode on every ported architecture against the JAX
package: two chunks of a paged prefill (the second padded) and a paged
decode step through one block table, with f32 pools and int8 QuantKV
pools, on the smoke configs of the three dense archs and granite-moe and
on the GQA variant of granite-moe with shared experts and a first dense
layer (two stages, one page pool each). In f32 every logit agrees to
1e-5 (f32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as JLM
from repro_torch.models import lm as TLM

from test_torch_archs import B, CASES, _close, _f32, setup


@pytest.mark.parametrize("quant", [False, True], ids=["f32-pools",
                                                      "int8-pools"])
@pytest.mark.parametrize("case", CASES)
def test_prefill_chunk_and_paged_decode_match_jax(case, quant):
    """Two chunks of a paged prefill (the second padded) and a paged
    decode step through one block table, f32 pools or int8 QuantKV."""
    jcfg, tcfg, jp, tp, toks = setup(case)
    P, page, C = 8, 4, 4
    bt = np.array([[5, 2, 7], [1, 6, 3]], np.int32)
    a, b = _f32()
    # the JAX calls jitted, start and valid traced: one compile a case
    chunk_fn = jax.jit(lambda p, t, c, bt_, st, v: JLM.prefill_chunk(
        p, jcfg, t, c, bt_, st, v))
    decode_fn = jax.jit(lambda p, t, c, pos, bt_: JLM.decode_step(
        p, jcfg, t, c, pos, block_tables=bt_))
    with a, b:
        jc = JLM.init_paged_cache(jcfg, P, page, quant=quant)
        tc = TLM.init_paged_cache(tcfg, P, page, device="cpu", quant=quant)
        for start, valid in ((0, C), (C, 3)):
            chunk = np.zeros((B, C), np.int32)
            chunk[:, :valid] = toks[:, start:start + valid]
            jlog, jc = chunk_fn(jp, jnp.asarray(chunk), jc, jnp.asarray(bt),
                                jnp.int32(start), jnp.int32(valid))
            tlog, tc = TLM.prefill_chunk(tp, tcfg, torch.from_numpy(chunk),
                                         tc, torch.from_numpy(bt), start,
                                         valid)
            _close(tlog, jlog)
        pos = np.full((B,), C + 3, np.int32)
        t = toks[:, C + 3:C + 4]
        jlog, _ = decode_fn(jp, jnp.asarray(t), jc, jnp.asarray(pos),
                            jnp.asarray(bt))
        tlog, _ = TLM.decode_step(tp, tcfg, torch.from_numpy(t), tc,
                                  torch.from_numpy(pos),
                                  block_tables=torch.from_numpy(bt))
        _close(tlog, jlog)
