"""repro_torch.analysis.profile, the counterpart of repro/analysis/hlo.py.

  * On chains of matmuls, ``dot_flops`` equals the reference's
    ``hlo.program_cost`` of the jitted same chain exactly (2·M·N·K each).
  * On a smoke-size starcoder2 prefill of 16 tokens and a decode step,
    ``dot_flops`` equals an analytic count worked out from the config:
    the projections and MLP of every layer on every token, the attention
    kernel's q·k and p·v over the keys each query sees, and the LM head
    on each request's last row. It matches the reference's within the
    gap that attention explains: the reference's chunked attention
    multiplies every query by every key of its block (the masked upper
    triangle of the prefill; the whole cache in decode), where the
    port's flash kernels count the keys a query sees (``cost()``).
  * A ported kernel's call on the CPU counts its ``cost()`` and nothing
    else, and the same kernel under an outer op counts both apart.
  * ``bytes_accessed`` and ``memory_summary``'s argument and output bytes
    are exact on hand-countable functions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import hlo
from repro.configs import get_smoke_config as j_smoke
from repro.models import layers as JL
from repro.models import lm as JLM
from repro_torch.analysis import profile
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import flash_decode_blocks
from repro_torch.kernels.flash_prefill import (flash_prefill_blocks,
                                               flash_prefill_cost)
from repro_torch.kernels.masked_update import masked_update
from repro_torch.kernels.scatter_apply import scatter_apply
from repro_torch.kernels.sidedelta import (sidedelta, sidedelta_cost,
                                           sidedelta_dvals)
from repro_torch.kernels.sparse_adamw import sparse_adamw_rows
from repro_torch.models import layers as TL
from repro_torch.models import lm

B, S, CACHE = 2, 16, 24

CHAINS = {
    "mm": (lambda a, b, c: (a @ b) @ c, ((32, 64), (64, 48), (48, 16))),
    "bmm": (lambda a, b, c: (a @ b) @ c, ((3, 8, 40), (3, 40, 24),
                                          (3, 24, 5))),
    "einsum": (lambda a, b, c: torch.einsum(
        "bij,bjk->bik", torch.einsum("bij,bjk->bik", a, b), c)
               if isinstance(a, torch.Tensor) else jnp.einsum(
        "bij,bjk->bik", jnp.einsum("bij,bjk->bik", a, b), c),
        ((2, 16, 32), (2, 32, 8), (2, 8, 12))),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_matmul_chain_dot_flops_equal_the_reference(name):
    fn, shapes = CHAINS[name]
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want = hlo.program_cost(jax.jit(fn).lower(
        *(jnp.asarray(x) for x in xs)).compile().as_text())
    got = profile.program_cost(fn, *(torch.from_numpy(x) for x in xs))
    assert got["dot_flops"] == want["dot_flops"]
    assert got["flops"] == want["dot_flops"]        # nothing but matmuls
    assert got["ops_without_cost"] == 0.0
    # bytes: each product reads its operands and writes its output once
    (p, q, r) = shapes
    mid = p[:-1] + q[-1:]
    out = p[:-1] + r[-1:]
    n = lambda s: int(np.prod(s)) * 4
    assert got["bytes_accessed"] == n(p) + n(q) + n(mid) + n(mid) + n(r) \
        + n(out)


def _dense_dot_flops(cfg, tokens, heads_keys, last_rows):
    """Projections and MLP on every token of every layer, attention's
    q·k and p·v over ``heads_keys`` (sum over requests and queries of the
    keys each sees), the LM head on ``last_rows`` rows."""
    d, f = cfg.d_model, cfg.d_ff
    q = cfg.num_heads * cfg.resolved_head_dim
    kv = cfg.num_kv_heads * cfg.resolved_head_dim
    mult = 3 if cfg.act == "silu" else 2
    per_token = 2 * (d * q + 2 * d * kv + q * d + mult * d * f)
    attn = 4 * cfg.resolved_head_dim * cfg.num_heads * heads_keys
    head = 2 * d * cfg.padded_vocab * last_rows
    return float(cfg.num_layers * (per_token * tokens + attn) + head)


@pytest.fixture(scope="module")
def models():
    jcfg = j_smoke("starcoder2-7b")
    jparams = JLM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_smoke_config("starcoder2-7b")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    return jcfg, jparams, cfg, params, toks


def test_prefill_and_decode_count_against_analytic_and_reference(models):
    jcfg, jparams, cfg, params, toks = models
    tt = torch.from_numpy(toks)
    jt = jnp.asarray(toks, jnp.int32)
    with TL.compute_precision(torch.float32):
        pre = profile.program_cost(
            lambda: lm.prefill(params, cfg, {"tokens": tt}, CACHE))
        logits, caches = lm.prefill(params, cfg, {"tokens": tt}, CACHE)
        nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
        dec = profile.program_cost(
            lambda: lm.decode_step(params, cfg, nxt, caches, S))
    causal = B * S * (S + 1) // 2              # keys the queries see
    assert pre["dot_flops"] == _dense_dot_flops(cfg, B * S, causal, B)
    assert dec["dot_flops"] == _dense_dot_flops(cfg, B, B * (S + 1), B)
    assert pre["kernel_calls"] == {"flash_prefill": cfg.num_layers}
    assert dec["kernel_calls"] == {"flash_decode": cfg.num_layers}
    assert pre["ops_without_cost"] == dec["ops_without_cost"] == 0.0

    with JL.compute_precision(jnp.float32):
        f = jax.jit(lambda p, t: JLM.prefill(p, jcfg, {"tokens": t}, CACHE))
        jpre = hlo.program_cost(f.lower(jparams, jt).compile().as_text())
        jlog, jcaches = f(jparams, jt)
        jn = jnp.argmax(jlog, -1).astype(jnp.int32)[:, None]
        g = jax.jit(lambda p, t, c: JLM.decode_step(p, jcfg, t, c, S))
        jdec = hlo.program_cost(g.lower(jparams, jn, jcaches).compile()
                                .as_text())
    per_key = 4 * cfg.resolved_head_dim * cfg.num_heads * cfg.num_layers
    # prefill: the reference also multiplies the masked upper triangle
    assert jpre["dot_flops"] - pre["dot_flops"] == \
        per_key * (B * S * S - causal)
    # decode: the reference attends every cache row, the kernel kv_len
    assert jdec["dot_flops"] - dec["dot_flops"] == \
        per_key * B * (CACHE - (S + 1))


def test_kernel_call_counts_its_cost_and_nothing_else():
    gen = torch.Generator().manual_seed(0)
    n, m, k = 24, 40, 30
    slots = [(torch.stack([torch.randperm(n * m, generator=gen)[:k].sort()
                           .values]).to(torch.int32),
              0.1 * torch.randn((1, k), generator=gen)) for _ in range(3)]
    t = {key: v[0].contiguous() for key, v in ops.sidedelta_table(
        slots, 1, n, m).items()}
    x = torch.randn((4, 5, n), generator=gen)
    ids = torch.tensor([0, 2, -1, 0], dtype=torch.int32)
    args = (x, t["rows"], t["vals"], t["colptr"], ids)
    got = profile.program_cost(sidedelta, *args)
    want = sidedelta_cost(*args)
    assert got["flops"] == want["flops"] + want["bf16_flops"]
    assert got["bytes_accessed"] == want["bytes_accessed"]
    assert got["dot_flops"] == 0.0 and got["ops"] == 0
    assert got["kernel_calls"] == {"sidedelta": 1}
    valid = t["colptr"][:, -1].tolist()
    assert want["flops"] == 2 * 5 * (2 * valid[0] + valid[2])

    # an op around the call counts apart: (x * 2) reads and writes x once
    got2 = profile.program_cost(lambda: sidedelta(x * 2, *args[1:]))
    assert got2["flops"] == want["flops"] + x.numel()
    assert got2["bytes_accessed"] == want["bytes_accessed"] + 8 * x.numel()

    # attention kernels count as dot products
    q, kk, v = (torch.randn(s, generator=gen) for s in
                ((2, 9, 4, 16), (2, 9, 2, 16), (2, 9, 2, 16)))
    got = profile.program_cost(flash_prefill_blocks, q, kk, v)
    want = flash_prefill_cost(q, kk, v)
    assert got["dot_flops"] == got["flops"] == want["flops"] == \
        4 * 16 * 4 * 2 * (9 * 10 // 2)
    assert got["bytes_accessed"] == want["bytes_accessed"] == \
        (2 * q.numel() + 2 * kk.numel()) * 4


def test_every_kernel_reports_once_on_the_cpu():
    gen = torch.Generator().manual_seed(1)
    w = torch.randn((2, 8, 16), generator=gen)
    idx = torch.tensor([[1, 9, 40], [0, 3, 127]], dtype=torch.int32)
    vals = torch.randn((2, 3), generator=gen)
    mask = torch.rand((2, 8, 16), generator=gen) < 0.1
    v = torch.randn((6, 10), generator=gen)
    q = torch.randn((2, 2, 3, 16), generator=gen)
    cache = torch.randn((2, 12, 2, 16), generator=gen)
    x = torch.randn((2, 3, 8), generator=gen)
    dy = torch.randn((2, 3, 16), generator=gen)
    t = {key: val[0].contiguous() for key, val in ops.sidedelta_table(
        [(idx[:1], vals[:1]), (idx[1:], vals[1:])], 1, 8, 16).items()}
    ids = torch.tensor([0, 1], dtype=torch.int32)
    ones, u = torch.ones_like(w), v.abs()
    scalars = [1e-3, 0.9, 0.999, 1e-8, 0.0, 0.1, 0.001]
    calls = {
        "scatter_apply": lambda: scatter_apply(w, idx, vals, 1.0),
        "masked_update": lambda: masked_update(w, mask, ones, -1.0),
        "sparse_adamw_rows": lambda: sparse_adamw_rows(
            v, v, v, u, None, None, scalars),
        "flash_decode": lambda: flash_decode_blocks(q, cache, cache, 7),
        "sidedelta_dvals": lambda: sidedelta_dvals(
            x, dy, t["rows"], t["colptr"], ids),
    }
    for name, fn in calls.items():
        got = profile.program_cost(fn)
        assert got["kernel_calls"] == {name: 1}, name
        assert got["ops"] == 0, name
    got = profile.program_cost(calls["scatter_apply"])
    # 6 entries; sectors of 8 floats at flat 1, 9, 40 | 128, 131, 255 (w
    # 64-byte aligned): 0, 1, 5, 16, 31
    assert w.data_ptr() % 32 == 0
    assert got["bytes_accessed"] == 6 * 8 + 64 * 5
    got = profile.program_cost(calls["masked_update"])
    sectors = int(mask.reshape(-1, 8).any(1).sum())
    assert got["bytes_accessed"] == w.numel() * 9 + 32 * sectors
    got = profile.program_cost(calls["flash_decode"])
    assert got["dot_flops"] == 4 * (2 * 7) * 2 * 3 * 16


def test_bytes_and_memory_are_exact_on_hand_countable_functions():
    x = torch.ones((100,), dtype=torch.float32)
    y = torch.ones((100,), dtype=torch.float64)
    # add: x (400) and y (800) read, out (800) written; sum: 800 + 8
    got = profile.program_cost(lambda a, b: (a + b).sum(), x, y)
    assert got["bytes_accessed"] == 400 + 800 + 800 + 800 + 8
    assert got["flops"] == 100 + 1
    # a broadcast operand spans its own bytes once
    row = torch.ones((1, 50))
    got = profile.program_cost(lambda a: a.expand(20, 50) * 3.0, row)
    assert got["bytes_accessed"] == 200 + 20 * 50 * 4
    # an in-place op counts the region it touches, read and written
    big = torch.zeros((10, 100))
    got = profile.program_cost(lambda a: a[2].add_(1.0), big)
    assert got["bytes_accessed"] == 2 * 400
    # copy_ writes its target, reads its source
    got = profile.program_cost(lambda a, b: a[3].copy_(b), big, x)
    assert got["bytes_accessed"] == 400 + 400
    # a gather reads what it returns, and its indices
    i = torch.tensor([1, 5, 7])
    got = profile.program_cost(lambda a, j: a[j], big, i)
    assert got["bytes_accessed"] == 2 * 3 * 400 + 3 * 8

    mem = profile.memory_summary(lambda a, b: (a * 2 + 1, b.sum()), x, y)
    assert mem["argument_size_in_bytes"] == 400 + 800
    assert mem["output_size_in_bytes"] == 400 + 8
    assert mem["alias_size_in_bytes"] == 0
    # the peak: a * 2 and its + 1 live at once (the sum comes after a * 2
    # is freed), less the outputs
    assert mem["temp_size_in_bytes"] == 400 + 400 - (400 + 8)
    mem = profile.memory_summary(lambda a: a.mul_(2.0), big)
    assert mem["argument_size_in_bytes"] == mem["output_size_in_bytes"] == \
        mem["alias_size_in_bytes"] == 4000
    assert mem["temp_size_in_bytes"] == 0
    assert mem["peak_device_mb"] == round(4000 / 1e6, 1)


def test_sparse_operands_are_counted_as_not_costed():
    sp = torch.eye(4).to_sparse()
    got = profile.program_cost(torch.sparse.mm, sp, torch.ones((4, 2)))
    assert got["ops_without_cost"] >= 1.0
    assert got["dot_flops"] == 0.0


def test_cost_summary_is_the_library_count():
    a, b = torch.ones((8, 16)), torch.ones((16, 4))
    assert profile.cost_summary(torch.mm, a, b) == {"flops": 2.0 * 8 * 16 * 4}
