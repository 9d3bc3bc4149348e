"""repro_torch.optim and repro_torch.training.qstate against the JAX
package on the same numpy inputs.

lr_schedule, global_norm, batched_global_norm and adamw_update agree to
1e-6 relative (f32 sums in another order). The cosine schedule's tail is
held to 1e-6 of the base rate instead: 1 + cos(pi * frac) cancels there,
and one ulp of cos, where XLA's and numpy's float32 cos differ, is a large
relative change of a near-zero rate. qstate's int8 codes are equal and its
scales agree to 1e-7 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.optim import adamw as JO
from repro.training import qstate as jq
from repro_torch.configs import TrainConfig
from repro_torch.optim import adamw as TO
from repro_torch.training import qstate as tq

REL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("schedule", ["linear", "cosine", "constant"])
@pytest.mark.parametrize("warm,total", [(2, 6), (10, 300), (1, 1)])
def test_lr_schedule_matches_jax(schedule, warm, total):
    kw = dict(schedule=schedule, warmup_steps=warm, total_steps=total,
              learning_rate=3e-4)
    j, t = JO.lr_schedule(JTrainConfig(**kw)), TO.lr_schedule(
        TrainConfig(**kw))
    got = np.array([t(s) for s in range(total + 3)])
    want = np.array([float(j(jnp.int32(s))) for s in range(total + 3)])
    atol = REL * 3e-4 if schedule == "cosine" else 0.0
    np.testing.assert_allclose(got, want, rtol=REL, atol=atol)
    assert all(float(np.float32(x)) == x for x in got)


def _tree(rng, shapes):
    return {"stages": [{"attn": {k: rng.standard_normal(s).astype(np.float32)
                                 for k, s in shapes.items()}}],
            "embed": None}


def test_global_norms_match_jax():
    rng = np.random.default_rng(0)
    tree = _tree(rng, {"wq": (3, 2, 40), "w_up": (3, 2, 70)})
    jt = jax.tree.map(jnp.asarray, tree)
    tt = jax.tree.map(_t, tree)
    np.testing.assert_allclose(float(TO.global_norm(tt)),
                               float(JO.global_norm(jt)), rtol=REL)
    np.testing.assert_allclose(TO.batched_global_norm(tt, 3).numpy(),
                               np.asarray(JO.batched_global_norm(jt, 3)),
                               rtol=REL)


@pytest.mark.parametrize("clip,wd", [(1.0, 0.0), (0.0, 0.1), (50.0, 0.0)])
def test_adamw_update_matches_jax(clip, wd):
    """Three steps of the plain reference update, clipping active (1.0),
    off (0.0) and inactive (50.0)."""
    rng = np.random.default_rng(1)
    shapes = {"wq": (2, 30), "w_up": (2, 45)}
    params = _tree(rng, shapes)
    kw = dict(learning_rate=1e-2, grad_clip=clip, weight_decay=wd)
    jc, tc = JTrainConfig(**kw), TrainConfig(**kw)
    jp, tp = jax.tree.map(jnp.asarray, params), jax.tree.map(_t, params)
    js, ts = JO.adamw_init(jp), TO.adamw_init(tp)
    for step in range(3):
        grads = _tree(rng, shapes)
        lr = TO.lr_schedule(tc)(step)
        jp, js, jm = JO.adamw_update(jax.tree.map(jnp.asarray, grads), js,
                                     jp, jc, jnp.float32(lr))
        tp, ts, tm = TO.adamw_update(jax.tree.map(_t, grads), ts, tp, tc, lr)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=REL)
    assert ts.step == int(js.step) == 3
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        for k in shapes:
            np.testing.assert_allclose(
                got["stages"][0]["attn"][k].numpy(),
                np.asarray(want["stages"][0]["attn"][k]), rtol=REL,
                atol=REL)


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("sqrt_domain", [False, True])
def test_qstate_encode_decode_match_jax(mode, sqrt_domain):
    rng = np.random.default_rng(2)
    m = (rng.standard_normal((2, 5, 64)) * 1e-3).astype(np.float32)
    if sqrt_domain:
        m = np.square(m)
    m[1, 3] = 0.0                                  # an all-zero row
    js, jsc = jq.encode(jnp.asarray(m), mode, sqrt_domain)
    ts, tsc = tq.encode(_t(m), mode, sqrt_domain)
    assert ts.dtype == tq.storage_dtype(mode)
    if mode == "int8":
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-7)
        assert float(tsc[1, 3]) == 1.0
    else:
        assert tsc is None and jsc is None
        np.testing.assert_array_equal(ts.float().numpy(),
                                      np.asarray(js.astype(jnp.float32)))
    back = tq.decode(ts, tsc, mode, sqrt_domain)
    jback = jq.decode(js, jsc, mode, sqrt_domain)
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), rtol=1e-7)
    assert float(back[1, 3].abs().max()) == 0.0


def test_qstate_rounds_half_to_even_and_counts_bytes():
    """torch.round and jnp.rint agree on ties; moment bytes as the
    reference counts them."""
    m = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]], np.float32)
    ts, _ = tq.encode(_t(m), "int8")
    js, _ = jq.encode(jnp.asarray(m), "int8")
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0].tolist() == [127, 0, 2, 2, 0, -2]
    for mode in tq.MOMENT_MODES:
        assert tq.moment_bytes_per_value(mode, 40) == \
            jq.moment_bytes_per_value(mode, 40)
