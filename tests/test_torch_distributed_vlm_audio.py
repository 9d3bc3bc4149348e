"""The TP forward of the vision and audio families on gloo ranks, against
the JAX package's unsharded steps on the same bridged weights (the harness
of test_torch_distributed.py: four CPU processes spawned once for the
file, the JAX references computed meanwhile):

  * paligemma-3b's smoke config (4 q heads over one KV head of 16, a
    16-patch prefix, tied vocabulary) and hubert-xlarge's (encoder only,
    bidirectional, frame embeddings) on (2, 2): the fsdp full-finetune
    step of both and paligemma's packed SHiRA step (shard-local indices
    split from one global pack), f32 losses, grad norms and updated
    values within 1e-5 over 2 steps;
  * paligemma's prefill of 16 patches + 5 tokens into a 40-row cache and
    12 greedy decode steps on (1, 4), where its one KV head shards the
    cache's sequence over ``model`` (10 rows a rank) and its q heads are
    split (gathered for the attention), and on (4, 1) with batch 1, the
    sequence over ``data``: greedy tokens equal the JAX run's, logits
    within 1e-4; the prefix rows land on the ranks that hold them;
  * hubert's encode step on (1, 4) (4 heads of 16, one a rank): frame
    logits within 1e-4 of the JAX ``encode``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_distributed import (TCFG, _check_train, _job_key, _ok,
                                    j_cfg, np_tree, run_cases)
from repro.models import layers as JL
from repro.models import lm as JLM

PG = ("paligemma-3b", {})
PG_FSDP = ("paligemma-3b", {"fsdp": True})
HB = ("hubert-xlarge", {})
HB_FSDP = ("hubert-xlarge", {"fsdp": True})
TRAIN = [("pg_full_fsdp", PG_FSDP, "full", (2, 2)),
         ("pg_shira", PG, "shira", (2, 2)),
         ("hb_full_fsdp", HB_FSDP, "full", (2, 2))]
STEPS = 2
# (key, mesh, batch): a 16-patch prefix and a 5-token prompt into a
# 40-row cache, 12 decode steps
VLM_SERVE = (("pg@1x4", (1, 4), 2), ("pg@4x1", (4, 1), 1))
PROMPT, CACHE, STEPS = 5, 40, 12
ENCODE = (("hb@1x4", (1, 4)),)
FRAMES = (4, 16)


def vlm_inputs(cfg, batch):
    rng = np.random.RandomState(8)
    toks = rng.randint(0, cfg.vocab_size, (batch, PROMPT)).astype(np.int32)
    patches = (rng.randn(batch, cfg.num_prefix_embeds, cfg.d_model)
               * 0.5).astype(np.float32)
    return toks, patches


def jax_vlm_serve(cfg, params, toks, patches):
    """Greedy tokens and logits of the JAX prefill and decode steps (f32,
    jitted)."""
    P0 = patches.shape[1] + toks.shape[1]
    out_t, out_l = [], []
    with JL.compute_precision(jnp.float32):
        prefill = jax.jit(lambda p, b: JLM.prefill(p, cfg, b, CACHE))
        decode = jax.jit(lambda p, t, c, pos: JLM.decode_step(p, cfg, t, c,
                                                              pos))
        logits, caches = prefill(params, {
            "tokens": jnp.asarray(toks),
            "patch_embeds": jnp.asarray(patches)})
        for i in range(STEPS):
            nxt = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
            out_t.append(np.asarray(nxt))
            out_l.append(np.asarray(logits))
            logits, caches = decode(params, nxt, caches, jnp.int32(P0 + i))
        out_l.append(np.asarray(logits))
    return np.concatenate(out_t, 1), np.stack(out_l, 1)


def jobs_and_refs(jobs):
    """Add the serving and encode jobs; return a function that computes
    their references."""
    pcfg = j_cfg(PG)
    pparams = JLM.init_params(pcfg, jax.random.PRNGKey(0))
    inputs = {}
    for key, mesh, batch in VLM_SERVE:
        toks, patches = inputs[key] = vlm_inputs(pcfg, batch)
        jobs[key] = {"kind": "serve", "cfg": PG, "mesh": mesh,
                     "params": np_tree(pparams), "prompt": toks,
                     "patches": patches, "steps": STEPS, "size": CACHE}
    hcfg = j_cfg(HB)
    hparams = JLM.init_params(hcfg, jax.random.PRNGKey(0))
    frames = (np.random.RandomState(9).randn(*FRAMES, hcfg.d_model)
              * 0.5).astype(np.float32)
    for key, mesh in ENCODE:
        jobs[key] = {"kind": "encode", "cfg": HB, "mesh": mesh,
                     "params": np_tree(hparams), "frames": frames}

    def references(refs):
        for key, _, _ in VLM_SERVE:
            refs[key] = jax_vlm_serve(pcfg, pparams, *inputs[key])
        with JL.compute_precision(jnp.float32):
            enc = np.asarray(jax.jit(lambda p, f: JLM.encode(p, hcfg, {
                "frame_embeds": f}))(hparams, jnp.asarray(frames)))
        for key, _ in ENCODE:
            refs[key] = enc
    return references


@pytest.fixture(scope="module")
def runs():
    return run_cases(TRAIN, (), 4, more_jobs=jobs_and_refs, steps=STEPS)


@pytest.mark.parametrize("case", TRAIN, ids=lambda c: _job_key(c[0], c[3]))
def test_vlm_audio_step_matches_jax(runs, case):
    refs, res = runs
    name, _, _, mesh = case
    _check_train(refs[name], _ok(res, _job_key(name, mesh)),
                 _job_key(name, mesh))


@pytest.mark.parametrize("case", VLM_SERVE, ids=lambda c: c[0])
def test_vision_prefix_prefill_decode_match_jax(runs, case):
    """The cache's sequence split 4 ways (10 rows a rank): the 21 prefix
    and prompt rows fill ranks 0 and 1 and part of 2, the decode steps
    cross into rank 3."""
    refs, res = runs
    key = case[0]
    toks, logits = refs[key]
    r = _ok(res, key)
    assert r["cache_rows"] == CACHE // 4, r["cache_rows"]
    assert r["coll"]["by_kind_count"].get("all-reduce", 0) > 0
    np.testing.assert_array_equal(r["tokens"], toks)
    np.testing.assert_allclose(r["logits"], logits, atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", ENCODE, ids=lambda c: c[0])
def test_encode_step_matches_jax(runs, case):
    refs, res = runs
    key, mesh = case
    r = _ok(res, key)
    assert r["logits"].shape == refs[key].shape
    np.testing.assert_allclose(r["logits"], refs[key], atol=1e-4, rtol=0)
    # the heads' partial sums (wo, w_down) and the gathered logits
    kinds = r["coll"]["by_kind_count"]
    assert kinds.get("all-reduce", 0) > 0 and kinds.get("all-gather", 0) > 0
