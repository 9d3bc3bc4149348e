"""The port's multi-rank path where the model axis does not divide the
vocabulary: three gloo processes on the CPU, a (1, 3) mesh, against the
JAX package on one device (the harness of test_torch_distributed.py).

The padded vocabulary (256 rows) does not split 3 ways, so the rules
shard the embedding dim instead: ``emb`` ``P(None, "model")`` (a local
lookup, all-gathered) and ``lm_head`` ``P("model", None)`` (gathered
before the logits), the reference's fallbacks; ``d_ff`` 128 does not
split either, so the MLP is replicated under TP. On starcoder2's smoke
config widened to d_model 96 (6 heads, 3 KV heads: one a rank) the fsdp
full-finetune step's f32 losses, grad norms and updated values are within
1e-5 of the JAX ``make_train_step`` over 3 steps, and prefill and decode
on its head-sharded cache give the JAX run's greedy tokens, logits within
1e-4. On granite-moe's, tied (the fallback table serves both ends) with 6
experts, two a rank under expert parallelism, the step holds the same
bounds.
"""
import pytest

from test_torch_distributed import _check_train, _job_key, _ok, run_cases

# vocab 256 and d_ff 128 split 3 ways do not divide; d_model 96 does
SC3 = ("starcoder2-7b", {"d_model": 96, "num_heads": 6, "num_kv_heads": 3,
                         "fsdp": True})
GM3 = ("granite-moe-1b-a400m", {"d_model": 96, "num_heads": 6,
                                "num_kv_heads": 3,
                                "moe": {"num_experts": 6, "top_k": 2,
                                        "d_ff": 32,
                                        "capacity_factor": 1.25}})
TRAIN3 = [("sc3_full", SC3, "full", (1, 3)),
          ("gm3_full", GM3, "full", (1, 3))]
SERVE3 = (("serve_sc3@1x3", SC3, (1, 3)),)


@pytest.fixture(scope="module")
def runs():
    return run_cases(TRAIN3, SERVE3, 3)


@pytest.mark.parametrize("case", TRAIN3, ids=lambda c: _job_key(c[0], c[3]))
def test_fallback_step_matches_jax(runs, case):
    refs, res = runs
    name, _, _, mesh = case
    _check_train(refs[name], _ok(res, _job_key(name, mesh)),
                 _job_key(name, mesh))


def test_fallback_prefill_decode_match_jax(runs):
    import numpy as np
    refs, res = runs
    toks, logits = refs["serve_sc3@1x3"]
    r = _ok(res, "serve_sc3@1x3")
    np.testing.assert_array_equal(r["tokens"], toks)
    np.testing.assert_allclose(r["logits"], logits, atol=1e-4, rtol=0)
