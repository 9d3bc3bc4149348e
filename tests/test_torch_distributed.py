"""The port's multi-rank path against the JAX package on one device.

Four gloo processes on the CPU (``torch_dist_worker.py``, spawned once
for the file) run the port's sharded code on numpy-seeded inputs whose weights cross
through ``bridge``; the parent computes the JAX references meanwhile:

  * expert-parallel MoE (``_moe_ffn_ep`` over (2, 2)) against the JAX
    ``moe_ffn`` dense dispatch: bf16 within 0.05 (the reference's own
    test), f32 within 1e-5, and the gradients of sum(y) summed over the
    data ranks within 1e-5 of the whole batch's;
  * ``materialize_sharded`` against the reference's numpy loop
    (``test_distributed_features.py``) within 1e-5;
  * the packed SHiRA step (shard-local indices split from one global
    pack) and the fsdp full-finetune step on (2, 2), (1, 4) and (4, 1):
    f32 losses, global grad norms and updated values within 1e-5 of the
    JAX ``make_shira_train_step`` / ``make_train_step`` over 3 steps; the
    same for granite-moe on (1, 4) (expert parallel, tied vocab-parallel
    embedding) and for microbatch accumulation on (2, 2);
  * every collective of ``launch.mesh`` (all_reduce sum, max and mean,
    all_gather, reduce_scatter, all_to_all) over one axis and over the
    tuple ("data", "model") of a real (2, 2) mesh, against numpy;
  * prefill and decode on head-sharded meshes, and on sequence-sharded
    ones (a 5-token prompt into a 32-row cache, 12 decode steps, so some
    shards start empty and the writes cross shard boundaries): starcoder2
    on (1, 4) (the gather-q case: its 4 q heads split, its 2 KV heads
    not), on (4, 1) with batch 2 and on (2, 2) with batch 1 (the sequence
    over ``data``), granite-moe on (1, 4) and granite-34b on (2, 2) with
    batch 1 (one KV head: the sequence over ("data", "model"), q
    gathered): greedy tokens equal the JAX package's unsharded run's,
    logits within 1e-4.

``SyntheticTask.host_batch`` equals the reference's. The vocabulary
fallbacks run on 3 ranks in test_torch_distributed_fallback.py.
"""
import os
import pickle
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import AdapterConfig as JAdapterConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core.masks import path_str
from repro.data.pipeline import SyntheticTask as JSyntheticTask
from repro.data.pipeline import make_batch as j_make_batch
from repro.launch import steps as JS
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.models.moe import init_moe as j_init_moe
from repro.models.moe import moe_ffn as j_moe_ffn

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-5
# eps 1e-6: AdamW's step m / (sqrt(v) + eps) is a whole lr for any
# gradient well above eps, so an entry whose gradient cancels to f32
# rounding noise (~1e-10; sums in another order on the ranks) would move a
# noise-signed lr step with eps 1e-8
TCFG = {"learning_rate": 1e-3, "warmup_steps": 1, "grad_clip": 1.0,
        "eps": 1e-6}
STEPS = 3
B, S = 4, 16

SC = ("starcoder2-7b", {})
SC_FSDP = ("starcoder2-7b", {"fsdp": True})
GM = ("granite-moe-1b-a400m", {})


def j_cfg(spec):
    name, kw = spec
    kw = dict(kw)
    if "moe" in kw:
        kw["moe"] = JMoEConfig(**kw["moe"])
    return j_smoke(name).replace(**kw)


def np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree,
                        is_leaf=lambda x: x is None)


def flat(tree):
    return {path_str(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def batches_of(cfg, steps, seed=0):
    """``steps`` train batches of B x S tokens (a vision batch's patches
    in front of them)."""
    prefix = cfg.num_prefix_embeds if cfg.modality == "vision" else 0
    shape = JShapeSpec("t", S + prefix, B, "train")
    return [j_make_batch(cfg, shape, seed, i) for i in range(steps)]


def shira_indices(params, acfg, seed=3):
    """One global rand pack: sorted flat indices a target matrix."""
    rng = np.random.RandomState(seed)
    out = {}
    for p, x in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = path_str(p)
        if name.split("/")[-1] not in acfg.target_modules or x.ndim < 2:
            continue
        *lead, n, m = x.shape
        k = max(1, int(round((1.0 - acfg.sparsity) * n * m)))
        rows = [np.sort(rng.choice(n * m, k, replace=False))
                for _ in range(int(np.prod(lead)))]
        out[name] = np.stack(rows).reshape(tuple(lead) + (k,)).astype(
            np.int32)
    return out


def j_tree_like(params, values):
    return jax.tree_util.tree_map_with_path(
        lambda p, x: None if path_str(p) not in values
        else jnp.asarray(values[path_str(p)]), params)


def jax_train(spec, mode, steps, tcfg_kw=None, indices=None, seed=0):
    cfg = j_cfg(spec)
    tcfg = JTrainConfig(**{**TCFG, **(tcfg_kw or {})})
    params = JLM.init_params(cfg, jax.random.PRNGKey(seed))
    batches = batches_of(cfg, steps)
    out = {"loss": [], "grad_norm": []}
    with JL.compute_precision(jnp.float32):
        if mode == "full":
            step = jax.jit(JS.make_train_step(cfg, tcfg))
            state = {"trainable": params, "step": jnp.zeros((), jnp.int32),
                     "mu": jax.tree.map(jnp.zeros_like, params),
                     "nu": jax.tree.map(jnp.zeros_like, params)}
            for b in batches:
                state, m = step(state, {k: jnp.asarray(v)
                                        for k, v in b.items()})
                out["loss"].append(float(m["loss"]))
                out["grad_norm"].append(float(m["grad_norm"]))
            out["trainable"] = flat(state["trainable"])
        else:
            acfg = JAdapterConfig(kind="shira", mask="rand", sparsity=0.99)
            idx = j_tree_like(params, indices)
            vals = j_tree_like(params, {p: np.zeros(i.shape, np.float32)
                                        for p, i in indices.items()})
            step = jax.jit(JS.make_shira_train_step(cfg, tcfg, acfg))
            z = lambda t: jax.tree.map(jnp.zeros_like, t)
            state = {"trainable": vals, "step": jnp.zeros((), jnp.int32),
                     "mu": z(vals), "nu": z(vals)}
            for b in batches:
                state, m = step(state, {k: jnp.asarray(v)
                                        for k, v in b.items()}, params, idx)
                out["loss"].append(float(m["loss"]))
                out["grad_norm"].append(float(m["grad_norm"]))
            out["values"] = flat(state["trainable"])
    return params, batches, out


def jax_serve(spec, params, prompt, steps, size=None):
    """Greedy tokens and logits of a prefill and ``steps`` decode steps
    into a cache of ``size`` rows (jitted, f32)."""
    cfg = j_cfg(spec)
    size = size or prompt.shape[1] + steps + 1
    toks, logit_list = [], []
    with JL.compute_precision(jnp.float32):
        prefill = jax.jit(lambda p, t: JLM.prefill(p, cfg, {"tokens": t},
                                                   size))
        decode = jax.jit(lambda p, t, c, pos: JLM.decode_step(p, cfg, t, c,
                                                              pos))
        logits, caches = prefill(params, jnp.asarray(prompt))
        for i in range(steps):
            nxt = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
            toks.append(np.asarray(nxt))
            logit_list.append(np.asarray(logits))
            logits, caches = decode(params, nxt, caches,
                                    jnp.int32(prompt.shape[1] + i))
        logit_list.append(np.asarray(logits))
    return np.concatenate(toks, 1), np.stack(logit_list, 1)


# ---------------------------------------------------------------------------
# Jobs, the spawn, and the references
# ---------------------------------------------------------------------------

TRAIN4 = [("sc_full_fsdp", SC_FSDP, "full", (2, 2)),
          ("sc_full_fsdp", SC_FSDP, "full", (1, 4)),
          ("sc_full_fsdp", SC_FSDP, "full", (4, 1)),
          ("sc_shira", SC, "shira", (2, 2)),
          ("sc_shira", SC, "shira", (1, 4)),
          ("sc_shira", SC, "shira", (4, 1)),
          ("gm_full", GM, "full", (1, 4)),
          ("gm_shira", GM, "shira", (1, 4))]
GR = ("granite-34b", {})
# head-sharded on (2, 2): the prompt (4, 6) and 4 decode steps
SERVE4 = (("serve_sc@2x2", SC, (2, 2)), ("serve_gm@2x2", GM, (2, 2)))
# sequence-sharded: (key, spec, mesh, batch), a 5-token prompt into a
# 32-row cache and 12 decode steps; on (4, 1) the positions go as (B,)
# tensors, the per-request form
SEQ4 = (("seq_sc@1x4", SC, (1, 4), 2), ("seq_sc@4x1", SC, (4, 1), 2),
        ("seq_sc@2x2", SC, (2, 2), 1), ("seq_gm@1x4", GM, (1, 4), 2),
        ("seq_gr@2x2", GR, (2, 2), 1))
SEQ_VECTOR_POS = ("seq_sc@4x1",)
SEQ_PROMPT, SEQ_CACHE, SEQ_STEPS = 5, 32, 12


def _job_key(name, mesh):
    return f"{name}@{mesh[0]}x{mesh[1]}"


def _spawn(n, tmp):
    """Start ``n`` ranks before their jobs exist (they import torch and
    join the group meanwhile, then wait for the jobs file): (process, jobs
    path, out path)."""
    jp, op = os.path.join(tmp, f"jobs{n}.pkl"), os.path.join(tmp,
                                                             f"out{n}.pkl")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dist_worker.py"), jp, op,
         str(n)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env)
    return proc, jp, op


def _post(jobs, jp):
    """Hand the ranks their jobs: written whole, then renamed into place."""
    with open(jp + ".part", "wb") as f:
        pickle.dump(jobs, f)
    os.replace(jp + ".part", jp)


def _finish(proc, op):
    out, err = proc.communicate(timeout=400)
    assert proc.returncode == 0, err[-3000:]
    with open(op, "rb") as f:
        return pickle.load(f)


def _extra_jobs(jobs, inputs):
    """Microbatching, expert-parallel MoE and materialize_sharded: the
    jobs, and a function that computes their references."""
    mb_params, mb_batches, _ = inputs["sc_full_fsdp"]
    jobs["microbatch"] = {"kind": "train", "cfg": SC_FSDP, "mesh": (2, 2),
                          "mode": "full", "params": np_tree(mb_params),
                          "batches": mb_batches,
                          "tcfg": {**TCFG, "microbatch": 2}}
    gcfg = j_smoke("granite-moe-1b-a400m")
    mp = j_init_moe(jax.random.PRNGKey(0), gcfg)
    x = (np.random.RandomState(1).randn(4, 16, gcfg.d_model) * 0.5).astype(
        np.float32)
    for dt in ("float32", "bfloat16"):
        jobs[f"ep_{dt}"] = {"kind": "ep_moe", "cfg": GM, "mesh": (2, 2),
                            "dtype": dt, "params": np_tree(mp), "x": x}
    rng = np.random.RandomState(0)
    L, n, m, ks = 3, 8, 16, 5
    mat = {"w": rng.randn(L, n, m).astype(np.float32),
           "idx": rng.randint(0, (n // 2) * (m // 2),
                              (L, 2, 2, ks)).astype(np.int32),
           "val": rng.randn(L, 2, 2, ks).astype(np.float32), "alpha": 0.5}
    jobs["materialize"] = {"kind": "materialize", "mesh": (2, 2), **mat}
    jobs["collectives"] = {"kind": "collectives", "mesh": (2, 2)}

    def references(refs):
        refs["microbatch"] = jax_train(SC_FSDP, "full", STEPS,
                                       {"microbatch": 2})[2]
        for dt, jdt in (("float32", jnp.float32),
                        ("bfloat16", jnp.bfloat16)):
            with JL.compute_precision(jdt):
                xj = jnp.asarray(x).astype(jdt)
                y, _ = j_moe_ffn(mp, gcfg, xj)
                g = jax.grad(lambda p: jnp.sum(
                    j_moe_ffn(p, gcfg, xj)[0].astype(jnp.float32)))(mp)
            refs[f"ep_{dt}"] = (np.asarray(y.astype(jnp.float32)),
                                np_tree(g))
        ref = mat["w"].copy()
        for di in range(2):
            for mi in range(2):
                for l in range(L):
                    for t in range(ks):
                        fi = int(mat["idx"][l, di, mi, t])
                        r, c = fi // (m // 2), fi % (m // 2)
                        ref[l, di * (n // 2) + r, mi * (m // 2) + c] += \
                            0.5 * float(mat["val"][l, di, mi, t])
        refs["materialize"] = ref

    return references


def run_cases(train, serve, nprocs, extras=False, seq=(), more_jobs=None,
              ref_tcfg=None, vector_pos=SEQ_VECTOR_POS, tcfg=None,
              steps=STEPS):
    """Spawn ``nprocs`` ranks on the jobs of these cases, compute the JAX
    references while they run, and return (references, results).
    ``more_jobs(jobs)`` adds jobs and returns a function that fills in
    their references; ``ref_tcfg`` ({name: TrainConfig fields}) sets a
    train case's JAX reference apart from the mesh's step (microbatches
    equal to the data shards, for an MoE model's aux); ``tcfg`` ({name:
    TrainConfig fields}) sets both sides' apart from TCFG; the ``seq``
    cases named in ``vector_pos`` decode at (B,) positions; each train
    case takes ``steps`` steps."""
    tmp = tempfile.mkdtemp()
    proc, jp, op = _spawn(nprocs, tmp)
    refs, jobs, inputs = {}, {}, {}
    serve_params, seq_prompts = {}, {}
    try:
        for name, spec, mode, mesh in train:
            if name not in inputs:
                cfg = j_cfg(spec)
                params = JLM.init_params(cfg, jax.random.PRNGKey(0))
                acfg = JAdapterConfig(kind="shira", mask="rand",
                                      sparsity=0.99)
                inputs[name] = (params, batches_of(cfg, steps),
                                shira_indices(params, acfg)
                                if mode == "shira" else None)
            params, batches, idx = inputs[name]
            jobs[_job_key(name, mesh)] = {
                "kind": "train", "cfg": spec, "mesh": mesh, "mode": mode,
                "params": np_tree(params), "batches": batches,
                "tcfg": {**TCFG, **(tcfg or {}).get(name, {})},
                "indices": idx}
        more = _extra_jobs(jobs, inputs) if extras else None
        more_refs = more_jobs(jobs) if more_jobs is not None else None
        prompt = np.random.RandomState(5).randint(0, 200, (4, 6)).astype(
            np.int32)
        for key, spec, mesh in serve:
            serve_params[key] = JLM.init_params(j_cfg(spec),
                                                jax.random.PRNGKey(0))
            jobs[key] = {"kind": "serve", "cfg": spec, "mesh": mesh,
                         "params": np_tree(serve_params[key]),
                         "prompt": prompt, "steps": 4}
        for key, spec, mesh, batch in seq:
            serve_params[key] = JLM.init_params(j_cfg(spec),
                                                jax.random.PRNGKey(0))
            seq_prompts[key] = np.random.RandomState(6).randint(
                0, 100, (batch, SEQ_PROMPT)).astype(np.int32)
            jobs[key] = {"kind": "serve", "cfg": spec, "mesh": mesh,
                         "params": np_tree(serve_params[key]),
                         "prompt": seq_prompts[key], "steps": SEQ_STEPS,
                         "size": SEQ_CACHE, "vector_pos": key in vector_pos}
    except BaseException:   # the ranks wait for a jobs file: let them exit
        _post({}, jp)
        proc.communicate(timeout=400)
        raise
    _post(jobs, jp)
    # the JAX references, meanwhile
    for key, spec, _ in serve:
        refs[key] = jax_serve(spec, serve_params[key], prompt, 4)
    done = {}       # one JAX run for the meshes that share a spec and batch
    for key, spec, _, batch in seq:
        same = (spec[0], repr(spec[1]), batch)
        if same not in done:
            done[same] = jax_serve(spec, serve_params[key], seq_prompts[key],
                                   SEQ_STEPS, SEQ_CACHE)
        refs[key] = done[same]
    for name, spec, mode, mesh in train:
        if name not in refs:
            refs[name] = jax_train(spec, mode, steps,
                                   {**(tcfg or {}).get(name, {}),
                                    **(ref_tcfg or {}).get(name, {})},
                                   indices=inputs[name][2])[2]
    if more is not None:
        more(refs)
    if more_refs is not None:
        more_refs(refs)
    return refs, _finish(proc, op)


@pytest.fixture(scope="module")
def runs():
    return run_cases(TRAIN4, SERVE4, 4, extras=True, seq=SEQ4)


def _ok(res, key):
    r = res[key]
    assert "error" not in r, r.get("error")
    return r


def _check_train(ref, got, key):
    np.testing.assert_allclose(got["loss"], ref["loss"], atol=TOL, rtol=0,
                               err_msg=key)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                               atol=TOL, rtol=TOL, err_msg=key)
    want = ref.get("trainable", ref.get("values"))
    have = got.get("trainable", got.get("values"))
    assert set(have) == set(want), key
    for p in want:
        np.testing.assert_allclose(have[p], want[p], atol=TOL, rtol=0,
                                   err_msg=f"{key} {p}")


@pytest.mark.parametrize("case", TRAIN4,
                         ids=lambda c: _job_key(c[0], c[3]))
def test_sharded_step_matches_jax(runs, case):
    refs, res = runs
    name, _, _, mesh = case
    _check_train(refs[name], _ok(res, _job_key(name, mesh)),
                 _job_key(name, mesh))


def test_microbatch_accumulation_matches_jax(runs):
    refs, res = runs
    _check_train(refs["microbatch"], _ok(res, "microbatch"), "microbatch")


@pytest.mark.parametrize("dt,tol", [("float32", 1e-5), ("bfloat16", 0.05)])
def test_ep_moe_matches_dense_dispatch(runs, dt, tol):
    refs, res = runs
    r = _ok(res, f"ep_{dt}")
    y, g = refs[f"ep_{dt}"]
    assert r["finite"]
    np.testing.assert_allclose(r["y"], y, atol=tol, rtol=0)
    if dt == "float32":
        for k in g:
            np.testing.assert_allclose(r["grads"][k], g[k], atol=1e-5,
                                       rtol=0, err_msg=k)


def _group(rank, axes):
    """The ranks of a (2, 2) ("data", "model") mesh that share ``rank``'s
    coordinates off ``axes``, row-major over ``axes``; rank's index."""
    d, m = divmod(rank, 2)
    if axes == "model":
        g = [2 * d, 2 * d + 1]
    elif axes == "data":
        g = [m, m + 2]
    else:
        g = [0, 1, 2, 3]
    return g, g.index(rank)


@pytest.mark.parametrize("axes", ["model", "data", "data+model"])
def test_collectives_over_an_axis_and_a_tuple(runs, axes):
    _, res = runs
    ranks = _ok(res, "collectives")["ranks"]
    x = lambda r: np.arange(8, dtype=np.float32) + 10 * r
    for rank, (coords, got) in enumerate(ranks):
        assert tuple(coords) == divmod(rank, 2)
        g, i = _group(rank, axes)
        n = len(g)
        total = sum(x(p) for p in g)
        np.testing.assert_array_equal(got[f"sum {axes}"], total)
        np.testing.assert_array_equal(got[f"max {axes}"], x(max(g)))
        np.testing.assert_allclose(got[f"mean {axes}"], total / n)
        np.testing.assert_array_equal(got[f"gather {axes}"],
                                      np.concatenate([x(p)[:2] for p in g]))
        c = 8 // n
        np.testing.assert_array_equal(got[f"scatter {axes}"],
                                      total[i * c:(i + 1) * c])
        # chunk j of rank p holds j + 100 p; rank i of the group gets its
        # chunk from every peer, in the group's order
        np.testing.assert_array_equal(
            got[f"a2a {axes}"], np.repeat([i + 100 * p for p in g], 2))


def test_materialize_sharded_matches_numpy_loop(runs):
    refs, res = runs
    got = _ok(res, "materialize")
    np.testing.assert_allclose(got["wq"], refs["materialize"], atol=1e-5)


@pytest.mark.parametrize("key", ["serve_sc@2x2", "serve_gm@2x2"])
def test_head_sharded_prefill_decode_match_jax(runs, key):
    refs, res = runs
    toks, logits = refs[key]
    r = _ok(res, key)
    np.testing.assert_array_equal(r["tokens"], toks)
    np.testing.assert_allclose(r["logits"], logits, atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", SEQ4, ids=lambda c: c[0])
def test_sequence_sharded_prefill_decode_match_jax(runs, case):
    """Each rank holds SEQ_CACHE / 4 (or / 2) rows of the cache; the
    merged decode equals the JAX package's unsharded decode_step."""
    refs, res = runs
    key, _, mesh, _ = case
    toks, logits = refs[key]
    r = _ok(res, key)
    n = 2 if key == "seq_sc@2x2" else 4
    assert r["cache_rows"] == SEQ_CACHE // n, r["cache_rows"]
    assert r["coll"]["by_kind_count"].get("all-reduce", 0) > 0
    np.testing.assert_array_equal(r["tokens"], toks)
    np.testing.assert_allclose(r["logits"], logits, atol=1e-4, rtol=0)


def test_host_batch_matches_reference():
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import SyntheticTask
    for arch in ("starcoder2-7b", "paligemma-3b", "hubert-xlarge"):
        shape = ShapeSpec("t", 300, 8, "train")
        js = JSyntheticTask(j_smoke(arch), JShapeSpec("t", 300, 8, "train"),
                            seed=4)
        ts = SyntheticTask(get_smoke_config(arch), shape, seed=4)
        for step, (hi, hc) in enumerate([(0, 2), (1, 2), (3, 4), (0, 1)]):
            want = js.host_batch(step, hi, hc)
            got = ts.host_batch(step, hi, hc)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
