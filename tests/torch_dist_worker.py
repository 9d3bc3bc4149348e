"""Multi-rank jobs for tests/test_torch_distributed.py: N gloo processes
on the CPU, one file store.

    python tests/torch_dist_worker.py JOBS.pkl OUT.pkl NPROCS

spawns NPROCS ranks; every rank waits for JOBS.pkl to appear (the
caller may start the ranks first), runs every job in it (a dict name ->
job, numpy inputs only) in order, and rank 0 writes {name: result} to
OUT.pkl. A job builds its mesh, cuts each rank's shards of the global
inputs (``launch.sharding.local_shard``), runs the port's multi-rank
code, and gathers what the test compares back to global arrays. It
imports nothing of jax or the JAX package.
"""
import os
import pickle
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import bridge  # noqa: E402
from repro_torch.analysis.profile import collective_summary  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import (AdapterConfig, MoEConfig,  # noqa: E402
                                      ShapeSpec, TrainConfig)
from repro_torch.core import adapters as A  # noqa: E402
from repro_torch.core.masks import iter_leaves, map_leaves  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch.actctx import sharding_hints  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_mesh  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.moe import moe_ffn  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_cfg(job):
    name, kw = job["cfg"]
    kw = dict(kw)
    if "moe" in kw:
        kw["moe"] = MoEConfig(**kw["moe"])
    return get_smoke_config(name).replace(**kw)


def mesh_of(job):
    shape = tuple(job["mesh"])
    if len(shape) == 2:
        return make_host_mesh(*shape)
    return make_mesh(shape, ("pod", "data", "model")[-len(shape):], "cpu")


def gather_tree(tree, spec_tree, mesh, shapes):
    """Rank 0 gets the global arrays of a tree of local shards."""
    specs = dict(iter_leaves(spec_tree))
    local = {p: t.detach().float().numpy() for p, t in iter_leaves(tree)}
    allp = [None] * dist.get_world_size()
    dist.all_gather_object(allp, (mesh.coords, local))
    if dist.get_rank():
        return None
    out = {}
    for p, shape in shapes.items():
        g = np.zeros(shape, np.float32)
        for coords, loc in allp:
            cm = dict(zip(mesh.axis_names, coords))
            sl = []
            ents = list(specs[p]) + [None] * (len(shape) - len(specs[p]))
            for d, e in zip(shape, ents):
                axes = shd._entry_axes(e)
                n = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
                i = 0
                for a in axes:
                    i = i * mesh.shape[a] + cm[a]
                c = d // n
                sl.append(slice(i * c, (i + 1) * c))
            g[tuple(sl)] = loc[p]
        out[p] = g
    return out


def rows_of(x, mesh):
    """This rank's data-parallel rows of a global batch array."""
    n, i = mesh.shape.get("data", 1), mesh.coord("data")
    per = x.shape[0] // n
    return x[i * per:(i + 1) * per]


def gather_rows(t, mesh):
    allp = [None] * dist.get_world_size()
    dist.all_gather_object(allp, (mesh.coords, t.detach().float().numpy()))
    if dist.get_rank():
        return None
    di = mesh.axis_names.index("data")
    parts = {c[di]: a for c, a in allp}
    return np.concatenate([parts[i] for i in sorted(parts)], axis=0)


# ---------------------------------------------------------------------------
# Jobs
# ---------------------------------------------------------------------------

def job_ep_moe(job):
    cfg = make_cfg(job)
    mesh = mesh_of(job)
    dt = DTYPES[job["dtype"]]
    p = bridge.params_from_numpy(job["params"], "cpu")
    spec_e = shd.P("model", None, None)
    pl = {k: (shd.local_shard(v, spec_e, mesh) if k.startswith("experts_")
              else v).clone().requires_grad_(True) for k, v in p.items()}
    x = torch.from_numpy(rows_of(job["x"], mesh)).to(dt)
    with TL.compute_precision(dt), sharding_hints(
            moe_ep_mesh=(mesh, mesh.shape["model"])):
        y, aux = moe_ffn(pl, cfg, x)
        y.float().sum().backward()
    grads = {k: v.grad for k, v in pl.items()}
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    # the data ranks' gradients of sum(y) add up to the whole batch's
    for g in grads.values():
        dist.all_reduce(g, group=mesh._groups["data"])
    specs = {k: (spec_e if k.startswith("experts_") else shd.P())
             for k in grads}
    shapes = {k: tuple(v.shape) for k, v in p.items()}
    return {"y": gather_rows(y, mesh), "aux": float(aux), "finite": finite,
            "grads": gather_tree(grads, specs, mesh, shapes)}


def job_materialize(job):
    mesh = mesh_of(job)
    spec = shd.P(None, "data", "model")
    w = torch.from_numpy(job["w"])
    idx = torch.from_numpy(job["idx"])
    val = torch.from_numpy(job["val"])
    vspec = shd.P(None, "data", "model", None)
    wl = shd.local_shard(w, spec, mesh)
    out = A.materialize_sharded({"wq": wl}, {"wq": shd.local_shard(
        val, vspec, mesh)}, {"wq": shd.local_shard(idx, vspec, mesh)},
        alpha=job["alpha"])["wq"]
    return gather_tree({"wq": out}, {"wq": spec}, mesh,
                       {"wq": tuple(w.shape)})


def job_train(job):
    cfg = make_cfg(job)
    mesh = mesh_of(job)
    tcfg = TrainConfig(**job.get("tcfg", {}))
    params = bridge.params_from_numpy(job["params"], "cpu")
    pspecs = shd.param_specs(params, cfg, mesh)
    base = shd.shard_tree(params, pspecs, mesh)
    batches = [{k: torch.from_numpy(rows_of(v, mesh)) for k, v in b.items()}
               for b in job["batches"]]
    out = {"loss": [], "grad_norm": []}
    with TL.compute_precision(torch.float32):
        if job["mode"] == "full":
            step = S.make_train_step(cfg, tcfg, mesh, pspecs)
            state = {"trainable": base, "step": 0,
                     "mu": map_leaves(lambda _, t: torch.zeros_like(t), base),
                     "nu": map_leaves(lambda _, t: torch.zeros_like(t), base)}
            for b in batches:
                state, m = step(state, b)
                out["loss"].append(float(m["loss"]))
                out["grad_norm"].append(float(m["grad_norm"]))
            shapes = {p: tuple(t.shape) for p, t in iter_leaves(params)}
            out["trainable"] = gather_tree(state["trainable"], pspecs, mesh,
                                           shapes)
            return out
        acfg = AdapterConfig(kind="shira", mask="rand", sparsity=0.99)
        specs = dict(iter_leaves(pspecs))
        gidx = job["indices"]
        idx4, place = {}, {}
        for path, i in gidx.items():
            shape = dict(iter_leaves(params))[path].shape
            tiles = shd.tile_counts(specs[path], len(shape), mesh)
            ii, _, pl = A.split_packed(torch.from_numpy(i),
                                       torch.zeros(i.shape), shape, tiles)
            idx4[path], place[path] = ii, pl
        vspecs = S.value_specs(pspecs, idx4)
        idx_tree = map_leaves(lambda p, t: idx4.get(p), params)
        idx_local = map_leaves(
            lambda p, t: shd.local_shard(t, vspecs[p], mesh), idx_tree)
        vals = map_leaves(lambda _, t: torch.zeros(t.shape), idx_local)
        step = S.make_shira_train_step(cfg, tcfg, acfg, mesh, pspecs)
        state = {"trainable": vals, "step": 0,
                 "mu": map_leaves(lambda _, t: torch.zeros_like(t), vals),
                 "nu": map_leaves(lambda _, t: torch.zeros_like(t), vals)}
        for b in batches:
            state, m = step(state, b, base, idx_local)
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
        g4 = gather_tree(state["trainable"], vspecs, mesh,
                         {p: tuple(t.shape) for p, t in idx4.items()})
        if dist.get_rank() == 0:
            out["values"] = {p: A.join_packed(torch.from_numpy(v), place[p],
                                              gidx[p].shape[-1]).numpy()
                             for p, v in g4.items()}
        return out


def kv_rows(caches):
    """The rows a rank's first KV cache holds (a hybrid stage's shared
    block's), or None for a model with none (Mamba2)."""
    for st in caches:
        kv = st["attn"] if isinstance(st, dict) else st
        if hasattr(kv, "k"):
            return int(kv.k.shape[-3 if kv.k.ndim == 5 else -2])
    return None


def job_serve(job):
    """Prefill and greedy decode steps through the serving steps, the
    cache of ``size`` rows laid out by ``kv_cache_spec`` for a batch of
    the prompt's rows: by KV heads, or by sequence (KV heads that do not
    divide ``model``; a batch below the dp size, which every rank then
    serves whole). ``vector_pos``: each decode step's position as a (B,)
    tensor, the per-request form. ``patches``: a vision prefix of
    (B, P, d) patch embeddings, the first P cache rows. Also the
    collective bytes of the first decode step and each rank's cache
    length."""
    cfg = make_cfg(job)
    mesh = mesh_of(job)
    params = bridge.params_from_numpy(job["params"], "cpu")
    pspecs = S.serve_param_shardings(cfg, mesh)
    local = shd.shard_tree(params, pspecs, mesh)
    prompt = job["prompt"]
    B, S0 = prompt.shape
    patches = job.get("patches")
    P0 = 0 if patches is None else patches.shape[1]
    size = job.get("size") or P0 + S0 + job["steps"] + 1
    shape = ShapeSpec("serve", size, B, "decode")
    prefill = S.make_prefill_step(cfg, size, mesh, shape)
    decode = S.make_decode_step(cfg, mesh, shape)
    split = shd.cache_batch_axes(cfg, shape, mesh)[0] is not None
    mine = lambda a: torch.from_numpy(rows_of(a, mesh) if split else a)
    toks = mine(prompt)
    batch = {"tokens": toks}
    if patches is not None:
        batch["patch_embeds"] = mine(patches)
    out_t, out_l = [], []
    with TL.compute_precision(torch.float32):
        logits, caches = prefill(local, batch)
        for i in range(job["steps"]):
            nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
            out_t.append(nxt)
            out_l.append(logits)
            pos = P0 + S0 + i
            if job.get("vector_pos"):
                pos = torch.full((toks.shape[0],), pos, dtype=torch.int32)
            with M.record() as ev:
                logits, caches = decode(local, caches, nxt, pos)
            if i == 0:
                coll = collective_summary(ev)
        out_l.append(logits)
    toks, logits = torch.cat(out_t, 1), torch.stack(out_l, 1)
    out = {"coll": coll, "cache_rows": kv_rows(caches)}
    if split:
        out.update(tokens=gather_rows(toks, mesh),
                   logits=gather_rows(logits, mesh))
    else:               # every rank served the whole batch: rank 0's
        out.update(tokens=toks.numpy(), logits=logits.float().numpy())
    return out


def job_encode(job):
    """The encode step (an encoder-only model's frame logits) on the mesh,
    the batch's rows cut over the dp ranks; the logits gathered back."""
    cfg = make_cfg(job)
    mesh = mesh_of(job)
    params = bridge.params_from_numpy(job["params"], "cpu")
    local = shd.shard_tree(params, S.serve_param_shardings(cfg, mesh), mesh)
    frames = job["frames"]
    shape = ShapeSpec("encode", frames.shape[1], frames.shape[0], "prefill")
    step = S.make_encode_step(cfg, mesh, shape)
    with TL.compute_precision(torch.float32), M.record() as ev:
        logits = step(local, {"frame_embeds": torch.from_numpy(
            rows_of(frames, mesh))})
    return {"logits": gather_rows(logits, mesh),
            "coll": collective_summary(ev)}


def job_collectives(job):
    """Each collective over one axis and over the tuple, as rank 0 sees
    it, plus every rank's all_to_all result (rank r holds r * 100 + j in
    chunk j)."""
    mesh = mesh_of(job)
    r = dist.get_rank()
    x = torch.arange(8, dtype=torch.float32) + 10 * r
    out = {}
    for axes in ("model", "data", ("data", "model")):
        key = axes if isinstance(axes, str) else "+".join(axes)
        out[f"sum {key}"] = M.all_reduce(mesh, x, axes)
        out[f"max {key}"] = M.all_reduce(mesh, x, axes, "max")
        out[f"mean {key}"] = M.all_reduce(mesh, x, axes, "mean")
        out[f"gather {key}"] = M.all_gather(mesh, x[:2], axes)
        out[f"scatter {key}"] = M.reduce_scatter(mesh, x, axes)
        n = M.axis_size(mesh, axes) if isinstance(axes, str) else 4
        chunks = torch.arange(n, dtype=torch.float32).repeat_interleave(2)
        out[f"a2a {key}"] = M.all_to_all(mesh, chunks + 100 * r, axes)
    allp = [None] * dist.get_world_size()
    dist.all_gather_object(allp, (mesh.coords, {k: v.tolist()
                                                for k, v in out.items()}))
    return {"ranks": allp} if dist.get_rank() == 0 else None


JOBS = {"ep_moe": job_ep_moe, "materialize": job_materialize,
        "train": job_train, "serve": job_serve, "encode": job_encode,
        "collectives": job_collectives}


def _rank(rank, n, job_path, out_path, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=n)
    while not os.path.exists(job_path):     # the parent may still be
        time.sleep(0.05)                    # building the jobs
    with open(job_path, "rb") as f:
        jobs = pickle.load(f)
    results = {}
    for name, job in jobs.items():
        try:
            results[name] = JOBS[job["kind"]](job)
        except Exception:  # noqa: BLE001 — reported to the test
            results[name] = {"error": traceback.format_exc()[-3000:]}
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


def main():
    job_path, out_path, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
    store = os.path.join(tempfile.mkdtemp(), "store")
    torch.multiprocessing.spawn(_rank, args=(n, job_path, out_path, store),
                                nprocs=n)


if __name__ == "__main__":
    main()
