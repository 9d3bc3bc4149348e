"""Multi-pod dry run: every (arch x shape x mesh) cell, per rank, with no
device memory.

Port of ``repro/launch/dryrun.py``. The reference lowers and compiles each
cell for the production meshes (16 x 16 and 2 x 16 x 16) on 512 forced
host devices and reads XLA's memory and cost analyses and the collectives
of the optimized HLO. The port has no compiler to ask. For each cell it
writes the reference's record fields from what it can know:

  * ``memory``: the per-rank bytes of the parameters, the optimizer state
    (or the packed adapter and its moments), the caches and the batch,
    from the sharding specs (``launch.sharding``) and each leaf's dtype;
  * ``cost`` (``analysis.profile.program_cost``) and ``collectives``
    (``analysis.profile.collective_bytes``'s record): from running rank
    0's step on the "meta" device over the abstract mesh, where its
    collectives communicate nothing and are counted at the ring model:
    every cell, whether its cache (if any) is sharded by KV heads, by
    latent columns or by sequence. No cell is skipped silently.
  * ``lower_s``: seconds to build the step and its abstract inputs;
    ``compile_s``: seconds of the meta run (0 where it did not run);
  * ``cost_xla_raw``: always null. The reference's is XLA's own aggregate
    count; the port has no compiler whose count it could stand for.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both [--adapter shira] [--variant padded] \\
      [--out build/dryrun/dryrun.json]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any, Dict

import torch

from repro_torch.analysis.profile import collective_summary, program_cost
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, AdapterConfig, TrainConfig
from repro_torch.configs.registry import ARCH_IDS, applicable_shapes
from repro_torch.core.masks import iter_leaves, map_leaves
from repro_torch.kernels.counting import on_meta
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps as S

DEFAULT_OUT = "build/dryrun/dryrun.json"

# The reference's optimized per-arch variants: head-group padding and
# kv-repeat, so attention shards over 16-way TP instead of replicating.
VARIANTS = {
    "padded": {
        "deepseek-coder-33b": dict(pad_heads_to=64, attn_repeat_kv=True),
        "starcoder2-7b": dict(pad_heads_to=48, attn_repeat_kv=True),
        "qwen1.5-32b": dict(pad_heads_to=48, pad_kv_to=48),
        "paligemma-3b": dict(pad_heads_to=16, attn_repeat_kv=True),
        "granite-34b": dict(attn_repeat_kv=True),
        "granite-moe-1b-a400m": dict(attn_repeat_kv=True),
    },
}


def _bytes(tree, spec_tree, mesh) -> int:
    """Per-rank bytes of a tree of (global) tensors under its specs."""
    specs = dict(iter_leaves(spec_tree))
    total = 0
    for p, t in iter_leaves(tree):
        shape = shd.local_shape(tuple(t.shape), specs[p], mesh)
        total += math.prod(shape) * t.element_size()
    return int(total)


def _memory(**parts: int) -> Dict[str, Any]:
    out = {f"{k}_bytes": int(v) for k, v in parts.items()}
    total = sum(parts.values())
    out["total_bytes"] = int(total)
    out["per_rank_gb"] = total / 1e9
    return out


def _run(step, args):
    """Run rank 0's step once on "meta" tensors: (cost, collectives,
    seconds)."""
    t0 = time.time()
    with M.record() as events, on_meta():
        cost = program_cost(step, *args)
    return cost, collective_summary(events), time.time() - t0


def lower_cell(arch: str, shape_name: str, mesh, *, adapter: str = "none",
               variant: str = "none", extra_tags: str = "",
               cfg=None) -> Dict[str, Any]:
    """One cell's record (``cfg`` overrides the registry's, for tests at
    smoke size)."""
    cfg = cfg or get_config(arch)
    if variant != "none":
        cfg = cfg.replace(**VARIANTS[variant].get(arch, {}))
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    t0 = time.time()
    loc = lambda tree, specs: S.local_meta(tree, specs, mesh)
    if shape.kind == "train":
        tcfg = TrainConfig()
        state_spec, bspec = S.train_shardings(cfg, shape, mesh)
        batch = S.abstract_batch(cfg, shape)
        pspecs = state_spec["trainable"]
        params = S.abstract_params(cfg)
        pbytes = _bytes(params, pspecs, mesh)
        bbytes = _bytes(batch, bspec, mesh)
        if adapter == "shira":
            acfg = AdapterConfig(kind="shira", mask="rand", sparsity=0.99)
            values, idx, _, vspecs = S.abstract_shira_sharded(cfg, acfg,
                                                              mesh)
            vtree = {p: v for p, v in iter_leaves(values)}
            vb = _bytes(vtree, vspecs, mesh)
            # the adapter: f32 values and their int32 indices
            memory = _memory(params=pbytes, adapter=2 * vb,
                             opt_state=2 * vb, batch=bbytes)
            make = lambda: (
                S.make_shira_train_step(cfg, tcfg, acfg, mesh, pspecs),
                (_state(loc(values, _vspec_tree(values, vspecs))),
                 loc(batch, bspec), loc(params, pspecs),
                 loc(idx, _vspec_tree(idx, vspecs))))
        else:
            memory = _memory(params=pbytes, opt_state=2 * pbytes,
                             batch=bbytes)
            make = lambda: (S.make_train_step(cfg, tcfg, mesh, pspecs),
                            (_state(loc(params, pspecs)),
                             loc(batch, bspec)))
    else:
        scfg = cfg.replace(fsdp=False)
        params = S.abstract_params(scfg, dtype=torch.bfloat16)
        pspecs = S.serve_param_shardings(cfg, mesh)
        pbytes = _bytes(params, pspecs, mesh)
        if shape.kind == "prefill":
            batch = S.abstract_batch(cfg, shape, with_labels=False)
            _, bspec = S.train_shardings(cfg, shape, mesh)
            bspec = {k: v for k, v in bspec.items() if k in batch}
            bbytes = _bytes(batch, bspec, mesh)
            cbytes = 0
            if not cfg.encoder_only:
                cache = S.abstract_cache(cfg, shape.global_batch,
                                         shape.seq_len)
                cspec = shd.sanitize_tree(shd.cache_specs(cfg, shape, mesh),
                                          cache, mesh)
                cbytes = _bytes(cache, cspec, mesh)
            memory = _memory(params=pbytes, cache=cbytes, batch=bbytes)
            if cfg.encoder_only:
                make = lambda: (S.make_encode_step(cfg, mesh, shape),
                                (loc(params, pspecs), loc(batch, bspec)))
            else:
                make = lambda: (
                    S.make_prefill_step(cfg, shape.seq_len, mesh, shape),
                    (loc(params, pspecs), loc(batch, bspec)))
        else:
            _, cspec, tspec = S.decode_shardings(cfg, shape, mesh)
            cache = S.abstract_cache(cfg, shape.global_batch, shape.seq_len)
            tokens = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                                 device="meta")
            cbytes = _bytes(cache, cspec, mesh)
            memory = _memory(params=pbytes, cache=cbytes,
                             batch=_bytes({"t": tokens}, {"t": tspec}, mesh))
            make = lambda: (S.make_decode_step(cfg, mesh, shape),
                            (loc(params, pspecs), loc(cache, cspec),
                             loc(tokens, tspec), shape.seq_len - 1))
    rec = {"arch": arch, "shape": shape.name,
           "mesh": list(mesh.devices_shape), "axes": list(mesh.axis_names),
           "kind": shape.kind, "adapter": adapter, "variant": variant,
           "tags": extra_tags, "memory": memory, "cost": None,
           "cost_xla_raw": None, "collectives": None, "ok": True}
    step, args = make()
    rec["lower_s"] = round(time.time() - t0, 1)
    cost, coll, secs = _run(step, args)
    rec.update(cost=cost, collectives=coll, compile_s=round(secs, 1))
    return rec


def _state(trainable):
    """A train state of "meta" leaves: the moments shaped as the
    trainable tree."""
    like = lambda: map_leaves(lambda _, t: torch.empty_like(t), trainable)
    return {"trainable": trainable, "step": 0, "mu": like(), "nu": like()}


def _vspec_tree(tree, vspecs):
    """The value specs laid out as ``tree`` (None where it has None)."""
    return map_leaves(lambda p, _: vspecs[p], tree)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--adapter", default="none", choices=["none", "shira"])
    ap.add_argument("--variant", default="none", choices=["none", "padded"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], tuple(r["mesh"]),
             r.get("adapter", "none"), r.get("variant", "none"))
            for r in results if r.get("ok")}
    for multi in meshes:
        mesh = M.make_production_mesh(multi_pod=multi)
        for arch in archs:
            app = [s.name for s in applicable_shapes(arch)]
            shapes = app if args.shape == "all" else args.shape.split(",")
            for shape_name in shapes:
                if shape_name not in app:
                    print(f"[dryrun] SKIP {arch} x {shape_name} "
                          "(inapplicable)")
                    continue
                key = (arch, shape_name, mesh.devices_shape, args.adapter,
                       args.variant)
                if key in done:
                    print(f"[dryrun] cached {key}")
                    continue
                print(f"[dryrun] {arch} x {shape_name} x mesh"
                      f"{mesh.devices_shape} adapter={args.adapter} ...",
                      flush=True)
                try:
                    rec = lower_cell(arch, shape_name, mesh,
                                     adapter=args.adapter,
                                     variant=args.variant)
                    gb = rec["memory"]["per_rank_gb"]
                    print(f"[dryrun]   ok: {gb:.2f} GB/rank "
                          f"flops={rec['cost']['flops']:.3e} "
                          f"coll={rec['collectives']['total_gb']:.2f}GB "
                          f"run={rec['compile_s']}s", flush=True)
                except Exception as e:  # noqa: BLE001 — record and go on
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": list(mesh.devices_shape),
                           "adapter": args.adapter, "ok": False,
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    print(f"[dryrun]   FAIL {type(e).__name__}: {e}",
                          flush=True)
                results.append(rec)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results if r.get("ok"))
    print(f"[dryrun] {n_ok}/{len(results)} cells OK -> {args.out}")


if __name__ == "__main__":
    main()
