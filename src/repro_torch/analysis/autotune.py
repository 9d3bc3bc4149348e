"""Measured-time path autotuning for the sidedelta kernel.

The port's counterpart of ``repro/analysis/autotune.py``. The reference
tunes the Pallas kernel's VMEM tile plan (bm, kc); the port's tunable
plan is the path ``kernels/sidedelta.py::kernel_path`` picks for a call:
"rows" (a table walk per row) or "tokens" (token-minor, a table walk per
adapter and tile of 128 tokens), by the static rule ``ROWS_BELOW``, a
crossover measured at one leaf width. This module closes the loop: for
each call class (B, S, n, m, K, x itemsize) it times both paths through
the real ``_sidedelta`` dispatch on the card and persists the winners in
a JSON plan cache that ``kernel_path`` consults before its static rule
(``sidedelta.install_plan_cache``; invalid entries are rejected at
lookup, so a stale cache degrades to the rule instead of a broken
launch). Nothing installs a cache by default.

Typical flow (also what ``python -m repro_torch.analysis.autotune`` runs,
on the card)::

    from repro_torch.analysis import autotune
    with autotune.observe():
        ...                                  # a serving warmup
    shapes = autotune.observed_shapes()     # classes kernel_path saw
    plans = autotune.autotune(shapes)       # sweep + measure
    autotune.save_cache(plans, "build/plan_cache.json")
    autotune.install(plans)                 # live in this process

    # later processes:
    autotune.install(autotune.load_cache("build/plan_cache.json"))

Classes are discovered, not guessed: ``observe()`` wraps a workload and
records every distinct class ``kernel_path`` is asked for under it, on
the CPU too (the wrapper asks before it takes its plain version). Timing
runs only on the card: a plain version's time says nothing of a path.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence

import torch

# the kernels package re-exports a function named ``sidedelta``: resolve
# the module itself
SD = importlib.import_module("repro_torch.kernels.sidedelta")

PlanKey = SD.PlanKey
Plan = str


# ---------------------------------------------------------------------------
# Class discovery
# ---------------------------------------------------------------------------

_observed: "dict[PlanKey, int]" = {}


@contextlib.contextmanager
def observe():
    """Record every class (B, S, n, m, K, x itemsize) ``kernel_path`` is
    asked to plan while the context is open (run a serving warmup
    inside)."""
    orig = SD.kernel_path

    def recording(B, S, n=None, m=None, K=None, x_itemsize=2):
        if n is not None:
            key = SD.plan_cache_key(B, S, n, m, K, x_itemsize)
            _observed[key] = _observed.get(key, 0) + 1
        return orig(B, S, n, m, K, x_itemsize)

    SD.kernel_path = recording
    try:
        yield
    finally:
        SD.kernel_path = orig


def observed_shapes() -> List[PlanKey]:
    """Classes seen under ``observe()``, most-requested first."""
    return sorted(_observed, key=lambda k: -_observed[k])


def clear_observed() -> None:
    _observed.clear()


# ---------------------------------------------------------------------------
# Candidates and measurement
# ---------------------------------------------------------------------------

def candidates(key: PlanKey) -> List[Plan]:
    """The paths valid at one class, the static rule's first."""
    static = SD.static_path(*key[:2])
    return [p for p in (static, *(q for q in SD.PATHS if q != static))
            if SD.plan_is_valid(key, p)]


def class_inputs(key: PlanKey, *, adapters: int = 3, seed: int = 0,
                 device="cuda"):
    """Seeded operands of one class: x (B, S, n) of the key's itemsize
    (f32 or bf16), ``adapters`` tables of K valid entries each (rows
    int32, f32 values, columns sorted into colptr), every request on an
    adapter."""
    B, S, n, m, K, isize = key
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt = {4: torch.float32, 2: torch.bfloat16}[isize]
    x = torch.randn((B, S, n), generator=gen, device=device).to(dt)
    rows = torch.randint(0, n, (adapters, K), generator=gen, device=device,
                         dtype=torch.int32)
    cols = torch.randint(0, m, (adapters, K), generator=gen,
                         device=device).sort(1).values
    colptr = torch.searchsorted(cols, torch.arange(
        m + 1, device=device).expand(adapters, m + 1).contiguous()
    ).to(torch.int32)
    vals = 0.01 * torch.randn((adapters, K), generator=gen, device=device)
    ids = (torch.arange(B, device=device) % adapters).to(torch.int32)
    return x, rows, vals, colptr, ids


@contextlib.contextmanager
def forced(key: PlanKey, plan: Plan):
    """``kernel_path`` answers ``plan`` for ``key`` within; the cache and
    its counters are restored after."""
    saved, stats = SD.plan_cache(), dict(SD.plan_cache_stats)
    SD.install_plan_cache({key: plan})
    try:
        yield
    finally:
        SD.install_plan_cache(saved, replace=True)
        SD.plan_cache_stats.update(stats)


def run_plan(key: PlanKey, plan: Plan, inputs) -> torch.Tensor:
    """One ``_sidedelta`` dispatch of ``inputs`` through ``plan``."""
    with forced(key, plan):
        return SD._sidedelta(*inputs)


def measure_plan(key: PlanKey, plan: Plan, *, adapters: int = 3,
                 reps: int = 3, seed: int = 0, device="cuda",
                 inputs=None) -> float:
    """Best-of-``reps`` seconds (CUDA events) of one ``_sidedelta``
    dispatch at this class through ``plan``, after one warm-up call.
    Raises off the card: on CPU tensors the wrapper runs its plain
    version, whose time says nothing of a path."""
    if torch.device(device).type != "cuda":
        raise RuntimeError(f"measure_plan times the kernel on a CUDA device,"
                           f" not {device}")
    inputs = inputs or class_inputs(key, adapters=adapters, seed=seed,
                                    device=device)
    run_plan(key, plan, inputs)                  # warm-up
    best = float("inf")
    with forced(key, plan):
        for _ in range(max(reps, 1)):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            SD._sidedelta(*inputs)
            e.record()
            e.synchronize()
            best = min(best, s.elapsed_time(e) / 1e3)
    return best


def autotune(shapes: Iterable[PlanKey], *, reps: int = 3,
             adapters: int = 3, device="cuda", verbose: bool = False,
             results: Optional[dict] = None) -> Dict[PlanKey, Plan]:
    """Time every candidate path of each class and return the faster one
    per class; ``results``, when given, receives ``{key: {path:
    seconds}}``. Every swept class gets an entry: a hit that repeats the
    static rule still skips it."""
    plans: Dict[PlanKey, Plan] = {}
    for key in shapes:
        inputs = class_inputs(key, adapters=adapters, device=device)
        times = {p: measure_plan(key, p, reps=reps, device=device,
                                 inputs=inputs) for p in candidates(key)}
        if verbose:
            B, S, n, m, K, isize = key
            print("  (B={},S={},n={},m={},K={},x {} B) ".format(
                B, S, n, m, K, isize) + ", ".join(
                    f"{p} {t * 1e3:.4f} ms" for p, t in times.items()),
                flush=True)
        if results is not None:
            results[key] = times
        if times:
            plans[key] = min(times, key=times.get)
    return plans


# ---------------------------------------------------------------------------
# Persistence + installation
# ---------------------------------------------------------------------------

def save_cache(plans: Dict[PlanKey, Plan], path: str,
               meta: Optional[dict] = None) -> str:
    """JSON plan cache: ``{"B,S,n,m,K,itemsize": "rows" | "tokens"}``."""
    body = {",".join(str(x) for x in key): str(plan)
            for key, plan in sorted(plans.items())}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"schema": 1, "meta": dict(meta or {}), "plans": body},
                  f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def load_cache(path: str) -> Dict[PlanKey, Plan]:
    with open(path) as f:
        doc = json.load(f)
    plans: Dict[PlanKey, Plan] = {}
    for key, plan in doc.get("plans", {}).items():
        parts = tuple(int(x) for x in key.split(","))
        if len(parts) == 6 and isinstance(plan, str):
            plans[parts] = plan
    return plans


def install(plans: Dict[PlanKey, Plan], replace: bool = False) -> int:
    """Make ``kernel_path`` consult these plans (process-wide)."""
    return SD.install_plan_cache(plans, replace=replace)


def maybe_install_file(path: str) -> int:
    """Install a plan-cache file if it exists; returns entries installed
    (0 when the file is absent — callers need no existence check)."""
    if not os.path.exists(path):
        return 0
    return install(load_cache(path))


# ---------------------------------------------------------------------------
# CLI: observe a smoke serving workload, sweep, persist.
# ---------------------------------------------------------------------------

def _collect_smoke_shapes(arch: str, batch: int, prompt_len: int,
                          tokens: int, adapters: int,
                          device) -> List[PlanKey]:
    """Run small multi-tenant and paged-engine workloads under
    ``observe()``, so the swept classes are what serving plans: the
    multi-tenant engine's prefill and decode, and the paged engine's
    prefill chunks and decode steps over its lanes."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.hub import PagedServingEngine
    from repro_torch.launch.serve import make_adapters
    from repro_torch.models import lm
    from repro_torch.serving import MultiTenantEngine

    cfg = get_smoke_config(arch)
    clear_observed()
    params = lm.init_params(cfg, seed=0, device=device)
    packs = make_adapters(cfg, params, adapters, multi_tenant=True)
    engine = MultiTenantEngine(cfg, params)
    for p in packs:
        engine.register(p)
    names = [packs[i % adapters].name for i in range(batch)]
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=gen, device=device)
    with observe():
        engine.generate({"tokens": toks}, names, tokens)
    engine.close()

    pe = PagedServingEngine(cfg, params, slots=4, num_pages=64, page_size=2,
                            max_len=prompt_len + tokens + 2, chunk_size=4)
    for p in packs:
        pe.register(p)
    rng = np.random.default_rng(0)
    with observe():
        for i in range(batch):
            pe.submit(rng.integers(0, cfg.vocab_size, prompt_len),
                      packs[i % adapters].name, max_tokens=tokens)
        pe.run()
    pe.shutdown()
    return observed_shapes()


def full_width_classes(arch: str = "starcoder2-7b", x_itemsize: int = 2
                       ) -> List[PlanKey]:
    """The multi-tenant serving classes of an arch's MLP leaves at full
    width, w_up (d, f) and w_down (f, d), tables at sparsity 0.98: the
    serving batch of 8 at S = 1 (decode), 16 (a prompt) and 256 (a
    chunk), and one request at S = 4..32, around the static rule's
    crossover."""
    from repro_torch.configs import get_config
    from repro_torch.core.masks import budget
    cfg = get_config(arch)
    d, f = cfg.d_model, cfg.d_ff
    calls = [(8, s) for s in (1, 16, 256)] + [(1, s) for s in (4, 8, 16, 32)]
    return [SD.plan_cache_key(B, S, n, m, budget(n, m, 0.98), x_itemsize)
            for n, m in ((d, f), (f, d)) for B, S in calls]


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Autotune sidedelta's path (rows or tokens) for the "
        "smoke serving classes and an arch's full-width ones, on the card, "
        "and write the plan cache JSON.")
    ap.add_argument("--arch", default="starcoder2-7b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=4)
    ap.add_argument("--adapters", type=int, default=3)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shape", action="append", default=[],
                    metavar="B,S,n,m,K", help="extra class to sweep, bf16 x "
                    "(repeatable; replaces the full-width extras)")
    ap.add_argument("--out", default="build/plan_cache.json")
    args = ap.parse_args(argv)

    shapes = _collect_smoke_shapes(args.arch, args.batch, args.prompt_len,
                                   args.tokens, args.adapters, args.device)
    extras = ([SD.plan_cache_key(*(int(x) for x in s.split(",")))
               for s in args.shape] if args.shape
              else full_width_classes(args.arch))
    for key in extras:
        if key not in shapes:
            shapes.append(key)
    print(f"observed {len(shapes)} classes (incl. {len(extras)} "
          f"full-width extras); sweeping...", flush=True)
    plans = autotune(shapes, reps=args.reps, adapters=args.adapters,
                     device=args.device, verbose=True)
    changed = sum(p != SD.static_path(*k[:2]) for k, p in plans.items())
    path = save_cache(plans, args.out,
                      meta={"arch": args.arch, "source": "autotune CLI",
                            "device": torch.cuda.get_device_name(0),
                            "changed_vs_static": changed})
    print(f"wrote {path}: {len(plans)} plans ({changed} differ from the "
          f"static rule)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
