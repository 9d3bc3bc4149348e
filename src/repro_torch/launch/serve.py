"""Serving entry point: batched greedy decode with SHiRA adapters.

Port of ``repro/launch/serve.py``. Four modes:
  (default)       swap adapters BETWEEN batches through the sparse scatter
                  (``SwitchEngine``): base weights patched in place
  --fuse          serve with all adapters fused by naive addition
  --multi-tenant  every request names its own adapter and all decode
                  together off one shared base (``MultiTenantEngine``):
                  per-request sparse side deltas, with a ``FusedLRU``
                  fusing the hot adapter into the base; ``--int8`` keeps
                  the side-delta tables int8
  --continuous    request-level serving (``hub.ServingEngine``): a seeded
                  trace of ``--requests`` requests, one adapter each, is
                  submitted at once and decoded over ``--slots`` lanes with
                  continuous batching, the adapters loaded lazily from an
                  ``AdapterStore`` of .shpk files in a temporary directory;
                  ``--int8`` stores int8 packs and serves int8 tables
A vision model's batches carry zero patch embeddings before their
prompts, as the reference's; an encoder-only model (hubert-xlarge) has no
decode path, and ``main`` exits with the reference's message before
building anything (serve it through ``lm.encode``).
Sequential and ``--fuse`` packs cover every default target; those of the
multi-tenant and continuous modes leave out MLA's ``w_uk``/``w_uv``
(``make_adapters``), which side deltas cannot serve.
Runs on the card unless ``--device cpu`` is given; ``--layers`` cuts the
model's depth (a port-only option, as ``launch.train``'s: the dense 32B
configs fit one card only so). ``main`` returns the run's numbers as a
dict, so scripts can drive it as a user would.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-7b \
      --multi-tenant --adapters 3 --tokens 16 --batch 8 --batches 4
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import AdapterConfig, get_config, get_smoke_config
from repro_torch.core import (FusedLRU, SwitchEngine, init_adapter,
                              pack_from_shira)
from repro_torch.core.masks import map_leaves
from repro_torch.models import lm
from repro_torch.serving.multitenant import (UNSUPPORTED_LEAVES,
                                             MultiTenantEngine,
                                             greedy_decode,
                                             serving_cache_size)


def make_adapters(cfg, params, n: int, seed: int = 7,
                  multi_tenant: bool = False) -> list:
    """n random SHiRA packs (stand-ins for independently trained adapters):
    ``rand`` masks at sparsity 0.98 over the default targets, values
    0.01 * N(0, 1). ``multi_tenant`` leaves out the leaves a side delta
    cannot serve (``multitenant.UNSUPPORTED_LEAVES``: MLA's ``w_uk`` and
    ``w_uv``), as the reference's does; no other ported arch has them, so
    there the packs are the same either way."""
    device = next(iter(params["embed"].values())).device
    targets = AdapterConfig().target_modules
    if multi_tenant:
        targets = tuple(t for t in targets if t not in UNSUPPORTED_LEAVES)
    acfg = AdapterConfig(kind="shira", mask="rand", sparsity=0.98,
                         target_modules=targets)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    packs = []
    for i in range(n):
        values, aux = init_adapter(gen, params, acfg)
        values = map_leaves(
            lambda _, v: 0.01 * torch.randn(v.shape, generator=gen,
                                            device=device), values)
        packs.append(pack_from_shira(f"adapter_{i}", values, aux))
    return packs


def tenant_mix(rng, packs, batch: int, skew: float) -> list:
    """Per-request adapter names: ``skew`` of the batch goes to the first
    adapter, the rest spread over the others + the base model (None)."""
    pool = [p.name for p in packs[1:]] + [None]
    return [packs[0].name if rng.random() < skew
            else pool[rng.integers(len(pool))] for _ in range(batch)]


def _prompts(cfg, batch: int, prompt_len: int, seed: int, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=gen, device=device)


def _batch(cfg, batch: int, prompt_len: int, seed: int, device) -> dict:
    """A serve batch: the prompts, and a vision model's zero patch
    embeddings (B, num_prefix_embeds, d_model), as the reference's."""
    out = {"tokens": _prompts(cfg, batch, prompt_len, seed, device)}
    if cfg.prefix_rows:
        out["patch_embeds"] = torch.zeros(
            (batch, cfg.prefix_rows, cfg.d_model), device=device)
    return out


def serve_multi_tenant(cfg, params, packs, args) -> dict:
    engine = MultiTenantEngine(cfg, params, scheduler=FusedLRU(),
                               table_dtype="int8" if args.int8 else "f32")
    for p in packs:
        engine.register(p)
    rng = np.random.default_rng(0)
    B = args.batch
    total, t_total, table_bytes = 0, 0.0, 0
    for step in range(args.batches):
        names = tenant_mix(rng, packs, B, args.skew)
        batch = _batch(cfg, B, args.prompt_len, 1 + step, args.device)
        out, dt = engine.generate(batch, names, args.tokens)
        table_bytes = max(table_bytes, engine.table_nbytes()["total"])
        total += B * args.tokens
        t_total += dt
        mix = {n or "base": names.count(n) for n in dict.fromkeys(names)}
        print(f"[serve-mt] batch {step}: {mix} fused={engine.fused} "
              f"{B * args.tokens / dt:.1f} tok/s")
    print(f"[serve-mt] {total} tokens in {t_total*1e3:.0f}ms "
          f"({total / t_total:.1f} tok/s), "
          f"{engine.fuse_transitions} fused-state transitions")
    stats = {"tok_s": total / t_total, "last_out": out,
             "fuse_transitions": engine.fuse_transitions,
             "table_bytes": table_bytes}
    engine.close()
    return stats


def serve_continuous(cfg, params, packs, args) -> dict:
    """The ``--continuous`` mode. Returns the numbers it prints, the
    engine's ``health()`` and its store's retries, and every request's
    future and tokens."""
    import tempfile

    from repro_torch.hub import AdapterStore, ServingEngine
    with tempfile.TemporaryDirectory(prefix="adapter-store-") as root:
        store = AdapterStore(root)
        for p in packs:
            store.add(p, values="int8" if args.int8 else "f32")
        engine = ServingEngine(
            cfg, params, slots=args.slots or args.batch, store=store,
            table_dtype="int8" if args.int8 else "f32",
            cache_size=args.prompt_len + cfg.prefix_rows + args.tokens
            + 8)
        rng = np.random.default_rng(0)
        futs = []
        for r in range(args.requests):
            name = tenant_mix(rng, packs, 1, args.skew)[0]
            toks = _prompts(cfg, 1, args.prompt_len, 1 + r, args.device)
            futs.append(engine.submit(toks[0].cpu().numpy(), name,
                                      max_tokens=args.tokens))
        dt = engine.run()
        done = sum(f.done() for f in futs)
        print(f"[serve-cc] {done}/{len(futs)} requests, {engine.tokens_out} "
              f"tokens in {dt*1e3:.0f}ms ({engine.tokens_out/dt:.1f} tok/s), "
              f"{engine.step_count} decode steps, idle-lane steps "
              f"{engine.decode_slot_waste}, store loads={store.loads} "
              f"resident={store.resident_bytes()/1e3:.1f}kB")
        return {"tok_s": engine.tokens_out / dt,
                "done": done, "requests": len(futs),
                "tokens_out": engine.tokens_out,
                "steps": engine.step_count,
                "idle_lane_steps": engine.decode_slot_waste,
                "store_loads": store.loads,
                "resident_bytes": store.resident_bytes(),
                "health": engine.health(), "store_retries": store.retries,
                "futs": futs, "outs": [f.result() for f in futs]}


def serve_switching(cfg, params, packs, args) -> dict:
    """The sequential (default) and ``--fuse`` modes."""
    engine = SwitchEngine(params)
    cache_size = serving_cache_size(cfg, args.prompt_len, args.tokens)
    B = args.batch
    stats = {"tok_s": {}, "switch_ms": []}

    def serve_batch(label):
        batch = _batch(cfg, B, args.prompt_len, 1, args.device)
        t0 = time.perf_counter()
        out, _ = greedy_decode(
            cfg, batch, args.tokens,
            lambda b: lm.prefill(engine.params, cfg, b, cache_size),
            lambda t, c, pos: lm.decode_step(engine.params, cfg, t, c, pos))
        dt = time.perf_counter() - t0
        stats["tok_s"][label] = B * args.tokens / dt
        stats["last_out"] = out
        print(f"[serve] {label}: {B}x{args.tokens} tokens in {dt*1e3:.0f}ms "
              f"({B * args.tokens / dt:.1f} tok/s)")

    serve_batch("base model")
    if args.fuse:
        st = engine.load_fused(packs)
        stats["switch_ms"].append(sum(s.seconds for s in st) * 1e3)
        print(f"[serve] fused {len(packs)} adapters: "
              f"{stats['switch_ms'][-1]:.1f}ms, "
              f"{sum(s.entries_written for s in st)} entries")
        serve_batch("multi-adapter fused")
    else:
        for pack in packs:
            st = engine.switch(pack)
            stats["switch_ms"].append(st.seconds * 1e3)
            print(f"[serve] switched to {pack.name}: {st.seconds*1e3:.1f}ms, "
                  f"{st.entries_written} entries "
                  f"({st.bytes_written/1e6:.2f}MB adapter vs "
                  f"{st.weight_bytes_total/1e6:.0f}MB weights)")
            serve_batch(pack.name)
    return stats


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="starcoder2-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--adapters", type=int, default=2)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--fuse", action="store_true",
                      help="serve with all adapters fused (multi-adapter)")
    mode.add_argument("--multi-tenant", action="store_true",
                      help="per-request adapters batched in one forward pass")
    mode.add_argument("--continuous", action="store_true",
                      help="request-level serving via hub.ServingEngine")
    ap.add_argument("--batches", type=int, default=4,
                    help="request batches to stream (multi-tenant)")
    ap.add_argument("--skew", type=float, default=0.5,
                    help="fraction of requests routed to adapter_0")
    ap.add_argument("--requests", type=int, default=12,
                    help="requests to stream (continuous)")
    ap.add_argument("--slots", type=int, default=0,
                    help="decode lanes (continuous; 0 = --batch)")
    ap.add_argument("--int8", action="store_true",
                    help="int8 adapters: quantized store packs (continuous) "
                    "and int8 side-delta tables (multi-tenant, continuous)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers (0: all)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    if args.int8 and not (args.multi_tenant or args.continuous):
        raise SystemExit("--int8 applies to --multi-tenant and --continuous")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.encoder_only:
        raise SystemExit("encoder-only archs have no decode serving path")
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    params = lm.init_params(cfg, seed=0, device=args.device)
    packs = make_adapters(cfg, params, args.adapters,
                          multi_tenant=args.multi_tenant or args.continuous)
    if args.continuous:
        return serve_continuous(cfg, params, packs, args)
    if args.multi_tenant:
        return serve_multi_tenant(cfg, params, packs, args)
    return serve_switching(cfg, params, packs, args)


if __name__ == "__main__":
    main()
