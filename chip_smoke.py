#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

  python3 chip_smoke.py        # from the repository root, one card

Phases, each fatal on failure (non-zero exit, no result line):
  1. device    the card's name and power limit (nvidia-smi)
  2. build     nvcc builds every kernel of csrc/, one process each, at once
  3. kernels   each kernel against its plain version on the card, at
               starcoder2-7b shapes; times (cold L2) beside the bound
  4. serve     starcoder2-7b at full width through repro_torch.launch.serve:
               sequential switching, --fuse, --multi-tenant (f32, int8);
               launch counts are zeroed before each mode and must be > 0
               for every kernel of that mode's path
  5. profile   device time by kernel of one full-width decode step, base
               model and multi-tenant (torch.profiler)
  6. consistency  full width, 2 layers, f32: multi-tenant tokens equal the
               switch-per-request reference, unfused and with a hot adapter
  7. summary   one JSON line of kernel numbers, the card line, and last
               {"ok": true, "device": {...}}
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOP_PER_S = 67e12         # H100 SXM f32 rate outside the tensor cores
SIDEDELTA_TOL = 1e-4           # f32 sums of ~400 products in another order
RESTORE_TOL = 1e-5             # the JAX package's load/unload tolerance
B, PROMPT, TOKENS = 8, 16, 16  # serving batch, prompt and generated tokens
IDS = [0, 1, 2, -1, 0, 1, 2, 0]


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cold_ms(torch, fn, iters: int, flush) -> float:
    """Mean device time of fn over ``iters`` launches, L2 flushed before
    each (a decode step streams other weights between two calls). The card
    spins ~1 ms before each start event, so the host has enqueued fn's
    launches by the time it is timed: host overhead is not counted unless
    fn waits for the device itself."""
    fn()
    events = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(2_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def rand_entries(torch, gen, nl, n, m, k):
    """nl rows of k unique ascending flat indices, as a rand mask's pack
    holds them, and their values."""
    idx = torch.stack([torch.randperm(n * m, generator=gen, device="cuda")[:k]
                       .sort().values for _ in range(nl)]).to(torch.int32)
    vals = 0.01 * torch.randn((nl, k), generator=gen, device="cuda")
    return idx, vals


def sidedelta_case(torch, gen, flush, label, n, m, S, int8, slots=None,
                   pad_to=0):
    """One sidedelta comparison at (n, m) on layer 0 of ``slots`` (three
    random single-layer adapters by default), its rows/vals padded with
    zeros to ``pad_to`` entries when given; returns its numbers."""
    import torch.nn.functional as F
    from repro_torch.core.masks import budget
    from repro_torch.kernels import ops
    from repro_torch.kernels.sidedelta import sidedelta, sidedelta_plain
    if slots is None:
        slots = [rand_entries(torch, gen, 1, n, m, budget(n, m, 0.98))
                 for _ in range(3)]
    nl = slots[0][0].shape[0]
    t = {k: v[0].contiguous() for k, v in ops.sidedelta_table(
        slots, nl, n, m, int8=int8).items()}
    for k in ("rows", "vals"):
        t[k] = F.pad(t[k], (0, max(pad_to - t[k].shape[-1], 0)))
    x = torch.randn((B, S, n), generator=gen, device="cuda").to(
        torch.bfloat16)
    ids = torch.tensor(IDS, dtype=torch.int32, device="cuda")
    args = (x, t["rows"], t["vals"], t["colptr"], ids, t.get("scale"))
    got = sidedelta(*args)
    want = sidedelta_plain(*args)
    err = float((got - want).abs().max())
    if not err <= SIDEDELTA_TOL:
        fail(f"sidedelta {label}: max_abs_err {err} > {SIDEDELTA_TOL}")
    ms = cold_ms(torch, lambda: sidedelta(*args), 20, flush)
    plain_ms = cold_ms(torch, lambda: sidedelta_plain(*args), 3, flush)
    # yardstick: one batched matmul against densified per-request dW
    valid = t["colptr"][:, -1].long()
    dense = torch.zeros((len(slots) + 1, n * m), device="cuda")
    for a in range(len(slots)):
        col = torch.repeat_interleave(
            torch.arange(m, device="cuda"),
            torch.diff(t["colptr"][a].long()))
        v = t["vals"][a, :valid[a]].float()
        if int8:
            v = v * t["scale"][a]
        dense[a].index_put_((t["rows"][a, :valid[a]].long() * m + col,), v,
                            accumulate=True)
    per_req = dense.reshape(-1, n, m)[torch.tensor(
        [a if a >= 0 else len(slots) for a in IDS], device="cuda")]
    xf = x.float()
    library_ms = cold_ms(torch, lambda: torch.bmm(xf, per_req), 5, flush)
    del dense, per_req
    used = sorted({a for a in IDS if a >= 0})
    entry_bytes = t["rows"].element_size() + t["vals"].element_size()
    table_bytes = sum(int(valid[a]) * entry_bytes + (m + 1) * 4 +
                      (4 if int8 else 0) for a in used)
    nbytes = x.numel() * 2 + ids.numel() * 4 + table_bytes + B * S * m * 4
    flops = sum(2 * S * int(valid[a]) for a in IDS if a >= 0)
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    r = {"label": label, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "library_ms": library_ms, "bound_ms": max(b_ms, o_ms),
         "bound_by": "bytes" if b_ms >= o_ms else "operations",
         "K": [int(valid[a]) for a in range(len(slots))]}
    print(f"[kernels] sidedelta {label} ({n}x{m}) K={r['K']} S={S} "
          f"{'int8/int16' if int8 else 'f32/int32'}: max_abs_err={err:.3g} "
          f"(tol {SIDEDELTA_TOL}) ms={ms:.4f} plain_ms={plain_ms:.3f} "
          f"library_ms(bmm, dense dW)={library_ms:.3f} "
          f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    return r


def kernels_phase(torch, flush):
    from repro_torch.core.adapters import AdapterPack
    from repro_torch.core.masks import budget
    from repro_torch.core.fusion import fuse_packs
    from repro_torch.kernels.scatter_apply import (scatter_apply,
                                                   scatter_apply_plain)
    d, f = 4608, 18432
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    side = []
    for n, m, name in ((d, f, "w_up"), (d, d, "wq"), (d, 512, "wk"),
                       (f, d, "w_down")):
        for S in (1, PROMPT):
            for int8 in (False, True):
                side.append(sidedelta_case(torch, gen, flush, name, n, m,
                                           S, int8))
    # the fused state of two stacked w_up layers, as MultiTenantEngine
    # builds it with adapter_0 hot: diff packs (whose shorter layer is
    # padded with index 0, value 0) and slot padding past each valid count
    k = budget(d, f, 0.98)
    packs = [AdapterPack(f"a{i}", {"w": rand_entries(torch, gen, 2, d, f, k)})
             for i in range(3)]
    fused = [fuse_packs([packs[1], packs[0]], [1.0, -1.0]),
             fuse_packs([packs[2], packs[0]], [1.0, -1.0]),
             fuse_packs([packs[0]], [-1.0])]
    slots = [p.entries["w"] for p in fused]
    pad = max(s[0].shape[-1] for s in slots)
    for S in (1, PROMPT):
        tight = sidedelta_case(torch, gen, flush, "w_up fused state", d,
                               f, S, False, slots=slots)
        padded = sidedelta_case(torch, gen, flush,
                                "w_up fused state, padded x2", d, f, S,
                                False, slots=slots, pad_to=2 * pad)
        again = sidedelta_case(torch, gen, flush, "w_up fused state", d,
                               f, S, False, slots=slots)
        ref_ms = (tight["ms"] + again["ms"]) / 2
        if padded["ms"] > 1.25 * ref_ms + 0.01:
            fail(f"padding is walked: padded {padded['ms']:.4f} ms vs "
                 f"{ref_ms:.4f} ms unpadded (S={S})")
        side += [tight, padded, again]

    # scatter_apply on a fused pack of two w_up layers, padded as fuse_packs
    # pads a shorter layer (index 0, value 0), 4096 more entries a layer:
    # the kernel must equal the plain version bit for bit on the whole leaf
    import torch.nn.functional as F
    w2 = torch.randn((2, d, f), generator=gen, device="cuda")
    fi, fv = (F.pad(t, (0, 4096)) for t in fused[0].entries["w"])
    want = scatter_apply_plain(w2.clone(), fi, fv, 1.0)
    scatter_apply(w2, fi, fv, 1.0)
    pad_err = float((w2 - want).abs().max())
    print(f"[kernels] scatter_apply fused pack (2, {d}, {f}) K={fi.shape[-1]}"
          f" padded entries {int((fv == 0).sum())}: max_abs_err={pad_err}",
          flush=True)
    if pad_err != 0.0:
        fail("scatter_apply disagrees with its plain version on a padded "
             "fused pack")
    del packs, fused, slots, w2, want, fi, fv

    # scatter_apply on a stacked (32, 4608, 18432) leaf: load, unload
    L = 32
    w = torch.randn((L, d, f), generator=gen, device="cuda")
    idx, vals = rand_entries(torch, gen, L, d, f, k)
    gi = (torch.arange(L, device="cuda")[:, None] * (d * f)
          + idx.long()).reshape(-1)
    before = w.view(-1)[gi].clone()
    probe = torch.randint(0, w.numel(), (1 << 20,), generator=gen,
                          device="cuda")
    probe = probe[~torch.isin(probe, gi)]          # entries no pack touches
    probe_before = w.view(-1)[probe].clone()
    scatter_apply(w, idx, vals, 1.0)
    want = scatter_apply_plain(before.clone()[None], torch.arange(
        gi.numel(), dtype=torch.int32, device="cuda"), vals.reshape(-1),
        1.0)[0]
    load_err = float((w.view(-1)[gi] - want).abs().max())
    scatter_apply(w, idx, vals, -1.0)
    restore_err = float((w.view(-1)[gi] - before).abs().max())
    untouched = bool(torch.equal(w.view(-1)[probe], probe_before))
    print(f"[kernels] scatter_apply ({L}, {d}, {f}) K={gi.numel()}: load "
          f"err={load_err} restore err={restore_err:.3g} (tol {RESTORE_TOL})"
          f" untouched entries equal: {untouched}", flush=True)
    if load_err != 0.0 or not restore_err <= RESTORE_TOL or not untouched:
        fail("scatter_apply disagrees with its plain version")
    sign = [1.0]

    def flip(fn):
        def go():
            fn(sign[0])
            sign[0] = -sign[0]
        return go
    ms = cold_ms(torch, flip(lambda a: scatter_apply(w, idx, vals, a)), 10,
                 flush)
    plain_ms = cold_ms(torch, flip(
        lambda a: scatter_apply_plain(w, idx, vals, a)), 4, flush)
    upd = {1.0: vals.reshape(-1).clone(), -1.0: -vals.reshape(-1)}
    library_ms = cold_ms(torch, flip(lambda a: w.view(-1).index_put_(
        (gi,), upd[a], accumulate=True)), 4, flush)
    nbytes = gi.numel() * (4 + 4 + 4 + 4)   # index, value, W read + write
    scat = {"max_abs_err": max(load_err, restore_err), "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    print(f"[kernels] scatter_apply ms={ms:.4f} plain_ms(index_add_)="
          f"{plain_ms:.4f} library_ms(index_put_ accumulate)="
          f"{library_ms:.4f} bound_ms={scat['bound_ms']:.4f} (bytes)",
          flush=True)
    del w, idx, vals, gi, before, probe, probe_before, upd
    return side, scat


def serve_phase(torch):
    from repro_torch.kernels.scatter_apply import scatter_apply
    from repro_torch.kernels.sidedelta import sidedelta
    from repro_torch.launch import serve
    common = ["--arch", "starcoder2-7b", "--batch", str(B), "--prompt-len",
              str(PROMPT), "--tokens", str(TOKENS), "--adapters", "3"]
    modes = [("sequential", [], ("scatter_apply",)),
             ("fuse", ["--fuse"], ("scatter_apply",)),
             ("multi-tenant f32", ["--multi-tenant", "--skew", "0.8"],
              ("sidedelta", "scatter_apply")),
             ("multi-tenant int8", ["--multi-tenant", "--int8", "--skew",
                                    "0.8"], ("sidedelta", "scatter_apply"))]
    totals = {"sidedelta": 0, "scatter_apply": 0}
    torch.cuda.reset_peak_memory_stats()
    for label, extra, needed in modes:
        sidedelta.launches = scatter_apply.launches = 0
        t0 = time.perf_counter()
        stats = serve.main(common + extra)
        torch.cuda.synchronize()
        counts = {"sidedelta": sidedelta.launches,
                  "scatter_apply": scatter_apply.launches}
        out = stats["last_out"]
        ok = (out.shape == (B, TOKENS) and int(out.min()) >= 0
              and int(out.max()) < 49152)
        if "table_bytes" in stats:
            extra_info = (f"tables {stats['table_bytes'] / 1e9:.2f} GB, "
                          f"{stats['tok_s']:.1f} tok/s, "
                          f"{stats['fuse_transitions']} fuse transitions")
        else:
            tok_s = {k: round(v, 1) for k, v in stats["tok_s"].items()}
            extra_info = (f"switch ms "
                          f"{[round(x, 3) for x in stats['switch_ms']]}, "
                          f"tok/s {tok_s}")
        print(f"[serve] {label}: launches {counts}, {extra_info}, "
              f"{time.perf_counter() - t0:.1f}s wall", flush=True)
        if not ok:
            fail(f"serve {label}: tokens out of range or misshapen")
        for k in needed:
            if counts[k] <= 0:
                fail(f"serve {label}: kernel {k} was never launched")
            totals[k] += counts[k]
        del stats, out                 # the next mode builds its own model
        torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[serve] peak memory {peak:.1f} GB (max_memory_allocated)",
          flush=True)
    return totals


def profile_phase(torch):
    """Where a full-width decode step (B=8) spends its device time: the
    base model, and multi-tenant with every request on an adapter or the
    base. Device time per kernel from torch.profiler; wall time from the
    host clock around synchronized steps (mean of 3, profiler off)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serving import MultiTenantEngine
    cfg = get_config("starcoder2-7b")
    params = lm.init_params(cfg, seed=0, device="cuda")
    eng = MultiTenantEngine(cfg, params)
    for p in serve.make_adapters(cfg, params, 3):
        eng.register(p)
    names = ["adapter_0", "adapter_1", None, "adapter_2"] * (B // 4)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, PROMPT),
                                     generator=gen, device="cuda")}
    cuda = torch.autograd.DeviceType.CUDA
    for label, p in (("base", params),
                     ("multi-tenant f32",
                      eng.wrapped_params(eng.ids_for(names)))):
        logits, caches = lm.prefill(p, cfg, batch, PROMPT + 8)
        nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]

        def step():
            lm.decode_step(p, cfg, nxt, caches, PROMPT)
            torch.cuda.synchronize()
        step()
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        wall = (time.perf_counter() - t0) / 3 * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step()
        kern = [(getattr(e, "self_device_time_total", 0) / 1e3, e.count,
                 e.key) for e in prof.key_averages()
                if e.device_type == cuda]
        busy = sum(k[0] for k in kern)
        print(f"[profile] {label} decode step (B={B}, {cfg.num_layers} "
              f"layers): wall "
              f"{wall:.2f} ms; kernels {busy:.2f} ms"
              + (f" ({busy / wall:.0%} of wall)" if busy else
                 " (profiler saw no device time: not measured)"),
              flush=True)
        for ms, n, name in sorted(kern, reverse=True)[:6]:
            print(f"[profile]   {ms:8.3f} ms  x{n:<4d} {name[:90]}")
    eng.close()


def consistency_phase(torch):
    from repro_torch.configs import get_config
    from repro_torch.core import FusedLRU
    from repro_torch.launch import serve
    from repro_torch.models import layers, lm
    from repro_torch.serving import MultiTenantEngine
    from repro_torch.serving.multitenant import (greedy_decode,
                                                 switch_per_request_reference)
    cfg = get_config("starcoder2-7b").replace(num_layers=2)
    names = ["adapter_0", "adapter_2", None, "adapter_1", "adapter_0",
             "adapter_1", None, "adapter_2"]
    T = 8
    with layers.compute_precision(torch.float32):
        params = lm.init_params(cfg, seed=0, device="cuda")
        packs = serve.make_adapters(cfg, params, 3)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(3)
        toks = torch.randint(0, cfg.vocab_size, (len(names), PROMPT),
                             generator=gen, device="cuda")
        ref, ref_logits, _ = switch_per_request_reference(
            cfg, params, packs, toks, names, T)
        # promote_at 0.1: adapter_0 wins the three-way tie on its name
        for label, sched in (("unfused", None),
                             ("adapter_0 fused", FusedLRU(promote_at=0.1,
                                                          demote_at=0.0))):
            eng = MultiTenantEngine(cfg, params, scheduler=sched)
            for p in packs:
                eng.register(p)
            out, _ = eng.generate({"tokens": toks}, names, T)
            p = eng.wrapped_params(eng.ids_for(names))
            _, logits = greedy_decode(
                cfg, {"tokens": toks}, T,
                lambda b: lm.prefill(p, cfg, b, PROMPT + T + 8),
                lambda t, c, pos: lm.decode_step(p, cfg, t, c, pos))
            equal = bool(torch.equal(out, ref))
            diff = float((logits - ref_logits).abs().max())
            print(f"[consistency] f32, 2 layers, full width, {label}: tokens "
                  f"equal {equal}, last-step logits max diff {diff:.3g}",
                  flush=True)
            if not equal or (sched is not None and eng.fused != "adapter_0"):
                fail(f"consistency {label}: multi-tenant tokens differ from "
                     "the switch-per-request reference")
            eng.close()


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs on an NVIDIA card")
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"the repro_torch package is not beside this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = card_line()
    print(f"[device] {line}", flush=True)

    t0 = time.perf_counter()
    build.build()
    print(f"[build] {len(build.KERNELS)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for name, log in build.ptxas_log.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"[build] {name}: {ln.strip()}")

    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    side, scat = kernels_phase(torch, lambda: scratch.fill_(1))
    del scratch
    torch.cuda.empty_cache()
    launches = serve_phase(torch)
    torch.cuda.empty_cache()
    profile_phase(torch)
    torch.cuda.empty_cache()
    consistency_phase(torch)

    main_side = side[0]     # w_up, S=1, f32 tables: the multi-tenant decode
    kernels = [
        {"name": "sidedelta", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sidedelta.cu",
         "replaces": "src/repro/kernels/sidedelta.py:282",
         "launches": launches["sidedelta"],
         "max_abs_err": max(r["max_abs_err"] for r in side),
         **{k: main_side[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}},
        {"name": "scatter_apply", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/scatter_apply.cu",
         "replaces": "src/repro/kernels/scatter_apply.py:49",
         "launches": launches["scatter_apply"], **scat},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
