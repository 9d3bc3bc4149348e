#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

  python3 chip_smoke.py        # from the repository root, one card

Phases, each fatal on failure (non-zero exit, no result line); each
prints its seconds on a "[time]" line:
  1. device    the card's name and power limit (nvidia-smi)
  2. build     nvcc builds every kernel of csrc/, one process each, at once
  3. kernels   each kernel against its plain version on the card, at
               starcoder2-7b shapes; times (cold L2) beside the bound:
               sidedelta (S = 1, 16, 256, with the path each S takes,
               and where the token-minor path starts to pay) and
               scatter_apply (serving), sparse_adamw (blocks and rows,
               f32/bf16/int8 moments) and the trainable sidedelta's forward
               and gradients (dx through the forward kernel, dvals) of
               training, and the attention kernels flash_decode ((B,) and
               scalar kv_len), flash_decode_paged (pages of 16, 8, 24;
               G = 9 and 48) and flash_prefill, bf16 and f32, beside
               F.scaled_dot_product_attention
  4. serve     starcoder2-7b at full width through repro_torch.launch.serve:
               sequential switching, --fuse, --multi-tenant (f32, int8);
               launch counts are zeroed before each mode and must be > 0
               for every kernel of that mode's path
  5. profile   device time by kernel of one full-width decode step, base
               model and multi-tenant, and of one batch-1, 1024-token
               prefill with flash_prefill's share (torch.profiler)
  6. consistency  full width, 2 layers, f32: multi-tenant tokens equal the
               switch-per-request reference, unfused and with a hot adapter
  7. continuous  full width: serve --continuous --int8, then a 24-request
               trace (prompts of 64..1024 tokens, half with one shared
               256-token prefix, 32 tokens each) through ServingEngine and
               PagedServingEngine over an AdapterStore: tokens/s, TTFT,
               steps, residency, COW copies, launches, peak memory, and
               one decode-only and one prefill step of each engine under
               torch.profiler
  8. continuous-consistency  full width, 2 layers, f32: both engines'
               tokens equal each request's fixed-batch tokens, with COW
  9. train     full width: repro_torch.launch.train (packed SHiRA, Trainer)
               and MultiAdapterTrainer (3 adapters, f32 then int8
               moments), launch counts > 0 for every kernel of each path,
               and a torch.profiler breakdown of one multi-adapter step
  10. train-consistency  full width, 2 layers, f32: adapter a of the
               multi-adapter trainer tracks Trainer(init a) to 5e-3
  11. train (wm, hook)  full width: launch.train --adapter shira-wm (the
               reference's default mask, packed, all 32 layers), then a
               hook-mode Trainer (shira-wm, packed=False) cut to 12 layers:
               step ms, tokens/s, peak memory, the mask build's seconds,
               masked_update launched 6 times a step; its exported pack's
               %C, and the pack loaded back through SwitchEngine
               (scatter_apply) equal to the trained weights
  12. hook-consistency  full width, 2 layers, f32: hook and packed runs on
               one wm mask give the same losses to 2e-3; grad and snip
               masks from one batch's calibration gradients train, and
               their exported packs load
  13. personalization  full width: three f32 packs published as
               adapter_i@1 into an AdapterStore (resident budget one pack,
               pinned staging two), the continuous trace's first 12
               requests, adapter_0@2 published after step 10, the other
               12; ServingEngine and PagedServingEngine with a FusedLRU and
               slot_pad=4, async_prefetch off and on, traced: tok/s, cold
               and hot TTFT, decode-only step ms with and without a build
               in flight, the pipeline's span ms by thread, async build
               counters, the un-fuse of adapter_0@1, peak memory and
               pinned staging; the hot swap's invariants are held
  14. personalization-consistency  full width, 2 layers, f32: each
               request through the swap equals a run of the same engine
               that saw only its version, both engines, both modes
  15. summary   one JSON line of kernel numbers, the card line, and last
               {"ok": true, "device": {...}}

The kernels phase also holds masked_update (the dense-mask apply of hook
mode) against its plain version, bit for bit, at the stacked (32, 4608,
18432) w_up leaf with a 1% mask: f32 W with a bool mask, bf16 W with a
bool mask, f32 W with an f32 mask, beside Tensor.addcmul_. Its
sparse_adamw part prints each kernel instance's registers and spills
(fatal on a spill), holds every case at inputs where the check would see
an output zeroed or permuted within a vector, prints the achieved TB/s
and share of the bound of every timed case, checks rows
of K = 3 and 13 in every moment type and views one element past their
start (the one-element instance, which must count an unaligned launch),
and times qstate.encode's int8 re-encode beside the int8 update; the
train phase fails if any update there took the one-element instance.
scatter_apply is held bit for bit against its plain version on a padded
fused pack, on (37, 96, 160) with k = 307 and (70001, 8, 8) with k = 3
(layer boundaries inside a block, more layers than a grid dimension
holds), and on the (32, 4608, 18432) leaf with ascending and shuffled
indices; its bound counts the 32-byte sectors of W its entries touch
(scatter_bytes). A pack with repeated indices (ROADMAP C3) loads
through apply_pack within one ulp of its plain version's sum, and a
second process shows the kernel's assertion on an unmerged row; the
merged-form check is timed on the leaf. The train phases publish the
trained packs into a store and read them back equal. The dvals kernel is
timed alone on grouped token-minor
inputs beside the wrapper as the backward calls it and the whole
wrapper, and held within 1e-4 at S = 250 (the one-token instance, which
must count an unaligned launch) and with an adapter that has no tokens;
the train phase fails if a multi-adapter step took the one-token
instance. The scatter_apply, sidedelta_grad and sparse_adamw parts print
each kernel instance's registers and spills and fail on a spill.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from concurrent import futures
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOP_PER_S = 67e12         # H100 SXM f32 rate outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor-core rate
ATTN_TOL = {"bf16": 1e-2,      # 2.5x the largest bf16 error measured on the
            "f32": 1e-5}       # card (3.9e-3, one bf16 ulp near 1)
SIDEDELTA_TOL = 1e-4           # f32 sums of ~400 products in another order
RESTORE_TOL = 1e-5             # the JAX package's load/unload tolerance
ADAMW_TOL = 1e-6               # rtol = atol: the JAX package's own, and the
                               # kernel rounds as its plain version does
TRAIN_TOL = 5e-3               # the JAX package's trainer-parity tolerance
GRAD_TOL = 1e-4                # value gradients, of each leaf's largest
B, PROMPT, TOKENS = 8, 16, 16  # serving batch, prompt and generated tokens
CACHE = 1056                   # the lane engine's rows a request: prompts
                               # up to 1024 + 32 generated tokens
CC_REQUESTS, CC_TOKENS = 24, 32   # the continuous-batching trace
CHUNK = 256                    # the paged engine's prefill chunk, and a
                               # training sequence's rows
IDS = [0, 1, 2, -1, 0, 1, 2, 0]
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 256, 8, 4   # launch.train phase
MT_SEQ, MT_BATCH, MT_STEPS = 256, 2, 3            # per adapter, A = 3
MT_IDS = [0, 0, 1, 1, 2, 2]    # the multi-adapter batch: T_a = 512 tokens
MU_DENSITY = 0.01              # masked_update's mask: 1% of the leaf
HOOK_LAYERS, HOOK_STEPS = 12, 4  # hook mode at full width: 21 B a target
                                # entry, 54.7 GB at 12 of 32 layers
HOOK_TOL = 2e-3                # hook vs packed losses: the JAX package's
                               # own claim (tests/test_training.py)
ROUND_TRIP_TOL = 1e-6          # a loaded pack vs the trained weights, of
                               # the largest weight: base + (W - base)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def timed(label: str, fn, *args):
    """Run one phase and print its seconds on a line of its own."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] {label} {time.perf_counter() - t0:.1f}s", flush=True)
    return out


def bound(nbytes: float, flops: float, bf16_flops: float = 0) -> dict:
    """The least time the card could take: bytes over the memory rate or
    the operations over the peak rate of their operands' type, whichever
    is larger. ``flops`` have an f32 operand (non-tensor-core rate);
    ``bf16_flops`` are products of two bf16 operands summed in f32, which
    the tensor cores compute exactly."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = (flops / F32_FLOP_PER_S + bf16_flops / BF16_FLOP_PER_S) * 1e3
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations"}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """name<template arguments> of a kernel from its mangled name, whose
    identifier is the one ending in "_kernel" after its length."""
    end = mangled.find("_kernel") + len("_kernel")
    for i in range(end - 1, -1, -1):
        m = re.match(r"\d+", mangled[i:end])
        if m and int(m.group()) == end - i - len(m.group()):
            args = re.match(r"I(\w*?)EE", mangled[end:])
            return (mangled[i + len(m.group()):end]
                    + (f"<{args.group(1)}>" if args else ""))
    return mangled[:48]


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


def device_kernels(torch, prof):
    """(device ms, launches, name) of each kernel a torch.profiler run saw."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(getattr(e, "self_device_time_total", 0) / 1e3, e.count, e.key)
            for e in prof.key_averages() if e.device_type == cuda]


def kernel_share(label, kern) -> None:
    """Print the device ms, launches and share of the port's attention and
    sidedelta kernels among the profiled kernels ``kern``."""
    busy = sum(k[0] for k in kern)
    for ms, n, name in sorted(kern, reverse=True):
        if ("flash_" in name or "sidedelta" in name) and busy:
            print(f"[profile]   {label}: {ms:.3f} ms x{n} ({ms / busy:.1%} of "
                  f"device time) {name[:70]}", flush=True)


def rand_entries(torch, gen, nl, n, m, k):
    """nl rows of k unique ascending flat indices, as a rand mask's pack
    holds them, and their values."""
    idx = torch.stack([torch.randperm(n * m, generator=gen, device="cuda")[:k]
                       .sort().values for _ in range(nl)]).to(torch.int32)
    vals = 0.01 * torch.randn((nl, k), generator=gen, device="cuda")
    return idx, vals


def repeat_entries(torch, gen, nl, n, m):
    """The entries of ROADMAP C3's case: each of nl rows holds 1% of its
    (n, m) matrix's indices ascending, then every tenth entry takes an
    index already in its row, alternately that of the entry just before it
    and of the one five before; row 0 begins with index 0 and takes it
    again, with a nonzero value, just before the padding (index 0, value
    0) that ends every row."""
    k = n * m // 100
    idx, vals = rand_entries(torch, gen, nl, n, m, k)
    pos = torch.arange(9, k, 10, device=idx.device)
    odd = torch.arange(pos.numel(), device=idx.device) % 2 == 1
    idx[:, pos] = idx[:, torch.where(odd, pos - 5, pos - 1)]
    idx[0, 0] = 0
    tail_i = torch.zeros((nl, 4), dtype=torch.int32, device=idx.device)
    tail_v = torch.zeros((nl, 4), device=idx.device)
    tail_v[0, 0] = 0.5
    return torch.cat([idx, tail_i], 1), torch.cat([vals, tail_v], 1)


def ulp_tol(torch, want) -> float:
    """One ulp of the largest |want|: the tolerance of a merged pack's
    load, whose kernel adds W + (a + b) where the plain version adds
    (W + a) + b."""
    mx = want.abs().max()
    return float(torch.nextafter(mx, torch.tensor(float("inf"),
                                                  device=mx.device)) - mx)


def repeat_case(torch, gen, apply, label):
    """C3 on a (4, 4608, 18432) f32 slice of w_up: ``apply(w, idx, vals)``
    loads the repeat pack (``repeat_entries``); held against
    scatter_apply_plain of the same entries, which sums the repeats, to
    one ulp of the largest result. Returns (max_abs_err, tol, entries,
    repeats)."""
    from repro_torch.kernels.scatter_apply import scatter_apply_plain
    d, f = 4608, 18432
    w = torch.randn((4, d, f), generator=gen, device="cuda")
    ri, rv = repeat_entries(torch, gen, 4, d, f)
    want = scatter_apply_plain(w.clone(), ri, rv, 1.0)
    apply(w, ri, rv)
    torch.cuda.synchronize()
    err, tol = float((w - want).abs().max()), ulp_tol(torch, want)
    repeats = 4 * len(range(9, d * f // 100, 10)) + 1
    print(f"[kernels] scatter_apply repeated indices ({label}): "
          f"{ri.numel()} entries, {repeats} repeats: max_abs_err={err:.3g} "
          f"(tol {tol:.3g}, one ulp of the largest result)", flush=True)
    return err, tol, ri.numel(), repeats


def assert_probe():
    """Start a process that hands scatter_apply's kernel a row with a
    repeated index; ``check_assert_probe`` holds it to the kernel's
    assertion."""
    code = ("import sys, torch; sys.path.insert(0, 'src')\n"
            "from repro_torch.kernels.scatter_apply import scatter_apply\n"
            "w = torch.zeros((1, 64, 64), device='cuda')\n"
            "i = torch.tensor([[3, 7, 7]], dtype=torch.int32, device='cuda')\n"
            "scatter_apply(w, i, torch.ones((1, 3), device='cuda'))\n"
            "try:\n"
            "    torch.cuda.synchronize()\n"
            "except RuntimeError as e:\n"
            "    print('raised:', str(e).splitlines()[0])\n"
            "    sys.exit(3)\n")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def check_assert_probe(proc) -> None:
    out, _ = proc.communicate(timeout=300)
    said = [ln for ln in out.splitlines() if "raised:" in ln
            or "Assertion" in ln]
    print(f"[kernels] scatter_apply on an unmerged row (another process): "
          f"exit {proc.returncode}; {said[-2:]}", flush=True)
    if proc.returncode != 3 or not any("assert" in ln.lower()
                                       for ln in said):
        fail("scatter_apply's kernel did not assert on an unmerged row:\n"
             + out[-2000:])


def scatter_bytes(torch, w, idx, vals):
    """(bytes, sectors) that scatter_apply(w, idx, vals) must move: the
    index and value of every entry read once, and each 32-byte sector of W
    that holds an applied entry (value not 0, index inside its matrix) read
    and written once, counted from the indices at W's own addresses."""
    n, m = w.shape[-2:]
    nl, k = idx.numel() // idx.shape[-1], idx.shape[-1]
    i = idx.reshape(nl, k).long()
    keep = (vals.reshape(nl, k) != 0) & (i >= 0) & (i < n * m)
    first = w.data_ptr() % 32 // 4      # W's first element within a sector
    flat = (torch.arange(nl, device=i.device)[:, None] * (n * m) + i
            + first)[keep]
    sectors = int(torch.unique(flat // 8).numel())
    return nl * k * 8 + 64 * sectors, sectors


def switch_bound(torch, cfg):
    """(bound, entries, sectors) of one whole adapter load as the serve
    phase's packs make it: every adapted leaf of ``cfg`` (wq, wk, wv, wo,
    w_up, w_down, each stacked over the layers) at sparsity 0.98, the
    sectors counted from a draw of the same masks."""
    from repro_torch.core.masks import budget
    d, f, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    kv = cfg.num_kv_heads * cfg.resolved_head_dim
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    nbytes = sectors = entries = 0
    for n, m in ((d, d), (d, kv), (d, kv), (d, d), (d, f), (f, d)):
        idx, vals = rand_entries(torch, gen, L, n, m, budget(n, m, 0.98))
        b, s = scatter_bytes(torch, torch.empty((L, n, m), device="meta"),
                             idx, vals)
        nbytes, sectors = nbytes + b, sectors + s
        entries += idx.numel()
        del idx, vals
    return bound(nbytes, 0), entries, sectors


def sidedelta_case(torch, gen, flush, label, n, m, S, int8, slots=None,
                   pad_to=0):
    """One sidedelta comparison at (n, m) on layer 0 of ``slots`` (three
    random single-layer adapters by default), its rows/vals padded with
    zeros to ``pad_to`` entries when given; returns its numbers."""
    import torch.nn.functional as F
    from repro_torch.core.masks import budget
    from repro_torch.kernels import ops
    from repro_torch.kernels.sidedelta import (kernel_path, sidedelta,
                                               sidedelta_plain)
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
          f"{'int8/int16' if int8 else 'f32/int32'} "
          f"path={kernel_path(B, S)}: "
          f"max_abs_err={err:.3g} "
          f"(tol {SIDEDELTA_TOL}) ms={ms:.4f} plain_ms={plain_ms:.3f} "
          f"library_ms(bmm, dense dW)={library_ms:.3f} "
          f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    return r


def sidedelta_crossover(torch, gen, flush, n, m):
    """Where the token-minor path starts to pay, which sets the wrapper's
    rule (kernel_path): at the w_up shape, the serving batch's adapters at
    S = 2..32 and one adapter's single request at S = 4..32, each through
    both paths' launches on the same inputs. Prints both times and the
    path the rule takes; the paths' results must agree."""
    from repro_torch.core.masks import budget
    from repro_torch.kernels import ops
    from repro_torch.kernels.sidedelta import (_launch_rows, _launch_tokens,
                                               kernel_path)
    slots = [rand_entries(torch, gen, 1, n, m, budget(n, m, 0.98))
             for _ in range(3)]
    t = {k: v[0].contiguous() for k, v in ops.sidedelta_table(
        slots, 1, n, m).items()}
    tab = (t["rows"], t["vals"], t["colptr"])
    ids = torch.tensor(IDS, dtype=torch.int32, device="cuda")
    for Bx, S in [(B, s) for s in (2, 4, 8, 16, 32)] + [
            (1, s) for s in (4, 8, 16, 32)]:
        x = torch.randn((Bx, S, n), generator=gen, device="cuda").to(
            torch.bfloat16)
        xi = ids[:Bx]
        err = float((_launch_tokens(x, *tab, xi) - _launch_rows(x, *tab, xi))
                    .abs().max())
        if not err <= SIDEDELTA_TOL:
            fail(f"sidedelta crossover B={Bx} S={S}: the paths differ by "
                 f"{err}")
        tok = cold_ms(torch, lambda: _launch_tokens(x, *tab, xi), 20, flush)
        row = cold_ms(torch, lambda: _launch_rows(x, *tab, xi), 20, flush)
        print(f"[kernels] sidedelta crossover w_up B={Bx} S={S} "
              f"({len(set(xi.tolist()) - {-1})} adapters): tokens "
              f"{tok:.4f} ms, rows {row:.4f} ms, paths differ by "
              f"{err:.3g}; the rule takes {kernel_path(Bx, S)}", flush=True)


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
        for S in (1, PROMPT) + ((CHUNK,) if m == f or n == f else ()):
            for int8 in (False, True):
                side.append(sidedelta_case(torch, gen, flush, name, n, m,
                                           S, int8))
        torch.cuda.empty_cache()
    sidedelta_crossover(torch, gen, flush, d, f)
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
    for S in (1, PROMPT, CHUNK):     # the decode and token-minor paths
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

    # scatter_apply, every case bit for bit against its plain version.
    # First a fused pack of two w_up layers, padded as fuse_packs pads a
    # shorter layer (index 0, value 0), 4096 more entries a layer
    kernel_ptxas("scatter_apply")
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
    # C3: a pack with repeated indices, merged when it is built
    from repro_torch.core.adapters import apply_pack
    probe = assert_probe()
    err, tol, _, _ = repeat_case(
        torch, gen, lambda w, i, v: apply_pack(
            {"w": w}, AdapterPack("repeats", {"w": (i, v)})), "apply_pack")
    if not err <= tol:
        fail(f"scatter_apply: a pack with repeated indices loads "
             f"{err:.3g} away from its plain version (tol {tol:.3g})")
    check_assert_probe(probe)
    torch.cuda.empty_cache()
    # many layers of odd k: layer boundaries inside a block, and at 70,001
    # layers more layers than a grid dimension holds
    for nl, n, m, kk in ((37, 96, 160, 307), (70001, 8, 8, 3)):
        ws = torch.randn((nl, n, m), generator=gen, device="cuda")
        ii = torch.argsort(torch.rand((nl, n * m), generator=gen,
                                      device="cuda"), 1)[:, :kk]
        ii = ii.sort(1).values.to(torch.int32)
        vv = torch.randn((nl, kk), generator=gen, device="cuda")
        want = scatter_apply_plain(ws.clone(), ii, vv, 0.5)
        scatter_apply(ws, ii, vv, 0.5)
        equal = bool(torch.equal(ws, want))
        print(f"[kernels] scatter_apply ({nl}, {n}, {m}) k={kk}: bit-equal "
              f"to its plain version: {equal}", flush=True)
        if not equal:
            fail(f"scatter_apply disagrees with its plain version at "
                 f"({nl}, {n}, {m}) k={kk}")
    del ws, ii, vv, want

    # the stacked (32, 4608, 18432) leaf: load, unload, with the indices
    # ascending (as every pack holds them) and shuffled within each layer
    L = 32
    w = torch.randn((L, d, f), generator=gen, device="cuda")
    idx, vals = rand_entries(torch, gen, L, d, f, k)
    perm = torch.argsort(torch.rand((L, k), generator=gen, device="cuda"),
                         dim=1)
    shuffled = idx.gather(1, perm), vals.gather(1, perm)
    del perm
    gi = (torch.arange(L, device="cuda")[:, None] * (d * f)
          + idx.long()).reshape(-1)
    before = w.view(-1)[gi].clone()
    probe = torch.randint(0, w.numel(), (1 << 20,), generator=gen,
                          device="cuda")
    probe = probe[~torch.isin(probe, gi)]          # entries no pack touches
    probe_before = w.view(-1)[probe].clone()
    want = scatter_apply_plain(before.clone()[None], torch.arange(
        gi.numel(), dtype=torch.int32, device="cuda"), vals.reshape(-1),
        1.0)[0]
    errs = []
    for label, entries in (("ascending", (idx, vals)),
                           ("shuffled", shuffled)):
        ordered = label == "ascending"   # shuffled rows are not merged
        scatter_apply(w, *entries, 1.0, ordered=ordered)
        load_err = float((w.view(-1)[gi] - want).abs().max())
        scatter_apply(w, *entries, -1.0, ordered=ordered)
        restore_err = float((w.view(-1)[gi] - before).abs().max())
        untouched = bool(torch.equal(w.view(-1)[probe], probe_before))
        print(f"[kernels] scatter_apply ({L}, {d}, {f}) K={gi.numel()} "
              f"{label}: load err={load_err} restore err={restore_err:.3g} "
              f"(tol {RESTORE_TOL}) untouched entries equal: {untouched}",
              flush=True)
        if (load_err != 0.0 or not restore_err <= RESTORE_TOL
                or not untouched):
            fail(f"scatter_apply disagrees with its plain version "
                 f"({label} indices)")
        w.view(-1)[gi] = before         # the exact base for the next case
        errs += [load_err, restore_err]
    sign = [1.0]

    def flip(fn):
        def go():
            fn(sign[0])
            sign[0] = -sign[0]
        return go
    ms = cold_ms(torch, flip(lambda a: scatter_apply(w, idx, vals, a)), 10,
                 flush)
    shuffled_ms = cold_ms(torch, flip(
        lambda a: scatter_apply(w, *shuffled, a, ordered=False)), 10, flush)
    plain_ms = cold_ms(torch, flip(
        lambda a: scatter_apply_plain(w, idx, vals, a)), 4, flush)
    upd = {1.0: vals.reshape(-1).clone(), -1.0: -vals.reshape(-1)}
    library_ms = cold_ms(torch, flip(lambda a: w.view(-1).index_put_(
        (gi,), upd[a], accumulate=True)), 4, flush)
    # C3's check, paid once where a pack is built (AdapterPack): one
    # compare pass over the leaf's entries and one read of the result
    from repro_torch.core.adapters import merged_form
    check_ms = cold_ms(torch, lambda: merged_form(idx, vals), 10, flush)
    hi, hv = idx.cpu(), vals.cpu()
    t0 = time.perf_counter()
    ok = merged_form(hi, hv)
    check_cpu = time.perf_counter() - t0
    print(f"[kernels] merged-form check of the leaf's {idx.numel()} entries "
          f"(once, when a pack is built): {check_ms:.4f} ms on the card, "
          f"{check_cpu * 1e3:.1f} ms on the host (a pack from a file); "
          f"merged {ok}", flush=True)
    if not ok:
        fail("merged_form refused a pack of ascending unique indices")
    del hi, hv
    nbytes, sectors = scatter_bytes(torch, w, idx, vals)
    scat = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, **bound(nbytes, 0)}
    print(f"[kernels] scatter_apply ms={ms:.4f} (shuffled {shuffled_ms:.4f})"
          f" plain_ms(index_add_)={plain_ms:.4f} library_ms(index_put_ "
          f"accumulate)={library_ms:.4f} bound_ms={scat['bound_ms']:.4f} "
          f"(bytes: {sectors} of {w.numel() // 8} W sectors read and "
          f"written, 8 B an entry): {rate_line(scat, nbytes)}", flush=True)
    del w, idx, vals, shuffled, gi, before, probe, probe_before, upd, want
    return side, scat


def adamw_inputs(torch, gen, shape):
    """v, g, m, u on the card, at magnitudes where every output lies far
    above ADAMW_TOL (as the CPU tests' inputs): v, g ~ N(0, 1),
    m ~ N(0, 0.1^2), u = |N(0, 1)| * 0.01, so u_out ~ 0.01 and m_out ~ 0.1."""
    r = lambda: torch.randn(shape, generator=gen, device="cuda")
    return r(), r(), r().mul_(0.1), r().abs_().mul_(0.01)


def adamw_within(got, want) -> bool:
    """Every kernel output within rtol = atol = ADAMW_TOL of the plain
    version's."""
    return all(bool(((a - b).abs() <= ADAMW_TOL * b.abs() + ADAMW_TOL).all())
               for a, b in zip(got, want))


def adamw_planted(torch, want):
    """Faults the check must see: each output in turn zeroed, or rotated
    within each vector of 4 elements (the last n mod 4 left as they are)."""
    for j, w in enumerate(want):
        rot = w.clone().reshape(-1)
        n4 = rot.numel() // 4 * 4
        rot[:n4] = rot[:n4].view(-1, 4).roll(1, dims=1).reshape(-1)
        for bad in (torch.zeros_like(w), rot.view_as(w)):
            yield [bad if i == j else x for i, x in enumerate(want)]


def adamw_close(torch, got, want):
    """(max_abs_err, max_rel_err, bit-equal) of kernel outputs against the
    plain version's; fails beyond rtol = atol = ADAMW_TOL, and fails if
    that check would pass a planted fault (``adamw_planted``) at these
    inputs."""
    if not adamw_within(got, want):
        fail("sparse_adamw disagrees with its plain version")
    if any(adamw_within(p, want) for p in adamw_planted(torch, want)):
        fail("sparse_adamw: the check passes a zeroed or permuted output "
             "at these inputs")
    errs = []
    for a, b in zip(got, want):
        d = (a - b).abs()
        errs.append((float(d.max()),
                     float((d / b.abs().clamp(min=1e-30)).max()),
                     bool(torch.equal(a, b))))
    return (max(e[0] for e in errs), max(e[1] for e in errs),
            all(e[2] for e in errs))


def fused_adamw_ms(torch, flush, v, g, m, u, scalars):
    """library_ms: torch._fused_adamw_ over the same f32 vector, in place on
    copies (PyTorch's own fused AdamW; the port never calls it)."""
    p, e1, e2 = v.clone(), m.clone(), u.clone()
    steps = [torch.tensor(3.0, device="cuda")]
    lr, b1, b2, eps, wd = scalars[:5]
    return cold_ms(torch, lambda: torch._fused_adamw_(
        [p], [g], [e1], [e2], [], steps, lr=lr, beta1=b1, beta2=b2,
        weight_decay=wd, eps=eps, amsgrad=False, maximize=False), 10, flush)


def rate_line(r: dict, nbytes: float) -> str:
    """Achieved TB/s of one timed case's bytes and its share of the
    bound."""
    return (f"{nbytes / r['ms'] / 1e9:.3f} TB/s, {r['bound_ms'] / r['ms']:.1%}"
            " of bound")


def ptxas_lines(log: str):
    """(kernel, line) of each registers or spills line of a ptxas log."""
    fn = ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = kernel_name(ln.split("'")[1])
        if "registers" in ln or "spill" in ln:
            yield fn, ln.strip()


def kernel_ptxas(name: str) -> None:
    """Prints the -Xptxas -v lines (registers, spills) of every kernel
    instance of library ``name``; fails if the log is missing or an
    instance spills."""
    from repro_torch.kernels import build
    lines = list(ptxas_lines(build.ptxas(name)))
    if not any("spill stores" in ln for _, ln in lines):
        fail(f"{name}: no ptxas log beside its library")
    for fn, ln in lines:
        print(f"[kernels] {name} ptxas: {fn}: {ln}", flush=True)
        if re.search(r"[1-9]\d* bytes spill (stores|loads)", ln):
            fail(f"{name}: {fn} spills registers")


def adamw_kernels(torch, flush, cfg):
    """sparse_adamw (blocks) on the stacked w_up leaf's packed vector and
    sparse_adamw_rows on (3 adapters x layers, K) rows with f32, bf16 and
    int8 moments, at sparsity 0.98 as the multi-adapter phase trains; then
    short rows (K = 3 and 13: row boundaries inside a vector) in every
    moment type, and views at an element offset of 1, which take the
    one-element instance."""
    from repro_torch.core.masks import budget
    from repro_torch.kernels import ops
    from repro_torch.kernels.sparse_adamw import (sparse_adamw,
                                                  sparse_adamw_plain,
                                                  sparse_adamw_rows,
                                                  sparse_adamw_rows_plain)
    from repro_torch.training import qstate
    kernel_ptxas("sparse_adamw")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    k = budget(cfg.d_model, cfg.d_ff, 0.98)
    L = cfg.num_layers
    scalars = ops._adamw_scalars(3, 3e-4, 0.9, 0.999, 1e-8, 0.0)

    v, g, m, u = adamw_inputs(torch, gen, (L * k,))
    got = sparse_adamw(v, g, m, u, scalars)
    want = sparse_adamw_plain(v, g, m, u, scalars)
    err, rel, equal = adamw_close(torch, got, want)
    del got, want
    blocks = {"max_abs_err": err,
              "ms": cold_ms(torch, lambda: sparse_adamw(v, g, m, u, scalars),
                            20, flush),
              "plain_ms": cold_ms(torch, lambda: sparse_adamw_plain(
                  v, g, m, u, scalars), 3, flush),
              "library_ms": fused_adamw_ms(torch, flush, v, g, m, u, scalars),
              **bound(v.numel() * 28, v.numel() * 15)}
    print(f"[kernels] sparse_adamw_blocks w_up leaf ({L}*{k},): "
          f"max_abs_err={err:.3g} max_rel_err={rel:.3g} bit-equal={equal} "
          f"(tol rtol=atol={ADAMW_TOL}) ms={blocks['ms']:.4f} "
          f"plain_ms={blocks['plain_ms']:.3f} library_ms(_fused_adamw_)="
          f"{blocks['library_ms']} bound_ms={blocks['bound_ms']:.4f} "
          f"({blocks['bound_by']}), {rate_line(blocks, v.numel() * 28)}",
          flush=True)
    # the one-element instance: every operand one element past its start
    before = sparse_adamw.unaligned_launches
    views = [t[1:] for t in (v, g, m, u)]
    got = sparse_adamw(*views, scalars)
    if sparse_adamw.unaligned_launches != before + 1:
        fail("sparse_adamw at an offset of 1 did not take the one-element "
             "instance")
    err1, _, _ = adamw_close(torch, got,
                             sparse_adamw_plain(*views, scalars))
    blocks["max_abs_err"] = max(err, err1)
    ms1 = cold_ms(torch, lambda: sparse_adamw(*views, scalars), 10, flush)
    print(f"[kernels] sparse_adamw_blocks at offset 1 (one-element "
          f"instance): max_abs_err={err1:.3g} ms={ms1:.4f}, "
          f"{v.numel() * 28 / ms1 / 1e9:.3f} TB/s", flush=True)
    del v, g, m, u, views, got

    R = 3 * L
    v, g, m, u = adamw_inputs(torch, gen, (R, k))
    rows = {}
    for mode in ("f32", "bf16", "int8"):
        mq, ms = qstate.encode(m, mode)
        uq, us = qstate.encode(u, mode, sqrt_domain=True)
        args = (v, g, mq, uq, ms, us, scalars)
        got = sparse_adamw_rows(*args)
        want = sparse_adamw_rows_plain(*args)
        err, rel, equal = adamw_close(torch, got, want)
        del got, want
        nbytes = v.numel() * (20 + 2 * mq.element_size())
        r = {"max_abs_err": err,
             "ms": cold_ms(torch, lambda: sparse_adamw_rows(*args), 10,
                           flush),
             "plain_ms": cold_ms(torch, lambda: sparse_adamw_rows_plain(
                 *args), 3, flush),
             "library_ms": (fused_adamw_ms(torch, flush, v, g, m, u, scalars)
                            if mode == "f32" else None),
             **bound(nbytes, v.numel() * 15)}
        rows[mode] = r
        print(f"[kernels] sparse_adamw_rows ({R}, {k}) {mode} moments: "
              f"max_abs_err={err:.3g} max_rel_err={rel:.3g} bit-equal="
              f"{equal} (tol rtol=atol={ADAMW_TOL}) ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.3f} library_ms(_fused_adamw_, f32)"
              f"={r['library_ms']} bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']}), {rate_line(r, nbytes)}", flush=True)
        if mode == "int8":   # the re-encode that follows every int8 update
            enc = cold_ms(torch, lambda: (
                qstate.encode(m, "int8"),
                qstate.encode(u, "int8", sqrt_domain=True)), 10, flush)
            print(f"[kernels] qstate.encode int8 of both ({R}, {k}) f32 "
                  f"moments: ms={enc:.4f} (the int8 update above: "
                  f"{r['ms']:.4f})", flush=True)
        del mq, uq, ms, us, args
    # f32 rows one element past the start: the one-element instance
    before = sparse_adamw_rows.unaligned_launches
    views = [t.view(-1)[1:1 + (R - 1) * k].view(R - 1, k)
             for t in (v, g, m, u)]
    got = sparse_adamw_rows(*views, None, None, scalars)
    if sparse_adamw_rows.unaligned_launches != before + 1:
        fail("sparse_adamw_rows at an offset of 1 did not take the "
             "one-element instance")
    err1, _, _ = adamw_close(torch, got, sparse_adamw_rows_plain(
        *views, None, None, scalars))
    ms1 = cold_ms(torch, lambda: sparse_adamw_rows(*views, None, None,
                                                   scalars), 10, flush)
    print(f"[kernels] sparse_adamw_rows ({R - 1}, {k}) f32 at offset 1 "
          f"(one-element instance): max_abs_err={err1:.3g} ms={ms1:.4f}, "
          f"{views[0].numel() * 28 / ms1 / 1e9:.3f} TB/s", flush=True)
    rows["f32"]["max_abs_err"] = max(rows["f32"]["max_abs_err"], err1)
    del v, g, m, u, views, got
    # short rows: a row boundary inside a vector, or rows shorter than one
    for R, K in ((5, 3), (7, 13)):
        v, g, m, u = adamw_inputs(torch, gen, (R, K))
        for mode in ("f32", "bf16", "int8"):
            mq, ms = qstate.encode(m, mode)
            uq, us = qstate.encode(u, mode, sqrt_domain=True)
            args = (v, g, mq, uq, ms, us, scalars)
            err, _, equal = adamw_close(torch, sparse_adamw_rows(*args),
                                        sparse_adamw_rows_plain(*args))
            rows[mode]["max_abs_err"] = max(rows[mode]["max_abs_err"], err)
            print(f"[kernels] sparse_adamw_rows ({R}, {K}) {mode} moments: "
                  f"max_abs_err={err:.3g} bit-equal={equal}", flush=True)
    return blocks, rows


def sampled_addmm_ms(torch, flush, t, x, dy, A, n, m, S):
    """library_ms of dvals: torch.sparse.sampled_addmm of x^T @ dy at each
    adapter's pattern, one batched CSR call (the row-sorted table is the
    CSR layout)."""
    Ta = x.shape[0] // A * S
    xa = x.float().reshape(A, Ta, n).transpose(1, 2).contiguous()
    dya = dy.reshape(A, Ta, m).contiguous()
    csr = torch.sparse_csr_tensor(
        t["t_ptr"].long(), t["t_rows"].long(),
        torch.zeros(t["t_rows"].shape, device="cuda"), (A, n, m))
    return cold_ms(torch, lambda: torch.sparse.sampled_addmm(
        csr, xa, dya, beta=0.0), 5, flush)


def grad_case(torch, gen, flush, label, n, m):
    """The trainable side delta at one layer's (n, m) leaf, 3 adapters at
    sparsity 0.98 and T_a = 512 tokens each, x bf16 as the multi-adapter
    forward runs it: the forward over the column-sorted table, dx through
    the forward kernel over the transposed table, each against the plain
    version beside one bmm on the densified per-request dW (dW^T for dx),
    and dvals against its plain version. dy is scaled by 1e-2, a
    gradient's size, so the f32 sums of 512 products stay within the
    absolute tolerance."""
    from repro_torch.core.masks import budget
    from repro_torch.kernels import ops
    from repro_torch.kernels.sidedelta import (_launch_dvals,
                                               _sidedelta_dvals,
                                               group_by_adapter, kernel_path,
                                               sidedelta, sidedelta_dvals,
                                               sidedelta_dvals_plain,
                                               sidedelta_plain, token_minor)
    A, S = 3, MT_SEQ
    k = budget(n, m, 0.98)
    idx = [rand_entries(torch, gen, 1, n, m, k)[0] for _ in range(A)]
    t = {key: v[0].contiguous() for key, v in ops.sidedelta_table(
        idx, 1, n, m, trainable=True).items()}
    del idx
    vals = 0.01 * torch.randn((A, k), generator=gen, device="cuda")
    vals_t = vals.gather(1, t["perm"].long()).gather(1, t["t_perm"].long())
    ids = torch.tensor(MT_IDS, dtype=torch.int32, device="cuda")
    Bt = len(MT_IDS)
    x = torch.randn((Bt, S, n), generator=gen, device="cuda").to(
        torch.bfloat16)
    dy = 0.01 * torch.randn((Bt, S, m), generator=gen, device="cuda")
    out = {}
    dx_args = (dy, t["t_rows"], vals_t, t["t_ptr"], ids)
    err = float((sidedelta(*dx_args) - sidedelta_plain(*dx_args)).abs().max())
    if not err <= SIDEDELTA_TOL:
        fail(f"sidedelta dx {label}: max_abs_err {err} > {SIDEDELTA_TOL}")
    dense = torch.zeros((A, n * m), device="cuda")
    vs = vals.gather(1, t["perm"].long())
    col = torch.repeat_interleave(torch.arange(m, device="cuda")[None]
                                  .expand(A, m).reshape(-1),
                                  torch.diff(t["colptr"].long()).reshape(-1))
    dense.scatter_(1, t["rows"].long() * m + col.reshape(A, k), vs)
    fw_args = (x, t["rows"], vs, t["colptr"], ids)
    err_fw = float((sidedelta(*fw_args)
                    - sidedelta_plain(*fw_args)).abs().max())
    if not err_fw <= SIDEDELTA_TOL:
        fail(f"sidedelta forward {label}: max_abs_err {err_fw} > "
             f"{SIDEDELTA_TOL}")
    dense_f = dense.reshape(A, n, m)[ids.long()]
    xf = x.float()
    out["forward"] = {
        "max_abs_err": err_fw,
        "ms": cold_ms(torch, lambda: sidedelta(*fw_args), 10, flush),
        "plain_ms": cold_ms(torch, lambda: sidedelta_plain(*fw_args), 2,
                            flush),
        "library_ms": cold_ms(torch, lambda: torch.bmm(xf, dense_f), 5,
                              flush),
        **bound(x.numel() * 2 + A * k * 8 + A * (m + 1) * 4 + Bt * S * m * 4,
                2 * S * k * Bt)}
    del dense_f, xf
    dense_t = dense.reshape(A, n, m).transpose(1, 2)[ids.long()]
    nbytes_dx = dy.numel() * 4 + A * k * 8 + A * (n + 1) * 4 + Bt * S * n * 4
    out["dx"] = {"max_abs_err": err,
                 "ms": cold_ms(torch, lambda: sidedelta(*dx_args), 10, flush),
                 "plain_ms": cold_ms(torch, lambda: sidedelta_plain(*dx_args),
                                     2, flush),
                 "library_ms": cold_ms(torch, lambda: torch.bmm(dy, dense_t),
                                       5, flush),
                 **bound(nbytes_dx, 2 * S * k * Bt)}
    del dense, dense_t, col
    dv_args = (x, dy, t["rows"], t["colptr"], ids)
    want = sidedelta_dvals_plain(*dv_args)
    err = float((sidedelta_dvals(*dv_args) - want).abs().max())
    # the kernel alone, on the grouping and token-minor x and dy that the
    # wrapper prepares (the backward passes dy's, shared with dx)
    order, rptr = group_by_adapter(ids, A)
    dyT, xT = token_minor(dy, order), token_minor(x, order)
    dv_out = torch.zeros((A, k), device="cuda")
    alone = lambda: _launch_dvals(xT, dyT, t["rows"], t["colptr"], rptr, S,
                                  dv_out)
    err = max(err, float((alone() - want).abs().max()))
    if not err <= SIDEDELTA_TOL:
        fail(f"sidedelta_dvals {label}: max_abs_err {err} > {SIDEDELTA_TOL}")
    del want
    nbytes_dv = x.numel() * 2 + dy.numel() * 4 + A * k * 8 + A * (m + 1) * 4
    out["dvals"] = {
        "max_abs_err": err,
        "ms": cold_ms(torch, alone, 10, flush),
        "backward_ms": cold_ms(torch, lambda: _sidedelta_dvals(
            *dv_args, grouped=(order, rptr, dyT)), 10, flush),
        "wrapper_ms": cold_ms(torch, lambda: sidedelta_dvals(*dv_args), 10,
                              flush),
        "plain_ms": cold_ms(torch, lambda: sidedelta_dvals_plain(*dv_args),
                            2, flush),
        "library_ms": sampled_addmm_ms(torch, flush, t, x, dy, A, n, m, S),
        **bound(nbytes_dv, 2 * S * k * Bt)}
    del xT, dyT, dv_out
    # the wrapper's prep for dx (and dvals, which shares it): the grouping
    # and dy in token-minor order
    prep_ms = cold_ms(torch, lambda: token_minor(
        dy, group_by_adapter(ids, A)[0]), 10, flush)
    print(f"[kernels] sidedelta {label}: grouping + token-minor dy "
          f"({Bt}, {S}, {m}) f32: {prep_ms:.4f} ms of each dx call",
          flush=True)
    for name, r in out.items():
        yard = {"forward": "bmm, dense dW", "dx": "bmm, dense dW^T",
                "dvals": "sampled_addmm"}[name]
        path = (f" path={kernel_path(Bt, S)}" if name != "dvals"
                else " kernel alone")
        print(f"[kernels] sidedelta {name} {label} ({n}x{m}) K={k}x{A} "
              f"T_a={2 * S}{path}: max_abs_err={r['max_abs_err']:.3g} (tol "
              f"{SIDEDELTA_TOL}) ms={r['ms']:.4f} plain_ms="
              f"{r['plain_ms']:.3f} library_ms({yard})="
              f"{r['library_ms']:.3f} bound_ms="
              f"{r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    r = out["dvals"]
    print(f"[kernels] sidedelta dvals {label}: as the backward calls it "
          f"(x to token-minor order) {r['backward_ms']:.4f} ms, the whole "
          f"wrapper (grouping, x and dy to token-minor order) "
          f"{r['wrapper_ms']:.4f} ms; the kernel alone "
          f"{rate_line(r, nbytes_dv)}, "
          f"{2 * Bt * S * k / r['ms'] / 1e9:.3f} TB/s of x gathered",
          flush=True)
    return out


def dvals_edge_cases(torch, gen, n, m):
    """sidedelta_dvals at (n, m) against its plain version on the
    multi-adapter batch at S = 250 (not a multiple of a vector: the
    one-token instance, which must count an unaligned launch), and at
    S = 256 with adapter 1 given no tokens (its gradient must be zero)."""
    from repro_torch.core.masks import budget
    from repro_torch.kernels import ops
    from repro_torch.kernels.sidedelta import (sidedelta_dvals,
                                               sidedelta_dvals_plain)
    A, k = 3, budget(n, m, 0.98)
    t = {key: v[0].contiguous() for key, v in ops.sidedelta_table(
        [rand_entries(torch, gen, 1, n, m, k)[0] for _ in range(A)], 1, n,
        m, trainable=True).items()}
    for S, ids, one_token in ((250, MT_IDS, True),
                              (MT_SEQ, [0, 0, 2, 2, -1, 0], False)):
        ids = torch.tensor(ids, dtype=torch.int32, device="cuda")
        x = torch.randn((len(ids), S, n), generator=gen, device="cuda").to(
            torch.bfloat16)
        dy = 0.01 * torch.randn((len(ids), S, m), generator=gen,
                                device="cuda")
        args = (x, dy, t["rows"], t["colptr"], ids)
        before = sidedelta_dvals.unaligned_launches
        got = sidedelta_dvals(*args)
        took = sidedelta_dvals.unaligned_launches - before
        err = float((got - sidedelta_dvals_plain(*args)).abs().max())
        empty = [a for a in range(A) if a not in ids.tolist()]
        zero = all(float(got[a].abs().max()) == 0.0 for a in empty)
        print(f"[kernels] sidedelta dvals ({n}x{m}) S={S} ids "
              f"{ids.tolist()}: max_abs_err={err:.3g} (tol {SIDEDELTA_TOL}),"
              f" one-token launches {took}, adapters without tokens "
              f"{empty} all zero: {zero}", flush=True)
        if not err <= SIDEDELTA_TOL or not zero:
            fail(f"sidedelta_dvals disagrees with its plain version at "
                 f"S={S}")
        if took != int(one_token):
            fail(f"sidedelta_dvals at S={S}: {took} one-token launches, "
                 f"expected {int(one_token)}")


def train_kernels_phase(torch, flush):
    from repro_torch.configs import get_config
    cfg = get_config("starcoder2-7b")
    blocks, rows = adamw_kernels(torch, flush, cfg)
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    d, f = cfg.d_model, cfg.d_ff
    kv = cfg.num_kv_heads * cfg.resolved_head_dim
    kernel_ptxas("sidedelta_grad")
    grads = {}
    for label, n, m in (("w_up", d, f), ("wq", d, d), ("wk", d, kv),
                        ("w_down", f, d)):
        grads[label] = grad_case(torch, gen, flush, label, n, m)
        torch.cuda.empty_cache()
    dvals_edge_cases(torch, gen, d, f)
    torch.cuda.empty_cache()
    return blocks, rows, grads


def attn_case(torch, flush, label, fn, plain, library, tol, nbytes, flops,
              bf16, iters=20, hi_lo=False):
    """One attention kernel against its plain version on the same inputs:
    max_abs_err within ``tol``, then cold-L2 times of the kernel, the plain
    version and the library call, and the bound from this call's bytes
    and operations. ``flops`` counts the score products (q . k) and the
    value products (p . v) alike: the scores take the bf16 tensor-core
    rate when the inputs are ``bf16``, the value products keep p in f32
    and take the f32 rate, unless ``hi_lo``: then p . v runs on the tensor
    cores as two bf16 products (p = hi + lo) and counts twice at the bf16
    rate, and the count with p . v at the f32 rate is printed beside it."""
    got = fn()
    want = plain()
    err = float((got.float() - want.float()).abs().max())
    if not err <= tol:
        fail(f"{label}: max_abs_err {err} > {tol}")
    f32_pv = bound(nbytes, flops / 2 * (1 if bf16 else 2),
                   flops / 2 if bf16 else 0)
    r = {"max_abs_err": err, "ms": cold_ms(torch, fn, iters, flush),
         "plain_ms": cold_ms(torch, plain, 3, flush),
         "library_ms": cold_ms(torch, library, 10, flush),
         **(bound(nbytes, 0, 3 * flops / 2) if hi_lo and bf16 else f32_pv)}
    print(f"[kernels] {label}: max_abs_err={err:.3g} (tol {tol}) "
          f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.3f} library_ms(sdpa)="
          f"{r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
          f"({r['bound_by']})" + (
              f" [p.v at the f32 rate: {f32_pv['bound_ms']:.4f}]"
              if hi_lo and bf16 else ""), flush=True)
    return r


def attention_kernels_phase(torch, flush):
    """flash_decode, flash_decode_paged and flash_prefill against their
    plain versions at the continuous-batching shapes of starcoder2-7b (KV
    4, G 9, D 128), bf16 (the serving dtype) and f32, within ATTN_TOL;
    then both decode kernels at granite-34b's grouping (KV 1, G 48), the
    paged kernel with pages of 8 (the engine's default) and of 24 (which
    do not divide the kernel's 64-position splits), a prefill whose length
    is no multiple of the kernel's 64-row tiles (S 777), and one small
    case (B 1, S 256, H 8, KV 2) of each kernel at each other head dim the
    wrappers take (16, 32, 64), so that every template instance they can
    reach runs once. The yardstick is one
    F.scaled_dot_product_attention(..., enable_gqa=True) call on the same
    inputs, laid out as it wants them beforehand (for paged: a gather of
    the pages, then the call)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import (decode_lengths,
                                                  flash_decode_blocks,
                                                  flash_decode_paged,
                                                  flash_decode_paged_plain,
                                                  flash_decode_plain,
                                                  paged_gather)
    from repro_torch.kernels.flash_prefill import (flash_prefill_blocks,
                                                   flash_prefill_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    Bd, KV, G, D = B, 4, 9, 128
    H = KV * G
    out = {"flash_decode": [], "flash_decode_paged": [], "flash_prefill": []}
    spread = torch.linspace(1, CACHE, Bd, device="cuda").round().to(
        torch.int32)
    for dt in (torch.bfloat16, torch.float32):
        es = 2 if dt == torch.bfloat16 else 4
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        tol, bf = ATTN_TOL[tag], dt == torch.bfloat16
        r = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)

        def decode(Bd, KV, G, D, S, kls):
            q, k, v = r(Bd, KV, G, D), r(Bd, S, KV, D), r(Bd, S, KV, D)
            qs = q.reshape(Bd, KV * G, 1, D)
            ks = k.transpose(1, 2).contiguous()
            vs = v.transpose(1, 2).contiguous()
            for name, kl in kls:
                lens = decode_lengths(kl, Bd, "cuda")
                mask = (torch.arange(S, device="cuda")[None, :]
                        < lens.long()[:, None])[:, None, None, :]
                rows = int(lens.sum())
                out["flash_decode"].append(attn_case(
                    torch, flush, f"flash_decode {tag} ({Bd},{KV},{G},{D}) "
                    f"S={S} {name}",
                    lambda: flash_decode_blocks(q, k, v, kl),
                    lambda: flash_decode_plain(q, k, v, lens),
                    lambda: F.scaled_dot_product_attention(
                        qs, ks, vs, attn_mask=mask, enable_gqa=True), tol,
                    2 * q.numel() * es + 2 * rows * KV * D * es + Bd * 4,
                    4 * rows * KV * G * D, bf))

        def prefill(Bp, Sp, H, KV, D):
            q, k, v = r(Bp, Sp, H, D), r(Bp, Sp, KV, D), r(Bp, Sp, KV, D)
            qs = q.transpose(1, 2)
            ks, vs = k.transpose(1, 2), v.transpose(1, 2)
            out["flash_prefill"].append(attn_case(
                torch, flush, f"flash_prefill {tag} causal B={Bp} S={Sp} "
                f"H={H} KV={KV} D={D}",
                lambda: flash_prefill_blocks(q, k, v, causal=True),
                lambda: flash_prefill_plain(q, k, v, True),
                lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=True, enable_gqa=True), tol,
                (2 * q.numel() + 2 * k.numel()) * es,
                4 * D * H * Bp * Sp * (Sp + 1) // 2, bf, iters=10,
                hi_lo=True))

        def paged(Bd, KV, G, D, S, page, name, kl):
            """A shuffled pool of ``page``-row pages, tables S positions
            wide; entries past each request's pages are the scratch page
            0."""
            lens = decode_lengths(kl, Bd, "cuda")
            nblk = -(-S // page)
            used = [-(-int(n) // page) for n in lens.tolist()]
            P = 1 + sum(used) + 8
            perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
            bt = torch.zeros((Bd, nblk), dtype=torch.int32, device="cuda")
            o = 0
            for b, u in enumerate(used):
                bt[b, :u] = perm[o:o + u].to(torch.int32)
                o += u
            q, kp, vp = r(Bd, KV, G, D), r(P, page, KV, D), r(P, page, KV, D)
            qs = q.reshape(Bd, KV * G, 1, D)
            mask = (torch.arange(nblk * page, device="cuda")[None, :]
                    < lens.long()[:, None])[:, None, None, :]

            def paged_sdpa():
                kk = paged_gather(kp, bt).transpose(1, 2)
                vv = paged_gather(vp, bt).transpose(1, 2)
                return F.scaled_dot_product_attention(
                    qs, kk, vv, attn_mask=mask, enable_gqa=True)
            rows = int(lens.sum())
            out["flash_decode_paged"].append(attn_case(
                torch, flush, f"flash_decode_paged {tag} ({Bd},{KV},{G},{D}) "
                f"pages of {page}, {P} pages, nblk={nblk}, {name}",
                lambda: flash_decode_paged(q, kp, vp, bt, lens),
                lambda: flash_decode_paged_plain(q, kp, vp, bt, lens),
                paged_sdpa, tol,
                2 * q.numel() * es + 2 * rows * KV * D * es + bt.numel() * 4
                + Bd * 4, 4 * rows * KV * G * D, bf))

        decode(Bd, KV, G, D, CACHE, (("(B,) kv_len 1..1056", spread),
                                     ("scalar kv_len 700", 700)))
        paged(Bd, KV, G, D, CACHE, 16, "kv_len 1..1056", spread)
        for Bp, Sp in ((1, 1024), (B, PROMPT), (1, 777)):
            prefill(Bp, Sp, H, KV, D)
        decode(Bd, 1, 48, D, CACHE, (("(B,) kv_len 1..1056", spread),))
        paged(Bd, 1, 48, D, CACHE, 16, "kv_len 1..1056", spread)
        for page in (8, 24):
            paged(Bd, KV, G, D, CACHE, page, "kv_len 1..1056", spread)
        for d in (16, 32, 64):
            prefill(1, 256, 8, 2, d)
            decode(1, 2, 4, d, 256, (("kv_len 200", 200),))
            paged(1, 2, 4, d, 256, 16, "kv_len 200", 200)
    return out


def masked_update_kernels(torch, flush):
    """masked_update at the stacked (32, 4608, 18432) w_up leaf, 1% mask,
    alpha = -3e-4: f32 W with a bool mask (the hook path's), bf16 W with a
    bool mask, f32 W with an f32 mask (the reference's masks), each held
    bit for bit against its plain version. The plain version runs layer by
    layer, on a copy of W: its f32 temporaries of the whole leaf would not
    fit beside it. The yardstick is one w.addcmul_(m, v) call on the same
    inputs (addcmul_ promotes a bool m). The bound reads W, M and V whole
    (a NaN in V or a -0 in W changes W off the mask too) and writes only
    the 32-byte sectors of W that hold a masked entry, counted on this
    run's mask: the update is in place."""
    from repro_torch.kernels.masked_update import (masked_update,
                                                   masked_update_plain)
    L, d, f = 32, 4608, 18432
    n = L * d * f
    alpha = -3e-4
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    mask = torch.empty((L, d, f), dtype=torch.bool, device="cuda")
    for i in range(L):
        mask[i] = torch.rand((d, f), generator=gen, device="cuda") < MU_DENSITY
    v = torch.randn((L, d, f), generator=gen, device="cuda")
    out = {}

    def case(label, w, m):
        bits = torch.int32 if w.dtype == torch.float32 else torch.int16
        w0, first = w.clone(), w[0].clone()
        masked_update(w, m, v, alpha)
        for i in range(L):
            masked_update_plain(w0[i], m[i], v[i], alpha)
        torch.cuda.synchronize()
        err = max(float((w[i].float() - w0[i].float()).abs().max())
                  for i in range(L))
        equal = all(bool(torch.equal(w[i].view(bits), w0[i].view(bits)))
                    for i in range(L))
        on = m[0].bool()        # the update moves masked entries only
        moved = bool((w[0] != first)[on].any()) and bool(torch.equal(
            w[0][~on].view(bits), first[~on].view(bits)))
        del first
        per = 32 // w.element_size()        # W entries a 32-byte sector
        sectors = sum(int(m[i].reshape(-1, per).ne(0).any(1).sum())
                      for i in range(L))
        if not equal or err != 0.0 or not moved:
            fail(f"masked_update {label}: not bit-equal to its plain version"
                 f" (max_abs_err {err})")
        r = {"max_abs_err": err,
             "ms": cold_ms(torch, lambda: masked_update(w, m, v, alpha), 10,
                           flush),
             "plain_ms": cold_ms(torch, lambda: [masked_update_plain(
                 w0[i], m[i], v[i], alpha) for i in range(L)], 2, flush),
             "library_ms": cold_ms(torch, lambda: w.addcmul_(
                 m, v, value=alpha), 10, flush),
             **bound(n * (w.element_size() + m.element_size() + 4)
                     + 32 * sectors, 3 * n)}
        print(f"[kernels] masked_update ({L}, {d}, {f}) {label}, "
              f"{int(m[0].count_nonzero())} of {d * f} entries a layer, "
              f"{sectors} of {n // per} W sectors written: "
              f"max_abs_err={err} bit-equal={equal} ms={r['ms']:.4f} "
              f"plain_ms(layer by layer)={r['plain_ms']:.3f} "
              f"library_ms(addcmul_)={r['library_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
        out[label] = r
        del w0

    w = torch.randn((L, d, f), generator=gen, device="cuda")
    case("f32 W, bool M", w, mask)
    del w
    w = torch.randn((L, d, f), generator=gen, device="cuda").to(
        torch.bfloat16)
    case("bf16 W, bool M", w, mask)
    del w
    mask_f = mask.float()
    del mask
    torch.cuda.empty_cache()
    w = torch.randn((L, d, f), generator=gen, device="cuda")
    case("f32 W, f32 M", w, mask_f)
    del w, mask_f, v
    return out


def serve_phase(torch):
    from repro_torch.launch import serve
    common = ["--arch", "starcoder2-7b", "--batch", str(B), "--prompt-len",
              str(PROMPT), "--tokens", str(TOKENS), "--adapters", "3"]
    attn = ("flash_prefill", "flash_decode")
    modes = [("sequential", [], ("scatter_apply",) + attn),
             ("fuse", ["--fuse"], ("scatter_apply",) + attn),
             ("multi-tenant f32", ["--multi-tenant", "--skew", "0.8"],
              ("sidedelta", "scatter_apply") + attn),
             ("multi-tenant int8", ["--multi-tenant", "--int8", "--skew",
                                    "0.8"],
              ("sidedelta", "scatter_apply") + attn)]
    totals = {}
    torch.cuda.reset_peak_memory_stats()
    for label, extra, needed in modes:
        zero_counts()
        t0 = time.perf_counter()
        stats = serve.main(common + extra)
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_counts().items() if v}
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
        check_run(f"serve {label}", read_counts(), needed, totals)
        del stats, out                 # the next mode builds its own model
        torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[serve] peak memory {peak:.1f} GB (max_memory_allocated)",
          flush=True)
    from repro_torch.configs import get_config
    b, entries, sectors = switch_bound(torch, get_config("starcoder2-7b"))
    print(f"[serve] a switch's bound (one adapter load, {entries} entries, "
          f"{sectors} W sectors read and written): {b['bound_ms']:.4f} ms "
          f"({b['bound_by']})", flush=True)
    torch.cuda.empty_cache()
    return totals


def continuous_trace(vocab: int, packs):
    """The full-width request trace, from seed 0: 24 requests, prompt
    lengths uniform in 64..1024, 12 of the prompts at least 257 tokens long
    beginning with one 256-token system prefix; adapters drawn as
    ``serve --multi-tenant`` draws them (skew 0.8 to the first, the rest
    over the others and the base model), and requests 5 and 17 on the base
    model. Returns [(prompt int32, adapter)]."""
    import numpy as np
    from repro_torch.launch.serve import tenant_mix
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 1025, CC_REQUESTS)
    prefix = rng.integers(0, vocab, 256).astype(np.int32)
    shared = [i for i in range(CC_REQUESTS) if lens[i] > 256][:12]
    adapters = [tenant_mix(rng, packs, 1, 0.8)[0]
                for _ in range(CC_REQUESTS)]
    for i in (5, 17):
        adapters[i] = None
    trace = []
    for i, n in enumerate(lens):
        p = rng.integers(0, vocab, int(n)).astype(np.int32)
        if i in shared:
            p[:256] = prefix
        trace.append((p, adapters[i]))
    return trace


def drive(torch, engine, trace, max_tokens, profile_from=5):
    """Submit the whole trace at once, then step the engine until every
    request resolved; returns (futures, wall seconds, peak resident
    requests, per-step numbers, profiles), synchronized. Each step's
    host-clock time is kept with whether it admitted a request (lanes) or
    ran a prefill chunk (pages). Engine step ``profile_from`` runs under
    torch.profiler, and after it each step that follows a step of a kind
    (decode-only, or with a prefill) not yet profiled, since kinds come in
    runs: profiles maps "decode-only" and "prefill" to (engine step,
    profile), the first of each; profiled steps are left out of the
    per-step times."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = [engine.submit(p, a, max_tokens=max_tokens) for p, a in trace]
    peak, steps, profs, last = 0, [], {}, None
    while engine.pending():
        admitted = sum(f.submitted_step is not None for f in futs)
        chunks = getattr(engine, "prefill_chunks", 0)
        at = engine.step_count
        ts = time.perf_counter()
        prof = None
        if at == profile_from or (at > profile_from
                                  and last not in profs):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                engine.step()
                torch.cuda.synchronize()
        else:
            engine.step()
            torch.cuda.synchronize()
        wall = time.perf_counter() - ts
        prefilled = (sum(f.submitted_step is not None for f in futs)
                     > admitted
                     or getattr(engine, "prefill_chunks", 0) > chunks)
        last = "prefill" if prefilled else "decode-only"
        if prof is None:
            steps.append((wall, prefilled))
        else:
            profs.setdefault(last, (at + 1, prof))
        peak = max(peak, sum(a is not None for a in engine._active))
    torch.cuda.synchronize()
    return futs, time.perf_counter() - t0, peak, steps, profs


def step_report(label, steps, profs):
    """Median host-clock ms of decode-only steps and of steps that
    prefilled, and each profiled step's device time by kernel."""
    import statistics
    import torch
    dec = [t for t, pf in steps if not pf]
    pre = [t for t, pf in steps if pf]
    med = lambda xs: statistics.median(xs) * 1e3 if xs else float("nan")
    line = (f"[continuous] {label} steps (profiled ones left out): "
            f"{len(dec)} decode-only, median {med(dec):.1f} ms; {len(pre)} "
            f"with a prefill, median {med(pre):.1f} ms")
    print(line, flush=True)
    for kind, (at, prof) in sorted(profs.items()):
        kern = device_kernels(torch, prof)
        busy = sum(k[0] for k in kern)
        print(f"[profile] {label} engine step {at}, {kind} (profiler on): "
              f"kernels {busy:.2f} ms" + ("" if busy else
                                          " (profiler saw no device time: "
                                          "not measured)"), flush=True)
        for ms, n, name in sorted(kern, reverse=True)[:6]:
            print(f"[profile]   {ms:8.3f} ms  x{n:<5d} {name[:90]}")
        kernel_share(f"{label} step {at}", kern)


def report_engine(torch, label, engine, futs, wall, peak, vocab, needed,
                  totals):
    """Print one engine's numbers and fail unless every future is done
    with in-range tokens and every kernel of its path launched."""
    import numpy as np
    counts = read_counts()
    ttft = np.array([f.ttft for f in futs])
    kv_gb = engine.kv_cache_bytes() / 1e9
    outs = [f.result() for f in futs]
    ok = all(f.done() and f.error is None for f in futs) and all(
        len(o) == CC_TOKENS and 0 <= int(o.min()) and int(o.max()) < vocab
        for o in outs)
    extra = ""
    if hasattr(engine, "pool"):
        extra = (f", COW copies {engine.pool.cow_copies}, prefill chunks "
                 f"{engine.prefill_chunks}, prefix hits "
                 f"{engine.pool.prefix_hits} ({engine.pool.prefix_shared_tokens}"
                 f" tokens), peak pages {engine.peak_used_pages}")
    print(f"[continuous] {label}: {len(futs)} requests, {engine.tokens_out} "
          f"tokens in {wall:.2f}s ({engine.tokens_out / wall:.1f} tok/s), "
          f"TTFT p50 {np.percentile(ttft, 50):.3f}s p99 "
          f"{np.percentile(ttft, 99):.3f}s, {engine.step_count} decode steps,"
          f" {engine.decode_slot_waste} idle-lane steps, peak resident "
          f"{peak} requests, KV {kv_gb:.3f} GB ({peak / kv_gb:.1f} resident "
          f"requests per GB){extra}, launches "
          f"{ {k: v for k, v in counts.items() if v} }, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB", flush=True)
    if not ok:
        fail(f"continuous {label}: a request failed or its tokens are out "
             "of range")
    check_run(f"continuous {label}", counts, needed, totals)
    return outs


def continuous_phase(torch):
    """Continuous batching at full width: ``serve --continuous --int8``
    (the CLI, int8 packs and tables), then the 24-request trace through
    ServingEngine (8 lanes of 1056 rows) and PagedServingEngine (8 slots,
    321 pages of 16 rows, about 61% of the lanes' KV bytes, chunks of 256)
    over an AdapterStore of 3 f32 packs in a temporary directory, one
    engine after the other on one copy of the base."""
    import tempfile
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.hub import AdapterStore, PagedServingEngine, ServingEngine
    from repro_torch.launch import serve
    from repro_torch.models import lm
    totals = {}
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = serve.main(["--arch", "starcoder2-7b", "--continuous", "--int8",
                        "--requests", str(B), "--slots", str(B),
                        "--prompt-len", "64", "--tokens", "8",
                        "--adapters", "3", "--skew", "0.8"])
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"[continuous] serve --continuous --int8 ({B} requests, prompt 64,"
          f" 8 tokens, {B} lanes): {stats['done']}/{stats['requests']} done,"
          f" {stats['tok_s']:.1f} tok/s, {stats['steps']} decode steps, "
          f"launches { {k: v for k, v in counts.items() if v} }, "
          f"{time.perf_counter() - t0:.1f}s wall", flush=True)
    if stats["done"] != stats["requests"] or any(
            int(o.min()) < 0 or int(o.max()) >= 49152 for o in stats["outs"]):
        fail("serve --continuous: a request failed or is out of range")
    check_run("serve --continuous", counts,
              ("flash_prefill", "flash_decode", "sidedelta"), totals)
    del stats
    torch.cuda.empty_cache()

    cfg = get_config("starcoder2-7b")
    params = lm.init_params(cfg, seed=0, device="cuda")
    packs = serve.make_adapters(cfg, params, 3)
    trace = continuous_trace(cfg.vocab_size, packs)
    with tempfile.TemporaryDirectory(prefix="adapter-store-") as root:
        t0 = time.perf_counter()
        store = AdapterStore(root)
        for p in packs:
            store.add(p)
        del packs
        torch.cuda.empty_cache()
        print(f"[continuous] store: {len(store.names())} f32 packs written in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        outs = {}
        for label, make, needed in (
                ("ServingEngine", lambda: ServingEngine(
                    cfg, params, slots=B, cache_size=CACHE, store=store),
                 ("flash_prefill", "flash_decode", "sidedelta")),
                ("PagedServingEngine", lambda: PagedServingEngine(
                    cfg, params, slots=B, num_pages=321, page_size=16,
                    chunk_size=CHUNK, store=store),
                 ("flash_decode_paged", "sidedelta"))):
            zero_counts()
            torch.cuda.reset_peak_memory_stats()
            engine = make()
            futs, wall, peak, steps, profs = drive(torch, engine, trace,
                                                   CC_TOKENS)
            if hasattr(engine, "peak_resident"):
                peak = engine.peak_resident
            outs[label] = report_engine(torch, label, engine, futs, wall,
                                        peak, cfg.vocab_size, needed, totals)
            step_report(label, steps, profs)
            del engine, futs
            torch.cuda.empty_cache()
    pairs = list(zip(outs["ServingEngine"], outs["PagedServingEngine"]))
    same = sum(bool((a == b).all()) for a, b in pairs)
    first = sum(int(a[0]) == int(b[0]) for a, b in pairs)
    split = {i: int(np.argmax(a != b)) for i, (a, b) in enumerate(pairs)
             if not (a == b).all()}
    print(f"[continuous] bf16: {same}/{len(trace)} requests token-equal "
          f"across the two engines, {first}/{len(trace)} first tokens equal;"
          f" request: first differing token {split}", flush=True)
    del params
    return totals


def continuous_consistency_phase(torch):
    """Both engines against the fixed batch: full widths cut to 2 layers,
    f32. Each request's tokens from ServingEngine and PagedServingEngine
    must equal its own MultiTenantEngine.generate tokens, on a trace with
    a shared prefix (COW), one prompt under two adapters, an adapter
    stack, the base model and a 601-token prompt that the paged engine
    prefills in three chunks of up to 256; the paged engine must share
    prefix pages and copy on write."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.hub import PagedServingEngine, ServingEngine
    from repro_torch.launch import serve
    from repro_torch.models import layers, lm
    from repro_torch.serving import MultiTenantEngine
    cfg = get_config("starcoder2-7b").replace(num_layers=2)
    T = 8
    rng = np.random.default_rng(7)
    tok = lambda n: rng.integers(0, cfg.vocab_size, n).astype(np.int32)
    prefix = tok(40)
    first = (np.concatenate([prefix, tok(10)]), "adapter_0")
    same = tok(37)
    rest = [(np.concatenate([prefix, tok(23)]), "adapter_0"),
            (same, "adapter_1"), (same, "adapter_2"),
            (tok(70), ("adapter_0", "adapter_1")), (tok(19), None),
            (tok(601), "adapter_1"), first]
    trace = [first] + rest
    with layers.compute_precision(torch.float32):
        params = lm.init_params(cfg, seed=0, device="cuda")
        packs = serve.make_adapters(cfg, params, 3)
        mt = MultiTenantEngine(cfg, params)
        for p in packs:
            mt.register(p)
        want = [mt.generate({"tokens": torch.from_numpy(p[None].copy()).to(
            "cuda")}, [a], T)[0][0].cpu().numpy() for p, a in trace]
        se = ServingEngine(cfg, params, slots=3, cache_size=640)
        pe = PagedServingEngine(cfg, params, slots=3, num_pages=80,
                                page_size=16, chunk_size=256)
        for e in (se, pe):
            for p in packs:
                e.register(p)
        lane = [se.submit(p, a, max_tokens=T) for p, a in trace]
        se.run()
        # the first request's prompt pages are registered before the rest
        # arrive, so they can share its prefix
        paged = [pe.submit(*first, max_tokens=T)]
        while not paged[0].tokens:
            pe.step()
        paged += [pe.submit(p, a, max_tokens=T) for p, a in rest]
        pe.run()
    for label, futs in (("ServingEngine", lane),
                        ("PagedServingEngine", paged)):
        equal = [bool(np.array_equal(f.result(), w))
                 for f, w in zip(futs, want)]
        print(f"[continuous-consistency] f32, 2 layers, full width, {label}:"
              f" {sum(equal)}/{len(equal)} requests token-equal to the fixed "
              f"batch", flush=True)
        if not all(equal):
            fail(f"continuous-consistency: {label} differs from the fixed "
                 f"batch on requests "
                 f"{[i for i, e in enumerate(equal) if not e]}")
    print(f"[continuous-consistency] paged: prefix hits "
          f"{pe.pool.prefix_hits} ({pe.pool.prefix_shared_tokens} tokens), "
          f"COW copies {pe.pool.cow_copies}, prefill chunks "
          f"{pe.prefill_chunks}", flush=True)
    if pe.pool.prefix_hits < 2 or pe.pool.cow_copies < 1:
        fail("continuous-consistency: the paged engine did not share the "
             "prefix pages or copy on write")


PZ_PUBLISH_STEP = 10     # personalization: adapter_0@2 after this step
PZ_LANES = B             # 8 lanes, as the continuous phase


def pz_store(root, files, one):
    """A store over the three published adapter_i@1 files: a resident
    budget of one pack (the others are cold) and a pinned staging tier of
    two."""
    from repro_torch.hub import AdapterStore
    store = AdapterStore(root, budget_bytes=int(1.5 * one),
                         staging_bytes=int(2.5 * one))
    for f in files:
        store.register_file(f)
    return store


def pz_drive(torch, engine, store, trace_reqs, v2, max_tokens):
    """Submit the first half of the trace, step the engine, publish v2 (as
    adapter_0's next version) after step PZ_PUBLISH_STEP and submit the
    rest, then step until every request resolved. Returns (futures, wall
    seconds, per-step (wall s, prefilled, build in flight), the steps at
    which a request on adapter_0@1 was still open and adapter_0@1 had left
    the engine, peak staged bytes)."""
    half = len(trace_reqs) // 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = [engine.submit(p, a, max_tokens=max_tokens)
            for p, a in trace_reqs[:half]]
    steps, early, staged, published = [], [], 0, False
    mt = engine.engine
    while engine.pending() or not published:
        if not published and (engine.step_count >= PZ_PUBLISH_STEP
                              or not engine.pending()):
            store.publish(v2)
            futs += [engine.submit(p, a, max_tokens=max_tokens)
                     for p, a in trace_reqs[half:]]
            published = True
        admitted = sum(f.submitted_step is not None for f in futs)
        chunks = getattr(engine, "prefill_chunks", 0)
        kicked = mt.async_builds
        bf = mt._build_fut is not None and not mt._build_fut[1].done()
        ts = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - ts
        # a build ran beside this step: in flight when it began, kicked
        # during it, or still running when it ended
        bf = bf or mt.async_builds > kicked or (
            mt._build_fut is not None and not mt._build_fut[1].done())
        prefilled = (sum(f.submitted_step is not None for f in futs)
                     > admitted
                     or getattr(engine, "prefill_chunks", 0) > chunks)
        steps.append((wall, prefilled, bf))
        if "adapter_0@1" not in mt.packs and any(
                f.adapter == "adapter_0@1" and not f.done() for f in futs):
            early.append(engine.step_count)
        staged = max(staged, store.staged_bytes())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # a build kicked by the last steps (the retirement's) is settled, so
    # that every build is adopted, found stale, or raises here
    if mt._build_fut is not None:
        futures.wait([mt._build_fut[1]])
        mt.poll_async_build()
    return futs, wall, steps, early, staged


def pz_thread_ms(tr):
    """Milliseconds of the pipeline's spans by (name, thread): disk reads
    (``disk_load`` on the serving thread, ``prefetch.disk`` on a store
    worker), pinning into staging (``dequant``, ``prefetch.decode``),
    table builds (``table_rebuild``, ``prefetch.h2d`` on the build
    worker) and the waits for them (``prefetch.stall``)."""
    out = {}
    for e in tr.events():
        if e["ph"] == "X" and e["name"] in (
                "prefetch.stall", "prefetch.disk", "prefetch.decode",
                "prefetch.h2d", "disk_load", "dequant", "table_rebuild"):
            k = f"{e['name']}@tid{e['tid']}"
            out[k] = round(out.get(k, 0.0) + e["dur"] / 1e3, 1)
    return out


def pz_time_demote(torch, mt, demote_ms):
    """Time each un-fuse of adapter_0@1 (the scatter_apply demote) with
    CUDA events, noting whether the scheduler or the retirement
    (``unregister``) asked for it; the one synchronization is this
    measurement's. Returns a function that removes the wrappers."""
    from repro_torch.core.switching import tenant_members
    demote, unregister = mt._demote, mt.unregister
    why = ["scheduler"]

    def timed():
        if "adapter_0@1" not in tenant_members(mt.fused):
            return demote()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        demote()
        e1.record()
        e1.synchronize()
        demote_ms.append((why[0], round(e0.elapsed_time(e1), 3)))

    def retiring(name):
        why[0] = "retirement"
        try:
            return unregister(name)
        finally:
            why[0] = "scheduler"
    mt._demote, mt.unregister = timed, retiring

    def undo():
        del mt._demote, mt.unregister
    return undo


def personalization_phase(torch):
    """The personalization loop at full width (starcoder2-7b, bf16
    compute): three f32 packs at sparsity 0.98 published as adapter_i@1
    into a store whose resident budget holds one pack and whose pinned
    staging tier holds two; the continuous phase's 24-request trace (seed
    0, prompts of 64..1024, skew 0.8), the first 12 submitted at once, and
    after step 10 adapter_0@2 is published (values from a numpy seed) and
    the other 12 submitted. Through ServingEngine (8 lanes) and
    PagedServingEngine (321 pages of 16), each with a FusedLRU and
    slot_pad=4, with async_prefetch off and on, traced. FusedLRU's
    promote_at is 0.3, so that adapter_0@1 is fused before the swap and
    its un-fuse, the paper's rapid switch on a live server, is timed."""
    import gc
    import tempfile
    import numpy as np
    from repro_torch.analysis import trace
    from repro_torch.configs import get_config
    from repro_torch.core import FusedLRU
    from repro_torch.core.adapters import AdapterPack, map_entries
    from repro_torch.hub import PagedServingEngine, ServingEngine, save_pack
    from repro_torch.launch import serve
    from repro_torch.models import lm
    totals = {}
    cfg = get_config("starcoder2-7b")
    params = lm.init_params(cfg, seed=0, device="cuda")
    packs = serve.make_adapters(cfg, params, 3)
    trace_reqs = continuous_trace(cfg.vocab_size, packs)
    one = packs[0].nbytes()
    rng = np.random.default_rng(21)
    v2 = AdapterPack("adapter_0", {p: (i.cpu(), torch.from_numpy(
        (0.01 * rng.standard_normal(tuple(v.shape))).astype(np.float32)))
        for p, (i, v) in packs[0].entries.items()})
    outs, base = {}, 0
    with tempfile.TemporaryDirectory(prefix="personalize-") as root:
        t0 = time.perf_counter()
        files = [save_pack(map_entries(p, name=f"{p.name}@1"),
                           f"{root}/{p.name}@1.shpk") for p in packs]
        del packs
        torch.cuda.empty_cache()
        print(f"[personalization] 3 f32 packs published as adapter_i@1 "
              f"({one / 1e9:.2f} GB each) in {time.perf_counter() - t0:.1f}s"
              f"; store budget {1.5 * one / 1e9:.2f} GB (one pack), pinned "
              f"staging {2.5 * one / 1e9:.2f} GB (two)", flush=True)
        for label, make, needed in (
                ("ServingEngine", lambda **kw: ServingEngine(
                    cfg, params, slots=PZ_LANES, cache_size=CACHE, **kw),
                 ("flash_prefill", "flash_decode", "sidedelta",
                  "scatter_apply")),
                ("PagedServingEngine", lambda **kw: PagedServingEngine(
                    cfg, params, slots=PZ_LANES, num_pages=321, page_size=16,
                    chunk_size=CHUNK, **kw),
                 ("flash_decode_paged", "sidedelta", "scatter_apply"))):
            for mode in (False, True):
                tag = f"{label} async_prefetch={mode}"
                store = pz_store(f"{root}/{label}-{mode}", files, one)
                zero_counts()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                base = base or before
                print(f"[personalization] {tag}: {before / 1e9:.1f} GB "
                      f"allocated before the engine (the base: "
                      f"{base / 1e9:.1f} GB before the first)", flush=True)
                if before - base > 2 ** 30:
                    fail(f"personalization {tag}: "
                         f"{(before - base) / 1e9:.1f} GB of an earlier "
                         "run are still allocated")
                # promote_at 0.3: adapter_0@1 (3 of the first 8 live
                # lanes) is fused before the publish and un-fused after
                eng = make(store=store, scheduler=FusedLRU(promote_at=0.3),
                           slot_pad=4, async_prefetch=mode)
                demote_ms = []
                undo = pz_time_demote(torch, eng.engine, demote_ms)
                tr = trace.install(trace.Tracer(capacity=1 << 20))
                try:
                    futs, wall, steps, early, staged = pz_drive(
                        torch, eng, store, trace_reqs, v2, CC_TOKENS)
                finally:
                    trace.uninstall()
                counts = read_counts()
                outs[label, mode] = pz_report(
                    torch, tag, eng, store, futs, wall, steps, early, staged,
                    tr, demote_ms, cfg.vocab_size, needed, counts, totals)
                undo()
                eng.engine.close()          # un-fuse: the base is back
                eng.shutdown(include_store=True)
                # undo's closure holds the engine: dropped with it, or its
                # tables and packs stay allocated into the next run
                del eng, store, futs, tr, undo
                gc.collect()
                torch.cuda.empty_cache()
    for label in ("ServingEngine", "PagedServingEngine"):
        a, b = outs[label, False], outs[label, True]
        same = sum(bool((x == y).all()) for x, y in zip(a, b))
        print(f"[personalization] bf16 {label}: {same}/{len(a)} requests "
              f"token-equal between async_prefetch off and on (reported, "
              f"not held)", flush=True)
    del params
    return totals


def pz_report(torch, tag, eng, store, futs, wall, steps, early, staged, tr,
              demote_ms, vocab, needed, counts, totals):
    """Print one run's numbers and hold its invariants."""
    import statistics
    import numpy as np
    mt = eng.engine
    total = torch.cuda.get_device_properties(0).total_memory
    reserved = torch.cuda.max_memory_reserved()
    outs = [f.result() if f.error is None else None for f in futs]
    ok = all(f.done() and f.error is None for f in futs) and all(
        o is not None and len(o) == CC_TOKENS and 0 <= int(o.min())
        and int(o.max()) < vocab for o in outs)
    if not ok:
        fail(f"personalization {tag}: a request failed or its tokens are "
             "out of range")
    half = len(futs) // 2
    want = ["adapter_0@1"] * half + ["adapter_0@2"] * (len(futs) - half)
    wrong = [i for i, f in enumerate(futs)
             if f.adapter in ("adapter_0@1", "adapter_0@2")
             and f.adapter != want[i]]
    if wrong:
        fail(f"personalization {tag}: requests {wrong} resolved to the "
             "wrong version of adapter_0")
    evs = tr.events()
    evicted = [e for e in evs if e["name"] == "hotswap.evict"
               and e["args"].get("name") == "adapter_0@1"]
    if early or len(evicted) != 1 or "adapter_0@1" in mt.packs \
            or store.is_resident("adapter_0@1") or eng._vpins:
        fail(f"personalization {tag}: adapter_0@1 retired at steps {early} "
             f"with a request open, {len(evicted)} hotswap.evict, still "
             f"registered {'adapter_0@1' in mt.packs}, resident "
             f"{store.is_resident('adapter_0@1')}, pins {eng._vpins}")
    failed = sum(e["name"] == "prefetch.h2d_failed" for e in evs)
    if (failed or mt.async_failed or mt._build_fut is not None
            or mt.async_builds != mt.async_adopted + mt.async_stale):
        fail(f"personalization {tag}: background builds {mt.async_builds} "
             f"are not all adopted ({mt.async_adopted}) or stale "
             f"({mt.async_stale}): {mt.async_failed} failed, {failed} "
             f"prefetch.h2d_failed events, in flight "
             f"{mt._build_fut is not None}")
    neg = [e["name"] for e in evs if e["dur"] < 0]
    if neg or any(tr._depths.values()) or tr.dropped:
        fail(f"personalization {tag}: trace has negative durations {neg}, "
             f"open depths {tr._depths}, {tr.dropped} dropped events")
    ttft = lambda fs: (np.percentile([f.ttft for f in fs], 50),
                       np.percentile([f.ttft for f in fs], 99)) if fs else (
                           float("nan"),) * 2
    cold = ttft([f for f in futs if f.cold])
    hot = ttft([f for f in futs if not f.cold])
    med = lambda xs: statistics.median(xs) * 1e3 if xs else float("nan")
    dec = [w for w, pf, _ in steps if not pf]
    dec_build = [w for w, pf, bf in steps if not pf and bf]
    dec_plain = [w for w, pf, bf in steps if not pf and not bf]
    print(f"[personalization] {tag}: {len(futs)} requests, "
          f"{eng.tokens_out} tokens in {wall:.2f}s "
          f"({eng.tokens_out / wall:.1f} tok/s), TTFT cold "
          f"({sum(f.cold for f in futs)}) p50 {cold[0]:.3f}s p99 "
          f"{cold[1]:.3f}s, hot p50 {hot[0]:.3f}s p99 {hot[1]:.3f}s; "
          f"{eng.step_count} steps, decode-only step median {med(dec):.1f} "
          f"ms, with a build in flight {med(dec_build):.1f} ms "
          f"({len(dec_build)} steps), without {med(dec_plain):.1f} ms "
          f"({len(dec_plain)} steps); spans by thread (ms) {pz_thread_ms(tr)}"
          f"; async_builds {mt.async_builds} async_adopted "
          f"{mt.async_adopted} async_stale {mt.async_stale} async_failed "
          f"{mt.async_failed}; fuse "
          f"transitions {mt.fuse_transitions}, un-fuse of adapter_0@1 "
          f"(scatter_apply, by whom, ms) {demote_ms}; store "
          f"loads {store.loads}, evictions {store.evictions}, peak pinned "
          f"staging {staged / 1e9:.2f} GB; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB allocated, "
          f"{reserved / 1e9:.1f} GB reserved of {total / 1e9:.1f} GB "
          f"(headroom {(total - reserved) / 1e9:.1f} GB); launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    check_run(f"personalization {tag}", counts, needed, totals)
    return outs


def pz_consistency_phase(torch):
    """The hot swap at full width cut to 2 layers, f32: each request
    through the swap (ServingEngine and PagedServingEngine, FusedLRU,
    slot_pad=4, async_prefetch off and on) gives the tokens of a run of
    the same engine that only ever saw the version it resolved to."""
    import tempfile
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import FusedLRU
    from repro_torch.core.adapters import map_entries
    from repro_torch.hub import (AdapterStore, PagedServingEngine,
                                 ServingEngine)
    from repro_torch.core.masks import map_leaves
    from repro_torch.launch import serve
    from repro_torch.models import layers, lm
    cfg = get_config("starcoder2-7b").replace(num_layers=2)
    T = 8
    rng = np.random.default_rng(11)
    tok = lambda n: rng.integers(0, cfg.vocab_size, n).astype(np.int32)
    first = [(tok(40), "adapter_0"), (tok(23), "adapter_1"),
             (tok(301), "adapter_0"), (tok(17), None)]
    second = [(tok(33), "adapter_0"), (tok(280), "adapter_0"),
              (tok(12), "adapter_1")]
    with layers.compute_precision(torch.float32), \
            tempfile.TemporaryDirectory(prefix="pz-consistency-") as root:
        params = lm.init_params(cfg, seed=0, device="cuda")
        packs = serve.make_adapters(cfg, params, 2)
        v2 = map_entries(packs[1], name="adapter_0")   # other values

        def make(kind, store, base=params, **kw):
            if kind == "lane":
                return ServingEngine(cfg, base, slots=3, cache_size=400,
                                     store=store, **kw)
            return PagedServingEngine(cfg, base, slots=3, num_pages=80,
                                      page_size=16, chunk_size=256,
                                      store=store, **kw)

        def single(kind, mode, pack_for_0, reqs, sub):
            store = AdapterStore(f"{root}/{sub}")
            store.publish(map_entries(pack_for_0, name="adapter_0"))
            store.publish(packs[1])
            eng = make(kind, store, async_prefetch=mode)
            futs = [eng.submit(p, a, max_tokens=T) for p, a in reqs]
            eng.run()
            eng.shutdown(include_store=True)
            return [f.result() for f in futs]

        for kind in ("lane", "paged"):
            for mode in (False, True):
                store = AdapterStore(f"{root}/{kind}-{mode}")
                store.publish(packs[0])
                store.publish(packs[1])
                # fusion updates the base in place: each swap run gets
                # its own copy, and the references the untouched one
                eng = make(kind, store, map_leaves(lambda _, x: x.clone(),
                                                   params),
                           scheduler=FusedLRU(promote_at=0.3), slot_pad=4,
                           async_prefetch=mode)
                futs = [eng.submit(p, a, max_tokens=T) for p, a in first]
                for _ in range(3):
                    eng.step()
                store.publish(v2)
                futs += [eng.submit(p, a, max_tokens=T) for p, a in second]
                eng.run()
                eng.shutdown(include_store=True)
                got = [f.result() for f in futs]
                vers = [f.adapter for f in futs]
                want = (single(kind, mode, packs[0], first,
                               f"{kind}-{mode}-v1")
                        + single(kind, mode, v2, second, f"{kind}-{mode}-v2"))
                equal = [bool(np.array_equal(g, w))
                         for g, w in zip(got, want)]
                print(f"[personalization-consistency] f32, 2 layers, full "
                      f"width, {kind} async_prefetch={mode}: {sum(equal)}/"
                      f"{len(equal)} requests through the swap token-equal "
                      f"to single-version runs; versions {vers}; fuse "
                      f"transitions {eng.engine.fuse_transitions}",
                      flush=True)
                if not all(equal) or vers[0] != "adapter_0@1" \
                        or vers[4] != "adapter_0@2" \
                        or "adapter_0@1" in eng.engine.packs:
                    fail(f"personalization-consistency: {kind} "
                         f"async_prefetch={mode} differs on requests "
                         f"{[i for i, e in enumerate(equal) if not e]} "
                         f"(versions {vers})")
                del eng


def profile_phase(torch):
    """Where a full-width decode step (B=8) spends its device time: the
    base model, and multi-tenant with every request on an adapter or the
    base; then one batch-1, 1024-token prefill of the base model, a lane
    admission's unit of work. Device time per kernel from torch.profiler;
    wall time from the host clock around synchronized steps (decode: mean
    of 3; prefill: one, after a warm-up; profiler off)."""
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
        kern = device_kernels(torch, prof)
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

    # a lane admission's unit of work: one batch-1, 1024-token prefill
    tokens = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen,
                           device="cuda")

    def prefill():
        lm.prefill(params, cfg, {"tokens": tokens}, CACHE)
        torch.cuda.synchronize()
    prefill()
    t0 = time.perf_counter()
    prefill()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prefill()
    kern = device_kernels(torch, prof)
    busy = sum(k[0] for k in kern)
    fp = sum(ms for ms, _, name in kern if "flash_prefill" in name)
    print(f"[profile] base prefill (B=1, S=1024, {cfg.num_layers} layers): "
          f"wall {wall:.2f} ms; kernels {busy:.2f} ms"
          + (f"; flash_prefill {fp:.3f} ms ({fp / busy:.1%})" if busy else
             " (profiler saw no device time: not measured)"), flush=True)
    for ms, n, name in sorted(kern, reverse=True)[:8]:
        print(f"[profile]   {ms:8.3f} ms  x{n:<4d} {name[:90]}")


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


KERNEL_COUNTERS = ("sidedelta", "sidedelta_dvals", "scatter_apply",
                   "sparse_adamw_blocks", "sparse_adamw_rows", "flash_decode",
                   "flash_decode_paged", "flash_prefill", "masked_update")


def counters():
    """The launch counter of every kernel wrapper of the port, by the
    kernel's name in the summary."""
    from repro_torch.kernels.flash_decode import (flash_decode_blocks,
                                                  flash_decode_paged)
    from repro_torch.kernels.flash_prefill import flash_prefill_blocks
    from repro_torch.kernels.masked_update import masked_update
    from repro_torch.kernels.scatter_apply import scatter_apply
    from repro_torch.kernels.sidedelta import sidedelta, sidedelta_dvals
    from repro_torch.kernels.sparse_adamw import (sparse_adamw,
                                                  sparse_adamw_rows)
    return dict(zip(KERNEL_COUNTERS, (sidedelta, sidedelta_dvals,
                                      scatter_apply, sparse_adamw,
                                      sparse_adamw_rows, flash_decode_blocks,
                                      flash_decode_paged,
                                      flash_prefill_blocks, masked_update)))


def zero_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


def check_run(label, counts, needed, totals):
    for k in needed:
        if counts[k] <= 0:
            fail(f"{label}: kernel {k} was never launched")
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v


def train_phase(torch):
    """Full-width training through the entry points a user calls: the
    launch.train CLI (one packed adapter, Trainer), then
    MultiAdapterTrainer with 3 adapters, f32 then int8 moments."""
    import math
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import (AdapterConfig, RunConfig, ShapeSpec,
                                     TrainConfig, get_config)
    from repro_torch.launch import train
    from repro_torch.kernels.sidedelta import sidedelta_dvals
    from repro_torch.kernels.sparse_adamw import (sparse_adamw,
                                                  sparse_adamw_rows)
    from repro_torch.training import MultiAdapterTrainer
    totals = {}
    zero_counts()
    sparse_adamw.unaligned_launches = sparse_adamw_rows.unaligned_launches = 0
    sidedelta_dvals.unaligned_launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = train.main(["--arch", "starcoder2-7b", "--adapter", "shira-rand",
                        "--seq", str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH),
                        "--steps", str(TRAIN_STEPS)], keep=True)
    torch.cuda.synchronize()
    counts = read_counts()
    losses = stats["losses"]
    print(f"[train] Trainer (launch.train, {TRAIN_BATCH}x{TRAIN_SEQ} tokens,"
          f" {stats['trained_values']} packed values): launches {counts}, "
          f"step {stats['steady_step_ms']:.1f} ms (median after the first; "
          f"all {[round(x, 1) for x in stats['step_ms']]}), "
          f"{stats['tokens_per_s']:.0f} tokens/s, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB, "
          f"{time.perf_counter() - t0:.1f}s wall", flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail("Trainer: a loss is not finite")
    check_run("Trainer", counts, ("scatter_apply", "sparse_adamw_blocks"),
              totals)
    tr, state = stats.pop("trainer"), stats.pop("state")
    publish_check(torch, "Trainer", lambda store: [
        tr.publish(store, state, "adapter")], [tr.export_pack(state,
                                                             "adapter")])
    del stats, tr, state
    torch.cuda.empty_cache()

    run = RunConfig(model=get_config("starcoder2-7b"),
                    shape=ShapeSpec("mt", MT_SEQ, MT_BATCH, "train"),
                    adapter=AdapterConfig(kind="shira", mask="rand",
                                          sparsity=0.98),
                    train=TrainConfig(learning_rate=3e-4,
                                      total_steps=2 * MT_STEPS,
                                      warmup_steps=1))
    names = [f"adapter_{a}" for a in range(3)]
    base = auxes = None
    for moments in ("f32", "int8"):
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mt = MultiAdapterTrainer(run, names, moments=moments,
                                 base_params=base, auxes=auxes)
        base, auxes = mt.base, mt.auxes
        setup_s = time.perf_counter() - t0
        out = mt.fit(MT_STEPS, log=None)
        torch.cuda.synchronize()
        counts = read_counts()
        hist = out["history"]
        step_ms = [h["step_ms"] for h in hist]
        steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
        tokens = 3 * MT_BATCH * MT_SEQ
        values = out["state"]["values"]
        finite = all(bool(torch.isfinite(v).all()) for v in values.values())
        print(f"[train] MultiAdapterTrainer 3 adapters, {moments} moments "
              f"({tokens} tokens a step, "
              f"{sum(v.numel() for v in values.values())} packed values): "
              f"launches {counts}, step {steady:.1f} ms (median after the "
              f"first; all {[round(x, 1) for x in step_ms]}), "
              f"{tokens / steady * 1e3:.0f} tokens/s, loss "
              f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, peak "
              f"memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB, "
              f"set-up {setup_s:.1f}s, {time.perf_counter() - t0:.1f}s wall",
              flush=True)
        if not finite or not all(math.isfinite(h["loss"]) for h in hist):
            fail(f"MultiAdapterTrainer {moments}: not finite")
        check_run(f"MultiAdapterTrainer {moments}", counts,
                  ("sidedelta", "sidedelta_dvals", "sparse_adamw_rows"),
                  totals)
        if moments == "f32":
            profile_train_step(torch, profile, ProfilerActivity, mt, out)
            publish_check(torch, "MultiAdapterTrainer",
                          lambda store: mt.publish(store, out["state"]),
                          mt.export_packs(out["state"]))
        del mt, out, values
        torch.cuda.empty_cache()
    unaligned = (sparse_adamw.unaligned_launches,
                 sparse_adamw_rows.unaligned_launches)
    print(f"[train] sparse_adamw one-element (unaligned) launches over the "
          f"three runs: blocks {unaligned[0]}, rows {unaligned[1]}",
          flush=True)
    if any(unaligned):
        fail("train: a sparse_adamw update took the one-element instance")
    print(f"[train] sidedelta_dvals one-token (unaligned) launches over the "
          f"two multi-adapter runs: {sidedelta_dvals.unaligned_launches}",
          flush=True)
    if sidedelta_dvals.unaligned_launches:
        fail("train: a dvals launch took the one-token instance")
    return totals


def publish_check(torch, label, publish, trained):
    """Publish a trainer's packs into a store (``publish(store)`` returns
    the versioned ids) and hold each stored pack, read back from its file,
    equal to the trained pack: the same indices, the same f32 values."""
    import tempfile
    from repro_torch.hub import AdapterStore
    with tempfile.TemporaryDirectory(prefix="publish-") as root:
        store = AdapterStore(root)
        t0 = time.perf_counter()
        vids = publish(store)
        dt = time.perf_counter() - t0
        for vid, want in zip(vids, trained):
            got = store.get(vid)
            same = got.entries.keys() == want.entries.keys() and all(
                torch.equal(got.entries[p][0], i.cpu())
                and torch.equal(got.entries[p][1], v.detach().float().cpu())
                for p, (i, v) in want.entries.items())
            if not same or vid != f"{want.name}@1":
                fail(f"{label}.publish: {vid} does not hold the trained "
                     "values")
        values = sum(p.num_params() for p in trained)
        print(f"[train] {label}.publish: {vids} ({values} values) in "
              f"{dt:.1f}s, read back equal to the trained packs", flush=True)


def profile_train_step(torch, profile, ProfilerActivity, mt, out):
    """Device time by kernel of one more multi-adapter step."""
    from repro_torch.runtime.trainer import device_batch
    from repro_torch.training import multi_batch_iterator
    from repro_torch.data import TaskSpec
    batch = device_batch(next(multi_batch_iterator(
        mt.cfg, mt.run.shape, 0, [TaskSpec(a) for a in range(mt.A)],
        start_step=MT_STEPS)), mt.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mt.step(out["state"], batch)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    kern = device_kernels(torch, prof)
    busy = sum(k[0] for k in kern)
    print(f"[profile] multi-adapter train step (3 adapters, f32 moments): "
          f"wall {wall:.1f} ms (profiler on); kernels {busy:.1f} ms"
          + (f" ({busy / wall:.0%} of wall)" if busy else
             " (profiler saw no device time: not measured)"), flush=True)
    for ms, n, name in sorted(kern, reverse=True)[:10]:
        print(f"[profile]   {ms:9.3f} ms  x{n:<5d} {name[:90]}")
    kernel_share("multi-adapter step", kern)


def train_consistency_phase(torch):
    """The JAX package's multi-adapter contract with the kernels in the
    loop: full width, 2 layers, f32 on the card, adapter a of
    MultiAdapterTrainer (fused) against Trainer(init a) on task a.

    Held: (1) the first step's value gradients, the sidedelta kernels'
    against materialize's dense gradient, to GRAD_TOL of each leaf's
    largest; (2) the losses of 3 steps to TRAIN_TOL; (3) the packed values
    after 3 steps to rtol = atol = TRAIN_TOL at every entry whose
    first-step gradient is not within (1)'s bound of zero. At those few
    entries the two f32 summation orders may disagree on the sign, and
    Adam's normalised first step (about lr * g / |g|) turns either sign
    into a full +-lr move; they are counted and printed, and held to the
    largest move that can make: 2 * lr * steps."""
    from repro_torch.configs import (AdapterConfig, RunConfig, ShapeSpec,
                                     TrainConfig, get_config)
    from repro_torch.data import TaskSpec, batch_iterator
    from repro_torch.models import layers
    from repro_torch.runtime import Trainer
    from repro_torch.runtime.trainer import device_batch
    from repro_torch.training import MultiAdapterTrainer, multi_batch_iterator
    cfg = get_config("starcoder2-7b").replace(num_layers=2)
    lr, steps = 1e-2, 3
    run = RunConfig(model=cfg, shape=ShapeSpec("c", 64, 2, "train"),
                    adapter=AdapterConfig(kind="shira", mask="rand",
                                          sparsity=0.98),
                    train=TrainConfig(learning_rate=lr, total_steps=steps,
                                      warmup_steps=1))
    names = [f"a{a}" for a in range(3)]
    tasks = [TaskSpec(a) for a in range(3)]
    with layers.compute_precision(torch.float32):
        mt = MultiAdapterTrainer(run, names, init_key=0)
        _, g_mt = mt.loss_and_grads(mt.init_state()["values"], device_batch(
            next(multi_batch_iterator(cfg, run.shape, 0, tasks)), "cuda"))
        out = mt.fit(steps, log=None)
        packs = mt.export_packs(out["state"])
        for a, pack in enumerate(packs):
            tr = Trainer(run, init_key=a, base_params=mt.base)
            stream = lambda: batch_iterator(cfg, run.shape, seed=0,
                                            task=tasks[a])
            _, _, g_tr = tr.loss_and_grads(
                tr.init_state()["trainable"],
                device_batch(next(stream()), "cuda"))
            ref = tr.fit(steps, log=None, batches=stream())
            ref_pack = tr.export_pack(ref["state"], pack.name)
            loss_d = max(abs(h[f"loss:{pack.name}"] - r["loss"])
                         for h, r in zip(out["history"], ref["history"]))
            grad_rel, val_d, undetermined, moved, ok = 0.0, 0.0, 0, 0, True
            for p, (idx, v) in pack.entries.items():
                gt, gm = g_tr[p], g_mt[p][a]
                bound_g = GRAD_TOL * float(gt.abs().max())
                grad_rel = max(grad_rel, float((gm - gt).abs().max())
                               / float(gt.abs().max()))
                d = (v - ref_pack.entries[p][1]).abs()
                free = gt.abs() <= bound_g
                held = ~free
                val_d = max(val_d, float(d[held].max()))
                undetermined += int(free.sum())
                moved += int((d[free] > TRAIN_TOL).sum())
                ok &= bool(torch.equal(idx, ref_pack.entries[p][0]))
                ok &= bool((d[held] <= TRAIN_TOL * (
                    1 + ref_pack.entries[p][1][held].abs())).all())
                ok &= bool((d <= 2 * lr * steps).all())
            print(f"[train-consistency] f32, 2 layers, full width, adapter "
                  f"{a}: first-step value gradients max diff "
                  f"{grad_rel:.3g} of their largest (tol {GRAD_TOL}); loss "
                  f"max diff {loss_d:.3g}; packed values max diff "
                  f"{val_d:.3g} (tol rtol=atol={TRAIN_TOL}) at entries "
                  f"with a determined gradient sign; {undetermined} entries "
                  f"with |g| <= {GRAD_TOL} of the largest, {moved} of them "
                  f"apart by more than {TRAIN_TOL}", flush=True)
            if (not ok or grad_rel > GRAD_TOL
                    or not loss_d <= TRAIN_TOL * (1 + abs(
                        ref["history"][0]["loss"]))):
                fail(f"train-consistency: adapter {a} departs from its "
                     "single-adapter Trainer")
            del tr, ref, ref_pack, g_tr


def wm_ties(torch, tr):
    """How often the wm mask's K-th largest |W| of a matrix is tied with
    an entry left out (where torch.topk's own order would pick apart from
    lax.top_k's). Returns (matrices with such a tie, matrices, tied
    entries beyond the K)."""
    from repro_torch.core.masks import budget, iter_leaves
    masks = dict(iter_leaves(tr.masks))
    tied = rows = extra = 0
    for p, w in iter_leaves(tr.base):
        if p not in masks:
            continue
        k = budget(*w.shape[-2:], tr.acfg.sparsity)
        for r in w.reshape(-1, w.shape[-2] * w.shape[-1]):
            s = r.abs()
            kth = torch.topk(s, k, sorted=False).values.min()
            over = int((s >= kth).sum()) - k
            rows += 1
            tied += over > 0
            extra += over
    return tied, rows, extra


def profile_hook_step(torch, tr, state):
    """Device time by kernel of one more hook-mode step (its launches are
    not counted: the counts were read before it)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import batch_iterator
    from repro_torch.runtime.trainer import device_batch
    batch = device_batch(next(batch_iterator(tr.cfg, tr.run.shape, seed=1)),
                         tr.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tr.step(state, batch)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    kern = device_kernels(torch, prof)
    busy = sum(k[0] for k in kern)
    print(f"[profile] hook-mode train step ({HOOK_LAYERS} layers): wall "
          f"{wall:.1f} ms (profiler on); kernels {busy:.1f} ms"
          + (f" ({busy / wall:.0%} of wall)" if busy else
             " (profiler saw no device time: not measured)"), flush=True)
    for ms, n, name in sorted(kern, reverse=True)[:12]:
        print(f"[profile]   {ms:9.3f} ms  x{n:<5d} {name[:90]}")


def hook_round_trip(torch, tr, state):
    """Export the hook trainer's pack, check its %C, and load it onto the
    trainer's base through SwitchEngine (scatter_apply, in place): the
    loaded target leaves must equal the trained weights within
    ROUND_TRIP_TOL of the largest. Returns (pack, %C, largest diff)."""
    from repro_torch.core import SwitchEngine, changed_fraction
    from repro_torch.core.masks import budget, iter_leaves
    pack = tr.export_pack(state, "hook")
    frac = changed_fraction(tr.base, state["trainable"])
    total = sum(x.numel() for _, x in iter_leaves(tr.base))
    most = sum(m.numel() // (m.shape[-2] * m.shape[-1])
               * budget(*m.shape[-2:], tr.acfg.sparsity)
               for _, m in iter_leaves(tr.masks)) / total
    if not 0 < frac <= most:
        fail(f"hook export: %C {frac} outside (0, {most}]")
    SwitchEngine(tr.base).switch(pack)
    trained = dict(iter_leaves(state["trainable"]))
    diff, scale = 0.0, 0.0
    for p, w in iter_leaves(tr.base):
        if p in pack.entries:
            diff = max(diff, float((w - trained[p]).abs().max()))
            scale = max(scale, float(trained[p].abs().max()))
    if not diff <= ROUND_TRIP_TOL * scale:
        fail(f"hook export: the loaded pack is {diff} from the trained "
             f"weights (tol {ROUND_TRIP_TOL} of {scale})")
    return pack, frac, most, diff, scale


def train_masks_phase(torch):
    """The reference's default adapter at full width: the launch.train CLI
    with --adapter shira-wm (packed, all layers), then hook mode (shira-wm,
    packed=False) through the Trainer API at full width cut to
    HOOK_LAYERS layers, its pack exported and loaded back."""
    import math
    import statistics
    from repro_torch.configs import (AdapterConfig, RunConfig, ShapeSpec,
                                     TrainConfig, get_config)
    from repro_torch.core.masks import iter_leaves
    from repro_torch.launch import train
    from repro_torch.runtime import Trainer
    totals = {}
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = train.main(["--arch", "starcoder2-7b", "--adapter", "shira-wm",
                        "--seq", str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH),
                        "--steps", str(TRAIN_STEPS)])
    torch.cuda.synchronize()
    counts = read_counts()
    losses = stats["losses"]
    print(f"[train] Trainer shira-wm (launch.train, packed, "
          f"{TRAIN_BATCH}x{TRAIN_SEQ} tokens, {stats['trained_values']} "
          f"packed values): wm mask built in {stats['mask_seconds']:.2f}s, "
          f"launches {counts}, step {stats['steady_step_ms']:.1f} ms (median"
          f" after the first; all {[round(x, 1) for x in stats['step_ms']]})"
          f", {stats['tokens_per_s']:.0f} tokens/s, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB, "
          f"{time.perf_counter() - t0:.1f}s wall", flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail("Trainer shira-wm: a loss is not finite")
    check_run("Trainer shira-wm", counts,
              ("scatter_apply", "sparse_adamw_blocks"), totals)
    del stats
    torch.cuda.empty_cache()

    cfg = get_config("starcoder2-7b").replace(num_layers=HOOK_LAYERS)
    run = RunConfig(model=cfg,
                    shape=ShapeSpec("hook", TRAIN_SEQ, TRAIN_BATCH, "train"),
                    adapter=AdapterConfig(kind="shira", mask="wm",
                                          packed=False),
                    train=TrainConfig(learning_rate=3e-4,
                                      total_steps=HOOK_STEPS,
                                      warmup_steps=1))
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(run)
    setup_s = time.perf_counter() - t0
    out = tr.fit(HOOK_STEPS, log=None)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    hist = out["history"]
    step_ms = [h["step_ms"] for h in hist]
    steady = statistics.median(step_ms[1:])
    leaves = len(list(iter_leaves(tr.masks)))
    entries = sum(m.numel() for _, m in iter_leaves(tr.masks))
    print(f"[train] hook-mode Trainer shira-wm ({HOOK_LAYERS} of "
          f"{get_config('starcoder2-7b').num_layers} layers, "
          f"{run.shape.tokens} tokens a step, {leaves} target leaves, "
          f"{entries} target entries, bool masks): wm masks built in "
          f"{tr.mask_seconds:.2f}s (set-up {setup_s:.1f}s), launches "
          f"{counts}, step {steady:.1f} ms (median after the first; all "
          f"{[round(x, 1) for x in step_ms]}), "
          f"{run.shape.tokens / steady * 1e3:.0f} tokens/s, loss "
          f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, peak memory "
          f"{peak:.1f} GB, {time.perf_counter() - t0:.1f}s wall", flush=True)
    if not all(math.isfinite(h["loss"]) for h in hist):
        fail("hook-mode Trainer: a loss is not finite")
    tied, rows, entries_tied = wm_ties(torch, tr)
    print(f"[train] wm ties: {tied} of {rows} matrices have |W| values "
          f"equal to the K-th largest beside it ({entries_tied} entries), "
          f"decided by the lower index as lax.top_k decides them",
          flush=True)
    if leaves != 6 or counts["masked_update"] != leaves * HOOK_STEPS:
        fail(f"hook-mode Trainer: masked_update launched "
             f"{counts['masked_update']} times over {HOOK_STEPS} steps of "
             f"{leaves} target leaves")
    check_run("hook-mode Trainer", counts, ("masked_update",), totals)
    profile_hook_step(torch, tr, out["state"])
    state = {"trainable": out["state"]["trainable"]}
    del out                         # the moments: 8 bytes a target entry
    torch.cuda.empty_cache()
    # published before the round trip, which loads the pack onto tr.base
    publish_check(torch, "hook-mode Trainer",
                  lambda store: [tr.publish(store, state, "hook")],
                  [tr.export_pack(state, "hook")])
    zero_counts()
    t0 = time.perf_counter()
    pack, frac, most, diff, scale = hook_round_trip(torch, tr, state)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"[train] hook export: pack_from_delta {pack.num_params()} values "
          f"({pack.nbytes() / 1e6:.1f} MB), %C {frac:.6f} (<= {most:.6f}, "
          f"1 - sparsity {1 - run.adapter.sparsity:.2f} at the target "
          f"leaves); loaded through SwitchEngine: max |loaded - trained| "
          f"{diff:.3g} (tol {ROUND_TRIP_TOL} of {scale:.3g}), launches "
          f"{ {k: v for k, v in counts.items() if v} }, "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    check_run("hook export", counts, ("scatter_apply",), totals)
    del tr, state, pack
    torch.cuda.empty_cache()
    return totals


def hook_consistency_phase(torch):
    """Hook mode against packed at full width cut to 2 layers, f32: 3
    steps of each on one wm mask give the same losses to HOOK_TOL (the
    reference's claim, with masked_update on one side and scatter_apply +
    sparse_adamw on the other). Then grad (packed) and snip (hook) masks
    from one batch's calibration gradients: one step each, and each
    exported pack, loaded onto a copy of the base through SwitchEngine,
    gives the trained weights."""
    import numpy as np
    from repro_torch.configs import (AdapterConfig, RunConfig, ShapeSpec,
                                     TrainConfig, get_config)
    from repro_torch.core import SwitchEngine
    from repro_torch.core.masks import iter_leaves, map_leaves
    from repro_torch.data import batch_iterator
    from repro_torch.models import layers, lm
    from repro_torch.runtime import Trainer
    from repro_torch.runtime.trainer import dense_grads, device_batch
    cfg = get_config("starcoder2-7b").replace(num_layers=2)
    shape = ShapeSpec("c", 64, 2, "train")
    steps = 3

    def run_of(mask, packed):
        return RunConfig(model=cfg, shape=shape,
                         adapter=AdapterConfig(kind="shira", mask=mask,
                                               packed=packed),
                         train=TrainConfig(learning_rate=1e-2,
                                           total_steps=steps,
                                           warmup_steps=1))
    with layers.compute_precision(torch.float32):
        base = lm.init_params(cfg, seed=0, device="cuda")
        losses = {}
        zero_counts()
        for packed in (False, True):
            t = Trainer(run_of("wm", packed), base_params=base)
            losses[packed] = [h["loss"] for h in
                              t.fit(steps, log=None)["history"]]
            del t
        counts = read_counts()
        d = max(abs(a - b) for a, b in zip(losses[False], losses[True]))
        print(f"[hook-consistency] f32, 2 layers, full width, wm mask, "
              f"{steps} steps: hook losses {losses[False]}, packed "
              f"{losses[True]}, max diff {d:.3g} (tol rtol=atol={HOOK_TOL});"
              f" launches { {k: v for k, v in counts.items() if v} }",
              flush=True)
        if not np.allclose(losses[False], losses[True], rtol=HOOK_TOL,
                           atol=HOOK_TOL):
            fail("hook-consistency: hook and packed losses differ")
        for k in ("masked_update", "scatter_apply", "sparse_adamw_blocks"):
            if counts[k] <= 0:
                fail(f"hook-consistency: kernel {k} was never launched")
        batch = device_batch(next(batch_iterator(cfg, shape, seed=1)),
                             "cuda")
        calib = dense_grads(base, cfg, batch,
                            AdapterConfig().target_modules)[2]
        for mask, packed in (("grad", True), ("snip", False)):
            t = Trainer(run_of(mask, packed), base_params=base,
                        calib_grads=calib)
            state = t.fit(1, log=None)["state"]
            pack = t.export_pack(state, mask)
            trained = (materialize_dense(torch, base, state, t) if packed
                       else dict(iter_leaves(state["trainable"])))
            copy = map_leaves(lambda _, x: x.clone(), base)
            SwitchEngine(copy).switch(pack)
            diff = max(float((w - trained[p]).abs().max())
                       for p, w in iter_leaves(copy) if p in pack.entries)
            scale = max(float(trained[p].abs().max()) for p in pack.entries)
            mode = "packed" if packed else "hook"
            print(f"[hook-consistency] {mask} mask ({mode}, calibration "
                  f"gradients of one {shape.tokens}-token "
                  f"batch, built in {t.mask_seconds:.2f}s): pack of "
                  f"{pack.num_params()} values loads to max diff {diff:.3g} "
                  f"from the trained weights (tol {ROUND_TRIP_TOL} of "
                  f"{scale:.3g})", flush=True)
            if not diff <= ROUND_TRIP_TOL * scale:
                fail(f"hook-consistency: the {mask} pack does not load to "
                     "its trained weights")
            del t, state, pack, trained, copy


def materialize_dense(torch, base, state, t):
    """{path: base + scatter(values)} of a packed trainer's target leaves,
    by the plain scatter."""
    from repro_torch.core.masks import iter_leaves, scatter_packed_add
    vals = dict(iter_leaves(state["trainable"]))
    idx = dict(iter_leaves(t.aux["indices"]))
    return {p: scatter_packed_add(w, idx[p], vals[p])
            for p, w in iter_leaves(base) if p in idx}


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

    def build_all():
        build.build()
        print(f"[build] {len(build.KERNELS)} kernel libraries", flush=True)
        for name in build.KERNELS:
            for fn, ln in ptxas_lines(build.ptxas(name)):
                print(f"[build] {name}: {fn}: {ln}")
    timed("build", build_all)

    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scratch.fill_(1)
    side, scat = timed("kernels (serving)", kernels_phase, torch, flush)
    torch.cuda.empty_cache()
    blocks, rows, grads = timed("kernels (training)", train_kernels_phase,
                                torch, flush)
    torch.cuda.empty_cache()
    attn = timed("kernels (attention)", attention_kernels_phase, torch, flush)
    torch.cuda.empty_cache()
    masked = timed("kernels (masked_update)", masked_update_kernels, torch,
                   flush)
    del scratch
    torch.cuda.empty_cache()
    launches = timed("serve", serve_phase, torch)
    torch.cuda.empty_cache()
    timed("profile", profile_phase, torch)
    torch.cuda.empty_cache()
    timed("consistency", consistency_phase, torch)
    torch.cuda.empty_cache()
    for k, v in timed("continuous", continuous_phase, torch).items():
        launches[k] = launches.get(k, 0) + v
    torch.cuda.empty_cache()
    timed("continuous-consistency", continuous_consistency_phase, torch)
    torch.cuda.empty_cache()
    for k, v in timed("train", train_phase, torch).items():
        launches[k] = launches.get(k, 0) + v
    torch.cuda.empty_cache()
    timed("train-consistency", train_consistency_phase, torch)
    torch.cuda.empty_cache()
    for k, v in timed("train (wm, hook)", train_masks_phase, torch).items():
        launches[k] = launches.get(k, 0) + v
    torch.cuda.empty_cache()
    timed("hook-consistency", hook_consistency_phase, torch)
    torch.cuda.empty_cache()
    for k, v in timed("personalization", personalization_phase,
                      torch).items():
        launches[k] = launches.get(k, 0) + v
    torch.cuda.empty_cache()
    timed("personalization-consistency", pz_consistency_phase, torch)

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    main_side = side[0]     # w_up, S=1, f32 tables: the multi-tenant decode
    side_err = max([r["max_abs_err"] for r in side]
                   + [g[e]["max_abs_err"] for g in grads.values()
                      for e in ("forward", "dx")])
    dvals = grads["w_up"]["dvals"]
    kernels = [
        {"name": "sidedelta", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sidedelta.cu",
         "replaces": "src/repro/kernels/sidedelta.py:282",
         "launches": launches["sidedelta"], "max_abs_err": side_err,
         **{k: main_side[k] for k in keys}},
        {"name": "sidedelta_dvals", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sidedelta_grad.cu",
         "replaces": "src/repro/kernels/sidedelta.py:245",
         "launches": launches["sidedelta_dvals"],
         "max_abs_err": max(g["dvals"]["max_abs_err"]
                            for g in grads.values()),
         **{k: dvals[k] for k in keys}},
        {"name": "scatter_apply", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/scatter_apply.cu",
         "replaces": "src/repro/kernels/scatter_apply.py:49",
         "launches": launches["scatter_apply"], **scat},
        {"name": "sparse_adamw_blocks", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sparse_adamw.cu",
         "replaces": "src/repro/kernels/sparse_adamw.py:38",
         "launches": launches["sparse_adamw_blocks"], **blocks},
        {"name": "sparse_adamw_rows", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sparse_adamw.cu",
         "replaces": "src/repro/kernels/sparse_adamw.py:99",
         "launches": launches["sparse_adamw_rows"],
         **rows["f32"],
         "max_abs_err": max(r["max_abs_err"] for r in rows.values())},
    ]
    # each attention kernel's row: its bf16 case at the main path's shape
    # (the first case of each list), its largest error over every case
    for name, src, rep in (
            ("flash_decode", "flash_decode.cu", "flash_decode.py:71"),
            ("flash_decode_paged", "flash_decode.cu", "flash_decode.py:141"),
            ("flash_prefill", "flash_prefill.cu", "flash_prefill.py:74")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{rep}",
            "launches": launches.get(name, 0),
            **{k: attn[name][0][k] for k in keys},
            "max_abs_err": max(r["max_abs_err"] for r in attn[name])})
    # masked_update's row: the hook path's case (f32 W, bool M)
    kernels.append({
        "name": "masked_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/masked_update.cu",
        "replaces": "src/repro/kernels/masked_update.py:23",
        "launches": launches.get("masked_update", 0),
        **{k: masked["f32 W, bool M"][k] for k in keys},
        "max_abs_err": max(r["max_abs_err"] for r in masked.values())})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
