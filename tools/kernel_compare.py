"""Hold this tree's scatter_apply and sidedelta_dvals kernels against other
builds of them on the card: another commit's kernels, and variants of this
tree's sources.

  python3 tools/kernel_compare.py [--other DIR] [--rounds 7]
                                  [--l2-fetch BYTES]

DIR is a checkout of another commit (``git archive <rev> | tar -x -C
build/other``). The script compiles, one ``nvcc`` each, all at once:

  this        ``csrc/scatter_apply.cu`` and ``csrc/sidedelta_grad.cu`` as
              the port builds them;
  other       DIR's two sources, called through DIR's wrappers;
  o16, o6, o2 this scatter_apply with 16 (as many as fit: no cap), 6 or 2
              blocks an SM, not 4;
  ldcs        this scatter_apply reading indices and values with the
              streaming ``__ldcs``, not ``__ldg``;
  read, write this scatter_apply's W traffic in halves, timed only (they
              do not compute the function): ``read`` loads every W element
              it would update and stores nothing, ``write`` stores the
              update without loading W;
  e2, e8      this sidedelta_dvals with 2 or 8 entries' loads in flight,
              not 4;
  ldcg        this sidedelta_dvals reading x through ``__ldcg`` (L2 only),
              not ``__ldg``.

scatter_apply runs at ``chip_smoke.py``'s (32, 4608, 18432) w_up leaf
(1,698,693 entries a layer, sparsity 0.98) with ascending and with
shuffled indices, and on (37, 96, 160) with k = 307 and (70001, 8, 8) with
k = 3 (layer boundaries inside a block, more layers than a grid
dimension holds): every build's result must equal this build's bit for
bit, and the leaf's untouched entries stay as they were.
sidedelta_dvals runs at the multi-adapter training shape (w_up, 3
adapters, T_a = 512, bf16 x), the kernel alone on grouped token-minor
inputs as the backward hands them over and the whole wrapper with its
grouping and transposition, and on small cases (S = 250, which takes the
one-token instance; an adapter with no tokens; f32 x): every build's
result must lie within 1e-4 of this build's. Then the builds are timed at
the large shapes in ``--rounds`` rounds, each round every build in turn,
cold L2 as ``chip_smoke.py`` times them, and the median and range over
the rounds are printed for each build and case, with the achieved rate and
share of the bound. ``--l2-fetch`` sets the card's L2 fetch granularity
for this process before anything runs (the default is printed either
way). Needs the card and ``nvcc``; exits 1 if a build's results differ
from this one's.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import inspect
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (adds ROOT/src to the path)

OUT = ROOT / "build" / "kernel_compare"
CSRC = Path("src/repro_torch/kernels/csrc")
KERNELS = {     # C source -> wrapper module, in this tree and in DIR's
    "scatter_apply": Path("src/repro_torch/kernels/scatter_apply.py"),
    "sidedelta_grad": Path("src/repro_torch/kernels/sidedelta.py"),
}
VARIANTS = {    # name -> (kernel, [(text of this source, replacement)])
    "o16": ("scatter_apply", [("kBlocksPerSm = 4;", "kBlocksPerSm = 16;")]),
    "o6": ("scatter_apply", [("kBlocksPerSm = 4;", "kBlocksPerSm = 6;")]),
    "o2": ("scatter_apply", [("kBlocksPerSm = 4;", "kBlocksPerSm = 2;")]),
    "ldcs": ("scatter_apply", [("i = __ldg(", "i = __ldcs("),
                               ("v = __ldg(", "v = __ldcs(")]),
    "read": ("scatter_apply", [(
        "*p = __fadd_rn(__ldcg(p), __fmul_rn(alpha, v));",
        "const float o = __ldcg(p);\n  if (o != o) *p = o;")]),
    "write": ("scatter_apply", [(
        "*p = __fadd_rn(__ldcg(p), __fmul_rn(alpha, v));",
        "*p = __fmul_rn(alpha, v);")]),
    "e2": ("sidedelta_grad", [("kEntries = 4;", "kEntries = 2;")]),
    "e8": ("sidedelta_grad", [("kEntries = 4;", "kEntries = 8;")]),
    "ldcg": ("sidedelta_grad", [("r = __ldg(", "r = __ldcg(")]),
}
PROBES = ("read", "write")  # timed only: they do not compute the function
L2_FETCH = """#include <cuda_runtime.h>
extern "C" int l2_fetch(size_t set, size_t* now) {
  if (set && cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, set))
    return 1;
  return static_cast<int>(
      cudaDeviceGetLimit(now, cudaLimitMaxL2FetchGranularity));
}
"""
DVALS_TOL = cs.SIDEDELTA_TOL


def fail(msg: str) -> None:
    print(f"[kernel_compare] FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def sources(other):
    """(kernel, build) -> CUDA source."""
    out = {}
    for kernel in KERNELS:
        out[kernel, "this"] = (ROOT / CSRC / f"{kernel}.cu").read_text()
        if other:
            out[kernel, "other"] = (other / CSRC / f"{kernel}.cu").read_text()
    for name, (kernel, edits) in VARIANTS.items():
        text = out[kernel, "this"]
        for a, b in edits:
            if a not in text:
                fail(f"variant {name}: {a!r} is not in {kernel}.cu")
            text = text.replace(a, b)
        out[kernel, name] = text
    return out


def compile_all(srcs):
    """(kernel, build) -> loaded library; prints registers and spills."""
    from repro_torch.kernels import build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for (kernel, name), text in srcs.items():
        cu, so = OUT / f"{kernel}-{name}.cu", OUT / f"lib{kernel}-{name}.so"
        cu.write_text(text)
        procs[kernel, name] = (so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (kernel, name), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            fail(f"nvcc {kernel} {name}:\n{log}")
        for fn, ln in cs.ptxas_lines(log):
            print(f"[ptxas] {kernel} {name}: {fn}: {ln}", flush=True)
        libs[kernel, name] = ctypes.CDLL(str(so))
    return libs


class OneLibrary:
    """Stands in for a wrapper module's ``build``: every load is one
    library."""

    def __init__(self, lib):
        self.lib = lib

    def load(self, name):
        return self.lib


def wrapper(kernel, name, libs, other):
    """The wrapper module of ``kernel`` bound to build ``name``'s library:
    DIR's own module for "other", a fresh copy of this tree's for every
    other build (so the ctypes signatures of one library never serve
    another)."""
    path = (other if name == "other" else ROOT) / KERNELS[kernel]
    spec = importlib.util.spec_from_file_location(
        f"cmp_{kernel}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build = OneLibrary(libs[kernel, name])
    return mod


def scatter_cases(torch, gen, mods, libs):
    """case -> (run(build) -> result, timed(build) -> fn or None, the
    bytes the case must move)."""
    d, f, L = 4608, 18432, 32
    from repro_torch.core.masks import budget
    from repro_torch.kernels.scatter_apply import sector_bytes
    k = budget(d, f, 0.98)
    w = torch.randn((L, d, f), generator=gen, device="cuda")
    idx, vals = cs.rand_entries(torch, gen, L, d, f, k)
    perm = torch.argsort(torch.rand((L, k), generator=gen, device="cuda"),
                         dim=1)
    shuffled = idx.gather(1, perm), vals.gather(1, perm)
    gi = (torch.arange(L, device="cuda")[:, None] * (d * f)
          + idx.long()).reshape(-1)
    before = w.view(-1)[gi].clone()
    probe = torch.randint(0, w.numel(), (1 << 20,), generator=gen,
                          device="cuda")
    probe = probe[~torch.isin(probe, gi)]
    probe_before = w.view(-1)[probe].clone()
    nbytes, _ = sector_bytes(w, idx, vals)

    def leaf(entries, ordered=True):
        def apply(name, a):
            # unique indices in another order pass the kernel's check of
            # merged rows only when the caller says so (ordered=False)
            fn = mods[name].scatter_apply
            kw = ({} if ordered or "ordered" not in
                  inspect.signature(fn).parameters else {"ordered": False})
            return fn(w, *entries, a, **kw)

        def run(name):
            apply(name, 1.0)
            got = w.view(-1)[gi].clone()
            w.view(-1)[gi] = before
            if not torch.equal(w.view(-1)[probe], probe_before):
                print(f"[bits] scatter_apply {name} changed untouched "
                      f"entries", flush=True)
                w.view(-1)[probe] = probe_before
                return torch.full_like(got, float("nan"))
            return got

        def timed_run(name):   # load and unload in turn: W stays bounded
            sign = [1.0]

            def go():
                apply(name, sign[0])
                sign[0] = -sign[0]
            return go
        return run, timed_run

    out = {f"scatter_apply ({L}, {d}, {f}) ascending": (
               *leaf((idx, vals)), nbytes),
           f"scatter_apply ({L}, {d}, {f}) shuffled": (
               *leaf(shuffled, ordered=False), nbytes)}
    for nl, n, m, kk in ((37, 96, 160, 307), (70001, 8, 8, 3)):
        ws = torch.randn((nl, n, m), generator=gen, device="cuda")
        ii = torch.argsort(torch.rand((nl, n * m), generator=gen,
                                      device="cuda"), 1)[:, :kk]
        ii = ii.sort(1).values.to(torch.int32)
        vv = torch.randn((nl, kk), generator=gen, device="cuda")

        def run(name, ws=ws, ii=ii, vv=vv):
            return mods[name].scatter_apply(ws.clone(), ii, vv, 0.5)
        out[f"scatter_apply ({nl}, {n}, {m}) k={kk}"] = (run, None, None)
    return out


def dvals_cases(torch, gen, mods, libs):
    """case -> (run(build) -> result, timed(build) -> fn or None, (bound,
    bytes, bytes of x gathered))."""
    from repro_torch.core.masks import budget
    from repro_torch.kernels import ops
    from repro_torch.kernels.sidedelta import group_by_adapter, token_minor

    def inputs(n, m, S, ids, xdt, K=None):
        A = 3
        K = K or budget(n, m, 0.98)
        idx = [cs.rand_entries(torch, gen, 1, n, m, K)[0] for _ in range(A)]
        t = {key: v[0].contiguous() for key, v in ops.sidedelta_table(
            idx, 1, n, m, trainable=True).items()}
        ids = torch.tensor(ids, dtype=torch.int32, device="cuda")
        x = torch.randn((len(ids), S, n), generator=gen, device="cuda").to(
            xdt)
        dy = 0.01 * torch.randn((len(ids), S, m), generator=gen,
                                device="cuda")
        return x, dy, t["rows"], t["colptr"], ids

    def kernel_alone(name, x, dy, rows, colptr, ids):
        """A launch on grouped token-minor inputs, prepared once; builds
        whose wrapper has no ``_launch_dvals`` (older trees) take
        their own C signature: (xT, bf16, dyT, rows, colptr, rptr, dvals,
        A, m, S, T, K, stream), rows of xT and dyT B * S apart."""
        A, K = rows.shape
        B, S, _ = x.shape
        order, rptr = group_by_adapter(ids, A)
        xT = token_minor(x, order).contiguous()
        dyT = token_minor(dy, order).contiguous()
        out = torch.zeros((A, K), device="cuda")
        mod = mods[name]
        if hasattr(mod, "_launch_dvals"):
            return lambda: mod._launch_dvals(xT, dyT, rows, colptr, rptr, S,
                                             out)
        fn = libs["sidedelta_grad", name].sidedelta_dvals_launch
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i, p, p, p, p, p, i, i, i, ll, ll, p]
        fn.restype = ctypes.c_int

        def go():
            err = fn(xT.data_ptr(), int(x.dtype == torch.bfloat16),
                     dyT.data_ptr(), rows.data_ptr(), colptr.data_ptr(),
                     rptr.data_ptr(), out.data_ptr(), A, dy.shape[2], S,
                     B * S, K, torch.cuda.current_stream().cuda_stream)
            if err:
                fail(f"sidedelta_dvals {name}: cudaError {err}")
            return out
        return go

    d, f = 4608, 18432
    S = cs.MT_SEQ
    big = inputs(d, f, S, cs.MT_IDS, torch.bfloat16)
    A, K = big[2].shape
    nbytes = (big[0].numel() * 2 + big[1].numel() * 4 + A * K * 8
              + A * (f + 1) * 4)
    b = cs.bound(nbytes, 2 * S * K * len(cs.MT_IDS))
    gathered = 2 * S * K * len(cs.MT_IDS)     # bytes of x rows gathered
    alone = {}

    def run_alone(name):
        fn = alone.setdefault(name, kernel_alone(name, *big))
        return fn().clone()

    out = {
        "sidedelta_dvals w_up kernel alone": (
            run_alone, lambda name: alone.setdefault(
                name, kernel_alone(name, *big)), (b, nbytes, gathered)),
        "sidedelta_dvals w_up whole wrapper": (
            lambda name: mods[name].sidedelta_dvals(*big),
            lambda name: lambda: mods[name].sidedelta_dvals(*big),
            (b, nbytes, gathered)),
    }
    for label, n, m, S_, ids, xdt in (
            ("S=250 (one token a lane)", 512, 1024, 250, [0, 1, 2, 0],
             torch.bfloat16),
            ("adapter 1 without tokens", 512, 1024, 64, [2, 0, 2, -1],
             torch.bfloat16),
            ("f32 x", 512, 1024, 600, [1, 0, 2], torch.float32)):
        small = inputs(n, m, S_, ids, xdt)
        out[f"sidedelta_dvals {label}"] = (
            lambda name, small=small: mods[name].sidedelta_dvals(*small),
            None, None)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="checkout of another commit")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--l2-fetch", type=int, default=0, metavar="BYTES",
                    help="set the card's L2 fetch granularity (this process "
                         "only) before anything runs")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] {cs.card_line()}", flush=True)
    other = Path(args.other).resolve() if args.other else None
    srcs = sources(other)
    srcs["l2", "fetch"] = L2_FETCH
    libs = compile_all(srcs)
    now = ctypes.c_size_t()
    torch.zeros(1, device="cuda")     # the context the limit belongs to
    if libs["l2", "fetch"].l2_fetch(ctypes.c_size_t(0), ctypes.byref(now)):
        fail("cudaDeviceGetLimit(cudaLimitMaxL2FetchGranularity)")
    print(f"[l2] fetch granularity {now.value} bytes", flush=True)
    if args.l2_fetch:
        if libs["l2", "fetch"].l2_fetch(ctypes.c_size_t(args.l2_fetch),
                                        ctypes.byref(now)):
            fail(f"cudaDeviceSetLimit to {args.l2_fetch}")
        print(f"[l2] fetch granularity set to {now.value} bytes", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    differ = []
    timings = {}    # case -> (builds, timed_run, bound info)
    for kernel, make in (("scatter_apply", scatter_cases),
                         ("sidedelta_grad", dvals_cases)):
        builds = [n for (k, n) in libs if k == kernel]
        mods = {n: wrapper(kernel, n, libs, other) for n in builds}
        for case, (run, timed_run, info) in make(torch, gen, mods,
                                                 libs).items():
            try:
                ref = run("this")
            except ValueError as e:
                fail(f"{case}: this build raised {e}")
            for name in builds:
                if name == "this" or name in PROBES:
                    continue
                try:
                    got = run(name)
                except ValueError as e:     # an older wrapper's own limit
                    print(f"[bits] {case}: {name} refuses: {e}", flush=True)
                    continue
                if kernel == "scatter_apply":
                    ok, what = torch.equal(got, ref), "bit-equal"
                else:
                    err = float((got - ref).abs().max())
                    ok, what = err <= DVALS_TOL, f"max diff {err:.3g}, within"
                print(f"[bits] {case}: {name} {what} this: {ok}", flush=True)
                if not ok:
                    differ.append(f"{name} at {case}")
            del ref
            if timed_run is not None:
                timings[case] = (builds, {n: timed_run(n) for n in builds},
                                 info)
        entry = ("scatter_apply" if kernel == "scatter_apply"
                 else "sidedelta_dvals")
        fn = getattr(mods["this"], entry)
        print(f"[launches] {entry} of this build: {fn.launches}"
              + (f", one-token instance {fn.unaligned_launches}"
                 if hasattr(fn, "unaligned_launches") else ""), flush=True)
        torch.cuda.empty_cache()

    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scratch.fill_(1)
    ms = {(n, c): [] for c, (builds, _, _) in timings.items()
          for n in builds}
    for _ in range(args.rounds):
        for case, (builds, fns, _) in timings.items():
            for name in builds:
                ms[name, case].append(cs.cold_ms(torch, fns[name], 10, flush))
    for case, (builds, _, info) in timings.items():
        for name in builds:
            xs = ms[name, case]
            med = statistics.median(xs)
            rate = ""
            if case.startswith("scatter_apply"):
                rate = (f", {info / med / 1e9:.3f} TB/s, "
                        f"{info / cs.card_hw().hbm_bw * 1e3 / med:.1%} of the "
                        f"sector bound")
            else:
                b, nbytes, gathered = info
                rate = (f", {nbytes / med / 1e9:.3f} TB/s of its bytes, "
                        f"{gathered / med / 1e9:.3f} TB/s of x gathered, "
                        f"{b['bound_ms'] / med:.1%} of bound "
                        f"{b['bound_ms']:.4f} ({b['bound_by']})")
            print(f"[time] {case}: {name} median {med:.4f} ms, range "
                  f"{min(xs):.4f}-{max(xs):.4f} over {len(xs)} rounds"
                  f"{rate}", flush=True)
    print(f"[device] {cs.card_line()}", flush=True)
    if differ:
        fail("results differ from this build's: " + ", ".join(differ))


if __name__ == "__main__":
    main()
