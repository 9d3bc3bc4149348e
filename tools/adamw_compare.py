"""Hold this tree's sparse_adamw kernel against other builds of it on the
card: another commit's kernel, and variants of this tree's source.

  python3 tools/adamw_compare.py [--other DIR] [--rounds 7]

DIR is a checkout of another commit (``git archive <rev> | tar -x -C
build/other``). The script compiles, one ``nvcc`` each, all at once:

  this        ``csrc/sparse_adamw.cu`` as the port builds it;
  other       DIR's ``csrc/sparse_adamw.cu``, called through DIR's wrapper;
  v8          this source with vectors of 8 elements, not 4;
  t256, t128  this source with blocks of 256 and 128 threads, not 512;
  ldcs        this source with streaming loads (``__ldcs``) for ``__ldg``.

Every build runs on ``chip_smoke.py``'s sparse_adamw inputs at the
starcoder2-7b shapes (the (32 * K,) w_up vector, and (96, K) rows with f32,
bf16 and int8 moments, K = 1,698,693 at sparsity 0.98) and on (5, 3) and
(7, 13) rows, and each of its three outputs is compared with this build's
bit for bit (``torch.equal``). Then the builds are timed at the large
shapes in ``--rounds`` rounds, each round every build in turn, cold L2 as
``chip_smoke.py`` times them, and the median and range over the rounds are
printed for each build and case. Needs the card and ``nvcc``; exits 1 if a
build's outputs differ from this one's.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (adds ROOT/src to the path)

OUT = ROOT / "build" / "adamw_compare"
SOURCE = Path("src/repro_torch/kernels/csrc/sparse_adamw.cu")
WRAPPER = Path("src/repro_torch/kernels/sparse_adamw.py")
VARIANTS = {    # name -> (text of this source, what replaces it)
    "v8": ("constexpr int kVec = 4;", "constexpr int kVec = 8;"),
    "t256": ("constexpr int kThreads = 512;", "constexpr int kThreads = 256;"),
    "t128": ("constexpr int kThreads = 512;", "constexpr int kThreads = 128;"),
    "ldcs": ("__ldg(", "__ldcs("),
}


def fail(msg: str) -> None:
    print(f"[adamw_compare] FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def sources(other):
    """name -> CUDA source of each build."""
    text = (ROOT / SOURCE).read_text()
    out = {"this": text}
    if other:
        out["other"] = (other / SOURCE).read_text()
    for name, (a, b) in VARIANTS.items():
        if a not in text:
            fail(f"variant {name}: {a!r} is not in {SOURCE}")
        out[name] = text.replace(a, b)
    return out


def compile_all(srcs):
    """name -> loaded library; prints each kernel's registers and spills."""
    from repro_torch.kernels import build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            fail(f"nvcc {name}:\n{log}")
        for fn, ln in cs.ptxas_lines(log):
            print(f"[ptxas] {name}: {fn}: {ln}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


class OneLibrary:
    """Stands in for a wrapper module's ``build``: every load is one
    library."""

    def __init__(self, lib):
        self.lib = lib

    def load(self, name):
        return self.lib


def wrappers(names, other):
    """name -> the wrapper module that calls that build's C interface."""
    import repro_torch.kernels.sparse_adamw as mine
    mods = {n: mine for n in names}
    if other:
        spec = importlib.util.spec_from_file_location("other_sparse_adamw",
                                                      other / WRAPPER)
        mods["other"] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods["other"])
    return mods


def cases(torch):
    """case -> (entry point, its arguments, timed?)."""
    from repro_torch.configs import get_config
    from repro_torch.core.masks import budget
    from repro_torch.kernels import ops
    from repro_torch.training import qstate
    cfg = get_config("starcoder2-7b")
    k, L = budget(cfg.d_model, cfg.d_ff, 0.98), cfg.num_layers
    scalars = ops._adamw_scalars(3, 3e-4, 0.9, 0.999, 1e-8, 0.0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    out = {f"blocks ({L}*{k},)": (
        "sparse_adamw", (*cs.adamw_inputs(torch, gen, (L * k,)), scalars),
        True)}
    for shape, timed in (((3 * L, k), True), ((5, 3), False),
                         ((7, 13), False)):
        v, g, m, u = cs.adamw_inputs(torch, gen, shape)
        for mode in ("f32", "bf16", "int8"):
            mq, ms = qstate.encode(m, mode)
            uq, us = qstate.encode(u, mode, sqrt_domain=True)
            out[f"rows {shape} {mode}"] = (
                "sparse_adamw_rows", (v, g, mq, uq, ms, us, scalars), timed)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="checkout of another commit")
    ap.add_argument("--rounds", type=int, default=7)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    print(f"[device] {cs.card_line()}", flush=True)
    other = Path(args.other).resolve() if args.other else None
    libs = compile_all(sources(other))
    mods = wrappers(libs, other)

    def call(name, entry, a):
        mods[name].build = OneLibrary(libs[name])
        return getattr(mods[name], entry)(*a)

    work = cases(torch)
    differ = []
    for case, (entry, a, _) in work.items():
        ref = call("this", entry, a)
        for name in libs:
            if name != "this":
                equal = all(torch.equal(x, y)
                            for x, y in zip(call(name, entry, a), ref))
                print(f"[bits] {case}: {name} bit-equal to this: {equal}",
                      flush=True)
                if not equal:
                    differ.append(f"{name} at {case}")
        del ref
        torch.cuda.empty_cache()

    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scratch.fill_(1)
    timed = {c: w for c, w in work.items() if w[2]}
    ms = {(n, c): [] for n in libs for c in timed}
    for _ in range(args.rounds):
        for name in libs:
            for case, (entry, a, _) in timed.items():
                ms[name, case].append(cs.cold_ms(
                    torch, lambda: call(name, entry, a), 10, flush))
    for case in timed:
        for name in libs:
            xs = ms[name, case]
            print(f"[time] {case}: {name} median {statistics.median(xs):.4f}"
                  f" ms, range {min(xs):.4f}-{max(xs):.4f} over "
                  f"{len(xs)} rounds", flush=True)
    print(f"[device] {cs.card_line()}", flush=True)
    if differ:
        fail("outputs differ from this build's: " + ", ".join(differ))


if __name__ == "__main__":
    main()
