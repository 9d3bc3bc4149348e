"""Time chip_smoke.py's attention phase for this tree and for another
checkout of the repository on one card, in turns, and print each
flash_decode and flash_decode_paged case's times side by side.

  python3 tools/attention_compare.py --other DIR [--order otto] [--logs OUT]

DIR is a checkout of another commit (``git archive <rev> | tar -x -C
build/other``). ``--order`` names the turns, ``t`` this tree and ``o`` the
other (parent, change, change, parent by default). Each turn is a process
of its own: the checkout's ``src`` and ``chip_smoke.py`` first on the
path, its kernels built into the checkout's ``build/kernels``, then
``chip_smoke.attention_kernels_phase`` (every case checked against its
plain version, cold-L2 CUDA events). The summary gives, for each decode
case of this tree, the mean ms over each side's turns and their ratio,
SDPA's ms, the bound and the case's splits a request (``nsplit``, this
tree's plan); each turn's whole output is kept under ``--logs``
(``build/attention_compare`` by default). Needs the card and ``nvcc``;
exits 1 if a turn fails.
"""
from __future__ import annotations

import argparse
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TURN = """
import sys
root = sys.argv[1]
sys.path[:0] = [root + "/src", root]
import torch
from repro_torch.kernels import build
import chip_smoke
build.build(["flash_decode", "flash_prefill"])
print("[turn]", chip_smoke.card_line(), flush=True)
scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
chip_smoke.attention_kernels_phase(torch, lambda: scratch.fill_(1))
"""
FIELDS = {"ms": r" ms=([\d.]+)", "sdpa": r"library_ms\(sdpa\)=([\d.]+)",
          "bound": r"bound_ms=([\d.]+)", "nsplit": r"nsplit=(\d+)"}


def cases(log: str) -> dict:
    """{case label: {field: value}} of a turn's flash_decode lines."""
    out = {}
    for ln in log.splitlines():
        if ln.startswith("[kernels] flash_decode") and " ms=" in ln:
            label = ln[len("[kernels] "):].split(": max_abs_err")[0]
            out[label] = {k: float(m.group(1)) for k, p in FIELDS.items()
                          if (m := re.search(p, ln))}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--order", default="otto")
    ap.add_argument("--logs", type=Path,
                    default=ROOT / "build" / "attention_compare")
    args = ap.parse_args()
    logs = args.logs
    logs.mkdir(parents=True, exist_ok=True)
    runs = {"t": [], "o": []}
    for i, side in enumerate(args.order):
        root = ROOT if side == "t" else args.other.resolve()
        p = subprocess.run([sys.executable, "-c", TURN, str(root)],
                           capture_output=True, text=True)
        (logs / f"turn{i}_{side}.log").write_text(p.stdout + p.stderr)
        if p.returncode:
            print(p.stdout[-2000:] + p.stderr[-2000:])
            sys.exit(f"turn {i} ({side}) failed: {p.returncode}")
        card = re.search(r"\[turn\] (.*)", p.stdout)
        print(f"[compare] turn {i} ({side}): {card and card.group(1)}",
              flush=True)
        runs[side].append(cases(p.stdout))
    mean = lambda side, k, f: statistics.fmean(r[k][f] for r in runs[side])
    for k, row in runs["t"][0].items():
        new = mean("t", k, "ms")
        old = (f"{mean('o', k, 'ms'):.4f} -> " if runs["o"] and
               k in runs["o"][0] else "")
        ratio = (f" ({new / mean('o', k, 'ms'):.2f}x)" if old else "")
        print(f"[compare] {k}: {old}{new:.4f}{ratio} sdpa "
              f"{mean('t', k, 'sdpa'):.4f} bound {row['bound']:.4f} "
              f"nsplit {row.get('nsplit', 0):.0f}", flush=True)


if __name__ == "__main__":
    main()
