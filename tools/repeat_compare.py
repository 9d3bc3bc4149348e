"""Load a pack with repeated indices (ROADMAP C3) through this tree's
scatter_apply and through another commit's, on the card.

  python3 tools/repeat_compare.py --other DIR

DIR is a checkout of another commit (``git archive <rev> | tar -x -C
build/other``). The case is ``chip_smoke.repeat_case``: a (4, 4608,
18432) f32 slice of w_up, 1% of each matrix's entries, every tenth of
them a repeat of an index already in its row (adjacent and five apart),
and index 0 repeated beside the padding. This tree loads it through
``apply_pack``, whose ``AdapterPack`` merges the repeats first; DIR's
``scatter_apply`` gets the entries as they are, as DIR's ``apply_pack``
hands a pack's entries over. Each result is held against
``scatter_apply_plain`` of the same entries to one ulp of the largest
result. Prints one line per build; exits 1 if this tree's load is off,
whatever DIR's does. Needs the card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import kernel_compare as kc  # noqa: E402  (imports chip_smoke, adds src)

cs = kc.cs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, required=True)
    args = ap.parse_args()
    import torch
    from repro_torch.core.adapters import AdapterPack, apply_pack
    from repro_torch.kernels import build
    print(f"[device] {cs.card_line()}", flush=True)
    build.build(["scatter_apply"])
    text = (args.other / kc.CSRC / "scatter_apply.cu").read_text()
    libs = kc.compile_all({("scatter_apply", "other"): text})
    other = kc.wrapper("scatter_apply", "other", libs, args.other)
    out = {}
    for label, apply in (
            ("other: its scatter_apply on the entries as they are",
             lambda w, i, v: other.scatter_apply(w, i, v, 1.0)),
            ("this: apply_pack, merged when the pack is built",
             lambda w, i, v: apply_pack(
                 {"w": w}, AdapterPack("repeats", {"w": (i, v)})))):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(21)
        err, tol, _, _ = cs.repeat_case(torch, gen, apply, label)
        out[label.split(":")[0]] = err <= tol
        torch.cuda.empty_cache()
    print(f"[repeat_compare] within one ulp: {out}", flush=True)
    return 0 if out["this"] else 1


if __name__ == "__main__":
    sys.exit(main())
