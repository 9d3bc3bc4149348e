"""Training entry point: SHiRA finetuning of one adapter.

Port of ``repro/launch/train.py``, with its flags. Runs on the card unless
``--device cpu`` is given (with ``--smoke`` for the 2-layer config there).
``--adapter`` takes the reference's ``shira[-<mask>][-hook]``: plain
``shira`` is the ``wm`` mask, packed; ``-hook`` trains in hook mode. The
``grad`` and ``snip`` masks need calibration gradients, which the command
line does not give, so they raise ``ValueError`` as the reference's do.
``none``, ``lora``, ``dora`` and ``shira-dora`` wait (ROADMAP A2),
``--ckpt-dir`` waits for checkpointing (A8). ``main`` returns the run's
numbers as a dict, so scripts can drive it as a user would.

  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-7b \\
      --adapter shira-wm --seq 256 --batch 8 --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-7b \\
      --smoke --device cpu --adapter shira-wm-hook --steps 3
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
from typing import List, Optional

import torch

from repro_torch.configs import (AdapterConfig, ModelConfig, RunConfig,
                                 ShapeSpec, TrainConfig, get_config,
                                 get_smoke_config)
from repro_torch.core.masks import iter_leaves
from repro_torch.data import TaskSpec, batch_iterator
from repro_torch.runtime import Trainer, TrainerConfig

PRESET_100M = ModelConfig(
    name="dense-100m", family="dense", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=12, d_ff=3072, vocab_size=32000,
    tie_embeddings=True,
)


def parse_adapter(spec: str) -> AdapterConfig:
    """'shira' | 'shira-<mask>' | 'shira-<mask>-hook', as the reference
    parses them ('none', 'lora', 'dora' and 'shira-dora' wait, ROADMAP
    A2)."""
    if spec in ("none", "lora", "dora") or spec.startswith("shira-dora"):
        raise NotImplementedError(
            f"--adapter {spec!r} is not ported (ROADMAP A2); use "
            "shira[-<mask>][-hook]")
    if spec.startswith("shira"):
        parts = spec.split("-")
        mask = parts[1] if len(parts) > 1 else "wm"
        hook = len(parts) > 2 and parts[2] == "hook"
        return AdapterConfig(kind="shira", mask=mask, packed=not hook)
    raise ValueError(spec)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--preset", default=None, choices=[None, "100m"])
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config for --arch")
    ap.add_argument("--adapter", default="none")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--task", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--out", default=None, help="write loss history JSON")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked for")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None, keep: bool = False) -> dict:
    """Train as the flags say; returns the run's numbers, and with
    ``keep`` also the ``Trainer`` and its final state (``trainer``,
    ``state``), for a caller that exports or publishes the adapter."""
    args = parse_args(argv)
    if args.preset == "100m":
        cfg = PRESET_100M
    elif args.arch:
        cfg = (get_smoke_config(args.arch) if args.smoke
               else get_config(args.arch))
    else:
        raise SystemExit("need --arch or --preset")
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    run = RunConfig(model=cfg, shape=shape,
                    adapter=parse_adapter(args.adapter),
                    train=TrainConfig(learning_rate=args.lr, seed=args.seed,
                                      total_steps=args.steps,
                                      warmup_steps=max(args.steps // 20, 1)))
    trainer = Trainer(run, TrainerConfig(ckpt_dir=args.ckpt_dir,
                                         log_every=max(args.steps // 20, 1)),
                      device=args.device)
    batches = batch_iterator(cfg, shape, seed=args.seed,
                             task=TaskSpec(task_id=args.task))
    out = trainer.fit(args.steps, batches=batches)
    losses = [h["loss"] for h in out["history"]]
    step_ms = [h["step_ms"] for h in out["history"]]
    steady = statistics.median(step_ms[1:] or step_ms)
    print(f"[train] {cfg.name} adapter={args.adapter} "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"step {steady:.1f} ms (median after the first), "
          f"{shape.tokens / steady * 1e3:.0f} tokens/s")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"arch": cfg.name, "adapter": args.adapter,
                       "losses": losses}, f)
    n_trained = (sum(int(m.count_nonzero())
                     for _, m in iter_leaves(trainer.masks))
                 if trainer.hook_mode else
                 sum(v.numel() for _, v in
                     iter_leaves(out["state"]["trainable"])))
    stats = {"losses": losses, "step_ms": step_ms, "steady_step_ms": steady,
             "tokens_per_s": shape.tokens / steady * 1e3,
             "trained_values": n_trained,
             "mask_seconds": trainer.mask_seconds}
    if keep:
        stats.update(trainer=trainer, state=out["state"])
    del out, trainer
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return stats


if __name__ == "__main__":
    main()
