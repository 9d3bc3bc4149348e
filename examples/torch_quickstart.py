"""Quickstart for the PyTorch/CUDA port: SHiRA in ~70 lines.

Builds a causal LM, finetunes a SHiRA-WM adapter (1% of weights) on a
synthetic task, exports the sparse pack, and rapid-switches it on a
deployed copy of the base model. The port's counterpart of
examples/quickstart.py.

  PYTHONPATH=src python examples/torch_quickstart.py            # the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu --smoke

On the card it runs starcoder2-7b cut to 2 layers at full width (or
``--arch``); ``--smoke`` takes the reduced config, which runs on a CPU.
"""
import argparse

import torch

from repro_torch import core
from repro_torch.configs import (AdapterConfig, RunConfig, ShapeSpec,
                                 TrainConfig, get_config, get_smoke_config)
from repro_torch.data import TaskSpec, batch_iterator, make_batch
from repro_torch.models import lm
from repro_torch.runtime import Trainer, TrainerConfig
from repro_torch.runtime.trainer import device_batch

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--arch", default="starcoder2-7b")
ap.add_argument("--smoke", action="store_true",
                help="the reduced config (runs on a CPU)")
ap.add_argument("--layers", type=int, default=2,
                help="depth at full width (0: all)")
ap.add_argument("--steps", type=int, default=60)
ap.add_argument("--device", default="cuda",
                help="torch device; the CPU only when asked for")
args = ap.parse_args()

# 1. model + adapter config ---------------------------------------------------
cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
if args.layers and not args.smoke:
    cfg = cfg.replace(num_layers=args.layers)
shape = ShapeSpec("demo", seq_len=64, global_batch=8, kind="train")
adapter = AdapterConfig(kind="shira", mask="wm", sparsity=0.99)  # 1% trainable
run = RunConfig(model=cfg, shape=shape, adapter=adapter,
                train=TrainConfig(learning_rate=2e-2, total_steps=args.steps,
                                  warmup_steps=3))

# 2. finetune the adapter (packed mode: optimizer state only on the 1%) -------
trainer = Trainer(run, TrainerConfig(log_every=20), device=args.device)
out = trainer.fit(args.steps, batches=batch_iterator(
    cfg, shape, seed=0, task=TaskSpec(task_id=1)))
pack = trainer.export_pack(out["state"], name="task1")
n_base = sum(x.numel() for _, x in core.masks.iter_leaves(trainer.base))
print(f"adapter pack: {pack.num_params()} params, {pack.nbytes()/1e3:.1f}KB "
      f"(model is {n_base/1e3:.0f}K params)")

# 3. rapid switching on a deployed model --------------------------------------
engine = core.SwitchEngine(trainer.base)


def task_loss(task):
    b = device_batch(make_batch(cfg, shape, seed=9, step=0,
                                task=TaskSpec(task_id=task)), args.device)
    with torch.no_grad():
        return float(lm.train_loss(engine.params, cfg, b)[0])


print(f"base model loss on task1:    {task_loss(1):.4f}")
st = engine.switch(pack)                          # sparse scatter, no fuse
print(f"switched in {st.seconds*1e3:.1f}ms ({st.entries_written} entries)")
print(f"adapted model loss on task1: {task_loss(1):.4f}")
engine.unload()                                   # base restored exactly
print(f"base restored, loss again:   {task_loss(1):.4f}")
