"""Deterministic synthetic data pipeline (text modality).

A copy of ``repro/data/pipeline.py``'s text path, so the port makes the
same batches without importing the JAX package: numpy draws, bit-identical
to the reference's for the same (seed, step, task). A ``TaskSpec`` defines
an affine next-token rule

    t_{i+1} = (a * t_i + b) mod V'        over a vocab slice V' <= V

with per-task (a, b, V'), so adapters trained on different task ids learn
different rules. The vision and audio stubs wait with their families
(ROADMAP A9).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeSpec


@dataclass(frozen=True)
class TaskSpec:
    task_id: int = 0
    vocab_slice: int = 0        # 0 => min(4096, vocab)

    def rule(self, vocab: int):
        v = self.vocab_slice or min(4096, vocab)
        rng = np.random.RandomState(1000 + self.task_id)
        a = int(rng.randint(2, v - 1)) | 1
        b = int(rng.randint(1, v - 1))
        return a, b, v


def _token_stream(cfg: ModelConfig, n: int, s: int, seed: int, step: int,
                  task: TaskSpec) -> np.ndarray:
    a, b, v = task.rule(cfg.vocab_size)
    rng = np.random.RandomState((seed * 9973 + step * 131 + task.task_id)
                                % (2 ** 31))
    t0 = rng.randint(0, v, size=(n, 1))
    toks = [t0]
    # occasional re-seeding breaks degenerate cycles, keeps the rule learnable
    for i in range(s):
        nxt = (toks[-1] * a + b) % v
        if i % 64 == 63:
            nxt = rng.randint(0, v, size=(n, 1))
        toks.append(nxt)
    return np.concatenate(toks, axis=1).astype(np.int32)  # (n, s+1)


def make_batch(cfg: ModelConfig, shape: ShapeSpec, seed: int, step: int,
               task: TaskSpec = TaskSpec()) -> Dict[str, np.ndarray]:
    """Global train batch: {"tokens", "labels"} int32 (batch, seq)."""
    if cfg.modality != "text":
        raise NotImplementedError(
            f"modality {cfg.modality!r} is not ported (ROADMAP A9)")
    stream = _token_stream(cfg, shape.global_batch, shape.seq_len, seed,
                           step, task)
    return {"tokens": stream[:, :-1], "labels": stream[:, 1:]}


def batch_iterator(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
                   task: TaskSpec = TaskSpec(),
                   start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield make_batch(cfg, shape, seed, step, task)
        step += 1
