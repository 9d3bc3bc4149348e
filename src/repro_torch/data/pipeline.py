"""Deterministic synthetic data pipeline, every modality.

A copy of ``repro/data/pipeline.py``, so the port makes the same batches
without importing the JAX package: numpy draws, bit-identical to the
reference's for the same (seed, step, task). A ``TaskSpec`` defines
an affine next-token rule

    t_{i+1} = (a * t_i + b) mod V'        over a vocab slice V' <= V

with per-task (a, b, V'), so adapters trained on different task ids learn
different rules.

The modality frontends are stubs, as in the reference: an audio batch is
precomputed frame embeddings with random class labels, a vision batch a
text stream after ``num_prefix_embeds`` precomputed patch embeddings
(``_stub_embeds``: 0.02 N(0, 1) in f32). A vision batch's ``seq_len``
counts the patches, so its text is ``seq_len - num_prefix_embeds`` tokens
(none where ``seq_len <= num_prefix_embeds``, as the reference's).
``SyntheticTask.host_batch`` slices a data-parallel rank's rows out of the
global batch.
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


class SyntheticTask:
    """One (config, shape, seed, task) stream of global batches, and a
    host's (a data-parallel rank's) contiguous slice of each."""

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
                 task: TaskSpec = TaskSpec()):
        self.cfg, self.shape, self.seed, self.task = cfg, shape, seed, task

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        return make_batch(self.cfg, self.shape, self.seed, step, self.task)

    def host_batch(self, step: int, host_index: int,
                   host_count: int) -> Dict[str, np.ndarray]:
        full = self.global_batch(step)
        bsz = self.shape.global_batch
        assert bsz % host_count == 0
        per = bsz // host_count
        sl = slice(host_index * per, (host_index + 1) * per)
        return {k: v[sl] for k, v in full.items()}


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


def _stub_embeds(n: int, s: int, d: int, seed: int, step: int) -> np.ndarray:
    rng = np.random.RandomState((seed * 7919 + step * 17) % (2 ** 31))
    return (rng.randn(n, s, d) * 0.02).astype(np.float32)


def make_batch(cfg: ModelConfig, shape: ShapeSpec, seed: int, step: int,
               task: TaskSpec = TaskSpec()) -> Dict[str, np.ndarray]:
    """Global train batch for any modality: text {"tokens", "labels"}
    int32 (batch, seq); audio {"frame_embeds" f32 (batch, seq, d_model),
    "labels"}; vision the text of ``seq - num_prefix_embeds`` tokens and
    "patch_embeds" f32 (batch, num_prefix_embeds, d_model)."""
    n, s = shape.global_batch, shape.seq_len
    if cfg.modality == "audio":
        emb = _stub_embeds(n, s, cfg.d_model, seed, step)
        rng = np.random.RandomState((seed + step) % (2 ** 31))
        labels = rng.randint(0, cfg.vocab_size, size=(n, s)).astype(np.int32)
        return {"frame_embeds": emb, "labels": labels}
    if cfg.modality == "vision":
        p = cfg.prefix_rows
        stream = _token_stream(cfg, n, s - p, seed, step, task)
        return {"tokens": stream[:, :-1], "labels": stream[:, 1:],
                "patch_embeds": _stub_embeds(n, p, cfg.d_model, seed, step)}
    stream = _token_stream(cfg, n, s, seed, step, task)
    return {"tokens": stream[:, :-1], "labels": stream[:, 1:]}


def batch_iterator(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
                   task: TaskSpec = TaskSpec(),
                   start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield make_batch(cfg, shape, seed, step, task)
        step += 1
