"""AdamW over trees of packed values, the dense AdamW direction of
hook-mode training, and the learning-rate schedule.

Port of ``repro/optim/adamw.py``: the plain reference, used on the CPU and
in the tests. The packed trainers' update on the card is the fused
``kernels.ops.sparse_adamw`` (one launch per leaf), which computes the same
step from the same scalars; this module's ``adamw_update`` follows the
reference's own rounding (Python-float betas), which differs from the
kernel's f32 scalars in the last bits only. Hook mode splits the update:
``adamw_direction_`` computes the direction U = m̂ / (√v̂ + ε) with the
reference's f32 operations in its order, and the ``masked_update`` kernel
applies W + (-lr) * (M ⊙ U).

Trees are nested dicts/lists of tensors with None at leaves that are not
trained, as ``core.masks.map_leaves`` builds them.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.masks import iter_leaves, map_leaves
from repro_torch.kernels.ops import _adamw_scalars


class AdamWState(NamedTuple):
    step: int
    mu: Any
    nu: Any


def adamw_init(trainable) -> AdamWState:
    zeros = lambda t: map_leaves(
        lambda _, x: torch.zeros_like(x, dtype=torch.float32), t)
    return AdamWState(step=0, mu=zeros(trainable), nu=zeros(trainable))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, f32 (a 0-dim tensor)."""
    leaves = [torch.sum(torch.square(x.float())) for _, x in iter_leaves(tree)]
    return (torch.sqrt(torch.sum(torch.stack(leaves))) if leaves
            else torch.zeros(()))


def batched_global_norm(tree, batch: int) -> torch.Tensor:
    """Per-row global norms for a tree whose leaves all carry the same
    leading stacked axis of size ``batch``: the multi-adapter trainer's
    per-adapter clip, each adapter's norm as its own run would have it."""
    leaves = [torch.sum(torch.square(x.float().reshape(batch, -1)), dim=1)
              for _, x in iter_leaves(tree)]
    if not leaves:
        return torch.zeros((batch,))
    return torch.sqrt(torch.sum(torch.stack(leaves, dim=0), dim=0))


def clip_scale(gnorm: torch.Tensor, clip: float) -> torch.Tensor:
    """min(1, clip / (gnorm + 1e-9)) in f32, the reference's clip factor."""
    return torch.clamp(clip / (gnorm + 1e-9), max=1.0)


def adamw_update(grads, state: AdamWState, trainable, tcfg: TrainConfig,
                 lr, gnorm: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step over a tree. ``gnorm``, the global gradient norm the
    clip reads, defaults to ``global_norm(grads)``; a sharded step passes
    the norm over every rank's shards (``launch.steps``)."""
    if gnorm is None:
        gnorm = global_norm(grads)
    if tcfg.grad_clip > 0:
        scale = clip_scale(gnorm, tcfg.grad_clip)
        grads = map_leaves(lambda _, g: g * scale, grads)
    step = state.step + 1
    b1, b2 = tcfg.beta1, tcfg.beta2
    t = torch.tensor(step, dtype=torch.float32)
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    lr = torch.as_tensor(lr, dtype=torch.float32)
    mu = dict(iter_leaves(state.mu))
    nu = dict(iter_leaves(state.nu))
    gr = dict(iter_leaves(grads))
    out = {}
    for path, p in iter_leaves(trainable):
        g = gr[path].float()
        m = b1 * mu[path] + (1 - b1) * g
        v = b2 * nu[path] + (1 - b2) * g * g
        delta = (m / c1) / (torch.sqrt(v / c2) + tcfg.eps)
        if tcfg.weight_decay:
            delta = delta + tcfg.weight_decay * p.float()
        out[path] = ((p.float() - lr * delta).to(p.dtype), m, v)
    pick = lambda i: map_leaves(lambda path, _: out[path][i], trainable)
    return pick(0), AdamWState(step, pick(1), pick(2)), {"grad_norm": gnorm}


def adamw_direction_(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                     step: int, tcfg: TrainConfig) -> torch.Tensor:
    """The AdamW direction of one dense f32 leaf at the 1-based ``step``,
    in place: mu and nu become the step's moments and g is overwritten
    with U = (m / c1) / (sqrt(v / c2) + eps); returns g. The reference's
    operations in its order, one PyTorch elementwise op each, none fused:

      m = b1 * m + (1 - b1) * g
      v = b2 * v + (1 - b2) * g * g

    The bias corrections are the packed kernels' (f32, from the f32
    betas) and divide as 0-dim tensors on g's device (PyTorch divides by
    a CPU scalar through its reciprocal on the card). One scratch leaf of
    g's size is alive while it runs."""
    b1, b2 = tcfg.beta1, tcfg.beta2
    c1, c2 = (torch.tensor(c, dtype=torch.float32, device=g.device)
              for c in _adamw_scalars(step, 0.0, b1, b2, 0.0, 0.0)[5:])
    t = g * (1 - b1)
    mu.mul_(b1).add_(t)
    torch.mul(g, 1 - b2, out=t).mul_(g)
    nu.mul_(b2).add_(t)
    torch.div(nu, c2, out=t).sqrt_().add_(tcfg.eps)
    return torch.div(mu, c1, out=g).div_(t)


def lr_schedule(tcfg: TrainConfig) -> Callable[[int], float]:
    """step (0-based) -> learning rate, computed in f32 as the reference's
    jnp schedule is; returned as a Python float that f32 holds exactly."""
    f = np.float32
    base = f(tcfg.learning_rate)
    warm = max(tcfg.warmup_steps, 1)
    total = max(tcfg.total_steps, warm + 1)

    def fn(step: int) -> float:
        s = f(step)
        if s < f(warm):
            return float(base * (s + f(1)) / f(warm))
        frac = min(max((s - f(warm)) / f(total - warm), f(0)), f(1))
        if tcfg.schedule == "cosine":
            post = base * f(0.5) * (f(1) + np.cos(f(math.pi) * frac))
        elif tcfg.schedule == "linear":
            post = base * (f(1) - frac)
        else:
            post = base
        return float(f(post))

    return fn
