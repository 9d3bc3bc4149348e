"""Plain-torch oracles, ports of ``repro/kernels/ref.py``: the same math on
the reference's coordinate layout ((row, col, val) triples), with dense
intermediates. Tests hold the kernels' plain versions against these and
against the JAX package."""
from __future__ import annotations

import torch


def scatter_apply_ref(w: torch.Tensor, flat_idx: torch.Tensor,
                      vals: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """w: (n, m); flat_idx/vals: (K,). W + alpha * scatter(vals), summed in
    f32 and rounded once to w's dtype."""
    n, m = w.shape
    out = w.reshape(-1).float().clone()
    out.index_add_(0, flat_idx.long(), vals.float() * alpha)
    return out.reshape(n, m).to(w.dtype)


def sidedelta_ref(x: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                  vals: torch.Tensor, ids: torch.Tensor, m: int
                  ) -> torch.Tensor:
    """x: (B, S, n); rows/cols/vals: (A, K); ids: (B,) with -1 = no adapter.
    Returns (B, S, m) f32: delta[b] = x[b] @ dW_{ids[b]}, dW scattered
    densely from the (row, col, val) triples."""
    B, S, n = x.shape
    A, K = rows.shape
    dense = torch.zeros((A, n * m), dtype=torch.float32, device=x.device)
    flat = rows.long() * m + cols.long()
    dense.scatter_add_(1, flat, vals.float())
    slot = ids.long().clamp(min=0)
    delta = torch.einsum("bsn,bnm->bsm", x.float(),
                         dense.reshape(A, n, m)[slot])
    return torch.where((ids >= 0)[:, None, None], delta,
                       torch.zeros((), device=x.device))


def sidedelta_int8_ref(x: torch.Tensor, rows: torch.Tensor,
                       cols: torch.Tensor, vals_q: torch.Tensor,
                       scale: torch.Tensor, ids: torch.Tensor, m: int
                       ) -> torch.Tensor:
    """int8-table oracle: vals_q (A, K) int8 with per-adapter scale (A,) f32,
    dequantized as q * scale in f32 before the dense contraction."""
    vals = vals_q.float() * scale[:, None].float()
    return sidedelta_ref(x, rows, cols, vals, ids, m)
