"""Plain-torch oracles, ports of ``repro/kernels/ref.py``: the same math on
the reference's coordinate layout ((row, col, val) triples), with dense
intermediates. Tests hold the kernels' plain versions against these and
against the JAX package."""
from __future__ import annotations

import numpy as np
import torch


def scatter_apply_ref(w: torch.Tensor, flat_idx: torch.Tensor,
                      vals: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """w: (n, m); flat_idx/vals: (K,). W + alpha * scatter(vals), summed in
    f32 and rounded once to w's dtype."""
    n, m = w.shape
    out = w.reshape(-1).float().clone()
    out.index_add_(0, flat_idx.long(), vals.float() * alpha)
    return out.reshape(n, m).to(w.dtype)


def masked_update_ref(w: torch.Tensor, mask: torch.Tensor,
                      vals: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """W + alpha * (M * V), summed in f32 and rounded once to w's dtype,
    as a new tensor."""
    out = w.float() + alpha * mask.float() * vals.float()
    return out.to(w.dtype)


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


def sidedelta_dvals_ref(x: torch.Tensor, dy: torch.Tensor,
                        rows: torch.Tensor, cols: torch.Tensor,
                        ids: torch.Tensor) -> torch.Tensor:
    """The gradient of ``sidedelta_ref`` with respect to its values, on the
    coordinate layout: per adapter a, the dense dW_a = sum over its
    requests of x[b]^T @ dy[b], (n, m) in f32, read at (rows, cols).
    x: (B, S, n); dy: (B, S, m); rows/cols: (A, K); returns (A, K) f32."""
    B, S, n = x.shape
    m = dy.shape[-1]
    A, K = rows.shape
    out = torch.zeros((A, K), dtype=torch.float32, device=x.device)
    flat = rows.long() * m + cols.long()
    for a in range(A):
        sel = ids == a
        if not bool(sel.any()):
            continue
        xa = x[sel].float().reshape(-1, n)
        dya = dy[sel].float().reshape(-1, m)
        out[a] = (xa.T @ dya).reshape(-1)[flat[a]]
    return out


def sparse_adamw_ref(values, grads, mu, nu, *, lr, b1, b2, eps, wd, step):
    """One AdamW step, the reference oracle's math (Python-float scalars,
    as ``repro.kernels.ref.sparse_adamw_ref`` has them)."""
    g = grads.float()
    v = values.float()
    m = b1 * mu + (1 - b1) * g
    u = b2 * nu + (1 - b2) * g * g
    c1 = 1.0 - b1 ** step
    c2 = 1.0 - b2 ** step
    delta = (m / c1) / (torch.sqrt(u / c2) + eps) + wd * v
    return (v - lr * delta).to(values.dtype), m, u


def sparse_adamw_rows_ref(values, grads, mu, nu, mu_scale, nu_scale, step,
                          *, lr, b1, b2, eps, wd, mode: str):
    """The row-batched step of the multi-adapter trainer's reference path
    (``repro/training/multi.py``, ``fused=False``): decode the stored
    moments (f32, bf16, or int8 with per-row scales, nu in the sqrt
    domain), then AdamW with bias corrections from the f32 step. Returns
    (values, mu, nu), the moments f32."""
    if mode == "int8":
        mf = mu.float() * mu_scale[..., None]
        ru = nu.float() * nu_scale[..., None]
        uf = ru * ru
    else:
        mf, uf = mu.float(), nu.float()
    g = grads.float()
    t = torch.tensor(step, dtype=torch.float32)
    m = b1 * mf + (1.0 - b1) * g
    u = b2 * uf + (1.0 - b2) * g * g
    mh = m / (1.0 - b1 ** t)
    uh = u / (1.0 - b2 ** t)
    delta = mh / (torch.sqrt(uh) + eps) + wd * values
    return values - lr * delta, m, u


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len) -> torch.Tensor:
    """q: (B, KV, G, D); k/v: (B, S, KV, D); kv_len a scalar or (B,)
    per-request lengths. Masked softmax attention in f32, cast to q's
    dtype (the reference's oracle, with per-request lengths)."""
    B, KV, G, D = q.shape
    S = k.shape[1]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(D)))
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) * scale
    kl = torch.as_tensor(kv_len, device=q.device).long().reshape(-1, 1)
    mask = torch.arange(S, device=q.device)[None, :] < kl     # (B|1, S)
    s = s.masked_fill(~mask[:, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p, v.float()).to(q.dtype)


def flash_decode_paged_ref(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           kv_len: torch.Tensor) -> torch.Tensor:
    """The paged oracle: gather each request's pages (P, page, KV, D) ->
    (B, nblk * page, KV, D) in table order, then ``flash_decode_ref`` with
    the per-request lengths (B,)."""
    B, nblk = block_tables.shape
    flat = block_tables.reshape(-1).long()
    rows = nblk * k_pool.shape[1]
    kk = k_pool[flat].reshape((B, rows) + tuple(k_pool.shape[2:]))
    vv = v_pool[flat].reshape((B, rows) + tuple(v_pool.shape[2:]))
    return flash_decode_ref(q, kk, vv, kv_len)


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Skv, KV, D) -> (B, Sq, H, D). Softmax
    attention in f32 (causal positions aligned from 0), cast to q's
    dtype."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(D)))
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Skv, device=q.device)[None, :])
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)
