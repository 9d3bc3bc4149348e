"""Basic building blocks: norms, embeddings, RoPE, MLPs, init helpers.

Port of ``repro/models/layers.py``. Modules are plain functions over dicts
of tensors. Matmuls run in ``compute_dtype`` (bf16 by default); norms,
RoPE and the side delta run in f32. Parameters stay in f32 and ``pdot``
casts each weight to the compute dtype at every call, as the reference
does; that cast is the largest non-kernel cost of a decode step (PERF.md).
Leaf names follow the reference's convention (``wq wk wv wo w_up w_gate
w_down emb lm_head scale b*``), which the adapter machinery keys off.

Under the launch layer's "tp" hint (``launch.actctx``, a
``launch.sharding.TPLayout``) the leaves are one rank's local shards and
the TP/FSDP forward below runs (``tp_column``, ``tp_row``, ``mlp`` with
its ``d_ff``, ``embed_tp``, ``tp_unembed_weight``, ``vocab_parallel_nll``):
a column-parallel leaf keeps a local output behind ``copy_to`` (identity
forward, all-reduce backward), a row-parallel one all-reduces its partial
sums, an FSDP leaf is gathered over ``data`` (its gradient
reduce-scattered), the vocabulary is split over ``model``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.adapters import is_bundle, materialize_leaf
from repro_torch.kernels.ops import sidedelta
from repro_torch.kernels.sidedelta import sidedelta_train
from repro_torch.launch import mesh as MESH
from repro_torch.launch.actctx import hint

COMPUTE_DTYPE = torch.bfloat16  # default; see compute_precision()


def compute_dtype() -> torch.dtype:
    """The current matmul/activation dtype."""
    return COMPUTE_DTYPE


@contextlib.contextmanager
def compute_precision(dtype: torch.dtype):
    """Temporarily override the compute dtype (default bf16). Parity checks
    run under ``torch.float32``, as the reference's do under
    ``jnp.float32``."""
    global COMPUTE_DTYPE
    prev = COMPUTE_DTYPE
    COMPUTE_DTYPE = dtype
    try:
        yield
    finally:
        COMPUTE_DTYPE = prev


def cast_compute(tree):
    """Cast every >=2D float tensor of a nested dict/list to the compute
    dtype; other leaves pass through."""
    if isinstance(tree, dict):
        return {k: cast_compute(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_compute(v) for v in tree)
    if (isinstance(tree, torch.Tensor) and tree.ndim >= 2
            and tree.is_floating_point()):
        return tree.to(compute_dtype())
    return tree


# ---------------------------------------------------------------------------
# Side-delta weights (multi-tenant serving, multi-adapter training)
# ---------------------------------------------------------------------------
# A weight leaf may be replaced by a dict bundling the shared base matrix
# with the per-adapter sparse-delta table (the column-sorted layout built by
# ``kernels.ops.sidedelta_table``) and the batch's per-request adapter ids
# (see repro_torch/serving/multitenant.py). ``pdot`` then computes the base
# matmul once for the whole batch plus each request's sparse correction via
# the sidedelta kernel. Every entry carries the weight's leading layer dims,
# so slicing a stacked layer slices the bundle too. The multi-adapter
# trainer's bundles carry trainable values and the gradient's layout
# (``trainable_sidedelta_weight``).

SIDEDELTA_KEY = "sd.base"


def sidedelta_weight(base: torch.Tensor, rows: torch.Tensor,
                     vals: torch.Tensor, colptr: torch.Tensor,
                     ids: torch.Tensor,
                     scale: Optional[torch.Tensor] = None) -> dict:
    """base: (n, m); rows/vals: (A, K) column-sorted per-adapter entries
    (vals f32, or int8 with per-adapter ``scale`` (A,) f32); colptr:
    (A, m + 1) int32 column offsets; ids: (B,) int32 per-request adapter
    slot (-1 = base only)."""
    w = {SIDEDELTA_KEY: base, "sd.rows": rows, "sd.vals": vals,
         "sd.colptr": colptr, "sd.ids": ids}
    if scale is not None:
        w["sd.scale"] = scale
    return w


def trainable_sidedelta_weight(base: torch.Tensor, vals: torch.Tensor,
                               table: dict, ids: torch.Tensor) -> dict:
    """The multi-adapter trainer's bundle: ``vals`` (A, K) are trainable
    f32 values in the packs' own order, ``table`` the layout of
    ``ops.sidedelta_table(..., trainable=True)``; the delta is then
    differentiable in x and vals (``kernels.sidedelta.sidedelta_train``)."""
    w = {SIDEDELTA_KEY: base, "sd.vals": vals, "sd.ids": ids}
    w.update({f"sd.{k}": v for k, v in table.items()})
    return w


def is_sidedelta(w) -> bool:
    return isinstance(w, dict) and SIDEDELTA_KEY in w


def pdot(x: torch.Tensor, w) -> torch.Tensor:
    """Matmul in the compute dtype, output in the compute dtype.

    ``w`` may also be a side-delta bundle: then the result is x @ base plus
    the per-request sparse deltas routed by the bundled ids. A packed-SHiRA
    or LoRA/DoRA/SHiRA-DoRA bundle (``core.adapters.materialize``) is
    materialized here, one matrix at a time."""
    if is_sidedelta(w):
        return _pdot_sidedelta(x, w)
    if is_bundle(w):
        w = materialize_leaf(w)
    cd = compute_dtype()
    return torch.matmul(x.to(cd), w.to(cd))


def _pdot_sidedelta(x: torch.Tensor, w: dict) -> torch.Tensor:
    if x.ndim == 2:
        # Flattened-token call sites (MoE shared experts): the model only
        # flattens row-major from (B, S, d), so the request axis comes
        # back from the bundled per-request ids.
        B, T = w["sd.ids"].shape[-1], x.shape[0]
        if T % B:
            raise ValueError(f"flattened tokens {T} not divisible by batch "
                             f"{B} at a side-delta weight")
        y = _pdot_sidedelta(x.reshape(B, T // B, x.shape[-1]), w)
        return y.reshape(T, y.shape[-1])
    if x.ndim != 3:
        raise ValueError("side-delta weights serve batched (B, S, d) "
                         f"activations, got {tuple(x.shape)}")
    y = pdot(x, w[SIDEDELTA_KEY])
    if "sd.perm" in w:
        delta = sidedelta_train(x, w["sd.vals"], w["sd.rows"],
                                w["sd.colptr"], w["sd.perm"], w["sd.t_rows"],
                                w["sd.t_ptr"], w["sd.t_perm"], w["sd.ids"])
    else:
        delta = sidedelta(x, w["sd.rows"], w["sd.vals"], w["sd.colptr"],
                          w["sd.ids"], scale=w.get("sd.scale"))
    return delta.add_(y).to(y.dtype)


def dense(x: torch.Tensor, w, b: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    y = pdot(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token negative log-likelihood: logits f32 (..., V), labels int
    (...)."""
    logz = torch.logsumexp(logits, dim=-1)
    return logz - torch.gather(logits, -1, labels[..., None].long())[..., 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token CE. logits f32 (..., V), labels int (...)."""
    nll = token_nll(logits, labels)
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(compute_dtype())


def init_rms_norm(d: int, *, lead=(), device="cuda") -> dict:
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=torch.float32,
                                device=device)}


def glorot(gen: torch.Generator, shape, device="cuda") -> torch.Tensor:
    """Normal with std sqrt(2 / (fan_in + fan_out)) over the trailing
    (fan_in, fan_out) dims; leading dims are stacked layers."""
    std = math.sqrt(2.0 / (shape[-2] + shape[-1]))
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).mul_(std)


def normal_init(gen: torch.Generator, shape, std: float = 0.02,
                device="cuda") -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).mul_(std)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, D); positions: (S,) or (..., S). Split-half
    convention."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                  # (d/2,)
    angles = positions[..., :, None].float() * inv        # (..., S, d/2)
    cos = torch.cos(angles)[..., :, None, :]              # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, act: str = "silu",
             *, lead=(), device="cuda") -> dict:
    lead = tuple(lead)
    p = {
        "w_up": glorot(gen, lead + (d_model, d_ff), device),
        "w_down": glorot(gen, lead + (d_ff, d_model), device),
    }
    if act == "silu":  # SwiGLU
        p["w_gate"] = glorot(gen, lead + (d_model, d_ff), device)
    return p


def mlp(params: dict, x: torch.Tensor, act: str = "silu",
        d_ff: Optional[int] = None) -> torch.Tensor:
    """The MLP; under the "tp" hint its TP form, which needs the global
    hidden width ``d_ff``."""
    tp = tp_layout()
    if tp is not None:
        return _mlp_tp(params, x, act, tp, d_ff)
    up = dense(x, params["w_up"])
    if act == "silu":
        gate = dense(x, params["w_gate"])
        h = F.silu(gate.float()).to(compute_dtype()) * up
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(up.float(), approximate="tanh").to(compute_dtype())
    return dense(h, params["w_down"])


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   device="cuda") -> dict:
    return {"emb": normal_init(gen, (vocab, d_model), 0.02, device)}


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["emb"][tokens].to(compute_dtype())


def unembed(params: Optional[dict], h: torch.Tensor,
            tie_to: Optional[torch.Tensor] = None, softcap: float = 0.0,
            logical_vocab: int = 0) -> torch.Tensor:
    """Logits in f32: compute-dtype operands, f32 accumulation and output
    (the reference's ``preferred_element_type=f32``)."""
    w = tie_to.T if tie_to is not None else params["lm_head"]
    cd = compute_dtype()
    logits = torch.matmul(h.to(cd).float(), w.to(cd).float())
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    if logical_vocab and logical_vocab < w.shape[-1]:
        pad = torch.arange(w.shape[-1], device=logits.device) >= logical_vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


# ---------------------------------------------------------------------------
# Tensor parallelism (the launch layer's "tp" hint)
# ---------------------------------------------------------------------------

def tp_layout():
    """The installed ``launch.sharding.TPLayout``, or None."""
    return hint("tp")


def tp_column(x: torch.Tensor, w, name: str, shape, tp, b=None,
              copied: bool = False):
    """x @ w (+ b) for a column-parallel leaf of global ``shape``: with its
    output dim split over ``model`` the result is this rank's columns and
    ``x`` goes through ``copy_to`` first (unless the caller ``copied``
    it); a replicated leaf gives the whole product. Returns (y, whether
    the output is split)."""
    w, spec = tp.weight(w, name, shape)
    col = tp.sharded(spec, -1)
    if col and not copied:
        x = MESH.copy_to(tp.mesh, x, "model")
    y = pdot(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y, col


def tp_row(x: torch.Tensor, w, name: str, shape, tp) -> torch.Tensor:
    """x @ w for a row-parallel leaf: with its input dim split over
    ``model`` each rank's product is a partial sum, all-reduced."""
    w, spec = tp.weight(w, name, shape)
    y = pdot(x, w)
    if tp.sharded(spec, -2):
        y = MESH.reduce_from(tp.mesh, y, "model")
    return y


def _mlp_tp(params: dict, x: torch.Tensor, act: str, tp,
            d_ff: Optional[int]) -> torch.Tensor:
    if d_ff is None:
        raise ValueError("the TP mlp needs its global d_ff")
    d = x.shape[-1]
    w, spec = tp.weight(params["w_up"], "w_up", (d, d_ff))
    col = tp.sharded(spec, -1)
    xc = MESH.copy_to(tp.mesh, x, "model") if col else x
    up = pdot(xc, w)
    if act == "silu":
        gate, _ = tp_column(xc, params["w_gate"], "w_gate", (d, d_ff), tp,
                            copied=True)
        h = F.silu(gate.float()).to(compute_dtype()) * up
    else:
        h = F.gelu(up.float(), approximate="tanh").to(compute_dtype())
    return tp_row(h, params["w_down"], "w_down", (d_ff, d), tp)


def embed_tp(params: dict, tokens: torch.Tensor, vocab: int, d: int, tp
             ) -> torch.Tensor:
    """The TP embedding lookup of a (vocab, d) table: vocab-parallel (a
    masked lookup of this rank's rows, then an all-reduce over ``model``),
    or d-sharded (the reference's fallback ``P(None, "model")``: this
    rank's columns, all-gathered), or replicated."""
    w, spec = tp.weight(params["emb"], "emb", (vocab, d))
    cd = compute_dtype()
    if tp.sharded(spec, 0):
        vl = w.shape[0]
        loc = tokens.long() - tp.rank * vl
        mine = (loc >= 0) & (loc < vl)
        h = w[loc.clamp(0, vl - 1)] * mine[..., None].to(w.dtype)
        return MESH.reduce_from(tp.mesh, h.to(cd), "model")
    h = w[tokens].to(cd)
    if tp.sharded(spec, 1):
        h = MESH.gather_from(tp.mesh, h, "model", -1)
    return h


def tp_unembed_weight(params: dict, tie_to_params: Optional[dict],
                      vocab: int, d: int, tp):
    """(w (d, V_local), first vocab row of this rank, vocab-parallel?):
    the unembedding as the loss and the serving logits use it. Tied, the
    embedding table transposed; a vocab-parallel leaf keeps its columns;
    the d-sharded fallback (``lm_head`` ``P("model", None)``, or a tied
    ``emb`` ``P(None, "model")``) is all-gathered over ``model``."""
    if tie_to_params is not None:
        w, spec = tp.weight(tie_to_params["emb"], "emb", (vocab, d))
        if tp.sharded(spec, 0):
            return w.T, tp.rank * w.shape[0], True
        if tp.sharded(spec, 1):
            w = MESH.gather_from(tp.mesh, w, "model", 1)
        return w.T, 0, False
    w, spec = tp.weight(params["lm_head"], "lm_head", (d, vocab))
    if tp.sharded(spec, 1):
        return w, tp.rank * w.shape[1], True
    if tp.sharded(spec, 0):
        w = MESH.gather_from(tp.mesh, w, "model", 0)
    return w, 0, False


def tp_logits(h: torch.Tensor, w: torch.Tensor, v0: int,
              softcap: float = 0.0, logical_vocab: int = 0
              ) -> torch.Tensor:
    """``unembed`` over the columns [v0, v0 + w.shape[1]) of the padded
    vocabulary: f32 logits, pad columns masked to -1e30."""
    cd = compute_dtype()
    logits = torch.matmul(h.to(cd).float(), w.to(cd).float())
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    if logical_vocab:
        col = v0 + torch.arange(w.shape[-1], device=logits.device)
        logits = logits.masked_fill(col >= logical_vocab, -1e30)
    return logits


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, v0: int,
                       mesh) -> torch.Tensor:
    """Per-token NLL from this rank's vocabulary columns (logits (T,
    V_local) f32, columns from v0): the max, the sum of exponentials and
    the target logit each all-reduced over ``model``; the f32 logits are
    never gathered."""
    m = MESH.all_reduce(mesh, logits.detach().amax(-1), "model", "max")
    s = MESH.reduce_from(mesh, torch.exp(logits - m[:, None]).sum(-1),
                         "model")
    vl = logits.shape[-1]
    loc = labels.long() - v0
    mine = (loc >= 0) & (loc < vl)
    t = torch.gather(logits, -1, loc.clamp(0, vl - 1)[:, None])[:, 0]
    t = MESH.reduce_from(mesh, torch.where(mine, t, torch.zeros_like(t)),
                         "model")
    return torch.log(s) + m - t
