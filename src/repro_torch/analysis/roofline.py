"""Three-term roofline of one program on an NVIDIA H100 SXM.

  compute    = FLOPs_per_device / peak_FLOPs
  memory     = bytes_per_device / HBM_bw
  collective = collective_bytes_per_device / link_bw

The port's copy of ``repro/analysis/roofline.py``: the same arithmetic and
output keys, with the card's published dense peaks in ``HW``. The cost
record's ``flops`` and ``bytes_accessed`` come from
``analysis.profile.program_cost`` (the ops the port dispatches, each
ported kernel at its ``cost()``); a one-card record has mesh ``(1,)`` and
``collectives.total_bytes`` 0 (the port has no collective yet).
MODEL_FLOPS uses the 6·N·D (train) / 2·N·D (inference) convention with
N_active for MoE.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Union

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec


@dataclass(frozen=True)
class HW:
    """NVIDIA H100 SXM at its 700 W limit (dense, no sparsity)."""
    peak_flops: float = 989e12     # bf16 FLOP/s on the tensor cores
    f32_flops: float = 67e12       # f32 FLOP/s outside the tensor cores
    hbm_bw: float = 3.35e12        # B/s of device memory
    link_bw: float = 450e9         # B/s of NVLink, each way


def count_params(cfg: ModelConfig) -> Dict[str, float]:
    """Analytic parameter counts (total and active-per-token)."""
    d, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    hd = cfg.resolved_head_dim
    emb = V * d * (1 if cfg.tie_embeddings else 2)

    def attn_params():
        if cfg.attn_type == "mla":
            m = cfg.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            p = d * cfg.num_heads * qk                      # wq
            p += d * (m.kv_lora_rank + m.qk_rope_head_dim)  # w_dkv
            p += m.kv_lora_rank * cfg.num_heads * (
                m.qk_nope_head_dim + m.v_head_dim)          # w_uk + w_uv
            p += cfg.num_heads * m.v_head_dim * d           # wo
            return p
        if cfg.attn_type == "none":
            return 0
        return d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)

    def mlp_params(ff):
        mult = 3 if cfg.act == "silu" else 2
        return mult * d * ff

    def mamba_params():
        s = cfg.ssm
        d_in = s.expand * d
        nh = d_in // s.head_dim
        conv_dim = d_in + 2 * s.n_groups * s.d_state
        return (d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)
                + conv_dim * (s.d_conv + 1) + 3 * nh + d_in + d_in * d)

    total = emb
    active = emb
    if cfg.family in ("dense", "vlm", "audio"):
        per = attn_params() + mlp_params(cfg.d_ff)
        total += L * per
        active += L * per
    elif cfg.family == "moe":
        m = cfg.moe
        fd = m.first_dense_layers
        dense_l = attn_params() + mlp_params(m.first_dense_d_ff or cfg.d_ff)
        moe_total = attn_params() + m.num_experts * mlp_params(m.d_ff) \
            + m.num_shared * mlp_params(m.d_ff) + d * m.num_experts
        moe_active = attn_params() + m.top_k * mlp_params(m.d_ff) \
            + m.num_shared * mlp_params(m.d_ff) + d * m.num_experts
        total += fd * dense_l + (L - fd) * moe_total
        active += fd * dense_l + (L - fd) * moe_active
    elif cfg.family == "ssm":
        total += L * mamba_params()
        active += L * mamba_params()
    elif cfg.family == "hybrid":
        shared = attn_params() + mlp_params(cfg.d_ff) + 2 * d * d
        total += L * mamba_params() + shared
        active += L * mamba_params() \
            + (L // max(cfg.hybrid_attn_every, 1)) * shared
    return {"total": float(total), "active": float(active)}


def model_flops(cfg: ModelConfig, shape: Union[str, ShapeSpec]) -> float:
    """6·N_active·D for train, 2·N_active·D for inference steps (global).
    ``shape`` is a name in ``SHAPES`` or a ``ShapeSpec`` of the step's own
    (the card's steps are not the pod's shapes)."""
    if isinstance(shape, str):
        shape = SHAPES[shape]
    n = count_params(cfg)["active"]
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def roofline_terms(record: Dict[str, Any], cfg: ModelConfig,
                   hw: HW = HW()) -> Dict[str, Any]:
    """record: ``{"mesh", "shape", "cost", "collectives"}`` of one program
    (per-device cost numbers); ``shape`` a name or a ``ShapeSpec``."""
    chips = 1
    for s in record["mesh"]:
        chips *= s
    flops_dev = record["cost"].get("flops", 0.0)
    bytes_dev = record["cost"].get("bytes_accessed", 0.0)
    coll_dev = record["collectives"].get("total_bytes", 0)

    t_compute = flops_dev / hw.peak_flops
    t_memory = bytes_dev / hw.hbm_bw
    t_coll = coll_dev / hw.link_bw
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(t_compute, t_memory, t_coll)

    mf_global = model_flops(cfg, record["shape"])
    mf_dev = mf_global / chips
    useful_ratio = mf_dev / flops_dev if flops_dev else 0.0
    # roofline fraction: useful model FLOPs per device / (peak * bound time)
    frac = (mf_dev / hw.peak_flops) / bound if bound > 0 else 0.0
    return {
        **terms,
        "dominant": dominant,
        "bound_s": bound,
        "model_flops_global": mf_global,
        "model_flops_per_dev": mf_dev,
        "hlo_flops_per_dev": flops_dev,
        "useful_flops_ratio": useful_ratio,
        "roofline_fraction": frac,
        "chips": chips,
    }
