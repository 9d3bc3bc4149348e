"""The Mamba2 mixer through SSD (state-space duality).

Port of ``repro/models/mamba2.py``. Training and prefill run the chunked
SSD algorithm: an attention-like product inside chunks of ``chunk``
positions and a recurrence over the chunks' states, so no S x S object
is built. Decode is the O(1) recurrent update of a (B, H, P, N) f32 state
and of a rolling depthwise-conv window. No TPU kernel computes any of it:
the reference's is plain jnp, and this is plain torch, f32 inside the
scan as ``ssd_chunked`` is.

The projections are the reference's separate leaves (``in_z``, ``in_x``,
``in_bc``, ``in_dt``, ``out_proj``), each through ``layers.dense``, so a
SHiRA side delta or bundle on ``out_proj`` (the one default target among
them) works as it does on ``wo``.

Where the port differs from the reference:
  - the associative scan over chunk states is a sequential recurrence
    over the chunks (the same sums, in another order);
  - a prompt shorter than ``d_conv - 1`` tokens gets conv windows padded
    in front with zeros, the window ``_causal_conv``'s own padding
    implies; the reference's slice returns fewer rows there, and its
    first decode step raises;
  - ``mamba_decode`` writes the new state and windows into the cache in
    place (the reference returns new arrays).
Under the launch layer's "tp" hint (``launch.sharding.TPLayout``) the
mixer runs on the rank's heads: ``in_z``, ``in_x`` and ``in_dt``
column-parallel (u through ``copy_to``), ``conv_x`` its channels,
``in_bc`` and ``conv_bc`` replicated (B and C through ``copy_to`` after
the conv, before the rank's heads use them), the per-head ``A_log``,
``D`` and ``dt_bias`` and the norm's scale replicated and sliced to the
rank's range after ``copy_to``, each head's B/C group its global one
(``_local_groups``), the gated RMSNorm's sum of squares all-reduced over
``model`` and ``out_proj`` row-parallel; the cache holds the rank's
heads' state and channels' windows.
The profile ranges of chip_smoke.py wrap the helpers by name
(``_project``, ``_causal_conv``, ``_ssd_intra``, ``_ssd_states``,
``_ssd_inter``, ``_gated_out``, ``_conv_step``, ``_ssm_step``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as MESH
from repro_torch.models.layers import (compute_dtype, dense, glorot,
                                       init_rms_norm, tp_column, tp_layout,
                                       tp_row)


class MambaCache(NamedTuple):
    ssm: torch.Tensor      # (B, H, P, N) f32       [stacked: (L, B, ...)]
    conv_x: torch.Tensor   # (B, d_conv - 1, d_inner)     compute dtype
    conv_bc: torch.Tensor  # (B, d_conv - 1, 2 * g * n)   compute dtype


def dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    bc_dim = 2 * s.n_groups * s.d_state
    return d_inner, n_heads, bc_dim


def init_mamba(gen: torch.Generator, cfg: ModelConfig, *, lead=(),
               device="cuda") -> dict:
    """Parameters of ``lead`` stacked mixers: the reference's tree and
    initial distributions (dt_bias the inverse softplus of a log-uniform
    dt in [dt_min, dt_max], A_log = log(1..H), D = 1)."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner, n_heads, bc_dim = dims(cfg)
    lead = tuple(lead)
    f32 = dict(dtype=torch.float32, device=device)
    u = torch.rand(lead + (n_heads,), generator=gen, **f32)
    dt = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                   + math.log(s.dt_min))
    dt_bias = dt + torch.log(-torch.expm1(-dt))  # inverse softplus
    conv_scale = 1.0 / math.sqrt(s.d_conv)
    conv = lambda c: torch.randn(lead + (s.d_conv, c), generator=gen,
                                 **f32).mul_(conv_scale)
    a_log = torch.log(torch.arange(1, n_heads + 1, **f32))
    return {
        "in_z": glorot(gen, lead + (d, d_inner), device),
        "in_x": glorot(gen, lead + (d, d_inner), device),
        "in_bc": glorot(gen, lead + (d, bc_dim), device),
        "in_dt": glorot(gen, lead + (d, n_heads), device),
        "conv_x_w": conv(d_inner),
        "conv_x_b": torch.zeros(lead + (d_inner,), **f32),
        "conv_bc_w": conv(bc_dim),
        "conv_bc_b": torch.zeros(lead + (bc_dim,), **f32),
        "A_log": a_log.expand(lead + (n_heads,)).clone(),
        "D": torch.ones(lead + (n_heads,), **f32),
        "dt_bias": dt_bias,
        "norm": init_rms_norm(d_inner, lead=lead, device=device),
        "out_proj": glorot(gen, lead + (d_inner, d), device),
    }


def _causal_conv(x, w, b):
    """x: (B, S, C); w: (K, C) depthwise. Unrolled over the tiny K, in
    x's dtype, as the reference sums it."""
    K = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = sum(xp[:, i:i + S, :] * w[i].to(x.dtype) for i in range(K))
    return F.silu((y + b.to(x.dtype)).float()).to(compute_dtype())


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0), with no threshold (torch's
    softplus returns x above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


class _Local(NamedTuple):
    """The rank's share of a mixer under the "tp" hint: its first head
    and head count, whether the heads are split over ``model``."""
    tp: object
    h0: int
    hl: int
    split: bool


def _local(cfg) -> Optional[_Local]:
    """Under the "tp" hint, the rank's share (``_Local``); else None."""
    tp = tp_layout()
    if tp is None:
        return None
    d_inner, n_heads, _ = dims(cfg)
    d = cfg.d_model
    split = [tp.sharded(tp.spec(name, shape), -1) for name, shape in (
        ("in_x", (d, d_inner)), ("in_z", (d, d_inner)),
        ("in_dt", (d, n_heads)))]
    if any(split) and not (all(split) and n_heads % tp.tp == 0):
        raise ValueError(f"{cfg.name}: {n_heads} SSD heads and {d_inner} "
                         f"channels do not split alike over a model axis "
                         f"of {tp.tp}")
    if not split[0]:
        return _Local(tp, 0, n_heads, False)
    hl = n_heads // tp.tp
    return _Local(tp, tp.rank * hl, hl, True)


def _head_leaf(leaf, loc: Optional[_Local], width: int = 1):
    """A replicated per-head (H,) leaf, or per-channel (H * width,), as the
    rank uses it: its slice of the heads, after ``copy_to`` (each rank's
    gradient reaches only its own slice)."""
    if loc is None or not loc.split:
        return leaf
    leaf = MESH.copy_to(loc.tp.mesh, leaf, "model")
    return leaf[loc.h0 * width:(loc.h0 + loc.hl) * width]


def _local_groups(n_groups: int, n_heads: int, loc: Optional[_Local]):
    """The B/C groups (global indices) the rank's heads read, such that
    local head j reads entry j // (hl / len): the group of global head h is
    h // (n_heads / n_groups). None where that is every group as it is."""
    if loc is None or not loc.split:
        return None
    hg = n_heads // n_groups
    ids = [(loc.h0 + j) // hg for j in range(loc.hl)]
    if loc.hl % hg == 0 and loc.h0 % hg == 0:
        sel = ids[::hg]
    elif min(ids) == max(ids):
        sel = ids[:1]
    else:
        sel = ids
    return None if sel == list(range(n_groups)) else sel


def _project(params, cfg, u):
    """u: (B, S, d) -> z, x_raw, bc_raw, dt (pre-conv; dt after softplus,
    f32); under the "tp" hint z, x_raw and dt of the rank's heads."""
    loc = _local(cfg)
    if loc is not None:
        return _project_tp(params, cfg, u, loc)
    z = dense(u, params["in_z"])
    x_raw = dense(u, params["in_x"])
    bc_raw = dense(u, params["in_bc"])
    dt_raw = dense(u, params["in_dt"])
    dt = _softplus(dt_raw.float() + params["dt_bias"].float())
    return z, x_raw, bc_raw, dt


def _project_tp(params, cfg, u, loc: _Local):
    d = cfg.d_model
    d_inner, n_heads, bc_dim = dims(cfg)
    tp = loc.tp
    uc = MESH.copy_to(tp.mesh, u, "model") if loc.split else u
    col = lambda name, width: tp_column(uc, params[name], name, (d, width),
                                        tp, copied=True)[0]
    z, x_raw, dt_raw = col("in_z", d_inner), col("in_x", d_inner), col(
        "in_dt", n_heads)
    bc_raw = dense(u, tp.weight(params["in_bc"], "in_bc", (d, bc_dim))[0])
    dt = _softplus(dt_raw.float()
                   + _head_leaf(params["dt_bias"], loc).float())
    return z, x_raw, bc_raw, dt


def _gated_out(params, cfg, y, z):
    """RMSNorm(y * silu(z)) in f32, cast, then ``out_proj``. Under the
    "tp" hint y and z are the rank's channels: the sum of squares is
    all-reduced over ``model`` (forward and backward: every rank's outputs
    read it) before the mean, the norm's scale sliced to the channels, and
    ``out_proj`` row-parallel."""
    g = y.float() * F.silu(z.float())
    loc = _local(cfg)
    if loc is None:
        var = torch.mean(g * g, dim=-1, keepdim=True)
        g = g * torch.rsqrt(var + cfg.norm_eps) * \
            params["norm"]["scale"].float()
        return dense(g.to(compute_dtype()), params["out_proj"])
    d_inner = dims(cfg)[0]
    ss = torch.sum(g * g, dim=-1, keepdim=True)
    if loc.split:
        mesh = loc.tp.mesh
        ss = MESH.copy_to(mesh, MESH.reduce_from(mesh, ss, "model"), "model")
    scale = _head_leaf(params["norm"]["scale"], loc, cfg.ssm.head_dim)
    g = g * torch.rsqrt(ss / d_inner + cfg.norm_eps) * scale.float()
    return tp_row(g.to(compute_dtype()), params["out_proj"], "out_proj",
                  (d_inner, cfg.d_model), loc.tp)


# ---------------------------------------------------------------------------
# Chunked SSD
# ---------------------------------------------------------------------------

def _segsum(x):
    """x: (..., L) log-decays -> (..., L, L) lower-triangular cumulative
    sums, -inf above the diagonal (masked before any exp, so backward
    never meets inf * 0)."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    upper = torch.ones((L, L), dtype=torch.bool, device=x.device).triu(1)
    return seg.masked_fill(upper, float("-inf"))


def _ssd_intra(xc, dAc, Bc, Cc):
    """The diagonal blocks: each chunk's outputs from its own inputs.
    xc: (b, nc, l, g, hg, p) = x * dt; dAc: (b, nc, l, h); Bc, Cc: (b, nc,
    l, g, n). Returns (b, nc, l, g, hg, p)."""
    b, nc, l, g, hg, _ = xc.shape
    Ldec = torch.exp(_segsum(dAc.movedim(3, 2)))          # (b,nc,h,l,l)
    Ldec = Ldec.movedim(2, 4)                             # (b,nc,l,l,h)
    CB = torch.einsum("bclgn,bcsgn->bclsg", Cc, Bc)       # (b,nc,l,l,g)
    att = CB.reshape(b, nc, l, l, g, 1) * Ldec.reshape(b, nc, l, l, g, hg)
    return torch.einsum("bclsgh,bcsghp->bclghp", att, xc)


def _ssd_states(xc, dA_cs, Bc, initial_state):
    """Each chunk's end state from its own inputs, then the recurrence
    over chunks (the reference's associative scan, in sequence). Returns
    (the state entering each chunk (b, nc, h, p, n), the final state (b,
    h, p, n))."""
    b, nc, l, g, hg, p = xc.shape
    n = Bc.shape[-1]
    h = g * hg
    dte = torch.exp(dA_cs[:, :, -1:, :] - dA_cs).reshape(b, nc, l, g, hg)
    states = torch.einsum("bclgn,bclghp->bcghpn", Bc,
                          dte[..., None] * xc).reshape(b, nc, h, p, n)
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])           # (b,nc,h)
    run = (torch.zeros((b, h, p, n), dtype=torch.float32, device=xc.device)
           if initial_state is None else initial_state.float())
    prev = []
    for c in range(nc):
        prev.append(run)
        run = states[:, c] + chunk_decay[:, c, :, None, None] * run
    return torch.stack(prev, dim=1), run


def _ssd_inter(Cc, dA_cs, prev):
    """The off-diagonal blocks: each position's output from the state
    entering its chunk, decayed to the position. Returns (b, nc, l, g,
    hg, p)."""
    b, nc, l, g, n = Cc.shape
    h, p = prev.shape[2], prev.shape[3]
    hg = h // g
    out_decay = torch.exp(dA_cs).reshape(b, nc, l, g, hg)
    prevg = prev.reshape(b, nc, g, hg, p, n)
    return (torch.einsum("bclgn,bcghpn->bclghp", Cc, prevg)
            * out_decay[..., None])


def ssd_chunked(x, dt, A, B, C, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan. x: (b, s, h, p); dt: (b, s, h); A: (h,); B, C: (b, s, g,
    n). Returns (y (b, s, h, p) in the compute dtype, final_state (b, h,
    p, n) f32). Everything f32 inside."""
    b, s_orig, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    # Pad to a chunk multiple: dt = 0 at pad positions => decay 1, no state
    # update, so the scan is unchanged (pad outputs are sliced off).
    pad = (-s_orig) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    s = s_orig + pad
    nc = s // chunk
    xf = x.float() * dt[..., None]                        # X * dt
    dA = dt * A[None, None, :]                            # (b,s,h) log decays
    xc = xf.reshape(b, nc, chunk, g, hg, p)
    dAc = dA.reshape(b, nc, chunk, h)
    Bc = B.float().reshape(b, nc, chunk, g, n)
    Cc = C.float().reshape(b, nc, chunk, g, n)
    dA_cs = torch.cumsum(dAc, dim=2)                      # (b,nc,l,h)
    y_diag = _ssd_intra(xc, dAc, Bc, Cc)
    prev, final_state = _ssd_states(xc, dA_cs, Bc, initial_state)
    y_off = _ssd_inter(Cc, dA_cs, prev)
    y = (y_diag + y_off).reshape(b, s, h, p)[:, :s_orig]
    return y.to(compute_dtype()), final_state


# ---------------------------------------------------------------------------
# Module entry points
# ---------------------------------------------------------------------------

def _bc_groups(cfg, bc, lead, loc: Optional[_Local]):
    """(B, C) of the conv'd bc (..., 2 g n) as (*lead, groups, n): the
    groups the rank's heads read (``_local_groups``); under the "tp" hint
    with the heads split, bc goes through ``copy_to`` first (every rank
    computes it whole, each rank's heads use it)."""
    s = cfg.ssm
    _, n_heads, _ = dims(cfg)
    if loc is not None and loc.split:
        bc = MESH.copy_to(loc.tp.mesh, bc, "model")
    gn = s.n_groups * s.d_state
    Bm = bc[..., :gn].reshape(tuple(lead) + (s.n_groups, s.d_state))
    Cm = bc[..., gn:].reshape(tuple(lead) + (s.n_groups, s.d_state))
    sel = _local_groups(s.n_groups, n_heads, loc)
    if sel is not None:
        idx = torch.tensor(sel, device=bc.device)
        Bm, Cm = Bm.index_select(-2, idx), Cm.index_select(-2, idx)
    return Bm, Cm


def _ssd_from_parts(params, cfg, xBC_x, xBC_bc, dt, B_, S_):
    s = cfg.ssm
    loc = _local(cfg)
    x = xBC_x.reshape(B_, S_, -1, s.head_dim)
    Bm, Cm = _bc_groups(cfg, xBC_bc, (B_, S_), loc)
    A = -torch.exp(_head_leaf(params["A_log"], loc).float())
    y, final_state = ssd_chunked(x, dt, A, Bm, Cm, s.chunk)
    y = y + (_head_leaf(params["D"], loc).float()[None, None, :, None]
             * x.float()).to(compute_dtype())
    return y, final_state


def mamba_train(params, cfg: ModelConfig, u):
    B_, S_, _ = u.shape
    z, x_raw, bc_raw, dt = _project(params, cfg, u)
    xx = _causal_conv(x_raw, params["conv_x_w"], params["conv_x_b"])
    bc = _causal_conv(bc_raw, params["conv_bc_w"], params["conv_bc_b"])
    y, _ = _ssd_from_parts(params, cfg, xx, bc, dt, B_, S_)
    return _gated_out(params, cfg, y.reshape(B_, S_, -1), z)


def _window(raw, k1: int):
    """The conv window a prefill leaves: the last ``k1`` pre-conv rows of
    raw (B, S, C), in the compute dtype; a prompt shorter than ``k1`` gets
    zero rows in front, the rows ``_causal_conv`` pads with."""
    S = raw.shape[1]
    if S < k1:
        raw = F.pad(raw, (0, 0, k1 - S, 0))
    return raw[:, raw.shape[1] - k1:].to(compute_dtype())


def mamba_prefill(params, cfg: ModelConfig, u
                  ) -> Tuple[torch.Tensor, MambaCache]:
    s = cfg.ssm
    B_, S_, _ = u.shape
    z, x_raw, bc_raw, dt = _project(params, cfg, u)
    conv_x_state = _window(x_raw, s.d_conv - 1)
    conv_bc_state = _window(bc_raw, s.d_conv - 1)
    xx = _causal_conv(x_raw, params["conv_x_w"], params["conv_x_b"])
    bc = _causal_conv(bc_raw, params["conv_bc_w"], params["conv_bc_b"])
    y, final_state = _ssd_from_parts(params, cfg, xx, bc, dt, B_, S_)
    out = _gated_out(params, cfg, y.reshape(B_, S_, -1), z)
    return out, MambaCache(ssm=final_state, conv_x=conv_x_state,
                           conv_bc=conv_bc_state)


def _conv_step(window, new, w, b):
    """window: (B, K-1, C); new: (B, 1, C) -> (out (B, C), the next window
    (B, K-1, C), a new tensor)."""
    win = torch.cat([window, new.to(window.dtype)], dim=1)
    out = torch.sum(win.float() * w.float()[None], dim=1) + b.float()
    return F.silu(out).to(compute_dtype()), win[:, 1:]


def _ssm_step(ssm, x, dt1, A, Bm, Cm):
    """One recurrent step, the state updated in place. ssm: (B, H, P, N)
    f32; x: (B, H, P); dt1: (B, H) f32; Bm, Cm: (B, g, N). Returns y (B,
    H, P) f32 (before the skip)."""
    hg = ssm.shape[1] // Bm.shape[1]
    dA = torch.exp(dt1 * A[None])                         # (B,H)
    Bh = torch.repeat_interleave(Bm, hg, dim=1).float()   # (B,H,N)
    Ch = torch.repeat_interleave(Cm, hg, dim=1).float()
    xdt = x.float() * dt1[..., None]                      # (B,H,P)
    ssm.mul_(dA[..., None, None]).add_(xdt[..., :, None] * Bh[:, :, None, :])
    return torch.einsum("bhpn,bhn->bhp", ssm, Ch)


def mamba_decode(params, cfg: ModelConfig, u, cache: MambaCache, pos
                 ) -> Tuple[torch.Tensor, MambaCache]:
    """u: (B, 1, d). The cache's state and windows are written in place;
    ``pos`` is unused (the state is O(1) a request)."""
    del pos
    s = cfg.ssm
    loc = _local(cfg)
    B_ = u.shape[0]
    z, x_raw, bc_raw, dt = _project(params, cfg, u)       # (B,1,.)
    xx, new_conv_x = _conv_step(cache.conv_x, x_raw, params["conv_x_w"],
                                params["conv_x_b"])
    bc, new_conv_bc = _conv_step(cache.conv_bc, bc_raw, params["conv_bc_w"],
                                 params["conv_bc_b"])
    cache.conv_x.copy_(new_conv_x)
    cache.conv_bc.copy_(new_conv_bc)
    x = xx.reshape(B_, -1, s.head_dim)
    Bm, Cm = _bc_groups(cfg, bc, (B_,), loc)
    A = -torch.exp(_head_leaf(params["A_log"], loc).float())
    y = _ssm_step(cache.ssm, x, dt[:, 0], A, Bm, Cm)
    y = y + _head_leaf(params["D"], loc).float()[None, :, None] * x.float()
    y = y.reshape(B_, 1, -1).to(compute_dtype())
    return _gated_out(params, cfg, y, z), cache
