"""Adapters: SHiRA (the paper), LoRA, DoRA and SHiRA-masked DoRA. Init,
the packed adapter (``AdapterPack``), the rapid switch that applies one to
a deployed base, ``materialize``, the effective weights of training, and
``pack_from_delta``, the export of hook-mode training.

Port of ``repro/core/adapters.py``, every kind and mask strategy. All
kinds share one contract:

  trainable, aux = init_adapter(gen, base_params, acfg, calib_grads=None)
  params_eff     = materialize(base_params, trainable, aux, acfg, alpha)

``materialize`` is lazy: each target leaf becomes a bundle that
``models.layers.pdot`` turns into one layer's effective matrix where the
layer uses it (``materialize_leaf``), inside the layer's checkpoint.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import AdapterConfig
from repro_torch.core import masks as M
from repro_torch.kernels.ops import scatter_apply

SHIRA_KEY = "shira.base"
FACTOR_KEY = "factor.base"
FACTOR_KINDS = ("lora", "dora", "shira-dora")


def _leaf_generator(gen: torch.Generator, path: str, device
                    ) -> torch.Generator:
    """A generator for one leaf's LoRA draw, seeded from ``gen``'s seed
    and the crc32 of the leaf's path: the same draws in every process
    (the reference folds in Python's ``hash`` of the path, which is
    salted per process)."""
    sub = torch.Generator(device=device)
    sub.manual_seed((gen.initial_seed() * 1_000_003
                     + zlib.crc32(path.encode())) % (2 ** 63))
    return sub


def _lora_init(gen: torch.Generator, w: torch.Tensor, rank: int) -> dict:
    *lead, n, m = w.shape
    a = torch.randn(tuple(lead) + (n, rank), generator=gen,
                    dtype=torch.float32, device=w.device) * (1.0 / math.sqrt(n))
    b = torch.zeros(tuple(lead) + (rank, m), dtype=torch.float32,
                    device=w.device)
    return {"A": a, "B": b}


def _col_norm(w: torch.Tensor) -> torch.Tensor:
    """The column norm of DoRA's magnitude, over axis -2, with 1e-12 inside
    the square root."""
    return torch.sqrt(torch.sum(torch.square(w.float()), dim=-2,
                                keepdim=True) + 1e-12)


def init_adapter(gen: Optional[torch.Generator], params,
                 acfg: AdapterConfig, calib_grads=None):
    """(trainable, aux) of an adapter of ``acfg.kind``:

      none        (None, None)
      shira       zero values (..., K) at every target leaf and {"indices":
                  packed indices}; None elsewhere
      lora, dora  {"A" (..., n, r), "B" (..., r, m)} at every target leaf
                  (A normal over sqrt(n), B zero), DoRA also "m" (..., 1, m),
                  the base's column norm; aux None
      shira-dora  DoRA's factors and SHiRA's {"indices"}

    ``gen`` draws ``rand`` masks and seeds each leaf's A
    (``_leaf_generator``); ``calib_grads`` (a tree aligned with
    ``params``) scores ``grad`` and ``snip`` masks."""
    kind = acfg.kind
    if kind == "none":
        return None, None
    if kind == "shira":
        idx = M.make_packed_indices(params, acfg, gen, calib_grads)
        values = M.map_leaves(
            lambda _, i: torch.zeros(i.shape, dtype=torch.float32,
                                     device=i.device), idx)
        return values, {"indices": idx}
    if kind in FACTOR_KINDS:
        if gen is None:
            raise ValueError(f"kind={kind!r} draws its factors from a "
                             "torch.Generator")

        def per_leaf(path, w):
            t = _lora_init(_leaf_generator(gen, path, w.device), w,
                           acfg.rank)
            if kind != "lora":      # one layer at a time: no stacked square
                *lead, n, m = w.shape
                t["m"] = torch.stack([_col_norm(x) for x in w.reshape(
                    -1, n, m)]).reshape(tuple(lead) + (1, m))
            return t

        trainable = M.map_targets(per_leaf, params, acfg.target_modules)
        aux = None
        if kind == "shira-dora":
            aux = {"indices": M.make_packed_indices(params, acfg, gen,
                                                    calib_grads)}
        return trainable, aux
    raise ValueError(f"unknown adapter kind {kind!r}")


def merge_rows(idx: torch.Tensor, vals: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nl, k) flat indices and f32 values -> (nl, k') merged rows: each
    index once, ascending, the values of a repeated index summed in the
    order they come (a stable sort, so in pack order), rows shorter than
    the longest padded with index 0 and value 0. ``fuse_packs`` merges
    with it, and so does an ``AdapterPack`` whose rows are not merged."""
    nl = idx.shape[0]
    device = idx.device
    idx = idx.long()
    span = int(idx.max()) + 1 if idx.numel() else 1
    layer = torch.arange(nl, device=device)[:, None]
    key_s, order = torch.sort((layer * span + idx).reshape(-1), stable=True)
    v_s = vals.reshape(-1)[order]
    uniq, inv = torch.unique_consecutive(key_s, return_inverse=True)
    acc = torch.zeros(uniq.shape, dtype=torch.float32, device=device)
    acc.index_add_(0, inv, v_s)
    row = uniq // span
    counts = torch.bincount(row, minlength=nl)
    k = int(counts.max()) if counts.numel() else 0
    pos = torch.arange(uniq.numel(), device=device) - (
        torch.cumsum(counts, 0) - counts)[row]
    mi = torch.zeros((nl, k), dtype=torch.int32, device=device)
    mv = torch.zeros((nl, k), dtype=torch.float32, device=device)
    mi[row, pos] = (uniq % span).to(torch.int32)
    mv[row, pos] = acc
    return mi, mv


def merged_form(idx: torch.Tensor, vals: torch.Tensor) -> bool:
    """Whether every (nl, k) row is merged: its indices strictly
    ascending, apart from trailing padding entries (index 0, value 0).
    The form every mask, ``pack_from_delta`` and ``fuse_packs`` emits,
    for which it costs one compare pass; ``scatter_apply``'s kernel
    asserts the same rule entry by entry."""
    if idx.shape[-1] < 2:
        return True
    asc = idx[:, 1:] > idx[:, :-1]
    if bool(asc.all()):
        return True
    # entry j >= 1 is padding, or ascends from an entry that is not
    # padding (entry 0 may be a real entry at index 0 of value 0)
    pad = (idx == 0) & (vals == 0)
    prev_pad = pad[:, :-1].clone()
    prev_pad[:, 0] = False
    return bool((pad[:, 1:] | (asc & ~prev_pad)).all())


def repeats_any(idx: torch.Tensor, vals: torch.Tensor) -> bool:
    """Whether a (nl, k) row names one index twice with nonzero values
    (entries of value 0 change nothing and the kernel skips them). A sort
    of the row's keys: the test for rows that are not in the merged
    form."""
    nl, k = idx.shape
    live = vals.reshape(-1) != 0
    key = (torch.arange(nl, device=idx.device)[:, None] * (int(idx.max()) + 1
           if idx.numel() else 1) + idx.long()).reshape(-1)[live]
    key = torch.sort(key).values
    return bool((key[1:] == key[:-1]).any())


def merge_entries(entries: Dict[str, Tuple[torch.Tensor, torch.Tensor]]):
    """A pack's entries with no index twice in a matrix, and the set of
    paths whose rows are unique but not in the merged form. Leaves in the
    merged form (``merged_form``, one compare pass) come back as the same
    tensors; so do leaves whose rows are unique in another order (the
    reference's rand masks leave them unsorted, and its files keep that
    order), found by a sort, whose paths are returned. Leaves that repeat
    an index are merged by ``merge_rows``: two updates of one weight
    entry in one scatter would race on the card, where the reference adds
    both (ROADMAP C3)."""
    out, unordered = dict(entries), set()
    for path, (i, v) in entries.items():
        lead, k = tuple(i.shape[:-1]), i.shape[-1]
        nl = i.numel() // k if k else 0
        i2, v2 = i.reshape(nl, k), v.reshape(nl, k)
        if merged_form(i2, v2):
            continue
        if not repeats_any(i2, v2):
            unordered.add(path)
            continue
        mi, mv = merge_rows(i2, v2.float())
        out[path] = (mi.reshape(lead + (mi.shape[-1],)),
                     mv.to(v.dtype).reshape(lead + (mi.shape[-1],)))
    return out, unordered


@dataclass
class AdapterPack:
    """Sparse weights + indices, per target path: entries[path] = (flat
    indices (..., K) int32, values (..., K) f32). Loading one overwrites
    only its 1-2% of entries. Each matrix's indices ascend, each once,
    and rows shorter than K are padded with index 0 and value 0: every
    mask of the port, ``pack_from_delta`` and ``fuse_packs`` build them
    so. A pack built from entries that repeat an index (by hand, from a
    file) merges them here, as ``fuse_packs`` merges; leaves whose
    entries are unique but unsorted (the reference's rand masks) are kept
    as they are and their paths noted in ``unordered``, for which
    ``apply_pack`` tells the kernel not to assert the order
    (``merge_entries``). ``map_entries`` carries the set over."""

    name: str
    entries: Dict[str, Tuple[torch.Tensor, torch.Tensor]]
    alpha: float = 1.0

    def __post_init__(self):
        self.entries, self.unordered = merge_entries(self.entries)

    def num_params(self) -> int:
        return int(sum(v.numel() for _, v in self.entries.values()))

    def nbytes(self) -> int:
        return int(sum(i.numel() * i.element_size()
                       + v.numel() * v.element_size()
                       for i, v in self.entries.values()))


def map_entries(pack: AdapterPack, fn=None, name: Optional[str] = None,
                alpha: Optional[float] = None) -> AdapterPack:
    """The pack with ``fn`` applied to each index and value tensor (a copy
    to another device or into pinned memory), renamed or rescaled. The
    entries' form was checked when the pack was built, and ``fn`` keeps
    it, so it is not checked again."""
    fn = fn or (lambda t: t)
    out = AdapterPack.__new__(AdapterPack)
    out.name = pack.name if name is None else name
    out.alpha = pack.alpha if alpha is None else alpha
    out.entries = {p: (fn(i), fn(v)) for p, (i, v) in pack.entries.items()}
    out.unordered = set(pack.unordered)
    return out


def pack_to(pack: AdapterPack, device, non_blocking: bool = False
            ) -> AdapterPack:
    """The pack with its entries on ``device``; the same pack when they
    are there."""
    device = torch.device(device)
    if all(i.device == device and v.device == device
           for i, v in pack.entries.values()):
        return pack
    return map_entries(pack, lambda t: t.to(device,
                                            non_blocking=non_blocking))


def pack_from_shira(name: str, trainable, aux, alpha: float = 1.0
                    ) -> AdapterPack:
    vals = dict(M.iter_leaves(trainable))
    entries = {p: (i, vals[p]) for p, i in M.iter_leaves(aux["indices"])}
    return AdapterPack(name=name, entries=entries, alpha=alpha)


def pack_from_delta(name: str, base, tuned, acfg: AdapterConfig,
                    alpha: float = 1.0) -> AdapterPack:
    """S = W_new - W at its K largest magnitudes per matrix (K = the mask
    budget; paper App. G): the export of hook-mode training, whose weights
    were updated in place. Indices ascend within each matrix; of equal
    magnitudes the lower index is kept, as the reference's ``lax.top_k``
    keeps it. Where fewer than K entries moved, the rest are entries with
    delta 0, whichever the tie rule picks."""
    old = dict(M.iter_leaves(base))
    entries = {}
    for path, w_new in M.iter_leaves(tuned):
        if not M.is_target(path, w_new, acfg.target_modules):
            continue
        *lead, n, m = w_new.shape
        k = M.budget(n, m, acfg.sparsity)
        df = w_new.float().reshape(-1, n * m)
        bf = old[path].float().reshape(-1, n * m)
        idx, val = [], []
        for r in range(df.shape[0]):    # one matrix's delta alive at a time
            d = df[r] - bf[r]
            i = M.topk_indices(d.abs(), k)
            idx.append(i)
            val.append(d[i.long()])
            del d
        entries[path] = (torch.stack(idx).reshape(tuple(lead) + (k,)),
                         torch.stack(val).reshape(tuple(lead) + (k,)))
    return AdapterPack(name=name, entries=entries, alpha=alpha)


def apply_pack(params, pack: AdapterPack, alpha: Optional[float] = None,
               sign: float = 1.0):
    """W += sign * alpha * S at the pack's indices (load / unload).

    Unlike the reference, which returns a new tree, this updates the
    weights IN PLACE through the ``scatter_apply`` kernel (its plain version
    for CPU tensors) and returns the same tree: the full-width base does not
    fit on the card twice. Paths the tree lacks are ignored, as there."""
    a = (pack.alpha if alpha is None else alpha) * sign
    for path, w in M.iter_leaves(params):
        if path in pack.entries:
            idx, vals = pack.entries[path]
            scatter_apply(w, idx, vals.float(), alpha=a,
                          ordered=path not in pack.unordered)
    return params


# ---------------------------------------------------------------------------
# materialize: the effective weights of training, one layer at a time
# ---------------------------------------------------------------------------

class _Materialize(torch.autograd.Function):
    """One matrix: the forward clones w and adds alpha * values at idx in
    place through the ``scatter_apply`` kernel; the backward gathers the
    dense gradient at idx (what autodiff of the reference's scatter
    computes)."""

    @staticmethod
    def forward(ctx, w, idx, vals, alpha):
        ctx.save_for_backward(idx)
        ctx.alpha = alpha
        return scatter_apply(w.detach().clone(), idx, vals.detach().float(),
                             alpha=alpha)

    @staticmethod
    def backward(ctx, dw):
        (idx,) = ctx.saved_tensors
        dvals = M.gather_packed(dw.float(), idx)
        return None, None, dvals * ctx.alpha, None


def shira_weight(base: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                 alpha: float) -> dict:
    """A weight leaf as a lazy SHiRA bundle: ``models.layers.pdot``
    materializes it per call (``materialize_leaf``). Every tensor carries
    the leaf's leading layer dims, so slicing a stacked layer slices it."""
    return {SHIRA_KEY: base, "shira.idx": idx, "shira.vals": vals,
            "shira.alpha": float(alpha)}


def factor_weight(base: torch.Tensor, t: dict, kind: str, scale: float,
                  alpha: float, idx: Optional[torch.Tensor] = None) -> dict:
    """A weight leaf as a lazy LoRA / DoRA / SHiRA-DoRA bundle over its
    factors ``t`` ({"A", "B"[, "m"]}) and, for SHiRA-DoRA, its packed
    indices; sliced per layer as ``shira_weight`` is."""
    w = {FACTOR_KEY: base, "factor.kind": kind, "factor.A": t["A"],
         "factor.B": t["B"], "factor.scale": float(scale),
         "factor.alpha": float(alpha)}
    if "m" in t:
        w["factor.m"] = t["m"]
    if idx is not None:
        w["factor.idx"] = idx
    return w


def is_bundle(w) -> bool:
    return isinstance(w, dict) and (SHIRA_KEY in w or FACTOR_KEY in w)


def _lora_delta(a: torch.Tensor, b: torch.Tensor, scale: float
                ) -> torch.Tensor:
    return scale * torch.matmul(a.float(), b.float())


def _dora_weight(w: torch.Tensor, bundle: dict) -> torch.Tensor:
    v = w.float() + _lora_delta(bundle["factor.A"], bundle["factor.B"],
                                bundle["factor.scale"])
    return bundle["factor.m"] * v / _col_norm(v)


def materialize_leaf(w: dict) -> torch.Tensor:
    """The effective (n, m) matrix of one layer's bundle, differentiable
    in the trainable tensors, with the reference's numerics: f32 LoRA
    delta ``scale * A @ B``; DoRA ``m * v / ||v||``; the blend
    W + a * (Wd - W); SHiRA-DoRA's DoRA delta gathered at the mask and
    added back by the ``scatter_apply`` kernel (``_Materialize``, whose
    backward gathers, so the gradient reaches A, B and m through the
    gather)."""
    if SHIRA_KEY in w:
        return _Materialize.apply(w[SHIRA_KEY], w["shira.idx"],
                                  w["shira.vals"], w["shira.alpha"])
    base, kind, a = w[FACTOR_KEY], w["factor.kind"], w["factor.alpha"]
    if kind == "lora":
        delta = _lora_delta(w["factor.A"], w["factor.B"], w["factor.scale"])
        return (base.float() + a * delta).to(base.dtype)
    if kind == "dora":
        w32 = base.float()
        return (w32 + a * (_dora_weight(base, w) - w32)).to(base.dtype)
    delta = _dora_weight(base, w) - base.float()
    dv = M.gather_packed(delta, w["factor.idx"])    # only the masked 1%
    return _Materialize.apply(base, w["factor.idx"], dv, a)


def bundle_layers(w: dict):
    """The effective (n, m) matrices of a bundle over a (..., n, m) leaf,
    one layer at a time (``materialize_leaf`` of each layer's slice), with
    no gradient: for counting and comparing, never a whole effective
    leaf at once."""
    base = w[SHIRA_KEY if SHIRA_KEY in w else FACTOR_KEY]
    lead = base.ndim - 2
    nl = base[..., 0, 0].numel()
    flat = {k: v.reshape((nl,) + tuple(v.shape[lead:]))
            if isinstance(v, torch.Tensor) else v for k, v in w.items()}
    with torch.no_grad():
        for i in range(nl):
            yield materialize_leaf({k: v[i] if isinstance(v, torch.Tensor)
                                    else v for k, v in flat.items()})


def materialize(params, trainable, aux, acfg: AdapterConfig,
                alpha: Optional[float] = None):
    """The effective parameter tree for forward passes (alpha defaults to
    ``acfg.alpha``): W + alpha * S (SHiRA), W + alpha * scale * A @ B
    (LoRA, scale = lora_alpha / rank), the DoRA blend, or its SHiRA-masked
    form; the base itself for ``none``.

    Unlike the reference, which builds the whole effective tree, the
    target leaves become lazy bundles (``shira_weight``,
    ``factor_weight``): each matrix is materialized where a layer uses it,
    so inside ``lm.train_loss``'s checkpointed layers only one layer's
    effective weights are alive. At starcoder2-7b's full width the six
    adapted leaves hold 6.94 B entries; an effective copy of them all, and
    its dense gradient, would not fit beside the base on one 80 GB card."""
    if acfg.kind == "none" or trainable is None:
        return params
    a = acfg.alpha if alpha is None else alpha
    if acfg.kind == "shira":
        vals = dict(M.iter_leaves(trainable))
        idx = dict(M.iter_leaves(aux["indices"]))
        return M.map_leaves(
            lambda p, w: shira_weight(w, idx[p], vals[p], a)
            if p in idx else w, params)
    if acfg.kind not in FACTOR_KINDS:
        raise ValueError(acfg.kind)
    scale = acfg.lora_alpha / max(acfg.rank, 1)
    factors: Dict[str, dict] = {}
    for p, t in M.iter_leaves(trainable):
        leaf, _, name = p.rpartition("/")
        factors.setdefault(leaf, {})[name] = t
    idx = (dict(M.iter_leaves(aux["indices"])) if acfg.kind == "shira-dora"
           else {})
    return M.map_leaves(
        lambda p, w: factor_weight(w, factors[p], acfg.kind, scale, a,
                                   idx.get(p)) if p in factors else w,
        params)


# ---------------------------------------------------------------------------
# Shard-local materialize (the multi-rank training path)
# ---------------------------------------------------------------------------

def materialize_sharded(params, values, indices, alpha: float = 1.0):
    """W_eff = W + alpha * scatter(values) with SHARD-LOCAL packed indices.

    ``params`` holds this rank's shards; an ``indices``/``values`` leaf is
    (..., DPC, TPC, Ks) globally, per (n, m) tile of the (..., n, m)
    weight as its sharding spec splits it (a stack's leading dims, (L,) or
    a hybrid stage's (G, k), or none, kept as they are; DPC, TPC the
    products of those entries' axis sizes), Ks flat indices into the
    LOCAL (n/DPC, m/TPC) tile. This rank holds its (L, 1, 1, Ks) slice and
    scatters it into its tile through the ``scatter_apply`` kernel, one
    launch a leaf (its leading dims flattened), with no communication
    (``_Materialize``: the gradient is the gather of dW at the local
    indices, so the values' gradients
    are sharded as the weights are). The caller cut the tiles
    (``split_packed``, ``launch.sharding.local_shard``); the scatter needs
    neither the mesh nor the specs."""
    vals = dict(M.iter_leaves(values))
    idx = dict(M.iter_leaves(indices))

    def leaf(p, w):
        if p not in idx or vals.get(p) is None:
            return w
        w3 = w.reshape((-1,) + tuple(w.shape[-2:]))
        L = w3.shape[0]
        return _Materialize.apply(w3, idx[p].reshape(L, -1),
                                  vals[p].reshape(L, -1), alpha
                                  ).reshape(w.shape)

    return M.map_leaves(leaf, params)


def padding_mask(idx: torch.Tensor) -> torch.Tensor:
    """True at the padding entries of merged-form rows (..., K): index 0
    past the first place (a real index ascends, so 0 can only come
    first). Their values stay 0 when their gradient is kept at 0."""
    pos = torch.arange(idx.shape[-1], device=idx.device)
    return (pos >= 1) & (idx == 0)


def split_packed(idx: torch.Tensor, vals: torch.Tensor, shape, tiles
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A global pack leaf, (..., K) ascending flat indices into (n, m) and
    its values, split into shard-local tiles: ``tiles`` = (DPC, TPC), the
    ways the leaf's spec splits its (n, m) dims (``launch.sharding.
    tile_counts``). Returns (indices, values, place), each (..., DPC, TPC,
    Ks), the leading dims the pack's, with Ks the most
    entries any tile holds: a tile's entries in ascending local order
    ((r mod n/DPC) * m/TPC + c mod m/TPC), then padding (index 0, value
    0; ``padding_mask``), and ``place`` each entry's position in the
    global row (-1 at padding; ``join_packed`` reverses the split). Every
    tile must hold an entry: an empty tile's row would read as an entry
    at index 0."""
    lead = tuple(idx.shape[:-1])
    idx, vals = idx.reshape(-1, idx.shape[-1]), vals.reshape(-1,
                                                            idx.shape[-1])
    L, K = idx.shape
    n, m = shape[-2:]
    dpc, tpc = tiles
    nl, ml = n // dpc, m // tpc
    i = idx.long()
    r, c = i // m, i % m
    tile = (r // nl) * tpc + c // ml
    local = (r % nl) * ml + c % ml
    ntile = dpc * tpc
    # ascending global order is ascending local order within a tile: a
    # stable sort by tile keeps it
    key = torch.arange(L, device=i.device)[:, None] * ntile + tile
    order = torch.sort(key.reshape(-1), stable=True).indices
    counts = torch.bincount(key.reshape(-1), minlength=L * ntile)
    if bool((counts == 0).any()):
        raise ValueError("split_packed: a tile holds no entry of the pack")
    ks = int(counts.max())
    start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(L * K, device=i.device) - start[key.reshape(-1)[
        order]]
    dst = key.reshape(-1)[order] * ks + slot
    out_i = torch.zeros(L * ntile * ks, dtype=torch.int32, device=i.device)
    out_v = torch.zeros(L * ntile * ks, dtype=vals.dtype, device=i.device)
    place = torch.full((L * ntile * ks,), -1, dtype=torch.long,
                       device=i.device)
    out_i[dst] = local.reshape(-1)[order].to(torch.int32)
    out_v[dst] = vals.reshape(-1)[order]
    place[dst] = order % K
    shp = lead + (dpc, tpc, ks)
    return out_i.reshape(shp), out_v.reshape(shp), place.reshape(shp)


def join_packed(tile_vals: torch.Tensor, place: torch.Tensor, K: int
                ) -> torch.Tensor:
    """(..., DPC, TPC, Ks) tile values back to the (..., K) global row
    order of ``split_packed``'s ``place``."""
    lead = tuple(tile_vals.shape[:-3])
    L = math.prod(lead)
    out = torch.zeros((L, K), dtype=tile_vals.dtype, device=tile_vals.device)
    pl = place.reshape(L, -1)
    keep = pl >= 0
    rows = torch.arange(L, device=pl.device)[:, None].expand_as(pl)
    out[rows[keep], pl[keep]] = tile_vals.reshape(L, -1)[keep]
    return out.reshape(lead + (K,))
