"""Logical -> physical sharding rules, and the cut of a rank's local shard.

Port of ``repro/launch/sharding.py``, with the port's own spec type ``P``
(a tuple of entries, each None, an axis name or a tuple of axis names).
Parameter leaves are mapped to specs by *leaf name*. Rules give the spec
of the trailing "semantic" dims; extra leading dims (layer stacks (L, ...),
hybrid groups (G, k, ...)) are padded with None.

Megatron-style TP over the ``model`` axis:
  column-parallel (out-dim sharded): wq wk wv w_up w_gate in_proj w_dkv wq_a
                                     wq_b w_uk w_uv + their biases
  row-parallel  (in-dim sharded):    wo w_down out_proj
  expert-parallel:                   experts_* sharded on the expert dim
  vocab-parallel:                    emb (V, d) and lm_head (d, V)

FSDP (cfg.fsdp) additionally shards the non-TP matrix dim over ``data``.

Where the reference hands ``NamedSharding``s to ``jit``, the port cuts
each rank's shard itself (``local_shard``, ``shard_tree``) and runs the
model on it; ``TPLayout`` is the hint that tells the model how each leaf
it uses is laid out (``launch.actctx``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.masks import leaf_name
from repro_torch.launch import mesh as M
from repro_torch.launch.mesh import axis_size, dp_axes


class P:
    """A partition spec: one entry a dim (None, an axis name, or a tuple of
    axis names; a tuple of one name is that name, as ``jax``'s
    ``PartitionSpec`` keeps it); dims past its length are unsharded."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1
            else tuple(e) if isinstance(e, list) else e for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, P):
            return self.entries == other.entries
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"

    def axes(self) -> Tuple[str, ...]:
        """Every axis name the spec shards over, in order."""
        out = []
        for e in self.entries:
            out.extend(_entry_axes(e))
        return tuple(out)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


# name -> (n_semantic_dims, spec builder)
_COL = lambda f: (2, lambda: P(f, "model"))
_ROW = lambda f: (2, lambda: P("model", f))


def _rules(fsdp: Optional[str]) -> Dict[str, Tuple[int, Any]]:
    f = fsdp
    return {
        # attention / MLA
        "wq": _COL(f), "wk": _COL(f), "wv": _COL(f),
        "wq_a": _COL(f), "wq_b": _COL(f),
        "w_dkv": (2, lambda: P(f, None)),     # latent dim is tiny: replicate
        "w_uk": _COL(f), "w_uv": _COL(f),
        "wo": _ROW(f),
        "bq": (1, lambda: P("model")), "bk": (1, lambda: P("model")),
        "bv": (1, lambda: P("model")),
        # MLPs
        "w_up": _COL(f), "w_gate": _COL(f), "w_down": _ROW(f),
        # MoE
        "w_router": (2, lambda: P(f, None)),
        "experts_w_up": (3, lambda: P("model", f, None)),
        "experts_w_gate": (3, lambda: P("model", f, None)),
        "experts_w_down": (3, lambda: P("model", None, f)),
        # Mamba2 (separate shard-aligned projections)
        "in_z": _COL(f), "in_x": _COL(f), "in_dt": _COL(f),
        "in_bc": (2, lambda: P(f, None)),     # 2*g*n is tiny: replicate
        "out_proj": _ROW(f),
        "conv_x_w": (2, lambda: P(None, "model")),
        "conv_x_b": (1, lambda: P("model")),
        "conv_bc_w": (2, lambda: P(None, None)),
        "conv_bc_b": (1, lambda: P(None)),
        "A_log": (1, lambda: P(None)), "D": (1, lambda: P(None)),
        "dt_bias": (1, lambda: P(None)),
        # zamba2 shared-block fuse
        "w_fuse": (2, lambda: P(f, None)),
        # embeddings
        "emb": (2, lambda: P("model", f)),
        "lm_head": (2, lambda: P(f, "model")),
        # norms
        "scale": (1, lambda: P(None)),
    }


def _axis_prod(mesh, entry) -> int:
    return math.prod(axis_size(mesh, a) for a in _entry_axes(entry))


def sanitize_spec(spec: P, shape, mesh) -> P:
    """Drop axes that do not divide the corresponding dim."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return P(*(entry if dim % _axis_prod(mesh, entry) == 0 else None
               for dim, entry in zip(shape, entries)))


def spec_for(name: str, shape: Tuple[int, ...], cfg: ModelConfig, mesh) -> P:
    """The spec of a leaf called ``name`` of (global) ``shape``."""
    ndim = len(shape)
    fsdp = "data" if cfg.fsdp else None
    rules = _rules(fsdp)
    if name not in rules:
        return P()  # replicate anything unknown (defensive)
    # Head-alignment guard: sharding the flat (H*hd) projection when H does
    # not divide TP splits inside a head; the reference replicates the
    # projection instead.
    tp = axis_size(mesh, "model")
    if cfg.attn_type == "gqa":
        from repro_torch.models.attention import padded_heads
        hp, kvp = padded_heads(cfg)
        if name in ("wq", "wo", "bq") and hp % tp != 0:
            return P(*([None] * ndim))
        if name in ("wk", "wv", "bk", "bv") and kvp % tp != 0:
            return P(*([None] * ndim))
    nsem, builder = rules[name]
    extra = ndim - nsem
    if extra < 0:
        return P()
    spec = sanitize_spec(P(*([None] * extra + list(builder()))), shape, mesh)
    # vocab dims that do not divide TP: shard the embedding dim over
    # `model` instead of replicating the table.
    if name == "emb" and spec[0] is None and shape[1] % tp == 0:
        spec = P(None, "model")
    if name == "lm_head" and spec[1] is None and shape[0] % tp == 0:
        spec = P("model", None)
    return spec


def param_spec(path: str, leaf, cfg: ModelConfig, mesh) -> P:
    return spec_for(leaf_name(path), tuple(leaf.shape), cfg, mesh)


def _tree_map(fn, tree, *rest, prefix: Tuple[str, ...] = ()):
    """``fn(path, leaf, *rest_leaves)`` over a tree of dicts, lists and
    tuples (named tuples keep their type) whose leaves are tensors, specs
    or shapes; None stays None."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest),
                             prefix=prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, torch.Size):
        items = [_tree_map(fn, v, *(r[i] for r in rest),
                           prefix=prefix + (str(i),))
                 for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    if tree is None:
        return None
    return fn("/".join(prefix), tree, *rest)


def param_specs(params, cfg: ModelConfig, mesh):
    """Tree of ``P`` matching a parameter tree (meta tensors will do)."""
    return _tree_map(lambda p, x: param_spec(p, x, cfg, mesh), params)


def sanitize_tree(spec_tree, shape_tree, mesh):
    return _tree_map(lambda _, s, x: sanitize_spec(s, tuple(x.shape), mesh),
                     spec_tree, shape_tree)


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------

def _dp_size(mesh) -> int:
    return math.prod(axis_size(mesh, a) for a in dp_axes(mesh))


def batch_spec(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Dict[str, P]:
    dp = dp_axes(mesh)
    dp_size = _dp_size(mesh)
    bspec = dp if shape.global_batch % dp_size == 0 and \
        shape.global_batch >= dp_size else None
    out: Dict[str, P] = {}
    if cfg.modality == "audio":
        out["frame_embeds"] = P(bspec, None, None)
    else:
        out["tokens"] = P(bspec, None)
        if cfg.modality == "vision":
            out["patch_embeds"] = P(bspec, None, None)
    out["labels"] = P(bspec, None)
    return out


def cache_batch_axes(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """How to shard (batch, seq) of KV caches: batch over dp when divisible,
    otherwise the cache *sequence* over 'data' (long-context batch 1)."""
    dp = dp_axes(mesh)
    dp_size = _dp_size(mesh)
    if shape.global_batch % dp_size == 0 and shape.global_batch >= dp_size:
        return dp, None          # (batch axes, seq axes)
    return None, ("data",)       # sequence-sharded decode


def kv_cache_spec(cfg: ModelConfig, shape: ShapeSpec, mesh, lead: int,
                  mla: bool):
    """Spec for one stage's stacked KVCache; ``lead`` = # leading stack dims.

    The head dim is sharded over ``model`` when it divides evenly;
    otherwise the cache *sequence* is (MQA kv=1, kv=8 against 16-way TP,
    MHA kv=40). MLA caches shard the latent dim."""
    from repro_torch.models.attention import KVCache, padded_heads
    b_ax, s_ax = cache_batch_axes(cfg, shape, mesh)
    pad = [None] * lead
    if mla:  # (..., B, S, r) latent + (..., B, S, rope)
        lat = "model" if cfg.mla.kv_lora_rank % axis_size(mesh, "model") == 0 \
            else None
        return KVCache(P(*pad, b_ax, s_ax, lat), P(*pad, b_ax, s_ax, None))
    if padded_heads(cfg)[1] % axis_size(mesh, "model") == 0:
        heads, seq = "model", s_ax
    else:
        heads = None
        seq = ("data", "model") if s_ax else "model"
    return KVCache(P(*pad, b_ax, seq, heads, None),
                   P(*pad, b_ax, seq, heads, None))


def mamba_cache_spec(cfg: ModelConfig, shape: ShapeSpec, mesh, lead: int):
    from repro_torch.models.mamba2 import MambaCache
    b_ax, _ = cache_batch_axes(cfg, shape, mesh)
    pad = [None] * lead
    d_inner = cfg.ssm.expand * cfg.d_model
    n_heads = d_inner // cfg.ssm.head_dim
    heads = "model" if n_heads % axis_size(mesh, "model") == 0 else None
    return MambaCache(ssm=P(*pad, b_ax, heads, None, None),
                      conv_x=P(*pad, b_ax, None, "model"),
                      conv_bc=P(*pad, b_ax, None, None))


def cache_specs(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """Spec tree matching ``lm.init_cache``'s structure."""
    from repro_torch.models.lm import stage_plan
    mla = cfg.attn_type == "mla"
    out = []
    for kind, _ in stage_plan(cfg):
        if kind == "mamba":
            out.append(mamba_cache_spec(cfg, shape, mesh, lead=1))
        elif kind == "hybrid":
            out.append({"mamba": mamba_cache_spec(cfg, shape, mesh, lead=2),
                        "attn": kv_cache_spec(cfg, shape, mesh, lead=1,
                                              mla=mla)})
        else:
            out.append(kv_cache_spec(cfg, shape, mesh, lead=1, mla=mla))
    return out


def kv_seq_axes(cfg: ModelConfig, spec_tree) -> Tuple[str, ...]:
    """The axes ``cfg``'s cache spec tree shards a KV cache's sequence dim
    over, or (): the S of a GQA stage's (L, B, S, KV, D) leaves, of an MLA
    stage's (L, B, S, r)."""
    from repro_torch.models.attention import KVCache
    seq = -2 if cfg.attn_type == "mla" else -3
    stages = spec_tree if isinstance(spec_tree, list) else [spec_tree]
    for st in stages:
        kv = st["attn"] if isinstance(st, dict) else st
        if isinstance(kv, KVCache) and len(kv.k) >= -seq and \
                kv.k[seq] is not None:
            return _entry_axes(kv.k[seq])
    return ()


# ---------------------------------------------------------------------------
# Local shards (in place of the reference's NamedSharding / device_put)
# ---------------------------------------------------------------------------

def _coord_index(mesh, entry, coords: Optional[Dict[str, int]]) -> int:
    i = 0
    for a in _entry_axes(entry):
        c = (coords or {}).get(a, mesh.coord(a))
        i = i * axis_size(mesh, a) + c
    return i


class SeqLayout:
    """The "kv_seq" hint: each rank's KV caches hold its shard of the
    sequence, cut over ``axes`` as ``local_shard`` cuts it (row-major over
    the axes, so the rank's rows start at ``index`` times the local
    length). The model writes only the rows it holds and merges the ranks'
    attention with ``launch.mesh.softmax_merge`` over ``axes``."""

    def __init__(self, mesh, axes):
        self.mesh, self.axes = mesh, tuple(_entry_axes(axes))
        self.n = _axis_prod(mesh, self.axes)
        self.index = _coord_index(mesh, self.axes, None)

    def local_len(self, cache_size: int) -> int:
        if cache_size % self.n:
            raise ValueError(f"a cache of {cache_size} rows does not divide "
                             f"over {self.axes} ({self.n} ranks)")
        return cache_size // self.n

    def offset(self, local_len: int) -> int:
        """The first global position of this rank's rows."""
        return self.index * local_len


def tile_counts(spec: P, ndim: int, mesh) -> Tuple[int, int]:
    """(DPC, TPC): the ways ``spec`` splits the trailing (n, m) dims of a
    leaf of ``ndim`` dims (a stack's leading dims padded with None)."""
    entries = list(spec) + [None] * (ndim - len(spec))
    return _axis_prod(mesh, entries[-2]), _axis_prod(mesh, entries[-1])


def local_shape(shape, spec: P, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a (global) ``shape``."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(d // _axis_prod(mesh, e) for d, e in zip(shape, entries))


def local_shard(tensor: torch.Tensor, spec: P, mesh,
                coords: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """One rank's shard of a global tensor: each dim cut into the product
    of its entry's axis sizes, the rank's chunk taken (row-major over the
    entry's axes). ``coords`` ({axis: index}) picks another rank than
    ``mesh``'s own. A sharded leaf comes back as its own contiguous copy
    (so the global tensor can be freed), a replicated one as itself."""
    entries = list(spec) + [None] * (tensor.ndim - len(spec))
    out = tensor
    for dim, e in enumerate(entries):
        n = _axis_prod(mesh, e)
        if n == 1:
            continue
        if tensor.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(tensor.shape)} does not "
                             f"divide {e} ({n})")
        c = tensor.shape[dim] // n
        out = out.narrow(dim, _coord_index(mesh, e, coords) * c, c)
    return out if out is tensor else out.clone(
        memory_format=torch.contiguous_format)


def shard_tree(tree, spec_tree, mesh,
               coords: Optional[Dict[str, int]] = None):
    """``local_shard`` of every leaf of ``tree`` by the aligned spec
    tree."""
    return _tree_map(lambda _, t, s: local_shard(t, s, mesh, coords), tree,
                     spec_tree)


# ---------------------------------------------------------------------------
# The "tp" hint: how each leaf the model uses is laid out
# ---------------------------------------------------------------------------

class TPLayout:
    """The mesh and the leaf specs, as the model reads them: ``spec(name,
    shape)`` is the spec of a leaf ``name`` of (global, per-layer) shape
    ``shape``, by the rules above; ``weight`` turns the local leaf into
    the tensor a layer multiplies (a SHiRA bundle materialized; an FSDP
    leaf gathered over ``data``, its gradient reduce-scattered). Every
    family reads it: dense GQA, MoE (GQA or MLA), Mamba2, the hybrid, and
    the vision and audio stubs."""

    def __init__(self, cfg: ModelConfig, mesh):
        self.cfg, self.mesh = cfg, mesh
        self.tp = axis_size(mesh, "model")
        self.rank = mesh.coord("model")
        self._cache: Dict[Tuple[str, Tuple[int, ...]], P] = {}

    def spec(self, name: str, shape: Tuple[int, ...]) -> P:
        key = (name, tuple(shape))
        if key not in self._cache:
            self._cache[key] = spec_for(name, tuple(shape), self.cfg,
                                        self.mesh)
        return self._cache[key]

    def sharded(self, spec: P, dim: int) -> bool:
        """Whether dim ``dim`` of the spec is split over ``model``."""
        entries = list(spec)
        if not -len(entries) <= dim < len(entries):
            return False
        return "model" in _entry_axes(entries[dim]) and self.tp > 1

    def weight(self, w, name: str, shape: Tuple[int, ...]):
        """(tensor, spec): the local leaf, a bundle materialized, its
        FSDP dims gathered."""
        from repro_torch.core.adapters import is_bundle, materialize_leaf
        if is_bundle(w):
            w = materialize_leaf(w)
        spec = self.spec(name, shape)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        for dim, e in enumerate(entries):
            dp = tuple(a for a in _entry_axes(e) if a != "model")
            if dp:
                w = M.fsdp_gather(self.mesh, w, dp, dim - len(shape))
        return w, spec
