"""The port's sharding rules against the JAX package's, leaf by leaf.

``launch.sharding.param_specs`` (head-alignment guard and vocab
fallbacks included), ``cache_specs`` and ``batch_spec`` give the JAX
package's specs over the same paths, for all ten archs on the abstract
meshes (16, 16), (2, 16, 16), (2, 2), (1, 4) and (4, 1); the JAX side
reads ``jax.eval_shape``'s parameter tree, the port's a "meta" tree.
Also: ``local_shard`` cuts the tiles a spec names, ``TPLayout`` lays
out the leaves of every family (MLA, Mamba2, the hybrid, vision and
audio as the dense ones), ``kv_seq_axes`` reads the sequence entry of
GQA and MLA cache specs, and the serving steps of zamba2 and paligemma on
a sequence-sharded (4, 1) cache install the "kv_seq" hint.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS, SHAPES
from repro.configs import get_config as j_config
from repro.launch import sharding as jshd
from repro.launch.steps import abstract_params as j_abstract_params
from repro.core.masks import path_str
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.masks import iter_leaves
from repro_torch.launch import sharding as tshd
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.launch.steps import abstract_params

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "4x1": ((4, 1), ("data", "model"))}


class FakeMesh:
    """Just enough mesh for the JAX package's spec computation."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))


def canon(x):
    """Nested plain structure: specs as tuples of entries, named tuples as
    dicts of their fields."""
    if isinstance(x, (JP, tshd.P)):
        return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                     for e in x)
    if hasattr(x, "_fields"):
        return {f: canon(getattr(x, f)) for f in x._fields}
    if isinstance(x, dict):
        return {k: canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    return x


_PARAMS = {}


def params_of(arch):
    if arch not in _PARAMS:
        jp = j_abstract_params(j_config(arch))
        _PARAMS[arch] = (jp, abstract_params(get_config(arch)))
    return _PARAMS[arch]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh_name):
    shape, axes = MESHES[mesh_name]
    jp, tp = params_of(arch)
    js = jshd.param_specs(jp, j_config(arch), FakeMesh(shape, axes))
    ts = tshd.param_specs(tp, get_config(arch), abstract_mesh(shape, axes))
    jflat = {path_str(p): canon(s) for p, s in
             jax.tree_util.tree_flatten_with_path(
                 js, is_leaf=lambda x: isinstance(x, JP))[0]}
    tflat = {p: canon(s) for p, s in iter_leaves(ts)}
    assert tflat == jflat
    # the port's params have the reference's shapes, leaf by leaf
    jshape = {path_str(p): tuple(x.shape) for p, x in
              jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert {p: tuple(t.shape) for p, t in iter_leaves(tp)} == jshape


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_match_reference(arch, mesh_name):
    shape, axes = MESHES[mesh_name]
    jm, tm = FakeMesh(shape, axes), abstract_mesh(shape, axes)
    jc, tc = j_config(arch), get_config(arch)
    for sname, sp in SHAPES.items():
        tsp = ShapeSpec(sp.name, sp.seq_len, sp.global_batch, sp.kind)
        assert canon(tshd.batch_spec(tc, tsp, tm)) == canon(
            jshd.batch_spec(jc, sp, jm)), sname
        assert tshd.cache_batch_axes(tc, tsp, tm) == \
            jshd.cache_batch_axes(jc, sp, jm)
        if sp.kind == "decode":
            assert canon(tshd.cache_specs(tc, tsp, tm)) == canon(
                jshd.cache_specs(jc, sp, jm)), sname


def test_local_shard_cuts_tiles():
    mesh = abstract_mesh((2, 2), ("data", "model"), coords=(1, 0))
    w = torch.arange(3 * 8 * 6, dtype=torch.float32).reshape(3, 8, 6)
    spec = tshd.P(None, "data", "model")
    got = tshd.local_shard(w, spec, mesh)
    assert torch.equal(got, w[:, 4:, :3])
    got = tshd.local_shard(w, spec, mesh, coords={"data": 0, "model": 1})
    assert torch.equal(got, w[:, :4, 3:])
    assert tshd.local_shard(w, tshd.P(), mesh) is w
    assert tshd.local_shape((3, 8, 6), spec, mesh) == (3, 4, 3)
    # a tuple entry is row-major over its axes
    m3 = abstract_mesh((2, 2, 2), ("pod", "data", "model"), coords=(1, 0, 1))
    v = torch.arange(8.0)
    assert torch.equal(tshd.local_shard(v, tshd.P(("pod", "data")), m3),
                       v[4:6])


# per arch, (leaf, per-layer shape of its semantic dims, the (1, 4) spec)
TP_LEAVES = {
    "mamba2-780m": [("in_x", (1536, 3072), (None, "model")),
                    ("in_dt", (1536, 48), (None, "model")),
                    ("in_bc", (1536, 256), (None, None)),
                    ("out_proj", (3072, 1536), ("model", None)),
                    ("conv_x_w", (4, 3072), (None, "model")),
                    ("A_log", (48,), (None,))],
    # trained with FSDP: the non-TP matrix dim over ``data``
    "deepseek-v2-lite-16b": [("wq", (2048, 3072), ("data", "model")),
                             ("w_dkv", (2048, 576), ("data", None)),
                             ("w_uk", (512, 2048), ("data", "model")),
                             ("w_uv", (512, 2048), ("data", "model")),
                             ("wo", (2048, 2048), ("model", "data"))],
    "zamba2-2.7b": [("in_z", (2560, 5120), (None, "model")),
                    ("out_proj", (5120, 2560), ("model", None)),
                    ("w_fuse", (5120, 2560), (None, None)),
                    ("wk", (2560, 2560), (None, "model"))],
    "paligemma-3b": [("wq", (2048, 2048), (None, "model")),
                     ("wk", (2048, 256), (None, None)),
                     ("wo", (2048, 2048), ("model", None))],
    "hubert-xlarge": [("wq", (1280, 1280), (None, "model")),
                      ("wk", (1280, 1280), (None, "model")),
                      ("w_down", (5120, 1280), ("model", None))],
}


@pytest.mark.parametrize("arch", ["mamba2-780m", "deepseek-v2-lite-16b",
                                  "zamba2-2.7b", "paligemma-3b",
                                  "hubert-xlarge"])
def test_tp_layout_refuses_families_without_tp_forward(arch):
    """No family is refused: ``TPLayout`` lays out the leaves of the five
    families that once had no TP forward by the rules, on (1, 4) (MLA's
    heads column-parallel and w_dkv replicated; the SSD heads split,
    in_bc and the per-head leaves replicated; paligemma's one KV head
    replicated beside its split q heads), and reads the serving step's
    "tp" hint."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps as S
    cfg = get_config(arch)
    mesh = abstract_mesh((1, 4), ("data", "model"))
    lay = tshd.TPLayout(cfg, mesh)
    for name, shape, want in TP_LEAVES[arch]:
        assert canon(lay.spec(name, shape)) == want, name
    smoke = get_smoke_config(arch)
    hints = S._serve_hints(smoke, mesh, ShapeSpec("d", 32, 4, "decode"),
                           cache=not smoke.encoder_only)
    assert isinstance(hints["tp"], tshd.TPLayout)


def test_tp_layout_specs_follow_the_rules():
    cfg = get_config("starcoder2-7b")
    lay = tshd.TPLayout(cfg, abstract_mesh((2, 2), ("data", "model")))
    hd = cfg.resolved_head_dim
    assert lay.spec("wq", (cfg.d_model, cfg.num_heads * hd)) == \
        tshd.P(None, "model")
    assert lay.sharded(lay.spec("wo", (cfg.num_heads * hd, cfg.d_model)), -2)
    # 16-way TP splits neither 36 q heads nor 4 KV heads: replicated
    lay16 = tshd.TPLayout(cfg, abstract_mesh((16, 16), ("data", "model")))
    assert lay16.spec("wq", (cfg.d_model, cfg.num_heads * hd)) == \
        tshd.P(None, None)
    assert np.all([e is None for e in lay16.spec(
        "wk", (cfg.d_model, cfg.num_kv_heads * hd))])


@pytest.mark.parametrize("arch", ["starcoder2-7b", "deepseek-v2-lite-16b",
                                  "zamba2-2.7b"])
def test_kv_seq_axes_reads_the_sequence_entry(arch):
    """The sequence entry of a GQA cache's (L, B, S, KV, D) spec and of an
    MLA cache's (L, B, S, r): none on (4, 1) with a batch that divides the
    dp size (the batch entry is sharded, not the sequence), "data" with a
    batch of 1, and for starcoder2 on 16 x 16 "model" (4 KV heads against
    16-way TP)."""
    cfg = get_config(arch)
    mesh = abstract_mesh((4, 1), ("data", "model"))
    for batch, want in ((4, ()), (1, ("data",))):
        specs = tshd.cache_specs(cfg, ShapeSpec("d", 32, batch, "decode"),
                                 mesh)
        assert tshd.kv_seq_axes(cfg, specs) == want, batch
    if arch == "starcoder2-7b":
        from repro_torch.configs import SHAPES as T_SHAPES
        specs = tshd.cache_specs(cfg, T_SHAPES["decode_32k"],
                                 abstract_mesh((16, 16), ("data", "model")))
        assert tshd.kv_seq_axes(cfg, specs) == ("model",)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "paligemma-3b"])
def test_serving_steps_without_tp_forward_refuse_naming_a11(arch):
    """zamba2 and paligemma on (4, 1) with batch 1 (a cache spec that
    shards the sequence over ``data``): the serving steps build, and
    install the "kv_seq" hint over ``data``, 8 rows of a 32-row cache a
    rank; no step refuses a family."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps as S
    cfg = get_smoke_config(arch)
    mesh = abstract_mesh((4, 1), ("data", "model"))
    shape = ShapeSpec("d", 32, 1, "decode")
    assert tshd.kv_seq_axes(cfg, tshd.cache_specs(cfg, shape, mesh)) == \
        ("data",)
    hints = S._serve_hints(cfg, mesh, shape)
    assert hints["kv_seq"].axes == ("data",) and hints["kv_seq"].n == 4
    assert hints["kv_seq"].local_len(32) == 8
    S.make_prefill_step(cfg, 32, mesh, shape)
    S.make_decode_step(cfg, mesh, shape)
