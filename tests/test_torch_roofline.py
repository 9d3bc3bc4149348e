"""repro_torch.analysis.roofline and the port's shape tables against the JAX
package's (repro/analysis/roofline.py, repro/configs).

  * ``SHAPES``, ``applicable_shapes`` and ``all_cells`` equal the
    reference's for every registry id;
  * ``count_params`` (total and active) and ``model_flops`` equal the
    reference's exactly, for every arch and every applicable shape, by
    name and by ``ShapeSpec``;
  * ``roofline_terms`` equals the reference's on synthetic records when
    ``HW`` holds the reference's figures (the same arithmetic), and a
    one-card record has one chip and no collective term;
  * the default ``HW`` is the H100 SXM's, with none of the TPU's figures;
  * ``count_params`` lies within 20% of the port's full-size parameter
    count, built as fake (meta-backed) tensors, as
    ``tests/test_archs_smoke.py`` holds the reference's.
"""
import dataclasses

import pytest
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.analysis import roofline as JR
from repro.configs import base as JB
from repro.configs import registry as JReg
from repro_torch.analysis import roofline as TR
from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeSpec, all_cells,
                                 applicable_shapes, get_config)
from repro_torch.core.masks import iter_leaves
from repro_torch.models import lm

REF_HW = TR.HW(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)


def test_shapes_equal_the_reference():
    assert list(SHAPES) == list(JB.SHAPES)
    for name, s in SHAPES.items():
        assert dataclasses.astuple(s) == dataclasses.astuple(JB.SHAPES[name])
        assert s.tokens == JB.SHAPES[name].tokens


def test_all_cells_equal_the_reference():
    assert all_cells() == JReg.all_cells()
    assert ARCH_IDS == JReg.ARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_applicable_shapes_equal_the_reference(arch):
    got = [dataclasses.astuple(s) for s in applicable_shapes(arch)]
    want = [dataclasses.astuple(s) for s in JReg.applicable_shapes(arch)]
    assert got == want
    assert get_config(arch).subquadratic == JReg.get_config(arch).subquadratic


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_and_model_flops_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), JReg.get_config(arch)
    assert TR.count_params(cfg) == JR.count_params(jcfg)
    for s in JReg.applicable_shapes(arch):
        want = JR.model_flops(jcfg, s.name)
        assert TR.model_flops(cfg, s.name) == want
        # a ShapeSpec of the same numbers gives the same count
        spec = ShapeSpec(s.name, s.seq_len, s.global_batch, s.kind)
        assert TR.model_flops(cfg, spec) == want


def _records():
    """Synthetic dry-run records: pod meshes, a one-card mesh, zero and
    nonzero costs and collectives, every shape."""
    out = []
    for i, (name, mesh) in enumerate(
            [("train_4k", (2, 16, 16)), ("prefill_32k", (16, 16)),
             ("decode_32k", (256,)), ("long_500k", (1,)),
             ("decode_32k", (1,)), ("train_4k", (4, 8))]):
        out.append({"mesh": mesh, "shape": name,
                    "cost": {"flops": 3.1e14 * (i + 1) if i != 4 else 0.0,
                             "bytes_accessed": 7.7e10 / (i + 1)},
                    "collectives": {"total_bytes": (5e9 * i) if i != 3
                                    else 0}})
    return out


@pytest.mark.parametrize("arch", ["starcoder2-7b", "deepseek-v2-lite-16b",
                                  "mamba2-780m", "zamba2-2.7b"])
def test_roofline_terms_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), JReg.get_config(arch)
    for rec in _records():
        if rec["shape"] == "long_500k" and not cfg.subquadratic:
            continue
        assert TR.roofline_terms(rec, cfg, REF_HW) == \
            JR.roofline_terms(rec, jcfg)
        # and a ShapeSpec in the record reads as its name does
        spec = SHAPES[rec["shape"]]
        assert TR.roofline_terms({**rec, "shape": spec}, cfg, REF_HW) == \
            JR.roofline_terms(rec, jcfg)


def test_one_card_record():
    cfg = get_config("starcoder2-7b")
    rec = {"mesh": (1,), "shape": ShapeSpec("decode", 24, 8, "decode"),
           "cost": {"flops": 1.2e11, "bytes_accessed": 5.9e10},
           "collectives": {"total_bytes": 0}}
    r = TR.roofline_terms(rec, cfg)
    hw = TR.HW()
    assert r["chips"] == 1 and r["collective_s"] == 0.0
    assert r["dominant"] == "memory_s"
    assert r["memory_s"] == 5.9e10 / hw.hbm_bw
    assert r["bound_s"] == r["memory_s"]
    assert r["model_flops_global"] == 2.0 * TR.count_params(cfg)["active"] * 8


def test_default_hw_is_the_h100():
    hw = TR.HW()
    assert (hw.peak_flops, hw.f32_flops, hw.hbm_bw, hw.link_bw) == \
        (989e12, 67e12, 3.35e12, 450e9)
    tpu = dataclasses.astuple(JR.HW())
    assert not set(dataclasses.astuple(hw)) & set(tpu)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_matches_the_built_model(arch):
    cfg = get_config(arch)
    with FakeTensorMode():
        params = lm.init_params(cfg, seed=0, device="cpu")
        n = sum(x.numel() for _, x in iter_leaves(params))
    analytic = TR.count_params(cfg)["total"]
    assert abs(n - analytic) / analytic < 0.2, (arch, n, analytic)
