"""repro_torch.kernels.masked_update (B8, the dense-mask apply) against the
JAX package's ``ops.masked_update`` and ``ref.masked_update_ref``.

Inputs are the JAX kernel test's (``tests/test_kernels.py``): W from a
numpy seed in f32 or bf16, a 2% mask, f32 values, alpha 1.5. The port's
plain version (what the wrapper computes for CPU tensors, and what
``chip_smoke.py`` holds the CUDA kernel against) forms the reference's f32
products and sum, each rounded on its own, and rounds once to W's dtype.
It is held bit-equal (tolerance 0, where the JAX test allows 1e-6 for f32
and 3e-2 for bf16) to the JAX oracle ``ref.masked_update_ref``, which runs
op by op. The JAX kernel in Pallas interpret mode is compiled by XLA's CPU
compiler, which contracts the product and the sum into one FMA: in f32 it
equals the once-rounded w + (alpha * m) * v (computed here in float64)
bit for bit, and the port is held to within the product's rounding (an
ulp of the product, and one of the result); in bf16
the two agree bit for bit on these inputs. The port takes its own bool
masks and the reference's f32 masks alike.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build
from repro_torch.kernels import masked_update as mu
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, seed=2):
    rng = np.random.RandomState(seed)
    w = rng.randn(*shape).astype(np.float32)
    mask = rng.rand(*shape) < 0.02
    vals = rng.randn(*shape).astype(np.float32)
    return w, mask, vals


def _bits(t: torch.Tensor) -> np.ndarray:
    """The raw bits of a float tensor, so equality is bit-for-bit."""
    itype = torch.int32 if t.dtype == torch.float32 else torch.int16
    return t.contiguous().view(itype).numpy()


@pytest.mark.parametrize("shape", [(256, 256), (512, 1024)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mask_dtype", ["f32", "bool"])
def test_masked_update_bit_equal_to_jax(shape, dtype, mask_dtype):
    jd, td = DTYPES[dtype]
    w, mask, vals = _inputs(shape)
    jw = jnp.asarray(w, jd)
    jm = jnp.asarray(mask, jnp.float32)
    jv = jnp.asarray(vals)
    want = jops.masked_update(jw, jm, jv, 1.5, interpret=True)
    oracle = jref.masked_update_ref(jw, jm, jv, 1.5)
    tw = torch.from_numpy(w.copy()).to(td)   # jw may share w's memory
    tm = torch.from_numpy(mask if mask_dtype == "bool"
                          else mask.astype(np.float32))
    out = tops.masked_update(tw, tm, torch.from_numpy(vals), 1.5)
    assert out is tw                                     # in place
    want_t = torch.from_numpy(np.asarray(want, np.float32)).to(td)
    oracle_t = torch.from_numpy(np.asarray(oracle, np.float32)).to(td)
    np.testing.assert_array_equal(_bits(out), _bits(oracle_t))
    if dtype == "bf16":
        np.testing.assert_array_equal(_bits(out), _bits(want_t))
        return
    wf = np.asarray(jw, np.float32).astype(np.float64)
    fused = (wf + (np.float32(1.5) * mask.astype(np.float32)).astype(
        np.float64) * vals.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(want), fused)
    prod = np.float32(1.5) * mask.astype(np.float32) * vals
    ulp = np.spacing(np.abs(prod)) + np.spacing(np.abs(out.numpy()))
    assert (np.abs(out.numpy() - np.asarray(want)) <= ulp).all()


@pytest.mark.parametrize("shape", [(37, 53), (3, 40, 24), (2, 5, 7, 9)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.uint8,
                                        torch.float32])
def test_plain_version_any_shape(shape, dtype, mask_dtype):
    """The port alone: shapes no multiple of 256 and stacked (L, n, m)
    leaves, which the Pallas kernel refuses, against the port's oracle
    bit for bit; entries off the mask keep their bits."""
    td = DTYPES[dtype][1]
    w, mask, vals = (torch.from_numpy(a) for a in _inputs(shape, seed=5))
    w = w.to(td)
    m = mask.to(mask_dtype)
    v = 0.01 * vals
    alpha = -3e-4 if dtype == "f32" else -0.5   # moves bf16 weights too
    want = tref.masked_update_ref(w, m, v, alpha)
    out = mu.masked_update(w.clone(), m, v, alpha)
    np.testing.assert_array_equal(_bits(out), _bits(want))
    np.testing.assert_array_equal(_bits(out[~mask]), _bits(w[~mask]))
    assert bool((out[mask] != w[mask]).any())


def test_checks_and_devices(monkeypatch, tmp_path):
    w = torch.zeros(4, 8)
    m = torch.zeros(4, 8, dtype=torch.bool)
    v = torch.zeros(4, 8)
    with pytest.raises(TypeError, match="f32 or bf16"):
        mu.masked_update(w.double(), m, v)
    with pytest.raises(TypeError, match="mask"):
        mu.masked_update(w, m.to(torch.int32), v)
    with pytest.raises(ValueError, match="shape"):
        mu.masked_update(w, m[:2], v)
    with pytest.raises(ValueError, match="contiguous"):
        mu.masked_update(w.t(), m.t(), v.t())
    meta = torch.device("meta")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        mu.masked_update(w.to(meta), m.to(meta), v.to(meta))
    # without a compiler and a built library, loading the kernel raises:
    # nothing falls back to the plain version quietly
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda _: str(tmp_path / "x"))
    monkeypatch.setattr(build.os.path, "exists", lambda _: False)
    monkeypatch.delitem(build._LIBS, "masked_update", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        mu._lib()
    assert mu.masked_update.launches == 0      # CPU calls launch nothing
