"""repro_torch.training.MultiAdapterTrainer with quantized optimizer
moments, against the JAX package's and against the port's f32 runs.

As in test_torch_multiadapter.py, the JAX trainer draws the base and the
indices, which cross over through repro_torch.bridge, and both packages
run in f32 compute. With int8 moments the two packages agree to rtol =
atol = 5e-3 (the JAX package's trainer tolerance; measured ~2e-7).
Against the port's f32-moment Trainer, adapter a is held at 2e-2, the JAX
package's documented tolerance of int8 moments against the f32 oracle
(tests/test_multiadapter.py; measured 1.4e-2 after 4 steps): a stored
moment's rounding flip moves a trajectory. The kernel path (fused=True)
equals the reference path (fused=False) to 1e-5 with f32 moments, and
both stay within 1e-2 (bf16) and 2e-2 (int8) of the f32 run.
"""
import numpy as np
import pytest
import torch

from repro_torch.models import layers as TL
from repro_torch.training import MultiAdapterTrainer
from test_torch_multiadapter import (STEPS, _check_vs_jax, _check_vs_trainer,
                                     _pair, _runs, jbase)  # noqa: F401

INT8_VS_F32 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def int8_run(jbase):
    return _pair(jbase, "int8", 2)


def test_int8_moments_match_jax_multi_trainer(int8_run):
    _, jm, jout, tm, tout = int8_run
    _check_vs_jax(jm, jout, tm, tout)
    st = tout["state"]
    for p, mu in st["mu"].items():
        assert mu.dtype == torch.int8 and st["nu"][p].dtype == torch.int8
        assert st["mu_scale"][p].shape == mu.shape[:-1]


def test_int8_moments_track_f32_trainers(int8_run):
    trun, _, _, tm, tout = int8_run
    _check_vs_trainer(trun, tm, tout, INT8_VS_F32)


def _final_values(trun, moments, fused, like=None):
    kw = {} if like is None else dict(base_params=like.base,
                                      auxes=like.auxes)
    with TL.compute_precision(torch.float32):
        mt = MultiAdapterTrainer(trun, ["a0", "a1"], moments=moments,
                                 fused=fused, device="cpu", **kw)
        vals = mt.fit(STEPS, log=None)["state"]["values"]
    return mt, torch.cat([v.reshape(-1) for v in vals.values()]).numpy()


def test_kernel_path_matches_reference_path():
    """As the JAX package's own test: with f32 moments the kernel path
    (fused=True, the sparse_adamw_rows wrapper) equals the reference path
    (fused=False, kernels.ref.sparse_adamw_rows_ref) to 1e-5; with bf16 or
    int8 moments a rounding flip of a stored moment moves a trajectory,
    so both paths are held near the f32 run, within 1e-2 (bf16) and 2e-2
    (int8), the JAX package's documented tolerances."""
    _, trun = _runs()
    mt, oracle = _final_values(trun, "f32", True)
    _, ref = _final_values(trun, "f32", False, mt)
    np.testing.assert_allclose(oracle, ref, rtol=1e-5, atol=1e-6)
    for mode, tol in (("bf16", 1e-2), ("int8", 2e-2)):
        for fused in (True, False):
            _, got = _final_values(trun, mode, fused, mt)
            np.testing.assert_allclose(got, oracle, rtol=tol, atol=tol)


