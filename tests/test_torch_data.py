"""repro_torch.data against repro.data: the port's copy of the synthetic
pipeline makes the same batches, byte for byte, for the same (seed, step,
task), as the trainers' parity tests assume; and the multi-adapter
stream's row blocks are the single-task streams. The vision and audio
batches are held in test_torch_vlm.py and test_torch_audio.py."""
import numpy as np
import pytest

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.data import TaskSpec as JTaskSpec
from repro.data import batch_iterator as j_batches
from repro.data import make_batch as j_make_batch
from repro.training import multi_batch_iterator as j_multi
from repro_torch.configs import ShapeSpec, get_smoke_config
from repro_torch.data import TaskSpec, batch_iterator, make_batch
from repro_torch.training import multi_batch_iterator

CFG, JCFG = get_smoke_config("starcoder2-7b"), j_smoke("starcoder2-7b")


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("seed,step,task,seq,batch,vslice", [
    (0, 0, 0, 8, 4, 0),
    (3, 17, 2, 130, 3, 0),          # seq > 64: crosses the re-seed points
    (7, 5, 1, 16, 2, 97),           # a vocab slice
])
def test_make_batch_is_bit_identical(seed, step, task, seq, batch, vslice):
    got = make_batch(CFG, ShapeSpec("t", seq, batch, "train"), seed, step,
                     TaskSpec(task, vslice))
    want = j_make_batch(JCFG, JShapeSpec("t", seq, batch, "train"), seed,
                        step, JTaskSpec(task, vslice))
    _equal(got, want)


def test_task_rules_match():
    for t in range(5):
        for v in (256, 49152):
            assert TaskSpec(t).rule(v) == JTaskSpec(t).rule(v)


def test_batch_iterator_is_bit_identical():
    shape, jshape = (ShapeSpec("t", 8, 2, "train"),
                     JShapeSpec("t", 8, 2, "train"))
    got = batch_iterator(CFG, shape, seed=4, task=TaskSpec(1), start_step=2)
    want = j_batches(JCFG, jshape, seed=4, task=JTaskSpec(1), start_step=2)
    for _ in range(3):
        _equal(next(got), next(want))


def test_multi_batch_iterator_matches_jax_and_single_streams():
    shape, jshape = (ShapeSpec("t", 8, 3, "train"),
                     JShapeSpec("t", 8, 3, "train"))
    A, n = 3, 3
    got = multi_batch_iterator(CFG, shape, 0, [TaskSpec(a) for a in range(A)])
    want = j_multi(JCFG, jshape, 0, [JTaskSpec(a) for a in range(A)])
    singles = [batch_iterator(CFG, shape, seed=0, task=TaskSpec(a))
               for a in range(A)]
    for _ in range(2):
        mb = next(got)
        _equal(mb, next(want))
        np.testing.assert_array_equal(mb["ids"], np.repeat(np.arange(A), n))
        for a, it in enumerate(singles):
            for k, v in next(it).items():
                np.testing.assert_array_equal(mb[k][a * n:(a + 1) * n], v)
