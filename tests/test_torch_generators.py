"""The port's copies of the problem generators (``tests/_torch_cases.py``:
``make_problem`` and ``make_sparse_problem``), bit for bit against the
originals in ``bench.py`` and ``benchmarks/_common.py``, which the port's
scripts no longer import: the seeds and the RNG call order are part of
every recorded problem."""

import numpy as np
import pytest

pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

import bench  # noqa: E402
from _torch_cases import make_problem, make_sparse_problem  # noqa: E402
from benchmarks import _common  # noqa: E402


def assert_bit_equal(mine, theirs):
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", [0, 7])
def test_make_problem_is_bench_make_problem(dtype, seed):
    assert_bit_equal(make_problem(48, 96, 5, 6, seed=seed, dtype=dtype),
                     bench.make_problem(48, 96, 5, 6, seed=seed,
                                        dtype=dtype))


@pytest.mark.parametrize("signed,amp", [(False, (0.5, 1.0)),
                                        (True, (0.5, 1.5))])
@pytest.mark.parametrize("seed", [0, 3])
def test_make_sparse_problem_is_the_benchmarks_one(signed, amp, seed):
    assert_bit_equal(
        make_sparse_problem(40, 128, 6, 5, seed=seed, signed=signed,
                            amp=amp),
        _common.make_sparse_problem(40, 128, 6, 5, seed=seed,
                                    signed=signed, amp=amp))
