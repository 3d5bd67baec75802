"""The port's input views (``sparse_solvers_tpu_torch/utils/ndview.py``)
against the JAX package's, case for case as ``tests/test_ndview.py``:
shape mismatches raise with the same messages, dtypes follow the input,
and non-contiguous numpy views (row and column slices, transposes,
strides) are consumed as their contiguous copies. The cases
``test_torch_api.py::test_ndview_matches_jax_ndview`` already holds (a
1-d matrix, a 3-d signal batch, a strided transposed view, integer
promotion) are not repeated."""

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

from sparse_solvers_tpu.utils import ndview as jnd  # noqa: E402
from sparse_solvers_tpu_torch.utils import ndview  # noqa: E402


def same_error(fn, *args, **kwargs):
    """``fn`` raises a ValueError in both packages, with one message."""
    with pytest.raises(ValueError) as mine:
        getattr(ndview, fn)(*args, **kwargs)
    with pytest.raises(ValueError) as theirs:
        getattr(jnd, fn)(*args, **kwargs)
    assert str(mine.value) == str(theirs.value)
    return str(mine.value)


def test_matrix_requires_2d():
    assert "dimensions" in same_error("as_matrix", np.zeros((2, 2, 2)))


def test_vector_requires_1d():
    assert "dimensions" in same_error("as_vector", np.zeros((5, 1)))


def test_vector_size_check():
    assert "length" in same_error("as_vector", np.zeros(4), size=5)


def test_dtype_follows_input():
    for np_dtype, torch_dtype in ((np.float32, torch.float32),
                                  (np.float64, torch.float64)):
        a = np.zeros((2, 2), np_dtype)
        assert ndview.as_matrix(a).dtype == torch_dtype
        assert jnd.as_matrix(a).dtype == np_dtype


def test_noncontiguous_views_roundtrip():
    base = np.arange(40, dtype=np.float64).reshape(5, 8)
    for v in (base[:, 2:6], base[1:4, :], base.T):
        out = ndview.as_matrix(v)
        assert out.is_contiguous() and out.dtype == torch.float64
        np.testing.assert_array_equal(out.numpy(), np.ascontiguousarray(v))
        np.testing.assert_array_equal(out.numpy(),
                                      np.asarray(jnd.as_matrix(v)))


def test_strided_vector():
    base = np.arange(10, dtype=np.float64)
    v = base[::2]
    out = ndview.as_vector(v)
    np.testing.assert_array_equal(out.numpy(), base[::2])
    np.testing.assert_array_equal(out.numpy(), np.asarray(jnd.as_vector(v)))
