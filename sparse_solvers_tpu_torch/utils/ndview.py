"""Input normalization — the port of ``sparse_solvers_tpu/utils/ndview.py``.

Any array-like (numpy arrays, including non-contiguous views, or torch
tensors) is normalized here once into a contiguous tensor on the solver's
device; every kernel then consumes that tensor. Shape and dtype validation
mirrors the reference binding's checks (binding.cpp:21-37) with the same
messages as the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def _dim_error(expected: int, got: int) -> ValueError:
    # Same message shape as the reference binding (binding.cpp:24-25).
    return ValueError(
        f"Unexpected number of dimensions. Expected {expected} but got {got}"
    )


def _resolve_dtype(src) -> torch.dtype:
    """float32/float64 inputs keep their type; other real floats and
    integers promote to float32, as in the JAX package. ``src`` is a numpy
    or a torch dtype."""
    if src in (np.float64, torch.float64):
        return torch.float64
    if src in (np.float32, torch.float32):
        return torch.float32
    if isinstance(src, torch.dtype):
        ok = not (src.is_complex or src == torch.bool)
    else:
        ok = (np.issubdtype(src, np.floating)
              or np.issubdtype(src, np.integer))
    if ok:
        return torch.float32
    raise TypeError(f"Unsupported dtype {src}; expected float32 or float64")


def _to_tensor(x, ndim: int, dtype: torch.dtype | None,
               device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    if x.ndim != ndim:
        raise _dim_error(ndim, x.ndim)
    dt = dtype or _resolve_dtype(x.dtype)
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dt).contiguous()
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=device)


def as_matrix(A, *, dtype: torch.dtype | None = None,
              device=None) -> torch.Tensor:
    """Normalize a 2-d array-like to a contiguous tensor on ``device``.

    The dtype is taken from the input (float32 or float64), mirroring how
    the reference binding selects the solver precision from the NumPy dtype
    (binding.cpp:69-86)."""
    return _to_tensor(A, 2, dtype, device)


def as_signal_batch(Y, *, dtype: torch.dtype | None = None,
                    size: int | None = None, device=None) -> torch.Tensor:
    """Normalize a (batch, m) array-like of signals to a tensor."""
    if not isinstance(Y, torch.Tensor):
        Y = np.asarray(Y)
    if Y.ndim != 2:
        raise _dim_error(2, Y.ndim)
    if size is not None and Y.shape[1] != size:
        raise ValueError(
            f"Expected signals of length {size} but got {Y.shape[1]}"
        )
    return _to_tensor(Y, 2, dtype, device)


def as_vector(x, *, dtype: torch.dtype | None = None,
              size: int | None = None, device=None) -> torch.Tensor:
    """Normalize a 1-d array-like to a tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    if x.ndim != 1:
        raise _dim_error(1, x.ndim)
    if size is not None and x.shape[0] != size:
        raise ValueError(
            f"Expected a vector of length {size} but got {x.shape[0]}")
    return _to_tensor(x, 1, dtype, device)
