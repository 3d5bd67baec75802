"""Cholesky factorization with SPD detection — the port of
``sparse_solvers_tpu/linalg/cholesky.py``.

The reference records a non-SPD input through a flag instead of an error
(src/linalg/cholesky_decomposition.h:28-113, pivot check at :80-83), and
the IRLS solver degrades to ``spd_failure`` on it (irls-cpu.cpp:50-51,
95-97). The JAX package reads the flag from XLA's factor: NaNs where a
pivot went negative, and the reference's pivot criterion √a_jj ≤ machine
eps. ``torch.linalg.cholesky`` raises instead, so the port factors with
``cholesky_ex(check_errors=False)`` (no host sync on the card) and adds
its ``info`` to the same test, per lane. The input is symmetrized first,
as ``jnp.linalg.cholesky`` does by default; the factor of a failed lane is
whatever the library left and is not used.
"""

from __future__ import annotations

import torch

from ..ops import blas


def cholesky_spd(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (L, isspd) with A ≈ L Lᵀ, L lower-triangular, batched over
    leading axes: A (..., n, n) → L (..., n, n), isspd (...) bool."""
    eps = torch.finfo(A.dtype).eps
    A = (A + A.mT) / 2
    with blas.precision_scope("highest"):
        L, info = torch.linalg.cholesky_ex(A, check_errors=False)
    diag = L.diagonal(dim1=-2, dim2=-1)
    isspd = ((info == 0) & torch.isfinite(L).all(dim=-1).all(dim=-1)
             & (diag > eps).all(dim=-1))
    return L, isspd


def cholesky_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given A = L Lᵀ by two triangular solves, batched over
    leading axes (reference: cholesky_decomposition.h:94-103)."""
    y = blas.xtrsv(L, b, lower=True, trans=False)
    return blas.xtrsv(L, y, lower=True, trans=True)
