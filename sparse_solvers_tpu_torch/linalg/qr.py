"""Householder QR factorization (economy) — the port of
``sparse_solvers_tpu/linalg/qr.py``, the explicit-reflector component.

The reference's LINPACK-style QR (src/linalg/qr_decomposition.h:32-227):
Q is held implicitly as Householder vectors in the lower trapezoid of
``packed`` (diagonal included), R's strict upper triangle sits above it,
and R's diagonal lives in ``rdiag`` (= −σ_k). Each reflector is applied
with masked full-width tensor ops, as the JAX package's ``fori_loop`` body
applies it; here the column loop is a Python loop over the n columns.

The IRLS hot path factors with the library's blocked QR
(``torch.linalg.qr``, in ``api.Irls``); this module gives ``q()``/``r()``/
``solve()`` parity with the reference (qr_decomposition.h:140-227).
"""

from __future__ import annotations

import torch

from ..ops import blas


def _nonzero_or_one(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t == 0, torch.ones_like(t), t)


def householder_factor(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Factor an m×n (m ≥ n) matrix; returns (packed, rdiag).

    Reference: qr_decomposition.h constructor (:94-137)."""
    M, N = A.shape
    QR = A.clone()
    rdiag = torch.zeros(N, dtype=A.dtype, device=A.device)
    rows = torch.arange(M, device=A.device)
    cols = torch.arange(N, device=A.device)
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    for k in range(N):
        rowmask = rows >= k
        x = torch.where(rowmask, QR[:, k], zero)
        nrm = torch.sqrt((x * x).sum())
        sigma = torch.where(QR[k, k] < 0, -nrm, nrm)  # :113
        safe = nrm != 0
        v = torch.where(safe, x / _nonzero_or_one(sigma), zero)
        v[k] = v[k] + torch.where(safe, 1.0, 0.0).to(A.dtype)
        # apply the reflector to the columns j > k:
        # s = −(vᵀ QR)/v_k ; QR += v sᵀ  (:119-132)
        s = -blas.xgemv(QR, v, trans=True) / _nonzero_or_one(v[k])
        colmask = (cols > k) & safe
        QR = QR + torch.outer(v, torch.where(colmask, s, zero))
        # pack the reflector into column k (rows ≥ k); untouched if unsafe
        QR[:, k] = torch.where(rowmask & safe, v, QR[:, k])
        rdiag[k] = -sigma
    return QR, rdiag


def q(packed: torch.Tensor, rdiag: torch.Tensor) -> torch.Tensor:
    """Materialize the m×n economy Q. Reference: qr_decomposition.h:140-173."""
    M, N = packed.shape
    rows = torch.arange(M, device=packed.device)
    cols = torch.arange(N, device=packed.device)
    zero = torch.zeros((), dtype=packed.dtype, device=packed.device)
    Q = torch.zeros((M, N), dtype=packed.dtype, device=packed.device)
    for k in range(N - 1, -1, -1):
        v = torch.where(rows >= k, packed[:, k], zero)
        Q[:, k] = (rows == k).to(packed.dtype)  # e_k
        live = v[k] != 0
        s = -blas.xgemv(Q, v, trans=True) / _nonzero_or_one(v[k])
        colmask = (cols >= k) & live
        Q = Q + torch.outer(v, torch.where(colmask, s, zero))
    return Q


def r(packed: torch.Tensor, rdiag: torch.Tensor) -> torch.Tensor:
    """Materialize the n×n R. Reference: qr_decomposition.h:176-190."""
    N = packed.shape[1]
    return torch.triu(packed[:N, :N], 1) + torch.diag(rdiag)


def solve(packed: torch.Tensor, rdiag: torch.Tensor,
          b: torch.Tensor) -> torch.Tensor:
    """Least-squares solve min‖Ax − b‖₂ from the packed factorization.

    Reference: qr_decomposition.h:193-227 (implicit Qᵀb, then
    back-substitution against R)."""
    M, N = packed.shape
    rows = torch.arange(M, device=packed.device)
    zero = torch.zeros((), dtype=packed.dtype, device=packed.device)
    s = b.to(packed.dtype)
    for k in range(N):
        v = torch.where(rows >= k, packed[:, k], zero)
        w = -blas.xdot(v, s) / _nonzero_or_one(v[k])
        s = s + torch.where(v[k] == 0, zero, w) * v
    return blas.xtrsv(r(packed, rdiag), s[:N], lower=False)


class QRDecomposition:
    """Construct-once QR over a matrix on a device, the reference's
    amortized-state shape (src/lib.cpp:51-57)."""

    def __init__(self, A: torch.Tensor):
        M, N = A.shape
        if M < N:
            raise ValueError(
                "QR requires m >= n (underdetermined systems not supported); "
                f"got {M}x{N}"
            )
        self.packed, self.rdiag = householder_factor(A)

    def q(self) -> torch.Tensor:
        return q(self.packed, self.rdiag)

    def r(self) -> torch.Tensor:
        return r(self.packed, self.rdiag)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        return solve(self.packed, self.rdiag, b)
