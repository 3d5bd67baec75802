"""Sensing-matrix operators — the port of ``sparse_solvers_tpu/ops/
operators.py::DenseOperator``, the seam between the homotopy core's math
and the matrix.

The core touches A only through these products (reference call stack:
src/solvers/homotopy-cpu.cpp): matvec p = A d, rmatvec c = Aᵀ r, column
v = A e_j and the Gram column g = AᵀA e_j with vᵀv. Each takes a leading
lane axis, as the vmapped JAX core sees them: every n- or m-vector is
(b, n) or (b, m), every column index (b,), every slot vector (b, K). The
shared A then multiplies all lanes in one product (``xgemm`` with the
lanes as rows). Sentinel slots (index n) gather zeros through
``active_set.take``, never an out-of-range index.

The row-sharded operators come with multi-GPU solving (ROADMAP.md Queue 1
item 10).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..linalg import active_set
from . import blas


class DenseOperator(NamedTuple):
    """Plain dense sensing matrix A (m, n) on one device; ``G`` optionally
    carries the precomputed Gram matrix AᵀA (n, n), which turns every
    insert and the sparse q = AᵀA·d into O(n·k) gathers."""
    A: torch.Tensor
    G: torch.Tensor | None = None

    @property
    def shape(self):
        return self.A.shape

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def has_gram(self):
        return self.G is not None

    def matvec(self, x):
        """A x per lane: x (b, n) → (b, m)."""
        return blas.xgemm(x, self.A, trans_b=True)

    def _gather_cols(self, M, indices):
        """M[:, indices] per lane → (b, rows, K), zero in sentinel slots."""
        n = self.A.shape[1]
        cols = M[:, indices.clamp(0, n - 1).long()].permute(1, 0, 2)
        return torch.where((indices < n).unsqueeze(1), cols,
                           torch.zeros_like(cols))

    def matvec_sparse(self, x, indices, vals=None):
        """A x for x supported on ``indices`` (b, K): an (m, K) column
        gather and a small product per lane instead of a full pass over
        A. ``vals`` (slot-ordered x[indices]) skips the dense gather."""
        if vals is None:
            vals = active_set.take(x, indices, self.A.shape[1])
        return blas.xgemv(self._gather_cols(self.A, indices), vals)

    def rmatvec(self, u):
        """Aᵀ u per lane: u (b, m) → (b, n)."""
        return blas.xgemm(u, self.A)

    def column(self, j):
        """A e_j per lane: j (b,) → (b, m)."""
        return self.A[:, j.long()].T

    def gram_column(self, j):
        """((AᵀA)[:, j] (b, n), ‖A e_j‖² (b,))."""
        if self.G is not None:
            jl = j.long()
            return self.G[:, jl].T, self.G[jl, jl]
        v = self.column(j)
        return self.rmatvec(v), blas.xdot(v, v)

    def gram_matvec_sparse(self, d, indices, vals=None):
        """q = AᵀA d for d supported on ``indices`` via Gram-column gather
        — O(n·k) bytes, no pass over A. Requires ``G``."""
        if vals is None:
            vals = active_set.take(d, indices, self.A.shape[1])
        return blas.xgemv(self._gather_cols(self.G, indices), vals)

    def gram_gathered(self, col, slots):
        """(u1 (b, K), vtv (b,)) with u1[i] = (AᵀA)[slots[i], col]
        (sentinel slots → 0) and vtv = (AᵀA)[col, col]: one row of G (G is
        symmetric) and a K-element gather from it, or without G one Gram
        column product and the same gather."""
        n = self.A.shape[1]
        if self.G is not None:
            row = self.G[col.long()]
            return (active_set.take(row, slots, n),
                    row.gather(1, col.long()[:, None])[:, 0])
        g, vtv = self.gram_column(col)
        return active_set.take(g, slots, n), vtv

    def mdot(self, u, v):
        """Inner product of two m-vectors per lane."""
        return blas.xdot(u, v)
