"""Sensing-matrix operators — the port of ``sparse_solvers_tpu/ops/
operators.py::DenseOperator``, the seam between the homotopy core's math
and the matrix.

The core touches A only through these products (reference call stack:
src/solvers/homotopy-cpu.cpp): matvec p = A d, rmatvec c = Aᵀ r, column
v = A e_j and the Gram column g = AᵀA e_j with vᵀv. The IRLS core holds
Q in the same operator and adds the weighted Gram Qᵀ(Q∘w). Each takes a leading
lane axis, as the vmapped JAX core sees them: every n- or m-vector is
(b, n) or (b, m), every column index (b,), every slot vector (b, K). The
shared A then multiplies all lanes in one product (``xgemm`` with the
lanes as rows). Sentinel slots (index n) gather zeros through
``active_set.take``, never an out-of-range index.

The sharded operators are the JAX package's ``RowShardedOperator`` and
``ColShardedOperator`` over a process group of a mesh
(``parallel/sharding.py``): each rank holds its shard of A, and every
product that reduces over the sharded axis ends in one all-reduce over
the group (``ops/collectives.py``), JAX's ``psum``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..linalg import active_set
from . import blas, collectives


class DenseOperator(NamedTuple):
    """Plain dense sensing matrix A (m, n) on one device; ``G`` optionally
    carries the precomputed Gram matrix AᵀA (n, n), which turns every
    insert and the sparse q = AᵀA·d into O(n·k) gathers.

    ``AT`` optionally carries the bf16 transposed copy of A (n + 1, m),
    zero in row n (``homotopy_batch.transposed_copy``). In the "default"
    scope every product over A reads it: the bf16 values ``blas._operands``
    would round A to, with fp32 accumulation, so A is never rounded again
    per product. In any other scope, or without it, A is read."""
    A: torch.Tensor
    G: torch.Tensor | None = None
    AT: torch.Tensor | None = None

    @property
    def shape(self):
        return self.A.shape

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def has_gram(self):
        return self.G is not None

    def _copy(self) -> torch.Tensor | None:
        """The bf16 copy where the scope reads it ("default"), else None."""
        if self.AT is None or blas.current_precision() != "default":
            return None
        return self.AT

    def matvec(self, x):
        """A x per lane: x (b, n) → (b, m)."""
        AT = self._copy()
        if AT is not None:
            return blas.bf16_mm(x.to(torch.bfloat16), AT[:self.A.shape[1]])
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
        AT = self._copy()
        if AT is not None:
            # the copy's rows, row n zero for sentinel slots: (b, K, m)
            return blas.xgemv(AT[indices.long()].float(), vals, trans=True)
        return blas.xgemv(self._gather_cols(self.A, indices), vals)

    def rmatvec(self, u):
        """Aᵀ u per lane: u (b, m) → (b, n)."""
        AT = self._copy()
        if AT is not None:
            return blas.bf16_mm(u.to(torch.bfloat16),
                                AT[:self.A.shape[1]].mT)
        return blas.xgemm(u, self.A)

    def column(self, j):
        """A e_j per lane: j (b,) → (b, m); from the copy, the bf16 values
        every product in the scope multiplies it as."""
        AT = self._copy()
        if AT is not None:
            return AT[j.long()].float()
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

    def gram_weighted(self, w):
        """Aᵀ(A ∘ w), the IRLS Newton Gram (irls-cpu.cpp:47-48), at the
        scope's precision: w (b, n) scales A's columns per lane and gives
        (b, n, n); a (n,) w gives one (n, n)."""
        return blas.xgemm(self.A, self.A * w.unsqueeze(-2), trans_a=True)

    def mdot(self, u, v):
        """Inner product of two m-vectors per lane."""
        return blas.xdot(u, v)


class ColShardedOperator(NamedTuple):
    """A column shard of A, A_local (m, n_local), on each rank of
    ``group``: the layout of the underdetermined (m ≪ n) regime that
    CG-IRLS serves (solvers/irls_cg.py). x, the weights and Aᵀu stay
    sharded along n; m-sized quantities (y, the CG iterates) are
    replicated, so the only collective is one all-reduce per matvec
    A(D∘Aᵀz), one per CG step."""
    A_local: torch.Tensor
    group: object

    @property
    def dtype(self):
        return self.A_local.dtype

    def matvec(self, x_local):
        """A x per lane: x_local (b, n_local) → (b, m), summed over the
        column shards."""
        return collectives.all_reduce(
            blas.xgemm(x_local, self.A_local, trans_b=True), self.group)

    def rmatvec(self, u):
        """Aᵀ u per lane: u (b, m) → (b, n_local), stays column-sharded."""
        return blas.xgemm(u, self.A_local)


class RowShardedOperator(NamedTuple):
    """A row shard of A, A_local (m_local, n), on each rank of ``group``;
    every reduction over rows ends in one all-reduce over the group.

    The m-sized quantities (p = A d, the residual r) stay sharded: only a
    following rmatvec consumes them, so exactly one collective (the
    n-sized correlation's) runs per product. ``G`` is the replicated AᵀA,
    all-reduced once at construction, which turns the inserts and the
    sparse q = AᵀA·d into local gathers. ``split`` > 1 splits each
    correlation all-reduce into that many column-block all-reduces (the
    JAX package's overlap experiment)."""
    A_local: torch.Tensor
    group: object
    G: torch.Tensor | None = None
    split: int = 1

    @property
    def _local(self) -> DenseOperator:
        return DenseOperator(self.A_local, self.G)

    @property
    def shape(self):
        # the local shape: callers read n = shape[1], which is global
        return self.A_local.shape

    @property
    def dtype(self):
        return self.A_local.dtype

    @property
    def has_gram(self):
        return self.G is not None

    def matvec(self, x):
        """This shard's rows of A x: stays row-sharded."""
        return self._local.matvec(x)

    def matvec_sparse(self, x, indices, vals=None):
        """This shard's rows of A x for x supported on ``indices``."""
        return self._local.matvec_sparse(x, indices, vals)

    def rmatvec(self, u_local):
        """Aᵀ u per lane from this shard's rows u_local (b, m_local): the
        local product and one all-reduce (``split`` of them, one per
        column block)."""
        if self.split <= 1:
            return collectives.all_reduce(self._local.rmatvec(u_local),
                                          self.group)
        n = self.A_local.shape[1]
        step = -(-n // self.split)
        return torch.cat([
            collectives.all_reduce(
                blas.xgemm(u_local, self.A_local[:, i:i + step]), self.group)
            for i in range(0, n, step)], dim=-1)

    def column(self, j):
        """This shard's rows of A e_j per lane."""
        return self._local.column(j)

    def gram_column(self, j):
        """((AᵀA)[:, j], ‖A e_j‖²): from G, or one all-reduced Gram-column
        product and one all-reduced norm."""
        if self.G is not None:
            return self._local.gram_column(j)
        v = self.column(j)
        return (collectives.all_reduce(self._local.rmatvec(v), self.group),
                collectives.all_reduce(blas.xdot(v, v), self.group))

    def gram_matvec_sparse(self, d, indices, vals=None):
        """q = AᵀA d via the replicated Gram's columns: no collective."""
        return self._local.gram_matvec_sparse(d, indices, vals)

    def gram_gathered(self, col, slots):
        """(u1, vtv) as ``DenseOperator.gram_gathered``: a row of G, or
        one all-reduced Gram column without it."""
        if self.G is not None:
            return self._local.gram_gathered(col, slots)
        g, vtv = self.gram_column(col)
        return active_set.take(g, slots, self.A_local.shape[1]), vtv

    def gram_weighted(self, w):
        """Aᵀ(A ∘ w), summed over the row shards."""
        return collectives.all_reduce(self._local.gram_weighted(w),
                                      self.group)

    def mdot(self, u_local, v_local):
        """Inner product of row-sharded m-vectors: local dot and one
        all-reduce."""
        return collectives.all_reduce(blas.xdot(u_local, v_local),
                                      self.group)
