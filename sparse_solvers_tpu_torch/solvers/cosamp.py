"""CoSaMP — Compressive Sampling Matching Pursuit (Needell–Tropp 2009), the
port of ``sparse_solvers_tpu/solvers/cosamp.py``. Per round:

    c   = Aᵀr                                   (proxy correlations)
    Ω   = supp(x) ∪ top_{2k} inactive |c|       (≤ 3k candidate columns)
    b|Ω = argmin ‖y − A_Ω b‖₂                   (one LS on ≤ 3k columns)
    x   = b pruned to its k largest entries     (support replacement)
    r   = y − A x

until ‖r‖₂ ≤ tolerance, the round budget is spent, or a round fails.

The JAX package vmaps a ``lax.while_loop`` over lanes; here the lanes are
a tensor axis, as in the port's other cores (``solvers/omp.py``): every
lane runs the body while any lane is live, each state field is then
selected through ``torch.where`` on the lane's live flag, and the loop
reads ``any(live)`` on the host once per round. Inside the body JAX's rule
holds: a round whose residual is not finite or does not fall keeps the
previous support, values and ‖r‖², leaves the round count, and stops the
lane.

Shapes are JAX's: the support is a (b, k) int32 vector with sentinel n,
the union (b, S) with S = k + k2 and k2 = min(2k, n − k, m − k); sentinel
slots gather zero columns whose Gram diagonal is patched to 1, so their LS
coefficients solve to 0. Both selections take ``lax.top_k``'s order:
descending, the lower index first among equal values (one stable
descending sort; ``torch.topk`` promises no order among ties). The union
LS is one batched Cholesky of the symmetrized S×S Gram;
``jnp.linalg.cholesky`` returns NaNs for a Gram that is not positive
definite and the round then fails on a non-finite residual, while
``cholesky_ex`` leaves a finite partial factor, so its ``info`` fails the
round here. The committed residual is carried from the round that
committed it: JAX recomputes it from the same gathered columns and values
with the same product, which gives the same value.

Row-sharded (``axis``, a process group): A and Y are this rank's rows,
and c = Aᵀr, the union Gram BᵀB, the rhs Bᵀy and ‖r‖² each end in one
all-reduce over the group; the selections, the S×S Cholesky and the prune
run replicated on the all-reduced values. ``m_global`` sizes the pool
clamp by the true row count.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import blas, collectives
from ..utils import profiling
from . import loops
from .loops import _select
from .omp import OmpReportArrays


class _CState(NamedTuple):
    it: torch.Tensor     # (b,) int32 committed rounds
    supp: torch.Tensor   # (b, k) int32 support indices, sentinel n
    vals: torch.Tensor   # (b, k) support values
    r: torch.Tensor      # (b, m) residual y − Ax of the committed iterate
    rss: torch.Tensor    # (b,) ‖y − Ax‖² of the committed iterate
    done: torch.Tensor   # (b,) bool — a failed round stopped the lane


def union_capacity(m: int, n: int, k: int) -> int:
    """S = k + k2 with the inactive pool k2 = min(2k, n − k, m − k): the
    union never exceeds the row count, so its LS stays overdetermined or
    square (cosamp.py:85-93)."""
    return k + min(2 * k, n - k, m - k)


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest scores per lane (b, k), in
    ``lax.top_k``'s order: descending, the lower index first among equal
    values."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True)
    return order.indices[:, :k]


def solve_cosamp(A: torch.Tensor, Y: torch.Tensor, k_sparsity: int,
                 tolerance, max_iterations: int = 20,
                 AT: torch.Tensor | None = None, axis=None,
                 m_global: int | None = None):
    """CoSaMP for signals Y (b, m), one lane each, over A (m, n); returns
    (X (b, n), OmpReportArrays) with iter = rounds committed and
    solution_error = √‖y − Ax‖². ``AT`` is A's transpose as a contiguous
    (n, m) tensor, from which the union's columns are gathered as rows
    (made here when not given). Products run at the caller's
    ``blas.precision_scope``. ``axis`` (a process group) runs the rounds
    row-sharded, with ``m_global`` (required then) the unsharded row
    count."""
    m_local, n = A.shape
    m = m_local
    if axis is not None:
        if m_global is None:
            raise ValueError("axis requires m_global (the unsharded "
                             "row count, for the pool clamp)")
        m = m_global
    k = int(k_sparsity)
    if k < 1:
        raise ValueError(f"k_sparsity must be >= 1, got {k_sparsity}")
    if k >= min(m, n):
        raise ValueError(
            f"k_sparsity must be < min(m, n) = {min(m, n)} (the round "
            f"needs a nonempty inactive pool and an overdetermined union "
            f"LS), got {k}")
    if AT is None:
        AT = A.T.contiguous()
    dtype, dev, b = A.dtype, Y.device, Y.shape[0]
    S = union_capacity(m, n, k)
    k2 = S - k
    # the loop's comparisons with tol² happen in the working dtype
    tol_t = torch.tensor(float(tolerance), dtype=dtype)
    tol2 = float(tol_t * tol_t)
    psum = ((lambda v: collectives.all_reduce(v, axis)) if axis is not None
            else (lambda v: v))

    state = _CState(
        it=torch.zeros(b, dtype=torch.int32, device=dev),
        supp=torch.full((b, k), n, dtype=torch.int32, device=dev),
        vals=torch.zeros((b, k), dtype=dtype, device=dev),
        r=Y, rss=psum(blas.xdot(Y, Y)),
        done=torch.zeros(b, dtype=torch.bool, device=dev))

    def body(s: _CState) -> _CState:
        c = psum(blas.xgemm(s.r, A))                    # (b, n): (Aᵀr)ᵀ
        # the 2k largest inactive |c|; the active mask is a scatter whose
        # sentinel slots land in a column that is then dropped, never
        # clamped onto column n − 1
        active = torch.zeros((b, n + 1), dtype=torch.bool, device=dev)
        active.scatter_(1, s.supp.long(), True)
        scores = c.abs().masked_fill(active[:, :n], -1)
        top = top_k_indices(scores, k2).to(torch.int32)
        omega = torch.cat([s.supp, top], dim=1)         # (b, S)
        valid = omega < n
        # Bᵀ (b, S, m): the union's columns as rows of AT, zero at
        # sentinel slots
        Bt = AT.index_select(0, omega.clamp(max=n - 1).reshape(-1).long())
        Bt = Bt.view(b, S, m_local).masked_fill_(~valid.unsqueeze(-1), 0)
        profiling.count("cosamp.union_bytes", Bt.numel() * Bt.element_size())
        G = psum(blas.xgemm(Bt, Bt, trans_b=True))      # (b, S, S)
        # sentinel diagonal → 1: exact (zero rows/cols elsewhere, rhs 0)
        G.diagonal(dim1=-2, dim2=-1).add_((~valid).to(dtype))
        rhs = psum(blas.xgemv(Bt, Y))                   # (b, S): Bᵀy
        with blas.precision_scope("highest"):
            L, info = torch.linalg.cholesky_ex((G + G.mT) / 2,
                                               check_errors=False)
        coef = blas.xtrsv(L, blas.xtrsv(L, rhs, lower=True), lower=True,
                          trans=True)

        # prune to the k largest |b|
        pos = top_k_indices(coef.abs(), k)             # (b, k)
        supp2 = omega.gather(1, pos)
        vals2 = coef.gather(1, pos)
        Bp = Bt.gather(1, pos.unsqueeze(-1).expand(b, k, m_local))
        r2 = Y - blas.xgemv(Bp, vals2, trans=True)
        rss2 = psum(blas.xdot(r2, r2))

        # a failed factor, a non-finite or a non-decreasing residual:
        # the previous iterate stands and the lane stops
        ok = (info == 0) & torch.isfinite(rss2) & (rss2 < s.rss)
        new = _CState(it=s.it + ok.to(torch.int32), supp=supp2,
                      vals=vals2, r=r2, rss=rss2, done=~ok)
        return _select(ok, new, s)._replace(it=new.it, done=new.done)

    def cond(s: _CState) -> torch.Tensor:
        return ~s.done & (s.it < max_iterations) & (s.rss > tol2)

    state = loops.synced_while(*loops.lanes(body, cond, state))[0]

    X = torch.zeros((b, n + 1), dtype=dtype, device=dev)
    X.scatter_(1, state.supp.long(), state.vals)
    err = torch.sqrt(state.rss.clamp(min=0))
    return X[:, :n].contiguous(), OmpReportArrays(iter=state.it,
                                                  solution_error=err)
