"""Orthogonal Matching Pursuit — the port of ``sparse_solvers_tpu/solvers/
omp.py``: the per-lane greedy core and its report type.

Each round adds the column most correlated with the residual (the
``picks`` largest, for gOMP) and re-solves least squares on the grown
support, Γ ← Γ ∪ {argmaxⱼ |aⱼᵀr|}, x_Γ = (A_ΓᵀA_Γ)⁻¹A_Γᵀy, until
‖r‖₂ ≤ tolerance or the support budget is spent. The inverse is kept by
``linalg/online_inverse.py``; A_Γᵀy is a gather of c₀ = Aᵀy, computed once.

The core carries a leading lane axis, as the Homotopy core does
(``solvers/homotopy.py``): a single solve is one lane, and a batch of b
signals is b lanes stepped together, standing in for ``jax.vmap`` of the
JAX core. Every lane runs the body while any lane is live; a lane whose
condition is false keeps every field through ``torch.where``; the loop
reads ``any(live)`` on the host once per round.

Two modes, as in the JAX package: ``"fast"`` keeps the inverse in
insertion order and takes the insert's column from the Gram
(``DenseOperator.gram_gathered``), and ``"exact"`` keeps it in rank order,
recomputes the Gram column at full length and forms the residual
literally. ``corr`` picks the fast correlation update: Gram-column gathers
("gram"), an (m, K) column gather and one Aᵀ pass ("sparse"), or the dense
scatter and two full products ("dense").
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..linalg import active_set
from ..linalg import online_inverse as oinv
from ..ops import blas
from . import loops
from .loops import _select


class OmpReportArrays(NamedTuple):
    """Per-lane report tensors: iterations = support size reached,
    solution_error = final residual ℓ₂ norm ‖y − Ax‖₂."""
    iter: torch.Tensor            # (b,) int32 (uint32 in the JAX package)
    solution_error: torch.Tensor  # (b,) ‖r‖₂


class _LoopState(NamedTuple):
    it: torch.Tensor       # (b,) int32
    c: torch.Tensor        # (b, n) residual correlations Aᵀr
    inv: oinv.InverseState
    coef: torch.Tensor     # (b, K) LS coefficients in slot order
    rss: torch.Tensor      # (b,) ‖r‖²
    broke: torch.Tensor    # (b,) degenerate round — stop, solution intact
    done: torch.Tensor     # (b,) rss stalled — stop, iterate kept


def top_picks(scores: torch.Tensor, picks: int):
    """The ``picks`` largest scores per lane in ``lax.top_k``'s order:
    descending, and the lower index first among equal values (``torch.topk``
    promises no order for ties). Iterated first-occurrence argmax, each
    pick then set to -inf so that no index repeats. Returns (values,
    indices), each (b, picks)."""
    sc = scores.clone()
    vals, idxs = [], []
    for _ in range(picks):
        idx = torch.argmax(sc, dim=-1)
        vals.append(sc.gather(-1, idx.unsqueeze(-1)).squeeze(-1))
        idxs.append(idx)
        sc.scatter_(-1, idx.unsqueeze(-1), float("-inf"))
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


def solve_omp_core(op, n: int, Y: torch.Tensor, tolerance,
                   max_iterations: int, k_max: int | None = None, *,
                   mode: str = "fast", corr: str | None = None,
                   picks: int = 1):
    """OMP over a sensing operator (``ops/operators.py``) for signals Y (b,
    m), one lane each; returns (X (b, n), OmpReportArrays).

    ``k_max`` caps the support (default min(max_iterations, m, n); OMP only
    inserts, so that never overflows). ``tolerance`` is the absolute
    residual target ‖r‖₂. ``corr`` ("gram", "sparse", "dense"; default
    "gram" when ``op`` holds a Gram, else "sparse") selects the fast
    correlation update; the insert takes the Gram whenever ``op`` has one.
    ``picks`` > 1 runs gOMP rounds: the ``picks`` largest inactive
    correlations (``top_picks``) with a strictly positive score, inserted
    one by one so each sees the grown support, then one LS re-solve and one
    correlation update; degenerate sub-inserts are skipped, and a round
    that commits nothing breaks with the previous iterate intact.
    ``max_iterations`` is the column budget (iter = support size)."""
    if picks < 1:
        raise ValueError(f"picks must be >= 1, got {picks}")
    if mode not in ("fast", "exact"):
        raise ValueError(f"mode must be 'fast' or 'exact', got {mode!r}")
    fast = mode == "fast"
    if corr is None:
        corr = "gram" if op.has_gram else "sparse"
    if corr not in ("gram", "sparse", "dense"):
        raise ValueError(
            f"corr must be 'gram', 'sparse' or 'dense', got {corr!r}")
    if corr == "gram" and not op.has_gram:
        corr = "sparse"
    corr_gram = fast and corr == "gram"
    dtype = op.dtype
    m = op.shape[0]
    if k_max is None:
        k_max = max(1, min(max_iterations, m, n))
    b = Y.shape[0]
    dev = Y.device
    # every comparison with tol and tol² happens in the working dtype
    tol_t = torch.tensor(float(tolerance), dtype=dtype)
    tol2 = float(tol_t * tol_t)
    tiny = 256 * torch.finfo(dtype).tiny

    # one-time products: every A_Γᵀy the LS solves need is a gather of c0
    c0 = op.rmatvec(Y)
    yty = op.mdot(Y, Y)
    false = torch.zeros(b, dtype=torch.bool, device=dev)
    state = _LoopState(
        it=torch.zeros(b, dtype=torch.int32, device=dev), c=c0,
        inv=oinv.init(k_max, n, dtype, b, dev),
        coef=torch.zeros((b, k_max), dtype=dtype, device=dev), rss=yty,
        broke=false, done=false)

    def try_insert(inv: oinv.InverseState, idx, eligible):
        """One guarded bordered insert per lane: (inv', committed)."""
        if fast:
            u1, vtv = op.gram_gathered(idx, inv.indices)
            uslot = u1
        else:
            u1, vtv = op.gram_column(idx)
            uslot = active_set.take(u1, inv.indices, n)
        # a rank-deficient pick makes the Schur complement rounding noise
        # and the bordered inverse infinite: skip it
        den = vtv - blas.xdot(uslot, blas.xgemv(inv.inv, uslot))
        ok = eligible & (den.abs() > tiny)
        u1_safe = torch.where(ok.unsqueeze(-1), u1, torch.zeros_like(u1))
        vtv_safe = torch.where(ok, vtv, torch.ones_like(vtv))
        ins = oinv.insert_unordered if fast else oinv.insert
        return _select(ok, ins(inv, idx, u1_safe, vtv_safe), inv), ok

    def body(s: _LoopState) -> _LoopState:
        scores = torch.where(s.inv.mask, torch.full_like(s.c, -1),
                             s.c.abs())
        if picks == 1:
            # the leftmost argmax over the inactive set (|c| ≥ 0 > −1)
            idx = torch.argmax(scores, dim=-1)
            inv1, ok = try_insert(s.inv, idx, torch.ones_like(false))
            ncommit = ok.to(torch.int32)
            broke = ~ok
        else:
            vals, idxs = top_picks(scores, picks)
            inv1 = s.inv
            ncommit = torch.zeros(b, dtype=torch.int32, device=dev)
            for j in range(picks):
                eligible = ((vals[:, j] > 0)
                            & (s.it + ncommit < max_iterations)
                            & (inv1.k < k_max))
                inv1, ok = try_insert(inv1, idxs[:, j], eligible)
                ncommit = ncommit + ok.to(torch.int32)
            broke = ncommit == 0
        it = s.it + ncommit

        # LS re-solve on the grown support: b_Γ = c0[Γ], coef = B·b_Γ
        b_act = active_set.take(c0, inv1.indices, n)
        coef1 = blas.xgemv(inv1.inv, b_act)

        # correlations and ‖r‖² recomputed from the new coefficients; only
        # the Gram form, which never forms the m-vector, uses the identity
        # ‖r‖² = ‖y‖² − b_Γᵀx_Γ (its cancellation floor is ~eps·‖y‖²)
        if corr_gram:
            c1 = c0 - op.gram_matvec_sparse(None, inv1.indices, vals=coef1)
            rss1 = yty - blas.xdot(b_act, coef1)
        else:
            if fast and corr == "sparse":
                ax = op.matvec_sparse(None, inv1.indices, vals=coef1)
            else:  # "dense", and exact mode's literal products
                ax = op.matvec(active_set.scatter(coef1, inv1.indices, n))
            resid = Y - ax
            c1 = op.rmatvec(resid)
            rss1 = op.mdot(resid, resid)

        # a broken lane keeps its previous state wholesale
        keep = ~broke
        rss_out = torch.where(keep, rss1, s.rss)
        return _LoopState(
            it=it, c=_select(keep, c1, s.c), inv=_select(keep, inv1, s.inv),
            coef=_select(keep, coef1, s.coef), rss=rss_out, broke=broke,
            # ‖r‖² falls strictly in exact arithmetic: a non-decrease is
            # the rounding floor of the rss form in use — stop, iterate kept
            done=rss_out >= s.rss)

    def cond(s: _LoopState) -> torch.Tensor:
        return (~s.broke & ~s.done & (s.it < max_iterations)
                & (s.inv.k < k_max) & (s.rss.clamp(min=0) > tol2))

    state = loops.synced_while(*loops.lanes(body, cond, state))[0]

    X = active_set.scatter(state.coef, state.inv.indices, n)
    if corr_gram:
        # the identity's rss saturates at its floor long before the true
        # residual does: report the real one, from one column-gather matvec
        resid = Y - op.matvec_sparse(None, state.inv.indices,
                                     vals=state.coef)
        err = torch.sqrt(op.mdot(resid, resid))
    else:
        err = torch.sqrt(state.rss.clamp(min=0))
    return X, OmpReportArrays(iter=state.it, solution_error=err)

