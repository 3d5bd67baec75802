"""IRLS ℓ₁-minimization — the port of ``sparse_solvers_tpu/solvers/irls.py``:
Chartrand–Yin reweighting (p = 0.9) over the economy QR of A, computed once
per sensing matrix and reused across solves (the reference computes it in
the solver constructor, src/lib.cpp:51-57).

Parity target, as in the JAX package: reference src/solvers/irls-cpu.cpp:
39-124 — the Cholesky Newton step with a graceful ``spd_failure``
(:39-60, :95-97), the relative threshold abstol = max(x)·tol (:100-103),
eps from the second-largest raw value (:107-110), sum-normalized weights
(x² + eps)^(p/2−1) (:113-114), the do-while ``iter < max_iter && x₂ >
abstol`` (:118), the final x /= Σx (:121) and eps as the reported error
(:123).

The loop carries a leading lane axis, as the port's other cores do
(``solvers/omp.py``): a single solve is one lane, and b signals are b
lanes stepped together, standing in for ``jax.vmap`` of the JAX loop. The
loop runs while any lane's do-while condition holds; every state write
goes through ``torch.where`` on the lane's own live flag, and ``lax.cond``
on the spd flag becomes a select, as under vmap. R is shared by the
lanes, so the fast step's back-substitution is one triangular solve
against the lanes' right-hand sides as the columns of one (n, b) block.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..linalg.cholesky import cholesky_solve, cholesky_spd
from ..ops import blas
from ..ops.operators import DenseOperator
from . import loops
from .loops import _select


class IrlsReportArrays(NamedTuple):
    """Per-lane report tensors — mirrors ss::irls_report (reference:
    include/ss/policies.h:58-71)."""
    iter: torch.Tensor            # (b,) int32 (uint32 in the JAX package)
    solution_error: torch.Tensor  # (b,) final eps (irls-cpu.cpp:123)
    spd_failure: torch.Tensor     # (b,) bool


class _LoopState(NamedTuple):
    it: torch.Tensor       # (b,) int32
    started: torch.Tensor  # (b,) bool
    x: torch.Tensor        # (b, n)
    w: torch.Tensor        # (b, n)
    eps: torch.Tensor      # (b,)
    abstol: torch.Tensor   # (b,)
    x2: torch.Tensor       # (b,)
    spd: torch.Tensor      # (b,) bool
    broke: torch.Tensor    # (b,) bool


def _back_substitute(R: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """R⁻¹ v per lane for the shared upper-triangular R: the lanes' rows
    of V (b, n) are the columns of one triangular solve."""
    return blas.xtrsm(R, V.T, lower=False).T


def _newton(qop, R, qty, w):
    """One weighted least-squares Newton step per lane (irls-cpu.cpp:
    39-60): G = Qᵀ(Q∘w), s = G⁻¹Qᵀy by Cholesky, x = R⁻¹Qᵀ(Q s).
    ``qty`` is Qᵀy (b, n). Returns (x (b, n), isspd (b,))."""
    L, isspd = cholesky_spd(qop.gram_weighted(w))
    s = cholesky_solve(L, qty)
    xn = qop.rmatvec(qop.matvec(s))
    return _back_substitute(R, xn), isspd


def _newton_fast(R, rhs, w, dtype, r_inv=None):
    """The Newton step collapsed by QᵀQ = I (solvers/irls.py:_newton_fast
    in the JAX package): x = R⁻¹(rhs/w) with rhs = Qᵀy, and the spd
    failure is a Cholesky pivot of diag(w) at machine eps, min(w) ≤ eps².

    ``r_inv`` applies the cached R⁻¹ as one (b, n)×(n, n) product instead
    of the back-substitution, always at "highest": the solve it replaces
    has no precision level, so a "default" instance must not degrade its
    Newton step to a bf16 product."""
    eps = torch.finfo(dtype).eps
    isspd = w.amin(dim=-1) > eps * eps
    v = rhs / w
    if r_inv is not None:
        with blas.precision_scope("highest"):
            return blas.xgemm(v, r_inv, trans_b=True), isspd
    return _back_substitute(R, v), isspd


def solve_irls(Q: torch.Tensor, R: torch.Tensor, Y: torch.Tensor, tolerance,
               max_iterations: int, *, mode: str = "fast", r_inv=None,
               stabilized: bool = False):
    """IRLS from the economy QR of A for signals Y (b, m), one lane each;
    returns (X (b, n), IrlsReportArrays)."""
    return solve_irls_core(DenseOperator(Q), R, Y, tolerance, max_iterations,
                           mode=mode, r_inv=r_inv, stabilized=stabilized)


def solve_irls_core(qop, R: torch.Tensor, Y: torch.Tensor, tolerance,
                    max_iterations: int, *, mode: str = "fast", r_inv=None,
                    stabilized: bool = False):
    """The IRLS loop over a Q operator (``ops/operators.py``), per lane.

    mode="fast" takes the collapsed Newton step (one Qᵀy per solve, one
    triangular solve per iteration); mode="exact" the reference's dense
    gemm + Cholesky step. ``r_inv`` (fast only) applies a precomputed R⁻¹
    by product. ``stabilized`` divides each Newton iterate by its maximum
    before the threshold, eps and weight updates, which makes the
    recurrence scale-free (solve_irls_core in the JAX package explains
    why the reference recurrence is not).
    """
    if mode not in ("fast", "exact"):
        raise ValueError(f"mode must be 'fast' or 'exact', got {mode!r}")
    if r_inv is not None and mode != "fast":
        raise ValueError("r_inv is a fast-mode option")
    n = R.shape[0]
    dtype = qop.dtype
    b, dev = Y.shape[0], Y.device
    tol = torch.as_tensor(tolerance, dtype=dtype, device=dev)
    p = 0.9  # reweighting exponent (irls-cpu.cpp:70)
    rhs = qop.rmatvec(Y)  # Qᵀy, loop-invariant

    def full(value, dt=dtype, shape=(b,)):
        return torch.full(shape, value, dtype=dt, device=dev)

    false = full(False, torch.bool)
    state = _LoopState(
        it=full(0, torch.int32), started=false, x=full(0, shape=(b, n)),
        w=full(1, shape=(b, n)), eps=full(1), abstol=full(1), x2=full(1),
        spd=false, broke=false)

    def cond(s: _LoopState) -> torch.Tensor:
        # do-while (irls-cpu.cpp:92-118)
        return ~s.started | (~s.broke & (s.it < max_iterations)
                             & (s.x2 > s.abstol))

    def body(s: _LoopState) -> _LoopState:
        if mode == "fast":
            xn, isspd = _newton_fast(R, rhs, s.w, dtype, r_inv=r_inv)
        else:
            xn, isspd = _newton(qop, R, rhs, s.w)
        if stabilized:
            # scale-free iterate, guarded against an all-nonpositive solve
            mx = xn.amax(dim=-1, keepdim=True)
            xn = torch.where(mx > 0, xn / mx, xn)
        abstol = xn.amax(dim=-1) * tol                                # :100
        xt = torch.where(xn < abstol[:, None], torch.zeros_like(xn), xn)  # :103
        x2 = torch.topk(xt, 2, dim=-1).values[:, 1]          # :107, raw values
        eps = torch.minimum(s.eps, x2 / n)                            # :110
        w = torch.pow(xt * xt + eps[:, None], p / 2.0 - 1.0)          # :113
        w = w / w.sum(dim=-1, keepdim=True)                           # :114
        true = ~false
        committed = _LoopState(it=s.it + 1, started=true, x=xt, w=w,
                               eps=eps, abstol=abstol, x2=x2, spd=false,
                               broke=false)
        # an spd failure breaks before committing x; iter unchanged
        # (irls-cpu.cpp:94-97)
        failed = s._replace(started=true, spd=true, broke=true)
        return _select(isspd, committed, failed)

    state = loops.synced_while(*loops.lanes(body, cond, state))[0]

    X = state.x / state.x.sum(dim=-1, keepdim=True)  # irls-cpu.cpp:121
    return X, IrlsReportArrays(iter=state.it, solution_error=state.eps,
                               spd_failure=state.spd)
