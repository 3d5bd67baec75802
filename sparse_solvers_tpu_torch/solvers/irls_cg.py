"""CG-accelerated IRLS — the port of ``sparse_solvers_tpu/solvers/
irls_cg.py``: factorization-free basis pursuit for the m ≤ n regime.

The Daubechies–DeVore–Fornasier–Güntürk IRLS for min ‖x‖₁ s.t. Ax = y,
its weighted least-norm step solved by conjugate gradients (Fornasier,
Peter, Rauhut, Worm, arXiv:1509.04063):

    D_i = (x_i² + ε²)^(1 − p/2)                  (inverse weights)
    solve (A D Aᵀ) z = y by CG (warm-started)     ← all the work
    x ← D ∘ (Aᵀ z)                                (weighted least norm)
    ε ← min(ε, r_{K+1}(x) / n)                    (K+1-th largest |x|)

until the relative sup-norm change of x falls below ``tolerance`` or
``max_iterations`` outer steps. A touches the iteration only through
matvec/rmatvec, so no QR or Gram is ever formed. Reports carry the
reference IRLS fields: ``solution_error`` is the final ε and
``spd_failure`` flags an inner-CG curvature breakdown.

Both loops carry a leading lane axis, standing in for ``jax.vmap`` of the
JAX loops: the inner CG runs while any lane's own CG condition holds and
freezes each lane, its step count included, on that condition; the outer
loop gates every write on its live flag. A lane whose outer loop has
ended skips the inner CG, whose result it would discard. One CG step
applies B = A D Aᵀ to all lanes as two products, (D ∘ (V A)) Aᵀ, each of
which streams A once.

Column-sharded (``n_axis``, a process group): each rank holds A's columns
n_local and x's entries there; m-sized iterates are replicated, so the CG
dot products stay local; ``matvec`` all-reduces A·(D∘Aᵀz) (one all-reduce
a CG step), and each outer step all-reduces (MAX) the change's two
maxima and all-gathers each rank's top K+1 of |x| for the ε rule.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import blas, collectives
from . import loops
from .irls import IrlsReportArrays


class _CgState(NamedTuple):
    it: torch.Tensor     # (b,) int32
    z: torch.Tensor      # (b, m)
    r: torch.Tensor      # (b, m)
    p: torch.Tensor      # (b, m)
    rs: torch.Tensor     # (b,) ⟨r, r⟩
    broke: torch.Tensor  # (b,) curvature breakdown


class _OuterState(NamedTuple):
    it: torch.Tensor       # (b,) int32
    started: torch.Tensor  # (b,) bool
    x: torch.Tensor        # (b, n)
    z: torch.Tensor        # (b, m) CG warm start carried across outer steps
    eps: torch.Tensor      # (b,)
    change: torch.Tensor   # (b,) last relative sup-norm change of x
    broke: torch.Tensor    # (b,) CG breakdown → spd_failure


def _pdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """⟨a, b⟩ per lane as a plain sum — not a blas product, so it has no
    bf16 rounding at "default" (``jnp.sum(a * b)`` in the JAX package)."""
    return (a * b).sum(dim=-1)


def _cg_solve(body_matvec, Y, Z0, cg_tol2, max_cg: int, dtype,
              active=None) -> _CgState:
    """Conjugate gradients for B z = y per lane, warm-started at Z0.

    ``body_matvec(V)`` applies B (SPD) to each lane's row of V (b, m). A
    lane stops when ⟨r,r⟩ ≤ its ``cg_tol2``, after ``max_cg`` steps, or on
    curvature breakdown (pᵀBp ≤ 0 or non-finite). ``active`` (b,) bool
    marks the lanes that step at all; the others keep their initial
    state."""
    r0 = Y - body_matvec(Z0)
    b, dev = Y.shape[0], Y.device
    state = _CgState(it=torch.zeros(b, dtype=torch.int32, device=dev),
                     z=Z0, r=r0, p=r0, rs=_pdot(r0, r0),
                     broke=torch.zeros(b, dtype=torch.bool, device=dev))
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)

    def cond(s: _CgState) -> torch.Tensor:
        live = ~s.broke & (s.it < max_cg) & (s.rs > cg_tol2)
        return live if active is None else live & active

    def body(s: _CgState) -> _CgState:
        Bp = body_matvec(s.p)
        pBp = _pdot(s.p, Bp)
        okc = torch.isfinite(pBp) & (pBp > zero)
        alpha = (s.rs / torch.where(okc, pBp, one))[:, None]
        z = s.z + alpha * s.p
        r = s.r - alpha * Bp
        rs = _pdot(r, r)
        # a positive-subnormal curvature passes the okc gate but makes
        # alpha overflow; the NaN/inf surfaces in rs — the same breakdown
        # (else a NaN rs would leave the loop through a false comparison
        # with broke unset, and the outer step would commit a NaN iterate)
        ok = okc & torch.isfinite(rs)
        okv = ok[:, None]
        z = torch.where(okv, z, s.z)
        r = torch.where(okv, r, s.r)
        rs = torch.where(ok, rs, s.rs)
        beta = (rs / s.rs)[:, None]
        p = torch.where(okv, r + beta * s.p, s.p)
        return _CgState(it=s.it + 1, z=z, r=r, p=p, rs=rs, broke=~ok)

    return loops.synced_while(*loops.lanes(body, cond, state))[0]


def _kth_largest(v_abs: torch.Tensor, k: int, group=None) -> torch.Tensor:
    """(k+1)-th largest entry of each lane's |x| (0-based k), clamped to
    the row length; over the column shards of ``group`` when given: each
    rank's top k+1 are all-gathered (S·(k+1) values a lane) and reduced
    again (irls_cg.py:122-131)."""
    kk = min(k + 1, v_abs.shape[-1])
    top = torch.topk(v_abs, kk, dim=-1).values
    if group is not None:
        top = collectives.all_gather(top, group).permute(1, 0, 2).reshape(
            top.shape[0], -1)
        top = torch.topk(top, min(k + 1, top.shape[-1]), dim=-1).values
    return top[..., -1]


def solve_irls_cg(A: torch.Tensor, Y: torch.Tensor, tolerance,
                  max_iterations: int, *, p: float = 1.0,
                  k_sparsity: int | None = None,
                  cg_max_iterations: int | None = None,
                  cg_tolerance: float | None = None):
    """Dense single-device CG-IRLS for signals Y (b, m), one lane each;
    returns (X (b, n), IrlsReportArrays)."""
    m, n = A.shape
    return solve_irls_cg_core(
        lambda V: blas.xgemm(V, A, trans_b=True),   # (b, n) → (b, m)
        lambda U: blas.xgemm(U, A),                 # (b, m) → (b, n)
        m, n, Y, tolerance, max_iterations, p=p, k_sparsity=k_sparsity,
        cg_max_iterations=cg_max_iterations, cg_tolerance=cg_tolerance,
        dtype=A.dtype)


def solve_irls_cg_core(matvec, rmatvec, m: int, n: int, Y, tolerance,
                       max_iterations: int, *, p: float = 1.0,
                       k_sparsity: int | None = None,
                       cg_max_iterations: int | None = None,
                       cg_tolerance: float | None = None,
                       dtype=torch.float32, n_local: int | None = None,
                       n_axis=None):
    """CG-IRLS over abstract A products, per lane: ``matvec(X)`` maps
    (b, n_local) → (b, m), ``rmatvec(U)`` (b, m) → (b, n_local).
    ``k_sparsity`` is the K of the ε-rule (default m // 4; any K at or
    above the true sparsity preserves recovery, arXiv:1509.04063 §2.2).
    For column sharding pass ``n_axis`` (the process group partitioning n;
    ``matvec`` all-reduces over it, ``ops/operators.py::
    ColShardedOperator``) and ``n_local``, this rank's column count; ``n``
    stays the global one."""
    if not (0 < p <= 1.0):
        raise ValueError(f"p must be in (0, 1], got {p}")
    if k_sparsity is not None and k_sparsity < 1:
        raise ValueError(f"k_sparsity must be >= 1, got {k_sparsity}")
    if cg_max_iterations is not None and cg_max_iterations < 1:
        # a zero-step CG would return z = z0 and the first outer step
        # would "converge" to x = 0 silently
        raise ValueError(
            f"cg_max_iterations must be >= 1, got {cg_max_iterations}")
    if cg_tolerance is not None and not cg_tolerance > 0:
        raise ValueError(f"cg_tolerance must be > 0, got {cg_tolerance}")
    n_local = n if n_local is None else n_local
    K = k_sparsity if k_sparsity is not None else max(1, m // 4)
    max_cg = cg_max_iterations if cg_max_iterations is not None else min(m, 128)
    b, dev = Y.shape[0], Y.device

    def scalar(value):
        return torch.as_tensor(value, dtype=dtype, device=dev)

    tol = scalar(tolerance)
    eps_d = torch.finfo(dtype).eps
    if cg_tolerance is None:
        # the inner solve's accuracy sets the floor of the outer change:
        # tol/10, within [10·eps, √eps]
        cg_rel = torch.maximum(
            scalar(10 * eps_d),
            torch.minimum(scalar(math.sqrt(eps_d)), tol / 10))
    else:
        cg_rel = scalar(cg_tolerance)
    # absolute CG target per lane: ‖r‖ ≤ cg_rel · ‖y‖
    cg_tol2 = cg_rel ** 2 * _pdot(Y, Y)
    pexp = 1.0 - p / 2.0
    tiny = torch.finfo(dtype).tiny

    def full(value, dt=dtype, shape=(b,)):
        return torch.full(shape, value, dtype=dt, device=dev)

    state = _OuterState(
        it=full(0, torch.int32), started=full(False, torch.bool),
        x=full(0, shape=(b, n_local)), z=full(0, shape=(b, m)), eps=full(1),
        change=full(float("inf")), broke=full(False, torch.bool))

    def cond(s: _OuterState) -> torch.Tensor:
        # do-while, like the reference loop (irls-cpu.cpp:92-118)
        return ~s.started | (~s.broke & (s.it < max_iterations)
                             & (s.change > tol))

    def body(s: _OuterState, live: torch.Tensor) -> _OuterState:
        D = torch.pow(s.x * s.x + (s.eps * s.eps)[:, None], pexp)  # D = W⁻¹
        cg = _cg_solve(lambda V: matvec(D * rmatvec(V)), Y, s.z, cg_tol2,
                       max_cg, dtype, active=live)
        xn = D * rmatvec(cg.z)
        xabs = xn.abs()
        xmax = xabs.amax(dim=-1)
        dmax = (xn - s.x).abs().amax(dim=-1)
        if n_axis is not None:
            xmax, dmax = collectives.all_reduce(
                torch.stack([xmax, dmax]), n_axis, op="max")
        change = dmax / torch.clamp(xmax, min=tiny)
        eps = torch.minimum(s.eps, _kth_largest(xabs, K, n_axis) / n)
        ok = live & ~cg.broke
        okv = ok[:, None]
        return _OuterState(
            it=torch.where(ok, s.it + 1, s.it),
            started=torch.ones_like(s.started),
            x=torch.where(okv, xn, s.x), z=torch.where(okv, cg.z, s.z),
            eps=torch.where(ok, eps, s.eps),
            change=torch.where(ok, change, s.change),
            broke=s.broke | (live & cg.broke))

    def trip(carry):
        # the outer body gates every field by the lanes' live flags itself
        s, live = carry
        s = body(s, live)
        return s, cond(s)

    state = loops.synced_while(trip, lambda c: c[1],
                               (state, cond(state)))[0]

    return state.x, IrlsReportArrays(iter=state.it,
                                     solution_error=state.eps,
                                     spd_failure=state.broke)
