"""Homotopy ℓ₁-minimization — the port of
``sparse_solvers_tpu/solvers/homotopy.py``: the per-lane path-following
core and the pieces the batch driver shares.

Solves min ‖x‖₁ s.t. Ax = y by following the homotopy path of
min_x ‖y − Ax‖₂² + λ‖x‖₁ as λ ↓ tolerance, with the active-set Gram
inverse (A_ΓᵀA_Γ)⁻¹ maintained incrementally (reference:
src/solvers/homotopy-cpu.cpp:186-275), keeping its quirks: the
leftmost-minimum tie-break of the γ scan (:156-160), the sign deadzone at
the tolerance (:59-67), the initial direction sign(‖c‖∞) = +1 (:223-224),
do-while iterations with the empty-set break (:236-272), and the report
{iter, solution_error = final ‖c‖∞} (:274).

The core carries a leading lane axis: a single solve is one lane, and a
batch of b signals is b lanes stepped together, which stands in for
``jax.vmap`` of the JAX core (its api.py:571-572). The semantics are the
batched ``lax.while_loop``'s:

  * every lane runs the body each iteration while any lane is live; a lane
    whose (do-while) condition is false keeps every field through
    ``torch.where``, never through a 0·x multiply;
  * ``lax.cond`` becomes a per-lane select over both branches, as under
    vmap, so a broken lane's toggle still runs on the virtual orthogonal
    column (u1 = 0, vᵀv = 1) and no 1/0 enters its inverse;
  * the loop is ``loops.run``'s: it reads ``any(live)`` on the host once
    per iteration, and replays each trip after the first as one CUDA graph
    on a card with a dense operator.

Two modes, as in the JAX package: ``"exact"`` recomputes c = Aᵀ(y − Ax)
and q = Aᵀ(A d) as full dense products each iteration (K6's and K5's
arithmetic, computed here as plain products, as the JAX core computes them
through ``DenseOperator``), with the rank-ordered inverse; ``"fast"`` uses
the correlation recurrence c ← c − γ·q, the sparse direction and the Gram
gathers, with the insertion-ordered inverse and the degenerate-insert
guard.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..linalg import active_set
from ..linalg import online_inverse as oinv
from ..ops import blas
from ..ops.operators import DenseOperator
from . import loops
from .loops import _select


class HomotopyReportArrays(NamedTuple):
    """Per-lane report tensors — mirrors ss::homotopy_report
    (reference: include/ss/policies.h:25-32)."""
    iter: torch.Tensor            # (b,) int32 (uint32 in the JAX package)
    solution_error: torch.Tensor  # (b,) final ‖c‖∞ or the certificate


class _LoopState(NamedTuple):
    it: torch.Tensor         # (b,) int32
    x: torch.Tensor          # (b, n)
    c: torch.Tensor          # (b, n)
    c_inf: torch.Tensor      # (b,)
    direction: torch.Tensor  # (b, n)
    inv: oinv.InverseState
    gk: torch.Tensor         # (b, K, K) active Gram submatrix (use_gk)
    c_act: torch.Tensor      # (b, K) active correlations in slot order
    d_act: torch.Tensor      # (b, K) direction over slots (use_gk)
    broke: torch.Tensor      # (b,) bool
    # regularization-path history (record_path only; (b,1,1)/(b,1)
    # dummies otherwise): per-breakpoint slot values, slot indices, λ
    hist_v: torch.Tensor
    hist_i: torch.Tensor
    hist_l: torch.Tensor


def _sign_deadzone(v: torch.Tensor, tol: float) -> torch.Tensor:
    """sign with a ±tol deadzone (reference: homotopy-cpu.cpp:59-67)."""
    one = torch.ones((), dtype=v.dtype, device=v.device)
    return torch.where(v > tol, one, torch.where(v < -tol, -one, 0 * one))


def _find_max_gamma(q, c, x, direction, c_inf, mask, dtype):
    """Vectorized γ-candidate scan with the leftmost-min tie-break,
    per lane. Reference: homotopy-cpu.cpp:100-164. Active indices give
    −x_i/d_i, inactive ones the two path-crossing terms
    (c_inf ∓ c_i)/(1 ∓ q_i); candidates must be strictly positive, and
    invalid ones take the dtype max (the reference's running-min init,
    :123). ``argmin``'s first occurrence is the reference's leftmost
    minimum. Returns (gamma (b,), idx (b,))."""
    # filled on the device: an upload from the host would wait for it
    big = torch.full((), torch.finfo(dtype).max, dtype=dtype,
                     device=q.device)
    t_active = -x / direction
    cand_active = torch.where((t_active > 0) & (t_active < big), t_active,
                              big)
    dl = 1 - q
    dr = 1 + q
    ci = c_inf.unsqueeze(-1)
    tl = (ci - c) / dl
    tr = (ci + c) / dr
    cl = torch.where((dl != 0) & (tl > 0) & (tl < big), tl, big)
    cr = torch.where((dr != 0) & (tr > 0) & (tr < big), tr, big)
    cand = torch.where(mask, cand_active, torch.minimum(cl, cr))
    idx = torch.argmin(cand, dim=-1)
    return cand.gather(-1, idx.unsqueeze(-1)).squeeze(-1), idx


def _toggle_support(state: oinv.InverseState, col, u1_full, vtv):
    """Insert or remove column ``col`` from the rank-ordered active set
    (reference: homotopy-cpu.cpp:166-183): both sides run, each lane keeps
    its own. The Gram column is the caller's, so neither side closes over
    the sensing matrix."""
    present = state.mask.gather(-1, col.long().unsqueeze(-1)).squeeze(-1)
    return _select(present, oinv.remove(state, col),
                   oinv.insert(state, col, u1_full, vtv))


def _toggle_support_unordered(state: oinv.InverseState, gk, c_act, col,
                              u1, vtv):
    """Fast-path toggle over the insertion-ordered active set with its
    slot-space companions kept in lockstep: ``gk`` the active Gram
    submatrix (the insert's bordering row/col is ``u1`` with ``vtv`` on
    the diagonal) and ``c_act`` the active correlations (removals
    swap-drop it; the caller writes the inserted slot's value)."""
    present = state.mask.gather(-1, col.long().unsqueeze(-1)).squeeze(-1)
    i = torch.arange(gk.shape[-1], device=gk.device)
    # remove: swap the slot with the last live one and drop it
    pos = torch.argmax((state.indices == col.unsqueeze(-1)).to(torch.int8),
                       dim=-1)
    last = state.k - 1
    g_rm = oinv.swap_drop_rowcol(gk, pos, last)
    last_val = oinv._at(c_act, last).unsqueeze(-1)
    ca_rm = torch.where(i == pos.unsqueeze(-1), last_val, c_act)
    ca_rm = torch.where(i == oinv._slot(last, gk.shape[-1]).unsqueeze(-1),
                        torch.zeros_like(ca_rm), ca_rm)
    # insert: border gk with u1 (vtv on the diagonal) at slot k
    at_k = i == state.k.unsqueeze(-1)
    row_k = torch.where(at_k, vtv.unsqueeze(-1), u1)
    g_in = torch.where(at_k.unsqueeze(-1), row_k.unsqueeze(-2), gk)
    g_in = torch.where(at_k.unsqueeze(-2), row_k.unsqueeze(-1), g_in)
    return (_select(present, oinv.remove_unordered(state, col),
                    oinv.insert_unordered(state, col, u1, vtv)),
            _select(present, g_rm, g_in), _select(present, ca_rm, c_act))


def _update_direction(inv_state: oinv.InverseState, c, tol, n: int):
    """direction = expand(inv · sign(c_Γ)) — gather, sign, gemv, scatter
    (reference: homotopy-cpu.cpp:257-266)."""
    cg = _sign_deadzone(active_set.take(c, inv_state.indices, n), tol)
    ds = blas.xgemv(inv_state.inv, cg)
    return active_set.scatter(ds, inv_state.indices, n)


def solve_homotopy(A: torch.Tensor, Y: torch.Tensor, tolerance,
                   max_iterations: int, k_max: int, *, mode: str = "fast",
                   sparse_matvec: bool = False):
    """Run the core on a dense A (m, n) for signals Y (b, m); returns (X
    (b, n), HomotopyReportArrays)."""
    return solve_homotopy_core(DenseOperator(A), A.shape[1], Y, tolerance,
                               max_iterations, k_max, mode=mode,
                               sparse_matvec=sparse_matvec)


def solve_homotopy_core(op, n: int, Y: torch.Tensor, tolerance,
                        max_iterations: int, k_max: int, *,
                        mode: str = "fast", sparse_matvec: bool = False,
                        use_gk: bool = False, record_path: bool = False,
                        compact: bool = False, keep: dict | None = None):
    """Homotopy path loop over a sensing operator for signals Y (b, m),
    one lane each.

    ``use_gk`` switches the fast-mode direction update to the slot-space
    Gram-companion recurrence. ``record_path`` also records the LARS/LASSO
    regularization path the loop follows: after breakpoint t the iterate
    x_t minimizes ½‖y−Ax‖² + λ_t‖x‖₁ with λ_t = ‖Aᵀ(y−Ax_t)‖∞. The history
    is kept in slot space, ((b, max_iterations+1, k_max) values and
    indices and the (b, max_iterations+1) λ), and returned as a third
    element: (X, report, (hist_v, hist_i, hist_l)). ``compact`` returns
    ((values, indices), report), the k_max-slot solution with sentinel
    index n, instead of the dense (b, n) X.

    ``keep`` (an entry of a ``loops.Kept``, whose key holds every
    argument but Y) keeps what the loop's body reads across calls: the
    operator, the lane index and a copy of Y, which each call overwrites,
    and the loop's trip graph with its state. Returned tensors are never
    the kept state's own."""
    if mode not in ("fast", "exact"):
        raise ValueError(f"mode must be 'fast' or 'exact', got {mode!r}")
    fast = mode == "fast"
    dtype = op.dtype
    dev = Y.device
    b = Y.shape[0]
    # every comparison with tol happens in the working dtype
    tol = float(torch.tensor(float(tolerance), dtype=dtype))
    kept = {} if keep is None else keep
    if "operands" in kept:
        # exact mode's body reads Y: this call's goes into the kept copy
        kept["operands"][2].copy_(Y)
    else:
        kept["operands"] = (op, torch.arange(b, device=dev),
                            Y if keep is None else Y.clone())
    op, lanes, Y = kept["operands"]
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)

    # --- init (homotopy-cpu.cpp:215-229); x0 = 0, so c0 = Aᵀy ---
    c0 = op.rmatvec(Y)
    idx0 = torch.argmax(c0.abs(), dim=-1)
    c_at0 = c0[lanes, idx0]
    c_inf0 = c_at0.abs()

    empty_set = oinv.init(k_max, n, dtype, b, dev)
    if fast:
        u1_0, vtv_0 = op.gram_gathered(idx0, empty_set.indices)
        inv0 = oinv.insert_unordered(empty_set, idx0, u1_0, vtv_0)
    else:
        u1_0, vtv_0 = op.gram_column(idx0)
        inv0 = oinv.insert(empty_set, idx0, u1_0, vtv_0)

    # initial direction: sign(c_inf) · inv[0, 0] at idx0 — the sign of the
    # *norm*, not of c[idx0] (homotopy-cpu.cpp:223-227)
    ds0 = _sign_deadzone(c_inf0, tol) * inv0.inv[:, 0, 0]
    d0 = zeros(b, n)
    d0[lanes, idx0] = ds0
    if fast and use_gk:
        gk0, c_act0, d_act0 = zeros(b, k_max, k_max), zeros(b, k_max), \
            zeros(b, k_max)
        gk0[:, 0, 0] = vtv_0
        c_act0[:, 0] = c_at0
        d_act0[:, 0] = ds0
    else:  # one-element dummies: the fields exist, the machinery is off
        gk0, c_act0, d_act0 = zeros(b, 1, 1), zeros(b, 1), zeros(b, 1)

    T = max_iterations + 1
    if record_path:
        # row 0 = the λ-max end of the path (x = 0, λ0 = ‖Aᵀy‖∞)
        hist_v0 = zeros(b, T, k_max)
        hist_i0 = torch.full((b, T, k_max), n, dtype=torch.int32,
                             device=dev)
        hist_l0 = zeros(b, T)
        hist_l0[:, 0] = c_inf0
    else:
        hist_v0, hist_i0, hist_l0 = (
            zeros(b, 1, 1), torch.zeros((b, 1, 1), dtype=torch.int32,
                                        device=dev), zeros(b, 1))

    state = _LoopState(
        it=torch.zeros(b, dtype=torch.int32, device=dev), x=zeros(b, n),
        c=c0, c_inf=c_inf0, direction=d0, inv=inv0, gk=gk0, c_act=c_act0,
        d_act=d_act0, broke=torch.zeros(b, dtype=torch.bool, device=dev),
        hist_v=hist_v0, hist_i=hist_i0, hist_l=hist_l0)

    def compute_q(s: _LoopState):
        """q = AᵀA d (homotopy-cpu.cpp:111-120)."""
        if fast and sparse_matvec and op.has_gram:
            return op.gram_matvec_sparse(s.direction, s.inv.indices)
        if fast and sparse_matvec:
            return op.rmatvec(op.matvec_sparse(s.direction, s.inv.indices))
        return op.rmatvec(op.matvec(s.direction))

    def body(s: _LoopState) -> _LoopState:
        it = s.it + 1
        q = compute_q(s)
        gamma, idx = _find_max_gamma(q, s.c, s.x, s.direction, s.c_inf,
                                     s.inv.mask, dtype)
        present = s.inv.mask[lanes, idx]
        # this toggle empties the active set iff it removes the only
        # member (homotopy-cpu.cpp:248-249): the step is clamped to 0,
        # which freezes x and c, as the reference breaks before them
        empty = present & (s.inv.k == 1)
        if k_max <= max_iterations:
            # a user-shrunk capacity can overflow: break instead of
            # inserting past it
            empty = empty | (~present & (s.inv.k >= k_max))
        if fast:
            # degenerate-insert guard: a Schur complement den at
            # subnormal scale would put inf/NaN in the inverse — break
            u1g, vtvg = op.gram_gathered(idx, s.inv.indices)
            den = vtvg - blas.xdot(u1g, blas.xgemv(s.inv.inv, u1g))
            tiny = 256 * torch.finfo(dtype).tiny
            empty = empty | (~present & (den.abs() <= tiny))
            # the broken lane's toggle still runs: feed it the virtual
            # orthogonal column (u1 = 0, vᵀv = 1)
            u1g = torch.where(empty.unsqueeze(-1), torch.zeros_like(u1g),
                              u1g)
            vtvg = torch.where(empty, torch.ones_like(vtvg), vtvg)
        gamma = torch.where(empty, torch.zeros_like(gamma), gamma)

        d_act1 = s.d_act
        if fast and use_gk:
            # active correlations advance by the same recurrence as c:
            # q[Γ] = (AᵀA)[Γ,Γ] d[Γ] from the companion, no n-gather
            q_act = blas.xgemv(s.gk, s.d_act)
            c_act1 = s.c_act - gamma.unsqueeze(-1) * q_act
            inv1, gk1, c_act1 = _toggle_support_unordered(
                s.inv, s.gk, c_act1, idx, u1g, vtvg)
        elif fast:
            inv1 = _select(present, oinv.remove_unordered(s.inv, idx),
                           oinv.insert_unordered(s.inv, idx, u1g, vtvg))
            gk1, c_act1 = s.gk, s.c_act
        else:
            u1, vtv = op.gram_column(idx)
            inv1 = _toggle_support(s.inv, idx, u1, vtv)
            gk1, c_act1 = s.gk, s.c_act

        x1 = s.x + gamma.unsqueeze(-1) * s.direction
        if fast:
            # c(x + γd) = c(x) − γ·AᵀAd, the recurrence in place of the
            # two residual products at homotopy-cpu.cpp:255
            c1 = s.c - gamma.unsqueeze(-1) * q
            if use_gk:
                # the newly inserted slot's correlation: one scalar of c1
                at_k = (torch.arange(k_max, device=dev)
                        == s.inv.k.unsqueeze(-1))
                c_new = torch.where(at_k, c1[lanes, idx].unsqueeze(-1),
                                    c_act1)
                c_act1 = torch.where(present.unsqueeze(-1), c_act1, c_new)
                cg = c_act1
            else:
                cg = active_set.take(c1, inv1.indices, n)
            # direction = B·sign(c_Γ) wholly in slot space
            ds = blas.xgemv(inv1.inv, _sign_deadzone(cg, tol))
            if use_gk:
                d_act1 = ds
            d1 = active_set.scatter(ds, inv1.indices, n)
        else:
            c1 = op.rmatvec(Y - op.matvec(x1))
            d1 = _update_direction(inv1, c1, tol, n)
        c_inf_out = torch.where(empty, s.c_inf, c1.abs().amax(dim=-1))

        hist_v, hist_i, hist_l = s.hist_v, s.hist_i, s.hist_l
        if record_path:
            # a break iteration commits nothing: record the pre-toggle
            # support, which duplicates the previous breakpoint (solve_path
            # trims it). Row `it` of each lane; none past the history.
            rec_idx = torch.where(empty.unsqueeze(-1), s.inv.indices,
                                  inv1.indices)
            vals = active_set.take(x1, rec_idx, n)
            row = (torch.arange(T, device=dev) == it.unsqueeze(-1))
            hist_v = torch.where(row.unsqueeze(-1), vals.unsqueeze(1),
                                 hist_v)
            hist_i = torch.where(row.unsqueeze(-1), rec_idx.unsqueeze(1),
                                 hist_i)
            hist_l = torch.where(row, c_inf_out.unsqueeze(-1), hist_l)

        return _LoopState(
            it=it, x=x1, c=c1, c_inf=c_inf_out, direction=d1, inv=inv1,
            gk=gk1, c_act=c_act1, d_act=d_act1, broke=empty,
            hist_v=hist_v, hist_i=hist_i, hist_l=hist_l)

    def cond(s: _LoopState) -> torch.Tensor:
        # do-while: the body always runs at least once (homotopy-cpu.cpp:236)
        return (s.it == 0) | (~s.broke & (s.it < max_iterations)
                              & (s.c_inf > tol))

    state = loops.run(*loops.lanes(body, cond, state),
                      sharded=not isinstance(op, DenseOperator),
                      slot=kept.setdefault("loop", loops.Slot()))[0]

    report = HomotopyReportArrays(iter=state.it.clone(),
                                  solution_error=state.c_inf.clone())
    if record_path:
        return state.x.clone(), report, (
            state.hist_v.clone(), state.hist_i.clone(),
            state.hist_l.clone())
    if compact:
        # the loop's own active set: scatter(values, indices) is x exactly
        vals = active_set.take(state.x, state.inv.indices, n)
        return (vals, state.inv.indices.clone()), report
    return state.x.clone(), report
