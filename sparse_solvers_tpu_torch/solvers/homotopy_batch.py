"""Batch-native homotopy driver — the port of ``sparse_solvers_tpu/solvers/
homotopy_batch.py``, the throughput path.

Fast-mode batched homotopy in slot space, decision for decision the JAX
driver: x, the direction and the active correlations live as (b, k_max)
slot vectors; the only (b, n) carries are the correlation c and an int8
membership mask. Each iteration scatters the slot direction, forms
q = AᵀA·d (the K1 kernel at "default" precision, two fp32 products
otherwise), runs the γ scan (K2), gathers the insert's Gram column, applies
the active-set transition (K3), and updates c, ‖c‖∞ and the mask. The
capacity ladder (``_plan_tiers``) runs the early path in smaller slot
buffers and zero-pads the state into the next tier (``_embed``).

PyTorch idiom against the JAX form:
  * the loop is a Python ``while`` on the host that reads ``any(live)``
    once per iteration (one device sync); frozen lanes pass through an
    iteration unchanged, exactly as under ``lax.while_loop``;
  * the transition updates the state's inv, gk, x_act, d_act, c_act and
    indices in place, as the Pallas call aliases them, and the mask is
    updated in place too — a ``body(s)`` call consumes ``s``;
  * slot scatters with the sentinel index n (JAX's ``mode="drop"``) add
    zeros at a clamped column instead, which leaves every value exact;
  * the precision scope in force when a stepper is made is captured and
    re-entered by its init and body, as JAX captures it at trace time.

Left out here (ROADMAP.md Queue 1): the sharded modes and ``psum`` (item
10), ``record_path`` (item 4) and the gram-free route ``G=None`` (item 5).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops import blas
from ..ops.cuda import kernels as _kern
from ..ops.cuda import scan as _scan
from ..ops.cuda import transition as _trans
from .homotopy import HomotopyReportArrays, _sign_deadzone


class _BState(NamedTuple):
    it: torch.Tensor        # (b,) int32 per-lane iteration count
    c: torch.Tensor         # (b, n) correlations
    c_inf: torch.Tensor     # (b,)
    mask: torch.Tensor      # (b, n) int8 support membership
    inv: torch.Tensor       # (b, K, K) padded (A_ΓᵀA_Γ)⁻¹
    gk: torch.Tensor        # (b, K, K) active Gram submatrix (AᵀA)[Γ,Γ]
    x_act: torch.Tensor     # (b, K) solution over slots
    d_act: torch.Tensor     # (b, K) direction over slots
    c_act: torch.Tensor     # (b, K) active correlations c[Γ] (recurrence)
    indices: torch.Tensor   # (b, K) int32, sentinel n
    kk: torch.Tensor        # (b,) int32 live slot count
    broke: torch.Tensor     # (b,) bool


def _take1(M: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """M[lane, idx[lane]] → (b,)."""
    return M.gather(1, idx.long()[:, None])[:, 0]


def _slots_to_dense(values: torch.Tensor, indices: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Scatter slot values (b, K) to dense (b, n) at columns ``indices``;
    sentinel slots (index n) contribute nothing. Live indices are unique
    per lane, so the add writes each value exactly once and the sentinel
    slots add exact zeros at a clamped column."""
    out = torch.zeros((values.shape[0], n), dtype=values.dtype,
                      device=values.device)
    if n:
        live = indices < n
        out.scatter_add_(1, indices.clamp(max=n - 1).long(),
                         torch.where(live, values, torch.zeros_like(values)))
    return out


def route_batch_native(lanes: int | None, n: int, dtype,
                       sparse: bool) -> bool:
    """The routing rule for the slot-space solver. The port has no
    per-lane core yet (ROADMAP.md Queue 1 item 4), so every float32 batch
    outside the sparse-matvec regime runs here, on any device and for any
    n — the kernels handle ragged shapes themselves — and so does an
    empty batch (its own early return). No environment override."""
    return (lanes is not None and dtype == torch.float32
            and (lanes == 0 or not sparse))


def make_qprod(A: torch.Tensor):
    """q = AᵀA·D product factory, unsharded (homotopy_batch.py:221-229).
    The K1 bf16 kernel is on exactly when the scope's precision is
    "default" (for any shape: the port has no TPU envelope); otherwise the
    product is two fp32 gemms at the scope's precision."""
    if blas.current_precision() == "default":
        A16 = A.to(torch.bfloat16)
        return lambda D: _kern.normal_matvec_fused_bf16(A16, D)
    return lambda D: blas.xgemm(blas.xgemm(D, A, trans_b=True), A)


def gram_slot_gather(G: torch.Tensor, idx: torch.Tensor,
                     indices: torch.Tensor, n: int):
    """u1 (b,K) = G[idx, indices] (sentinel n → 0) and vtv (b,) =
    G[idx, idx]: the insert's Gram column over the slots. A direct point
    gather: the JAX form's aligned-block gather was a TPU gather-rate
    workaround and gives the same values."""
    rows = idx.long()
    u1 = G[rows[:, None], indices.clamp(max=n - 1).long()]
    u1 = torch.where(indices < n, u1, torch.zeros_like(u1))
    return u1, G[rows, rows]


def _plan_tiers(k_max: int, max_iterations: int, ladder) -> list[int]:
    """Capacity ladder (homotopy_batch.py:305-347): after ``i`` iterations
    a lane holds at most ``i + 1`` support members, so iterations
    < K/2−1 run in a half-capacity loop and one zero-pad embed migrates
    the state to the full capacity.

    ladder: None = auto (on from k_max ≥ 48), True = force two tiers when
    structurally possible, False = off, or an explicit ascending tier
    list ending at k_max (infeasible intermediate tiers are dropped)."""
    if ladder is False:
        return [k_max]
    if isinstance(ladder, (list, tuple)):
        if list(ladder) != sorted(set(ladder)) or ladder[-1] != k_max:
            raise ValueError(
                f"ladder must be ascending and end at k_max={k_max}: "
                f"{ladder}")
        return [K for K in ladder
                if K == k_max or (2 <= K and max_iterations > K)]
    half = lambda K: -(-((K + 1) // 2) // 8) * 8  # ceil(K/2), multiple of 8
    if ladder is None and k_max < 48:
        return [k_max]
    tiers = [k_max]
    t = half(k_max)
    while t >= 16 and t < tiers[0] and len(tiers) < 3:
        if max_iterations > t:  # a tier no path can outgrow is skipped
            tiers.insert(0, t)
        t = half(t)
    if ladder is True and len(tiers) == 1:
        t = half(k_max)
        if 2 <= t < k_max and max_iterations > t:
            tiers.insert(0, t)
    return tiers


def _embed(s: _BState, K2: int, n: int) -> _BState:
    """Zero-pad a capacity-K1 state into capacity K2 (> K1). Exact: the
    kernels derive slot liveness from kk/indices."""
    p = K2 - s.x_act.shape[1]
    pad2 = lambda a: F.pad(a, (0, p))
    return s._replace(
        inv=F.pad(s.inv, (0, p, 0, p)), gk=F.pad(s.gk, (0, p, 0, p)),
        x_act=pad2(s.x_act), d_act=pad2(s.d_act), c_act=pad2(s.c_act),
        indices=F.pad(s.indices, (0, p), value=n))


def solve_homotopy_batch(A: torch.Tensor, G: torch.Tensor | None,
                         Y: torch.Tensor, tolerance, max_iterations: int,
                         k_max: int, ladder=None, dense: bool = True):
    """Fast-mode batched homotopy — the slot-space throughput driver.

    A: (m, n) f32; G = AᵀA (n, n); Y: (b, m), all on one device. Returns
    (X (b, n), HomotopyReportArrays of per-lane tensors). ``ladder``
    controls the capacity tiers (see _plan_tiers).

    ``dense=False`` skips the final (b, n) scatter and returns the
    compact slot-space solution ``((values, indices), report)`` — values
    (b, k_max) at columns indices (b, k_max), sentinel ``n`` marking
    empty slots; ``densify_batch`` rebuilds the dense X exactly."""
    n = A.shape[1]
    b = Y.shape[0]
    if b == 0:
        report = HomotopyReportArrays(
            iter=torch.zeros(0, dtype=torch.int32, device=A.device),
            solution_error=torch.zeros(0, dtype=A.dtype, device=A.device))
        out = (torch.zeros((0, n), dtype=A.dtype, device=A.device) if dense
               else (torch.zeros((0, k_max), dtype=A.dtype, device=A.device),
                     torch.full((0, k_max), n, dtype=torch.int32,
                                device=A.device)))
        return out, report
    tiers = _plan_tiers(k_max, max_iterations, ladder)
    state = None
    for t, Kt in enumerate(tiers):
        # non-final tiers stop before any lane could need slot Kt
        cap = None if t == len(tiers) - 1 else Kt - 1
        init, body, lane_live = make_stepper(
            A, G, Y, tolerance, max_iterations, Kt, it_cap=cap)
        state = init() if state is None else _embed(state, Kt, n)
        while bool(lane_live(state).any()):
            state = body(state)
    if dense:
        out = _slots_to_dense(state.x_act, state.indices, n)
    else:
        out = (state.x_act, state.indices)
    return out, HomotopyReportArrays(iter=state.it,
                                     solution_error=state.c_inf)


def densify_batch(values, indices, n: int) -> torch.Tensor:
    """Scatter a compact slot-space batch solution (``dense=False``) back
    to dense (b, n) — values (b, K) at columns indices (b, K), sentinel
    ``n`` = empty slot. Takes numpy arrays or tensors."""
    values = torch.as_tensor(values)
    indices = torch.as_tensor(indices, device=values.device)
    return _slots_to_dense(values, indices, n)


def make_stepper(A: torch.Tensor, G: torch.Tensor | None, Y: torch.Tensor,
                 tolerance, max_iterations: int, k_max: int,
                 it_cap: int | None = None):
    """Build ``(init, body, lane_live)`` for the batch driver — exposed so
    tests can step the iteration. ``init()`` computes the initial state;
    ``body(s)`` runs one iteration and consumes ``s`` (in-place updates);
    ``lane_live(s)`` is the per-lane do-while condition. ``it_cap``
    freezes lanes at an iteration bound (a capacity-ladder tier)."""
    if G is None:
        raise NotImplementedError(
            "the gram-free route (G=None) is not ported yet: ROADMAP.md "
            "Queue 1 item 5")
    b = Y.shape[0]
    n = A.shape[1]
    K = k_max
    dtype = A.dtype
    if dtype != torch.float32:
        raise ValueError(
            "the batch-native driver is float32 (its kernels are); got "
            f"{dtype}")
    # every comparison with tol happens in f32, as in the JAX driver
    tol = float(torch.tensor(float(tolerance), dtype=dtype))
    prec = blas.current_precision()
    dev = A.device
    bidx = torch.arange(b, device=dev)
    gdiag = torch.diagonal(G)
    qprod = make_qprod(A)

    def init() -> _BState:
        # solve_homotopy_core's init, batched (homotopy-cpu.cpp:215-229)
        with blas.precision_scope(prec):
            C0 = blas.xgemm(Y, A)                  # c0 = Aᵀy per lane
        idx0 = torch.argmax(C0.abs(), dim=1).to(torch.int32)
        c0 = _take1(C0, idx0)
        c_inf0 = c0.abs()
        vtv0 = gdiag[idx0.long()]
        # initial direction: sign of ‖c‖∞ (+1), NOT sign(c[idx0]) — the
        # reference quirk; the slot's tracked correlation is c[idx0]
        ds0 = _sign_deadzone(c_inf0, tol) / vtv0
        zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
        mask = torch.zeros((b, n), dtype=torch.int8, device=dev)
        mask[bidx, idx0.long()] = 1
        inv, gk = zeros(b, K, K), zeros(b, K, K)
        inv[:, 0, 0] = 1 / vtv0
        gk[:, 0, 0] = vtv0
        d_act, c_act = zeros(b, K), zeros(b, K)
        d_act[:, 0] = ds0
        c_act[:, 0] = c0
        indices = torch.full((b, K), n, dtype=torch.int32, device=dev)
        indices[:, 0] = idx0
        return _BState(
            it=torch.zeros(b, dtype=torch.int32, device=dev),
            c=C0, c_inf=c_inf0, mask=mask, inv=inv, gk=gk,
            x_act=zeros(b, K), d_act=d_act, c_act=c_act, indices=indices,
            kk=torch.ones(b, dtype=torch.int32, device=dev),
            broke=torch.zeros(b, dtype=torch.bool, device=dev))

    def lane_live(s: _BState) -> torch.Tensor:
        # per-lane do-while (homotopy-cpu.cpp:236)
        live = (s.it == 0) | (~s.broke & (s.it < max_iterations)
                              & (s.c_inf > tol))
        if it_cap is not None:
            live = live & (s.it < it_cap)
        return live

    def body(s: _BState) -> _BState:
        live = lane_live(s)

        # q = AᵀA d: scatter the slot direction, then K1 or two gemms
        D = _slots_to_dense(s.d_act, s.indices, n)
        with blas.precision_scope(prec):
            q = qprod(D)

        gamma_raw, idx = _scan.find_max_gamma_fused(
            q, s.c, s.mask, s.c_inf, s.x_act, s.d_act, s.indices)

        present = (s.indices == idx[:, None]).any(dim=1)
        empty = present & (s.kk == 1)
        if k_max <= max_iterations:
            # a user-shrunk capacity can overflow: break instead
            empty = empty | (~present & (s.kk >= k_max))
        gamma = torch.where(live & ~empty, gamma_raw,
                            torch.zeros_like(gamma_raw))

        u1, vtv = gram_slot_gather(G, idx, s.indices, n)
        cnew = _take1(s.c, idx) - gamma * _take1(q, idx)
        doins = live & ~present & (s.kk < K)
        # `~empty` gates the remove: removing the only active member
        # breaks the lane with its solution intact (homotopy-cpu.cpp:246)
        dorm = live & present & ~empty
        # in place on inv, gk, x_act, d_act, c_act, indices; `deg` flags a
        # noise-level Schur complement (lane untouched, breaks below)
        deg = _trans.transition(
            s.inv, s.gk, s.x_act, s.d_act, s.c_act, s.indices, u1, idx,
            s.kk, gamma, vtv, cnew, live, doins, dorm, tol, n)

        stepped = live & ~empty & ~deg
        c1 = torch.where(stepped[:, None], s.c - gamma[:, None] * q, s.c)
        c_inf1 = torch.where(stepped, c1.abs().amax(dim=1), s.c_inf)
        grow = doins & ~deg
        mval = torch.where(dorm, 0, torch.where(grow, 1, present.to(
            torch.int8))).to(torch.int8)
        s.mask[bidx, idx.long()] = mval
        kk1 = torch.where(dorm, s.kk - 1, torch.where(grow, s.kk + 1, s.kk))

        # per-lane finiteness break: a lane whose slot state went
        # non-finite stops here rather than poisoning later iterations
        blew = live & ~(torch.isfinite(s.x_act).all(dim=1)
                        & torch.isfinite(s.d_act).all(dim=1)
                        & torch.isfinite(s.c_act).all(dim=1)
                        & torch.isfinite(s.inv[:, 0, 0]))

        return s._replace(
            it=s.it + live.to(torch.int32), c=c1, c_inf=c_inf1, kk=kk1,
            broke=s.broke | (live & (empty | deg)) | blew)

    return init, body, lane_live
