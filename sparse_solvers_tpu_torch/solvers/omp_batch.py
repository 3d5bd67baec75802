"""Batch-native OMP driver — the port of ``sparse_solvers_tpu/solvers/
omp_batch.py``, the greedy family's throughput path.

Slot-space batched OMP and generalized OMP (gOMP), decision for decision
the JAX driver: the LS state lives as (b, k_max) slot vectors and a
(b, K, K) inverse; the only (b, n) carries are the residual correlation c
and an int8 membership mask. Each round picks the largest inactive |c|
(``picks`` of them for gOMP, by iterated masked argmax), gathers the
insert's Gram column, applies the guarded insert + LS re-solve (K4, once
per pick), and pays one correlation pass c = c₀ − AᵀA·x̂ (the K1 kernel at
"default" precision, two fp32 products otherwise). Without a Gram
(``G=None``) the insert's column comes from the Homotopy driver's
``make_insert_column``, as with one. c₀ = AᵀY is computed
once at "highest"; ‖r‖² follows the LS identity ‖y‖² − b_actᵀ·coef in the
loop; the reported error is a post-loop ℓ₂ certificate ‖y − Ax‖₂ at
"high" (or "highest" when that is in force). The capacity ladder
(``_plan_tiers``, shared with the Homotopy driver) runs early picks in
smaller slot buffers and zero-pads the state upward (``_embed_omp``).

PyTorch idiom against the JAX form:
  * the loop is ``loops.run``'s, as the Homotopy driver's: one device
    sync a round, and each tier's rounds after its first replayed as one
    CUDA graph on a card and unsharded; under a profiler every round,
    replays included, counts one ``omp.passes`` and ``picks``
    ``omp.sub_inserts`` (``utils/profiling``);
  * K4 updates the state's inverse in place, as the Pallas call aliases
    it, and commits it ungated as the JAX driver does (inert and
    degenerate lanes are not written by the kernel; a blown lane breaks
    and its inverse is never read again); the mask is updated in place;
  * slot writes at ``kk`` are one-hot selects, so a lane at capacity
    (kk == K, where JAX's ``.at[].set`` drops the write) writes nothing
    and never touches slot K−1.

Row-sharded (``axis`` = the row process group of a mesh), as the
Homotopy driver: c₀ = AᵀY, ‖y‖², the q products, the gram-free column
norms and insert columns and the certificate's ‖r‖² end in all-reduces
over the group (``ops/collectives.py``); the picks and K4 run replicated.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..linalg import active_set
from ..ops import blas, collectives
from ..ops.cuda import omp_insert as _oins
from ..utils import profiling
from . import loops
from .homotopy_batch import (_identity, _plan_tiers, _take1,
                             make_insert_column, make_qprod)
from .omp import OmpReportArrays


class _OBState(NamedTuple):
    it: torch.Tensor       # (b,) int32
    c: torch.Tensor        # (b, n) residual correlations
    mask: torch.Tensor     # (b, n) int8 membership
    inv: torch.Tensor      # (b, K, K)
    b_act: torch.Tensor    # (b, K) A_Γᵀy in slot order
    coef: torch.Tensor     # (b, K) LS coefficients
    indices: torch.Tensor  # (b, K) int32, sentinel n
    kk: torch.Tensor       # (b,) int32 live size
    rss: torch.Tensor      # (b,) ‖r‖² (identity form)
    broke: torch.Tensor    # (b,) degenerate pick — stop, state reverted
    done: torch.Tensor     # (b,) rss stalled — stop, iterate kept


def _embed_omp(s: _OBState, K2: int, n: int) -> _OBState:
    """Zero-pad a capacity-K1 state into capacity K2 (> K1) at a tier
    boundary: exact, because padded slots carry the sentinel index and
    zero inverse rows and columns, which K4 and the slot reductions treat
    as absent."""
    p = K2 - s.b_act.shape[1]
    pad2 = lambda a: F.pad(a, (0, p))
    return s._replace(
        inv=F.pad(s.inv, (0, p, 0, p)), b_act=pad2(s.b_act),
        coef=pad2(s.coef), indices=F.pad(s.indices, (0, p), value=n))


def l2_certificate(A: torch.Tensor, X: torch.Tensor, Y: torch.Tensor,
                   psum=_identity) -> torch.Tensor:
    """ℓ₂ residual certificate ‖y − Ax‖₂ per lane of X (b, n) against
    Y (b, m), at the scope's precision: the driver's post-loop certificate,
    which the façade reports as it is (api.py:1726-1727 of the JAX
    package). Row-sharded, ``psum`` sums ‖r‖² over the shards. Looked up
    at call time, so tests can replace it to force certificate
    failures."""
    R = Y - blas.xgemm(X, A, trans_b=True)
    return torch.sqrt(psum((R * R).sum(dim=1)).clamp(min=0))


def solve_omp_batch(A: torch.Tensor, G: torch.Tensor | None,
                    Y: torch.Tensor, tolerance, max_iterations: int,
                    k_max: int, ladder=None, dense: bool = True,
                    picks: int = 1, AT: torch.Tensor | None = None,
                    axis=None, overlap_blocks: int = 1,
                    overlap_mode: str = "psum",
                    axis_size: int | None = None, sync_axes=None,
                    keep: dict | None = None):
    """Batched greedy solve; returns (X (b, n), OmpReportArrays).

    A: (m, n) f32; G = AᵀA (n, n), or None to run gram-free; Y: (b, m), all
    on one device. The precision scope in force is the path's ("default"
    runs K1). ``AT``: the gram-free route's ``transposed_copy(A)``, made in
    the same precision scope; made here when not given.
    ``ladder`` controls the capacity tiers (see ``_plan_tiers``).
    ``dense=False`` returns the compact slot-space solution ``((values,
    indices), report)`` — values (b, k_max) at columns indices (b, k_max),
    sentinel ``n`` for empty slots.

    ``picks`` (≥ 1): gOMP rounds — each selects the ``picks`` largest
    inactive correlations per lane with strictly positive score, inserts
    them by sequential guarded K4 calls (each sub-insert's Gram column
    sees the grown support) and pays one correlation pass. Degenerate
    sub-inserts are skipped individually; a lane whose round commits
    nothing breaks with its solution intact. ``max_iterations`` stays the
    column budget (iter = support size). A tier boundary may split a
    round, as in the JAX driver.

    ``axis``, ``overlap_blocks``, ``overlap_mode``, ``axis_size`` and
    ``sync_axes``: the row-sharded run, as ``solve_homotopy_batch``'s;
    the reported error is then the all-reduced certificate.

    ``keep`` (an entry of a ``loops.Kept``, whose key holds every
    argument but Y) keeps what the rounds read across calls: c₀ and
    ‖y‖², written anew each call into the kept tensors, the constants,
    the q product and the insert's column, and each tier's trip graph
    with its state. Returned tensors are never the kept state's own."""
    n = A.shape[1]
    b = Y.shape[0]
    dtype = A.dtype
    if dtype != torch.float32:
        raise ValueError(
            "the batch-native OMP driver is float32 (its kernels are); got "
            f"{dtype}")
    if overlap_blocks > 1 and axis is None:
        raise ValueError(
            "overlap_blocks splits the sharded q psum into column-block "
            "collectives; without a shard axis there is no psum to "
            "overlap — pass axis=... or overlap_blocks=1")
    dev = A.device
    if b == 0:
        report = OmpReportArrays(
            iter=torch.zeros(0, dtype=torch.int32, device=dev),
            solution_error=torch.zeros(0, dtype=dtype, device=dev))
        out = (torch.zeros((0, n), dtype=dtype, device=dev) if dense
               else (torch.zeros((0, k_max), dtype=dtype, device=dev),
                     torch.full((0, k_max), n, dtype=torch.int32,
                                device=dev)))
        return out, report
    # every comparison with tol and tol² happens in f32, as in JAX
    tol_t = torch.tensor(float(tolerance), dtype=dtype)
    tol2 = float(tol_t * tol_t)

    # c₀ at "highest": the rhs of every LS re-solve and the dominant noise
    # term of the rss identity (omp_batch.py:169-183); the certificate
    # honours an ambient "highest"
    cert_prec = ("highest" if blas.current_precision() == "highest"
                 else "high")
    psum = ((lambda v: collectives.all_reduce(v, axis)) if axis is not None
            else _identity)
    with blas.precision_scope("highest"):
        C0 = psum(blas.xgemm(Y, A))
    yty = psum((Y * Y).sum(dim=1))
    kept = {} if keep is None else keep
    if "operands" in kept:
        # the rounds' graphs read the kept c₀ and ‖y‖²: this call's go
        # into them
        kept["operands"][0].copy_(C0)
        kept["operands"][1].copy_(yty)
    else:
        kept["operands"] = (
            C0, yty, torch.arange(b, device=dev),
            torch.ones((), dtype=torch.int8, device=dev),
            # gOMP's taken score, written from the device (a graphed round
            # uploads nothing from the host)
            torch.full((), -1.0, dtype=dtype, device=dev),
            make_qprod(A, psum, overlap_blocks, overlap_mode, axis,
                       axis_size),
            make_insert_column(A, G, AT, psum)[1])
    C0, yty, bidx, one8, neg1, qprod, insert_column = kept["operands"]

    def lane_live(s: _OBState, it_cap: int | None) -> torch.Tensor:
        live = (~s.broke & ~s.done & (s.it < max_iterations)
                & (s.kk < s.b_act.shape[1]) & (s.rss.clamp(min=0) > tol2))
        if it_cap is not None:
            live = live & (s.it < it_cap)
        return live

    def body(s: _OBState, it_cap: int | None) -> _OBState:
        live = lane_live(s, it_cap)
        K = s.b_act.shape[1]
        slots = torch.arange(K, device=dev)[None, :]
        scores = torch.where(s.mask > 0, -1.0, s.c.abs())
        picked = []           # (idx, committed) of each sub-insert
        if picks == 1:
            # greedy pick over the inactive set (leftmost argmax)
            idx = torch.argmax(scores, dim=1).to(torch.int32)
            u1, vtv = insert_column(idx, s.indices)
            # the LS rhs grows by one gathered scalar of c₀
            at_kk = slots == s.kk[:, None]
            b_act1 = torch.where(live[:, None] & at_kk,
                                 _take1(C0, idx)[:, None], s.b_act)
            coef1, deg = _oins.omp_insert(s.inv, u1, s.kk, vtv, b_act1,
                                          live)
            stepped = live & ~deg
            it1 = s.it + stepped.to(torch.int32)
            kk1 = s.kk + stepped.to(torch.int32)
            broke_round = live & deg
            ind1 = torch.where(stepped[:, None] & at_kk, idx[:, None],
                               s.indices)
            picked.append((idx, stepped))
        else:
            # gOMP round: the picks largest inactive scores per lane by
            # iterated masked argmax, inserted by sequential guarded K4
            # calls; b_act_j and coef_j are each sub-insert's own and are
            # committed only where it succeeded
            b_act1, ind1, kk1, it1, coef1 = (s.b_act, s.indices, s.kk, s.it,
                                             s.coef)
            ncommit = torch.zeros(b, dtype=torch.int32, device=dev)
            for _ in range(picks):
                idx = torch.argmax(scores, dim=1).to(torch.int32)
                val = _take1(scores, idx)
                scores[bidx, idx.long()] = neg1
                # strictly positive correlation (the oracle's
                # degenerate-round semantics)
                elig = (live & (val > 0) & (kk1 < K)
                        & (it1 < max_iterations))
                if it_cap is not None:
                    elig = elig & (it1 < it_cap)
                u1, vtv = insert_column(idx, ind1)
                at_kk = slots == kk1[:, None]
                b_act_j = torch.where(elig[:, None] & at_kk,
                                      _take1(C0, idx)[:, None], b_act1)
                coef_j, deg = _oins.omp_insert(s.inv, u1, kk1, vtv, b_act_j,
                                               elig)
                ok = elig & ~deg
                ind1 = torch.where(ok[:, None] & at_kk, idx[:, None], ind1)
                b_act1 = torch.where(ok[:, None], b_act_j, b_act1)
                coef1 = torch.where(ok[:, None], coef_j, coef1)
                kk1 = kk1 + ok.to(torch.int32)
                it1 = it1 + ok.to(torch.int32)
                ncommit = ncommit + ok.to(torch.int32)
                picked.append((idx, ok))
            stepped = live & (ncommit > 0)
            broke_round = live & (ncommit == 0)

        # ‖r‖² by the LS identity (in-loop stop only; the reported error
        # is the post-loop certificate)
        rss1 = yty - (b_act1 * coef1).sum(dim=1)

        # correlation update from the new coefficients (one q pass)
        D = active_set.scatter(
            torch.where(stepped[:, None], coef1, torch.zeros_like(coef1)),
            ind1, n)
        q = qprod(D)

        # a blown lane stops with its previous committed state
        blew = stepped & ~(torch.isfinite(coef1).all(dim=1)
                           & torch.isfinite(rss1))
        stepped = stepped & ~blew

        for idx, ok in picked:
            cols = idx.long()
            s.mask[bidx, cols] = torch.where(stepped & ok, one8,
                                             s.mask[bidx, cols])
        keep = lambda new, old: torch.where(stepped[:, None], new, old)
        return s._replace(
            it=torch.where(stepped, it1, s.it),
            c=keep(C0 - q, s.c),
            b_act=keep(b_act1, s.b_act),
            coef=keep(coef1, s.coef),
            indices=keep(ind1, s.indices),
            kk=torch.where(stepped, kk1, s.kk),
            rss=torch.where(stepped, rss1, s.rss),
            broke=s.broke | broke_round | blew,
            # strictly-decreasing contract: a stall marks the identity's
            # rounding floor — stop, iterate kept
            done=s.done | (stepped & (rss1 >= s.rss)))

    tiers = _plan_tiers(k_max, max_iterations, ladder)
    # what every trip issues, whether eager, captured or replayed: one
    # correlation pass over A and ``picks`` guarded K4 sub-inserts
    trip_counts = {"omp.passes": 1, "omp.sub_inserts": picks}
    state = None
    for t, Kt in enumerate(tiers):
        # non-final tiers stop before any lane could need slot Kt
        cap = None if t == len(tiers) - 1 else Kt - 1
        with profiling.span("solvers.tier", K=Kt):
            if state is None:
                zeros = lambda *shape: torch.zeros(shape, dtype=dtype,
                                                   device=dev)
                # c and rss are the state's own: a trip writes them back
                state = _OBState(
                    it=torch.zeros(b, dtype=torch.int32, device=dev),
                    c=C0.clone(),
                    mask=torch.zeros((b, n), dtype=torch.int8, device=dev),
                    inv=zeros(b, Kt, Kt), b_act=zeros(b, Kt),
                    coef=zeros(b, Kt),
                    indices=torch.full((b, Kt), n, dtype=torch.int32,
                                       device=dev),
                    kk=torch.zeros(b, dtype=torch.int32, device=dev),
                    rss=yty.clone(),
                    broke=torch.zeros(b, dtype=torch.bool, device=dev),
                    done=torch.zeros(b, dtype=torch.bool, device=dev))
            else:
                state = _embed_omp(state, Kt, n)
            step = lambda s, c=cap: body(s, c)
            live_fn = lambda s, c=cap: lane_live(s, c)
            state = loops.run(step, live_fn, state, sharded=axis is not None,
                              sync_axes=sync_axes,
                              slot=kept.setdefault(("tier", Kt, cap),
                                                   loops.Slot()),
                              counts=trip_counts)

    X = active_set.scatter(state.coef, state.indices, n)
    # the certificate: ‖y − Ax‖₂ per lane from the returned solution (a
    # replaced seam takes the unsharded arguments); the facade's
    # certificate, so an api.certify span
    with profiling.span("api.certify"), blas.precision_scope(cert_prec):
        err = (l2_certificate(A, X, Y) if axis is None
               else l2_certificate(A, X, Y, psum))
    report = OmpReportArrays(iter=state.it.clone(), solution_error=err)
    if not dense:
        return (state.coef.clone(), state.indices.clone()), report
    return X, report
