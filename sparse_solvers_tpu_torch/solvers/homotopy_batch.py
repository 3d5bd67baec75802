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
buffers and zero-pads the state into the next tier (``_embed``). Without
a Gram (``G=None``, the large-n regime where n² cannot be held) the
insert's column comes from ``make_gram_u1`` over a transposed copy of A,
and vᵀv from the exact f32 column norms.

PyTorch idiom against the JAX form:
  * the loop is a Python ``while`` on the host that reads ``any(live)``
    once per iteration (one device sync); frozen lanes pass through an
    iteration unchanged, exactly as under ``lax.while_loop``. On a card
    and unsharded, every trip after the first replays one CUDA graph of
    the trip (``graphed_while``), so the host issues one launch a trip
    in place of each of the trip's kernels;
  * the transition updates the state's inv, gk, x_act, d_act, c_act and
    indices in place, as the Pallas call aliases them, and the mask is
    updated in place too — a ``body(s)`` call consumes ``s``;
  * slot scatters with the sentinel index n (JAX's ``mode="drop"``) add
    zeros at a clamped column instead, which leaves every value exact;
  * the precision scope in force when a stepper is made is captured and
    re-entered by its init and body, as JAX captures it at trace time.

Row-sharded (``axis`` = the row process group of a mesh,
``parallel/sharding.py``): A and Y are this rank's row shards, and every
product that reduces over rows (the initial Aᵀy, the q products, the
gram-free column norms and insert columns) ends in one all-reduce over
the group (``ops/collectives.py``), JAX's ``psum``. The slot state, the γ
scan (K2) and the transition (K3) run replicated on every rank of the
group: they are the same functions of the same all-reduced values, so
every rank takes the same decisions bit for bit. ``overlap_blocks``
splits q's all-reduce into column blocks; ``overlap_mode="ppermute"``
replaces it by the collective-matmul ring (``make_qprod``); ``sync_axes``
(a process group) makes every rank of it run the same number of loop
trips, as JAX's ``synced_while``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..linalg import active_set
from ..ops import blas, collectives
from ..ops import dispatch as _dispatch
from ..ops.cuda import kernels as _kern
from ..ops.cuda import scan as _scan
from ..ops.cuda import transition as _trans
from ..utils import profiling
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


def route_batch_native(lanes: int | None, n: int, dtype,
                       sparse: bool) -> bool:
    """The routing rule for the slot-space solver: every float32 batch
    outside the sparse-matvec regime runs here, on any device and for any
    n — the kernels handle ragged shapes themselves — and so does an
    empty batch (its own early return). The sparse regime, float64 and
    single solves take the per-lane core (solvers/homotopy.py). No
    environment override, and no TPU envelope: the JAX package keeps the
    vmapped core off the TPU, where its Pallas kernels would only
    interpret."""
    return (lanes is not None and dtype == torch.float32
            and (lanes == 0 or not sparse))


def _identity(v):
    return v


def make_qprod(A: torch.Tensor, psum=_identity, overlap_blocks: int = 1,
               overlap_mode: str = "psum", axis=None,
               axis_size: int | None = None):
    """q = AᵀA·D product factory shared by both batch drivers
    (homotopy_batch.py:124-229). Unsharded, or in the plain ``psum``
    form: the K1 bf16 kernel exactly when the scope's precision is
    "default" (for any shape: the port has no TPU envelope), two products
    at the scope's precision otherwise, then ``psum`` (the all-reduce over
    the row shards when sharded).

    ``overlap_blocks`` > 1 (sharded) forces the two-step form and splits
    the second product into column blocks, each with its own all-reduce:
    every q element is the same local-row dot and the same reduction as
    the unsplit form.

    ``overlap_mode="ppermute"`` (sharded; ``axis`` the row group of
    ``axis_size`` ≥ 2 ranks) is the collective-matmul ring: q's columns
    split into S = axis_size chunks; at ring step t each rank adds its
    local partial of chunk (i − t) mod S to the running sum that arrived
    from its ring predecessor and sends it on (S − 1 ``ring_shift``
    steps); rank i then holds the reduced chunk (i + 1) mod S, and one
    all-gather rebuilds q. The sums are in ring-visit order, which may
    differ from the all-reduce's by ulps."""
    if overlap_mode not in ("psum", "ppermute"):
        raise ValueError(
            f"overlap_mode must be 'psum' or 'ppermute', got {overlap_mode!r}")
    n = A.shape[1]
    if overlap_mode == "ppermute":
        if axis is None or not axis_size or axis_size < 2:
            raise ValueError(
                "overlap_mode='ppermute' ring-pipelines the row-shard "
                "reduction; it needs axis=... with axis_size >= 2 "
                f"(got axis={axis!r}, axis_size={axis_size})")
        if overlap_blocks > 1:
            raise ValueError(
                "overlap_blocks is the psum-mode knob; the ppermute ring "
                "always uses S = axis_size chunks")
        S = axis_size
        blk = -(-n // S)
        Ap = F.pad(A, (0, S * blk - n))
        me = collectives.group_rank(axis)

        def ring(D):
            p = blas.xgemm(D, A, trans_b=True)         # (b, m_local)
            acc = None
            for t in range(S):
                j = (me - t) % S                        # this step's chunk
                part = blas.xgemm(p, Ap[:, j * blk:(j + 1) * blk])
                acc = part if acc is None else acc + part
                if t < S - 1:
                    acc = collectives.ring_shift(acc, axis)
            # rank i holds the reduced chunk (i + 1) mod S
            got = collectives.all_gather(acc, axis)    # (S, b, blk)
            return torch.cat([got[(j - 1) % S] for j in range(S)],
                             dim=1)[:, :n]

        return ring
    if overlap_blocks > 1:
        blk = -(-n // overlap_blocks)

        def blocks(D):
            p = blas.xgemm(D, A, trans_b=True)         # (b, m_local)
            return torch.cat([psum(blas.xgemm(p, A[:, j0:j0 + blk]))
                              for j0 in range(0, n, blk)], dim=1)

        return blocks
    if blas.current_precision() == "default":
        A16 = A.to(torch.bfloat16)
        return lambda D: psum(_kern.normal_matvec_fused_bf16(A16, D))
    return lambda D: psum(blas.xgemm(blas.xgemm(D, A, trans_b=True), A))


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


def transposed_copy(A: torch.Tensor) -> torch.Tensor:
    """The gram-free insert column's operand: Aᵀ (n + 1, m), contiguous,
    with a zero row at index n so that sentinel slots gather zeros (JAX's
    ``mode="fill"``). bf16 in the "default" scope, where the dot's inputs
    are bf16 either way (homotopy_batch.py:286-288), A's dtype otherwise.
    At 2048×65536 a bf16 copy is 256 MiB: callers that solve again make
    it once (the façades keep one per precision)."""
    one_pass = blas.current_precision() == "default"
    m, n = A.shape
    AT = A.new_zeros((n + 1, m),
                     dtype=torch.bfloat16 if one_pass else A.dtype)
    AT[:n] = A.T
    return AT


def make_gram_u1(AT: torch.Tensor):
    """Gram-free insert-column factory (homotopy_batch.py:278-302): u1[j] =
    ⟨A e_ind_j, A e_idx⟩ over the slots, from two row gathers of ``AT``
    (``transposed_copy``) and a (b, K, m)·(b, m) batched dot with fp32
    accumulation. A bf16 copy is widened to f32 after the gather (exact):
    a bf16 product would round u1 to bf16, where JAX asks for
    ``preferred_element_type=float32``; bf16 values multiply exactly under
    the "default" scope's TF32, and an f32 copy multiplies with TF32 off
    under "high" and "highest". Returns ``gram_u1(idx, indices)`` → (b,
    K)."""
    def gram_u1(idx: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
        V = AT[idx.long()].float()          # (b, m)
        C = AT[indices.long()].float()      # (b, K, m), sentinel: zero rows
        return torch.matmul(C, V.unsqueeze(-1)).squeeze(-1)

    return gram_u1


def make_insert_column(A: torch.Tensor, G: torch.Tensor | None,
                       AT: torch.Tensor | None = None, psum=_identity):
    """The insert's Gram entries, shared by both drivers: ``(gdiag,
    insert_column)`` with ``insert_column(idx, indices)`` → (u1 (b, K),
    vtv (b,)). With a Gram, its diagonal and ``gram_slot_gather``;
    gram-free (``G=None``), the exact f32 column norms Σᵢ A²ᵢⱼ
    (homotopy_batch.py:590, they feed the insert's degeneracy guard) and
    ``make_gram_u1`` over ``AT`` (``transposed_copy(A)``, made here when
    not given), each summed over the row shards by ``psum`` when sharded
    (u1 in f32, as JAX casts it after the sum)."""
    n = A.shape[1]
    if G is not None:
        return torch.diagonal(G), (
            lambda idx, indices: gram_slot_gather(G, idx, indices, n))
    gdiag = psum((A * A).sum(dim=0))
    gram_u1 = make_gram_u1(transposed_copy(A) if AT is None else AT)
    return gdiag, (lambda idx, indices: (psum(gram_u1(idx, indices)),
                                         gdiag[idx.long()]))


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


def synced_while(body, live_fn, state, sync_axes=None):
    """The drivers' host loop: ``state = body(state)`` while any lane of
    ``live_fn(state)`` is live (homotopy_batch.py:350-376).
    ``sync_axes=None``: each rank reads its own lanes (the ranks of a row
    group hold the same replicated state, so they agree). A process
    group: the continue flag is all-reduced (MAX) over it each trip, so
    every rank of it runs the same number of trips; frozen lanes pass
    through the extra trips unchanged. Each trip is a ``solvers.iter``
    span: the body, then the liveness test that decides the next trip,
    whose read of the flag is a ``solvers.sync`` span; the first test
    lies outside them (``utils/profiling``)."""
    go = _any_live(live_fn, state, sync_axes)
    while go:
        with profiling.span("solvers.iter"):
            state = body(state)
            go = _any_live(live_fn, state, sync_axes)
    return state


def _any_live(live_fn, state, sync_axes) -> bool:
    """Whether any lane of ``live_fn(state)`` is live, read on the host
    (over ``sync_axes``' group when one is given)."""
    live = live_fn(state).any()
    with profiling.span("solvers.sync", what="live"):
        if sync_axes is not None:
            live = collectives.all_reduce(
                live.to(torch.float32).reshape(1), sync_axes,
                op="max") > 0
        return bool(live)


def _leaves(tree) -> list:
    """The tensors of a (nested) tuple state, depth first."""
    if isinstance(tree, tuple):
        return [t for sub in tree for t in _leaves(sub)]
    return [tree]


def graph_route(state, sharded: bool = False,
                host_reads: bool = False) -> bool:
    """Whether a driver loop runs through ``graphed_while``: every tensor
    of its state is on a CUDA card, no collective runs in it (``sharded``:
    a row group, a group that syncs the trips, or a row-sharded operator)
    and its body reads nothing on the host (``host_reads``: the batch
    driver's breakpoint history). Both batch drivers' tier loops (Homotopy
    and OMP) and the per-lane Homotopy core ask it. Every other loop runs
    ``synced_while``."""
    return (not sharded and not host_reads
            and all(t.is_cuda for t in _leaves(state)))


# per card: the memory pool every trip graph is captured into, the side
# stream captures run on, and the newest graph, which holds the pool open
# between driver calls
_pools: dict = {}
_streams: dict = {}
_newest: dict = {}


def _capture(fn, device: torch.device):
    """Capture ``fn()`` into a new CUDA graph on ``device``'s side stream,
    its memory drawn from the process's one pool for trip graphs. Returns
    (the graph, what ``fn`` returned: tensors the graph writes). Nothing
    runs until the graph is replayed."""
    key = device.index
    if key not in _pools:
        _pools[key] = torch.cuda.graph_pool_handle()
        _streams[key] = torch.cuda.Stream(device)
    stream = _streams[key]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device):
        stream.wait_stream(torch.cuda.current_stream(device))
        # cuBLAS keeps a workspace for each stream it ran on; cleared
        # before and after, the capture's own lands in the pool and no
        # stream holds a second one beside the caller's
        torch._C._cuda_clearCublasWorkspaces()
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=_pools[key])
            try:
                out = fn()
            finally:
                graph.capture_end()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.current_stream(device).wait_stream(stream)
    _newest[key] = graph
    return graph, out


class _TripGraph:
    """One loop trip captured as a CUDA graph over the state's tensors:
    the body, a copy of every field the body replaced back into the
    state's own tensor, and the liveness ``any()`` into ``flag``.
    ``launches`` holds the hand kernels' launches of one trip, which
    ``ops/dispatch.launches`` counted only once, at the capture."""

    def __init__(self, body, live_fn, state):
        before = dict(_dispatch.launches)
        with profiling.span("solvers.capture"):
            self.graph, self.flag = _capture(
                lambda: _captured_trip(body, live_fn, state),
                _leaves(state)[0].device)
        self.launches = {k: n - before[k]
                         for k, n in _dispatch.launches.items()
                         if n != before[k]}
        _dispatch.launches.update(before)

    def replay(self) -> bool:
        """Run the trip once more; whether any lane is still live."""
        self.graph.replay()
        for name, n in self.launches.items():
            _dispatch.launches[name] += n
        profiling.count("solvers.graph_replays")
        with profiling.span("solvers.sync", what="live"):
            return bool(self.flag)


def _captured_trip(body, live_fn, state) -> torch.Tensor:
    """Issue one trip on ``state``'s tensors, write the body's results
    back into them, and return the liveness flag (under a capture, every
    tensor read or written is the graph's)."""
    dst = _leaves(state)
    src = _leaves(body(state))
    held = [d.untyped_storage().data_ptr() for d in dst]
    if len(set(held)) != len(held) or len(src) != len(dst) or any(
            s.shape != d.shape or s.dtype != d.dtype or (
                s is not d and s.untyped_storage().data_ptr() in held)
            for s, d in zip(src, dst)):
        raise ValueError(
            "a graphed trip writes each result back whole: every state "
            "field needs a tensor of its own, and the body's results "
            "their fields' shapes and dtypes")
    for s, d in zip(src, dst):
        if s is not d:
            d.copy_(s)
    return live_fn(state).any()


def graphed_while(body, live_fn, state):
    """``synced_while`` (unsharded) with each trip after the first
    replayed as one CUDA graph (``graph_route`` says where). The first
    trip runs eagerly, which also warms every lazy set-up its kernels
    have; its state becomes the graph's buffers. A trip is captured (a
    ``solvers.capture`` span) while the card still runs the first one,
    before its liveness read, and replayed while any lane lives, each
    replay counted in ``solvers.graph_replays``. Spans, syncs, values and
    the hand kernels' launch counts are the eager loop's. The graph lives
    for this loop only."""
    if not _any_live(live_fn, state, None):
        return state
    with profiling.span("solvers.iter"):
        state = body(state)
        live = live_fn(state).any()
        trip = _TripGraph(body, live_fn, state)
        with profiling.span("solvers.sync", what="live"):
            go = bool(live)
    while go:
        with profiling.span("solvers.iter"):
            go = trip.replay()
    return state


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
                         k_max: int, ladder=None, dense: bool = True,
                         record_path: bool = False,
                         AT: torch.Tensor | None = None, axis=None,
                         overlap_blocks: int = 1, overlap_mode: str = "psum",
                         axis_size: int | None = None, sync_axes=None):
    """Fast-mode batched homotopy — the slot-space throughput driver.

    A: (m, n) f32; G = AᵀA (n, n), or None to run gram-free; Y: (b, m), all
    on one device. Returns (X (b, n), HomotopyReportArrays of per-lane
    tensors). ``ladder`` controls the capacity tiers (see _plan_tiers).
    ``AT``: the gram-free route's ``transposed_copy(A)``, made in the same
    precision scope; made here when not given.

    ``dense=False`` skips the final (b, n) scatter and returns the
    compact slot-space solution ``((values, indices), report)`` — values
    (b, k_max) at columns indices (b, k_max), sentinel ``n`` marking
    empty slots; ``densify_batch`` rebuilds the dense X exactly.

    ``record_path=True`` also records the LARS/LASSO breakpoint history
    the loop visits (see solvers/homotopy.py ``record_path``) and returns
    it as a third element ``(hist_v (b, T, k_max), hist_i (b, T, k_max),
    hist_l (b, T))`` with T = max_iterations + 1: row 0 is the λ-max end
    (x = 0, λ0 = ‖Aᵀy‖∞), and each live lane's iteration writes its
    post-transition slot state at row ``it``; frozen lanes write
    nothing.

    ``axis`` (a process group) runs the driver row-sharded: A (m_local,
    n) and Y (b, m_local) are this rank's rows, G is replicated, and the
    reductions over rows end in all-reduces over ``axis``.
    ``overlap_blocks``, ``overlap_mode`` and ``axis_size`` shape the q
    reduction (``make_qprod``); ``sync_axes`` is a group over which every
    rank runs the same number of loop trips (``synced_while``)."""
    n = A.shape[1]
    b = Y.shape[0]
    T = max_iterations + 1
    dev = A.device
    if b == 0:
        report = HomotopyReportArrays(
            iter=torch.zeros(0, dtype=torch.int32, device=dev),
            solution_error=torch.zeros(0, dtype=A.dtype, device=dev))
        out = (torch.zeros((0, n), dtype=A.dtype, device=dev) if dense
               else (torch.zeros((0, k_max), dtype=A.dtype, device=dev),
                     torch.full((0, k_max), n, dtype=torch.int32,
                                device=dev)))
        if record_path:
            return out, report, (
                torch.zeros((0, T, k_max), dtype=A.dtype, device=dev),
                torch.full((0, T, k_max), n, dtype=torch.int32, device=dev),
                torch.zeros((0, T), dtype=A.dtype, device=dev))
        return out, report
    tiers = _plan_tiers(k_max, max_iterations, ladder)
    state = hist = None
    for t, Kt in enumerate(tiers):
        # non-final tiers stop before any lane could need slot Kt
        cap = None if t == len(tiers) - 1 else Kt - 1
        if G is None and AT is None:
            AT = transposed_copy(A)
        with profiling.span("solvers.tier", K=Kt):
            init, body, lane_live = make_stepper(
                A, G, Y, tolerance, max_iterations, Kt, it_cap=cap, AT=AT,
                axis=axis, overlap_blocks=overlap_blocks,
                overlap_mode=overlap_mode, axis_size=axis_size)
            state = init() if state is None else _embed(state, Kt, n)
            if record_path:
                hist = _grow_history(hist, state, T, Kt, n)

                def body(s, _body=body, _live=lane_live):
                    with profiling.span("solvers.sync", what="read"):
                        lanes = _live(s).nonzero()[:, 0]
                    s = _body(s)
                    rows = s.it[lanes].long()
                    for h, v in zip(hist, (s.x_act, s.indices, s.c_inf)):
                        h[lanes, rows] = v[lanes]
                    return s
            if graph_route(state, sharded=axis is not None
                           or sync_axes is not None, host_reads=record_path):
                state = graphed_while(body, lane_live, state)
            else:
                state = synced_while(body, lane_live, state, sync_axes)
    if dense:
        out = active_set.scatter(state.x_act, state.indices, n)
    else:
        out = (state.x_act, state.indices)
    report = HomotopyReportArrays(iter=state.it, solution_error=state.c_inf)
    if record_path:
        return out, report, hist
    return out, report


def _grow_history(hist, state: _BState, T: int, K: int, n: int):
    """The breakpoint history at capacity K: started from the initial
    state (row 0), or the previous tier's zero-padded (sentinel n)."""
    if hist is None:
        b = state.c.shape[0]
        hv = state.x_act.new_zeros((b, T, K))
        hi = torch.full((b, T, K), n, dtype=torch.int32,
                        device=state.c.device)
        hl = state.c_inf.new_zeros((b, T))
        hl[:, 0] = state.c_inf
        return hv, hi, hl
    p = K - hist[0].shape[2]
    return (F.pad(hist[0], (0, p)), F.pad(hist[1], (0, p), value=n), hist[2])


def densify_batch(values, indices, n: int) -> torch.Tensor:
    """Scatter a compact slot-space batch solution (``dense=False``) back
    to dense (b, n) — values (b, K) at columns indices (b, K), sentinel
    ``n`` = empty slot. Takes numpy arrays or tensors."""
    values = torch.as_tensor(values)
    indices = torch.as_tensor(indices, device=values.device)
    return active_set.scatter(values, indices, n)


def make_stepper(A: torch.Tensor, G: torch.Tensor | None, Y: torch.Tensor,
                 tolerance, max_iterations: int, k_max: int,
                 it_cap: int | None = None, AT: torch.Tensor | None = None,
                 axis=None, overlap_blocks: int = 1,
                 overlap_mode: str = "psum", axis_size: int | None = None):
    """Build ``(init, body, lane_live)`` for the batch driver — exposed so
    tests can step the iteration. ``init()`` computes the initial state;
    ``body(s)`` runs one iteration and consumes ``s`` (in-place updates);
    ``lane_live(s)`` is the per-lane do-while condition. ``it_cap``
    freezes lanes at an iteration bound (a capacity-ladder tier). ``G=None``
    runs gram-free (``make_insert_column``). ``axis`` is the row group of
    a sharded run; the overlap arguments shape its q reduction
    (``make_qprod``)."""
    b = Y.shape[0]
    n = A.shape[1]
    K = k_max
    dtype = A.dtype
    if overlap_blocks > 1 and axis is None:
        raise ValueError(
            "overlap_blocks splits the sharded q psum into column-block "
            "collectives; without a shard axis there is no psum to "
            "overlap — pass axis=... or overlap_blocks=1")
    if dtype != torch.float32:
        raise ValueError(
            "the batch-native driver is float32 (its kernels are); got "
            f"{dtype}")
    # every comparison with tol happens in f32, as in the JAX driver
    tol = float(torch.tensor(float(tolerance), dtype=dtype))
    prec = blas.current_precision()
    dev = A.device
    bidx = torch.arange(b, device=dev)
    psum = ((lambda v: collectives.all_reduce(v, axis)) if axis is not None
            else _identity)
    qprod = make_qprod(A, psum, overlap_blocks, overlap_mode, axis,
                       axis_size)
    gdiag, insert_column = make_insert_column(A, G, AT, psum)

    def init() -> _BState:
        # solve_homotopy_core's init, batched (homotopy-cpu.cpp:215-229)
        with blas.precision_scope(prec):
            C0 = psum(blas.xgemm(Y, A))            # c0 = Aᵀy per lane
        idx0 = torch.argmax(C0.abs(), dim=1).to(torch.int32)
        c0 = _take1(C0, idx0)
        c_inf0 = c0.abs()
        vtv0 = gdiag[idx0.long()]
        # initial direction: sign of ‖c‖∞ (+1), NOT sign(c[idx0]) — the
        # reference quirk; the slot's tracked correlation is c[idx0]
        ds0 = _sign_deadzone(c_inf0, tol) / vtv0
        zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
        mask = torch.zeros((b, n), dtype=torch.int8, device=dev)
        # the scalar 1 is uploaded from the host, which waits for the
        # device
        with profiling.span("solvers.sync", what="copy"):
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
        D = active_set.scatter(s.d_act, s.indices, n)
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

        u1, vtv = insert_column(idx, s.indices)
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
