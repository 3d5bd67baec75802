"""Multi-device sharded solves — the port of ``sparse_solvers_tpu/parallel/
sharding.py``: A's rows over a mesh of processes, the batch over a second
axis.

The design is the JAX package's (SURVEY.md §2.4): each rank holds a row
shard of A and computes partial correlations Aᵀ_shard·r_shard, summed by
one all-reduce over its row group per product; the small active-set state
(the γ scan, the K_max² inverse) is replicated across the row group; the
batch of signals splits over the data axis, whose lanes never
communicate.

JAX's mesh routes are single-controller (``shard_map`` over a device
mesh); torch.distributed is SPMD, so the port maps one onto the other:

  * ``Mesh`` is a (data, row) grid of the group's ranks, filled row-major
    as JAX's ``make_mesh`` fills its device grid, with one process group
    per row of the grid (a "row group": the ranks that share a data slice
    and split A's rows), one per column (a "data group") and one over
    all. Every rank makes every group once, in the same order.
  * Every rank calls a route with the same arguments: the whole problem,
    as arrays or tensors on any device. The route hands each rank its
    rows of A and Y (zero rows pad m to the row-axis multiple; they are
    inert) and its lanes of the batch (the batch must divide over the
    data axis; the façades pad it), and every rank returns the whole
    answer on the mesh's device: the lanes are all-gathered over the data
    group, as JAX's caller sees one global array.
  * ``psum`` over "row" is an all-reduce over the row group, a ``psum``
    over both axes one over all ranks, ``all_gather`` an all-gather over
    the row group and ``ppermute`` a send/receive step around it
    (``ops/collectives.py``, which counts them).
  * The certified re-solve is decided on the gathered certificates of the
    whole batch, which every rank holds bit for bit, so every rank takes
    the same branch (JAX's ``sharding.py:332-366``).

Every argument is validated before the first collective, identically on
every rank: a rank that raises while its peers wait in a collective would
hang them.

Mesh axes:
  * "row"  — partitions A's rows / the signal's m dimension
  * "data" — partitions the signal batch
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .. import certify
from ..linalg.active_set import compact_from_dense
from ..ops import blas, collectives
from ..ops.operators import ColShardedOperator, RowShardedOperator
from ..solvers.cosamp import solve_cosamp
from ..solvers.homotopy import HomotopyReportArrays, solve_homotopy_core
from ..solvers.homotopy_batch import (densify_batch, route_batch_native,
                                      solve_homotopy_batch, transposed_copy)
from ..solvers.irls import IrlsReportArrays, solve_irls_core
from ..solvers.irls_cg import solve_irls_cg_core
from ..solvers.omp import OmpReportArrays, solve_omp_core
from ..solvers.omp_batch import solve_omp_batch
from ..utils import ndview

ROW_AXIS = "row"
DATA_AXIS = "data"

# The collective timeout given to ``distributed.initialize``, which every
# mesh group takes too (None: torch's default for the backend), so that a
# rank left waiting on a peer fails in its group as in the default one
_GROUP_TIMEOUT = None

# Replicated Gram matrices above this size are not built automatically in
# the sharded solver (n² bytes on every rank)
_SHARDED_GRAM_AUTO_BYTES = 1 << 30


class Mesh:
    """A (data, row) grid of the process group's ranks (rank = data index
    · n_row + row index) on one device per rank, with its process groups:
    ``row_group`` (this rank's data slice, which splits A's rows),
    ``data_group`` (the ranks holding the same rows) and ``world`` (every
    rank). ``shape`` is ``{"data": n_data, "row": n_row}`` as JAX's
    ``Mesh.shape``. The groups run on the device's backend: NCCL on a
    card, gloo on the CPU, with the collective timeout given to
    ``distributed.initialize``. Made by ``make_mesh``."""

    def __init__(self, n_data: int, n_row: int, device: torch.device):
        self.shape = {DATA_AXIS: n_data, ROW_AXIS: n_row}
        self.device = device
        self.backend = "nccl" if device.type == "cuda" else "gloo"
        self.rank = dist.get_rank()
        self.data_index, self.row_index = divmod(self.rank, n_row)
        self.row_group = self.data_group = None
        for d in range(n_data):
            group = dist.new_group([d * n_row + r for r in range(n_row)],
                                   backend=self.backend,
                                   timeout=_GROUP_TIMEOUT)
            if d == self.data_index:
                self.row_group = group
        for r in range(n_row):
            group = dist.new_group([d * n_row + r for d in range(n_data)],
                                   backend=self.backend,
                                   timeout=_GROUP_TIMEOUT)
            if r == self.row_index:
                self.data_group = group
        self.world = dist.new_group(list(range(n_data * n_row)),
                                    backend=self.backend,
                                    timeout=_GROUP_TIMEOUT)

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape[DATA_AXIS]}, "
                f"row={self.shape[ROW_AXIS]}, device={self.device}, "
                f"backend={self.backend!r})")


def _local_rank() -> int:
    """This process's card under a launcher (``LOCAL_RANK``), else its
    rank modulo the cards torch sees."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() % max(1, torch.cuda.device_count())


def make_mesh(n_row: int | None = None, n_data: int = 1,
              device=None) -> Mesh:
    """Build a (data, row) mesh over every rank of the default process
    group (``parallel/distributed.initialize``). ``n_row`` defaults to
    all ranks over ``n_data``; n_data · n_row must equal the group's size.
    ``device`` defaults to the card, ``cuda:LOCAL_RANK``; where torch sees
    no card that is an error, as it is for the façades: the CPU is asked
    for with ``device="cpu"``, never taken silently. A CUDA mesh runs NCCL
    groups (and sets the current device, as NCCL needs before its first
    collective) and a CPU mesh gloo groups, whatever the default group's
    backend. Every rank must call this with the same arguments, in the
    same order as its other ``make_mesh`` calls."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call parallel.distributed."
            "initialize() first")
    world = dist.get_world_size()
    if n_row is None:
        n_row = world // n_data
    if n_row < 1 or n_data < 1 or n_row * n_data != world:
        raise ValueError(
            f"a (data={n_data}, row={n_row}) mesh needs {n_data * n_row} "
            f"ranks; the process group has {world}")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} but torch sees no CUDA device; "
                "pass device='cpu' to run the mesh on the CPU (gloo)")
        if device.index is None:
            device = torch.device("cuda", _local_rank())
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"a mesh runs on CUDA or the CPU, got {device}")
    return Mesh(n_data, n_row, device)


def _dtype_of(A) -> torch.dtype:
    return ndview._resolve_dtype(A.dtype)


def _block(rows, index: int, size: int, stop: int):
    """``rows`` [index·size, (index+1)·size) clipped at ``stop`` along
    axis 0."""
    r0 = min(index * size, stop)
    return rows[r0:min(r0 + size, stop)]


def _fresh(piece, shape, dtype, device) -> torch.Tensor:
    """A new zero tensor of ``shape`` with ``piece`` (array or tensor) in
    its leading corner: a shard never aliases the caller's data, so the
    façades may update it in place."""
    out = torch.zeros(shape, dtype=dtype, device=device)
    if isinstance(piece, np.ndarray):
        piece = torch.from_numpy(np.ascontiguousarray(piece))
    out[tuple(slice(0, s) for s in piece.shape)] = piece.to(device, dtype)
    return out


def shard_rows(mesh: Mesh, A, m_pad: int | None = None,
               dtype=None) -> torch.Tensor:
    """This rank's rows of A (m, ...) zero-padded to ``m_pad`` rows
    (default: m up to the row-axis multiple; JAX's ``_pad_rows`` then the
    row shard), as a new tensor on the mesh's device, in A's dtype
    (``dtype`` overrides it). Zero rows change neither Aᵀ(y−Ax) nor AᵀA
    nor QᵀQ, so solver results are unaffected."""
    S = mesh.shape[ROW_AXIS]
    m = A.shape[0]
    m_pad = m + (-m) % S if m_pad is None else m_pad
    m_loc = m_pad // S
    piece = _block(A, mesh.row_index, m_loc, m)
    return _fresh(piece, (m_loc,) + tuple(A.shape[1:]),
                  dtype or _dtype_of(A), mesh.device)


def _lane_block(mesh: Mesh, b: int):
    d = mesh.shape[DATA_AXIS]
    if b % d:
        raise ValueError(
            f"the batch of {b} signals does not divide over the mesh's data "
            f"axis of {d}; pad it with zero signals (the façades do)")
    return b // d


def shard_signals(mesh: Mesh, Y, m_pad: int, dtype) -> torch.Tensor:
    """This rank's lanes and rows of Y (batch, m ≤ m_pad), zero rows
    padding m to ``m_pad``: (batch / n_data, m_pad / n_row)."""
    b_loc = _lane_block(mesh, Y.shape[0])
    m_loc = m_pad // mesh.shape[ROW_AXIS]
    lanes = _block(Y, mesh.data_index, b_loc, Y.shape[0])
    piece = _block(lanes.T, mesh.row_index, m_loc, Y.shape[1])
    return _fresh(piece.T, (b_loc, m_loc), dtype, mesh.device)


def shard_lanes(mesh: Mesh, Y, dtype) -> torch.Tensor:
    """This rank's lanes of Y (batch, m), every row: (batch / n_data, m)."""
    b_loc = _lane_block(mesh, Y.shape[0])
    lanes = _block(Y, mesh.data_index, b_loc, Y.shape[0])
    return _fresh(lanes, (b_loc, Y.shape[1]), dtype, mesh.device)


def shard_columns(mesh: Mesh, A, dtype=None) -> torch.Tensor:
    """This rank's columns of A (m, n), zero columns padding n to the
    row-axis multiple (inert in CG-IRLS: a zero column adds nothing to
    A D Aᵀ and its x_j = D_j·(Aᵀz)_j = 0): (m, n_pad / n_row)."""
    S = mesh.shape[ROW_AXIS]
    n = A.shape[1]
    n_loc = (n + (-n) % S) // S
    piece = _block(A.T, mesh.row_index, n_loc, n)
    return _fresh(piece.T, (A.shape[0], n_loc), dtype or _dtype_of(A),
                  mesh.device)


def shard_inputs(mesh: Mesh, A, Y):
    """This rank's shards of A (m, n) and Y (batch, m): A's rows padded
    to the row-axis multiple (``shard_rows``) and Y's lanes and matching
    rows (``shard_signals``), in A's dtype. Zero row padding changes
    neither Aᵀ(y−Ax), AᵀA nor QᵀQ, so solver results are unaffected."""
    if Y.shape[1] > A.shape[0]:
        raise ValueError(
            f"Expected signals of length {A.shape[0]} but got {Y.shape[1]}")
    A_local = shard_rows(mesh, A)
    m_pad = A_local.shape[0] * mesh.shape[ROW_AXIS]
    return A_local, shard_signals(mesh, Y, m_pad, A_local.dtype)


def _gather_lanes(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every data slice's lanes of t (b_local, ...), in lane order:
    (n_data · b_local, ...)."""
    got = collectives.all_gather(t, mesh.data_group)
    return got.reshape((-1,) + tuple(t.shape[1:]))


def _gather_out(mesh: Mesh, X, dense: bool):
    if dense:
        return _gather_lanes(mesh, X)
    return tuple(_gather_lanes(mesh, part) for part in X)


def _check_precision(precision: str, allowed) -> None:
    if precision not in allowed:
        names = ", ".join(repr(p) for p in allowed[:-1])
        raise ValueError(f"precision must be {names} or {allowed[-1]!r}, "
                         f"got {precision!r}")


def _overlap_plan(overlap_mode, overlap_blocks, batch_native: bool, S: int,
                  n: int):
    """The q reduction's (overlap_mode, overlap_blocks) of the sharded
    drivers (sharding.py:282-317): "auto" takes the ring when there is a
    row reduction to pipeline and its chunks hold ≥ 128 columns, unless an
    explicit ``overlap_blocks`` keeps the all-reduce form."""
    if overlap_mode not in (None, "auto", "psum", "ppermute"):
        raise ValueError(
            "overlap_mode must be 'auto', 'psum' or 'ppermute', got "
            f"{overlap_mode!r}")
    if overlap_mode in (None, "auto"):
        overlap_mode = ("ppermute"
                        if (batch_native and S > 1 and n >= 128 * S
                            and overlap_blocks is None)
                        else "psum")
    if overlap_mode == "ppermute":
        if not batch_native or S < 2:
            raise ValueError(
                "overlap_mode='ppermute' ring-pipelines the batch-native "
                "driver's q reduction over the row shards; it needs "
                "batch_native=True and a row axis of size >= 2")
        if overlap_blocks not in (None, 1):
            raise ValueError(
                "overlap_blocks is the psum-mode knob; the ppermute ring "
                "always uses S = row-axis chunks")
        overlap_blocks = 1
    elif overlap_blocks is None:
        overlap_blocks = 4 if (batch_native and S > 1 and n >= 512) else 1
    return overlap_mode, overlap_blocks


def _sync_group(mesh: Mesh, overlap_mode: str):
    """The ring's loops run the same trip count over every rank when the
    mesh has a data axis (JAX's ``sync_axes``: ppermute's rendezvous was
    unscoped there)."""
    if overlap_mode == "ppermute" and mesh.shape[DATA_AXIS] > 1:
        return mesh.world
    return None


def _transposed(A_local: torch.Tensor, at_cache):
    """The gram-free drivers' transposed copy of this rank's shard for the
    scope's precision, kept in ``at_cache`` (the façade's dict); None
    without one, and the driver makes its own for the call."""
    if at_cache is None:
        return None
    key = blas.current_precision() == "default"
    if key not in at_cache:
        at_cache[key] = transposed_copy(A_local)
    return at_cache[key]


def _gram_local(mesh: Mesh, A_local: torch.Tensor) -> torch.Tensor:
    """AᵀA from the row shards at "highest": one all-reduced product."""
    with blas.precision_scope("highest"):
        return collectives.all_reduce(
            blas.xgemm(A_local, A_local, trans_a=True), mesh.row_group)


def homotopy_sharded(mesh: Mesh, A, Y, tolerance, max_iterations: int,
                     k_max: int | None = None, gram: bool | None = None,
                     overlap_split: int = 1, precision: str = "high",
                     batch_native: bool | None = None, dense: bool = True,
                     overlap_blocks: int | None = None,
                     overlap_mode: str | None = None, G=None):
    """Row-sharded, batch-sharded homotopy solve.

    A: (m, n), Y: (batch, m) with the batch a multiple of the data axis;
    every rank passes the same. Returns (X (batch, n), HomotopyReportArrays)
    on every rank, on the mesh's device; ``dense=False`` returns
    ``(values, indices, reports)``, the compact slot-space solution (see
    ``Homotopy.solve_batch``).

    ``batch_native`` (default: the port's routing rule on the per-rank
    lane count, ``homotopy_batch.route_batch_native``) runs the slot-space
    driver on each rank's row shard, the q products all-reduced over the
    row group and K2/K3 replicated across it; off, the per-lane core runs
    over a ``RowShardedOperator`` (the only route for float64), and with
    a Gram and few lanes per rank its q = AᵀA·d comes from Gram-column
    gathers, with no collective in its loop.

    ``gram`` (default: on while n² fits in 1 GiB a rank) all-reduces
    AᵀA once per call at the path's precision (``G`` passes one computed
    beforehand, ``gram_replicated``); ``gram=False`` runs without.
    ``overlap_split`` > 1 splits the per-lane core's correlation
    all-reduces into column blocks. ``overlap_blocks`` (driver only;
    auto: 4 when the row axis is sharded and n ≥ 512) splits each q
    all-reduce into column blocks; ``overlap_mode`` ("auto", "psum",
    "ppermute") picks the collective-matmul ring instead (``make_qprod``;
    "auto" takes it when the row axis is sharded and n ≥ 128·S, unless
    ``overlap_blocks`` is given).

    ``precision`` follows the façades ("highest", "high", "default",
    "certified"). Under "certified" the path runs at "default" and each
    lane's ‖Aᵀ(y−Ax)‖∞ is recomputed at "high" (per-shard partial
    correlations, one all-reduce) as its solution_error; lanes whose
    certificate misses the tolerance without exhausting max_iterations
    are re-solved at "high" and merged."""
    A_local, Y_local = shard_inputs(mesh, A, Y)
    if G is not None:
        G = ndview.as_matrix(G, dtype=A_local.dtype, device=mesh.device)
    return _homotopy_placed(mesh, A_local, Y_local, tolerance,
                            max_iterations, m=A.shape[0], k_max=k_max,
                            gram=gram, overlap_split=overlap_split,
                            precision=precision, batch_native=batch_native,
                            dense=dense, overlap_blocks=overlap_blocks,
                            overlap_mode=overlap_mode, G=G)


def _homotopy_placed(mesh: Mesh, A_local, Y_local, tolerance,
                     max_iterations: int, *, m: int, k_max=None, gram=None,
                     overlap_split: int = 1, precision: str = "high",
                     batch_native=None, dense: bool = True,
                     overlap_blocks=None, overlap_mode=None, G=None,
                     at_cache=None):
    """``homotopy_sharded`` on this rank's shards. ``m`` is the row count
    the routing rules read (JAX reads the array it is handed: unpadded
    from a caller, padded from a façade); ``at_cache`` the façade's
    transposed copies of the shard."""
    certify.check_max_iterations(max_iterations)
    _check_precision(precision, ("highest", "high", "default", "certified"))
    n = A_local.shape[1]
    S = mesh.shape[ROW_AXIS]
    k_max = k_max or min(n, max_iterations + 1)
    if G is not None:
        if gram is False:
            raise ValueError("a precomputed G was passed with gram=False")
        gram = True
    if gram is None:
        gram = n * n * A_local.element_size() <= _SHARDED_GRAM_AUTO_BYTES
    if batch_native and overlap_split > 1:
        raise ValueError(
            "overlap_split > 1 splits the vmapped core's correlation "
            "psums; the batch-native driver has no per-correlation psum "
            "to split — use one or the other")
    local_batch = Y_local.shape[0]
    if batch_native is None:
        # overlap_split is a per-lane core construct: auto keeps it there
        sparse = gram and local_batch * k_max < 2 * m and k_max < n
        batch_native = (overlap_split <= 1 and route_batch_native(
            local_batch, n, A_local.dtype, sparse))
    overlap_mode, overlap_blocks = _overlap_plan(
        overlap_mode, overlap_blocks, batch_native, S, n)
    if overlap_blocks > 1 and not batch_native:
        raise ValueError(
            "overlap_blocks splits the batch-native driver's q psum; "
            "the vmapped core's analog is overlap_split")

    def solve(precision=precision):
        return _homotopy_run(
            mesh, A_local, Y_local, G, tolerance, max_iterations, k_max,
            precision, gram, batch_native, overlap_split, dense,
            overlap_blocks, overlap_mode, at_cache)

    return certify.certified_batch(solve, precision == "certified",
                                   tolerance, max_iterations, dense)


def _homotopy_run(mesh: Mesh, A_local, Y_local, G, tolerance,
                  max_iterations: int, k_max: int, precision: str,
                  gram: bool, batch_native: bool, overlap_split: int,
                  dense: bool, overlap_blocks: int, overlap_mode: str,
                  at_cache):
    """One sharded pass (sharding.py:76-161) at ``precision``: this rank's
    lanes solved on its row shard, the certificate under "certified" (the
    path then at "default"), then every lane gathered. Returns (X,
    HomotopyReportArrays) of the whole batch."""
    row = mesh.row_group
    S = mesh.shape[ROW_AXIS]
    n = A_local.shape[1]
    certified = precision == "certified"
    with blas.precision_scope("default" if certified else precision):
        # a replicated Gram handed in (the façade's, computed once) skips
        # the per-call all-reduced build
        if G is None and gram:
            G = collectives.all_reduce(
                blas.xgemm(A_local, A_local, trans_a=True), row)
        if batch_native:
            X, rep = solve_homotopy_batch(
                A_local, G, Y_local, tolerance, max_iterations, k_max,
                dense=dense,
                AT=None if G is not None else _transposed(A_local, at_cache),
                axis=row, overlap_blocks=overlap_blocks,
                overlap_mode=overlap_mode, axis_size=S,
                sync_axes=_sync_group(mesh, overlap_mode))
        else:
            op = RowShardedOperator(A_local, row, G, split=overlap_split)
            # with a replicated Gram and few lanes a rank, q = AᵀA·d comes
            # from Gram-column gathers: no collective per iteration
            sparse = gram and Y_local.shape[0] * k_max < 2 * A_local.shape[
                0] * S
            X, rep = solve_homotopy_core(
                op, n, Y_local, tolerance, max_iterations, k_max,
                sparse_matvec=sparse, compact=not dense)
    err = rep.solution_error
    if certified:
        # per-shard partial correlations of the returned solutions at
        # "high", one all-reduce over the row group
        Xd = X if dense else densify_batch(X[0], X[1], n)
        with blas.precision_scope("high"):
            r_loc = Y_local - blas.xgemm(Xd, A_local, trans_b=True)
            c_part = blas.xgemm(r_loc, A_local)
        err = collectives.all_reduce(c_part, row).abs().amax(dim=-1).to(
            err.dtype)
    return _gather_out(mesh, X, dense), HomotopyReportArrays(
        iter=_gather_lanes(mesh, rep.iter),
        solution_error=_gather_lanes(mesh, err))


def omp_sharded(mesh: Mesh, A, Y, tolerance, max_iterations: int,
                k_max: int | None = None, gram: bool | None = None,
                precision: str = "highest", batch_native: bool | None = None,
                dense: bool = True, overlap_blocks: int | None = None,
                overlap_mode: str | None = None, G=None, picks: int = 1):
    """Row-sharded, batch-sharded OMP over the same (data, row) layout as
    ``homotopy_sharded``: per-pick residual correlations all-reduced once
    over the row group (or gathered from a replicated Gram with no
    collective per pick), the k_max² inverse and the LS coefficients
    replicated; ‖r‖² all-reduced likewise. Returns (X (batch, n),
    OmpReportArrays) on every rank.

    ``batch_native`` runs the slot-space OMP driver on each shard (its q
    products all-reduced, K4 replicated, its reported error the
    all-reduced certificate); ``gram=False`` runs it gram-free. Off, the
    per-lane core runs with the correlation update ``corr`` routed on the
    per-rank lane count (sharding.py:556-562): "gram" where ``gram=True``
    pins it or a Gram is held and lanes·k_max < 2m, else "sparse" below
    that crossover and "dense" past it. ``dense=False`` returns
    ``(values, indices, reports)``. ``overlap_blocks``, ``overlap_mode``
    and ``picks`` (gOMP) as in ``homotopy_sharded`` and ``Omp``.

    ``precision="certified"`` runs the picks at "default" with each
    lane's reported error the all-reduced ℓ₂ residual at "high"; lanes
    that miss the tolerance without exhausting max_iterations re-solve
    at "high"."""
    A_local, Y_local = shard_inputs(mesh, A, Y)
    if G is not None:
        G = ndview.as_matrix(G, dtype=A_local.dtype, device=mesh.device)
    return _omp_placed(mesh, A_local, Y_local, tolerance, max_iterations,
                       m=A.shape[0], k_max=k_max, gram=gram,
                       precision=precision, batch_native=batch_native,
                       dense=dense, overlap_blocks=overlap_blocks,
                       overlap_mode=overlap_mode, G=G, picks=picks)


def _omp_placed(mesh: Mesh, A_local, Y_local, tolerance,
                max_iterations: int, *, m: int, k_max=None, gram=None,
                precision: str = "highest", batch_native=None,
                dense: bool = True, overlap_blocks=None, overlap_mode=None,
                G=None, picks: int = 1, at_cache=None):
    """``omp_sharded`` on this rank's shards (``m`` and ``at_cache`` as in
    ``_homotopy_placed``)."""
    certify.check_max_iterations(max_iterations)
    _check_precision(precision, ("highest", "high", "default", "certified"))
    n = A_local.shape[1]
    S = mesh.shape[ROW_AXIS]
    k_max = k_max or max(1, min(max_iterations, m, n))
    gram_forced = gram is True
    if G is not None:
        if gram is False:
            raise ValueError("a precomputed G was passed with gram=False")
        gram = True
    if gram is None:
        gram = n * n * A_local.element_size() <= _SHARDED_GRAM_AUTO_BYTES
    if picks < 1:
        raise ValueError(f"picks must be >= 1, got {picks}")
    local_batch = Y_local.shape[0]
    small = local_batch * k_max < 2 * m
    if batch_native is None:
        batch_native = (not gram_forced) and route_batch_native(
            local_batch, n, A_local.dtype, sparse=small)
    overlap_mode, overlap_blocks = _overlap_plan(
        overlap_mode, overlap_blocks, batch_native, S, n)
    if overlap_blocks > 1 and not batch_native:
        raise ValueError(
            "overlap_blocks splits the batch-native driver's q psum; "
            "the vmapped pick loop has no per-block product to split")
    if gram_forced or (gram and small):
        corr = "gram"
    else:
        corr = "sparse" if small else "dense"

    def solve(precision=precision):
        return _omp_run(
            mesh, A_local, Y_local, G, tolerance, max_iterations, k_max,
            precision, gram, batch_native, corr, dense, overlap_blocks,
            overlap_mode, picks, at_cache)

    return certify.certified_batch(solve, precision == "certified",
                                   tolerance, max_iterations, dense)


def _omp_run(mesh: Mesh, A_local, Y_local, G, tolerance,
             max_iterations: int, k_max: int, precision: str,
             gram: bool, batch_native: bool, corr: str, dense: bool,
             overlap_blocks: int, overlap_mode: str, picks: int, at_cache):
    """One sharded OMP pass (sharding.py:368-436) at ``precision``, as
    ``_homotopy_run``'s, then every lane gathered: (X, OmpReportArrays) of
    the whole batch."""
    row = mesh.row_group
    n = A_local.shape[1]
    certified = precision == "certified"
    with blas.precision_scope("default" if certified else precision):
        if G is None and gram:
            G = collectives.all_reduce(
                blas.xgemm(A_local, A_local, trans_a=True), row)
        if batch_native:
            # the driver's reported error is the all-reduced certificate
            X, rep = solve_omp_batch(
                A_local, G, Y_local, tolerance, max_iterations, k_max,
                dense=dense, picks=picks,
                AT=None if G is not None else _transposed(A_local, at_cache),
                axis=row, overlap_blocks=overlap_blocks,
                overlap_mode=overlap_mode, axis_size=mesh.shape[ROW_AXIS],
                sync_axes=_sync_group(mesh, overlap_mode))
            err = rep.solution_error
        else:
            op = RowShardedOperator(A_local, row, G)
            X, rep = solve_omp_core(op, n, Y_local, tolerance,
                                    max_iterations, k_max, corr=corr,
                                    picks=picks)
            err = rep.solution_error
            if certified:
                # per-shard partial residual norms at "high", one
                # all-reduce over the row group
                with blas.precision_scope("high"):
                    R = Y_local - blas.xgemm(X, A_local, trans_b=True)
                    err = torch.sqrt(collectives.all_reduce(
                        (R * R).sum(dim=1), row).clamp(min=0)).to(err.dtype)
            if not dense:
                X = compact_from_dense(X, k_max)
    return _gather_out(mesh, X, dense), OmpReportArrays(
        iter=_gather_lanes(mesh, rep.iter),
        solution_error=_gather_lanes(mesh, err))


def gram_replicated(mesh: Mesh, A) -> torch.Tensor:
    """AᵀA of A (m, n) from its row shards, replicated on every rank —
    one all-reduced product at "highest" (the unsharded façades' lazy
    Gram convention). The mesh façades compute it once and pass it to
    every sharded call (``G=``)."""
    return _gram_local(mesh, shard_rows(mesh, A))


def _update_column_local(mesh: Mesh, A_local: torch.Tensor, G, v_local,
                         j: int):
    """Column j of this rank's shard set to ``v_local`` in place, and the
    replicated Gram's row and column j rebuilt from one all-reduced Aᵀv at
    "highest" (sharding.py:632-665). Returns the new G (None without)."""
    A_local[:, j] = v_local
    if G is None:
        return None
    with blas.precision_scope("highest"):
        g = collectives.all_reduce(
            blas.xgemv(A_local, v_local, trans=True), mesh.row_group)
    G = G.clone()
    G[:, j] = g
    G[j, :] = g
    return G


def update_column_sharded(mesh: Mesh, A, G, v, j: int):
    """Replace column j of A (m, n) with ``v`` (m,) and, when a replicated
    Gram ``G`` is held, its row and column j — rebuilt from this rank's
    rows by one all-reduced Aᵀv, not by a new n² Gram. Returns (A2, G2) on
    the mesh's device (G2 None when G is None); A is not modified."""
    m, n = A.shape
    if not 0 <= j < n:
        raise ValueError(f"column index {j} out of range [0, {n})")
    A2 = ndview.as_matrix(A, device=mesh.device).clone()
    v = ndview.as_vector(v, dtype=A2.dtype, size=m, device=mesh.device)
    A2[:, j] = v
    if G is None:
        return A2, None
    G = ndview.as_matrix(G, dtype=A2.dtype, device=mesh.device)
    return A2, _update_column_local(mesh, shard_rows(mesh, A2), G,
                                    shard_rows(mesh, v), j)


def _qr_local(mesh: Mesh, A_local: torch.Tensor, passes: int = 2):
    """CholeskyQR on the row shards (sharding.py:686-714): each pass
    all-reduces the Gram QᵀQ once, Cholesky-factors it on every rank, and
    applies R₁⁻¹ to the local rows. Returns (this rank's Q rows, R)."""
    n = A_local.shape[1]
    eye = torch.eye(n, dtype=A_local.dtype, device=A_local.device)
    Q, R = A_local, eye
    with blas.precision_scope("highest"):
        for _ in range(passes):
            G = collectives.all_reduce(blas.xgemm(Q, Q, trans_a=True),
                                       mesh.row_group)
            L, info = torch.linalg.cholesky_ex(G)
            # a Gram that is not positive definite (rank-deficient A)
            # gives NaNs, as jnp.linalg.cholesky does
            L = torch.where(info == 0, L, torch.full_like(L, float("nan")))
            R1 = L.mT                               # upper, positive diag
            Q = blas.xgemm(Q, blas.xtrsm(R1, eye, lower=False))
            R = blas.xgemm(R1, R)
    return Q, R


def _check_economy(m: int, n: int) -> None:
    if m < n:
        raise ValueError(
            f"qr_sharded requires m >= n (economy QR); got {m}x{n}")


def qr_sharded(mesh: Mesh, A, passes: int = 2):
    """Economy QR of A (m, n), m ≥ n, on the mesh — CholeskyQR2.

    Returns ``(Q, R)`` on every rank: Q (m_padded, n), its rows computed
    by their shards and gathered (padded rows exactly zero), R (n, n)
    upper-triangular with a positive diagonal. Each pass all-reduces the
    (n, n) Gram once; ``passes=2`` squares away the first pass's
    κ(A)-dependent loss of orthogonality. Needs full column rank: rank
    deficiency surfaces as NaNs from the first Cholesky (the reference's
    QR divides by a zero pivot there, qr_decomposition.h:101,227)."""
    m, n = A.shape
    _check_economy(m, n)
    if passes < 1:
        raise ValueError(f"passes must be >= 1, got {passes}")
    Q_local, R = _qr_local(mesh, shard_rows(mesh, A), passes)
    Q = collectives.all_gather(Q_local, mesh.row_group)
    return Q.reshape(-1, n), R


def irls_sharded(mesh: Mesh, Q, R, Y, tolerance, max_iterations: int,
                 mode: str = "fast", newton: str | None = None,
                 stabilized: bool = False):
    """Row-sharded, batch-sharded IRLS given the economy QR of A.

    Q: (m, n) (or ``qr_sharded``'s padded rows), R: (n, n), Y: (batch,
    m); every rank passes the same. In mode="fast" the only collective of
    the solve is the all-reduce of Qᵀy: every iteration is replicated
    O(n²) work. ``newton="gemm"`` applies R⁻¹ (inverted once per call) by
    one product per iteration instead of the triangular solve;
    ``stabilized`` selects the scale-stabilized iteration. Returns (X
    (batch, n), IrlsReportArrays) on every rank."""
    Q_local, Y_local = shard_inputs(mesh, Q, Y)
    R = ndview.as_matrix(R, dtype=Q_local.dtype, device=mesh.device)
    return _irls_placed(mesh, Q_local, R, Y_local, tolerance,
                        max_iterations, mode, newton, stabilized)


def _irls_placed(mesh: Mesh, Q_local, R, Y_local, tolerance,
                 max_iterations: int, mode: str = "fast", newton=None,
                 stabilized: bool = False):
    """``irls_sharded`` on this rank's shards."""
    certify.check_max_iterations(max_iterations)
    if newton not in (None, "trsm", "gemm"):
        raise ValueError(f"newton must be 'trsm' or 'gemm', got {newton!r}")
    r_inv = None
    if mode == "fast" and newton == "gemm":
        r_inv = blas.xtrsm(R, torch.eye(R.shape[0], dtype=R.dtype,
                                        device=R.device), lower=False)
    X, rep = solve_irls_core(RowShardedOperator(Q_local, mesh.row_group), R,
                             Y_local, tolerance, max_iterations, mode=mode,
                             r_inv=r_inv, stabilized=stabilized)
    return _gather_lanes(mesh, X), IrlsReportArrays(
        *(_gather_lanes(mesh, f) for f in rep))


def irls_sharded_from_a(mesh: Mesh, A, Y, tolerance, max_iterations: int,
                        **kwargs):
    """``irls_sharded`` from A itself: the economy QR comes from the mesh
    (``qr_sharded``'s CholeskyQR2 on the row shards, no host
    factorization), then the solve runs sharded. Factor once and solve
    many with ``Irls(A, mesh=...)``."""
    _check_economy(*A.shape)
    A_local, Y_local = shard_inputs(mesh, A, Y)
    Q_local, R = _qr_local(mesh, A_local)
    return _irls_placed(mesh, Q_local, R, Y_local, tolerance,
                        max_iterations, **kwargs)


def cosamp_sharded(mesh: Mesh, A, Y, k_sparsity: int, tolerance,
                   max_iterations: int = 20, precision: str = "highest",
                   m_global: int | None = None):
    """Row-sharded, batch-sharded CoSaMP over the (data, row) layout: per
    round the proxy correlations c = Aᵀr, the ≤ 3k-union Gram BᵀB, the
    rhs Bᵀy and ‖r‖² each all-reduce once over the row group; the S×S
    Cholesky, the selections and the prune run replicated on the
    all-reduced values. The pool clamp sizes by the true row count
    ``m_global`` (default A's rows). Returns (X (batch, n),
    OmpReportArrays) on every rank."""
    certify.check_max_iterations(max_iterations)
    _check_precision(precision, ("highest", "high", "default"))
    A_local, Y_local = shard_inputs(mesh, A, Y)
    return _cosamp_placed(mesh, A_local, Y_local, k_sparsity, tolerance,
                          max_iterations, precision,
                          A.shape[0] if m_global is None else m_global)


def _cosamp_placed(mesh: Mesh, A_local, Y_local, k_sparsity: int, tolerance,
                   max_iterations: int, precision: str, m_global: int,
                   AT=None):
    """``cosamp_sharded`` on this rank's shards; ``AT`` the shard's
    transpose when the caller keeps one."""
    with blas.precision_scope(precision):
        X, rep = solve_cosamp(A_local, Y_local, k_sparsity, tolerance,
                              max_iterations, AT=AT, axis=mesh.row_group,
                              m_global=m_global)
    return _gather_lanes(mesh, X), OmpReportArrays(
        *(_gather_lanes(mesh, f) for f in rep))


def irls_cg_sharded(mesh: Mesh, A, Y, tolerance, max_iterations: int, *,
                    p: float = 1.0, k_sparsity: int | None = None,
                    cg_max_iterations: int | None = None,
                    cg_tolerance: float | None = None):
    """Column-sharded, batch-sharded CG-IRLS (solvers/irls_cg.py).

    A: (m, n) — its **columns** split over the mesh's "row" axis (in the
    underdetermined basis-pursuit regime n is the large dimension; the
    axis name is the mesh's tensor axis), zero columns padding n to the
    axis multiple (inert). Y: (batch, m), lanes over "data", m replicated.
    Every m-sized CG iterate is replicated and x and the weights stay
    column-sharded: one all-reduce (of A·(D∘Aᵀz), m values a lane) per CG
    step, plus per outer step one all-reduce (MAX) of the change's maxima
    and one all-gather of each rank's top K+1 of |x| (the ε rule).
    Returns (X (batch, n), IrlsReportArrays) on every rank."""
    certify.check_max_iterations(max_iterations)
    A_local = shard_columns(mesh, A)
    Y_local = shard_lanes(mesh, Y, A_local.dtype)
    return _irls_cg_placed(mesh, A_local, Y_local, A.shape[1], tolerance,
                           max_iterations, p=p, k_sparsity=k_sparsity,
                           cg_max_iterations=cg_max_iterations,
                           cg_tolerance=cg_tolerance)


def _irls_cg_placed(mesh: Mesh, A_local, Y_local, n: int, tolerance,
                    max_iterations: int, **knobs):
    """``irls_cg_sharded`` on this rank's column shard and lanes; ``n`` is
    the true (unpadded) column count."""
    m, n_local = A_local.shape
    op = ColShardedOperator(A_local, mesh.row_group)
    X, rep = solve_irls_cg_core(op.matvec, op.rmatvec, m, n, Y_local,
                                tolerance, max_iterations,
                                dtype=A_local.dtype, n_local=n_local,
                                n_axis=mesh.row_group, **knobs)
    # this data slice's lanes over every column shard, then every lane
    X = collectives.all_gather(X, mesh.row_group).permute(1, 0, 2)
    X = X.reshape(X.shape[0], -1)[:, :n]
    return _gather_lanes(mesh, X), IrlsReportArrays(
        *(_gather_lanes(mesh, f) for f in rep))
