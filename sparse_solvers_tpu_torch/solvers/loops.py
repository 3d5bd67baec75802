"""The solvers' host loops: the per-lane select, the eager loop
(``synced_while``), the loop that replays each trip after the first as one
CUDA graph (``graphed_while``) and ``run``, the one rule that picks
between them from what its caller observes.

The batch drivers and the per-lane Homotopy core call ``run``; the
per-lane OMP core, IRLS, CG-IRLS and CoSaMP call ``synced_while`` and stay
eager; the per-lane cores step in the carry form ``lanes`` builds.

A caller that solves again with the same shapes keeps its loops' graphs
across calls (``Kept``, which the façades own): a loop given a ``Slot``
that holds a captured trip writes its new state into the tensors that
trip was captured over and replays it from the first trip on, with no
eager trip and no capture.
"""

from __future__ import annotations

import torch

from ..ops import collectives
from ..ops import dispatch as _dispatch
from ..utils import profiling


def _select(keep_new: torch.Tensor, new, old):
    """Per-lane select over (nested) state tuples: ``new`` where
    ``keep_new`` (b,) holds, ``old`` elsewhere."""
    if isinstance(new, tuple):
        return type(new)(*(_select(keep_new, a, b) for a, b in zip(new, old)))
    sel = keep_new.reshape(keep_new.shape + (1,) * (new.dim() - 1))
    return torch.where(sel, new, old)


def lanes(body, cond, state):
    """A per-lane loop in the carry form the loops take: ``(trip,
    live_fn, carry)`` over the carry (state, live). A trip keeps
    ``body``'s results on the live lanes and then runs ``cond``, the test
    that decides the next trip, once."""
    def trip(carry):
        s, live = carry
        s = _select(live, body(s), s)
        return s, cond(s)
    return trip, lambda carry: carry[1], (state, cond(state))


def synced_while(body, live_fn, state, sync_axes=None):
    """The solvers' host loop: ``state = body(state)`` while any lane of
    ``live_fn(state)`` is live (homotopy_batch.py:350-376 of the JAX
    package). ``sync_axes=None``: each rank reads its own lanes (the ranks
    of a row group hold the same replicated state, so they agree). A
    process group: the continue flag is all-reduced (MAX) over it each
    trip, so every rank of it runs the same number of trips; frozen lanes
    pass through the extra trips unchanged. Each trip is a
    ``solvers.iter`` span: the body, then the liveness test that decides
    the next trip, whose read of the flag is a ``solvers.sync`` span; the
    first test lies outside them (``utils/profiling``)."""
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
    """Whether a loop runs through ``graphed_while``: every tensor of its
    state is on a CUDA card, no collective runs in it (``sharded``: a row
    group, a group that syncs the trips, or a row-sharded operator) and
    its body reads nothing on the host (``host_reads``: the batch
    driver's breakpoint history)."""
    return (not sharded and not host_reads
            and all(t.is_cuda for t in _leaves(state)))


def run(body, live_fn, state, *, sharded: bool = False,
        host_reads: bool = False, sync_axes=None, slot=None):
    """``body`` over ``state`` while any lane of ``live_fn`` lives, on the
    loop ``graph_route`` picks from what the caller observes: a collective
    in the loop (``sharded``, or a ``sync_axes`` group, which then syncs
    the trips) and host reads in the body. ``slot`` (a ``Slot``) keeps the
    graph route's trip for the next run of the same loop."""
    if graph_route(state, sharded=sharded or sync_axes is not None,
                   host_reads=host_reads):
        return graphed_while(body, live_fn, state, slot)
    return synced_while(body, live_fn, state, sync_axes)


class Slot:
    """Where one loop keeps its captured trip (a ``_TripGraph``, None
    until the loop first takes the graph route) from one run to the
    next."""

    def __init__(self):
        self.trip = None


class Kept:
    """What a caller keeps of its graph-route loops across calls, for its
    newest key only: ``entry(key)`` is a dict in which the drivers keep
    each loop's ``Slot`` and the tensors and closures their bodies read
    that they would otherwise build per call. The key is everything a
    trip bakes in; another key drops the old entry, and with it its
    graphs and buffers, before anything new is built. Its owner solves
    one call at a time: two at once would write the same buffers."""

    def __init__(self):
        self._key, self._entry = None, {}

    def entry(self, key) -> dict:
        if key != self._key:
            self.drop()
            self._key = key
        return self._entry

    def drop(self) -> None:
        """Forget the entry: its graphs and buffers are freed."""
        self._key, self._entry = None, {}


# per card: the memory pool every trip graph is captured into, the side
# stream captures run on, and the newest graph, which holds the pool open
# between loop calls
_pools: dict = {}
_streams: dict = {}
_newest: dict = {}


def _release_cublas_workspaces(device: torch.device) -> None:
    """Free the workspace cuBLAS keeps for each stream it ran on (a card
    has them; a replay uses the one its capture took)."""
    if device.type == "cuda":
        torch._C._cuda_clearCublasWorkspaces()


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
        # cleared before and after, the capture's own workspace lands in
        # the pool and no stream holds a second one beside the caller's
        _release_cublas_workspaces(device)
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=_pools[key])
            try:
                out = fn()
            finally:
                graph.capture_end()
        _release_cublas_workspaces(device)
        torch.cuda.current_stream(device).wait_stream(stream)
    _newest[key] = graph
    return graph, out


class _TripGraph:
    """One loop trip captured as a CUDA graph over the state's tensors:
    the body, a copy of every field the body replaced back into the
    state's own tensor, and the liveness ``any()`` into ``flag``.
    ``launches`` holds the hand kernels' launches of one trip, which
    ``ops/dispatch.launches`` counted only once, at the capture. It holds
    ``state`` and the body, so that every tensor the graph reads lives as
    long as it does."""

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
        self.state, self._reads = state, (body, live_fn)

    def load(self, state):
        """Write ``state`` into the tensors the trip was captured over
        (a field that already is one is left as it is); returns them."""
        dst, src = _leaves(self.state), _leaves(state)
        if len(src) != len(dst) or any(
                s.shape != d.shape or s.dtype != d.dtype
                for s, d in zip(src, dst)):
            raise ValueError(
                "a kept trip graph replays only on a state of the shapes "
                "and dtypes it was captured over")
        for s, d in zip(src, dst):
            if s is not d:
                d.copy_(s)
        return self.state

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


def graphed_while(body, live_fn, state, slot=None):
    """``synced_while`` (unsharded) with each trip replayed as one CUDA
    graph (``graph_route`` says where). A loop without a kept trip runs
    its first trip eagerly, which also warms every lazy set-up its kernels
    have, and writes its results back into ``state``'s own tensors, which
    become the graph's buffers; it captures a trip (a ``solvers.capture``
    span) while the card still runs the first one, before its liveness
    read, and keeps it in ``slot`` when one is given. A loop whose
    ``slot`` holds a trip writes ``state`` into that trip's tensors and
    replays it from the first trip on (counted once in
    ``solvers.graph_reuses``), as a capture does releasing the cuBLAS
    workspaces, which no replay uses. Each replay is counted in
    ``solvers.graph_replays``. Spans, syncs, values and the hand kernels'
    launch counts are the eager loop's. Returns the state's tensors: a
    kept trip's, which its next run overwrites."""
    trip = None if slot is None else slot.trip
    if trip is not None:
        state = trip.load(state)
    if not _any_live(live_fn, state, None):
        return state
    if trip is None:
        with profiling.span("solvers.iter"):
            live = _captured_trip(body, live_fn, state)
            trip = _TripGraph(body, live_fn, state)
            with profiling.span("solvers.sync", what="live"):
                go = bool(live)
        if slot is not None:
            slot.trip = trip
    else:
        profiling.count("solvers.graph_reuses")
        _release_cublas_workspaces(_leaves(state)[0].device)
        go = True
    while go:
        with profiling.span("solvers.iter"):
            go = trip.replay()
    return state
