"""The drivers' graph route (``loops.graph_route`` and ``graphed_while``,
chosen by ``loops.run``) on the CPU: the rule that picks it, the loops that stay
on ``synced_while`` (CPU tensors, a row group or a group that syncs the
trips, a row-sharded operator, the batch driver's breakpoint history),
the OMP batch driver asking the same rule, the trip's write-back into the
state's tensors run through an eager stand-in for the CUDA graph
(bit-equal to the eager loop for Homotopy's loops and for OMP, gOMP and
gram-free OMP, the same spans, one replay counted a trip after the
first), and the γ scan's bound filled on the device bit for bit as the
host upload gave it. Graphs kept across a façade's calls (``loops.Kept``):
a sequence of calls bit-equal to the eager loop with each loop captured
once and then replayed from its first trip (one ``solvers.graph_reuses``
a reused loop), answers that the next call leaves alone, another key or
``update_column`` freeing the kept entry, the "high" re-solve capturing
anew and keeping nothing, a deleted façade freeing its graphs, and a kept
trip refusing a state of other shapes. The CUDA graph itself runs in
``tests/test_torch_cuda.py``.
"""

import weakref

import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

import sparse_solvers_tpu_torch as pt
from _torch_cases import TORCH_ROUTE, compressive_problem
from sparse_solvers_tpu_torch.ops import blas, collectives
from sparse_solvers_tpu_torch.ops.operators import (DenseOperator,
                                                    RowShardedOperator)
from sparse_solvers_tpu_torch.solvers import homotopy as core
from sparse_solvers_tpu_torch.solvers import homotopy_batch as hb
from sparse_solvers_tpu_torch.solvers import loops, omp_batch
from sparse_solvers_tpu_torch.utils import profiling

TOL = 0.01
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def fresh_records():
    profiling.clear()
    yield
    profiling.clear()


class _OnCard:
    """A stand-in leaf that says it lives on a card."""
    is_cuda = True


class _EagerGraph:
    """Stands in for a captured trip: a replay runs the trip's function
    eagerly and writes its flag where the graph would."""

    def __init__(self, fn):
        self.fn = fn
        self.flag = torch.zeros((), dtype=torch.bool)

    def replay(self):
        self.flag.copy_(self.fn())


def _eager_capture(fn, device):
    graph = _EagerGraph(fn)
    return graph, graph.flag


def _rule_says(mp, rule):
    """Replace the rule where every loop looks it up."""
    mp.setattr(loops, "graph_route", rule)


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """The graph route taken on the CPU, with eager stand-in graphs."""
    _rule_says(monkeypatch, lambda *a, **k: True)
    monkeypatch.setattr(loops, "_capture", _eager_capture)


def _t(a):
    return torch.from_numpy(a)


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


@pytest.mark.parametrize("sharded,host_reads,leaf,want", [
    (False, False, _OnCard(), True),
    (False, False, torch.zeros(2), False),      # CPU tensors
    (True, False, _OnCard(), False),            # a row group or sync group
    (False, True, _OnCard(), False),            # the breakpoint history
    (True, True, _OnCard(), False)])
def test_the_rule_takes_the_graph_route_only_on_an_unsharded_card_loop(
        sharded, host_reads, leaf, want):
    state = (leaf, (_OnCard(), leaf))
    assert loops.graph_route(state, sharded=sharded,
                             host_reads=host_reads) is want


def test_a_state_with_one_cpu_tensor_stays_eager():
    assert not loops.graph_route((_OnCard(), torch.zeros(1)))


@pytest.mark.parametrize("case", ["plain", "record_path", "axis",
                                  "sync_axes", "dense_core", "row_core"])
def test_each_loop_asks_the_rule_with_what_it_observes(case, monkeypatch):
    """The drivers hand the rule their state and whether a collective
    runs in the loop or the body reads the host; on the CPU the rule
    answers eager, and the loop runs ``synced_while``."""
    A, Y, _ = compressive_problem(64, 128, 4, 3, seed=5)
    A, Y = _t(A), _t(Y)
    asked = []
    real = loops.graph_route

    def spy(state, sharded=False, host_reads=False):
        asked.append((sharded, host_reads))
        assert not real(state, sharded, host_reads)   # CPU tensors
        return real(state, sharded, host_reads)

    def no_graph(*a):
        raise AssertionError("the graph route ran")
    monkeypatch.setattr(loops, "graph_route", spy)
    monkeypatch.setattr(loops, "graphed_while", no_graph)
    # one process: the group's sum and max are the rank's own values
    monkeypatch.setattr(collectives, "all_reduce",
                        lambda t, group, op="sum": t)
    kw = dict(record_path=case == "record_path",
              axis=object() if case == "axis" else None,
              sync_axes=object() if case == "sync_axes" else None)
    if case.endswith("core"):
        op = (DenseOperator(A) if case == "dense_core"
              else RowShardedOperator(A, object()))
        core.solve_homotopy_core(op, 128, Y, TOL, 20, 21)
        assert asked == [(case == "row_core", False)]
    else:
        hb.solve_homotopy_batch(A, A.T @ A, Y, TOL, 20, 21, ladder=False,
                                **kw)
        assert asked == [(case in ("axis", "sync_axes"),
                          case == "record_path")]


@pytest.mark.parametrize("case", ["plain", "axis", "sync_axes"])
def test_the_omp_driver_asks_the_rule_with_what_it_observes(case,
                                                            monkeypatch):
    """OMP's driver hands the rule its state and whether a row group or
    a trip-sync group is in force. The rule, answering as it would on a
    card, sends the unsharded loop through the (stand-in) graphs, one
    replay a round after each tier's first, and the sharded ones through
    ``synced_while``, which counts no replay."""
    asked = []
    real = loops.graph_route

    def on_card(state, sharded=False, host_reads=False):
        asked.append((sharded, host_reads))
        return real(tuple(_OnCard() for _ in loops._leaves(state)), sharded,
                    host_reads)
    _rule_says(monkeypatch, on_card)
    monkeypatch.setattr(loops, "_capture", _eager_capture)
    # one process: the group's sum and max are the rank's own values
    monkeypatch.setattr(collectives, "all_reduce",
                        lambda t, group, op="sum": t)
    A, Y, _ = compressive_problem(128, 512, 6, 8, seed=2)
    A, Y = _t(A), _t(Y)
    with torch.profiler.profile(activities=CPU):
        with profiling.span("call"):
            _, rep = omp_batch.solve_omp_batch(
                A, A.T @ A, Y, 1e-3, 12, 16, ladder=[4, 16],
                axis=object() if case == "axis" else None,
                sync_axes=object() if case == "sync_axes" else None)
    [call] = profiling.calls()
    sharded = case != "plain"
    assert asked == [(sharded, False)] * 2
    trips = [s for s in call.spans if s.name == "solvers.iter"]
    assert int(rep.iter.max()) > 4
    # every trip counts its pass and its one insert, on either loop
    assert call.counters["omp.passes"] == len(trips)
    assert call.counters["omp.sub_inserts"] == len(trips)
    if sharded:
        assert "solvers.graph_replays" not in call.counters
    else:
        assert call.counters["solvers.graph_replays"] == len(trips) - 2


@pytest.mark.parametrize("entry", ["solve_batch", "solve"])
def test_the_eager_route_counts_no_replay_and_no_capture(entry):
    A, Y, _ = compressive_problem(128, 512, 6, 8, seed=1)
    solver = pt.Homotopy(A, k_max=64, **TORCH_ROUTE)
    with torch.profiler.profile(activities=CPU):
        if entry == "solve":
            solver.solve(Y[0], TOL, 60)
        else:
            solver.solve_batch(Y, TOL, 60)
    [call] = profiling.calls()
    assert call.counters.get("solvers.graph_replays", 0) == 0
    assert not [s for s in call.spans if s.name == "solvers.capture"]
    assert [s for s in call.spans if s.name == "solvers.iter"]


def _batch(gram, ladder):
    A, Y, _ = compressive_problem(128, 512, 14, 6, seed=7)
    A, Y = _t(A), _t(Y)
    with blas.precision_scope("default"):
        return hb.solve_homotopy_batch(
            A, A.T @ A if gram else None, Y, TOL, 40, 48, ladder=ladder)


def _core(mode, record_path):
    A, Y, _ = compressive_problem(64, 256, 5, 3, seed=3)
    return core.solve_homotopy_core(
        DenseOperator(_t(A)), 256, _t(Y), TOL, 30, 31, mode=mode,
        use_gk=mode == "fast", record_path=record_path)


def _omp(gram, ladder, picks):
    A, Y, _ = compressive_problem(128, 512, 14, 6, seed=7)
    A, Y = _t(A), _t(Y)
    with blas.precision_scope("default"):
        return omp_batch.solve_omp_batch(
            A, A.T @ A if gram else None, Y, TOL, 24, 24, ladder=ladder,
            picks=picks)


CASES = {
    "batch_tiers": lambda: _batch(True, [16, 32, 48]),
    "batch_gram_free": lambda: _batch(False, False),
    "core_fast": lambda: _core("fast", False),
    "core_exact_path": lambda: _core("exact", True),
    "omp_tiers": lambda: _omp(True, [4, 8, 24], 1),
    "omp_gomp": lambda: _omp(True, [4, 12, 24], 4),
    "omp_gram_free": lambda: _omp(False, False, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stand_in_graphs_replay_the_eager_loop_bit_for_bit(
        case, stand_in_graphs, monkeypatch):
    """With each captured trip replaced by its eager stand-in, the graph
    route's write-back into the state's tensors gives the eager loop's
    values bit for bit and its spans and syncs, one
    ``solvers.graph_replays`` a trip after each loop's first and one
    ``solvers.capture`` a loop, made during its first trip."""
    runs = {}
    for route in ("graph", "eager"):
        with monkeypatch.context() as mp:
            if route == "eager":
                _rule_says(mp, lambda *a, **k: False)
            profiling.clear()
            with torch.profiler.profile(activities=CPU):
                with profiling.span("call"):
                    out = CASES[case]()
            [call] = profiling.calls()
            runs[route] = (_flat(out), call)
    (got, gcall), (want, ecall) = runs["graph"], runs["eager"]
    assert len(got) == len(want)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    names = lambda c, n: [s for s in c.spans if s.name == n]
    trips = len(names(ecall, "solvers.iter"))
    loops = max(1, len(names(ecall, "solvers.tier")))
    captures = len(names(gcall, "solvers.capture"))
    assert len(names(gcall, "solvers.iter")) == trips
    assert len(names(gcall, "solvers.sync")) == len(names(ecall,
                                                          "solvers.sync"))
    assert captures == loops
    assert gcall.counters["solvers.graph_replays"] == trips - loops
    assert "solvers.graph_replays" not in ecall.counters
    # every other counter (the OMP driver's passes and sub-inserts) is the
    # eager loop's: a replay counts what the trip issued
    own = lambda c: {k: v for k, v in c.counters.items()
                     if not k.startswith("solvers.graph")}
    assert own(gcall) == own(ecall)
    if case.startswith("omp"):
        picks = 4 if case == "omp_gomp" else 1
        assert own(ecall) == {"omp.passes": trips,
                              "omp.sub_inserts": picks * trips}


def test_write_back_refuses_what_it_cannot_write_back_whole():
    """A body's results go back into the state's own tensors: results of
    another shape, a result that is another field's tensor, and two
    fields that share one are refused; an in-place field and a new
    result are written back."""
    a, b = torch.arange(4.0), torch.arange(4.0) + 10
    flag = loops._captured_trip(lambda s: (s[0].add_(1), s[1] * 2),
                                lambda s: s[0] > 4, (a, b))
    assert torch.equal(a, torch.arange(4.0) + 1)
    assert torch.equal(b, 2 * torch.arange(4.0) + 20)
    assert not bool(flag)
    for body, state in [(lambda s: (s[0][:2], s[1]), (a, b)),
                        (lambda s: (s[1], s[0]), (a, b)),
                        (lambda s: (s[0][:4], s[1]), (a, b)),
                        (lambda s: (s[0] + 1, s[1] + 1), (a, a[:4]))]:
        with pytest.raises(ValueError, match="written back|writes each"):
            loops._captured_trip(body, lambda s: s[0] > 0, state)


def _gamma_with_host_upload(q, c, x, direction, c_inf, mask, dtype):
    """``_find_max_gamma`` as it read before the bound was filled on the
    device: the dtype's max uploaded from the host."""
    big = torch.tensor(torch.finfo(dtype).max, dtype=dtype, device=q.device)
    t_active = -x / direction
    cand_active = torch.where((t_active > 0) & (t_active < big), t_active,
                              big)
    dl, dr = 1 - q, 1 + q
    ci = c_inf.unsqueeze(-1)
    tl, tr = (ci - c) / dl, (ci + c) / dr
    cl = torch.where((dl != 0) & (tl > 0) & (tl < big), tl, big)
    cr = torch.where((dr != 0) & (tr > 0) & (tr < big), tr, big)
    cand = torch.where(mask, cand_active, torch.minimum(cl, cr))
    idx = torch.argmin(cand, dim=-1)
    return cand.gather(-1, idx.unsqueeze(-1)).squeeze(-1), idx


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_scan_bound_filled_on_the_device_is_bit_identical(dtype):
    """Random lanes with q = ±1 (a zero denominator), zero directions,
    ties, and a lane with no valid candidate (every value the max)."""
    g = torch.Generator().manual_seed(9)
    b, n = 6, 300
    q = torch.randn(b, n, generator=g, dtype=dtype)
    q[0, :10] = 1.0
    q[1, :10] = -1.0
    c = torch.randn(b, n, generator=g, dtype=dtype)
    x = torch.randn(b, n, generator=g, dtype=dtype)
    direction = torch.randn(b, n, generator=g, dtype=dtype)
    direction[2, :50] = 0.0
    c[3, 5] = c[3, 6]
    q[3, 5] = q[3, 6]
    c_inf = c.abs().amax(dim=1)
    mask = torch.rand(b, n, generator=g) < 0.1
    # lane 5: every candidate invalid
    c[5], q[5], x[5], direction[5] = 0.0, 1.0, 0.0, 1.0
    c_inf[5] = 0.0
    args = (q, c, x, direction, c_inf, mask, dtype)
    gamma, idx = core._find_max_gamma(*args)
    want_gamma, want_idx = _gamma_with_host_upload(*args)
    assert torch.equal(gamma, want_gamma) and torch.equal(idx, want_idx)
    assert gamma[5] == torch.finfo(dtype).max


# --- graphs kept across a façade's calls -----------------------------------

def _names(call, name):
    return [s for s in call.spans if s.name == name]


def _loops_run(call) -> set:
    """The loops of a call that made a trip: each tier's capacity K (the
    batch drivers' ``solvers.tier`` spans around at least one trip), or
    the core's one loop."""
    tiers = _names(call, "solvers.tier")
    if not tiers:
        return {"core"} if _names(call, "solvers.iter") else set()
    parents = {s.parent_id for s in _names(call, "solvers.iter")}
    return {t.attrs["K"] for t in tiers if t.span_id in parents}


FACADES = {
    # the slot-space driver: batch·k_max ≥ 2m, tiers 16, 24 and 48
    "homotopy_batch": (lambda A: pt.Homotopy(A, k_max=48, precision="default",
                                             **TORCH_ROUTE), 6, 40),
    # the per-lane core: a single solve
    "homotopy_core": (lambda A: pt.Homotopy(A, precision="default",
                                            **TORCH_ROUTE), None, 40),
    # the OMP driver: batch·k_max ≥ 2m, tiers 16, 24 and 48
    "omp": (lambda A: pt.Omp(A, k_max=48, precision="default",
                             **TORCH_ROUTE), 12, 40),
    "gomp": (lambda A: pt.Omp(A, k_max=48, precision="default", picks=4,
                              **TORCH_ROUTE), 12, 40),
}


def _signals(kind, seed):
    batch = FACADES[kind][1]
    A, Y, _ = compressive_problem(128, 512, 14, batch or 1, seed=seed)
    return A, Y if batch else Y[0]


def _solve(solver, kind, Y, tol=TOL, max_iterations=None):
    max_iterations = max_iterations or FACADES[kind][2]
    if FACADES[kind][1] is None:
        x, rep = solver.solve(Y, tol, max_iterations)
        return [x, torch.tensor(rep.iter), torch.tensor(rep.solution_error)]
    X, rep = solver.solve_batch(Y, tol, max_iterations)
    return [X, rep.iter, rep.solution_error]


def _traced(fn):
    """``fn()`` under the CPU profiler: (its result, its call record)."""
    profiling.clear()
    with torch.profiler.profile(activities=CPU):
        out = fn()
    [call] = profiling.calls()
    return out, call


def _kept_tensor(solver):
    """A state tensor of one of the façade's kept trips."""
    slots = [v for v in solver._kept._entry.values()
             if isinstance(v, loops.Slot) and v.trip is not None]
    assert slots
    return loops._leaves(slots[0].trip.state)[1]


@pytest.mark.parametrize("kind", sorted(FACADES))
def test_kept_graphs_replay_a_sequence_of_calls_as_the_eager_loop(
        kind, stand_in_graphs, monkeypatch):
    """Four calls with different signals on one façade: every answer
    bit-equal to the eager loop's on another façade, every loop (a tier)
    captured once, in the first call that runs it, with an eager first
    trip, and replayed from its first trip in every later call, one
    ``solvers.graph_reuses`` a reused loop."""
    A = _signals(kind, 0)[0]
    Ys = [_signals(kind, seed)[1] for seed in (0, 1, 2, 0)]
    graph = FACADES[kind][0](A)
    with monkeypatch.context() as mp:
        _rule_says(mp, lambda *a, **k: False)
        eager = FACADES[kind][0](A)
        want = [_solve(eager, kind, Y) for Y in Ys]
    seen, reused = set(), 0
    for i, Y in enumerate(Ys):
        got, call = _traced(lambda: _solve(graph, kind, Y))
        assert all(torch.equal(g, w) for g, w in zip(got, want[i]))
        runs = _loops_run(call)
        new, old = runs - seen, runs & seen
        trips = len(_names(call, "solvers.iter"))
        assert runs
        assert len(_names(call, "solvers.capture")) == len(new)
        assert call.counters.get("solvers.graph_reuses", 0) == len(old)
        assert call.counters["solvers.graph_replays"] == trips - len(new)
        seen |= runs
        reused += len(old)
    # the last call repeats the first's signals: every loop it runs is kept
    assert not new and reused


@pytest.mark.parametrize("route", ["eager", "graph"])
@pytest.mark.parametrize("kind", ["omp", "gomp"])
def test_omp_counters_record_on_every_trip(kind, route, monkeypatch):
    """``omp.passes`` counts 1 and ``omp.sub_inserts`` picks on every trip
    of the OMP driver: on the eager loop, and on the graph route, whose
    first call runs an eager trip and captures, and whose later calls
    replay kept trips from the first on and run none of the body's
    Python. A Homotopy call counts neither."""
    if route == "graph":
        _rule_says(monkeypatch, lambda *a, **k: True)
        monkeypatch.setattr(loops, "_capture", _eager_capture)
    picks = 4 if kind == "gomp" else 1
    A = _signals(kind, 0)[0]
    solver = FACADES[kind][0](A)
    for i, seed in enumerate((0, 1, 0)):
        _, call = _traced(lambda: _solve(solver, kind,
                                         _signals(kind, seed)[1]))
        trips = len(_names(call, "solvers.iter"))
        assert trips > 0
        assert call.counters["omp.passes"] == trips
        assert call.counters["omp.sub_inserts"] == picks * trips
        if route == "graph" and i:
            # every trip but a new tier's first was a replay, of a trip
            # kept from an earlier call or captured in this one
            captures = len(_names(call, "solvers.capture"))
            assert call.counters["solvers.graph_replays"] == trips - captures
            assert call.counters["solvers.graph_reuses"] > 0
            # the last call repeats the first's signals: replays alone
            assert i == 1 or not captures
    hom = FACADES["homotopy_batch"]
    _, call = _traced(lambda: _solve(hom[0](A), "homotopy_batch",
                                     _signals("homotopy_batch", 0)[1]))
    assert _names(call, "solvers.iter")
    assert not {"omp.passes", "omp.sub_inserts"} & set(call.counters)


@pytest.mark.parametrize("loop", ["synced", "graphed", "kept"])
def test_a_loop_adds_its_counts_on_every_trip(loop, monkeypatch):
    """``loops.run``'s ``counts`` on a toy loop of three trips: each trip
    adds them, whichever loop runs it, a kept trip's replays included; a
    loop given none counts nothing."""
    if loop != "synced":
        _rule_says(monkeypatch, lambda *a, **k: True)
        monkeypatch.setattr(loops, "_capture", _eager_capture)
    slot = loops.Slot()
    body = lambda s: (s[0] + 1,)
    live = lambda s: s[0] < 3
    for _ in range(2 if loop == "kept" else 1):
        _, call = _traced(lambda: _run_toy(body, live, slot,
                                           {"a": 1, "b": 5}))
    assert call.counters["a"] == 3 and call.counters["b"] == 15
    if loop == "kept":
        assert call.counters["solvers.graph_reuses"] == 1
    _, call = _traced(lambda: _run_toy(body, live, loops.Slot(), None))
    assert not {"a", "b"} & set(call.counters)


def _run_toy(body, live, slot, counts):
    with profiling.span("call"):
        return loops.run(body, live, (torch.zeros(2),), slot=slot,
                         counts=counts)


@pytest.mark.parametrize("kind", sorted(FACADES))
def test_a_kept_graphs_answer_survives_the_next_call(kind, stand_in_graphs):
    """What a call returned (the answer, the iterations and the errors;
    the compact pair of a batch) is the caller's: the next call, which
    replays the same kept graphs over the same buffers, leaves it
    unchanged."""
    A, Y1 = _signals(kind, 3)
    Y2 = _signals(kind, 4)[1]
    solver = FACADES[kind][0](A)
    first = _solve(solver, kind, Y1)
    held = [t.clone() for t in first]
    compact = None
    if FACADES[kind][1] is not None:
        compact = solver.solve_batch(Y1, TOL, FACADES[kind][2], dense=False)
        held_compact = [t.clone() for t in compact[:2]]
    _solve(solver, kind, Y2)
    assert all(torch.equal(a, b) for a, b in zip(first, held))
    if compact is not None:
        _solve(solver, kind, Y2)
        assert all(torch.equal(a, b)
                   for a, b in zip(compact[:2], held_compact))


@pytest.mark.parametrize("change", ["tolerance", "max_iterations", "batch",
                                    "precision"])
@pytest.mark.parametrize("kind", ["homotopy_batch", "omp"])
def test_another_key_drops_the_kept_graphs_and_captures_anew(
        kind, change, stand_in_graphs, monkeypatch):
    """A call whose trips bake in something else (the f32 tolerance, the
    iteration budget, the batch size, the path's precision) frees the
    kept entry before it captures its own, and answers as the eager loop
    does; a tolerance that rounds to the same f32 keeps the entry."""
    A, Y = _signals(kind, 5)
    solver = FACADES[kind][0](A)
    _solve(solver, kind, Y)
    tol, max_iterations = TOL, None
    if change == "tolerance":
        same = float(np.nextafter(np.float64(np.float32(TOL)), 1.0))
        assert np.float32(same) == np.float32(TOL) and same != TOL
        _, call = _traced(lambda: _solve(solver, kind, Y, tol=same))
        assert not _names(call, "solvers.capture")
        tol = 2 * TOL
    elif change == "max_iterations":
        max_iterations = FACADES[kind][2] + 1
    elif change == "batch":
        Y = Y[:-1]
    else:
        solver._precision = "high"
    old = weakref.ref(_kept_tensor(solver))
    got, call = _traced(lambda: _solve(solver, kind, Y, tol, max_iterations))
    assert old() is None
    assert len(_names(call, "solvers.capture")) == len(_loops_run(call)) > 0
    with monkeypatch.context() as mp:
        _rule_says(mp, lambda *a, **k: False)
        eager = FACADES[kind][0](A)
        eager._precision = solver._precision
        want = _solve(eager, kind, Y, tol, max_iterations)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("kind", ["homotopy_batch", "homotopy_core", "omp"])
def test_update_column_drops_the_kept_graphs(kind, stand_in_graphs,
                                             monkeypatch):
    """``update_column`` replaces operands the kept graphs read: it frees
    the entry at once, and the next call captures anew over the new
    operands and answers as a façade built on the updated A."""
    A, Y = _signals(kind, 6)
    solver = FACADES[kind][0](A)
    _solve(solver, kind, Y)
    old = weakref.ref(_kept_tensor(solver))
    col = np.random.RandomState(1).randn(A.shape[0]).astype(np.float32)
    col /= np.linalg.norm(col)
    solver.update_column(7, col)
    assert old() is None and solver._kept._entry == {}
    got, call = _traced(lambda: _solve(solver, kind, Y))
    assert _names(call, "solvers.capture")
    A2 = A.copy()
    A2[:, 7] = col
    with monkeypatch.context() as mp:
        _rule_says(mp, lambda *a, **k: False)
        want = _solve(FACADES[kind][0](A2), kind, Y)
    # the updated Gram's row and column come from one product, so compare
    # with the route's own tolerance of a rebuilt Gram
    assert torch.equal(got[1], want[1])
    assert torch.allclose(got[0], want[0], atol=1e-5)


@pytest.mark.parametrize("kind", ["homotopy_batch", "homotopy_core", "omp"])
def test_the_high_resolve_captures_anew_and_keeps_nothing(
        kind, stand_in_graphs, monkeypatch):
    """A certified façade whose certificate is forced to miss: the
    one-pass solve reuses its kept graphs from the second call on, and
    the "high" re-solve captures its loops anew in every call and leaves
    the kept entry as the one-pass solve's."""
    import sparse_solvers_tpu_torch.api as api
    A, Y = _signals(kind, 8)
    factory = {"homotopy_batch": lambda: pt.Homotopy(A, k_max=48,
                                                     **TORCH_ROUTE),
               "homotopy_core": lambda: pt.Homotopy(A, **TORCH_ROUTE),
               "omp": lambda: pt.Omp(A, **TORCH_ROUTE)}[kind]
    # the OMP driver's certificate is its own
    where, seam = ((omp_batch, "l2_certificate") if kind == "omp"
                   else (api, "_certified_error"))
    real = getattr(where, seam)

    def missing(A, x, Y, *psum):
        err = real(A, x, Y, *psum).clone()
        err[0] = 1e3
        return err
    monkeypatch.setattr(where, seam, missing)
    solver = factory()
    calls = []
    for _ in range(2):
        calls.append(_traced(lambda: _solve(solver, kind, Y))[1])
    key = solver._kept._key
    assert "default" in key and "high" not in key
    for i, call in enumerate(calls):
        [resolve] = _names(call, "api.resolve")
        inside = {resolve.span_id}
        for span in sorted(call.spans, key=lambda span: span.span_id):
            if span.parent_id in inside:
                inside.add(span.span_id)
        captures = _names(call, "solvers.capture")
        resolved = [c for c in captures if c.span_id in inside]
        assert resolved
        if i == 0:
            assert len(captures) > len(resolved)
            assert "solvers.graph_reuses" not in call.counters
        else:
            assert len(captures) == len(resolved)
            assert call.counters["solvers.graph_reuses"] > 0


@pytest.mark.parametrize("kind", sorted(FACADES))
def test_a_deleted_facade_frees_its_kept_graphs(kind, stand_in_graphs):
    """The kept entry belongs to the façade: deleting the façade frees
    every kept state tensor and the operands the graphs read."""
    A, Y = _signals(kind, 9)
    solver = FACADES[kind][0](A)
    _solve(solver, kind, Y)
    _solve(solver, kind, Y)
    state = weakref.ref(_kept_tensor(solver))
    operands = weakref.ref(next(
        t for t in solver._kept._entry["operands"]
        if isinstance(t, torch.Tensor)))
    del solver
    assert state() is None and operands() is None


@pytest.mark.parametrize("kind", ["homotopy_batch", "omp"])
def test_the_eager_route_keeps_no_graph(kind):
    """On the CPU the loops run eagerly: a façade keeps no trip, and its
    calls count neither a capture nor a reuse."""
    A, Y = _signals(kind, 10)
    solver = FACADES[kind][0](A)
    for _ in range(2):
        _, call = _traced(lambda: _solve(solver, kind, Y))
        assert not _names(call, "solvers.capture")
        assert "solvers.graph_reuses" not in call.counters
    assert not [v for v in solver._kept._entry.values()
                if isinstance(v, loops.Slot) and v.trip is not None]


def test_a_kept_trip_refuses_a_state_of_other_shapes():
    trip = loops._TripGraph.__new__(loops._TripGraph)
    trip.state = (torch.zeros(3), torch.zeros(2, 4))
    got = trip.load((torch.ones(3), torch.ones(2, 4)))
    assert got is trip.state and torch.equal(got[1], torch.ones(2, 4))
    for bad in [(torch.ones(3), torch.ones(2, 1)),
                (torch.ones(3, dtype=torch.float64), torch.ones(2, 4)),
                (torch.ones(3),)]:
        with pytest.raises(ValueError, match="shapes and dtypes"):
            trip.load(bad)
