"""The port's spans and counters (``utils/profiling.span``/``count``) on the
CPU twins: nothing is recorded without a profiler, the span tree of a
``Homotopy`` call under one, the spans the benchmark's readers count, the
re-solve, the drivers that share ``synced_while``, the exporter
and the bound on the records kept.
"""

import collections
import json
import time

import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

import sparse_solvers_tpu_torch as pt
from _torch_cases import TORCH_ROUTE, compressive_problem, irls_problem
from sparse_solvers_tpu_torch import api as papi
from sparse_solvers_tpu_torch.ops.operators import DenseOperator
from sparse_solvers_tpu_torch.solvers import (cosamp, homotopy_batch, irls,
                                              irls_cg, omp, omp_batch)
from sparse_solvers_tpu_torch.utils import profiling

TOL = 0.01
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def fresh_records():
    profiling.clear()
    yield
    profiling.clear()


def _problem(batch=8, seed=1):
    return compressive_problem(128, 512, 6, batch, seed=seed)


def _solver(k_max=64, precision="certified"):
    return pt.Homotopy(_problem()[0], k_max=k_max, precision=precision,
                       **TORCH_ROUTE)


def _call(solver, entry, Y):
    """(longest lane's iterations) of one ``entry`` call."""
    if entry == "solve":
        _, rep = solver.solve(Y[0], TOL, 60)
        return rep.iter
    _, rep = solver.solve_batch(Y, TOL, 60)
    return int(rep.iter.max())


def _recorded(fn):
    with torch.profiler.profile(activities=CPU):
        out = fn()
    return out, profiling.calls()


def _named(call, name):
    return [s for s in call.spans if s.name == name]


@pytest.mark.parametrize("entry", ["solve_batch", "solve"])
def test_nothing_is_recorded_or_timed_without_a_profiler(entry,
                                                         monkeypatch):
    solver = _solver()
    _, Y, _ = _problem()

    def no_clock():
        raise AssertionError("a timestamp was taken with no profiler on")
    monkeypatch.setattr(time, "time_ns", no_clock)
    _call(solver, entry, Y)
    assert profiling.calls() == []
    assert profiling.span("api.solve") is profiling.span("solvers.iter")


@pytest.mark.parametrize("k_max,tiers", [(40, 1), (64, 3)])
@pytest.mark.parametrize("precision,reads", [("certified", 2), ("high", 0)])
def test_solve_batch_span_tree_and_counters(k_max, tiers, precision,
                                            reads):
    solver = _solver(k_max, precision)
    _, Y, _ = _problem()
    longest, calls = _recorded(lambda: _call(solver, "solve_batch", Y))
    assert len(calls) == 1
    call = calls[0]
    [root] = [s for s in call.spans if s.parent_id is None]
    assert root.name == "api.solve_batch"
    assert root.attrs == {"precision": precision}
    byid = {s.span_id: s for s in call.spans}
    for s in call.spans:     # every child lies inside its parent
        assert s.call_id == call.call_id and s.start_ns <= s.end_ns
        if s.parent_id is not None:
            parent = byid[s.parent_id]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    [path] = _named(call, "api.path")
    assert path.parent_id == root.span_id
    assert [s.attrs["K"] for s in _named(call, "solvers.tier")] == (
        homotopy_batch._plan_tiers(k_max, 60, None))
    assert len(_named(call, "solvers.tier")) == tiers
    assert all(byid[s.parent_id].name == "solvers.tier"
               for s in _named(call, "solvers.iter"))
    syncs = _named(call, "solvers.sync")
    parents = collections.Counter(
        (byid[s.parent_id].name, s.attrs["what"]) for s in syncs)
    # a trip is its body and the liveness read after it; each tier opens
    # with a liveness read and the upload of the initial mask's scalar;
    # the facade reads the reports
    assert parents == collections.Counter({
        ("solvers.iter", "live"): longest, ("solvers.tier", "live"): tiers,
        ("solvers.tier", "copy"): 1, ("api.solve_batch", "read"): reads})
    assert len(_named(call, "api.certify")) == (precision == "certified")
    assert not _named(call, "api.resolve")
    assert len(_named(call, "solvers.iter")) == longest
    assert len(syncs) == longest + tiers + reads + 1
    assert call.counters == {"api.lanes": 8}


def test_solve_records_the_per_lane_core():
    solver = _solver()
    _, Y, _ = _problem()
    it, calls = _recorded(lambda: _call(solver, "solve", Y))
    [call] = calls
    root = _named(call, "api.solve")[0]
    assert root.parent_id is None
    [path] = _named(call, "api.path")
    assert not _named(call, "solvers.tier")
    iters = _named(call, "solvers.iter")
    assert len(iters) == it
    assert all(s.parent_id == path.span_id for s in iters)
    syncs = _named(call, "solvers.sync")
    whats = [s.attrs["what"] for s in syncs]
    assert whats.count("read") == 2
    # the liveness read after the body, inside each trip (the gamma
    # scan's bound is filled on the device, with no upload); the first
    # liveness read before any trip
    assert "copy" not in whats
    inside = collections.Counter(s.parent_id for s in syncs
                                 if s.attrs["what"] == "live")
    assert all(inside[s.span_id] == 1 for s in iters)
    assert [s.parent_id for s in syncs if s.attrs["what"] == "live"][0] == (
        path.span_id)
    assert len(syncs) == it + 1 + 2
    # the per-lane core's operator carries the bf16 copy at "default"
    assert call.counters == {"api.lanes": 1, "api.bf16_copy_lanes": 1}


@pytest.mark.parametrize("entry,lanes", [("solve_batch", 8), ("solve", 1)])
def test_a_missed_certificate_records_the_resolve(entry, lanes,
                                                  monkeypatch):
    _, Y, _ = _problem()
    # the iterations of the two paths the re-solving call runs
    fast = _call(_solver(precision="default"), entry, Y)
    high = _call(_solver(precision="high"), entry, Y)
    real = papi._certified_error

    def miss_lane_0(A, x, y):
        err = real(A, x, y).clone()
        err[0] = 1.0
        return err
    monkeypatch.setattr(papi, "_certified_error", miss_lane_0)
    solver = _solver()
    _, calls = _recorded(lambda: _call(solver, entry, Y))
    [call] = calls
    [resolve] = _named(call, "api.resolve")
    assert resolve.parent_id == _named(call, entry.replace(
        "solve", "api.solve", 1))[0].span_id
    paths = _named(call, "api.path")
    assert len(paths) == 2
    assert sum(p.parent_id == resolve.span_id for p in paths) == 1
    c = call.counters
    assert c["api.resolved_lanes"] == lanes == c["api.lanes"]
    # both driver runs' trips, each opening with one liveness read
    assert len(_named(call, "solvers.iter")) == fast + high
    whats = collections.Counter(s.attrs["what"]
                                for s in _named(call, "solvers.sync"))
    assert whats["live"] == fast + high + (
        2 * len(homotopy_batch._plan_tiers(64, 60, None))
        if entry == "solve_batch" else 2)


def test_omp_driver_records_iterations_through_synced_while():
    A, Y, _ = compressive_problem(128, 512, 6, 8, seed=2)
    A, Y = torch.from_numpy(A), torch.from_numpy(Y)
    (_, rep), calls = _recorded(lambda: omp_batch.solve_omp_batch(
        A, A.T @ A, Y, 1e-3, 12, 16))
    iters = [s for c in calls for s in c.spans if s.name == "solvers.iter"]
    syncs = [s for c in calls for s in c.spans if s.name == "solvers.sync"]
    assert len(iters) == int(rep.iter.max())
    assert len(syncs) == len(iters) + len(homotopy_batch._plan_tiers(
        16, 12, None))
    assert all(s.attrs == {"what": "live"} for s in syncs)


def _eager_loop_solve(family):
    """A small solve of a family whose loop runs ``loops.synced_while``."""
    A, Y, _ = compressive_problem(128, 512, 6, 8, seed=2)
    A, Y = torch.from_numpy(A), torch.from_numpy(Y)
    if family == "omp_core":
        return omp.solve_omp_core(DenseOperator(A), 512, Y, 1e-3, 12)
    if family == "cosamp":
        return cosamp.solve_cosamp(A, Y, 6, 1e-3, 20)
    if family == "irls":
        A, Y = (torch.from_numpy(a) for a in irls_problem(40, 25, 6, 3, 5))
        Q, R = torch.linalg.qr(A)
        return irls.solve_irls(Q, R, Y, 1e-6, 50)
    return irls_cg.solve_irls_cg(A[:64, :256].double(), Y[:4, :64].double(),
                                 1e-6, 40)


@pytest.mark.parametrize("loop", ["omp_core", "irls", "irls_cg_outer",
                                  "irls_cg_inner", "cosamp"])
def test_each_eager_loop_records_one_iteration_span_a_trip(loop,
                                                           monkeypatch):
    """The loops on ``loops.synced_while`` (the per-lane OMP core, IRLS,
    CG-IRLS's outer and inner loops, CoSaMP): a traced solve records one
    ``solvers.iter`` a trip, each with the ``live`` read that decides the
    next: one per reported iteration (and breaking trip) for an outer loop
    and one per CG step for the inner. X and the reports are the untraced
    solve's, bit for bit."""
    family = loop.rsplit("_", 1)[0] if loop.startswith("irls_cg") else loop
    steps = []
    real_cg = irls_cg._cg_solve

    def counted(*args, **kwargs):
        state = real_cg(*args, **kwargs)
        steps.append(int(state.it.max()))
        return state
    monkeypatch.setattr(irls_cg, "_cg_solve", counted)
    want = _eager_loop_solve(family)
    steps.clear()
    with torch.profiler.profile(activities=CPU):
        with profiling.span("call"):
            got = _eager_loop_solve(family)
    [call] = profiling.calls()
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        assert torch.equal(g, w)
    byid = {s.span_id: s for s in call.spans}
    trips = _named(call, "solvers.iter")
    inner = [s for s in trips if byid[s.parent_id].name == "solvers.iter"]
    outer = [s for s in trips if byid[s.parent_id].name == "call"]
    assert len(inner) + len(outer) == len(trips)
    # a lane is live for its iterations and, where the loop broke on it
    # (IRLS's spd failure, CG-IRLS's breakdown), the trip that broke it
    rep = got[1]
    lane_trips = rep.iter + getattr(rep, "spd_failure", 0)
    assert len(outer) == int(lane_trips.max()) > 0
    # a CG solve each outer trip, each a loop of its own
    loops_run = 1 + len(steps)
    assert len(steps) == (len(outer) if family == "irls_cg" else 0)
    assert len(inner) == sum(steps)
    if loop == "irls_cg_inner":
        assert sum(steps) > len(outer)
    syncs = _named(call, "solvers.sync")
    assert all(s.attrs == {"what": "live"} for s in syncs)
    assert len(syncs) == len(trips) + loops_run


def test_solve_path_batch_counts_the_history_reads():
    solver = _solver(40, "high")
    _, Y, _ = _problem()
    (_, _, _, rep), calls = _recorded(
        lambda: solver.solve_path_batch(Y, TOL, 30))
    [call] = calls
    assert call.spans[-1].name == "api.path"       # no facade root here
    it = int(rep.iter.max())
    assert len(_named(call, "solvers.iter")) == it
    # a liveness read and the history's row read each trip, the first
    # liveness read, the initial mask's upload
    assert len(_named(call, "solvers.sync")) == 2 * it + 1 + 1


def test_trace_writes_spans_and_clears_on_entry(tmp_path):
    with torch.profiler.profile(activities=CPU):
        with profiling.span("before"):
            pass
    assert len(profiling.calls()) == 1
    solver = _solver(40)
    _, Y, _ = _problem()
    with profiling.trace(str(tmp_path)):
        assert profiling.calls() == []
        _call(solver, "solve_batch", Y)
    assert (tmp_path / "trace.json").exists()
    written = json.loads((tmp_path / "spans.json").read_text())
    [call] = profiling.calls()
    assert [w["call_id"] for w in written] == [call.call_id]
    assert written[0]["counters"] == call.counters
    assert [tuple(s.values()) for s in written[0]["spans"]] == [
        tuple(s) for s in call.spans]
    assert set(written[0]["spans"][0]) == {
        "call_id", "span_id", "parent_id", "name", "start_ns", "end_ns",
        "attrs"}


def test_the_records_are_bounded():
    extra = 5
    with torch.profiler.profile(activities=CPU):
        for _ in range(profiling.CALLS_KEPT + extra):
            with profiling.span("root"):
                profiling.count("n")
    calls = profiling.calls()
    assert len(calls) == profiling.CALLS_KEPT
    ids = [c.call_id for c in calls]
    assert ids == sorted(ids) and ids[-1] - ids[0] == len(ids) - 1
    assert all(c.counters == {"n": 1} for c in calls)


def test_counts_need_an_open_call_and_nest_under_it():
    with torch.profiler.profile(activities=CPU):
        profiling.count("dropped")
        with profiling.span("outer", a=1):
            with profiling.span("inner"):
                profiling.count("kept", 3)
            profiling.count("kept")
        with profiling.span("second"):
            pass
    first, second = profiling.calls()
    assert first.counters == {"kept": 4} and second.counters == {}
    inner, outer = first.spans              # in the order they closed
    assert (outer.name, outer.parent_id, outer.attrs) == ("outer", None,
                                                          {"a": 1})
    assert inner.parent_id == outer.span_id
    assert second.call_id == first.call_id + 1


def test_spans_share_the_profilers_clock():
    """A span around a host operation contains that operation's event as
    the profiler records it: the two clocks are one."""
    x = torch.ones(256, 256)
    with torch.profiler.profile(activities=CPU) as prof:
        with profiling.span("mm"):
            x @ x
    [s] = profiling.calls()[0].spans
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::mm"]
    assert len(events) == 1
    assert s.start_ns <= events[0].start_ns() <= events[0].end_ns() <= (
        s.end_ns)


def test_a_profiler_of_another_process_kind_turns_the_store_on():
    """``torch.autograd.profiler.profile`` sets the same flag as
    ``torch.profiler.profile``; leaving either turns the store off."""
    with torch.autograd.profiler.profile():
        with profiling.span("legacy"):
            pass
    with profiling.span("after"):
        pass
    assert [c.spans[0].name for c in profiling.calls()] == ["legacy"]


def test_solve_results_do_not_change_under_the_profiler():
    solver = _solver()
    _, Y, _ = _problem()
    X0, rep0 = solver.solve_batch(Y, TOL, 60)
    (X1, rep1), _ = _recorded(lambda: solver.solve_batch(Y, TOL, 60))
    assert torch.equal(X0, X1) and torch.equal(rep0.iter, rep1.iter)
    np.testing.assert_array_equal(rep0.solution_error.numpy(),
                                  rep1.solution_error.numpy())
    assert collections.Counter(s.name for s in profiling.calls()[0].spans)[
        "api.solve_batch"] == 1
