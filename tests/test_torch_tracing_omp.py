"""The ``Omp`` facade's spans and counters on the CPU twins, under the names
and nesting ``Homotopy`` records (``tests/test_torch_tracing.py``): the
facade's root ⊃ ``api.path``, ``api.certify`` and ``api.resolve``, the
counters ``api.lanes`` and ``api.resolved_lanes``, one ``solvers.tier``
per capacity tier of the slot-space driver; nothing without a profiler,
and the same results with one.
"""

import collections
import time

import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

import sparse_solvers_tpu_torch as pt
from _torch_cases import TORCH_ROUTE, compressive_problem
from sparse_solvers_tpu_torch.solvers import homotopy_batch, omp_batch
from sparse_solvers_tpu_torch.utils import profiling

TOL = 0.01
ITERS = 60
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def fresh_records():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(scope="module")
def problem():
    A, Y, _ = compressive_problem(128, 512, 6, 8, seed=3)
    return torch.from_numpy(A), torch.from_numpy(Y)


def _solver(A, precision="certified"):
    return pt.Omp(A, precision=precision, **TORCH_ROUTE)


def _call(solver, entry, Y):
    """The report of one ``entry`` call."""
    if entry == "solve":
        return solver.solve(Y[0], TOL, ITERS)[1]
    return solver.solve_batch(Y, TOL, ITERS)[1]


def _recorded(fn):
    with torch.profiler.profile(activities=CPU):
        out = fn()
    return out, profiling.calls()


def _named(call, name):
    return [s for s in call.spans if s.name == name]


def _parents(call, name):
    byid = {s.span_id: s for s in call.spans}
    return [byid[s.parent_id].name for s in _named(call, name)]


@pytest.mark.parametrize("entry", ["solve_batch", "solve"])
def test_nothing_is_recorded_or_timed_without_a_profiler(problem, entry,
                                                         monkeypatch):
    A, Y = problem
    solver = _solver(A)

    def no_clock():
        raise AssertionError("a timestamp was taken with no profiler on")
    monkeypatch.setattr(time, "time_ns", no_clock)
    _call(solver, entry, Y)
    assert profiling.calls() == []


@pytest.mark.parametrize("precision,reads", [("certified", 2), ("high", 0)])
def test_solve_batch_span_tree_and_counters(problem, precision, reads):
    A, Y = problem
    solver = _solver(A, precision)
    assert solver.explain(batch=8, max_iterations=ITERS)["corr"] == "driver"
    rep, calls = _recorded(lambda: _call(solver, "solve_batch", Y))
    [call] = calls
    [root] = [s for s in call.spans if s.parent_id is None]
    assert root.name == "api.solve_batch"
    assert root.attrs == {"precision": precision}
    byid = {s.span_id: s for s in call.spans}
    for s in call.spans:     # every child lies inside its parent
        if s.parent_id is not None:
            parent = byid[s.parent_id]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    [path] = _named(call, "api.path")
    assert path.parent_id == root.span_id
    # the driver's post-loop certificate, on every precision: the reported
    # error
    assert _parents(call, "api.certify") == ["api.path"]
    tiers = homotopy_batch._plan_tiers(ITERS, ITERS, None)
    assert [s.attrs["K"] for s in _named(call, "solvers.tier")] == tiers
    assert set(_parents(call, "solvers.tier")) == {"api.path"}
    assert set(_parents(call, "solvers.iter")) == {"solvers.tier"}
    assert len(_named(call, "solvers.iter")) == int(rep.iter.max())
    syncs = collections.Counter(
        (parent, s.attrs["what"]) for parent, s in zip(
            _parents(call, "solvers.sync"), _named(call, "solvers.sync")))
    assert syncs == collections.Counter({
        ("solvers.iter", "live"): int(rep.iter.max()),
        ("solvers.tier", "live"): len(tiers),
        ("api.solve_batch", "read"): reads})
    assert not _named(call, "api.resolve")
    assert call.counters == {"api.lanes": 8}


def test_solve_records_the_per_lane_core(problem):
    A, Y = problem
    solver = _solver(A)
    assert solver.explain(max_iterations=ITERS)["corr"] != "driver"
    _, calls = _recorded(lambda: _call(solver, "solve", Y))
    [call] = calls
    [root] = _named(call, "api.solve")
    assert root.parent_id is None
    assert root.attrs == {"precision": "certified"}
    assert _parents(call, "api.path") == ["api.solve"]
    assert _parents(call, "api.certify") == ["api.solve"]
    assert not _named(call, "solvers.tier")
    # the core's loop: one solvers.iter a round, each ending in the live
    # read that decides the next, after the one before the first
    trips = _named(call, "solvers.iter")
    assert set(_parents(call, "solvers.iter")) == {"api.path"}
    assert len(trips) == _call(solver, "solve", Y).iter
    assert [s.attrs["what"] for s in _named(call, "solvers.sync")] == [
        "live"] * (len(trips) + 1) + ["read", "read"]
    assert _parents(call, "solvers.sync")[1:len(trips) + 1] == [
        "solvers.iter"] * len(trips)
    assert call.counters == {"api.lanes": 1}


@pytest.mark.parametrize("entry,lanes", [("solve_batch", 8), ("solve", 1)])
def test_a_missed_certificate_records_the_resolve(problem, entry, lanes,
                                                  monkeypatch):
    A, Y = problem
    real = omp_batch.l2_certificate

    def miss_lane_0(*args):
        err = real(*args).clone()
        err[0] = 1.0
        return err
    # the seam both routes' certificates go through
    monkeypatch.setattr(omp_batch, "l2_certificate", miss_lane_0)
    solver = _solver(A)
    rep, calls = _recorded(lambda: _call(solver, entry, Y))
    [call] = calls
    root = entry.replace("solve", "api.solve", 1)
    assert _parents(call, "api.resolve") == [root]
    # the first path under the root, the re-solve's under api.resolve
    assert sorted(_parents(call, "api.path")) == sorted([root,
                                                         "api.resolve"])
    # the driver certifies both runs; the core's "high" re-solve reports
    # its own residual
    assert len(_named(call, "api.certify")) == (
        2 if entry == "solve_batch" else 1)
    assert call.counters == {"api.lanes": lanes,
                             "api.resolved_lanes": lanes}
    whats = collections.Counter(s.attrs["what"]
                                for s in _named(call, "solvers.sync"))
    # the first solve's two reads, and the re-solve's on the single route
    # or the upload of the mask it merges by on the batch route
    assert whats["read"] == (2 if entry == "solve_batch" else 4)
    assert whats["copy"] == (entry == "solve_batch")
    if entry == "solve_batch":
        assert float(rep.solution_error[0]) == 1.0


@pytest.mark.parametrize("entry", ["solve_batch", "solve"])
def test_results_do_not_change_under_the_profiler(problem, entry):
    A, Y = problem
    solver = _solver(A)
    run = {"solve_batch": lambda: solver.solve_batch(Y, TOL, ITERS),
           "solve": lambda: solver.solve(Y[0], TOL, ITERS)}[entry]
    x0, rep0 = run()
    (x1, rep1), _ = _recorded(run)
    assert torch.equal(x0, x1)
    np.testing.assert_array_equal(np.asarray(rep0.iter),
                                  np.asarray(rep1.iter))
    np.testing.assert_array_equal(np.asarray(rep0.solution_error),
                                  np.asarray(rep1.solution_error))
