"""The ``Cosamp`` facade's spans and counters on the CPU, under the names
``Homotopy`` and ``Omp`` record (``tests/test_torch_tracing.py``): the
facade's root ⊃ ``api.path`` ⊃ one ``solvers.iter`` a round, the counter
``api.lanes``, and ``cosamp.union_bytes``, the bytes of the union each
round gathers; nothing without a profiler, and the same results with one.
"""

import time

import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

import sparse_solvers_tpu_torch as pt
from _torch_cases import compressive_problem
from sparse_solvers_tpu_torch.solvers import cosamp
from sparse_solvers_tpu_torch.utils import profiling

TOL = 0.01
K = 6
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def fresh_records():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(scope="module")
def problem():
    A, Y, _ = compressive_problem(128, 512, K, 8, seed=3)
    return torch.from_numpy(A), torch.from_numpy(Y)


def _call(solver, entry, Y):
    """(x, report) of one ``entry`` call."""
    if entry == "solve":
        return solver.solve(Y[0], TOL)
    return solver.solve_batch(Y, TOL)


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
    solver = pt.Cosamp(A, K, device="cpu")

    def no_clock():
        raise AssertionError("a timestamp was taken with no profiler on")
    monkeypatch.setattr(time, "time_ns", no_clock)
    _call(solver, entry, Y)
    assert profiling.calls() == []


@pytest.mark.parametrize("entry, lanes", [("solve_batch", 8), ("solve", 1)])
def test_span_tree_and_counters(problem, entry, lanes):
    A, Y = problem
    solver = pt.Cosamp(A, K, device="cpu")
    (_, rep), calls = _recorded(lambda: _call(solver, entry, Y))
    [call] = calls
    [root] = [s for s in call.spans if s.parent_id is None]
    assert root.name == entry.replace("solve", "api.solve", 1)
    assert root.attrs == {"precision": "highest"}
    byid = {s.span_id: s for s in call.spans}
    for s in call.spans:     # every child lies inside its parent
        if s.parent_id is not None:
            parent = byid[s.parent_id]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    assert _parents(call, "api.path") == [root.name]
    # a round a trip, each ending in the liveness read of the next
    trips = _named(call, "solvers.iter")
    assert set(_parents(call, "solvers.iter")) == {"api.path"}
    assert len(trips) == int(np.max(np.asarray(rep.iter))) >= 1
    whats = [s.attrs["what"] for s in _named(call, "solvers.sync")]
    assert whats == ["live"] * (len(trips) + 1) + (
        ["read", "read"] if entry == "solve" else [])
    # the union of S = 3k columns of m f32 rows, for every lane, a trip
    S = cosamp.union_capacity(*A.shape, K)
    assert S == 3 * K
    assert call.counters == {
        "api.lanes": lanes,
        "cosamp.union_bytes": len(trips) * lanes * S * A.shape[0] * 4}


@pytest.mark.parametrize("entry", ["solve_batch", "solve"])
def test_results_do_not_change_under_the_profiler(problem, entry):
    A, Y = problem
    solver = pt.Cosamp(A, K, device="cpu")
    x0, rep0 = _call(solver, entry, Y)
    (x1, rep1), _ = _recorded(lambda: _call(solver, entry, Y))
    assert torch.equal(x0, x1)
    np.testing.assert_array_equal(np.asarray(rep0.iter),
                                  np.asarray(rep1.iter))
    np.testing.assert_array_equal(np.asarray(rep0.solution_error),
                                  np.asarray(rep1.solution_error))
