"""The span readers' arithmetic on synthetic call records and device
intervals, their None where the records are missing or do not line up
with the traced calls, and the readers in a whole traced run on the
CPU."""

import json

import pytest
import torch

import _cases
from _cases import REPO
from perfbench import harness
from perfbench.metrics import _spans
from sparse_solvers_tpu_torch.utils import profiling

NEW = ("solver.host_ms_per_iter", "solver.syncs_per_iter",
       "api.resolved_share", "api.host_ms_per_call",
       "device.idle_issue_share")
MS = 1_000_000      # ns


def read(name, run):
    return harness.load_module(REPO, "metrics", name).read(run)


def make_run(device_ops, traced_iters):
    traced = harness.Traced(
        [harness.Call(0.0, list(i), [0.0] * len(i)) for i in traced_iters],
        1.0, device_ops)
    return harness.Run("w", {"tolerance": 0.01}, {"batch": 2}, 1, 1.0,
                       [harness.Call(0.1, [3, 3], [0.0, 0.0])], 0.1, 0,
                       traced, 0)


def record(call_id, spans, **counters):
    """A call record from (span_id, parent_id, name, start_ms, end_ms)."""
    return profiling.CallRecord(call_id, [
        profiling.Span(call_id, i, p, name, int(s * MS), int(e * MS), {})
        for i, p, name, s, e in spans], dict(counters))


def one_call(call_id, t0, iters=2, resolved=0, lanes=2):
    """A batch call at ``t0`` ms: a 1 ms root self time, a tier that opens
    with a 1 ms live read, ``iters`` trips of a 2 ms body then a 1 ms live
    read, then a 1 ms facade read."""
    t = t0 + 0.5
    end = t + 3 * iters + 1
    spans = [(1, 0, "api.path", t, end), (2, 1, "solvers.tier", t, end),
             (3, 2, "solvers.sync", t, t + 1)]
    t, sid = t + 1, 4
    for _ in range(iters):
        spans += [(sid, 2, "solvers.iter", t, t + 3),
                  (sid + 1, sid, "solvers.sync", t + 2, t + 3)]
        t, sid = t + 3, sid + 2
    spans += [(sid, 0, "solvers.sync", end, end + 1),
              (0, None, "api.solve_batch", t0, end + 1.5)]
    return record(call_id, spans, **{"api.lanes": lanes,
                                     "api.resolved_lanes": resolved})


@pytest.fixture
def records(monkeypatch):
    kept = []
    monkeypatch.setattr(profiling, "calls", lambda: list(kept))
    return kept


def test_interval_arithmetic():
    a = _spans.union([(0, 2), (1, 3), (5, 6), (6, 7), (9, 9)])
    assert a == [(0, 3), (5, 7)]
    b = [(1, 2), (2.5, 5.5), (8, 10)]
    assert _spans.intersect(a, b) == [(1, 2), (2.5, 3), (5, 5.5)]
    assert _spans.subtract(a, b) == [(0, 1), (2, 2.5), (5.5, 7)]
    assert _spans.subtract(a, []) == a and _spans.subtract([], b) == []
    assert _spans.length(a) == 5


def test_readers_on_synthetic_records(records):
    records += [one_call(7, 0.0), one_call(8, 20.0)]
    # the card busy inside each body's second ms, and across the facade's
    # read of the first call
    ops = [("k", (t0 + 0.5 + 3 * i + 2) * 1e-3, (t0 + 0.5 + 3 * i + 3)
            * 1e-3) for t0 in (0.0, 20.0) for i in range(2)]
    ops.append(("read", 7.5e-3, 8.5e-3))
    run = make_run(ops, [(2, 1), (2, 2)])
    # every body is a 2 ms self time; a root's 9 ms less 8 of children
    assert read("solver.host_ms_per_iter", run) == pytest.approx(2.0)
    assert read("solver.syncs_per_iter", run) == 8 / 4
    assert read("api.resolved_share", run) == 0
    assert read("api.host_ms_per_call", run) == pytest.approx(1.0)
    # idle: each call's 9 ms root less 2 ms of bodies' kernels, and 1 ms
    # of the first call's read; issue: a body's first ms, 4 in all
    assert read("device.idle_issue_share", run) == pytest.approx(
        100 * 4 / (9 - 2 + 9 - 3))


def test_a_resolved_call_counts_and_is_not_held_to_its_report(records):
    records += [one_call(1, 0.0, iters=5, resolved=2)]
    run = make_run([("k", 0.0, 1e-3)], [(2, 1)])
    assert read("api.resolved_share", run) == 100
    assert read("solver.syncs_per_iter", run) == 7 / 5


@pytest.mark.parametrize("case", ["missing", "misaligned", "untraced",
                                  "no_store"])
def test_readers_read_nothing_without_aligned_records(records, case,
                                                      monkeypatch):
    records += [one_call(1, 0.0), one_call(2, 20.0)]
    iters = [(2, 1), (2, 2)]
    if case == "missing":
        iters = [(2,)] * 3
    elif case == "misaligned":
        iters = [(2,), (3,)]
    run = make_run([("k", 0.0, 1e-3)], iters)
    if case == "untraced":
        run.traced = None
    elif case == "no_store":
        # a program before the span store: nothing to read, nothing raised
        monkeypatch.delattr(profiling, "calls")
    for name in NEW:
        assert read(name, run) is None, name


def test_only_the_newest_records_are_the_traced_calls(records):
    records += [one_call(1, 0.0, iters=9), one_call(2, 20.0),
                one_call(3, 40.0)]
    run = make_run([("k", 0.0, 1e-3)], [(2,), (2,)])
    assert read("solver.syncs_per_iter", run) == 2


def test_readers_in_a_traced_run_on_the_cpu(tmp_path):
    here = _cases.checkout(tmp_path)
    spec = json.loads((here / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        if m["name"] in NEW:
            m["workloads"] += list(_cases.CELLS)
    (here / "BENCHMARK.json").write_text(json.dumps(spec))
    for cell in sorted(_cases.CELLS):
        result, _ = harness.run_cell(here, cell, 2**31 + 5, 0.3, True,
                                     torch.device("cpu"), 0.0)
        got = result["metrics"]
        # the CPU has no device intervals, so no idle to split
        assert set(NEW) - set(got) == {"device.idle_issue_share"}
        assert got["api.resolved_share"]["value"] == 0
        # a liveness read a trip, one closing each tier, the facade's two
        assert 1 < got["solver.syncs_per_iter"]["value"] <= 4
        assert got["solver.host_ms_per_iter"]["value"] > 0
        assert got["api.host_ms_per_call"]["value"] > 0


def test_attribution_splits_the_idle_by_span(records):
    records += [one_call(7, 0.0), one_call(8, 20.0)]
    ops = [("k", (t0 + 2.5) * 1e-3, (t0 + 3.5) * 1e-3) for t0 in (0, 20)]
    run = make_run(ops, [(2,), (2,)])
    out = _spans.attribution(run, _spans.traced_records(run))
    by = out["by_span"]
    # per call: 9 ms of roots, 1 ms busy inside the first body
    assert out["idle_ms"] == pytest.approx(8.0)
    assert by["solvers.iter"] == pytest.approx({"self_ms": 4.0,
                                                "idle_ms": 3.0})
    assert by["solvers.sync"]["idle_ms"] == pytest.approx(4.0)
    assert by["api.solve_batch"]["self_ms"] == pytest.approx(1.0)
    assert sum(v["idle_ms"] for v in by.values()) == pytest.approx(8.0)
    # 11 ms between the two calls, no kernel there
    assert out["between_calls_idle_ms"] == pytest.approx(11 / 2)
