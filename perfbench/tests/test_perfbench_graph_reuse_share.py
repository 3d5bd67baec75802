"""``solver.graph_reuse_share`` on synthetic call records: the reuses over
the reuses and the capture spans of the traced calls, 0 with captures
alone, None with no store, no graph-route loop or a program that keeps no
graphs across calls; and the reader in whole traced runs on the CPU: None
where every loop runs eagerly, 100 where the loops take the graph route
(an eager stand-in for each CUDA graph) and the warm-up captured them."""

import json

import pytest
import torch

import _cases
from perfbench import harness
from sparse_solvers_tpu_torch.solvers import loops
from sparse_solvers_tpu_torch.utils import profiling
from test_perfbench_spans import make_run, one_call, read, record, records  # noqa: F401

NAME = "solver.graph_reuse_share"


def _capture_span(rec, span_id):
    """Add a ``solvers.capture`` span under the record's first tier."""
    tier = next(s for s in rec.spans if s.name == "solvers.tier")
    rec.spans.append(profiling.Span(rec.call_id, span_id, tier.span_id,
                                    "solvers.capture", tier.start_ns,
                                    tier.start_ns + 1, {}))


def test_graph_reuse_share_reads_reuses_over_loop_runs(records):
    run = make_run([("k", 0.0, 1e-3)], [(2, 1), (2, 2)])
    records += [one_call(1, 0.0), one_call(2, 20.0)]
    _capture_span(records[0], 99)
    assert read(NAME, run) == 0
    records[1].counters["solvers.graph_reuses"] = 3
    assert read(NAME, run) == 100 * 3 / 4
    records[0].spans.pop()
    assert read(NAME, run) == 100


def test_graph_reuse_share_reads_nothing_without_a_graph_route(records):
    # the loops ran eagerly: no capture, no reuse
    records += [one_call(1, 0.0), one_call(2, 20.0)]
    run = make_run([("k", 0.0, 1e-3)], [(2, 1), (2, 2)])
    assert read(NAME, run) is None


@pytest.mark.parametrize("case", ["no_kept_graphs", "no_store",
                                  "untraced"])
def test_graph_reuse_share_reads_nothing_on_an_older_program(
        records, case, monkeypatch):
    records += [one_call(1, 0.0), one_call(2, 20.0)]
    _capture_span(records[0], 99)
    records[1].counters["solvers.graph_reuses"] = 1
    run = make_run([("k", 0.0, 1e-3)], [(2, 1), (2, 2)])
    if case == "no_kept_graphs":
        monkeypatch.delattr(loops, "Kept")
    elif case == "no_store":
        monkeypatch.delattr(profiling, "calls")
    else:
        run.traced = None
    assert read(NAME, run) is None


class _EagerGraph:
    """A captured trip's stand-in: a replay runs the trip's function."""

    def __init__(self, fn):
        self.fn = fn
        self.flag = torch.zeros((), dtype=torch.bool)

    def replay(self):
        self.flag.copy_(self.fn())


def _eager_capture(fn, device):
    graph = _EagerGraph(fn)
    return graph, graph.flag


@pytest.mark.parametrize("route", ["eager", "graph"])
def test_graph_reuse_share_in_a_traced_run_on_the_cpu(tmp_path, route,
                                                      monkeypatch):
    here = _cases.checkout(tmp_path)
    spec = json.loads((here / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        if m["name"] in (NAME, "api.resolved_share"):
            m["workloads"] += list(_cases.CELLS)
    (here / "BENCHMARK.json").write_text(json.dumps(spec))
    if route == "graph":
        monkeypatch.setattr(loops, "graph_route", lambda *a, **k: True)
        monkeypatch.setattr(loops, "_capture", _eager_capture)
    for cell in sorted(_cases.CELLS):
        result, _ = harness.run_cell(here, cell, 2**31 + 5, 0.3, True,
                                     torch.device("cpu"), 0.0)
        got = result["metrics"]
        if route == "eager":
            assert NAME not in got
        elif got["api.resolved_share"]["value"] == 0:
            # the warm-up captured every loop the traced calls run
            assert got[NAME]["value"] == 100
        else:
            # a "high" re-solve captures anew
            assert 0 < got[NAME]["value"] < 100
