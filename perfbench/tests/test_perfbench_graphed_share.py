"""``solver.graphed_share`` on synthetic call records: the replays over
the traced calls' ``solvers.iter`` spans, 0 with no replay, None with no
store, no iteration or a program without the graph route; and the
reader in a whole traced run on the CPU, where every loop runs eagerly."""

import json

import pytest
import torch

import _cases
from perfbench import harness
from sparse_solvers_tpu_torch.utils import profiling
from test_perfbench_spans import make_run, one_call, read, record, records  # noqa: F401

NAME = "solver.graphed_share"


def test_graphed_share_reads_replays_over_trips(records):
    run = make_run([("k", 0.0, 1e-3)], [(2, 1), (2, 2)])
    records += [one_call(1, 0.0), one_call(2, 20.0)]
    assert read(NAME, run) == 0
    records[0].counters["solvers.graph_replays"] = 1
    records[1].counters["solvers.graph_replays"] = 2
    assert read(NAME, run) == 100 * 3 / 4


def test_graphed_share_reads_nothing_without_trips(records):
    # records of calls that ran no driver iteration
    records += [record(1, [(0, None, "api.solve_batch", 0, 1)]),
                record(2, [(0, None, "api.solve_batch", 2, 3)])]
    run = make_run([("k", 0.0, 1e-3)], [(0,), (0,)])
    assert read(NAME, run) is None


@pytest.mark.parametrize("case", ["no_graph_route", "no_store"])
def test_graphed_share_reads_nothing_on_an_older_program(records, case,
                                                         monkeypatch):
    records += [one_call(1, 0.0), one_call(2, 20.0)]
    run = make_run([("k", 0.0, 1e-3)], [(2, 1), (2, 2)])
    if case == "no_graph_route":
        from sparse_solvers_tpu_torch.solvers import homotopy_batch
        monkeypatch.delattr(homotopy_batch, "graphed_while")
    else:
        monkeypatch.delattr(profiling, "calls")
    assert read(NAME, run) is None


def test_graphed_share_in_a_traced_run_on_the_cpu(tmp_path):
    here = _cases.checkout(tmp_path)
    spec = json.loads((here / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        if m["name"] == NAME:
            m["workloads"] += list(_cases.CELLS)
    (here / "BENCHMARK.json").write_text(json.dumps(spec))
    for cell in sorted(_cases.CELLS):
        result, _ = harness.run_cell(here, cell, 2**31 + 5, 0.3, True,
                                     torch.device("cpu"), 0.0)
        # the CPU's loops run eagerly
        assert result["metrics"][NAME]["value"] == 0
