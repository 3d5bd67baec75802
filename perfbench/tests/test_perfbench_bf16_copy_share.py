"""``api.bf16_copy_share`` on synthetic call records: the lanes whose
per-lane operator carried the bf16 copy over the lanes asked, None with no
store or where no call counted it (an older program, or the batch
drivers); and the reader in whole traced runs on the CPU: 100 in the tiny
single cell, absent in the tiny batch cell, whose driver takes no
per-lane operator."""

import json

import pytest
import torch

import _cases
from perfbench import harness
from sparse_solvers_tpu_torch.utils import profiling
from test_perfbench_spans import make_run, one_call, read, records  # noqa: F401

NAME = "api.bf16_copy_share"


def test_bf16_copy_share_reads_copy_lanes_over_lanes(records):
    run = make_run([("k", 0.0, 1e-3)], [(2, 1), (2, 2)])
    records += [one_call(1, 0.0), one_call(2, 20.0)]
    records[0].counters["api.bf16_copy_lanes"] = 2
    assert read(NAME, run) == 50
    records[1].counters["api.bf16_copy_lanes"] = 0
    assert read(NAME, run) == 50
    records[1].counters["api.bf16_copy_lanes"] = 2
    assert read(NAME, run) == 100


@pytest.mark.parametrize("case", ["no_counter", "no_store", "untraced"])
def test_bf16_copy_share_reads_nothing_without_the_counter(
        records, case, monkeypatch):
    records += [one_call(1, 0.0), one_call(2, 20.0)]
    if case != "no_counter":
        records[0].counters["api.bf16_copy_lanes"] = 2
    run = make_run([("k", 0.0, 1e-3)], [(2, 1), (2, 2)])
    if case == "no_store":
        monkeypatch.delattr(profiling, "calls")
    elif case == "untraced":
        run.traced = None
    assert read(NAME, run) is None


def test_bf16_copy_share_in_a_traced_run_on_the_cpu(tmp_path):
    here = _cases.checkout(tmp_path)
    spec = json.loads((here / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        if m["name"] == NAME:
            m["workloads"] += list(_cases.CELLS)
    (here / "BENCHMARK.json").write_text(json.dumps(spec))
    for cell in sorted(_cases.CELLS):
        result, _ = harness.run_cell(here, cell, 2**31 + 7, 0.3, True,
                                     torch.device("cpu"), 0.0)
        got = result["metrics"]
        if cell == "tiny.single":
            assert got[NAME]["value"] == 100
        else:
            assert NAME not in got
