"""BENCHMARK.json against the benchmark's contract, and every file it
names found by that name."""

import json
import re

import pytest

from _cases import REPO
from perfbench import check, harness

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    assert all(_line(w) for w in SPEC["command"])
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_every_later_check():
    # 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s of
    # compiling a cell, 1200 s spare, inside 43200 s
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_configs_are_used_and_load():
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("perfbench/") and c["file"] not in files
        files.add(c["file"])
        config = json.loads((REPO / c["file"]).read_text())
        assert config["reduced"] == c["reduced"] == []
        assert config["name"] == c["name"]


def test_cells():
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    names = [w["name"] for w in SPEC["workloads"]]
    assert len(set(names)) == len(names)


def test_metrics():
    names = []
    for kind in ("end_to_end", "per_layer"):
        for m in SPEC[kind]:
            names.append(m["name"])
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
            if kind == "end_to_end":
                assert set(m) - {"workloads"} == {
                    "name", "unit", "better", "bound", "source"}
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert set(m) - {"workloads"} == {
                    "name", "unit", "better", "source", "layer", "moves"}
                assert _line(m["layer"])
                assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
            assert all(w in {c["name"] for c in SPEC["workloads"]}
                       for w in m.get("workloads", ()))
            reader = harness.load_module(REPO, "metrics", m["name"])
            assert callable(reader.read)
    assert len(set(names)) == len(names)
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    roof = [m for m in SPEC["per_layer"] if m["name"].endswith("_roofline")]
    assert all(m["unit"] == "%" for m in roof)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_loads_and_reports(cell):
    spec, entry, config, traffic = harness.load_cell(REPO, cell)
    e2e = [m["name"] for m in harness.metrics_of(spec, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_of(spec, cell, "per_layer")
    assert traffic["entry"] in ("solve_batch", "solve")
    assert traffic["k_min"] <= traffic["k_max"]
    reference = harness.load_module(REPO, "reference", config["reference"])
    assert callable(reference.solve)
    limits = json.loads(
        (REPO / "perfbench" / "checks" / f"{cell}.json").read_text())
    assert set(limits) <= {"x_err", "cert", "report_gap", "unsolved"}
    assert limits["cert"]["limit"] == 1.0      # the configuration's own


def test_judge_fails_a_number_over_its_limit_and_a_nan():
    limits = {"cert": {"limit": 1.0}, "report_gap": {"limit": 1e-3}}
    ok, lines = check.judge({"cert": 0.5, "report_gap": 1e-6}, limits)
    assert ok and len(lines) == 2 and lines[0].startswith("check cert 0.5")
    assert not check.judge({"cert": 1.5, "report_gap": 0.0}, limits)[0]
    assert not check.judge({"cert": float("nan"), "report_gap": 0.0},
                           limits)[0]
