"""Whole runs on the CPU, past the harness's look for a card: the result
line, the modules a run loads, cells and metrics added as files, and the
refusal of ``run.py`` without a card. One test runs a real cell on the
card and skips elsewhere."""

import json
import subprocess
import sys
import textwrap

import pytest
import torch

import _cases
from perfbench import harness

CPU = torch.device("cpu")
SEED = 2**31 + 77


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _cases.checkout(tmp_path_factory.mktemp("checkout"))


def run(root, cell, traced=False, seed=SEED):
    return harness.run_cell(root, cell, seed, 0.3, traced, CPU, 0.0)


@pytest.mark.parametrize("cell", sorted(_cases.CELLS))
def test_result_line(root, cell):
    result, lines = run(root, cell)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= _cases.TINY_TRAFFIC[
        _cases.CELLS[cell]]["batch"]
    # call_ms_p95 lists its cells, and the tiny ones are not among them
    assert set(result["metrics"]) == {"solves_per_s", "peak_mem_gib",
                                      "setup_s"}
    assert all(set(v) == {"value", "unit"}
               for v in result["metrics"].values())
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert set(result["checks"]) == {"cert", "report_gap", "unsolved"}
    assert [ln.split()[1] for ln in lines] == ["cert", "report_gap",
                                               "unsolved"]
    assert "\n" not in json.dumps(result)


def test_traced_result_carries_per_layer_metrics(root):
    result, _ = run(root, "tiny.batch", traced=True)
    # on the CPU only the reader of the reports finds something to read
    assert set(result["metrics"]) == {"solver.iters_mean"}
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_sample_of_calls_is_drawn_from_the_seed():
    def kept(seed, calls):
        sample = harness._Sample(4, seed)
        for i in range(calls):
            sample.offer(i, lambda: i)
        return sample.kept
    assert kept(5, 100) == kept(5, 100)
    assert kept(5, 100) != kept(6, 100)
    assert kept(5, 3) == [0, 1, 2]
    counts = [0] * 20
    for seed in range(2000):
        for i in kept(seed, 20):
            counts[i] += 1
    assert min(counts) > 300 and max(counts) < 500      # 400 expected


def test_a_metric_added_as_a_file(root, tmp_path):
    here = _cases.checkout(tmp_path)
    (here / "perfbench" / "metrics" / "solver.iters_max.py").write_text(
        "def read(run):\n"
        "    return max(max(c.iters) for c in run.window)\n")
    spec = json.loads((here / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": "solver.iters_max", "unit": "iters", "better": "lower",
        "source": "program_counter", "layer": "solvers",
        "moves": "solves_per_s", "workloads": ["tiny.batch"]})
    (here / "BENCHMARK.json").write_text(json.dumps(spec))
    result, _ = run(here, "tiny.batch", traced=True)
    assert result["metrics"]["solver.iters_max"]["value"] >= 4
    result, _ = run(here, "tiny.single", traced=True)
    assert "solver.iters_max" not in result["metrics"]


def test_a_family_added_as_files(tmp_path, monkeypatch):
    here = _cases.checkout(tmp_path)
    cell = _cases.add_omp(here)
    result, lines = run(here, cell)
    # lanes of k > 5 end unsolved after 5 picks and say so
    assert result["failed"] > 0
    assert result["correct"] is True, lines
    assert result["checks"]["report_gap"]["value"] < 1e-3
    # held to Homotopy's certificate in its place, the same answers fail
    from perfbench.reference import homotopy
    load = harness.load_module

    def with_homotopy_certificate(root, kind, name):
        module = load(root, kind, name)
        if kind == "reference":
            module.certificate = homotopy.certificate
        return module
    monkeypatch.setattr(harness, "load_module", with_homotopy_certificate)
    result, lines = run(here, cell)
    assert result["correct"] is False, lines


def test_the_sample_builds_only_what_it_keeps():
    made = []

    def make(i):
        made.append(i)
        return i
    sample = harness._Sample(3, 1)
    for i in range(200):
        sample.offer(i, lambda: make(i))
    assert set(sample.kept) <= set(made)
    assert len(made) < 40           # about 3 (1 + ln(200 / 3)) = 15


def test_a_run_loads_no_jax(root):
    code = textwrap.dedent(f"""
        import json, sys, torch
        sys.path.insert(0, {str(_cases.REPO)!r})
        from pathlib import Path
        from perfbench import harness
        harness.run_cell(Path({str(root)!r}), "tiny.batch", 3, 0.2, True,
                         torch.device("cpu"), 0.0)
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "sparse_solvers_tpu_torch" in top
    assert not top & set(harness.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sparse_solvers_tpu.api", object())
    assert harness.forbidden_modules() == ["sparse_solvers_tpu"]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA card here")


def test_run_refuses_without_a_card(no_card):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "h4k-batch256-k64", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=_cases.REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_a_cell_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "hgf-batch256-k16", "--seed", "9", "--seconds", "2", "--trace",
         "0"], cwd=_cases.REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
