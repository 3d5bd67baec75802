"""The benchmark's CoSaMP configuration on the CPU: its plain reference
(``perfbench/reference/cosamp.py``) against the JAX package's NumPy oracle,
the port's ``Cosamp`` against that reference, and a tiny CoSaMP cell run
end to end by the harness, sound and with a fault planted in the program.

The harness refuses to finish a run in a process that has loaded JAX, as
this one has (``conftest.py``), so the cells run in a child process.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

import sparse_solvers_tpu_torch as pt
from _torch_cases import compressive_problem
from perfbench.reference import cosamp as reference
from sparse_solvers_tpu.oracle import cosamp as oracle

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-2


# (m, n, k, tol, rounds): lanes that converge; k2 = m - k < k, where the
# lanes stall; a round budget that cuts them
@pytest.mark.parametrize("m, n, k, tol, rounds", [
    (128, 512, 8, 1e-2, 20), (48, 160, 4, 1e-6, 20), (48, 160, 30, 1e-2, 20),
    (64, 256, 12, 1e-2, 20), (64, 256, 12, 1e-8, 1)])
def test_reference_is_the_jax_packages_oracle(m, n, k, tol, rounds):
    """Lane for lane, each lane exactly k-sparse: the same rounds, the same
    support, x and ||r||_2 to 1e-10 in float64."""
    rng = np.random.RandomState(m + k)
    A = rng.randn(m, n)
    A /= np.linalg.norm(A, axis=0)
    X0 = np.zeros((6, n))
    for lane in range(6):
        X0[lane, rng.choice(n, k, replace=False)] = rng.uniform(0.5, 1.0, k)
    Y = X0 @ A.T
    X, it, rnorm, supp = reference.solve_sparsity(
        torch.from_numpy(A), torch.from_numpy(Y), k, tol, rounds)
    assert X.dtype == torch.float64
    for lane in range(6):
        x, r, res, support = oracle.solve(A, Y[lane], k, tol, rounds)
        assert int(it[lane]) == r
        assert sorted(j for j in supp[lane].tolist() if j < n) == support
        assert np.abs(X[lane].numpy() - x).max() <= 1e-10
        assert abs(float(rnorm[lane]) - res) <= 1e-10


def test_reference_reads_the_configurations_sparsity():
    config = json.loads((ROOT / "perfbench" / "configs"
                         / "cosamp-4096x8192.json").read_text())
    assert reference.K_SPARSITY == config["options"]["k_sparsity"] == 64


@pytest.fixture(scope="module")
def problem():
    A, Y, X0 = compressive_problem(256, 1024, 8, 16, seed=4)
    return torch.from_numpy(A), torch.from_numpy(Y), X0


def test_port_matches_the_reference(problem):
    A, Y, X0 = problem
    X, rep = pt.Cosamp(A, 8, device="cpu").solve_batch(Y, TOL, 20)
    Xr, itr, rr, supp = reference.solve_sparsity(A, Y, 8, TOL, 20)
    assert bool(((rep.solution_error <= TOL) & (rr <= TOL)).all())
    assert rep.iter.tolist() == itr.tolist()
    for lane in range(Y.shape[0]):
        support = set(supp[lane].tolist())
        assert set(np.flatnonzero(X[lane].numpy()).tolist()) == support
        assert support == set(np.flatnonzero(X0[lane]).tolist())
    # the union LS by a float32 Cholesky of a Gram whose condition is near
    # 1, at "highest": float32 rounding, far under the amplitudes' 0.5
    assert float((X.double() - Xr).abs().max()) <= 1e-5
    # the reported ||y - Ax||_2 is the loop's float32 residual
    cert = reference.certificate(A.double(), Y.double(), X.double())
    assert float((rep.solution_error.double() - cert).abs().max()) <= 1e-6


def _cell(tmp: Path) -> Path:
    """A copy of the benchmark whose CoSaMP configuration is cut to 256 x
    1024 at k = 8, with a tiny cell of it: 16 signals of k = 8 a call and
    the cell's limits. The reference reads k from that copy's file."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp / "perfbench"
    path = bench / "configs" / "cosamp-4096x8192.json"
    config = json.loads(path.read_text())
    config.update(m=256, n=1024)
    config["options"]["k_sparsity"] = 8
    path.write_text(json.dumps(config))
    (bench / "traffic" / "tiny-cosamp.json").write_text(json.dumps({
        "entry": "solve_batch", "batch": 16, "k_min": 8, "k_max": 8,
        "amplitude": [0.5, 1.0], "pool_calls": 3, "warmup_calls": 1,
        "check_calls": 2, "trace_calls": 1}))
    shutil.copy(bench / "checks" / "c4k-batch256-k64.json",
                bench / "checks" / "tiny.cosamp.json")
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny.cosamp",
                              "config": "cosamp-4096x8192",
                              "traffic": "tiny-cosamp", "chips": 1,
                              "why": "CPU tests"})
    for m in spec["per_layer"]:
        if m["name"].startswith("cosamp."):
            m["workloads"].append("tiny.cosamp")
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


# the program told k - 1: every prune keeps one member too few
PRUNE_SHORT = """
from sparse_solvers_tpu_torch import api
solve_cosamp = api._cosamp.solve_cosamp
api._cosamp.solve_cosamp = lambda A, Y, k, *a, **kw: solve_cosamp(
    A, Y, k - 1, *a, **kw)
"""


def _run(here: Path, fault: str = "") -> dict:
    code = "\n".join([
        "import json, sys, torch",
        "torch.set_num_threads(1)",            # as run.py runs a cell
        f"sys.path.insert(0, {str(ROOT)!r})",
        "from pathlib import Path",
        "from perfbench import harness",
        fault,
        f"result, _ = harness.run_cell(Path({str(here)!r}), 'tiny.cosamp', "
        "2**33 + 17, 0.3, True, torch.device('cpu'), 0.0)",
        "print(json.dumps(result))"])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, check=True, cwd=here)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    return _cell(tmp_path_factory.mktemp("cosamp_cell"))


def test_tiny_cosamp_cell_is_correct(cell):
    result = _run(cell)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] % 16 == 0
    assert result["checks"]["x_err"]["value"] <= 1e-5
    # each round gathers 16 lanes' union of S = 24 columns of 256 f32 rows
    gib = result["metrics"]["cosamp.union_gib_per_round"]
    assert gib == {"value": 16 * 24 * 256 * 4 / 2 ** 30, "unit": "GiB/round"}
    # no card, so no device operations: the roofline reads nothing
    assert "cosamp.round_roofline" not in result["metrics"]


def test_tiny_cosamp_cell_with_a_short_prune_is_not_correct(cell):
    result = _run(cell, PRUNE_SHORT)
    assert result["correct"] is False
    assert result["checks"]["unsolved"]["value"] == 100.0
