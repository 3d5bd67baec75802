"""The benchmark's OMP configuration on the CPU: its plain reference
(``perfbench/reference/omp.py``) against the JAX package's NumPy oracle,
the port's ``Omp`` on its slot-space driver against that reference, and a
tiny OMP cell run end to end by the harness, sound and with a fault
planted in the program.

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
from perfbench.reference import omp as reference
from sparse_solvers_tpu.oracle import omp as oracle

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-2


@pytest.mark.parametrize("tol, iters", [(1e-2, 40), (1e-6, 60), (1e-2, 3)])
def test_reference_is_the_jax_packages_oracle(tol, iters):
    """Lane for lane at 48 x 160 with k from 1 to 40: the lanes of k 20
    and 40 stall at the rounding floor or use up the budget."""
    rng = np.random.RandomState(9)
    m, n = 48, 160
    A = rng.randn(m, n)
    A /= np.linalg.norm(A, axis=0)
    ks = (1, 2, 4, 7, 12, 20, 40)
    X0 = np.zeros((len(ks), n))
    for i, k in enumerate(ks):
        X0[i, rng.choice(n, k, replace=False)] = rng.uniform(0.5, 1.0, k)
    Y = X0 @ A.T
    X, it, rnorm, slots = reference.solve_supports(
        torch.from_numpy(A), torch.from_numpy(Y), tol, iters)
    for lane in range(len(ks)):
        x, k, r, support = oracle.solve(A, Y[lane], tol, iters)
        assert int(it[lane]) == k
        assert slots[lane, :k].tolist() == support
        assert np.abs(X[lane].numpy() - x).max() <= 1e-10
        assert abs(float(rnorm[lane]) - r) <= 1e-10


@pytest.fixture(scope="module")
def problem():
    A, Y, X0 = compressive_problem(256, 1024, 8, 16, seed=4)
    return torch.from_numpy(A), torch.from_numpy(Y), X0


def test_port_driver_matches_the_reference(problem):
    A, Y, X0 = problem
    iters = 32                      # b k_max = 512 = 2 m: the driver's side
    solver = pt.Omp(A, precision="certified", device="cpu")
    assert solver.explain(batch=16, max_iterations=iters)["corr"] == "driver"
    X, rep = solver.solve_batch(Y, TOL, iters)
    Xr, itr, rr, slots = reference.solve_supports(A, Y, TOL, iters)
    solved = (rep.solution_error <= TOL) & (rr <= TOL)
    assert bool(solved.all())
    n = A.shape[1]
    for lane in range(Y.shape[0]):
        k = int(itr[lane])
        support = set(slots[lane, :k].tolist())
        assert set(np.flatnonzero(X[lane].numpy()).tolist()) == support
        assert support == set(np.flatnonzero(X0[lane]).tolist())
        assert int(rep.iter[lane]) == k and n not in support
    # the coefficients come from a float32 online inverse of a system whose
    # condition is near 1, fed by c0 at "highest": float32 rounding over k
    # members and a few inserts, far under the amplitudes' 0.5
    assert float((X.double() - Xr).abs().max()) <= 1e-5
    # the reported certificate is ||y - Ax||_2 at fp32, TF32 off: against a
    # float64 recompute of the same x, float32 rounding of an m-row residual
    cert = reference.certificate(A.double(), Y.double(), X.double())
    assert float((rep.solution_error.double() - cert).abs().max()) <= 1e-6


def _cell(tmp: Path) -> Path:
    """A copy of the benchmark with a tiny cell of the OMP configuration:
    its facade, options, tolerance, reference and limits, at 256 x 1024,
    16 signals of k = 8 a call and 32 picks (the driver's side of b k_max
    >= 2 m)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp / "perfbench"
    config = json.loads((bench / "configs" / "omp-4096x8192.json").read_text())
    config.update(name="tiny-omp", m=256, n=1024, max_iterations=32)
    (bench / "configs" / "tiny-omp.json").write_text(json.dumps(config))
    (bench / "traffic" / "tiny-omp.json").write_text(json.dumps({
        "entry": "solve_batch", "batch": 16, "k_min": 8, "k_max": 8,
        "amplitude": [0.5, 1.0], "pool_calls": 3, "warmup_calls": 1,
        "check_calls": 2, "trace_calls": 1}))
    shutil.copy(bench / "checks" / "o4k-batch256-k64.json",
                bench / "checks" / "tiny.omp.json")
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-omp", "source": "a test size",
                            "file": "perfbench/configs/tiny-omp.json",
                            "reduced": [], "why": "CPU tests"})
    spec["workloads"].append({"name": "tiny.omp", "config": "tiny-omp",
                              "traffic": "tiny-omp", "chips": 1,
                              "why": "CPU tests"})
    for m in spec["per_layer"]:
        if m["name"] == "k4_roofline":
            m["workloads"].append("tiny.omp")
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


# K4's coefficients zeroed: every insert's least squares reads 0
ZERO_K4 = """
from sparse_solvers_tpu_torch.ops.cuda import omp_insert as k4
insert = k4.omp_insert
def zeroed(*args):
    coef, deg = insert(*args)
    return torch.zeros_like(coef), deg
k4.omp_insert = zeroed
"""


def _run(here: Path, fault: str = "") -> dict:
    code = "\n".join([
        "import json, sys, torch",
        "torch.set_num_threads(1)",            # as run.py runs a cell
        f"sys.path.insert(0, {str(ROOT)!r})",
        "from pathlib import Path",
        "from perfbench import harness",
        fault,
        f"result, _ = harness.run_cell(Path({str(here)!r}), 'tiny.omp', "
        "2**33 + 17, 0.3, True, torch.device('cpu'), 0.0)",
        "print(json.dumps(result))"])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, check=True, cwd=here)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    return _cell(tmp_path_factory.mktemp("omp_cell"))


def test_tiny_omp_cell_is_correct(cell):
    result = _run(cell)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] % 16 == 0
    assert result["metrics"]["solver.iters_mean"]["value"] >= 8
    # no card, so no device operations: K4's reader reads nothing
    assert "k4_roofline" not in result["metrics"]


def test_tiny_omp_cell_with_k4_zeroed_is_not_correct(cell):
    result = _run(cell, ZERO_K4)
    assert result["correct"] is False
    assert result["checks"]["unsolved"]["value"] == 100.0
