"""The benchmark's gOMP configuration on the CPU: its plain reference
(``perfbench/reference/gomp.py``) against the JAX package's NumPy oracle
with ``picks`` > 1, the port's ``Omp(picks=4)`` on its slot-space driver
against that reference, and a tiny gOMP cell run end to end by the
harness, sound and with a fault planted in the program.

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
from perfbench.reference import gomp as reference
from perfbench.reference import omp as omp_reference
from sparse_solvers_tpu.oracle import omp as oracle
from sparse_solvers_tpu_torch.ops import blas
from sparse_solvers_tpu_torch.solvers import omp_batch

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-2


def _gaussian_lanes():
    """48 x 160 with k from 1 to 40: the lanes of k 20 and 40 use up the
    budget, and short budgets cut a round."""
    rng = np.random.RandomState(9)
    m, n = 48, 160
    A = rng.randn(m, n)
    A /= np.linalg.norm(A, axis=0)
    ks = (1, 2, 4, 7, 12, 20, 40)
    X0 = np.zeros((len(ks), n))
    for i, k in enumerate(ks):
        X0[i, rng.choice(n, k, replace=False)] = rng.uniform(0.5, 1.0, k)
    return A, X0 @ A.T


def _unit_column_lanes():
    """Six unit columns of R^8: a signal with a part along e7, which no
    column reaches, ends in a round whose every inactive score is exactly
    0 (degenerate); equal amplitudes plant ties, taken leftmost first;
    a lane of e7 alone is degenerate from its first round. The last lane
    stalls: its columns' parts (1e-10) lie below the rounding of ||r||_2 =
    1, which their fit therefore leaves as it was, in any order of
    summation."""
    A = np.eye(8)[:, :6]
    Y = np.array([[1, 1, 0, 0, 0, 0, 0, 0.5],
                  [0.5, 0, 0.5, 0.5, 0, 0, 0, 0.25],
                  [0, 0, 0, 0, 0, 0, 0, 1.0],
                  [1, 0.5, 0.25, 0.125, 1, 0, 0, 0],
                  [0, 1e-10, 5e-11, 0, 0, 0, 0, 1.0]])
    return A, Y


CASES = {
    "converge": (_gaussian_lanes, 1e-2, 40),
    "budget_3": (_gaussian_lanes, 1e-2, 3),
    "budget_10": (_gaussian_lanes, 1e-8, 10),
    "degenerate_stall": (_unit_column_lanes, 1e-3, 6),
}


@pytest.mark.parametrize("picks", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_is_the_jax_packages_oracle(case, picks):
    """Lane for lane in float64: the same ``iter`` (columns), the same
    support in pick order, x and ||r||_2 to 1e-10."""
    make, tol, iters = CASES[case]
    A, Y = make()
    X, it, rnorm, slots = reference.solve_picks(
        torch.from_numpy(A), torch.from_numpy(Y), picks, tol, iters)
    assert X.dtype == torch.float64
    ends = []
    for lane in range(Y.shape[0]):
        x, k, r, support = oracle.solve(A, Y[lane], tol, iters, picks=picks)
        assert int(it[lane]) == k
        assert slots[lane, :k].tolist() == support
        assert np.abs(X[lane].numpy() - x).max() <= 1e-10
        assert abs(float(rnorm[lane]) - r) <= 1e-10
        ends.append("solved" if r <= tol else "budget" if k == min(
            iters, *A.shape) else "stopped")
    # each case reaches the ends it is named for
    if case == "degenerate_stall":
        assert ends == ["stopped"] * 3 + ["solved", "stopped"]
        # the stalled lane kept the round's iterate: both its columns
        assert int(it[4]) == 2 and float(rnorm[4]) == 1.0
    else:
        assert {"budget"} <= set(ends)


def test_reference_reads_the_configurations_picks():
    config = json.loads((ROOT / "perfbench" / "configs"
                         / "gomp-4096x8192.json").read_text())
    assert reference.PICKS == config["options"]["picks"] == 4
    assert config["reference"] == "gomp" and config["facade"] == "Omp"
    assert reference.certificate is omp_reference.certificate


def test_control_is_bf16_and_far_from_the_reference():
    """At 1e-3, under the bf16 residual's floor at m = 128 (about 7e-3),
    the control solves no lane that the reference solves."""
    A, Y, _ = compressive_problem(128, 512, 8, 6, seed=3)
    A, Y = torch.from_numpy(A), torch.from_numpy(Y)
    X, _, rnorm, _ = reference.solve_picks(A, Y, 4, 1e-3, 32)
    Xc, _, rc, _ = reference.solve_picks(A, Y, 4, 1e-3, 32, "bfloat16")
    assert Xc.dtype == rc.dtype == torch.float32
    assert bool((rnorm <= 1e-3).all()) and not bool((rc <= 1e-3).any())
    assert 1e-3 < float((Xc.double() - X).abs().max())
    with pytest.raises(ValueError):
        reference.solve(A, Y, TOL, 32, "float16")


def _slot_order(A, Y, iters):
    """The driver's supports in slot (pick) order, at the certified
    path's precision."""
    with blas.precision_scope("default"):
        (_, indices), rep = omp_batch.solve_omp_batch(
            A, A.T @ A, Y, TOL, iters, iters, dense=False, picks=4)
    return indices, rep


def test_port_matches_the_reference_in_one_tier():
    """k_max = 32 < 48: one tier, so every round is whole and the
    trajectories are the reference's: the same columns, in the same pick
    order, and the same iterations."""
    A, Y, X0 = compressive_problem(256, 1024, 8, 16, seed=4)
    A, Y = torch.from_numpy(A), torch.from_numpy(Y)
    iters = 32                      # b k_max = 512 = 2 m: the driver's side
    solver = pt.Omp(A, precision="certified", picks=4, device="cpu")
    plan = solver.explain(batch=16, max_iterations=iters)
    assert (plan["corr"], plan["picks"], plan["capacity_tiers"]) == (
        "driver", 4, [32])
    X, rep = solver.solve_batch(Y, TOL, iters)
    Xr, itr, rr, slots = reference.solve_picks(A, Y, 4, TOL, iters)
    assert bool(((rep.solution_error <= TOL) & (rr <= TOL)).all())
    assert rep.iter.tolist() == itr.tolist()
    indices, _ = _slot_order(A, Y, iters)
    for lane in range(Y.shape[0]):
        k = int(itr[lane])
        assert indices[lane, :k].tolist() == slots[lane, :k].tolist()
        assert set(np.flatnonzero(X[lane].numpy()).tolist()) == set(
            np.flatnonzero(X0[lane]).tolist())
    # a float32 online inverse of a system whose condition is near 1, fed
    # by c0 at "highest": float32 rounding, far under the amplitudes' 0.5
    assert float((X.double() - Xr).abs().max()) <= 1e-5
    # the reported certificate is ||y - Ax||_2 at fp32, TF32 off: against a
    # float64 recompute of the same x, float32 rounding of an m-row residual
    cert = reference.certificate(A.double(), Y.double(), X.double())
    assert float((rep.solution_error.double() - cert).abs().max()) <= 1e-6


def test_port_certifies_where_tiers_split_rounds():
    """k_max = 64: tiers 16, 32 and 64 stop a round at 15 and 31 columns,
    so a 20-sparse lane takes 4 + 4 + 4 + 3 + 4 = 19 columns where whole
    rounds take 20 and then 23 in the next. Supports then differ from the
    reference's in their extra columns; each certificate is within tol."""
    A, Y, X0 = compressive_problem(256, 1024, 20, 16, seed=4)
    A, Y = torch.from_numpy(A), torch.from_numpy(Y)
    solver = pt.Omp(A, precision="certified", picks=4, device="cpu")
    assert solver.explain(batch=16, max_iterations=64)[
        "capacity_tiers"] == [16, 32, 64]
    X, rep = solver.solve_batch(Y, TOL, 64)
    _, itr, rr, _ = reference.solve_picks(A, Y, 4, TOL, 64)
    assert bool((rr <= TOL).all()) and itr.tolist() == [20] * 16
    assert bool((rep.solution_error <= TOL).all())
    assert bool((rep.iter >= itr).all()) and bool((rep.iter <= 24).all())
    cert = reference.certificate(A.double(), Y.double(), X.double())
    # the certificate is the program's guarantee; its report is fp32
    # rounding of an m-row residual away from the float64 recompute
    assert float(cert.max()) <= TOL
    assert float((rep.solution_error.double() - cert).abs().max()) <= 1e-6
    for lane in range(Y.shape[0]):
        assert set(np.flatnonzero(X0[lane]).tolist()) <= set(
            np.flatnonzero(X[lane].numpy()).tolist())


def _cell(tmp: Path) -> Path:
    """A copy of the benchmark whose gOMP configuration is cut to 256 x
    1024 and 64 columns (tiers 16, 32 and 64), with a tiny cell of it: 16
    signals of k = 16 a call and the cell's limits. The reference reads
    picks from that copy's file."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp / "perfbench"
    path = bench / "configs" / "gomp-4096x8192.json"
    config = json.loads(path.read_text())
    config.update(m=256, n=1024, max_iterations=64)
    path.write_text(json.dumps(config))
    (bench / "traffic" / "tiny-gomp.json").write_text(json.dumps({
        "entry": "solve_batch", "batch": 16, "k_min": 16, "k_max": 16,
        "amplitude": [0.5, 1.0], "pool_calls": 3, "warmup_calls": 1,
        "check_calls": 2, "trace_calls": 1}))
    shutil.copy(bench / "checks" / "g4k-batch256-k64.json",
                bench / "checks" / "tiny.gomp.json")
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny.gomp",
                              "config": "gomp-4096x8192",
                              "traffic": "tiny-gomp", "chips": 1,
                              "why": "CPU tests"})
    for m in spec["per_layer"]:
        if "g4k-batch256-k64" in m.get("workloads", ()):
            m["workloads"].append("tiny.gomp")
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


# the second sub-insert of every round reported done and never made: its
# column is committed to the support and the mask, the inverse lacks it
DROP_SUB_INSERT = """
from sparse_solvers_tpu_torch.ops.cuda import omp_insert as k4
insert = k4.omp_insert
made = [0]
def dropped(inv, u1, kk, vtv, b_act, doins):
    made[0] += 1
    if made[0] % 4 == 2:
        return torch.zeros_like(b_act), torch.zeros_like(doins)
    return insert(inv, u1, kk, vtv, b_act, doins)
k4.omp_insert = dropped
"""


def _run(here: Path, fault: str = "") -> dict:
    code = "\n".join([
        "import json, sys, torch",
        "torch.set_num_threads(1)",            # as run.py runs a cell
        f"sys.path.insert(0, {str(ROOT)!r})",
        "from pathlib import Path",
        "from perfbench import harness",
        fault,
        f"result, _ = harness.run_cell(Path({str(here)!r}), 'tiny.gomp', "
        "2**33 + 17, 0.3, True, torch.device('cpu'), 0.0)",
        "print(json.dumps(result))"])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, check=True, cwd=here)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    return _cell(tmp_path_factory.mktemp("gomp_cell"))


def test_tiny_gomp_cell_is_correct(cell):
    result = _run(cell)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] % 16 == 0
    # 16 columns take 4 whole rounds, but the tier of 16 stops at 15: every
    # lane takes 5 passes for 19 columns
    assert result["metrics"]["solver.iters_mean"]["value"] == 19
    assert result["metrics"]["omp.cols_per_pass"] == {"value": 19 / 5,
                                                      "unit": "cols/pass"}
    # no card, so no device operations: the roofline reads nothing
    assert "gomp.round_roofline" not in result["metrics"]


def test_tiny_gomp_cell_with_a_dropped_sub_insert_is_not_correct(cell):
    result = _run(cell, DROP_SUB_INSERT)
    assert result["correct"] is False
    assert result["checks"]["unsolved"]["value"] == 100.0
