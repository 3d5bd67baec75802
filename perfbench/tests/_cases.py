"""Copies of the checkout's benchmark with cells small enough for the CPU,
added as new files and new entries, the way a later change adds a cell.

The facade takes its torch route at these sizes (m n > 2^16, so a CPU
facade's "auto" keeps off the host engine) and its batch driver (batch
k_max >= 2 m); on the CPU every hand kernel runs its plain twin.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_CONFIG = {
    "name": "tiny-homotopy", "source": "a test size", "facade": "Homotopy",
    "options": {"k_max": 24, "precision": "certified"},
    "m": 128, "n": 1024, "dtype": "float32", "tolerance": 0.01,
    "max_iterations": 32, "reference": "homotopy", "reduced": [],
}
TINY_TRAFFIC = {
    "tiny-batch": {"entry": "solve_batch", "batch": 16, "k_min": 4,
                   "k_max": 4, "amplitude": [0.5, 1.0], "pool_calls": 3,
                   "warmup_calls": 1, "check_calls": 2, "trace_calls": 1},
    "tiny-single": {"entry": "solve", "batch": 1, "k_min": 2, "k_max": 6,
                    "amplitude": [0.5, 1.0], "pool_calls": 10,
                    "warmup_calls": 1, "check_calls": 4, "trace_calls": 2},
}
# the cells' limits; the control and the faults read far above them
TINY_LIMITS = {"cert": {"limit": 1.0}, "report_gap": {"limit": 1e-3},
               "unsolved": {"limit": 10.0}}
CELLS = {"tiny.batch": "tiny-batch", "tiny.single": "tiny-single"}


def checkout(dest: Path) -> Path:
    """A copy of BENCHMARK.json and the benchmark's folder under ``dest``
    with the tiny configuration, mixes, limits and cells added."""
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = dest / "perfbench"
    (bench / "configs" / "tiny-homotopy.json").write_text(
        json.dumps(TINY_CONFIG))
    for name, mix in TINY_TRAFFIC.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    spec["configs"].append({
        "name": "tiny-homotopy", "source": "a test size",
        "file": "perfbench/configs/tiny-homotopy.json", "reduced": [],
        "why": "CPU tests"})
    for cell, mix in CELLS.items():
        (bench / "checks" / f"{cell}.json").write_text(
            json.dumps(TINY_LIMITS))
        spec["workloads"].append({"name": cell, "config": "tiny-homotopy",
                                  "traffic": mix, "chips": 1,
                                  "why": "CPU tests"})
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest


# A second family added as files alone: a plain OMP reference (its
# certificate is the l2 residual the Omp facade reports, not Homotopy's
# ||A^T r||_inf), an Omp configuration, a mix and a cell. With 5 picks
# the lanes of k > 5 end unsolved, so their reported residuals are far
# from zero and only the family's own certificate matches them.
OMP_REFERENCE = '''"""Plain OMP, one lane at a time in float64: pick the largest |A^T r|,
refit the support by least squares, stop once ||r||_2 <= tol or after
max_iterations picks."""

import torch


def certificate(A, Y, X):
    return torch.linalg.vector_norm(Y - X @ A.T, dim=1)


def solve(A, Y, tol, max_iterations, precision="float64"):
    A, Y = A.to(torch.float64), Y.to(torch.float64)
    n = A.shape[1]
    X = torch.zeros((Y.shape[0], n), dtype=torch.float64)
    its = torch.zeros(Y.shape[0], dtype=torch.long)
    for lane, y in enumerate(Y):
        support, x, r = [], torch.zeros(n, dtype=torch.float64), y
        while float(r.norm()) > tol and len(support) < max_iterations:
            support.append(int((A.T @ r).abs().argmax()))
            x = torch.zeros(n, dtype=torch.float64)
            x[support] = torch.linalg.lstsq(A[:, support],
                                            y[:, None]).solution[:, 0]
            r = y - A @ x
        X[lane], its[lane] = x, len(support)
    return X, its, certificate(A, Y, X)
'''
OMP_CONFIG = dict(TINY_CONFIG, name="tiny-omp", facade="Omp",
                  options={"precision": "certified"}, max_iterations=5,
                  reference="omp_plain")
OMP_TRAFFIC = {"entry": "solve_batch", "batch": 16, "k_min": 2, "k_max": 8,
               "amplitude": [0.5, 1.0], "pool_calls": 2, "warmup_calls": 1,
               "check_calls": 2, "trace_calls": 1}


def add_omp(dest: Path) -> str:
    """Add the OMP family's files and entries to a checkout made by
    ``checkout``; returns the new cell's name."""
    bench = dest / "perfbench"
    (bench / "reference" / "omp_plain.py").write_text(OMP_REFERENCE)
    (bench / "configs" / "tiny-omp.json").write_text(json.dumps(OMP_CONFIG))
    (bench / "traffic" / "tiny-omp-batch.json").write_text(
        json.dumps(OMP_TRAFFIC))
    (bench / "checks" / "tiny.omp.json").write_text(json.dumps(TINY_LIMITS))
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    spec["configs"].append({
        "name": "tiny-omp", "source": "a test size",
        "file": "perfbench/configs/tiny-omp.json", "reduced": [],
        "why": "CPU tests"})
    spec["workloads"].append({"name": "tiny.omp", "config": "tiny-omp",
                              "traffic": "tiny-omp-batch", "chips": 1,
                              "why": "CPU tests"})
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return "tiny.omp"
