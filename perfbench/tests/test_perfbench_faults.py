"""A run with the timed path broken underneath reads ``correct`` false:
each fault a cell can have, planted in the program, and the control (the
plain reference in bf16 put in the program's place). On the CPU at a
tiny size, past the harness's look for a card; the limits are the
cells' own (``_cases.TINY_LIMITS``)."""

import pytest
import torch

import _cases
from perfbench import harness
from perfbench.reference import homotopy as reference
from sparse_solvers_tpu_torch import api
from sparse_solvers_tpu_torch.reports import HomotopyReport
from sparse_solvers_tpu_torch.solvers import homotopy as core
from sparse_solvers_tpu_torch.solvers import homotopy_batch as driver

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _cases.checkout(tmp_path_factory.mktemp("checkout"))


def correct(root, cell, seed=13):
    result, _ = harness.run_cell(root, cell, seed, 0.3, False, CPU, 0.0)
    return result["correct"], result["checks"]


@pytest.mark.parametrize("cell", sorted(_cases.CELLS))
def test_sound_runs_are_correct(root, cell):
    assert correct(root, cell)[0]


def step_unchanged(monkeypatch):
    """Every step of both loops returns its solution unchanged: the step
    length is 0 (the loops still count their iterations and end)."""
    scan = driver._scan.find_max_gamma_fused
    monkeypatch.setattr(driver._scan, "find_max_gamma_fused",
                        lambda *a: (torch.zeros_like(scan(*a)[0]),
                                    scan(*a)[1]))
    gamma = core._find_max_gamma
    monkeypatch.setattr(core, "_find_max_gamma",
                        lambda *a: (torch.zeros_like(gamma(*a)[0]),
                                    gamma(*a)[1]))


def half_the_batch(monkeypatch):
    """The batch driver solves the first half of its lanes and returns
    zeros, with the first half's reports, for the rest."""
    solve = driver.solve_homotopy_batch

    def half(A, G, Y, *args, **kwargs):
        h = Y.shape[0] // 2
        X, rep = solve(A, G, Y[:h], *args, **kwargs)
        pad = lambda t: torch.cat([t, t[:Y.shape[0] - h]])
        return (torch.cat([X, torch.zeros_like(X[:Y.shape[0] - h])]),
                type(rep)(iter=pad(rep.iter),
                          solution_error=pad(rep.solution_error)))
    monkeypatch.setattr(driver, "solve_homotopy_batch", half)


def answer_altered(monkeypatch):
    """One coordinate of lane 0's answer moved where the facade produces
    it, after its certificate."""
    solve_batch, solve = api.Homotopy.solve_batch, api.Homotopy.solve

    def altered_batch(self, *args, **kwargs):
        X, rep = solve_batch(self, *args, **kwargs)
        X = X.clone()
        X[0, 7] += 0.05
        return X, rep

    def altered(self, *args, **kwargs):
        x, rep = solve(self, *args, **kwargs)
        x = x.clone()
        x[7] += 0.05
        return x, rep
    monkeypatch.setattr(api.Homotopy, "solve_batch", altered_batch)
    monkeypatch.setattr(api.Homotopy, "solve", altered)


def control(monkeypatch):
    """The plain reference computed in bf16, in the facade's place."""
    def solve_batch(self, Y, tolerance, max_iterations):
        X, it, c_inf = reference.solve(self._A, Y, tolerance, max_iterations,
                                       "bfloat16")
        return X, driver.HomotopyReportArrays(iter=it, solution_error=c_inf)

    def solve(self, y, tolerance, max_iterations):
        X, it, c_inf = reference.solve(self._A, y[None], tolerance,
                                       max_iterations, "bfloat16")
        return X[0], HomotopyReport(int(it[0]), float(c_inf[0]))
    monkeypatch.setattr(api.Homotopy, "solve_batch", solve_batch)
    monkeypatch.setattr(api.Homotopy, "solve", solve)


FAULTS = [("tiny.batch", step_unchanged), ("tiny.single", step_unchanged),
          ("tiny.batch", half_the_batch), ("tiny.batch", answer_altered),
          ("tiny.single", answer_altered), ("tiny.batch", control),
          ("tiny.single", control)]


@pytest.mark.parametrize("cell, fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_path_is_not_correct(root, monkeypatch, cell, fault):
    fault(monkeypatch)
    ok, checks = correct(root, cell)
    assert not ok, checks
