"""Solver reports — the library's observability API.

Re-defines the JAX package's ``HomotopyReport``, ``OmpReport`` and
``IrlsReport`` (sparse_solvers_tpu/reports.py) with the same field names —
ss::homotopy_report's (policies.h:25-32) and ss::irls_report's
(policies.h:58-71) for the first and the last; the port cannot import
them, since that package pulls in jax. The batched tensor forms are
``solvers.homotopy.HomotopyReportArrays``, ``solvers.omp.OmpReportArrays``
and ``solvers.irls.IrlsReportArrays``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class HomotopyReport:
    """Mirrors ss::homotopy_report (policies.h:25-32)."""
    iter: int = 0
    solution_error: float = 0.0


@dataclass
class OmpReport:
    """OMP report (beyond-reference solver — no policies.h twin; field
    names follow the house style). ``solution_error`` is the final
    residual norm ‖y − Ax‖₂ — OMP's own convergence criterion — unlike
    the homotopy report's ‖Aᵀ(y−Ax)‖∞."""
    iter: int = 0
    solution_error: float = 0.0


@dataclass
class IrlsReport:
    """Mirrors ss::irls_report (policies.h:58-71).

    ``solution_error`` is the final eps of the reweighting schedule, not a
    residual norm (reference: irls-cpu.cpp:123).
    """
    iter: int = 0
    solution_error: float = 0.0
    spd_failure: bool = False
