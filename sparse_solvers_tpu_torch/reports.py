"""Solver reports — the library's observability API.

Re-defines the JAX package's ``HomotopyReport`` (sparse_solvers_tpu/
reports.py) with the exact field names of the reference's
ss::homotopy_report (policies.h:25-32); the port cannot import it, since
that package pulls in jax. The batched tensor form is
``solvers.homotopy.HomotopyReportArrays``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class HomotopyReport:
    """Mirrors ss::homotopy_report (policies.h:25-32)."""
    iter: int = 0
    solution_error: float = 0.0
