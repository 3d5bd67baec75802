"""OMP pieces shared by the batch driver — the port of the report type of
``sparse_solvers_tpu/solvers/omp.py`` (:52-56). The per-lane core
``solve_omp_core`` is ROADMAP.md Queue 1 item 6.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class OmpReportArrays(NamedTuple):
    """Per-lane report tensors: iterations = support size reached,
    solution_error = final residual ℓ₂ norm ‖y − Ax‖₂."""
    iter: torch.Tensor            # (b,) int32 (uint32 in the JAX package)
    solution_error: torch.Tensor  # (b,) ‖r‖₂
