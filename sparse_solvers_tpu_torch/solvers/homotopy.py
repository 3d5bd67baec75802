"""Homotopy pieces shared by the batch driver — the port of the parts of
``sparse_solvers_tpu/solvers/homotopy.py`` (:63-91) that the slot-space
driver needs. The per-lane while-loop core is ROADMAP Queue 1 item 4.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class HomotopyReportArrays(NamedTuple):
    """Per-lane report tensors — mirrors ss::homotopy_report
    (reference: include/ss/policies.h:25-32)."""
    iter: torch.Tensor            # (b,) int32 (uint32 in the JAX package)
    solution_error: torch.Tensor  # (b,) final ‖c‖∞ or the certificate


def _sign_deadzone(v: torch.Tensor, tol: float) -> torch.Tensor:
    """sign with a ±tol deadzone (reference: homotopy-cpu.cpp:59-67)."""
    one = torch.ones((), dtype=v.dtype, device=v.device)
    return torch.where(v > tol, one, torch.where(v < -tol, -one, 0 * one))
