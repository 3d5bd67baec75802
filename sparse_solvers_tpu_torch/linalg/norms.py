"""Norms and normalization — the port of
``sparse_solvers_tpu/linalg/norms.py``. Reference: src/linalg/norms.h:22-33
and the ``inf_norm`` helpers of the homotopy solver
(src/solvers/homotopy-cpu.cpp:32-44). Each reduces over the last axis, so a
leading axis batches lanes.
"""

from __future__ import annotations

import torch


def l1_columns(A: torch.Tensor) -> torch.Tensor:
    """Normalize each column of A by its L1 norm (norms.h l1(ndspan<T,2>))."""
    return A / A.abs().sum(dim=-2, keepdim=True)


def l1_vector(x: torch.Tensor) -> torch.Tensor:
    """Normalize a vector by its L1 norm (norms.h l1(ndspan<T,1>))."""
    return x / x.abs().sum(dim=-1, keepdim=True)


def inf_norm_with_index(v: torch.Tensor):
    """(‖v‖∞, index of the first max-|v| element).

    Reference: homotopy-cpu.cpp:32-44 — ixamax returns the *first* index of
    the maximum absolute value, which the homotopy tie-breaking relies on;
    ``torch.argmax`` returns the first maximal index too."""
    idx = torch.argmax(v.abs(), dim=-1)
    return v.abs().gather(-1, idx.unsqueeze(-1)).squeeze(-1), idx


def inf_norm(v: torch.Tensor) -> torch.Tensor:
    return v.abs().amax(dim=-1)
