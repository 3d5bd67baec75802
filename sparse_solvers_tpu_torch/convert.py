"""State carried across from the JAX package.

The JAX package's batch-driver state (``sparse_solvers_tpu.solvers.
homotopy_batch._BState``) and its online-inverse state (``sparse_solvers_
tpu.linalg.online_inverse.InverseState``), handed over as numpy arrays,
become the port's on a device, and back — so a test can step both packages
from identical state. ``irls_factor_from_numpy`` carries the IRLS
factorization (Q, R and R⁻¹) across the same way. The representational differences: the iteration
count is uint32 in JAX and int32 here, and the port's inverse state
always carries a leading lane axis.
"""

from __future__ import annotations

import numpy as np
import torch

from .linalg.online_inverse import InverseState
from .solvers.homotopy_batch import _BState

_DTYPES = {"it": np.int32, "c": np.float32, "c_inf": np.float32,
           "mask": np.int8, "inv": np.float32, "gk": np.float32,
           "x_act": np.float32, "d_act": np.float32, "c_act": np.float32,
           "indices": np.int32, "kk": np.int32, "broke": np.bool_}


def state_from_numpy(fields: dict, device) -> _BState:
    """A port ``_BState`` on ``device`` from a dict with every _BState
    field as an array (e.g. ``{k: np.asarray(v) for k, v in
    jax_state._asdict().items()}``)."""
    missing = set(_BState._fields) - set(fields)
    if missing:
        raise ValueError(f"state lacks fields {sorted(missing)}")
    return _BState(**{
        k: torch.from_numpy(np.array(fields[k], dtype=_DTYPES[k])).to(device)
        for k in _BState._fields})


def state_to_numpy(state: _BState) -> dict:
    """The inverse of ``state_from_numpy``: a dict of numpy arrays in the
    JAX package's dtypes (``it`` as uint32)."""
    out = {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}
    out["it"] = out["it"].astype(np.uint32)
    return out


def inverse_state_from_numpy(inv, indices, mask, k, device) -> InverseState:
    """A port ``InverseState`` on ``device`` from the JAX state's arrays
    (``np.asarray`` of each field). One lane's state (a 2-d ``inv``) gets
    a lane axis of 1; a vmapped one keeps its lanes."""
    inv = np.asarray(inv)
    lanes = inv.ndim == 2
    arrs = [np.asarray(a) for a in (inv, indices, mask, k)]
    if lanes:
        arrs = [a[None] for a in arrs]
    inv, indices, mask, k = arrs
    return InverseState(
        inv=torch.from_numpy(np.array(inv)).to(device),
        indices=torch.from_numpy(indices.astype(np.int32)).to(device),
        mask=torch.from_numpy(mask.astype(np.bool_)).to(device),
        k=torch.from_numpy(k.astype(np.int32).reshape(-1)).to(device))


def inverse_state_to_numpy(state: InverseState) -> dict:
    """A port ``InverseState`` as a dict of numpy arrays, lane axis
    first."""
    return {f: v.detach().cpu().numpy()
            for f, v in state._asdict().items()}


def irls_factor_from_numpy(Q, R, device, r_inv=None):
    """The JAX package's IRLS factorization as the port's tensors on
    ``device``: (Q (m, n), R (n, n), R⁻¹ or None), in Q's dtype. QR sign
    conventions differ between XLA and LAPACK or cuSOLVER, and the
    iteration is invariant to them only in exact arithmetic, so a test
    that steps both packages hands JAX's own factors over."""
    Q = np.asarray(Q)
    if Q.dtype not in (np.float32, np.float64):
        raise ValueError(f"Q must be float32 or float64, got {Q.dtype}")

    def put(a):
        return torch.from_numpy(np.array(a, dtype=Q.dtype)).to(device)

    return put(Q), put(R), None if r_inv is None else put(r_inv)
