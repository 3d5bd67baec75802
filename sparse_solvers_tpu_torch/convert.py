"""State carried across from the JAX package.

The JAX package's batch-driver state (``sparse_solvers_tpu.solvers.
homotopy_batch._BState``), handed over as a dict of numpy arrays, becomes
the port's ``_BState`` on a device, and back — so a test can step both
drivers from identical state. The one representational difference: the
iteration count is uint32 in JAX and int32 here.
"""

from __future__ import annotations

import numpy as np
import torch

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
