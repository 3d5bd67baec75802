"""Fixed-capacity sorted active set — the port of
``sparse_solvers_tpu/linalg/active_set.py``, the analog of the reference's
``rank_index`` (src/linalg/rank_index.h:26-98).

The set lives in a fixed-capacity int32 vector: the first ``k`` slots hold
the member column indices in ascending order, the rest the sentinel ``n``
(one past any valid column), which keeps the vector ascending and makes a
rank one vectorized comparison. Every function works over leading lane
axes: ``indices`` (..., capacity) against a ``value`` of shape (...).

The sentinel never reaches an index operation on a device: ``take`` and
``scatter`` below clamp it into range and mask its slot, because an
out-of-range index on a CUDA tensor is a device-side assert, where JAX's
``mode="fill"`` and ``mode="drop"`` read zeros and drop writes.
"""

from __future__ import annotations

import torch


def _values(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` as an int tensor with a trailing axis to broadcast
    against ``like`` (..., capacity)."""
    return torch.as_tensor(value, dtype=like.dtype,
                           device=like.device).unsqueeze(-1)


def empty(capacity: int, n: int, lanes: int | None = None,
          device=None) -> torch.Tensor:
    """An empty active set over columns [0, n) with the given capacity
    (one per lane when ``lanes`` is given)."""
    shape = (capacity,) if lanes is None else (lanes, capacity)
    return torch.full(shape, n, dtype=torch.int32, device=device)


def rank_of(indices: torch.Tensor, value) -> torch.Tensor:
    """Rank (position) ``value`` would occupy / occupies: the reference's
    ``rank_index::rank_of`` for members and its ``insert`` return value for
    non-members (rank_index.h:40-75). Sentinel slots never count."""
    return (indices < _values(value, indices)).sum(dim=-1).to(torch.int32)


def contains(indices: torch.Tensor, value) -> torch.Tensor:
    """Membership test (rank_index.h rank_of >= 0 analog)."""
    return (indices == _values(value, indices)).any(dim=-1)


def insert(indices: torch.Tensor, value, n: int):
    """Insert ``value``, returning (new_indices, rank). The caller
    guarantees non-membership and spare capacity. Reference: rank_index.h
    insert."""
    r = rank_of(indices, value).unsqueeze(-1)
    v = _values(value, indices)
    i = torch.arange(indices.shape[-1], device=indices.device)
    shifted = torch.cat([v, indices[..., :-1]], dim=-1)
    out = torch.where(i < r, indices, torch.where(i == r, v, shifted))
    return out.to(torch.int32), r.squeeze(-1)


def remove(indices: torch.Tensor, value, n: int):
    """Remove ``value``, returning (new_indices, old_rank). The caller
    guarantees membership. Reference: rank_index.h erase."""
    r = rank_of(indices, value).unsqueeze(-1)
    i = torch.arange(indices.shape[-1], device=indices.device)
    shifted = torch.cat([indices[..., 1:], indices[..., -1:]], dim=-1)
    out = torch.where(i < r, indices, shifted)
    # the last slot always becomes padding after a removal
    out = torch.where(i == indices.shape[-1] - 1, n, out)
    return out.to(torch.int32), r.squeeze(-1)


def rank_at(indices: torch.Tensor, rank) -> torch.Tensor:
    """Value stored at the given rank. Reference: rank_index.h rank_at."""
    r = torch.as_tensor(rank, device=indices.device).long().unsqueeze(-1)
    return indices.gather(-1, r).squeeze(-1)


def take(v: torch.Tensor, indices: torch.Tensor, n: int) -> torch.Tensor:
    """v[..., indices] with sentinel slots reading 0 (JAX's ``jnp.take(v,
    indices, mode="fill", fill_value=0)``): v (..., n), indices
    (..., capacity)."""
    got = v.gather(-1, indices.clamp(0, max(n - 1, 0)).long())
    return torch.where(indices < n, got, torch.zeros_like(got))


def scatter(values: torch.Tensor, indices: torch.Tensor,
            n: int) -> torch.Tensor:
    """A zero (..., n) vector with ``values`` (..., capacity) written at
    ``indices``, sentinel slots dropped (JAX's ``.at[indices].set(values,
    mode="drop")``). Live indices are unique, so the scatter-add writes each
    value exactly once and the sentinel slots add exact zeros at a clamped
    column."""
    out = values.new_zeros(values.shape[:-1] + (n,))
    if n:
        live = indices < n
        out.scatter_add_(-1, indices.clamp(max=n - 1).long(),
                         torch.where(live, values, torch.zeros_like(values)))
    return out


def compact_from_dense(X: torch.Tensor, k_max: int):
    """The compact (values, indices) form of a dense batch solution X
    (b, n), the per-lane core's ``dense=False`` (api.py:2103-2115 of the
    JAX package): per lane the ≤ k_max nonzero coordinates in ascending
    index order, sentinel n beyond them. An exactly-zero active coordinate
    contributes nothing either way."""
    n = X.shape[1]
    nz = X != 0
    order = torch.sort((~nz).to(torch.int8), dim=1,
                       stable=True).indices[:, :k_max]
    keep = nz.gather(1, order)
    vals = torch.where(keep, X.gather(1, order), torch.zeros_like(X[:, :1]))
    idxs = torch.where(keep, order, torch.full_like(order, n))
    return vals, idxs.to(torch.int32)
