"""Masked online column inverse — the port of
``sparse_solvers_tpu/linalg/online_inverse.py``: (A_ΓᵀA_Γ)⁻¹ maintained on
a padded buffer as columns enter and leave Γ (reference:
src/linalg/online_inverse.h:35-301).

Every state carries a leading lane axis: ``inv`` (b, K, K), ``indices``
(b, K), ``mask`` (b, n), ``k`` (b,), and the column arguments are (b,).
One lane is b = 1. The live k×k block sits top-left, everything outside
it is zero. Two layouts, as in the JAX package:

  * ordered (``insert`` / ``remove``, exact mode): the block is in rank
    order, and the reference's ``square_permute`` rotations are one
    double gather per toggle, on the device;
  * unordered (``insert_unordered`` / ``remove_unordered``, fast mode):
    slots in insertion order, an append and a swap-remove.

Update math (the reference's): insert borders with Sherman–Morrison —
u1 = A_Γᵀv, u2 = B·u1, d = 1/(vᵀv − u1ᵀu2), B += d·u2u2ᵀ, new row/col
−d·u2, corner d; remove downdates B := B − u uᵀ/d with u the removed
row/col and d its corner.

Every function runs on all lanes, including lanes whose caller will keep
the old state (a frozen lane, the unselected side of a toggle). Where
JAX indexes with a slot out of range there (k = K on a full insert,
k − 1 = −1 on an empty set), the gathers here wrap and clamp as JAX's do
and the writes match nothing, so no index ever leaves its tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import blas
from . import active_set


class InverseState(NamedTuple):
    """Padded inverse + active-set bookkeeping, one row per lane."""
    inv: torch.Tensor      # (b, K, K), live k×k block
    indices: torch.Tensor  # (b, K) int32, padded with n
    mask: torch.Tensor     # (b, n) bool membership
    k: torch.Tensor        # (b,) int32 live size


def init(capacity: int, n: int, dtype, lanes: int = 1,
         device=None) -> InverseState:
    return InverseState(
        inv=torch.zeros((lanes, capacity, capacity), dtype=dtype,
                        device=device),
        indices=active_set.empty(capacity, n, lanes, device),
        mask=torch.zeros((lanes, n), dtype=torch.bool, device=device),
        k=torch.zeros(lanes, dtype=torch.int32, device=device),
    )


def _slot(i: torch.Tensor, capacity: int) -> torch.Tensor:
    """A slot index as JAX gathers it: negative wraps once, then clamps."""
    i = torch.where(i < 0, i + capacity, i)
    return i.clamp(0, capacity - 1).long()


def _col(M: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """M[lane, :, j[lane]] → (b, K)."""
    return M.gather(-1, _slot(j, M.shape[-1])[..., None, None].expand(
        *M.shape[:-1], 1)).squeeze(-1)


def _row(M: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """M[lane, i[lane], :] → (b, K)."""
    return M.gather(-2, _slot(i, M.shape[-1])[..., None, None].expand(
        *M.shape[:-2], 1, M.shape[-1])).squeeze(-2)


def _at(v: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """v[lane, i[lane]] → (b,), with JAX's wrap-and-clamp."""
    return v.gather(-1, _slot(i, v.shape[-1]).unsqueeze(-1)).squeeze(-1)


def _move_perm(capacity: int, src, dest, device=None) -> torch.Tensor:
    """Permutation moving row/col ``src`` to ``dest`` with the entries
    between shifted — the reference's ``square_permute``
    (online_inverse.h:76-117) as a gather index, (..., capacity)."""
    src = torch.as_tensor(src, device=device).unsqueeze(-1)
    dest = torch.as_tensor(dest, device=device).unsqueeze(-1)
    i = torch.arange(capacity, device=device)
    fwd = torch.where(i < src, i, torch.where(
        i < dest, i + 1, torch.where(i == dest, src, i)))
    bwd = torch.where(i < dest, i, torch.where(
        i == dest, src, torch.where(i <= src, i - 1, i)))
    return torch.where(src <= dest, fwd, bwd)


def square_permute(A: torch.Tensor, src, dest) -> torch.Tensor:
    """Apply the src→dest row+column rotation to a square matrix
    (..., K, K), per lane when ``src``/``dest`` carry a lane axis."""
    cap = A.shape[-1]
    perm = _slot(_move_perm(cap, src, dest, A.device), cap)
    rows = A.gather(-2, perm.unsqueeze(-1).expand(*perm.shape, cap))
    return rows.gather(-1, perm.unsqueeze(-2).expand(*perm.shape[:-1], cap,
                                                     cap))


def _border(inv: torch.Tensor, k: torch.Tensor, u1: torch.Tensor,
            vtv: torch.Tensor) -> torch.Tensor:
    """The bordered inverse with the new row/col at slot k (the Sherman–
    Morrison step shared by both inserts, online_inverse.h:184-251). Row
    and column k of the buffer are zero before (outside the live block,
    and u2[k] = 0), so setting them is exact; a k equal to the capacity
    writes nothing, as JAX drops it."""
    u2 = blas.xgemv(inv, u1)
    d = 1 / (vtv - blas.xdot(u1, u2))
    new_inv = blas.xger(d, u2, u2, inv)
    i = torch.arange(inv.shape[-1], device=inv.device)
    at_k = i == k.unsqueeze(-1)
    u3 = torch.where(i < k.unsqueeze(-1), -d.unsqueeze(-1) * u2,
                     torch.zeros_like(u2))
    row_k = torch.where(at_k, d.unsqueeze(-1), u3)
    new_inv = torch.where(at_k.unsqueeze(-1), row_k.unsqueeze(-2), new_inv)
    return torch.where(at_k.unsqueeze(-2), row_k.unsqueeze(-1), new_inv)


def _set_mask(mask: torch.Tensor, col: torch.Tensor,
              value: bool) -> torch.Tensor:
    return mask.scatter(-1, col.long().unsqueeze(-1), value)


def insert(state: InverseState, col: torch.Tensor, u1_full: torch.Tensor,
           vtv: torch.Tensor) -> InverseState:
    """Insert column ``col`` (b,) whose Gram column ``u1_full`` (b, n) =
    (AᵀA)[:, col] and ``vtv`` (b,) = vᵀv are supplied; the live entries are
    gathered here. Reference: online_inverse.h:184-251."""
    inv, indices, mask, k = state
    n = mask.shape[-1]
    new_indices, r = active_set.insert(indices, col, n)
    u1 = active_set.take(u1_full, indices, n)
    new_inv = square_permute(_border(inv, k, u1, vtv), k, r)
    return InverseState(inv=new_inv, indices=new_indices,
                        mask=_set_mask(mask, col, True), k=k + 1)


def remove(state: InverseState, col: torch.Tensor) -> InverseState:
    """Remove column ``col`` (b,): permute its rank to the end of the live
    block, then Schur-downdate. Reference: online_inverse.h:253-293."""
    inv, indices, mask, k = state
    n = mask.shape[-1]
    new_indices, r = active_set.remove(indices, col, n)
    last = k - 1
    p = square_permute(inv, r, last)
    new_inv, keep = _downdate(p, last)
    new_indices = torch.where(keep, new_indices, n).to(torch.int32)
    return InverseState(inv=new_inv, indices=new_indices,
                        mask=_set_mask(mask, col, False), k=last)


def _downdate(p: torch.Tensor, last: torch.Tensor):
    """B − u uᵀ/d with u = p[:, last] over the slots before ``last`` and d
    = p[last, last], then row/col ``last`` and beyond zeroed. Returns the
    new block and the slots kept (i < last)."""
    d = _at(_row(p, last), last)
    i = torch.arange(p.shape[-1], device=p.device)
    keep = i < last.unsqueeze(-1)
    u = torch.where(keep, _col(p, last), torch.zeros_like(d).unsqueeze(-1))
    new = p - (u.unsqueeze(-1) * u.unsqueeze(-2)) / d[..., None, None]
    return torch.where(keep.unsqueeze(-1) & keep.unsqueeze(-2), new,
                       torch.zeros_like(new)), keep


def _swap_rowcol(M: torch.Tensor, i: torch.Tensor,
                 j: torch.Tensor) -> torch.Tensor:
    """Exchange rows i, j and columns i, j of (b, K, K) per lane. The
    rows and columns are read at clamped positions, as JAX's
    dynamic_slice reads them; the selects compare the raw ones."""
    cap = M.shape[-1]
    idx = torch.arange(cap, device=M.device)
    is_i = (idx == i.unsqueeze(-1)).unsqueeze(-1)
    is_j = (idx == j.unsqueeze(-1)).unsqueeze(-1)
    ci, cj = i.clamp(0, cap - 1), j.clamp(0, cap - 1)
    ri, rj = _row(M, ci).unsqueeze(-2), _row(M, cj).unsqueeze(-2)
    M = torch.where(is_i, rj, torch.where(is_j, ri, M))
    coli, colj = _col(M, ci).unsqueeze(-1), _col(M, cj).unsqueeze(-1)
    return torch.where(is_i.mT, colj, torch.where(is_j.mT, coli, M))


def swap_drop_rowcol(M: torch.Tensor, pos: torch.Tensor,
                     last: torch.Tensor) -> torch.Tensor:
    """Swap rows/cols pos↔last and zero out row/col ``last`` — the
    companion-matrix form of an unordered removal (the active Gram
    submatrix kept in lockstep with the inverse)."""
    pos = torch.as_tensor(pos, device=M.device)
    last = torch.as_tensor(last, device=M.device)
    p = _swap_rowcol(M, pos, last)
    keep = torch.arange(M.shape[-1], device=M.device) != last.unsqueeze(-1)
    return torch.where(keep.unsqueeze(-1) & keep.unsqueeze(-2), p,
                       torch.zeros_like(p))


def insert_unordered(state: InverseState, col: torch.Tensor,
                     u1: torch.Tensor, vtv: torch.Tensor) -> InverseState:
    """Insert ``col`` by appending its bordered row/col at slot k: the same
    bordering as :func:`insert` without the rank-order rotation. ``u1``
    (b, K) is already gathered to the live slots, zero in padding."""
    inv, indices, mask, k = state
    i = torch.arange(inv.shape[-1], device=inv.device)
    new_indices = torch.where(i == k.unsqueeze(-1),
                              col.to(torch.int32).unsqueeze(-1), indices)
    return InverseState(inv=_border(inv, k, u1, vtv), indices=new_indices,
                        mask=_set_mask(mask, col, True), k=k + 1)


def remove_unordered(state: InverseState, col: torch.Tensor) -> InverseState:
    """Remove ``col`` from an insertion-ordered inverse: swap its slot with
    the last live slot, then Schur-downdate — the math of :func:`remove`
    with the rotation replaced by a swap."""
    inv, indices, mask, k = state
    n = mask.shape[-1]
    pos = torch.argmax((indices == col.unsqueeze(-1)).to(torch.int8),
                       dim=-1).to(torch.int32)
    last = k - 1
    new_inv, _ = _downdate(_swap_rowcol(inv, pos, last), last)
    i = torch.arange(inv.shape[-1], device=inv.device)
    new_indices = torch.where(i == pos.unsqueeze(-1),
                              _at(indices, last).unsqueeze(-1), indices)
    new_indices = torch.where(i == _slot(last, inv.shape[-1]).unsqueeze(-1),
                              n, new_indices).to(torch.int32)
    return InverseState(inv=new_inv, indices=new_indices,
                        mask=_set_mask(mask, col, False), k=last)
