"""The collectives of the mesh routes — every all-reduce, gather and ring
step that ``parallel/sharding.py``, the sharded operators and the sharded
drivers issue goes through this module, which counts what it issues.

JAX's mesh routes name their collectives inside ``shard_map`` and XLA
emits them; here each is one ``torch.distributed`` call on a process group
of the mesh (``sharding.Mesh``):

  * ``psum`` over an axis        → ``all_reduce`` (SUM) over that group;
  * ``pmax``                     → ``all_reduce`` (MAX);
  * ``all_gather``               → ``all_gather`` (stacked on a new axis);
  * one ``ppermute`` step of the
    collective-matmul ring       → ``ring_shift``: send to the next rank of
                                   the group, receive from the previous.

``counts`` takes the place of the JAX tests' HLO collective counts, as
``ops/dispatch.launches`` counts kernel launches: each call adds one to
its kind and the bytes it moves to ``<kind>_bytes`` (the payload of an
all-reduce, the gathered output of a gather, the sent tensor of a ring
step). ``reset_counts()`` sets them to 0.

Every all-reduced tensor is float32 or float64 (gloo and NCCL sum both
alike, and the mesh routes reduce nothing else); a gather takes any
dtype, booleans as bytes. An all-reduce works in place on a contiguous
operand and returns it: pass a tensor the caller owns.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

counts = {kind: 0 for kind in ("all_reduce", "all_gather", "ring_step",
                                "all_reduce_bytes", "all_gather_bytes",
                                "ring_step_bytes")}

_REDUCE_DTYPES = (torch.float32, torch.float64)
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def reset_counts() -> None:
    for kind in counts:
        counts[kind] = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The SUM (``op="max"``: MAX) of ``t`` over ``group``, in place;
    every rank of the group gets the same bits."""
    if t.dtype not in _REDUCE_DTYPES:
        raise TypeError(f"all_reduce takes float32 or float64, got {t.dtype}")
    t = t.contiguous()
    dist.all_reduce(t, op=_OPS[op], group=group)
    counts["all_reduce"] += 1
    counts["all_reduce_bytes"] += _nbytes(t)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` over ``group``, stacked in group-rank order:
    (S, *t.shape)."""
    S = dist.get_world_size(group)
    src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    flat = src.reshape((1,) + tuple(src.shape)) if src.dim() == 0 else src
    out = torch.empty((S * flat.shape[0],) + tuple(flat.shape[1:]),
                      dtype=src.dtype, device=src.device)
    # all_gather_single is the name from torch 2.13 on
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, flat, group=group)
    counts["all_gather"] += 1
    counts["all_gather_bytes"] += _nbytes(out)
    out = out.reshape((S,) + tuple(t.shape))
    return out.to(torch.bool) if t.dtype == torch.bool else out


def group_rank(group) -> int:
    """This rank's index in ``group``."""
    return dist.get_rank(group)


def ring_shift(t: torch.Tensor, group) -> torch.Tensor:
    """One step of the ring over ``group`` (JAX's ``ppermute`` with the
    pairs (s, s+1 mod S)): send ``t`` to the next rank of the group and
    return what the previous one sent."""
    S = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % S)
    prev = dist.get_global_rank(group, (me - 1) % S)
    t = t.contiguous()
    buf = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, nxt, group),
           dist.P2POp(dist.irecv, buf, prev, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    counts["ring_step"] += 1
    counts["ring_step_bytes"] += _nbytes(t)
    return buf
