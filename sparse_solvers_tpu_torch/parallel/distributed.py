"""Process-group wiring — the port of ``sparse_solvers_tpu/parallel/
distributed.py``, the thin runtime layer under ``parallel/sharding.py``.

JAX's multi-host runtime joins hosts into one single-controller job;
torch.distributed is SPMD: every process (one per card) runs the same
program, and a default process group joins them. This module wraps that
start-up so a solver program needs one call::

    from sparse_solvers_tpu_torch.parallel import distributed
    distributed.initialize()                  # no-op without a launcher
    mesh = distributed.global_mesh(n_data=...)

Under ``torchrun`` the call reads the launcher's environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); elsewhere it takes
explicit arguments in place of JAX's ``coordinator_address``,
``num_processes`` and ``process_id``: ``init_method``
(``"tcp://host:port"`` or ``"file:///path"``), ``world_size`` and
``rank``. The default group's backend follows the device: NCCL where
torch sees a card, gloo otherwise; each mesh makes its own groups on its
device's backend (``sharding.make_mesh``), and a mesh runs on the card
unless it is given ``device="cpu"``.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from . import sharding as _sharding

# Environment variables of a launcher (torchrun) from which
# init_process_group can read its whole configuration ("env://")
_LAUNCH_ENV_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def is_initialized() -> bool:
    """Whether this process has joined a process group (single-process
    programs never need one)."""
    return dist.is_available() and dist.is_initialized()


def _launcher_detected() -> bool:
    return all(os.environ.get(v) for v in _LAUNCH_ENV_VARS)


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               backend: str | None = None, timeout: float | None = None
               ) -> bool:
    """Join this process to the default process group (idempotent).

    With no arguments: join only under a launcher whose environment names
    the group (``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR``, as torchrun
    sets them); on a plain single process this is a no-op returning
    False, so programs can call it unconditionally. With explicit
    arguments: ``torch.distributed.init_process_group`` with them,
    raising on failure as it does. ``backend`` defaults to NCCL where
    torch sees a card and gloo otherwise; ``timeout`` (seconds) bounds
    every collective of the group and of every mesh made on it. Returns
    True when the group is (now) initialized."""
    if is_initialized():
        return True
    explicit = (init_method is not None or world_size is not None
                or rank is not None)
    if not explicit and not _launcher_detected():
        return False
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(
        backend=backend or ("nccl" if torch.cuda.is_available() else "gloo"),
        init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank, **kwargs)
    _sharding._GROUP_TIMEOUT = kwargs.get("timeout")
    return True


def global_mesh(n_row: int | None = None, n_data: int = 1, device=None):
    """A (data, row) mesh over every rank of the group
    (``sharding.make_mesh``), on this rank's card unless ``device="cpu"``
    asks for the CPU: without a card and without that, it raises. With
    ``n_data=1`` every rank joins the row
    axis; ranks fill the grid row-major, so with one process per card and
    ``n_data`` = the number of hosts each data row is one host's cards and
    each row group's all-reduce stays within a host."""
    return _sharding.make_mesh(n_row=n_row, n_data=n_data, device=device)


def process_index() -> int:
    """This process's rank (0 in single-process programs)."""
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    """The number of processes in the group (1 in single-process
    programs)."""
    return dist.get_world_size() if is_initialized() else 1
