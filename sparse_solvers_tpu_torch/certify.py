"""The certified re-solve, one policy for the ``Homotopy`` and ``Omp``
façades (``api.py``) and their sharded routes (``parallel/sharding.py``),
which both call it: which lanes fail their certificate
(``failed_lanes``), the re-solve at ``RESOLVE_PRECISION`` and the merge of
its lanes over the first answer (``certified_one``, ``certified_batch``,
``merge_lanes``), and the iteration-budget check every route shares. It
imports nothing from its callers.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils import profiling

RESOLVE_PRECISION = "high"


def check_max_iterations(max_iterations: int) -> int:
    """The reference's caller contract (homotopy-cpu.cpp:193:
    ``assert(max_iter > 0)``) as an edge ValueError."""
    if max_iterations < 1:
        raise ValueError(
            f"max_iterations must be >= 1, got {max_iterations}")
    return max_iterations


def read(t: torch.Tensor, to_host):
    """``to_host(t)``, a read of a device value that waits for the device:
    a ``solvers.sync`` span."""
    with profiling.span("solvers.sync", what="read"):
        return to_host(t)


def _host_array(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def failed_lanes(errs, iters, tolerance, max_iterations: int):
    """Which lanes re-solve, from host values: a batch's arrays, or a
    single solve's numbers. A lane fails where its certificate missed the
    tolerance (NaN-safe: a non-finite certificate fails) without
    exhausting max_iterations. Looked up at call time, so tests can
    replace it to force the re-solve and the merge; on a mesh every rank
    calls it on the same gathered values."""
    return (~(np.asarray(errs) <= float(tolerance))
            & (np.asarray(iters) < max_iterations))


def merge_lanes(sel: torch.Tensor, new, old, dense: bool):
    """Per-lane select of a re-solve's output (dense X, or the compact
    (values, indices) pair) over the first solve's."""
    if dense:
        return torch.where(sel[:, None], new, old)
    return tuple(torch.where(sel[:, None], a, b) for a, b in zip(new, old))


def certified_one(solve, certified: bool, tolerance, max_iterations: int):
    """A single solve, ``solve()`` → (x, report) at the caller's precision,
    as ``(x, iterations, error)`` with its report read on the host (two
    ``read`` syncs). Where ``certified`` and the certificate failed, the
    solve is taken again whole, ``solve(RESOLVE_PRECISION)``, in an
    ``api.resolve`` span."""
    x, rep = solve()
    it, err = read(rep.iter, int), read(rep.solution_error, float)
    if certified and failed_lanes(err, it, tolerance, max_iterations):
        with profiling.span("api.resolve"):
            profiling.count("api.resolved_lanes")
            x, rep = solve(RESOLVE_PRECISION)
            it, err = read(rep.iter, int), read(rep.solution_error, float)
    return x, it, err


def certified_batch(solve, certified: bool, tolerance, max_iterations: int,
                    dense: bool = True):
    """A batch solve, ``solve()`` → (out, report) at the caller's
    precision, with ``out`` X or, where ``dense`` is off, (values,
    indices); returned as ``(X, report)`` or ``(values, indices,
    report)``. Where ``certified``, the certificates and iterations are
    read on the host, and where a lane failed, the whole batch is solved
    again, ``solve(RESOLVE_PRECISION)``, in an ``api.resolve`` span, and
    the failed lanes' answers and reports are merged over the first
    ones."""
    out, rep = solve()
    if certified:
        errs = read(rep.solution_error, _host_array)
        bad = failed_lanes(errs, read(rep.iter, _host_array), tolerance,
                           max_iterations)
        if bad.any():
            with profiling.span("api.resolve"):
                profiling.count("api.resolved_lanes", len(bad))
                out_h, rep_h = solve(RESOLVE_PRECISION)
                # the mask's upload from pageable memory waits for the
                # device
                with profiling.span("solvers.sync", what="copy"):
                    sel = torch.as_tensor(bad, device=rep.iter.device)
                out = merge_lanes(sel, out_h, out, dense)
                rep = type(rep)(*(torch.where(sel, h, f)
                                  for h, f in zip(rep_h, rep)))
    return (out, rep) if dense else (*out, rep)
