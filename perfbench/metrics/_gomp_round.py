"""The work of an OMP or gOMP round of the slot-space driver, counted
from what its lanes need and not from the launches: the least the card
could compute and move for the passes and inserts the traced calls ran,
whatever implements the round.

A pass is one q = A^T A D over the call's lanes (``_yardstick.
q_pass_work``, bf16 products, as the configuration's "certified" path
runs them); each lane's committed columns are one insert each
(``_omp_insert.lane_seconds``). The passes are the program's
``omp.passes`` counter, which its loops record on every trip, replays
included; a program without it reads None.
"""

from __future__ import annotations

from perfbench.metrics._omp_insert import lane_seconds
from perfbench.metrics._yardstick import bound_seconds, q_pass_work


def call_passes(run):
    """Each traced call's ``omp.passes``, in order, or None where the
    program keeps no span store, its records do not line up with the
    traced calls (each record's ``api.lanes`` the lanes of its call), or
    a call counts no pass."""
    t = run.traced
    if t is None or not t.calls:
        return None
    try:
        from sparse_solvers_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "calls"):
        return None
    records = profiling.calls()[-len(t.calls):]
    if len(records) < len(t.calls) or any(
            r.counters.get("api.lanes") != len(c.iters)
            for r, c in zip(records, t.calls)):
        return None
    passes = [r.counters.get("omp.passes", 0) for r in records]
    if not all(passes):
        return None
    return passes


def call_seconds(iters, passes: int, m: int, n: int) -> float:
    """The least time of one call: ``passes`` q passes over its lanes and
    each lane's ``iter`` inserts, at live sizes 1 to ``iter``."""
    return (passes * bound_seconds(*q_pass_work(len(iters), m, n), "bf16")
            + sum(lane_seconds(int(i)) for i in iters))
