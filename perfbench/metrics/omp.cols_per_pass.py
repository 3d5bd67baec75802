"""Columns committed a pass over A in the OMP slot-space driver, over the
traced calls: the lanes' reported ``iter`` (each lane's support size)
summed, over the sum of each call's lanes times its ``omp.passes`` (the
program's count of the driver's trips, replays included). About 1 at
picks 1 and up to picks with gOMP; a tier boundary that cuts a round, or
lanes that finish early while others run on, lower it. None where the
program does not count the passes or its records do not line up with the
traced calls (``_gomp_round.call_passes``)."""

from perfbench.metrics import _gomp_round


def read(run):
    passes = _gomp_round.call_passes(run)
    if passes is None:
        return None
    calls = run.traced.calls
    cols = sum(sum(int(i) for i in c.iters) for c in calls)
    lane_passes = sum(len(c.iters) * p for c, p in zip(calls, passes))
    return cols / lane_passes
