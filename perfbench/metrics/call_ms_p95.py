"""95th percentile of the wall time of every call of the window (a
``solve_batch`` of the mix's batch, or one ``solve``), each call fenced
by a synchronize."""

import statistics


def read(run):
    walls = [c.wall_s * 1e3 for c in run.window]
    if len(walls) < 2:
        return walls[0]
    return statistics.quantiles(walls, n=20, method="inclusive")[18]
