"""K4's share of its roofline: the least time the card could take for the
inserts the traced calls made (every lane's ``iter`` picks, one insert
each, at live sizes 1 to ``iter``: ``_omp_insert.insert_work``, counted
from the reports, not from any kernel's launches), over the device time of
K4's kernel in the traced calls."""

from perfbench.metrics._omp_insert import lane_seconds

KERNEL = "omp_insert_rows_kernel"


def read(run):
    t = run.traced
    if t is None:
        return None
    busy = sum(e - s for name, s, e in t.device if KERNEL in name)
    if busy <= 0:
        return None
    bound = sum(lane_seconds(int(i)) for c in t.calls for i in c.iters)
    return 100 * bound / busy
