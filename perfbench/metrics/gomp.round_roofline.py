"""The gOMP round's share of its roofline: the least time the card could
take for the work the traced calls ran (each call's ``omp.passes`` q
passes over its lanes at the bf16 peak, and each lane's ``iter`` K4
inserts; ``_gomp_round.call_seconds``), over the seconds in which
anything ran on the card in those calls, in %. None without device
operations, or where the program does not count the passes
(``_gomp_round.call_passes``)."""

from perfbench import trace
from perfbench.metrics import _gomp_round


def read(run):
    t = run.traced
    if t is None or not t.device:
        return None
    passes = _gomp_round.call_passes(run)
    if passes is None:
        return None
    m, n = run.config["m"], run.config["n"]
    bound = sum(_gomp_round.call_seconds(c.iters, p, m, n)
                for c, p in zip(t.calls, passes))
    busy = trace.busy_seconds(t.device)
    if busy <= 0:
        return None
    return 100 * bound / busy
