"""The CoSaMP round's share of its roofline: the least time the card could
take for the rounds the traced calls ran (each lane's ``iter`` rounds,
``_cosamp_round.call_seconds``, counted from the reports and not from any
kernel's launches), over the seconds in which anything ran on the card in
those calls, in %."""

from perfbench import trace
from perfbench.metrics import _cosamp_round


def read(run):
    t = run.traced
    if t is None or not t.device:
        return None
    m, n = run.config["m"], run.config["n"]
    S = _cosamp_round.union_capacity(m, n, run.config["options"]["k_sparsity"])
    bound = sum(_cosamp_round.call_seconds(c.iters, m, n, S)
                for c in t.calls)
    busy = trace.busy_seconds(t.device)
    if bound <= 0 or busy <= 0:
        return None
    return 100 * bound / busy
