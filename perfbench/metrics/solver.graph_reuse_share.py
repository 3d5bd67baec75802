"""Share of the graph-route loop runs that replayed a trip graph kept from
an earlier call, over the traced calls, in %: the program's
``solvers.graph_reuses`` counter (once a loop run on a kept graph) over
itself plus its ``solvers.capture`` spans (once a loop run that captured
its trip). 100 where every loop of the traced calls ran on graphs its
façade kept; a call that captures (a new key, the "high" re-solve)
lowers it. None where the program keeps no graphs across calls or no
span store, or where no loop of the traced calls took the graph route
(every loop on the CPU)."""

from perfbench.metrics import _spans


def read(run):
    records = _spans.traced_records(run)
    if records is None:
        return None
    try:
        from sparse_solvers_tpu_torch.solvers import loops
    except ImportError:
        return None
    if not hasattr(loops, "Kept"):
        return None
    reuses = _spans.total(records, "solvers.graph_reuses")
    runs = reuses + len(_spans.named(records, "solvers.capture"))
    if not runs:
        return None
    return 100 * reuses / runs
