"""The host's time to issue one driver iteration: the self time of the
program's ``solvers.iter`` spans (a trip's body and the liveness test
after it, less any ``solvers.sync`` inside them) over the traced calls,
in ms per span. A host time taken while the profiler records: the
profiler adds host time to every kernel launch, so the figure holds that
cost (PERF.md, section 3) and falls with the launches as well as with
the host's own work."""

from perfbench.metrics import _spans


def read(run):
    records = _spans.traced_records(run)
    if records is None:
        return None
    iters = _spans.named(records, "solvers.iter")
    if not iters:
        return None
    kids = _spans.children(records)
    return sum(_spans.self_ns(s, kids) for s in iters) * 1e-6 / len(iters)
