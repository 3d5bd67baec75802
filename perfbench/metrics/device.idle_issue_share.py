"""Share of the card's idle time inside the traced calls that the host
spent issuing a driver iteration: idle is the union of the program's root
spans less the union of the operations on the card; the share of it that
lies in the self time of ``solvers.iter`` spans (issue, not a sync), in
%. The idle a change to the host loop can recover."""

from perfbench.metrics import _spans


def read(run):
    records = _spans.traced_records(run)
    if records is None or not run.traced.device:
        return None
    idle = _spans.idle(run, records)
    if _spans.length(idle) <= 0:
        return None
    issue = _spans.self_intervals(_spans.named(records, "solvers.iter"),
                                  _spans.children(records))
    return 100 * _spans.length(_spans.intersect(idle, issue)) / (
        _spans.length(idle))
