"""Share of the lanes asked that the certified facade solved twice: the
program's ``api.resolved_lanes`` counter (the "high" re-solve covers the
whole batch once any lane's certificate misses) over ``api.lanes``, over
the traced calls, in %."""

from perfbench.metrics import _spans


def read(run):
    records = _spans.traced_records(run)
    if records is None:
        return None
    lanes = _spans.total(records, "api.lanes")
    if not lanes:
        return None
    return 100 * _spans.total(records, "api.resolved_lanes") / lanes
