"""Share of the lanes asked whose per-lane core read the façade's bf16
transposed copy of A at "default" instead of rounding A for each product:
the program's ``api.bf16_copy_lanes`` counter over ``api.lanes``, over the
traced calls, in %. None where no traced call counted it: a program
without the counter, or calls that took no per-lane route."""

from perfbench.metrics import _spans

COUNTER = "api.bf16_copy_lanes"


def read(run):
    records = _spans.traced_records(run)
    if records is None or not any(COUNTER in r.counters for r in records):
        return None
    lanes = _spans.total(records, "api.lanes")
    if not lanes:
        return None
    return 100 * _spans.total(records, COUNTER) / lanes
