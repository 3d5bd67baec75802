"""The facade's own host time per call: the self time of the program's
root span of each traced call (``api.solve_batch`` or ``api.solve``) less
every child: the conversion of the input, the solve function's set-up
and the certificate's comparison with the tolerance, in ms per call. A
host time taken while the profiler records, which adds host time to
each kernel launch (PERF.md, section 3)."""

from perfbench.metrics import _spans


def read(run):
    records = _spans.traced_records(run)
    if records is None:
        return None
    roots = _spans.roots(records)
    if not roots:
        return None
    kids = _spans.children(records)
    return sum(_spans.self_ns(s, kids) for s in roots) * 1e-6 / len(roots)
