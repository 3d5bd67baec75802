"""The arithmetic the span readers share: the program's call records of
the traced calls, a span's self time, and unions, differences and
intersections of intervals on the profiler's clock.

The program (``sparse_solvers_tpu_torch.utils.profiling``) records spans
and counters only while a profiler records, so after a run its records
are those of the traced calls, the newest last. A program without the
span store, or records that do not line up with the traced calls'
reports, read as None.
"""

from __future__ import annotations

from perfbench.metrics._yardstick import union_seconds as length


def traced_records(run):
    """The call records of ``run``'s traced calls, in order, or None when
    the program keeps none, keeps fewer than the traced calls, or a call
    that did not re-solve ran other driver iterations (``solvers.iter``
    spans) than its longest lane reported."""
    t = run.traced
    if t is None or not t.calls:
        return None
    try:
        from sparse_solvers_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "calls"):
        return None
    records = profiling.calls()
    if len(records) < len(t.calls):
        return None
    records = records[-len(t.calls):]
    for record, call in zip(records, t.calls):
        if (not record.counters.get("api.resolved_lanes")
                and len(named([record], "solvers.iter"))
                != int(max(call.iters))):
            return None
    return records


def total(records, counter: str) -> int:
    return sum(r.counters.get(counter, 0) for r in records)


def named(records, name: str) -> list:
    return [s for r in records for s in r.spans if s.name == name]


def roots(records) -> list:
    return [s for r in records for s in r.spans if s.parent_id is None]


def children(records) -> dict:
    """{(call_id, span_id): the spans whose parent it is}."""
    out = {}
    for r in records:
        for s in r.spans:
            if s.parent_id is not None:
                out.setdefault((s.call_id, s.parent_id), []).append(s)
    return out


def self_ns(span, kids: dict) -> int:
    """The span's time less the time of its children."""
    inner = kids.get((span.call_id, span.span_id), ())
    return (span.end_ns - span.start_ns) - sum(c.end_ns - c.start_ns
                                               for c in inner)


def seconds(span) -> tuple[float, float]:
    """(start_s, end_s) of a span, as the device operations are held."""
    return span.start_ns * 1e-9, span.end_ns * 1e-9


def union(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals
    (``length``, ``_yardstick.union_seconds``, gives its seconds)."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return [(s, e) for s, e in out]


def intersect(a, b) -> list:
    """The intersection of two unions (disjoint sorted intervals)."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a, b) -> list:
    """``a`` less ``b``, both unions (disjoint sorted intervals)."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def self_intervals(spans, kids: dict) -> list:
    """The union of the spans' own time, less their children's."""
    own = union(seconds(s) for s in spans)
    inner = union(seconds(c) for s in spans
                  for c in kids.get((s.call_id, s.span_id), ()))
    return subtract(own, inner)


def idle(run, records) -> list:
    """The times inside the traced calls' root spans in which no
    operation ran on the card."""
    busy = union((s, e) for _, s, e in run.traced.device)
    return subtract(union(seconds(s) for s in roots(records)), busy)


def attribution(run, records) -> dict:
    """Where the host was while the card idled: per span name, the self
    time and the idle inside it, and the idle between calls, in ms per
    traced call."""
    kids = children(records)
    gaps = idle(run, records)
    per = 1e3 / len(records)
    by_span = {}
    for name in sorted({s.name for r in records for s in r.spans}):
        own = self_intervals(named(records, name), kids)
        by_span[name] = {"self_ms": length(own) * per,
                         "idle_ms": length(intersect(gaps, own)) * per}
    calls = union(seconds(s) for s in roots(records))
    between = subtract([(calls[0][0], calls[-1][1])], calls)
    busy = union((s, e) for _, s, e in run.traced.device)
    return {"idle_ms": length(gaps) * per, "by_span": by_span,
            "between_calls_idle_ms": length(subtract(between, busy)) * per}
