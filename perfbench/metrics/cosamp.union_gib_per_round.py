"""GiB of the CoSaMP union gathered a round: the program's
``cosamp.union_bytes`` counter (each trip adds the bytes of the (b, S, m)
union of columns it gathers) over its ``solvers.iter`` spans, over the
traced calls. A route that reads the union's Gram from a held Gram would
count b S^2 values a trip. None where the program keeps no span store,
counts no union, or its records do not line up with the traced calls
(each record's ``api.lanes`` the lanes of its call)."""

from perfbench.metrics import _spans


def read(run):
    t = run.traced
    if t is None or not t.calls:
        return None
    try:
        from sparse_solvers_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "calls"):
        return None
    records = profiling.calls()[-len(t.calls):]
    if len(records) < len(t.calls) or any(
            r.counters.get("api.lanes") != len(c.iters)
            for r, c in zip(records, t.calls)):
        return None
    nbytes = _spans.total(records, "cosamp.union_bytes")
    trips = len(_spans.named(records, "solvers.iter"))
    if not nbytes or not trips:
        return None
    return nbytes / trips / 2 ** 30
