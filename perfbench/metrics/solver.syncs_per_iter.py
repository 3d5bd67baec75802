"""Host-device synchronisations per driver iteration over the traced
calls: the program's ``solvers.sync`` spans (the liveness reads, one a
trip and one opening each capacity tier, the facade's reads and the
uploads that wait for the card) over its ``solvers.iter`` spans (the
re-solve's iterations included)."""

from perfbench.metrics import _spans


def read(run):
    records = _spans.traced_records(run)
    if records is None:
        return None
    iters = len(_spans.named(records, "solvers.iter"))
    if not iters:
        return None
    return len(_spans.named(records, "solvers.sync")) / iters
