"""Share of the driver iterations that replayed a captured CUDA graph: the
program's ``solvers.graph_replays`` counter over its ``solvers.iter``
spans, over the traced calls, in %. A loop's first trip runs eagerly
and every later trip replays its graph where the program takes the graph
route (``solvers/homotopy_batch.graph_route``: on a card, unsharded, no
host reads in the body); 0 where every loop runs eagerly. None where the
program has no graph route, keeps no span store, or ran no iteration."""

from perfbench.metrics import _spans


def read(run):
    records = _spans.traced_records(run)
    if records is None:
        return None
    try:
        from sparse_solvers_tpu_torch.solvers import homotopy_batch
    except ImportError:
        return None
    if not hasattr(homotopy_batch, "graphed_while"):
        return None
    iters = len(_spans.named(records, "solvers.iter"))
    if not iters:
        return None
    return 100 * _spans.total(records, "solvers.graph_replays") / iters
