"""Share of the wall time in which the card runs nothing: 1 - (seconds an
operation ran on the card per loop iteration, the union of every kernel and
copy over the traced calls) / (wall seconds per loop iteration of the
untraced window). Per iteration, so that traced and untraced calls of
different sparsity compare; the profiler's own slowdown of the host stays
out."""

from perfbench.metrics._yardstick import iterations_run, union_seconds


def read(run):
    t = run.traced
    if t is None or not t.device:
        return None
    busy = union_seconds((s, e) for _, s, e in t.device)
    busy_per_iter = busy / iterations_run(t.calls)
    wall_per_iter = run.window_s / iterations_run(run.window)
    return 100 * (1 - busy_per_iter / wall_per_iter)
