"""Device kernels the profiler recorded over the traced calls, per loop
iteration run: a call runs as many iterations as its lane with the most,
since every lane runs the loop body while any lane is live."""

from perfbench.metrics._yardstick import iterations_run, is_copy


def read(run):
    t = run.traced
    if t is None or not t.device:
        return None
    kernels = sum(1 for name, _, _ in t.device if not is_copy(name))
    return kernels / iterations_run(t.calls)
