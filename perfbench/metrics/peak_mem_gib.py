"""``torch.cuda.max_memory_allocated()`` over the program's set-up, the
window and the traced calls, read before the comparison runs, less the
benchmark's own pool of signals. A, which the user holds on the card for
the facade, counts; the draws' scratch, freed before the peak is reset,
does not, and the window's reports and sampled answers go to the host."""


def read(run):
    return (run.memory_peak_bytes - run.harness_bytes) / 2**30
