"""Seconds from the start of the process to the window's first call:
imports, the card's start, the draws, the facade, and its warm-up with the
mix's heaviest calls (and, in a checkout's first run, the nvcc build)."""


def read(run):
    return run.setup_s
