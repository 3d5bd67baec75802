"""Lanes returned with a certificate within the tolerance, over the wall
time from the window's first call's start to its last call's end."""


def read(run):
    tol = run.config["tolerance"]
    solved = sum(1 for c in run.window for e in c.errs if e <= tol)
    return solved / run.window_s
