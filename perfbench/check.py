"""The comparison that decides ``correct``.

Every lane of the calls sampled from the window (``check_calls`` of the
mix, drawn from the seed) is judged once the program's state is freed,
against A and the signals drawn again from the seed and the plain
reference run on them. The configuration names its reference module
(``reference/<name>.py``), which owns the family's algorithm and its
certificate: ``solve(A, Y, tol, max_iterations, precision)`` returns (X,
iterations, the certificate its loop reached) and ``certificate(A, Y,
X)`` the certificate of any X, in float64 (Homotopy's is ||A^T (y -
A x)||_inf, a greedy family's ||y - A x||_2). The numbers, each a worst
case over those lanes:

- ``cert``: the certificate of the program's x over the tolerance, on
  every lane the program counts as solved: the configuration's
  guarantee, so its limit is 1;
- ``report_gap``: |reported certificate - recomputed certificate| over the
  tolerance, on every lane: the certificate the user is given;
- ``unsolved``: the share (%) of the lanes the float64 reference solves to
  the tolerance that the program reports unsolved. A sound program leaves
  a rare lane unsolved and says so (its bf16 path can use up
  max_iterations, which no re-solve restores); a step that does nothing
  or a batch half left out leaves most of them;
- ``x_err``: ||x - x_ref||_inf / ||x_ref||_inf. Recorded, and compared
  only where a cell's limits name it: the program's path runs its products
  in bf16, so its x sits as far from the float64 x_ref as the bf16 control
  does, and only the certificate separates them.

``checks/<workload>.json`` names the numbers a cell compares. A non-finite
number fails its limit.
"""

from __future__ import annotations

import torch

from perfbench import generator

# lanes the reference takes at once
BLOCK = 512


def numbers(A: torch.Tensor, Y: torch.Tensor, X: torch.Tensor,
            errs: torch.Tensor, tol: float, max_iterations: int,
            reference) -> dict:
    """The comparison's numbers for solutions X (b, n) and reported
    certificates ``errs`` (b,) of signals Y (b, m) against A (m, n)."""
    worst = {"x_err": 0.0, "cert": 0.0, "report_gap": 0.0}
    solvable = unsolved = 0
    A64 = A.to(torch.float64)
    for r0 in range(0, Y.shape[0], BLOCK):
        Yb = Y[r0:r0 + BLOCK]
        Xb = X[r0:r0 + BLOCK].to(torch.float64)
        eb = errs[r0:r0 + BLOCK].to(torch.float64)
        Xr, _, c_ref = reference.solve(A, Yb, tol, max_iterations,
                                       "float64")
        scale = Xr.abs().amax(dim=1).clamp_min(torch.finfo(torch.float64).tiny)
        x_err = (Xb - Xr).abs().amax(dim=1) / scale
        cert = reference.certificate(A64, Yb.to(torch.float64), Xb)
        gap = (eb - cert).abs() / tol
        solved = eb <= tol                   # NaN is never within tol
        solvable += int((c_ref <= tol).sum())
        unsolved += int(((c_ref <= tol) & ~solved).sum())
        for name, v in (("x_err", x_err), ("cert", (cert / tol)[solved]),
                        ("report_gap", gap)):
            if v.numel():
                v = torch.where(torch.isnan(v), float("inf"), v)
                worst[name] = max(worst[name], float(v.max()))
        del Xr, c_ref
    worst["unsolved"] = 100 * unsolved / solvable if solvable else 0.0
    return worst


def compare_run(config: dict, traffic: dict, seed: int, device, kept,
                reference) -> dict:
    """The numbers over the kept calls: (pool index, X, iterations,
    certificates) each."""
    A = generator.sensing_matrix(config, seed, device)
    pool, _ = generator.signal_pool(A, traffic, seed)
    Y = torch.cat([pool[p] for p, *_ in kept])
    X = torch.cat([x.to(device) for _, x, _, _ in kept])
    errs = torch.tensor([e for *_, err in kept for e in err],
                        dtype=torch.float64, device=device)
    del pool
    return numbers(A, Y, X, errs, config["tolerance"],
                   config["max_iterations"], reference)


def judge(found: dict, limits: dict):
    """(correct, lines): every number the limits name at or under its
    limit; one line a number, its value beside its limit."""
    ok, lines = True, []
    for name, entry in limits.items():
        value, limit = found[name], entry["limit"]
        passed = value <= limit
        ok &= passed
        lines.append(f"check {name} {value!r} limit {limit!r} "
                     f"{'ok' if passed else 'FAILED'}")
    return ok, lines
