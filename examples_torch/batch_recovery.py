"""Batched sparse-recovery example — the face-recognition-style workload,
on the PyTorch/CUDA port.

One sensing matrix (the "dictionary": columns are known patterns /
training faces), many observed signals to classify by sparse coding —
the motivating workload of the reference library (needle-in-haystack
pattern search) scaled to batch throughput on one card.

The counterpart of ``examples/batch_recovery.py``: the same problem from
the same seed, the same lines, the port's numbers. What differs: the
solver lives on the card (``device="cuda"``; ``SS_EXAMPLE_CPU=1`` asks for
the CPU), nothing is compiled, so the first batch's time includes the
Gram and, on the card, loading the kernels; and the single solve takes
the C++ host engine only on a CPU façade at m·n ≤ 2¹⁶ (a card façade
keeps it on the card). ``main`` returns the numbers it prints.

Run: python examples_torch/batch_recovery.py [m] [n] [k] [batch]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import sparse_solvers_tpu_torch as pt  # noqa: E402


def main(argv=None):
    argv = [int(a) for a in (sys.argv[1:] if argv is None else argv)]
    m, n, k, batch = (argv + [512, 1024, 8, 64][len(argv):])[:4]
    device = "cpu" if os.environ.get("SS_EXAMPLE_CPU") else "cuda"

    rng = np.random.RandomState(0)
    # dictionary with unit-L2 columns (standard compressive-sensing form)
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)

    # each signal is a sparse nonnegative combination of k dictionary atoms
    X_true = np.zeros((batch, n), np.float32)
    for b in range(batch):
        sup = rng.choice(n, k, replace=False)
        X_true[b, sup] = rng.uniform(0.5, 1.0, k)
    Y = X_true @ A.T

    # construct once; the Gram is computed at first use and cached
    solver = pt.Homotopy(A, device=device)
    plans = [solver.explain(batch=batch, max_iterations=4 * k),
             solver.explain(max_iterations=4 * k)]
    t0 = time.time()
    X, reports = solver.solve_batch(Y, tolerance=1e-2, max_iterations=4 * k)
    X = X.cpu().numpy()                 # fences the device work
    dt = time.time() - t0

    iters = reports.iter.cpu().numpy()
    hits = sum(
        set(np.flatnonzero(X[b] > 0.1)) == set(np.flatnonzero(X_true[b]))
        for b in range(batch))
    print(f"{batch} solves of {m}x{n} (k={k}) in {dt*1e3:.1f} ms "
          f"({batch/dt:.1f} solves/s, first call includes the Gram)")
    print(f"mean path length {iters.mean():.1f}; "
          f"exact support recovery on {100*hits/batch:.0f}% of signals")

    # single-signal latency path (a CPU façade routes small problems to
    # the native C++ backend; a card façade keeps it on the card)
    x1, rep = solver.solve(Y[0], tolerance=1e-2, max_iterations=4 * k)
    print(f"single solve: iter={rep.iter} "
          f"solution_error={rep.solution_error:.2e}")
    return {"m": m, "n": n, "k": k, "batch": batch, "ms": dt * 1e3,
            "solves_per_s": batch / dt,
            "mean_iterations": float(iters.mean()),
            "support_recovered": int(hits),
            "single_iter": rep.iter,
            "single_solution_error": rep.solution_error,
            "engines": [p["engine"] for p in plans],
            "kernels": sorted({kn for p in plans
                               for kn in p.get("kernels", {})})}


if __name__ == "__main__":
    main()
