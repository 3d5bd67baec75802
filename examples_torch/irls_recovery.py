"""IRLS pattern-search example — construct-once / solve-many, on the
PyTorch/CUDA port.

The IRLS solver (reference: src/solvers/irls-cpu.cpp) amortizes one
economy QR factorization of the sensing matrix across every solve — the
right tool when the same overdetermined dictionary (m ≥ n) serves a
stream of signals and per-solve latency matters more than an exact ℓ₁
path.

The workload mirrors the reference's own IRLS fixtures (needle-in-
haystack pattern identification, src/solvers/test_util.h:136-197): each
observed signal is one dictionary atom plus noise, and the solver must
name the atom. This is the regime IRLS-p0.9 with the reference's eps
schedule is built for — very sparse representations. For general
k-sparse recovery use Homotopy (see examples_torch/batch_recovery.py):
with k ≳ 4 supports on gaussian ensembles the reweighting schedule drives
the weighted Gram singular and the solver degrades gracefully with
`report.spd_failure`.

The counterpart of ``examples/irls_recovery.py``: the same problem from
the same seed, the same lines, the port's numbers. What differs: the
solver lives on the card (``device="cuda"``; ``SS_EXAMPLE_CPU=1`` asks for
the CPU); the QR is ``torch.linalg.qr``'s, whose column signs may differ
from XLA's (the iteration is invariant to them up to rounding); nothing
is compiled, so the first batch's time includes the QR only; and the C++
host engine serves only a CPU façade at m·n ≤ 2¹⁶. ``main`` returns the
numbers it prints.

Run: python examples_torch/irls_recovery.py [m] [n] [batch]
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
    m, n, batch = (argv + [512, 256, 64][len(argv):])[:3]
    assert m >= n, "IRLS requires an overdetermined system (m >= n)"
    device = "cpu" if os.environ.get("SS_EXAMPLE_CPU") else "cuda"

    rng = np.random.RandomState(0)
    # gaussian dictionary, L1-normalized columns (the reference's
    # noisy-patterns preconditioning, test_util.h:150)
    A = pt.norm_l1(rng.randn(m, n).astype(np.float32), device=device)

    # each signal = one atom + gaussian noise at 25% of the atom scale
    # (L1-normalized columns have ~1/m-sized entries)
    atoms = rng.randint(0, n, size=batch)
    noise = 0.25 * float(np.std(A))
    Y = A.T[atoms] + noise * rng.randn(batch, m).astype(np.float32)

    t0 = time.time()
    solver = pt.Irls(A, device=device)  # QR computed once, cached on device
    plans = [solver.explain(batch=batch, max_iterations=20)]
    X, reports = solver.solve_batch(Y, tolerance=0.1, max_iterations=20)
    X = X.cpu().numpy()                 # fences the device work
    dt = time.time() - t0

    iters = reports.iter.cpu().numpy()
    hits = int(np.sum(np.argmax(X, axis=1) == atoms))
    spd = int(reports.spd_failure.cpu().numpy().sum())
    print(f"{batch} IRLS solves of {m}x{n} in {dt*1e3:.1f} ms "
          f"(includes the QR)")
    print(f"mean iterations {iters.mean():.1f}; "
          f"atom identified on {100*hits/batch:.0f}% of signals; "
          f"spd failures {spd}/{batch}")

    # the cached QR makes subsequent batches cheap
    t0 = time.time()
    X2, _ = solver.solve_batch(Y, tolerance=0.1, max_iterations=20)
    X2.cpu()                            # fences the device work
    dt2 = time.time() - t0
    print(f"amortized second batch: {1e3*dt2:.1f} ms")

    x1, rep = solver.solve(Y[0], tolerance=0.1, max_iterations=20)
    plans.append(solver.explain(max_iterations=20))
    print(f"single solve: iter={rep.iter} "
          f"solution_error={rep.solution_error:.2e} "
          f"spd_failure={rep.spd_failure}")
    return {"m": m, "n": n, "batch": batch, "ms": dt * 1e3,
            "second_batch_ms": dt2 * 1e3,
            "mean_iterations": float(iters.mean()),
            "atoms_identified": hits, "spd_failures": spd,
            "single_iter": rep.iter,
            "single_solution_error": rep.solution_error,
            "single_spd_failure": rep.spd_failure,
            "engines": [p["engine"] for p in plans],
            "kernels": sorted({kn for p in plans
                               for kn in p.get("kernels", {})})}


if __name__ == "__main__":
    main()
