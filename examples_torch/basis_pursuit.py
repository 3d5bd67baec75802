"""Basis-pursuit example — CG-IRLS in the underdetermined regime, on the
PyTorch/CUDA port.

Compressed sensing proper: recover a k-sparse signal from m ≪ n random
measurements by solving min ‖x‖₁ s.t. Ax = y. The reference library has
no solver for this shape — its IRLS rejects m < n (irls_test.cpp:53) and
its homotopy serves the same objective along a different algorithmic
path. CG-IRLS (solvers/irls_cg.py, arXiv:1509.04063) is factorization-
free: construction does no device work, and each inner conjugate-
gradient step is two products with A, so the solver runs at
sensing-matrix sizes where a QR or Gram matrix could never be
materialized.

The counterpart of ``examples/basis_pursuit.py``: the same problem from
the same seed, the same lines, the port's numbers. What differs: the
solver lives on the card (``device="cuda"``; ``SS_EXAMPLE_CPU=1`` asks for
the CPU), nothing is compiled, and the C++ host engine serves only a CPU
façade at m·n ≤ 2¹⁶. ``main`` returns the numbers it prints.

Run: python examples_torch/basis_pursuit.py [m] [n] [k] [batch]
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
    m, n, k, batch = (argv + [128, 1024, 8, 32][len(argv):])[:4]
    assert m <= n, "basis pursuit is the underdetermined regime (m <= n)"
    device = "cpu" if os.environ.get("SS_EXAMPLE_CPU") else "cuda"

    rng = np.random.RandomState(0)
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)          # unit-norm columns

    # planted k-sparse signed ground truth, measured without noise
    Xtrue = np.zeros((batch, n), np.float32)
    for b in range(batch):
        sup = rng.choice(n, k, replace=False)
        Xtrue[b, sup] = rng.choice([-1.0, 1.0], k) * rng.uniform(0.5, 1.5, k)
    Y = (Xtrue @ A.T).astype(np.float32)

    solver = pt.IrlsCg(A, k_sparsity=2 * k, device=device)
    plan = solver.explain(batch=batch)
    print("plan:", plan)

    t0 = time.perf_counter()
    X, rep = solver.solve_batch(Y, tolerance=1e-4, max_iterations=50)
    iters = rep.iter.cpu().numpy()          # fences the device work
    dt = time.perf_counter() - t0

    X = X.cpu().numpy()
    exact = 0
    for b in range(batch):
        top = set(np.argsort(-np.abs(X[b]))[:k])
        exact += top == set(np.nonzero(Xtrue[b])[0])
    err = float(np.abs(X - Xtrue).max())

    print(f"{batch} signals, {m}x{n} k={k}: support recovered "
          f"{exact}/{batch}, max |x - x_true| = {err:.2e}, "
          f"mean outer iterations {iters.mean():.1f}, "
          f"{dt * 1e3:.1f} ms (no compile)")
    assert exact == batch, "basis pursuit failed to recover a support"
    assert err < 1e-2
    return {"m": m, "n": n, "k": k, "batch": batch, "ms": dt * 1e3,
            "support_recovered": int(exact), "max_abs_err": err,
            "mean_outer_iterations": float(iters.mean()),
            "spd_failures": int(rep.spd_failure.cpu().numpy().sum()),
            "engines": [plan["engine"]],
            "kernels": sorted(plan.get("kernels", {}))}


if __name__ == "__main__":
    main()
