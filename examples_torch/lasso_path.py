"""LASSO regularization-path example — Homotopy.solve_path, on the
PyTorch/CUDA port.

The homotopy solver follows min ½‖y−Ax‖² + λ‖x‖₁ as λ decreases from
‖Aᵀy‖∞; `solve_path` returns every breakpoint it visits (beyond the
reference, which returns only the endpoint). The path is the classic
model-selection object: supports enter (and occasionally leave) one
index at a time, and each iterate satisfies its own KKT identity
‖Aᵀ(y−Ax_t)‖∞ = λ_t, which this demo verifies.

The counterpart of ``examples/lasso_path.py``: the same problem from the
same seed, the same lines, the port's numbers. What differs: the solver
lives on the card (``device="cuda"``; ``SS_EXAMPLE_CPU=1`` asks for the
CPU), and the path runs the per-lane core at "high" there, whatever the
engine. ``main`` returns the numbers it prints.

Run: python examples_torch/lasso_path.py [m n k]   (SS_EXAMPLE_CPU=1 for CPU)
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import sparse_solvers_tpu_torch as pt  # noqa: E402


def main(argv=None):
    args = [int(a) for a in (sys.argv[1:] if argv is None else argv)[:3]]
    defaults = [128, 256, 6]
    m, n, k = args + defaults[len(args):]
    device = "cpu" if os.environ.get("SS_EXAMPLE_CPU") else "cuda"
    rng = np.random.RandomState(0)
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    x_true = np.zeros(n, np.float32)
    sup = np.sort(rng.choice(n, k, replace=False))
    x_true[sup] = rng.uniform(0.4, 1.0, k)
    y = A @ x_true

    solver = pt.Homotopy(A, device=device)  # solve_path: the per-lane core
    plan = solver.explain(max_iterations=4 * k)
    lambdas, Xs, rep = solver.solve_path(y, tolerance=1e-3,
                                         max_iterations=4 * k)

    print(f"{len(lambdas)} breakpoints, λ from {lambdas[0]:.4f} "
          f"to {lambdas[-1]:.6f}")
    kkt_err = max(
        abs(float(np.max(np.abs(A.T @ (y - A @ Xs[t])))) - lambdas[t])
        for t in range(len(lambdas)))
    print(f"max |KKT − λ| over the path: {kkt_err:.2e}")
    supports = []
    for t in range(len(lambdas)):
        live = [int(i) for i in np.flatnonzero(np.abs(Xs[t]) > 0)]
        supports.append(live)
        print(f"  λ={lambdas[t]:.5f}  support={live}")
    ok = set(np.flatnonzero(np.abs(Xs[-1]) > 1e-3)) == set(sup)
    print(f"true support: {[int(i) for i in sup]}  (recovered: {ok})")
    return {"m": m, "n": n, "k": k, "breakpoints": len(lambdas),
            "lambdas": [float(v) for v in lambdas],
            "kkt_err": float(kkt_err), "supports": supports,
            "true_support": [int(i) for i in sup], "recovered": bool(ok),
            "iterations": rep.iter, "engines": ["torch"],
            "kernels": sorted(plan.get("kernels", {}))}


if __name__ == "__main__":
    main()
