"""Greedy pursuit example — OMP against homotopy on the same ensemble, on
the PyTorch/CUDA port.

Orthogonal Matching Pursuit (solvers/omp.py, beyond the reference's
homotopy/IRLS pair) recovers a k-sparse signal in exactly k column
picks when the dictionary is incoherent enough — each pick adds the
column most correlated with the residual and re-solves least squares
on the grown support through the online Gram inverse. This example
solves the same batch with ``pt.Omp`` and ``pt.Homotopy`` and compares
picks/iterations, residuals, and wall time.

The counterpart of ``examples/greedy_pursuit.py``: the same problem from
the same seed, the same lines, the port's numbers, and each route's
``explain()["engine"]``. What differs is the engine routing: a card
façade's ``"auto"`` keeps the work on the card (``"torch"``), while a
CPU façade (``SS_EXAMPLE_CPU=1``) sends problems of m·n ≤ 2¹⁶ to the C++
host engine (``"native"``), as the JAX package's ``"auto"`` does. The
gOMP line keeps ``engine="jax"``, the port's name for its torch route.
Nothing is compiled. ``main`` returns the numbers it prints.

Run: python examples_torch/greedy_pursuit.py [m] [n] [k] [batch]
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
    m, n, k, batch = (argv + [256, 1024, 12, 32][len(argv):])[:4]
    device = "cpu" if os.environ.get("SS_EXAMPLE_CPU") else "cuda"

    rng = np.random.RandomState(0)
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)          # unit-norm columns

    Xtrue = np.zeros((batch, n), np.float32)
    for b in range(batch):
        sup = rng.choice(n, k, replace=False)
        Xtrue[b, sup] = rng.uniform(0.5, 1.5, k)
    Y = (Xtrue @ A.T).astype(np.float32)

    def recovered(X):
        return int(sum(
            set(np.argsort(-np.abs(X[b]))[:k]) ==
            set(np.nonzero(Xtrue[b])[0]) for b in range(batch)))

    results, kernels = {}, set()
    # tol 1e-2: the OMP batch driver's in-loop stop squares the
    # residual, so an f32 tolerance must sit above the rss rounding
    # floor ~sqrt(eps)·‖y‖ (solvers/omp.py) for the exactly-k-picks
    # contract below — tighter tolerances may add one stall pick
    for name, solver in [("omp", pt.Omp(A, device=device)),
                         ("homotopy", pt.Homotopy(A, device=device))]:
        plan = solver.explain(batch=batch)
        kernels.update(plan.get("kernels", {}))
        print(f"{name} plan:", plan)
        print(f"  {name} engine: {plan['engine']}")
        t0 = time.perf_counter()
        X, rep = solver.solve_batch(Y, tolerance=1e-2, max_iterations=100)
        iters = rep.iter.cpu().numpy()      # fences the device work
        dt = time.perf_counter() - t0
        exact = recovered(X.cpu().numpy())
        results[name] = {"support_recovered": exact,
                         "mean_iterations": float(iters.mean()),
                         "ms": dt * 1e3, "engine": plan["engine"]}
        print(f"  {name}: support {exact}/{batch}, "
              f"mean iters {iters.mean():.1f}, {dt * 1e3:.1f} ms "
              f"(no compile)")

    # OMP's contract on a clean incoherent ensemble: k picks per lane
    assert results["omp"]["support_recovered"] == batch, \
        "OMP failed to recover a support"
    assert results["omp"]["mean_iterations"] == k, (
        results["omp"]["mean_iterations"], k)
    assert results["homotopy"]["support_recovered"] == batch

    # generalized OMP: 4 picks per round -> ~k/4 correlation passes, same
    # recovered support (the extra coefficients near the tolerance are ~0)
    gomp = pt.Omp(A, engine="jax", picks=4, device=device)
    plan = gomp.explain(batch=batch, max_iterations=2 * k)
    kernels.update(plan.get("kernels", {}))
    t0 = time.perf_counter()
    X4, rep4 = gomp.solve_batch(Y, tolerance=1e-2, max_iterations=2 * k)
    iters4 = rep4.iter.cpu().numpy()        # fences the device work
    dt = time.perf_counter() - t0
    exact4 = recovered(X4.cpu().numpy())
    rounds = float(np.ceil(iters4 / 4).mean())
    print(f"  gomp(picks=4) engine: {plan['engine']}")
    print(f"  gomp(picks=4): support {exact4}/{batch}, "
          f"mean rounds {rounds:.1f} (vs {k} single-pick passes)")
    assert exact4 == batch
    results["gomp"] = {"support_recovered": exact4, "mean_rounds": rounds,
                       "ms": dt * 1e3, "engine": plan["engine"]}
    return {"m": m, "n": n, "k": k, "batch": batch, **results,
            "engines": [r["engine"] for r in results.values()],
            "kernels": sorted(kernels)}


if __name__ == "__main__":
    main()
