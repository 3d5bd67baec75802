"""Serving-loop example — certified, pipelined, on the PyTorch/CUDA port.

How a production recovery service drives the solver at full device
throughput: construct once, then feed batches already on the card
through `solve_batch_on_device` (tensors in and out, no host transfer per
call) with `precision="certified"` — the path runs at one-pass bf16
speed and every lane carries a high-precision convergence certificate;
the loop inspects the certificates *after* fencing and re-solves any
failing batch at parity precision.

`explain()` shows the execution plan (engine, formulation, capacity
tiers, hand kernels) before anything runs.

The counterpart of ``examples/serving_loop.py``: the same problem and
batches from the same seeds, the same lines, the port's numbers. What
differs: PyTorch runs eagerly, so nothing is compiled — the warm-up call
computes the Gram and, on the card, loads the kernels; the eight calls
are queued and fenced once by ``torch.cuda.synchronize()``, though each
driver step still reads lane liveness on the host; and
``update_column(7)`` replaces the column and rewrites the cached Gram's
row and column 7 from one Aᵀ·col product, with no rebuild, so the next
batch runs at once. The solver runs on the card (``device="cuda"``;
``SS_EXAMPLE_CPU=1`` asks for the CPU). ``main`` returns the numbers it
prints.

Run: python examples_torch/serving_loop.py   (SS_EXAMPLE_CPU=1 for CPU)
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import sparse_solvers_tpu_torch as pt  # noqa: E402


def main(argv=None):
    m, n, k, batch, n_batches = 512, 1024, 16, 64, 8
    tol, max_iter = 1e-2, 64
    device = "cpu" if os.environ.get("SS_EXAMPLE_CPU") else "cuda"

    def fence():
        if device == "cuda":
            torch.cuda.synchronize()

    rng = np.random.RandomState(0)
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)

    solver = pt.Homotopy(A, precision="certified", device=device)
    plan = solver.explain(batch=batch, max_iterations=max_iter)
    print("plan:", plan)

    def make_batch(seed):
        r = np.random.RandomState(seed)
        X = np.zeros((batch, n), np.float32)
        for b in range(batch):
            X[b, r.choice(n, k, replace=False)] = r.uniform(0.5, 1.0, k)
        return torch.from_numpy((X @ A.T).astype(np.float32)).to(device)

    batches = [make_batch(s) for s in range(n_batches)]

    # warm-up (the Gram, and on the card the kernels' load)
    X, rep = solver.solve_batch_on_device(batches[0], tol, max_iter)
    fence()

    # pipelined serving: dispatch everything, fence once
    t0 = time.time()
    out = [solver.solve_batch_on_device(Y, tol, max_iter) for Y in batches]
    fence()
    dt = time.time() - t0

    # certificate audit (off the timed path; a failing batch would be
    # re-solved at precision="high" — or route it through solve_batch,
    # which does this automatically)
    failed = sum(int(np.sum(~(rep.solution_error.cpu().numpy() <= tol)))
                 for _, rep in out)
    total = batch * n_batches
    print(f"{total} certified solves in {dt*1e3:.1f} ms "
          f"({total/dt:.0f} solves/s pipelined); "
          f"{failed}/{total} lanes failed certification")

    # gallery churn: swap one dictionary column in place — the cached
    # Gram's row and column 7 are rewritten from one Aᵀ·col product, no
    # rebuild, so the serving loop keeps running without a re-warm-up
    new_col = np.random.RandomState(99).randn(m).astype(np.float32)
    new_col /= np.linalg.norm(new_col)
    solver.update_column(7, new_col)
    # probe with the same batch shape the loop serves
    probe = torch.from_numpy(np.tile(new_col, (batch, 1))).to(device)
    Xc, repc = solver.solve_batch_on_device(probe, tol, max_iter)
    hit = int(Xc[0].argmax())
    print(f"after update_column(7): probe for the new gallery entry "
          f"recovers column {hit} (expected 7), cached Gram updated in "
          f"place")
    return {"ms": dt * 1e3, "solves_per_s": total / dt,
            "failed": failed, "total": total, "probe_column": hit,
            "engines": [plan["engine"]],
            "kernels": sorted(plan.get("kernels", {}))}


if __name__ == "__main__":
    main()
