"""Multi-device sparse recovery — row-sharded sensing matrix over a mesh
of processes, on the PyTorch/CUDA port.

Scales the homotopy solver past one card by partitioning the sensing
matrix's rows over the "row" mesh axis and the signal batch over the
"data" axis; each rank computes partial correlations, combined by one
all-reduce over its row group per product (parallel/sharding.py).

The counterpart of ``examples/sharded_recovery.py``, whose re-execution
onto 8 virtual CPU devices becomes one onto processes: torch.distributed
is SPMD, one process per card. Under ``torchrun`` every rank joins
through ``distributed.initialize()``; run plainly, the script re-executes
itself under ``python -m torch.distributed.run --standalone``, one
process per card. ``SS_SHARDED_DEMO_CPU=1`` asks for the CPU instead: 8
gloo processes and ``device="cpu"``; without it the mesh is on the card,
and a machine without one is the mesh's error. Every rank runs the same
six steps on the whole problem and gets the whole answer; only rank 0
prints, the same lines as the JAX example with the port's numbers.
What differs: the first solve pins ``batch_native=False``, the per-lane
core that JAX's first solve runs off the TPU, so the driver is compared
with it wherever this runs; the ring is a send/receive step around the
row group; and the mesh façade is built at ``precision="high"``, the
functional route's, since the port's default ``"certified"`` runs its
path on bf16 products on every device (about 2e-3 from the "high" path
here; JAX's CPU runs it in f32), so the comparison checks the façade's
placement and cached Gram and not the precision. ``main`` returns the
numbers it prints.

Run: torchrun --nproc-per-node=N examples_torch/sharded_recovery.py
     python examples_torch/sharded_recovery.py   (one process per card)
     SS_SHARDED_DEMO_CPU=1 python examples_torch/sharded_recovery.py
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import sparse_solvers_tpu_torch as pt  # noqa: E402
from sparse_solvers_tpu_torch.parallel import distributed  # noqa: E402
from sparse_solvers_tpu_torch.parallel import sharding as sh  # noqa: E402

# ranks of the CPU demonstration, as the JAX example's virtual devices
DEMO_CPU_RANKS = 8
# seconds a rank may wait on its peers in one collective before it fails
GROUP_TIMEOUT_S = 120


def main(argv=None):
    demo_cpu = bool(os.environ.get("SS_SHARDED_DEMO_CPU"))
    if not distributed.initialize(backend="gloo" if demo_cpu else None,
                                  timeout=GROUP_TIMEOUT_S):
        # no launcher: re-execute under one, one process per card
        nproc = (DEMO_CPU_RANKS if demo_cpu
                 else max(1, torch.cuda.device_count()))
        os.execv(sys.executable, [
            sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc-per-node={nproc}", os.path.abspath(__file__)])
    rank0 = distributed.process_index() == 0

    def say(*args):
        if rank0:
            print(*args, flush=True)

    m, n, k, batch = 1024, 2048, 16, 64
    rng = np.random.RandomState(0)
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    X_true = np.zeros((batch, n), np.float32)
    for b in range(batch):
        sup = rng.choice(n, k, replace=False)
        X_true[b, sup] = rng.uniform(0.5, 1.0, k)
    Y = X_true @ A.T

    world = distributed.process_count()
    n_row, n_data = (4, world // 4) if world % 4 == 0 else (world, 1)
    mesh = distributed.global_mesh(n_row=n_row, n_data=n_data,
                                   device="cpu" if demo_cpu else None)
    say(f"mesh: {n_row} row-shards x {n_data} data-shards "
        f"({mesh.device.type}, {mesh.backend})")

    def supports_hit(X):
        return int(sum(
            set(np.flatnonzero(X[b] > 0.1)) == set(np.flatnonzero(X_true[b]))
            for b in range(batch)))

    X, reports = sh.homotopy_sharded(mesh, A, Y, tolerance=1e-2,
                                     max_iterations=4 * k,
                                     batch_native=False)
    X = X.cpu().numpy()
    iters = reports.iter.cpu().numpy()
    hit = supports_hit(X)
    say(f"{batch} solves of {m}x{n} (k={k}) across {world} ranks; "
        f"mean path length {iters.mean():.1f}; "
        f"support recovery {100*hit/batch:.0f}%")

    # the same solve through the slot-space driver (K2 and K3 on each
    # rank, the q products all-reduced over the row group), gram-free as
    # the very-large-n regime would run it
    Xb, repb = sh.homotopy_sharded(mesh, A, Y, tolerance=1e-2,
                                   max_iterations=4 * k,
                                   batch_native=True, gram=False)
    Xb = Xb.cpu().numpy()
    iters_b = repb.iter.cpu().numpy()
    matches = {"driver": bool(np.allclose(Xb, X, atol=1e-5))}
    say(f"batch-native sharded driver (gram-free): mean path length "
        f"{iters_b.mean():.1f}; matches per-lane core: "
        f"{matches['driver']}")

    # the ring-pipelined reduction (a collective matmul: S − 1
    # send/receive steps around the row group, then one all-gather;
    # "auto" takes it on sharded row axes at n >= 128·S, forced here)
    if mesh.shape[sh.ROW_AXIS] > 1:
        Xp, _ = sh.homotopy_sharded(mesh, A, Y, tolerance=1e-2,
                                    max_iterations=4 * k,
                                    batch_native=True, gram=False,
                                    overlap_mode="ppermute")
        matches["ring"] = bool(np.allclose(Xp.cpu().numpy(), Xb,
                                           atol=1e-5))
        say(f"ppermute collective-matmul ring: matches psum driver: "
            f"{matches['ring']}")

    # the construct-once façade on the mesh — each rank's rows of A
    # placed once, the replicated Gram all-reduced once and cached, batch
    # padding handled; at the functional route's precision
    solver = pt.Homotopy(A, precision="high", mesh=mesh)
    Xf, _ = solver.solve_batch(Y, tolerance=1e-2, max_iterations=4 * k)
    plan = solver.explain(batch=batch)
    matches["facade"] = bool(np.allclose(Xf.cpu().numpy(), X, atol=1e-4))
    say(f"mesh facade Homotopy(A, mesh=...): matches functional path: "
        f"{matches['facade']}; plan: {plan['formulation']}")

    # IRLS on the mesh with its construction QR computed BY the mesh
    # (CholeskyQR2 — no host factorization; IRLS needs m >= n, so a tall
    # sub-dictionary)
    At = A[:, : m // 2]
    Yt = (X_true[:, : m // 2] @ At.T).astype(np.float32)
    irls = pt.Irls(At, mesh=mesh)
    _, repi = irls.solve_batch(Yt, tolerance=1e-3, max_iterations=30)
    iters_i = repi.iter.cpu().numpy()
    say(f"mesh facade Irls (CholeskyQR2 construction, "
        f"{m}x{m // 2}): mean iters {iters_i.mean():.1f}")

    # the underdetermined regime shards the other way: columns of a wide
    # A over the row axis, CG-IRLS replicating only m-sized iterates
    # (one all-reduce per CG step)
    mw, nw, kw = 96, 1024, 6
    Aw = rng.randn(mw, nw).astype(np.float32)
    Aw /= np.linalg.norm(Aw, axis=0)
    Xw = np.zeros((batch, nw), np.float32)
    for b in range(batch):
        sup = rng.choice(nw, kw, replace=False)
        Xw[b, sup] = rng.choice([-1.0, 1.0], kw) * rng.uniform(0.5, 1.5, kw)
    Yw = Xw @ Aw.T
    Xc, repc = sh.irls_cg_sharded(mesh, Aw, Yw, tolerance=1e-4,
                                  max_iterations=40)
    Xc = Xc.cpu().numpy()
    iters_c = repc.iter.cpu().numpy()
    hit_c = int(sum(
        set(np.argsort(-np.abs(Xc[b]))[:kw]) == set(np.flatnonzero(Xw[b]))
        for b in range(batch)))
    say(f"column-sharded CG-IRLS {mw}x{nw} (k={kw}): mean outer "
        f"iterations {iters_c.mean():.1f}; "
        f"support recovery {100*hit_c/batch:.0f}%")
    return {"mesh": {"row": n_row, "data": n_data}, "world": world,
            "device": str(mesh.device), "backend": mesh.backend,
            "batch": batch, "mean_path_length": float(iters.mean()),
            "support_recovered": hit,
            "driver_mean_path_length": float(iters_b.mean()),
            "facade_formulation": plan["formulation"],
            "irls_mean_iterations": float(iters_i.mean()),
            "cg_mean_outer_iterations": float(iters_c.mean()),
            "cg_support_recovered": hit_c, "matches": matches}


if __name__ == "__main__":
    main()
