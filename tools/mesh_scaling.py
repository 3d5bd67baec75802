"""The mesh routes on several cards: parity with one card, ranks in
agreement, and the time of a batch on each mesh shape.

    torchrun --standalone --nproc-per-node=4 tools/mesh_scaling.py
    torchrun --standalone --nproc-per-node=4 tools/mesh_scaling.py --cpu

Every process joins the group through ``parallel.distributed.initialize()``
(torchrun's environment) and lays, in turn, each (row, data) mesh of the
world's ranks: all rows (row N), rows and lanes (row 2 × data N/2 where N
is even and above 2) and all lanes (data N). On each it runs, through the
façades' ``mesh=``, the paths of ``chip_smoke.py``'s mesh phase:
certified ``Homotopy`` (4096x8192, k=64, batch 256, k_max 96, 128
iterations, tol 1e-2) and ``Omp`` (72 iterations) on its problems, both
gram-free at 2048x65536 (k=16, 40 and 24 iterations) and ``IrlsCg`` at
1024x65536 (k=24, batch 32, K=48, 96 CG steps, 25 outer iterations, tol
1e-3, columns split over the row axis). Each rank also solves the same
batch without a mesh on its own card (one warm-up call first, as on the
meshes).

For each mesh and path rank 0 prints one JSON line: the median of 5
batches (every rank fenced by a sync and a barrier before each, the wall
of the slowest rank's batch as rank 0 sees it after the closing barrier)
beside the one-card route's median, its quartiles, the iterations (equal
to the one-card route's on how many lanes), the largest |ΔX| against the
one-card route, whether every rank returned the same X bit for bit, the
lanes certified within the tolerance with the true support (CG-IRLS: the
planted support, no breakdown), the collectives of one solve on rank 0
(``ops/collectives.counts``) and K1 to K4's launches there. The last line
is the card's name and power limit. ``--cpu`` runs the same on CPU ranks
(gloo) at sizes cut 16 times in m and n and 4 times in the batch, to
rehearse the script; its times are no device times.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# the seeded problems (tests/_torch_cases.py: numpy only)
sys.path.insert(0, str(ROOT / "tests"))

RUNS = 5


def fenced(run, runs: int = RUNS):
    """Wall ms of ``runs`` calls of ``run()`` on every rank, each started
    after a sync and a barrier and ended after a sync and a barrier, and
    the last call's output."""
    times, out = [], None
    for _ in range(runs):
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        out = run()
        sync()
        dist.barrier()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, out


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def same_on_every_rank(X: torch.Tensor) -> bool:
    """Whether every rank holds X bit for bit (a SHA-256 of its bytes,
    all-gathered over the default group)."""
    digest = hashlib.sha256(
        X.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, digest)
    return len(set(got)) == 1


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true",
                        help="CPU ranks (gloo) at cut sizes: a rehearsal")
    args = parser.parse_args()
    from _torch_cases import make_problem, make_sparse_problem
    from sparse_solvers_tpu_torch import Homotopy, IrlsCg, Omp
    from sparse_solvers_tpu_torch.ops import collectives, dispatch
    from sparse_solvers_tpu_torch.parallel import distributed, sharding

    if not args.cpu and not torch.cuda.is_available():
        print("mesh_scaling: torch sees no CUDA device (use --cpu)",
              file=sys.stderr)
        return 1
    check = distributed.initialize(
        backend="gloo" if args.cpu else None, timeout=300)
    if not check:
        print("mesh_scaling: no launcher environment (run under torchrun)",
              file=sys.stderr)
        return 1
    world, rank = distributed.process_count(), distributed.process_index()
    device = "cpu" if args.cpu else None
    cut = 16 if args.cpu else 1
    bcut = 4 if args.cpu else 1
    if args.cpu:
        torch.set_num_threads(1)

    M, N, K, B = 4096 // cut, 8192 // cut, 64 // cut, 256 // bcut
    GM, GN, GK = 2048 // cut, 65536 // cut, 16 // cut
    CM, CN, CK, CB = 1024 // cut, 65536 // cut, 24 // cut, 32 // bcut
    A, Y = make_problem(M, N, K, B)
    rng = np.random.RandomState(0)
    rng.randn(M, N)
    sups = []
    for _ in range(B):
        sups.append(set(rng.choice(N, K, replace=False).tolist()))
        rng.uniform(0.5, 1.0, K)
    Ao, Xo, Yo = make_sparse_problem(M, N, K, B, seed=0)
    Ag, Xg, Yg = make_sparse_problem(GM, GN, GK, B, seed=0)
    Ac, Xc, Yc = make_sparse_problem(CM, CN, CK, CB, signed=True,
                                     amp=(0.5, 1.5))
    truth = lambda X0: [set(np.flatnonzero(x).tolist()) for x in X0]
    paths = [
        ("homotopy", lambda **kw: Homotopy(A, k_max=96 // cut, **kw), Y,
         1e-2, 128 // cut, sups, K),
        ("omp", lambda **kw: Omp(Ao, **kw), Yo, 1e-2, 72 // cut, truth(Xo),
         K),
        ("gram-free homotopy", lambda **kw: Homotopy(Ag, gram=False, **kw),
         Yg, 1e-2, 40, truth(Xg), GK),
        ("gram-free omp", lambda **kw: Omp(Ag, gram=False, **kw), Yg, 1e-2,
         24, truth(Xg), GK),
        ("irls_cg", lambda **kw: IrlsCg(Ac, k_sparsity=2 * CK,
                                        cg_max_iterations=96, **kw), Yc,
         1e-3, 25, truth(Xc), CK),
    ]
    if args.cpu:
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", sharding._local_rank())
        torch.cuda.set_device(dev)

    shapes = [(world, 1)]
    if world > 2 and world % 2 == 0:
        shapes.append((2, world // 2))
    shapes.append((1, world))
    meshes = [sharding.make_mesh(r, d, device=device) for r, d in shapes]

    def lanes_ok(label, X, rep, tol, sup, k):
        Xh = X.cpu().numpy()
        top = np.argsort(-np.abs(Xh), axis=1)[:, :k]
        if label == "irls_cg":
            bad = rep.spd_failure.cpu().numpy()
            return sum(set(top[i].tolist()) == sup[i] and not bad[i]
                       for i in range(len(sup)))
        err = rep.solution_error.cpu().numpy()
        return sum(bool(err[i] <= tol) and set(top[i].tolist()) == sup[i]
                   for i in range(len(sup)))

    card = "CPU rehearsal (gloo)"
    if not args.cpu:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    for label, make, YY, tol, it, sup, k in paths:
        Yd = torch.from_numpy(YY).to(dev)
        plain = make(device=dev)
        plain.solve_batch(Yd, tol, it)
        plain_times, (Xp, rp) = fenced(lambda: plain.solve_batch(Yd, tol,
                                                                 it))
        del plain
        for mesh in meshes:
            solver = make(mesh=mesh)
            dispatch.reset_launches()
            collectives.reset_counts()
            Xm, rm = solver.solve_batch(Yd, tol, it)
            sync()
            counts, launches = (dict(collectives.counts),
                                dict(dispatch.launches))
            times, (Xm, rm) = fenced(lambda: solver.solve_batch(Yd, tol,
                                                                it))
            agree = same_on_every_rank(Xm)
            line = {
                "path": label, "mesh": dict(mesh.shape),
                "backend": mesh.backend, "ranks": world,
                "batch": int(YY.shape[0]), "mesh_ms": float(np.median(times)),
                "mesh_quartiles_ms": [float(q) for q in
                                      np.percentile(times, [25, 75])],
                "one_card_ms": float(np.median(plain_times)),
                "iterations_equal_lanes": int(
                    (rm.iter == rp.iter).sum()),
                "max_iterations": int(rm.iter.max()),
                "max_abs_dx_vs_one_card": float((Xm - Xp).abs().max()),
                "ranks_bit_identical": agree,
                "lanes_ok": int(lanes_ok(label, Xm, rm, tol, sup, k)),
                "lanes": len(sup), "collectives_rank0": counts,
                "launches_rank0": {kk: v for kk, v in launches.items()
                                   if v}, "card": card}
            if rank == 0:
                print(json.dumps(line), flush=True)
            del solver
            if not args.cpu:
                torch.cuda.empty_cache()
    if rank == 0:
        print(card, flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
