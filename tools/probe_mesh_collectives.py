"""What the mesh routes' collectives cost on one card, and where a mesh
route's extra wall time goes.

    python3 tools/probe_mesh_collectives.py

On a one-rank NCCL process group (the mesh of ``chip_smoke.py``'s mesh
phase: ``distributed.initialize`` through a file store, ``make_mesh(1,
1)``), where an all-reduce or a gather moves no byte between cards:

Part 1: ``ops/collectives.all_reduce`` and ``all_gather`` on float32
tensors of 4 KiB, 128 KiB, 8 MiB and 64 MiB, beside ``torch.distributed.
all_reduce`` called directly and a ``clone()`` of the same tensor. For
each, one JSON line: the host µs a call takes to return (200 calls, no
sync), the wall µs a call with the device (the same 200 calls, then a
sync), the device µs a call from CUDA events around 200 calls queued
behind a spin kernel, and the host µs one call takes to return with
about 10 ms of device work (a spin kernel) queued ahead of it: a call
that waits for the stream returns after the spin, one that does not
returns at once.

Part 2: the certified ``Homotopy`` and ``Omp`` ``solve_batch`` of
``chip_smoke.py``'s mesh phase (4096x8192, k=64, batch 256, tol 1e-2; 128
and 72 iterations) and its ``IrlsCg`` (1024x65536, k=24, batch 32, K=48,
96 CG steps, tol 1e-3, 25 outer iterations) through ``mesh=`` and
without, in turns (plain, mesh, local, local, mesh, plain, 3 fenced
batches each, where "local" is the mesh route with ``ops/collectives``'
all-reduce and all-gather replaced by the local result they give on one
rank: what the route costs apart from its collective calls), then one
batch of the plain and mesh routes under ``torch.profiler``: the wall ms, the device ms,
the host ms and count of the collective operations (names holding
"c10d", "nccl" or "all_reduce"/"allgather") and, on the mesh route, the
12 host operations whose self time grew most over the plain route's.
One JSON line per route.
Run it again with ``TORCH_NCCL_AVOID_RECORD_STREAMS=1`` to see what
ProcessGroupNCCL's ``recordStream`` of every collective's tensors costs
(each line carries the variable's value).

Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# the seeded problems (tests/_torch_cases.py: numpy only)
sys.path.insert(0, str(ROOT / "tests"))

SIZES = (1 << 10, 1 << 15, 1 << 21, 1 << 24)   # float32 elements
CALLS = 200
COLLECTIVE_KEYS = ("c10d", "nccl", "all_reduce", "allreduce", "allgather",
                   "all_gather")


def per_call(fn):
    """(host µs to return, wall µs with a sync, device µs) a call, and
    ``behind_busy_stream``'s µs."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(400_000_000)
    e0.record()
    for _ in range(CALLS):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return ((t1 - t0) / CALLS * 1e6, (t2 - t0) / CALLS * 1e6,
            e0.elapsed_time(e1) / CALLS * 1e3, behind_busy_stream(fn))


def behind_busy_stream(fn) -> float:
    """Host µs one call of ``fn`` takes to return with a spin kernel of
    about 10 ms queued ahead of it on the current stream."""
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    t0 = time.perf_counter()
    fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6


def fenced_ms(fn, runs: int):
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def profiled(fn):
    """(wall ms, device ms, collective host ms, collective calls, host ms
    and calls by operation) of one call under torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = host = 0.0
    calls, by_op = {}, {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            device += evt.self_device_time_total / 1e3
            continue
        by_op[evt.key] = (evt.self_cpu_time_total / 1e3, evt.count)
        if any(k in evt.key.lower() for k in COLLECTIVE_KEYS):
            calls[evt.key] = [evt.count, evt.cpu_time_total / 1e3]
            host += evt.self_cpu_time_total / 1e3
    return wall, device, host, calls, by_op


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_mesh_collectives: torch sees no CUDA device",
              file=sys.stderr)
        return 1
    from _torch_cases import make_problem, make_sparse_problem
    from sparse_solvers_tpu_torch import Homotopy, IrlsCg, Omp
    from sparse_solvers_tpu_torch.ops import collectives
    from sparse_solvers_tpu_torch.parallel import distributed, sharding
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    store = tempfile.mkdtemp()
    distributed.initialize(init_method=f"file://{store}/init", world_size=1,
                           rank=0, backend="nccl")
    try:
        mesh = sharding.make_mesh(1, 1)
        dev = mesh.device
        for n in SIZES:
            x = torch.randn(n, device=dev)
            forms = {
                "collectives.all_reduce": lambda: collectives.all_reduce(
                    x, mesh.row_group),
                "dist.all_reduce": lambda: torch.distributed.all_reduce(
                    x, group=mesh.row_group),
                "collectives.all_gather": lambda: collectives.all_gather(
                    x, mesh.row_group),
                "clone": lambda: x.clone()}
            for name, fn in forms.items():
                host, wall, device, busy = per_call(fn)
                print(json.dumps({"part": "collective", "form": name,
                                  "bytes": 4 * n, "host_us": host,
                                  "wall_us": wall, "device_us": device,
                                  "host_us_behind_busy_stream": busy,
                                  "avoid_record_streams": os.environ.get(
                                      "TORCH_NCCL_AVOID_RECORD_STREAMS"),
                                  "card": card}), flush=True)
        A, Y = make_problem(4096, 8192, 64, 256)
        A2, _, Y2 = make_sparse_problem(4096, 8192, 64, 256, seed=0)
        A3, _, Y3 = make_sparse_problem(1024, 65536, 24, 32, signed=True,
                                        amp=(0.5, 1.5))
        for label, cls, kw, AA, YY, it, tol in (
                ("homotopy", Homotopy, dict(k_max=96), A, Y, 128, 1e-2),
                ("omp", Omp, {}, A2, Y2, 72, 1e-2),
                ("irls_cg", IrlsCg, dict(k_sparsity=48,
                                         cg_max_iterations=96), A3, Y3, 25,
                 1e-3)):
            Yd = torch.from_numpy(YY).to(dev)
            routes = {"plain": cls(AA, device=dev, **kw),
                      "mesh": cls(AA, mesh=mesh, **kw)}
            runs = {name: [] for name in ("plain", "mesh", "local")}
            real = collectives.all_reduce, collectives.all_gather
            for name in ("plain", "mesh", "local", "local", "mesh",
                         "plain"):
                solver = routes["mesh" if name == "local" else name]
                if name == "local":
                    collectives.all_reduce = (
                        lambda t, group, op="sum": t.contiguous())
                    collectives.all_gather = (
                        lambda t, group: t.unsqueeze(0).clone())
                try:
                    solver.solve_batch(Yd, tol, it)
                    runs[name] += fenced_ms(
                        lambda s=solver: s.solve_batch(Yd, tol, it), 3)
                finally:
                    collectives.all_reduce, collectives.all_gather = real
            print(json.dumps({
                "part": "route", "route": f"{label} mesh, collectives as "
                "local results", "median_ms": float(np.median(
                    runs["local"])), "runs_ms": runs["local"],
                "card": card}), flush=True)
            ops = {}
            for name, solver in routes.items():
                collectives.reset_counts()
                wall, device, host, calls, ops[name] = profiled(
                    lambda s=solver: s.solve_batch(Yd, tol, it))
                # the host operations whose self time grew most on the
                # mesh route: (key, ms more, calls more)
                delta = sorted(
                    ((k, v[0] - ops["plain"].get(k, (0.0, 0))[0],
                      v[1] - ops["plain"].get(k, (0.0, 0))[1])
                     for k, v in ops[name].items()),
                    key=lambda t: -t[1])[:12] if name == "mesh" else []
                print(json.dumps({
                    "part": "route", "route": f"{label} {name}",
                    "median_ms": float(np.median(runs[name])),
                    "runs_ms": runs[name], "profiled_wall_ms": wall,
                    "device_ms": device, "collective_host_ms": host,
                    "collective_ops": calls,
                    "collectives": dict(collectives.counts),
                    "host_ops_grown": delta,
                    "avoid_record_streams": os.environ.get(
                        "TORCH_NCCL_AVOID_RECORD_STREAMS"),
                    "card": card}), flush=True)
            del routes
            torch.cuda.empty_cache()
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
