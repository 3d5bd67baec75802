"""Where the time of one small single-signal solve on the card goes, and
what CoSaMP's transposed copy of A buys.

    python3 tools/profile_small_solve.py [--skip-gather]

Part 1, at ``chip_smoke.py``'s host-engine shapes (128x512, k=8, seed 0;
the torch route, ``engine="jax"``): one ``solve`` of certified ``Homotopy``,
of ``Homotopy`` at "default" and at "high" (the certified solve's two
passes taken apart), of certified ``Omp`` and of ``IrlsCg`` at tol 1e-5.
For each, one JSON line: the median wall ms of 20 fenced calls, the
iterations, the ATen operations of one call (counted by a
``TorchDispatchMode``), and from one call under ``torch.profiler`` the
device kernels, their device ms, the CUDA runtime calls that launch a
kernel or copy to the host, and the wall microseconds per ATen operation.

Part 2 (``--skip-gather`` leaves it out), at ``chip_smoke.py``'s CoSaMP
shapes (4096x8192, k=64 and 2048x65536, k=16, batch 256, "highest", tol
1e-2, 20 rounds): one whole ``solve_cosamp`` batch gathering the union
from the contiguous transposed copy of A against the same batch gathering
A's columns straight from A (``AT=A.T``, a strided view), the median of 5
fenced batches each, and the gather alone on one round's union (median of
20 fenced calls): rows of the copy, ``A.T.index_select(0, ·)`` and
``A.index_select(1, ·)`` made contiguous in the same (b·S, m) layout.
Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
# the seeded problems (tests/_torch_cases.py: numpy only)
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))


def fenced(fn, runs: int) -> list[float]:
    """Wall ms of ``runs`` calls of ``fn()``, each fenced by a sync."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def aten_ops(fn) -> int:
    """The ATen operations one call of ``fn()`` dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def profiled(fn) -> dict:
    """Device kernels, device ms and CUDA runtime calls of one call."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = device_us = 0.0
    runtime: dict[str, int] = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels += e.count
            device_us += e.self_device_time_total
        elif e.key.startswith("cuda"):
            runtime[e.key] = runtime.get(e.key, 0) + e.count
    launch = sum(c for k, c in runtime.items() if "Launch" in k)
    memcpy = sum(c for k, c in runtime.items() if "Memcpy" in k)
    sync = sum(c for k, c in runtime.items() if "Synchronize" in k)
    return {"profiled_wall_ms": wall, "device_kernels": int(kernels),
            "device_ms": device_us / 1e3, "busy_share": device_us / 1e3
            / wall, "runtime_launch_calls": launch,
            "runtime_memcpy_calls": memcpy, "runtime_sync_calls": sync}


def small_solves(dev, card) -> None:
    from _torch_cases import make_sparse_problem
    from sparse_solvers_tpu_torch import Homotopy, IrlsCg, Omp
    A, _, Y = make_sparse_problem(128, 512, 8, 64, seed=0)
    Ac, _, Yc = make_sparse_problem(128, 512, 8, 64, signed=True,
                                    amp=(0.5, 1.5))
    torch_route = {"engine": "jax", "device": dev}
    cases = (
        ("homotopy certified", Homotopy(A, **torch_route), Y, 1e-3, 64),
        ("homotopy default", Homotopy(A, precision="default",
                                      **torch_route), Y, 1e-3, 64),
        ("homotopy high", Homotopy(A, precision="high", **torch_route), Y,
         1e-3, 64),
        ("omp certified", Omp(A, **torch_route), Y, 1e-3, 32),
        ("irls_cg highest", IrlsCg(Ac, k_sparsity=16, **torch_route), Yc,
         1e-5, 60))
    for name, solver, Ys, tol, max_it in cases:
        def one():
            return solver.solve(Ys[0], tol, max_it)
        for _ in range(3):
            _, rep = one()
        wall = float(np.median(fenced(one, 20)))
        ops = aten_ops(one)
        line = {"phase": "small_solve", "case": name, "m": 128, "n": 512,
                "solve_ms": wall, "iterations": rep.iter,
                "solution_error": rep.solution_error, "aten_ops": ops,
                "wall_us_per_aten_op": wall * 1e3 / ops, **profiled(one),
                "card": card}
        print(json.dumps(line), flush=True)


def gather_forms(dev, card) -> None:
    from _torch_cases import make_sparse_problem
    from sparse_solvers_tpu_torch.ops import blas
    from sparse_solvers_tpu_torch.solvers import cosamp
    for m, n, k in ((4096, 8192, 64), (2048, 65536, 16)):
        A_h, _, Y_h = make_sparse_problem(m, n, k, 256, seed=0)
        A = torch.from_numpy(A_h).to(dev)
        Y = torch.from_numpy(Y_h).to(dev)
        AT = A.T.contiguous()
        out, batch = {}, {}
        for form, at in (("copy", AT), ("view", A.T), ("copy", AT),
                         ("view", A.T)):
            def run():
                with blas.precision_scope("highest"):
                    return cosamp.solve_cosamp(A, Y, k, 1e-2, 20, AT=at)
            run()
            batch.setdefault(form, []).extend(fenced(run, 5))
            out[form] = run()
        (Xc, rc), (Xv, rv) = out["copy"], out["view"]
        S = cosamp.union_capacity(m, n, k)
        g = torch.Generator(device=dev).manual_seed(0)
        idx = torch.rand(256, n, generator=g, device=dev).argsort(
            dim=1)[:, :S].reshape(-1)
        forms = {"copy rows": lambda: AT.index_select(0, idx),
                 "A.T rows": lambda: A.T.index_select(0, idx),
                 "A columns": lambda: A.index_select(1, idx).T.contiguous()}
        ref = forms["copy rows"]()
        gather = {}
        for name, fn in forms.items():
            assert torch.equal(fn(), ref), name
            fn()
            gather[name] = float(np.median(fenced(fn, 20)))
        print(json.dumps({
            "phase": "cosamp_gather", "m": m, "n": n, "k": k, "batch": 256,
            "union": S, "batch_ms": {f: float(np.median(t))
                                     for f, t in batch.items()},
            "batch_ms_all": batch, "equal": bool(torch.equal(Xc, Xv)
                                                 and torch.equal(rc.iter,
                                                                 rv.iter)),
            "gather_ms": gather, "gathered_mb": ref.numel() * 4 / 1e6,
            "copy_mib": AT.numel() * 4 / 2 ** 20, "card": card}),
            flush=True)
        del A, Y, AT, ref
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-gather", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_small_solve: torch sees no CUDA device",
              file=sys.stderr)
        return 1
    warnings.filterwarnings("ignore", "engine='jax' on a", RuntimeWarning)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    dev = torch.device("cuda", 0)
    print(card, flush=True)
    small_solves(dev, card)
    if not args.skip_gather:
        gather_forms(dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
