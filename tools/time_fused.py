"""Time K1, K2, K3, K4, K5 and K6 of the port found under a root directory,
on the card, as ``chip_smoke.py``'s phases time them: for A/B runs of two
trees.

    python3 tools/time_fused.py [--root DIR]
        [--kernels k1,k2,k3,k3routes,k4,k5,k6]

Loads ``sparse_solvers_tpu_torch`` from DIR (default: this checkout),
builds its kernels and prints one line per case: K1 at b=256, m=4096,
n=8192, K2 at b=256, n=8192 at each Homotopy tier, K3 at b=256 at each
capacity of ``chip_smoke.py``'s K3 phases (each mix at its capacities;
the event time and, through the wrapper, the device time of the kernels
whose names hold "transition"), K3 on each route that can run it at
``K3_ROUTE_CAPACITIES`` (``k3routes``, not in the default set: the
plan's route and the device route forced in its place, checked against
the twin, timed in two rounds, the second in reverse order) and K4 at
b=256 at each OMP and gOMP tier (``chip_smoke.time_ms``, the median of 20 calls, on the inputs of
``chip_smoke.py``'s checks), K5 and K6 at m=4096, n=8192, b = 8,
64, 256, at "highest" and "default" (``utils/profiling.measure``, 10
back-to-back launches) on ``chip_smoke.fused_case``'s inputs. Run each
tree in a process of its own, in turns (parent, change, change, parent),
so that each loads only its own library. Needs one CUDA card; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
# the main path's top tier and both sides of K3's route threshold, then
# the device route further up
K3_ROUTE_CAPACITIES = (96, 128, 129, 200, 236, 237)


def k3_route_plans(K3, K):
    """Every K3 launch plan that can run capacity K: the registers route
    where a thread's tile fits its budget, the device route always."""
    plan = K3.k3_launch_plan(K)
    plans = {plan.route: plan}
    if plan.route == "registers":
        plans["device"] = K3.K3Plan("device", 0, plan.vec,
                                    4 * K3._vector_floats(K))
    return plans


def time_k3_routes(smoke, dev, tag):
    from sparse_solvers_tpu_torch.ops.cuda import transition as K3
    planner = K3.k3_launch_plan
    try:
        for k in K3_ROUTE_CAPACITIES:
            K3.k3_launch_plan = planner
            base = [torch.from_numpy(a).to(dev) for a in
                    smoke.transition_mix(smoke.BATCH, k, smoke.N)]
            ref = K3.transition_plain(*base, 0.01, smoke.N)
            work = [t.clone() for t in base]
            plans = k3_route_plans(K3, k)

            def restore():
                for t, t0 in zip(work, base):
                    t.copy_(t0)

            def run():
                K3.transition(*work, 0.01, smoke.N)

            order = sorted(plans)
            for rnd, routes in enumerate((order, order[::-1])):
                for route in routes:
                    K3.k3_launch_plan = (
                        lambda K, aligned=True, p=plans[route]: p)
                    restore()
                    run()
                    err = max(float((w - r).abs().max())
                              / max(1.0, float(r.abs().max()))
                              for w, r in zip(work[:5], ref[:5]))
                    if not torch.equal(work[5], ref[5]) or err > 1e-5:
                        raise RuntimeError(f"K3 K={k} route {route}: "
                                           f"relative err {err}")
                    ms = smoke.time_ms(run, prepare=restore)
                    dms = smoke.device_ms(run, ("transition",),
                                          prepare=restore)
                    print(f"K3 route b={smoke.BATCH} K={k} {route}"
                          f"{' (plan)' if route == planner(k).route else ''}"
                          f" round {rnd}: {ms:.4f} ms, device {dms:.4f} ms,"
                          f" relative err {err:.2e} {tag}", flush=True)
            del base, work, ref
            torch.cuda.empty_cache()
    finally:
        K3.k3_launch_plan = planner


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--kernels", default="k1,k2,k3,k4,k5,k6")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_fused: torch sees no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from sparse_solvers_tpu_torch.ops import blas
    from sparse_solvers_tpu_torch.ops.cuda import kernels as K
    from sparse_solvers_tpu_torch.utils import profiling
    if not Path(K.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"loaded {K.__file__}, not the tree at {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    dev = torch.device("cuda", 0)
    wanted = args.kernels.split(",")
    tag = f"[{root.name}; {card}]"
    if "k1" in wanted:
        g = torch.Generator(device=dev).manual_seed(1)
        A = torch.randn(smoke.M, smoke.N, generator=g, device=dev)
        A16 = (A / A.norm(dim=0)).to(torch.bfloat16)
        D = torch.randn(smoke.BATCH, smoke.N, generator=g, device=dev)
        ms = smoke.time_ms(lambda: K.normal_matvec_fused_bf16(A16, D))
        print(f"K1 b={smoke.BATCH}: {ms:.4f} ms {tag}", flush=True)
    if "k2" in wanted:
        from sparse_solvers_tpu_torch.ops.cuda import scan as K2
        for k in smoke.SCAN_TIERS:
            # ties planted at n/2, the same inputs for any tree
            arrays, _ = smoke.scan_split_case(smoke.BATCH, smoke.N, k,
                                              [smoke.N // 2])
            args = [torch.from_numpy(a).to(dev) for a in arrays]
            ms = smoke.time_ms(lambda: K2.find_max_gamma_fused(*args))
            print(f"K2 b={smoke.BATCH} n={smoke.N} K={k}: {ms:.4f} ms {tag}",
                  flush=True)
    if "k3" in wanted:
        from sparse_solvers_tpu_torch.ops.cuda import transition as K3
        cases = [(k, "all") for k in smoke.K3_CAPACITIES + smoke.K3_THRESHOLDS]
        cases += [(k, mix) for k in smoke.K3_MIX_CAPACITIES
                  for mix in ("insert", "remove")]
        for k, mix in cases:
            base = [torch.from_numpy(a).to(dev) for a in
                    smoke.transition_mix(smoke.BATCH, k, smoke.N, mix=mix)]
            work = [t.clone() for t in base]

            def restore():
                for t, t0 in zip(work, base):
                    t.copy_(t0)

            def run():
                K3.transition(*work, 0.01, smoke.N)

            ms = smoke.time_ms(run, prepare=restore)
            dms = smoke.device_ms(run, ("transition",), prepare=restore)
            print(f"K3 b={smoke.BATCH} K={k} mix={mix}: {ms:.4f} ms, device "
                  f"{dms:.4f} ms {tag}", flush=True)
            del base, work
            torch.cuda.empty_cache()
    if "k3routes" in wanted:
        time_k3_routes(smoke, dev, tag)
    if "k4" in wanted:
        from sparse_solvers_tpu_torch.ops.cuda import omp_insert as K4
        for k in smoke.OMP_TIERS + smoke.GOMP_TIERS:
            base = [torch.from_numpy(a).to(dev)
                    for a in smoke.omp_insert_case(smoke.BATCH, k)]
            inv = base[0].clone()
            ms = smoke.time_ms(lambda: K4.omp_insert(inv, *base[1:]),
                               prepare=lambda: inv.copy_(base[0]))
            print(f"K4 b={smoke.BATCH} K={k}: {ms:.4f} ms {tag}", flush=True)
    names = {"k5": "normal_matvec_fused", "k6": "residual_correlation_fused"}
    for b in smoke.FUSED_BATCHES:
        A, D, Y = smoke.fused_case(dev, b)
        for prec in smoke.FUSED_PRECISIONS:
            with blas.precision_scope(prec):
                calls = smoke.fused_calls(A, D, Y)
                for key, name in names.items():
                    if key in wanted:
                        r = profiling.measure(calls[name][0], reps=10)
                        print(f"{name} b={b} {prec}: {r.seconds * 1e3:.4f} "
                              f"ms {tag}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
