"""Time K1, K2, K4, K5 and K6 of the port found under a root directory, on
the card, as ``chip_smoke.py``'s phases time them: for A/B runs of two
trees.

    python3 tools/time_fused.py [--root DIR] [--kernels k1,k2,k4,k5,k6]

Loads ``sparse_solvers_tpu_torch`` from DIR (default: this checkout),
builds its kernels and prints one line per case: K1 at b=256, m=4096,
n=8192, K2 at b=256, n=8192 at each Homotopy tier and K4 at b=256 at each
OMP and gOMP tier (``chip_smoke.time_ms``, the median of 20 calls, on the
inputs of ``chip_smoke.py``'s checks), K5 and K6 at m=4096, n=8192, b = 8,
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--kernels", default="k1,k2,k4,k5,k6")
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
