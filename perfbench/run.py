"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this folder and
the ``sparse_solvers_tpu_torch`` package. Set-up (drawing A and the
signals on the card from the seed, building the facade, warming it with
the cell's heaviest calls) is timed from the start of this process; then
one caller drives the cell's entry in a closed loop for ``--seconds``,
each call fenced by a synchronize. ``--trace 1`` then profiles the mix's
``trace_calls`` calls and prints the per-layer metrics in place of the
end-to-end ones. The last lines on standard error are the comparison's
numbers beside their limits; the last line on standard output is the
result. Without a CUDA card, or with fewer than the cell asks for, it
prints no result and exits with 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    the port's nvcc library builds into ``build/sparse_solvers_tpu_torch``
    there by itself."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv_compute_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _caches()
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import harness

    _, cell, _, _ = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("perfbench: torch sees no CUDA device; the benchmark runs "
              "only on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} cards, "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result, lines = harness.run_cell(
        ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda", 0), T_START)
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
