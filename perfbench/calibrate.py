"""Readings for the limits of the comparison, on the card, in one process.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \
        --seconds <s>

For each seed: one run of the cell as ``run.py`` makes it (a window of
``--seconds``), whose comparison's numbers are the program's readings;
then the control, the plain reference computed in bfloat16 put in the
program's place on as many calls of the same pool as a run compares,
held to the same numbers. One JSON line a seed. The benchmark's own runs
never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def control_numbers(root: Path, workload: str, seed: int, device) -> dict:
    """The comparison's numbers for the bf16 reference in the program's
    place, on the pool's first ``check_calls`` calls."""
    from perfbench import check, generator, harness

    _, _, config, traffic = harness.load_cell(root, workload)
    reference = harness.load_module(root, "reference", config["reference"])
    A = generator.sensing_matrix(config, seed, device)
    pool, _ = generator.signal_pool(A, traffic, seed)
    Y = pool[:traffic["check_calls"]].reshape(-1, A.shape[0])
    tol, iters = config["tolerance"], config["max_iterations"]
    X, _, c_inf = reference.solve(A, Y, tol, iters, "bfloat16")
    return check.numbers(A, Y, X, c_inf, tol, iters, reference)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("calibrate: torch sees no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in map(int, args.seeds.split(",")):
        result, _ = harness.run_cell(ROOT, args.workload, seed, args.seconds,
                                     False, device, time.perf_counter())
        program = {k: v["value"] for k, v in result["checks"].items()}
        control = control_numbers(ROOT, args.workload, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": program, "control": control,
                          "failed": result["failed"],
                          "attempted": result["attempted"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
