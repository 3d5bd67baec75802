"""One traced run of a cell, and where the host was while the card idled.

    python3 perfbench/attribution.py --workload <name> --seed <n> \
        --seconds <s>

Runs the cell as ``run.py --trace 1`` does and prints one JSON line: the
result line; the untraced and the traced wall per driver iteration and
the difference per kernel launch, the profiler's cost on the host; and,
from the program's spans (``metrics/_spans.attribution``), the self time
and the card's idle inside each span name and between the calls, in ms
per traced call. Not a metric: the figures behind PERF.md's attribution
tables.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import harness, run
    from perfbench.metrics import _spans

    run._caches()
    if not torch.cuda.is_available():
        print("perfbench: torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    kept = []
    made = harness.Run

    def keep(*a, **k):
        kept.append(made(*a, **k))
        return kept[-1]
    harness.Run = keep
    result, _ = harness.run_cell(ROOT, args.workload, args.seed,
                                 args.seconds, True,
                                 torch.device("cuda", 0), T_START)
    cell = kept[-1]
    records = _spans.traced_records(cell)
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "result": result,
        "profiler": profiler_cost(cell),
        "attribution": (None if records is None
                        else _spans.attribution(cell, records))}))
    return 0


def profiler_cost(cell) -> dict:
    """The untraced window's and the traced calls' wall per driver
    iteration (a call runs as many as its longest lane), and the
    difference per kernel launch: what the profiler adds to the host."""
    from perfbench.metrics._yardstick import is_copy

    def per_iter(wall_s, calls):
        return wall_s / sum(int(max(c.iters)) for c in calls)
    t = cell.traced
    untraced = per_iter(sum(c.wall_s for c in cell.window), cell.window)
    traced = per_iter(t.window_s, t.calls)
    launches = per_iter(sum(not is_copy(n) for n, _, _ in t.device),
                        t.calls)
    return {"untraced_ms_per_iter": untraced * 1e3,
            "traced_ms_per_iter": traced * 1e3,
            "kernels_per_iter": launches,
            "us_per_launch": (traced - untraced) * 1e6 / launches}


if __name__ == "__main__":
    sys.exit(main())
