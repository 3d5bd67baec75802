"""One run of one cell: set-up, the timed window, the traced calls, the
comparison with the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, metric or
reference is a file of its own, found by the name ``BENCHMARK.json``
gives it: ``configs/`` (the entry's ``file``), ``traffic/<mix>.json``,
``metrics/<metric>.py`` (a ``read(run)`` that returns a number or None),
``reference/<name>.py`` and ``checks/<workload>.json`` (the limits of the
comparison). The system under test is ``sparse_solvers_tpu_torch``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import random
import subprocess
import sys
import time
from pathlib import Path

import torch

from perfbench import check, generator, trace

# the benchmark's folder, looked up under the checkout's root, so that a
# copy of the checkout with files added runs with them
FOLDER = Path(__file__).resolve().parent.name
# the top-level modules that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "sparse_solvers_tpu")


@dataclasses.dataclass
class Call:
    """One call of the window: its wall time and its lanes' reports."""
    wall_s: float
    iters: list
    errs: list


@dataclasses.dataclass
class Traced:
    """The profiled calls after the window."""
    calls: list
    window_s: float
    device: list        # (name, start_s, end_s) of each operation on the card


@dataclasses.dataclass
class Run:
    """What a run measured; the metric readers take it."""
    workload: str
    config: dict
    traffic: dict
    seed: int
    setup_s: float
    window: list
    window_s: float
    memory_peak_bytes: int
    traced: Traced | None = None
    # the benchmark's own bytes on the card inside memory_peak_bytes: the
    # pool of signals, allocated before the peak is reset and held to the
    # end
    harness_bytes: int = 0


def load_cell(root: Path, workload: str):
    """(spec, cell, config, traffic) of a workload of ``root``'s
    BENCHMARK.json."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (root / FOLDER / "traffic" / f"{cell['traffic']}.json").read_text())
    return spec, cell, config, traffic


def load_module(root: Path, kind: str, name: str):
    """``<kind>/<name>.py`` of the benchmark's folder as a module."""
    path = root / FOLDER / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metrics_of(spec: dict, workload: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
    return [m for m in spec[kind]
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _entry(solver, config: dict, traffic: dict):
    """The user's entry the mix drives: ``call(Y (batch, m))`` → (X (batch,
    n), iterations, certificates), the last two as the facade returns
    them. Every facade of the program (Homotopy, Omp, Irls, IrlsCg,
    Cosamp) takes ``solve(y, tolerance=, max_iterations=)`` and
    ``solve_batch(Y, tolerance=, max_iterations=)`` and reports ``iter``
    and ``solution_error``."""
    kw = {"tolerance": config["tolerance"],
          "max_iterations": config["max_iterations"]}
    if traffic["entry"] == "solve_batch":
        def call(Y):
            X, rep = solver.solve_batch(Y, **kw)
            return X, rep.iter, rep.solution_error
    elif traffic["entry"] == "solve":
        def call(Y):
            x, rep = solver.solve(Y[0], **kw)
            return x[None], [rep.iter], [rep.solution_error]
    else:
        raise ValueError(f"unknown entry {traffic['entry']!r}")
    return call


def _host(values) -> list:
    if isinstance(values, torch.Tensor):
        return values.cpu().tolist()
    return [float(v) for v in values]


class _Sample:
    """A uniform sample of ``size`` calls of a window of unknown length,
    drawn from the seed (reservoir sampling). ``make()`` builds the item
    only when it is kept."""

    def __init__(self, size: int, seed: int):
        self.size, self.kept = size, []
        self.rng = random.Random(seed)

    def offer(self, i: int, make) -> None:
        if i < self.size:
            self.kept.append(make())
        else:
            j = self.rng.randrange(i + 1)
            if j < self.size:
                self.kept[j] = make()


def _power_limit_w():
    """The card's power limit as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             traced: bool, device: torch.device, t_start: float):
    """Run one cell once. Returns (result dict, check lines); the dict's
    last key is the comparison's numbers beside their limits."""
    import sparse_solvers_tpu_torch as program

    t_cell = time.perf_counter()
    spec, cell, config, traffic = load_cell(root, workload)
    A = generator.sensing_matrix(config, seed, device)
    pool, ks = generator.signal_pool(A, traffic, seed)
    _sync(device)
    t_drawn = time.perf_counter()
    pool_bytes = pool.numel() * pool.element_size()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    solver = getattr(program, config["facade"])(A, **config["options"],
                                                device=device)
    call = _entry(solver, config, traffic)
    calls = len(pool)
    # warm with the heaviest calls of the mix: the lazy Gram or transposed
    # copy, and every capacity tier the mix's lanes reach
    heavy = sorted(range(calls), key=lambda i: -int(ks[i].sum()))
    for i in heavy[:traffic["warmup_calls"]]:
        call(pool[i])
    _sync(device)
    setup_s = time.perf_counter() - t_start
    print(f"setup {setup_s:.3f} s: start and imports {t_cell - t_start:.3f}, "
          f"draws {t_drawn - t_cell:.3f}, facade and warm-up "
          f"{t_start + setup_s - t_drawn:.3f}", file=sys.stderr, flush=True)

    # the reports and the sampled answers go to the host as each call
    # ends, so that the card holds no more of the window than the program
    window = []
    sample = _Sample(traffic["check_calls"], seed)
    i = 0
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        X, it, err = call(pool[i % calls])
        _sync(device)
        b = time.perf_counter()
        window.append(Call(b - a, _host(it), _host(err)))
        sample.offer(i, lambda: (i % calls, X.cpu(), window[-1].iters,
                                 window[-1].errs))
        i += 1
        if b - t0 >= seconds:
            break
    window_s = b - t0
    del X

    record = None
    if traced:
        reports, traced_s, ops = trace.traced_calls(
            lambda j: call(pool[(i + j) % calls]), traffic["trace_calls"],
            device)
        record = Traced([Call(0.0, _host(it), _host(err))
                         for it, err in reports], traced_s, ops)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    run = Run(workload, config, traffic, seed, setup_s, window, window_s,
              peak, record, pool_bytes)

    # the program's state goes before the reference runs; the reference
    # draws A and the signals again from the seed
    kept = sample.kept
    del solver, call, A, pool, sample
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.compare_run(config, traffic, seed, device, kept,
                                load_module(root, "reference",
                                            config["reference"]))
    limits = json.loads(
        (root / FOLDER / "checks" / f"{workload}.json").read_text())
    verdict, lines = check.judge(numbers, limits)

    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in metrics_of(spec, workload, kind):
        value = load_module(root, "metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    lanes = sum(len(c.iters) for c in window)
    tol = config["tolerance"]
    failed = sum(1 for c in window for e in c.errs if not e <= tol)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": peak}
    if device.type == "cuda":
        dev["power_limit_w"] = _power_limit_w()
    result = {"correct": verdict, "attempted": lanes, "failed": failed,
              "metrics": metrics, "device": dev}
    if record is not None:
        dev["busy_s"] = trace.busy_seconds(record.device)
        dev["window_s"] = record.window_s
        result["breakdown"] = trace.breakdown(record.device)
    result["checks"] = {name: {"value": numbers[name],
                               "limit": entry["limit"]}
                        for name, entry in limits.items()}
    # the window has closed and everything the run loads is loaded
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package loaded: "
                           f"{found}")
    return result, lines
