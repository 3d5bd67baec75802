"""The traced calls: a fixed number of calls under ``torch.profiler`` with
CUDA activity only, after the timed window, and the reductions of their
device operations that the result line carries. No trace file is written.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict

import torch

from perfbench.metrics._yardstick import union_seconds

TOP = 10


def _device_ops(prof):
    """(name, start_s, end_s) of every operation that ran on the card,
    read from the profiler's raw events (no event tree is built)."""
    return [(e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


def traced_calls(fn, count: int, device):
    """Run ``fn(j)`` for j < ``count`` under the profiler, each call fenced
    by a synchronize. Returns (each call's (iterations, certificates), the
    traced wall seconds, the device operations)."""
    acts = ([torch.profiler.ProfilerActivity.CUDA] if device.type == "cuda"
            else [torch.profiler.ProfilerActivity.CPU])
    reports = []
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for j in range(count):
            _, iters, errs = fn(j)     # the solutions are not kept
            reports.append((iters, errs))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    return reports, window_s, (_device_ops(prof) if device.type == "cuda"
                               else [])


def short_name(name: str) -> str:
    """A kernel's name without its template arguments, parameter list and
    return type."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            if ch == "(":
                break
            out.append(ch)
    return "".join(out).strip()[:120] or name[:120]


def busy_seconds(device_ops) -> float:
    return union_seconds((s, e) for _, s, e in device_ops)


def breakdown(device_ops) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each gap named by the operations on either side of it (the host
    was issuing what comes after it)."""
    by_op = defaultdict(float)
    for name, s, e in device_ops:
        by_op[short_name(name)] += e - s
    gaps = defaultdict(float)
    ops = sorted(device_ops, key=lambda o: o[1])
    end, last = None, None
    for name, s, e in ops:
        if end is not None and s > end:
            gaps[f"after {last}, before {short_name(name)}"] += s - end
        if end is None or e >= end:
            end, last = e, short_name(name)
    top = lambda d: [[k, v] for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(by_op), "idle_gaps": top(gaps)}
