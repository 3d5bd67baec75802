"""Profiling and roofline accounting — the port of
``sparse_solvers_tpu/utils/profiling.py``.

The JAX package traces with ``jax.profiler`` and sets measured rates
against a TPU's peaks. Here the card is an NVIDIA GPU: ``trace`` wraps
``torch.profiler``, ``measure`` times with CUDA events, and ``ChipSpec``
holds the H100's data-sheet peaks. Its fp32 peak is its own number, not a
fraction of the bf16 one: the JAX package's ``bf16/6`` and ``bf16/3`` are
the TPU's MXU passes, which this card does not have. There is no CPU
fallback: a time taken on the host is not a device number.

Spans and counters (``span``, ``count``) mark what the host does inside a
solve: the facade, its certificate and re-solve, the capacity tiers, the
driver's iterations and every host-device synchronisation. They record
only while a ``torch.profiler`` session records, in any process and with
any activities; otherwise a span is one flag check and records nothing.
Their times are ``time.time_ns()``, the clock of the profiler's events,
so a span and the kernels it issued lie on one timeline.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

# the call records kept, the newest last
CALLS_KEPT = 4096


class Span(NamedTuple):
    """One closed span: its call, its id and its parent's (None for the
    call's root), its name, its host times and its attributes."""
    call_id: int
    span_id: int
    parent_id: int | None
    name: str
    start_ns: int
    end_ns: int
    attrs: dict


@dataclasses.dataclass
class CallRecord:
    """The spans (in the order they closed) and counters of one call: a
    span opened outside any other opens one, and everything opened or
    counted inside it is stored here."""
    call_id: int
    spans: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)
    next_span: int = 0


_calls: collections.deque = collections.deque(maxlen=CALLS_KEPT)
_call_ids = itertools.count()
_local = threading.local()


def _open_spans() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


# the span while no profiler records
_OFF = contextlib.nullcontext()
_tuple_new = tuple.__new__


class _Recording:
    __slots__ = ("name", "attrs", "stack", "call", "span_id", "parent_id",
                 "start_ns")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.stack = stack = _open_spans()
        if stack:
            self.call, self.parent_id = stack[-1].call, stack[-1].span_id
        else:
            self.call, self.parent_id = CallRecord(next(_call_ids)), None
            _calls.append(self.call)
        self.span_id = self.call.next_span
        self.call.next_span += 1
        stack.append(self)
        self.start_ns = time.time_ns()
        return None

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        self.stack.pop()
        call = self.call
        # tuple.__new__ builds the record without Span.__new__'s overhead
        call.spans.append(_tuple_new(Span, (
            call.call_id, self.span_id, self.parent_id, self.name,
            self.start_ns, end_ns, self.attrs)))
        return False


def span(name: str, **attrs):
    """A context manager that records the host's time in ``name`` under
    the open span, while a profiler records; otherwise it does nothing.
    It never touches the device."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the open call, while a
    profiler records; outside any span there is no call and nothing is
    counted."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    stack = _open_spans()
    if stack:
        counters = stack[-1].call.counters
        counters[name] = counters.get(name, 0) + n


def calls() -> list[CallRecord]:
    """The call records kept (at most ``CALLS_KEPT``), the oldest first."""
    return list(_calls)


def clear() -> None:
    """Forget every call record."""
    _calls.clear()


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile a block on the CPU and the card with ``torch.profiler``.
    Yields the profiler (``key_averages()`` gives device time by kernel).
    The call records are cleared on entry; with ``logdir``, a Chrome
    trace (``trace.json``) and the call records (``spans.json``: a list
    of calls, each with its counters and its spans, times in the
    profiler's nanoseconds) are written there on exit."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    clear()
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
        with open(os.path.join(logdir, "spans.json"), "w") as f:
            json.dump([{"call_id": c.call_id, "counters": c.counters,
                        "spans": [s._asdict() for s in c.spans]}
                       for c in calls()], f)


@dataclasses.dataclass
class ChipSpec:
    """Peak numbers for roofline accounting (per card)."""
    name: str
    bf16_tflops: float   # dense tensor-core rate
    f32_tflops: float    # fp32 FMAs outside the tensor cores
    hbm_gbps: float

    def peak_tflops(self, precision: str) -> float:
        """The arithmetic peak a product at ``precision`` runs at:
        "highest" and "high" are fp32 without TF32, "default" is bf16."""
        return {"highest": self.f32_tflops, "high": self.f32_tflops,
                "default": self.bf16_tflops}[precision]

    def bound_seconds(self, flops: float, bytes: float,
                      precision: str) -> float:
        """The least time this card could take: the larger of the
        operations over their peak and the bytes over the memory rate."""
        return max(flops / (self.peak_tflops(precision) * 1e12),
                   bytes / (self.hbm_gbps * 1e9))


# NVIDIA's H100 SXM data sheet, dense rates without sparsity, at 700 W.
CHIPS = {
    "h100": ChipSpec("H100 SXM", bf16_tflops=989, f32_tflops=67,
                     hbm_gbps=3350),
}


def detect_chip() -> ChipSpec | None:
    """The spec of card 0, or None without a card or for one not listed."""
    if not torch.cuda.is_available():
        return None
    kind = torch.cuda.get_device_name(0).lower()
    for key, spec in CHIPS.items():
        if key in kind:
            return spec
    return None


@dataclasses.dataclass
class Roofline:
    """Measured-vs-peak summary for one op."""
    seconds: float
    flops: float
    bytes: float
    chip: ChipSpec | None

    @property
    def tflops(self) -> float:
        return self.flops / self.seconds / 1e12

    @property
    def gbps(self) -> float:
        return self.bytes / self.seconds / 1e9

    def fraction_of_peak(self, precision: str = "high") -> float | None:
        """max(compute, memory) fraction of the roofline bound."""
        if self.chip is None:
            return None
        peak_f = self.chip.peak_tflops(precision)
        return max(self.tflops / peak_f, self.gbps / self.chip.hbm_gbps)

    def __str__(self):
        s = f"{self.seconds*1e3:.3f} ms, {self.tflops:.2f} TFLOP/s, " \
            f"{self.gbps:.0f} GB/s"
        frac = self.fraction_of_peak()
        if frac is not None:
            s += f", {100*frac:.0f}% of roofline ({self.chip.name})"
        return s


def measure(fn, *args, flops: float = 0, bytes: float = 0,
            reps: int = 10, warmup: int = 3) -> Roofline:
    """Time ``fn(*args)`` on the card and report roofline occupancy.

    After ``warmup`` calls, ``reps`` calls run back to back between two
    CUDA events, behind a spin kernel that lets the host queue them before
    the card reaches them; the time is the events' span over ``reps``.
    ``flops``/``bytes`` are the caller's op accounting per call (e.g.
    4·b·m·n and the bytes each input and output moves once). Raises
    without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("profiling.measure times on a CUDA card; torch "
                           "sees none")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)
    e0.record()
    for _ in range(reps):
        fn(*args)
    e1.record()
    torch.cuda.synchronize()
    return Roofline(seconds=e0.elapsed_time(e1) / 1e3 / reps, flops=flops,
                    bytes=bytes, chip=detect_chip())
