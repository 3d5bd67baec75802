"""Profiling and roofline accounting — the port of
``sparse_solvers_tpu/utils/profiling.py``.

The JAX package traces with ``jax.profiler`` and sets measured rates
against a TPU's peaks. Here the card is an NVIDIA GPU: ``trace`` wraps
``torch.profiler``, ``measure`` times with CUDA events, and ``ChipSpec``
holds the H100's data-sheet peaks. Its fp32 peak is its own number, not a
fraction of the bf16 one: the JAX package's ``bf16/6`` and ``bf16/3`` are
the TPU's MXU passes, which this card does not have. There is no CPU
fallback: a time taken on the host is not a device number.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import torch


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile a block on the CPU and the card with ``torch.profiler``.
    Yields the profiler (``key_averages()`` gives device time by kernel);
    with ``logdir``, a Chrome trace is written there on exit."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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
