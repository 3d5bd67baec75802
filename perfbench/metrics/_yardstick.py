"""The yardstick the readers share: the card's published peaks, the work of
one q pass, and the arithmetic on device intervals.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
700 W power limit; the result line records the card's own limit beside
every reading.
"""

from __future__ import annotations

PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_seconds(flops: float, nbytes: float, peak: str) -> float:
    """The least time the card could take: the larger of the operations
    over their peak and the bytes over the memory rate."""
    return max(flops / PEAK_FLOPS[peak], nbytes / HBM_BYTES_PER_S)


def q_pass_work(b: int, m: int, n: int) -> tuple[float, float]:
    """(operations, bytes) of one q = A^T A D pass over b lanes: two
    products of 2 b m n operations; A read once in bf16, D read and Q
    written in f32. The count is the algorithm's, whatever kernel runs
    it."""
    return 4.0 * b * m * n, m * n * 2.0 + 2.0 * b * n * 4.0


def iterations_run(calls) -> int:
    """Loop iterations the calls ran: every lane runs the loop body while
    any lane of its call is live, so a call runs as many as its longest
    lane. In the batch driver each is one q pass."""
    return int(sum(int(max(c.iters)) for c in calls))


def union_seconds(intervals) -> float:
    """Seconds covered by the union of (start_s, end_s) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def is_copy(name: str) -> bool:
    """A memory copy or fill, as the profiler names them, not a kernel."""
    return name.startswith(("Memcpy", "Memset"))
