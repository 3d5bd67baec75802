"""The work of a CoSaMP round, counted from what its lanes need and not
from the launches: the least the card could compute and move for the
rounds the reports count, whatever implements them.

A round of a live lane needs its proxy c = A^T r (2 m n operations at the
fp32 peak, since the configuration runs its products in fp32 at
"highest") and the union's least squares at its least: the S x S Gram's
entries read from a Gram held on the card and an S^3 / 3 Cholesky, S the
union's capacity. A trip reads A once for all its live lanes.
"""

from __future__ import annotations

from perfbench.metrics._yardstick import bound_seconds


def union_capacity(m: int, n: int, k: int) -> int:
    """S = k + min(2k, n - k, m - k), the union of the support and the
    inactive candidates."""
    return k + min(2 * k, n - k, m - k)


def trip_work(lanes: int, m: int, n: int, S: int) -> tuple[float, float]:
    """(operations, bytes) of one trip over ``lanes`` live lanes: each
    lane's proxy product and Cholesky, A read once, each lane's S^2 Gram
    entries read; f32."""
    return (lanes * (2.0 * m * n + S ** 3 / 3.0),
            4.0 * m * n + lanes * 4.0 * S * S)


def call_seconds(iters, m: int, n: int, S: int) -> float:
    """The least time of one call's rounds: trip t runs the lanes whose
    reports count at least t rounds."""
    iters = [int(i) for i in iters]
    return sum(bound_seconds(*trip_work(sum(i >= t for i in iters), m, n, S),
                             "fp32")
               for t in range(1, max(iters, default=0) + 1))
