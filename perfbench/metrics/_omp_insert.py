"""The work of K4, the OMP insert and least-squares re-solve of one pick
(``csrc/omp_insert.cu``), counted from what a lane needs and not from the
launches: the least the kernel could move and compute on the card."""

from __future__ import annotations

from perfbench.metrics._yardstick import bound_seconds


def insert_work(s: int) -> tuple[float, float]:
    """(operations, bytes) of one insert that grows a lane's support to
    ``s`` members: the (s-1) x (s-1) inverse block read and the s x s block
    written; the inserted Gram column, b_act read and coef written, s
    values each; all f32. Operations: u2 = inv u1 (2 (s-1)^2), the rank-1
    update of the block and coef = inv' b_act (2 s^2 each)."""
    return (2.0 * (s - 1) ** 2 + 4.0 * s * s,
            4.0 * ((s - 1) ** 2 + s * s + 3 * s))


def lane_seconds(picks: int) -> float:
    """The least time of a lane's ``picks`` inserts, at live sizes 1 to
    ``picks``."""
    return sum(bound_seconds(*insert_work(s), "fp32")
               for s in range(1, picks + 1))
