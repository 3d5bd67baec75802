"""Plain reference of generalized Orthogonal Matching Pursuit (gOMP),
batched over lanes.

The steps of the NumPy OMP oracle of this repository's JAX package
(``sparse_solvers_tpu/oracle/omp.py``) with ``picks`` = J > 1: a round
takes the J largest inactive |A^T r| in descending order, the leftmost
index first among equal values, keeps those whose score is strictly
positive, and cuts them to the column budget min(max_iterations - iter,
k_max - |S|); it refits the coefficients afresh by least squares on the
gathered columns, with no online inverse. A lane stops once ||r||_2 <=
tol, when the budget is spent, after a round with no strictly positive
score (discarded whole, its last iterate kept), or when ||r||_2 stalls
(does not fall), keeping the iterate of that round. ``iter`` counts
columns, the support's size, as the oracle's and the facade's do. gOMP is
in the setting of Wang, Kwon and Shim, "Generalized Orthogonal Matching
Pursuit", IEEE Trans. Signal Process. 60(12):6202-6216, 2012; it is not
in the upstream library (rayglover-ibm/sparse-solvers).

The harness passes ``solve`` no option of the configuration, so J is read
once, here, from the configuration's file beside this folder
(``configs/gomp-4096x8192.json``, ``options.picks``), which stays its one
source.

Departures from the oracle, none of which changes a pick:
- the J largest scores come from J passes of a leftmost argmax, each
  taking its pick out of the next, not from a stable sort of all n: the
  same indices in the same order;
- the least squares is solved by its normal equations, as
  ``reference/omp.py`` solves it (its docstring says why that is exact
  enough in float64), a block of lanes at a time;
- lanes run side by side, each with its own support; a finished lane
  passes through a round unchanged, and a round works only on the lanes
  still live.

Where the program departs from these whole rounds, and why the limits
judge certificates and not trajectories: the port's capacity ladder (tiers
32, 64 and 128 at k_max 128) stops a tier's rounds one column short of
its capacity, so a round that would cross 31 or 63 columns is cut there
and the next tier's round starts from the scores refreshed after the cut.
The program's supports can therefore differ from this reference's in the
order of their columns and in the extra columns past the true support; a
64-sparse lane takes 17 passes over A and about 67 columns where whole
rounds would take 16.

Plain torch only: it imports nothing of the program and forms no Gram of
all of A. ``precision="float64"`` is the reference; ``"bfloat16"`` is the
control, every stored value rounded to bf16 and every product summed in
fp32 from bf16 operands, as a bf16 tensor-core product does. The
certificate is OMP's, ||y - A x||_2 (``reference/omp.py``), which the
facade reports.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from perfbench.reference import omp as _omp
from perfbench.reference.omp import PRECISIONS, certificate  # noqa: F401

CONFIG = Path(__file__).resolve().parent.parent / "configs" / (
    "gomp-4096x8192.json")
PICKS = int(json.loads(CONFIG.read_text())["options"]["picks"])


def solve(A: torch.Tensor, Y: torch.Tensor, tol: float, max_iterations: int,
          precision: str = "float64"):
    """Solve every row of Y (b, m) against A (m, n) with the
    configuration's picks a round.

    Returns (X (b, n), iterations (b,), rnorm (b,)), X and rnorm in the
    compute dtype: ||y - A x||_2 as the loop last computed it."""
    return solve_picks(A, Y, PICKS, tol, max_iterations, precision)[:3]


def solve_picks(A: torch.Tensor, Y: torch.Tensor, picks: int, tol: float,
                max_iterations: int, precision: str = "float64"):
    """``solve`` with ``picks`` columns a round: (X, iterations, rnorm),
    and each lane's support in pick order (b, k_max), n past its last
    pick."""
    if picks < 1:
        raise ValueError(f"picks must be >= 1, got {picks}")
    dtype, rnd = _omp._rounding(precision)
    with _omp._no_tf32():
        return _solve(rnd(A.to(dtype)), rnd(Y.to(dtype)), int(picks),
                      float(tol), max_iterations, rnd)


def _top(score: torch.Tensor, picks: int):
    """(indices, values) (l, picks) of each row's ``picks`` largest
    scores, largest first, the leftmost index first among equal values."""
    score = score.clone()
    idx, val = [], []
    for _ in range(picks):
        j = score.argmax(dim=1, keepdim=True)
        idx.append(j)
        val.append(score.gather(1, j))
        score.scatter_(1, j, -torch.inf)
    return torch.cat(idx, dim=1), torch.cat(val, dim=1)


def _solve(A, Y, picks, tol, max_iterations, rnd):
    b, m = Y.shape
    n = A.shape[1]
    k_max = max(1, min(max_iterations, m, n))
    dev, dtype = A.device, A.dtype
    AT = torch.cat([A.T, A.new_zeros((1, m))])

    slots = torch.full((b, k_max), n, dtype=torch.long, device=dev)
    coef = torch.zeros((b, k_max), dtype=dtype, device=dev)
    mask = torch.zeros((b, n), dtype=torch.bool, device=dev)
    R = Y.clone()
    rnorm = torch.linalg.vector_norm(R, dim=1)
    it = torch.zeros(b, dtype=torch.long, device=dev)
    stopped = torch.zeros(b, dtype=torch.bool, device=dev)
    order = torch.arange(picks, device=dev)

    while True:
        live = ~stopped & (it < max_iterations) & (it < k_max) & (rnorm > tol)
        L = live.nonzero()[:, 0]
        if not L.numel():
            break
        score = rnd(R[L] @ A).abs().masked_fill(mask[L], -torch.inf)
        idx, val = _top(score, picks)
        # the strictly positive scores lead the descending order, and the
        # column budget cuts what follows them
        budget = torch.minimum(max_iterations - it[L], k_max - it[L])
        take = (val > 0) & (order < budget[:, None])
        count = take.sum(dim=1)
        # no strictly positive score: the round is discarded, the lane stops
        stopped[L[count == 0]] = True
        keep = count > 0
        L, idx, take, count = L[keep], idx[keep], take[keep], count[keep]
        if not L.numel():
            continue
        s = it[L]
        for j in range(picks):
            lanes = take[:, j]
            slots[L[lanes], s[lanes] + j] = idx[lanes, j]
            mask[L[lanes], idx[lanes, j]] = True
        it[L] = s + count
        w = int(it[L].max())
        c, RL = _omp._refit(AT, Y[L], slots[L, :w], rnd)
        coef[L, :w] = c
        R[L] = RL
        rnext = torch.linalg.vector_norm(RL, dim=1)
        # a stall marks the rounding floor: stop with this iterate kept
        stopped[L] = rnext >= rnorm[L]
        rnorm[L] = rnext

    X = torch.zeros((b, n + 1), dtype=dtype, device=dev)
    X.scatter_(1, slots, coef)
    return X[:, :n], it, rnorm, slots
