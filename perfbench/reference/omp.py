"""Plain reference of Orthogonal Matching Pursuit, batched over lanes.

The steps of the NumPy OMP oracle of this repository's JAX package
(``sparse_solvers_tpu/oracle/omp.py``) with one pick a round: pick the
largest |A^T r| over the inactive set, the leftmost index on ties, and only
where it is strictly positive (a lane with none stops, its last iterate
kept); refit the coefficients afresh by least squares on the gathered
columns, with no online inverse; stop once ||r||_2 <= tol, after
max_iterations picks, at k_max = min(max_iterations, m, n) members, or
when ||r||_2 stalls (does not fall), keeping the iterate of that pick.
OMP is not in the upstream library (rayglover-ibm/sparse-solvers); it is
this framework's greedy family beyond it, in the setting of Tropp and
Gilbert, "Signal Recovery From Random Measurements Via Orthogonal
Matching Pursuit", IEEE Trans. Inf. Theory 53(12), 2007.

Departures from the oracle, none of which changes a pick:
- the least squares is solved by its normal equations (A_S^T A_S) c =
  A_S^T y, not by ``lstsq``'s orthogonal factorisation; that squares the
  condition number, which for a Gaussian A_S of k << m unit columns is
  near 1, so in float64 the two agree to rounding;
- lanes run side by side, each with its own support; a finished lane
  passes through a round unchanged, and a round works only on the lanes
  still live;
- the gathered columns A_S are formed a block of lanes at a time, so
  that their (lanes, |S|, m) copy stays under ``_GATHER_ELEMS`` values.

Plain torch only: it imports nothing of the program and forms no Gram of
all of A. ``precision="float64"`` is the reference; ``"bfloat16"`` is the
control, every stored value rounded to bf16 and every product summed in
fp32 from bf16 operands, as a bf16 tensor-core product does.
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("float64", "bfloat16")
# values of the gathered columns formed at once
_GATHER_ELEMS = 1 << 25


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _rounding(precision: str):
    """(compute dtype, rounding of every stored value)."""
    if precision == "float64":
        return torch.float64, lambda t: t
    if precision == "bfloat16":
        return torch.float32, lambda t: t.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"precision must be one of {PRECISIONS}: {precision!r}")


def certificate(A: torch.Tensor, Y: torch.Tensor,
                X: torch.Tensor) -> torch.Tensor:
    """||y - A x||_2 of every row of X (b, n) against Y (b, m), in the
    dtype of the arguments: the certificate the configuration guarantees
    and the facade reports."""
    with _no_tf32():
        return torch.linalg.vector_norm(Y - X @ A.T, dim=1)


def solve(A: torch.Tensor, Y: torch.Tensor, tol: float, max_iterations: int,
          precision: str = "float64"):
    """Solve every row of Y (b, m) against A (m, n).

    Returns (X (b, n), iterations (b,), rnorm (b,)), X and rnorm in the
    compute dtype: ||y - A x||_2 as the loop last computed it."""
    return solve_supports(A, Y, tol, max_iterations, precision)[:3]


def solve_supports(A: torch.Tensor, Y: torch.Tensor, tol: float,
                   max_iterations: int, precision: str = "float64"):
    """``solve``'s (X, iterations, rnorm), and each lane's support in pick
    order (b, k_max), n past its last pick."""
    dtype, rnd = _rounding(precision)
    with _no_tf32():
        return _solve(rnd(A.to(dtype)), rnd(Y.to(dtype)), float(tol),
                      max_iterations, rnd)


def _refit(AT, Y, slots, rnd):
    """(coef (b, w), residual (b, m)) of the least-squares fit of each
    row of Y on its columns ``slots`` (b, w) of A (AT: A^T with a zero row
    at n, the empty slot), a block of lanes at a time."""
    b, w = slots.shape
    m = Y.shape[1]
    n = AT.shape[0] - 1
    coef = Y.new_empty((b, w))
    R = torch.empty_like(Y)
    lanes = max(1, _GATHER_ELEMS // (w * m))
    for l0 in range(0, b, lanes):
        used = slots[l0:l0 + lanes]
        ok = used < n
        AS = AT[used]                                   # (lanes, w, m)
        y = Y[l0:l0 + lanes]
        # empty slots held at coef = 0 by a unit diagonal
        G = rnd(AS @ AS.transpose(1, 2)) + torch.diag_embed(
            (~ok).to(Y.dtype))
        rhs = rnd((AS @ y.unsqueeze(-1)).squeeze(-1))
        c = rnd(torch.linalg.solve_ex(G, rhs.unsqueeze(-1))[0].squeeze(-1))
        coef[l0:l0 + lanes] = c
        R[l0:l0 + lanes] = rnd(y - rnd((c.unsqueeze(1) @ AS).squeeze(1)))
        del AS, G
    return coef, R


def _solve(A, Y, tol, max_iterations, rnd):
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
    ninf = torch.tensor(float("-inf"), dtype=dtype, device=dev)

    while True:
        live = ~stopped & (it < max_iterations) & (it < k_max) & (rnorm > tol)
        L = live.nonzero()[:, 0]
        if not L.numel():
            break
        # the pick: the largest inactive |A^T r|, leftmost on ties
        score = torch.where(mask[L], ninf, rnd(R[L] @ A).abs())
        idx = score.argmax(dim=1)
        keep = score.gather(1, idx[:, None])[:, 0] > 0
        # no strictly positive score: the round is discarded, the lane stops
        stopped[L[~keep]] = True
        L, idx = L[keep], idx[keep]
        if not L.numel():
            continue
        s = it[L]
        slots[L, s] = idx
        mask[L, idx] = True
        it[L] = s + 1
        w = int(s.max()) + 1
        c, RL = _refit(AT, Y[L], slots[L, :w], rnd)
        coef[L, :w] = c
        R[L] = RL
        rnext = torch.linalg.vector_norm(RL, dim=1)
        # a stall marks the rounding floor: stop with this iterate kept
        stopped[L] = rnext >= rnorm[L]
        rnorm[L] = rnext

    X = torch.zeros((b, n + 1), dtype=dtype, device=dev)
    X.scatter_(1, slots, coef)
    return X[:, :n], it, rnorm, slots
