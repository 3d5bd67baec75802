"""Plain reference of CoSaMP, batched over lanes.

The steps of the NumPy CoSaMP oracle of this repository's JAX package
(``sparse_solvers_tpu/oracle/cosamp.py``): a round takes the k2 = min(2k,
n - k, m - k) largest inactive |A^T r| in a stable descending order (the
lower index first among equal values), joins them to supp(x), fits y by
least squares on the union's columns through an orthogonal factorisation
(a QR and a triangular solve, never the union's Gram, so that a Gram or
Cholesky fault of the program cannot hide), prunes to the k largest |b|
(again stable) and forms r = y - A x. A round whose ||r||_2^2 is not
finite or does not fall stops the lane with its previous iterate kept; a
lane stops once ||r||_2 <= tol or after max_iterations rounds. CoSaMP is
in the setting of Needell and Tropp, "CoSaMP: Iterative signal recovery
from incomplete and inaccurate samples", Appl. Comput. Harmon. Anal.
26(3):301-321, 2009; it is not in the upstream library
(rayglover-ibm/sparse-solvers).

The harness passes ``solve`` no option of the configuration, so the
sparsity k it must be told is read once, here, from the configuration's
file beside this folder (``configs/cosamp-4096x8192.json``,
``options.k_sparsity``), which stays its one source.

Departures from the oracle, none of which changes a selection:
- lanes run side by side, each with its own support; a finished lane
  passes through a round unchanged, and a round works only on the lanes
  still live;
- the support is a fixed (b, k) array whose empty slots hold n, a zero
  column of A: the oracle's first round fits on the k2 candidates alone,
  here on k empty slots beside them. An empty slot's column gets a 1 in
  one of S extra rows whose right-hand side is 0, so that its coefficient
  solves to exactly 0 and the fit of the other columns is the oracle's;
  the prune then ranks the empty slots' zeros below every nonzero |b|;
- the union is gathered, and factorised, a block of lanes at a time, so
  that its (lanes, m + S, S) copy stays under ``_GATHER_ELEMS`` values;
- the residual is y - A x with x scattered over all n columns, the same
  sum as the oracle's over the k support columns, in another order.

Plain torch only: it imports nothing of the program and forms no Gram.
``precision="float64"`` is the reference; ``"bfloat16"`` is the control,
every stored value rounded to bf16 and every product summed in fp32 from
bf16 operands, as a bf16 tensor-core product does. The certificate is
OMP's, ||y - A x||_2 (``reference/omp.py``), which the facade reports.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from perfbench.reference import omp as _omp
from perfbench.reference.omp import PRECISIONS, certificate  # noqa: F401

CONFIG = Path(__file__).resolve().parent.parent / "configs" / (
    "cosamp-4096x8192.json")
K_SPARSITY = int(json.loads(CONFIG.read_text())["options"]["k_sparsity"])
# values of the gathered, augmented union formed at once
_GATHER_ELEMS = 1 << 26


def solve(A: torch.Tensor, Y: torch.Tensor, tol: float, max_iterations: int,
          precision: str = "float64"):
    """Solve every row of Y (b, m) against A (m, n) at the configuration's
    sparsity.

    Returns (X (b, n), rounds (b,), rnorm (b,)), X and rnorm in the
    compute dtype: ||y - A x||_2 as the loop last computed it."""
    return solve_sparsity(A, Y, K_SPARSITY, tol, max_iterations,
                          precision)[:3]


def solve_sparsity(A: torch.Tensor, Y: torch.Tensor, k: int, tol: float,
                   max_iterations: int, precision: str = "float64"):
    """``solve`` at sparsity ``k``: (X, rounds, rnorm), and each lane's
    support (b, k) in the order of its last prune, n at empty slots."""
    dtype, rnd = _omp._rounding(precision)
    with _omp._no_tf32():
        return _solve(rnd(A.to(dtype)), rnd(Y.to(dtype)), int(k),
                      float(tol), max_iterations, rnd)


def _descending(scores: torch.Tensor, count: int) -> torch.Tensor:
    """The positions of the ``count`` largest scores of each row, largest
    first, the lower position first among equal values."""
    return torch.sort(scores, dim=1, descending=True,
                      stable=True).indices[:, :count]


def _fit(AT, Y, omega, rnd):
    """The least-squares coefficients (l, S) of each row of Y (l, m) on
    its columns ``omega`` (l, S) of A (AT: A^T with a zero row at n, the
    empty slot), by a QR of the gathered columns, a block of lanes at a
    time."""
    l, S = omega.shape
    m = Y.shape[1]
    n = AT.shape[0] - 1
    coef = Y.new_empty((l, S))
    lanes = max(1, _GATHER_ELEMS // (S * (m + S)))
    for l0 in range(0, l, lanes):
        om = omega[l0:l0 + lanes]
        # (lanes, m + S, S): the columns, and a unit row for each empty slot
        B = torch.cat([AT[om].transpose(1, 2),
                       torch.diag_embed((om == n).to(Y.dtype))], dim=1)
        Q, R = torch.linalg.qr(B)
        del B
        qty = rnd(Q[:, :m].transpose(1, 2) @ Y[l0:l0 + lanes, :, None])
        coef[l0:l0 + lanes] = rnd(torch.linalg.solve_triangular(
            rnd(R), qty, upper=True)[..., 0])
        del Q, R
    return coef


def _solve(A, Y, k, tol, max_iterations, rnd):
    b, m = Y.shape
    n = A.shape[1]
    k2 = min(2 * k, n - k, m - k)
    dev, dtype = A.device, A.dtype
    AT = torch.cat([A.T, A.new_zeros((1, m))])

    supp = torch.full((b, k), n, dtype=torch.long, device=dev)
    vals = torch.zeros((b, k), dtype=dtype, device=dev)
    R = Y.clone()
    rss = rnd((Y * Y).sum(dim=1))
    it = torch.zeros(b, dtype=torch.long, device=dev)
    stopped = torch.zeros(b, dtype=torch.bool, device=dev)

    while True:
        live = ~stopped & (it < max_iterations) & (rss > tol * tol)
        L = live.nonzero()[:, 0]
        if not L.numel():
            break
        # the k2 largest inactive |A^T r|
        active = torch.zeros((len(L), n + 1), dtype=torch.bool, device=dev)
        active.scatter_(1, supp[L], True)
        score = rnd(R[L] @ A).abs().masked_fill(active[:, :n], -torch.inf)
        omega = torch.cat([supp[L], _descending(score, k2)], dim=1)
        coef = _fit(AT, Y[L], omega, rnd)
        # the prune to the k largest |b|
        pos = _descending(coef.abs(), k)
        supp2, vals2 = omega.gather(1, pos), coef.gather(1, pos)
        X2 = torch.zeros((len(L), n + 1), dtype=dtype, device=dev)
        X2.scatter_(1, supp2, vals2)
        R2 = rnd(Y[L] - rnd(X2[:, :n] @ A.T))
        rss2 = rnd((R2 * R2).sum(dim=1))
        # a stall or a non-finite round: the previous iterate stands
        ok = torch.isfinite(rss2) & (rss2 < rss[L])
        stopped[L[~ok]] = True
        L = L[ok]
        supp[L], vals[L], R[L], rss[L] = supp2[ok], vals2[ok], R2[ok], rss2[ok]
        it[L] += 1

    X = torch.zeros((b, n + 1), dtype=dtype, device=dev)
    X.scatter_(1, supp, vals)
    return X[:, :n], it, rss.clamp_min(0).sqrt(), supp
