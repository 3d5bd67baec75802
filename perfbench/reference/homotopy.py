"""Plain reference of the Homotopy solver, batched over lanes.

The algorithm of the upstream C++ solver (src/solvers/homotopy-cpu.cpp:
186-275) as a NumPy oracle states it, step for step: the first support
member is the largest |A^T y|, the first direction takes the sign of the
norm (+1), the step is the smallest positive breakpoint with the leftmost
index on ties, a toggled member is inserted or removed, and after each
step the correlation c = A^T (y - A x) is recomputed from scratch and the
direction solved afresh from the active Gram A_S^T A_S. A lane stops once
its support empties, max_iterations is reached or ||c||_inf <= tol.

Plain torch only: it imports nothing of the program, forms no Gram of all
of A, and keeps no state between steps but x, c, the support and the
direction. ``precision="float64"`` is the reference; ``"bfloat16"`` is the
control, every stored value rounded to bf16 and every product summed in
fp32 from bf16 operands, as a bf16 tensor-core product does.
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("float64", "bfloat16")


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _rounding(precision: str):
    """(compute dtype, rounding of every stored value)."""
    if precision == "float64":
        return torch.float64, lambda t: t
    if precision == "bfloat16":
        return torch.float32, lambda t: t.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"precision must be one of {PRECISIONS}: {precision!r}")


def _sign_deadzone(v: torch.Tensor, tol: float) -> torch.Tensor:
    return (v > tol).to(v.dtype) - (v < -tol).to(v.dtype)


def certificate(A: torch.Tensor, Y: torch.Tensor,
                X: torch.Tensor) -> torch.Tensor:
    """||A^T (y - A x)||_inf of every row of X (b, n) against Y (b, m),
    in the dtype of the arguments: the certificate the configuration
    guarantees and the facade reports."""
    with _no_tf32():
        return ((Y - X @ A.T) @ A).abs().amax(dim=1)


def solve(A: torch.Tensor, Y: torch.Tensor, tol: float, max_iterations: int,
          precision: str = "float64"):
    """Solve every row of Y (b, m) against A (m, n).

    Returns (X (b, n), iterations (b,), c_inf (b,)), X and c_inf in the
    compute dtype: ||A^T (y - A x)||_inf as the loop last computed it."""
    dtype, rnd = _rounding(precision)
    with _no_tf32():
        return _solve(rnd(A.to(dtype)), rnd(Y.to(dtype)), float(tol),
                      max_iterations, rnd)


def _solve(A, Y, tol, max_iterations, rnd):
    b, m = Y.shape
    n = A.shape[1]
    K = min(n, max_iterations + 1)     # a step adds at most one member
    dev, dtype = A.device, A.dtype
    lanes = torch.arange(b, device=dev)
    # A^T with a zero row at n: slot index n is an empty slot
    AT = torch.cat([A.T, A.new_zeros((1, m))])

    x = torch.zeros((b, n), dtype=dtype, device=dev)
    c = rnd(Y @ A)
    idx0 = c.abs().argmax(dim=1)
    c_inf = c.abs()[lanes, idx0]
    mask = torch.zeros((b, n), dtype=torch.bool, device=dev)
    mask[lanes, idx0] = True
    slots = torch.full((b, K), n, dtype=torch.long, device=dev)
    slots[:, 0] = idx0
    d = torch.zeros_like(x)
    d[lanes, idx0] = rnd(_sign_deadzone(c_inf, tol)
                         / rnd((AT[idx0] * AT[idx0]).sum(dim=1)))
    it = torch.zeros(b, dtype=torch.long, device=dev)
    live = torch.ones(b, dtype=torch.bool, device=dev)
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    big = torch.tensor(torch.finfo(dtype).max, dtype=dtype, device=dev)

    while bool(live.any()):
        it = it + live.long()
        # the step: the smallest positive breakpoint, leftmost on ties
        q = rnd(rnd(d @ A.T) @ A)
        t_act = torch.where(mask, -x / d, inf)
        dl, dr = 1 - q, 1 + q
        t_in = torch.minimum(
            torch.where((dl != 0), (c_inf[:, None] - c) / dl, inf),
            torch.where((dr != 0), (c_inf[:, None] + c) / dr, inf))
        t = torch.where(mask, t_act, t_in)
        t = torch.where(t > 0, t, inf)                   # NaN fails t > 0
        idx = t.argmin(dim=1)                            # the first minimum
        gamma = t[lanes, idx]
        none = torch.isinf(gamma)
        gamma = rnd(torch.where(none, big, gamma))
        idx = torch.where(none, torch.zeros_like(idx), idx)

        # toggle idx in the live lanes
        was = mask[lanes, idx]
        mask[lanes, idx] = torch.where(live, ~was, was)
        at = slots == idx[:, None]
        free = (slots == n).long().argmax(dim=1)
        slots = torch.where(live[:, None] & was[:, None] & at,
                            torch.full_like(slots, n), slots)
        ins = live & ~was
        slots[lanes[ins], free[ins]] = idx[ins]
        empty = ~mask.any(dim=1)
        step = live & ~empty

        x = torch.where(step[:, None], rnd(x + gamma[:, None] * d), x)
        c_new = rnd(rnd(Y - rnd(x @ A.T)) @ A)
        c = torch.where(step[:, None], c_new, c)
        # the direction: solve A_S^T A_S d_S = sign(c_S) over the slots in
        # use, empty slots held at d = 0 by a unit diagonal
        valid = slots < n
        w = int(valid.any(dim=0).nonzero().max()) + 1 if bool(
            valid.any()) else 1
        used, ok = slots[:, :w], valid[:, :w]
        AS = AT[used]                                     # (b, w, m)
        G = rnd(AS @ AS.transpose(1, 2)) + torch.diag_embed((~ok).to(dtype))
        cs = torch.where(ok, _sign_deadzone(
            c.gather(1, used.clamp(max=n - 1)), tol), 0)
        dS = rnd(torch.linalg.solve_ex(G, cs.unsqueeze(-1))[0].squeeze(-1))
        d_new = torch.zeros((b, n + 1), dtype=dtype, device=dev)
        d_new.scatter_(1, used, dS)
        d = torch.where(step[:, None], d_new[:, :n], d)
        c_inf = torch.where(step, c.abs().amax(dim=1), c_inf)
        live = step & (it < max_iterations) & (c_inf > tol)
    return x, it, c_inf
