"""The empty-slot invariant of the Homotopy batch driver, on the CPU twins.

The CUDA K3 (``csrc/transition.cu``) reads and writes only a lane's live
block: it relies on every vacant slot (≥ kk) holding zero rows and columns
in inv and gk, zero x_act, d_act and c_act, and the sentinel in indices.
The driver keeps that through init, K3's remove (which clears slot l) and
the capacity ladder's zero-padding embed. Here ``make_stepper`` is
wrapped so that the state is checked after init and before and after
every step of ``solve_homotopy_batch``, on signed coefficients with noise
(tests/test_torch_homotopy_batch.py:188), a problem that crosses the
ladder's tiers [16, 32, 61] and removes often, at "highest" (with the
Gram and gram-free, so every source of u1 the kernel reads is held) and
through the façade at "certified" (the path at "default", then the re-solve of
any lane whose certificate misses at "high").
"""

import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

from _torch_cases import TORCH_ROUTE, vacant_nonzero
from sparse_solvers_tpu_torch import Homotopy
from sparse_solvers_tpu_torch.ops import blas as pblas
from sparse_solvers_tpu_torch.solvers import homotopy_batch as PHB

TOL, MAX_IT = 0.05, 60


def _signed_noisy_problem():
    rng = np.random.RandomState(3)
    m, n, k, B = 40, 80, 10, 12
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    Xt = np.zeros((B, n), np.float32)
    for i in range(B):
        Xt[i, rng.choice(n, k, replace=False)] = rng.randn(k)
    Y = (Xt @ A.T + 0.01 * rng.randn(B, m)).astype(np.float32)
    return A, Y


@pytest.fixture
def steps(monkeypatch):
    """Wraps ``make_stepper``; returns the list of (capacity, lanes that
    removed, lanes that inserted) of every step taken."""
    seen = []
    real = PHB.make_stepper

    def vacant_zero(s):
        state = [t.numpy() for t in (s.inv, s.gk, s.x_act, s.d_act,
                                     s.c_act, s.indices)]
        n = s.c.shape[1]
        bad = vacant_nonzero(state, s.kk.numpy(), n)
        assert bad == [], f"vacant slots not zero (lane, tensor): {bad}"

    def stepper(*args, **kwargs):
        init, body, lane_live = real(*args, **kwargs)

        def checked_init():
            s = init()
            vacant_zero(s)
            return s

        def checked_body(s):
            vacant_zero(s)
            live, kk = lane_live(s), s.kk.clone()
            s = body(s)
            vacant_zero(s)
            seen.append((s.inv.shape[1], int((live & (s.kk < kk)).sum()),
                         int((live & (s.kk > kk)).sum())))
            return s

        return checked_init, checked_body, lane_live

    monkeypatch.setattr(PHB, "make_stepper", stepper)
    return seen


def _crossed_tiers_and_removed(seen):
    assert sorted({K for K, _, _ in seen}) == [16, 32, 61]
    assert sum(r for _, r, _ in seen) >= 10
    assert sum(i for _, _, i in seen) > 0


@pytest.mark.parametrize("gram", [True, False], ids=["gram", "gram_free"])
def test_driver_keeps_vacant_slots_zero_at_highest(steps, gram):
    """With the Gram, u1 comes from ``gram_slot_gather``; gram-free, from
    ``make_gram_u1`` over the transposed copy with its zero sentinel
    row."""
    A, Y = _signed_noisy_problem()
    G = torch.from_numpy(A.T @ A) if gram else None
    with pblas.precision_scope("highest"):
        X, rep = PHB.solve_homotopy_batch(
            torch.from_numpy(A), G, torch.from_numpy(Y), TOL, MAX_IT,
            MAX_IT + 1)
    assert bool(torch.isfinite(X).all())
    _crossed_tiers_and_removed(steps)


def test_facade_keeps_vacant_slots_zero_at_certified(steps):
    A, Y = _signed_noisy_problem()
    solver = Homotopy(A, precision="certified", **TORCH_ROUTE)
    assert solver.explain(batch=len(Y), max_iterations=MAX_IT)[
        "capacity_tiers"] == [16, 32, 61]
    X, rep = solver.solve_batch(Y, TOL, MAX_IT)
    assert bool(torch.isfinite(X).all())
    assert bool(torch.isfinite(rep.solution_error).all())
    _crossed_tiers_and_removed(steps)
