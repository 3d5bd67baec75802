"""The batched plain reference against a loop, step for step, at a tiny
size; and its bf16 control far from it."""

import numpy as np
import pytest
import torch

from perfbench.reference import homotopy


def _deadzone(v, tol):
    return np.where(v > tol, 1.0, np.where(v < -tol, -1.0, 0.0))


def loop_solve(A, y, tol, max_iterations):
    """One lane in float64, a Python loop over the columns: the upstream
    solver's algorithm as its NumPy oracle writes it (the active Gram
    inverted afresh each step)."""
    m, n = A.shape
    x = np.zeros(n)
    mask = np.zeros(n, dtype=bool)
    c = A.T @ y
    idx0 = int(np.argmax(np.abs(c)))
    c_inf = abs(c[idx0])
    mask[idx0] = True
    direction = np.zeros(n)
    direction[idx0] = _deadzone(c_inf, tol) / (A[:, idx0] @ A[:, idx0])
    it = 0
    while True:
        it += 1
        q = A.T @ (A @ direction)
        best, idx = np.finfo(np.float64).max, 0
        for i in range(n):
            prev = best
            with np.errstate(divide="ignore", invalid="ignore"):
                if mask[i]:
                    ts = [-x[i] / direction[i]]
                else:
                    ts = [(c_inf - c[i]) / (1 - q[i]) if q[i] != 1 else -1,
                          (c_inf + c[i]) / (1 + q[i]) if q[i] != -1 else -1]
            for t in ts:
                if t > 0 and t < best:
                    best = t
            if prev > best:
                idx = i
        mask[idx] = ~mask[idx]
        if not mask.any():
            break
        As = A[:, mask]
        inv = np.linalg.inv(As.T @ As)
        x = x + best * direction
        c = A.T @ (y - A @ x)
        direction = np.zeros(n)
        direction[mask] = inv @ _deadzone(c[mask], tol)
        c_inf = np.max(np.abs(c))
        if not (it < max_iterations and c_inf > tol):
            break
    return x, it, c_inf


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(4)
    m, n, b = 48, 160, 6
    A = rng.randn(m, n)
    A /= np.linalg.norm(A, axis=0)
    X = np.zeros((b, n))
    for i, k in enumerate((1, 2, 3, 4, 6, 8)):
        X[i, rng.choice(n, k, replace=False)] = rng.uniform(0.5, 1.0, k)
    Y = X @ A.T
    return (torch.from_numpy(A.astype(np.float32)),
            torch.from_numpy(Y.astype(np.float32)), X)


@pytest.mark.parametrize("tol, iters", [(1e-2, 40), (1e-6, 40), (1e-2, 3)])
def test_batched_reference_is_the_loop(problem, tol, iters):
    A, Y, _ = problem
    X, it, c_inf = homotopy.solve(A, Y, tol, iters)
    assert X.dtype == torch.float64
    for lane in range(Y.shape[0]):
        x, k, c = loop_solve(A.double().numpy(), Y[lane].double().numpy(),
                             tol, iters)
        assert int(it[lane]) == k
        assert np.abs(X[lane].numpy() - x).max() <= 1e-10
        assert float(c_inf[lane]) == pytest.approx(c, rel=1e-8, abs=1e-12)


def test_reference_recovers_the_planted_signals(problem):
    A, Y, X0 = problem
    X, _, c_inf = homotopy.solve(A, Y, 1e-6, 40)
    assert bool((c_inf <= 1e-6).all())
    assert np.abs(X.numpy() - X0).max() < 1e-4


def test_control_is_bf16(problem):
    A, Y, _ = problem
    X, _, _ = homotopy.solve(A, Y, 1e-2, 40)
    Xc, _, _ = homotopy.solve(A, Y, 1e-2, 40, "bfloat16")
    assert Xc.dtype == torch.float32
    gap = (Xc.double() - X).abs().max()
    assert 1e-4 < float(gap)
    with pytest.raises(ValueError):
        homotopy.solve(A, Y, 1e-2, 40, "float16")
