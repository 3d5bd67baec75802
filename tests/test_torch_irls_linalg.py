"""The PyTorch port's IRLS linear algebra against the JAX package's, on the
CPU: the explicit-reflector QR (``linalg/qr.py``) and the SPD-flagging
Cholesky (``linalg/cholesky.py``) case for case as ``tests/test_qr.py``
and ``tests/test_cholesky.py`` hold the JAX package's, plus the triangular
solves ``xtrsv``/``xtrsm`` and ``DenseOperator.gram_weighted``.

Both sides take the same seeded numpy inputs. Tolerances: the JAX tests'
own (1e-4 float32, 1e-10 float64 for the QR properties; 1e-3·n and
1e-9·n for the Cholesky products), and against the JAX results 1e-5
(float32) and 1e-12 (float64) of the value's scale, since LAPACK and XLA
sum in other orders. The SPD flag is compared exactly; a failed lane's
factor is not compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

from sparse_solvers_tpu.linalg import cholesky as jchol
from sparse_solvers_tpu.linalg.qr import QRDecomposition as JQR
from sparse_solvers_tpu.ops import blas as jblas
from sparse_solvers_tpu.ops.operators import DenseOperator as JDense
from sparse_solvers_tpu_torch.linalg.cholesky import (cholesky_solve,
                                                       cholesky_spd)
from sparse_solvers_tpu_torch.linalg.qr import QRDecomposition
from sparse_solvers_tpu_torch.ops import blas as pblas
from sparse_solvers_tpu_torch.ops.operators import DenseOperator

JAX_TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --- QR, as tests/test_qr.py -------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_qr_2x2_solve(dtype):
    A = np.array([[2, 1], [1, 3]], dtype)
    b = np.array([1, -1], dtype)
    x = QRDecomposition(_t(A)).solve(_t(b)).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(A, b), atol=1e-4)
    xj = np.asarray(JQR(jnp.asarray(A)).solve(jnp.asarray(b)))
    np.testing.assert_allclose(x, xj, atol=JAX_TOL[dtype])


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-4),
                                       (np.float64, 1e-10)])
@pytest.mark.parametrize("shape", [(4, 4), (16, 16), (32, 32), (40, 24),
                                   (64, 16)])
def test_qr_decomposition_properties(dtype, tol, shape):
    rng = np.random.RandomState(0)
    M, N = shape
    A = rng.randn(M, N).astype(dtype)
    qr = QRDecomposition(_t(A))
    Q, R = qr.q().numpy(), qr.r().numpy()
    assert Q.shape == (M, N) and R.shape == (N, N)
    np.testing.assert_allclose(R, np.triu(R), atol=tol)
    np.testing.assert_allclose(Q @ R, A, atol=tol)
    np.testing.assert_allclose(Q.T @ Q, np.eye(N), atol=tol)
    # the same reflectors as the JAX package's, so the same signs
    jqr = JQR(jnp.asarray(A))
    scale = 10 * JAX_TOL[dtype] * max(1.0, np.abs(A).max())
    np.testing.assert_allclose(qr.packed.numpy(), np.asarray(jqr.packed),
                               atol=scale)
    np.testing.assert_allclose(Q, np.asarray(jqr.q()), atol=scale)
    np.testing.assert_allclose(R, np.asarray(jqr.r()), atol=scale)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-3),
                                       (np.float64, 1e-9)])
def test_qr_least_squares_solve(dtype, tol):
    rng = np.random.RandomState(1)
    M, N = 30, 12
    A = rng.randn(M, N).astype(dtype)
    b = rng.randn(M).astype(dtype)
    x = QRDecomposition(_t(A)).solve(_t(b)).numpy()
    expect, *_ = np.linalg.lstsq(A.astype(np.float64), b.astype(np.float64),
                                 rcond=None)
    np.testing.assert_allclose(x, expect, atol=tol)
    xj = np.asarray(JQR(jnp.asarray(A)).solve(jnp.asarray(b)))
    np.testing.assert_allclose(x, xj, atol=10 * JAX_TOL[dtype])


def test_qr_underdetermined_rejected():
    with pytest.raises(ValueError, match="m >= n") as mine:
        QRDecomposition(torch.zeros((3, 5)))
    with pytest.raises(ValueError) as theirs:
        JQR(jnp.zeros((3, 5)))
    assert str(mine.value) == str(theirs.value)


# --- Cholesky, as tests/test_cholesky.py --------------------------------

@pytest.mark.parametrize("name,A", [
    ("indefinite", [[0.0, 1.0], [1.0, 0.0]]),
    ("negative_definite", [[-2.0, 0.0], [0.0, -2.0]]),
    ("singular", [[1.0, 1.0], [1.0, 1.0]]),
])
def test_cholesky_isspd_false(name, A):
    A = np.array(A, np.float32)
    _, isspd = cholesky_spd(_t(A))
    _, jspd = jchol.cholesky_spd(jnp.asarray(A))
    assert not bool(isspd)
    assert bool(isspd) == bool(jspd)


def test_cholesky_2x2():
    A = np.array([[2.0, 1.0], [1.0, 2.0]], np.float32)
    b = np.array([1.0, -1.0], np.float32)
    L, isspd = cholesky_spd(_t(A))
    assert bool(isspd)
    L = L.numpy()
    np.testing.assert_allclose(L @ L.T, A, atol=1e-4)
    x = cholesky_solve(_t(L), _t(b)).numpy()
    np.testing.assert_allclose(x, [1.0, -1.0], atol=1e-4)
    Lj, _ = jchol.cholesky_spd(jnp.asarray(A))
    np.testing.assert_allclose(L, np.asarray(Lj), atol=1e-6)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-3),
                                       (np.float64, 1e-9)])
@pytest.mark.parametrize("n", [5, 20, 100])
def test_cholesky_random_spd(dtype, tol, n):
    rng = np.random.RandomState(0)
    noise = rng.randn(n, n).astype(dtype)
    A = noise @ noise.T + n * np.eye(n, dtype=dtype)
    L, isspd = cholesky_spd(_t(A))
    assert bool(isspd)
    L = L.numpy()
    np.testing.assert_allclose(L @ L.T, A, atol=tol * n)
    b = rng.randn(n).astype(dtype)
    x = cholesky_solve(_t(L), _t(b)).numpy()
    np.testing.assert_allclose(A @ x, b, atol=tol * n)
    Lj, jspd = jchol.cholesky_spd(jnp.asarray(A))
    assert bool(jspd)
    scale = JAX_TOL[dtype] * np.abs(A).max()
    np.testing.assert_allclose(L, np.asarray(Lj), atol=scale)
    xj = jchol.cholesky_solve(Lj, jnp.asarray(b))
    np.testing.assert_allclose(x, np.asarray(xj), atol=100 * JAX_TOL[dtype])


def test_cholesky_flags_each_lane():
    """A lane axis: each lane's flag is its own, as the JAX function's is
    under vmap (SPD, singular, negative definite, a pivot below eps, a
    NaN entry)."""
    rng = np.random.RandomState(3)
    noise = rng.randn(6, 6)
    lanes = [noise @ noise.T + 6 * np.eye(6),
             np.ones((6, 6)),
             -np.eye(6),
             np.diag([1.0, 1.0, 1e-40, 1.0, 1.0, 1.0]),
             np.eye(6)]
    lanes[4][2, 3] = lanes[4][3, 2] = np.nan
    A = np.stack(lanes)
    _, isspd = cholesky_spd(_t(A))
    import jax
    _, jspd = jax.vmap(jchol.cholesky_spd)(jnp.asarray(A))
    assert isspd.tolist() == [True, False, False, False, False]
    assert isspd.tolist() == np.asarray(jspd).tolist()


# --- triangular solves and the weighted Gram -----------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("lower", [False, True])
@pytest.mark.parametrize("trans", [False, True])
def test_xtrsm_xtrsv_match_jax(dtype, lower, trans):
    rng = np.random.RandomState(4)
    n, k = 24, 5
    T = rng.randn(n, n) + 4 * np.eye(n)
    T = (np.tril(T) if lower else np.triu(T)).astype(dtype)
    B = rng.randn(n, k).astype(dtype)
    X = pblas.xtrsm(_t(T), _t(B), lower=lower, trans=trans).numpy()
    Xj = np.asarray(jblas.xtrsm(jnp.asarray(T), jnp.asarray(B),
                                lower=lower, trans=trans))
    np.testing.assert_allclose(X, Xj, atol=JAX_TOL[dtype] * 10)
    opT = T.T if trans else T
    np.testing.assert_allclose(opT @ X, B, atol=JAX_TOL[dtype] * 100)
    x = pblas.xtrsv(_t(T), _t(B[:, 0]), lower=lower, trans=trans).numpy()
    xj = np.asarray(jblas.xtrsv(jnp.asarray(T), jnp.asarray(B[:, 0]),
                                lower=lower, trans=trans))
    np.testing.assert_allclose(x, xj, atol=JAX_TOL[dtype] * 10)
    # leading axes batch: each lane its own triangle and right-hand side
    Ts = np.stack([T, 2 * T])
    Bs = np.stack([B, -B])
    Xs = pblas.xtrsm(_t(Ts), _t(Bs), lower=lower, trans=trans).numpy()
    np.testing.assert_allclose(Xs[0], X, atol=JAX_TOL[dtype])
    np.testing.assert_allclose(Xs[1], -X / 2, atol=JAX_TOL[dtype] * 10)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gram_weighted_matches_jax(dtype):
    rng = np.random.RandomState(5)
    m, n, b = 40, 16, 3
    Q = rng.randn(m, n).astype(dtype)
    W = rng.uniform(0.1, 2.0, (b, n)).astype(dtype)
    op = DenseOperator(_t(Q))
    G = op.gram_weighted(_t(W)).numpy()
    assert G.shape == (b, n, n)
    for lane in range(b):
        Gj = np.asarray(JDense(jnp.asarray(Q)).gram_weighted(
            jnp.asarray(W[lane])))
        np.testing.assert_allclose(G[lane], Gj,
                                   atol=JAX_TOL[dtype] * np.abs(Gj).max())
        np.testing.assert_allclose(
            op.gram_weighted(_t(W[lane])).numpy(), G[lane],
            atol=JAX_TOL[dtype] * np.abs(Gj).max())


def test_gram_weighted_default_rounds_operands_to_bf16():
    """At "default" both operands of Qᵀ(Q∘w) are rounded to bf16 and
    multiplied in fp32: the TPU's one-pass product (JAX on the CPU ignores
    the precision, so the reference here is numpy on rounded operands)."""
    rng = np.random.RandomState(6)
    Q = rng.randn(32, 8).astype(np.float32)
    w = rng.uniform(0.1, 2.0, (2, 8)).astype(np.float32)
    with pblas.precision_scope("default"):
        G = DenseOperator(_t(Q)).gram_weighted(_t(w)).numpy()

    def bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16).to(
            torch.float32).numpy().astype(np.float64)

    for lane in range(2):
        ref = bf16(Q).T @ bf16(Q * w[lane])
        np.testing.assert_allclose(G[lane], ref, atol=1e-5 * np.abs(ref).max())
