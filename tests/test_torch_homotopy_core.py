"""The PyTorch port's per-lane Homotopy core (``solvers/homotopy.py``)
against the JAX package's ``solve_homotopy_core`` under ``jax.vmap`` and
against the float64 NumPy oracle, on the CPU.

Trajectories are compared step for step only where the arithmetic allows
it: float32 at "highest" on well-conditioned ensembles (equal iterations,
X within 1e-5) and float64 (equal iterations, X within 1e-10).
"""

import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

import jax
import jax.numpy as jnp
from _torch_cases import compressive_problem
from sparse_solvers_tpu.ops import blas as jblas
from sparse_solvers_tpu.ops.operators import DenseOperator as JOp
from sparse_solvers_tpu.oracle import homotopy as oracle_homotopy
from sparse_solvers_tpu.solvers import homotopy as JH
from sparse_solvers_tpu_torch.ops import blas
from sparse_solvers_tpu_torch.ops.operators import DenseOperator
from sparse_solvers_tpu_torch.solvers import homotopy as PH


def _both(A, Y, tol, max_it, k_max, with_g=False, **kw):
    """(JAX vmapped core, port core) at "highest" on the same inputs."""
    n = A.shape[1]
    G = A.T @ A if with_g else None

    def jcore(y):
        op = JOp(jnp.asarray(A), None if G is None else jnp.asarray(G))
        return JH.solve_homotopy_core(op, n, y, tol, max_it, k_max, **kw)

    with jblas.precision_scope("highest"):
        jout = jax.vmap(jcore)(jnp.asarray(Y))
    op = DenseOperator(torch.from_numpy(A),
                       None if G is None else torch.from_numpy(G))
    with blas.precision_scope("highest"):
        pout = PH.solve_homotopy_core(op, n, torch.from_numpy(Y), tol,
                                      max_it, k_max, **kw)
    return jout, pout


FAST_VARIANTS = {
    "dense_q": dict(sparse_matvec=False),
    "sparse_q": dict(sparse_matvec=True),
    "sparse_q_gram": dict(sparse_matvec=True, with_g=True),
    "gram_gather": dict(sparse_matvec=False, with_g=True),
    "use_gk": dict(sparse_matvec=True, with_g=True, use_gk=True),
}


@pytest.mark.parametrize("variant", sorted(FAST_VARIANTS))
def test_fast_f32_highest_matches_jax_core(variant):
    A, Y, _ = compressive_problem(64, 160, 6, 4, seed=4)
    (xj, rj), (xp, rp) = _both(A, Y, 1e-4, 40, 30, mode="fast",
                               **FAST_VARIANTS[variant])
    np.testing.assert_array_equal(rp.iter.numpy(), np.asarray(rj.iter))
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-5)
    np.testing.assert_allclose(rp.solution_error.numpy(),
                               np.asarray(rj.solution_error), atol=1e-5)


def test_exact_f32_highest_matches_jax_core():
    A, Y, _ = compressive_problem(64, 160, 6, 4, seed=4)
    (xj, rj), (xp, rp) = _both(A, Y, 1e-4, 40, 41, mode="exact")
    np.testing.assert_array_equal(rp.iter.numpy(), np.asarray(rj.iter))
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-5)


@pytest.mark.parametrize("mode,sparse", [("fast", False), ("fast", True),
                                         ("exact", False)])
def test_float64_matches_jax_core(mode, sparse):
    """float64 on signed signals, one lane's path with removals (18
    iterations for 8 columns): equal iterations, X within 1e-10."""
    rng = np.random.RandomState(2)
    m, n, k, b = 40, 90, 8, 3
    A = rng.randn(m, n)
    A /= np.linalg.norm(A, axis=0)
    X = np.zeros((b, n))
    for lane in range(b):
        X[lane, rng.choice(n, k, replace=False)] = rng.randn(k)
    Y = X @ A.T
    (xj, rj), (xp, rp) = _both(A, Y, 1e-9, 60, 61, mode=mode,
                               sparse_matvec=sparse)
    assert xp.dtype == torch.float64
    np.testing.assert_array_equal(rp.iter.numpy(), np.asarray(rj.iter))
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-10)


def test_record_path_and_compact_match_jax_core():
    A, Y, _ = compressive_problem(48, 96, 4, 3, seed=2)
    A, Y = A.astype(np.float64), Y.astype(np.float64)
    (xj, rj, hj), (xp, rp, hp) = _both(A, Y, 1e-8, 30, 31, mode="fast",
                                       record_path=True)
    np.testing.assert_array_equal(rp.iter.numpy(), np.asarray(rj.iter))
    for got, want in zip(hp, hj):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10)
    ((vj, ij), _), ((vp, ip), _) = _both(A, Y, 1e-8, 30, 31, mode="fast",
                                         compact=True)
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    np.testing.assert_allclose(vp.numpy(), np.asarray(vj), atol=1e-10)


def test_float64_oracle_sweep():
    """Both modes reproduce the float64 NumPy oracle's iteration count and
    solution_error over random problems (test_oracle_parity.py:76-100)."""
    for seed in range(8):
        rng = np.random.RandomState(seed)
        m, n = rng.randint(20, 60), rng.randint(20, 80)
        k = rng.randint(1, 6)
        A = rng.randn(m, n)
        A /= np.linalg.norm(A, axis=0)
        xt = np.zeros(n)
        xt[rng.choice(n, k, replace=False)] = rng.uniform(0.5, 1, k)
        y = A @ xt
        xo, ito, erro = oracle_homotopy.solve(A, y, 0.01, 100)
        for mode in ("exact", "fast"):
            with blas.precision_scope("highest"):
                x, rep = PH.solve_homotopy(
                    torch.from_numpy(A), torch.from_numpy(y)[None], 0.01,
                    100, min(n, 101), mode=mode)
            assert int(rep.iter[0]) == ito, (seed, mode)
            np.testing.assert_allclose(float(rep.solution_error[0]), erro,
                                       rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(x[0].numpy(), xo, atol=1e-9)


def test_k_max_overflow_breaks_cleanly():
    """A user-shrunk capacity ends the path at the capacity instead of
    writing past it (test_solvers.py:238)."""
    rng = np.random.RandomState(0)
    m, n = 30, 60
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    xt = np.zeros(n, np.float32)
    xt[rng.choice(n, 10, replace=False)] = 1.0
    y = A @ xt
    for mode in ("fast", "exact"):
        x, rep = PH.solve_homotopy(torch.from_numpy(A),
                                   torch.from_numpy(y)[None], 0.01, 50, 4,
                                   mode=mode)
        assert int(rep.iter[0]) <= 5
        assert torch.isfinite(x).all()
        assert torch.isfinite(rep.solution_error).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_identity_smoke_is_exact(dtype):
    """A = I and a one-hot signal: one iteration, error exactly 0, x
    exact (test_util.h:27-55)."""
    A = torch.eye(5, dtype=dtype)
    for mode in ("fast", "exact"):
        x, rep = PH.solve_homotopy(A, A[2][None], 10 * torch.finfo(
            dtype).eps, 5, 6, mode=mode)
        assert rep.iter.tolist() == [1]
        assert rep.solution_error.tolist() == [0.0]
        assert torch.equal(x[0], A[2])


def test_readme_toy_problem():
    """The reference README's toy (test_oracle_parity.py:60): 10×10
    gaussian + identity, 1-sparse signal, tol 0.1 → argmax 2, sparsity
    0.9."""
    rng = np.random.RandomState(42)
    N = 10
    A = rng.normal(loc=0.025, scale=0.025, size=(N, N)) + np.identity(N)
    signal = np.zeros(N)
    signal[2] = 1
    x, rep = PH.solve_homotopy(torch.from_numpy(A.astype(np.float32)),
                               torch.from_numpy(signal.astype(np.float32))
                               [None], 0.1, 100, N)
    x = x[0].numpy()
    assert np.argmax(x) == 2
    assert 1 - np.count_nonzero(x) / N == pytest.approx(0.9)
    assert float(rep.solution_error[0]) <= 0.1


def test_frozen_lanes_keep_their_state_exactly():
    """Lanes that stop early pass through the later iterations unchanged:
    each lane of a batch equals the same signal solved alone."""
    A, Y, _ = compressive_problem(48, 96, 4, 4, seed=6)
    Y[1] = A[:, 7]                     # a one-step path beside longer ones
    op = DenseOperator(torch.from_numpy(A))
    with blas.precision_scope("highest"):
        X, rep = PH.solve_homotopy_core(op, 96, torch.from_numpy(Y), 1e-4,
                                        30, 31)
        for lane in range(4):
            x1, r1 = PH.solve_homotopy_core(op, 96,
                                            torch.from_numpy(Y[lane:lane + 1]),
                                            1e-4, 30, 31)
            assert int(r1.iter[0]) == int(rep.iter[lane])
            np.testing.assert_allclose(X[lane].numpy(), x1[0].numpy(),
                                       atol=1e-6)
    assert len(set(rep.iter.tolist())) > 1


OPERATOR_CALLS = {
    "matvec": lambda op, c: op.matvec(c["x"]),
    "rmatvec": lambda op, c: op.rmatvec(c["u"]),
    "column": lambda op, c: op.column(c["j"]),
    "matvec_sparse": lambda op, c: op.matvec_sparse(c["xs"], c["idx"]),
    "gram_column": lambda op, c: op.gram_column(c["j"]),
    "gram_gathered": lambda op, c: op.gram_gathered(c["j"], c["idx"]),
}


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("with_g", [False, True], ids=["no_gram", "gram"])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("method", sorted(OPERATOR_CALLS))
def test_operator_bf16_copy_matches_rounded_a(method, b, with_g):
    """``DenseOperator`` carrying the bf16 transposed copy of A against
    the operator without it. In the "default" scope every output lies
    within fp32 summation order of the copy-free one: |Δ| ≤ max(m, n)·eps
    of Σ|a||u| over the bf16-rounded operands (a column is exactly the
    bf16 values every product rounds it to). In "high" and "highest" the
    copy is not read and the outputs are bit-identical."""
    from sparse_solvers_tpu_torch.solvers.homotopy_batch import (
        transposed_copy)
    m, n, K = 40, 96, 7
    rng = np.random.RandomState(10 * b + with_g)
    A = torch.from_numpy(rng.randn(m, n).astype(np.float32))
    with blas.precision_scope("highest"):
        G = blas.xgemm(A, A, trans_a=True) if with_g else None
    with blas.precision_scope("default"):
        AT = transposed_copy(A)
    idx = np.stack([rng.permutation(n)[:K] for _ in range(b)])
    idx[:, -2:] = n                       # sentinel slots gather zeros
    idx = torch.from_numpy(idx.astype(np.int32))
    xs = torch.zeros(b, n)
    for lane in range(b):
        xs[lane, idx[lane, :-2].long()] = torch.from_numpy(
            rng.uniform(-1, 1, K - 2).astype(np.float32))
    case = {"x": torch.from_numpy(rng.randn(b, n).astype(np.float32)),
            "u": torch.from_numpy(rng.randn(b, m).astype(np.float32)),
            "j": torch.from_numpy(rng.choice(n, b).astype(np.int32)),
            "xs": xs, "idx": idx}
    call = OPERATOR_CALLS[method]
    plain, copied = DenseOperator(A, G), DenseOperator(A, G, AT)

    with blas.precision_scope("default"):
        want = _outputs(call(plain, case))
        got = _outputs(call(copied, case))
        if method == "column":
            want = (blas.scope_operand(want[0]),)
    # Σ|a||u| over the rounded operands, in float64
    r16 = lambda t: (t.to(torch.bfloat16).double().abs()
                     if t.is_floating_point() else t)
    A16 = r16(A)
    scale_op = DenseOperator(A16, A16.T @ A16 if with_g else None)
    with blas.precision_scope("highest"):
        scale = _outputs(call(scale_op, {k: r16(v) for k, v in case.items()}))
    eps = torch.finfo(torch.float32).eps
    for w, g, s in zip(want, got, scale):
        assert g.dtype == w.dtype and g.shape == w.shape
        if method == "column":
            assert torch.equal(g, w)
        else:
            assert ((g.double() - w.double()).abs()
                    <= max(m, n) * eps * s).all()

    for precision in ("high", "highest"):
        with blas.precision_scope(precision):
            for w, g in zip(_outputs(call(plain, case)),
                            _outputs(call(copied, case))):
                assert torch.equal(g, w)
