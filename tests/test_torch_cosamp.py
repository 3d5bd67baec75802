"""The PyTorch port's CoSaMP (``solvers/cosamp.py`` and ``api.Cosamp``)
against the JAX package's and the independent dense-lstsq NumPy oracle
(``oracle/cosamp.py``), on the CPU: every case of ``tests/test_cosamp.py``
that runs without a mesh, plus a lane whose union Cholesky fails beside a
lane that continues, ties planted in |c| and |b|, and a frozen lane held
bit for bit while another runs on.

Tolerances: against the oracle, round counts exact and x within 1e-3
(float32) or 1e-8 (float64), the JAX test's; against JAX, round counts
exact and x within 1e-5 (float32) or 1e-10 (float64), the solution errors
within the same; planted ties and failed factors exactly equal. JAX runs
at its default precision "highest", as the port does.
"""

import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

import sparse_solvers_tpu as ss
import sparse_solvers_tpu_torch as pt
from sparse_solvers_tpu.oracle import cosamp as oracle
from sparse_solvers_tpu_torch.ops import blas
from sparse_solvers_tpu_torch.ops import dispatch
from sparse_solvers_tpu_torch.solvers import cosamp as PC

JAX_ATOL = {np.float32: 1e-5, np.float64: 1e-10}


def _problem(m, n, k, seed=0, dtype=np.float32, signed=True):
    """tests/test_cosamp.py's ensemble: unit-norm gaussian columns and a
    k-sparse truth with |x| in [0.5, 1)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n).astype(dtype)
    A /= np.linalg.norm(A, axis=0)
    x = np.zeros(n, dtype)
    sup = rng.choice(n, k, replace=False)
    amp = rng.uniform(0.5, 1.0, k)
    if signed:
        amp = amp * rng.choice([-1.0, 1.0], k)
    x[sup] = amp.astype(dtype)
    return A, x, (A @ x).astype(dtype)


def _both(A, k, y, tol, max_it, **kw):
    """(port x, port report, JAX x, JAX report) of one solve."""
    x, rep = pt.Cosamp(A, k, device="cpu", **kw).solve(y, tol, max_it)
    xj, repj = ss.Cosamp(A, k, **kw).solve(y, tolerance=tol,
                                            max_iterations=max_it)
    return x.numpy(), rep, np.asarray(xj), repj


@pytest.mark.parametrize("m,n,k,dtype", [
    (64, 160, 8, np.float32),
    (100, 300, 12, np.float32),
    (96, 48, 5, np.float32),          # overdetermined
    (64, 160, 8, np.float64),
])
def test_oracle_parity(m, n, k, dtype):
    """The oracle's round count, support and solution, and JAX's."""
    A, x_true, y = _problem(m, n, k, seed=m + n, dtype=dtype)
    tol = 1e-4 if dtype == np.float32 else 1e-8
    xo, ito, erro, so = oracle.solve(A, y, k, tol, 20)
    x, rep, xj, repj = _both(A, k, y, tol, 20)
    assert isinstance(rep, pt.OmpReport)
    assert x.dtype == dtype
    assert rep.iter == ito == repj.iter
    np.testing.assert_allclose(x, xo, atol=1e-3 if dtype == np.float32
                               else 1e-8)
    np.testing.assert_allclose(x, xj, atol=JAX_ATOL[dtype])
    assert abs(rep.solution_error - repj.solution_error) <= JAX_ATOL[dtype]
    got = sorted(np.flatnonzero(np.abs(x) > 10 * tol).tolist())
    assert got == so == sorted(np.flatnonzero(x_true).tolist())
    assert rep.solution_error <= tol


def test_support_replacement_beats_omp_on_coherent_column():
    """A decoy column almost along y: CoSaMP's prune evicts it once the
    true atoms explain y better."""
    rng = np.random.RandomState(42)
    m, n, k = 48, 120, 4
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    sup = np.array([10, 30, 50, 70])
    x_true = np.zeros(n, np.float32)
    x_true[sup] = np.array([1.0, 0.9, 0.8, 0.7], np.float32)
    y = A @ x_true
    decoy = y + 0.15 * rng.randn(m).astype(np.float32)
    A[:, 0] = (decoy / np.linalg.norm(decoy)).astype(np.float32)
    y = A @ x_true
    x, rep, xj, repj = _both(A, k, y, 1e-4, 30)
    got = set(np.flatnonzero(np.abs(x) > 1e-2).tolist())
    assert got == set(sup.tolist()), got
    assert rep.solution_error <= 1e-4
    assert rep.iter == repj.iter
    np.testing.assert_allclose(x, xj, atol=1e-5)


def test_batch_matches_single_jax_and_on_device():
    """solve_batch against single solves (1e-5, the JAX test's) and
    against JAX's vmapped batch; the *_on_device entries give the same
    tensors; no hand kernel launches."""
    A, _, _ = _problem(64, 160, 6, seed=3)
    Y = np.stack([_problem(64, 160, 6, seed=s)[2] for s in range(4)])
    solver = pt.Cosamp(A, 6, device="cpu")
    dispatch.reset_launches()
    X, reps = solver.solve_batch(Y, tolerance=1e-4)
    assert not any(dispatch.launches.values())
    assert reps.iter.dtype == torch.int32 and X.shape == (4, 160)
    for b in range(4):
        xb, repb = solver.solve(Y[b], tolerance=1e-4)
        assert int(reps.iter[b]) == repb.iter
        np.testing.assert_allclose(X[b].numpy(), xb.numpy(), atol=1e-5)
    Xj, repj = ss.Cosamp(A, 6).solve_batch(Y, tolerance=1e-4)
    np.testing.assert_array_equal(reps.iter.numpy(), np.asarray(repj.iter))
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), atol=1e-5)
    X2, r2 = solver.solve_batch_on_device(torch.from_numpy(Y), 1e-4)
    assert torch.equal(X2, X) and torch.equal(r2.iter, reps.iter)
    x1, r1 = solver.solve_on_device(torch.from_numpy(Y[2]), 1e-4)
    assert r1.iter.dim() == 0
    assert torch.equal(x1, solver.solve(Y[2], tolerance=1e-4)[0])


def test_stall_keeps_previous_iterate():
    """Noise below the tolerance floor: the residual stalls at its LS
    optimum and the solve stops with a finite iterate and an honest error
    above tol. Against JAX: the stall's last rounds move ‖r‖ by about one
    float32 ulp, so whether the last of them commits is set by summation
    order (the rss rounding floor of ROADMAP.md Queue 3): round counts
    within one, x within 1e-5, the errors within 1e-6 of each other."""
    rng = np.random.RandomState(9)
    A, x_true, y = _problem(64, 160, 6, seed=9)
    y = y + 0.05 * rng.randn(64).astype(np.float32)
    x, rep, xj, repj = _both(A, 6, y, 1e-6, 25)
    assert np.all(np.isfinite(x))
    assert rep.iter <= 25 and rep.solution_error > 1e-6
    got = set(np.flatnonzero(np.abs(x) > 1e-1).tolist())
    assert got == set(np.flatnonzero(x_true).tolist())
    assert abs(rep.iter - int(repj.iter)) <= 1
    np.testing.assert_allclose(x, xj, atol=1e-5)
    assert abs(rep.solution_error - repj.solution_error) <= 1e-6


@pytest.mark.parametrize("args,kw", [
    ((0,), {}), ((9,), {}), ((2.0,), {}), ((2,), {"engine": "native"}),
    ((2,), {"precision": "certified"}),
], ids=["k0", "k9", "kfloat", "native", "certified"])
def test_validation_matches_jax(args, kw):
    """Rejected as JAX rejects them, with JAX's messages."""
    A = np.eye(8, dtype=np.float32)
    with pytest.raises(ValueError) as mine:
        pt.Cosamp(A, *args, device="cpu", **kw)
    with pytest.raises(ValueError) as theirs:
        ss.Cosamp(A, *args, **kw)
    assert str(mine.value) == str(theirs.value)


def test_explain_and_remaining_errors():
    A = np.eye(8, dtype=np.float32)
    with pytest.raises(ValueError, match="max_iterations must be >= 1"):
        pt.Cosamp(A, 2, device="cpu").solve(np.zeros(8, np.float32),
                                             max_iterations=0)
    # mesh= is ported: what is not a Mesh is refused, as JAX refuses what
    # is not a jax.sharding.Mesh
    with pytest.raises(ValueError, match="mesh must be a .*Mesh"):
        pt.Cosamp(A, 2, mesh=object(), device="cpu")
    plan = pt.Cosamp(A, 2, device="cpu").explain(batch=4)
    want = ss.Cosamp(A, 2).explain(batch=4)
    for key in ("mode", "precision", "k_sparsity", "union_capacity"):
        assert plan[key] == want[key], key
    assert plan["union_capacity"] == 6 and "CoSaMP" in plan["formulation"]
    assert plan["engine"] == "torch" and plan["kernels"] == {}
    # the pool clamp at 3k > m: k2 = m − k
    assert pt.Cosamp(np.ones((20, 60), np.float32), 8,
                     device="cpu").explain()["union_capacity"] == 20


def test_identity_smoke():
    """A = I recovers a one-hot exactly in one round."""
    I = np.eye(6, dtype=np.float32)
    sig = np.zeros(6, np.float32)
    sig[3] = 1.0
    x, rep = pt.Cosamp(I, 1, device="cpu").solve(sig, tolerance=0.1)
    assert rep.iter == 1
    assert rep.solution_error <= 1e-6
    np.testing.assert_allclose(x.numpy(), sig, atol=1e-7)


def test_union_pool_clamped_when_3k_exceeds_m():
    """3k > m: the clamp k2 = min(2k, n − k, m − k) keeps the union LS
    overdetermined; the port, the oracle and JAX agree and iterate."""
    rng = np.random.RandomState(11)
    m, n, k = 48, 120, 18
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    x0 = np.zeros(n, np.float32)
    x0[rng.choice(n, k, replace=False)] = rng.uniform(0.5, 1, k)
    y = A @ x0
    xo, ito, erro, so = oracle.solve(A, y, k, 1e-3, 30)
    x, rep, xj, repj = _both(A, k, y, 1e-3, 30)
    assert rep.iter == ito == repj.iter and rep.iter >= 1
    np.testing.assert_allclose(float(rep.solution_error), erro,
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(x, xo, atol=2e-3)
    np.testing.assert_allclose(x, xj, atol=1e-4)


def test_k_equal_min_dim_rejected():
    I = np.eye(8, dtype=np.float32)
    with pytest.raises(ValueError, match="k_sparsity must be <"):
        pt.Cosamp(I, 8, device="cpu")


def _zero_column_problem():
    """A 12x16 matrix: column 0 is zero, columns 1-12 the identity, 13-15
    unit vectors on rows 6-11. k=2, so k2 = 4. Lane 0 is e₀: one column
    correlates, the ties at 0 take the lowest indices, the zero column
    joins the union and its Gram is singular. Lane 1 lies on rows 6-11,
    where at least 4 inactive columns always correlate, so the zero
    column never joins."""
    rng = np.random.RandomState(5)
    A = np.zeros((12, 16))
    A[:, 1:13] = np.eye(12)
    A[6:, 13:] = rng.randn(6, 3)
    A[:, 13:] /= np.linalg.norm(A[:, 13:], axis=0)
    Y = np.stack([np.eye(12)[0], 0.8 * A[:, 13] + 0.6 * A[:, 14]])
    return A, Y


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_failed_union_cholesky_stops_where_jax_stops(dtype):
    """cholesky_ex leaves a finite partial factor where jnp.linalg.
    cholesky gives NaNs: its info must fail the round. Lane 0 stops
    after 0 rounds with x = 0 and ‖y‖ as its error, as JAX's lane does;
    lane 1 continues to the tolerance."""
    A, Y = _zero_column_problem()
    A, Y = A.astype(dtype), Y.astype(dtype)
    tol = 1e-5 if dtype == np.float32 else 1e-10
    X, rep = pt.Cosamp(A, 2, device="cpu").solve_batch(Y, tol, 20)
    Xj, repj = ss.Cosamp(A, 2).solve_batch(Y, tolerance=tol,
                                           max_iterations=20)
    np.testing.assert_array_equal(rep.iter.numpy(), np.asarray(repj.iter))
    assert rep.iter[0] == 0 and rep.iter[1] >= 1
    assert float(rep.solution_error[0]) == 1.0
    assert not X[0].any()
    assert rep.solution_error[1] <= tol
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj),
                               atol=JAX_ATOL[dtype])
    # the round itself: info > 0 on lane 0, a finite partial factor
    G = torch.tensor([[1.0, 0.0], [0.0, 0.0]], dtype=torch.float64)
    L, info = torch.linalg.cholesky_ex(G, check_errors=False)
    assert int(info) == 2 and torch.isfinite(L).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("perm_seed", [None, 3])
def test_planted_ties_pick_jax_indices(dtype, perm_seed):
    """A permutation matrix makes every correlation and LS coefficient
    exact: five columns tie in |c| for the pool's four places and the LS
    ties in |b| for the prune's two. Both selections take lax.top_k's
    order (descending, the lower index first), so the port picks JAX's
    columns: round 1 keeps the two lowest tied columns and round 2
    stalls."""
    n = 8
    P = np.eye(n)
    if perm_seed is not None:
        P = P[:, np.random.RandomState(perm_seed).permutation(n)]
    coef = np.array([0, 1, 1, 0, 0, 1, 1, -1.0])
    y = P @ coef
    A, y = P.astype(dtype), y.astype(dtype)
    x, rep, xj, repj = _both(A, 2, y, 1e-6, 10)
    np.testing.assert_array_equal(x, xj)
    assert rep.iter == repj.iter == 1
    assert rep.solution_error == repj.solution_error == float(
        np.sqrt(dtype(3)))
    # the two tied columns of lowest index among the five
    tied = sorted(np.flatnonzero(np.abs(A.T @ y) == 1).tolist())
    assert np.flatnonzero(x).tolist() == tied[:2]


def test_frozen_lane_bit_equal_across_further_rounds():
    """A lane that stops (here: converged in its first round) keeps its
    state bit for bit while another lane runs on: its x, round count and
    error are identical whatever the round budget past its stop."""
    A, _, _ = _problem(48, 120, 8, seed=21)
    rng = np.random.RandomState(9)
    easy = A[:, [3, 50]] @ np.array([1.0, -0.8], np.float32)
    x_hard = np.zeros(120, np.float32)
    x_hard[rng.choice(120, 8, replace=False)] = (
        rng.uniform(0.1, 1.0, 8) * rng.choice([-1, 1], 8))
    Y = np.stack([easy, (A @ x_hard).astype(np.float32)])
    At, Yt = torch.from_numpy(A), torch.from_numpy(Y)
    outs = []
    for max_it in range(1, 8):
        with blas.precision_scope("highest"):
            X, rep = PC.solve_cosamp(At, Yt, 8, 1e-5, max_it)
        outs.append((X, rep))
    X0, r0 = outs[0]
    assert int(r0.iter[0]) == 1
    hard_iters = [int(rep.iter[1]) for _, rep in outs]
    assert hard_iters[-1] > 1            # the other lane ran further
    for X, rep in outs[1:]:
        assert torch.equal(X[0], X0[0])
        assert int(rep.iter[0]) == 1
        assert torch.equal(rep.solution_error[0], r0.solution_error[0])


@pytest.mark.parametrize("precision", ["high", "default"])
def test_other_precisions_recover(precision):
    """"high" is "highest" on this hardware mapping (fp32, TF32 off), so it
    equals it bit for bit; "default" rounds the products' operands to
    bf16 and still recovers the support within a bf16-scale error."""
    A, x_true, y = _problem(64, 160, 8, seed=5)
    x, rep = pt.Cosamp(A, 8, precision=precision, device="cpu").solve(
        y, 1e-2, 20)
    xh, reph = pt.Cosamp(A, 8, device="cpu").solve(y, 1e-2, 20)
    if precision == "high":
        assert torch.equal(x, xh) and rep.iter == reph.iter
    got = set(np.flatnonzero(np.abs(x.numpy()) > 0.1).tolist())
    assert got == set(np.flatnonzero(x_true).tolist())
    assert np.abs(x.numpy() - x_true).max() <= 2e-2
