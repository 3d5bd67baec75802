"""The PyTorch port's IRLS (``solvers/irls.py`` and ``api.Irls``) against the
JAX package's and the float64 NumPy oracle (``oracle/irls.py``), on the
CPU.

The JAX loop runs under ``jax.vmap``; the port steps the same lanes
together on ``device="cpu"``. Both sides start from the same factors: the
JAX package's ``jnp.linalg.qr`` of A, carried across by
``convert.irls_factor_from_numpy`` or ``Irls.from_numpy`` (QR sign
conventions differ between XLA and LAPACK, and the iteration is invariant
to them only in exact arithmetic). The façade's JAX side is built with
``engine="jax"``.

Tolerances: float64, iterations and spd flags exact, X within 1e-10 and
eps within 1e-12 relative; float32 (well-conditioned fixtures),
iterations and spd flags exact, X within 1e-4. Exact mode's Newton step
solves the weighted Gram, whose condition number grows as 1/min(w); run
to its spd failure, a final X agrees to 1e-3 (float64) only, the last
bits of the Gram's sums amplified by that conditioning, so the 1e-10
check of exact mode stops at a budget below the failure. Against the
oracle: the JAX package's own tolerances (tests/test_oracle_parity.py,
tests/test_irls_stabilized.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

import sparse_solvers_tpu as ss
import sparse_solvers_tpu_torch as pt
from _torch_cases import TORCH_ROUTE, competing_pair, cs_problem, irls_problem
from sparse_solvers_tpu.oracle import irls as oracle
from sparse_solvers_tpu.ops import blas as jblas
from sparse_solvers_tpu.solvers import irls as JI
from sparse_solvers_tpu_torch import convert
from sparse_solvers_tpu_torch.solvers import irls as PI

F32_TOL = 1e-4
F64_TOL = 1e-10


def _jax_factor(A):
    Q, R = jnp.linalg.qr(jnp.asarray(A), mode="reduced")
    Rinv = jblas.xtrsm(R, jnp.eye(A.shape[1], dtype=R.dtype), lower=False)
    return np.array(Q), np.array(R), np.array(Rinv)


def _jax_core(A, Y, tol, max_it, r_inv=False, **kw):
    Q, R, Rinv = _jax_factor(A)
    ri = jnp.asarray(Rinv) if r_inv else None
    X, rep = jax.jit(jax.vmap(lambda y: JI.solve_irls(
        jnp.asarray(Q), jnp.asarray(R), y, tol, max_it, r_inv=ri, **kw)))(
            jnp.asarray(Y))
    return (np.asarray(X), np.asarray(rep.iter), np.asarray(rep.spd_failure),
            np.asarray(rep.solution_error))


def _port_core(A, Y, tol, max_it, r_inv=False, **kw):
    Qn, Rn, Rinvn = _jax_factor(A)
    Q, R, Rinv = convert.irls_factor_from_numpy(Qn, Rn, "cpu", r_inv=Rinvn)
    X, rep = PI.solve_irls(Q, R, torch.from_numpy(Y), tol, max_it,
                           r_inv=Rinv if r_inv else None, **kw)
    return (X.numpy(), rep.iter.numpy(), rep.spd_failure.numpy(),
            rep.solution_error.numpy())


def _assert_same(mine, theirs, atol, eps_rtol):
    X, it, spd, eps = mine
    Xj, itj, spdj, epsj = theirs
    np.testing.assert_array_equal(it, itj)
    np.testing.assert_array_equal(spd, spdj)
    np.testing.assert_allclose(X, Xj, atol=atol)
    np.testing.assert_allclose(eps, epsj, rtol=eps_rtol, atol=0)


FORMS = {"fast": dict(mode="fast"), "exact": dict(mode="exact"),
         "stabilized": dict(mode="fast", stabilized=True),
         "r_inv": dict(mode="fast", r_inv=True)}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_core_float64_iteration_exact(form):
    """tests/test_batch.py's float64 ensemble (40×25, k=3, six lanes,
    tol 0.01): every form iteration-exact with X within 1e-10. Exact mode
    stops at 7 iterations, before the weights spread its Gram's
    conditioning (test_core_exact_at_the_spd_boundary runs it on)."""
    A, Y = irls_problem(40, 25, 6, 3, seed=5)
    max_it = 7 if form == "exact" else 50
    mine = _port_core(A, Y, 0.01, max_it, **FORMS[form])
    theirs = _jax_core(A, Y, 0.01, max_it, **FORMS[form])
    assert theirs[1].max() > 1
    _assert_same(mine, theirs, F64_TOL, 1e-12)


def test_core_exact_at_the_spd_boundary():
    """Exact mode run on to its spd failure (every lane): iterations and
    flags exact; X within 1e-3, the Gram's conditioning at the boundary
    (see the module docstring)."""
    A, Y = irls_problem(40, 25, 6, 3, seed=5)
    mine = _port_core(A, Y, 0.01, 50, mode="exact")
    theirs = _jax_core(A, Y, 0.01, 50, mode="exact")
    assert theirs[2].all()
    _assert_same(mine, theirs, 1e-3, 1e-12)


def _noisy_one_sparse(dtype):
    """tests/test_solvers.py's fast/exact fixture (80×40, unit columns)
    with four noisy 1-sparse signals."""
    rng = np.random.RandomState(9)
    A = rng.randn(80, 40)
    A /= np.linalg.norm(A, axis=0)
    Y = np.stack([A[:, j] + 0.01 * rng.uniform(0, 1, 80)
                  for j in (13, 2, 30, 7)])
    return A.astype(dtype), Y.astype(dtype)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("fixture", ["one_sparse", "three_sparse"])
def test_core_float32(form, fixture):
    if fixture == "one_sparse":
        A, Y = _noisy_one_sparse(np.float32)
        tol = 1e-3
    else:
        A, Y = irls_problem(40, 25, 6, 3, seed=5, dtype=np.float32)
        tol = 0.01
    mine = _port_core(A, Y, tol, 50, **FORMS[form])
    theirs = _jax_core(A, Y, tol, 50, **FORMS[form])
    _assert_same(mine, theirs, F32_TOL, 1e-5)


def test_batch_lanes_with_spd_failures_and_nan_normalization():
    """One batch, lane by lane against JAX's vmapped loop: lanes that
    spd-fail at different steps, a lane that converges, and a zero signal,
    whose x stays zero so that the final x/Σx is NaN in both packages (the
    port does not repair it)."""
    A, Y = irls_problem(40, 25, 5, 3, seed=5)
    Y = np.concatenate([Y, np.zeros((1, 40)), A[:, [4]].T])
    mine = _port_core(A, Y, 0.01, 50)
    theirs = _jax_core(A, Y, 0.01, 50)
    _assert_same(mine, theirs, F64_TOL, 1e-12)
    assert len(set(theirs[1][:5].tolist())) > 1 and theirs[2][:5].all()
    assert np.isnan(mine[0][5]).all() and not mine[2][5]
    assert mine[1][6] == 1 and not mine[2][6]


def test_spd_failure_at_the_first_step():
    """A Q with a zero column makes exact mode's first Gram singular: the
    lane breaks before committing anything, iter 0, eps 1, and x = 0/0 is
    NaN, in both packages."""
    A, Y = irls_problem(40, 25, 3, 3, seed=5)
    Q, R, _ = _jax_factor(A)
    Q[:, 3] = 0
    Xj, repj = jax.vmap(lambda y: JI.solve_irls(
        jnp.asarray(Q), jnp.asarray(R), y, 0.01, 50, mode="exact"))(
            jnp.asarray(Y))
    Qt, Rt, _ = convert.irls_factor_from_numpy(Q, R, "cpu")
    X, rep = PI.solve_irls(Qt, Rt, torch.from_numpy(Y), 0.01, 50,
                           mode="exact")
    assert rep.iter.tolist() == np.asarray(repj.iter).tolist() == [0] * 3
    assert rep.spd_failure.all() and np.asarray(repj.spd_failure).all()
    assert rep.solution_error.tolist() == [1.0] * 3
    assert torch.isnan(X).all() and np.isnan(np.asarray(Xj)).all()


def test_core_validation_matches_jax():
    A, Y = irls_problem(16, 8, 1, 2, seed=1)
    Q, R, _ = convert.irls_factor_from_numpy(*_jax_factor(A)[:2], "cpu")
    for kw in (dict(mode="slow"), dict(mode="exact", r_inv=R)):
        with pytest.raises(ValueError) as mine:
            PI.solve_irls(Q, R, torch.from_numpy(Y), 0.1, 5, **kw)
        with pytest.raises(ValueError) as theirs:
            JI.solve_irls(jnp.asarray(Q.numpy()), jnp.asarray(R.numpy()),
                          jnp.asarray(Y[0]), 0.1, 5, **kw)
        assert str(mine.value) == str(theirs.value)


# --- the façade ----------------------------------------------------------

def _pair(A, **kw):
    """(port Irls on the CPU from JAX's factors, JAX Irls)."""
    Q, R, Rinv = _jax_factor(A)
    return (pt.Irls.from_numpy(A, Q=Q, R=R, r_inv=Rinv, **TORCH_ROUTE, **kw),
            ss.Irls(A, engine="jax", **kw))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_facade_batch_matches_jax_and_sequential(dtype):
    """tests/test_batch.py's IRLS case: solve_batch against JAX's, and
    each lane against the port's own single solve (a one-column triangular
    solve and a gemv instead of a b-column one and a gemm: the last bits
    may differ, so X within the tolerance, eps within 1e-6 relative in
    float32 and 1e-12 in float64, iterations and flags exact)."""
    A, Y = irls_problem(40, 25, 6, 3, seed=5, dtype=dtype)
    mine, theirs = _pair(A)
    X, rep = mine.solve_batch(Y, tolerance=0.01, max_iterations=50)
    Xj, repj = theirs.solve_batch(Y, tolerance=0.01, max_iterations=50)
    atol = F64_TOL if dtype == np.float64 else F32_TOL
    rtol = 1e-12 if dtype == np.float64 else 1e-6
    np.testing.assert_array_equal(rep.iter.numpy(), np.asarray(repj.iter))
    np.testing.assert_array_equal(rep.spd_failure.numpy(),
                                  np.asarray(repj.spd_failure))
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), atol=atol)
    for lane in range(len(Y)):
        x, r = mine.solve(Y[lane], tolerance=0.01, max_iterations=50)
        assert r.iter == int(rep.iter[lane])
        assert r.spd_failure == bool(rep.spd_failure[lane])
        np.testing.assert_allclose(r.solution_error,
                                   float(rep.solution_error[lane]),
                                   rtol=rtol)
        np.testing.assert_allclose(x.numpy(), X[lane].numpy(), atol=atol)


@pytest.mark.parametrize("shape,k", [((40, 25), 3), ((60, 30), 5)])
def test_facade_matches_oracle(shape, k):
    """tests/test_oracle_parity.py's IRLS case, with the port's own QR
    (LAPACK, as the oracle's): iterations, the spd flag and eps as there.
    The JAX test's 1e-4 on x holds its "auto" engine (the C++ host engine
    at this size); the JAX package's jax engine lies 1.67e-4 from the
    oracle on the (60, 30) case, both loops ending at an spd failure whose
    last Newton step the oracle solves through a Gram near singularity.
    So the port is held to the oracle at 2e-4 and to the jax engine at
    1e-10."""
    rng = np.random.RandomState(11)
    m, n = shape
    A = rng.randn(m, n)
    A = A / np.abs(A).sum(axis=0)
    x_true = np.zeros(n)
    x_true[rng.choice(n, k, replace=False)] = rng.uniform(0.2, 1.0, k)
    y = A @ x_true
    xo, it_o, eps_o, spd_o = oracle.solve(A, y, 0.001, 100)
    x, rep = pt.Irls(A, **TORCH_ROUTE).solve(y, tolerance=0.001,
                                            max_iterations=100)
    assert rep.iter == it_o and rep.spd_failure == spd_o
    np.testing.assert_allclose(rep.solution_error, eps_o, atol=1e-9)
    np.testing.assert_allclose(x.numpy(), xo, atol=2e-4)
    xj, repj = _pair(A)[1].solve(y, tolerance=0.001, max_iterations=100)
    assert rep.iter == repj.iter
    np.testing.assert_allclose(x.numpy(), xj, atol=F64_TOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_smoke_identity(dtype):
    """A = I₅: every one-hot recovered exactly in one iteration with eps
    0 (tests/test_api.py's and tests/test_solvers.py's smoke)."""
    A = np.identity(5, dtype=dtype)
    solver = pt.Irls(A, **TORCH_ROUTE)
    for j in range(5):
        x, rep = solver.solve(A[j], tolerance=0.001, max_iterations=5)
        assert rep.iter == 1 and rep.solution_error == 0.0
        assert not rep.spd_failure
        np.testing.assert_array_equal(x.numpy(), A[j])
    assert hasattr(rep, "spd_failure")


def test_fast_exact_mode_parity():
    """tests/test_solvers.py::test_irls_fast_exact_mode_parity on the port:
    the collapsed step equals the dense one on a recoverable problem, and
    each equals JAX's."""
    rng = np.random.RandomState(9)
    A = rng.randn(80, 40).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    y = A[:, 13].copy()
    out = {}
    for mode in ("exact", "fast"):
        mine, theirs = _pair(A, mode=mode)
        x, r = mine.solve(y, tolerance=1e-3, max_iterations=50)
        xj, rj = theirs.solve(y, tolerance=1e-3, max_iterations=50)
        assert (r.iter, r.spd_failure) == (rj.iter, rj.spd_failure)
        np.testing.assert_allclose(x.numpy(), xj, atol=1e-5)
        out[mode] = (x.numpy(), r)
    assert out["exact"][1].iter == out["fast"][1].iter
    assert out["exact"][1].spd_failure == out["fast"][1].spd_failure
    np.testing.assert_allclose(out["exact"][0], out["fast"][0], atol=1e-5)


def test_spd_boundary_fast_vs_exact():
    """tests/test_solvers.py::test_irls_spd_boundary_parity_fast_vs_exact
    on the port: across decay scales both modes flag spd_failure at the
    same iteration with matching eps, as JAX's do."""
    rng = np.random.RandomState(0)
    A = rng.randn(60, 30).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    Q, R = np.linalg.qr(A)
    Qt, Rt, _ = convert.irls_factor_from_numpy(Q.astype(np.float32),
                                               R.astype(np.float32), "cpu")
    for decay in [1.0, 0.3, 0.1]:
        xt = np.zeros(30, np.float32)
        xt[:8] = decay ** np.arange(8)
        y = torch.from_numpy((A @ xt).astype(np.float32))[None]
        reps = {mode: PI.solve_irls(Qt, Rt, y, 1e-7, 100, mode=mode)[1]
                for mode in ("fast", "exact")}
        assert bool(reps["fast"].spd_failure) and bool(
            reps["exact"].spd_failure), decay
        assert int(reps["fast"].iter) == int(reps["exact"].iter), decay
        np.testing.assert_allclose(float(reps["fast"].solution_error),
                                   float(reps["exact"].solution_error),
                                   rtol=1e-5)


def test_gemm_newton_matches_trsm_and_jax(monkeypatch):
    """tests/test_batch.py::test_irls_batch_gemm_newton_matches_trsm on the
    port (SS_IRLS_GEMM read at each solve), and the gemm route against
    JAX's gemm route from the same R⁻¹."""
    rng = np.random.RandomState(13)
    m, n, batch, k = 60, 30, 8, 3
    A = rng.randn(m, n)
    A = A / np.abs(A).sum(axis=0)
    Y = []
    for _ in range(batch):
        x = np.zeros(n)
        x[rng.choice(n, k, replace=False)] = rng.uniform(0.2, 1.0, k)
        Y.append(A @ x)
    A, Y = A.astype(np.float32), np.stack(Y).astype(np.float32)
    mine, theirs = _pair(A)
    monkeypatch.setenv("SS_IRLS_GEMM", "1")
    assert "gemm" in mine.explain(batch=batch)["newton"]
    assert "newton" not in mine.explain()  # single solves keep the trsm
    Xg, rg = mine.solve_batch(Y, tolerance=0.01, max_iterations=50)
    Xjg, rjg = theirs.solve_batch(Y, tolerance=0.01, max_iterations=50)
    monkeypatch.setenv("SS_IRLS_GEMM", "0")
    assert "newton" not in mine.explain(batch=batch)
    Xt, rt = mine.solve_batch(Y, tolerance=0.01, max_iterations=50)
    iters = rg.iter.numpy()
    assert iters.max() > 1
    np.testing.assert_array_equal(iters, rt.iter.numpy())
    np.testing.assert_allclose(Xg.numpy(), Xt.numpy(), atol=1e-4)
    np.testing.assert_array_equal(rg.spd_failure.numpy(),
                                  rt.spd_failure.numpy())
    np.testing.assert_array_equal(iters, np.asarray(rjg.iter))
    np.testing.assert_allclose(Xg.numpy(), np.asarray(Xjg), atol=F32_TOL)


def test_gemm_newton_runs_at_highest_under_default(monkeypatch):
    """The R⁻¹ product runs at "highest" whatever the instance precision:
    under "default" the gemm and trsm routes still agree (only Qᵀy, the
    one product of the fast loop, is rounded)."""
    A, Y = irls_problem(60, 30, 8, 3, seed=13, dtype=np.float32)
    solver = pt.Irls(A, precision="default", **TORCH_ROUTE)
    monkeypatch.setenv("SS_IRLS_GEMM", "1")
    Xg, rg = solver.solve_batch(Y, tolerance=0.01, max_iterations=50)
    monkeypatch.setenv("SS_IRLS_GEMM", "0")
    Xt, rt = solver.solve_batch(Y, tolerance=0.01, max_iterations=50)
    np.testing.assert_array_equal(rg.iter.numpy(), rt.iter.numpy())
    np.testing.assert_allclose(Xg.numpy(), Xt.numpy(), atol=1e-4)


def test_precision_knob():
    """tests/test_api.py::test_irls_precision_knob on the port: "highest"
    and "high" are the same fp32 products here (TF32 off), "default"
    rounds Qᵀy's operands to bf16 and still finds the component;
    "certified" is rejected with JAX's message."""
    rng = np.random.RandomState(0)
    A = rng.randn(64, 32).astype(np.float32)
    y = (A @ np.eye(32, dtype=np.float32)[3]).astype(np.float32)
    x0, r0 = pt.Irls(A, **TORCH_ROUTE).solve(y, tolerance=0.1)
    x1, r1 = pt.Irls(A, precision="high", **TORCH_ROUTE).solve(
        y, tolerance=0.1)
    assert torch.equal(x0, x1) and r0.iter == r1.iter
    x2, _ = pt.Irls(A, precision="default", **TORCH_ROUTE).solve(
        y, tolerance=0.1)
    assert int(x2.argmax()) == int(x0.argmax()) == 3
    with pytest.raises(ValueError) as mine:
        pt.Irls(A, precision="certified", device="cpu")
    with pytest.raises(ValueError) as theirs:
        ss.Irls(A, precision="certified")
    assert str(mine.value) == str(theirs.value)


BAD_KWARGS = {
    "engine": dict(engine="gpu"),
    "mode": dict(mode="slow"),
    "precision": dict(precision="fast"),
    "stabilized_native": dict(engine="native", stabilized=True),
}


@pytest.mark.parametrize("case", sorted(BAD_KWARGS))
def test_validation_messages_match_jax(case):
    A = np.eye(8, dtype=np.float32)
    with pytest.raises(ValueError) as mine:
        pt.Irls(A, device="cpu", **BAD_KWARGS[case])
    with pytest.raises(ValueError) as theirs:
        ss.Irls(A, **BAD_KWARGS[case])
    assert str(mine.value) == str(theirs.value)


def test_underdetermined_rejected_with_jax_message():
    A = np.zeros((3, 5), np.float32)
    with pytest.raises(ValueError, match="m >= n") as mine:
        pt.Irls(A, device="cpu")
    with pytest.raises(ValueError) as theirs:
        ss.Irls(A)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("batch", [None, 4])
@pytest.mark.parametrize("stabilized", [False, True])
def test_explain_has_jax_keys(monkeypatch, batch, stabilized):
    monkeypatch.setenv("SS_IRLS_GEMM", "1")
    A = np.random.RandomState(2).randn(16, 8).astype(np.float32)
    mine = pt.Irls(A, stabilized=stabilized, **TORCH_ROUTE)
    theirs = ss.Irls(A, engine="jax", stabilized=stabilized)
    plan, jplan = mine.explain(batch=batch), theirs.explain(batch=batch)
    assert set(jplan) <= set(plan)
    for key in ("mode", "qr_cached", "newton", "stabilized", "backend"):
        assert plan.get(key) == jplan.get(key), key
    assert plan["engine"] == "torch" and plan["kernels"] == {}
    mine.solve(A @ np.eye(8, dtype=np.float32)[1], 0.1)
    assert mine.explain()["qr_cached"]


def test_empty_batch():
    A = np.random.RandomState(0).randn(16, 8).astype(np.float32)
    X, rep = pt.Irls(A, **TORCH_ROUTE).solve_batch(np.zeros((0, 16)),
                                                  tolerance=1e-3)
    Xj, repj = ss.Irls(A, engine="jax").solve_batch(
        np.zeros((0, 16), np.float32), tolerance=1e-3)
    assert tuple(X.shape) == Xj.shape == (0, 8)
    assert tuple(rep.iter.shape) == np.asarray(repj.iter).shape == (0,)
    assert rep.spd_failure.dtype == torch.bool
    assert X.dtype == torch.float32


def test_on_device_entries_and_max_iterations():
    A, Y = irls_problem(40, 25, 3, 3, seed=5, dtype=np.float32)
    solver = pt.Irls(A, **TORCH_ROUTE)
    Yt = torch.from_numpy(Y)
    X, rep = solver.solve_batch_on_device(Yt, 0.01, 30)
    Xb, repb = solver.solve_batch(Y, 0.01, 30)
    assert torch.equal(X, Xb) and torch.equal(rep.iter, repb.iter)
    x, r = solver.solve_on_device(Yt[1], 0.01, 30)
    assert x.shape == (25,) and r.iter.dim() == 0
    assert int(r.iter) == int(rep.iter[1])
    np.testing.assert_allclose(x.numpy(), X[1].numpy(), atol=F32_TOL)
    for call in (lambda: solver.solve(Y[0], max_iterations=0),
                 lambda: solver.solve_batch(Y, max_iterations=-1),
                 lambda: solver.solve_batch_on_device(Yt, 1e-3, 0)):
        with pytest.raises(ValueError, match="max_iterations"):
            call()


def test_from_numpy_takes_the_given_factor():
    A, Y = irls_problem(40, 25, 2, 3, seed=5, dtype=np.float32)
    Q, R, Rinv = _jax_factor(A)
    solver = pt.Irls.from_numpy(A, Q=Q, R=R, r_inv=Rinv, **TORCH_ROUTE)
    assert solver.explain()["qr_cached"]
    np.testing.assert_array_equal(solver._qr()[0].numpy(), Q)
    np.testing.assert_array_equal(solver._Rinv.numpy(), Rinv)
    with pytest.raises(ValueError, match="together"):
        pt.Irls.from_numpy(A, Q=Q, device="cpu")


# --- stabilized, as tests/test_irls_stabilized.py's CPU cases -------------

def test_stabilized_sustains_where_reference_recurrence_bails():
    A, Y, leaders = competing_pair(768, 256, 8)
    Xr, rr = pt.Irls(A, **TORCH_ROUTE).solve_batch(Y, tolerance=0.3,
                                                  max_iterations=60)
    assert rr.spd_failure.all()
    assert int(rr.iter.max()) <= 6
    mine, theirs = _pair(A, stabilized=True)
    Xs, rs = mine.solve_batch(Y, tolerance=0.3, max_iterations=60)
    iters = rs.iter.numpy()
    assert not rs.spd_failure.any()
    assert (iters < 60).all()
    assert iters.min() >= 5 and iters.mean() >= 7, iters
    assert (Xs.numpy().argmax(axis=1) == leaders).all()
    Xj, rj = theirs.solve_batch(Y, tolerance=0.3, max_iterations=60)
    np.testing.assert_array_equal(iters, np.asarray(rj.iter))
    np.testing.assert_allclose(Xs.numpy(), np.asarray(Xj), atol=F32_TOL)


def test_stabilized_matches_oracle_f64():
    A, Y, _ = competing_pair(96, 48, 4, dtype=np.float64)
    s = pt.Irls(A, stabilized=True, **TORCH_ROUTE)
    for i in range(Y.shape[0]):
        x, rep = s.solve(Y[i], tolerance=0.25, max_iterations=60)
        xo, it_o, eps_o, spd_o = oracle.solve(A, Y[i], 0.25,
                                              max_iterations=60,
                                              stabilized=True)
        assert rep.iter == it_o and rep.spd_failure == spd_o
        np.testing.assert_allclose(x.numpy(), xo, atol=1e-8)
        np.testing.assert_allclose(rep.solution_error, eps_o, rtol=1e-10)


def test_stabilized_identity_smoke_unchanged():
    A = np.eye(5, dtype=np.float32)
    x, rep = pt.Irls(A, stabilized=True, **TORCH_ROUTE).solve(A[:, 2],
                                                             tolerance=0.1)
    assert rep.iter == 1 and rep.solution_error == 0.0
    np.testing.assert_array_equal(x.numpy(), A[:, 2])


def test_stabilized_one_sparse_noisy_matches_reference_mode():
    rng = np.random.RandomState(3)
    A = rng.randn(128, 64).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    y = (A[:, 7] + rng.uniform(0, 0.05, 128)).astype(np.float32)
    xr, _ = pt.Irls(A, **TORCH_ROUTE).solve(y, tolerance=0.1)
    xs, _ = pt.Irls(A, stabilized=True, **TORCH_ROUTE).solve(y, tolerance=0.1)
    assert int(xr.argmax()) == int(xs.argmax()) == 7


# --- mesh= refusals, and the device rule -----------------------------------

# mesh= is ported (parallel/sharding.py): what is not a Mesh is refused, as
# JAX's _check_mesh refuses what is not a jax.sharding.Mesh
UNPORTED = {
    "irls_mesh": lambda A: pt.Irls(A, mesh=object(), device="cpu"),
    "irls_cg_mesh": lambda A: pt.IrlsCg(A.T, mesh=object(), device="cpu"),
}


@pytest.mark.parametrize("route", sorted(UNPORTED))
def test_unported_routes_raise(route):
    with pytest.raises(ValueError, match="mesh must be a .*Mesh"):
        UNPORTED[route](np.ones((8, 4), np.float32))


@pytest.mark.parametrize("family,engine", [("irls", "native"),
                                           ("irls", "auto"),
                                           ("irls_cg", "native"),
                                           ("irls_cg", "auto")])
def test_native_route_runs_and_matches_jax(family, engine):
    """engine="native", and "auto" at m·n ≤ 2¹⁶, run Irls (over the host
    engine's own QR) and IrlsCg on the C++ host engine: equal to the JAX
    package's native route, which runs the same source."""
    if family == "irls":
        A, Y = irls_problem(40, 25, 3, 1, seed=5, dtype=np.float32)
        mine = pt.Irls(A, engine=engine, device="cpu")
        theirs = ss.Irls(A, engine="native")
        tol, max_it = 1e-3, 50
    else:
        A, _, _ = cs_problem(32, 96, 4, seed=2, dtype=np.float32)
        Y = np.stack([A @ cs_problem(32, 96, 4, seed=s,
                                     dtype=np.float32)[1] for s in (3, 4)])
        mine = pt.IrlsCg(A, engine=engine, device="cpu")
        theirs = ss.IrlsCg(A, engine="native")
        tol, max_it = 1e-6, 60
    assert mine.explain() == dict(theirs.explain(), device="cpu")
    x, rep = mine.solve(Y[0], tol, max_it)
    xj, repj = theirs.solve(Y[0], tol, max_it)
    assert isinstance(x, torch.Tensor) and isinstance(rep, pt.IrlsReport)
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
    assert (rep.iter, rep.solution_error, rep.spd_failure) == (
        repj.iter, repj.solution_error, repj.spd_failure)
    X, reps = mine.solve_batch(Y, tol, max_it)
    Xj, repsj = theirs.solve_batch(Y, tol, max_it)
    np.testing.assert_array_equal(X.numpy(), np.asarray(Xj))
    for got, want in zip(reps, repsj):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("family", ["irls", "irls_cg"])
def test_missing_gpu_is_an_error_not_a_cpu_run(family):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    make = pt.Irls if family == "irls" else pt.IrlsCg
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(np.eye(4, dtype=np.float32))


def test_irls_has_no_update_column():
    """As in the JAX package: a new column would leave the cached QR
    stale, so only the factorization-free IrlsCg replaces columns."""
    assert not hasattr(ss.Irls, "update_column")
    assert not hasattr(pt.Irls, "update_column")
    assert hasattr(pt.IrlsCg, "update_column")
