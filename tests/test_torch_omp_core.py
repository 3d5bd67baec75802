"""The PyTorch port's per-lane OMP core (``solvers/omp.py``) and the ``Omp``
routes on it, against the JAX package's core and the NumPy oracle
(``oracle/omp.py``), on the CPU.

The JAX core runs under ``jax.vmap``, the port's steps the same lanes
together on ``device="cpu"``. The façade's JAX side is built with
``engine="jax"`` (its "auto" sends small problems to the C++ host engine;
the port's runs the torch routes). Both sides take the same seeded numpy
inputs, the Gram where one is used is the JAX-computed one, and the
trajectories are compared at "high"/"highest" and in float64.

Tolerances: against the JAX core and façade, iteration counts exact, X and
the reported errors within 1e-5 (f32 sums in another order; 1e-12 in
float64). Against the oracle, which re-solves least squares densely each
round, the pick count exact and X within 2e-4 (3e-4 for gOMP), the
tolerances of tests/test_omp.py; f32 tolerances stay ≥ 1e-3 so tol² sits
above the rss rounding floor there. "certified" is held to what it
promises: each certificate within the tolerance and equal to a float64
‖y − Ax‖₂, and the recovered supports.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

import sparse_solvers_tpu as ss
import sparse_solvers_tpu_torch as pt
from _torch_cases import TORCH_ROUTE, compressive_problem
from sparse_solvers_tpu.ops import blas as jblas
from sparse_solvers_tpu.ops.operators import DenseOperator as JDense
from sparse_solvers_tpu.oracle import omp as oracle
from sparse_solvers_tpu.solvers import omp as JOMP
from sparse_solvers_tpu_torch import api as papi
from sparse_solvers_tpu_torch.ops import blas as pblas
from sparse_solvers_tpu_torch.ops import dispatch
from sparse_solvers_tpu_torch.ops.operators import DenseOperator
from sparse_solvers_tpu_torch.solvers import omp as POMP


def _problem(m, n, k, seed=0, dtype=np.float32):
    """tests/test_omp.py's single-signal ensemble."""
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n).astype(dtype)
    A /= np.linalg.norm(A, axis=0)
    x = np.zeros(n, dtype)
    x[rng.choice(n, k, replace=False)] = rng.uniform(0.5, 1.0, k).astype(
        dtype)
    return A, x, (A @ x).astype(dtype)


def _gram(A):
    return np.array(jnp.asarray(A).T @ jnp.asarray(A))


def _jax(A, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return ss.Omp(A, engine="jax", **kw)


def _jax_core(A, G, Y, tol, max_it, prec, **kw):
    """The JAX core over the lanes of Y, vmapped, at ``prec``."""
    n = A.shape[1]
    fn = jax.jit(jax.vmap(lambda y: JOMP.solve_omp_core(
        JDense(jnp.asarray(A), None if G is None else jnp.asarray(G)), n, y,
        tol, max_it, **kw)))
    with jblas.precision_scope(prec):
        X, rep = fn(jnp.asarray(Y))
    return np.asarray(X), np.asarray(rep.iter), np.asarray(
        rep.solution_error)


def _port_core(A, G, Y, tol, max_it, prec, **kw):
    t = torch.from_numpy
    op = DenseOperator(t(A), None if G is None else t(G))
    with pblas.precision_scope(prec):
        X, rep = POMP.solve_omp_core(op, A.shape[1], t(Y), tol, max_it,
                                     **kw)
    return X.numpy(), rep.iter.numpy(), rep.solution_error.numpy()


def _assert_same(mine, theirs, atol=1e-5):
    np.testing.assert_array_equal(mine[1], theirs[1])
    np.testing.assert_allclose(mine[0], theirs[0], atol=atol)
    np.testing.assert_allclose(mine[2], theirs[2], atol=atol)


# --- top_picks: lax.top_k's order ---------------------------------------------

def test_top_picks_follow_lax_top_k_on_planted_ties():
    """Equal values come out lower index first, as ``lax.top_k`` returns
    them; the active sentinel −1 is picked last, leftmost first."""
    rng = np.random.RandomState(0)
    S = rng.choice([0.0, 0.25, 0.5, 1.0], size=(6, 40)).astype(np.float32)
    S[0, [3, 9, 17, 30]] = 2.0           # a four-way tie at the top
    S[1, :] = 0.5                         # every value tied
    S[2, :] = -1.0                        # every column active
    S[2, [5, 33]] = 0.5
    S[3, [0, 39]] = 3.0                   # tie at the two ends
    for picks in (1, 2, 4, 7):
        vals, idxs = POMP.top_picks(torch.from_numpy(S), picks)
        jv, ji = jax.lax.top_k(jnp.asarray(S), picks)
        np.testing.assert_array_equal(idxs.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    _, idxs = POMP.top_picks(torch.from_numpy(S), 4)
    assert idxs[0].tolist() == [3, 9, 17, 30]
    assert idxs[1].tolist() == [0, 1, 2, 3]
    assert idxs[2].tolist() == [5, 33, 0, 1]


def test_gomp_picks_planted_ties_in_jax_order():
    """Columns of equal correlation enter a gOMP round in JAX's order:
    y = e_0 + e_1 + e_2 + e_3 over orthonormal columns ties four
    correlations at 1, and the slots fill 0, 1, 2, 3 on both sides."""
    A = np.eye(16, dtype=np.float32)[:, :8]
    y = np.zeros(16, np.float32)
    y[[2, 3, 5, 6]] = 1.0
    y = y[None]
    op = DenseOperator(torch.from_numpy(A), torch.from_numpy(A.T @ A))
    with pblas.precision_scope("highest"):
        X, rep = POMP.solve_omp_core(op, 8, torch.from_numpy(y), 1e-6, 8,
                                     picks=3)
    # round 1 takes the leftmost three of the four ties, round 2 the last
    assert rep.iter.tolist() == [4]
    mine = _port_core(A, _gram(A), y, 1e-6, 8, "highest", picks=3)
    theirs = _jax_core(A, _gram(A), y, 1e-6, 8, "highest", picks=3)
    _assert_same(mine, theirs)
    np.testing.assert_array_equal(X.numpy()[0], [0, 0, 1, 1, 0, 1, 1, 0])


# --- the core against JAX's and the oracle ----------------------------------

@pytest.mark.parametrize("corr", ["gram", "sparse", "dense"])
@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_core_matches_jax_core_and_oracle(corr, mode):
    """Each corr × mode on 4 lanes at "highest" (tests/test_omp.py:287's
    ensemble): the JAX core's picks, X and errors, and the oracle's pick
    count and X."""
    A, Y, _ = compressive_problem(96, 256, 7, 4, seed=29)
    G = _gram(A) if mode == "fast" else None
    mine = _port_core(A, G, Y, 1e-3, 60, "highest", mode=mode, corr=corr)
    theirs = _jax_core(A, G, Y, 1e-3, 60, "highest", mode=mode, corr=corr)
    _assert_same(mine, theirs)
    for lane in range(len(Y)):
        xo, ito, _, _ = oracle.solve(A, Y[lane], 1e-3, 60)
        assert mine[1][lane] == ito
        np.testing.assert_allclose(mine[0][lane], xo, atol=2e-4)


@pytest.mark.parametrize("m,n,k,J", [(48, 128, 6, 2), (64, 160, 9, 3),
                                     (64, 128, 8, 4)])
def test_gomp_core_matches_jax_core_and_oracle(m, n, k, J):
    """tests/test_omp.py:721-739's gOMP cases: round for round the JAX
    core and the oracle, and the planted support recovered."""
    A, x_true, y = _problem(m, n, k, seed=m + n + J)
    G = _gram(A)
    mine = _port_core(A, G, y[None], 1e-3, 100, "highest", picks=J)
    theirs = _jax_core(A, G, y[None], 1e-3, 100, "highest", picks=J)
    _assert_same(mine, theirs)
    xo, ito, _, _ = oracle.solve(A, y, 1e-3, 100, picks=J)
    assert mine[1][0] == ito
    np.testing.assert_allclose(mine[0][0], xo, atol=3e-4)
    assert set(np.flatnonzero(x_true)) <= set(
        np.flatnonzero(np.abs(mine[0][0]) > 1e-2))


@pytest.mark.parametrize("corr", ["gram", "dense"])
def test_core_float64_matches_jax_and_oracle(corr):
    A, _, y = _problem(48, 96, 5, seed=144, dtype=np.float64)
    G = _gram(A)
    mine = _port_core(A, G, y[None], 1e-6, 100, "highest", corr=corr)
    theirs = _jax_core(A, G, y[None], 1e-6, 100, "highest", corr=corr)
    _assert_same(mine, theirs, atol=1e-12)
    xo, ito, _, _ = oracle.solve(A, y, 1e-6, 100)
    assert mine[1][0] == ito
    np.testing.assert_allclose(mine[0][0], xo, atol=1e-8)


def test_core_edges_match_jax():
    """The identity smoke (one pick, exact), a zero signal (no pick) and a
    k_max cap against the JAX core; duplicated columns (the degenerate
    guard stops the lane finite) and the noise-floor stall held to
    tests/test_omp.py's contracts."""
    eye = np.eye(5, dtype=np.float32)
    sig = np.zeros((2, 5), np.float32)
    sig[0, 2] = 1.0
    mine = _port_core(eye, eye, sig, 0.1, 100, "highest")
    _assert_same(mine, _jax_core(eye, eye, sig, 0.1, 100, "highest"))
    assert mine[1].tolist() == [1, 0] and mine[2].tolist() == [0.0, 0.0]
    np.testing.assert_array_equal(mine[0], sig)

    A, _, y = _problem(64, 128, 8, seed=5)
    capped = _port_core(A, None, y[None], 1e-6, 50, "highest", k_max=3)
    _assert_same(capped, _jax_core(A, None, y[None], 1e-6, 50, "highest",
                                   k_max=3))
    assert capped[1][0] == 3 and np.count_nonzero(capped[0]) <= 3

    rng = np.random.RandomState(8)
    base = rng.randn(24, 6).astype(np.float32)
    D = np.concatenate([base] * 8, axis=1)
    D /= np.linalg.norm(D, axis=0)
    yd = (D[:, :3] @ np.array([1.0, -0.5, 0.8], np.float32))[None]
    dup = _port_core(D, _gram(D), yd, 1e-7, 40, "highest")
    assert np.isfinite(dup[0]).all() and np.isfinite(dup[2]).all()
    assert dup[1][0] <= 7                 # rank bound (+1 boundary pick)

    # below the rss rounding floor the stall pick is set by summation
    # order (ROADMAP.md Queue 3): held to tests/test_omp.py:236's contract
    A, _, y = _problem(128, 512, 12, seed=4)
    stall = _port_core(A, _gram(A), y[None], 1e-30, 100, "highest")
    assert stall[1][0] < 100 and np.isfinite(stall[2]).all()


def test_gomp_zero_correlation_round_matches_oracle():
    """tests/test_omp.py:856: orthonormal columns and a 3-sparse signal —
    picks=4's first round commits exactly 3 columns (a zero-correlation
    column is not eligible)."""
    A = np.eye(16, dtype=np.float32)[:, :8]
    y = np.zeros(16, np.float32)
    y[[0, 2, 5]] = [1.0, -0.5, 0.25]
    mine = _port_core(A, _gram(A), y[None], 1e-6, 20, "highest", picks=4)
    _assert_same(mine, _jax_core(A, _gram(A), y[None], 1e-6, 20, "highest",
                                 picks=4))
    xo, ito, _, _ = oracle.solve(A, y, 1e-6, 20, picks=4)
    assert mine[1][0] == ito == 3
    np.testing.assert_allclose(mine[0][0], xo, atol=1e-6)


def test_core_validation():
    op = DenseOperator(torch.eye(4), None)
    Y = torch.ones(1, 4)
    for kw in ({"picks": 0}, {"mode": "slow"}, {"corr": "fused"}):
        with pytest.raises(ValueError):
            POMP.solve_omp_core(op, 4, Y, 1e-3, 4, **kw)


# --- the façade's routes on the core -----------------------------------------

@pytest.mark.parametrize("kw", [
    {"precision": "high"}, {"precision": "highest"},
    {"precision": "high", "picks": 3}, {"mode": "exact"},
    {"gram": False, "precision": "high"},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_solve_matches_jax(kw):
    A, _, y = _problem(64, 160, 6, seed=9)
    theirs = _jax(A, **kw)
    xj, rj = theirs.solve(y, 1e-3, 60)
    G = None if theirs._G is None else np.array(theirs._G)
    mine = pt.Omp.from_numpy(A, G, **TORCH_ROUTE, **kw)
    x, rep = mine.solve(y, 1e-3, 60)
    assert isinstance(rep, pt.OmpReport) and rep.iter == rj.iter
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-5)
    assert abs(rep.solution_error - rj.solution_error) <= 1e-5
    got, want = mine.explain(), theirs.explain()
    for key in ("corr", "k_max", "formulation", "precision", "mode",
                "picks", "path_precision"):
        assert got.get(key) == want.get(key), key


def test_float64_solve_matches_jax_and_oracle():
    A, x_true, y = _problem(48, 96, 5, seed=7, dtype=np.float64)
    x, rep = pt.Omp(A, **TORCH_ROUTE).solve(y, 1e-6, 100)
    xj, rj = _jax(A).solve(y, 1e-6, 100)
    xo, ito, _, _ = oracle.solve(A, y, 1e-6, 100)
    assert x.dtype == torch.float64 and rep.iter == rj.iter == ito
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-10)
    np.testing.assert_allclose(x.numpy(), xo, atol=1e-8)
    assert rep.solution_error <= 1e-6


def test_exact_and_fast_agree():
    A, _, y = _problem(64, 160, 6, seed=9)
    xf, rf = pt.Omp(A, precision="highest", **TORCH_ROUTE).solve(y, 1e-3, 60)
    xe, re_ = pt.Omp(A, mode="exact", **TORCH_ROUTE).solve(y, 1e-3, 60)
    assert rf.iter == re_.iter
    np.testing.assert_allclose(xf.numpy(), xe.numpy(), atol=1e-5)


@pytest.mark.parametrize("kw,corr", [({}, "gram"), ({"gram": True}, "gram"),
                                     ({"gram": False}, "sparse")])
def test_small_batch_regime_matches_jax_vmapped_core(kw, corr):
    """batch·k_max < 2m, and gram=True at any batch: the vmapped core with
    the routed corr (the JAX CPU backend keeps every batch there)."""
    A, Y, _ = compressive_problem(128, 256, 6, 4, seed=2)
    theirs = _jax(A, precision="high", **kw)
    mine = pt.Omp.from_numpy(
        A, None if theirs._G is None else np.array(theirs._G),
        precision="high", **TORCH_ROUTE, **kw)
    plan = mine.explain(batch=4, max_iterations=24)
    assert plan["corr"] == corr == theirs.explain(batch=4,
                                                  max_iterations=24)["corr"]
    assert plan["formulation"] == f"vmapped OMP loop (corr={corr})"
    dispatch.reset_launches()
    X, rep = mine.solve_batch(Y, 1e-2, 24)
    assert not any(dispatch.launches.values())
    Xj, rj = theirs.solve_batch(Y, 1e-2, 24)
    np.testing.assert_array_equal(rep.iter.numpy(), np.asarray(rj.iter))
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), atol=1e-5)
    np.testing.assert_allclose(rep.solution_error.numpy(),
                               np.asarray(rj.solution_error), atol=1e-5)
    vals, idxs, _ = mine.solve_batch(Y, 1e-2, 24, dense=False)
    jv, ji, _ = theirs.solve_batch(Y, 1e-2, 24, dense=False)
    np.testing.assert_array_equal(idxs.numpy(), np.asarray(ji))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), atol=1e-5)
    assert torch.equal(pt.densify_batch(vals, idxs, 256), X)


def test_gram_true_pins_the_core_past_the_crossover(monkeypatch):
    A, Y, _ = compressive_problem(64, 128, 4, 16, seed=4)
    # the JAX routing rule on a TPU, as SS_BATCH_NATIVE=1 gives it past
    # the crossover (below it the variable forces the driver there too)
    monkeypatch.setenv("SS_BATCH_NATIVE", "1")
    for kw, corr, batches in (({"gram": True}, "gram", (None, 2, 16)),
                              ({}, "driver", (None, 16))):
        mine = pt.Omp(A, precision="high", **TORCH_ROUTE, **kw)
        theirs = _jax(A, precision="high", **kw)
        for batch in batches:
            got = mine.explain(batch=batch, max_iterations=24)
            want = theirs.explain(batch=batch, max_iterations=24)
            for key in ("corr", "k_max", "formulation", "gram_free"):
                assert got.get(key) == want.get(key), (kw, batch, key)
        assert mine.explain(batch=16, max_iterations=24)["corr"] == corr


@pytest.mark.parametrize("batch,max_it,kw", [
    (None, 10, {}), (100, 20, {}), (None, 10, {"gram": False}),
    (100, 20, {"gram": False}), (100, 20, {"gram": True}),
    (None, 40, {"k_max": 8}), (3, 40, {"mode": "exact"}),
])
def test_route_corr_matches_jax(batch, max_it, kw):
    """tests/test_omp.py:312's routing, and more, against the JAX façade's
    ``_route_corr``."""
    A, _, _ = _problem(64, 256, 4, seed=31)
    mine = pt.Omp(A, device="cpu", **kw)._route_corr(batch, max_it)
    assert mine == _jax(A, **kw)._route_corr(batch, max_it)


def test_certified_solve_and_forced_resolve(monkeypatch):
    """Certified single solves: the certificate within the tolerance and
    equal to a float64 ‖y − Ax‖₂ (rtol 1e-4, atol 1e-6), the support
    recovered; a certificate forced to fail re-solves at "high" and
    returns that solve's result."""
    A, x_true, y = _problem(64, 160, 6, seed=9)
    solver = pt.Omp(A, **TORCH_ROUTE)
    x, rep = solver.solve(y, 1e-3, 60)
    r = y.astype(np.float64) - A.astype(np.float64) @ x.numpy()
    assert rep.solution_error <= 1e-3
    np.testing.assert_allclose(rep.solution_error, np.linalg.norm(r),
                               rtol=1e-4, atol=1e-6)
    assert set(np.flatnonzero(np.abs(x.numpy()) > 1e-2)) == set(
        np.flatnonzero(x_true))
    real = papi._certified_l2_error
    calls = []

    def spoofed(Am, X, Y):
        calls.append(1)
        err = real(Am, X, Y)
        return err + 1.0 if len(calls) == 1 else err

    monkeypatch.setattr(papi, "_certified_l2_error", spoofed)
    xs, reps = solver.solve(y, 1e-3, 60)
    monkeypatch.undo()
    xh, reph = pt.Omp(A, precision="high", **TORCH_ROUTE).solve(y, 1e-3, 60)
    assert len(calls) == 1    # the re-solve at "high" reports its own
    assert torch.equal(xs, xh) and reps.iter == reph.iter
    assert reps.solution_error == reph.solution_error


def test_solve_on_device_returns_tensors():
    A, _, y = _problem(48, 96, 4, seed=13)
    solver = pt.Omp(A, precision="high", **TORCH_ROUTE)
    x, rep = solver.solve_on_device(torch.from_numpy(y), 1e-3, 40)
    assert x.shape == (96,) and rep.iter.shape == ()
    assert rep.iter.dtype == torch.int32 and int(rep.iter) == 4
    xs, reps = solver.solve(y, 1e-3, 40)
    assert torch.equal(x, xs) and int(rep.iter) == reps.iter


def test_update_column_refreshes_the_core():
    """tests/test_omp.py:246 on the port: after a column is replaced, a
    signal on that column alone is found in one pick."""
    A, _, y = _problem(48, 96, 4, seed=17)
    solver = pt.Omp(A, **TORCH_ROUTE)
    solver.solve(y, 1e-3)                  # builds the Gram
    v = np.random.RandomState(99).randn(48).astype(np.float32)
    v /= np.linalg.norm(v)
    solver.update_column(7, v)
    x, rep = solver.solve(v, 1e-3)
    assert int(np.argmax(np.abs(x.numpy()))) == 7 and rep.iter == 1
