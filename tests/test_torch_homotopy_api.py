"""The PyTorch port's ``Homotopy`` routes on the per-lane core — ``solve``,
``solve_on_device``, sparse-regime ``solve_batch``, ``mode="exact"``,
float64, ``solve_path`` and ``solve_path_batch`` — and ``update_column``
and the module functions, against the JAX package on the CPU.

The JAX side is built with ``engine="jax"``: its ``engine="auto"`` would
send these small problems to the C++ host engine, while the port's runs
the torch routes. Trajectories are compared at "high" and in float64; at
"certified" the port's path really runs at bf16 while JAX on the CPU does
not, so there the tests compare what "certified" promises.
"""

import warnings

import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

import sparse_solvers_tpu as ss
import sparse_solvers_tpu_torch as pt
from _torch_cases import TORCH_ROUTE, compressive_problem
from sparse_solvers_tpu_torch import api as papi

TOL = 1e-3


def _jax(A, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return ss.Homotopy(A, engine="jax", **kw)


def _problem(m=64, n=128, k=5, batch=4, seed=3):
    return compressive_problem(m, n, k, batch, seed=seed)


@pytest.mark.parametrize("mode,precision", [("fast", "high"),
                                            ("exact", "highest")])
def test_solve_matches_jax(mode, precision):
    A, Y, _ = _problem()
    mine = pt.Homotopy(A, mode=mode, precision=precision, **TORCH_ROUTE)
    theirs = _jax(A, mode=mode, precision=precision)
    for y in Y[:2]:
        x, rep = mine.solve(y, TOL, 60)
        xj, repj = theirs.solve(y, TOL, 60)
        assert isinstance(x, torch.Tensor) and x.shape == (128,)
        assert rep.iter == repj.iter
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-5)
        np.testing.assert_allclose(rep.solution_error, repj.solution_error,
                                   atol=1e-5)


def test_float64_solve_both_modes_match_jax():
    A, Y, _ = _problem(seed=5)
    A, y = A.astype(np.float64), Y[0].astype(np.float64)
    for mode in ("fast", "exact"):
        x, rep = pt.Homotopy(A, mode=mode, precision="highest",
                             **TORCH_ROUTE).solve(y, 1e-9, 60)
        xj, repj = _jax(A, mode=mode, precision="highest").solve(y, 1e-9, 60)
        assert x.dtype == torch.float64 and rep.iter == repj.iter
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-10)


def test_exact_and_fast_agree():
    A, Y, _ = _problem(seed=7)
    outs = [pt.Homotopy(A, mode=mode, precision="highest",
                        **TORCH_ROUTE).solve(Y[0], TOL, 60)
            for mode in ("fast", "exact")]
    assert outs[0][1].iter == outs[1][1].iter
    np.testing.assert_allclose(outs[0][0].numpy(), outs[1][0].numpy(),
                               atol=1e-5)


def test_sparse_regime_batch_matches_jax_vmapped_core():
    """batch·k_max < 2m: the port runs the per-lane core with the lanes
    stepped together, as the JAX package vmaps its core."""
    A, Y, _ = _problem(m=96, n=128, k=4, batch=3, seed=9)
    mine = pt.Homotopy(A, k_max=24, precision="high", **TORCH_ROUTE)
    plan = mine.explain(batch=3, max_iterations=40)
    assert plan["sparse_matvec"] and not plan["batch_native"]
    assert plan["kernels"] == {}
    X, rep = mine.solve_batch(Y, TOL, 40)
    Xj, repj = _jax(A, k_max=24, precision="high").solve_batch(Y, TOL, 40)
    np.testing.assert_array_equal(rep.iter.numpy(), np.asarray(repj.iter))
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), atol=1e-5)
    vals, idxs, repc = mine.solve_batch(Y, TOL, 40, dense=False)
    assert torch.equal(pt.densify_batch(vals, idxs, 128), X)
    assert torch.equal(repc.iter, rep.iter)


def test_certified_solve_and_forced_resolve(monkeypatch):
    """"certified" single solves certify against a float64 recompute; a
    forced certificate failure re-solves at "high" (api.py:634-640)."""
    A, Y, Xt = _problem(seed=11)
    solver = pt.Homotopy(A, **TORCH_ROUTE)
    x, rep = solver.solve(Y[0], 1e-2, 60)
    assert rep.solution_error <= 1e-2
    c = (Y[0].astype(np.float64) - A.astype(np.float64)
         @ x.numpy().astype(np.float64)) @ A.astype(np.float64)
    np.testing.assert_allclose(rep.solution_error, np.abs(c).max(),
                               rtol=1e-4)
    assert set(np.argsort(-np.abs(x.numpy()))[:5]) == set(
        np.flatnonzero(Xt[0]))
    calls, real = [], papi.Homotopy._fn

    def counting(self, *a, **kw):
        calls.append(kw.get("precision"))
        return real(self, *a, **kw)

    monkeypatch.setattr(papi.Homotopy, "_fn", counting)
    monkeypatch.setattr(papi, "_certified_error",
                        lambda *a: torch.full((1,), float("nan")))
    xf, repf = solver.solve(Y[0], 1e-2, 60)
    assert calls == [None, "high"]
    xh, reph = pt.Homotopy(A, precision="high", **TORCH_ROUTE).solve(
        Y[0], 1e-2, 60)
    assert torch.equal(xf, xh) and repf.iter == reph.iter


def test_solve_on_device_returns_tensors():
    A, Y, _ = _problem()
    solver = pt.Homotopy(A, precision="high", **TORCH_ROUTE)
    x, rep = solver.solve_on_device(torch.from_numpy(Y[1]), TOL, 60)
    x2, rep2 = solver.solve(Y[1], TOL, 60)
    assert x.shape == (128,) and rep.iter.dim() == 0
    assert torch.equal(x, x2) and int(rep.iter) == rep2.iter


def test_explain_core_routes():
    A, _, _ = _problem()
    single = pt.Homotopy(A, **TORCH_ROUTE).explain()
    assert single["formulation"] == "while-loop core"
    assert single["kernels"] == {} and single["path_precision"] == "default"
    exact = pt.Homotopy(A, mode="exact", **TORCH_ROUTE).explain(batch=64)
    assert exact["mode"] == "exact" and exact["gram"] is False
    assert exact["precision"] == "highest" and not exact["batch_native"]
    assert exact["formulation"].startswith("batched while-loop core")
    theirs = _jax(A, mode="exact").explain(batch=64)
    for key in ("mode", "precision", "gram", "k_max", "sparse_matvec",
                "batch_native"):
        assert exact[key] == theirs[key], key
    f64 = pt.Homotopy(A.astype(np.float64), **TORCH_ROUTE)
    assert f64.explain(batch=64)["batch_native"] is False


def test_gram_auto_size_follows_the_dtype(monkeypatch):
    """The automatic Gram is sized at the dtype's bytes per value
    (api.py:352-355): a limit between n²·4 and n²·8 keeps float32's Gram
    and drops float64's."""
    A, _, _ = _problem()
    monkeypatch.setattr(papi, "_GRAM_AUTO_BYTES", 128 * 128 * 6)
    assert pt.Homotopy(A, **TORCH_ROUTE)._gram_enabled
    assert not pt.Homotopy(A.astype(np.float64),
                           **TORCH_ROUTE)._gram_enabled
    assert not pt.Homotopy(A, mode="exact", **TORCH_ROUTE)._gram_enabled


def test_gram_free_core_matches_gram_core(monkeypatch):
    A, Y, _ = _problem(m=96, n=128, k=4, batch=2, seed=13)
    X0, r0 = pt.Homotopy(A, gram=False, precision="high",
                         **TORCH_ROUTE).solve_batch(Y, TOL, 40)
    X1, r1 = pt.Homotopy(A, precision="high", **TORCH_ROUTE).solve_batch(
        Y, TOL, 40)
    assert torch.equal(r0.iter, r1.iter)
    np.testing.assert_allclose(X0.numpy(), X1.numpy(), atol=1e-5)
    # past the sparse-matvec regime (16·41 ≥ 2m) the gram-free driver runs:
    # the JAX gram-free driver's iterations, X within 1e-5
    Y16 = np.repeat(Y, 8, axis=0)
    Xf, rf = pt.Homotopy(A, gram=False, precision="high",
                         **TORCH_ROUTE).solve_batch(Y16, TOL, 40)
    monkeypatch.setenv("SS_BATCH_NATIVE", "1")
    jax_solver = _jax(A, gram=False, precision="high")
    assert jax_solver.explain(batch=16, max_iterations=40)["gram_free"]
    Xj, rj = jax_solver.solve_batch(Y16, TOL, 40)
    np.testing.assert_array_equal(rf.iter.numpy(), np.asarray(rj.iter))
    np.testing.assert_allclose(Xf.numpy(), np.asarray(Xj), atol=1e-5)


@pytest.mark.parametrize("kw", [{"gram": False}, {"mode": "exact"},
                                {"dtype": np.float64}])
def test_empty_batch_on_every_route(kw):
    A, _, _ = _problem()
    kw = dict(kw)
    A = A.astype(kw.pop("dtype", np.float32))
    solver = pt.Homotopy(A, **TORCH_ROUTE, **kw)
    X, rep = solver.solve_batch(np.zeros((0, 64), A.dtype), TOL, 10)
    assert X.shape == (0, 128) and rep.iter.shape == (0,)
    hl, hv, hi, rep = solver.solve_path_batch(np.zeros((0, 64), A.dtype),
                                              TOL, 10)
    assert hl.shape == (0, 11) and hv.shape == hi.shape == (0, 11, 11)


@pytest.mark.parametrize("family", ["homotopy", "omp"])
def test_update_column_matches_rebuild(family):
    """update_column: the incrementally updated A and Gram give the
    solves of a solver built on the changed matrix (test_api.py:260)."""
    rng = np.random.RandomState(8)
    m, n = 48, 96
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    new_col = rng.randn(m).astype(np.float32)
    new_col /= np.linalg.norm(new_col)
    A2 = A.copy()
    A2[:, 5] = new_col
    x0 = np.zeros(n, np.float32)
    x0[[5, 17, 40, 63]] = [1.0, 0.7, 0.5, 0.9]
    y = A2 @ x0
    cls = pt.Homotopy if family == "homotopy" else pt.Omp
    s = cls(A, precision="high", **TORCH_ROUTE)
    _ = s._G
    s.update_column(5, new_col)
    np.testing.assert_allclose(s._G.numpy(), A2.T @ A2, atol=1e-5)
    assert torch.equal(s._A, torch.from_numpy(A2))
    Y = np.stack([y] * 64)         # outside the sparse regime for both
    Xa, ra = s.solve_batch(Y, 1e-3, 60)
    Xb, rb = cls(A2, precision="high", **TORCH_ROUTE).solve_batch(Y, 1e-3, 60)
    assert torch.equal(ra.iter, rb.iter)
    np.testing.assert_allclose(Xa.numpy(), Xb.numpy(), atol=1e-5)
    if family == "homotopy":
        xa, _ = s.solve(y, 1e-3, 60)
        assert set(np.flatnonzero(np.abs(xa.numpy()) > 1e-3)) == {5, 17, 40,
                                                                  63}
    with pytest.raises(ValueError, match="out of range"):
        s.update_column(n, new_col)
    with pytest.raises(ValueError, match="length"):
        s.update_column(0, new_col[:-1])


def _path_problem(seed, m=64, n=128, k=5):
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    x0 = np.zeros(n, np.float32)
    x0[rng.choice(n, k, replace=False)] = rng.uniform(0.3, 1, k)
    return A, A @ x0


def test_solve_path_matches_jax_and_keeps_kkt():
    """solve_path: λ strictly decreasing from ‖Aᵀy‖∞, each breakpoint's
    KKT identity ‖Aᵀ(y−Ax_t)‖∞ = λ_t, the last row equal to solve(), and
    equal to the JAX package's path (test_api.py:316)."""
    A, y = _path_problem(3)
    s = pt.Homotopy(A, **TORCH_ROUTE)
    lambdas, Xs, rep = s.solve_path(y, 1e-3, 60)
    assert isinstance(Xs, np.ndarray)
    assert len(lambdas) == rep.iter + 1 == Xs.shape[0]
    assert np.all(np.diff(lambdas) < 0)
    assert np.abs(Xs[0]).max() == 0.0
    np.testing.assert_allclose(lambdas[0], np.abs(A.T @ y).max(), rtol=1e-6)
    for t in range(len(lambdas)):
        np.testing.assert_allclose(np.abs(A.T @ (y - A @ Xs[t])).max(),
                                   lambdas[t], rtol=1e-4, atol=1e-6)
    xf, repf = pt.Homotopy(A, precision="high", **TORCH_ROUTE).solve(
        y, 1e-3, 60)
    assert repf.iter == rep.iter
    np.testing.assert_allclose(Xs[-1], xf.numpy(), atol=1e-6)
    lj, Xj, repj = _jax(A).solve_path(y, 1e-3, 60)
    assert repj.iter == rep.iter
    np.testing.assert_allclose(lambdas, lj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(Xs, Xj, atol=1e-5)


def test_solve_path_break_terminated():
    """The empty-set break commits nothing: its duplicate row is trimmed,
    the last row equals solve()'s x, and the KKT identity holds on every
    recorded row (test_api.py:344)."""
    rng = np.random.RandomState(0)
    A = rng.randn(16, 3).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    y = (-A[:, 0] + 0.4 * A[:, 1]).astype(np.float32)
    s = pt.Homotopy(A, precision="high", **TORCH_ROUTE)
    lambdas, Xs, rep = s.solve_path(y, 1e-3, 30)
    xf, repf = s.solve(y, 1e-3, 30)
    assert rep.iter == repf.iter
    np.testing.assert_allclose(Xs[-1], xf.numpy(), atol=1e-6)
    assert len(lambdas) == rep.iter
    for t in range(len(lambdas)):
        np.testing.assert_allclose(np.abs(A.T @ (y - A @ Xs[t])).max(),
                                   lambdas[t], rtol=1e-4, atol=1e-6)


def test_solve_path_float64():
    rng = np.random.RandomState(2)
    A = rng.randn(48, 96)
    A /= np.linalg.norm(A, axis=0)
    x0 = np.zeros(96)
    x0[rng.choice(96, 3, replace=False)] = rng.uniform(0.4, 1, 3)
    y = A @ x0
    lambdas, Xs, rep = pt.Homotopy(A, **TORCH_ROUTE).solve_path(y, 1e-9, 40)
    assert Xs.dtype == np.float64
    for t in range(len(lambdas)):
        np.testing.assert_allclose(np.abs(A.T @ (y - A @ Xs[t])).max(),
                                   lambdas[t], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(Xs[-1][x0 > 0], x0[x0 > 0], atol=1e-7)


@pytest.mark.parametrize("b", [3, 24])
def test_solve_path_batch_matches_single_paths(b):
    """Per-lane histories (the core at b = 3, the slot-space driver at
    b = 24) densify to the single-signal paths (test_api.py:377)."""
    rng = np.random.RandomState(6)
    m, n, k = 64, 128, 4
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    Y = np.zeros((b, m), np.float32)
    for i in range(b):
        x0 = np.zeros(n, np.float32)
        x0[rng.choice(n, k, replace=False)] = rng.uniform(0.3, 1, k)
        Y[i] = A @ x0
    s = pt.Homotopy(A, k_max=24, **TORCH_ROUTE)
    assert s.explain(batch=b, max_iterations=40)["batch_native"] == (b == 24)
    hl, hv, hi, rep = s.solve_path_batch(Y, 1e-3, 40)
    assert hl.shape == (b, 41) and hv.shape == hi.shape == (b, 41, 24)
    for i in range(0, b, max(1, b // 4)):
        lam_b, Xs_b = pt.densify_path(hl[i], hv[i], hi[i], int(rep.iter[i]),
                                      n)
        lam_s, Xs_s, rep_s = s.solve_path(Y[i], 1e-3, 40)
        assert rep_s.iter == rep.iter[i]
        np.testing.assert_allclose(lam_b, lam_s, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(Xs_b, Xs_s, atol=1e-6)


def test_lasso_at_and_batch():
    """lasso_at satisfies the LASSO KKT conditions between breakpoints and
    clamps at both ends; lasso_at_batch equals it lane by lane
    (test_api.py:413-470), and both equal the JAX package's."""
    A, y = _path_problem(12)
    s = pt.Homotopy(A, **TORCH_ROUTE)
    lambdas, Xs, rep = s.solve_path(y, 1e-3, 60)
    for t in (0, len(lambdas) // 2, len(lambdas) - 2):
        lam = 0.5 * (lambdas[t] + lambdas[t + 1])
        x = pt.lasso_at(lambdas, Xs, lam)
        np.testing.assert_array_equal(x, ss.lasso_at(lambdas, Xs, lam))
        c = A.T @ (y - A @ x)
        np.testing.assert_allclose(np.abs(c).max(), lam, rtol=1e-4,
                                   atol=1e-6)
        act = np.abs(x) > 1e-7
        np.testing.assert_allclose(c[act], lam * np.sign(x[act]), rtol=1e-3,
                                   atol=1e-5)
    np.testing.assert_allclose(pt.lasso_at(lambdas, Xs, lambdas[3]), Xs[3],
                               atol=1e-7)
    assert np.all(pt.lasso_at(lambdas, Xs, 2 * lambdas[0]) == 0)
    np.testing.assert_allclose(pt.lasso_at(lambdas, Xs, lambdas[-1] / 2),
                               Xs[-1], atol=0)
    rng = np.random.RandomState(13)
    Y = np.stack([A @ np.where(rng.rand(128) < 0.03, 0.8, 0.0)
                  .astype(np.float32) for _ in range(5)])
    hl, hv, hi, reps = s.solve_path_batch(Y, 1e-3, 50)
    Xb = pt.lasso_at_batch(hl, hv, hi, reps.iter, 128, 0.05)
    np.testing.assert_array_equal(
        Xb, ss.lasso_at_batch(hl, hv, hi, reps.iter, 128, 0.05))
    for i in range(5):
        la, Xs_i = pt.densify_path(hl[i], hv[i], hi[i], int(reps.iter[i]),
                                   128)
        np.testing.assert_array_equal(Xb[i], pt.lasso_at(la, Xs_i, 0.05))


def test_reconstruct_signal_and_norm_l1():
    rng = np.random.RandomState(1)
    A = rng.randn(6, 9).astype(np.float32)
    x = rng.randn(9).astype(np.float32)
    np.testing.assert_allclose(pt.reconstruct_signal(A, x, device="cpu"),
                               ss.reconstruct_signal(A, x), atol=1e-6)
    np.testing.assert_allclose(pt.norm_l1(A, device="cpu"), ss.norm_l1(A),
                               rtol=1e-6)
    assert pt.norm_l1(A.astype(np.float64), device="cpu").dtype == np.float64


def test_row_and_column_subsets_and_transpose():
    """Strided numpy views go through ndview (test_api.py:38-65)."""
    rng = np.random.RandomState(0)
    A = rng.rand(10, 5) * 0.1
    A_sub = A[:5, :]
    A_sub[:, 0] = 1
    x, _ = pt.Homotopy(A_sub, **TORCH_ROUTE).solve(np.ones(5))
    assert x.shape == (5,) and int(torch.count_nonzero(x)) == 1
    A = rng.rand(10, 5) * 0.1
    A[:, 0] = A[:, 3] = 1
    x, _ = pt.Homotopy(A[:, 2:], **TORCH_ROUTE).solve(np.ones(10))
    assert x.shape == (3,) and int(torch.argmax(x)) == 1
    A = rng.rand(5, 10) * 0.1
    A[3, :] = 1
    x, _ = pt.Homotopy(A.T, **TORCH_ROUTE).solve(np.ones(10))
    assert x.shape == (5,) and int(torch.argmax(x)) == 3


def test_length_mismatch_and_zero_budget():
    """test_api.py:88-110: a signal of the wrong length and a budget
    below one iteration are ValueErrors on every entry."""
    solver = pt.Homotopy(np.identity(5, np.float32), **TORCH_ROUTE)
    with pytest.raises(ValueError, match="length 5"):
        solver.solve(np.ones(4, np.float32))
    with pytest.raises(ValueError, match="Expected 1"):
        solver.solve(np.ones((5, 1), np.float32))
    y = np.eye(5, dtype=np.float32)[2]
    for call in (lambda: solver.solve(y, max_iterations=0),
                 lambda: solver.solve_on_device(torch.from_numpy(y), 1e-3, 0),
                 lambda: solver.solve_path(y, max_iterations=0),
                 lambda: solver.solve_batch(y[None], max_iterations=-1),
                 lambda: solver.solve_batch_on_device(torch.from_numpy(y)[None],
                                                      1e-3, 0)):
        with pytest.raises(ValueError, match="max_iterations"):
            call()


def test_quick_start_flow():
    """The README's port quick start on the 32×64 flow: support of three
    unit spikes recovered, certificate within the tolerance."""
    A = np.random.RandomState(0).randn(32, 64).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    x0 = np.zeros(64, np.float32)
    x0[[3, 17, 40]] = 1.0
    x, rep = pt.Homotopy(A, **TORCH_ROUTE).solve(A @ x0, 0.01, 100)
    assert rep.solution_error <= 0.01
    assert set(np.argsort(-np.abs(x.numpy()))[:3]) == {3, 17, 40}
