"""The PyTorch port's CG-IRLS (``solvers/irls_cg.py`` and ``api.IrlsCg``)
against the JAX package's and the float64 dense-inner-solve oracle
(``oracle/irls_cg.py``), on the CPU: every test of ``tests/test_irls_cg.py``
that runs neither the host engine nor a mesh, case for case, plus a batch
whose lanes stop CG at different steps with one lane breaking down,
``update_column`` and the oracle.

The JAX side runs under ``jax.vmap`` with ``engine="jax"``; the port steps
the same lanes together on ``device="cpu"``. Tolerances: against JAX,
float64 iterations and breakdown flags exact with X within 1e-10 on
converging fixtures (1e-8 where every lane spends its whole 60-step budget
at tol 1e-8, and the last bits of each CG solve add up); float32
iterations exact, X within 1e-5 (the recovery tests' own tolerances are
the JAX tests'). The final ε of a recovered exactly-sparse signal is dust
of its zero tail and is compared on an absolute scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

import sparse_solvers_tpu as ss
import sparse_solvers_tpu_torch as pt
from _torch_cases import TORCH_ROUTE, cs_problem
from sparse_solvers_tpu.oracle import irls_cg as oracle
from sparse_solvers_tpu.solvers import irls_cg as JCG
from sparse_solvers_tpu_torch.solvers import irls_cg as PCG

pytestmark = pytest.mark.filterwarnings(
    "ignore:engine='jax' on a:RuntimeWarning")


def _solve_both(A, y, tol, max_it, **kw):
    x, rep = pt.IrlsCg(A, **TORCH_ROUTE, **kw).solve(y, tolerance=tol,
                                                    max_iterations=max_it)
    xj, repj = ss.IrlsCg(A, engine="jax", **kw).solve(
        y, tolerance=tol, max_iterations=max_it)
    assert rep.iter == repj.iter and rep.spd_failure == repj.spd_failure
    return x.numpy(), rep, np.asarray(xj), repj


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-6),
                                        (np.float32, 1e-3)])
def test_recovers_sparse_signal(dtype, atol):
    A, x_true, y = cs_problem(64, 256, 5, seed=0, dtype=dtype)
    tol = 1e-8 if dtype == np.float64 else 1e-5
    x, rep, xj, repj = _solve_both(A, y, tol, 80)
    assert not rep.spd_failure and rep.iter >= 1
    np.testing.assert_allclose(x, x_true, atol=atol)
    np.testing.assert_allclose(x, xj, atol=1e-10 if dtype == np.float64
                               else 1e-5)


def test_first_iterate_is_least_norm_solution():
    A, _, y = cs_problem(20, 50, 3, seed=1)
    x, rep = pt.IrlsCg(A, **TORCH_ROUTE).solve(y, tolerance=np.inf,
                                              max_iterations=1)
    assert rep.iter == 1
    np.testing.assert_allclose(x.numpy(), np.linalg.pinv(A) @ y, atol=1e-8)


def test_cg_matches_direct_solve():
    """One CG solve at fixed weights against numpy's direct solve of
    (A D Aᵀ) z = y and against JAX's ``_cg_solve``, two lanes at once."""
    rng = np.random.RandomState(2)
    m, n = 24, 60
    A = rng.randn(m, n)
    D = rng.uniform(0.5, 2.0, n)
    y = rng.randn(m)
    B = (A * D) @ A.T
    At, Dt = torch.from_numpy(A), torch.from_numpy(D)
    Y = torch.from_numpy(np.stack([y, 2 * y]))
    out = PCG._cg_solve(lambda V: (Dt * (V @ At)) @ At.T, Y,
                        torch.zeros_like(Y),
                        torch.full((2,), 1e-24, dtype=torch.float64), 200,
                        torch.float64)
    assert not out.broke.any()
    z = np.linalg.solve(B, y)
    np.testing.assert_allclose(out.z.numpy(), np.stack([z, 2 * z]),
                               atol=1e-8)
    Aj, Dj = jnp.asarray(A), jnp.asarray(D)
    ref = JCG._cg_solve(lambda v: Aj @ (Dj * (Aj.T @ v)), jnp.asarray(y),
                        jnp.zeros(m), jnp.asarray(1e-24), 200, jnp.float64)
    assert int(out.it[0]) == int(ref.it)
    np.testing.assert_allclose(out.z.numpy()[0], np.asarray(ref.z),
                               atol=1e-10)


def test_solution_satisfies_constraint_and_l1_optimality():
    A, x_true, y = cs_problem(48, 200, 4, seed=3)
    x, _ = pt.IrlsCg(A, **TORCH_ROUTE).solve(y, tolerance=1e-9,
                                            max_iterations=100)
    x = x.numpy()
    np.testing.assert_allclose(A @ x, y, atol=1e-6)
    assert np.abs(x).sum() <= np.abs(x_true).sum() + 1e-6


def test_nonconvex_p_recovers():
    A, x_true, y = cs_problem(64, 256, 5, seed=4)
    x, rep, xj, _ = _solve_both(A, y, 1e-8, 80, p=0.9)
    assert not rep.spd_failure
    np.testing.assert_allclose(x, x_true, atol=1e-5)
    np.testing.assert_allclose(x, xj, atol=1e-10)


def _batch_problem():
    A, _, _ = cs_problem(32, 96, 3, seed=5)
    Y = np.stack([cs_problem(32, 96, 3, seed=10 + i)[2] for i in range(4)])
    return A, Y


def test_batch_matches_sequential():
    """tests/test_irls_cg.py's batch test on the port, and the batch
    against JAX's vmapped solve (every lane spends the 60-step budget
    here: X within 1e-8 of JAX's)."""
    A, Y = _batch_problem()
    solver = pt.IrlsCg(A, **TORCH_ROUTE)
    X, rep = solver.solve_batch(Y, tolerance=1e-8, max_iterations=60)
    for i in range(4):
        xi, ri = solver.solve(Y[i], tolerance=1e-8, max_iterations=60)
        np.testing.assert_allclose(X[i].numpy(), xi.numpy(), atol=1e-10)
        assert int(rep.iter[i]) == ri.iter
    Xj, repj = ss.IrlsCg(A, engine="jax").solve_batch(
        Y, tolerance=1e-8, max_iterations=60)
    np.testing.assert_array_equal(rep.iter.numpy(), np.asarray(repj.iter))
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), atol=1e-8)


def test_lanes_stop_cg_apart_and_one_breaks_down():
    """float32, one batch against JAX's vmapped solve: lanes of different
    difficulty (outer and inner loops end at different steps) and a lane
    scaled by 1e15, whose curvature pᵀBp overflows in its second outer
    step — a breakdown that freezes that lane's x while the others run
    on."""
    A, _, _ = cs_problem(32, 96, 3, seed=5, dtype=np.float32)
    Y = np.stack([A @ cs_problem(32, 96, k, seed=20 + k,
                                 dtype=np.float32)[1] for k in (1, 3, 6)])
    Y = np.concatenate([Y, 1e15 * Y[:1]]).astype(np.float32)
    X, rep = pt.IrlsCg(A, **TORCH_ROUTE).solve_batch(Y, tolerance=1e-3,
                                                    max_iterations=40)
    Xj, repj = ss.IrlsCg(A, engine="jax").solve_batch(
        Y, tolerance=1e-3, max_iterations=40)
    it, itj = rep.iter.numpy(), np.asarray(repj.iter)
    np.testing.assert_array_equal(it, itj)
    np.testing.assert_array_equal(rep.spd_failure.numpy(),
                                  np.asarray(repj.spd_failure))
    assert rep.spd_failure.tolist() == [False, False, False, True]
    assert len(set(it[:3].tolist())) == 3, it
    X, Xj = X.numpy(), np.asarray(Xj)
    np.testing.assert_allclose(X[:3], Xj[:3], atol=1e-5)
    np.testing.assert_allclose(X[3], Xj[3], rtol=1e-5,
                               atol=1e-5 * np.abs(Xj[3]).max())
    assert np.isfinite(X).all()


def test_inner_cg_steps_freeze_per_lane():
    """The inner CG alone, one lane converging in fewer steps than the
    other: each lane's step count and iterate are its own, as under
    vmap."""
    rng = np.random.RandomState(8)
    m, n = 40, 100
    A = rng.randn(m, n)
    D = np.stack([np.ones(n), rng.uniform(0.01, 5.0, n)])
    y = rng.randn(m)
    tol2 = 1e-16 * float(y @ y)
    At, Dt = torch.from_numpy(A), torch.from_numpy(D)
    Y = torch.from_numpy(np.stack([y, y]))
    out = PCG._cg_solve(lambda V: (Dt * (V @ At)) @ At.T, Y,
                        torch.zeros_like(Y),
                        torch.full((2,), tol2, dtype=torch.float64), 100,
                        torch.float64)
    Aj = jnp.asarray(A)
    for lane in range(2):
        Dj = jnp.asarray(D[lane])
        ref = JCG._cg_solve(lambda v: Aj @ (Dj * (Aj.T @ v)),
                            jnp.asarray(y), jnp.zeros(m),
                            jnp.asarray(tol2), 100, jnp.float64)
        assert int(out.it[lane]) == int(ref.it)
        np.testing.assert_allclose(out.z[lane].numpy(), np.asarray(ref.z),
                                   atol=1e-9)
    assert int(out.it[0]) != int(out.it[1])


def test_f32_tight_tolerance_stops_early():
    A, x_true, y = cs_problem(64, 256, 5, seed=9, dtype=np.float32)
    x, rep, xj, _ = _solve_both(A, y, 1e-5, 80)
    assert rep.iter < 80, rep
    np.testing.assert_allclose(x, x_true, atol=1e-3)
    np.testing.assert_allclose(x, xj, atol=1e-5)


@pytest.mark.parametrize("engine", ["jax", "auto"])
def test_empty_batch(engine):
    A, _, _ = cs_problem(16, 32, 2, seed=6)
    X, rep = pt.IrlsCg(A, engine=engine, device="cpu").solve_batch(
        np.zeros((0, 16)), tolerance=1e-6)
    assert tuple(X.shape) == (0, 32)
    assert tuple(rep.iter.shape) == (0,)


def _raises_as_jax(exc, make_port, make_jax, match):
    with pytest.raises(exc, match=match) as mine:
        make_port()
    with pytest.raises(exc) as theirs:
        make_jax()
    assert str(mine.value) == str(theirs.value)


def test_overdetermined_rejected():
    _raises_as_jax(ValueError,
                   lambda: pt.IrlsCg(np.ones((8, 4)), device="cpu"),
                   lambda: ss.IrlsCg(np.ones((8, 4))), "underdetermined")


@pytest.mark.parametrize("p", [1.5, 0.0])
def test_bad_p_rejected(p):
    _raises_as_jax(ValueError,
                   lambda: pt.IrlsCg(np.ones((4, 8)), p=p, device="cpu"),
                   lambda: ss.IrlsCg(np.ones((4, 8)), p=p), "p must be")


@pytest.mark.parametrize("knob,value", [("k_sparsity", 0),
                                        ("cg_max_iterations", 0),
                                        ("cg_tolerance", 0.0),
                                        ("precision", "certified"),
                                        ("engine", "gpu")])
def test_bad_knobs_rejected(knob, value):
    _raises_as_jax(ValueError,
                   lambda: pt.IrlsCg(np.ones((4, 8)), device="cpu",
                                     **{knob: value}),
                   lambda: ss.IrlsCg(np.ones((4, 8)), **{knob: value}),
                   knob)


def test_core_rejects_what_the_jax_core_rejects():
    A, _, y = cs_problem(8, 16, 2, seed=1)
    At, Y = torch.from_numpy(A), torch.from_numpy(y[None])
    for kw in (dict(p=0.0), dict(k_sparsity=0), dict(cg_max_iterations=0),
               dict(cg_tolerance=-1.0)):
        _raises_as_jax(ValueError,
                       lambda: PCG.solve_irls_cg(At, Y, 1e-6, 10, **kw),
                       lambda: JCG.solve_irls_cg(jnp.asarray(A),
                                                 jnp.asarray(y), 1e-6, 10,
                                                 **kw), None)
    # n_axis (column sharding) is ported: the argument checks come before
    # the first collective, so a bad argument raises alike on every rank
    # and no rank waits in an all-reduce
    with pytest.raises(ValueError, match="p must be in"):
        PCG.solve_irls_cg_core(lambda v: v, lambda u: u, 8, 16, Y, 1e-6, 10,
                               p=0.0, n_local=4, n_axis=object())


def test_cg_overflow_breaks_instead_of_nan():
    m = 8
    Y = torch.ones((1, m), dtype=torch.float32)
    out = PCG._cg_solve(lambda V: 1e-39 * V, Y, torch.zeros_like(Y),
                        torch.full((1,), 1e-20), 50, torch.float32)
    assert bool(out.broke[0])
    assert torch.isfinite(out.z).all()
    assert torch.isfinite(out.rs).all()
    ref = JCG._cg_solve(lambda v: jnp.float32(1e-39) * v,
                        jnp.ones((m,), jnp.float32),
                        jnp.zeros(m, jnp.float32), jnp.float32(1e-20), 50,
                        jnp.float32)
    assert int(out.it[0]) == int(ref.it)
    np.testing.assert_array_equal(out.z[0].numpy(), np.asarray(ref.z))


def test_explain():
    plan = pt.IrlsCg(np.ones((4, 8)), **TORCH_ROUTE).explain()
    jplan = ss.IrlsCg(np.ones((4, 8)), engine="jax").explain()
    assert set(jplan) <= set(plan)
    for key in ("backend", "mode", "precision", "p", "factorization_free"):
        assert plan[key] == jplan[key], key
    assert plan["engine"] == "torch" and plan["kernels"] == {}
    assert "batched" in pt.IrlsCg(np.ones((4, 8)), **TORCH_ROUTE).explain(
        batch=3)["formulation"]


def test_on_device_entries():
    """tests/test_irls_cg.py::test_jit_composable's serving shape: device
    tensors in, (x, report tensors) out."""
    A, x_true, y = cs_problem(48, 160, 4, seed=7)
    solver = pt.IrlsCg(A, **TORCH_ROUTE)
    x, rep = solver.solve_on_device(torch.from_numpy(y), 1e-8,
                                    max_iterations=60)
    np.testing.assert_allclose(x.numpy(), x_true, atol=1e-5)
    assert int(rep.iter) >= 1 and rep.iter.dim() == 0
    X, repb = solver.solve_batch_on_device(torch.from_numpy(y[None]), 1e-8,
                                           max_iterations=60)
    assert torch.equal(X[0], x) and int(repb.iter[0]) == int(rep.iter)
    with pytest.raises(ValueError, match="max_iterations"):
        solver.solve(y, max_iterations=0)


def test_view_semantics():
    A, _, y = cs_problem(24, 64, 3, seed=13)
    big = np.zeros((24, 128))
    big[:, ::2] = A
    Av = big[:, ::2]
    assert not Av.flags["C_CONTIGUOUS"]
    x_ref, rep_ref = pt.IrlsCg(A, **TORCH_ROUTE).solve(y, tolerance=1e-8,
                                                      max_iterations=60)
    x_v, rep_v = pt.IrlsCg(Av, **TORCH_ROUTE).solve(y, tolerance=1e-8,
                                                   max_iterations=60)
    assert torch.equal(x_v, x_ref) and rep_v.iter == rep_ref.iter
    At = np.ascontiguousarray(A.T).T
    assert not At.flags["C_CONTIGUOUS"]
    x_t, _ = pt.IrlsCg(At, **TORCH_ROUTE).solve(y, tolerance=1e-8,
                                               max_iterations=60)
    assert torch.equal(x_t, x_ref)


def test_update_column():
    """tests/test_api.py::test_irls_cg_update_column on the port: the
    updated solver equals a fresh one on the updated matrix exactly, and
    JAX's updated solver to 1e-5."""
    rng = np.random.RandomState(9)
    m, n = 24, 96
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    s = pt.IrlsCg(A, **TORCH_ROUTE)
    new_col = rng.randn(m).astype(np.float32)
    new_col /= np.linalg.norm(new_col)
    s.update_column(7, new_col)
    A2 = A.copy()
    A2[:, 7] = new_col
    x0 = np.zeros(n, np.float32)
    x0[[7, 30]] = [1.0, 0.6]
    y = A2 @ x0
    xa, ra = s.solve(y, tolerance=1e-5, max_iterations=60)
    xb, rb = pt.IrlsCg(A2, **TORCH_ROUTE).solve(y, tolerance=1e-5,
                                               max_iterations=60)
    assert ra.iter == rb.iter
    assert torch.equal(xa, xb)
    sj = ss.IrlsCg(A, engine="jax")
    sj.update_column(7, new_col)
    xj, rj = sj.solve(y, tolerance=1e-5, max_iterations=60)
    assert ra.iter == rj.iter
    np.testing.assert_allclose(xa.numpy(), xj, atol=1e-5)
    with pytest.raises(ValueError, match="out of range"):
        s.update_column(n, new_col)
    with pytest.raises(ValueError):
        s.update_column(0, new_col[:-1])


def test_matches_oracle():
    """tests/test_oracle_parity.py::test_irls_cg_matches_oracle on the
    port: with a tight inner-CG target the trajectory is the dense
    oracle's (final x to 1e-6, iterations within one step, ε to 1e-8
    absolute), and JAX's by the same contract: on these 20- to 40-step
    runs the relative change crosses 1e-8 at the last bits, and one
    seed stops a step apart from JAX."""
    for seed in range(4):
        rng = np.random.RandomState(100 + seed)
        m, n, k = 32, 128, 4
        A = rng.randn(m, n)
        A /= np.linalg.norm(A, axis=0)
        xt = np.zeros(n)
        xt[rng.choice(n, k, replace=False)] = (
            rng.choice([-1.0, 1.0], k) * rng.uniform(0.5, 1.5, k))
        y = A @ xt
        xo, ito, epso, broke_o = oracle.solve(A, y, 1e-8, 60)
        assert not broke_o
        x, rep = pt.IrlsCg(A, cg_tolerance=1e-12, **TORCH_ROUTE).solve(
            y, tolerance=1e-8, max_iterations=60)
        xj, repj = ss.IrlsCg(A, cg_tolerance=1e-12, engine="jax").solve(
            y, tolerance=1e-8, max_iterations=60)
        assert not rep.spd_failure
        for it, xr, eps in ((ito, xo, epso),
                            (repj.iter, xj, repj.solution_error)):
            assert abs(rep.iter - it) <= 1, (seed, rep.iter, it)
            np.testing.assert_allclose(x.numpy(), xr, atol=1e-6)
            np.testing.assert_allclose(rep.solution_error, eps, atol=1e-8)


@pytest.mark.parametrize("p", [1.0, 0.9])
def test_core_float64_iteration_exact(p):
    """``solve_irls_cg_core`` over the port's matvec/rmatvec against the
    JAX core under vmap, float64, three signals of 5, 3 and 8 nonzeros:
    iterations and flags exact; X within 1e-10. The final ε is r_{K+1}(x)/n
    of the solution's zero tail, dust set by the CG residual, so ε is
    compared at 1e-12 absolute (tests/test_oracle_parity.py's reason)."""
    A, _, _ = cs_problem(64, 256, 5, seed=0)
    Y = np.stack([A @ cs_problem(64, 256, k, seed=s)[1]
                  for s, k in ((0, 5), (4, 3), (9, 8))])
    At = torch.from_numpy(A)
    X, rep = PCG.solve_irls_cg_core(
        lambda V: V @ At.T, lambda U: U @ At, 64, 256, torch.from_numpy(Y),
        1e-8, 80, p=p, k_sparsity=8, dtype=torch.float64)
    Aj = jnp.asarray(A)
    Xj, repj = jax.vmap(lambda y: JCG.solve_irls_cg_core(
        lambda v: Aj @ v, lambda u: Aj.T @ u, 64, 256, y, 1e-8, 80, p=p,
        k_sparsity=8, dtype=jnp.float64))(jnp.asarray(Y))
    np.testing.assert_array_equal(rep.iter.numpy(), np.asarray(repj.iter))
    np.testing.assert_array_equal(rep.spd_failure.numpy(),
                                  np.asarray(repj.spd_failure))
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), atol=1e-10)
    np.testing.assert_allclose(rep.solution_error.numpy(),
                               np.asarray(repj.solution_error), rtol=0,
                               atol=1e-12)
    assert rep.iter.max() < 80
