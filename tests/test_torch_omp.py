"""The PyTorch port's OMP/gOMP path against the JAX package's, on the CPU.

K4 (``omp_insert``): the port's twin against the Pallas kernel in interpret
mode. The driver (``solve_omp_batch``) and the façade (``Omp``): the JAX
driver with its Pallas kernels in interpret mode (``use_kernel=False``, or
``SS_BATCH_NATIVE=1`` through ``ss.Omp(..., engine="jax")``), against the
port on ``device="cpu"``, where every kernel wrapper runs its plain twin.

Tolerances: K4 deg exact, lanes that are not gated bit-identical, inv and
coef within 1e-5 of each tensor's scale (sums in another order). Drivers:
iteration counts exact, X within atol 1e-5. Trajectories are compared at
"high" and "highest" only: at "default" (and so "certified") the port's q
pass really runs at bf16 while JAX on the CPU does not, so there the tests
hold what "certified" promises — every certificate within the tolerance
and equal to a float64 ‖y − Ax‖₂ recompute, and the recovered supports.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

import sparse_solvers_tpu as ss
import sparse_solvers_tpu_torch as pt
from _torch_cases import TORCH_ROUTE, compressive_problem, omp_insert_case
from sparse_solvers_tpu.ops import blas as jblas
from sparse_solvers_tpu.ops.pallas import omp_insert as JO
from sparse_solvers_tpu.solvers import homotopy_batch as JHB
from sparse_solvers_tpu.solvers import omp_batch as JOB
from sparse_solvers_tpu_torch import api as papi
from sparse_solvers_tpu_torch.ops import blas as pblas
from sparse_solvers_tpu_torch.ops import dispatch
from sparse_solvers_tpu_torch.ops.cuda import omp_insert as PO
from sparse_solvers_tpu_torch.solvers import omp_batch as POB

TOL = 1e-2


def _gram(A):
    return np.array(jnp.asarray(A).T @ jnp.asarray(A))


def _support(x, k):
    return set(np.argsort(-np.abs(x))[:k].tolist())


# --- K4 ----------------------------------------------------------------------

@pytest.mark.parametrize("b,K", [(11, 9), (19, 13)])
def test_k4_twin_matches_pallas_interpret(b, K):
    args = omp_insert_case(b, K, seed=K)
    inv_j, coef_j, deg_j = (np.asarray(o) for o in JO.omp_insert(
        *map(jnp.asarray, args), interpret=True))
    inv = torch.from_numpy(args[0].copy())
    coef, deg = PO.omp_insert(inv, *map(torch.from_numpy, args[1:]))
    assert coef.dtype == torch.float32 and deg.dtype == torch.bool
    np.testing.assert_array_equal(deg.numpy(), deg_j)
    assert bool(deg[1]) and int(deg.sum()) == 1
    gated = args[5] & ~deg.numpy()
    # lanes that are not gated keep their inverse bit for bit
    assert np.array_equal(inv.numpy()[~gated], args[0][~gated])
    for got, want in ((inv.numpy(), inv_j), (coef.numpy(), coef_j)):
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    # the insert grew each gated lane's inverse by one slot
    for lane in np.flatnonzero(gated):
        assert inv[lane, args[2][lane], args[2][lane]] > 0


def test_k4_twin_is_out_of_place_and_counts_no_launch():
    args = [torch.from_numpy(a) for a in omp_insert_case(7, 9)]
    keep = [a.clone() for a in args]
    before = dict(dispatch.launches)
    PO.omp_insert_plain(*args)
    for a, k in zip(args, keep):
        assert torch.equal(a, k)
    PO.omp_insert(*args)
    assert dispatch.launches == before
    assert not torch.equal(args[0], keep[0])


# --- the driver ----------------------------------------------------------------

# 20-sparse lanes cross the first two tiers [16, 24, 48] of k_max 48
LADDER_A, LADDER_Y, LADDER_X = compressive_problem(128, 256, 20, 10, seed=2)


@functools.lru_cache(maxsize=None)
def _ladder_gram():
    return _gram(LADDER_A)


@functools.lru_cache(maxsize=None)
def _jax_omp(prec, picks, tiers, dense=True):
    """The JAX driver's result on the ladder problem, cached by tier list:
    ladder True and None plan the same tiers at k_max 48 and so run the
    same program."""
    f = jax.jit(functools.partial(
        JOB.solve_omp_batch, max_iterations=48, k_max=48, use_kernel=False,
        ladder=list(tiers), picks=picks, dense=dense))
    with jblas.precision_scope(prec):
        out, rep = f(jnp.asarray(LADDER_A), jnp.asarray(_ladder_gram()),
                     jnp.asarray(LADDER_Y), TOL)
    out = (np.asarray(out) if dense
           else (np.asarray(out[0]), np.asarray(out[1])))
    return out, np.asarray(rep.iter), np.asarray(rep.solution_error)


def _port_omp(A, G, Y, prec, picks, ladder, dense=True, max_it=48,
              k_max=48):
    t = torch.from_numpy
    with pblas.precision_scope(prec):
        return POB.solve_omp_batch(t(A), t(G), t(Y), TOL, max_it, k_max,
                                   ladder=ladder, dense=dense, picks=picks)


@pytest.mark.parametrize("ladder", [False, True, None])
@pytest.mark.parametrize("picks", [1, 2, 4])
@pytest.mark.parametrize("prec", ["high", "highest"])
def test_driver_matches_jax_driver(prec, picks, ladder):
    A, G, Y, Xt = LADDER_A, _ladder_gram(), LADDER_Y, LADDER_X
    tiers = tuple(POB._plan_tiers(48, 48, ladder))
    assert tiers == tuple(JHB._plan_tiers(48, 48, ladder))
    Xj, ij, ej = _jax_omp(prec, picks, tiers)
    X, rep = _port_omp(A, G, Y, prec, picks, ladder)
    assert rep.iter.dtype == torch.int32
    np.testing.assert_array_equal(rep.iter.numpy(), ij)
    np.testing.assert_allclose(X.numpy(), Xj, atol=1e-5)
    np.testing.assert_allclose(rep.solution_error.numpy(), ej, atol=1e-5)
    assert (rep.solution_error.numpy() <= TOL).all()
    assert ij.max() > 16        # the lanes crossed a tier boundary
    for lane in range(len(Y)):
        assert _support(X[lane].numpy(), 20) == set(
            np.flatnonzero(Xt[lane]).tolist())


@pytest.mark.parametrize("picks", [1, 4])
def test_compact_output_matches_jax(picks):
    A, G, Y = LADDER_A, _ladder_gram(), LADDER_Y
    tiers = tuple(POB._plan_tiers(48, 48, None))
    (vj, ij_), itj, _ = _jax_omp("high", picks, tiers, dense=False)
    (v, ix), rep = _port_omp(A, G, Y, "high", picks, None, dense=False)
    assert v.shape == ix.shape == (len(Y), 48) and ix.dtype == torch.int32
    np.testing.assert_array_equal(ix.numpy(), ij_)
    np.testing.assert_allclose(v.numpy(), vj, atol=1e-5)
    np.testing.assert_array_equal(rep.iter.numpy(), itj)
    X, _ = _port_omp(A, G, Y, "high", picks, None)
    assert torch.equal(pt.densify_batch(v, ix, A.shape[1]), X)


def test_empty_batch():
    A, _, _ = compressive_problem(64, 128, 4, 1)
    Y0 = np.zeros((0, 64), np.float32)
    Xj, rj = JOB.solve_omp_batch(jnp.asarray(A), jnp.asarray(_gram(A)),
                                 jnp.asarray(Y0), TOL, 16, 16)
    X, rep = _port_omp(A, _gram(A), Y0, "high", 1, None, max_it=16,
                       k_max=16)
    assert X.shape == Xj.shape == (0, 128)
    assert rep.iter.shape == rj.iter.shape == (0,)
    (v, i), _ = _port_omp(A, _gram(A), Y0, "high", 2, None, dense=False,
                          max_it=16, k_max=16)
    assert v.shape == i.shape == (0, 16) and i.dtype == torch.int32


def _vacant_nonzero(inv, kk):
    """Lanes whose inverse has a nonzero entry in a row or column at a
    slot ≥ kk (kk clamped to the capacity)."""
    K = inv.shape[1]
    vacant = torch.arange(K)[None, :] >= kk.clamp(0, K)[:, None]   # (b, K)
    outside = vacant[:, :, None] | vacant[:, None, :]
    return torch.nonzero((inv != 0) & outside)[:, 0].unique().tolist()


@pytest.mark.parametrize("picks", [1, 4])
def test_driver_keeps_vacant_slots_of_the_inverse_zero(monkeypatch, picks):
    """The CUDA K4 reads only a lane's live block: it relies on every row
    and column of the inverse at slots ≥ kk being exactly zero. The driver
    writes the inverse only through K4 inside a round and zero-pads it at
    a tier boundary, so holding each K4 call's input (at its kk) and
    output (at kk + 1 where the insert was gated) holds the state after
    every round, across the embed from tier 16 into tier 24 (the 20-sparse
    lanes stop there).

    Broken lanes are outside that contract: a lane that blew (non-finite
    coef or rss, omp_batch.py:219-221) had its inverse grown in place by
    K4 before the driver knew, keeps its old kk and stops, so its row kk
    may be stale; its coef is never committed again. No lane blows on this
    problem (asserted), and degenerate inserts are never written, so here
    the contract covers every lane."""
    seen = []
    real = PO.omp_insert

    def spy(inv, u1, kk, vtv, b_act, doins):
        assert _vacant_nonzero(inv, kk) == []
        coef, deg = real(inv, u1, kk, vtv, b_act, doins)
        assert bool(torch.isfinite(coef).all())
        grown = kk + (doins & ~deg).to(kk.dtype)
        assert _vacant_nonzero(inv, grown) == []
        seen.append((inv.shape[1], int(grown.max())))
        return coef, deg

    monkeypatch.setattr(POB._oins, "omp_insert", spy)
    A, G, Y = LADDER_A, _ladder_gram(), LADDER_Y
    X, rep = _port_omp(A, G, Y, "high", picks, True)
    assert (rep.solution_error.numpy() <= TOL).all()
    assert sorted({K for K, _ in seen}) == [16, 24]
    assert max(k for _, k in seen) >= 20


@pytest.mark.parametrize("picks", [1, 4])
def test_lane_at_capacity_writes_no_slot(monkeypatch, picks):
    """Lane 0 needs 24 picks against k_max 10; the others need 3 to 6. At
    picks=4, lane 0 fills slot 9 mid-round and the round's later
    sub-inserts see kk == K (where JAX's ``.at[].set`` drops the write):
    no slot may be written then, so lane 0's slot K−1 keeps its pick."""
    rng = np.random.RandomState(4)
    m, n, K = 64, 160, 10
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    Xt = np.zeros((5, n), np.float32)
    for lane, k in enumerate((24, 3, 4, 5, 6)):
        Xt[lane, rng.choice(n, k, replace=False)] = rng.uniform(0.5, 1, k)
    Y = (Xt @ A.T).astype(np.float32)
    G = _gram(A)
    seen = []
    real = PO.omp_insert

    def spy(inv, u1, kk, vtv, b_act, doins):
        seen.append((kk.clone(), doins.clone(), b_act.clone()))
        return real(inv, u1, kk, vtv, b_act, doins)

    monkeypatch.setattr(POB._oins, "omp_insert", spy)
    (v, ix), rep = _port_omp(A, G, Y, "high", picks, False, dense=False,
                             max_it=40, k_max=K)
    monkeypatch.undo()
    f = jax.jit(functools.partial(
        JOB.solve_omp_batch, max_iterations=40, k_max=K, use_kernel=False,
        ladder=False, picks=picks, dense=False))
    with jblas.precision_scope("high"):
        (vj, ij_), rj = f(jnp.asarray(A), jnp.asarray(G), jnp.asarray(Y),
                          TOL)
    np.testing.assert_array_equal(rep.iter.numpy(), np.asarray(rj.iter))
    np.testing.assert_array_equal(ix.numpy(), np.asarray(ij_))
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), atol=1e-5)
    assert int(rep.iter[0]) == K and (ix[0] < n).all()
    assert len(set(ix[0].tolist())) == K
    full = [(kk, b_act) for kk, _, b_act in seen if int(kk[0]) == K]
    if picks > 1:
        assert full, "lane 0 never sat at capacity inside a round"
    for _, b_act in full:
        # the K-th committed rhs entry is still in place
        assert float(b_act[0, K - 1]) != 0.0


def test_degenerate_duplicate_columns_break_finite(monkeypatch):
    """tests/test_omp.py:393: a dictionary of eight copies of six columns,
    at a tolerance (1e-7, so tol² = 1e-14) far below the f32 rounding floor
    of the rss identity. Lanes stop finitely, as in JAX. Once the true
    support is in, whether a lane stops or takes one more pick of a copy
    (den at rounding level, not exactly 0) hangs on summation order, so
    lanes are held to JAX only where the pick counts agree (ROADMAP.md
    Queue 3)."""
    rng = np.random.RandomState(8)
    base = rng.randn(24, 6).astype(np.float32)
    A = np.concatenate([base] * 8, axis=1)
    A /= np.linalg.norm(A, axis=0)
    Y = np.stack([(A[:, :3] @ rng.uniform(0.5, 1, 3).astype(np.float32))
                  for _ in range(4)])
    monkeypatch.setenv("SS_BATCH_NATIVE", "1")
    js = ss.Omp(A, engine="jax", precision="high")
    assert js.explain(batch=4, max_iterations=40)["corr"] == "driver"
    Xj, rj = js.solve_batch(Y, tolerance=1e-7, max_iterations=40)
    port = pt.Omp.from_numpy(A, np.array(js._G), precision="high",
                             **TORCH_ROUTE)
    X, rep = port.solve_batch(Y, tolerance=1e-7, max_iterations=40)
    assert np.isfinite(X.numpy()).all()
    assert np.isfinite(rep.solution_error.numpy()).all()
    assert (rep.iter.numpy() <= 7).all()
    agree = rep.iter.numpy() == np.asarray(rj.iter)
    assert agree.sum() >= 3
    np.testing.assert_allclose(X.numpy()[agree], np.asarray(Xj)[agree],
                               atol=1e-5)


# --- the façade ------------------------------------------------------------------

@pytest.fixture(scope="module")
def problem():
    # b·k_max = 16·24 >= 2m = 256: the driver route
    return compressive_problem(128, 256, 8, 16, seed=3)


def _jax_omp_solver(monkeypatch, A, **kw):
    monkeypatch.setenv("SS_BATCH_NATIVE", "1")
    return ss.Omp(A, engine="jax", **kw)


@pytest.mark.parametrize("picks", [1, 4])
def test_facade_high_matches_jax(problem, monkeypatch, picks):
    A, Y, _ = problem
    js = _jax_omp_solver(monkeypatch, A, precision="high", picks=picks)
    Xj, rj = js.solve_batch(Y, TOL, 24)
    port = pt.Omp.from_numpy(A, np.array(js._G), precision="high",
                             picks=picks, **TORCH_ROUTE)
    X, rep = port.solve_batch(Y, TOL, 24)
    np.testing.assert_array_equal(rep.iter.numpy(), np.asarray(rj.iter))
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), atol=1e-5)
    np.testing.assert_allclose(rep.solution_error.numpy(),
                               np.asarray(rj.solution_error), atol=1e-5)


@pytest.mark.parametrize("picks", [1, 4])
def test_certified_certificates_and_supports(problem, monkeypatch, picks):
    """Noise of norm about 4.5e-3 keeps each lane's final residual well
    above the f32 rounding floor, where a relative comparison means
    something."""
    A, Y, Xt = problem
    Y = Y + 4e-4 * np.random.RandomState(6).randn(*Y.shape).astype(
        np.float32)
    X, rep = pt.Omp(A, picks=picks, **TORCH_ROUTE).solve_batch(Y, TOL, 24)
    X, err = X.numpy(), rep.solution_error.numpy()
    assert np.all(err <= TOL)
    r = Y.astype(np.float64) - X.astype(np.float64) @ A.T.astype(np.float64)
    np.testing.assert_allclose(err, np.linalg.norm(r, axis=1), rtol=1e-4)
    Xj, rj = _jax_omp_solver(monkeypatch, A, picks=picks).solve_batch(
        Y, TOL, 24)
    Xj = np.asarray(Xj)
    assert np.all(np.asarray(rj.solution_error) <= TOL)
    for lane in range(len(Y)):
        truth = set(np.flatnonzero(Xt[lane]).tolist())
        assert _support(X[lane], 8) == truth == _support(Xj[lane], 8)


@pytest.mark.parametrize("dense", [True, False])
def test_certified_resolve_merge(problem, monkeypatch, dense):
    """Forced certificate failures (one too large, one NaN: the NaN-safe
    predicate must count it as failing) re-solve the batch at "high" and
    merge exactly those lanes (api.py:1838-1861). The driver's certificate
    is spoofed on its first call, the certified pass; the re-solve's
    certificate is reported as it is."""
    A, Y, _ = problem
    real = POB.l2_certificate
    calls = []

    def spoofed(Am, x, y):
        err = real(Am, x, y)
        calls.append(len(calls))
        if len(calls) == 1:
            err = err.clone()
            err[1], err[3] = 1e3, float("nan")
        return err

    def run(precision):
        out = pt.Omp(A, precision=precision, **TORCH_ROUTE).solve_batch(
            Y, TOL, 24, dense=dense)
        X = out[0] if dense else pt.densify_batch(out[0], out[1], 256)
        return X, out[-1]

    monkeypatch.setattr(POB, "l2_certificate", spoofed)
    Xc, rc = run("certified")
    monkeypatch.undo()
    assert calls == [0, 1]   # the certified pass and the re-solve
    Xf, rf = run("certified")
    Xh, rh = run("high")
    for lane in range(len(Y)):
        src_X, src_r = (Xh, rh) if lane in (1, 3) else (Xf, rf)
        assert torch.equal(Xc[lane], src_X[lane])
        assert int(rc.iter[lane]) == int(src_r.iter[lane])
        assert float(rc.solution_error[lane]) == float(
            src_r.solution_error[lane])
    assert np.all(rc.solution_error.numpy() <= TOL)


def test_certified_reports_the_driver_certificate(problem, monkeypatch):
    """On the driver route the façade reports the driver's ℓ₂ certificate
    as it is and never takes it again (api.py:1726-1727)."""
    A, Y, _ = problem

    def refuse(*args):
        raise AssertionError("_certified_l2_error on the driver route")

    monkeypatch.setattr(papi, "_certified_l2_error", refuse)
    solver = pt.Omp(A, **TORCH_ROUTE)
    X, rep = solver.solve_batch(Y, TOL, 24)
    Xd, repd = solver.solve_batch_on_device(torch.from_numpy(Y), TOL, 24)
    assert np.all(rep.solution_error.numpy() <= TOL)   # no lane re-solved
    assert torch.equal(X, Xd)
    assert torch.equal(rep.solution_error, repd.solution_error)


def test_exhausted_lanes_are_not_resolved(problem, monkeypatch):
    """A lane that ran out of picks is honestly non-convergent: its failing
    certificate is reported as-is, with no re-solve."""
    A, Y, _ = problem
    calls = []
    real = papi.Omp._fn

    def counting(self, *a, **kw):
        calls.append(kw.get("precision"))
        return real(self, *a, **kw)

    monkeypatch.setattr(papi.Omp, "_fn", counting)
    X, rep = pt.Omp(A, k_max=24, **TORCH_ROUTE).solve_batch(Y, 1e-30, 4)
    assert np.all(rep.iter.numpy() == 4)
    assert not np.any(rep.solution_error.numpy() <= 1e-30)
    assert calls == [None]


def test_on_device_entry_and_compact_output(problem):
    A, Y, _ = problem
    solver = pt.Omp(A, precision="high", **TORCH_ROUTE)
    X, rep = solver.solve_batch(Y, TOL, 24)
    vals, idxs, repc = solver.solve_batch(Y, TOL, 24, dense=False)
    assert vals.shape == idxs.shape == (16, 24)
    assert torch.equal(pt.densify_batch(vals, idxs, 256), X)
    Xd, repd = solver.solve_batch_on_device(torch.from_numpy(Y), TOL, 24)
    assert torch.equal(Xd, X) and torch.equal(repd.iter, rep.iter)
    (v2, i2), _ = solver.solve_batch_on_device(torch.from_numpy(Y), TOL, 24,
                                               dense=False)
    assert torch.equal(v2, vals) and torch.equal(i2, idxs)
    assert isinstance(pt.OmpReport(), pt.OmpReport)


@pytest.mark.parametrize("prec", ["certified", "high"])
@pytest.mark.parametrize("picks", [1, 3])
def test_explain_shared_keys_match_jax(problem, monkeypatch, prec, picks):
    A, _, _ = problem
    mine = pt.Omp(A, precision=prec, picks=picks, **TORCH_ROUTE).explain(
        batch=16, max_iterations=24)
    theirs = _jax_omp_solver(monkeypatch, A, precision=prec,
                             picks=picks).explain(batch=16,
                                                  max_iterations=24)
    for key in ("corr", "k_max", "precision", "path_precision", "picks",
                "gram_free", "formulation"):
        assert mine.get(key) == theirs.get(key), key
    assert mine["capacity_tiers"] == JHB._plan_tiers(24, 24, None)
    assert mine["fused_q"] == (prec == "certified")
    want = {"omp_insert"} | ({"normal_matvec_fused_bf16"}
                             if prec == "certified" else set())
    assert set(mine["kernels"]) == want
    assert set(mine["kernels"].values()) == {"plain torch twin"}


@pytest.mark.parametrize("kw", [
    {"mode": "slow"}, {"engine": "gpu"}, {"precision": "fastest"},
    {"mode": "exact", "precision": "certified"},
    {"mode": "exact", "engine": "native"}, {"mode": "exact", "gram": True},
    {"picks": 0}, {"picks": 2.0}, {"picks": 9}, {"k_max": 0},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_validation_matches_jax(kw):
    A = np.eye(8, dtype=np.float32)
    with pytest.raises(ValueError) as mine:
        pt.Omp(A, device="cpu", **kw)
    with pytest.raises(ValueError) as theirs:
        ss.Omp(A, **kw)
    # the same parameter is named first
    assert str(mine.value).split()[0] == str(theirs.value).split()[0]


def test_solve_batch_argument_errors():
    solver = pt.Omp(np.eye(8, dtype=np.float32), device="cpu")
    with pytest.raises(ValueError, match="max_iterations must be >= 1"):
        solver.solve_batch(np.ones((8, 8), np.float32), TOL, 0)
    with pytest.raises(ValueError, match="Expected signals of length 8"):
        solver.solve_batch(np.ones((2, 7), np.float32), TOL, 10)


# mesh= is ported (parallel/sharding.py): what is not a Mesh is refused,
# as JAX's _check_mesh refuses what is not a jax.sharding.Mesh
UNPORTED = {
    "mesh": lambda A: pt.Omp(A, mesh=object(), device="cpu"),
}


@pytest.mark.parametrize("route", sorted(UNPORTED))
def test_unported_routes_raise(route):
    A, _, _ = compressive_problem(64, 128, 4, 1)
    with pytest.raises(ValueError, match="mesh must be a .*Mesh"):
        UNPORTED[route](A)


@pytest.mark.parametrize("engine,picks", [("native", 1), ("native", 4),
                                          ("auto", 1)])
def test_native_route_runs_and_matches_jax(engine, picks):
    """The host engine through the port's façade equals the JAX package's
    native route (the same C++ source): solve, solve_batch and its compact
    form, with k_max in the plan."""
    A, Y, _ = compressive_problem(64, 128, 4, 3)
    solver = pt.Omp(A, engine=engine, picks=picks, device="cpu")
    theirs = ss.Omp(A, engine="native", picks=picks)
    got, want = solver.explain(max_iterations=24), theirs.explain(
        max_iterations=24)
    assert got["engine"] == "native" and got["k_max"] == want["k_max"]
    x, rep = solver.solve(Y[0], 1e-4, 24)
    xj, repj = theirs.solve(Y[0], 1e-4, 24)
    assert isinstance(rep, pt.OmpReport)
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
    assert (rep.iter, rep.solution_error) == (repj.iter, repj.solution_error)
    X, reps = solver.solve_batch(Y, 1e-4, 24)
    Xj, repsj = theirs.solve_batch(Y, 1e-4, 24)
    np.testing.assert_array_equal(X.numpy(), np.asarray(Xj))
    np.testing.assert_array_equal(reps.iter.numpy(), np.asarray(repsj.iter))
    vals, idxs, _ = solver.solve_batch(Y, 1e-4, 24, dense=False)
    jv, ji, _ = theirs.solve_batch(Y, 1e-4, 24, dense=False)
    np.testing.assert_array_equal(idxs.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
