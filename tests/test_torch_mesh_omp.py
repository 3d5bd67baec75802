"""The port's sharded greedy routes (``parallel/sharding.py``:
``omp_sharded`` and ``cosamp_sharded``) on gloo process groups of 2 and 4
CPU ranks, against the JAX package's sharded routes on its virtual CPU
devices, on the same seeded inputs (``_torch_mesh_cases.py``; the harness
and the meshes are ``test_torch_mesh_homotopy.py``'s).

Tolerances: float64 within 1e-10 of JAX with equal iterations; float32
at "highest" within 1e-5 with equal pick counts (tol 1e-2 keeps tol² far
above the in-loop ‖r‖² rounding floor, so the all-reduced and the
unsharded sums stop alike); "certified" compares certificates, supports
and the re-solved lane. The collective contracts of test_sharding.py:693
and :800 are held as counts from ``ops/collectives.counts``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

import jax  # noqa: E402

import _torch_mesh_cases as C  # noqa: E402
from sparse_solvers_tpu.parallel import sharding as jsh  # noqa: E402
from sparse_solvers_tpu.solvers.homotopy_batch import densify_batch  # noqa

WORLDS = {2: ("2x1",), 4: ("2x2", "4x1")}
MESHES = ("2x1", "2x2", "4x1")
CORE = {"omp_core_gram": dict(gram=True),
        "omp_core_dense": dict(gram=False),
        "omp_core_sparse": dict(gram=False, k_max=6, max_it=20,
                                problem=C.P_OMP_SPARSE),
        "omp_core_gomp": dict(gram=True, picks=4)}
DRIVER = {"omp_driver": {}, "omp_driver_gram_free": dict(gram=False),
          "omp_driver_gomp": dict(picks=4),
          "omp_driver_gomp_gram_free": dict(picks=4, gram=False),
          "omp_overlap_blocks": dict(overlap_blocks=4),
          "omp_ppermute": dict(overlap_mode="ppermute")}
OTHER = ("omp_compact", "omp_certified", "omp_resolve", "cosamp")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    names = list(CORE) + list(DRIVER) + list(OTHER)
    launches = {w: C.Launch(w, [f"{m}:{c}" for m in ms for c in names],
                           tmp_path_factory.mktemp(f"w{w}"))
                for w, ms in WORLDS.items()}
    yield launches
    for launch in launches.values():
        launch.close()


def _get(runs, mesh, name):
    n_row, n_data = map(int, mesh.split("x"))
    return runs[n_row * n_data].get(f"{mesh}:{name}")


@functools.lru_cache(maxsize=None)
def _jax_mesh():
    return jsh.make_mesh(n_row=2, n_data=2, devices=jax.devices()[:4])


@functools.lru_cache(maxsize=None)
def _jax_core(name):
    kw = dict(CORE[name])
    problem = kw.pop("problem", C.P_OMP_CORE)
    max_it = kw.pop("max_it", 30)
    A, Y = problem()
    X, rep = jsh.omp_sharded(_jax_mesh(), A, Y, 1e-6, max_it, **kw)
    return np.asarray(X), np.asarray(rep.iter)


@functools.lru_cache(maxsize=None)
def _jax_driver(name):
    A, _, Y = C.P_OMP_DRIVER()
    X, rep = jsh.omp_sharded(_jax_mesh(), A, Y, C.OMP_TOL, C.OMP_IT,
                             batch_native=True, **DRIVER[name])
    return np.asarray(X), np.asarray(rep.iter)


def _truth():
    _, X0, _ = C.P_OMP_DRIVER()
    return [set(np.flatnonzero(x).tolist()) for x in X0]


def _supports(X, k=5):
    return [set(np.argsort(-np.abs(x))[:k].tolist()) for x in X]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("route", sorted(CORE))
def test_per_lane_core_matches_jax(runs, route, mesh):
    """The per-lane pick loop over a RowShardedOperator in float64, each
    correlation update (the Gram gathers, the sparse column gather and the
    dense products; test_sharding.py:654-690) and gOMP picks=4: X within
    1e-10 of JAX's, pick counts equal. The Gram form all-reduces only
    outside its loop (the Gram, Aᵀy, ‖y‖² and the final ‖r‖²); the dense
    form without a Gram all-reduces the insert's Gram column and norm,
    the correlations and ‖r‖² every pick."""
    ranks = _get(runs, mesh, route)
    got = C.same_on_every_rank(ranks)
    X, iters = _jax_core(route)
    np.testing.assert_array_equal(got["iter"], iters)
    np.testing.assert_allclose(got["X"], X, atol=1e-10)
    for r in ranks:
        if CORE[route].get("gram"):
            assert r["count_all_reduce"] == 4
        elif route == "omp_core_dense":
            trips, rest = divmod(int(r["count_all_reduce"]) - 2, 4)
            assert rest == 0 and trips in (int(r["iter"].max()),
                                           int(r["iter"].max()) + 1)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("route", sorted(DRIVER))
def test_driver_matches_jax_and_its_collective_contract(runs, route, mesh):
    """The slot-space OMP driver on row shards (K1 and K4's twins, q
    all-reduced, K4 replicated) against JAX's sharded driver in float32
    at "highest": X within 1e-5, pick counts equal, top-5 supports the
    truth. Each loop trip issues one all-reduce for q (four with
    overlap_blocks=4; S−1 ring steps and one all-gather instead where the
    ring runs, which "auto" picks at n ≥ 128·S) and, gram-free, one more
    per sub-pick for the insert column."""
    ranks = _get(runs, mesh, route)
    got = C.same_on_every_rank(ranks)
    kw = DRIVER[route]
    S, _ = map(int, mesh.split("x"))
    n = C.P_OMP_DRIVER()[0].shape[1]
    ring = kw.get("overlap_mode") == "ppermute" or (
        "overlap_blocks" not in kw and n >= 128 * S)
    # JAX's row axis is 2, where "auto" takes the ring: the all-reduce and
    # the ring differ by ulps, within the tolerance
    X, iters = _jax_driver(route)
    np.testing.assert_array_equal(got["iter"], iters)
    np.testing.assert_allclose(got["X"], X, atol=1e-5)
    assert _supports(got["X"]) == _truth()
    want = [0 if ring else (4 if "overlap_blocks" in kw else 1),
            1 if ring else 0, S - 1 if ring else 0]
    if kw.get("gram") is False:
        want[0] += kw.get("picks", 1)
    for r in ranks:
        assert len(r["trips"]) > 0
        for trip in r["trips"]:
            assert trip.tolist() == want, (trip, want)


@pytest.mark.parametrize("mesh", MESHES)
def test_compact_output(runs, mesh):
    """dense=False on the driver and on the per-lane loop densifies to the
    dense sharded solve exactly, and to JAX's within 1e-5."""
    got = C.same_on_every_rank(_get(runs, mesh, "omp_compact"))
    n = got["dense1_X"].shape[1]
    for bn in ("1", "0"):
        np.testing.assert_array_equal(
            np.asarray(densify_batch(got[f"bn{bn}_values"],
                                     got[f"bn{bn}_indices"], n)),
            got[f"dense{bn}_X"])
        np.testing.assert_array_equal(got[f"bn{bn}_iter"],
                                      got[f"dense{bn}_iter"])
    np.testing.assert_allclose(got["dense0_X"], got["dense1_X"], atol=1e-5)
    np.testing.assert_allclose(got["dense1_X"], _jax_driver("omp_driver")[0],
                               atol=1e-5)


@pytest.mark.parametrize("mesh", MESHES)
def test_certified(runs, mesh):
    """precision="certified" on both legs: the reported error is the
    all-reduced ℓ₂ residual at "high" (equal to a float64 recompute within
    rtol 1e-4, atol 1e-6), and every lane meets the tolerance or spent its
    pick budget (such lanes are reported as they are, not re-solved).
    Without ``G`` the route all-reduces its Gram at the path's one-pass
    precision, as JAX's does (sharding.py:395-398), and the driver's
    inserts then stall some lanes at the budget; with the façades' Gram,
    all-reduced once at "highest", every lane is certified within the
    tolerance and its support is the truth's."""
    got = C.same_on_every_rank(_get(runs, mesh, "omp_certified"))
    A, _, Y = C.P_OMP_DRIVER()
    for leg in ("bn1_", "bn0_", "g_"):
        X, err = got[leg + "X"], got[leg + "solution_error"]
        ref = np.linalg.norm(Y - X.astype(np.float64) @ A.T, axis=1)
        np.testing.assert_allclose(err, ref, rtol=1e-4, atol=1e-6)
        assert np.all((err <= C.OMP_TOL) | (got[leg + "iter"] == C.OMP_IT))
    for leg in ("bn0_", "g_"):
        assert np.all(got[leg + "solution_error"] <= C.OMP_TOL)
        assert _supports(got[leg + "X"]) == _truth()


@pytest.mark.parametrize("mesh", MESHES)
def test_certified_resolve_merges_the_failed_lane(runs, mesh, monkeypatch):
    """A certificate failure forced on lane 0 (the ``_cert_failures``
    seam): lane 0 is the "high" solve's bit for bit, and JAX's re-solved
    lane within 1e-5 with an equal pick count; the other lanes keep the
    certified run (within the tolerance or at the pick budget, see
    ``test_certified``)."""
    got = C.same_on_every_rank(_get(runs, mesh, "omp_resolve"))
    np.testing.assert_array_equal(got["cert_X"][0], got["high_X"][0])
    assert got["cert_iter"][0] == got["high_iter"][0]
    assert np.all((got["cert_solution_error"] <= C.OMP_TOL)
                  | (got["cert_iter"] == C.OMP_IT))
    real = jsh._cert_failures

    def spoofed(errs, iters, tolerance, max_iterations):
        bad = real(errs, iters, tolerance, max_iterations).copy()
        bad[0] = True
        return bad

    monkeypatch.setattr(jsh, "_cert_failures", spoofed)
    A, _, Y = C.P_OMP_DRIVER()
    Xj, rj = jsh.omp_sharded(_jax_mesh(), A, Y, C.OMP_TOL, C.OMP_IT,
                             precision="certified", batch_native=True)
    np.testing.assert_allclose(got["cert_X"][0], np.asarray(Xj)[0],
                               atol=1e-5)
    assert got["cert_iter"][0] == int(np.asarray(rj.iter)[0])


@pytest.mark.parametrize("mesh", MESHES)
def test_cosamp_matches_jax(runs, mesh):
    """cosamp_sharded in float64: X within 1e-10 of JAX's, rounds equal;
    each round all-reduces c = Aᵀr, the union Gram, Bᵀy and ‖r‖² once
    (and ‖y‖² once a solve)."""
    ranks = _get(runs, mesh, "cosamp")
    got = C.same_on_every_rank(ranks)
    A, _, Y = C.sparse_problem(5, 40, 96, 8, 4, np.float64)
    Xj, rj = jsh.cosamp_sharded(_jax_mesh(), A, Y, 4, 1e-8, 20)
    np.testing.assert_array_equal(got["iter"], np.asarray(rj.iter))
    np.testing.assert_allclose(got["X"], np.asarray(Xj), atol=1e-10)
    for r in ranks:
        rounds, rest = divmod(int(r["count_all_reduce"]) - 1, 4)
        assert rest == 0 and rounds >= int(r["iter"].max())
