"""The port's sharded Homotopy routes (``parallel/sharding.py``:
``homotopy_sharded``, ``gram_replicated``, ``update_column_sharded``) on
gloo process groups of 2 and 4 CPU ranks, against the JAX package's
sharded routes on its virtual CPU devices (conftest), on the same seeded
inputs.

The port runs SPMD: ``_torch_dist_child.py`` runs each case on every rank
of a row 2 × data 1 mesh (2 ranks) and of row 2 × data 2 and row 4 ×
data 1 meshes (4 ranks); one launch per world serves the whole file. JAX
runs each route once, on a row 2 × data 2 mesh. Every rank must return
bit-identical results: replicated state that differed by one ulp between
the ranks of a row group would make their loops decide differently and
hang the next collective.

Tolerances: float64 solutions within 1e-10 of JAX's and equal iterations;
float32 at "high" within 1e-5 and equal iterations (the row split changes
the summation order of every all-reduced product by ulps, on
well-conditioned problems only); "certified" (bf16 K1 products, which JAX
on the CPU does not round) compares certificates, supports and the
re-solved lane, not trajectories.

The collective contracts of the JAX HLO tests (test_sharding.py:296, :311,
:424, :568, :971) are held as counts from ``ops/collectives.counts``, per
loop trip of the driver and per solve of the per-lane core.
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
DRIVER = {"hom_driver": {}, "hom_driver_gram_free": dict(gram=False),
          "hom_overlap_blocks": dict(overlap_blocks=4),
          "hom_ppermute": dict(overlap_mode="ppermute"),
          "hom_ppermute_gram_free": dict(gram=False,
                                         overlap_mode="ppermute")}
CORE = {"hom_core": {}, "hom_core_dense": dict(gram=False),
        "hom_core_split": dict(gram=False, overlap_split=2)}
OTHER = ("hom_compact", "hom_certified", "hom_resolve",
         "hom_core_sparse_contract", "hom_core_dense_contract",
         "gram_and_update")


def _specs(meshes):
    names = list(DRIVER) + list(CORE) + list(OTHER)
    specs = [f"{m}:{c}" for m in meshes for c in names]
    if "2x2" in meshes:
        specs.append("2x2:hom_divergence")
    return specs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    launches = {w: C.Launch(w, _specs(ms), tmp_path_factory.mktemp(f"w{w}"))
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
def _jax(route, **kw):
    if route == "driver":
        A, _, Y = C.P_DRIVER()
        out = jsh.homotopy_sharded(_jax_mesh(), A, Y, C.HOM_TOL, C.HOM_IT,
                                   batch_native=True, **kw)
    elif route == "core":
        A, Y = C.P_CORE()
        out = jsh.homotopy_sharded(_jax_mesh(), A, Y, 0.01, 50, **kw)
    else:
        A, _, Y = C.P_CERT()
        out = jsh.homotopy_sharded(_jax_mesh(), A, Y, C.CERT_TOL, 60,
                                   precision="certified", **kw)
    return np.asarray(out[0]), np.asarray(out[-1].iter)


def _supports(X, k):
    return [set(np.argsort(-np.abs(x))[:k].tolist()) for x in X]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("route", sorted(DRIVER))
def test_driver_matches_jax_and_its_collective_contract(runs, route, mesh):
    """The slot-space driver on row shards (K1-K3's twins replicated, q
    all-reduced, or reduced around the ring) against JAX's sharded driver:
    float32 at "high", X within 1e-5 with equal iterations. Each loop trip
    issues one all-reduce for q with a Gram, one more for the gram-free
    insert column, four with overlap_blocks=4, and S−1 ring steps and one
    all-gather in place of q's all-reduce in ppermute mode, whose loops
    all-reduce a continue flag each trip on a mesh with a data axis."""
    ranks = _get(runs, mesh, route)
    got = C.same_on_every_rank(ranks)
    kw = DRIVER[route]
    X, iters = _jax("driver", **kw)
    np.testing.assert_array_equal(got["iter"], iters)
    np.testing.assert_allclose(got["X"], X, atol=1e-5)
    S, D = map(int, mesh.split("x"))
    ring = kw.get("overlap_mode") == "ppermute"
    want = [0 if ring else (4 if "overlap_blocks" in kw else 1),
            1 if ring else 0, S - 1 if ring else 0]
    if kw.get("gram") is False:
        want[0] += 1
    for r in ranks:
        assert len(r["trips"]) >= int(r["iter"].max())
        for trip in r["trips"]:
            assert trip.tolist() == want, (trip, want)
        for trips, flags in r["loops"]:
            assert flags == (trips + 1 if ring and D > 1 else 0)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("route", sorted(CORE))
def test_per_lane_core_matches_jax(runs, route, mesh):
    """The per-lane core over a RowShardedOperator (float64, the route
    JAX takes for it; test_sharding.py:36-51), with a replicated Gram, the
    dense route and the split correlation all-reduces: X within 1e-10 of
    JAX's, iterations equal."""
    got = C.same_on_every_rank(_get(runs, mesh, route))
    X, iters = _jax("core", **CORE[route])
    np.testing.assert_array_equal(got["iter"], iters)
    np.testing.assert_allclose(got["X"], X, atol=1e-10)


@pytest.mark.parametrize("mesh", MESHES)
def test_per_lane_collective_contract(runs, mesh):
    """test_sharding.py:296 and :311 as counts: with the replicated Gram
    and few lanes a rank, the per-lane core's loop issues no all-reduce
    (the Gram's and Aᵀy's are the solve's only two); without a Gram each
    iteration all-reduces q, the insert's Gram column and its norm."""
    for r in _get(runs, mesh, "hom_core_sparse_contract"):
        assert r["count_all_reduce"] == 2
    for r in _get(runs, mesh, "hom_core_dense_contract"):
        b_loc = len(r["iter"]) // r["n_data"]
        lanes = r["iter"][r["data_index"] * b_loc:][:b_loc]
        assert r["count_all_reduce"] == 3 + 3 * int(lanes.max())


@pytest.mark.parametrize("mesh", MESHES)
def test_compact_output(runs, mesh):
    """dense=False on the driver and on the per-lane core: the compact
    (values, indices) densify to the dense sharded solve (the driver's
    exactly, the core's within 1e-5) and to JAX's within 1e-5."""
    got = C.same_on_every_rank(_get(runs, mesh, "hom_compact"))
    n = got["dense_X"].shape[1]
    np.testing.assert_array_equal(
        np.asarray(densify_batch(got["values"], got["indices"], n)),
        got["dense_X"])
    core = np.asarray(densify_batch(got["core_values"], got["core_indices"],
                                    n))
    np.testing.assert_allclose(core, got["dense_X"], atol=1e-5)
    np.testing.assert_allclose(got["dense_X"], _jax("driver")[0], atol=1e-5)
    assert got["values"].shape == (8, C.HOM_IT + 1)


@pytest.mark.parametrize("mesh", MESHES)
def test_certified(runs, mesh):
    """precision="certified" on both routes: every certificate within the
    tolerance and equal to a float64 recompute of ‖Aᵀ(y−Ax)‖∞ (rtol 1e-4:
    the certificate is computed in f32 at "high"); the supports are the
    truth's, as JAX's are."""
    got = C.same_on_every_rank(_get(runs, mesh, "hom_certified"))
    A, X0, Y = C.P_CERT()
    truth = [set(np.flatnonzero(x).tolist()) for x in X0]
    Xj, _ = _jax("cert", batch_native=True)
    assert _supports(Xj, 4) == truth
    A64 = A.astype(np.float64)
    for bn in ("bn1_", "bn0_"):
        X, err = got[bn + "X"], got[bn + "solution_error"]
        assert np.all(err <= C.CERT_TOL)
        c = (Y - X.astype(np.float64) @ A64.T) @ A64
        np.testing.assert_allclose(err, np.abs(c).max(axis=1), rtol=1e-4)
        assert _supports(X, 4) == truth


@pytest.mark.parametrize("mesh", MESHES)
def test_certified_resolve_merges_the_failed_lane(runs, mesh, monkeypatch):
    """A certificate failure forced on lane 0 through the port's
    ``certify.failed_lanes`` seam and JAX's ``_cert_failures`` (every rank
    sees the gathered batch, so every rank takes the re-solve): lane 0 is
    the "high" solve's, bit for bit, and matches JAX's re-solved lane
    within 1e-5 with equal iterations."""
    got = C.same_on_every_rank(_get(runs, mesh, "hom_resolve"))
    np.testing.assert_array_equal(got["cert_X"][0], got["high_X"][0])
    assert got["cert_iter"][0] == got["high_iter"][0]
    assert np.all(got["cert_solution_error"][1:] <= C.CERT_TOL)
    real = jsh._cert_failures

    def spoofed(errs, iters, tolerance, max_iterations):
        bad = real(errs, iters, tolerance, max_iterations).copy()
        bad[0] = True
        return bad

    monkeypatch.setattr(jsh, "_cert_failures", spoofed)
    A, _, Y = C.P_CERT()
    Xj, rj = jsh.homotopy_sharded(_jax_mesh(), A, Y, C.CERT_TOL, 60,
                                  precision="certified", batch_native=True)
    np.testing.assert_allclose(got["cert_X"][0], np.asarray(Xj)[0],
                               atol=1e-5)
    assert got["cert_iter"][0] == int(np.asarray(rj.iter)[0])


def test_ring_survives_data_slice_divergence(runs):
    """test_sharding.py:1084: data slice 0's lanes stop after a few
    iterations while slice 1's run tens; the ring's loops all-reduce a
    continue flag over every rank, so all four ranks run the same trips,
    and the results match the all-reduce form lane for lane."""
    ranks = _get(runs, "2x2", "hom_divergence")
    got = C.same_on_every_rank(ranks)
    it = got["ring_iter"]
    assert it[:4].max() < it[4:].min()
    np.testing.assert_array_equal(it, got["psum_iter"])
    np.testing.assert_allclose(got["ring_X"], got["psum_X"], atol=1e-4)
    loops = [r["ring_loops"].tolist() for r in ranks]
    assert all(lp == loops[0] for lp in loops)
    for trips, flags in loops[0]:
        assert flags == trips + 1


@pytest.mark.parametrize("mesh", MESHES)
def test_gram_replicated_and_update_column(runs, mesh):
    """gram_replicated (one all-reduced product at "highest") and
    update_column_sharded (the column set, the Gram's row and column from
    one all-reduced Aᵀv) against JAX's and numpy's, within 1e-5."""
    got = C.same_on_every_rank(_get(runs, mesh, "gram_and_update"))
    A, _, _ = C.P_DRIVER()
    jm = _jax_mesh()
    Gj = jsh.gram_replicated(jm, jax.numpy.asarray(A))
    np.testing.assert_allclose(got["G"], np.asarray(Gj), atol=1e-5)
    v = C.update_vector(A.shape[0])
    A2 = A.copy()
    A2[:, C.UPDATE_J] = v
    np.testing.assert_array_equal(got["A2"], A2)
    np.testing.assert_array_equal(got["A3"], A2)
    assert got["no_gram"]
    Aj2, Gj2 = jsh.update_column_sharded(jm, jax.numpy.asarray(A), Gj, v,
                                         C.UPDATE_J)
    np.testing.assert_allclose(got["G2"], np.asarray(Gj2), atol=1e-5)
    np.testing.assert_allclose(got["G2"], A2.T.astype(np.float64) @ A2,
                               atol=1e-5)
    for r in _get(runs, mesh, "gram_and_update"):
        assert r["count_all_reduce"] == 2   # the Gram, then Aᵀv
