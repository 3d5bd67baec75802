"""The port's ``mesh=`` façades and ``parallel/distributed.py`` on gloo
process groups of 2 and 4 CPU ranks, against the JAX package's mesh
façades (tests/test_mesh_api.py, case for case) and the port's own
single-device façades, on the same seeded inputs
(``_torch_mesh_cases.py``; the harness and the meshes are
``test_torch_mesh_homotopy.py``'s).

Every rank constructs the same façade from the same A and calls it with
the same signals (SPMD); each gets the whole answer. Batches of 7 lanes
pad to the data axis and m = 37 to the row axis, and both are trimmed.
Tolerances: float32 at "high" within 1e-5 of JAX's mesh façade and of
the port's single-device one with equal iterations; float64 IRLS within
1e-10; "certified" compares certificates and supports.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")


import _torch_mesh_cases as C  # noqa: E402
import sparse_solvers_tpu as ss  # noqa: E402
import sparse_solvers_tpu_torch as pt  # noqa: E402
from sparse_solvers_tpu.parallel import sharding as jsh  # noqa: E402
from sparse_solvers_tpu_torch.parallel import distributed  # noqa: E402
from sparse_solvers_tpu_torch.parallel import sharding as psh  # noqa: E402

WORLDS = {2: ("2x1",), 4: ("2x2", "4x1")}
MESHES = ("2x1", "2x2", "4x1")
NAMES = ("api_homotopy", "api_omp", "api_irls", "api_irls_cg", "api_cosamp",
         "api_update_column", "api_errors", "dist_helpers")
SINGLE = dict(device="cpu", engine="jax")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    launches = {w: C.Launch(w, [f"{m}:{c}" for m in ms for c in NAMES],
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
    return jsh.make_mesh(n_row=4, n_data=2)


@pytest.mark.parametrize("mesh", MESHES)
def test_homotopy_mesh(runs, mesh):
    """test_mesh_api.py:34-58 and :211: solve_batch, solve, the compact
    form and the on-device entries through the mesh equal JAX's mesh
    façade and the port's single-device façade within 1e-5, iterations
    equal; the replicated Gram is cached; at "certified" every
    certificate is within the tolerance and the supports are the truth's."""
    got = C.same_on_every_rank(_get(runs, mesh, "api_homotopy"))
    A, X0, Y = C.P_FACADE()
    Xj, rj = ss.Homotopy(A, mesh=_jax_mesh(), precision="high").solve_batch(
        Y, 1e-3, 50)
    single = pt.Homotopy(A, precision="high", **SINGLE)
    Xs, rs = single.solve_batch(Y, 1e-3, 50)
    for X, it in ((got["X"], got["iter"]),
                  (got["device_X"], got["device_iter"])):
        assert X.shape == (7, 64)
        np.testing.assert_array_equal(it, np.asarray(rj.iter))
        np.testing.assert_array_equal(it, rs.iter.numpy())
        np.testing.assert_allclose(X, np.asarray(Xj), atol=1e-5)
        np.testing.assert_allclose(X, Xs.numpy(), atol=1e-5)
    np.testing.assert_array_equal(
        pt.densify_batch(got["compact_values"], got["compact_indices"],
                         64).numpy(), got["X"])
    assert got["gram_cached"] and got["plan_sharded"]
    plan = ss.Homotopy(A, mesh=_jax_mesh()).explain(batch=8,
                                                    max_iterations=50)
    assert int(got["plan_k_max"]) == plan["k_max"]
    assert bool(got["plan_gram"]) == plan["gram"]
    assert got["plan_mesh"].tolist() == [int(mesh[-1]), int(mesh[0])]
    x0, r0 = single.solve(Y[0], 1e-3, 50)
    np.testing.assert_allclose(got["x0"], x0.numpy(), atol=1e-5)
    np.testing.assert_allclose(got["device_x0"], got["x0"], atol=1e-6)
    assert int(got["iter0"]) == r0.iter
    A64 = A.astype(np.float64)
    c = (Y - got["cert_X"].astype(np.float64) @ A64.T) @ A64
    err = got["cert_solution_error"]
    assert np.all(err <= 1e-2)
    np.testing.assert_allclose(err, np.abs(c).max(axis=1), rtol=1e-4)
    truth = [set(np.flatnonzero(x).tolist()) for x in X0]
    assert [set(np.argsort(-np.abs(x))[:3].tolist())
            for x in got["cert_X"]] == truth


@pytest.mark.parametrize("mesh", MESHES)
def test_omp_mesh(runs, mesh):
    """test_mesh_api.py:99-110 and :205-207: Omp (picks 1 and gOMP picks
    2) through the mesh equals JAX's mesh façade and the port's
    single-device façade within 1e-5, pick counts equal, single solves and
    the on-device entry too; the certified default's certificates are the
    residuals and within the tolerance."""
    got = C.same_on_every_rank(_get(runs, mesh, "api_omp"))
    A, _, Y = C.P_FACADE()
    for picks in (1, 2):
        p = f"p{picks}_"
        Xj, rj = ss.Omp(A, mesh=_jax_mesh(), precision="high",
                        picks=picks).solve_batch(Y, 1e-3, 20)
        single = pt.Omp(A, precision="high", picks=picks, **SINGLE)
        Xs, rs = single.solve_batch(Y, 1e-3, 20)
        np.testing.assert_array_equal(got[p + "iter"], np.asarray(rj.iter))
        np.testing.assert_array_equal(got[p + "iter"], rs.iter.numpy())
        np.testing.assert_allclose(got[p + "X"], np.asarray(Xj), atol=1e-5)
        np.testing.assert_allclose(got[p + "X"], Xs.numpy(), atol=1e-5)
        x0, r0 = single.solve(Y[0], 1e-3, 20)
        np.testing.assert_allclose(got[p + "x0"], x0.numpy(), atol=1e-5)
        assert int(got[p + "iter0"]) == r0.iter
    # the on-device entry (picks 2) is solve_batch's route
    np.testing.assert_array_equal(got["device_X"], got["p2_X"])
    np.testing.assert_array_equal(got["device_iter"], got["p2_iter"])
    err = got["cert_solution_error"]
    np.testing.assert_allclose(
        err, np.linalg.norm(Y - got["cert_X"].astype(np.float64) @ A.T,
                            axis=1), rtol=1e-4, atol=1e-6)
    assert np.all(err <= 1e-2) and got["sharded"]


@pytest.mark.parametrize("mesh", MESHES)
def test_irls_mesh_factors_on_the_mesh(runs, mesh):
    """test_mesh_api.py:84-96 in float64: Irls(mesh=) factors A on the mesh
    (CholeskyQR2; the host QR is never made) and equals JAX's mesh façade
    within 1e-10 and the port's single-device façade (a Householder QR)
    within 1e-8, iterations equal."""
    got = C.same_on_every_rank(_get(runs, mesh, "api_irls"))
    A, Y = C.P_IRLS()
    Xj, rj = ss.Irls(A, mesh=_jax_mesh()).solve_batch(Y, 1e-3, 50)
    Xs, rs = pt.Irls(A, **SINGLE).solve_batch(Y, 1e-3, 50)
    np.testing.assert_array_equal(got["iter"], np.asarray(rj.iter))
    np.testing.assert_array_equal(got["iter"], rs.iter.numpy())
    np.testing.assert_allclose(got["X"], np.asarray(Xj), atol=1e-10)
    np.testing.assert_allclose(got["X"], Xs.numpy(), atol=1e-8)
    assert got["qr_cached"] and not got["host_qr"]
    # the on-device entry on 5 lanes (padded to the data axis, trimmed)
    np.testing.assert_allclose(got["device_X"], got["X"][:5], atol=1e-12)
    np.testing.assert_array_equal(got["device_iter"], got["iter"][:5])


@pytest.mark.parametrize("mesh", MESHES)
def test_irls_cg_mesh_support_recovery(runs, mesh):
    """test_mesh_api.py:113-130: IrlsCg(mesh=) splits A's columns (n = 50
    pads), 7 lanes pad to the data axis; every planted support is
    recovered and X is within 1e-4 of JAX's mesh façade and of the port's
    single-device façade (float32: the column split reorders the CG's
    sums)."""
    got = C.same_on_every_rank(_get(runs, mesh, "api_irls_cg"))
    A, X0, Y = C.cg_problem(dtype=np.float32)
    assert got["X"].shape == (7, 50)
    for x, x0 in zip(got["X"], X0):
        assert set(np.argsort(-np.abs(x))[:2]) == set(np.flatnonzero(x0))
    Xj, _ = ss.IrlsCg(A, mesh=_jax_mesh()).solve_batch(Y[:7], 1e-5, 60)
    Xs, _ = pt.IrlsCg(A, **SINGLE).solve_batch(Y[:7], 1e-5, 60)
    np.testing.assert_allclose(got["X"], np.asarray(Xj), atol=1e-4)
    np.testing.assert_allclose(got["X"], Xs.numpy(), atol=1e-4)
    assert got["device_X"].shape == (5, 50)
    np.testing.assert_allclose(got["device_X"], got["X"][:5], atol=1e-6)


@pytest.mark.parametrize("mesh", MESHES)
def test_cosamp_mesh(runs, mesh):
    """Cosamp(mesh=) (row padding m = 37, 7 lanes) equals JAX's mesh façade
    and the port's single-device façade within 1e-5, rounds equal."""
    got = C.same_on_every_rank(_get(runs, mesh, "api_cosamp"))
    A, _, Y = C.P_FACADE()
    Xj, rj = ss.Cosamp(A, 3, mesh=_jax_mesh()).solve_batch(Y, 1e-3, 20)
    Xs, rs = pt.Cosamp(A, 3, device="cpu").solve_batch(Y, 1e-3, 20)
    np.testing.assert_array_equal(got["iter"], np.asarray(rj.iter))
    np.testing.assert_array_equal(got["iter"], rs.iter.numpy())
    np.testing.assert_allclose(got["X"], np.asarray(Xj), atol=1e-5)
    np.testing.assert_allclose(got["X"], Xs.numpy(), atol=1e-5)
    np.testing.assert_allclose(got["device_X"], got["X"][:5], atol=1e-6)
    np.testing.assert_array_equal(got["device_iter"], got["iter"][:5])


@pytest.mark.parametrize("mesh", MESHES)
def test_update_column_on_the_mesh(runs, mesh):
    """test_mesh_api.py:150-181: update_column after the first placement
    rewrites each rank's shard and the replicated Gram's row and column
    from one all-reduced Aᵀv (the placements stay live; G = A₂ᵀA₂ within
    1e-5), and later solves see the new column (equal to the single-device
    solve on A₂); before the first placement the lazy one reads the
    updated A."""
    got = C.same_on_every_rank(_get(runs, mesh, "api_update_column"))
    A, _, Y = C.sparse_problem(6, 37, 48, 4, 2)
    A2 = A.copy()
    A2[:, C.UPDATE_J] = C.update_vector(37)
    np.testing.assert_array_equal(got["A2"], A2)
    assert got["placed"] and got["lazy_unplaced"]
    np.testing.assert_allclose(got["G"], A2.T.astype(np.float64) @ A2,
                               atol=1e-5)
    Xs, rs = pt.Homotopy(A2, precision="high", **SINGLE).solve_batch(
        Y, 1e-3, 30)
    np.testing.assert_array_equal(got["iter"], rs.iter.numpy())
    np.testing.assert_allclose(got["X"], Xs.numpy(), atol=1e-5)
    A3 = A.copy()
    A3[:, 3] = C.update_vector(37)
    Xl, rl = pt.Homotopy(A3, precision="high", **SINGLE).solve_batch(
        Y, 1e-3, 30)
    np.testing.assert_array_equal(got["lazy_iter"], rl.iter.numpy())
    np.testing.assert_allclose(got["lazy_X"], Xl.numpy(), atol=1e-5)


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_refusals(runs, mesh):
    """JAX's refusals (api.py:331-336, :668-672; test_mesh_api.py:133-147),
    raised alike on every rank before any collective: engine="native"
    with a mesh, mode="exact" with a mesh (Homotopy and Omp), path
    extraction with a mesh, max_iterations < 1, an unknown precision, and
    a batch that does not divide over the data axis of the functional
    route."""
    got = C.same_on_every_rank(_get(runs, mesh, "api_errors"))
    msgs = [str(m) for m in got["messages"]]
    wants = ("native", "exact", "exact", "single-device", "single-device",
             "max_iterations must be >= 1", "precision must be",
             "data axis" if mesh == "2x2" else "no error")
    for msg, want in zip(msgs, wants, strict=True):
        assert want in msg, (msg, want)


@pytest.mark.parametrize("cls,args", [
    (pt.Homotopy, ()), (pt.Omp, ()), (pt.Irls, ()), (pt.IrlsCg, ()),
    (pt.Cosamp, (2,))])
def test_every_facade_refuses_a_non_mesh(cls, args):
    """JAX's ``_check_mesh`` (api.py:149-151): a mesh that is not the
    port's ``Mesh`` is refused, as JAX refuses a non-``jax.sharding.Mesh``,
    before anything is placed."""
    A = np.eye(8, dtype=np.float32)
    with pytest.raises(ValueError, match="mesh must be a .*Mesh"):
        cls(A, *args, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="jax.sharding.Mesh"):
        getattr(ss, cls.__name__)(A, *args, mesh="nope")


def test_distributed_single_process(monkeypatch):
    """test_distributed.py:22-34: without a launcher's environment
    ``initialize()`` is a no-op returning False and starts nothing; the
    helpers report one process; a mesh needs a process group."""
    for v in distributed._LAUNCH_ENV_VARS:
        monkeypatch.delenv(v, raising=False)
    assert distributed.initialize() is False
    assert distributed.is_initialized() is False
    assert distributed.process_index() == 0
    assert distributed.process_count() == 1
    with pytest.raises(RuntimeError, match="initialize"):
        psh.make_mesh(1, 1, device="cpu")


def test_mesh_defaults_to_the_card(monkeypatch, tmp_path):
    """A mesh runs on the card unless it is given ``device="cpu"``: where
    torch sees no card, ``make_mesh`` and ``global_mesh`` raise, naming
    the way to ask for the CPU, as a façade does; asked for, the CPU mesh
    is built on gloo. The mesh's groups take ``initialize``'s timeout. On
    a one-rank gloo group through a file store, destroyed at the end."""
    import datetime
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(psh, "_GROUP_TIMEOUT", None)
    assert distributed.initialize(init_method=f"file://{tmp_path}/init",
                                  world_size=1, rank=0, backend="gloo",
                                  timeout=30)
    try:
        assert psh._GROUP_TIMEOUT == datetime.timedelta(seconds=30)
        for make in (lambda: psh.make_mesh(1, 1), distributed.global_mesh):
            with pytest.raises(RuntimeError, match="pass device='cpu'"):
                make()
        mesh = psh.make_mesh(1, 1, device="cpu")
        assert mesh.device == torch.device("cpu")
        assert mesh.backend == "gloo"
        assert torch.distributed.get_backend(mesh.row_group) == "gloo"
        assert mesh.shape == {"data": 1, "row": 1}
    finally:
        torch.distributed.destroy_process_group()
    assert not distributed.is_initialized()


@pytest.mark.parametrize("mesh", MESHES)
def test_multi_process_sharded_solve_matches_single_process(runs, mesh):
    """test_distributed.py:44-80 and tests/_dist_child.py: every rank
    joins through ``distributed.initialize`` (idempotent: a second call
    returns True), reports its own index and the group's size, lays the
    (data, row) mesh with ``global_mesh`` and runs a row+batch-sharded
    float64 solve equal to its own single-process solve and to JAX's
    within 1e-9, iterations equal."""
    n_row, n_data = map(int, mesh.split("x"))
    ranks = _get(runs, mesh, "dist_helpers")
    got = C.same_on_every_rank(ranks, ["X", "iter", "count", "shape",
                                       "initialized", "again"])
    assert got["initialized"] and got["again"]
    assert int(got["count"]) == n_row * n_data
    assert sorted(int(r["index"]) for r in ranks) == list(range(n_row
                                                               * n_data))
    assert got["shape"].tolist() == [n_data, n_row]
    np.testing.assert_allclose(got["X"], got["single_X"], atol=1e-9)
    np.testing.assert_array_equal(got["iter"], got["single_iter"])
    rng = np.random.RandomState(0)
    A = rng.randn(32, 16)
    A /= np.linalg.norm(A, axis=0)
    X0 = np.zeros((4, 16))
    for b in range(4):
        X0[b, rng.choice(16, 2, replace=False)] = rng.uniform(0.5, 1.0, 2)
    Xj, rj = ss.Homotopy(A, engine="jax").solve_batch(X0 @ A.T, 1e-6, 12)
    np.testing.assert_allclose(got["X"], np.asarray(Xj), atol=1e-9)
    np.testing.assert_array_equal(got["iter"], np.asarray(rj.iter))
    np.testing.assert_allclose(got["X"], X0, atol=1e-6)
