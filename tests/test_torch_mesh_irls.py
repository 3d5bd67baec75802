"""The port's sharded IRLS family (``parallel/sharding.py``:
``qr_sharded``, ``irls_sharded``, ``irls_sharded_from_a`` and the
column-sharded ``irls_cg_sharded``) on gloo process groups of 2 and 4 CPU
ranks, against the JAX package's sharded routes on its virtual CPU
devices, on the same seeded inputs (``_torch_mesh_cases.py``; the harness
and the meshes are ``test_torch_mesh_homotopy.py``'s).

Both sides of the IRLS cases start from one numpy QR of A (QR sign
conventions differ between XLA, LAPACK and cuSOLVER, ROADMAP.md Queue 3);
``irls_sharded_from_a`` factors on the mesh on both sides (CholeskyQR2).
Tolerances: float64 within 1e-10 of JAX with equal iterations, and
``qr_sharded`` at JAX's own tolerances (1e-4 in float32, 1e-10 in
float64; test_sharding.py:74-77). The collective contracts of
test_sharding.py:252 and :277 are held as counts.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

import jax  # noqa: E402

import _torch_mesh_cases as C  # noqa: E402
from sparse_solvers_tpu.parallel import sharding as jsh  # noqa: E402

WORLDS = {2: ("2x1",), 4: ("2x2", "4x1")}
MESHES = ("2x1", "2x2", "4x1")
QR = [f"qr_{m}x{n}_{dt}" for m, n in C.QR_SHAPES
      for dt in ("float32", "float64")]
IRLS = {"irls": {}, "irls_gemm": dict(newton="gemm"),
        "irls_exact": dict(mode="exact"),
        "irls_stabilized": dict(stabilized=True)}
OTHER = ("qr_rank_deficient", "irls_from_a", "irls_cg")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    names = QR + list(IRLS) + list(OTHER)
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


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", QR)
def test_qr_sharded_choleskyqr2(runs, name, mesh):
    """CholeskyQR2 on the row shards (one all-reduced Gram per pass):
    QᵀQ ≈ I, QR ≈ A, padded rows of Q exactly zero, R upper-triangular
    with a positive diagonal, the LS solve of numpy's, and Q and R equal
    to JAX's qr_sharded, each at JAX's tolerance for the dtype."""
    _, shape, dt = name.split("_")
    m, n = map(int, shape.split("x"))
    tol = 1e-4 if dt == "float32" else 1e-10
    ranks = _get(runs, mesh, name)
    got = C.same_on_every_rank(ranks)
    Q, R = got["Q"], got["R"]
    A = C.qr_input(m, n, np.dtype(dt))
    np.testing.assert_array_equal(Q[m:], 0)
    np.testing.assert_allclose(Q.T @ Q, np.eye(n), atol=tol)
    np.testing.assert_allclose(Q[:m] @ R, A, atol=tol)
    np.testing.assert_array_equal(np.tril(R, -1), 0)
    assert np.all(np.diag(R) > 0)
    y = np.random.RandomState(m + n).randn(m).astype(dt)
    np.testing.assert_allclose(np.linalg.solve(R, Q[:m].T @ y),
                               np.linalg.lstsq(A, y, rcond=None)[0],
                               atol=10 * tol)
    Qj, Rj = jsh.qr_sharded(_jax_mesh(), A)
    np.testing.assert_allclose(Q[:m], np.asarray(Qj)[:m], atol=tol)
    np.testing.assert_allclose(R, np.asarray(Rj), atol=tol)
    for r in ranks:
        assert r["count_all_reduce"] == 2   # one Gram a pass


@pytest.mark.parametrize("mesh", MESHES)
def test_qr_sharded_rank_deficiency_surfaces(runs, mesh):
    """A rank-deficient A surfaces as NaNs from the first Cholesky where
    its pivot is not positive, as in JAX (test_sharding.py:109-121), or
    else as a rounding-level diagonal entry of R, never as a factor that
    looks full-rank."""
    got = C.same_on_every_rank(_get(runs, mesh, "qr_rank_deficient"))
    Q, R = got["Q"], got["R"]
    if np.isfinite(Q).all() and np.isfinite(R).all():
        # the summation order of the Gram's all-reduce can leave the
        # dependent column a pivot at rounding level instead of a
        # non-positive one (ROADMAP.md Queue 3): the deficiency is then
        # in R's diagonal
        d = np.abs(np.diag(R))
        assert d.min() <= 1e-3 * d.max(), d


@functools.lru_cache(maxsize=None)
def _jax_irls(**kw):
    A, Y = C.P_IRLS()
    Q, R = np.linalg.qr(A)
    X, rep = jsh.irls_sharded(_jax_mesh(), Q, R, Y, 1e-3, 50, **kw)
    return np.asarray(X), np.asarray(rep.iter), np.asarray(rep.spd_failure)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("route", sorted(IRLS))
def test_irls_sharded_matches_jax(runs, route, mesh):
    """irls_sharded in float64 from numpy's QR: fast mode (triangular
    solve or the R⁻¹ product), exact mode and the stabilized loop, X
    within 1e-10 of JAX's, iterations and spd flags equal. Fast mode
    all-reduces once a solve (Qᵀy) and never in its loop; exact mode's
    Newton step all-reduces its weighted Gram and Qᵀ(Q s) each
    iteration."""
    ranks = _get(runs, mesh, route)
    got = C.same_on_every_rank(ranks)
    X, iters, spd = _jax_irls(**IRLS[route])
    np.testing.assert_array_equal(got["iter"], iters)
    np.testing.assert_array_equal(got["spd_failure"], spd)
    # exact mode's last Newton step before an spd failure amplifies the
    # weighted Gram's summation order by its condition number (ROADMAP.md
    # Queue 3): such lanes within 1e-3, as tests/test_torch_irls.py holds
    # them
    at_boundary = spd if route == "irls_exact" else np.zeros_like(spd)
    np.testing.assert_allclose(got["X"][~at_boundary], X[~at_boundary],
                               atol=1e-10)
    np.testing.assert_allclose(got["X"][at_boundary], X[at_boundary],
                               atol=1e-3)
    for r in ranks:
        if route == "irls_exact":
            assert r["count_all_reduce"] > 1
        else:
            assert r["count_all_reduce"] == 1


@pytest.mark.parametrize("mesh", MESHES)
def test_irls_sharded_from_a_matches_jax(runs, mesh):
    """irls_sharded_from_a factors A on the mesh (CholeskyQR2, two
    all-reduced Grams) and solves (one more all-reduce): float64 X within
    1e-10 of JAX's irls_sharded_from_a, iterations equal."""
    ranks = _get(runs, mesh, "irls_from_a")
    got = C.same_on_every_rank(ranks)
    A, Y = C.P_IRLS()
    Xj, rj = jsh.irls_sharded_from_a(_jax_mesh(), A, Y, 1e-3, 50)
    np.testing.assert_array_equal(got["iter"], np.asarray(rj.iter))
    np.testing.assert_allclose(got["X"], np.asarray(Xj), atol=1e-10)
    for r in ranks:
        assert r["count_all_reduce"] == 3


@pytest.mark.parametrize("mesh", MESHES)
def test_irls_cg_sharded_matches_jax_and_its_collective_contract(runs, mesh):
    """Column-sharded CG-IRLS in float64 (n = 50 pads to the shard
    multiple): X within 1e-8 of JAX's irls_cg_sharded (the column split
    changes the order of the CG's all-reduced sums, which the inner solves
    amplify), iterations equal, the planted supports recovered. Each CG
    matvec issues exactly one all-reduce (test_sharding.py:252); each
    outer step adds one all-reduce (the change's maxima) and one
    all-gather (the global (K+1)-th |x| of the ε rule); the solve gathers
    X over the column shards once and each lane's results over the data
    axis."""
    ranks = _get(runs, mesh, "irls_cg")
    got = C.same_on_every_rank(ranks)
    A, X0, Y = C.cg_problem()
    Xj, rj = jsh.irls_cg_sharded(_jax_mesh(), A, Y, 1e-6, 40)
    np.testing.assert_array_equal(got["iter"], np.asarray(rj.iter))
    np.testing.assert_allclose(got["X"], np.asarray(Xj), atol=1e-8)
    for x, x0 in zip(got["X"], X0):
        assert set(np.argsort(-np.abs(x))[:2]) == set(np.flatnonzero(x0))
    for r in ranks:
        outer = int(r["cg_solves"])
        b_loc = len(r["iter"]) // r["n_data"]
        assert outer >= int(r["iter"][r["data_index"] * b_loc:][:b_loc].max())
        for matvec in r["matvecs"]:
            assert matvec.tolist() == [1, 0, 0]
        assert r["count_all_reduce"] == len(r["matvecs"]) + outer
        assert r["count_all_gather"] == outer + 5
