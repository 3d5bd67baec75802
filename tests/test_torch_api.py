"""The PyTorch port's ``Homotopy`` façade against the JAX package's, on the
CPU, plus the port's import boundary and its unported routes.

The JAX side runs the same batch driver through ``SS_BATCH_NATIVE=1``
(Pallas in interpret mode). Trajectories are compared at "high" only; at
"certified" the port's path really runs at bf16 while JAX on the CPU does
not, so there the tests compare what "certified" promises: every
certificate within the tolerance, the certificate equal to a float64
recompute, and the recovered supports.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

import sparse_solvers_tpu as ss
import sparse_solvers_tpu_torch as pt
from _torch_cases import TORCH_ROUTE, compressive_problem
from sparse_solvers_tpu_torch import api as papi
from sparse_solvers_tpu_torch.utils import ndview

ROOT = Path(__file__).resolve().parents[1]
TOL, MAX_IT, K_MAX = 1e-2, 64, 48


@pytest.fixture(scope="module")
def problem():
    # b·k_max = 768 >= 2m = 512: outside the sparse-matvec regime, so the
    # port takes its driver; tiers [16, 24, 48]
    return compressive_problem(256, 512, 8, 16, seed=3)


def _jax_solver(monkeypatch, A, **kw):
    monkeypatch.setenv("SS_BATCH_NATIVE", "1")
    return ss.Homotopy(A, engine="jax", k_max=K_MAX, **kw)


def _support(x, k):
    return set(np.argsort(-np.abs(x))[:k].tolist())


def test_certified_certificates_and_supports(problem, monkeypatch):
    A, Y, Xt = problem
    port = pt.Homotopy(A, k_max=K_MAX, precision="certified", **TORCH_ROUTE)
    X, rep = port.solve_batch(Y, TOL, MAX_IT)
    X, err = X.numpy(), rep.solution_error.numpy()
    assert np.all(err <= TOL)
    c = (Y.astype(np.float64) - X.astype(np.float64)
         @ A.T.astype(np.float64)) @ A.astype(np.float64)
    np.testing.assert_allclose(err, np.abs(c).max(axis=1), rtol=1e-4)
    Xj, repj = _jax_solver(monkeypatch, A, precision="certified"
                           ).solve_batch(Y, TOL, MAX_IT)
    Xj = np.asarray(Xj)
    assert np.all(np.asarray(repj.solution_error) <= TOL)
    for lane in range(len(Y)):
        truth = set(np.flatnonzero(Xt[lane]).tolist())
        assert _support(X[lane], 8) == truth
        assert _support(Xj[lane], 8) == truth


def test_high_precision_matches_jax(problem, monkeypatch):
    A, Y, _ = problem
    X, rep = pt.Homotopy(A, k_max=K_MAX, precision="high",
                         **TORCH_ROUTE).solve_batch(Y, TOL, MAX_IT)
    Xj, repj = _jax_solver(monkeypatch, A, precision="high").solve_batch(
        Y, TOL, MAX_IT)
    np.testing.assert_array_equal(rep.iter.numpy(), np.asarray(repj.iter))
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), atol=1e-5)


def test_certified_resolve_merge(problem, monkeypatch):
    """Forced certificate failures (one too large, one NaN: the NaN-safe
    predicate must count it as failing) re-solve the batch at "high" and
    merge exactly those lanes (api.py:754-784)."""
    A, Y, _ = problem
    real = papi._certified_error

    def spoofed(Am, x, y):
        err = real(Am, x, y).clone()
        err[1], err[3] = 1e3, float("nan")
        return err

    monkeypatch.setattr(papi, "_certified_error", spoofed)
    Xc, rc = pt.Homotopy(A, k_max=K_MAX, precision="certified",
                         **TORCH_ROUTE).solve_batch(Y, TOL, MAX_IT)
    monkeypatch.undo()
    Xf, rf = pt.Homotopy(A, k_max=K_MAX, precision="certified",
                         **TORCH_ROUTE).solve_batch(Y, TOL, MAX_IT)
    Xh, rh = pt.Homotopy(A, k_max=K_MAX, precision="high",
                         **TORCH_ROUTE).solve_batch(Y, TOL, MAX_IT)
    for lane in range(len(Y)):
        src_X, src_r = (Xh, rh) if lane in (1, 3) else (Xf, rf)
        assert torch.equal(Xc[lane], src_X[lane])
        assert int(rc.iter[lane]) == int(src_r.iter[lane])
        assert float(rc.solution_error[lane]) == float(
            src_r.solution_error[lane])
    assert np.all(rc.solution_error.numpy() <= TOL)


def test_exhausted_lanes_are_not_resolved(monkeypatch):
    """A lane that ran out of iterations is honestly non-convergent: its
    failing certificate is reported as-is, with no re-solve."""
    A, Y, _ = compressive_problem(128, 256, 8, 16, seed=5)
    calls = []
    real = papi.Homotopy._fn

    def counting(self, *a, **kw):
        calls.append(kw.get("precision"))
        return real(self, *a, **kw)

    monkeypatch.setattr(papi.Homotopy, "_fn", counting)
    X, rep = pt.Homotopy(A, k_max=32, **TORCH_ROUTE).solve_batch(
        Y, 1e-30, 4)
    assert np.all(rep.iter.numpy() == 4)
    assert not np.any(rep.solution_error.numpy() <= 1e-30)
    assert calls == [None]


def test_explain_shared_keys_match_jax(problem, monkeypatch):
    A, _, _ = problem
    for prec in ("certified", "high"):
        mine = pt.Homotopy(A, k_max=K_MAX, precision=prec,
                           **TORCH_ROUTE).explain(batch=16,
                                                 max_iterations=MAX_IT)
        theirs = _jax_solver(monkeypatch, A, precision=prec).explain(
            batch=16, max_iterations=MAX_IT)
        for key in ("k_max", "batch_native", "capacity_tiers", "precision",
                    "path_precision"):
            assert mine.get(key) == theirs.get(key), key
        assert mine["fused_q"] == (prec == "certified")
        assert set(mine["kernels"].values()) == {"plain torch twin"}


def test_compact_output_and_on_device_entry(problem):
    A, Y, _ = problem
    solver = pt.Homotopy(A, k_max=K_MAX, **TORCH_ROUTE)
    X, rep = solver.solve_batch(Y, TOL, MAX_IT)
    vals, idxs, repc = solver.solve_batch(Y, TOL, MAX_IT, dense=False)
    assert vals.shape == idxs.shape == (16, K_MAX)
    assert torch.equal(pt.densify_batch(vals, idxs, 512), X)
    assert torch.equal(repc.solution_error, rep.solution_error)
    Xd, repd = solver.solve_batch_on_device(torch.from_numpy(Y), TOL, MAX_IT)
    assert torch.equal(Xd, X) and torch.equal(repd.iter, rep.iter)
    (v2, i2), _ = solver.solve_batch_on_device(torch.from_numpy(Y), TOL,
                                               MAX_IT, dense=False)
    assert torch.equal(v2, vals) and torch.equal(i2, idxs)


def test_from_numpy_uses_the_given_gram(problem):
    A, Y, _ = problem
    G = (A.T @ A).astype(np.float32)
    solver = pt.Homotopy.from_numpy(A, G, k_max=K_MAX, precision="high",
                                    **TORCH_ROUTE)
    assert torch.equal(solver._G, torch.from_numpy(G))
    X, rep = solver.solve_batch(Y, TOL, MAX_IT)
    X2, rep2 = pt.Homotopy(A, k_max=K_MAX, precision="high",
                           **TORCH_ROUTE).solve_batch(Y, TOL, MAX_IT)
    assert torch.equal(rep.iter, rep2.iter)
    np.testing.assert_allclose(X.numpy(), X2.numpy(), atol=1e-5)


def test_empty_batch():
    A, _, _ = compressive_problem(64, 128, 4, 1)
    X, rep = pt.Homotopy(A, **TORCH_ROUTE).solve_batch(
        np.zeros((0, 64), np.float32), TOL, 16)
    assert X.shape == (0, 128) and rep.iter.shape == (0,)


def test_validation_matches_jax():
    A = np.eye(8, dtype=np.float32)
    for kw in ({"mode": "slow"}, {"engine": "gpu"},
               {"precision": "fastest"},
               {"mode": "exact", "precision": "certified"},
               {"mode": "exact", "engine": "native"}):
        with pytest.raises(ValueError) as mine:
            pt.Homotopy(A, device="cpu", **kw)
        with pytest.raises(ValueError) as theirs:
            ss.Homotopy(A, **kw)
        # the same parameter is named first
        assert str(mine.value).split()[0] == str(theirs.value).split()[0]
    solver = pt.Homotopy(A, device="cpu")
    with pytest.raises(ValueError, match="max_iterations must be >= 1"):
        solver.solve_batch(np.ones((8, 8), np.float32), TOL, 0)
    with pytest.raises(ValueError, match="Expected signals of length 8"):
        solver.solve_batch(np.ones((2, 7), np.float32), TOL, 10)


def test_ndview_matches_jax_ndview():
    from sparse_solvers_tpu.utils import ndview as jnd
    base = np.arange(24, dtype=np.float64).reshape(4, 6)
    view = base[:, ::2].T                     # strided, transposed
    got = ndview.as_matrix(view)
    assert got.dtype == torch.float64 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnd.as_matrix(view)))
    assert ndview.as_matrix(np.ones((2, 2), np.int64)).dtype == torch.float32
    assert ndview.as_matrix(torch.ones(2, 2, dtype=torch.int32)).dtype \
        == torch.float32
    for bad, fn in ((np.ones(3), "as_matrix"), (np.ones((2, 2, 2)),
                                                "as_signal_batch")):
        with pytest.raises(ValueError) as mine:
            getattr(ndview, fn)(bad)
        with pytest.raises(ValueError) as theirs:
            getattr(jnd, fn)(bad)
        assert str(mine.value) == str(theirs.value)
    with pytest.raises(TypeError):
        ndview.as_matrix(np.ones((2, 2), np.complex64))


# mesh= is ported (parallel/sharding.py): what is not a Mesh is refused,
# as JAX's _check_mesh refuses what is not a jax.sharding.Mesh
UNPORTED = {
    "mesh": lambda A: pt.Homotopy(A, mesh=object(), device="cpu"),
}


@pytest.mark.parametrize("route", sorted(UNPORTED))
def test_unported_routes_raise(route):
    A, _, _ = compressive_problem(64, 128, 4, 1)
    with pytest.raises(ValueError, match="mesh must be a .*Mesh"):
        UNPORTED[route](A)


@pytest.mark.parametrize("engine", ["native", "auto"])
def test_native_route_runs_and_matches_jax(engine):
    """engine="native", and "auto" on a problem of at most 2¹⁶ elements,
    run solve and solve_batch on the C++ host engine: the JAX package's
    native route runs the same source, so the results are equal, returned
    as tensors on the solver's device."""
    A, Y, _ = compressive_problem(64, 128, 4, 3)
    solver = pt.Homotopy(A, engine=engine, device="cpu")
    theirs = ss.Homotopy(A, engine="native")
    assert solver.explain()["engine"] == theirs.explain()["engine"] \
        == "native"
    x, rep = solver.solve(Y[0], TOL, MAX_IT)
    xj, repj = theirs.solve(Y[0], TOL, MAX_IT)
    assert isinstance(x, torch.Tensor) and isinstance(rep, pt.HomotopyReport)
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
    assert (rep.iter, rep.solution_error) == (repj.iter, repj.solution_error)
    X, reps = solver.solve_batch(Y, TOL, MAX_IT)
    Xj, repsj = theirs.solve_batch(Y, TOL, MAX_IT)
    np.testing.assert_array_equal(X.numpy(), np.asarray(Xj))
    np.testing.assert_array_equal(reps.iter.numpy(), np.asarray(repsj.iter))
    np.testing.assert_array_equal(reps.solution_error.numpy(),
                                  np.asarray(repsj.solution_error))


def test_missing_gpu_is_an_error_not_a_cpu_run():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.Homotopy(np.eye(4, dtype=np.float32))


def test_version_matches_jax():
    """The port's own copy of utils/config.py gives the JAX package's
    version."""
    assert pt.version() == ss.version() == [0, 2, 0]


def test_import_leaves_jax_out():
    code = ("import sys, sparse_solvers_tpu_torch; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) "
            "or m == 'sparse_solvers_tpu' "
            "or m.startswith('sparse_solvers_tpu.')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


EXAMPLES = ("batch_recovery", "irls_recovery", "serving_loop",
            "basis_pursuit", "greedy_pursuit", "lasso_path",
            "sharded_recovery")


def test_no_jax_import_anywhere_in_the_port():
    """The package, ``chip_smoke.py``, ``examples_torch/`` and ``tools/``
    import nothing of JAX or of the JAX package, and neither ``bench`` nor
    ``benchmarks``: the card's machine has no jax, and the port keeps its
    own copies of the problem generators (``tests/_torch_cases.py``)."""
    files = sorted((ROOT / "sparse_solvers_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += sorted((ROOT / "examples_torch").glob("*.py"))
    files += sorted((ROOT / "tools").glob("*.py"))
    assert len(files) > 10
    names = {p.relative_to(ROOT).as_posix() for p in files}
    assert {"sparse_solvers_tpu_torch/backend/native.py",
            "sparse_solvers_tpu_torch/solvers/cosamp.py",
            "sparse_solvers_tpu_torch/ops/collectives.py",
            "sparse_solvers_tpu_torch/parallel/distributed.py",
            "sparse_solvers_tpu_torch/parallel/sharding.py",
            "tools/mesh_scaling.py", "tools/probe_mesh_collectives.py",
            "tools/profile_small_solve.py"} <= names
    assert {f"examples_torch/{e}.py" for e in EXAMPLES} <= names
    # nor does the port load the JAX package's binding or its library by
    # path (no string outside a docstring names them): the port's host
    # engine builds csrc/ itself
    for path in files:
        tree = ast.parse(path.read_text())
        docs = {id(node.value) for node in ast.walk(tree)
                if isinstance(node, ast.Expr)}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs):
                assert "backend/native" not in node.value, path
                assert "libsparsesolvers_cpu" not in node.value, path
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "sparse_solvers_tpu",
                                   "bench", "benchmarks"), (
                    f"{path.relative_to(ROOT)} imports {name}")
