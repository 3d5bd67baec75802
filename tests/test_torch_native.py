"""The port's binding of the C++ host engine (``backend/native.py``) and its
routing in the façades, on the CPU: every case of ``tests/test_native.py``
but the C++ embedding smoke (which tests ``csrc/`` itself, not a binding),
plus the port's host route against the JAX package's (the same C++
source, so equal results), the library built once by processes that
start together, and ``SS_NATIVE_DISABLE=1``.

The host engine runs the fast-path algorithms, so against the JAX
package's jax engine and the port's torch route its solutions agree
within float32 accumulation noise (test_native.py's tolerances: 5e-5,
1e-4 for IRLS, 1e-8 in float64); against the JAX package's own binding
they are equal.
"""

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
from sparse_solvers_tpu.backend import native as jnative
from sparse_solvers_tpu_torch import api as papi
from sparse_solvers_tpu_torch.backend import native

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _host_engine():
    """Build and load the port's host library once per process; skip
    where no C++ compiler can build it."""
    if not native.available():
        pytest.skip(f"host engine unavailable: {native.load_error()}")


def _problem(m, n, k, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n).astype(dtype)
    A /= np.linalg.norm(A, axis=0)
    x = np.zeros(n, dtype)
    x[rng.choice(n, k, replace=False)] = rng.uniform(0.5, 1.0, k).astype(dtype)
    return A, x, (A @ x).astype(dtype)


@pytest.mark.parametrize("m,n,k", [(32, 64, 4), (64, 128, 8), (128, 64, 6)])
def test_homotopy_matches_jax(m, n, k):
    A, x_true, y = _problem(m, n, k, seed=m + n)
    x_n, it_n, err_n = native.homotopy_solve(A, y, 1e-3, 100, 101)
    x_j, rep = ss.Homotopy(A, engine="jax").solve(
        y, tolerance=1e-3, max_iterations=100)
    assert it_n == rep.iter
    np.testing.assert_allclose(x_n, x_j, atol=5e-5)
    assert np.argmax(x_n) == np.argmax(x_true)
    # and the port's own torch route
    x_t, rep_t = pt.Homotopy(A, precision="highest", engine="jax",
                             device="cpu").solve(y, 1e-3, 100)
    assert it_n == rep_t.iter
    np.testing.assert_allclose(x_n, x_t.numpy(), atol=5e-5)


def test_homotopy_f64():
    A, x_true, y = _problem(48, 96, 5, seed=7, dtype=np.float64)
    x, it, err = native.homotopy_solve(A, y, 1e-6, 100, 101)
    assert err <= 1e-6
    np.testing.assert_allclose(A @ x, y, atol=1e-5)


def test_homotopy_batch_threads():
    A, _, y = _problem(64, 128, 8, seed=3)
    Y = np.stack([y] * 7)
    X, iters, errs = native.homotopy_solve_batch(A, Y, 1e-3, 100, 101)
    x0, it0, err0 = native.homotopy_solve(A, y, 1e-3, 100, 101)
    assert (iters == it0).all()
    np.testing.assert_array_equal(X, np.stack([x0] * 7))


def test_irls_matches_jax_one_sparse():
    A, x_true, y = _problem(96, 48, 1, seed=11)
    handle = native.IrlsNative(A)
    x_n, it_n, err_n, spd = handle.solve(y, 1e-3, 50)
    x_j, rep = ss.Irls(A, engine="jax").solve(
        y, tolerance=1e-3, max_iterations=50)
    assert not spd
    assert it_n == rep.iter
    assert np.argmax(x_n) == np.argmax(x_true) == np.argmax(x_j)
    np.testing.assert_allclose(x_n, x_j, atol=1e-4)


def test_irls_dense_signal_degrades_gracefully():
    """Multi-sparse signals collapse the reweighting in float32: the host
    engine, the JAX engine and the port's torch route flag spd_failure
    rather than returning NaNs."""
    A, x_true, y = _problem(96, 48, 4, seed=11)
    x_n, it_n, err_n, spd_n = native.IrlsNative(A).solve(y, 1e-3, 50)
    x_j, rep = ss.Irls(A, engine="jax").solve(
        y, tolerance=1e-3, max_iterations=50)
    x_t, rep_t = pt.Irls(A, engine="jax", device="cpu").solve(y, 1e-3, 50)
    assert spd_n and rep.spd_failure and rep_t.spd_failure
    assert np.isfinite(x_n).all() and np.isfinite(x_j).all()
    assert torch.isfinite(x_t).all()


def test_irls_rejects_underdetermined():
    A = np.zeros((4, 8), np.float32)
    with pytest.raises(ValueError):
        native.IrlsNative(A)


def test_engine_auto_routes_small_to_native_identity():
    """The identity smoke stays exact through the host route, and the
    result comes back as a tensor on the solver's device."""
    I = np.eye(5, dtype=np.float32)
    sig = np.zeros(5, np.float32)
    sig[2] = 1.0
    solver = pt.Homotopy(I, device="cpu")      # auto -> native (tiny)
    assert solver.explain()["engine"] == "native"
    x, rep = solver.solve(sig)
    assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
    assert rep.iter == 1 and rep.solution_error == 0.0
    np.testing.assert_array_equal(x.numpy(), sig)


def test_engine_native_forced():
    A, x_true, y = _problem(40, 80, 4, seed=5)
    x, rep = pt.Homotopy(A, engine="native", device="cpu").solve(
        y, tolerance=1e-3, max_iterations=100)
    assert np.argmax(x.numpy()) == np.argmax(x_true)
    X, reps = pt.Homotopy(A, engine="native", device="cpu").solve_batch(
        np.stack([y] * 3), tolerance=1e-3, max_iterations=100)
    assert tuple(X.shape) == (3, 80)
    assert (reps.iter.numpy() == rep.iter).all()
    assert reps.iter.dtype == torch.int32


def test_homotopy_batch_f64_matches_single():
    A, _, _ = _problem(48, 96, 5, seed=11, dtype=np.float64)
    rng = np.random.RandomState(3)
    Y = []
    for i in range(6):
        x = np.zeros(96)
        x[rng.choice(96, 4, replace=False)] = rng.uniform(0.5, 1, 4)
        Y.append(A @ x)
    Y = np.stack(Y)
    X, iters, errs = native.homotopy_solve_batch(A, Y, 1e-3, 100, 101)
    assert X.dtype == np.float64
    for i in range(6):
        xi, iti, erri = native.homotopy_solve(A, Y[i], 1e-3, 100, 101)
        assert iters[i] == iti
        np.testing.assert_array_equal(X[i], xi)
        assert errs[i] == erri


def test_irls_f64_native_matches_jax():
    """float64 host IRLS through the port's façade agrees with the JAX
    package's jax engine at the reference's float64 tolerances."""
    rng = np.random.RandomState(5)
    m, n = 40, 20
    A = rng.randn(m, n)
    A /= np.linalg.norm(A, axis=0)
    x = np.zeros(n)
    x[3] = 1.0
    y = A @ x
    xn, rn = pt.Irls(A, engine="native", device="cpu").solve(
        y, tolerance=1e-3, max_iterations=50)
    xj, rj = ss.Irls(A, engine="jax").solve(y, tolerance=1e-3,
                                            max_iterations=50)
    assert xn.dtype == torch.float64
    assert rn.iter == rj.iter
    assert rn.spd_failure == rj.spd_failure
    np.testing.assert_allclose(xn.numpy(), xj, atol=1e-8)
    assert int(xn.argmax()) == 3


def test_native_degenerate_insert_breaks_finite():
    """A thrashy signed ensemble drives the support toward rank
    deficiency: the degenerate-insert guard stops the solve with a finite
    x and error."""
    rng = np.random.RandomState(42)
    m, n, k = 40, 80, 10
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    for i in range(16):
        xt = np.zeros(n, np.float32)
        xt[rng.choice(n, k, replace=False)] = rng.randn(k)
        y = (A @ xt + 0.01 * rng.randn(m)).astype(np.float32)
        x, it, err = native.homotopy_solve(A, y, 0.05, 120, 121)
        assert np.isfinite(x).all(), i
        assert np.isfinite(err), i


def test_irls_batch_threads_bit_equal():
    """The threaded IRLS batch (one worker workspace per thread over the
    shared QR) is bit-identical to per-signal solves, at any thread
    count."""
    A, _, _ = _problem(96, 48, 1, seed=11)
    Y = np.stack([_problem(96, 48, 1, seed=s)[2] for s in range(9)])
    h = native.IrlsNative(A)
    X, iters, errs, spds = h.solve_batch(Y, 1e-3, 50)
    for b in range(Y.shape[0]):
        x0, it0, err0, spd0 = h.solve(Y[b], 1e-3, 50)
        assert iters[b] == it0 and errs[b] == err0 and spds[b] == spd0
        np.testing.assert_array_equal(X[b], x0)
    X1, it1, er1, sp1 = h.solve_batch(Y, 1e-3, 50, nthreads=1)
    np.testing.assert_array_equal(X, X1)
    np.testing.assert_array_equal(iters, it1)


def test_irls_api_batch_routes_threaded_native():
    """Irls.solve_batch on the host engine gives the per-signal solves'
    results; an empty batch keeps its shapes."""
    A, _, y = _problem(80, 40, 1, seed=21)
    Y = np.stack([y] * 5)
    solver = pt.Irls(A, engine="native", device="cpu")
    X, rep = solver.solve_batch(Y, tolerance=1e-3, max_iterations=50)
    x0, rep0 = solver.solve(y, tolerance=1e-3, max_iterations=50)
    assert (rep.iter.numpy() == rep0.iter).all()
    np.testing.assert_array_equal(X.numpy(), np.stack([x0.numpy()] * 5))
    X0, rep0b = solver.solve_batch(np.zeros((0, 80), np.float32))
    assert tuple(X0.shape) == (0, 40) and tuple(rep0b.iter.shape) == (0,)


def test_batch_entry_points_reject_misshaped_signals():
    """The C ABI reads batch·m values with no bounds information: the
    batch helpers reject a 1-d or wrong-width Y."""
    A, _, y = _problem(64, 32, 1, seed=2)
    h = native.IrlsNative(A)
    with pytest.raises(ValueError):
        h.solve_batch(y, 1e-3, 10)
    with pytest.raises(ValueError):
        h.solve_batch(np.zeros((3, 63), np.float32), 1e-3, 10)
    with pytest.raises(ValueError):
        native.homotopy_solve_batch(A, y, 1e-3, 10, 33)
    with pytest.raises(ValueError):
        native.omp_solve_batch(A, y, 1e-3, 10, 33)
    Aw = A.T.copy()
    with pytest.raises(ValueError):
        native.irls_cg_solve_batch(Aw, np.zeros((2, 63), np.float32),
                                   1e-3, 10)


def test_single_solve_entry_points_reject_misshaped_signals():
    A, _, y = _problem(64, 32, 1, seed=4)
    with pytest.raises(ValueError):
        native.homotopy_solve(A, y[:-1], 1e-3, 10, 33)
    with pytest.raises(ValueError):
        native.omp_solve(A, y[:-1], 1e-3, 10, 33)
    with pytest.raises(ValueError):
        native.IrlsNative(A).solve(y[:-1], 1e-3, 10)
    with pytest.raises(ValueError):
        native.irls_cg_solve(A.T.copy(), np.zeros(63, np.float32), 1e-3, 10)


def test_fuzz_engine_parity_homotopy():
    """Random shapes, sparsities and tolerances: the host engine and the
    port's torch route run the same fast-path algorithm, so iteration
    counts agree and solutions match at 5e-4; an ulp-tie fork is allowed
    on at most 1 in 8 trials, and then one of the two must converge."""
    rng = np.random.RandomState(123)
    forks = 0
    trials = 24
    for t in range(trials):
        m = int(rng.choice([24, 48, 96]))
        n = int(rng.choice([16, 64, 160]))
        k = int(rng.randint(1, max(2, min(m, n) // 6)))
        tol = float(rng.choice([1e-2, 1e-3]))
        A = rng.randn(m, n).astype(np.float32)
        A /= np.linalg.norm(A, axis=0)
        x_true = np.zeros(n, np.float32)
        x_true[rng.choice(n, k, replace=False)] = rng.uniform(0.3, 1.0, k)
        y = (A @ x_true).astype(np.float32)
        x_n, it_n, err_n = native.homotopy_solve(A, y, tol, 80,
                                                 min(n, 81))
        x_t, rep_t = pt.Homotopy(A, precision="highest", engine="jax",
                                 device="cpu").solve(y, tol, 80)
        if it_n != rep_t.iter:
            forks += 1
            assert err_n <= tol or rep_t.solution_error <= tol, (t, m, n, k)
            continue
        np.testing.assert_allclose(x_n, x_t.numpy(), atol=5e-4,
                                   err_msg=f"trial {t} {m}x{n} k={k}")
    assert forks <= trials // 8, f"{forks}/{trials} trajectory forks"


def test_blas_info_shape():
    info = native.blas_info()
    assert set(info) == {"active", "path"}
    assert info["active"] in (0, 1, 2)
    if info["active"]:
        assert info["path"]


def test_blas_vs_scalar_parity():
    """With a CBLAS loaded, forcing the scalar fallbacks leaves the
    trajectories intact: equal iteration counts, solutions within float32
    accumulation noise."""
    if not native.blas_info()["active"]:
        pytest.skip("no runtime CBLAS resolved on this host")
    lib = native.get_lib()
    A, x_true, y = _problem(96, 160, 8, seed=21)
    Ad, xd, yd = _problem(96, 48, 1, seed=22, dtype=np.float64)
    try:
        x_b, it_b, err_b = native.homotopy_solve(A, y, 1e-3, 100, 101)
        h = native.IrlsNative(Ad)
        xi_b, iti_b, erri_b, spd_b = h.solve(yd, 1e-6, 60)
        lib.ss_blas_set_enabled(0)
        assert native.blas_info()["active"] == 0
        x_s, it_s, err_s = native.homotopy_solve(A, y, 1e-3, 100, 101)
        h2 = native.IrlsNative(Ad)
        xi_s, iti_s, erri_s, spd_s = h2.solve(yd, 1e-6, 60)
    finally:
        lib.ss_blas_set_enabled(1)
    assert native.blas_info()["active"] in (1, 2)
    assert it_b == it_s
    np.testing.assert_allclose(x_b, x_s, atol=5e-5)
    assert iti_b == iti_s
    np.testing.assert_allclose(xi_b, xi_s, atol=1e-9)


def test_blas_pin_parsing_colon_path(tmp_path, monkeypatch):
    """SS_NATIVE_BLAS pins whose path contains ':' resolve as the longest
    existing-file prefix; the port parses pins as the JAX package does."""
    lib = tmp_path / "weird:name.so"
    lib.write_bytes(b"")
    for spec, want in ((str(lib), [(str(lib), "", "", 0)]),
                       (f"{lib}:scipy_:64_:1", [(str(lib), "scipy_", "64_",
                                                 1)]),
                       ("/no/such/lib.so:p_:s_:1",
                        [("/no/such/lib.so", "p_", "s_", 1)]),
                       ("0", [])):
        monkeypatch.setenv("SS_NATIVE_BLAS", spec)
        got = list(native._blas_candidates())
        assert got == want == list(jnative._blas_candidates()), spec


def _same_inputs():
    A, _, _ = _problem(48, 96, 5, seed=13)
    rng = np.random.RandomState(8)
    X0 = np.zeros((4, 96), np.float32)
    for row in X0:
        row[rng.choice(96, 5, replace=False)] = rng.uniform(0.5, 1.0, 5)
    return A, (X0 @ A.T).astype(np.float32)


@pytest.mark.parametrize("entry", ["homotopy", "omp", "gomp", "irls_cg",
                                   "irls"])
def test_host_route_equals_the_jax_package_host_route(entry):
    """The port's binding and the JAX package's load libraries built from
    the same csrc/ source with the same flags: single and batch results
    are equal, bit for bit."""
    if not jnative.available():
        pytest.skip("the JAX package's host library is unavailable")
    A, Y = _same_inputs()
    if entry == "irls":
        A, _, _ = _problem(96, 40, 1, seed=13)
        Y = np.stack([_problem(96, 40, 1, seed=13)[0][:, j]
                      for j in (3, 9, 17, 30)])
        Y += np.random.RandomState(2).uniform(0, 0.01, Y.shape).astype(
            np.float32)
        mine, theirs = native.IrlsNative(A), jnative.IrlsNative(A)
        single = [h.solve(Y[1], 1e-3, 50) for h in (mine, theirs)]
        batch = [h.solve_batch(Y, 1e-3, 50) for h in (mine, theirs)]
    else:
        call = {
            "homotopy": (lambda mod: mod.homotopy_solve,
                         lambda mod: mod.homotopy_solve_batch,
                         (1e-3, 60, 61), {}),
            "omp": (lambda mod: mod.omp_solve,
                    lambda mod: mod.omp_solve_batch, (1e-4, 30, 30), {}),
            "gomp": (lambda mod: mod.omp_solve,
                     lambda mod: mod.omp_solve_batch, (1e-4, 30, 30),
                     {"picks": 3}),
            "irls_cg": (lambda mod: mod.irls_cg_solve,
                        lambda mod: mod.irls_cg_solve_batch, (1e-6, 60),
                        {"k_sparsity": 10}),
        }[entry]
        one, many, args, kw = call
        single = [one(mod)(A, Y[1], *args, **kw)
                  for mod in (native, jnative)]
        batch = [many(mod)(A, Y, *args, **kw) for mod in (native, jnative)]
    for got, want in (single, batch):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_build_under_a_lock_by_processes_at_once(tmp_path):
    """Four processes that start together build the library into one
    directory: one compiles, the others wait on the lock and find its
    file; no temporary file is left, and the library binds."""
    code = ("import sys\n"
            "from pathlib import Path\n"
            "from sparse_solvers_tpu_torch.backend import native\n"
            "path, built = native.build_library(Path(sys.argv[1]))\n"
            "print(int(built), path)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        outs.append(out.split())
    assert sorted(int(built) for built, _ in outs) == [0, 0, 0, 1]
    paths = {path for _, path in outs}
    assert len(paths) == 1
    (path,) = paths
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [Path(path).name, Path(path).name + ".lock"])
    import ctypes
    native._bind(ctypes.CDLL(path))


def test_disable_sends_auto_to_torch_and_native_raises(monkeypatch):
    """SS_NATIVE_DISABLE=1 forbids the host engine: "auto" takes the
    torch route, and engine="native" raises the JAX package's error."""
    A, _, y = _problem(32, 64, 3, seed=1)
    monkeypatch.setenv("SS_NATIVE_DISABLE", "1")
    assert not native.available() and not native.available(build=False)
    solver = pt.Homotopy(A, precision="highest", device="cpu")
    assert solver.explain()["engine"] == "torch"
    x, rep = solver.solve(y, 1e-3, 50)
    x_t, rep_t = pt.Homotopy(A, precision="highest", engine="jax",
                             device="cpu").solve(y, 1e-3, 50)
    assert torch.equal(x, x_t) and rep.iter == rep_t.iter
    for make_mine, make_theirs in (
            (lambda: pt.Omp(A, engine="native", device="cpu"),
             lambda: ss.Omp(A, engine="native")),
            (lambda: pt.IrlsCg(A, engine="native", device="cpu"),
             lambda: ss.IrlsCg(A, engine="native"))):
        with pytest.raises(RuntimeError) as mine:
            make_mine().solve(y, 1e-3, 20)
        with pytest.raises(RuntimeError) as theirs:
            make_theirs().solve(y, tolerance=1e-3, max_iterations=20)
        assert str(mine.value) == str(theirs.value)
    monkeypatch.delenv("SS_NATIVE_DISABLE")
    assert pt.Homotopy(A, device="cpu").explain()["engine"] == "native"


def test_auto_above_the_limit_never_looks_at_the_library(monkeypatch):
    """Above 2¹⁶ elements "auto" takes the torch route without building or
    loading the host library (the JAX package's routing gives the same
    answer); at the limit it takes the host engine."""
    def refuse(*args, **kwargs):
        raise AssertionError("the host library was consulted")

    monkeypatch.setattr(native, "available", refuse)
    A, _, y = _problem(257, 256, 4, seed=3)          # 65792 > 2¹⁶
    solver = pt.Homotopy(A, precision="highest", device="cpu")
    assert solver.explain()["engine"] == "torch"
    x, rep = solver.solve(y, 1e-3, 40)
    assert rep.solution_error <= 1e-3
    cpu = torch.device("cpu")
    assert not papi._route_native("auto", 257, 256, False, cpu)
    monkeypatch.undo()
    assert papi._route_native("auto", 256, 256, False, cpu)


@pytest.mark.parametrize("engine,routes", [("auto", False),
                                           ("native", True)])
def test_a_card_facade_takes_the_host_engine_only_when_named(
        monkeypatch, engine, routes):
    """On a façade whose device is the card, "auto" keeps even the
    smallest problem on the torch route without consulting the library,
    and engine="native" still takes the host engine; on a CPU façade
    "auto" takes it at the same size."""
    calls = []

    def available(build=True):
        calls.append(build)
        return True

    monkeypatch.setattr(native, "available", available)
    for probe in (True, False):
        assert papi._route_native(engine, 8, 8, probe,
                                  torch.device("cuda", 0)) is routes
    assert bool(calls) is routes
    assert papi._route_native(engine, 8, 8, False, torch.device("cpu"))
