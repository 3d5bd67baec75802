"""The gram-free route of the PyTorch port's two batch drivers (``G=None``)
and of the ``Homotopy`` and ``Omp`` façades, against the JAX package's
``G=None`` drivers and the port's own gram drivers, on the CPU.

The JAX drivers run their Pallas kernels in interpret mode
(``use_kernel=False``), the port on ``device="cpu"``, where its kernel
wrappers run their plain twins. Trajectories are compared at "high" and
"highest" only: at "default" (and so "certified") the port's q pass and
u1 dot really take bf16 inputs while JAX on the CPU does not round the
product. There the tests hold what "certified" promises: every
certificate within the tolerance and equal to a float64 recompute, and the
recovered supports.

Tolerances: iteration counts exact, X within 1e-5 (f32 sums in another
order) on well-conditioned ensembles, as tests/test_batch_native.py:303
and tests/test_omp.py:455 hold the JAX drivers; u1 within 2e-6 of JAX's
``make_gram_u1`` (sums of the same exactly formed products of O(1)
values in another order) and exactly 0 at sentinel slots.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")
from torch.utils._python_dispatch import TorchDispatchMode

import sparse_solvers_tpu as ss
import sparse_solvers_tpu_torch as pt
from _torch_cases import TORCH_ROUTE, compressive_problem
from sparse_solvers_tpu.ops import blas as jblas
from sparse_solvers_tpu.solvers import homotopy_batch as JHB
from sparse_solvers_tpu.solvers import omp_batch as JOB
from sparse_solvers_tpu_torch import api as papi
from sparse_solvers_tpu_torch.ops import blas as pblas
from sparse_solvers_tpu_torch.solvers import homotopy_batch as PHB
from sparse_solvers_tpu_torch.solvers import omp_batch as POB


def _gram(A):
    return np.array(jnp.asarray(A).T @ jnp.asarray(A))


def _support(x, k):
    return set(np.argsort(-np.abs(x))[:k].tolist())


def _well_conditioned(seed=11, m=48, n=160, k=4, b=5):
    """tests/test_batch_native.py:303's ensemble."""
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    X0 = np.zeros((b, n), np.float32)
    for i in range(b):
        X0[i, rng.choice(n, k, replace=False)] = rng.uniform(0.3, 1, k)
    return A, (X0 @ A.T).astype(np.float32), X0


# --- u1 ----------------------------------------------------------------------

@pytest.mark.parametrize("prec", ["default", "highest"])
def test_gram_u1_matches_jax(prec):
    """u1 (b, K) for a random pick against slots holding random columns
    and the sentinel n, against JAX's factory at the same precision: at
    "default" both gather from a bf16 copy and accumulate in f32, at
    "highest" both multiply f32."""
    rng = np.random.RandomState(4)
    m, n, b, K = 96, 300, 7, 13
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    idx = rng.randint(0, n, b).astype(np.int32)
    ind = np.full((b, K), n, np.int32)
    for lane in range(b):
        k = rng.randint(0, K + 1)
        ind[lane, :k] = rng.choice(n, k, replace=False)
    with jblas.precision_scope(prec):
        want = np.asarray(JHB.make_gram_u1(
            jnp.asarray(A), None, False, lambda v: v, jnp.float32)(
            jnp.asarray(idx), jnp.asarray(ind)))
    with pblas.precision_scope(prec):
        AT = PHB.transposed_copy(torch.from_numpy(A))
        got = PHB.make_gram_u1(AT)(torch.from_numpy(idx),
                                   torch.from_numpy(ind)).numpy()
    assert AT.shape == (n + 1, m) and not AT[n].any()
    assert AT.dtype == (torch.bfloat16 if prec == "default"
                        else torch.float32)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got[ind == n], 0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    # the bf16 copy rounds A's inputs only: u1 is not rounded to bf16
    if prec == "default":
        assert not np.array_equal(got, got.astype(jnp.bfloat16).astype(
            np.float32))


# --- the drivers -------------------------------------------------------------

@pytest.mark.parametrize("prec", ["high", "highest"])
def test_homotopy_gram_free_driver_matches_jax_and_gram_driver(prec):
    """G=None against the JAX G=None driver and the port's gram driver
    (k_max 61: three capacity tiers, one transposed copy for all)."""
    A, Y, _ = _well_conditioned()
    assert PHB._plan_tiers(61, 60, None) == [16, 32, 61]
    f = jax.jit(functools.partial(JHB.solve_homotopy_batch,
                                  max_iterations=60, k_max=61,
                                  use_kernel=False))
    with jblas.precision_scope(prec):
        Xj, rj = f(jnp.asarray(A), None, jnp.asarray(Y), 1e-3)
    t = torch.from_numpy
    with pblas.precision_scope(prec):
        Xf, rf = PHB.solve_homotopy_batch(t(A), None, t(Y), 1e-3, 60, 61)
        Xg, rg = PHB.solve_homotopy_batch(t(A), t(_gram(A)), t(Y), 1e-3, 60,
                                          61)
    np.testing.assert_array_equal(rf.iter.numpy(), np.asarray(rj.iter))
    np.testing.assert_allclose(Xf.numpy(), np.asarray(Xj), atol=1e-5)
    np.testing.assert_allclose(rf.solution_error.numpy(),
                               np.asarray(rj.solution_error), atol=1e-5)
    assert torch.equal(rf.iter, rg.iter)
    np.testing.assert_allclose(Xf.numpy(), Xg.numpy(), atol=1e-5)
    assert float(np.abs(Xf.numpy() @ A.T - Y).max()) <= 1e-3


@pytest.mark.parametrize("picks", [1, 2, 4])
@pytest.mark.parametrize("prec", ["high", "highest"])
def test_omp_gram_free_driver_matches_jax_and_gram_driver(prec, picks):
    """tests/test_omp.py:455 and the gOMP sub-inserts: G=None against the
    JAX G=None driver and the port's gram driver."""
    A, Y, _ = compressive_problem(128, 256, 8, 16, seed=3)
    f = jax.jit(functools.partial(JOB.solve_omp_batch, max_iterations=24,
                                  k_max=24, use_kernel=False, picks=picks))
    with jblas.precision_scope(prec):
        Xj, rj = f(jnp.asarray(A), None, jnp.asarray(Y), 1e-2)
    t = torch.from_numpy
    with pblas.precision_scope(prec):
        Xf, rf = POB.solve_omp_batch(t(A), None, t(Y), 1e-2, 24, 24,
                                     picks=picks)
        Xg, rg = POB.solve_omp_batch(t(A), t(_gram(A)), t(Y), 1e-2, 24, 24,
                                     picks=picks)
    np.testing.assert_array_equal(rf.iter.numpy(), np.asarray(rj.iter))
    np.testing.assert_allclose(Xf.numpy(), np.asarray(Xj), atol=1e-5)
    np.testing.assert_allclose(rf.solution_error.numpy(),
                               np.asarray(rj.solution_error), atol=1e-5)
    assert torch.equal(rf.iter, rg.iter)
    np.testing.assert_allclose(Xf.numpy(), Xg.numpy(), atol=1e-5)


def test_gram_free_drivers_take_a_given_transposed_copy():
    """A copy made once by the caller gives the driver's own results, and
    the empty batch returns early without one."""
    A, Y, _ = compressive_problem(128, 256, 8, 16, seed=3)
    t = torch.from_numpy
    with pblas.precision_scope("high"):
        AT = PHB.transposed_copy(t(A))
        for solve, extra in ((PHB.solve_homotopy_batch, {}),
                             (POB.solve_omp_batch, {"picks": 2})):
            X0, r0 = solve(t(A), None, t(Y), 1e-2, 24, 25, **extra)
            X1, r1 = solve(t(A), None, t(Y), 1e-2, 24, 25, AT=AT, **extra)
            assert torch.equal(X0, X1) and torch.equal(r0.iter, r1.iter)
            Xe, re_ = solve(t(A), None, t(Y[:0]), 1e-2, 24, 25, **extra)
            assert Xe.shape == (0, 256) and re_.iter.shape == (0,)


# --- the façades -------------------------------------------------------------

class _LargestTensor(TorchDispatchMode):
    """Records the most elements any op's output holds."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.most = max(self.most, t.numel())
        return out


@pytest.mark.parametrize("family", ["homotopy", "omp"])
def test_certified_resolve_stays_gram_free(monkeypatch, family):
    """gram=False, certified, with every lane's certificate forced to fail:
    the lanes that did not exhaust their budget re-solve at "high" on the
    gram-free driver too, no op on either pass makes a tensor of n²
    elements, no Gram is cached, and the merge takes the "high" solve's
    lanes. The transposed copy is made once per precision and kept for the
    next call. (OMP's identity rss runs on a bf16 inverse on the one-pass
    path, so some lanes pick to the budget with a certificate within the
    tolerance: those are not re-solved.)"""
    A, Y, _ = compressive_problem(64, 256, 4, 16, seed=5)
    n = A.shape[1]
    if family == "homotopy":
        cls, seam, name, max_it = pt.Homotopy, papi, "_certified_error", 20
    else:
        cls, seam, name, max_it = pt.Omp, POB, "l2_certificate", 12
    real = getattr(seam, name)
    calls = []

    def spoofed(*args):
        err = real(*args)
        calls.append(1)
        return err + 1.0 if len(calls) == 1 else err

    solver = cls(A, gram=False, **TORCH_ROUTE)
    plan = solver.explain(batch=16, max_iterations=max_it)
    assert plan["gram_free"] is True and plan["fused_q"] is True
    monkeypatch.setattr(seam, name, spoofed)
    with _LargestTensor() as watch:
        X, rep = solver.solve_batch(Y, 1e-2, max_it)
    monkeypatch.undo()
    # the OMP driver takes its certificate at every precision
    assert len(calls) == (1 if family == "homotopy" else 2)
    assert watch.most < n * n, watch.most
    assert solver._G_cache is None
    assert sorted(solver._AT_cache) == [False, True]
    kept = dict(solver._AT_cache)
    Xc, rc = solver.solve_batch_on_device(torch.from_numpy(Y), 1e-2, max_it)
    Xh, reph = cls(A, gram=False, precision="high", **TORCH_ROUTE).solve_batch(
        Y, 1e-2, max_it)
    redone = rc.iter < max_it
    assert bool(redone.any())
    for lane in range(16):
        src, src_rep = (Xh, reph) if redone[lane] else (Xc, rc)
        assert torch.equal(X[lane], src[lane])
        assert int(rep.iter[lane]) == int(src_rep.iter[lane])
    assert all(solver._AT_cache[k] is v for k, v in kept.items())


@pytest.mark.parametrize("family", ["homotopy", "omp"])
def test_certified_gram_free_certificates_and_supports(family):
    """The one-pass path gram-free: u1 from the bf16 copy, q from K1's
    twin. Each certificate within the tolerance and equal to a float64
    recompute (rtol 1e-4 plus the f32 evaluation bound of the residual),
    each top-k support the truth."""
    A, Y, Xt = compressive_problem(128, 512, 8, 16, seed=3)
    cls = pt.Homotopy if family == "homotopy" else pt.Omp
    X, rep = cls(A, gram=False, **TORCH_ROUTE).solve_batch(Y, 1e-2, 24)
    X, err = X.numpy().astype(np.float64), rep.solution_error.numpy()
    assert np.all(err <= 1e-2)
    A64 = A.astype(np.float64)
    R = Y.astype(np.float64) - X @ A64.T
    ref = (np.abs(R @ A64).max(axis=1) if family == "homotopy"
           else np.linalg.norm(R, axis=1))
    slack = 10 * 2.0 ** -24 * np.linalg.norm(
        np.abs(Y) + np.abs(X) @ np.abs(A64).T, axis=1)
    assert np.all(np.abs(err - ref) <= 1e-4 * ref + slack)
    for lane in range(16):
        assert _support(X[lane], 8) == set(np.flatnonzero(Xt[lane]))


def test_auto_rule_above_the_limit_routes_gram_free(monkeypatch):
    """gram=None drops the Gram once n² values pass the limit
    (api.py:352-355); both façades then run their drivers gram-free and
    say so, as the JAX façades do."""
    A, Y, _ = compressive_problem(64, 256, 4, 16, seed=5)
    monkeypatch.setattr(papi, "_GRAM_AUTO_BYTES", 256 * 256 * 4 - 1)
    monkeypatch.setattr(ss.api, "_GRAM_AUTO_BYTES", 256 * 256 * 4 - 1)
    monkeypatch.setenv("SS_BATCH_NATIVE", "1")
    h, jh = pt.Homotopy(A, **TORCH_ROUTE), ss.Homotopy(A, engine="jax")
    o, jo = pt.Omp(A, **TORCH_ROUTE), ss.Omp(A, engine="jax")
    assert not h._gram_enabled and not o._gram_enabled
    for mine, theirs, keys in (
            (h, jh, ("gram", "batch_native", "capacity_tiers")),
            (o, jo, ("corr", "formulation"))):
        got = mine.explain(batch=16, max_iterations=24)
        want = theirs.explain(batch=16, max_iterations=24)
        for key in ("gram_free", "k_max", "path_precision") + keys:
            assert got.get(key) == want.get(key), key
        assert got["gram_free"] is True
    X, rep = h.solve_batch(Y, 1e-2, 24)
    assert h._G_cache is None and bool((rep.solution_error <= 1e-2).all())


@pytest.mark.parametrize("picks", [1, 4])
def test_omp_facade_gram_free_matches_jax(monkeypatch, picks):
    A, Y, _ = compressive_problem(128, 256, 8, 16, seed=3)
    monkeypatch.setenv("SS_BATCH_NATIVE", "1")
    theirs = ss.Omp(A, engine="jax", gram=False, precision="high",
                    picks=picks)
    mine = pt.Omp(A, gram=False, precision="high", picks=picks,
                  **TORCH_ROUTE)
    for key in ("corr", "gram_free", "formulation", "k_max", "picks"):
        assert mine.explain(batch=16, max_iterations=24).get(key) == \
            theirs.explain(batch=16, max_iterations=24).get(key), key
    Xj, rj = theirs.solve_batch(Y, 1e-2, 24)
    vals, idxs, rep = mine.solve_batch(Y, 1e-2, 24, dense=False)
    np.testing.assert_array_equal(rep.iter.numpy(), np.asarray(rj.iter))
    np.testing.assert_allclose(pt.densify_batch(vals, idxs, 256).numpy(),
                               np.asarray(Xj), atol=1e-5)


def test_update_column_drops_the_transposed_copy():
    """After update_column the gram-free solve reads the new column: the
    same result as a solver built on the changed A."""
    A, Y, _ = compressive_problem(64, 256, 4, 16, seed=5)
    col = np.random.RandomState(6).randn(64).astype(np.float32)
    col /= np.linalg.norm(col)
    A2 = A.copy()
    A2[:, 11] = col
    Y2 = Y.copy()
    Y2[0] = 0.8 * col
    for cls in (pt.Homotopy, pt.Omp):
        solver = cls(A, gram=False, precision="high", **TORCH_ROUTE)
        solver.solve_batch(Y, 1e-2, 16)
        solver.update_column(11, col)
        assert not solver._AT_cache
        X, rep = solver.solve_batch(Y2, 1e-2, 16)
        Xb, repb = cls(A2, gram=False, precision="high",
                       **TORCH_ROUTE).solve_batch(Y2, 1e-2, 16)
        assert torch.equal(X, Xb) and torch.equal(rep.iter, repb.iter)
        assert int(np.argmax(np.abs(X[0].numpy()))) == 11


@pytest.mark.parametrize("family", ["homotopy", "omp"])
def test_per_lane_solve_reads_the_kept_bf16_copy(monkeypatch, family):
    """A certified gram-free ``solve`` takes the per-lane core, whose
    operator carries the façade's bf16 transposed copy at "default": a
    second solve rounds no operand of A's size (``blas._operands``), where
    an operator without the copy rounds A for each product; its answer and
    iterations match that operator's; ``api.bf16_copy_lanes`` counts its
    one lane under the profiler, and a forced "high" re-solve none."""
    from sparse_solvers_tpu_torch import certify
    from sparse_solvers_tpu_torch.ops.operators import DenseOperator
    from sparse_solvers_tpu_torch.utils import profiling
    A, Y, _ = compressive_problem(64, 256, 4, 2, seed=5)
    m, n = A.shape
    cls = pt.Homotopy if family == "homotopy" else pt.Omp
    real = pblas._operands
    rounded = []

    def recording(*tensors):
        if pblas.current_precision() == "default":
            rounded.extend(t.numel() for t in tensors
                           if t.dtype == torch.float32)
        return real(*tensors)

    def second_solve(solver):
        solver.solve(Y[0], 1e-2, 20)
        rounded.clear()
        with monkeypatch.context() as patch:
            patch.setattr(pblas, "_operands", recording)
            x, rep = solver.solve(Y[1], 1e-2, 20)
        return x, rep, max(rounded)

    solver = cls(A, gram=False, **TORCH_ROUTE)
    assert "driver" not in solver.explain()["formulation"]
    x, rep, most = second_solve(solver)
    assert most < m * n
    assert solver._AT_cache[True].dtype == torch.bfloat16
    with monkeypatch.context() as patch:
        patch.setattr(papi._GramSolver, "_lane_operator",
                      lambda self, A, G, lanes: DenseOperator(A, G))
        x0, rep0, most0 = second_solve(cls(A, gram=False, **TORCH_ROUTE))
    assert most0 >= m * n
    assert rep.iter == rep0.iter
    np.testing.assert_allclose(x.numpy(), x0.numpy(), atol=1e-5)

    with profiling.trace():
        solver.solve(Y[1], 1e-2, 20)
    assert profiling.calls()[-1].counters == {
        "api.lanes": 1, "api.bf16_copy_lanes": 1}
    with monkeypatch.context() as patch:
        patch.setattr(certify, "failed_lanes", lambda *args: True)
        with profiling.trace():
            solver.solve(Y[1], 1e-2, 20)
    assert profiling.calls()[-1].counters == {
        "api.lanes": 1, "api.bf16_copy_lanes": 1, "api.resolved_lanes": 1}
