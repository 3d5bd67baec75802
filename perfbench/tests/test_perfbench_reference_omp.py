"""The batched plain OMP reference against a one-lane loop at a tiny size;
its certificate; its bf16 control far from it; and K4's roofline reader
on a synthetic traced run."""

import numpy as np
import pytest
import torch

from _cases import REPO
from perfbench import harness
from perfbench.metrics import _omp_insert
from perfbench.metrics import _yardstick as ys
from perfbench.reference import homotopy, omp


def loop_solve(A, y, tol, max_iterations):
    """One lane in float64, a Python loop: the largest |A^T r| over the
    columns not yet picked (leftmost on ties, strictly positive), the
    least squares refit by ``lstsq``, and the stops of OMP."""
    n = A.shape[1]
    k_max = max(1, min(max_iterations, *A.shape))
    support, coef, r = [], np.zeros(0), y.copy()
    rnorm = np.linalg.norm(r)
    while len(support) < min(max_iterations, k_max) and rnorm > tol:
        c = np.abs(A.T @ r)
        c[support] = -np.inf
        j = int(np.argmax(c))
        if not c[j] > 0:
            break
        support.append(j)
        coef = np.linalg.lstsq(A[:, support], y, rcond=None)[0]
        r = y - A[:, support] @ coef
        stall = np.linalg.norm(r) >= rnorm
        rnorm = np.linalg.norm(r)
        if stall:
            break
    x = np.zeros(n)
    x[support] = coef
    return x, len(support), rnorm, support


@pytest.fixture(scope="module")
def problem():
    rng = np.random.RandomState(5)
    m, n, b = 48, 160, 7
    A = rng.randn(m, n)
    A /= np.linalg.norm(A, axis=0)
    X = np.zeros((b, n))
    for i, k in enumerate((1, 2, 3, 5, 8, 20, 40)):
        X[i, rng.choice(n, k, replace=False)] = rng.uniform(0.5, 1.0, k)
    Y = X @ A.T
    return (torch.from_numpy(A.astype(np.float32)),
            torch.from_numpy(Y.astype(np.float32)), X)


# the last lanes (k = 20, 40 of m = 48) stall or use up the budget
@pytest.mark.parametrize("tol, iters", [(1e-2, 40), (1e-6, 60), (1e-2, 3)])
def test_batched_reference_is_the_loop(problem, tol, iters):
    A, Y, _ = problem
    X, it, rnorm, slots = omp.solve_supports(A, Y, tol, iters)
    assert X.dtype == torch.float64
    for lane in range(Y.shape[0]):
        x, k, r, support = loop_solve(A.double().numpy(),
                                      Y[lane].double().numpy(), tol, iters)
        assert int(it[lane]) == k
        assert slots[lane, :k].tolist() == support
        assert bool((slots[lane, k:] == A.shape[1]).all())
        assert np.abs(X[lane].numpy() - x).max() <= 1e-10
        assert float(rnorm[lane]) == pytest.approx(r, rel=1e-8, abs=1e-12)


def test_reference_recovers_the_planted_signals(problem):
    A, Y, X0 = problem
    X, it, rnorm = omp.solve(A, Y[:5], 1e-6, 40)
    assert bool((rnorm <= 1e-6).all())
    assert it.tolist() == [1, 2, 3, 5, 8]
    assert np.abs(X.numpy() - X0[:5]).max() < 1e-5


def test_certificate_is_the_l2_residual(problem):
    A, Y, _ = problem
    A64, Y64 = A.double(), Y.double()
    X = torch.zeros((Y.shape[0], A.shape[1]), dtype=torch.float64)
    assert torch.allclose(omp.certificate(A64, Y64, X),
                          Y64.norm(dim=1), rtol=1e-12)
    X[:, 3] = 0.25
    R = Y64 - X @ A64.T
    assert torch.allclose(omp.certificate(A64, Y64, X), R.norm(dim=1),
                          rtol=1e-12)
    # not Homotopy's ||A^T r||_inf
    assert not torch.allclose(omp.certificate(A64, Y64, X),
                              homotopy.certificate(A64, Y64, X))


def test_a_finished_lane_passes_through(problem):
    A, Y, _ = problem
    one = omp.solve(A, Y[:1], 1e-2, 40)
    many = omp.solve(A, Y, 1e-2, 40)
    assert torch.equal(one[0][0], many[0][0])
    assert int(one[1][0]) == int(many[1][0]) == 1


def test_control_is_bf16(problem):
    A, Y, _ = problem
    X, _, _ = omp.solve(A, Y, 1e-2, 40)
    Xc, _, rc = omp.solve(A, Y, 1e-2, 40, "bfloat16")
    assert Xc.dtype == rc.dtype == torch.float32
    assert 1e-3 < float((Xc.double() - X).abs().max())
    # its certificate held to float64 misses what its loop reports
    cert = omp.certificate(A.double(), Y.double(), Xc.double())
    assert float((cert - rc.double()).abs().max()) > 1e-3
    with pytest.raises(ValueError):
        omp.solve(A, Y, 1e-2, 40, "float16")


def test_insert_work_counts_the_live_block():
    # s = 1: nothing read of the inverse, a 1 x 1 block written, three
    # values of the column, b_act and coef
    assert _omp_insert.insert_work(1) == (4.0, 4.0 * (0 + 1 + 3))
    assert _omp_insert.insert_work(64) == (
        2.0 * 63 ** 2 + 4.0 * 64 ** 2, 4.0 * (63 ** 2 + 64 ** 2 + 192))
    # bytes bound it at every live size of the cell
    for s in (1, 24, 72):
        flops, nbytes = _omp_insert.insert_work(s)
        assert flops / ys.PEAK_FLOPS["fp32"] < nbytes / ys.HBM_BYTES_PER_S
    assert _omp_insert.lane_seconds(0) == 0
    assert _omp_insert.lane_seconds(3) == pytest.approx(sum(
        _omp_insert.insert_work(s)[1] for s in (1, 2, 3)) / 3.35e12)


def _run(device_ops, traced_iters):
    traced = None
    if device_ops is not None:
        traced = harness.Traced(
            [harness.Call(0.0, list(i), [0.0] * len(i))
             for i in traced_iters], 1.0, device_ops)
    window = [harness.Call(0.1, [64] * 4, [0.001] * 4)]
    return harness.Run("o", {"m": 4096, "n": 8192, "tolerance": 0.01},
                       {"batch": 4}, 1, 1.0, window, 0.1, 0, traced)


def read(run):
    return harness.load_module(REPO, "metrics", "k4_roofline").read(run)


def test_k4_roofline_reads_the_reports_over_the_kernel():
    ops = [("void (anonymous namespace)::omp_insert_rows_kernel<true, 4>"
            "(float*, float const*)", 0.0, 2e-6),
           ("void (anonymous namespace)::omp_insert_rows_kernel<false, 1>"
            "(float*, float const*)", 1e-3, 1e-3 + 3e-6),
           ("void tile_gemm::gemm_bf16_async_kernel<1>(x)", 0.0, 1.0),
           ("Memcpy DtoH (Device -> Pinned)", 0.5, 0.6)]
    iters = ((64, 60, 0), (10,))
    bound = sum(_omp_insert.lane_seconds(i) for c in iters for i in c)
    assert read(_run(ops, iters)) == pytest.approx(100 * bound / 5e-6)


def test_k4_roofline_reads_nothing_without_a_trace_or_k4():
    assert read(_run(None, ())) is None
    assert read(_run([("round_to_bf16_kernel", 0.0, 1.0)], ((64,),))) is None
