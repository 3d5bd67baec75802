"""The batched plain CoSaMP reference against the JAX package's NumPy
oracle at tiny sizes (loaded from its file, so that JAX is not imported);
its sparsity, read from the configuration; its bf16 control far from it;
and the round's roofline and union readers on synthetic runs."""

import importlib.util
import json

import numpy as np
import pytest
import torch

from _cases import REPO
from perfbench import harness
from perfbench.metrics import _cosamp_round
from perfbench.metrics import _yardstick as ys
from perfbench.reference import cosamp, omp

_spec = importlib.util.spec_from_file_location(
    "cosamp_oracle", REPO / "sparse_solvers_tpu" / "oracle" / "cosamp.py")
oracle = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(oracle)


def _problem(m, n, k, lanes=6, seed=5):
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n)
    A /= np.linalg.norm(A, axis=0)
    X = np.zeros((lanes, n))
    for lane in range(lanes):
        X[lane, rng.choice(n, k, replace=False)] = rng.uniform(0.5, 1.0, k)
    return A, X @ A.T, X


# converging lanes, lanes that stall (k2 = m - k < k), a cut budget
@pytest.mark.parametrize("m, n, k, tol, rounds", [
    (48, 160, 4, 1e-6, 20), (128, 512, 8, 1e-2, 20), (48, 160, 20, 1e-2, 20),
    (48, 160, 30, 1e-2, 5), (64, 256, 12, 1e-8, 1)])
def test_reference_is_the_oracle(m, n, k, tol, rounds):
    A, Y, _ = _problem(m, n, k)
    X, it, rnorm, supp = cosamp.solve_sparsity(
        torch.from_numpy(A), torch.from_numpy(Y), k, tol, rounds)
    for lane in range(Y.shape[0]):
        x, r, res, support = oracle.solve(A, Y[lane], k, tol, rounds)
        assert int(it[lane]) == r
        assert sorted(j for j in supp[lane].tolist() if j < n) == support
        assert np.abs(X[lane].numpy() - x).max() <= 1e-10
        assert float(rnorm[lane]) == pytest.approx(res, rel=1e-8, abs=1e-12)


def test_sparsity_is_the_configurations():
    config = json.loads((REPO / "perfbench" / "configs"
                         / "cosamp-4096x8192.json").read_text())
    assert cosamp.K_SPARSITY == config["options"]["k_sparsity"]
    assert config["reference"] == "cosamp" and config["facade"] == "Cosamp"


def test_recovers_the_planted_signals_and_passes_finished_lanes():
    A, Y, X0 = _problem(128, 512, 8)
    A, Y = torch.from_numpy(A), torch.from_numpy(Y)
    X, it, rnorm, _ = cosamp.solve_sparsity(A, Y, 8, 1e-6, 20)
    assert bool((rnorm <= 1e-6).all())
    assert np.abs(X.numpy() - X0).max() < 1e-10
    one = cosamp.solve_sparsity(A, Y[:1], 8, 1e-6, 20)
    # alone, a lane takes the same rounds to the same x
    assert int(one[1][0]) == int(it[0])
    assert float((one[0][0] - X[0]).abs().max()) <= 1e-12


def test_certificate_is_omps():
    assert cosamp.certificate is omp.certificate


def test_control_is_bf16():
    A, Y, _ = _problem(128, 512, 8)
    A, Y = torch.from_numpy(A).float(), torch.from_numpy(Y).float()
    X, _, _, _ = cosamp.solve_sparsity(A, Y, 8, 1e-2, 20)
    Xc, _, rc, _ = cosamp.solve_sparsity(A, Y, 8, 1e-2, 20, "bfloat16")
    assert Xc.dtype == rc.dtype == torch.float32
    assert 1e-3 < float((Xc.double() - X).abs().max())
    with pytest.raises(ValueError):
        cosamp.solve(A, Y, 1e-2, 20, "float16")


def test_round_work_by_hand():
    assert _cosamp_round.union_capacity(4096, 8192, 64) == 192
    assert _cosamp_round.union_capacity(48, 160, 30) == 48
    # two lanes at m = 8, n = 16, S = 3: each a 2 m n proxy and an S^3/3
    # Cholesky; A read once, each lane's S^2 Gram entries
    assert _cosamp_round.trip_work(2, 8, 16, 3) == (2 * (256 + 9.0),
                                                    4.0 * 128 + 2 * 36.0)
    # trips 1 and 2 run two lanes and one; a lane of 0 rounds adds nothing
    assert _cosamp_round.call_seconds([2, 1, 0], 8, 16, 3) == pytest.approx(
        ys.bound_seconds(*_cosamp_round.trip_work(2, 8, 16, 3), "fp32")
        + ys.bound_seconds(*_cosamp_round.trip_work(1, 8, 16, 3), "fp32"))
    assert _cosamp_round.call_seconds([], 8, 16, 3) == 0
    # the cell's trip of 256 lanes is bound by the fp32 proxy: 0.265 ms
    flops, nbytes = _cosamp_round.trip_work(256, 4096, 8192, 192)
    assert flops / 67e12 > nbytes / 3.35e12
    assert _cosamp_round.call_seconds([1] * 256, 4096, 8192, 192) == (
        pytest.approx(256 * (2 * 4096 * 8192 + 192 ** 3 / 3) / 67e12))


def _run(device_ops, traced_iters):
    traced = None
    if device_ops is not None:
        traced = harness.Traced(
            [harness.Call(0.0, list(i), [0.0] * len(i))
             for i in traced_iters], 1.0, device_ops)
    window = [harness.Call(0.1, [3] * 4, [0.001] * 4)]
    return harness.Run("c", {"m": 4096, "n": 8192, "tolerance": 0.01,
                             "options": {"k_sparsity": 64}},
                       {"batch": 4}, 1, 1.0, window, 0.1, 0, traced)


def read(name, run):
    return harness.load_module(REPO, "metrics", name).read(run)


def test_round_roofline_reads_the_reports_over_the_busy_time():
    ops = [("void at::native::sort_kernel(x)", 0.0, 2e-3),
           ("Memcpy DtoH (Device -> Pinned)", 1e-3, 3e-3),
           ("void gemm_kernel(x)", 4e-3, 5e-3)]
    iters = ((3, 2, 0), (1,))
    bound = sum(_cosamp_round.call_seconds(c, 4096, 8192, 192)
                for c in iters)
    assert read("cosamp.round_roofline", _run(ops, iters)) == (
        pytest.approx(100 * bound / 4e-3))


def test_round_roofline_reads_nothing_without_a_trace_or_a_round():
    assert read("cosamp.round_roofline", _run(None, ())) is None
    assert read("cosamp.round_roofline", _run([], ((1,),))) is None
    assert read("cosamp.round_roofline", _run([("k", 0.0, 1.0)],
                                              ((0, 0),))) is None


def test_union_reader_reads_nothing_without_matching_records():
    # no traced calls, or the program's records do not line up with them
    assert read("cosamp.union_gib_per_round", _run(None, ())) is None
    run = _run([("k", 0.0, 1.0)], ((1,) * 1000,))
    assert read("cosamp.union_gib_per_round", run) is None
