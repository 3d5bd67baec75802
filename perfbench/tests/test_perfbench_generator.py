"""The generator: the same seed gives the same inputs, every seed the same
work in another order."""

import numpy as np
import pytest
import torch

from _cases import TINY_CONFIG, TINY_TRAFFIC
from perfbench import generator

CPU = torch.device("cpu")
SEEDS = (0, 7, 2**31 + 12345, 2**40 + 3, -5)


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_inputs(seed):
    A1 = generator.sensing_matrix(TINY_CONFIG, seed, CPU)
    A2 = generator.sensing_matrix(TINY_CONFIG, seed, CPU)
    assert torch.equal(A1, A2)
    mix = TINY_TRAFFIC["tiny-single"]
    Y1, k1 = generator.signal_pool(A1, mix, seed)
    Y2, k2 = generator.signal_pool(A2, mix, seed)
    assert torch.equal(Y1, Y2) and np.array_equal(k1, k2)


def test_seeds_differ():
    A = [generator.sensing_matrix(TINY_CONFIG, s, CPU) for s in SEEDS]
    for i in range(len(A)):
        for j in range(i):
            assert not torch.equal(A[i], A[j])


def test_matrix_has_unit_columns():
    A = generator.sensing_matrix(TINY_CONFIG, 3, CPU)
    assert A.shape == (TINY_CONFIG["m"], TINY_CONFIG["n"])
    assert A.dtype == torch.float32
    norms = torch.linalg.vector_norm(A.double(), dim=0)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-6)


def test_every_seed_sends_each_k_once_a_block():
    mix = dict(TINY_TRAFFIC["tiny-single"], pool_calls=12)
    width = mix["k_max"] - mix["k_min"] + 1
    orders = []
    for seed in SEEDS:
        ks = generator.sparsities(mix, seed)
        assert len(ks) == 12
        for b in range(0, 12 - width + 1, width):
            assert sorted(ks[b:b + width]) == list(range(mix["k_min"],
                                                         mix["k_max"] + 1))
        orders.append(tuple(ks))
    assert len(set(orders)) > 1


def test_signals_are_k_sparse_combinations_of_columns():
    A = generator.sensing_matrix(TINY_CONFIG, 11, CPU)
    mix = TINY_TRAFFIC["tiny-single"]
    Y, ks = generator.signal_pool(A, mix, 11)
    assert Y.shape == (mix["pool_calls"], 1, TINY_CONFIG["m"])
    # recover each signal's x by the float64 reference (y is rounded to
    # f32, so the certificate stops near 1e-8) and count its support
    from perfbench.reference import homotopy
    X, _, c_inf = homotopy.solve(A, Y[:, 0], 1e-6, 64)
    assert bool((c_inf <= 1e-6).all())
    for x, k in zip(X, ks[:, 0]):
        nz = x.abs() > 1e-6
        assert int(nz.sum()) == k
        assert bool(((x[nz] >= 0.5 - 1e-6) & (x[nz] <= 1.0 + 1e-6)).all())
