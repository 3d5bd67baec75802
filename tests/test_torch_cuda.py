"""The port's hand-written CUDA kernels against their PyTorch twins, on the
card. Every test here needs an NVIDIA GPU with nvcc and skips where torch
sees none. This file imports no jax (the card's machine has none); run it
there without the suite's jax conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

The shapes are ragged on purpose (n not a multiple of 8, K=13) to reach the
kernels' masked edges, which chip_smoke.py's aligned main-path shapes do
not. Tolerances: K1 1e-3·max|Q| (a P element may land on the neighbouring
bf16 value when the fp32 sums run in another order), K2 idx and gamma
exact, K3 indices and deg exact, floats 1e-5 of the tensor's scale, frozen
lanes bit-identical.
"""

import numpy as np
import pytest
import torch

from _torch_cases import (compressive_problem, degenerate_case, scan_case,
                          transition_case)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda", 0)


def _counted(name, fn):
    from sparse_solvers_tpu_torch.ops import dispatch
    before = dispatch.launches[name]
    out = fn()
    torch.cuda.synchronize()
    assert dispatch.launches[name] == before + 1
    return out


@pytest.mark.parametrize("m,n,b", [(72, 200, 5), (96, 256, 8),
                                   (64, 130, 1), (1, 8, 70), (130, 67, 65)])
def test_k1_kernel_matches_twin(dev, m, n, b):
    from sparse_solvers_tpu_torch.ops.cuda import kernels as K1
    g = torch.Generator(device=dev).manual_seed(m * n + b)
    A16 = torch.randn(m, n, generator=g, device=dev).to(torch.bfloat16)
    D = torch.randn(b, n, generator=g, device=dev)
    Q = _counted(K1.NAME, lambda: K1.normal_matvec_fused_bf16(A16, D))
    want = K1.normal_matvec_fused_bf16_plain(A16, D)
    assert Q.shape == (b, n) and Q.dtype == torch.float32
    err = float((Q - want).abs().max())
    assert err <= 1e-3 * float(want.abs().max()), err


@pytest.mark.parametrize("n", [200, 384])
def test_k2_kernel_matches_twin(dev, n):
    from sparse_solvers_tpu_torch.ops.cuda import scan as K2
    arrays, planted = scan_case(n)
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    g, i = _counted(K2.NAME, lambda: K2.find_max_gamma_fused(*args))
    gp, ip = K2.find_max_gamma_fused_plain(*args)
    assert torch.equal(i, ip) and torch.equal(g, gp)
    assert i[:4].tolist() == planted


@pytest.mark.parametrize("case", ["remove_p", "remove_last", "degenerate"])
def test_k3_kernel_matches_twin(dev, case):
    from sparse_solvers_tpu_torch.ops.cuda import transition as K3
    arrays, tol, n = (degenerate_case() if case == "degenerate" else
                      transition_case(case == "remove_last"))
    base = [torch.from_numpy(a).to(dev) for a in arrays]
    work = [t.clone() for t in base]
    deg = _counted(K3.NAME, lambda: K3.transition(*work, tol, n))
    want = K3.transition_plain(*base, tol, n)
    assert torch.equal(work[5], want[5]) and torch.equal(deg, want[6])
    for got, w in zip(work[:5], want[:5]):
        scale = max(1.0, float(w.abs().max()))
        assert float((got - w).abs().max()) <= 1e-5 * scale
    untouched = ~base[12] | deg
    for got, b0 in zip(work[:6], base[:6]):
        assert torch.equal(got[untouched], b0[untouched])


def test_k3_refuses_a_capacity_beyond_shared_memory(dev):
    from sparse_solvers_tpu_torch.ops.cuda import transition as K3
    b, K = 2, 200
    f = lambda *s: torch.zeros(s, device=dev)
    i = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)
    z = lambda *s: torch.zeros(s, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        K3.transition(f(b, K, K), f(b, K, K), f(b, K), f(b, K), f(b, K),
                      i(b, K), f(b, K), i(b), i(b), f(b), f(b), f(b),
                      z(b), z(b), z(b), 0.01, 10)


def test_driver_on_card_matches_cpu_twins(dev):
    from sparse_solvers_tpu_torch import Homotopy
    A, Y, Xt = compressive_problem(128, 256, 8, 16)
    out = {}
    for where in (dev, "cpu"):
        X, rep = Homotopy(A, k_max=41, precision="high",
                          device=where).solve_batch(Y, 0.01, 40)
        out[str(where)] = (X.cpu().numpy(), rep.iter.cpu().numpy())
    (Xg, ig), (Xc, ic) = out[str(dev)], out["cpu"]
    np.testing.assert_array_equal(ig, ic)
    np.testing.assert_allclose(Xg, Xc, atol=1e-5)


def test_certified_driver_on_card_launches_every_kernel(dev):
    from sparse_solvers_tpu_torch import Homotopy
    from sparse_solvers_tpu_torch.ops import dispatch
    A, Y, Xt = compressive_problem(256, 512, 8, 16, seed=3)
    dispatch.reset_launches()
    X, rep = Homotopy(A, k_max=48, device=dev).solve_batch(Y, 0.01, 64)
    assert all(v > 0 for v in dispatch.launches.values())
    assert bool((rep.solution_error <= 0.01).all())
    X = X.cpu().numpy()
    for lane in range(16):
        top = set(np.argsort(-np.abs(X[lane]))[:8].tolist())
        assert top == set(np.flatnonzero(Xt[lane]).tolist())
