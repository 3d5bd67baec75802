"""The PyTorch port's kernel twins against the JAX package's Pallas kernels.

On the CPU every port wrapper runs its plain PyTorch twin (the CUDA kernels
are held against the same twins on the card by chip_smoke.py and
tests/test_torch_cuda.py). The same seeded numpy inputs go through the
Pallas kernel in interpret mode and through the port:

  K1 normal_matvec_fused_bf16  rtol 1e-5, atol 1e-4 (as tests/test_pallas.py:
                               f32 sums in another order)
  K2 find_max_gamma_fused      idx exact, gamma rtol 1e-6
  K3 transition                indices and deg exact, floats atol 1e-5,
                               frozen lanes bit-identical
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_cases import degenerate_case, scan_case, transition_case
from sparse_solvers_tpu.ops.pallas import kernels as JK
from sparse_solvers_tpu.ops.pallas import scan as JS
from sparse_solvers_tpu.ops.pallas import transition as JT
from sparse_solvers_tpu_torch.ops import dispatch
from sparse_solvers_tpu_torch.ops.cuda import kernels as PK
from sparse_solvers_tpu_torch.ops.cuda import scan as PS
from sparse_solvers_tpu_torch.ops.cuda import transition as PT


def _t(a):
    return torch.from_numpy(np.array(a))


def test_k1_twin_matches_pallas_interpret():
    rng = np.random.RandomState(0)
    m, n, b = 96, 256, 8
    A = rng.randn(m, n).astype(np.float32)
    D = rng.randn(b, n).astype(np.float32)
    q_jax = np.asarray(JK.normal_matvec_fused_bf16(
        jnp.asarray(A, jnp.bfloat16), jnp.asarray(D), interpret=True))
    q = PK.normal_matvec_fused_bf16(_t(A).to(torch.bfloat16), _t(D))
    assert q.dtype == torch.float32
    np.testing.assert_allclose(q.numpy(), q_jax, rtol=1e-5, atol=1e-4)


def test_k1_twin_matches_bf16_recipe_ragged():
    """At a ragged (72, 200, 5) the JAX wrapper leaves its TPU envelope and
    falls back to an unrounded two-gemm, so the port's twin is held
    against the numpy recipe of tests/test_pallas.py:61-64 instead."""
    import ml_dtypes

    rng = np.random.RandomState(1)
    m, n, b = 72, 200, 5
    A = rng.randn(m, n).astype(np.float32)
    D = rng.randn(b, n).astype(np.float32)
    A16 = A.astype(ml_dtypes.bfloat16).astype(np.float32)
    D16 = D.astype(ml_dtypes.bfloat16).astype(np.float32)
    p16 = (D16 @ A16.T).astype(ml_dtypes.bfloat16).astype(np.float32)
    q = PK.normal_matvec_fused_bf16(_t(A).to(torch.bfloat16), _t(D))
    np.testing.assert_allclose(q.numpy(), p16 @ A16, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n", [200, 384])
def test_k2_twin_matches_pallas_interpret(n):
    args, planted = scan_case(n)
    g_jax, i_jax = JS.find_max_gamma_fused(*map(jnp.asarray, args),
                                           interpret=True)
    g, i = PS.find_max_gamma_fused(*map(_t, args))
    assert i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_jax))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_jax), rtol=1e-6)
    assert i[:4].tolist() == planted
    assert float(g[3]) == float(np.finfo(np.float32).max)


def _jax_transition(args, tol, n):
    out = JT.transition(*map(jnp.asarray, args), np.float32(tol), n,
                        interpret=True)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("remove_last", [False, True])
def test_k3_twin_matches_pallas_interpret(remove_last):
    args, tol, n = transition_case(remove_last)
    want = _jax_transition(args, tol, n)
    state = [_t(a) for a in args]
    deg = PT.transition(*state, tol, n)   # in place on the first six
    got = [s.numpy() for s in state[:6]] + [deg.numpy()]
    names = ("inv", "gk", "x_act", "d_act", "c_act")
    for name, g, w in zip(names, got[:5], want[:5]):
        np.testing.assert_allclose(g, w, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got[5], want[5])
    np.testing.assert_array_equal(got[6], want[6])
    frozen = ~args[12]
    for g, a in zip(got[:6], args[:6]):
        assert np.array_equal(g[frozen], a[frozen]), "frozen lane moved"
    # the remove never leaves dust in vacated slots
    for lane in range(len(frozen)):
        dead = got[5][lane] >= n
        assert np.abs(got[0][lane][dead]).max(initial=0) == 0
        assert np.abs(got[1][lane][dead]).max(initial=0) == 0


def test_k3_degenerate_insert_flags_and_freezes_lane():
    args, tol, n = degenerate_case()
    want = _jax_transition(args, tol, n)
    state = [_t(a) for a in args]
    deg = PT.transition(*state, tol, n)
    np.testing.assert_array_equal(deg.numpy(), want[6])
    assert deg.tolist() == [True, False]
    for s, a in zip(state[:6], args[:6]):
        np.testing.assert_array_equal(s[0].numpy(), a[0])
    assert int(state[5][1, 2]) == 5
    np.testing.assert_allclose(state[2][1, 0].item(), 0.75, atol=1e-6)


def test_k3_twin_is_out_of_place():
    args, tol, n = transition_case(False)
    base = [_t(a) for a in args]
    keep = [b.clone() for b in base]
    PT.transition_plain(*base, tol, n)
    for b, k in zip(base, keep):
        assert torch.equal(b, k)


def test_cpu_tensors_take_the_twins_and_count_no_launch():
    before = dict(dispatch.launches)
    args, _ = scan_case(200)
    PS.find_max_gamma_fused(*map(_t, args))
    args3, tol, n = transition_case(True)
    PT.transition(*map(_t, args3), tol, n)
    PK.normal_matvec_fused_bf16(torch.ones(4, 8, dtype=torch.bfloat16),
                                torch.ones(2, 8))
    assert dispatch.launches == before
    assert set(dispatch.explain("cpu").values()) == {"plain torch twin"}
    assert all(v.startswith("cuda (sparse_solvers_tpu_torch/csrc/")
               for v in dispatch.explain("cuda").values())


def test_dispatch_refuses_other_and_mixed_devices():
    with pytest.raises(ValueError, match="no kernel route"):
        dispatch.use_cuda_kernel(torch.empty(2, device="meta"))
    with pytest.raises(ValueError, match="span devices"):
        dispatch.use_cuda_kernel(torch.empty(2),
                                 torch.empty(2, device="meta"))
