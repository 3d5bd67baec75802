"""K5 ``normal_matvec_fused`` and K6 ``residual_correlation_fused`` of the
PyTorch port, and its roofline module, on the CPU.

On a CPU tensor each wrapper runs its plain twin. At "highest" the twins
are held against the JAX Pallas kernels in interpret mode on
``tests/test_pallas.py``'s shapes (its tolerance, 2e-4·max|ref|), plus
shapes the JAX VMEM gate sends to its XLA fallback (n = 100, b = 72 > 64),
which the port's kernels take like any other. At "default" interpret mode
computes in f32 (the CPU ignores the precision hint), while the port rounds
A, the batch operand and the intermediate to bf16 by design, so the twins
are held against a numpy reference with ``ml_dtypes`` bf16 roundings
instead, as ``test_pallas.py`` holds the bf16 kernel.
"""

import ml_dtypes
import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

import jax.numpy as jnp
from sparse_solvers_tpu.ops.pallas import kernels as JK
from sparse_solvers_tpu_torch.ops import blas, dispatch
from sparse_solvers_tpu_torch.ops.cuda import kernels as PK
from sparse_solvers_tpu_torch.utils import profiling

SHAPES = [(64, 128, 4), (72, 256, 5), (128, 128, 8), (16, 100, 2),
          (40, 128, 72)]


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(a)


def _bf16(a):
    return a.astype(ml_dtypes.bfloat16).astype(np.float32)


@pytest.mark.parametrize("m,n,b", SHAPES)
def test_k5_twin_matches_jax_kernel(m, n, b):
    A, D = _rand((m, n), 0), _rand((b, n), 1)
    ref = np.asarray(JK.normal_matvec_fused(jnp.asarray(A), jnp.asarray(D),
                                            interpret=True))
    with blas.precision_scope("highest"):
        q = PK.normal_matvec_fused(_t(A), _t(D)).numpy()
    np.testing.assert_allclose(q, ref, atol=2e-4 * np.abs(ref).max())
    assert dispatch.launches["normal_matvec_fused"] == 0


@pytest.mark.parametrize("m,n,b", SHAPES)
def test_k6_twin_matches_jax_kernel(m, n, b):
    A, X, Y = _rand((m, n), 0), _rand((b, n), 1), _rand((b, m), 2)
    ref = np.asarray(JK.residual_correlation_fused(
        jnp.asarray(A), jnp.asarray(X), jnp.asarray(Y), interpret=True))
    with blas.precision_scope("high"):
        c = PK.residual_correlation_fused(_t(A), _t(X), _t(Y)).numpy()
    np.testing.assert_allclose(c, ref, atol=2e-4 * np.abs(ref).max())
    assert dispatch.launches["residual_correlation_fused"] == 0


@pytest.mark.parametrize("m,n,b", [(96, 256, 8), (40, 100, 72)])
def test_default_precision_rounds_like_the_mxu(m, n, b):
    """At "default" the operands and the intermediate are bf16, the sums
    fp32: A16·(bf16(D16·A16ᵀ)) and bf16(Y − X16·A16ᵀ)·A16."""
    A, D, Y = _rand((m, n), 3), _rand((b, n), 4), _rand((b, m), 5)
    A16, D16 = _bf16(A), _bf16(D)
    q_ref = _bf16(D16 @ A16.T) @ A16
    c_ref = _bf16(Y - D16 @ A16.T) @ A16
    with blas.precision_scope("default"):
        q = PK.normal_matvec_fused(_t(A), _t(D)).numpy()
        c = PK.residual_correlation_fused(_t(A), _t(D), _t(Y)).numpy()
    np.testing.assert_allclose(q, q_ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(c, c_ref, rtol=1e-5, atol=1e-4)
    # and they really differ from the f32 product
    with blas.precision_scope("highest"):
        q32 = PK.normal_matvec_fused(_t(A), _t(D)).numpy()
    assert np.abs(q32 - q).max() > 1e-3


def test_validation_errors():
    A, D, Y = _t(_rand((8, 16), 0)), _t(_rand((2, 16), 1)), _t(_rand((2, 8),
                                                                  2))
    with pytest.raises(ValueError, match=r"\(b, 16\)"):
        PK.normal_matvec_fused(A, D[:, :15])
    with pytest.raises(ValueError, match="2-d"):
        PK.normal_matvec_fused(A[0], D)
    with pytest.raises(ValueError, match="Y must have shape"):
        PK.residual_correlation_fused(A, D, Y[:, :7])
    with pytest.raises(ValueError, match="Y must have shape"):
        PK.residual_correlation_fused(A, D, Y[:1])
    with pytest.raises(ValueError, match="span devices"):
        PK.normal_matvec_fused(A, D.to("meta"))


def test_empty_shapes_run_the_twin():
    A = _t(_rand((8, 16), 0))
    assert PK.normal_matvec_fused(A, torch.zeros(0, 16)).shape == (0, 16)
    C = PK.residual_correlation_fused(torch.zeros(0, 16), _t(_rand((3, 16),
                                                                   1)),
                                      torch.zeros(3, 0))
    assert C.shape == (3, 16) and not C.any()


def test_dispatch_names_k5_and_k6():
    names = ("normal_matvec_fused", "residual_correlation_fused")
    for name, line in zip(names, ("kernels.py:136", "kernels.py:267")):
        src, replaces = dispatch.KERNELS[name]
        assert src == "sparse_solvers_tpu_torch/csrc/fused_corr.cu"
        assert replaces == f"sparse_solvers_tpu/ops/pallas/{line}"
    assert dispatch.explain("cpu", names) == dict.fromkeys(
        names, "plain torch twin")
    assert dispatch.explain("cuda", names) == dict.fromkeys(
        names, "cuda (sparse_solvers_tpu_torch/csrc/fused_corr.cu)")


def test_roofline_arithmetic():
    h100 = profiling.CHIPS["h100"]
    assert (h100.bf16_tflops, h100.f32_tflops, h100.hbm_gbps) == (989, 67,
                                                                  3350)
    assert h100.peak_tflops("highest") == h100.peak_tflops("high") == 67
    assert h100.peak_tflops("default") == 989
    # K5 at b=256, m=4096, n=8192: fp32 operations bound it at "highest",
    # bytes at "default"
    b, m, n = 256, 4096, 8192
    flops, nbytes = 4 * b * m * n, 4 * (m * n + 2 * b * n)
    np.testing.assert_allclose(h100.bound_seconds(flops, nbytes, "highest"),
                               flops / 67e12)
    np.testing.assert_allclose(h100.bound_seconds(flops, nbytes, "default"),
                               nbytes / 3350e9)
    r = profiling.Roofline(seconds=1e-3, flops=flops, bytes=nbytes,
                           chip=h100)
    np.testing.assert_allclose(r.tflops, flops / 1e-3 / 1e12)
    np.testing.assert_allclose(r.gbps, nbytes / 1e-3 / 1e9)
    np.testing.assert_allclose(r.fraction_of_peak("highest"),
                               r.tflops / 67)
    np.testing.assert_allclose(r.fraction_of_peak("default"),
                               r.gbps / 3350)
    assert "TFLOP/s" in str(r) and "H100" in str(r)
    assert profiling.Roofline(1.0, 1.0, 1.0, None).fraction_of_peak() is None


def test_no_device_numbers_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert profiling.detect_chip() is None
    with pytest.raises(RuntimeError, match="CUDA card"):
        profiling.measure(lambda: None, flops=1, bytes=1)


def test_trace_records_host_ops(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64).sum()
    assert (tmp_path / "tr" / "trace.json").exists()
    assert len(prof.key_averages()) > 0
