"""The readers' arithmetic on synthetic profiler events and reports."""

import math

import pytest

from _cases import REPO
from perfbench import harness, trace
from perfbench.metrics import _yardstick as ys

CONFIG = {"m": 4096, "n": 8192, "tolerance": 0.01,
          "options": {"precision": "certified"}}
TRAFFIC = {"batch": 256}


def read(name, run):
    return harness.load_module(REPO, "metrics", name).read(run)


def make_run(device_ops=None, traced_iters=((64,),), window=None):
    window = window or [harness.Call(0.1, [64] * 4, [0.001] * 4),
                        harness.Call(0.3, [60] * 4, [0.001, 0.5, 0.001,
                                                     float("nan")])]
    traced = None
    if device_ops is not None:
        traced = harness.Traced(
            [harness.Call(0.0, list(i), [0.0]) for i in traced_iters], 1.0,
            device_ops)
    return harness.Run("w", CONFIG, TRAFFIC, 1, 12.5, window, 0.4,
                       3 * 2**30, traced, 2**29)


def test_union_of_intervals():
    assert ys.union_seconds([]) == 0
    assert ys.union_seconds([(0, 1), (0.5, 2), (3, 4), (3.5, 3.6)]) == 3
    assert ys.union_seconds([(2, 3), (0, 1)]) == 2


def test_k1_work_and_bound():
    # b=256, m=4096, n=8192: 34.36 TFLOP... 3.4e10 operations at 989e12,
    # 1.8e8 bytes at 3.35e12: bound by operations
    flops, nbytes = ys.q_pass_work(256, 4096, 8192)
    assert flops == 4 * 256 * 4096 * 8192
    assert nbytes == 4096 * 8192 * 2 + 2 * 256 * 8192 * 4
    assert ys.bound_seconds(flops, nbytes, "bf16") == pytest.approx(
        flops / 989e12)
    assert ys.bound_seconds(0, 3.35e12, "fp32") == pytest.approx(1.0)


def test_end_to_end_readers():
    run = make_run()
    # 8 lanes, 6 within tol (0.5 over it, NaN never within) in 0.4 s
    assert read("solves_per_s", run) == pytest.approx(6 / 0.4)
    assert 100 < read("call_ms_p95", run) <= 300
    # the pool of signals (half a GiB here) is the benchmark's, not the
    # program's
    assert read("peak_mem_gib", run) == 2.5
    assert read("setup_s", run) == 12.5
    assert read("solver.iters_mean", run) == 62


def test_traced_readers():
    k1 = ys.bound_seconds(*ys.q_pass_work(256, 4096, 8192), "bf16")
    ops = [  # two calls of 64 driver iterations
        ("void tile_gemm::gemm_bf16_async_kernel<1>(x)", 0.0, 10 * k1),
        ("round_to_bf16_kernel(x)", 10 * k1, 11 * k1),
        ("gamma_scan_cluster_kernel", 0.010, 0.011),
        ("void at::native::reduce_kernel<1>(x)", 0.012, 0.014),
        ("Memcpy DtoH (Device -> Pinned)", 0.0135, 0.015),
        ("void at::native::elementwise_kernel<1>(x)", 0.020, 0.022),
    ]
    run = make_run(ops, traced_iters=((64, 10), (32, 64)))
    passes = 128
    assert read("k1_roofline", run) == pytest.approx(100 * passes / 11)
    assert read("solver.kernels_per_iter", run) == pytest.approx(5 / passes)
    assert read("torch_ops.device_ms_per_iter", run) == pytest.approx(
        4.0 / passes)
    busy = 11 * k1 + 0.001 + 0.003 + 0.002
    assert read("device.idle_share", run) == pytest.approx(
        100 * (1 - (busy / passes) / (0.4 / 124)))


def test_readers_without_a_trace_or_its_kernels_read_nothing():
    for name in ("k1_roofline", "solver.kernels_per_iter",
                 "torch_ops.device_ms_per_iter", "device.idle_share"):
        assert read(name, make_run()) is None
    other = make_run([("at::native::reduce_kernel", 0.0, 1.0)])
    assert read("k1_roofline", other) is None


def test_breakdown_names_ops_and_gaps():
    ops = [("void a<1>(x)", 0.0, 1.0), ("b(int)", 1.5, 2.0),
           ("void a<2>(y)", 4.0, 4.5), ("b(int)", 4.2, 5.0)]
    out = trace.breakdown(ops)
    assert out["device_ops"][0] == ["a", 1.5]
    assert out["idle_gaps"][0] == ["after b, before a", 2.0]
    assert out["idle_gaps"][1] == ["after a, before b", 0.5]
    assert trace.busy_seconds(ops) == 2.5
    many = [(f"k{i}", 2.0 * i, 2.0 * i + 1) for i in range(30)]
    out = trace.breakdown(many)
    assert len(out["device_ops"]) == len(out["idle_gaps"]) == trace.TOP


@pytest.mark.parametrize("name, short", [
    ("void tile_gemm::(anonymous namespace)::gemm_bf16_async_kernel<128, "
     "64, 32, 4, float>(__nv_bfloat16 const*, int)",
     "tile_gemm::gemm_bf16_async_kernel"),
    ("(anonymous namespace)::gamma_scan_cluster_kernel(float const*)",
     "gamma_scan_cluster_kernel"),
    ("Memcpy DtoH (Device -> Pinned)", "Memcpy DtoH"),
])
def test_short_names(name, short):
    assert trace.short_name(name) == short


def test_data_sheet_peaks():
    assert math.isclose(ys.PEAK_FLOPS["bf16"], 989e12)
    assert math.isclose(ys.PEAK_FLOPS["fp32"], 67e12)
    assert math.isclose(ys.HBM_BYTES_PER_S, 3.35e12)
