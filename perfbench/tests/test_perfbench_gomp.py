"""The OMP driver's readers on synthetic runs: ``omp.cols_per_pass`` and
``gomp.round_roofline`` from hand-built call records and device
intervals, the round's work by hand, and None without a trace, without
the program's ``omp.passes`` counter, without its span store, or where
its records do not line up with the traced calls."""

import pytest

from _cases import REPO
from perfbench import harness
from perfbench.metrics import _gomp_round, _omp_insert
from perfbench.metrics import _yardstick as ys
from sparse_solvers_tpu_torch.utils import profiling

M, N = 4096, 8192


def read(name, run):
    return harness.load_module(REPO, "metrics", name).read(run)


def _run(device_ops, traced_iters):
    traced = None
    if device_ops is not None:
        traced = harness.Traced(
            [harness.Call(0.0, list(i), [0.0] * len(i))
             for i in traced_iters], 1.0, device_ops)
    window = [harness.Call(0.1, [3] * 4, [0.001] * 4)]
    return harness.Run("g", {"m": M, "n": N, "tolerance": 0.01},
                       {"batch": 4}, 1, 1.0, window, 0.1, 0, traced)


@pytest.fixture
def records(monkeypatch):
    kept = []
    monkeypatch.setattr(profiling, "calls", lambda: list(kept))
    return kept


def _record(call_id, lanes, **counters):
    return profiling.CallRecord(call_id, [], {"api.lanes": lanes,
                                              **counters})


OPS = [("tile_gemm::ring::gemm_bf16_async_kernel", 0.0, 2e-3),
       ("Memcpy DtoD (Device -> Device)", 1e-3, 3e-3),
       ("omp_insert_rows_kernel", 4e-3, 5e-3)]
# two calls: 4 lanes in 3 passes, 2 lanes in 2 passes
ITERS = ((12, 11, 9, 12), (8, 5))


def _two_calls(records):
    records += [_record(1, 4, **{"omp.passes": 3, "omp.sub_inserts": 12}),
                _record(2, 2, **{"omp.passes": 2, "omp.sub_inserts": 8})]


def test_round_work_by_hand():
    # a pass over 2 lanes at m = 8, n = 16, and the lanes' 3 and 1 inserts
    q = ys.bound_seconds(*ys.q_pass_work(2, 8, 16), "bf16")
    assert _gomp_round.call_seconds([3, 1], 5, 8, 16) == pytest.approx(
        5 * q + _omp_insert.lane_seconds(3) + _omp_insert.lane_seconds(1))
    assert _gomp_round.call_seconds([], 0, 8, 16) == 0
    # the cell's pass: 256 lanes over 4096 x 8192, bound by its bf16
    # operations, 34.7 us
    assert ys.bound_seconds(*ys.q_pass_work(256, M, N), "bf16") == (
        pytest.approx(4 * 256 * M * N / 989e12))


def test_cols_per_pass_reads_columns_over_lane_passes(records):
    _two_calls(records)
    assert read("omp.cols_per_pass", _run(OPS, ITERS)) == (
        pytest.approx((44 + 13) / (4 * 3 + 2 * 2)))
    # one pick a pass and every lane to the end: 1
    records[:] = [_record(1, 2, **{"omp.passes": 5})]
    assert read("omp.cols_per_pass", _run(OPS, ((5, 5),))) == 1


def test_round_roofline_reads_the_work_over_the_busy_time(records):
    _two_calls(records)
    bound = (_gomp_round.call_seconds(ITERS[0], 3, M, N)
             + _gomp_round.call_seconds(ITERS[1], 2, M, N))
    # busy: 0 to 3 ms and 4 to 5 ms
    assert read("gomp.round_roofline", _run(OPS, ITERS)) == (
        pytest.approx(100 * bound / 4e-3))


@pytest.mark.parametrize("case", ["untraced", "no_counter", "no_store",
                                  "misaligned", "missing"])
@pytest.mark.parametrize("name", ["omp.cols_per_pass",
                                  "gomp.round_roofline"])
def test_readers_read_nothing_without_aligned_counted_records(
        records, name, case, monkeypatch):
    _two_calls(records)
    iters = ITERS
    if case == "no_counter":
        # a program that does not count the passes: no value, no raise
        for r in records:
            del r.counters["omp.passes"]
    elif case == "no_store":
        monkeypatch.delattr(profiling, "calls")
    elif case == "misaligned":
        iters = ((12, 11, 9), (8, 5))
    elif case == "missing":
        iters = ((1,),) * 3
    run = _run(None if case == "untraced" else OPS, iters)
    assert read(name, run) is None


def test_round_roofline_reads_nothing_without_device_operations(records):
    _two_calls(records)
    assert read("gomp.round_roofline", _run([], ITERS)) is None
    # the passes alone read without a card
    assert read("omp.cols_per_pass", _run([], ITERS)) is not None
