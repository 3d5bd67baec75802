"""K2's and K4's launch plans (``ops/cuda/scan.py::scan_launch_plan``,
``ops/cuda/omp_insert.py::k4_launch_plan``) on the CPU.

The split γ scan of ``csrc/scan.cu`` and the live-block insert of
``csrc/omp_insert.cu`` run only on the card; what their launches cover,
and what they ask of the card, is Python that the CPU reaches. K2: the
chunks tile each lane's positions exactly once, none empty, the cluster
is a portable shape, float4 loads only where the shapes allow, and the
main path's shape runs split. K4: the block and its shared memory fit, a
block takes a lane, rows load as float4 only where K and the alignment
allow, and the device-memory instantiation takes over exactly where the
shared one stops fitting. The
plans' constants are the ones the ``.cu`` files state.
"""

import re
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

from _torch_cases import omp_insert_case, scan_split_case
from sparse_solvers_tpu_torch.ops import dispatch
from sparse_solvers_tpu_torch.ops.cuda import omp_insert as K4
from sparse_solvers_tpu_torch.ops.cuda import scan as K2

CSRC = Path(__file__).resolve().parents[1] / "sparse_solvers_tpu_torch" / "csrc"
MAX_SMEM_BYTES = 232448  # a block's dynamic shared memory on the H100


def _constants(name):
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", (CSRC / name).read_text())}


# --- K2 ----------------------------------------------------------------------

@pytest.mark.parametrize("b", [1, 8, 256])
@pytest.mark.parametrize("n", [1, 3, 17, 4099, 8192, 65536])
def test_scan_chunks_tile_every_position_once(n, b):
    plan = K2.scan_launch_plan(b, n)
    hits = np.zeros(n, np.int32)
    for lo, hi in plan.chunks(n):
        assert lo < hi, "an empty chunk"
        hits[lo:hi] += 1
    assert (hits == 1).all()
    assert 1 <= plan.splits <= K2.SCAN_MAX_SPLITS
    assert plan.splits & (plan.splits - 1) == 0      # a cluster shape
    assert plan.grid == b * plan.splits < 2**31
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
    assert plan.chunk % 4 == 0
    if plan.vec == 4:
        assert n % 4 == 0
    # below the block's limit, one pass of UNROLL loads a thread covers it
    assert (plan.threads == K2.SCAN_MAX_THREADS
            or plan.threads * plan.vec * K2.SCAN_UNROLL >= plan.chunk)


@pytest.mark.parametrize("b", [1, 8, 64, 256, 1024])
def test_scan_splits_fill_the_sms(b):
    """S is the least power of two whose CTAs fill the 132 SMs twice, up
    to 8, wherever n gives each chunk its least share."""
    plan = K2.scan_launch_plan(b, 65536)
    assert b * plan.splits >= 2 * K2.SM_COUNT or plan.splits == 8
    assert plan.splits == 1 or b * plan.splits // 2 < 2 * K2.SM_COUNT


def test_scan_main_shape_runs_split():
    plan = K2.scan_launch_plan(256, 8192)
    assert (plan.splits, plan.threads, plan.vec, plan.chunk) == (2, 256, 4,
                                                                 4096)


@pytest.mark.parametrize("n", [17, 4099, 8192])
def test_scan_unaligned_bases_load_scalars(n):
    plan = K2.scan_launch_plan(3, n, aligned=False)
    assert plan.vec == 1
    assert plan.chunks(n) == K2.scan_launch_plan(3, n).chunks(n)


def test_scan_plan_refuses_what_passes_the_grid():
    with pytest.raises(ValueError, match="exceeds the kernel's grid"):
        K2.scan_launch_plan(2**29, 8)


def test_scan_plan_states_the_source_constants():
    c = _constants("scan.cu")
    assert c["MAX_THREADS"] == K2.SCAN_MAX_THREADS
    assert c["MAX_SPLITS"] == K2.SCAN_MAX_SPLITS
    assert c["UNROLL"] == K2.SCAN_UNROLL


# --- K4 ----------------------------------------------------------------------

def _shared_bytes(K):
    return 4 * (K * K + 3 * (-(-K // 4) * 4) + K4.K4_RED_FLOATS)


@pytest.mark.parametrize("K", [1, 13, 24, 32, 40, 64, 72, 128, 200, 300,
                               4096])
@pytest.mark.parametrize("b", [1, 5, 256])
def test_k4_plan_fits_the_card(b, K):
    plan = K4.k4_launch_plan(b, K)
    assert plan.smem_bytes <= MAX_SMEM_BYTES
    assert plan.threads <= K4.K4_MAX_THREADS and plan.threads % 32 == 0
    assert plan.threads // 32 <= K4.K4_RED_FLOATS
    # a warp for every K4_ROWS_PER_WARP rows, up to the block's limit
    assert (plan.threads == K4.K4_MAX_THREADS
            or plan.threads // 32 * K4.K4_ROWS_PER_WARP >= K)
    assert plan.smem_bytes == (_shared_bytes(K) if plan.shared
                               else _shared_bytes(K) - 4 * K * K)


def test_k4_device_memory_exactly_past_the_cap():
    shared = {K: K4.k4_launch_plan(256, K).shared for K in range(1, 400)}
    assert shared == {K: _shared_bytes(K) <= MAX_SMEM_BYTES for K in shared}
    cap = max(K for K, s in shared.items() if s)
    assert all(shared[K] for K in range(1, cap + 1))
    assert not any(shared[K] for K in range(cap + 1, 400))
    assert 230 <= cap <= 240 and not K4.k4_launch_plan(256, 300).shared


@pytest.mark.parametrize("K,aligned,vec", [(13, True, 1), (24, True, 4),
                                           (72, True, 4), (72, False, 1),
                                           (128, True, 4), (300, True, 4),
                                           (301, True, 1)])
def test_k4_rows_load_float4_where_they_can(K, aligned, vec):
    assert K4.k4_launch_plan(256, K, aligned).vec == vec


def test_k4_plan_refuses_what_shared_memory_cannot_hold():
    K4.k4_launch_plan(4, 19000)
    with pytest.raises(ValueError, match="exceeds the kernel's range"):
        K4.k4_launch_plan(4, 20000)


def test_k4_plan_states_the_source_constants():
    c = _constants("omp_insert.cu")
    assert c["MAX_THREADS"] == K4.K4_MAX_THREADS
    assert c["RED_FLOATS"] == K4.K4_RED_FLOATS


def test_cpu_tensors_take_the_twins():
    """The plans belong to the CUDA launches: on CPU tensors the wrappers
    run the twins and count no launch."""
    dispatch.reset_launches()
    arrays, expected = scan_split_case(3, 4099, 9, [2052])
    args = [torch.from_numpy(a) for a in arrays]
    g, i = K2.find_max_gamma_fused(*args)
    gp, ip = K2.find_max_gamma_fused_plain(*args)
    assert torch.equal(g, gp) and torch.equal(i, ip)
    assert {lane: int(i[lane]) for lane in expected} == expected
    base = [torch.from_numpy(a) for a in omp_insert_case(6, 24)]
    inv = base[0].clone()
    coef, deg = K4.omp_insert(inv, *base[1:])
    inv_p, coef_p, deg_p = K4.omp_insert_plain(*base)
    assert torch.equal(inv, inv_p) and torch.equal(coef, coef_p)
    assert torch.equal(deg, deg_p)
    assert not any(dispatch.launches.values())
