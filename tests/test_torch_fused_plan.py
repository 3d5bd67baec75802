"""K5's and K6's launch plan (``ops/cuda/kernels.py::fused_launch_plan``)
on the CPU.

The tile GEMMs of ``csrc/fused_corr.cu`` run only on the card; what their
launches cover, and what they ask of the card, is Python that the CPU
reaches. At both precisions, at the kernel bench's shapes and at the card
tests' shapes: every grid covers each output element of each split exactly
once, the splits' depth ranges tile the depth once and in order, the
dynamic shared memory fits a block, every grid dimension fits, and each
pass at the bench shapes launches at least one block per SM of the H100.
The plan's constants are the ones ``csrc/tile_gemm.cuh`` and
``csrc/fused_corr.cu`` state.
"""

import re
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

from sparse_solvers_tpu_torch.ops import blas, dispatch
from sparse_solvers_tpu_torch.ops.cuda import kernels as K

BENCH = [(8, 4096, 8192), (64, 4096, 8192), (256, 4096, 8192)]
# (b, m, n) of tests/test_torch_cuda.py's K5/K6 shapes
CARD = [(5, 72, 200), (8, 96, 256), (1, 64, 130), (70, 1, 8),
        (65, 130, 67), (17, 33, 100), (3, 300, 520), (8, 72, 4100),
        (64, 96, 2050), (130, 40, 1030)]
PRECISIONS = ["highest", "default"]
MAX_SMEM_BYTES = 232448  # a block's dynamic shared memory on the H100
CSRC = Path(__file__).resolve().parents[1] / "sparse_solvers_tpu_torch" / "csrc"


def _passes(plan, b, m, n):
    """(grid, splits, chunk, output columns, depth) of pass 1 and pass 2."""
    return [(plan.grid1, plan.splits[0], plan.chunks[0], m, n),
            (plan.grid2, plan.splits[1], plan.chunks[1], n, m)]


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("b,m,n", BENCH + CARD)
def test_grids_cover_each_output_of_each_split_once(b, m, n, precision):
    plan = K.fused_launch_plan(b, m, n, precision)
    bm, bn, _ = plan.tile
    for grid, splits, _, cols, _ in _passes(plan, b, m, n):
        assert grid[2] == splits
        hits = np.zeros((splits, b, cols), np.int32)
        for z in range(grid[2]):
            for bx in range(grid[0]):
                for by in range(grid[1]):
                    hits[z, bx * bm:(bx + 1) * bm, by * bn:(by + 1) * bn] += 1
        assert (hits == 1).all()
        # no block lies wholly past the edge
        assert (grid[0] - 1) * bm < b and (grid[1] - 1) * bn < cols


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("b,m,n", BENCH + CARD)
def test_split_ranges_tile_the_depth_once_in_order(b, m, n, precision):
    plan = K.fused_launch_plan(b, m, n, precision)
    bk = plan.tile[2]
    for _, splits, chunk, _, depth in _passes(plan, b, m, n):
        assert chunk % bk == 0 and 1 <= splits <= K.MAX_SPLITS
        ranges = [(z * chunk, min(depth, (z + 1) * chunk))
                  for z in range(splits)]
        assert ranges[0][0] == 0 and ranges[-1][1] == depth
        assert all(lo < hi for lo, hi in ranges)   # none empty
        assert all(a[1] == c[0] for a, c in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("b,m,n", BENCH + CARD)
def test_plan_fits_the_card(b, m, n, precision):
    plan = K.fused_launch_plan(b, m, n, precision)
    assert plan.smem_bytes <= MAX_SMEM_BYTES
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    for grid in (plan.grid1, plan.grid2):
        assert grid[0] < 2**31 and grid[1] <= K.MAX_GRID_Y
        assert grid[2] <= K.MAX_GRID_Y
    # the scratches the C entry takes, in its order
    assert list(plan.scratch) == ["a16", "v16", "p1", "t", "p2"]
    (s1, s2), bf16 = plan.splits, plan.ring == "bf16"
    assert plan.scratch["t"][0] == (b, m)
    assert (plan.scratch["p1"] is not None) == (bf16 or s1 > 1)
    assert (plan.scratch["p2"] is not None) == (s2 > 1)
    assert (plan.scratch["a16"] is not None) == bf16


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("b,m,n", BENCH)
def test_bench_shapes_fill_the_sms(b, m, n, precision):
    plan = K.fused_launch_plan(b, m, n, precision)
    for grid in (plan.grid1, plan.grid2):
        assert grid[0] * grid[1] * grid[2] >= K.SM_COUNT
    # the batch tile by b: at most 16 lanes at b=8, 64 at b=64, 128 at 256
    assert plan.tile[0] == {8: 16, 64: 64, 256: 128}[b]


def test_high_plans_as_highest():
    assert K.fused_launch_plan(64, 4096, 8192, "high") == \
        K.fused_launch_plan(64, 4096, 8192, "highest")


@pytest.mark.parametrize("b,m,n", [(4, 128 * 65535 + 1, 8),
                                   (4, 8, 128 * 65535 + 1),
                                   (2**31, 8, 8)])
def test_plan_refuses_what_passes_the_grid(b, m, n):
    with pytest.raises(ValueError, match="exceeds the kernel's grid"):
        K.fused_launch_plan(b, m, n, "highest")


def _constants(path, namespace=None):
    text = (CSRC / path).read_text()
    if namespace is not None:
        text = text[text.index(f"namespace {namespace} {{"):text.index(
            f"}}  // namespace {namespace}")]
    return {name: int(val) for name, val in re.findall(
        r"constexpr int (\w+) = (\d+);", text)}


def test_plan_states_the_source_constants():
    tiles = _constants("fused_corr.cu")
    assert (tiles["BATCH_TILE_SMALL"], tiles["BATCH_TILE_MID"],
            tiles["BATCH_TILE_LARGE"]) == K.FUSED_BATCH_TILES
    r = _constants("tile_gemm.cuh", "ring")
    assert K.RING_TILE_N == {16: r["BN"], 64: r["BN"],
                             128: tiles["RING_BN_LARGE"]}
    assert (K.RING_BK, K.RING_STAGES) == (tiles["RING_BK"],
                                          tiles["RING_STAGES"])
    f = _constants("tile_gemm.cuh", "f32ring")
    assert (f["BN"], f["BK"]) == K.F32_TILE and f["STAGES"] == K.F32_STAGES
    assert K.F32_THREAD_TILE == {16: (f["TM_SMALL"], f["TN"]),
                                 64: (f["TM"], f["TN"]),
                                 128: (f["TM"], f["TN"])}
    for b, bm in ((8, 16), (64, 64), (256, 128)):
        hi = K.fused_launch_plan(b, 4096, 8192, "highest")
        lo = K.fused_launch_plan(b, 4096, 8192, "default")
        tm, tn = hi.thread_tile
        # the header's f32 ring: padded [row][k] slices of L and R (N,K),
        # [k][col] slices of R (K,N), STAGES of them
        assert hi.tile == (bm, f["BN"], f["BK"])
        assert hi.threads == (bm // tm) * (f["BN"] // tn)
        assert hi.smem_bytes == 4 * f["STAGES"] * (
            bm * (f["BK"] + 4) + max(f["BN"] * (f["BK"] + 4),
                                     f["BK"] * (f["BN"] + 4)))
        # K1's ring at this tile: warps of 32x32 (16x32 at 16 lanes),
        # rows padded by 8 bf16, the f32 epilogue on the ring's memory
        bn, bk, st = K.RING_TILE_N[bm], K.RING_BK, K.RING_STAGES
        assert lo.tile == (bm, bn, bk) and lo.stages == st
        assert lo.threads == bm // (32 if bm >= 32 else 16) * bn
        assert lo.smem_bytes == max(2 * st * (
            bm * (bk + 8) + max(bn * (bk + 8), bk * (bn + 8))),
            4 * bm * (bn + 4))
    assert K.fused_launch_plan(8, 4096, 8192, "default").tile[1] == \
        K.k1_launch_plan(8, 4096, 8192).tile[1]


def test_cpu_tensors_take_the_twins():
    """The plan belongs to the CUDA launch: on CPU tensors the wrappers
    run the twins and count no launch."""
    dispatch.reset_launches()
    rng = np.random.RandomState(0)
    A, D, Y = (torch.from_numpy(rng.randn(*s).astype(np.float32))
               for s in ((40, 130), (9, 130), (9, 40)))
    for precision in PRECISIONS:
        with blas.precision_scope(precision):
            torch.testing.assert_close(K.normal_matvec_fused(A, D),
                                       K.normal_matvec_fused_plain(A, D),
                                       rtol=0, atol=0)
            torch.testing.assert_close(
                K.residual_correlation_fused(A, D, Y),
                K.residual_correlation_fused_plain(A, D, Y), rtol=0, atol=0)
    assert dispatch.launches[K.K5_NAME] == dispatch.launches[K.K6_NAME] == 0
