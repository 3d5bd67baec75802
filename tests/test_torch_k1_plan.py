"""K1's launch plan (``ops/cuda/kernels.py::k1_launch_plan``) on the CPU.

The GEMMs of ``csrc/normal_bf16.cu`` run only on the card; what their
launches cover, and what they ask of the card, is Python that the CPU
reaches. Two routes: the TMA → wgmma GEMM of ``csrc/wgmma_gemm.cuh``
wherever TMA can describe the operands, else the cp.async ring of
``csrc/tile_gemm.cuh``. For the ring, at the main-path shape and at the
card tests' ragged shapes: both grids cover every output element exactly
once, the dynamic shared memory fits a block, every grid dimension fits,
and pass 1 at the main shape gives each of the H100's 132 SMs about one
block. For the wgmma route, at the cells' shapes and ragged ones: each
pass covers every output once and pass 1's split ranges tile the depth
once, the split partials fit Q's storage, shared memory fits a block, each
pass fills the SMs at both cell shapes, and the route follows the shape's
and the pointer's alignment. Each plan's constants are the ones its
header states, and every kernel K1 launches carries a name the benchmark's
readers match.
"""

import re
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

from sparse_solvers_tpu_torch.ops.cuda import kernels as K

MAIN = (256, 4096, 8192)
# (b, m, n): the main path, then the card tests' K1 shapes
SHAPES = [MAIN, (5, 72, 200), (8, 96, 256), (1, 64, 130), (70, 1, 8),
          (65, 130, 67), (256, 512, 1024), (130, 96, 256), (130, 72, 200),
          (9, 40, 72)]
MAX_SMEM_BYTES = 232448  # a block's dynamic shared memory on the H100
CSRC = Path(__file__).resolve().parents[1] / "sparse_solvers_tpu_torch" / "csrc"
HEADER = CSRC / "tile_gemm.cuh"
WG_HEADER = CSRC / "wgmma_gemm.cuh"
# the cells' two shapes of K1: the headline's and the gram-free drivers'
GRAM_FREE = (256, 2048, 65536)


def _cover(grid, tile, rows, cols):
    """How many blocks of `grid` write each element of a (rows, cols)
    output, with blockIdx.x over rows in tiles of tile[0] and blockIdx.y
    over columns in tiles of tile[1], edges masked."""
    hits = np.zeros((rows, cols), np.int32)
    for bx in range(grid[0]):
        for by in range(grid[1]):
            hits[bx * tile[0]:(bx + 1) * tile[0],
                 by * tile[1]:(by + 1) * tile[1]] += 1
    return hits


@pytest.mark.parametrize("b,m,n", SHAPES)
def test_plan_grids_cover_every_output_once(b, m, n):
    plan = K.k1_launch_plan(b, m, n, aligned=False)
    assert plan.route == "ring" and plan.tile2 == plan.tile
    bm, bn, _ = plan.tile
    assert (_cover(plan.grid1, (bm, bn), b, m) == 1).all()   # P (b, m)
    assert (_cover(plan.grid2, (bm, bn), b, n) == 1).all()   # Q (b, n)
    # no block lies wholly past the edge
    assert (plan.grid1[0] - 1) * bm < b and (plan.grid1[1] - 1) * bn < m
    assert (plan.grid2[1] - 1) * bn < n
    assert plan.d16_shape == (b, n) and plan.p_shape == (b, m)


@pytest.mark.parametrize("b,m,n", SHAPES)
def test_plan_fits_the_card(b, m, n):
    plan = K.k1_launch_plan(b, m, n, aligned=False)
    assert plan.smem_bytes <= MAX_SMEM_BYTES
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    for grid in (plan.grid1, plan.grid2):
        assert grid[0] < 2**31 and grid[1] <= K.MAX_GRID_Y


def test_main_shape_fills_the_sms():
    plan = K.k1_launch_plan(*MAIN, aligned=False)
    assert plan.tile == (128, 64, 32) and plan.stages == 4
    assert plan.grid1 == (2, 64) and plan.grid2 == (2, 128)
    assert plan.grid1[0] * plan.grid1[1] >= 128
    # four stages of a 128x40 and a 64x40 bf16 slice
    assert plan.smem_bytes == 4 * 2 * (128 * 40 + 64 * 40) == 61440


@pytest.mark.parametrize("b,m,n", [(4, 64 * 65535 + 1, 8),
                                   (4, 8, 64 * 65535 + 1),
                                   (2**31, 8, 8)])
def test_plan_refuses_what_passes_the_grid(b, m, n):
    with pytest.raises(ValueError, match="exceeds the kernel's grid"):
        K.k1_launch_plan(b, m, n, aligned=False)


def test_plan_takes_the_largest_grid():
    plan = K.k1_launch_plan(4, 64 * 65535, 64 * 65535, aligned=False)
    assert plan.grid1[1] == plan.grid2[1] == K.MAX_GRID_Y


def _ring_constants():
    text = HEADER.read_text()
    body = text[text.index("namespace ring {"):text.index(
        "}  // namespace ring")]
    return {name: int(val) for name, val in re.findall(
        r"constexpr int (\w+) = (\d+);", body)}


def test_plan_states_the_header_constants():
    c = _ring_constants()
    assert (c["BM"], c["BN"], c["BK"]) == K.K1_TILE
    assert c["STAGES"] == K.K1_STAGES and c["THREADS"] == K.K1_THREADS
    # the header derives its shared memory from the same tile and pads
    bm, bn, bk = K.K1_TILE
    assert re.search(r"constexpr int LDA = BK \+ 8;", HEADER.read_text())
    ring = K.k1_launch_plan(*MAIN, aligned=False)
    assert ring.smem_bytes == 2 * c["STAGES"] * (
        bm * (bk + 8) + max(bn * (bk + 8), bk * (bn + 8)))


def test_cpu_tensors_take_the_twin():
    """The plan belongs to the CUDA launch: on CPU tensors the wrapper runs
    the twin and counts no launch."""
    from sparse_solvers_tpu_torch.ops import dispatch
    dispatch.reset_launches()
    rng = np.random.RandomState(0)
    A16 = torch.from_numpy(rng.randn(3, 130).astype(np.float32)).bfloat16()
    D = torch.from_numpy(rng.randn(130, 130).astype(np.float32))
    Q = K.normal_matvec_fused_bf16(A16, D)
    torch.testing.assert_close(Q, K.normal_matvec_fused_bf16_plain(A16, D),
                               rtol=0, atol=0)
    assert dispatch.launches[K.NAME] == 0


# the wgmma route: the cells' shapes, the card tests' aligned shapes (ragged
# batches of 1 and 130 lanes, m and n multiples of 8 but not of a tile, a
# second batch tile, splits of 8 and 4 ranges) and the mesh's local rows
WG_SHAPES = [MAIN, GRAM_FREE, (256, 512, 1024), (1, 72, 200), (130, 96, 256),
             (130, 520, 8200), (1, 64, 4096), (300, 136, 1048), (16, 256, 512),
             (256, 2048, 8192), (256, 1024, 65536), (5, 8, 8),
             (1024, 4096, 8192)]


@pytest.mark.parametrize("b,m,n", WG_SHAPES)
def test_wgmma_plan_covers_every_output_once(b, m, n):
    """Each pass's grid covers its output once per split, no block lies
    wholly past an edge, and pass 1's ranges tile the depth [0, n) once,
    none empty."""
    plan = K.k1_launch_plan(b, m, n)
    assert plan.route == "wgmma"
    for grid, (bm, bn, bk), cols in ((plan.grid1, plan.tile, m),
                                     (plan.grid2, plan.tile2, n)):
        assert bk == K.K1_WG_BK and bm in K.K1_WG_BATCH_TILES
        assert bn in K.K1_WG_COL_TILES
        assert (_cover(grid, (bm, bn), b, cols) == 1).all()
        assert (grid[0] - 1) * bm < b and (grid[1] - 1) * bn < cols
    assert plan.tile[0] == plan.tile2[0]
    assert plan.chunk % K.K1_WG_BK == 0
    ranges = [(z * plan.chunk, min(n, (z + 1) * plan.chunk))
              for z in range(plan.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:]))
    assert plan.kernels == 3 + (plan.splits > 1)


@pytest.mark.parametrize("b,m,n", WG_SHAPES + [(8, 8, 4096), (256, 4096, 4096),
                                               (64, 1024, 16384)])
def test_wgmma_split_partials_fit_q(b, m, n):
    """Pass 1's (S, b, m) f32 partials live in Q's (b, n) f32 storage, which
    pass 2 has not yet written: S·m ≤ n, S ≤ MAX_SPLITS, and each range
    holds at least K1_WG_MIN_SPLIT slices."""
    plan = K.k1_launch_plan(b, m, n)
    assert plan.splits * b * m <= b * n
    assert 1 <= plan.splits <= K.MAX_SPLITS
    if plan.splits > 1:
        assert plan.chunk >= K.K1_WG_MIN_SPLIT * K.K1_WG_BK


@pytest.mark.parametrize("b,m,n", WG_SHAPES)
def test_wgmma_plan_fits_the_card(b, m, n):
    plan = K.k1_launch_plan(b, m, n)
    assert plan.smem_bytes <= MAX_SMEM_BYTES
    assert plan.threads == K.K1_WG_THREADS and plan.threads <= 1024
    for grid in (plan.grid1, plan.grid2):
        assert grid[0] < 2**31 and grid[1] <= K.MAX_GRID_Y


@pytest.mark.parametrize("shape,tiles,splits,blocks", [
    # 4096x8192: the 64-wide tile, pass 1 in two ranges (S·m ≤ n allows no
    # more): 128 blocks a pass. 2048x65536: the 128-wide tile, pass 1 in
    # eight ranges of 8192, 128 blocks; pass 2's 512 blocks, 3.9 waves.
    (MAIN, (64, 64), 2, (128, 128)),
    (GRAM_FREE, (128, 128), 8, (128, 512))])
def test_cell_shapes_fill_the_sms(shape, tiles, splits, blocks):
    """At both cell shapes the whole batch is one tile and each pass puts
    a wave on the card: at least 128 blocks, on 128 of the 132 SMs where
    the pass has 128. No plan reaches 132 there: a pass-2 column tile is
    a multiple of 64 (8192 / 64 = 128), and S·m ≤ n holds pass 1 at
    4096x8192 to two ranges; a 133rd block would start a second wave."""
    plan = K.k1_launch_plan(*shape)
    assert plan.route == "wgmma" and plan.tile[0] == plan.tile2[0] == 256
    assert (plan.tile[1], plan.tile2[1]) == tiles and plan.splits == splits
    got = (plan.grid1[0] * plan.grid1[1] * plan.splits,
           plan.grid2[0] * plan.grid2[1])
    assert got == blocks
    assert min(got) >= 0.95 * K.SM_COUNT


@pytest.mark.parametrize("m,n,aligned,route", [
    (4096, 8192, True, "wgmma"), (4096, 8192, False, "ring"),
    (72, 200, True, "wgmma"), (64, 130, True, "ring"),
    (130, 67, True, "ring"), (1, 8, True, "ring"), (68, 200, True, "ring"),
    (72, 204, True, "ring"), (40, 72, False, "ring")])
def test_route_follows_alignment_and_stride(m, n, aligned, route):
    """TMA needs 16-byte bases and row strides: the wgmma route only where
    m and n are multiples of 8 and A16 starts on 16 bytes."""
    plan = K.k1_launch_plan(9, m, n, aligned)
    assert plan.route == route
    if route == "ring":
        assert plan.tile == plan.tile2 == K.K1_TILE and plan.splits == 1
        assert plan.kernels == 3


@pytest.mark.parametrize("b,m,n", [(0, 64, 128), (4, 0, 128), (4, 64, 0)])
def test_empty_shapes_plan_without_a_launch(b, m, n):
    """The wrapper plans before it returns early on an empty shape: the
    plan must not fail there (it never launches)."""
    plan = K.k1_launch_plan(b, m, n)
    assert plan.route == "ring" and plan.d16_shape == (b, n)


def test_wgmma_plan_refuses_what_passes_the_grid():
    with pytest.raises(ValueError, match="exceeds the kernel's grid"):
        K.k1_launch_plan(4, 8, 64 * 65536)
    assert K.k1_launch_plan(4, 8, 64 * 65535).grid2[1] == K.MAX_GRID_Y


def _wg_constants():
    text = WG_HEADER.read_text()
    body = text[text.index("namespace wg {"):text.index("}  // namespace wg")]
    return body, {name: int(val) for name, val in re.findall(
        r"constexpr int (\w+) = (\d+);", body)}


def test_wgmma_plan_states_the_header_constants():
    body, c = _wg_constants()
    assert c["BK"] == K.K1_WG_BK and c["STAGES"] == K.K1_WG_STAGES
    assert 128 * (c["CONSUMERS"] + 1) == K.K1_WG_THREADS
    assert re.search(r"constexpr int THREADS = 128 \* \(CONSUMERS \+ 1\);",
                     body)
    # setmaxnreg's budget: the producer's and consumers' registers fit
    assert 128 * c["PRODUCER_REGS"] + 128 * c["CONSUMERS"] * \
        c["CONSUMER_REGS"] <= 65536
    # the (BM, BN) pairs `launch` instantiates: BM = 64·CONSUMERS·SLABS
    pairs = {(64 * c["CONSUMERS"] * int(s), int(bn)) for s, bn in
             re.findall(r"launch_pass<(\d), (\d+), B_MN>", body)}
    assert pairs == {(bm, bn) for bm in K.K1_WG_BATCH_TILES
                     for bn in K.K1_WG_COL_TILES}
    assert re.search(r"SMEM_BYTES = STAGES \* STAGE_BYTES \+ 1024;", body)
    for bm in K.K1_WG_BATCH_TILES:
        for bn in K.K1_WG_COL_TILES:
            assert K._wg_smem(bm, bn) == \
                c["STAGES"] * (bm * c["BK"] * 2 + bn * c["BK"] * 2) + 1024
            assert K._wg_smem(bm, bn) <= MAX_SMEM_BYTES


def test_every_k1_kernel_carries_a_name_the_readers_match():
    """perfbench/metrics/k1_roofline.py finds K1's device time by the
    substrings below: every kernel the wgmma route launches keeps one."""
    keys = ("round_to_bf16_kernel", "gemm_bf16_async_kernel")
    kernels = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+"
                         r"(\w+)\(", WG_HEADER.read_text())
    assert set(kernels) == {"gemm_bf16_async_kernel",
                            "gemm_bf16_async_kernel_split_sum"}
    assert all(any(k in name for k in keys) for name in kernels)
    entry = (CSRC / "normal_bf16.cu").read_text()
    assert "round_to_bf16(" in entry and "wg::split_sum(" in entry


def test_wrapper_counts_the_ring_route():
    """``dispatch.reset_launches`` clears K1's ring count beside its
    launches; CPU tensors run the twin and count neither (the card tests
    hold the count to the route)."""
    from sparse_solvers_tpu_torch.ops import dispatch
    dispatch.fallbacks[K.NAME] = 5
    dispatch.reset_launches()
    assert dispatch.fallbacks[K.NAME] == 0
    A16 = torch.ones(8, 16, dtype=torch.bfloat16)
    K.normal_matvec_fused_bf16(A16, torch.ones(3, 16))
    assert dispatch.fallbacks[K.NAME] == 0 and dispatch.launches[K.NAME] == 0
