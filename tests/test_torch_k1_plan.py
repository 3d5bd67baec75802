"""K1's launch plan (``ops/cuda/kernels.py::k1_launch_plan``) on the CPU.

The ring tile GEMM of ``csrc/normal_bf16.cu`` runs only on the card; what
its launches cover, and what they ask of the card, is Python that the CPU
reaches. At the main-path shape and at the card tests' ragged shapes:
both grids cover every output element exactly once, the dynamic shared
memory fits a block, every grid dimension fits, and pass 1 at the main
shape gives each of the H100's 132 SMs about one block. The plan's
constants are the ones ``csrc/tile_gemm.cuh`` states.
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
HEADER = (Path(__file__).resolve().parents[1] / "sparse_solvers_tpu_torch"
          / "csrc" / "tile_gemm.cuh")


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
    plan = K.k1_launch_plan(b, m, n)
    bm, bn, _ = plan.tile
    assert (_cover(plan.grid1, (bm, bn), b, m) == 1).all()   # P (b, m)
    assert (_cover(plan.grid2, (bm, bn), b, n) == 1).all()   # Q (b, n)
    # no block lies wholly past the edge
    assert (plan.grid1[0] - 1) * bm < b and (plan.grid1[1] - 1) * bn < m
    assert (plan.grid2[1] - 1) * bn < n
    assert plan.d16_shape == (b, n) and plan.p_shape == (b, m)


@pytest.mark.parametrize("b,m,n", SHAPES)
def test_plan_fits_the_card(b, m, n):
    plan = K.k1_launch_plan(b, m, n)
    assert plan.smem_bytes <= MAX_SMEM_BYTES
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    for grid in (plan.grid1, plan.grid2):
        assert grid[0] < 2**31 and grid[1] <= K.MAX_GRID_Y


def test_main_shape_fills_the_sms():
    plan = K.k1_launch_plan(*MAIN)
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
        K.k1_launch_plan(b, m, n)


def test_plan_takes_the_largest_grid():
    plan = K.k1_launch_plan(4, 64 * 65535, 64 * 65535)
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
    assert K.k1_launch_plan(*MAIN).smem_bytes == 2 * c["STAGES"] * (
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
