"""K1, K5 and K6 — the fused correlation products of
``sparse_solvers_tpu/ops/pallas/kernels.py``.

K1 is the bf16 normal-equation product q = AᵀA·d of every driver
iteration.

Port of ``sparse_solvers_tpu/ops/pallas/kernels.py::normal_matvec_fused_bf16``
(the Pallas kernel at :160-241). The CUDA form is ``csrc/normal_bf16.cu``:
D rounded to bf16 into a (b, n) scratch, then two bf16 tensor-core GEMM
passes, P = bf16(D16·A16ᵀ) into a (b, m) bf16 scratch, then Q = P·A16 in
f32 (the file's header says why the TPU kernel's one-pass, output-resident
decomposition does not carry over, and what bounds the kernel on the
H100). ``k1_launch_plan`` picks the route and its geometry, which the C
entry takes as they are: the warp-specialised TMA → wgmma GEMM of
``csrc/wgmma_gemm.cuh`` wherever TMA can describe the operands, else the
cp.async ring of ``csrc/tile_gemm.cuh``, counted in
``dispatch.fallbacks``.

``normal_matvec_fused_bf16_plain`` is its twin: the same roundings in
plain PyTorch, fp32 products with TF32 off. A bare bf16 ``torch.matmul``
would round Q to bf16 as well, so the twin multiplies the bf16 values as
fp32 tensors.

K5 ``normal_matvec_fused`` (Q = (D·Aᵀ)·A) and K6
``residual_correlation_fused`` (C = (Y − X·Aᵀ)·A) are the f32 forms, the
Pallas kernels at :136 and :267; their CUDA form is ``csrc/fused_corr.cu``,
two passes through a (b, m) intermediate, T = D·Aᵀ (Y − X·Aᵀ) then T·A.
Their precision is ``blas.current_precision()`` at call time, as the
Pallas wrappers read it at trace time: "high" and "highest" run the fp32
ring tile GEMM (fp32 FMAs, no TF32); "default" rounds A and D (X) to bf16
scratches and runs K1's bf16 ring, rounding the intermediate to bf16 after
its fp32 sum, as K1 does. ``fused_launch_plan`` picks the batch tile and,
where a pass would not fill the SMs, splits its depth into fixed ranges
whose partial sums a small kernel adds in a fixed order. The JAX wrappers'
VMEM eligibility gate does not carry over: a CUDA tensor launches the hand
kernel for every f32 shape, and any other dtype raises. ``*_plain`` are
their twins.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import torch

from .. import blas, dispatch
from . import build

NAME = "normal_matvec_fused_bf16"
K5_NAME = "normal_matvec_fused"
K6_NAME = "residual_correlation_fused"

# K1's ring tile GEMM (the fallback route); csrc/tile_gemm.cuh's namespace
# ring states the same constants (tests/test_torch_k1_plan.py holds the two
# together)
K1_TILE = (128, 64, 32)   # BM (batch lanes), BN, BK
K1_STAGES = 4
K1_THREADS = 256
MAX_GRID_Y = 65535
SM_COUNT = 132            # the H100's streaming multiprocessors
MAX_SPLITS = 16           # depth ranges a pass splits into at most
# K1's TMA -> wgmma GEMM; csrc/wgmma_gemm.cuh's namespace wg states the
# first three and instantiates each pair of the two tile sets
K1_WG_BK = 64             # a slice: one 128-byte swizzled row of bf16
K1_WG_STAGES = 4
K1_WG_THREADS = 384       # a producer and two consumer warpgroups
K1_WG_BATCH_TILES = (128, 256)   # BM: 64-row slabs, one or two a consumer
K1_WG_COL_TILES = (64, 128)      # BN
K1_WG_MIN_SPLIT = 16      # slices a split range holds at least


@dataclasses.dataclass(frozen=True)
class K1Plan:
    """K1's launches for one (b, m, n): the round of D, then pass 1 P (b,
    m) = D16·A16ᵀ on tiles ``tile`` over grid ``grid1`` (x batch tiles, y
    column tiles) times ``splits`` depth ranges of ``chunk`` (split z covers
    [z·chunk, min(n, (z+1)·chunk)), its f32 partials in Q's storage, then
    summed into P), then pass 2 Q (b, n) = P·A16 on tiles ``tile2`` over
    ``grid2``. ``route``: "wgmma" (``csrc/wgmma_gemm.cuh``) or "ring"
    (``csrc/tile_gemm.cuh``'s ring, one tile, never split).
    ``smem_bytes``: the larger pass's dynamic shared memory."""
    route: str
    tile: tuple[int, int, int]    # pass 1's BM (batch lanes), BN, BK
    stages: int
    threads: int
    grid1: tuple[int, int]    # P (b, m) = D16·A16ᵀ
    grid2: tuple[int, int]    # Q (b, n) = P·A16
    smem_bytes: int
    d16_shape: tuple[int, int]
    p_shape: tuple[int, int]
    tile2: tuple[int, int, int]   # pass 2's
    splits: int = 1
    chunk: int = 0

    @property
    def kernels(self) -> int:
        """Launches a call makes: the round, the passes and, where pass 1
        splits, the sum of its ranges."""
        return 3 + (self.splits > 1)


def _wg_smem(bm: int, bn: int) -> int:
    """wgmma_gemm.cuh's Tile::SMEM_BYTES: the ring of L and R slices and
    1024 bytes to align it for the 128-byte swizzle."""
    return K1_WG_STAGES * (bm + bn) * K1_WG_BK * 2 + 1024


def _wg_pass(tiles_x: int, cols: int, slices: int,
             max_splits: int) -> tuple[int, int, int]:
    """(BN, S, slices per range) for one wgmma pass of ``tiles_x`` batch
    tiles by ``cols`` output columns over a depth of ``slices`` slices: the
    least work for the busiest SM, BN·(slices a range)·⌈blocks / SM_COUNT⌉,
    then the wider tile (fewer reads of the batch tile), then the fewer
    splits; no range is empty."""
    best = None
    for bn in K1_WG_COL_TILES:
        blocks = tiles_x * -(-cols // bn)
        for s in range(1, max_splits + 1):
            per = -(-slices // s)
            if -(-slices // per) != s:
                continue
            key = (bn * per * -(-blocks * s // SM_COUNT), -bn, s)
            if best is None or key < best[0]:
                best = (key, bn, s, per)
    return best[1:]


def k1_launch_plan(b: int, m: int, n: int, aligned: bool = True) -> K1Plan:
    """The launch geometry of K1 at (b, m, n); ``aligned``: A16 starts on
    16 bytes (the wrapper allocates D16, P and Q, which always do).

    The wgmma route wherever TMA can describe the operands, m and n
    multiples of 8 and ``aligned``: a batch tile of 128 lanes, or 256 where
    b > 128 (the whole batch at b = 256, so each A16 tile is read once a
    pass); each pass's column tile and pass 1's splits by ``_wg_pass``,
    which fills the 132 SMs where the tiles allow. Pass 1 splits only where
    the partials fit Q's storage (S·m ≤ n), each range holds at least
    K1_WG_MIN_SPLIT slices, and S ≤ MAX_SPLITS: at b=256 it takes 2 ranges
    at 4096x8192 and 8 at 2048x65536. Elsewhere the cp.async ring (an empty
    shape too, which the wrapper never launches). Raises ValueError where a
    grid or an index would pass the card's limits."""
    if max(b, m, n) >= 2**31:
        raise ValueError(f"shape (b={b}, m={m}, n={n}) exceeds the "
                         "kernel's grid")
    if aligned and m % 8 == 0 and n % 8 == 0 and min(b, m, n) > 0:
        bm = next((t for t in K1_WG_BATCH_TILES if b <= t),
                  K1_WG_BATCH_TILES[-1])
        gx = -(-b // bm)
        slices1 = -(-n // K1_WG_BK)
        cap = max(1, min(MAX_SPLITS, n // m, slices1 // K1_WG_MIN_SPLIT))
        bn1, s1, per1 = _wg_pass(gx, m, slices1, cap)
        bn2, _, _ = _wg_pass(gx, n, -(-m // K1_WG_BK), 1)
        grid1, grid2 = (gx, -(-m // bn1)), (gx, -(-n // bn2))
        if max(grid1[1], grid2[1]) > MAX_GRID_Y:
            raise ValueError(f"shape (b={b}, m={m}, n={n}) exceeds the "
                             "kernel's grid")
        return K1Plan("wgmma", (bm, bn1, K1_WG_BK), K1_WG_STAGES,
                      K1_WG_THREADS, grid1, grid2,
                      max(_wg_smem(bm, bn1), _wg_smem(bm, bn2)), (b, n),
                      (b, m), (bm, bn2, K1_WG_BK), s1, per1 * K1_WG_BK)
    bm, bn, bk = K1_TILE
    stage = 2 * (bm * (bk + 8) + max(bn * (bk + 8), bk * (bn + 8)))
    smem = max(K1_STAGES * stage, 4 * bm * (bn + 4))
    grid1 = (-(-b // bm), -(-m // bn))
    grid2 = (-(-b // bm), -(-n // bn))
    if max(grid1[1], grid2[1]) > MAX_GRID_Y:
        raise ValueError(f"shape (b={b}, m={m}, n={n}) exceeds the "
                         "kernel's grid")
    return K1Plan("ring", K1_TILE, K1_STAGES, K1_THREADS, grid1, grid2, smem,
                  (b, n), (b, m), K1_TILE, 1, n)


# K5's and K6's tiles: csrc/fused_corr.cu's batch tiles, and csrc/
# tile_gemm.cuh's namespace f32ring ("highest"/"high"; "default" runs K1's
# ring at these batch tiles) state the same constants
# (tests/test_torch_fused_plan.py holds them together)
FUSED_BATCH_TILES = (16, 64, 128)
F32_TILE = (128, 32)      # BN, BK
F32_STAGES = 3
F32_THREAD_TILE = {16: (2, 8), 64: (8, 8), 128: (8, 8)}  # (TM, TN) by tile
RING_TILE_N = {16: 64, 64: 64, 128: 128}   # the bf16 ring's BN by tile
RING_BK, RING_STAGES = 64, 3               # and its slices (K1: 32 and 4)


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """K5's or K6's launches for one (b, m, n, precision): pass 1 T (b, m)
    = V·Aᵀ (Y − V·Aᵀ), pass 2 Out (b, n) = T·A, each over ``splits`` depth
    ranges of ``chunks`` elements (split z covers [z·c, min(K, (z+1)·c))),
    grids (x batch tiles, y column tiles, z splits). ``scratch`` maps the
    C entry's scratch arguments, in its order, to (shape, dtype), or None
    where the plan does not use one."""
    ring: str                  # "f32" (fp32 FMAs) or "bf16" (K1's ring)
    tile: tuple[int, int, int]  # BM (batch lanes), BN, BK
    thread_tile: tuple[int, int] | None  # (TM, TN) of the fp32 ring
    stages: int
    threads: int
    splits: tuple[int, int]
    chunks: tuple[int, int]
    grid1: tuple[int, int, int]
    grid2: tuple[int, int, int]
    smem_bytes: int
    scratch: dict


def _splits(tiles: int, slices: int) -> tuple[int, int]:
    """(S, slices per split) for a pass of ``tiles`` output tiles over a
    depth of ``slices`` slices. One split where the tiles fill the SMs;
    else, of S ≤ MAX_SPLITS, those whose blocks reach SM_COUNT (all S when
    none does), the S that spreads the blocks most evenly over the SMs in
    waves (least ⌈tiles·S / SM_COUNT⌉ / S, then fewest splits), trimmed so
    that no range is empty."""
    if tiles >= SM_COUNT or slices <= 1:
        return 1, max(slices, 1)
    cands = range(1, min(MAX_SPLITS, slices) + 1)
    fill = [s for s in cands if tiles * s >= SM_COUNT] or list(cands)
    s = min(fill, key=lambda s: (Fraction(-(-tiles * s // SM_COUNT), s), s))
    per = -(-slices // s)
    return -(-slices // per), per


def fused_launch_plan(b: int, m: int, n: int, precision: str) -> FusedPlan:
    """The launch geometry of K5 and K6 at (b, m, n) and a precision name;
    raises ValueError where a grid or an index would pass the card's
    limits."""
    bf16 = precision == "default"
    bm = next((t for t in FUSED_BATCH_TILES if b <= t), FUSED_BATCH_TILES[-1])
    if bf16:
        bn, bk = RING_TILE_N[bm], RING_BK
        stages, thread_tile = RING_STAGES, None
        threads = bm // (32 if bm >= 32 else 16) * bn
        smem = max(2 * stages * (bm * (bk + 8)
                                 + max(bn * (bk + 8), bk * (bn + 8))),
                   4 * bm * (bn + 4))
    else:
        bn, bk = F32_TILE
        stages, thread_tile = F32_STAGES, F32_THREAD_TILE[bm]
        threads = (bm // thread_tile[0]) * (bn // thread_tile[1])
        smem = 4 * stages * (bm * (bk + 4) + max(bn * (bk + 4),
                                                  bk * (bn + 4)))
    gx, gm, gn = -(-b // bm), -(-m // bn), -(-n // bn)
    s1, per1 = _splits(gx * gm, -(-n // bk))
    s2, per2 = _splits(gx * gn, -(-m // bk))
    if max(b, m, n) >= 2**31 or max(gm, gn) > MAX_GRID_Y:
        raise ValueError(f"shape (b={b}, m={m}, n={n}) exceeds the "
                         "kernel's grid")
    f32, b16 = torch.float32, torch.bfloat16
    scratch = {
        "a16": ((m, n), b16) if bf16 else None,
        "v16": ((b, n), b16) if bf16 else None,
        "p1": ((s1, b, m), f32) if bf16 or s1 > 1 else None,
        "t": ((b, m), b16 if bf16 else f32),
        "p2": ((s2, b, n), f32) if s2 > 1 else None,
    }
    return FusedPlan("bf16" if bf16 else "f32", (bm, bn, bk), thread_tile,
                     stages, threads, (s1, s2), (per1 * bk, per2 * bk),
                     (gx, gm, s1), (gx, gn, s2), smem, scratch)


def normal_matvec_fused_bf16_plain(A16: torch.Tensor,
                                   D: torch.Tensor) -> torch.Tensor:
    """Q = bf16(bf16(D)·A16ᵀ)·A16 in f32: the kernel's twin."""
    A = A16.float()
    with blas.precision_scope("highest"):
        P = (D.to(torch.bfloat16).float() @ A.T).to(torch.bfloat16).float()
        return P @ A


def normal_matvec_fused_bf16(A16: torch.Tensor,
                             D: torch.Tensor) -> torch.Tensor:
    """Q (b, n) f32 = bf16(bf16(D)·A16ᵀ)·A16 for A16 (m, n) bf16 and
    D (b, n) f32. CUDA tensors launch the hand kernel; CPU tensors run
    the twin."""
    if not dispatch.use_cuda_kernel(A16, D):
        return normal_matvec_fused_bf16_plain(A16, D)
    if A16.dtype != torch.bfloat16 or A16.dim() != 2:
        raise ValueError(f"A16 must be a 2-d bfloat16 tensor, got "
                         f"{A16.dtype} of shape {tuple(A16.shape)}")
    if D.dtype != torch.float32 or D.dim() != 2 or D.shape[1] != A16.shape[1]:
        raise ValueError(f"D must be a (b, {A16.shape[1]}) float32 tensor, "
                         f"got {D.dtype} of shape {tuple(D.shape)}")
    if not (A16.is_contiguous() and D.is_contiguous()):
        raise ValueError("A16 and D must be contiguous")
    (b, n), m = D.shape, A16.shape[0]
    plan = k1_launch_plan(b, m, n, A16.data_ptr() % 16 == 0)
    Q = torch.empty((b, n), dtype=torch.float32, device=D.device)
    if b == 0 or n == 0:
        return Q
    if m == 0:
        return Q.zero_()
    D16 = torch.empty(plan.d16_shape, dtype=torch.bfloat16, device=D.device)
    P = torch.empty(plan.p_shape, dtype=torch.bfloat16, device=D.device)
    lib = build.library()
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream(D.device).cuda_stream
        rc = lib.ss_normal_matvec_bf16(
            D.data_ptr(), A16.data_ptr(), D16.data_ptr(), P.data_ptr(),
            Q.data_ptr(), b, m, n, int(plan.route == "wgmma"),
            plan.tile[0], plan.tile[1], plan.splits, plan.chunk,
            plan.tile2[1], stream)
    build.check(rc, NAME)
    dispatch.launches[NAME] += 1
    if plan.route == "ring":
        dispatch.fallbacks[NAME] += 1
    return Q


def normal_matvec_fused_plain(A: torch.Tensor,
                              D: torch.Tensor) -> torch.Tensor:
    """Q = (D·Aᵀ)·A as two products at the scope's precision — the JAX
    wrapper's two-gemm form, which at "default" rounds A, D and the
    intermediate to bf16: K5's twin."""
    return blas.xgemm(blas.xgemm(D, A, trans_b=True), A)


def residual_correlation_fused_plain(A: torch.Tensor, X: torch.Tensor,
                                     Y: torch.Tensor) -> torch.Tensor:
    """C = (Y − X·Aᵀ)·A as two products at the scope's precision: K6's
    twin."""
    return blas.xgemm(Y - blas.xgemm(X, A, trans_b=True), A)


def _check_fused(A: torch.Tensor, V: torch.Tensor,
                 Y: torch.Tensor | None = None) -> None:
    """Shapes K5 and K6 take on any device: A (m, n), V (b, n), Y (b, m)."""
    if A.dim() != 2:
        raise ValueError(f"A must be 2-d, got shape {tuple(A.shape)}")
    m, n = A.shape
    if V.dim() != 2 or V.shape[1] != n:
        raise ValueError(f"expected a (b, {n}) operand against A of shape "
                         f"{tuple(A.shape)}, got {tuple(V.shape)}")
    if Y is not None and tuple(Y.shape) != (V.shape[0], m):
        raise ValueError(f"Y must have shape {(V.shape[0], m)}, got "
                         f"{tuple(Y.shape)}")


def _launch_fused(name: str, entry: str, A: torch.Tensor, V: torch.Tensor,
                  Y: torch.Tensor | None) -> torch.Tensor:
    """Check the f32 operands of K5 (Y None) or K6, allocate the plan's
    scratches and launch the kernel at the scope's precision."""
    ops = (A, V) if Y is None else (A, V, Y)
    for t in ops:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} takes float32 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
    (b, n), m = V.shape, A.shape[0]
    plan = fused_launch_plan(b, m, n, blas.current_precision())
    out = torch.empty((b, n), dtype=torch.float32, device=V.device)
    if b == 0 or n == 0:
        return out
    if m == 0:
        return out.zero_()
    scratch = [None if spec is None else
               torch.empty(spec[0], dtype=spec[1], device=V.device)
               for spec in plan.scratch.values()]
    lib = build.library()
    with torch.cuda.device(V.device):
        stream = torch.cuda.current_stream(V.device).cuda_stream
        ptrs = [t.data_ptr() for t in ((V,) if Y is None else (V, Y))]
        rc = getattr(lib, entry)(
            *ptrs, A.data_ptr(),
            *(None if t is None else t.data_ptr() for t in scratch),
            out.data_ptr(), b, m, n, int(plan.ring == "bf16"), plan.tile[0],
            plan.splits[0], plan.chunks[0], plan.splits[1], plan.chunks[1],
            stream)
    build.check(rc, name)
    dispatch.launches[name] += 1
    return out


def normal_matvec_fused(A: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """K5: Q (b, n) = (D·Aᵀ)·A for A (m, n) and D (b, n) f32, at the
    scope's precision. CUDA tensors launch the hand kernel; CPU tensors
    run the twin."""
    _check_fused(A, D)
    if not dispatch.use_cuda_kernel(A, D):
        return normal_matvec_fused_plain(A, D)
    return _launch_fused(K5_NAME, "ss_normal_matvec_f32", A, D, None)


def residual_correlation_fused(A: torch.Tensor, X: torch.Tensor,
                               Y: torch.Tensor) -> torch.Tensor:
    """K6: C (b, n) = (Y − X·Aᵀ)·A for A (m, n), X (b, n) and Y (b, m)
    f32, at the scope's precision. CUDA tensors launch the hand kernel;
    CPU tensors run the twin."""
    _check_fused(A, X, Y)
    if not dispatch.use_cuda_kernel(A, X, Y):
        return residual_correlation_fused_plain(A, X, Y)
    return _launch_fused(K6_NAME, "ss_residual_correlation_f32", A, X, Y)
