"""K4 — the fused OMP insert + least-squares re-solve of one greedy pick.

Port of ``sparse_solvers_tpu/ops/pallas/omp_insert.py::omp_insert`` (the
Pallas kernel at :36-76 and :108; the math is written out in ``csrc/
omp_insert.cu``'s header). The CUDA form works on each lane's live block
only (slots below kk, and slot kk for an insert), one block a lane and a
warp to a row, staged once in shared memory, and updates the inverse in
place, as the Pallas call aliases it (:124); past the shared-memory cap
its other instantiation works on the inverse in device memory.
``k4_launch_plan`` picks the instantiation from the capacity K and the
row loads from K and the alignment of inv.

``omp_insert_plain`` is its twin: the Pallas body as batched torch ops,
every lane gated by ``torch.where`` selects (never a 0·x multiply).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import dispatch
from . import build

NAME = "omp_insert"
_TINY = 256 * 1.1754944e-38   # 256·FLT_MIN: the engines' shared guard

# csrc/omp_insert.cu states the first two (tests/test_torch_k2_k4_plan.py
# holds them together)
K4_MAX_THREADS = 512
K4_RED_FLOATS = 16            # den's per-warp sums
K4_ROWS_PER_WARP = 4          # rows of the capacity a warp walks
SMEM_OPTIN = 232448           # 227 KB: a Hopper block's shared-memory cap


@dataclasses.dataclass(frozen=True)
class K4Plan:
    """K4's launch for one (b, K): b blocks of ``threads`` threads, one a
    lane, each warp taking whole rows of its live block, ``vec`` columns a
    load (4: float4; 1: one). ``shared``: the block is staged in
    ``smem_bytes`` of shared memory; else the kernel works on it in device
    memory."""
    threads: int
    shared: bool
    vec: int
    smem_bytes: int


def k4_launch_plan(b: int, K: int, aligned: bool = True) -> K4Plan:
    """The launch of K4 at (b, K). A warp for every K4_ROWS_PER_WARP rows
    of the capacity, up to K4_MAX_THREADS threads (at least two warps): a
    warp's chain of rows sets the time. ``aligned``: inv starts on 16
    bytes, so float4 rows serve when K % 4 == 0. The inverse is staged in
    shared memory wherever its K rows and the lane's vectors fit
    SMEM_OPTIN. Raises ValueError where even the vectors do not fit (K
    above about 19,000)."""
    kv = -(-K // 4) * 4
    vectors = 4 * (3 * kv + K4_RED_FLOATS)
    shared = 4 * K * K + vectors <= SMEM_OPTIN
    smem = (4 * K * K if shared else 0) + vectors
    if K <= 0 or smem > SMEM_OPTIN:
        raise ValueError(f"capacity K={K} exceeds the kernel's range")
    vec = 4 if aligned and K % 4 == 0 else 1
    threads = min(K4_MAX_THREADS, 32 * max(2, -(-K // K4_ROWS_PER_WARP)))
    return K4Plan(threads, shared, vec, smem)


def omp_insert_plain(inv, u1, kk, vtv, b_act, doins):
    """The kernel's twin, out of place. Returns (inv′, coef, deg)."""
    K = u1.shape[1]
    slots = torch.arange(K, device=u1.device)[None, :]
    zero = torch.zeros((), dtype=inv.dtype, device=inv.device)

    def mv(M, v):           # per-lane matvec (b,K,K)@(b,K) -> (b,K)
        return (M * v[:, None, :]).sum(dim=2)

    ek = (slots == kk[:, None]).to(inv.dtype)
    u2 = mv(inv, u1)
    den = vtv - (u1 * u2).sum(dim=1)
    okins = den.abs() > _TINY
    gate = doins & okins
    di = 1.0 / torch.where(okins, den, torch.ones_like(den))
    sv = torch.where(gate[:, None], u2 - ek, zero)
    giv = torch.where(gate, di, zero)
    inv1 = inv + (giv[:, None] * sv)[:, :, None] * sv[:, None, :]
    return inv1, mv(inv1, b_act), doins & ~okins


def omp_insert(inv, u1, kk, vtv, b_act, doins):
    """Apply one batched OMP insert + LS re-solve IN PLACE on inv (b,K,K)
    f32. u1 (b,K) f32 — (AᵀA)[Γ, idx] over the slots (sentinel slots
    zero); kk (b,) int32, the insert slot; vtv (b,) f32; b_act (b,K) f32 —
    A_Γᵀy with the new entry already at slot kk; doins (b,) bool. Returns
    (coef (b,K) f32, deg (b,) bool): ``deg`` lanes had a noise-level Schur
    complement and kept their inverse (the caller breaks them). The CUDA
    kernel reads only each lane's live block: rows and columns of inv at
    slots ≥ kk must be zero, as the drivers keep them. CUDA tensors launch
    the hand kernel; CPU tensors run the twin and copy its inverse back."""
    args = (inv, u1, kk, vtv, b_act, doins)
    if not dispatch.use_cuda_kernel(*args):
        inv1, coef, deg = omp_insert_plain(*args)
        inv.copy_(inv1)
        return coef, deg
    b, K = u1.shape
    f32 = torch.float32
    build.check_operands(
        "inv u1 kk vtv b_act doins", args,
        [((b, K, K), f32), ((b, K), f32), ((b,), torch.int32), ((b,), f32),
         ((b, K), f32), ((b,), torch.bool)])
    coef = torch.empty((b, K), dtype=f32, device=inv.device)
    deg = torch.empty(b, dtype=torch.bool, device=inv.device)
    if b == 0 or K == 0:
        return coef.zero_(), deg.zero_()
    plan = k4_launch_plan(b, K, inv.data_ptr() % 16 == 0)
    lib = build.library()
    with torch.cuda.device(inv.device):
        stream = torch.cuda.current_stream(inv.device).cuda_stream
        rc = lib.ss_omp_insert(*(t.data_ptr() for t in args),
                               coef.data_ptr(), deg.data_ptr(), b, K,
                               plan.threads, int(plan.shared), plan.vec,
                               plan.smem_bytes, stream)
    build.check(rc, NAME)
    dispatch.launches[NAME] += 1
    return coef, deg
