"""K2 — the fused γ-candidate scan, the homotopy step-size search.

Port of ``sparse_solvers_tpu/ops/pallas/scan.py::find_max_gamma_fused``
(the Pallas kernel at :45-152). The CUDA form is ``csrc/scan.cu``: each
lane's n positions split into S chunks, one CTA each, the S CTAs of a lane
joined as a thread-block cluster; a lexicographic (value, int32 position)
reduction over the inactive candidates (float4 loads where the shapes and
bases allow) and the K active-slot candidates, folded across the cluster
through distributed shared memory. ``scan_launch_plan`` gives the launch
geometry the C entry takes as it is. CUDA C++ rather than Triton:
Triton's ``argmin`` gives no leftmost merge across blocks for free, and one
nvcc route keeps the build to a single library.

``find_max_gamma_fused_plain`` is its twin: the (b, n) inactive candidate
row, one more column for the sentinel position, the active candidates
scattered in at their positions, and the first position of the row
minimum. A lane with no valid candidate returns (FLT_MAX, 0) both ways.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import dispatch
from . import build

NAME = "find_max_gamma_fused"
_BIG = torch.finfo(torch.float32).max

# csrc/scan.cu states the first three (tests/test_torch_k2_k4_plan.py
# holds them together)
SCAN_MAX_THREADS = 256
SCAN_MAX_SPLITS = 8       # the portable cluster size
SCAN_UNROLL = 2           # float4 pairs a thread has in flight
SCAN_MIN_CHUNK = 512      # positions a split CTA gets at the least
SM_COUNT = 132            # the H100's streaming multiprocessors


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """K2's launch for one (b, n): ``splits`` CTAs per lane, a cluster of
    them, CTA r scanning positions [r·chunk, min(n, (r+1)·chunk)) with
    ``threads`` threads, ``vec`` positions a load (4: float4 of q and c,
    one 32-bit word of the mask; 1: scalar)."""
    threads: int
    splits: int
    chunk: int
    vec: int
    grid: int

    def chunks(self, n: int) -> list[tuple[int, int]]:
        return [(r * self.chunk, min(n, (r + 1) * self.chunk))
                for r in range(self.splits)]


def scan_launch_plan(b: int, n: int, aligned: bool = True) -> ScanPlan:
    """The launch of K2 at (b, n). ``aligned``: q and c start on 16 bytes
    and the mask on 4, so float4 loads serve when n % 4 == 0. S is the
    least power of two (a cluster shape) whose b·S CTAs fill the SMs
    twice, at most 8, and at most what gives every chunk SCAN_MIN_CHUNK
    positions; chunks are multiples of 4 and none is empty. Raises
    ValueError where the grid or a position would pass the card's
    limits."""
    if b * SCAN_MAX_SPLITS >= 2**31 or n >= 2**31 - 4 * SCAN_MAX_THREADS:
        raise ValueError(f"shape (b={b}, n={n}) exceeds the kernel's grid")
    vec = 4 if aligned and n % 4 == 0 else 1
    splits = 1
    while (splits < SCAN_MAX_SPLITS and b * splits < 2 * SM_COUNT
           and 2 * splits * SCAN_MIN_CHUNK <= n):
        splits *= 2
    chunk = -(-(-(-n // splits)) // 4) * 4
    per_thread = -(-chunk // (vec * SCAN_UNROLL))
    threads = min(SCAN_MAX_THREADS, max(32, -(-per_thread // 32) * 32))
    return ScanPlan(threads, splits, chunk, vec, b * splits)


def find_max_gamma_fused_plain(q, c, mask, c_inf, x_act, d_act, indices):
    """(gamma (b,), idx (b,) int32): the kernel's twin."""
    b, n = q.shape
    big = torch.tensor(_BIG, dtype=q.dtype, device=q.device)
    dl = 1.0 - q
    dr = 1.0 + q
    tl = (c_inf[:, None] - c) / dl
    tr = (c_inf[:, None] + c) / dr
    cl = torch.where((dl != 0) & (tl > 0) & (tl < _BIG), tl, big)
    cr = torch.where((dr != 0) & (tr > 0) & (tr < _BIG), tr, big)
    cand = torch.where(mask > 0, big, torch.minimum(cl, cr))
    cand = torch.cat([cand, big.expand(b, 1)], dim=1)   # column n: sentinel
    ta = -x_act / d_act                                 # padding: 0/0 = NaN
    ca = torch.where((ta > 0) & (ta < _BIG), ta, big)
    cand.scatter_reduce_(1, indices.long(), ca, reduce="amin")
    return cand.amin(dim=1), torch.argmin(cand, dim=1).to(torch.int32)


def find_max_gamma_fused(q, c, mask, c_inf, x_act, d_act, indices):
    """Batched γ scan. q, c (b, n) f32; mask (b, n) int8 (1 = active);
    c_inf (b,) f32; x_act, d_act (b, K) f32; indices (b, K) int32 with
    sentinel n for empty slots. Returns (gamma (b,) f32, idx (b,) int32).
    CUDA tensors launch the hand kernel; CPU tensors run the twin."""
    args = (q, c, mask, c_inf, x_act, d_act, indices)
    if not dispatch.use_cuda_kernel(*args):
        return find_max_gamma_fused_plain(*args)
    b, n = q.shape
    K = x_act.shape[1] if x_act.dim() == 2 else -1
    f32 = torch.float32
    build.check_operands(
        "q c mask c_inf x_act d_act indices", args,
        [((b, n), f32), ((b, n), f32), ((b, n), torch.int8), ((b,), f32),
         ((b, K), f32), ((b, K), f32), ((b, K), torch.int32)])
    gamma = torch.empty(b, dtype=torch.float32, device=q.device)
    idx = torch.empty(b, dtype=torch.int32, device=q.device)
    if b == 0:
        return gamma, idx
    # a contiguous tensor may start at any element: float4 loads need the
    # bases themselves aligned
    aligned = (q.data_ptr() % 16 == 0 and c.data_ptr() % 16 == 0
               and mask.data_ptr() % 4 == 0)
    plan = scan_launch_plan(b, n, aligned)
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.ss_find_max_gamma(*(t.data_ptr() for t in args),
                                   gamma.data_ptr(), idx.data_ptr(),
                                   b, n, K, plan.threads, plan.splits,
                                   plan.chunk, plan.vec, stream)
    build.check(rc, NAME)
    dispatch.launches[NAME] += 1
    return gamma, idx
