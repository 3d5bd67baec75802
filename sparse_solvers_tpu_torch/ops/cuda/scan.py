"""K2 — the fused γ-candidate scan, the homotopy step-size search.

Port of ``sparse_solvers_tpu/ops/pallas/scan.py::find_max_gamma_fused``
(the Pallas kernel at :45-152). The CUDA form is ``csrc/scan.cu``: one
block per lane, a lexicographic (value, int32 position) reduction over
the inactive candidates and the K active-slot candidates. CUDA C++ rather
than Triton: Triton's ``argmin`` gives no leftmost merge across blocks
for free, and one nvcc route keeps the build to a single library.

``find_max_gamma_fused_plain`` is its twin: the (b, n) inactive candidate
row, one more column for the sentinel position, the active candidates
scattered in at their positions, and the first position of the row
minimum. A lane with no valid candidate returns (FLT_MAX, 0) both ways.
"""

from __future__ import annotations

import torch

from .. import dispatch
from . import build

NAME = "find_max_gamma_fused"
_BIG = torch.finfo(torch.float32).max


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
    expect = {"q": ((b, n), torch.float32), "c": ((b, n), torch.float32),
              "mask": ((b, n), torch.int8), "c_inf": ((b,), torch.float32),
              "x_act": ((b, K), torch.float32),
              "d_act": ((b, K), torch.float32),
              "indices": ((b, K), torch.int32)}
    for (name, (shape, dtype)), t in zip(expect.items(), args):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got "
                             f"{t.dtype} of shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    gamma = torch.empty(b, dtype=torch.float32, device=q.device)
    idx = torch.empty(b, dtype=torch.int32, device=q.device)
    if b == 0:
        return gamma, idx
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.ss_find_max_gamma(*(t.data_ptr() for t in args),
                                   gamma.data_ptr(), idx.data_ptr(),
                                   b, n, K, stream)
    build.check(rc, NAME)
    dispatch.launches[NAME] += 1
    return gamma, idx
