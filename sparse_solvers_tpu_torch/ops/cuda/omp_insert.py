"""K4 — the fused OMP insert + least-squares re-solve of one greedy pick.

Port of ``sparse_solvers_tpu/ops/pallas/omp_insert.py::omp_insert`` (the
Pallas kernel at :36-76 and :108; the math is written out in ``csrc/
omp_insert.cu``'s header). The CUDA form runs one block per lane, keeps
the (K, K) inverse in device memory and updates it in place, as the
Pallas call aliases it (:124), with only K-vectors in shared memory, so
it serves any capacity.

``omp_insert_plain`` is its twin: the Pallas body as batched torch ops,
every lane gated by ``torch.where`` selects (never a 0·x multiply).
"""

from __future__ import annotations

import torch

from .. import dispatch
from . import build

NAME = "omp_insert"
_TINY = 256 * 1.1754944e-38   # 256·FLT_MIN: the engines' shared guard


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
    complement and kept their inverse (the caller breaks them). CUDA
    tensors launch the hand kernel; CPU tensors run the twin and copy its
    inverse back."""
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
    lib = build.library()
    with torch.cuda.device(inv.device):
        stream = torch.cuda.current_stream(inv.device).cuda_stream
        rc = lib.ss_omp_insert(*(t.data_ptr() for t in args),
                               coef.data_ptr(), deg.data_ptr(), b, K, stream)
    build.check(rc, NAME)
    dispatch.launches[NAME] += 1
    return coef, deg
