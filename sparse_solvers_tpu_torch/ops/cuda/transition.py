"""K3 — the fused active-set transition of a homotopy iteration.

Port of ``sparse_solvers_tpu/ops/pallas/transition.py::transition`` (the
Pallas kernel at :64-295; the math is written out in ``csrc/
transition.cu``'s header). The CUDA form runs one block per lane with the
lane's inverse and active Gram in shared memory, branches per lane, and
updates inv, gk, x_act, d_act, c_act and indices in place, as the Pallas
call aliases them (:279).

``transition_plain`` is its twin: the Pallas body as batched torch ops,
every lane gated by ``torch.where`` selects (never a 0·x multiply), and
the slot indices kept as integers.
"""

from __future__ import annotations

import torch

from .. import dispatch
from . import build

NAME = "transition"
_TINY = 256 * 1.1754944e-38   # 256·FLT_MIN: the engines' shared guard
_SMEM_OPTIN = 232448          # 227 KB: a Hopper block's shared-memory cap


def transition_plain(inv, gk, x_act, d_act, c_act, indices, u1, idx, kk,
                     gamma, vtv, cnew, live, doins, dorm, tol: float,
                     sentinel: int):
    """The kernel's twin, out of place. Returns (inv′, gk′, x_act′,
    d_act′, c_act′, indices′, deg)."""
    b, K = x_act.shape
    slots = torch.arange(K, device=x_act.device)[None, :]
    zero = torch.zeros((), dtype=inv.dtype, device=inv.device)

    def mv(M, v):           # per-lane matvec (b,K,K)@(b,K) -> (b,K)
        return (M * v[:, None, :]).sum(dim=2)

    # degenerate-insert guard (transition.py:102-126)
    u2 = mv(inv, u1)
    den = vtv - (u1 * u2).sum(dim=1)
    okins = den.abs() > _TINY
    deg = doins & ~okins
    lv = live & ~deg
    ins = doins & okins
    lv1, ins1 = lv[:, None], ins[:, None]

    x1 = torch.where(lv1, x_act + gamma[:, None] * d_act, x_act)
    ca1 = torch.where(lv1, c_act - gamma[:, None] * mv(gk, d_act), c_act)

    # insert: bordering at slot k as rank-1 adds (transition.py:135-165)
    ek = (slots == kk[:, None]).to(inv.dtype)
    di = 1.0 / torch.where(okins, den, torch.ones_like(den))
    sv = torch.where(ins1, u2 - ek, zero)
    giv = torch.where(ins, di, zero)
    u1g = torch.where(ins1, u1, zero)
    vtvg = torch.where(ins, vtv, zero)
    inv_o = inv + (giv[:, None] * sv)[:, :, None] * sv[:, None, :]
    gk_o = (gk + u1g[:, :, None] * ek[:, None, :]
            + ek[:, :, None] * (u1g + vtvg[:, None] * ek)[:, None, :])
    ca_o = ca1 + torch.where(ins1, cnew[:, None], zero) * ek
    ind_o = torch.where(ins1 & (slots == kk[:, None]),
                        indices + (idx[:, None] - sentinel), indices)
    x_o = x1

    # remove: Schur downdate at p, last live slot moved into p
    # (transition.py:167-207)
    rm1 = dorm[:, None]
    rm3 = dorm[:, None, None]
    at_p = (indices == idx[:, None]) & rm1               # (b,K) slot p
    at_l = slots == (kk - 1)[:, None]                    # (b,K) slot l
    p = torch.argmax(at_p.to(torch.int32), dim=1)
    l = (kk - 1).clamp(min=0).long()
    moved = at_p & ~at_l                                 # p != l
    rp = torch.take_along_dim(inv, p[:, None, None], dim=2)[:, :, 0]
    dpp = torch.take_along_dim(rp, p[:, None], dim=1)
    bd = inv - (rp / dpp)[:, :, None] * rp[:, None, :]

    def move_last_to_p(M):
        """Rows/cols p and l zeroed, then M's column l placed at row and
        column p (diagonal M[l,l]); when p == l the slot is dropped."""
        rl = torch.take_along_dim(M, l[:, None, None], dim=2)[:, :, 0]
        dll = torch.take_along_dim(rl, l[:, None], dim=1)
        ip, jp = moved[:, :, None], moved[:, None, :]
        il, jl = at_l[:, :, None], at_l[:, None, :]
        ipp, jpp = at_p[:, :, None], at_p[:, None, :]
        out = torch.where(ipp | jpp, zero, M)
        out = torch.where(ip & jp, dll[:, :, None], out)
        out = torch.where(ip & ~jp, rl[:, None, :], out)
        out = torch.where(jp & ~ip, rl[:, :, None], out)
        return torch.where(il | jl, zero, out)

    def vswap(v, fill):
        vl = torch.take_along_dim(v, l[:, None], dim=1)
        out = torch.where(moved, vl, v)
        return torch.where(at_l, torch.full_like(v, fill), out)

    inv_o = torch.where(rm3, move_last_to_p(bd), inv_o)
    gk_o = torch.where(rm3, move_last_to_p(gk), gk_o)
    x_o = torch.where(rm1, vswap(x1, 0.0), x_o)
    ca_o = torch.where(rm1, vswap(ca1, 0.0), ca_o)
    ind_o = torch.where(rm1, vswap(indices, sentinel), ind_o)

    # direction from the post-toggle state (transition.py:209-213)
    sgn = torch.where(ca_o > tol, 1.0, torch.where(ca_o < -tol, -1.0, 0.0))
    d_o = torch.where(lv1, mv(inv_o, sgn.to(inv.dtype)), d_act)
    return inv_o, gk_o, x_o, d_o, ca_o, ind_o, deg


def transition(inv, gk, x_act, d_act, c_act, indices, u1, idx, kk, gamma,
               vtv, cnew, live, doins, dorm, tol: float,
               sentinel: int) -> torch.Tensor:
    """Apply one batched homotopy transition IN PLACE on inv, gk (b,K,K)
    f32, x_act, d_act, c_act (b,K) f32 and indices (b,K) int32. u1 (b,K)
    f32; idx, kk (b,) int32; gamma, vtv, cnew (b,) f32; live, doins, dorm
    (b,) bool; tol a float; sentinel = n. Returns ``deg`` (b,) bool: the
    lane's insert had a noise-level Schur complement and its state was
    left untouched (the caller breaks the lane). CUDA tensors launch the
    hand kernel; CPU tensors run the twin and copy its result back."""
    state = (inv, gk, x_act, d_act, c_act, indices)
    args = state + (u1, idx, kk, gamma, vtv, cnew, live, doins, dorm)
    if not dispatch.use_cuda_kernel(*args):
        out = transition_plain(*args, tol, sentinel)
        for dst, src in zip(state, out):
            dst.copy_(src)
        return out[-1]
    b, K = x_act.shape
    f32, i32 = torch.float32, torch.int32
    expect = ([((b, K, K), f32)] * 2 + [((b, K), f32)] * 3
              + [((b, K), i32), ((b, K), f32), ((b,), i32), ((b,), i32)]
              + [((b,), f32)] * 3 + [((b,), torch.bool)] * 3)
    names = ("inv gk x_act d_act c_act indices u1 idx kk gamma vtv cnew "
             "live doins dorm").split()
    for name, (shape, dtype), t in zip(names, expect, args):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got "
                             f"{t.dtype} of shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    deg = torch.empty(b, dtype=torch.bool, device=x_act.device)
    if b == 0 or K == 0:
        return deg.zero_()
    lib = build.library()
    cap = getattr(torch.cuda.get_device_properties(x_act.device),
                  "shared_memory_per_block_optin", _SMEM_OPTIN)
    need = lib.ss_transition_smem_bytes(K)
    if need > cap - 1024:   # leave room for the kernel's static scalars
        raise ValueError(
            f"capacity K={K} needs {need} bytes of shared memory per block; "
            f"this card allows {cap} (about K <= 167 on Hopper)")
    with torch.cuda.device(x_act.device):
        stream = torch.cuda.current_stream(x_act.device).cuda_stream
        rc = lib.ss_transition(*(t.data_ptr() for t in args),
                               deg.data_ptr(), float(tol), int(sentinel),
                               b, K, stream)
    build.check(rc, NAME)
    dispatch.launches[NAME] += 1
    return deg
