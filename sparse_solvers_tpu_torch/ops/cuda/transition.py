"""K3 — the fused active-set transition of a homotopy iteration.

Port of ``sparse_solvers_tpu/ops/pallas/transition.py::transition`` (the
Pallas kernel at :64-295; the math is written out in ``csrc/
transition.cu``'s header). The CUDA form runs one block per lane on the
lane's live block only (slots below kk, and slot kk on an insert), holds
the inverse's block in registers or works on it in place in device
memory by capacity (``k3_launch_plan``), streams the active Gram once and
writes it only where it changes, branches per lane, and updates inv, gk,
x_act, d_act, c_act and indices in place, as the Pallas call aliases
them (:279).

``transition_plain`` is its twin: the Pallas body as batched torch ops,
every lane gated by ``torch.where`` selects (never a 0·x multiply), and
the slot indices kept as integers.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import dispatch
from . import build

NAME = "transition"
_TINY = 256 * 1.1754944e-38   # 256·FLT_MIN: the engines' shared guard

# csrc/transition.cu states the first five (tests/test_torch_k3_plan.py
# holds them together)
K3_THREADS = 256              # a block a lane, registers route (8 warps)
K3_MEM_THREADS = 512          # a block a lane, device routes
K3_REG_FLOATS = 64            # inv's floats a thread may hold in registers
K3_VECTORS = 10               # K-vectors staged per lane
K3_RED_FLOATS = 32            # den's and p's per-warp partials, 16 warps
SMEM_OPTIN = 232448           # 227 KB: a Hopper block's shared-memory cap
ROUTES = ("registers", "device")


@dataclasses.dataclass(frozen=True)
class K3Plan:
    """K3's launch at capacity K: b blocks of ``threads`` threads, one a
    lane. ``route``: "registers" (K3_THREADS threads, each holding rows w
    + 8r, r < 4·cols, by columns lane + 32c, c < cols, of the inverse's
    live block) or "device" (in place in device memory, K3_MEM_THREADS
    threads). ``vec``: gk's rows load 4 floats at a time (float4) or 1.
    ``smem_bytes``: the dynamic shared memory the route stages, the
    K-vectors. ``work_floats``: past the point where even the vectors do
    not fit (K above 5808), they live in a per-lane device workspace of
    that many floats; else 0."""
    route: str
    cols: int
    vec: int
    smem_bytes: int
    work_floats: int = 0

    @property
    def threads(self) -> int:
        return K3_THREADS if self.route == "registers" else K3_MEM_THREADS

    @property
    def code(self) -> int:
        """The route's number in ``ss_transition`` (2: device memory with
        the vectors in the workspace)."""
        return 2 if self.work_floats else ROUTES.index(self.route)


def _vector_floats(K: int) -> int:
    return K3_VECTORS * (-(-K // 4) * 4) + K3_RED_FLOATS


def k3_launch_plan(K: int, aligned: bool = True) -> K3Plan:
    """The launch of K3 at capacity K. The registers route wherever a
    thread's tile of the inverse, 4·⌈K/32⌉² floats, fits the register
    budget K3_REG_FLOATS (K ≤ 128: the Homotopy tiers 24, 48, 96 and the
    default k_max 101); else the device route, with the vectors in shared
    memory wherever they fit SMEM_OPTIN. ``aligned``: inv and gk start on
    16 bytes, so gk's rows load as float4 when K % 4 == 0. No capacity is
    refused."""
    if K <= 0:
        raise ValueError(f"capacity K={K} must be positive")
    vectors = 4 * _vector_floats(K)
    cols = -(-K // 32)
    vec = 4 if aligned and K % 4 == 0 else 1
    if 4 * cols * cols <= K3_REG_FLOATS:
        return K3Plan("registers", cols, vec, vectors)
    if vectors <= SMEM_OPTIN:
        return K3Plan("device", 0, vec, vectors)
    return K3Plan("device", 0, vec, 0, _vector_floats(K))


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
    left untouched (the caller breaks the lane). The CUDA kernel reads
    only each lane's live block: every slot ≥ kk must be vacant (zero
    rows and columns in inv and gk, zero u1, x_act, d_act and c_act, the
    sentinel in indices), as the driver keeps them. CUDA tensors launch
    the hand kernel; CPU tensors run the twin and copy its result back."""
    state = (inv, gk, x_act, d_act, c_act, indices)
    args = state + (u1, idx, kk, gamma, vtv, cnew, live, doins, dorm)
    if not dispatch.use_cuda_kernel(*args):
        out = transition_plain(*args, tol, sentinel)
        for dst, src in zip(state, out):
            dst.copy_(src)
        return out[-1]
    b, K = x_act.shape
    f32, i32 = torch.float32, torch.int32
    build.check_operands(
        "inv gk x_act d_act c_act indices u1 idx kk gamma vtv cnew live "
        "doins dorm", args,
        [((b, K, K), f32)] * 2 + [((b, K), f32)] * 3
        + [((b, K), i32), ((b, K), f32), ((b,), i32), ((b,), i32)]
        + [((b,), f32)] * 3 + [((b,), torch.bool)] * 3)
    deg = torch.empty(b, dtype=torch.bool, device=x_act.device)
    if b == 0 or K == 0:
        return deg.zero_()
    plan = k3_launch_plan(K, inv.data_ptr() % 16 == 0
                          and gk.data_ptr() % 16 == 0)
    work = (torch.empty((b, plan.work_floats), dtype=f32,
                        device=x_act.device) if plan.work_floats else None)
    lib = build.library()
    with torch.cuda.device(x_act.device):
        stream = torch.cuda.current_stream(x_act.device).cuda_stream
        rc = lib.ss_transition(*(t.data_ptr() for t in args),
                               deg.data_ptr(),
                               None if work is None else work.data_ptr(),
                               float(tol), int(sentinel), b, K, plan.code,
                               plan.threads, plan.cols, plan.vec,
                               plan.smem_bytes, stream)
    build.check(rc, NAME)
    dispatch.launches[NAME] += 1
    return deg
