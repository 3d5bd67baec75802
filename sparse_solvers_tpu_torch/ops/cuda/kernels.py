"""K1 — the bf16 normal-equation product q = AᵀA·d of every iteration.

Port of ``sparse_solvers_tpu/ops/pallas/kernels.py::normal_matvec_fused_bf16``
(the Pallas kernel at :160-241). The CUDA form is ``csrc/normal_bf16.cu``:
two launches of one bf16 tensor-core tile GEMM, P = bf16(bf16(D)·A16ᵀ) into
a (b, m) bf16 scratch, then Q = P·A16 in f32 (the file's header says why
the TPU kernel's one-pass, output-resident decomposition does not carry
over, and what bounds the kernel on the H100).

``normal_matvec_fused_bf16_plain`` is its twin: the same roundings in
plain PyTorch, fp32 products with TF32 off. A bare bf16 ``torch.matmul``
would round Q to bf16 as well, so the twin multiplies the bf16 values as
fp32 tensors.
"""

from __future__ import annotations

import torch

from .. import blas, dispatch
from . import build

NAME = "normal_matvec_fused_bf16"


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
    if max(b, m, n) >= 2**31 or -(-n // 64) > 65535 or -(-m // 64) > 65535:
        raise ValueError(f"shape (b={b}, m={m}, n={n}) exceeds the "
                         "kernel's grid")
    Q = torch.empty((b, n), dtype=torch.float32, device=D.device)
    if b == 0 or n == 0:
        return Q
    if m == 0:
        return Q.zero_()
    P = torch.empty((b, m), dtype=torch.bfloat16, device=D.device)
    lib = build.library()
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream(D.device).cuda_stream
        rc = lib.ss_normal_matvec_bf16(D.data_ptr(), A16.data_ptr(),
                                       P.data_ptr(), Q.data_ptr(),
                                       b, m, n, stream)
    build.check(rc, NAME)
    dispatch.launches[NAME] += 1
    return Q
