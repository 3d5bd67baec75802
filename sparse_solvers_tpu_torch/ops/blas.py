"""Precision-pinned dense products — the port of ``sparse_solvers_tpu/ops/
blas.py``.

The JAX package names the MXU contraction precision of every product;
this layer maps the same names onto H100 arithmetic:

  "highest", "high"  fp32 inputs, fp32 accumulation, TF32 off. TF32 keeps
                     a 10-bit mantissa, too coarse to stand in for the
                     TPU's 3-pass "high" under the certificate.
  "default"          bf16-rounded inputs, fp32 accumulation, fp32 output
                     — the TPU's one-pass MXU product. The operands are
                     rounded to bf16 and multiplied as fp32 tensors; TF32
                     is allowed there because every bf16 value is exact
                     in TF32 (8-bit exponent, 7 ≤ 10 mantissa bits), so
                     the tensor cores compute exactly the products of the
                     rounded operands. The precision names the passes of
                     an fp32 product: float64 operands multiply at full
                     precision under every name, as XLA multiplies them.

``precision_scope`` pins ``torch.backends.cuda.matmul.allow_tf32`` for its
extent and restores the caller's setting afterwards. The scope stack is
thread-local like the JAX package's; the TF32 flag itself is
process-global in PyTorch, so two threads solving at different precisions
at once would race on it.

Triangular solves have no precision level, in XLA as here: ``xtrsv`` and
``xtrsm`` pin TF32 off for their own extent, whatever the scope, so that
cuBLAS never runs an fp32 ``trsm`` on the tensor cores inside a
"default" scope.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from . import dispatch

_PRECISIONS = ("highest", "high", "default")
_TLS = threading.local()


def _stack() -> list[str]:
    st = getattr(_TLS, "prec_stack", None)
    if st is None:
        st = _TLS.prec_stack = ["highest"]
    return st


def current_precision() -> str:
    return _stack()[-1]


@contextlib.contextmanager
def precision_scope(precision: str):
    """Set the product precision ("highest" | "high" | "default") for the
    products issued within the scope."""
    precision = precision.lower()
    if precision not in _PRECISIONS:
        raise ValueError(
            f"precision must be one of {_PRECISIONS}, got {precision!r}")
    st = _stack()
    saved = torch.backends.cuda.matmul.allow_tf32
    st.append(precision)
    torch.backends.cuda.matmul.allow_tf32 = precision == "default"
    try:
        yield
    finally:
        st.pop()
        torch.backends.cuda.matmul.allow_tf32 = saved


def _operands(*tensors: torch.Tensor):
    """The operands as the scope's precision multiplies them: float32
    rounded to bf16 (and back) at "default", as they are otherwise."""
    if current_precision() == "default":
        return [t.to(torch.bfloat16).to(t.dtype)
                if t.dtype == torch.float32 else t for t in tensors]
    return list(tensors)


def scope_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the scope's precision multiplies it (``_operands``): a
    caller that already holds the bf16 copy of an operand widens that
    copy instead, which gives the same values."""
    return _operands(t)[0]


def bf16_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (p, q) @ b (q, r) for operands already held in bf16, with fp32
    accumulation and an fp32 result: the "default" scope's product
    without rounding either operand again. The tensor's device decides,
    as in ``ops/dispatch.py``: on the card one cuBLAS product that reads
    the bf16 operands (``mm`` with ``out_dtype``, which the card's torch
    registers and the CPU's does not); on the CPU the twin widens both
    (exactly) and multiplies in fp32, the values ``xgemm`` gives up to the
    order of the fp32 sums."""
    if dispatch.use_cuda_kernel(a, b):
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def xgemm(A: torch.Tensor, B: torch.Tensor, *, trans_a: bool = False,
          trans_b: bool = False) -> torch.Tensor:
    """C = op(A) @ op(B) at the scope's precision, in A's dtype, batched
    over any leading axes: op transposes the last two."""
    Ma, Mb = _operands(A.mT if trans_a else A, B.mT if trans_b else B)
    return torch.matmul(Ma, Mb)


def xgemv(A: torch.Tensor, x: torch.Tensor, *,
          trans: bool = False) -> torch.Tensor:
    """y = A @ x (or Aᵀ @ x) at the scope's precision, batched over any
    leading axes the two share: A (..., p, q), x (..., q) → (..., p)."""
    M, v = _operands(A.mT if trans else A, x)
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def xdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """xᵀy over the last axis at the scope's precision."""
    u, v = _operands(x, y)
    return (u * v).sum(dim=-1)


def xger(alpha, x: torch.Tensor, y: torch.Tensor,
         A: torch.Tensor) -> torch.Tensor:
    """A + alpha·x·yᵀ (rank-1 update), batched over leading axes; a tensor
    ``alpha`` carries one value per batch entry."""
    if isinstance(alpha, torch.Tensor):
        alpha = alpha[..., None, None]
    return A + alpha * (x.unsqueeze(-1) * y.unsqueeze(-2))


def xtrsm(R: torch.Tensor, B: torch.Tensor, *, lower: bool = False,
          trans: bool = False) -> torch.Tensor:
    """Solve op(R) X = B for triangular R at full precision, batched over
    leading axes: R (..., n, n), B (..., n, k) → (..., n, k)."""
    M = R.mT if trans else R
    # op(R) is upper exactly when R is lower and transposed, or upper and
    # not; the solve always runs with TF32 off
    with precision_scope("highest"):
        return torch.linalg.solve_triangular(M, B, upper=lower == trans)


def xtrsv(L: torch.Tensor, b: torch.Tensor, *, lower: bool = True,
          trans: bool = False) -> torch.Tensor:
    """Solve op(L) x = b for triangular L at full precision, batched over
    leading axes: L (..., n, n), b (..., n) → (..., n)."""
    return xtrsm(L, b.unsqueeze(-1), lower=lower, trans=trans).squeeze(-1)
