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
                     rounded operands.

``precision_scope`` pins ``torch.backends.cuda.matmul.allow_tf32`` for its
extent and restores the caller's setting afterwards. The scope stack is
thread-local like the JAX package's; the TF32 flag itself is
process-global in PyTorch, so two threads solving at different precisions
at once would race on it.
"""

from __future__ import annotations

import contextlib
import threading

import torch

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


def xgemm(A: torch.Tensor, B: torch.Tensor, *, trans_a: bool = False,
          trans_b: bool = False) -> torch.Tensor:
    """C = op(A) @ op(B) at the scope's precision, in A's dtype."""
    Ma = A.T if trans_a else A
    Mb = B.T if trans_b else B
    if current_precision() == "default":
        Ma = Ma.to(torch.bfloat16).to(A.dtype)
        Mb = Mb.to(torch.bfloat16).to(A.dtype)
    return torch.matmul(Ma, Mb)
