"""Precision-policy dense matmuls.

Counterpart of :mod:`sparse_matrix_mult_tpu.ops.matmul`.  The policy is
keyed on the tensors' device: a CPU tensor multiplies in its native dtype
(f64 gives exact parity with scipy), a CUDA tensor follows the policy.
Where the JAX package writes ``jnp.dot(..., precision="highest")`` on f32
operands (FAST, and SPLIT's three products), the card runs the hand-written
six-pass bf16 GEMM :func:`~.kernels.full_matmul.matmul_full` on the tensor
cores, the arithmetic XLA runs for HIGHEST on the TPU.  STRICT multiplies
in the native dtype with ``torch.matmul`` (cuBLAS; f64 for f64 operands),
in full FP32 for f32 whatever PyTorch's global TF32 setting
(:func:`full_fp32`): a 10-bit TF32 mantissa would lose the rtol = 1e-5
oracle.
"""

from __future__ import annotations

import torch

from ..config import Precision, get_config
from ._precision import full_fp32
from .kernels.full_matmul import matmul_full

__all__ = ["policy_matmul", "split_operand", "resolve_precision", "full_fp32"]


def resolve_precision(precision: str | None, expected_terms: float) -> str:
    """Resolve AUTO to a concrete policy given expected dot-product length."""
    cfg = get_config()
    p = precision or cfg.precision
    if p == Precision.AUTO:
        return Precision.FAST if expected_terms <= cfg.auto_split_terms else Precision.SPLIT
    return p


def split_operand(x: torch.Tensor):
    """Double-float split: ``x ~= hi + lo`` with both parts exactly f32."""
    hi = x.to(torch.float32)
    lo = (x - hi.to(x.dtype)).to(torch.float32)
    return hi, lo


def _on_card(x: torch.Tensor) -> bool:
    """Whether the policy applies to ``x`` (the JAX package's ``_on_tpu``)."""
    return x.device.type == "cuda"


def _highest(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of f32 operands through :func:`matmul_full`: a transposed
    view of a contiguous B takes the ``transpose_b`` form (the same bits),
    any other layout is copied contiguous first (the rings' column slices)."""
    if not b.is_contiguous() and b.T.is_contiguous():
        return matmul_full(a.contiguous(), b.T, transpose_b=True)
    return matmul_full(a.contiguous(), b.contiguous())


def policy_matmul(a: torch.Tensor, b: torch.Tensor, precision: str = Precision.FAST,
                  out_dtype=None) -> torch.Tensor:
    """``a @ b`` under a precision policy (native dtype on the CPU)."""
    if out_dtype is None:
        out_dtype = torch.promote_types(a.dtype, b.dtype)
    if not _on_card(a):
        return torch.matmul(a.to(out_dtype), b.to(out_dtype))
    if precision == Precision.STRICT:
        with full_fp32():
            return torch.matmul(a.to(out_dtype), b.to(out_dtype))
    if precision == Precision.FAST:
        return _highest(a.to(torch.float32), b.to(torch.float32)).to(out_dtype)
    if precision == Precision.SPLIT:
        ahi, alo = split_operand(a)
        bhi, blo = split_operand(b)
        hh = _highest(ahi, bhi).double()
        hl = _highest(ahi, blo).double()
        lh = _highest(alo, bhi).double()
        return (hh + (hl + lh)).to(out_dtype)
    raise ValueError(f"unknown precision policy: {precision!r}")
