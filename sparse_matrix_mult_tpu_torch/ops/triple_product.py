"""Fused triple product C = H . Q . H^T (dense symmetric output).

Counterpart of :mod:`sparse_matrix_mult_tpu.ops.triple_product`, branch for
branch.  The intermediate ``T = H.Q`` is never a sparse matrix, and with
``compute_full_matrix=1`` the lower triangle mirrors the upper one, so the
output is symmetric even when ``Q`` is not (the reference's contract).

On the card every f32 product that the JAX package writes as
``jnp.dot(..., precision="highest")`` runs the six-pass bf16 GEMM
:func:`~.kernels.full_matmul.matmul_full` on the tensor cores.  Under FAST,
K3 densifies H and Q in float32, ``H.Q`` is one full product and the second
contraction goes through K1 in its ``transpose_b`` form: only the upper
tiles of ``T . H^T`` are computed (:func:`_fast_dense`).  K1 runs its
full-f32 (HIGHEST) branch, and then H is split once: its three bf16 pieces
are A of ``H.Q`` and B of ``T . H^T``; or K1 runs its three-pass split3
branch when the caller passed ``precision="fast"`` explicitly, as in the
JAX package (no term-count gate here, as there).  STRICT, and every
product on the CPU, multiplies in the operands' dtype with
``torch.matmul``.
"""

from __future__ import annotations

import torch

from ..config import Precision
from ..types import CSRMatrix
from ..utils.profiling import span
from ._precision import full_fp32
from .convert import csr_to_dense
from .dense_path import _expected_terms, _triu_kernel_ok
from .kernels.full_matmul import matmul_full, matmul_full_pieces
from .kernels.triu_matmul import matmul_triu, matmul_triu_pieces, split_bf16
from .matmul import resolve_precision, split_operand

__all__ = ["triple_product_dense"]


def _chain(hd: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
    """H.Q.H^T of f32 operands as the JAX package's two HIGHEST dots."""
    return matmul_full(matmul_full(hd, qd), hd, transpose_b=True)


def _fast_dense(hd: torch.Tensor, qd: torch.Tensor, split3: bool) -> torch.Tensor:
    """The K1 branch on dense f32 H (m, n) and Q (n, n), on any device (the
    CPU runs the plain kernels): ``T = H.Q`` in full, then the upper tiles of
    ``T . H^T``.  Under HIGHEST H is split once, its three pieces in rows
    form feeding both GEMMs; split3 needs H's two halves for K1, so there
    nothing is shared."""
    if split3:
        return matmul_triu(matmul_full(hd, qd), hd, transpose_b=True, split3=True)
    m, n = hd.shape
    hp = split_bf16(hd, 3)
    t = matmul_full_pieces(hp, split_bf16(qd, 3, transpose=True), m, n)
    return matmul_triu_pieces(split_bf16(t, 3), hp, m, m)


def triple_product_dense(h: CSRMatrix, q: CSRMatrix, compute_full_matrix: int = 0,
                         precision: str | None = None) -> torch.Tensor:
    """Dense (m x m) result of H(m x n) . Q(n x n) . H^T.

    ``compute_full_matrix=0`` -> upper triangle only (the lower is zero);
    ``compute_full_matrix=1`` -> upper triangle mirrored into the lower.
    """
    prec = resolve_precision(precision, _expected_terms(h, q))
    # Operands of one dtype (the usual case) need no dispatched promotion.
    out_dtype = h.dtype if h.dtype == q.dtype else torch.promote_types(h.dtype, q.dtype)
    m = h.shape[0]

    if _triu_kernel_ok(h, m, m, prec):
        hd = csr_to_dense(h, torch.float32)
        qd = csr_to_dense(q, torch.float32)
        with span("smm.gemm"):
            c = _fast_dense(hd, qd, split3=precision == Precision.FAST)
    elif prec == Precision.STRICT or h.device.type != "cuda":
        hd = csr_to_dense(h, out_dtype)
        qd = csr_to_dense(q, out_dtype)
        with span("smm.gemm"), full_fp32():
            t = torch.matmul(hd, qd)
            del qd
            c = torch.matmul(t, hd.T)
            del t
    elif prec == Precision.FAST:
        hd = csr_to_dense(h, torch.float32)
        qd = csr_to_dense(q, torch.float32)
        with span("smm.gemm"):
            c = _chain(hd, qd)
            del hd, qd
    elif prec == Precision.SPLIT:
        hd = csr_to_dense(h, out_dtype)
        qd = csr_to_dense(q, out_dtype)
        with span("smm.gemm"):
            # Split both contractions; the lo*lo terms are below f64 noise here.
            hhi, hlo = split_operand(hd)
            qhi, qlo = split_operand(qd)
            del hd, qd
            t = (matmul_full(hhi, qhi).double() + matmul_full(hhi, qlo).double()
                 + matmul_full(hlo, qhi).double())
            thi, tlo = split_operand(t)
            c = (matmul_full(thi, hhi, transpose_b=True).double()
                 + matmul_full(thi, hlo, transpose_b=True).double()
                 + matmul_full(tlo, hhi, transpose_b=True).double())
    else:
        raise ValueError(f"unknown precision policy: {prec!r}")

    with span("smm.finish"):
        c = c.to(out_dtype)
        upper = torch.triu(c)
        if compute_full_matrix:
            return upper + torch.triu(c, 1).T
        return upper
