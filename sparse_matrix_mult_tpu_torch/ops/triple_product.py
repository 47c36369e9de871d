"""Fused triple product C = H . Q . H^T (dense symmetric output).

Counterpart of :mod:`sparse_matrix_mult_tpu.ops.triple_product`, branch for
branch.  The intermediate ``T = H.Q`` is never a sparse matrix, and with
``compute_full_matrix=1`` the lower triangle mirrors the upper one, so the
output is symmetric even when ``Q`` is not (the reference's contract).

On the card under FAST, K3 densifies H and Q in float32, ``H.Q`` is one
full-FP32 cuBLAS product (the JAX package leaves it to XLA), and the second
contraction goes through K1 in its ``transpose_b`` form: only the upper
tiles of ``T . H^T`` are computed, and K1's split reads the (m, n)
row-major ``hd`` as its K-major (N, K) operand directly.  K1 runs its
full-f32 (HIGHEST) branch, or its three-pass split3 branch when the caller
passed ``precision="fast"`` explicitly, as in the JAX package (no term-count
gate here, as there).
"""

from __future__ import annotations

import torch

from ..config import Precision
from ..types import CSRMatrix
from .convert import csr_to_dense
from .dense_path import _expected_terms, _triu_kernel_ok
from .kernels.triu_matmul import matmul_triu
from .matmul import full_fp32, resolve_precision, split_operand

__all__ = ["triple_product_dense"]


def _chain(hd: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
    with full_fp32():
        return torch.matmul(torch.matmul(hd, qd), hd.T)


def triple_product_dense(h: CSRMatrix, q: CSRMatrix, compute_full_matrix: int = 0,
                         precision: str | None = None) -> torch.Tensor:
    """Dense (m x m) result of H(m x n) . Q(n x n) . H^T.

    ``compute_full_matrix=0`` -> upper triangle only (the lower is zero);
    ``compute_full_matrix=1`` -> upper triangle mirrored into the lower.
    """
    prec = resolve_precision(precision, _expected_terms(h, q))
    out_dtype = torch.promote_types(h.dtype, q.dtype)
    m = h.shape[0]

    if _triu_kernel_ok(h, m, m, prec):
        hd = csr_to_dense(h, torch.float32)
        qd = csr_to_dense(q, torch.float32)
        with full_fp32():
            t = torch.matmul(hd, qd)
        split3 = precision == Precision.FAST
        c = matmul_triu(t, hd, transpose_b=True, split3=split3).to(out_dtype)
    elif prec == Precision.STRICT or h.device.type != "cuda":
        c = _chain(csr_to_dense(h, out_dtype), csr_to_dense(q, out_dtype))
    elif prec == Precision.FAST:
        c = _chain(csr_to_dense(h, torch.float32), csr_to_dense(q, torch.float32)).to(out_dtype)
    elif prec == Precision.SPLIT:
        # Split both contractions; the lo*lo terms are below f64 noise here.
        hhi, hlo = split_operand(csr_to_dense(h, out_dtype))
        qhi, qlo = split_operand(csr_to_dense(q, out_dtype))
        with full_fp32():
            t = (torch.matmul(hhi, qhi).double() + torch.matmul(hhi, qlo).double()
                 + torch.matmul(hlo, qhi).double())
            thi, tlo = split_operand(t)
            c = (torch.matmul(thi, hhi.T).double() + torch.matmul(thi, hlo.T).double()
                 + torch.matmul(tlo, hhi.T).double()).to(out_dtype)
    else:
        raise ValueError(f"unknown precision policy: {prec!r}")

    upper = torch.triu(c)
    if compute_full_matrix:
        return upper + torch.triu(c, 1).T
    return upper
