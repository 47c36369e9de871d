"""Dense route: densify -> matmul -> (optionally) re-sparsify.

Counterpart of :mod:`sparse_matrix_mult_tpu.ops.dense_path`.  At the
densities the reference targets the product is nearly dense, so SpGEMM is
lowered onto one dense product: densify both operands (K3), multiply
(:func:`policy_matmul`, or K1 for the upper triangle of a symmetric product) and
extract the structure (K2/K4).  K1 takes its three-pass split3 branch under
the same conditions as in the JAX package (:func:`spgemm_dense_out`).
"""

from __future__ import annotations

import math

import torch

from ..config import Precision, get_config
from ..types import CSRMatrix
from ..utils.profiling import span
from .convert import csr_to_dense, dense_to_csr
from .kernels.triu_matmul import matmul_triu
from .matmul import policy_matmul, resolve_precision

__all__ = ["spgemm_dense_out", "spgemm_sparse_out", "dense_path_fits", "product_dense"]


def dense_path_fits(*shapes) -> bool:
    limit = get_config().dense_path_limit
    return all(int(s[0]) * int(s[1]) <= limit for s in shapes)


def product_dense(a: CSRMatrix, b: CSRMatrix, precision: str) -> torch.Tensor:
    """Dense A@B under a precision policy: densify (K3) in the dtype the
    policy multiplies in (f32 for FAST on the card), then :func:`policy_matmul`."""
    # Operands of one dtype (the usual case) need no dispatched promotion.
    out_dtype = a.dtype if a.dtype == b.dtype else torch.promote_types(a.dtype, b.dtype)
    fast_on_card = precision == Precision.FAST and a.device.type == "cuda"
    dense_dtype = torch.float32 if fast_on_card else out_dtype
    ad, bd = csr_to_dense(a, dense_dtype), csr_to_dense(b, dense_dtype)
    with span("smm.gemm"):
        return policy_matmul(ad, bd, precision, out_dtype)


def _expected_terms(a: CSRMatrix, b: CSRMatrix) -> float:
    """Expected accumulation terms per output element (drives AUTO), from the
    capacities: ``K * density(A) * density(B)``, overestimated by < 4x."""
    m, k = a.shape
    n = b.shape[1]
    return (a.capacity * b.capacity) / max(m * k * n, 1)


def _split3_within_oracle(a: CSRMatrix, b: CSRMatrix, rtol: float = 1e-5) -> bool:
    """Size-aware gate of K1's split3 branch (the JAX package's, constant
    for constant).

    The bf16 hi/lo split keeps 16 of f32's 24 mantissa bits, so each partial
    product carries ~2^-16 relative error; over ``T`` random-signed terms the
    entry-wise max relative error behaves like ``2^-16 / sqrt(T)``, and the
    worst entries are those with the fewest terms.  With T ~ Poisson(tbar)
    over m*n entries the smallest count is ~ ``tbar - sqrt(2 tbar ln(m n))``.
    split3 is engaged only when that worst case clears rtol with 2x margin.
    Uses the capacities only.
    """
    m, n = a.shape[0], b.shape[1]
    tbar = _expected_terms(a, b)
    tmin = max(tbar - math.sqrt(2.0 * tbar * math.log(max(m * n, 2))), 1.0)
    return 2.0**-16 / math.sqrt(tmin) <= 0.5 * rtol


def _triu_kernel_ok(a: CSRMatrix, m: int, n: int, prec: str) -> bool:
    """Whether the symmetric product goes through K1: CUDA operands, the FAST
    policy, a square output and more than 2^20 elements."""
    return a.device.type == "cuda" and prec == Precision.FAST and m == n and m * n > 1 << 20


def spgemm_dense_out(a: CSRMatrix, b: CSRMatrix, symmetric: bool = False,
                     precision: str | None = None) -> torch.Tensor:
    """sparse x sparse -> dense; ``symmetric=True`` returns the upper
    triangle with a zero lower triangle (the reference's contract)."""
    prec = resolve_precision(precision, _expected_terms(a, b))
    if symmetric:
        m, n = a.shape[0], b.shape[1]
        if _triu_kernel_ok(a, m, n, prec):
            # Upper-tile-only product: the strictly-lower tiles are skipped.
            # split3 only on the caller's explicit FAST (AUTO resolving to
            # FAST does not opt into its weaker bound) and inside the gate.
            split3 = precision == Precision.FAST and _split3_within_oracle(a, b)
            ad = csr_to_dense(a, torch.float32)
            bd = csr_to_dense(b, torch.float32)
            with span("smm.gemm"):
                c = matmul_triu(ad, bd, split3=split3)
            with span("smm.finish"):
                return torch.triu(c).to(torch.promote_types(a.dtype, b.dtype))
        c = product_dense(a, b, prec)
        with span("smm.finish"):
            return torch.triu(c)
    return product_dense(a, b, prec)


def spgemm_sparse_out(a: CSRMatrix, b: CSRMatrix, out_capacity: int, symmetric: bool = False,
                      precision: str | None = None) -> CSRMatrix:
    """sparse x sparse -> padded CSR via the dense route.  Entries whose value
    is exactly 0 are dropped (Gustavson implementations keep them)."""
    c = spgemm_dense_out(a, b, symmetric=symmetric, precision=precision)
    return dense_to_csr(c, out_capacity)
