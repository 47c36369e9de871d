"""CSR <-> dense conversion on the container.

Counterpart of :mod:`sparse_matrix_mult_tpu.ops.convert`.  The JAX module
routes through shift networks (``ops/shift_network.py``) because XLA scatter
is near-serial on a TPU; here the conversions go straight to the kernels of
:mod:`.kernels.convert_kernels` (K3, K2/K4): a CUDA tensor launches the
kernel, a CPU tensor runs its plain PyTorch version.
"""

from __future__ import annotations

import torch

from ..types import CSRMatrix
from ..utils.profiling import span
from .kernels import convert_kernels

__all__ = ["csr_to_dense", "dense_to_csr", "dense_to_csr_triu", "csr_row_ids"]


def csr_row_ids(a: CSRMatrix) -> torch.Tensor:
    """Row id of every entry position; padding takes the last non-empty row's
    id (0 when there is none), as the JAX distribute + cummax gives."""
    out = a.row_ids()
    nnz = int(a.nnz)
    if nnz:
        out[nnz:] = out[nnz - 1]
    return out


def csr_to_dense(a: CSRMatrix, dtype=None) -> torch.Tensor:
    """Dense (rows, cols) matrix; entries must be sorted by (row, col) with no
    duplicates -- true for every container this package builds."""
    with span("smm.densify"):
        values = a.values if dtype is None else a.values.to(dtype)
        return convert_kernels.csr_to_dense(a.indptr, a.indices, values, a.shape)


def dense_to_csr(c: torch.Tensor, capacity: int, dtype=None) -> CSRMatrix:
    """Padded CSR of the nonzeros of ``c``; entries past ``capacity`` are
    dropped (callers size the capacity from the structure)."""
    with span("smm.extract"):
        if dtype is not None:
            c = c.to(dtype)
        indptr, indices, values = convert_kernels.dense_to_csr(c.contiguous(), capacity)
        return CSRMatrix(indptr=indptr, indices=indices, values=values, shape=tuple(c.shape))


def dense_to_csr_triu(c: torch.Tensor, capacity: int, dtype=None) -> CSRMatrix:
    """Padded CSR of the upper triangle of a square matrix (the symmetric
    routines' outputs): only columns ``col >= row`` are scanned.  A
    non-square matrix takes the full extraction, as in the JAX package."""
    if c.shape[0] != c.shape[1]:
        return dense_to_csr(c, capacity, dtype)
    with span("smm.extract"):
        if dtype is not None:
            c = c.to(dtype)
        indptr, indices, values = convert_kernels.dense_to_csr(c.contiguous(), capacity,
                                                               triu=True)
        return CSRMatrix(indptr=indptr, indices=indices, values=values, shape=tuple(c.shape))
