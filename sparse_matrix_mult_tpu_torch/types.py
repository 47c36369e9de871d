"""Capacity-padded CSR container of torch tensors.

Same layout as :class:`sparse_matrix_mult_tpu.types.CSRMatrix`:

* ``indptr``  -- int32, ``(rows + 1,)``, exact row pointers;
* ``indices`` -- int32, ``(capacity,)``, zero past ``indptr[-1]``;
* ``values``  -- float, ``(capacity,)``, zero past ``indptr[-1]``.

Capacities are powers of two (:func:`bucket_capacity`), as in the JAX
package, so the two packages can be fed the identical padded arrays
(:meth:`CSRMatrix.from_numpy`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .config import get_config

__all__ = ["row_ids_from_indptr", "CSRMatrix", "bucket_capacity", "from_scipy", "to_scipy",
           "from_dense"]

Shape = Tuple[int, int]

INDEX_DTYPE = torch.int32


def row_ids_from_indptr(indptr: torch.Tensor, capacity: int) -> torch.Tensor:
    """Row id (int32) of every entry position ``0..capacity`` from CSR row
    pointers, on ``indptr``'s device, with no host sync.

    JAX's marker scatter and inclusive cumsum: ``marker[p]`` counts the rows
    that end at position ``p`` (empty rows stack markers), so an entry at a
    row start belongs to that row.  Row ends past ``capacity`` land in a
    spare slot that the cumsum never reads (JAX drops them).  Positions from
    ``indptr[-1]`` on count every row end, as in JAX: mask at the call site
    where padding must map elsewhere.
    """
    ends = indptr[1:].long().clamp(max=capacity + 1)
    marker = torch.zeros(capacity + 2, dtype=INDEX_DTYPE, device=indptr.device)
    marker.index_add_(0, ends, torch.ones_like(ends, dtype=INDEX_DTYPE))
    return torch.cumsum(marker[:capacity], 0, dtype=INDEX_DTYPE)


def bucket_capacity(n: int, minimum: int = 128) -> int:
    """Round ``n`` up to a capacity bucket (next power of two)."""
    n = max(int(n), minimum)
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Capacity-padded CSR matrix; every tensor lies on one device."""

    indptr: torch.Tensor  # (rows + 1,) int32
    indices: torch.Tensor  # (capacity,) int32
    values: torch.Tensor  # (capacity,) float
    shape: Shape

    @property
    def rows(self) -> int:
        return self.shape[0]

    @property
    def cols(self) -> int:
        return self.shape[1]

    @property
    def capacity(self) -> int:
        return int(self.indices.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def nnz(self) -> torch.Tensor:
        """Logical number of stored entries (0-d tensor on the matrix's device)."""
        return self.indptr[-1]

    @classmethod
    def from_numpy(cls, indptr, indices, values, shape, device=None) -> "CSRMatrix":
        """Container from numpy arrays laid out as above (for example the
        ``np.asarray`` of each field of a JAX ``CSRMatrix``), kept as given:
        same capacity, same padding."""
        device = torch.device(device or get_config().device)
        return cls(
            indptr=torch.from_numpy(np.array(indptr, np.int32)).to(device),
            indices=torch.from_numpy(np.array(indices, np.int32)).to(device),
            values=torch.from_numpy(np.array(values)).to(device),
            shape=(int(shape[0]), int(shape[1])),
        )

    def row_ids(self) -> torch.Tensor:
        """Row index of every stored entry; padding maps to row 0."""
        pos = torch.arange(self.capacity, device=self.device)
        return torch.where(pos < self.nnz, row_ids_from_indptr(self.indptr, self.capacity), 0)

    def todense(self, dtype=None) -> torch.Tensor:
        """Dense ``(rows, cols)`` matrix, duplicate entries summed (plain
        PyTorch; the routes densify through K3, :func:`.ops.convert.csr_to_dense`)."""
        dtype = dtype or self.values.dtype
        nnz = int(self.nnz)
        out = torch.zeros(self.shape, dtype=dtype, device=self.device)
        rows = self.row_ids()[:nnz].long()
        cols = self.indices[:nnz].long()
        return out.index_put_((rows, cols), self.values[:nnz].to(dtype), accumulate=True)

    def transpose_dense(self) -> torch.Tensor:
        """Dense transpose."""
        return self.todense().T

    def with_capacity(self, capacity: int) -> "CSRMatrix":
        """A copy with another entry capacity: growth zero-pads, a shrink
        truncates (the caller keeps ``capacity >= nnz``)."""
        cap = int(capacity)
        if cap == self.capacity:
            return self
        pad = max(cap - self.capacity, 0)
        indices = torch.nn.functional.pad(self.indices[:cap], (0, pad))
        values = torch.nn.functional.pad(self.values[:cap], (0, pad))
        return CSRMatrix(self.indptr, indices, values, self.shape)


def from_scipy(mat, dtype=None, capacity: int | None = None, device=None) -> CSRMatrix:
    """Upload a scipy CSR (or anything ``csr_matrix`` accepts) to ``device``.

    Only the ``nnz`` live entries cross to the device; the padding up to the
    power-of-two capacity is zero-filled there.  ``dtype`` defaults to
    float64, the JAX package's default with x64 enabled.
    """
    import scipy.sparse as sp

    if not sp.issparse(mat):
        mat = sp.csr_matrix(np.asarray(mat))
    mat = mat.tocsr()
    mat.sum_duplicates()
    nnz = int(mat.nnz)
    cap = capacity if capacity is not None else bucket_capacity(nnz)
    if cap < nnz:
        raise ValueError(f"capacity {cap} < nnz {nnz}")
    dtype = dtype or torch.float64
    device = torch.device(device or get_config().device)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    indptr = torch.from_numpy(np.ascontiguousarray(mat.indptr, np.int32)).to(device)
    indices = torch.zeros(cap, dtype=INDEX_DTYPE, device=device)
    values = torch.zeros(cap, dtype=dtype, device=device)
    indices[:nnz] = torch.from_numpy(np.ascontiguousarray(mat.indices, np.int32)).to(device)
    values[:nnz] = torch.from_numpy(np.ascontiguousarray(mat.data, np_dtype)).to(device)
    return CSRMatrix(
        indptr=indptr,
        indices=indices,
        values=values,
        shape=tuple(int(s) for s in mat.shape),
    )


def to_scipy(mat: CSRMatrix, dtype=None):
    """Download to an exact (trimmed) scipy ``csr_matrix``, its values cast
    to ``dtype`` in the download (:func:`~.utils.transfer.fetch_np`) when
    one is given."""
    import scipy.sparse as sp

    from .utils.transfer import fetch_np

    indptr = fetch_np(mat.indptr)
    nnz = int(indptr[-1])
    indices = fetch_np(mat.indices[:nnz])
    values = fetch_np(mat.values[:nnz], dtype)
    return sp.csr_matrix((values, indices, indptr), shape=mat.shape)


def from_dense(dense: torch.Tensor, capacity: int) -> CSRMatrix:
    """Padded CSR of the nonzeros of a dense matrix (plain PyTorch).

    Mirrors the JAX ``from_dense``: ``indptr`` counts every nonzero, and the
    entries past ``capacity`` are dropped.
    """
    rows, cols = dense.shape
    mask = dense != 0
    indptr = torch.zeros(rows + 1, dtype=INDEX_DTYPE, device=dense.device)
    indptr[1:] = torch.cumsum(mask.sum(dim=1), dim=0)
    r, c = torch.nonzero(mask, as_tuple=True)
    keep = min(int(r.shape[0]), int(capacity))
    indices = torch.zeros(capacity, dtype=INDEX_DTYPE, device=dense.device)
    values = torch.zeros(capacity, dtype=dense.dtype, device=dense.device)
    indices[:keep] = c[:keep].to(INDEX_DTYPE)
    values[:keep] = dense[r[:keep], c[:keep]]
    return CSRMatrix(indptr=indptr, indices=indices, values=values, shape=(rows, cols))
