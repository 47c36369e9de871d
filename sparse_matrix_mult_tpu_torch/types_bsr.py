"""Block-sparse row (BSR) container of torch tensors.

Same layout as :class:`sparse_matrix_mult_tpu.types_bsr.BSRMatrix`:

* ``indptr``  -- int32, ``(nbr + 1,)``, block-row pointers;
* ``indices`` -- int32, ``(block_capacity,)``, block-column ids (padding: 0);
* ``blocks``  -- ``(block_capacity, b, b)`` values (padding: zero blocks);
* ``shape``   -- logical ``(rows, cols)``; rows and columns are padded up to
  multiples of ``b`` inside the blocks, and the padding is zero.

Block capacities are powers of two (``bucket_capacity(nblocks, minimum=1)``),
as in the JAX package, so the two packages can be fed the identical padded
arrays (:meth:`BSRMatrix.from_numpy`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .config import get_config
from .types import INDEX_DTYPE, bucket_capacity, row_ids_from_indptr

__all__ = ["BSRMatrix", "bsr_from_scipy", "bsr_from_dense", "bsr_to_dense"]

Shape = Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class BSRMatrix:
    """Capacity-padded BSR matrix; every tensor lies on one device."""

    indptr: torch.Tensor  # (nbr + 1,) int32
    indices: torch.Tensor  # (block_capacity,) int32
    blocks: torch.Tensor  # (block_capacity, b, b)
    shape: Shape

    @property
    def block_size(self) -> int:
        return int(self.blocks.shape[1])

    @property
    def block_capacity(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def nbr(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @property
    def nbc(self) -> int:
        return -(-self.shape[1] // self.block_size)

    @property
    def nblocks(self) -> torch.Tensor:
        """Number of stored blocks (0-d tensor on the matrix's device)."""
        return self.indptr[-1]

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.dtype

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    @classmethod
    def from_numpy(cls, indptr, indices, blocks, shape, device=None) -> "BSRMatrix":
        """Container from numpy arrays laid out as above (for example the
        ``np.asarray`` of each field of a JAX ``BSRMatrix``), kept as given:
        same capacity, same padding."""
        device = torch.device(device or get_config().device)
        return cls(
            indptr=torch.from_numpy(np.array(indptr, np.int32)).to(device),
            indices=torch.from_numpy(np.array(indices, np.int32)).to(device),
            blocks=torch.from_numpy(np.array(blocks)).to(device),
            shape=(int(shape[0]), int(shape[1])),
        )

    def stored(self) -> int:
        """Number of block slots that hold a block: ``nblocks``, or the
        capacity when ``indptr`` counts blocks past it (:func:`bsr_from_dense`)."""
        return min(int(self.nblocks), self.block_capacity)

    def block_rows(self) -> torch.Tensor:
        """Block-row id of every block slot; padding slots map to ``nbr``,
        the dummy block-row of the JAX kernel."""
        pos = torch.arange(self.block_capacity, device=self.device)
        rid = row_ids_from_indptr(self.indptr, self.block_capacity)
        return torch.where(pos < self.nblocks, rid, self.nbr)


def _tobsr_padded(mat, block_size: int):
    """scipy matrix -> scipy BSR with the logical shape padded to block
    multiples and sorted block indices.  The container (:func:`bsr_from_scipy`)
    and the pair planner share one result per operand, so block SLOT ids line
    up between them."""
    import scipy.sparse as sp

    if not sp.issparse(mat):
        mat = sp.csr_matrix(np.asarray(mat))
    rows, cols = map(int, mat.shape)
    b = int(block_size)
    if rows % b == 0 and cols % b == 0:
        bs = mat.tobsr(blocksize=(b, b))
    else:
        rp, cp = -(-rows // b) * b, -(-cols // b) * b
        coo = mat.tocoo()
        mat = sp.csr_matrix((coo.data, (coo.row, coo.col)), shape=(rp, cp))
        bs = mat.tobsr(blocksize=(b, b))
    bs.sort_indices()
    return bs


def bsr_from_scipy(mat, block_size: int = 128, dtype=None, block_capacity=None, padded_bsr=None,
                   device=None) -> BSRMatrix:
    """Upload any scipy sparse matrix to ``device`` as a :class:`BSRMatrix`.

    Only the live blocks cross to the device; the capacity padding is
    zero-filled there.  ``dtype`` defaults to float64, the JAX package's
    default with x64 enabled.  ``padded_bsr`` is a matching
    :func:`_tobsr_padded` result the caller already built (the BSR route
    shares it with the pair planner).
    """
    import scipy.sparse as sp

    if not sp.issparse(mat):
        mat = sp.csr_matrix(np.asarray(mat))
    rows, cols = map(int, mat.shape)
    b = int(block_size)
    bs = padded_bsr if padded_bsr is not None else _tobsr_padded(mat, b)
    nblocks = int(bs.indptr[-1])
    cap = block_capacity if block_capacity is not None else bucket_capacity(nblocks, minimum=1)
    if cap < nblocks:
        raise ValueError(f"block_capacity {cap} < nblocks {nblocks}")
    dtype = dtype or torch.float64
    device = torch.device(device or get_config().device)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    indices = torch.zeros(cap, dtype=INDEX_DTYPE, device=device)
    blocks = torch.zeros((cap, b, b), dtype=dtype, device=device)
    live_indices = np.ascontiguousarray(bs.indices[:nblocks], np.int32)
    indices[:nblocks] = torch.from_numpy(live_indices).to(device)
    live_blocks = np.ascontiguousarray(bs.data[:nblocks], np_dtype)
    blocks[:nblocks] = torch.from_numpy(live_blocks).to(device)
    return BSRMatrix(
        indptr=torch.from_numpy(np.ascontiguousarray(bs.indptr, np.int32)).to(device),
        indices=indices,
        blocks=blocks,
        shape=(rows, cols),
    )


def bsr_from_dense(dense: torch.Tensor, block_capacity: int, block_size: int = 128) -> BSRMatrix:
    """BSR of the nonzero blocks of a dense matrix (plain PyTorch), with a
    fixed block capacity: blocks past it are dropped, as in the JAX version,
    while ``indptr`` counts every nonzero block."""
    rows, cols = dense.shape
    b = int(block_size)
    nbr, nbc = -(-rows // b), -(-cols // b)
    padded = torch.zeros((nbr * b, nbc * b), dtype=dense.dtype, device=dense.device)
    padded[:rows, :cols] = dense
    tiles = padded.reshape(nbr, b, nbc, b).transpose(1, 2)  # (nbr, nbc, b, b)
    mask = (tiles != 0).any(dim=3).any(dim=2)
    indptr = torch.zeros(nbr + 1, dtype=INDEX_DTYPE, device=dense.device)
    indptr[1:] = torch.cumsum(mask.sum(dim=1), dim=0)
    pos = torch.nonzero(mask.reshape(-1)).flatten()[:block_capacity]
    kept = int(pos.shape[0])
    indices = torch.zeros(block_capacity, dtype=INDEX_DTYPE, device=dense.device)
    blocks = torch.zeros((block_capacity, b, b), dtype=dense.dtype, device=dense.device)
    indices[:kept] = (pos % nbc).to(INDEX_DTYPE)
    blocks[:kept] = tiles.reshape(nbr * nbc, b, b)[pos]
    return BSRMatrix(indptr=indptr, indices=indices, blocks=blocks, shape=(rows, cols))


def bsr_to_dense(a: BSRMatrix) -> torch.Tensor:
    """Dense ``(rows, cols)`` matrix: the stored blocks added at their places
    (plain PyTorch; padding slots are ignored)."""
    b = a.block_size
    nbr, nbc = a.nbr, a.nbc
    kept = a.stored()
    rid = a.block_rows()[:kept].long()
    out = torch.zeros((nbr, nbc, b, b), dtype=a.dtype, device=a.device)
    out.index_put_((rid, a.indices[:kept].long()), a.blocks[:kept], accumulate=True)
    dense = out.transpose(1, 2).reshape(nbr * b, nbc * b)
    return dense[: a.shape[0], : a.shape[1]]
