"""The plain products that answers are held to, and their controls.

``F64`` computes in float64 from the operands' stored values: cuBLAS's
DGEMM for products whose partial products outnumber the output's
entries, else a sort-based expansion (one partial per pair of entries,
summed by output position).  ``BF16`` is the control: the operands'
values rounded to bfloat16 and multiplied in float32 with TF32 off (what
one bf16 tensor-core pass gives), each intermediate product rounded to
bfloat16 again.  Both run in blocks of rows, so a product larger than
the card still fits.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..operands import Csr

F64, BF16 = "f64", "bf16"
DENSE_BLOCK_ELEMENTS = 1 << 27   # a dense block of the product: 1 GiB in float64
ESC_BLOCK_PARTIALS = 1 << 26     # partial products expanded at once


@contextlib.contextmanager
def _no_tf32():
    """Float32 products in full FP32 inside the block."""
    mm = torch.backends.cuda.matmul
    new_api = hasattr(mm, "fp32_precision")
    prev = mm.fp32_precision if new_api else mm.allow_tf32
    if new_api:
        mm.fp32_precision = "ieee"
    else:
        mm.allow_tf32 = False
    try:
        yield
    finally:
        if new_api:
            mm.fp32_precision = prev
        else:
            mm.allow_tf32 = prev


def _dtype(precision: str) -> torch.dtype:
    if precision not in (F64, BF16):
        raise ValueError(f"unknown precision {precision!r}")
    return torch.float64 if precision == F64 else torch.float32


def _cast(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == F64:
        return x.to(torch.float64)
    return x.to(torch.bfloat16).to(torch.float32)


def row_ids(indptr: torch.Tensor) -> torch.Tensor:
    rows = indptr.numel() - 1
    return torch.repeat_interleave(torch.arange(rows, device=indptr.device), torch.diff(indptr))


def partials(a: Csr, b: Csr) -> int:
    """Partial products of A B: each entry (i, k) of A times row k of B."""
    return int(torch.diff(b.indptr)[a.indices].sum())


def dense(m: Csr, precision: str, rows: slice | None = None) -> torch.Tensor:
    """Rows ``rows`` (all by default) of ``m`` as a dense matrix."""
    r0, r1 = (0, m.shape[0]) if rows is None else (rows.start, rows.stop)
    e0, e1 = int(m.indptr[r0]), int(m.indptr[r1])
    out = torch.zeros(r1 - r0, m.shape[1], dtype=_dtype(precision), device=m.values.device)
    local = row_ids(m.indptr[r0:r1 + 1] - e0)
    out[local, m.indices[e0:e1]] = _cast(m.values[e0:e1], precision)
    return out


def _dense_to_csr(c: torch.Tensor, shape) -> Csr:
    nonzero = c != 0
    indptr = torch.zeros(c.shape[0] + 1, dtype=torch.int64, device=c.device)
    indptr[1:] = torch.cumsum(nonzero.sum(1), 0)
    return Csr(indptr, nonzero.nonzero()[:, 1], c[nonzero], shape)


def _dense_blocks(a: Csr, b: Csr, upper: bool, precision: str):
    m, n = a.shape[0], b.shape[1]
    bd = dense(b, precision)
    step = max(1, DENSE_BLOCK_ELEMENTS // max(n, a.shape[1]))
    for r0 in range(0, m, step):
        r1 = min(m, r0 + step)
        with _no_tf32():
            c = dense(a, precision, slice(r0, r1)) @ bd
        if upper:
            c = torch.triu(c, diagonal=r0)
        yield r0, r1, _dense_to_csr(c, (r1 - r0, n))


def _esc_block(a: Csr, b: Csr, r0: int, r1: int, upper: bool, precision: str) -> Csr:
    """Rows r0..r1 of A B: every partial product expanded, summed by position."""
    n, device = b.shape[1], a.values.device
    e0, e1 = int(a.indptr[r0]), int(a.indptr[r1])
    a_rows = row_ids(a.indptr[r0:r1 + 1] - e0) + r0
    a_cols = a.indices[e0:e1]
    b_len = torch.diff(b.indptr)[a_cols]
    owner = torch.repeat_interleave(torch.arange(e1 - e0, device=device), b_len)
    first = torch.cumsum(b_len, 0) - b_len
    b_pos = b.indptr[a_cols][owner] + torch.arange(owner.numel(), device=device) - first[owner]
    rows, cols = a_rows[owner], b.indices[b_pos]
    vals = _cast(a.values[e0:e1], precision)[owner] * _cast(b.values, precision)[b_pos]
    if upper:
        keep = cols >= rows
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    keys, where = torch.unique((rows - r0) * n + cols, return_inverse=True)
    sums = torch.zeros(keys.numel(), dtype=vals.dtype, device=device).index_add_(0, where, vals)
    indptr = torch.zeros(r1 - r0 + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(torch.bincount(keys // n, minlength=r1 - r0), 0)
    return Csr(indptr, keys % n, sums, (r1 - r0, n))


def _esc_blocks(a: Csr, b: Csr, upper: bool, precision: str):
    m = a.shape[0]
    per_row = torch.zeros(m, dtype=torch.int64, device=a.values.device)
    per_row.index_add_(0, row_ids(a.indptr), torch.diff(b.indptr)[a.indices])
    ends = np.cumsum(per_row.cpu().numpy())
    r0 = 0
    while r0 < m:
        done = ends[r0 - 1] if r0 else 0
        r1 = max(r0 + 1, int(np.searchsorted(ends, done + ESC_BLOCK_PARTIALS, side="right")))
        r1 = min(r1, m)
        yield r0, r1, _esc_block(a, b, r0, r1, upper, precision)
        r0 = r1


def product_blocks(a: Csr, b: Csr, upper: bool = False, precision: str = F64):
    """A B (its upper triangle where ``upper``) in blocks of rows: yields
    (r0, r1, the block's :class:`Csr`, its ``indptr`` counted from 0)."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {a.shape} and {b.shape} do not multiply")
    _dtype(precision)
    if partials(a, b) >= a.shape[0] * b.shape[1]:
        return _dense_blocks(a, b, upper, precision)
    return _esc_blocks(a, b, upper, precision)


def product(a: Csr, b: Csr, upper: bool = False, precision: str = F64) -> Csr:
    """A B (its upper triangle where ``upper``) in one :class:`Csr`."""
    parts = list(product_blocks(a, b, upper, precision))
    indptr, offset = [torch.zeros(1, dtype=torch.int64, device=a.values.device)], 0
    for _, _, blk in parts:
        indptr.append(blk.indptr[1:] + offset)
        offset += blk.indices.numel()
    return Csr(torch.cat(indptr), torch.cat([blk.indices for _, _, blk in parts]),
               torch.cat([blk.values for _, _, blk in parts]), (a.shape[0], b.shape[1]))


def triple(h: Csr, q: Csr, full: bool, precision: str = F64) -> torch.Tensor:
    """H Q H^T, dense: its upper triangle, mirrored into the lower where ``full``."""
    hd, qd = dense(h, precision), dense(q, precision)
    with _no_tf32():
        t = hd @ qd
        if precision == BF16:
            t = _cast(t, BF16)
        c = t @ hd.T
    upper = torch.triu(c)
    return upper + torch.triu(c, 1).T if full else upper
