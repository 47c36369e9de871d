"""Work partitioning across the slots of a row mesh.

Counterpart of :mod:`sparse_matrix_mult_tpu.parallel.partition` (numpy, a
copy of its functions): contiguous equal-count row ranges, and row ranges
balanced by flops (the partial products each row contributes), which keep
skewed matrices from loading one slot with most of the work.
"""

from __future__ import annotations

import numpy as np

from ..utils.native import row_flops as _native_row_flops

__all__ = ["equal_rows_partition", "flop_balanced_partition", "row_flops"]


def equal_rows_partition(rows: int, parts: int) -> np.ndarray:
    """Contiguous equal-count row ranges, the remainder spread one per part;
    ``parts`` is clamped to ``rows``.  Returns ``(parts + 1,)`` boundaries."""
    parts = max(1, min(parts, rows)) if rows > 0 else 1
    base, rem = divmod(rows, parts)
    sizes = np.full(parts, base, dtype=np.int64)
    sizes[:rem] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


def row_flops(a_indptr, a_indices, b_indptr) -> np.ndarray:
    """Partial products contributed by each row of A (host; the native
    library when present, numpy otherwise)."""
    return _native_row_flops(a_indptr, a_indices, b_indptr)


def flop_balanced_partition(flops: np.ndarray, parts: int) -> np.ndarray:
    """Contiguous row ranges with near-equal total flops: boundary ``i`` is
    placed where the cumulative flops cross ``i / parts`` of the total.
    Returns ``(min(parts, rows) + 1,)`` boundaries."""
    rows = len(flops)
    if rows == 0 or parts <= 1:
        return np.array([0, rows], dtype=np.int64)
    parts = min(parts, rows)
    csum = np.cumsum(np.maximum(np.asarray(flops, dtype=np.float64), 1e-9))
    targets = csum[-1] * np.arange(1, parts) / parts
    cuts = np.searchsorted(csum, targets, side="left") + 1
    bounds = np.concatenate([[0], cuts, [rows]])
    # Degenerate flop profiles can collapse cuts: keep the bounds monotone.
    return np.maximum.accumulate(np.minimum(bounds, rows)).astype(np.int64)
