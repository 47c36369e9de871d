"""Expansion-sort-compress SpGEMM: the classic and windowed ESC engines.

Counterpart of :mod:`sparse_matrix_mult_tpu.ops.spgemm_jnp`, with its
functions, signatures and output contract: a padded :class:`CSRMatrix`
with sorted columns and Gustavson structure (an entry whose partial
products sum to exactly zero is kept), static ``expand_capacity``,
``tail_capacity`` and ``out_capacity``, and ``row_offset`` keeping the
symmetric filter global when A is a row chunk.  Both engines replace the
reference's Gustavson hot loop (its ``src/sparsework.cpp:56-129``).

The JAX module is shaped around a TPU: forward fills by ``cummax`` instead
of per-partial gathers, bit-packed row gathers, an ELLPACK window table, a
shifted-add dedup network with a ``lax.cond`` long-run fallback and a second
compaction sort, and int32 two-key sorts where ``rows * cols`` passes 2**31.
A GPU gathers elements cheaply and sorts 64-bit keys by radix, so here:

1. *expand* -- ``repeat_interleave`` gives each partial its A entry; two
   gathers give its B column and value; the key is the int64
   ``row * cols + col`` (no int32 limit on the output space);
2. *sort* -- one stable ``torch.sort`` of the keys;
3. *compress* -- run starts found by ``searchsorted`` over the running count
   of run boundaries, each run summed by ``torch.segment_reduce`` (a
   deterministic segmented sum: no atomics, so two identical calls give
   the same bits), then ``indptr`` by ``searchsorted`` over the output rows.

``spgemm_esc_windowed`` computes the same partial products as
``spgemm_esc`` and shares its expansion: the window only sizes the
``tail_capacity`` contract, which is checked, never trusted (R6 in
``ROADMAP.md``: the JAX engine drops partials past an undersized tail).

Host syncs: each engine call makes one (the live-entry, partial and tail
counts, fetched together), which sizes the expansion exactly and checks the
capacities.  ``esc_sort_compress`` makes none.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import CSRMatrix, INDEX_DTYPE
from ..utils.native import expansion_size

__all__ = [
    "spgemm_esc",
    "spgemm_esc_windowed",
    "precompute_window_table",
    "windowed_plan",
    "esc_sort_compress",
    "expansion_size",
]

_INT32_MAX = int(np.iinfo(np.int32).max)


def _row_ids(indptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """int64 row of each of the first ``nnz`` entries."""
    rows = indptr.shape[0] - 1
    counts = (indptr[1:] - indptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(rows, device=indptr.device), counts, output_size=nnz)


def _b_rows(b: CSRMatrix):
    """(start, length) of every row of B, int64."""
    ptr = b.indptr.long()
    return ptr[:-1], ptr[1:] - ptr[:-1]


def _expand(a: CSRMatrix, b_start, b_len, b: CSRMatrix, *, symmetric: bool, row_offset,
            window: int = 0, tail_capacity: int = 0, expand_capacity: int):
    """Every partial product of ``a @ b`` as (int64 key, value); partials the
    symmetric filter drops are dead: key ``rows * cols``, value 0.  Raises
    ``ValueError`` when ``expand_capacity`` (or, with ``window``,
    ``tail_capacity``) is smaller than the partials it must hold."""
    rows, cols = a.shape[0], b.shape[1]
    dev = a.device
    a_cols = a.indices.long()
    live = torch.arange(a.capacity, device=dev) < a.nnz
    lens = torch.where(live, b_len[a_cols], 0)
    counts = [lens.sum()]
    if window:
        counts.append((lens - window).clamp_min(0).sum())
    nnz, total, *tail = torch.stack([a.nnz.long(), *counts]).tolist()  # the one host sync
    if total > expand_capacity:
        raise ValueError(
            f"expand_capacity {expand_capacity} < {total} partial products: size it with "
            "expansion_size()")
    if window and tail[0] > tail_capacity:
        raise ValueError(
            f"tail_capacity {tail_capacity} < {tail[0]} partial products past window {window}: "
            "size window and tail_capacity with windowed_plan()")
    src = torch.repeat_interleave(torch.arange(a.capacity, device=dev), lens, output_size=total)
    within = torch.arange(total, device=dev) - (torch.cumsum(lens, 0) - lens)[src]
    b_pos = b_start[a_cols][src] + within
    del within
    i = _row_ids(a.indptr, nnz)[src]
    k = b.indices[b_pos].long()
    v = a.values[src] * b.values[b_pos]
    del src, b_pos
    key = i * cols + k
    if symmetric:
        keep = k >= i + row_offset
        key = torch.where(keep, key, rows * cols)
        v = torch.where(keep, v, torch.zeros((), dtype=v.dtype, device=dev))
    return key, v


def _compress(key_sorted, v_sorted, n_rows: int, n_cols: int, out_capacity: int):
    """Packed CSR of sorted partials: runs of equal keys summed in order.
    Keys at or above ``n_rows * n_cols`` are dead and carry the value 0, so
    the run before them may absorb them without changing its sum."""
    dev = key_sorted.device
    E = key_sorted.shape[0]
    oc = int(out_capacity)
    space = n_rows * n_cols
    live = key_sorted < space
    boundary = live.clone()
    boundary[1:] &= key_sorted[1:] != key_sorted[:-1]
    runs = torch.cumsum(boundary, 0)
    n_runs = runs[-1]
    # offsets[r]: where run r starts; every run past the last ends the data.
    offsets = torch.searchsorted(runs, torch.arange(1, oc + 2, device=dev))
    # Data of two dimensions takes segment_reduce's one-thread-per-run kernel;
    # 1-D data takes a segmented reduction with one CTA per run, which cost
    # ~1 ns a run on an H100, most of the engine's time.
    values = torch.segment_reduce(v_sorted[:, None], "sum", offsets=offsets, unsafe=True,
                                  axis=0)[:, 0]
    slot_live = torch.arange(oc, device=dev) < n_runs
    first = torch.where(slot_live, key_sorted[offsets[:oc].clamp_max(max(E - 1, 0))], 0)
    rows_out = torch.where(slot_live, first // n_cols, n_rows)
    indptr = torch.searchsorted(rows_out, torch.arange(n_rows + 1, device=dev))
    indices = torch.where(slot_live, first % n_cols, 0).to(INDEX_DTYPE)
    values = torch.where(slot_live, values, torch.zeros((), dtype=values.dtype, device=dev))
    return indptr.to(INDEX_DTYPE), indices, values


def _empty(n_rows: int, out_capacity: int, dtype, device):
    return (torch.zeros(n_rows + 1, dtype=INDEX_DTYPE, device=device),
            torch.zeros(out_capacity, dtype=INDEX_DTYPE, device=device),
            torch.zeros(out_capacity, dtype=dtype, device=device))


def esc_sort_compress(
    i_key,
    k_key: torch.Tensor,
    v: torch.Tensor,
    *,
    n_rows: int,
    n_cols: int,
    out_capacity: int,
    live_capacity: int | None = None,
):
    """Sort partial products by (row, col) and sum the duplicates into
    packed CSR arrays ``(indptr, indices, values)``.

    As in JAX, dead slots carry the int32 maximum in both ``i_key`` and
    ``k_key``; a caller holding the fused key ``i * n_cols + k`` passes it as
    ``k_key`` with ``i_key=None`` (here int64, dead at ``n_rows * n_cols`` or
    above, which covers JAX's int32 maximum wherever JAX fuses).
    ``live_capacity`` keeps, as in JAX, only that many slots after the sort.
    Entries past ``out_capacity`` are dropped; ``indptr`` counts those kept.
    No host sync.
    """
    space = n_rows * n_cols
    if i_key is None:
        key = k_key.long()
    else:
        i_key, k_key = i_key.long(), k_key.long()
        key = torch.where(i_key != _INT32_MAX, i_key * n_cols + k_key, space)
    live = key < space
    key = torch.where(live, key, space)
    v = torch.where(live, v, torch.zeros((), dtype=v.dtype, device=v.device))
    return _sort_compress(key, v, n_rows, n_cols, out_capacity, live_capacity)


def _sort_compress(key, v, n_rows: int, n_cols: int, out_capacity: int,
                   live_capacity: int | None = None):
    """:func:`esc_sort_compress` of int64 keys already dead at ``n_rows *
    n_cols`` with value 0 (what :func:`_expand` gives)."""
    if key.shape[0] == 0:
        return _empty(n_rows, out_capacity, v.dtype, v.device)
    key_sorted, perm = torch.sort(key, stable=True)
    v_sorted = v[perm]
    if live_capacity is not None and live_capacity < key.shape[0]:
        key_sorted, v_sorted = key_sorted[:live_capacity], v_sorted[:live_capacity]
    return _compress(key_sorted, v_sorted, n_rows, n_cols, out_capacity)


def _esc(a: CSRMatrix, b: CSRMatrix, b_start, b_len, *, out_capacity: int, symmetric: bool,
         row_offset, **expand_kw) -> CSRMatrix:
    rows, cols = a.shape[0], b.shape[1]
    key, v = _expand(a, b_start, b_len, b, symmetric=symmetric, row_offset=row_offset,
                     **expand_kw)
    indptr, indices, values = _sort_compress(key, v, rows, cols, out_capacity)
    return CSRMatrix(indptr=indptr, indices=indices, values=values, shape=(rows, cols))


def spgemm_esc(
    a: CSRMatrix,
    b: CSRMatrix,
    *,
    expand_capacity: int,
    out_capacity: int,
    symmetric: bool = False,
    row_offset=0,
) -> CSRMatrix:
    """``C = A @ B`` in padded CSR by expand-sort-compress.

    With ``symmetric=True`` only upper-triangle entries (``col >= row +
    row_offset``) are kept, ``sparsework_sym``'s filter
    (the reference's ``src/sparsework.cpp:217``); ``row_offset`` is the
    global row of A's first row.  ``expand_capacity`` must hold every partial
    product (``ValueError`` otherwise: no partial is dropped); entries past
    ``out_capacity`` are dropped.  One host sync.
    """
    b_start, b_len = _b_rows(b)
    return _esc(a, b, b_start, b_len, out_capacity=out_capacity, symmetric=symmetric,
                row_offset=row_offset, expand_capacity=int(expand_capacity))


def precompute_window_table(b: CSRMatrix, window: int) -> torch.Tensor:
    """What :func:`spgemm_esc_windowed` reuses across calls with one B: a
    ``(K, 2)`` int64 table ``[row start | row length]`` of B's rows.

    The JAX table is the ``(K, 2 + 2W)`` bit-packed ELLPACK window of B's
    values (f32 only); the port's engine gathers B's entries directly, so its
    table holds the row bounds only and takes any value type.  ``window``
    is kept for the signature.
    """
    if int(window) <= 0:
        raise ValueError(f"window must be positive, got {window}")
    b_start, b_len = _b_rows(b)
    return torch.stack([b_start, b_len], dim=1)


def spgemm_esc_windowed(
    a: CSRMatrix,
    b: CSRMatrix,
    *,
    window: int,
    expand_capacity: int,
    tail_capacity: int,
    out_capacity: int,
    symmetric: bool = False,
    row_offset=0,
    b_table: torch.Tensor | None = None,
) -> CSRMatrix:
    """ESC with a window: the counterpart of the JAX hypersparse engine.

    The JAX engine expands B's first ``window`` entries per row from an
    ELLPACK table and spills longer rows into a tail of ``tail_capacity``
    partials.  Here the expansion is :func:`spgemm_esc`'s (the same partial
    products), so the output equals the JAX engine's on correctly sized
    inputs.  The capacities are checked: a ``tail_capacity`` below the
    partials past the window (``windowed_plan`` sizes it), or an
    ``expand_capacity`` below all of them, raises ``ValueError`` where the
    JAX engine silently drops partials.  ``b_table`` is
    :func:`precompute_window_table`'s.  One host sync.
    """
    W = int(window)
    if W <= 0:
        raise ValueError(f"window must be positive, got {window}")
    kdim = b.shape[0]
    if b_table is not None:
        if tuple(b_table.shape) != (kdim, 2):
            raise ValueError(
                f"b_table shape {tuple(b_table.shape)} != ({kdim}, 2); build it with "
                f"precompute_window_table(b, window={W})")
        b_start, b_len = b_table[:, 0], b_table[:, 1]
    else:
        b_start, b_len = _b_rows(b)
    return _esc(a, b, b_start, b_len, out_capacity=out_capacity, symmetric=symmetric,
                row_offset=row_offset, expand_capacity=int(expand_capacity), window=W,
                tail_capacity=int(tail_capacity))


def windowed_plan(a_nnz: int, b_referenced_lens, expand: int):
    """Host planner for :func:`spgemm_esc_windowed` (numpy, JAX's as is).

    ``b_referenced_lens``: nnz of the B row each A entry references
    (``diff(b.indptr)[a.indices]``).  Returns ``(window, tail)``, the
    smallest window in {4, ..., 64} whose padded volume ``a_nnz * W + tail``
    stays under ~2.5x the exact expansion with at most a quarter of it in the
    tail, or ``None`` when no window qualifies (B rows too long).
    """
    if expand <= 0 or a_nnz == 0:
        return None
    for w in (4, 8, 16, 32, 64):
        tail = int(np.maximum(b_referenced_lens - w, 0).sum())
        padded = a_nnz * w + tail
        if padded <= max(2.5 * expand, expand + 4096) and tail <= expand // 4:
            return w, tail
    return None
