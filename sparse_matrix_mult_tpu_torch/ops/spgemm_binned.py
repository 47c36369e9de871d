"""Row-binned ESC: the sparse-output engine for hypersparse products.

Counterpart of :mod:`sparse_matrix_mult_tpu.ops.spgemm_binned`: the same
:class:`BinnedPlan`, the same numpy planner :func:`binned_plan` (its plans
are array-for-array the JAX planner's) and :func:`spgemm_esc_binned` with the
same arguments, whose padded CSR output has JAX's ``indptr`` and live
``indices``.

The plan cuts every B row into slices of ``window`` entries and lays the
(A entry, slice) pairs, the virtual entries, in a ``(G, P / W)`` grid whose
lane ``g`` holds whole output rows, lanes in ascending row order.  So the
partial products of a lane sort on their own, and the lanes read one after
another are sorted globally.  The engine:

1. gathers each virtual entry's slice of B and its A value and forms the
   ``(G, P)`` partial products with int64 keys ``row * cols + col`` (dead
   slots: key ``rows * cols`` and value 0);
2. sorts each lane (``torch.sort(dim=1)``, stable);
3. takes the run boundaries over the flattened lanes and sums each run with
   ``torch.segment_reduce``: deterministic, no atomics; a run may absorb the
   zero-valued dead slots at its lane's end;
4. keeps the runs' first keys in order, which is the final CSR order, and
   takes ``indptr`` by ``searchsorted`` over their rows.

The JAX engine's TPU workarounds are gone: the aligned block-pair slice
table and W-way masked shift, bit-packed values, the duplicated-pair row
gather, the shifted-add dedup network (and with it any dependence on
``dedup_span`` / ``BinnedPlan.max_run``: the segmented sum takes runs of
any length, so neither keys a specialisation here and ``dedup_span`` is
accepted and not read), the compaction sort, the lane-local binary-search
``indptr`` and the ``lax.scan`` stitch.  ``row_lane`` is accepted and not
read either: ``indptr`` comes from the compacted rows, so
:meth:`BinnedPlan.device_args` passes ``None`` in its slot.

Host syncs: none.  Every size comes from the plan and ``out_capacity``.

Device memory: the partials take ``G * P`` slots, at most about
``max_pad_ratio`` (3) times the exact expansion.  Live together at the sort:
the keys before and after it and the permutation (int64 each) and the
values before and after it (4 bytes each in f32), ~32 bytes a slot; then
the compaction's ``out_capacity``-long arrays (run offsets, first keys,
rows: int64 each), ~30 bytes an output slot.  On an H100 at 10**8 partials
(1.68e8 slots, ``out_capacity`` 2**27) the peak was 10.9 GiB, 1.8 GiB of it
the operands and the plan; at the planner's 3x padding expect ~20 GiB.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..types import CSRMatrix
from .spgemm_esc import _compress

__all__ = ["BinnedPlan", "binned_plan", "spgemm_esc_binned"]


@dataclasses.dataclass(frozen=True)
class BinnedPlan:
    """Host structure plan for :func:`spgemm_esc_binned` (numpy arrays).

    * ``slice_start``/``slice_len`` -- (S+1,) int32 positions into B's entry
      arrays; slice ``S`` is an empty dummy for dead slots.
    * ``va_slice``/``va_entry``/``va_row`` -- (G, P/W) int32 virtual-entry
      grid: slice id, A entry index, output row (dead slots: the dummy).
    * ``row_lane`` -- (n_rows,) int32 lane of each output row.
    * ``window`` (W), ``lane_width`` (P) -- the tile.
    * ``n_partials`` -- exact partial-product count; ``padded`` = G * P.
    * ``max_run`` -- bound on a duplicate (row, col) run: the largest nnz of
      an A row.  The JAX engine sizes its dedup network from it; the port's
      does not read it (see the module docstring).
    """

    slice_start: np.ndarray
    slice_len: np.ndarray
    va_slice: np.ndarray
    va_entry: np.ndarray
    va_row: np.ndarray
    row_lane: np.ndarray
    window: int
    lane_width: int
    n_partials: int
    max_run: int = 1 << 30
    # device_args' tensors by device, uploaded once per plan.
    _uploaded: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def padded(self) -> int:
        return self.va_slice.shape[0] * self.va_slice.shape[1] * self.window

    @property
    def va_start(self) -> np.ndarray:
        return self.slice_start[self.va_slice]

    @property
    def va_len(self) -> np.ndarray:
        """(G, P/W) slice length of each virtual entry."""
        return self.slice_len[self.va_slice]

    def device_args(self, device=None):
        """The positional arguments of :func:`spgemm_esc_binned` on
        ``device`` (default ``Config.device``): ``slice_start``,
        ``va_slice``, ``va_len``, ``va_entry`` and ``va_row`` as tensors
        there, and ``None`` for ``row_lane``, which the engine does not
        read.  ``va_len`` is gathered on the device from ``slice_len``, the
        shorter array.  They are made on the first call for a device and
        held by the plan, so products that reuse a plan upload it once."""
        from ..config import get_config

        device = torch.device(device or get_config().device)
        if device not in self._uploaded:
            start, slice_len, va_slice, va_entry, va_row = (
                torch.from_numpy(np.ascontiguousarray(x)).to(device)
                for x in (self.slice_start, self.slice_len, self.va_slice, self.va_entry,
                          self.va_row))
            va_len = slice_len[va_slice.long()]
            self._uploaded[device] = (start, va_slice, va_len, va_entry, va_row, None)
        return self._uploaded[device]


def binned_plan(
    a_indptr,
    a_indices,
    b_indptr,
    *,
    window: int = 8,
    lane_width: int = 4096,
    max_pad_ratio: float = 3.0,
):
    """A :class:`BinnedPlan` for ``A @ B`` from host CSR structure, or
    ``None`` when the layout degenerates: one output row's virtual entries
    overflow a lane, or the padding exceeds ``max_pad_ratio`` times the
    exact expansion.  O(nnz(A) + nnz(B)) numpy, the JAX planner's steps.
    """
    W = int(window)
    P = int(lane_width)
    Wp = P // W
    a_indptr = np.asarray(a_indptr, np.int64)
    a_indices = np.asarray(a_indices, np.int64)
    b_indptr = np.asarray(b_indptr, np.int64)
    n_rows = len(a_indptr) - 1
    a_nnz = int(a_indptr[-1])

    b_len = np.diff(b_indptr)
    nsl = -(-b_len // W)  # slices per B row
    S = int(nsl.sum())
    scum = np.concatenate([[0], np.cumsum(nsl)])

    per_entry = nsl[a_indices[:a_nnz]]
    ecum = np.concatenate([[0], np.cumsum(per_entry)])
    V = int(ecum[-1])
    n_partials = int((b_len[a_indices[:a_nnz]]).sum())
    if V == 0 or n_partials == 0:
        return None
    vrow_cum = ecum[a_indptr]  # virtual entries before each row
    vcnt = np.diff(vrow_cum)
    if int(vcnt.max()) > Wp:
        return None  # one output row overflows a lane
    # Contiguous first-fit binning, one searchsorted per lane.
    r0 = [0]
    while r0[-1] < n_rows:
        start = r0[-1]
        stop = int(np.searchsorted(vrow_cum, vrow_cum[start] + Wp, side="right") - 1)
        r0.append(min(max(stop, start + 1), n_rows))
    r0 = np.asarray(r0, np.int64)
    G = len(r0) - 1
    if G * P > max_pad_ratio * max(n_partials, 1) + P:
        return None
    row_lane = np.repeat(np.arange(G), np.diff(r0)).astype(np.int32)

    srow = np.repeat(np.arange(len(b_len)), nsl)
    within = np.arange(S) - scum[srow]
    slice_start = np.concatenate([(b_indptr[srow] + within * W), [0]]).astype(np.int32)
    slice_len = np.concatenate([np.minimum(b_len[srow] - within * W, W), [0]]).astype(np.int32)

    ve_entry = np.repeat(np.arange(a_nnz), per_entry)
    ve_within = np.arange(V) - ecum[ve_entry]
    ve_slice = scum[a_indices[ve_entry]] + ve_within
    row_of_entry = np.repeat(np.arange(n_rows), np.diff(a_indptr))
    ve_row = row_of_entry[ve_entry]

    bin_first_ve = vrow_cum[r0]
    bin_of_ve = np.searchsorted(bin_first_ve, np.arange(V), side="right") - 1
    slot = np.arange(V) - bin_first_ve[bin_of_ve]
    flat = bin_of_ve * Wp + slot

    va_slice = np.full(G * Wp, S, np.int32)
    va_entry = np.zeros(G * Wp, np.int32)
    va_row = np.zeros(G * Wp, np.int32)
    va_slice[flat] = ve_slice
    va_entry[flat] = ve_entry
    va_row[flat] = ve_row
    a_row_nnz = np.diff(a_indptr)
    return BinnedPlan(
        slice_start=slice_start,
        slice_len=slice_len,
        va_slice=va_slice.reshape(G, Wp),
        va_entry=va_entry.reshape(G, Wp),
        va_row=va_row.reshape(G, Wp),
        row_lane=row_lane,
        window=W,
        lane_width=P,
        n_partials=n_partials,
        max_run=int(a_row_nnz.max()) if len(a_row_nnz) else 1,
    )


def spgemm_esc_binned(
    a: CSRMatrix,
    b: CSRMatrix,
    slice_start: torch.Tensor,
    va_slice: torch.Tensor,
    va_len: torch.Tensor,
    va_entry: torch.Tensor,
    va_row: torch.Tensor,
    row_lane: torch.Tensor | None,
    *,
    window: int,
    out_capacity: int,
    symmetric: bool = False,
    row_offset=0,
    dedup_span: int = 0,
) -> CSRMatrix:
    """``C = A @ B`` by the row-binned pipeline (see the module docstring).

    The plan tensors are ``plan.device_args(device)`` of a plan built from
    the same host structure the operands were uploaded from (the entry
    order must match: canonical CSR, as ``from_scipy`` uploads it).
    ``va_row`` holds local rows when A is a row chunk; ``row_offset`` keeps
    the symmetric filter global.  Entries past ``out_capacity`` are dropped.
    ``row_lane`` and ``dedup_span`` are not read.
    """
    rows, cols = a.shape[0], b.shape[1]
    W = int(window)
    G, Wp = va_slice.shape
    P = Wp * W
    dev = a.device
    space = rows * cols
    wr = torch.arange(W, device=dev)
    pos = slice_start[va_slice.long()].long()[..., None] + wr  # (G, Wp, W)
    valid = wr < va_len[..., None]
    pos = torch.where(valid, pos, 0)
    k = b.indices[pos].long()
    i = va_row.long()[..., None]
    if symmetric:
        valid &= k >= i + row_offset
    vals = a.values[va_entry.long()][..., None] * b.values[pos]
    del pos
    zero = torch.zeros((), dtype=vals.dtype, device=dev)
    vals = torch.where(valid, vals, zero).reshape(G, P)
    keys = torch.where(valid, i * cols + k, space).reshape(G, P)
    del valid, k, i
    keys, perm = torch.sort(keys, dim=1, stable=True)
    vals = torch.gather(vals, 1, perm)
    del perm
    indptr, indices, values = _compress(keys.reshape(-1), vals.reshape(-1), rows, cols,
                                        out_capacity)
    return CSRMatrix(indptr=indptr, indices=indices, values=values, shape=(rows, cols))
