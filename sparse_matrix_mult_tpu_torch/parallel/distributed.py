"""Multi-device SpGEMM: row-sharded CSR operands, rings of B blocks over a row mesh.

Counterpart of :mod:`sparse_matrix_mult_tpu.parallel.distributed`, with its
functions, arguments, defaults and ``ValueError``s:

* **A and C are row-sharded** (:class:`ShardedCSR`): each slot of a
  :class:`~.mesh.RowMesh` owns a contiguous block of rows, uniform or
  flop-balanced (:func:`flop_shard_bounds`).
* **B is row-sharded along the contraction** and travels a bidirectional
  ring: ``ceil(S / 2)`` steps, each contracting one clockwise and one
  counter-clockwise block (the last counter-clockwise step of an odd ring
  skipped), with step ``t + 1``'s transfers started before step ``t``'s
  contraction (:func:`~.mesh.ring_shift`).  ``comm=False`` / ``_comm=False``
  keep every block where it is: the compute-only twin.
* **Densification happens per slot**: no slot holds a full dense A or B.
  ``_local_dense`` densifies through K3 and the CSR ring extracts through
  K4 (:mod:`..ops.convert`), so on the card those hand kernels run at the
  per-slot panel shapes.  The panel products go to
  :func:`..ops.matmul.policy_matmul`, which runs JAX's
  ``jnp.dot(precision="highest")`` on the card as the six-pass bf16 GEMM
  ``matmul_full`` on the tensor cores (f64 ``torch.matmul`` on the CPU).

Where the JAX module runs ``shard_map`` bodies in parallel, the port loops
over the slots this process owns.  Each function is called by every process
of a multi-process mesh, as in JAX; a slot another rank owns holds ``None``.

The sparse local contraction (:func:`spgemm_csr_distributed_sparse`) keeps
JAX's capacities and its cumulative-offset partials buffer but expands in
PyTorch's idiom (``repeat_interleave``, gathers, int64 ``row * n + col``
keys; no cummax forward fill, no bit packing) and compresses with
:func:`..ops.spgemm_esc.esc_sort_compress`.  An undersized
``expand_step_capacity`` or ``partials_capacity`` raises ``ValueError``
(one host sync after the ring), where JAX drops partials (R7 in
``ROADMAP.md``).  The sparse triple product sums each step's partials by
sort and segmented sum and writes each key of the dense C panel once: no
atomics, so two identical calls give the same bits.

Values are float32 on CUDA slots (the contraction runs ``matmul_full``;
float64 under ``Precision.STRICT`` or ``SPLIT``) and float64 on the CPU, where the
tests hold the port against JAX to 1e-12.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import Precision, get_config
from ..ops.convert import csr_to_dense, dense_to_csr
from ..ops.matmul import policy_matmul
from ..ops.spgemm_esc import esc_sort_compress
from ..types import CSRMatrix, INDEX_DTYPE, bucket_capacity, to_scipy
from ..utils.native import stitch_csr
from ..utils.transfer import fetch_np, fine_capacity
from .mesh import RowMesh, reduce_max, ring_shift, row_mesh
from .partition import flop_balanced_partition, row_flops

__all__ = [
    "ShardedCSR",
    "ShardedDense",
    "shard_csr",
    "flop_shard_bounds",
    "ring_matmul",
    "spgemm_dense_distributed",
    "spgemm_csr_distributed",
    "spgemm_csr_distributed_sparse",
    "triple_product_distributed",
    "triple_product_distributed_sparse",
    "pad_to_multiple",
]


def pad_to_multiple(x: torch.Tensor, axis: int, multiple: int) -> torch.Tensor:
    """Zero-pad ``x`` along ``axis`` up to the next multiple."""
    size = x.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return x
    shape = list(x.shape)
    shape[axis] = target
    out = x.new_zeros(shape)
    out.narrow(axis, 0, size).copy_(x)
    return out


# ---------------------------------------------------------------------------
# Row-sharded containers.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedCSR:
    """Row-sharded CSR matrix: one padded CSR block per slot, on its device.

    Slot ``s`` holds global rows ``bounds[s]:bounds[s + 1]`` with row
    pointers rebased to 0:

    * ``indptrs`` -- per slot, ``(rows_pad + 1,)`` int32; rows past the
      slot's own repeat the last pointer;
    * ``indices`` / ``values`` -- per slot, ``(shard_capacity,)``, padded;
    * ``None`` in each for a slot another rank owns;
    * ``shape`` -- the global shape; ``bounds`` -- global row boundaries
      (``None``: uniform ``ceil(m / S)`` blocks); ``mesh`` -- the mesh the
      blocks were placed on.
    """

    indptrs: tuple
    indices: tuple
    values: tuple
    shape: tuple
    bounds: tuple | None = None
    mesh: RowMesh | None = dataclasses.field(default=None, compare=False, repr=False)

    def _first(self, field: tuple) -> torch.Tensor:
        return next(t for t in field if t is not None)

    @property
    def n_shards(self) -> int:
        return len(self.indptrs)

    @property
    def rows_pad(self) -> int:
        return int(self._first(self.indptrs).shape[0]) - 1

    @property
    def shard_capacity(self) -> int:
        return int(self._first(self.indices).shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self._first(self.values).dtype

    @property
    def row_bounds(self) -> tuple:
        if self.bounds is not None:
            return self.bounds
        m, per = self.shape[0], self.rows_pad
        return tuple(min(i * per, m) for i in range(self.n_shards + 1))

    def local_shards(self) -> dict:
        """``{slot: (indptr, indices, values)}`` of the slots this process
        holds (the counterpart of ``addressable_shards``)."""
        return {s: (ip, self.indices[s], self.values[s])
                for s, ip in enumerate(self.indptrs) if ip is not None}

    def to_scipy(self):
        """Download every shard and stitch them into one scipy CSR on the
        host; ``ValueError`` when a shard lies with another process."""
        import scipy.sparse as sp

        if any(ip is None for ip in self.indptrs):
            raise ValueError("to_scipy needs every shard: some lie with another process")
        m, ncols = self.shape
        bounds = self.row_bounds
        chunks = []
        for s in range(self.n_shards):
            rows_here = bounds[s + 1] - bounds[s]
            ip = fetch_np(self.indptrs[s][: rows_here + 1])
            nnz = int(ip[-1]) if rows_here else 0
            chunks.append(sp.csr_matrix(
                (fetch_np(self.values[s][:nnz]), fetch_np(self.indices[s][:nnz]), ip),
                shape=(rows_here, ncols)))
        return stitch_csr(chunks, m, ncols)


@dataclasses.dataclass(frozen=True)
class ShardedDense:
    """Row-sharded dense result: per slot its ``(bounds[s+1] - bounds[s], n)``
    panel on its device (``None`` where another rank owns the slot), the
    counterpart of a row-sharded ``jax.Array``.  ``np.asarray`` stitches the
    panels on the host."""

    panels: tuple
    shape: tuple
    bounds: tuple

    @property
    def n_shards(self) -> int:
        return len(self.panels)

    def local_shards(self) -> dict:
        """``{slot: panel}`` of the slots this process holds."""
        return {s: p for s, p in enumerate(self.panels) if p is not None}

    def __array__(self, dtype=None, copy=None):
        if any(p is None for p in self.panels):
            raise ValueError("np.asarray needs every panel: some lie with another process")
        out = np.concatenate([fetch_np(p) for p in self.panels], axis=0)
        out = out.reshape(self.shape)
        return out if dtype is None else out.astype(dtype)


def _uniform_bounds(m: int, s: int) -> tuple:
    per = -(-m // s) if m else 1
    return tuple(min(i * per, m) for i in range(s + 1))


def _pad_bounds(bounds, m: int, s: int) -> tuple:
    """Flop-balanced bounds padded to ``s + 1`` entries (with fewer rows than
    slots, the trailing shards exist and are empty)."""
    bounds = tuple(int(b) for b in bounds)
    if len(bounds) < s + 1:
        bounds = bounds + (m,) * (s + 1 - len(bounds))
    return bounds


def _as_scipy(mat):
    """Host CSR of any operand; non-canonical CSR (unsorted or duplicate
    entries, which K3 does not take) is canonicalised on a copy."""
    import scipy.sparse as sp

    if isinstance(mat, ShardedCSR):
        return mat.to_scipy()
    if isinstance(mat, CSRMatrix):
        return to_scipy(mat)
    if not sp.issparse(mat):
        return sp.csr_matrix(np.asarray(mat))
    mat = mat.tocsr()
    if not mat.has_canonical_format:
        mat = mat.copy()
        mat.sum_duplicates()
    return mat


def _value_dtype(mesh: RowMesh) -> torch.dtype:
    """float32 on CUDA slots (FAST: full-FP32 contraction), float64 on the
    CPU and under ``Precision.STRICT`` / ``SPLIT``."""
    cuda = all(dev.type == "cuda" for dev in mesh.devices)
    if cuda and get_config().precision not in (Precision.STRICT, Precision.SPLIT):
        return torch.float32
    return torch.float64


def _place_shard(indptr, indices, values, rows_pad: int, cap: int, dtype, device):
    """One slot's padded block on ``device`` from its rebased host arrays
    (``indptr`` of the slot's own rows, starting at 0); only the live
    entries cross to the device."""
    nnz = int(indptr[-1])
    ip = np.full(rows_pad + 1, nnz, np.int32)
    ip[: len(indptr)] = indptr
    ix = torch.zeros(cap, dtype=INDEX_DTYPE, device=device)
    vv = torch.zeros(cap, dtype=dtype, device=device)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    ix[:nnz] = torch.from_numpy(np.ascontiguousarray(indices[:nnz], np.int32)).to(device)
    vv[:nnz] = torch.from_numpy(np.ascontiguousarray(values[:nnz], np_dtype)).to(device)
    return torch.from_numpy(ip).to(device), ix, vv


def shard_csr(mat, mesh: Optional[RowMesh] = None, *, bounds=None, dtype=None,
              capacity: int | None = None) -> ShardedCSR:
    """Split a host CSR matrix into per-slot row blocks and place them.

    A process builds and uploads only the blocks of the slots it owns (the
    counterpart of JAX's placement callbacks).  ``bounds`` defaults to
    uniform ``ceil(m / S)`` blocks; pass :func:`flop_shard_bounds`' for
    flop-balanced ones.  ``capacity`` (default: the bucketed largest shard
    nnz) is every shard's entry capacity.
    """
    mesh = mesh or row_mesh()
    s_count = mesh.size
    mat = _as_scipy(mat)
    m, n = (int(x) for x in mat.shape)
    if bounds is None:
        bounds = _uniform_bounds(m, s_count)
    bounds = tuple(int(b) for b in bounds)
    if len(bounds) != s_count + 1 or bounds[0] != 0 or bounds[-1] != m:
        raise ValueError(f"bounds {bounds} invalid for {m} rows / {s_count} shards")
    rows_pad = max(max(b1 - b0 for b0, b1 in zip(bounds[:-1], bounds[1:])), 1)
    shard_nnz = [int(mat.indptr[b1] - mat.indptr[b0]) for b0, b1 in zip(bounds[:-1], bounds[1:])]
    cap = int(capacity) if capacity is not None else bucket_capacity(max(shard_nnz + [1]))
    if cap < max(shard_nnz):
        raise ValueError(f"capacity {cap} < max shard nnz {max(shard_nnz)}")
    dtype = dtype or _value_dtype(mesh)
    fields = ([None] * s_count, [None] * s_count, [None] * s_count)
    for s in mesh.local_slots():
        _note_materialized(s)
        b0, b1 = bounds[s], bounds[s + 1]
        lo, hi = int(mat.indptr[b0]), int(mat.indptr[b1])
        block = _place_shard(np.asarray(mat.indptr[b0: b1 + 1], np.int64) - lo,
                             mat.indices[lo:hi], mat.data[lo:hi], rows_pad, cap, dtype,
                             mesh.slots[s][0])
        for field, t in zip(fields, block):
            field[s] = t
    return ShardedCSR(*(tuple(f) for f in fields), (m, n), bounds, mesh)


# The per-process data-locality contract: with TRACK_MATERIALIZATION on,
# every shard index shard_csr builds in THIS process is appended (the tests
# assert that a process touches only its own shards).  Off by default.
TRACK_MATERIALIZATION: bool = False
MATERIALIZED_SHARDS: list = []


def _note_materialized(s: int) -> None:
    if TRACK_MATERIALIZATION:
        MATERIALIZED_SHARDS.append(int(s))


def flop_shard_bounds(a_sp, b_sp, n_shards: int) -> tuple:
    """Flop-balanced shard boundaries for ``A @ B`` (host): each shard gets
    a near-equal count of partial products instead of of rows."""
    a_sp = _as_scipy(a_sp)
    if isinstance(b_sp, ShardedCSR):
        b_indptr = _sharded_global_indptr(b_sp)
    else:
        b_indptr = _as_scipy(b_sp).indptr
    flops = row_flops(a_sp.indptr, a_sp.indices, b_indptr)
    return _pad_bounds(flop_balanced_partition(flops, n_shards), a_sp.shape[0], n_shards)


# ---------------------------------------------------------------------------
# The ring core and the dense-panel rings.
# ---------------------------------------------------------------------------


def _local_dense(ip, ix, vv, rows: int, cols: int, dtype=None) -> torch.Tensor:
    """One slot's padded CSR block densified (K3 on the card)."""
    csr = CSRMatrix(indptr=ip[: rows + 1], indices=ix, values=vv, shape=(rows, cols))
    return csr_to_dense(csr, dtype=dtype)


def _contract(a_blk, b_blk, out_dtype) -> torch.Tensor:
    prec = Precision.STRICT if out_dtype == torch.float64 else Precision.FAST
    return policy_matmul(a_blk, b_blk, prec, out_dtype)


class _Here:
    """The transfer of the compute-only twin: every block stays put."""

    def __init__(self, blocks):
        self._blocks = blocks

    def wait(self):
        return self._blocks


def _shift(mesh, blocks, shift: int, channel: int, comm: bool):
    return ring_shift(mesh, blocks, shift, channel) if comm else _Here(blocks)


def _bidirectional_ring(mesh: RowMesh, blocks: list, emit, comm: bool = True) -> None:
    """Drive the bidirectional ring: ``emit(slot, block, j)`` for every local
    slot and every B block ``j`` it meets.  Step ``t`` gives slot ``d`` the
    clockwise block ``(d + t) % S`` and, while ``t < S // 2``, the
    counter-clockwise block ``(d - t - 1) % S``; step ``t + 1``'s transfers
    start before step ``t``'s work."""
    s_count = mesh.size
    local = mesh.local_slots()
    if s_count == 1:
        for s in local:
            emit(s, blocks[s], 0)
        return
    half, ccw_steps = (s_count + 1) // 2, s_count // 2
    cw = blocks
    ccw = _shift(mesh, blocks, -1, 1, comm).wait()
    for t in range(half):
        more = t + 1 < half
        if more:
            nxt_cw = _shift(mesh, cw, 1, 0, comm)
            nxt_ccw = _shift(mesh, ccw, -1, 1, comm)
        for s in local:
            emit(s, cw[s], (s + t) % s_count)
            if t < ccw_steps:
                emit(s, ccw[s], (s - t - 1) % s_count)
        if more:
            cw, ccw = nxt_cw.wait(), nxt_ccw.wait()


def _ring_accumulate(mesh: RowMesh, a_pads: list, b_locs: list, kb: int, out_dtype,
                     comm: bool = True) -> list:
    """Per local slot, ``a_pad @ B``: the B row blocks ``b_locs`` travel the
    bidirectional ring and each meets the matching ``kb`` columns of the
    slot's dense A rows ``a_pad`` (columns zero-padded to ``S * kb``)."""
    acc = [None] * mesh.size
    for s in mesh.local_slots():
        acc[s] = torch.zeros((a_pads[s].shape[0], b_locs[s].shape[1]), dtype=out_dtype,
                             device=a_pads[s].device)

    def emit(s, block, j):
        acc[s] += _contract(a_pads[s][:, j * kb:(j + 1) * kb], block[0], out_dtype)

    _bidirectional_ring(mesh, [None if b is None else (b,) for b in b_locs], emit, comm)
    return acc


def _check_operands(a: ShardedCSR, b: ShardedCSR):
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dims mismatch: {a.shape} @ {b.shape}")
    if a.n_shards != b.n_shards:
        raise ValueError("operands sharded over different mesh sizes")
    if b.bounds is not None and b.bounds != _uniform_bounds(b.shape[0], b.n_shards):
        raise ValueError("B must be uniformly row-sharded along the contraction dim")


def _shard(mat, mesh, bounds=None) -> ShardedCSR:
    return mat if isinstance(mat, ShardedCSR) else shard_csr(mat, mesh, bounds=bounds)


def _dense_panels(mesh, a: ShardedCSR, b: ShardedCSR, comm: bool = True) -> list:
    """The ring product's per-slot ``(rows_pad, n)`` C panels."""
    s_count = mesh.size
    k, n = a.shape[1], b.shape[1]
    kb, rows_pad = b.rows_pad, a.rows_pad
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    a_pads, b_locs = [None] * s_count, [None] * s_count
    for s in mesh.local_slots():
        a_loc = _local_dense(a.indptrs[s], a.indices[s], a.values[s], rows_pad, k)
        a_pads[s] = pad_to_multiple(a_loc, 1, s_count * kb) if k < s_count * kb else a_loc
        b_locs[s] = _local_dense(b.indptrs[s], b.indices[s], b.values[s], kb, n)
    return _ring_accumulate(mesh, a_pads, b_locs, kb, out_dtype, comm)


def _spgemm_dense(mesh, a: ShardedCSR, b: ShardedCSR, symmetric: bool,
                  comm: bool = True) -> ShardedDense:
    acc = _dense_panels(mesh, a, b, comm)
    bounds = a.row_bounds
    panels = [None] * mesh.size
    for s in mesh.local_slots():
        panels[s] = acc[s][: bounds[s + 1] - bounds[s]]
        if symmetric:
            panels[s].triu_(bounds[s])  # upper triangle in global coordinates
    return ShardedDense(tuple(panels), (a.shape[0], b.shape[1]), bounds)


def spgemm_dense_distributed(a, b, symmetric: bool = False,
                             mesh: Optional[RowMesh] = None) -> ShardedDense:
    """sparse x sparse -> dense across the mesh, row-sharded.

    Takes :class:`ShardedCSR` operands, or any host CSR, sharded uniformly
    on ingest.  A must be uniformly row-sharded (use
    :func:`spgemm_csr_distributed` for flop-balanced bounds).
    """
    mesh = mesh or row_mesh()
    a = _shard(a, mesh)
    b = _shard(b, mesh)
    _check_operands(a, b)
    if a.bounds is not None and a.bounds != _uniform_bounds(a.shape[0], a.n_shards):
        raise ValueError("dense output requires uniformly row-sharded A")
    return _spgemm_dense(mesh, a, b, symmetric)


def _spgemm_csr(mesh, a: ShardedCSR, b: ShardedCSR, symmetric: bool, cap_l: int) -> list:
    """Each local slot's C panel extracted into a padded CSR block (K4)."""
    acc = _dense_panels(mesh, a, b)
    bounds = a.row_bounds
    fields = ([None] * mesh.size, [None] * mesh.size, [None] * mesh.size)
    for s in mesh.local_slots():
        c_loc, acc[s] = acc[s], None
        if symmetric:
            c_loc.triu_(bounds[s])  # upper triangle in global coordinates
        csr = dense_to_csr(c_loc, cap_l)
        del c_loc
        for field, t in zip(fields, (csr.indptr, csr.indices, csr.values)):
            field[s] = t
    return fields


def spgemm_csr_distributed(a, b, shard_capacity: int | None = None, symmetric: bool = False,
                           mesh: Optional[RowMesh] = None, balance: str = "rows") -> ShardedCSR:
    """sparse x sparse -> row-sharded padded CSR across the mesh.

    Each slot's dense C panel is extracted where it was made (K4).
    ``balance='flops'`` shards A by partial products
    (:func:`flop_shard_bounds`).  ``shard_capacity`` is every shard's entry
    capacity (default: the dense panel size, always enough).  Host operands
    whose per-slot dense working set (A panel + B block + C panel) would
    pass ``Config.dense_shard_budget_bytes`` go to
    :func:`spgemm_csr_distributed_sparse` instead.
    """
    mesh = mesh or row_mesh()
    if not isinstance(a, ShardedCSR):
        a_probe = _as_scipy(a)
        s_count = mesh.size
        m, k = a_probe.shape
        n_cols = b.shape[1] if isinstance(b, ShardedCSR) else _as_scipy(b).shape[1]
        if balance == "flops":
            bnds = flop_shard_bounds(a_probe, b, s_count)
            rows_pad = max(max(b1 - b0 for b0, b1 in zip(bnds[:-1], bnds[1:])), 1)
        else:
            bnds = None
            rows_pad = -(-m // s_count)
        kb = -(-k // s_count)
        itemsize = _value_dtype(mesh).itemsize
        panel_bytes = (rows_pad * k + kb * n_cols + rows_pad * n_cols) * itemsize
        if panel_bytes > get_config().dense_shard_budget_bytes:
            return spgemm_csr_distributed_sparse(a_probe, b, mesh=mesh, symmetric=symmetric,
                                                 balance=balance)
        a = shard_csr(a_probe, mesh, bounds=bnds)
    b = _shard(b, mesh)
    _check_operands(a, b)
    m, n = a.shape[0], b.shape[1]
    cap_l = int(shard_capacity) if shard_capacity is not None else a.rows_pad * n
    fields = _spgemm_csr(mesh, a, b, symmetric, cap_l)
    return ShardedCSR(*(tuple(f) for f in fields), (m, n), a.bounds, mesh)


# ---------------------------------------------------------------------------
# The sparse local contraction: nothing is densified.  B blocks travel as
# padded CSR; each step expands its partial products into a per-slot
# buffer at the slot's running offset; one sort + segmented sum per slot
# after the ring builds the slot's output CSR.
# ---------------------------------------------------------------------------


def _sharded_global_indptr(b: ShardedCSR) -> np.ndarray:
    """Global row pointers of a row-sharded matrix from its per-shard ones
    (a few KB, not the operand); across processes the local ones are
    gathered from every rank."""
    local = {s: fetch_np(ip) for s, ip in enumerate(b.indptrs) if ip is not None}
    if len(local) < b.n_shards:
        if b.mesh is None or b.mesh.group is None:
            raise ValueError("the shards' row pointers are not all local")
        gathered = [None] * dist.get_world_size(b.mesh.group)
        dist.all_gather_object(gathered, local, group=b.mesh.group)
        for part in gathered:
            local.update(part)
    bounds = b.row_bounds
    parts = [np.zeros(1, np.int64)]
    base = 0
    for s in range(len(bounds) - 1):
        rows_here = bounds[s + 1] - bounds[s]
        parts.append(base + local[s][1: rows_here + 1].astype(np.int64))
        base += int(local[s][rows_here]) if rows_here else 0
    return np.concatenate(parts)


def _expand_step_capacity(a_sp, b_indptr, b_rows: int, bounds, s_count: int) -> tuple:
    """Exact per-(shard, ring-step) expansion sizes on the host: (the most
    partial products of one step, the most of one shard in all), the two
    capacities of the sparse ring.  ``b_indptr`` is B's global row
    pointers; sums are int64 throughout."""
    kb = -(-b_rows // s_count) if b_rows else 1
    b_row_nnz = np.diff(b_indptr)
    per_entry = b_row_nnz[a_sp.indices].astype(np.int64)
    col_block = (a_sp.indices // kb).astype(np.int64)
    shard_of_entry = np.zeros(a_sp.nnz, np.int64)
    for s in range(s_count):
        lo, hi = int(a_sp.indptr[bounds[s]]), int(a_sp.indptr[bounds[s + 1]])
        shard_of_entry[lo:hi] = s
    per_step = np.zeros(s_count * s_count, np.int64)
    np.add.at(per_step, shard_of_entry * s_count + col_block, per_entry)
    per_shard = per_step.reshape(s_count, s_count).sum(axis=1)
    return (int(per_step.max()) if per_step.size else 1,
            int(per_shard.max()) if per_shard.size else 1)


def _entry_rows(ip: torch.Tensor, cap: int) -> torch.Tensor:
    """int64 local row of every entry slot of a padded CSR block; padding
    slots get row 0.  No host sync."""
    rows = ip.shape[0] - 1
    counts = (ip[1:] - ip[:-1]).long()
    pad = (cap - ip[-1:].long()).clamp_min(0)
    rid = torch.repeat_interleave(torch.arange(rows + 1, device=ip.device),
                                  torch.cat([counts, pad]), output_size=cap)
    return torch.where(rid < rows, rid, 0)


def _expand_block_partials(a_live, a_rows, a_ix, a_v, bip, bix, bv, col0: int, kb: int,
                           e_step: int):
    """One ring step's partial products: the live A entries whose column
    lies in B block ``[col0, col0 + kb)`` against the block's padded CSR.
    Returns ``(i_loc, k_col, v, count, total)``: ``e_step`` slots, the
    first ``count = min(total, e_step)`` of them live, and ``total`` the
    step's partials (device scalars; no host sync)."""
    dev = a_ix.device
    cap_a = a_ix.shape[0]
    a_col = a_ix.long() - col0
    in_blk = a_live & (a_col >= 0) & (a_col < kb)
    safe = a_col.clamp(0, kb - 1)
    bip = bip.long()
    b_start = bip[safe]
    lens = torch.where(in_blk, bip[safe + 1] - b_start, 0)
    ends = torch.cumsum(torch.cat([lens.new_zeros(1), lens]), 0)  # entry i starts at ends[i]
    total = ends[-1]
    cut = ends.clamp(max=e_step)
    reps = torch.cat([cut[1:] - cut[:-1], e_step - cut[-1:]])  # sums to e_step exactly
    src = torch.repeat_interleave(torch.arange(cap_a + 1, device=dev), reps, output_size=e_step)
    e = torch.arange(e_step, device=dev)
    b_pos = (torch.cat([b_start, b_start.new_zeros(1)])[src] + e - cut[src]).clamp(
        0, bix.shape[0] - 1)
    i_loc = torch.cat([a_rows, a_rows.new_zeros(1)])[src]
    k_col = bix[b_pos].long()
    v = torch.cat([a_v, a_v.new_zeros(1)])[src] * bv[b_pos]
    return i_loc, k_col, v, cut[-1], total


def _raise_if_short(mesh, short: list, what: str) -> None:
    """One host sync: the largest shortfall over local slots and ranks;
    ``ValueError`` on every rank when any is positive."""
    worst = max((int(x) for x in short), default=0)
    worst = reduce_max(mesh, worst)
    if worst > 0:
        raise ValueError(f"{what} is {worst} partial products short: no partial is dropped; "
                         "size it from the operands' structure")


def _spgemm_sparse(mesh, a: ShardedCSR, b: ShardedCSR, symmetric: bool, e_step: int,
                   cap_l: int, buf_cap: int, comm: bool = True) -> tuple:
    """The bidirectional sparse ring; per local slot its output CSR block."""
    s_count = mesh.size
    n = b.shape[1]
    kb, rows_pad = b.rows_pad, a.rows_pad
    bounds = a.row_bounds
    val_dtype = torch.promote_types(a.dtype, b.dtype)
    dead = rows_pad * n
    state = {}
    for s in mesh.local_slots():
        ip, ix, vv = a.indptrs[s], a.indices[s], a.values[s]
        dev = ix.device
        cap_a = ix.shape[0]
        state[s] = dict(
            live=torch.arange(cap_a, device=dev) < ip[-1], rows=_entry_rows(ip, cap_a),
            ix=ix, v=vv.to(val_dtype),
            keys=torch.full((buf_cap + 1,), dead, dtype=torch.int64, device=dev),
            vals=torch.zeros(buf_cap + 1, dtype=val_dtype, device=dev),
            pos=torch.zeros((), dtype=torch.int64, device=dev),
            over=torch.zeros((), dtype=torch.int64, device=dev),
            e=torch.arange(e_step, device=dev))

    def emit(s, block, j):
        """Append block ``j``'s partials at the slot's running offset; slot
        ``buf_cap`` takes whatever would land past the buffer."""
        st = state[s]
        bip, bix, bv = block
        i_loc, k_col, v, count, total = _expand_block_partials(
            st["live"], st["rows"], st["ix"], st["v"], bip, bix, bv.to(val_dtype), j * kb, kb,
            e_step)
        key = i_loc * n + k_col
        if symmetric:
            keep = k_col >= i_loc + bounds[s]
            key = torch.where(keep, key, dead)
            v = torch.where(keep, v, torch.zeros((), dtype=v.dtype, device=v.device))
        at = st["pos"] + st["e"]
        at = torch.where((st["e"] < count) & (at < buf_cap), at, buf_cap)
        st["keys"].index_put_((at,), key)
        st["vals"].index_put_((at,), v)
        st["pos"] = st["pos"] + count
        st["over"] = torch.maximum(st["over"], total - e_step)

    _bidirectional_ring(mesh, [None if ip is None else (ip, b.indices[s], b.values[s])
                               for s, ip in enumerate(b.indptrs)], emit, comm)
    _raise_if_short(mesh, [state[s]["over"] for s in state], "expand_step_capacity")
    _raise_if_short(mesh, [state[s]["pos"] - buf_cap for s in state], "partials_capacity")
    fields = ([None] * s_count, [None] * s_count, [None] * s_count)
    for s in list(state):
        st = state.pop(s)
        out = esc_sort_compress(None, st["keys"][:buf_cap], st["vals"][:buf_cap],
                                n_rows=rows_pad, n_cols=n, out_capacity=cap_l)
        del st
        for field, t in zip(fields, out):
            field[s] = t
    return fields


def spgemm_csr_distributed_sparse(
    a,
    b,
    mesh: Optional[RowMesh] = None,
    symmetric: bool = False,
    balance: str = "flops",
    expand_step_capacity: int | None = None,
    shard_capacity: int | None = None,
    partials_capacity: int | None = None,
    _comm: bool = True,
) -> ShardedCSR:
    """Distributed SpGEMM with a sparse local contraction (large sparse).

    A and C stay row-sharded padded CSR, B blocks travel the ring as padded
    CSR, and each slot runs expand -> sort -> compress over its partial
    products.  ``expand_step_capacity`` (partials of one ring step) and
    ``shard_capacity`` (output entries per shard) are computed exactly on
    the host from scipy operands and must be given with pre-placed
    :class:`ShardedCSR` ones.  ``partials_capacity`` sizes each slot's
    partials buffer: the exact per-shard total plus one step when
    host-planned, ``(S + 1) * expand_step_capacity`` for pre-placed
    operands.  A capacity short of the partials raises ``ValueError``.
    """
    mesh = mesh or row_mesh()
    s_count = mesh.size
    if not isinstance(a, ShardedCSR):
        a_sp = _as_scipy(a)
        if isinstance(b, ShardedCSR):
            b_indptr = _sharded_global_indptr(b)
            b_rows, b_cols = b.shape
        else:
            b = _as_scipy(b)
            b_indptr = b.indptr
            b_rows, b_cols = b.shape
        if balance == "flops":
            flops = row_flops(a_sp.indptr, a_sp.indices, b_indptr)
            bounds = _pad_bounds(flop_balanced_partition(flops, s_count), a_sp.shape[0], s_count)
        else:
            bounds = _uniform_bounds(a_sp.shape[0], s_count)
        if expand_step_capacity is None or shard_capacity is None or partials_capacity is None:
            e_max, tot_max = _expand_step_capacity(a_sp, b_indptr, b_rows, bounds, s_count)
            if expand_step_capacity is None:
                expand_step_capacity = fine_capacity(e_max)
            if shard_capacity is None:
                shard_capacity = bucket_capacity(min(tot_max, a_sp.shape[0] * b_cols))
            if partials_capacity is None:
                partials_capacity = fine_capacity(tot_max) + int(expand_step_capacity)
        a = shard_csr(a_sp, mesh, bounds=bounds)
        b = _shard(b, mesh)
    else:
        b = _shard(b, mesh)
        if expand_step_capacity is None or shard_capacity is None:
            raise ValueError(
                "pre-placed ShardedCSR operands need explicit "
                "expand_step_capacity and shard_capacity"
            )
        if partials_capacity is None:
            partials_capacity = (s_count + 1) * int(expand_step_capacity)
    _check_operands(a, b)
    fields = _spgemm_sparse(mesh, a, b, symmetric, int(expand_step_capacity),
                            int(shard_capacity), int(partials_capacity), comm=_comm)
    return ShardedCSR(*(tuple(f) for f in fields), (a.shape[0], b.shape[1]), a.bounds, mesh)


# ---------------------------------------------------------------------------
# The sparse triple product H Q H^T: T = H Q by the sparse ring, then
# C = T H^T by a second sparse ring of H^T's row blocks into each slot's
# dense (rows_pad x m) C panel, the only dense object.
# ---------------------------------------------------------------------------


def _triple_counts(mesh, t: ShardedCSR, nnzht_pad: np.ndarray) -> int:
    """The most partial products of one (shard, step) of the second ring:
    per local slot, nnz(H^T row) summed over its T entries by H^T block
    (int64, one host sync per slot), then the largest over every rank."""
    s_count = mesh.size
    kb = nnzht_pad.shape[0] // s_count
    worst = 0
    for s, (ip, ix, _) in t.local_shards().items():
        nz = torch.from_numpy(nnzht_pad).to(ix.device)
        live = torch.arange(ix.shape[0], device=ix.device) < ip[-1]
        safe = ix.long().clamp(0, nz.shape[0] - 1)
        w = torch.where(live, nz[safe], 0)
        blk = (safe // kb).clamp(0, s_count - 1)
        counts = torch.zeros(s_count, dtype=torch.int64, device=ix.device).index_add_(0, blk, w)
        worst = max(worst, int(counts.max()))
    return reduce_max(mesh, worst)


def _triple_sparse(mesh, t: ShardedCSR, ht: ShardedCSR, e_step: int, full: bool) -> ShardedDense:
    s_count = mesh.size
    m = t.shape[0]
    m_out = ht.shape[1]
    kb, rows_pad = ht.rows_pad, t.rows_pad
    bounds = t.row_bounds
    val_dtype = torch.promote_types(t.dtype, ht.dtype)
    space = rows_pad * m_out
    state = {}
    for s, (ip, ix, vv) in t.local_shards().items():
        dev = ix.device
        state[s] = dict(
            live=torch.arange(ix.shape[0], device=dev) < ip[-1], rows=_entry_rows(ip, ix.shape[0]),
            ix=ix, v=vv.to(val_dtype),
            acc=torch.zeros(space + 1, dtype=val_dtype, device=dev),  # the last: a dump slot
            over=torch.zeros((), dtype=torch.int64, device=dev))
    blocks = [None if ip is None else (ip, ht.indices[s], ht.values[s])
              for s, ip in enumerate(ht.indptrs)]
    for step in range(s_count):
        if step + 1 < s_count:
            nxt = ring_shift(mesh, blocks, 1)
        for s, st in state.items():
            bip, bix, bv = blocks[s]
            j = (s + step) % s_count
            i_loc, k_col, v, count, total = _expand_block_partials(
                st["live"], st["rows"], st["ix"], st["v"], bip, bix, bv.to(val_dtype), j * kb, kb,
                e_step)
            st["over"] = torch.maximum(st["over"], total - e_step)
            keep = torch.arange(e_step, device=v.device) < count
            if not full:  # upper triangle in global coordinates
                keep &= k_col >= i_loc + bounds[s]
            key = torch.where(keep, i_loc * m_out + k_col, space)
            v = torch.where(keep, v, torch.zeros((), dtype=v.dtype, device=v.device))
            # The step's partials summed by key (sort + segmented sum), then
            # each key of the panel written once: deterministic, no atomics.
            ptr, flat, sums = esc_sort_compress(None, key, v, n_rows=1, n_cols=space,
                                                out_capacity=e_step)
            flat = torch.where(torch.arange(e_step, device=v.device) < ptr[1], flat.long(), space)
            acc = st["acc"]
            acc.index_put_((flat,), acc[flat] + sums)
        if step + 1 < s_count:
            blocks = nxt.wait()
    _raise_if_short(mesh, [st["over"] for st in state.values()], "expand_step_capacity")
    panels = [None] * s_count
    for s, st in state.items():
        panels[s] = st["acc"][:space].view(rows_pad, m_out)[: bounds[s + 1] - bounds[s]]
    return ShardedDense(tuple(panels), (m, m_out), bounds)


def triple_product_distributed_sparse(
    h,
    q,
    compute_full_matrix: int = 0,
    mesh: Optional[RowMesh] = None,
    expand_step_capacity: int | None = None,
) -> ShardedDense:
    """Distributed ``H . Q . H^T`` for large sparse operands: neither H nor
    Q is densified.  ``T = H.Q`` runs the sparse ring; ``C = T.H^T`` runs a
    second sparse ring over row-sharded H^T into each slot's dense
    ``(rows_pad x m)`` C panel.  Its step capacity comes from an exact count
    pass unless given.  Returns the (m, m) product row-sharded: its upper
    triangle, or with ``compute_full_matrix=1`` the full product.

    Gates, as in JAX: a C panel over ``Config.dense_shard_budget_bytes``
    raises ``ValueError``, and so does one of ``2**31`` elements or more --
    JAX's scatter indexes it in int32; the port's keys are int64, but the
    gate stays for the same behaviour.  (JAX's ``OverflowError`` guards its
    int32 count pass; the port counts in int64 and has none.)
    """
    mesh = mesh or row_mesh()
    s_count = mesh.size
    h_sp = _as_scipy(h)
    m, k = h_sp.shape
    rows_pad = -(-m // s_count)
    itemsize = _value_dtype(mesh).itemsize
    budget = get_config().dense_shard_budget_bytes
    if rows_pad * m * itemsize > budget:
        raise ValueError(
            f"sparse triple product accumulates a dense ({rows_pad} x {m}) "
            f"C panel per shard = {rows_pad * m * itemsize} bytes, over "
            f"dense_shard_budget_bytes={budget}; raise the budget or add "
            "devices (the panel shrinks as rows_pad = ceil(m / devices))"
        )
    if rows_pad * m >= 2**31:
        raise ValueError(
            f"per-shard C panel has {rows_pad * m} elements >= 2**31 (the "
            "int32 flat-index ceiling of the scatter kernel); add devices "
            "so rows_pad = ceil(m / devices) brings rows_pad * m under 2**31"
        )
    t = spgemm_csr_distributed_sparse(h_sp, q, mesh=mesh, balance="rows")
    ht_sp = h_sp.T.tocsr()
    ht = shard_csr(ht_sp, mesh)
    _check_operands(t, ht)
    if expand_step_capacity is None:
        nnzht = np.zeros(s_count * ht.rows_pad, np.int64)
        nnzht[:k] = np.diff(ht_sp.indptr)
        expand_step_capacity = bucket_capacity(max(_triple_counts(mesh, t, nnzht), 1))
    return _triple_sparse(mesh, t, ht, int(expand_step_capacity), bool(compute_full_matrix))


# ---------------------------------------------------------------------------
# The dense triple product H . Q . H^T.
# ---------------------------------------------------------------------------


def _mirror(mesh, panels: list, bounds: tuple, rows_pad: int) -> None:
    """Add to each slot's upper-triangle panel ``(rows_pad, S * rows_pad)``
    the transpose of the strict upper triangle: slot ``j``'s block travels
    the ring and slot ``d`` takes the transpose of its column block ``d``."""
    s_count = mesh.size
    lows = [None] * s_count
    for s in mesh.local_slots():
        lows[s] = (torch.triu(panels[s], bounds[s] + 1),)
    blocks = lows
    for step in range(s_count):
        if step + 1 < s_count:
            nxt = ring_shift(mesh, blocks, 1)
        for d in mesh.local_slots():
            j = (d + step) % s_count
            low = blocks[d][0]
            panels[d][:, j * rows_pad:(j + 1) * rows_pad] += \
                low[:, d * rows_pad:(d + 1) * rows_pad].T
        if step + 1 < s_count:
            blocks = nxt.wait()


def _triple_dense(mesh, h: ShardedCSR, q: ShardedCSR, full: bool) -> ShardedDense:
    s_count = mesh.size
    m, k = h.shape
    kb, rows_pad = q.rows_pad, h.rows_pad
    out_dtype = torch.promote_types(h.dtype, q.dtype)
    k_pad = max(s_count * kb, k)
    local = mesh.local_slots()
    h_pads, q_locs = [None] * s_count, [None] * s_count
    for s in local:
        h_loc = _local_dense(h.indptrs[s], h.indices[s], h.values[s], rows_pad, k)
        h_pads[s] = pad_to_multiple(h_loc, 1, k_pad) if k < k_pad else h_loc
        q_locs[s] = _local_dense(q.indptrs[s], q.indices[s], q.values[s], kb, k)
    # Ring 1: T = H . Q, row-sharded; T never leaves its slot.
    t_locs = _ring_accumulate(mesh, h_pads, q_locs, kb, out_dtype)
    del q_locs
    # Ring 2: C = T . H^T -- H's own row blocks travel; each step fills the
    # column block of C owned by the sending slot.
    acc = [None] * s_count
    t_pads = [None] * s_count
    for s in local:
        t_pads[s] = pad_to_multiple(t_locs[s], 1, k_pad) if k < k_pad else t_locs[s]
        t_locs[s] = None
        acc[s] = torch.zeros((rows_pad, s_count * rows_pad), dtype=out_dtype,
                             device=t_pads[s].device)
    blocks = [None if hp is None else (hp,) for hp in h_pads]
    for step in range(s_count):
        if step + 1 < s_count:
            nxt = ring_shift(mesh, blocks, 1)
        for s in local:
            j = (s + step) % s_count
            acc[s][:, j * rows_pad:(j + 1) * rows_pad] = _contract(
                t_pads[s], blocks[s][0].T, out_dtype)
        if step + 1 < s_count:
            blocks = nxt.wait()
    del t_pads, blocks, h_pads
    bounds = _uniform_bounds(m, s_count)
    for s in local:
        acc[s].triu_(bounds[s])  # upper triangle in global coordinates
    if full:
        _mirror(mesh, acc, bounds, rows_pad)
    panels = [None] * s_count
    for s in local:
        panels[s] = acc[s][: bounds[s + 1] - bounds[s], :m]
    return ShardedDense(tuple(panels), (m, m), bounds)


def triple_product_distributed(h, q, compute_full_matrix: int = 0,
                               mesh: Optional[RowMesh] = None) -> ShardedDense:
    """Distributed ``H . Q . H^T``, row-sharded: both contractions are
    rings over sharded operands, and ``T = H.Q`` stays on the slots that
    made it.  Returns the upper triangle, or with ``compute_full_matrix=1``
    the upper triangle mirrored.  Host operands whose dense panels would
    pass ``Config.dense_shard_budget_bytes`` go to
    :func:`triple_product_distributed_sparse`.
    """
    mesh = mesh or row_mesh()
    if not isinstance(h, ShardedCSR):
        h_probe = _as_scipy(h)
        s_count = mesh.size
        m, k = h_probe.shape
        rows_pad = -(-m // s_count)
        kb = -(-k // s_count)
        k_pad = max(s_count * kb, k)
        itemsize = _value_dtype(mesh).itemsize
        # Dense working set per slot: H panel + Q block + T panel + C block.
        panel_bytes = (rows_pad * k_pad * 2 + kb * k + rows_pad * s_count * rows_pad) * itemsize
        if panel_bytes > get_config().dense_shard_budget_bytes:
            return triple_product_distributed_sparse(h_probe, q, compute_full_matrix, mesh=mesh)
        h = h_probe
    h = _shard(h, mesh)
    q = _shard(q, mesh)
    _check_operands(h, q)
    if h.bounds is not None and h.bounds != _uniform_bounds(h.shape[0], h.n_shards):
        raise ValueError("triple product requires uniformly row-sharded H")
    return _triple_dense(mesh, h, q, bool(compute_full_matrix))


# ---------------------------------------------------------------------------
# Dense-operand ring matmul.
# ---------------------------------------------------------------------------


def ring_matmul(a, b, mesh: Optional[RowMesh] = None) -> ShardedDense:
    """Dense distributed ``a @ b`` with ring-travelling B blocks.  ``a`` is
    (m, k), ``b`` (k, c) (tensors or arrays); both are zero-padded so that
    m and k divide the mesh size.  Returns the (m, c) product row-sharded."""
    mesh = mesh or row_mesh()
    s_count = mesh.size
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    m, c = a.shape[0], b.shape[1]
    ap = pad_to_multiple(pad_to_multiple(a, 0, s_count), 1, s_count)
    bp = pad_to_multiple(b, 0, s_count)
    rows, blk = ap.shape[0] // s_count, ap.shape[1] // s_count
    a_pads, b_locs = [None] * s_count, [None] * s_count
    for s in mesh.local_slots():
        dev = mesh.slots[s][0]
        a_pads[s] = ap[s * rows:(s + 1) * rows].to(dev)
        b_locs[s] = bp[s * blk:(s + 1) * blk].to(dev)
    acc = _ring_accumulate(mesh, a_pads, b_locs, blk, torch.promote_types(a.dtype, b.dtype))
    bounds = tuple(min(s * rows, m) for s in range(s_count + 1))
    panels = [None if acc[s] is None else acc[s][: bounds[s + 1] - bounds[s], :c]
              for s in range(s_count)]
    return ShardedDense(tuple(panels), (m, c), bounds)
