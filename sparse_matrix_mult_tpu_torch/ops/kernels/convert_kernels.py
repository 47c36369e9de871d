"""CSR <-> dense conversion kernels (``csrc/convert.cu``,
``csrc/convert_fused.cu``) and their plain PyTorch versions.

* K3 :func:`csr_to_dense` -- replaces
  ``sparse_matrix_mult_tpu/ops/pallas/convert_kernels.py::_distribute_kernel``:
  persistent CTAs, each over a contiguous range of flat tiles of the output,
  write each tile once, from a zeroed shared buffer, with asynchronous bulk
  copies (:func:`_densify_tiling`).
* K4 :func:`dense_to_csr` and K2 :func:`dense_to_csr` with ``triu=True`` --
  one templated count / scan / fill triple (three launches, 16-byte loads)
  replacing ``_concentrate_kernel`` and ``_concentrate_payload_kernel`` (the
  staircase extraction).
* K7 :func:`dense_to_csr_fused` -- replaces ``_fused_extract_kernel``: K4's
  output in one launch that reads the matrix once: persistent CTAs claim
  tiles in ticket order, a producer warp keeps them in flight by bulk copies
  into a ring of shared stages, and a count warp, a scan warp (the
  look-back) and eight fill warps take each tile in turn
  (:func:`_extract_tiling`).
* K8 :func:`csr_to_dense_fused` -- replaces ``_fused_densify_kernel``: K3's
  output in one launch, one flat-row of ``lane`` elements per CTA.

The fused pair is on no production route, as in the JAX package: the routes
keep K3 and K4.  Their results do not depend on ``lane``.

Output contract of the extraction, the same as the Pallas pipeline's:
``indices``/``values`` of length ``capacity``, entries sorted by (row, col),
zeros dropped, entries past ``capacity`` dropped, zero padding past the last
kept entry, and ``indptr`` counting kept entries only (clamped at
``capacity``).  ``triu=True`` keeps columns ``col >= row`` only.
"""

from __future__ import annotations

import functools
import operator
from typing import NamedTuple

import torch

from . import _build

__all__ = [
    "LANE",
    "csr_to_dense",
    "csr_to_dense_plain",
    "csr_to_dense_fused",
    "csr_to_dense_fused_plain",
    "dense_to_csr",
    "dense_to_csr_plain",
    "dense_to_csr_fused",
    "dense_to_csr_fused_plain",
]

_FLOATS = {torch.float32: "f32", torch.float64: "f64"}

LANE = 8192  # default flat-row length of the fused conversions (the JAX default)

DENSIFY_BUFFER = 32768  # bytes of one of a K3 CTA's two shared buffers: a tile's most
DENSIFY_CTAS_PER_SM = 3  # K3's persistent CTAs per SM (two buffers each)

EXTRACT_TILE = 16384  # bytes of a K7 tile at most: one bulk copy, one stage of the ring
EXTRACT_QUANTUM = 4096  # a K7 tile is a multiple: one 16-byte vector per fill lane
EXTRACT_RING = 196608  # bytes of shared memory for the rings of an SM's K7 CTAs (kernel: <= 200 KB)
EXTRACT_MAX_STAGES = 8  # the kernel's most stages (kMaxStages)
EXTRACT_CTAS_PER_SM = 3  # K7's persistent CTAs per SM


def _check_csr(indptr, indices, values, shape):
    m, _ = shape
    if indptr.dtype != torch.int32 or indices.dtype != torch.int32:
        raise TypeError("indptr and indices must be int32")
    if values.dtype not in _FLOATS:
        raise TypeError(f"values must be float32 or float64, got {values.dtype}")
    if indptr.shape != (m + 1,) or indices.ndim != 1 or indices.shape != values.shape:
        raise ValueError("CSR arrays do not match the shape")
    if not (indptr.is_contiguous() and indices.is_contiguous() and values.is_contiguous()):
        raise ValueError("CSR arrays must be contiguous")


def csr_to_dense_plain(indptr, indices, values, shape) -> torch.Tensor:
    """K3's plain version: zero-fill, then ``index_put_`` of the live entries."""
    m, n = shape
    nnz = int(indptr[-1])
    counts = (indptr[1:] - indptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(m, device=values.device), counts, output_size=nnz
    )
    dense = torch.zeros((m, n), dtype=values.dtype, device=values.device)
    dense.index_put_((rows, indices[:nnz].long()), values[:nnz])
    return dense


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=256)
def _densify_tiling(m: int, n: int, itemsize: int, sms: int):
    """K3's flat tiles of the row-major (m, n) output: ``(tile_elems,
    per_cta, ctas)``.  Tile t covers elements ``[t * tile_elems, min((t + 1)
    * tile_elems, m * n))``; a tile is a multiple of 128 bytes (so every
    start is 16-byte aligned) and at most ``DENSIFY_BUFFER`` bytes, one
    shared buffer; a small matrix gets smaller tiles, so that its tiles
    still spread over the ``sms`` SMs.  CTA b walks the ``per_cta``
    consecutive tiles from ``b * per_cta`` (the last CTA may have fewer,
    none has none), so each tile's run of entries starts where the previous
    one's ended.  Cached: the main path densifies a few shapes many times."""
    most = sms * DENSIFY_CTAS_PER_SM
    total = m * n * itemsize
    per_cta_bytes = -(-total // most)
    tile_bytes = min(DENSIFY_BUFFER, max(128, -(-per_cta_bytes // 128) * 128))
    tile_elems = tile_bytes // itemsize
    n_tiles = -(-(m * n) // tile_elems)
    per_cta = -(-n_tiles // most)
    return tile_elems, per_cta, -(-n_tiles // per_cta)


def csr_to_dense(indptr, indices, values, shape) -> torch.Tensor:
    """Dense (m, n) matrix of sorted, duplicate-free padded CSR (K3).

    Entries past ``indptr[-1]`` are ignored.
    """
    m, n = int(shape[0]), int(shape[1])
    _check_csr(indptr, indices, values, (m, n))
    if not _build.is_cuda(indptr, indices, values):
        return csr_to_dense_plain(indptr, indices, values, (m, n))
    dense = torch.empty((m, n), dtype=values.dtype, device=values.device)
    if m * n == 0:
        return dense
    tile_elems, per_cta, ctas = _densify_tiling(m, n, values.element_size(),
                                                _sm_count(values.device))
    code = _build.launch(
        f"smm_csr_to_dense_{_FLOATS[values.dtype]}", values.device,
        indptr.data_ptr(), indices.data_ptr(), values.data_ptr(), dense.data_ptr(),
        m, n, tile_elems, per_cta, ctas,
    )
    _build.LAUNCHES["csr_to_dense"] += 1
    _build.check(code, "csr_to_dense")
    return dense


def dense_to_csr_plain(c: torch.Tensor, capacity: int, triu: bool = False):
    """K2/K4's plain version: a nonzero mask (upper triangle for K2), then
    ``nonzero`` in row-major order, truncated at ``capacity``."""
    m, n = c.shape
    keep = c != 0
    if triu:
        keep = torch.triu(keep)
    counts = keep.sum(dim=1)
    indptr = torch.zeros(m + 1, dtype=torch.int64, device=c.device)
    indptr[1:] = torch.cumsum(counts, dim=0)
    indptr = indptr.clamp_(max=capacity).to(torch.int32)
    rows, cols = torch.nonzero(keep, as_tuple=True)
    kept = min(int(rows.shape[0]), int(capacity))
    indices = torch.zeros(capacity, dtype=torch.int32, device=c.device)
    values = torch.zeros(capacity, dtype=c.dtype, device=c.device)
    indices[:kept] = cols[:kept].to(torch.int32)
    values[:kept] = c[rows[:kept], cols[:kept]]
    return indptr, indices, values


def _check_dense(c: torch.Tensor, name: str) -> None:
    if c.ndim != 2:
        raise ValueError(f"{name} takes a 2-D matrix")
    if c.dtype not in _FLOATS:
        raise TypeError(f"{name} takes float32 or float64, got {c.dtype}")
    if not c.is_contiguous():
        raise ValueError(f"{name} takes a contiguous matrix")


def dense_to_csr(c: torch.Tensor, capacity: int, triu: bool = False):
    """Packed ``(indptr, indices, values)`` of the nonzeros of ``c`` (K4), or
    of its upper triangle with ``triu=True`` (K2)."""
    if c.ndim == 2 and triu and c.shape[0] != c.shape[1]:
        raise ValueError("triu extraction requires a square matrix")
    _check_dense(c, "dense_to_csr")
    capacity = int(capacity)
    if not _build.is_cuda(c):
        return dense_to_csr_plain(c, capacity, triu)
    if not 0 <= capacity < 2**31:
        raise ValueError(f"capacity must lie in [0, 2^31), got {capacity}")
    (m, n), dev, kind = c.shape, c.device, _FLOATS[c.dtype]
    name = "dense_to_csr_triu" if triu else "dense_to_csr"
    # Count and scan first; the entries are allocated while they run.
    indptr = torch.empty(m + 1, dtype=torch.int32, device=dev)
    code = _build.launch(f"smm_dense_count_{kind}", dev, c.data_ptr(), m, n, int(triu), capacity,
                         indptr.data_ptr())
    _build.check(code, name)
    indices = torch.empty(capacity, dtype=torch.int32, device=dev)
    values = torch.empty(capacity, dtype=c.dtype, device=dev)
    code = _build.launch(f"smm_dense_fill_{kind}", dev, c.data_ptr(), m, n, int(triu), capacity,
                         indptr.data_ptr(), indices.data_ptr(), values.data_ptr())
    _build.LAUNCHES[name] += 1
    _build.check(code, name)
    return indptr, indices, values


def _check_lane(lane) -> int:
    lane = operator.index(lane)
    if lane < 32 or lane & (lane - 1):
        raise ValueError(f"lane must be a power of two >= 32, got {lane}")
    return lane


class ExtractTiling(NamedTuple):
    """K7's launch: the matrix's 16-byte-aligned span in tiles, and the ring."""

    lead: int  # elements of the span before the matrix's first
    span_bytes: int  # from the 16-byte chunk of the first element through that of the last
    tile_bytes: int  # tile t covers span bytes [t * tile_bytes, (t + 1) * tile_bytes)
    n_tiles: int
    stages: int  # shared stages of a CTA's ring (>= 2)
    ctas: int


@functools.lru_cache(maxsize=256)
def _extract_tiling(m: int, n: int, itemsize: int, address: int, sms: int) -> ExtractTiling:
    """K7's tiles of the row-major (m, n) matrix at ``address`` (only its
    remainder modulo 16 matters).  The span starts at the address rounded
    down to 16 bytes and ends at the end rounded up, so every tile starts
    16-byte aligned and every copy is a multiple of 16 bytes; the tiles cover
    it once.  A tile is a power of two between ``EXTRACT_QUANTUM`` and
    ``EXTRACT_TILE`` bytes, no more than an SM's share of a small matrix,
    so that its tiles still spread over the ``sms`` SMs.  Each CTA's ring
    takes its share of ``EXTRACT_RING``.  Cached: callers convert a few
    shapes many times."""
    lead = address % 16 // itemsize
    span = -(-(lead + m * n) * itemsize // 16) * 16
    per_sm = -(-span // sms)
    tile = min(EXTRACT_TILE, max(EXTRACT_QUANTUM, 1 << (per_sm.bit_length() - 1)))
    stages = min(EXTRACT_MAX_STAGES, EXTRACT_RING // (EXTRACT_CTAS_PER_SM * tile))
    return ExtractTiling(lead, span, tile, -(-span // tile), stages, sms * EXTRACT_CTAS_PER_SM)


def dense_to_csr_fused_plain(c: torch.Tensor, capacity: int):
    """K7's plain version: K4's, since the outputs are identical."""
    return dense_to_csr_plain(c, capacity)


def dense_to_csr_fused(c: torch.Tensor, capacity: int, lane: int = LANE):
    """Packed ``(indptr, indices, values)`` of the nonzeros of ``c`` in one
    launch (K7) that reads ``c`` once.  ``lane`` (a power of two >= 32) is
    the TPU kernel's flat-row; the CUDA kernel's tiles (powers of two, from
    the 16-byte boundary at or before ``c``) nest with it.

    The output is K4's (:func:`dense_to_csr`), truncation at ``capacity``
    included; it does not depend on ``lane``.
    """
    _check_dense(c, "dense_to_csr_fused")
    lane = _check_lane(lane)
    capacity = int(capacity)
    if not 0 <= capacity < 2**31:
        raise ValueError(f"capacity must lie in [0, 2^31), got {capacity}")
    if not _build.is_cuda(c):
        return dense_to_csr_fused_plain(c, capacity)
    m, n = c.shape
    indptr = torch.empty(m + 1, dtype=torch.int32, device=c.device)
    indices = torch.empty(capacity, dtype=torch.int32, device=c.device)
    values = torch.empty(capacity, dtype=c.dtype, device=c.device)
    if m * n == 0:  # no entries: nothing to launch
        return indptr.zero_(), indices.zero_(), values.zero_()
    size = c.element_size()
    tiling = _extract_tiling(m, n, size, c.data_ptr() % 16, _sm_count(c.device))
    # One status word per tile, then the ticket counter: zeroed in the C call.
    status = torch.empty(tiling.n_tiles + 1, dtype=torch.int64, device=c.device)
    code = _build.launch(
        f"smm_dense_to_csr_fused_{_FLOATS[c.dtype]}", c.device,
        c.data_ptr() - tiling.lead * size, tiling.lead, m, n, capacity, tiling.tile_bytes,
        tiling.stages, tiling.ctas, status.data_ptr(), indptr.data_ptr(), indices.data_ptr(),
        values.data_ptr(),
    )
    _build.LAUNCHES["dense_to_csr_fused"] += 1
    _build.check(code, "dense_to_csr_fused")
    return indptr, indices, values


def csr_to_dense_fused_plain(indptr, indices, values, shape) -> torch.Tensor:
    """K8's plain version: K3's, since the outputs are identical."""
    return csr_to_dense_plain(indptr, indices, values, shape)


def csr_to_dense_fused(indptr, indices, values, shape, lane: int = LANE) -> torch.Tensor:
    """Dense (m, n) matrix of sorted, duplicate-free padded CSR in one launch
    (K8), one flat-row of ``lane`` elements (a power of two >= 32) per CTA.

    The output is K3's (:func:`csr_to_dense`); entries past ``indptr[-1]``
    are ignored.
    """
    m, n = int(shape[0]), int(shape[1])
    _check_csr(indptr, indices, values, (m, n))
    lane = _check_lane(lane)
    if not _build.is_cuda(indptr, indices, values):
        return csr_to_dense_fused_plain(indptr, indices, values, (m, n))
    dense = torch.empty((m, n), dtype=values.dtype, device=values.device)
    if m * n == 0:
        return dense
    code = _build.launch(
        f"smm_csr_to_dense_fused_{_FLOATS[values.dtype]}", values.device,
        indptr.data_ptr(), indices.data_ptr(), values.data_ptr(), dense.data_ptr(), m, n, lane,
    )
    _build.LAUNCHES["csr_to_dense_fused"] += 1
    _build.check(code, "csr_to_dense_fused")
    return dense
