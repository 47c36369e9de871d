"""Public API: the reference-compatible ``sparse_matrix_multiply`` and the
device-resident ``multiply``.

Counterpart of :mod:`sparse_matrix_mult_tpu.api`: validation, the
empty-operand path, the host short-circuit (native Gustavson below
``Config.host_compute_limit`` partial products), the dense route with device
or host extraction and its BSR rung for block-sparse operands (K5/K6), the
sparse-output ladder below it (the binned, windowed and classic ESC engines,
row-chunked dense and flop-balanced row-chunked ESC), and the triple product
``H Q H^T`` (route ``"triple"``, and the device-resident
:func:`triple_product`).  Above ``host_compute_limit`` the three branches
(sparse, dense and triple) ask JAX's host/device cost model
(:func:`_route_costs`, fitted on an H100 host and its PCIe link; pin it with
``auto_calibrate_link=False`` and the ``link_*`` / ``host_*`` fields) whether
the host's Gustavson kernel beats the device round trip.

Every input is canonicalized (sorted indices, duplicates summed) on a copy
before any planning, so a structure plan and the uploaded operand always
agree (R1 in ``ROADMAP.md``).

The scipy-in/scipy-out entry point computes on ``device`` (default
``Config.device``, ``"cuda"``); it never probes for a GPU.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse import csr_matrix, isspmatrix_csr

from .config import Precision, get_config
from .ops.convert import csr_to_dense, dense_to_csr, dense_to_csr_triu
from .ops.dense_path import dense_path_fits, spgemm_dense_out
from .ops.kernels.bsr_spgemm import (
    KERNEL_BLOCK, bsr_bsr_matmul_dense, bsr_matmul_dense, bsr_pair_plan)
from .ops.matmul import resolve_precision
from .ops.spgemm_binned import binned_plan, spgemm_esc_binned
from .ops.spgemm_esc import spgemm_esc, spgemm_esc_windowed, windowed_plan
from .ops.triple_product import triple_product_dense
from .types import CSRMatrix, bucket_capacity, from_scipy, to_scipy
from .types_bsr import _tobsr_padded, bsr_from_scipy
from .utils.native import csr_triu, expansion_size, row_flops, spgemm_host, stitch_csr
from .utils.profiling import span
from .utils.transfer import fetch_dense_to_csr, fetch_np, fine_capacity

__all__ = ["sparse_matrix_multiply", "multiply", "triple_product", "get_last_route",
           "get_last_route_detail", "get_last_route_stages", "block_occupancy"]

# Route of the last sparse_matrix_multiply on this thread: "host", "dense",
# "bsr", "esc_binned", "esc_windowed", "esc", "dense_chunks", "esc_chunks",
# "triple" or "empty"; with its detail ("chunks" for "esc_chunks") and, on the
# ESC routes, the host seconds of each stage.
_ROUTE_STATE = threading.local()

# Above this many partial products the binned tile is tuned (JAX
# api.py:678-690): a doubled window when B's rows are long, else a doubled lane.
_BINNED_TUNE_PARTIALS = 12_000_000


def get_last_route() -> str | None:
    """Strategy chosen by the most recent :func:`sparse_matrix_multiply`
    on the calling thread."""
    return getattr(_ROUTE_STATE, "route", None)


def get_last_route_detail() -> dict:
    """Diagnostics recorded with the last route (``chunks`` for
    ``"esc_chunks"``); an empty dict when the route recorded none."""
    return getattr(_ROUTE_STATE, "detail", {}) or {}


def get_last_route_stages() -> dict:
    """Host seconds of each stage of the last :func:`sparse_matrix_multiply`
    on the calling thread, by stage name, on the ESC routes (``"esc_binned"``,
    ``"esc_windowed"``, ``"esc"``, ``"esc_chunks"``; a per-chunk stage is
    summed over the chunks); an empty dict on the other routes."""
    return getattr(_ROUTE_STATE, "stages", {}) or {}


def _set_route(route: str, **detail) -> None:
    _ROUTE_STATE.route = route
    _ROUTE_STATE.detail = detail
    _ROUTE_STATE.stages = {}


class _StageClock:
    """Host seconds of each stage of one routed call, each stage a ``with
    clock.stage(name)`` block, which a profiler sees as the span
    ``smm.route.<name>``; a stage run more than once (per chunk) sums.  On
    CUDA each stage waits for the device before it ends, so a stage holds
    the device work it queued.  The download that ends every ESC route waits
    for that work in any case, so the stages only move the wait, at a few
    microseconds each."""

    def __init__(self, device):
        device = torch.device(device)
        self._cuda = device if device.type == "cuda" else None
        self.seconds = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        with span("smm.route." + name):
            yield
            if self._cuda is not None:
                torch.cuda.synchronize(self._cuda)
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - start

    def finish(self, route: str, **detail) -> None:
        _set_route(route, **detail)
        _ROUTE_STATE.stages = self.seconds


def _coerce_csr(m):
    """Canonical scipy CSR: sorted indices, duplicates summed.  A caller's
    CSR matrix is never modified: a non-canonical one is copied first."""
    if not isspmatrix_csr(m):
        m = csr_matrix(m)
    elif not m.has_canonical_format:
        m = m.copy()
    if not m.has_canonical_format:
        m.sum_duplicates()
    return m


def _upload_dtype(a_sp, b_sp, device):
    """(upload dtype, resolved precision).  On CUDA under FAST the operands
    go up as float32 (all arithmetic is f32 anyway); elsewhere they keep
    their native f64 (``None``)."""
    if torch.device(device).type != "cuda":
        return None, None
    m, k = a_sp.shape
    n = b_sp.shape[1]
    terms = (a_sp.nnz * b_sp.nnz) / max(m * k * n, 1)
    prec = resolve_precision(None, terms)
    if prec == Precision.FAST:
        return torch.float32, prec
    return None, prec


def _value_bytes(a_sp, b_sp, device) -> int:
    """Bytes of one value on the wire: 4 when the upload dtype resolves to
    float32, else 8 (as JAX prices it)."""
    return 4 if _upload_dtype(a_sp, b_sp, device)[0] == torch.float32 else 8


def block_occupancy(mat, block_size: int) -> float:
    """Fraction of occupied (block_size x block_size) blocks of a scipy
    sparse matrix, in one O(nnz) pass without a sort: the block key of every
    entry, then a count per block (np.unique costs 2.6x as much at 1e7
    entries).  Nothing is cached, so an in-place edit of the pattern is
    always seen."""
    if not isspmatrix_csr(mat):
        mat = csr_matrix(mat)
    b = int(block_size)
    m, n = mat.shape
    nbr, nbc = -(-m // b), -(-n // b)
    if mat.nnz == 0:
        return 0.0
    block_starts = mat.indptr[np.minimum(np.arange(nbr + 1) * b, m)]
    block_row = np.repeat(np.arange(nbr, dtype=np.int64), np.diff(block_starts))
    keys = block_row * nbc + mat.indices[: mat.indptr[-1]] // b
    return np.count_nonzero(np.bincount(keys, minlength=nbr * nbc)) / (nbr * nbc)


def _block_sparse(mat, block_size: int, cutoff: float) -> bool:
    """``block_occupancy(mat, block_size) <= cutoff``, scanned a group of
    block-rows at a time and stopped as soon as the occupied count passes
    the cutoff (the same division, so the same answer as the full scan).
    A cutoff of 0 or less answers ``False`` without a scan."""
    if cutoff <= 0:
        return False
    if not isspmatrix_csr(mat):
        mat = csr_matrix(mat)
    b = int(block_size)
    m, n = mat.shape
    nbr, nbc = -(-m // b), -(-n // b)
    blocks = nbr * nbc
    step = max(1, -(-nbr // 16))
    occupied = 0
    for start in range(0, nbr, step):
        stop = min(start + step, nbr)
        bounds = mat.indptr[np.minimum(np.arange(start, stop + 1) * b, m)]
        block_row = np.repeat(np.arange(stop - start, dtype=np.int64), np.diff(bounds))
        keys = block_row * nbc + mat.indices[bounds[0]:bounds[-1]] // b
        occupied += np.count_nonzero(np.bincount(keys, minlength=(stop - start) * nbc))
        if occupied / blocks > cutoff:
            return False
    return occupied / blocks <= cutoff


def _bsr_route_ok(a_sp, device) -> bool:
    """Whether A goes down the BSR route: on CUDA, with the block size the
    kernels take, at least 2x2 blocks and at most
    ``cuda_bsr_occupancy_cutoff`` of them occupied (at the default 0, never:
    no scan runs); always with ``force_bsr``; never with ``use_bsr`` off."""
    cfg = get_config()
    if not cfg.use_bsr:
        return False
    if cfg.force_bsr:
        return True
    if torch.device(device).type != "cuda" or cfg.block_size != KERNEL_BLOCK:
        return False
    b = cfg.block_size
    m, k = a_sp.shape
    if m < 2 * b or k < 2 * b:
        return False  # fewer than 2x2 blocks: nothing to skip
    return _block_sparse(a_sp, b, cfg.cuda_bsr_occupancy_cutoff)


def _device_key(device) -> str:
    """The device a calibration belongs to: ``"cuda"`` names the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


# Calibrated link terms by device (_calibrate_link).
_LINK_TERMS: dict = {}
_PROBE_BYTES = 8 << 20
_PROBE_RUNS = 3


def _calibrate_link(device) -> dict:
    """Measure ``device``'s link and remember it: the ``link_*`` terms by name.

    JAX's probe (``sparse_matrix_mult_tpu/api.py:498-545``) in torch, with
    JAX's structure: the fixed term is one-element round trips read back by
    ``.item()``; the download and upload rates those of ``_PROBE_BYTES``
    copies net of the round trip.  Each is warmed once untimed and timed as
    the least of 3.  On CUDA the copies use pinned host memory: the link
    alone.  What :func:`fetch_np` adds on the host (its copy out of the
    pinned staging ring into a fresh array of the result's dtype, the cast
    fused in and the fresh pages faulted in) is host work that the CUDA cost
    model prices apart (``Config.host_copy_rate``).  Unlike JAX the terms
    are kept per device (a CPU calibration must not price a CUDA request),
    not written into the config, and a probe that fails raises.
    """
    key = _device_key(device)
    dev = torch.device(key)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def best(fn):
        fn()  # warm
        times = []
        for _ in range(_PROBE_RUNS):
            t0 = time.perf_counter()
            fn()
            sync()
            times.append(time.perf_counter() - t0)
        return min(times)

    one = torch.ones(1, device=dev)
    rtt = best(lambda: (one + 1.0).item())
    x = torch.full((_PROBE_BYTES // 4,), 2.0, dtype=torch.float32, device=dev)
    fetch_np(x)  # the staged path as the routes take it, warmed (the ring made)
    host = torch.ones(_PROBE_BYTES // 4, dtype=torch.float32, pin_memory=dev.type == "cuda")
    down_s = best(lambda: host.copy_(x))
    up_s = best(lambda: x.copy_(host))
    _LINK_TERMS[key] = dict(
        link_fixed_s=max(rtt, 1e-5),
        link_up_bytes_per_s=max(_PROBE_BYTES / max(up_s - rtt, 1e-5), 1e6),
        link_down_bytes_per_s=max(_PROBE_BYTES / max(down_s - rtt, 1e-5), 1e6))
    return _LINK_TERMS[key]


def _link_terms(device) -> dict:
    """The ``link_*`` terms that price ``device``'s requests: measured once
    per device with ``auto_calibrate_link``, else the config's."""
    cfg = get_config()
    if cfg.auto_calibrate_link:
        return _LINK_TERMS.get(_device_key(device)) or _calibrate_link(device)
    return dict(link_fixed_s=cfg.link_fixed_s, link_up_bytes_per_s=cfg.link_up_bytes_per_s,
                link_down_bytes_per_s=cfg.link_down_bytes_per_s)


def _est_result_nnz(expand: int, m: int, n: int) -> int:
    """Expected nnz(C) when ``expand`` partials land uniformly in the m*n
    output slots: a slot is hit with probability 1-exp(-expand/(m*n)).  Exact
    in both limits (hypersparse: nnz ~= expand; dense: nnz ~= m*n)."""
    slots = max(m * n, 1)
    return int(slots * (1.0 - np.exp(-expand / slots)))


def _route_costs(expand: int, a_sp, b_sp, device, out_bytes: int | None = None, *,
                 request: str | None = None, symmetric: bool = False, full: bool = False,
                 esc_limit: int | None = None):
    """(est_host, est_dev) seconds of a scipy-in request.

    JAX's cost model (``sparse_matrix_mult_tpu/api.py:557-599``), term for
    term, unless the request is on CUDA and names its device route
    (``request``): then :func:`_cuda_route_costs`.  JAX's: the host
    multiplies at ``host_rate_base * sqrt(reuse)`` partials/s, reuse =
    partials / expected nnz(C) (SPA cache reuse).  The device pays the
    link's fixed latency, the operands' upload and the result's download:
    ``out_bytes``, or for a sparse output the cheaper of packed CSR and the
    raw panel plus the host pack.  Entries are an int32 index and a value of
    the upload dtype.  The link terms are :func:`_link_terms`'.
    """
    link = _link_terms(device)
    if request is not None and torch.device(device).type == "cuda":
        return _cuda_route_costs(expand, a_sp, b_sp, link, request, symmetric, full, esc_limit)
    cfg = get_config()
    m = a_sp.shape[0]
    n = b_sp.shape[1]
    val_bytes = _value_bytes(a_sp, b_sp, device)
    entry_bytes = 4 + val_bytes
    nnz_est = _est_result_nnz(expand, m, n)
    down_bw = link["link_down_bytes_per_s"]
    if out_bytes is None:
        panel_cost = val_bytes * m * n / down_bw + m * n / cfg.host_pack_rate
        down_cost = min(entry_bytes * nnz_est / down_bw, panel_cost)
    else:
        down_cost = out_bytes / down_bw
    reuse = max(expand / max(nnz_est, 1), 1.0)
    est_host = expand / (cfg.host_rate_base * reuse**0.5)
    up_bytes = entry_bytes * (a_sp.nnz + b_sp.nnz)
    est_dev = link["link_fixed_s"] + up_bytes / link["link_up_bytes_per_s"] + down_cost
    return est_host, est_dev


# glibc's largest mmap threshold: a host array past it is mapped afresh, and
# its first writes fault its pages in (Config.host_page_rate).
_MMAP_BYTES = 32 << 20
# The synchronous transfers of one from_scipy (indptr, indices, values up) and
# of one to_scipy (the same three down): each waits out the link's fixed
# latency.
_TRANSFERS = 3
# The host bytes of one output entry: an int32 index and an f64 value.
_ENTRY_BYTES = 12


def _fresh(*nbytes) -> int:
    """The bytes of the host arrays of these sizes that land in fresh pages."""
    return sum(b for b in nbytes if b > _MMAP_BYTES)


def _single_row_entries(a_sp, b_sp) -> int:
    """The output entries of the rows of A that hold one stored entry: each
    is a copy of the B row its entry selects, so their count is the sum of
    those B rows' lengths.  O(rows of A and B); B's indices are not read."""
    indptr = np.asarray(a_sp.indptr)
    starts = indptr.take(np.flatnonzero(np.diff(indptr) == 1))
    return int(np.diff(b_sp.indptr).take(np.asarray(a_sp.indices).take(starts)).sum())


def _upload_cost(entries: float, operands: int, val_bytes: int, link: dict, cfg) -> float:
    """``from_scipy`` of ``operands`` host matrices of ``entries`` entries in
    all: three synchronous transfers each, an int32 index and a value of
    ``val_bytes`` an entry over the link, and the host work per entry
    (``host_upload_rate``)."""
    return (_TRANSFERS * operands * link["link_fixed_s"]
            + (4 + val_bytes) * entries / link["link_up_bytes_per_s"]
            + entries / cfg.host_upload_rate)


def _to_scipy_cost(nnz: float, val_bytes: int, link: dict, cfg,
                   fresh: float | None = None) -> float:
    """``to_scipy`` of a packed result of ``nnz`` entries on the card, its
    values cast to f64 in the download (:func:`_to_scipy_f64`): three
    synchronous fetches and ``4 + val_bytes`` bytes an entry over the link;
    ``fetch_np``'s host copies into an int32 and an f64 array (12 bytes an
    entry) at ``host_copy_rate``; the first writes of those arrays that land
    in fresh pages, which its copy threads fault in, at
    ``host_fetch_page_rate`` (``fresh``: their bytes, where the caller
    knows them better than the mmap threshold does); and the rest,
    ``csr_matrix`` and the staging ring's fixed work, at ``host_csr_rate``
    entries/s."""
    if fresh is None:
        fresh = _fresh(4 * nnz, 8 * nnz)
    return (_TRANSFERS * link["link_fixed_s"]
            + (4 + val_bytes) * nnz / link["link_down_bytes_per_s"]
            + _ENTRY_BYTES * nnz / cfg.host_copy_rate + fresh / cfg.host_fetch_page_rate
            + nnz / cfg.host_csr_rate)


def _fresh_copy_cost(nnz: float, cfg) -> float:
    """One copy of ``nnz`` entries of a host CSR into fresh arrays: the copy
    (``stitch_copy_rate``) and 12 bytes an entry of fresh pages
    (``host_page_rate``)."""
    return nnz / cfg.stitch_copy_rate + _ENTRY_BYTES * nnz / cfg.host_page_rate


def _stitch_cost(nnz: float, cfg) -> float:
    """``stitch_csr`` of parts of ``nnz`` entries in all: it concatenates
    their indices and values, then writes the output, two copies into fresh
    arrays (both chunked routes)."""
    return 2 * _fresh_copy_cost(nnz, cfg)


def _slice_cost(entries: float, cfg) -> float:
    """Row slices of A holding ``entries`` entries in all, each uploaded by
    ``from_scipy``: scipy's slice, and the canonical-format check of the new
    container, a pass of the same kind (both at ``host_slice_rate``)."""
    return 2 * entries / cfg.host_slice_rate


def _esc_chunk_count(expand: int, esc_limit: int) -> int:
    """The chunks :func:`_flop_chunk_bounds` cuts ``expand`` partials into
    at a budget of ``esc_limit``, as the cost model counts them:
    ``ceil(expand / esc_limit)``, no pass over A (the cut adds at most one
    while no row of A holds more than a small share of the budget)."""
    return max(1, -(-int(expand) // max(int(esc_limit), 1)))


def _esc_stage_costs(expand: int, a_sp, b_sp, nnz: int, val_bytes: int, link: dict, request: str,
                     esc_limit: int | None) -> dict:
    """The device side of an ESC route (``request`` ``"esc"`` or
    ``"esc_chunks"``) by the stages the router times
    (:func:`get_last_route_stages`), in seconds; ``nnz``: the result's
    entries.  The expansion both routes count is not priced, nor the chunked
    route's ``row_flops`` and chunk bounds.

    ``"esc"``: the window plan (``esc_plan_rate``), both uploads
    (:func:`_upload_cost`), the engine (``esc_fixed_s``, its launches and
    its host sync, and partials at ``esc_engine_rate``) and ``to_scipy``
    (:func:`_to_scipy_cost`).  ``"esc_chunks"``, as
    :func:`_sparse_out_chunked_esc` runs it: ``ceil(expand / esc_limit)``
    chunks (``_flop_chunk_bounds`` cuts at that budget); B's upload and the
    one window plan; each chunk's row slice of A (:func:`_slice_cost`) and
    its upload; the engine's fixed time per chunk; each chunk's
    ``to_scipy``, the slice ``[:rows]`` of its rows (``host_slice_rate``) and
    that part's bytes as fresh pages, since every part is held until the
    stitch (:func:`_stitch_cost`)."""
    cfg = get_config()
    plan = a_sp.nnz / cfg.esc_plan_rate
    engine = expand / cfg.esc_engine_rate
    if request == "esc":
        return dict(windowed_plan=plan,
                    upload=_upload_cost(a_sp.nnz + b_sp.nnz, 2, val_bytes, link, cfg),
                    engine=cfg.esc_fixed_s + engine,
                    download=_to_scipy_cost(nnz, val_bytes, link, cfg))
    chunks = _esc_chunk_count(expand, esc_limit or cfg.esc_expand_limit)
    part = nnz / chunks
    return dict(upload_b=_upload_cost(b_sp.nnz, 1, val_bytes, link, cfg),
                windowed_plan=plan,
                chunk_upload=(_slice_cost(a_sp.nnz, cfg)
                              + _upload_cost(a_sp.nnz, chunks, val_bytes, link, cfg)),
                engine=chunks * cfg.esc_fixed_s + engine,
                download=(chunks * _to_scipy_cost(part, val_bytes, link, cfg)
                          + nnz / cfg.host_slice_rate + _ENTRY_BYTES * nnz / cfg.host_page_rate),
                stitch=_stitch_cost(nnz, cfg))


def _cuda_route_costs(expand: int, a_sp, b_sp, link: dict, request: str, symmetric: bool,
                      full: bool, esc_limit: int | None = None, stages: bool = False):
    """(est_host, est_dev) of a CUDA request: each side prices the host work
    of the route it would take, at the rates of the config, and the device
    side the link (:func:`_link_terms`) as in JAX and the host work of the
    upload (:func:`_upload_cost`).  Of the device's own time only the ESC
    engine's is priced (``esc_fixed_s``, ``esc_engine_rate``): the dense
    route's kernels take a few ms where its host work takes tens.

    ``request``: the device route of a sparse output (``"dense"``,
    ``"esc"``, ``"dense_chunks"``, ``"esc_chunks"``;
    :func:`_sparse_device_route`; ``esc_limit`` its ESC budget, which sets
    the chunks of ``"esc_chunks"``), ``"dense_output"`` or ``"triple"``
    (``expand`` is then JAX's, twice the expansion of H Q; ``full``:
    ``compute_full_matrix``).  The host side: ``spgemm_host`` at
    ``host_partial_rate`` per partial and ``host_entry_rate`` per output
    entry, but ``host_copy_entry_rate`` for the entries of A's rows of one
    stored entry (:func:`_single_row_entries`: each such row copies one B
    row), and its output's fresh pages, which its threads fault in
    together, at ``host_out_page_rate``; for the triple scipy's
    ``(H Q) H^T`` at ``scipy_partial_rate``; a dense result's f64 passes
    (``toarray``, ``triu``, the mirror) at ``host_f64_rate`` (a symmetric
    output's ``toarray`` touches half its pages).  The device side: the
    link; each array ``fetch_np`` downloads, its host copy into an array of
    the result's own dtype (the f64 cast fused into it) at
    ``host_copy_rate`` bytes of that array per second, and that array's
    fresh pages at ``host_fetch_page_rate`` (a result under
    ``utils.transfer.STAGE_MIN_BYTES`` downloads pageable, within 0.3 ms of
    that price on an H100 host);
    ``to_scipy`` by its parts (:func:`_to_scipy_cost`); the ESC routes by
    their stages (:func:`_esc_stage_costs`); and the dense routes' host
    work: ``_fetch_full_triu``'s rebuild (``triu_rebuild_rate``), the panel
    pack (``host_pack_rate``) or a small panel's ``csr_matrix``
    (``dense_csr_rate``), and ``"dense_chunks"``'s row slices of A
    (:func:`_slice_cost`) and uploads of B per chunk, parts held until the stitch
    (:func:`_stitch_cost`) and, when ``symmetric``, ``csr_triu``'s copy of
    the triangle.  On both sides every other host array past
    ``_MMAP_BYTES`` also pays for its fresh pages (``host_page_rate``).
    With ``stages`` an ESC route's device side comes as its stages
    (:func:`_esc_stage_costs`) in place of their sum.
    """
    cfg = get_config()
    m, k = a_sp.shape
    n = b_sp.shape[1]
    val_bytes = _value_bytes(a_sp, b_sp, "cuda")

    def page(*nbytes):
        return _fresh(*nbytes) / cfg.host_page_rate

    def download(*arrays):
        # each array: (its bytes on the card, the bytes of the host array it lands in)
        return (sum(d for d, _ in arrays) / link["link_down_bytes_per_s"]
                + sum(h for _, h in arrays) / cfg.host_copy_rate
                + _fresh(*(h for _, h in arrays)) / cfg.host_fetch_page_rate)

    upload = _upload_cost(a_sp.nnz + b_sp.nnz, 2, val_bytes, link, cfg)
    if request == "triple":
        hq = _est_result_nnz(expand // 2, m, k)  # entries of H Q, each meeting H^T's mean row
        partials = expand // 2 + hq * a_sp.nnz / max(k, 1)
        passes = 4 if full else 2  # toarray and triu, then triu(c, 1).T and the sum
        est_host = (partials / cfg.scipy_partial_rate
                    + passes * (m * m / cfg.host_f64_rate + page(8 * m * m)))
        return est_host, upload + download((val_bytes * m * m, 8 * m * m))
    slots = m * n
    full_nnz = nnz = _est_result_nnz(expand, m, n)
    copied = _single_row_entries(a_sp, b_sp)
    if symmetric and m == n:
        nnz = nnz * (m + 1) // (2 * m)  # the upper triangle's share
        copied = copied * (m + 1) // (2 * m)
    est_host = (expand / cfg.host_partial_rate + copied / cfg.host_copy_entry_rate
                + max(nnz - copied, 0) / cfg.host_entry_rate
                + _fresh(4 * nnz, 8 * nnz) / cfg.host_out_page_rate)
    if request == "dense_output":
        # toarray writes the output's entries into zeroed pages: a triangle's
        # touch half of them; the device route's download writes every element
        touched = 0.5 if symmetric and m == n else 1.0
        return (est_host + touched * (slots / cfg.host_f64_rate + page(8 * slots)),
                upload + download((val_bytes * slots, 8 * slots)))
    if request in ("esc", "esc_chunks"):
        costs = _esc_stage_costs(expand, a_sp, b_sp, nnz, val_bytes, link, request, esc_limit)
        return est_host, costs if stages else sum(costs.values())
    chunks = 1
    if request == "dense_chunks":
        # equal row chunks, each the single-shot dense route on its rows of A
        # and all of B, of the full product (the triangle is cut after the stitch)
        chunks = -(-m // max(1, min(m, cfg.dense_path_limit // max(n, 1))))
        upload = (_upload_cost(a_sp.nnz + chunks * b_sp.nnz, 2 * chunks, val_bytes, link, cfg)
                  + _slice_cost(a_sp.nnz, cfg))
        nnz = full_nnz
    est_dev = upload
    panel_bytes = val_bytes * slots
    held = request == "dense_chunks"  # every part is held until the stitch
    if request == "dense" and slots <= cfg.host_extract_limit:
        # the panel cast to f64 in the download, then csr_matrix
        est_dev += download((panel_bytes, 8 * slots)) + slots / cfg.dense_csr_rate
    elif request == "dense" and symmetric and m == n and slots * np.exp(-expand / slots) < 1:
        # a full triangle (under one empty slot expected): values only, cast
        # to f64 in the download, then the indices' rebuild
        est_dev += download((val_bytes * nnz, 8 * nnz)) + nnz / cfg.triu_rebuild_rate
    elif panel_bytes < (4 + val_bytes) * fine_capacity(nnz):
        part = panel_bytes / chunks
        packed = _ENTRY_BYTES * nnz / cfg.host_page_rate if held else page(4 * nnz, 8 * nnz)
        est_dev += chunks * download((part, part)) + slots / cfg.host_pack_rate + packed
    else:
        part = nnz / chunks
        est_dev += chunks * _to_scipy_cost(part, val_bytes, link, cfg,
                                           fresh=_ENTRY_BYTES * part if held else None)
    if request == "dense_chunks":
        est_dev += _stitch_cost(nnz, cfg)
        if symmetric:
            est_dev += _fresh_copy_cost(full_nnz * (m + 1) // (2 * m), cfg)  # csr_triu
    return est_host, est_dev


def _host_route_wins(expand: int, a_sp, b_sp, device, out_bytes: int | None = None,
                     **request) -> bool:
    """Whether the cost model sends a scipy-in request to the host
    (:func:`_route_costs`).  The device-resident entry points never ask."""
    est_host, est_dev = _route_costs(expand, a_sp, b_sp, device, out_bytes, **request)
    return est_host < est_dev


def _request_costs(a_sp, b_sp, device, output_format="sparse", symmetric=False,
                   use_triple_product=False, compute_full_matrix=0, imem_size=None):
    """(est_host, est_dev) the router's cost model gives a
    :func:`sparse_matrix_multiply` request with these arguments (the
    branch's expansion, download and, on CUDA, device route)."""
    a_sp, b_sp = _coerce_csr(a_sp), _coerce_csr(b_sp)
    expand = expansion_size(a_sp.indices, a_sp.nnz, b_sp.indptr)
    val_bytes = _value_bytes(a_sp, b_sp, device)
    m, n = a_sp.shape[0], b_sp.shape[1]
    if use_triple_product:
        return _route_costs(2 * expand, a_sp, b_sp, device, out_bytes=val_bytes * m * m,
                            request="triple", full=bool(compute_full_matrix))
    if output_format == "dense":
        return _route_costs(expand, a_sp, b_sp, device, out_bytes=val_bytes * m * n,
                            request="dense_output", symmetric=symmetric)
    esc_limit = _esc_limit(imem_size)
    route = _sparse_device_route(expand, a_sp, b_sp, esc_limit, device)
    return _route_costs(expand, a_sp, b_sp, device, request=route, symmetric=symmetric,
                        esc_limit=esc_limit)


def _request_stage_costs(a_sp, b_sp, device, symmetric=False, imem_size=None) -> dict:
    """The device side the router's cost model prices for a sparse-output
    CUDA request whose device route is an ESC route, by the stages that
    route times (:func:`_esc_stage_costs`); an empty dict on the other
    routes."""
    a_sp, b_sp = _coerce_csr(a_sp), _coerce_csr(b_sp)
    expand = expansion_size(a_sp.indices, a_sp.nnz, b_sp.indptr)
    esc_limit = _esc_limit(imem_size)
    route = _sparse_device_route(expand, a_sp, b_sp, esc_limit, device)
    if route not in ("esc", "esc_chunks"):
        return {}
    return _cuda_route_costs(expand, a_sp, b_sp, _link_terms(device), route, symmetric, False,
                             esc_limit, stages=True)[1]


def _bsr_product_host(a_sp, b_sp, symmetric: bool, device) -> torch.Tensor:
    """Dense product of a block-sparse A on ``device``, float32 on every
    device as in the JAX route: K6 (BSR x BSR over the planned block pairs)
    when B is block-sparse too and the plan does less than 0.9 of K5's tile
    products, else K3 densifies B and K5 multiplies (BSR x dense).

    Each operand is converted by ``_tobsr_padded`` once; the container and
    the pair planner share the result, so their block slots line up.
    """
    cfg = get_config()
    bsz = cfg.block_size
    bs_a = _tobsr_padded(a_sp, bsz)
    a_bsr = bsr_from_scipy(a_sp, bsz, torch.float32, padded_bsr=bs_a, device=device)
    c = None
    if _block_sparse(b_sp, bsz, cfg.bsr_occupancy_cutoff):
        bs_b = _tobsr_padded(b_sp, bsz)
        plan = bsr_pair_plan(a_sp, b_sp, bsz, bs_a=bs_a, bs_b=bs_b)
        nbc = -(-b_sp.shape[1] // bsz)
        if plan is not None and plan["n_pairs"] < 0.9 * plan["n_a_blocks"] * nbc:
            b_bsr = bsr_from_scipy(b_sp, bsz, torch.float32, padded_bsr=bs_b, device=device)
            n = plan["n_pairs"]  # the real pairs only: no padding crosses
            tables = [torch.from_numpy(plan[key][:n]).to(device)
                      for key in ("pa", "pb", "ci", "cj", "first")]
            mask = torch.from_numpy(plan["mask"]).to(device)
            c = bsr_bsr_matmul_dense(a_bsr, b_bsr, *tables, mask)
    if c is None:
        b = from_scipy(b_sp, dtype=torch.float32, device=device)
        c = bsr_matmul_dense(a_bsr, csr_to_dense(b))
    return torch.triu(c) if symmetric else c


def _extract_csr(c: torch.Tensor, out_capacity: int, symmetric: bool = False) -> CSRMatrix:
    if symmetric and c.shape[0] == c.shape[1]:
        return dense_to_csr_triu(c, out_capacity)
    return dense_to_csr(c, out_capacity)


def _dense_to_scipy_csr(a_sp, b_sp, symmetric: bool, device):
    """Single-shot dense route: product on ``device`` (the BSR kernels for a
    block-sparse A, :func:`_bsr_product_host`), then extraction.

    * small outputs (<= ``host_extract_limit`` elements): download the
      panel and pack it with scipy;
    * a fully dense upper triangle: values only (:func:`_fetch_full_triu`);
    * dense-ish outputs (panel bytes < packed-CSR bytes): download the panel
      and pack it on the host;
    * sparse outputs: extract packed CSR on the device (K2/K4), download it.
    """
    m = a_sp.shape[0]
    n = b_sp.shape[1]
    if _bsr_route_ok(a_sp, device):
        c = _bsr_product_host(a_sp, b_sp, symmetric, device)
        _set_route("bsr")
    else:
        dtype, _ = _upload_dtype(a_sp, b_sp, device)
        a = from_scipy(a_sp, dtype=dtype, device=device)
        b = from_scipy(b_sp, dtype=dtype, device=device)
        c = spgemm_dense_out(a, b, symmetric=symmetric)
        _set_route("dense")
    if m * n <= get_config().host_extract_limit:
        return csr_matrix(fetch_np(c, np.float64))

    nnz = int(torch.count_nonzero(c))  # one scalar fetch; decides the download format

    if symmetric and m == n and nnz == m * (m + 1) // 2:
        return _fetch_full_triu(c, nnz)

    panel_bytes = m * n * c.element_size()
    csr_bytes = (4 + c.element_size()) * fine_capacity(nnz)
    if panel_bytes < csr_bytes:
        return fetch_dense_to_csr(c, symmetric=symmetric, nnz=nnz)

    return _to_scipy_f64(_extract_csr(c, bucket_capacity(nnz), symmetric=symmetric))


def _fetch_full_triu(c: torch.Tensor, nnz: int):
    """Download a fully dense upper-triangular product as values only.

    The device extracts the triangle (K2); only the values cross to the
    host, where the indices are rebuilt arithmetically (row i holds columns
    i..n-1).  Row counts can never exceed n-i, so nnz == n(n+1)/2 forces
    every row to be full.
    """
    m = c.shape[0]
    csr = _extract_csr(c, bucket_capacity(nnz), symmetric=True)
    indptr = fetch_np(csr.indptr)
    if int(indptr[-1]) != nnz:
        raise RuntimeError(f"triu extraction produced {int(indptr[-1])} entries, expected {nnz}")
    values = fetch_np(csr.values[:nnz], np.float64)
    return _full_triu_csr(values, indptr, m)


def _full_triu_csr(values: np.ndarray, indptr: np.ndarray, m: int):
    """scipy CSR of a full (m, m) upper triangle from its values and row
    pointers: row i holds columns i..m-1, so its indices are a suffix of one
    ``arange(m)``, written once into one int32 array.  Index arrays that
    are int32 already spare scipy a scan to choose its index type."""
    nnz = len(values)
    if nnz <= np.iinfo(np.int32).max:
        indptr = np.asarray(indptr, dtype=np.int32)
    base = np.arange(m, dtype=np.int32)
    indices = np.empty(nnz, dtype=np.int32)
    bounds = indptr.tolist()
    for i in range(m):
        indices[bounds[i]:bounds[i + 1]] = base[i:i + bounds[i + 1] - bounds[i]]
    return csr_matrix((values, indices, indptr), shape=(m, m))


def _to_scipy_f64(c: CSRMatrix):
    """``to_scipy`` with the values cast to f64 in the download."""
    return to_scipy(c, np.float64)


def _binned_plan_for(a_sp, b_sp, expand: int):
    """The router's binned plan for ``a_sp @ b_sp``, or ``None``.

    Above ``_BINNED_TUNE_PARTIALS`` partials the tile is tuned as in JAX
    (``api.py:664-690``): the window doubles when B's mean row length
    exceeds 3/4 of it, else the lane doubles.  When the tuned tile gives no
    plan, the configured tile is tried once more before the router falls
    back (R3 in ``ROADMAP.md``; JAX goes straight to the fallback).
    """
    cfg = get_config()
    tiles = [(cfg.binned_window, cfg.binned_lane_width)]
    if expand > _BINNED_TUNE_PARTIALS:
        window, lane = tiles[0]
        if b_sp.nnz / max(b_sp.shape[0], 1) > 0.75 * window:
            tiles.insert(0, (2 * window, lane))
        else:
            tiles.insert(0, (window, 2 * lane))
    for window, lane in tiles:
        plan = binned_plan(a_sp.indptr, a_sp.indices, b_sp.indptr, window=window,
                           lane_width=lane)
        if plan is not None:
            return plan
    return None


def _binned_budget(esc_limit: int, device):
    """(binned budget, whether the binned rung runs) of the ladder whose ESC
    budget is ``esc_limit``: the binned budget scales with it as in JAX.  On
    CUDA the binned rung runs only with ``binned_esc_on_cuda``; without it
    the windowed rung takes the binned budget."""
    cfg = get_config()
    budget = 0
    if cfg.use_binned_esc:
        budget = int(cfg.binned_expand_limit * (esc_limit / cfg.esc_expand_limit))
    return budget, budget > 0 and (torch.device(device).type != "cuda" or cfg.binned_esc_on_cuda)


def _sparse_device_route(expand: int, a_sp, b_sp, esc_limit: int, device) -> str:
    """The rung a sparse-output request takes when it stays on the device:
    ``"dense"``, ``"esc"`` (binned, windowed or classic), ``"dense_chunks"``
    or ``"esc_chunks"`` (the ladder of :func:`_sparse_out_host`)."""
    m, k = a_sp.shape
    n = b_sp.shape[1]
    wide = max(esc_limit, _binned_budget(esc_limit, device)[0])
    keep = get_config().keep_structure
    sparse_wins = expand <= wide and 4 * expand <= m * n
    if dense_path_fits((m, k), (k, n), (m, n)) and not keep and not sparse_wins:
        return "dense"
    if expand <= wide:
        return "esc"
    if dense_path_fits((k, n)) and not keep:
        return "dense_chunks"
    return "esc_chunks"


def _sparse_out_host(a_sp, b_sp, symmetric: bool, esc_limit: int, device):
    """sparse x sparse -> scipy CSR: the JAX strategy ladder, first match wins.

    0. few partial products, or -> native host Gustavson (unless force_bsr)
       the cost model says host    (unless A takes the BSR route)
    1. everything fits densely  -> dense route (unless ESC would win),
                                   BSR kernels for a block-sparse A
    2. expansion within budget  -> binned ESC, else windowed or classic ESC
                                   (on CUDA windowed or classic: the binned
                                   rung only with ``binned_esc_on_cuda``)
    3. B's panel fits densely   -> equal-row dense chunks
    4. otherwise                -> flop-balanced ESC chunks

    Every engine runs on ``device``; ``keep_structure`` skips the routes that
    prune exact zeros (1 and 3).  The ESC routes record their stages'
    host seconds (:func:`get_last_route_stages`).
    """
    m = a_sp.shape[0]
    n = b_sp.shape[1]
    cfg = get_config()
    clock = _StageClock(device)
    with clock.stage("expansion_size"):
        expand = expansion_size(a_sp.indices, a_sp.nnz, b_sp.indptr)
    keep = cfg.keep_structure
    route = _sparse_device_route(expand, a_sp, b_sp, esc_limit, device)
    # _bsr_route_ok stays behind the model: its occupancy scan runs only
    # when the model already says "host".
    if (expand <= cfg.host_compute_limit and not cfg.force_bsr) or (
            _host_route_wins(expand, a_sp, b_sp, device, request=route, symmetric=symmetric,
                             esc_limit=esc_limit)
            and not (_bsr_route_ok(a_sp, device) and not keep)):
        out = spgemm_host(a_sp, b_sp, symmetric, n_partials=expand, keep_structure=keep)
        _set_route("host")
        return out

    if route == "dense":
        return _dense_to_scipy_csr(a_sp, b_sp, symmetric, device)
    if route == "esc":
        binned_budget, binned = _binned_budget(esc_limit, device)
        dtype, _ = _upload_dtype(a_sp, b_sp, device)
        out_cap = bucket_capacity(min(expand, m * n))
        plan = wplan = None
        if binned and expand <= binned_budget:
            with clock.stage("binned_plan"):
                plan = _binned_plan_for(a_sp, b_sp, expand)
        if plan is None:
            if binned and expand > esc_limit:  # past the ESC budget only the binned rung runs
                return _sparse_out_chunked_esc(a_sp, b_sp, symmetric, esc_limit, device, clock)
            with clock.stage("windowed_plan"):
                wplan = windowed_plan(a_sp.nnz, np.diff(b_sp.indptr)[a_sp.indices], expand)
            if wplan is None and expand > esc_limit:  # the classic engine keeps the ESC budget
                return _sparse_out_chunked_esc(a_sp, b_sp, symmetric, esc_limit, device, clock)
        with clock.stage("upload"):
            a = from_scipy(a_sp, dtype=dtype, device=device)
            b = from_scipy(b_sp, dtype=dtype, device=device)
            args = plan.device_args(device) if plan is not None else None
        with clock.stage("engine"):
            if plan is not None:
                c = spgemm_esc_binned(a, b, *args, window=plan.window, out_capacity=out_cap,
                                      symmetric=symmetric, dedup_span=plan.max_run)
                route = "esc_binned"
            elif wplan is not None:
                w, tail = wplan
                c = spgemm_esc_windowed(a, b, window=w, expand_capacity=bucket_capacity(expand),
                                        tail_capacity=bucket_capacity(tail) if tail else 0,
                                        out_capacity=out_cap, symmetric=symmetric)
                route = "esc_windowed"
            else:
                c = spgemm_esc(a, b, expand_capacity=bucket_capacity(expand),
                               out_capacity=out_cap, symmetric=symmetric)
                route = "esc"
        with clock.stage("download"):
            out = _to_scipy_f64(c)
        clock.finish(route)
        return out
    if route == "dense_chunks":
        out = _sparse_out_chunked_dense(a_sp, b_sp, symmetric, device)
        _set_route("dense_chunks")
        return out
    return _sparse_out_chunked_esc(a_sp, b_sp, symmetric, esc_limit, device, clock)


def _chunk_rows_padded(a_sp, start: int, stop: int, rows_pad: int, dtype, device) -> CSRMatrix:
    """Rows [start, stop) of a scipy CSR as a container of ``rows_pad`` rows
    (the trailing rows empty), as JAX buckets its chunks' shapes."""
    sub = a_sp[start:stop]
    indptr = np.zeros(rows_pad + 1, dtype=np.int32)
    indptr[: stop - start + 1] = sub.indptr
    indptr[stop - start + 1:] = sub.indptr[-1]
    padded = sp.csr_matrix((sub.data, sub.indices, indptr), shape=(rows_pad, a_sp.shape[1]))
    return from_scipy(padded, dtype=dtype, device=device)


def _flop_chunk_bounds(flops: np.ndarray, expand_limit: int, max_rows: int):
    """Contiguous row-chunk boundaries with ~``expand_limit`` partial products
    and at most ``max_rows`` rows per chunk.  A row heavier than the limit is
    a chunk of its own, so the walk always advances."""
    m = len(flops)
    csum = np.concatenate([[0.0], np.cumsum(flops, dtype=np.float64)])
    bounds = [0]
    while bounds[-1] < m:
        start = bounds[-1]
        stop = int(np.searchsorted(csum, csum[start] + expand_limit, "right")) - 1
        stop = min(max(stop, start + 1), start + max_rows, m)
        bounds.append(stop)
    return bounds


def _sparse_out_chunked_esc(a_sp, b_sp, symmetric: bool, esc_limit, device, clock):
    """Flop-balanced row-chunked ESC (route ``"esc_chunks"``): each chunk of
    ~``esc_limit`` partials goes through the windowed engine (one window plan
    for the whole operand) or the classic one, B uploaded once; the chunks'
    CSR pieces are stitched on the host.  Every chunk gets the whole
    operand's tail as its ``tail_capacity``: the engine computes the exact
    expansion, so the tail only has to pass its check, and a chunk's tail
    is never larger than the whole's."""
    m = a_sp.shape[0]
    n = b_sp.shape[1]
    with clock.stage("row_flops"):
        flops = row_flops(a_sp.indptr, a_sp.indices, b_sp.indptr)
    with clock.stage("chunk_bounds"):
        bounds = _flop_chunk_bounds(flops, esc_limit or get_config().esc_expand_limit, m)
    dtype, _ = _upload_dtype(a_sp, b_sp, device)
    with clock.stage("upload_b"):
        b = from_scipy(b_sp, dtype=dtype, device=device)
    csum = np.concatenate([[0], np.cumsum(flops, dtype=np.int64)])
    with clock.stage("windowed_plan"):
        plan = windowed_plan(a_sp.nnz, np.diff(b_sp.indptr)[a_sp.indices], int(csum[-1]))
    parts = []
    for start, stop in zip(bounds[:-1], bounds[1:]):
        rows_c = stop - start
        rows_pad = min(bucket_capacity(rows_c, minimum=1), bucket_capacity(m, minimum=1))
        expand = int(csum[stop] - csum[start])
        with clock.stage("chunk_upload"):
            a_chunk = _chunk_rows_padded(a_sp, start, stop, rows_pad, dtype, device)
        kw = dict(expand_capacity=bucket_capacity(max(expand, 1)),
                  out_capacity=bucket_capacity(max(min(expand, rows_pad * n), 1)),
                  symmetric=symmetric, row_offset=start)
        with clock.stage("engine"):
            if plan is not None:
                c = spgemm_esc_windowed(a_chunk, b, window=plan[0],
                                        tail_capacity=bucket_capacity(plan[1]) if plan[1] else 0,
                                        **kw)
            else:
                c = spgemm_esc(a_chunk, b, **kw)
        with clock.stage("download"):
            parts.append(_to_scipy_f64(c)[:rows_c])
    with clock.stage("stitch"):
        out = stitch_csr(parts, m, n)
    clock.finish("esc_chunks", chunks=len(bounds) - 1)
    return out


def _sparse_out_chunked_dense(a_sp, b_sp, symmetric: bool, device):
    """Row-chunked dense route (``"dense_chunks"``): B's (k, n) panel fits but
    the output does not.  Equal rows per chunk (the dense cost of a chunk is
    rows * k * n whatever its sparsity); each chunk takes the single-shot
    dense route, and the symmetric filter runs on the stitched result."""
    m = a_sp.shape[0]
    n = b_sp.shape[1]
    chunk = max(1, min(m, get_config().dense_path_limit // max(n, 1)))
    parts = [_dense_to_scipy_csr(a_sp[start:min(start + chunk, m)], b_sp, False, device)
             for start in range(0, m, chunk)]
    out = stitch_csr(parts, m, n)
    if out.dtype != np.float64:
        out = out.astype(np.float64)
    return csr_triu(out) if symmetric else out


def _triple_product_host(a_sp, b_sp, compute_full_matrix: int, device) -> np.ndarray:
    """Dense ``A . B . A^T`` of scipy operands, as an f64 ndarray.

    Small products (twice the expansion of ``A . B`` at or below
    ``host_compute_limit``) are multiplied on the host in f64: below the
    device dispatch floor, and where FAST's f32 accumulation would risk the
    oracle's rtol = 1e-5 on mixed-sign operands; so are those the cost model
    prices cheaper there (:func:`_route_costs`, the m x m result as the
    download).  The rest go through
    :func:`triple_product_dense` on ``device`` (route ``"triple"``).
    """
    if a_sp.shape[1] != b_sp.shape[1]:
        raise ValueError(
            "Triple product requires B.cols == A.cols so that (A.B).A^T "
            "is well defined."
        )
    m = a_sp.shape[0]
    expand = 2 * expansion_size(a_sp.indices, a_sp.nnz, b_sp.indptr)
    if expand <= get_config().host_compute_limit or _host_route_wins(
            expand, a_sp, b_sp, device, out_bytes=_value_bytes(a_sp, b_sp, device) * m * m,
            request="triple", full=bool(compute_full_matrix)):
        c = ((a_sp @ b_sp) @ a_sp.T).toarray()
        upper = np.triu(c)
        _set_route("host")
        return upper + np.triu(c, 1).T if compute_full_matrix else upper
    dtype, _ = _upload_dtype(a_sp, b_sp, device)
    h = from_scipy(a_sp, dtype=dtype, device=device)
    q = from_scipy(b_sp, dtype=dtype, device=device)
    result = fetch_np(triple_product_dense(h, q, compute_full_matrix), np.float64)
    _set_route("triple")
    return result


def _zero_notice(result):
    if not get_config().zero_result_notice:
        return
    if isinstance(result, np.ndarray) and np.all(result == 0):
        print("Multiplication resulted in a zero matrix.")
    elif sp.issparse(result) and result.nnz == 0:
        print("Multiplication resulted in a zero matrix.")


def _esc_limit(imem_size) -> int:
    """The partial-product budget of the ESC rung: ``esc_expand_limit``
    scaled by ``imem_size`` (1..10, default 5)."""
    if imem_size is None:
        imem_size = 5
    else:
        try:
            imem_size = int(imem_size)
        except (ValueError, TypeError):
            raise ValueError(f"imem_size must be an integer or None, got {type(imem_size)}")
    pct = imem_size if 0 < imem_size <= 10 else 10
    return max(1, get_config().esc_expand_limit * pct // 5)


def sparse_matrix_multiply(
    matrix_a,
    matrix_b,
    output_format="sparse",
    symmetric=False,
    imem_size=None,
    use_triple_product=False,
    compute_full_matrix=None,
    *,
    device=None,
):
    """Multiply two sparse matrices on ``device``; reference-parity dispatcher.

    * ``output_format='sparse'`` -> scipy CSR (upper triangle only when
      ``symmetric=True``);
    * ``output_format='dense'``  -> numpy ndarray (upper triangle only when
      ``symmetric=True``);
    * ``use_triple_product=True`` -> numpy ndarray ``A . B . A^T`` (upper
      triangle, mirrored into the lower with ``compute_full_matrix=1``;
      ``output_format`` is ignored).

    ``device`` defaults to ``Config.device``.  ``imem_size`` (1..10, default
    5) scales the partial-product budget the router compares the expansion
    against.  Exact-zero entries of the product are pruned on the dense
    route; ``Config.keep_structure=True`` asks for Gustavson structure.
    """
    esc_limit = _esc_limit(imem_size)

    if compute_full_matrix is None:
        compute_full_matrix = 0
    elif compute_full_matrix not in (0, 1):
        raise ValueError("compute_full_matrix must be None, 0, or 1")

    device = device or get_config().device
    matrix_a = _coerce_csr(matrix_a)
    matrix_b = _coerce_csr(matrix_b)

    if matrix_a.shape[1] != matrix_b.shape[0]:
        raise ValueError("Matrix dimensions are incompatible for multiplication.")

    if matrix_a.nnz == 0 or matrix_b.nnz == 0:
        _set_route("empty")
        if use_triple_product:
            return np.zeros((matrix_a.shape[0], matrix_a.shape[0]))
        if output_format == "sparse":
            return csr_matrix((matrix_a.shape[0], matrix_b.shape[1]))
        return np.zeros((matrix_a.shape[0], matrix_b.shape[1]))

    if symmetric and (matrix_a.shape[0] != matrix_b.shape[1]):
        raise ValueError("For symmetric output, the resulting matrix must be square.")

    if use_triple_product:
        result = _triple_product_host(matrix_a, matrix_b, compute_full_matrix, device)
    elif output_format == "sparse":
        result = _sparse_out_host(matrix_a, matrix_b, symmetric, esc_limit, device)
    elif output_format == "dense":
        cfg = get_config()
        expand = expansion_size(matrix_a.indices, matrix_a.nnz, matrix_b.indptr)
        out_bytes = matrix_a.shape[0] * matrix_b.shape[1] * _value_bytes(matrix_a, matrix_b, device)
        # JAX's decision, host iff small or (the model says host and A is not
        # block-sparse), with the occupancy scan run once.
        small = expand <= cfg.host_compute_limit and not cfg.force_bsr
        bsr = not small and _bsr_route_ok(matrix_a, device)
        if small or (not bsr and _host_route_wins(expand, matrix_a, matrix_b, device,
                                                  out_bytes=out_bytes, request="dense_output",
                                                  symmetric=symmetric)):
            result = spgemm_host(matrix_a, matrix_b, symmetric, n_partials=expand).toarray()
            _set_route("host")
        elif bsr:
            c = _bsr_product_host(matrix_a, matrix_b, symmetric, device)
            result = fetch_np(c, np.float64)
            _set_route("bsr")
        else:
            dtype, _ = _upload_dtype(matrix_a, matrix_b, device)
            a = from_scipy(matrix_a, dtype=dtype, device=device)
            b = from_scipy(matrix_b, dtype=dtype, device=device)
            result = fetch_np(spgemm_dense_out(a, b, symmetric=symmetric), np.float64)
            _set_route("dense")
    else:
        raise ValueError("Invalid output_format. Choose 'sparse' or 'dense'.")

    _zero_notice(result)
    return result


def multiply(
    a: CSRMatrix,
    b: CSRMatrix,
    *,
    output_format: str = "sparse",
    symmetric: bool = False,
    out_capacity: int | None = None,
    expand_capacity: int | None = None,
    precision: str | None = None,
    window: int | None = None,
    tail_capacity: int = 0,
    b_table=None,
    plan=None,
):
    """Device-resident multiply: containers in, a dense tensor or a padded
    :class:`CSRMatrix` out, all on the operands' device.

    The sparse output needs a static ``out_capacity``.  With ``plan=``
    (:func:`.ops.spgemm_binned.binned_plan` of the operands' structure) it
    runs the binned ESC engine; with ``expand_capacity`` the windowed
    (``window``, ``tail_capacity``, ``b_table``; size them with
    :func:`.ops.spgemm_esc.windowed_plan`) or the classic ESC engine, which
    raise ``ValueError`` on an undersized capacity instead of dropping
    partials; otherwise the dense route and extraction.
    """
    with span("smm.multiply"):
        if output_format == "dense":
            return spgemm_dense_out(a, b, symmetric=symmetric, precision=precision)
        if output_format == "sparse":
            if out_capacity is None:
                raise ValueError("sparse output requires out_capacity")
            if plan is not None:
                return spgemm_esc_binned(a, b, *plan.device_args(a.device), window=plan.window,
                                         out_capacity=out_capacity, symmetric=symmetric,
                                         dedup_span=plan.max_run)
            if expand_capacity is None and (window is not None or b_table is not None
                                            or tail_capacity):
                raise ValueError(
                    "window/tail_capacity/b_table require expand_capacity: without it the call "
                    "would fall through to the dense route (different semantics)"
                )
            if expand_capacity is not None:
                if window is not None:
                    return spgemm_esc_windowed(a, b, window=window, expand_capacity=expand_capacity,
                                               tail_capacity=tail_capacity,
                                               out_capacity=out_capacity, symmetric=symmetric,
                                               b_table=b_table)
                return spgemm_esc(a, b, expand_capacity=expand_capacity, out_capacity=out_capacity,
                                  symmetric=symmetric)
            c = spgemm_dense_out(a, b, symmetric=symmetric, precision=precision)
            return _extract_csr(c, out_capacity, symmetric=symmetric)
        raise ValueError("Invalid output_format. Choose 'sparse' or 'dense'.")


def triple_product(h: CSRMatrix, q: CSRMatrix, compute_full_matrix: int = 0, precision=None):
    """Device-resident fused ``H . Q . H^T`` (see :mod:`.ops.triple_product`)."""
    with span("smm.triple_product"):
        return triple_product_dense(h, q, compute_full_matrix, precision=precision)
