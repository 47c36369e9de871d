"""Public API: the reference-compatible ``sparse_matrix_multiply`` and the
device-resident ``multiply``.

Counterpart of :mod:`sparse_matrix_mult_tpu.api`, for the slice the port
carries so far: validation, the empty-operand path, the host short-circuit
(native Gustavson below ``Config.host_compute_limit`` partial products), the
dense route with device or host extraction, its BSR rung for block-sparse
operands (K5/K6), and the triple product ``H Q H^T`` (route ``"triple"``,
and the device-resident :func:`triple_product`).  Every other rung of the
JAX router raises :class:`NotImplementedError` naming its ``ROADMAP.md``
item, rather than sending the problem down the dense route under another
structure contract.

The scipy-in/scipy-out entry point computes on ``device`` (default
``Config.device``, ``"cuda"``); it never probes for a GPU.
"""

from __future__ import annotations

import threading

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
from .ops.triple_product import triple_product_dense
from .types import CSRMatrix, bucket_capacity, from_scipy, to_scipy
from .types_bsr import _tobsr_padded, bsr_from_scipy
from .utils.native import expansion_size, spgemm_host
from .utils.transfer import fetch_dense_to_csr, fetch_np, fine_capacity

__all__ = ["sparse_matrix_multiply", "multiply", "triple_product", "get_last_route",
           "block_occupancy"]

# Route of the last sparse_matrix_multiply on this thread: "dense", "bsr",
# "triple", "host" or "empty".
_ROUTE_STATE = threading.local()


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to sparse_matrix_mult_tpu_torch yet ({item} in ROADMAP.md)"
    )


def get_last_route() -> str | None:
    """Strategy chosen by the most recent :func:`sparse_matrix_multiply`
    on the calling thread."""
    return getattr(_ROUTE_STATE, "route", None)


def _set_route(route: str) -> None:
    _ROUTE_STATE.route = route


def _coerce_csr(m):
    if not isspmatrix_csr(m):
        m = csr_matrix(m)
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


def _bsr_route_ok(a_sp, device) -> bool:
    """Whether A goes down the BSR route: on CUDA, with the block size the
    kernels take, at least 2x2 blocks and at most ``bsr_occupancy_cutoff``
    of them occupied; always with ``force_bsr``; never with ``use_bsr`` off."""
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
    return block_occupancy(a_sp, b) <= cfg.bsr_occupancy_cutoff


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
    if block_occupancy(b_sp, bsz) <= cfg.bsr_occupancy_cutoff:
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
        return csr_matrix(fetch_np(c).astype(np.float64))

    nnz = int(torch.count_nonzero(c))  # one scalar fetch; decides the download format

    if symmetric and m == n and nnz == m * (m + 1) // 2:
        return _fetch_full_triu(c, nnz)

    panel_bytes = m * n * c.element_size()
    csr_bytes = (4 + c.element_size()) * fine_capacity(nnz)
    if panel_bytes < csr_bytes:
        return fetch_dense_to_csr(c, symmetric=symmetric, nnz=nnz)

    out = to_scipy(_extract_csr(c, bucket_capacity(nnz), symmetric=symmetric))
    if out.dtype != np.float64:
        out = out.astype(np.float64)
    return out


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
    values = fetch_np(csr.values[:nnz]).astype(np.float64)
    counts = np.diff(indptr)
    rows = np.repeat(np.arange(m, dtype=np.int64), counts)
    indices = (
        np.arange(nnz, dtype=np.int64) - np.repeat(indptr[:-1].astype(np.int64), counts) + rows
    ).astype(np.int32)
    return csr_matrix((values, indices, indptr), shape=(m, m))


def _sparse_out_host(a_sp, b_sp, symmetric: bool, esc_limit: int, device):
    """sparse x sparse -> scipy CSR: the JAX strategy ladder, first match wins.

    0. few partial products       -> native host Gustavson (unless force_bsr)
    1. everything fits densely    -> dense route (unless ESC would win),
                                     BSR kernels for a block-sparse A
    2. ESC engines, row chunks    -> not ported yet (raise)
    """
    m, k = a_sp.shape
    n = b_sp.shape[1]
    cfg = get_config()
    expand = expansion_size(a_sp.indices, a_sp.nnz, b_sp.indptr)
    keep = cfg.keep_structure
    if expand <= cfg.host_compute_limit and not cfg.force_bsr:
        out = spgemm_host(a_sp, b_sp, symmetric, n_partials=expand, keep_structure=keep)
        _set_route("host")
        return out

    budget = esc_limit
    binned_budget = 0
    if cfg.use_binned_esc:
        binned_budget = int(cfg.binned_expand_limit * (budget / cfg.esc_expand_limit))
    sparse_wins = expand <= max(budget, binned_budget) and 4 * expand <= m * n
    if dense_path_fits((m, k), (k, n), (m, n)) and not keep and not sparse_wins:
        return _dense_to_scipy_csr(a_sp, b_sp, symmetric, device)
    if expand <= max(budget, binned_budget):
        raise _not_ported("The ESC engines (binned, windowed, classic)", "Queue 1 items 4-5")
    if dense_path_fits((k, n)) and not keep:
        raise _not_ported("The row-chunked dense route (dense_chunks)", "Queue 1 item 3")
    raise _not_ported("The row-chunked ESC route (esc_chunks)", "Queue 1 items 3-5")


def _triple_product_host(a_sp, b_sp, compute_full_matrix: int, device) -> np.ndarray:
    """Dense ``A . B . A^T`` of scipy operands, as an f64 ndarray.

    Small products (twice the expansion of ``A . B`` at or below
    ``host_compute_limit``) are multiplied on the host in f64: below the
    device dispatch floor, and where FAST's f32 accumulation would risk the
    oracle's rtol = 1e-5 on mixed-sign operands.  The rest go through
    :func:`triple_product_dense` on ``device`` (route ``"triple"``).
    """
    if a_sp.shape[1] != b_sp.shape[1]:
        raise ValueError(
            "Triple product requires B.cols == A.cols so that (A.B).A^T "
            "is well defined."
        )
    expand = 2 * expansion_size(a_sp.indices, a_sp.nnz, b_sp.indptr)
    if expand <= get_config().host_compute_limit:
        c = ((a_sp @ b_sp) @ a_sp.T).toarray()
        upper = np.triu(c)
        _set_route("host")
        return upper + np.triu(c, 1).T if compute_full_matrix else upper
    dtype, _ = _upload_dtype(a_sp, b_sp, device)
    h = from_scipy(a_sp, dtype=dtype, device=device)
    q = from_scipy(b_sp, dtype=dtype, device=device)
    result = fetch_np(triple_product_dense(h, q, compute_full_matrix)).astype(np.float64)
    _set_route("triple")
    return result


def _zero_notice(result):
    if not get_config().zero_result_notice:
        return
    if isinstance(result, np.ndarray) and np.all(result == 0):
        print("Multiplication resulted in a zero matrix.")
    elif sp.issparse(result) and result.nnz == 0:
        print("Multiplication resulted in a zero matrix.")


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
    if imem_size is None:
        imem_size = 5
    else:
        try:
            imem_size = int(imem_size)
        except (ValueError, TypeError):
            raise ValueError(f"imem_size must be an integer or None, got {type(imem_size)}")
    pct = imem_size if 0 < imem_size <= 10 else 10
    esc_limit = max(1, get_config().esc_expand_limit * pct // 5)

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
        if expand <= cfg.host_compute_limit and not cfg.force_bsr:
            result = spgemm_host(matrix_a, matrix_b, symmetric, n_partials=expand).toarray()
            _set_route("host")
        elif _bsr_route_ok(matrix_a, device):
            c = _bsr_product_host(matrix_a, matrix_b, symmetric, device)
            result = fetch_np(c).astype(np.float64)
            _set_route("bsr")
        else:
            dtype, _ = _upload_dtype(matrix_a, matrix_b, device)
            a = from_scipy(matrix_a, dtype=dtype, device=device)
            b = from_scipy(matrix_b, dtype=dtype, device=device)
            result = fetch_np(spgemm_dense_out(a, b, symmetric=symmetric)).astype(np.float64)
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

    The sparse output takes the dense route with a static ``out_capacity``.
    The ESC keyword arguments (``plan``, ``expand_capacity``, ``window``,
    ``tail_capacity``, ``b_table``) select engines that are not ported yet.
    """
    if output_format == "dense":
        return spgemm_dense_out(a, b, symmetric=symmetric, precision=precision)
    if output_format == "sparse":
        if out_capacity is None:
            raise ValueError("sparse output requires out_capacity")
        if plan is not None:
            raise _not_ported("The row-binned ESC engine (multiply(plan=...))", "Queue 1 item 4")
        if expand_capacity is None and (window is not None or b_table is not None
                                        or tail_capacity):
            raise ValueError(
                "window/tail_capacity/b_table require expand_capacity: without it the call would "
                "fall through to the dense route (different semantics)"
            )
        if expand_capacity is not None:
            raise _not_ported(
                "The ESC engines (multiply(expand_capacity=..., window=...))", "Queue 1 item 5"
            )
        c = spgemm_dense_out(a, b, symmetric=symmetric, precision=precision)
        return _extract_csr(c, out_capacity, symmetric=symmetric)
    raise ValueError("Invalid output_format. Choose 'sparse' or 'dense'.")


def triple_product(h: CSRMatrix, q: CSRMatrix, compute_full_matrix: int = 0, precision=None):
    """Device-resident fused ``H . Q . H^T`` (see :mod:`.ops.triple_product`)."""
    return triple_product_dense(h, q, compute_full_matrix, precision=precision)
