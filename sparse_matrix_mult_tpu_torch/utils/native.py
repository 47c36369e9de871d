"""ctypes loader for the shared native host library (``libsmmhost``).

The port reuses the host runtime built from ``native/csr_host.cpp`` without
importing the JAX package: the library is found by path, first as the
prebuilt package data of the JAX package
(``sparse_matrix_mult_tpu/lib/libsmmhost_<arch>.so``), then as the Makefile
output ``native/libsmmhost.so``.  Every entry point has a numpy/scipy
fallback, as in :mod:`sparse_matrix_mult_tpu.utils.native`; the GPU compute
path never depends on the library.
"""

from __future__ import annotations

import ctypes
import os
import platform
from typing import Optional

import numpy as np

__all__ = ["get_native", "expansion_size", "row_flops", "stitch_csr", "csr_triu", "dense_pack",
           "spgemm_host"]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_I32 = ctypes.POINTER(ctypes.c_int32)
_F32 = ctypes.POINTER(ctypes.c_float)
_F64 = ctypes.POINTER(ctypes.c_double)
_I64 = ctypes.POINTER(ctypes.c_int64)
_INT64 = ctypes.c_int64


def _lib_candidates():
    machine = platform.machine().lower()
    arch = "arm64" if machine in ("arm64", "aarch64") else "x86_64"
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    yield os.path.join(root, "sparse_matrix_mult_tpu", "lib", f"libsmmhost_{arch}.so")
    yield os.path.join(root, "native", "libsmmhost.so")


def get_native() -> Optional[ctypes.CDLL]:
    """The host library with its signatures declared, or None if absent."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    for path in _lib_candidates():
        if not os.path.exists(path):
            continue
        try:
            lib = ctypes.CDLL(path)
            lib.smm_expansion_size.restype = ctypes.c_int64
            lib.smm_expansion_size.argtypes = [_I32, _INT64, _I32]
            lib.smm_row_flops.restype = None
            lib.smm_row_flops.argtypes = [_I32, _I32, _INT64, _I32, _F64]
            lib.smm_stitch_csr.restype = None
            lib.smm_stitch_csr.argtypes = [
                _INT64, _I64, _I32, _I64, _I32, _F64, _I64, _I32, _I32, _F64,
            ]
            lib.smm_csr_triu.restype = ctypes.c_int64
            lib.smm_csr_triu.argtypes = [_INT64, _I32, _I32, _F64, _I32, _I32, _F64]
            for suffix, fp in (("f32", _F32), ("f64", _F64)):
                count = getattr(lib, f"smm_dense_pack_count_{suffix}")
                count.restype = None
                count.argtypes = [_INT64, _INT64, fp, _I32]
                fill = getattr(lib, f"smm_dense_pack_fill_{suffix}")
                fill.restype = None
                fill.argtypes = [_INT64, _INT64, fp, _I32, _I32, _F64]
            lib.smm_spgemm_count.restype = None
            lib.smm_spgemm_count.argtypes = [
                _INT64, _INT64, _I32, _I32, _I32, _I32, ctypes.c_int32, ctypes.c_int32, _I32,
            ]
            lib.smm_spgemm_fill.restype = None
            lib.smm_spgemm_fill.argtypes = [
                _INT64, _INT64, _I32, _I32, _F64, _I32, _I32, _F64,
                ctypes.c_int32, ctypes.c_int32, _I32, _I32, _F64,
            ]
        except (OSError, AttributeError):
            # Unloadable, or an older build without these symbols: try the next.
            continue
        _LIB = lib
        break
    return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype)


def expansion_size(a_indices, a_nnz: int, b_indptr) -> int:
    """Total partial products of A @ B (the flop count)."""
    if a_nnz == 0:
        return 0
    a_indices = np.ascontiguousarray(np.asarray(a_indices)[:a_nnz], np.int32)
    b_indptr = np.ascontiguousarray(b_indptr, np.int32)
    lib = get_native()
    if lib is not None:
        return int(lib.smm_expansion_size(_ptr(a_indices, _I32), a_nnz, _ptr(b_indptr, _I32)))
    return int((b_indptr[a_indices + 1] - b_indptr[a_indices]).sum())


def row_flops(a_indptr, a_indices, b_indptr) -> np.ndarray:
    """Partial products contributed by each row of A (float64, one per row)."""
    a_indptr = np.ascontiguousarray(a_indptr, np.int32)
    a_indices = np.ascontiguousarray(a_indices, np.int32)
    b_indptr = np.ascontiguousarray(b_indptr, np.int32)
    rows = len(a_indptr) - 1
    lib = get_native()
    if lib is not None:
        out = np.empty(rows, np.float64)
        lib.smm_row_flops(_ptr(a_indptr, _I32), _ptr(a_indices, _I32), rows,
                          _ptr(b_indptr, _I32), _ptr(out, _F64))
        return out
    nnz = int(a_indptr[-1])
    per_entry = b_indptr[a_indices[:nnz] + 1] - b_indptr[a_indices[:nnz]]
    row_ids = np.repeat(np.arange(rows), np.diff(a_indptr))
    return np.bincount(row_ids, weights=per_entry, minlength=rows)


def stitch_csr(chunks, total_rows: int, ncols: int):
    """Stitch scipy CSR pieces of consecutive row ranges into one scipy CSR
    (float64 values from the native library; scipy's ``vstack`` keeps the
    pieces' dtype when the library is absent)."""
    import scipy.sparse as sp

    lib = get_native()
    if lib is None:
        return sp.vstack(chunks, format="csr")
    n = len(chunks)
    chunk_rows = np.array([c.shape[0] for c in chunks], np.int64)
    indptrs = [np.ascontiguousarray(c.indptr, np.int32) for c in chunks]
    indptr_offsets = np.concatenate([[0], np.cumsum([len(ip) for ip in indptrs])[:-1]])
    indptr_offsets = np.ascontiguousarray(indptr_offsets, np.int64)
    nnzs = np.array([c.nnz for c in chunks], np.int64)
    entry_offsets = np.ascontiguousarray(np.concatenate([[0], np.cumsum(nnzs)[:-1]]), np.int64)
    nnz_total = int(nnzs.sum())
    indptr_cat = np.concatenate(indptrs)
    indices_cat = np.concatenate(
        [np.ascontiguousarray(c.indices[:c.nnz], np.int32) for c in chunks])
    values_cat = np.concatenate(
        [np.ascontiguousarray(c.data[:c.nnz], np.float64) for c in chunks])
    out_indptr = np.empty(total_rows + 1, np.int32)
    out_indices = np.empty(nnz_total, np.int32)
    out_values = np.empty(nnz_total, np.float64)
    lib.smm_stitch_csr(
        n, _ptr(chunk_rows, _I64), _ptr(indptr_cat, _I32), _ptr(indptr_offsets, _I64),
        _ptr(indices_cat, _I32), _ptr(values_cat, _F64), _ptr(entry_offsets, _I64),
        _ptr(out_indptr, _I32), _ptr(out_indices, _I32), _ptr(out_values, _F64),
    )
    return sp.csr_matrix((out_values, out_indices, out_indptr), shape=(total_rows, ncols))


def csr_triu(mat):
    """Upper triangle of a scipy CSR matrix."""
    import scipy.sparse as sp

    lib = get_native()
    if lib is None:
        return sp.triu(mat, format="csr")
    rows = mat.shape[0]
    indptr = np.ascontiguousarray(mat.indptr, np.int32)
    indices = np.ascontiguousarray(mat.indices, np.int32)
    values = np.ascontiguousarray(mat.data, np.float64)
    out_indptr = np.empty(rows + 1, np.int32)
    out_indices = np.empty(mat.nnz, np.int32)
    out_values = np.empty(mat.nnz, np.float64)
    nnz = lib.smm_csr_triu(
        rows,
        _ptr(indptr, _I32), _ptr(indices, _I32), _ptr(values, _F64),
        _ptr(out_indptr, _I32), _ptr(out_indices, _I32), _ptr(out_values, _F64),
    )
    return sp.csr_matrix((out_values[:nnz], out_indices[:nnz], out_indptr), shape=mat.shape)


def dense_pack(dense: np.ndarray):
    """Pack a dense row-major panel into scipy CSR with float64 values."""
    import scipy.sparse as sp

    dense = np.ascontiguousarray(dense)
    m, n = dense.shape
    lib = get_native()
    if lib is not None and dense.dtype in (np.float32, np.float64):
        f32 = dense.dtype == np.float32
        counts = np.empty(m, np.int32)
        count_fn = lib.smm_dense_pack_count_f32 if f32 else lib.smm_dense_pack_count_f64
        fill_fn = lib.smm_dense_pack_fill_f32 if f32 else lib.smm_dense_pack_fill_f64
        dptr = _ptr(dense, _F32 if f32 else _F64)
        count_fn(m, n, dptr, _ptr(counts, _I32))
        indptr64 = np.zeros(m + 1, np.int64)
        np.cumsum(counts, out=indptr64[1:], dtype=np.int64)
        if indptr64[-1] <= np.iinfo(np.int32).max:
            indptr = indptr64.astype(np.int32)
            nnz = int(indptr[-1])
            indices = np.empty(nnz, np.int32)
            values = np.empty(nnz, np.float64)
            fill_fn(m, n, dptr, _ptr(indptr, _I32), _ptr(indices, _I32), _ptr(values, _F64))
            return sp.csr_matrix((values, indices, indptr), shape=(m, n))
    flat = dense.reshape(-1)
    pos = np.flatnonzero(flat)
    indices = (pos % n).astype(np.int32)
    counts = np.bincount((pos // n).astype(np.int64), minlength=m)
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    values = flat[pos].astype(np.float64)
    return sp.csr_matrix((values, indices, indptr), shape=(m, n))


def spgemm_host(a_sp, b_sp, symmetric: bool = False, n_partials: int | None = None,
                keep_structure: bool = False):
    """Host SpGEMM: the native two-phase Gustavson kernel, or scipy below
    2^14 partial products (and whenever the library is absent).

    The native kernel keeps every touched output slot (Gustavson
    structure); scipy prunes exact zeros, so ``keep_structure`` forces the
    native kernel at every size.  Returns CSR with sorted column indices;
    ``symmetric`` keeps only the upper triangle.
    """
    import scipy.sparse as sp

    if n_partials is None:
        n_partials = expansion_size(a_sp.indices, a_sp.nnz, b_sp.indptr)
    lib = get_native()
    if lib is None or (n_partials < (1 << 14) and not keep_structure):
        out = (a_sp @ b_sp).tocsr()
        out.sort_indices()
        return csr_triu(out) if symmetric else out

    m = a_sp.shape[0]
    n = b_sp.shape[1]
    a_indptr = np.ascontiguousarray(a_sp.indptr, np.int32)
    a_indices = np.ascontiguousarray(a_sp.indices, np.int32)
    a_values = np.ascontiguousarray(a_sp.data, np.float64)
    b_indptr = np.ascontiguousarray(b_sp.indptr, np.int32)
    b_indices = np.ascontiguousarray(b_sp.indices, np.int32)
    b_values = np.ascontiguousarray(b_sp.data, np.float64)
    sym = 1 if symmetric else 0
    parallel = 1
    counts = np.empty(m, np.int32)
    lib.smm_spgemm_count(
        m, n, _ptr(a_indptr, _I32), _ptr(a_indices, _I32),
        _ptr(b_indptr, _I32), _ptr(b_indices, _I32), sym, parallel, _ptr(counts, _I32),
    )
    indptr64 = np.zeros(m + 1, np.int64)
    np.cumsum(counts, out=indptr64[1:], dtype=np.int64)
    if indptr64[-1] > np.iinfo(np.int32).max:
        # The native fill takes int32 row pointers; scipy handles int64.
        out = (a_sp @ b_sp).tocsr()
        out.sort_indices()
        return sp.triu(out, format="csr") if symmetric else out
    out_indptr = indptr64.astype(np.int32)
    nnz = int(out_indptr[-1])
    out_indices = np.empty(nnz, np.int32)
    out_values = np.empty(nnz, np.float64)
    lib.smm_spgemm_fill(
        m, n, _ptr(a_indptr, _I32), _ptr(a_indices, _I32), _ptr(a_values, _F64),
        _ptr(b_indptr, _I32), _ptr(b_indices, _I32), _ptr(b_values, _F64),
        sym, parallel, _ptr(out_indptr, _I32), _ptr(out_indices, _I32), _ptr(out_values, _F64),
    )
    return sp.csr_matrix((out_values, out_indices, out_indptr), shape=(m, n))
