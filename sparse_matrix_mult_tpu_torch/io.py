"""Save and load of CSR matrices, whole or row-partitioned.

Counterpart of :mod:`sparse_matrix_mult_tpu.io`, with the same ``.npz``
layout, so a file saved by either package loads in the other:

* :func:`save_csr` / :func:`load_csr` -- one ``.npz`` per matrix (keys
  ``indptr``, ``indices``, ``data``, ``shape``), an exact round trip;
* :func:`save_partitioned` / :func:`load_partitioned` -- one ``.npz`` per
  row shard (plus ``row0``) and ``<prefix>.meta.json``, row ranges
  flop-balanced when the other operand's row pointers are given;
* :func:`load_sharded_result` -- a partitioned save stitched into one scipy
  CSR;
* :func:`load_sharded_operand` -- a partitioned save placed straight onto a
  row mesh: each slot's file is read only by the process that owns it.
"""

from __future__ import annotations

import json
from typing import Sequence

import numpy as np
import scipy.sparse as sp
import torch

from .parallel.partition import equal_rows_partition, flop_balanced_partition, row_flops
from .types import CSRMatrix, bucket_capacity, from_scipy, to_scipy
from .utils.native import stitch_csr

__all__ = [
    "save_csr",
    "load_csr",
    "save_partitioned",
    "load_partitioned",
    "load_sharded_result",
    "load_sharded_operand",
]


def _as_scipy(mat) -> sp.csr_matrix:
    if isinstance(mat, CSRMatrix):
        return to_scipy(mat)
    if sp.issparse(mat):
        return mat.tocsr()
    return sp.csr_matrix(np.asarray(mat))


def _on_device(m: sp.csr_matrix, device, dtype):
    """``m`` itself when ``device`` is false, else a :class:`CSRMatrix` on
    ``Config.device`` (``True``) or on the given device."""
    if device is None or device is False:
        return m
    return from_scipy(m, dtype=dtype, device=None if device is True else torch.device(device))


def _read(path: str) -> sp.csr_matrix:
    with np.load(path) as z:
        return sp.csr_matrix((z["data"], z["indices"], z["indptr"]), shape=tuple(z["shape"]))


def save_csr(path: str, mat) -> None:
    """Save a CSRMatrix, a scipy matrix or a dense array as one ``.npz``."""
    m = _as_scipy(mat)
    np.savez_compressed(
        path,
        indptr=np.asarray(m.indptr, np.int64),
        indices=np.asarray(m.indices, np.int32),
        data=np.asarray(m.data),
        shape=np.asarray(m.shape, np.int64),
    )


def load_csr(path: str, device=False, dtype=None):
    """Load a matrix saved by :func:`save_csr`: a scipy CSR, or with
    ``device`` a :class:`CSRMatrix` on ``Config.device`` (``True``) or on
    the given ``torch.device`` or name."""
    return _on_device(_read(path), device, dtype)


def _shard_path(prefix: str, i: int) -> str:
    return f"{prefix}.shard{i:05d}.npz"


def _meta_path(prefix: str) -> str:
    return f"{prefix}.meta.json"


def save_partitioned(prefix: str, mat, n_shards: int, b_indptr=None) -> list[str]:
    """Save ``mat`` as ``n_shards`` contiguous row-range shard files:
    flop-balanced when ``b_indptr`` (row pointers of the matrix it will be
    multiplied with) is given, equal rows otherwise.  Writes
    ``<prefix>.meta.json`` and returns the shard paths."""
    m = _as_scipy(mat)
    if b_indptr is not None:
        bounds = flop_balanced_partition(row_flops(m.indptr, m.indices, b_indptr), n_shards)
    else:
        bounds = equal_rows_partition(m.shape[0], n_shards)
    paths, shard_nnz = [], []
    for i in range(len(bounds) - 1):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        sub = m[lo:hi]
        path = _shard_path(prefix, i)
        np.savez_compressed(
            path,
            indptr=np.asarray(sub.indptr, np.int64),
            indices=np.asarray(sub.indices, np.int32),
            data=np.asarray(sub.data),
            shape=np.asarray(sub.shape, np.int64),
            row0=np.asarray([lo], np.int64),
        )
        paths.append(path)
        shard_nnz.append(int(sub.nnz))
    with open(_meta_path(prefix), "w") as f:
        json.dump(
            {
                "shape": [int(s) for s in m.shape],
                "n_shards": len(paths),
                "bounds": [int(b) for b in bounds],
                "dtype": str(m.dtype),
                # load_sharded_operand sizes capacities from this without
                # opening any shard file it does not own.
                "shard_nnz": shard_nnz,
            },
            f,
        )
    return paths


def load_partitioned(prefix: str, shard_ids: Sequence[int] | None = None, device=False,
                     dtype=None):
    """Load shards saved by :func:`save_partitioned`: all, or ``shard_ids``.
    Returns ``(shards, meta)``, each shard a scipy CSR (or, with ``device``,
    a :class:`CSRMatrix` as :func:`load_csr` places it); ``meta['bounds']``
    holds each shard's first global row."""
    with open(_meta_path(prefix)) as f:
        meta = json.load(f)
    ids = list(shard_ids) if shard_ids is not None else range(meta["n_shards"])
    shards = [_on_device(_read(_shard_path(prefix, i)), device, dtype) for i in ids]
    return shards, meta


def load_sharded_result(prefix: str) -> sp.csr_matrix:
    """A partitioned save stitched into one scipy CSR (native stitch)."""
    shards, meta = load_partitioned(prefix)
    rows, cols = meta["shape"]
    return stitch_csr(shards, rows, cols)


def load_sharded_operand(prefix: str, mesh=None, dtype=None):
    """Load a partitioned save onto a row mesh as a
    :class:`~.parallel.distributed.ShardedCSR`.

    When the save's shard count equals the mesh's, each process reads only
    the files of the slots it owns; otherwise the save is stitched and
    sharded anew (uniform bounds).
    """
    from .parallel.distributed import ShardedCSR, _place_shard, _value_dtype, shard_csr
    from .parallel.mesh import row_mesh

    mesh = mesh or row_mesh()
    s_count = mesh.size
    with open(_meta_path(prefix)) as f:
        meta = json.load(f)
    if meta["n_shards"] != s_count:
        return shard_csr(load_sharded_result(prefix), mesh, dtype=dtype)
    bounds = tuple(int(b) for b in meta["bounds"])
    m, n = (int(x) for x in meta["shape"])
    rows_pad = max(max(b1 - b0 for b0, b1 in zip(bounds[:-1], bounds[1:])), 1)
    dtype = dtype or _value_dtype(mesh)
    shard_nnz = meta.get("shard_nnz")
    if shard_nnz is None:  # an older save: one header read per shard
        shard_nnz = []
        for i in range(s_count):
            with np.load(_shard_path(prefix, i)) as z:
                shard_nnz.append(int(z["indptr"][-1]))
    cap = bucket_capacity(max(max(shard_nnz), 1))
    fields = ([None] * s_count, [None] * s_count, [None] * s_count)
    for s in mesh.local_slots():
        with np.load(_shard_path(prefix, s)) as z:
            block = _place_shard(z["indptr"], z["indices"], z["data"], rows_pad, cap, dtype,
                                 mesh.slots[s][0])
        for field, t in zip(fields, block):
            field[s] = t
    return ShardedCSR(*(tuple(f) for f in fields), (m, n), bounds, mesh)
