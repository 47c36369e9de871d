"""Operands for tests and for ``chip_smoke.py``.

Counterpart of :mod:`sparse_matrix_mult_tpu.utils.testing` (numpy only).
"""

from __future__ import annotations

import numpy as np

__all__ = ["hypersparse_random"]


def hypersparse_random(m: int, n: int, nnz: int, seed: int):
    """Uniform random CSR with ~``nnz`` entries in O(nnz), values in [0, 1).

    ``scipy.sparse.random`` samples without replacement by materializing a
    permutation of all m*n cells, which is out of reach at 100k x 100k.
    Sampling with replacement and letting the COO->CSR conversion sum the
    few duplicates is equivalent for benchmarking and testing.
    """
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    return sp.coo_matrix(
        (rng.uniform(size=nnz), (rng.integers(0, m, nnz), rng.integers(0, n, nnz))),
        shape=(m, n),
    ).tocsr()
