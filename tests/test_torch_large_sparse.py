"""The sparse-output ladder of ``sparse_matrix_multiply`` in the port against
the JAX package, on the CPU in f64, each rung forced by shrunken limits (as
``tests/test_large_sparse.py`` does for JAX).

JAX is pinned off its host cost model (the port has none): the host rung
only below ``host_compute_limit``, here 0.  For every input the route label,
``get_last_route_detail()["chunks"]`` and the structure equal JAX's, and the
values agree to summation order.
"""

import time

import numpy as np
import pytest
import scipy.sparse as sp

import sparse_matrix_mult_tpu as jsmm
import sparse_matrix_mult_tpu_torch as tsmm
from sparse_matrix_mult_tpu import api as japi
from sparse_matrix_mult_tpu_torch import api as tapi

TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture
def limits():
    """Set the same limits in both packages (JAX also pinned off its cost
    model), and restore both configurations afterwards."""
    saved_t, saved_j = tsmm.get_config(), jsmm.get_config()

    def set_both(**kw):
        tsmm.set_config(host_compute_limit=0, **kw)
        jsmm.set_config(host_compute_limit=0, auto_calibrate_link=False, link_fixed_s=1e-9,
                        link_up_bytes_per_s=1e15, link_down_bytes_per_s=1e15,
                        host_rate_base=1.0, **kw)

    yield set_both
    tsmm.set_config(saved_t)
    jsmm.set_config(saved_j)


def _pair(m, k, n, da, db, seed, signed=True):
    rng = np.random.default_rng(seed)
    a = sp.random(m, k, density=da, format="csr", random_state=rng.integers(2**31))
    b = sp.random(k, n, density=db, format="csr", random_state=rng.integers(2**31))
    if signed:
        a.data = 2 * a.data - 1
    return a, b


def _heavy_row(m, k, n, row, seed, dense_b=0.5):
    """A with one full row, ~2% elsewhere."""
    a = sp.random(m, k, density=0.02, format="csr", random_state=seed).tolil()
    a[row, :] = np.arange(1, k + 1, dtype=float)
    return a.tocsr(), sp.random(k, n, density=dense_b, format="csr", random_state=seed + 1)


def _both(a, b, route, symmetric=False, **kw):
    """Both packages' products; the same route and chunk count; the port's
    structure equal to JAX's and its values within TOL."""
    got = tsmm.sparse_matrix_multiply(a, b, symmetric=symmetric, device="cpu", **kw)
    got_route, got_detail = tsmm.get_last_route(), tapi.get_last_route_detail()
    want = jsmm.sparse_matrix_multiply(a, b, symmetric=symmetric, **kw)
    assert (got_route, jsmm.get_last_route()) == (route, route)
    assert got_detail == japi.get_last_route_detail()
    assert got.dtype == np.float64
    for x in (got, want):
        x.sort_indices()
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, **TOL)
    ref = (a @ b).toarray()
    np.testing.assert_allclose(got.toarray(), np.triu(ref) if symmetric else ref, **TOL)
    return got, got_detail


# (route, limits, operands): each rung of the ladder, first match wins.  The
# products are square, so each rung also takes the symmetric output.
LADDER = {
    # Everything fits densely but the expansion is tiny: binned ESC wins.
    "esc_binned": ("esc_binned", dict(), (300, 300, 300, 0.01, 0.01, 1)),
    # Binned off, expansion within the budget, short B rows: windowed ESC.
    "esc_windowed": ("esc_windowed", dict(use_binned_esc=False, dense_path_limit=500),
                     (120, 100, 120, 0.03, 0.03, 2)),
    # Binned off, long B rows (no window qualifies): classic ESC.
    "esc": ("esc", dict(use_binned_esc=False, dense_path_limit=500),
            (150, 40, 150, 0.05, 0.6, 3)),
    # The output is too large for the dense route, B's panel fits.
    "dense_chunks": ("dense_chunks", dict(dense_path_limit=6000, esc_expand_limit=8,
                                          binned_expand_limit=8), (200, 30, 200, 0.1, 0.1, 4)),
    # Even B's panel exceeds the dense limit: flop-balanced ESC chunks, the
    # windowed engine in each, then the classic one (long B rows).
    "esc_chunks": ("esc_chunks", dict(dense_path_limit=1000, esc_expand_limit=500,
                                      binned_expand_limit=500), (60, 60, 60, 0.1, 0.1, 5)),
    "esc_chunks_classic": ("esc_chunks", dict(dense_path_limit=1000, esc_expand_limit=3000,
                                              binned_expand_limit=3000),
                           (150, 40, 150, 0.05, 0.6, 6)),
}


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("rung", sorted(LADDER))
def test_ladder_equals_jax(limits, rung, symmetric):
    route, kw, shape = LADDER[rung]
    limits(**kw)
    _both(*_pair(*shape), route, symmetric=symmetric)


_SINGLE = ("expansion_size", "upload", "engine", "download")
_CHUNKED = ("expansion_size", "row_flops", "chunk_bounds", "upload_b", "windowed_plan",
            "chunk_upload", "engine", "download", "stitch")
STAGES = {
    "esc_binned": _SINGLE + ("binned_plan",),
    "esc_windowed": _SINGLE + ("windowed_plan",),
    "esc": _SINGLE + ("windowed_plan",),
    "esc_chunks": _CHUNKED,
    "esc_chunks_classic": _CHUNKED,
    "dense_chunks": (),
}


@pytest.mark.parametrize("rung", sorted(LADDER))
def test_route_stages(limits, rung):
    """Each ESC route records the host seconds of its stages, which sum to
    no more than the call; the other routes record none."""
    route, kw, shape = LADDER[rung]
    limits(**kw)
    t = time.perf_counter()
    tsmm.sparse_matrix_multiply(*_pair(*shape), device="cpu")
    wall = time.perf_counter() - t
    assert tsmm.get_last_route() == route
    stages = tapi.get_last_route_stages()
    assert sorted(stages) == sorted(STAGES[rung])
    assert all(s >= 0 for s in stages.values()) and sum(stages.values()) <= wall


@pytest.mark.parametrize("symmetric", [False, True])
def test_heavy_row_is_a_chunk_of_its_own(limits, symmetric):
    """One A row whose partials dwarf the budget terminates as its own chunk."""
    limits(dense_path_limit=1000, esc_expand_limit=16, binned_expand_limit=16)
    _, detail = _both(*_heavy_row(40, 50, 40, 0, 7), "esc_chunks", symmetric=symmetric)
    assert detail["chunks"] > 1


def test_heavy_row_in_dense_chunks(limits):
    limits(dense_path_limit=400, esc_expand_limit=16, binned_expand_limit=16)
    a, b = _heavy_row(60, 10, 20, 3, 9, dense_b=0.6)
    _both(a, b, "dense_chunks")


@pytest.mark.parametrize("imem_size", [1, 3, 10, 99])
def test_imem_size_scales_the_chunk_count(limits, imem_size):
    """imem_size scales the per-chunk partial budget (1..10, else 10): the
    chunk count follows it, equal to JAX's; the product does not move."""
    limits(dense_path_limit=1000, esc_expand_limit=2000, binned_expand_limit=2000)
    a, b = _pair(100, 60, 60, 0.2, 0.2, 6)
    _, detail = _both(a, b, "esc_chunks", imem_size=imem_size)
    assert detail["chunks"] == {1: 45, 3: 13, 10: 4, 99: 4}[imem_size]


def _cancelling_pair(n=60, seed=3):
    """A @ B with exact cancellations: every A row holds +v and -v on an
    (even, odd) column pair whose B rows are identical."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(n):
        for _ in range(3):
            j = int(rng.integers(0, n // 2)) * 2
            v = float(rng.standard_normal())
            rows += [i, i]
            cols += [j, j + 1]
            vals += [v, -v]
    a = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    a.sum_duplicates()
    b_half = sp.random(n // 2, n, density=0.2, format="csr", random_state=seed + 1)
    b = sp.csr_matrix(np.repeat(b_half.toarray(), 2, axis=0))
    return a, b


@pytest.mark.parametrize("route,kw", [
    ("esc_binned", dict()),
    ("esc_windowed", dict(use_binned_esc=False)),
    ("esc_chunks", dict(dense_path_limit=1000, esc_expand_limit=200, binned_expand_limit=200)),
])
def test_keep_structure_keeps_explicit_zeros(limits, route, kw):
    """keep_structure sends a dense-fitting product to ESC, which keeps the
    entries whose partials cancel, as JAX's engines do."""
    limits(keep_structure=True, **kw)
    a, b = _cancelling_pair()
    got, _ = _both(a, b, route)
    touched = (abs(a) @ abs(b)).tocsr()
    assert got.nnz == touched.nnz > (a @ b).nnz
    np.testing.assert_array_equal(got.indices, touched.sorted_indices().indices)


def test_chunk_bounds_equal_jax():
    for flops, limit, rows in ((np.ones(100), 1000, 16), (np.zeros(50), 10, 64),
                               (np.array([1.0, 1e9, 1.0, 1.0]), 100, 64),
                               (np.random.default_rng(1).pareto(1.0, 500), 50, 40)):
        assert tapi._flop_chunk_bounds(flops, limit, rows) == japi._flop_chunk_bounds(
            flops, limit, rows)
