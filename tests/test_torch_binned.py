"""The port's row-binned ESC engine and planner against the JAX package's
(``ops/spgemm_binned.py``) and scipy, on the CPU in f64; and the router's
repairs R1 (canonical input before planning) and R3 (the tuned tile's
retry), held against scipy.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_matrix_mult_tpu as jsmm
import sparse_matrix_mult_tpu_torch as tsmm
from sparse_matrix_mult_tpu.ops import spgemm_binned as jbin
from sparse_matrix_mult_tpu_torch import api
from sparse_matrix_mult_tpu_torch.ops import spgemm_binned as tbin
from test_torch_esc import TOL, assert_same_csr

PLAN_FIELDS = ("slice_start", "slice_len", "va_slice", "va_entry", "va_row", "row_lane")


def _skewed(m, k, seed):
    """Rows of power-law lengths (a few long, most short)."""
    rng = np.random.default_rng(seed)
    lens = np.minimum((rng.pareto(1.2, m) * 2).astype(np.int64), k)
    rows = np.repeat(np.arange(m), lens)
    cols = np.concatenate([rng.choice(k, n, replace=False) for n in lens])
    return sp.csr_matrix((rng.uniform(0.5, 1.5, len(rows)), (rows, cols)), shape=(m, k))


def _structures():
    r = np.random.RandomState
    return {
        "uniform": (sp.random(200, 150, density=0.05, format="csr", random_state=r(1)),
                    sp.random(150, 180, density=0.05, format="csr", random_state=r(2)), 8, 512),
        "skewed": (_skewed(300, 200, 3), _skewed(200, 250, 4), 8, 2048),
        "long_b_rows": (sp.random(50, 40, density=0.2, format="csr", random_state=r(5)),
                        sp.random(40, 300, density=0.6, format="csr", random_state=r(6)), 4,
                        4096),
        # One output row's virtual entries overflow a lane: None.
        "heavy_row": (sp.csr_matrix(np.ones((4, 600))), sp.csr_matrix(np.ones((600, 4))), 8,
                      256),
        # 1-entry B rows padded to W = 8 across lanes: the pad ratio trips, None.
        "padding": (sp.csr_matrix(np.ones((2, 300))), sp.csr_matrix(np.ones((300, 1))), 8,
                    4096),
        "empty": (sp.random(5, 5, density=0.5, format="csr", random_state=r(7)),
                  sp.csr_matrix((5, 5)), 8, 4096),
    }


STRUCTURES = _structures()


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_binned_plan_equals_jax(name):
    a, b, window, lane = STRUCTURES[name]
    got = tbin.binned_plan(a.indptr, a.indices, b.indptr, window=window, lane_width=lane)
    want = jbin.binned_plan(a.indptr, a.indices, b.indptr, window=window, lane_width=lane)
    assert (got is None) == (want is None)
    if name in ("heavy_row", "padding", "empty"):
        assert got is None
        return
    for field in PLAN_FIELDS:
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype and np.array_equal(g, w), field
    for field in ("window", "lane_width", "n_partials", "max_run", "padded"):
        assert getattr(got, field) == getattr(want, field), field
    assert np.array_equal(got.va_len, want.va_len)


def _run_both(a, b, window, lane, symmetric=False, row_offset=0):
    plan_t = tbin.binned_plan(a.indptr, a.indices, b.indptr, window=window, lane_width=lane)
    plan_j = jbin.binned_plan(a.indptr, a.indices, b.indptr, window=window, lane_width=lane)
    cap = tsmm.bucket_capacity(plan_t.n_partials)
    kw = dict(window=plan_t.window, out_capacity=cap, symmetric=symmetric, row_offset=row_offset)
    got = tbin.spgemm_esc_binned(tsmm.from_scipy(a, device="cpu"),
                                 tsmm.from_scipy(b, device="cpu"),
                                 *plan_t.device_args("cpu"), dedup_span=plan_t.max_run, **kw)
    want = jbin.spgemm_esc_binned(jsmm.from_scipy(a), jsmm.from_scipy(b), *plan_j.device_args(),
                                  dedup_span=plan_j.max_run, **kw)
    return got, want


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("name", ["uniform", "skewed", "long_b_rows"])
def test_spgemm_esc_binned_equals_jax(name, symmetric):
    a, b, window, lane = STRUCTURES[name]
    a = a.copy()
    a.data = 2 * a.data - 1  # both signs
    got, want = _run_both(a, b, window, lane, symmetric=symmetric)
    assert_same_csr(got, want)
    ref = (a @ b).toarray()
    np.testing.assert_allclose(got.todense().numpy(), np.triu(ref) if symmetric else ref, **TOL)


def test_binned_row_offset_keeps_the_filter_global():
    a = sp.random(60, 60, density=0.1, format="csr", random_state=31)
    b = sp.random(60, 60, density=0.1, format="csr", random_state=32)
    parts = []
    for start, stop in ((0, 30), (30, 60)):
        got, want = _run_both(a[start:stop], b, 4, 256, symmetric=True, row_offset=start)
        assert_same_csr(got, want)
        parts.append(got.todense().numpy())
    np.testing.assert_allclose(np.vstack(parts), np.triu((a @ b).toarray()), **TOL)


def test_binned_long_duplicate_runs():
    """Every B row hits column 0: runs as long as an A row, summed exactly."""
    k = 32
    a = sp.csr_matrix(np.tile(1.0 + 0.01 * np.arange(k), (16, 1)))
    b = sp.csr_matrix((np.arange(1.0, k + 1), (np.arange(k), np.zeros(k, int))), shape=(k, 8))
    got, want = _run_both(a, b, 2, 256)
    assert int(got.nnz) == 16
    assert_same_csr(got, want)


def test_binned_full_lane_then_empty_row():
    """A lane packed to exactly P partials followed by an empty row."""
    a = sp.coo_matrix((np.ones(5), ([0, 1, 2, 3, 5], [0, 1, 2, 3, 4])), shape=(6, 5)).tocsr()
    b = sp.coo_matrix((np.arange(1.0, 11.0), (np.repeat(np.arange(5), 2),
                                              np.tile([0, 1], 5) + np.repeat(np.arange(5), 2))),
                      shape=(5, 7)).tocsr()
    got, want = _run_both(a, b, 2, 8)
    assert got.indptr.tolist()[:6] == [0, 2, 4, 6, 8, 8]
    assert_same_csr(got, want)


def test_binned_structural_zeros_kept():
    a = sp.csr_matrix(np.array([[1.0, -1.0], [0.0, 2.0]]))
    b = sp.csr_matrix(np.array([[1.0, 0.0], [1.0, 0.0]]))
    got, want = _run_both(a, b, 8, 4096)
    assert got.indptr.tolist() == [0, 1, 2]
    assert_same_csr(got, want)


def test_multiply_with_a_plan_equals_jax():
    a, b, window, lane = STRUCTURES["skewed"]
    plan = tbin.binned_plan(a.indptr, a.indices, b.indptr, window=window, lane_width=lane)
    jplan = jbin.binned_plan(a.indptr, a.indices, b.indptr, window=window, lane_width=lane)
    cap = tsmm.bucket_capacity(plan.n_partials)
    got = tsmm.multiply(tsmm.from_scipy(a, device="cpu"), tsmm.from_scipy(b, device="cpu"),
                        out_capacity=cap, plan=plan)
    assert_same_csr(got, jsmm.multiply(jsmm.from_scipy(a), jsmm.from_scipy(b),
                                       out_capacity=cap, plan=jplan))


def test_device_args_are_tensors_on_the_device():
    a, b, window, lane = STRUCTURES["uniform"]
    plan = tbin.binned_plan(a.indptr, a.indices, b.indptr, window=window, lane_width=lane)
    args = plan.device_args("cpu")
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu" for x in args[:5])
    assert [tuple(x.shape) for x in args[1:5]] == [plan.va_slice.shape] * 4
    np.testing.assert_array_equal(args[2].numpy(), plan.va_len)
    assert args[5] is None  # row_lane: the engine does not read it


@pytest.fixture
def routed():
    """Every product above 0 partials goes to the device engines (the cost
    model prices the device at nothing)."""
    saved = tsmm.get_config()
    tsmm.set_config(host_compute_limit=0, auto_calibrate_link=False, link_fixed_s=1e-9,
                    link_up_bytes_per_s=1e15, link_down_bytes_per_s=1e15, host_rate_base=1.0)
    yield
    tsmm.set_config(saved)


def _unsorted(mat, seed):
    """The same matrix with each row's entries in a shuffled order."""
    rng = np.random.default_rng(seed)
    mat = mat.tocsr()
    perm = np.concatenate([rng.permutation(np.arange(s, e))
                           for s, e in zip(mat.indptr[:-1], mat.indptr[1:])])
    out = sp.csr_matrix((mat.data[perm], mat.indices[perm], mat.indptr.copy()), shape=mat.shape)
    assert not out.has_canonical_format
    return out


def _with_duplicates(mat):
    """The same matrix with every entry split into two halves."""
    coo = mat.tocoo()
    data = np.concatenate([coo.data / 2, coo.data / 2])
    rows, cols = np.tile(coo.row, 2), np.tile(coo.col, 2)
    order = np.lexsort((cols, rows))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=mat.shape[0]))])
    out = sp.csr_matrix((data[order], cols[order], indptr), shape=mat.shape)
    assert not out.has_canonical_format
    return out


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("form", ["unsorted", "duplicates"])
def test_r1_non_canonical_input_equals_scipy(routed, form, symmetric):
    """R1: the plan is built from the canonical structure the engine uploads,
    and the caller's matrices are left as they were."""
    a = sp.random(400, 400, density=0.02, format="csr", random_state=41)
    b = sp.random(400, 400, density=0.02, format="csr", random_state=42)
    a.data = 2 * a.data - 1
    ref = (a @ b).toarray()
    a_in = _unsorted(a, 1) if form == "unsorted" else _with_duplicates(a)
    b_in = _unsorted(b, 2) if form == "unsorted" else _with_duplicates(b)
    saved = [(m.indptr.copy(), m.indices.copy(), m.data.copy()) for m in (a_in, b_in)]
    got = tsmm.sparse_matrix_multiply(a_in, b_in, symmetric=symmetric, device="cpu")
    assert tsmm.get_last_route() == "esc_binned"
    np.testing.assert_allclose(got.toarray(), np.triu(ref) if symmetric else ref, **TOL)
    for m, (ptr, idx, val) in zip((a_in, b_in), saved):
        assert (np.array_equal(m.indptr, ptr) and np.array_equal(m.indices, idx)
                and np.array_equal(m.data, val))


def test_r3_tuned_tile_falls_back_to_the_configured_tile(routed, monkeypatch):
    """R3: above the tuning threshold B's long rows double the window; one A
    row of 300 entries then overflows a 256-slot lane (None).  The router
    retries the configured tile (512 slots a lane) and stays on the binned
    engine, equal to scipy."""
    monkeypatch.setattr(api, "_BINNED_TUNE_PARTIALS", 1000)
    rng = np.random.default_rng(5)
    k, n = 400, 500
    b = sp.csr_matrix((rng.uniform(size=k * 7), (np.repeat(np.arange(k), 7),
                                                 rng.integers(0, n, k * 7))), shape=(k, n))
    b.sum_duplicates()
    rows = np.concatenate([np.zeros(300, int), rng.integers(1, 50, 200)])
    cols = np.concatenate([np.arange(300), rng.integers(0, k, 200)])
    a = sp.csr_matrix((rng.uniform(size=500), (rows, cols)), shape=(50, k))
    a.sum_duplicates()
    expand = int(np.diff(b.indptr)[a.indices].sum())
    assert b.nnz / k > 0.75 * 8 and expand > 1000
    assert tbin.binned_plan(a.indptr, a.indices, b.indptr, window=16, lane_width=4096) is None
    plan = api._binned_plan_for(a, b, expand)
    assert (plan.window, plan.lane_width) == (8, 4096)
    got = tsmm.sparse_matrix_multiply(a, b, device="cpu")
    assert tsmm.get_last_route() == "esc_binned"
    ref = (a @ b).tocsr()
    ref.sort_indices()
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_allclose(got.data, ref.data, **TOL)
