"""The port's classic and windowed ESC engines against the JAX package's
(``ops/spgemm_jnp.py``) and scipy, on the CPU in f64.

Both packages get the same padded containers of the same scipy operands;
``indptr`` and the live ``indices`` must be equal and the values agree to
summation order (rtol = atol = 1e-12).
"""

import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_matrix_mult_tpu as jsmm
import sparse_matrix_mult_tpu_torch as tsmm
from sparse_matrix_mult_tpu.ops import spgemm_jnp as jesc

tesc = importlib.import_module("sparse_matrix_mult_tpu_torch.ops.spgemm_esc")

TOL = dict(rtol=1e-12, atol=1e-12)

# (m, k, n, density of A, density of B, seed): generic, B rows longer than
# every window (the JAX tail engaged), and a square one for the symmetric
# filter.
CASES = {
    "generic": (120, 90, 110, 0.06, 0.08, 1),
    "long_b_rows": (60, 40, 300, 0.1, 0.4, 2),
    "square": (150, 150, 150, 0.05, 0.05, 3),
}


def _pair(case, signed=False):
    m, k, n, da, db, seed = CASES[case]
    a = sp.random(m, k, density=da, format="csr", random_state=seed)
    b = sp.random(k, n, density=db, format="csr", random_state=seed + 100)
    if signed:
        a.data = 2 * a.data - 1
    return a, b


def _containers(a, b, dtype=torch.float64):
    jdtype = np.float32 if dtype == torch.float32 else None
    return ((tsmm.from_scipy(a, dtype=dtype, device="cpu"),
             tsmm.from_scipy(b, dtype=dtype, device="cpu")),
            (jsmm.from_scipy(a, dtype=jdtype), jsmm.from_scipy(b, dtype=jdtype)))


def _expand(a, b):
    return int(np.diff(b.indptr)[a.indices].sum())


def assert_same_csr(got, want, tol=TOL):
    """A port container against a JAX one: equal indptr and live indices,
    values within ``tol``."""
    indptr = np.asarray(want.indptr)
    nnz = int(indptr[-1])
    np.testing.assert_array_equal(got.indptr.numpy(), indptr)
    np.testing.assert_array_equal(got.indices.numpy()[:nnz], np.asarray(want.indices)[:nnz])
    np.testing.assert_allclose(got.values.numpy()[:nnz], np.asarray(want.values)[:nnz], **tol)
    assert not got.values.numpy()[nnz:].any() and not got.indices.numpy()[nnz:].any()


def _scipy(c):
    out = tsmm.to_scipy(c)
    out.sort_indices()
    return out


@pytest.mark.parametrize("symmetric,row_offset", [(False, 0), (True, 0), (True, 7)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_spgemm_esc_equals_jax(case, symmetric, row_offset):
    a, b = _pair(case, signed=True)
    (ta, tb), (ja, jb) = _containers(a, b)
    cap = tsmm.bucket_capacity(_expand(a, b))
    kw = dict(expand_capacity=cap, out_capacity=cap, symmetric=symmetric)
    got = tesc.spgemm_esc(ta, tb, row_offset=row_offset, **kw)
    assert_same_csr(got, jesc.spgemm_esc(ja, jb, row_offset=row_offset, **kw))
    if row_offset == 0:
        ref = (a @ b).toarray()
        np.testing.assert_allclose(got.todense().numpy(), np.triu(ref) if symmetric else ref,
                                   **TOL)


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_spgemm_esc_windowed_equals_jax(case, symmetric):
    a, b = _pair(case, signed=True)
    (ta, tb), (ja, jb) = _containers(a, b)
    expand = _expand(a, b)
    plan = tesc.windowed_plan(a.nnz, np.diff(b.indptr)[a.indices], expand)
    window, tail = plan if plan is not None else (4, expand)
    cap = tsmm.bucket_capacity(expand)
    kw = dict(window=window, expand_capacity=cap, out_capacity=cap, symmetric=symmetric,
              tail_capacity=tsmm.bucket_capacity(tail) if tail else 0)
    got = tesc.spgemm_esc_windowed(ta, tb, row_offset=3, **kw)
    assert_same_csr(got, jesc.spgemm_esc_windowed(ja, jb, row_offset=3, **kw))


def test_windowed_equals_classic_bit_for_bit():
    """The windowed engine shares the classic expansion: the same bits."""
    a, b = _pair("long_b_rows", signed=True)
    ta, tb = _containers(a, b)[0]
    cap = tsmm.bucket_capacity(_expand(a, b))
    classic = tesc.spgemm_esc(ta, tb, expand_capacity=cap, out_capacity=cap)
    windowed = tesc.spgemm_esc_windowed(ta, tb, window=4, expand_capacity=cap,
                                        tail_capacity=cap, out_capacity=cap)
    for field in ("indptr", "indices", "values"):
        assert torch.equal(getattr(classic, field), getattr(windowed, field)), field


@pytest.mark.parametrize("symmetric", [False, True])
def test_b_table_gives_the_call_without_it(symmetric):
    a, b = _pair("square", signed=True)
    (ta, tb), (ja, jb) = _containers(a, b)
    expand = _expand(a, b)
    window, tail = tesc.windowed_plan(a.nnz, np.diff(b.indptr)[a.indices], expand)
    cap = tsmm.bucket_capacity(expand)
    kw = dict(window=window, expand_capacity=cap, out_capacity=cap, symmetric=symmetric,
              tail_capacity=tsmm.bucket_capacity(tail) if tail else 0)
    table = tesc.precompute_window_table(tb, window)
    with_table = tsmm.multiply(ta, tb, b_table=table, **kw)
    without = tsmm.multiply(ta, tb, **kw)
    for field in ("indptr", "indices", "values"):
        assert torch.equal(getattr(with_table, field), getattr(without, field)), field
    assert_same_csr(with_table, jsmm.multiply(ja, jb, **kw))
    # JAX's table is f32-only: the f32 products with a table each, held to f32 rounding.
    (ta32, tb32), (ja32, jb32) = _containers(a, b, torch.float32)
    got = tsmm.multiply(ta32, tb32, b_table=tesc.precompute_window_table(tb32, window), **kw)
    want = jsmm.multiply(ja32, jb32, b_table=jesc.precompute_window_table(jb32, window), **kw)
    assert_same_csr(got, want, tol=dict(rtol=1e-5, atol=1e-6))
    with pytest.raises(ValueError, match="b_table shape"):
        tsmm.multiply(ta, tb, b_table=table[:-1], **kw)


@pytest.mark.parametrize("out_capacity", [128, 256])
def test_truncated_out_capacity_equals_jax(out_capacity):
    """Entries past out_capacity are dropped; indptr counts those kept."""
    a, b = _pair("generic")
    (ta, tb), (ja, jb) = _containers(a, b)
    cap = tsmm.bucket_capacity(_expand(a, b))
    kw = dict(expand_capacity=cap, out_capacity=out_capacity)
    got = tesc.spgemm_esc(ta, tb, **kw)
    assert int(got.nnz) == out_capacity < (a @ b).nnz
    assert_same_csr(got, jesc.spgemm_esc(ja, jb, **kw))


@pytest.mark.parametrize("fused", [False, True])
def test_esc_sort_compress_equals_jax(fused):
    """Duplicate keys summed, dead slots (int32 max) dropped, in both key forms."""
    rng = np.random.default_rng(4)
    n_rows, n_cols, E = 30, 40, 2000
    i = rng.integers(0, n_rows, E).astype(np.int32)
    k = rng.integers(0, n_cols, E).astype(np.int32)
    dead = rng.random(E) < 0.2
    i[dead] = k[dead] = np.iinfo(np.int32).max
    v = rng.standard_normal(E)
    kw = dict(n_rows=n_rows, n_cols=n_cols, out_capacity=1024)
    if fused:
        key = np.where(dead, np.iinfo(np.int32).max, i.astype(np.int64) * n_cols + k)
        got = tesc.esc_sort_compress(None, torch.from_numpy(key), torch.from_numpy(v), **kw)
        want = jesc.esc_sort_compress(None, np.asarray(key, np.int32), v, **kw)
    else:
        got = tesc.esc_sort_compress(torch.from_numpy(i), torch.from_numpy(k),
                                     torch.from_numpy(v), **kw)
        want = jesc.esc_sort_compress(i, k, v, **kw)
    nnz = int(want[0][-1])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy()[:nnz], np.asarray(want[1])[:nnz])
    np.testing.assert_allclose(got[2].numpy()[:nnz], np.asarray(want[2])[:nnz], **TOL)


def _lens(seed, n, long_share):
    rng = np.random.default_rng(seed)
    lens = rng.poisson(6, n)
    heavy = rng.random(n) < long_share
    lens[heavy] = rng.integers(40, 200, heavy.sum())
    return lens


@pytest.mark.parametrize("lens", [
    _lens(1, 5000, 0.0), _lens(2, 5000, 0.02), _lens(3, 5000, 0.3),
    np.full(1000, 3), np.full(1000, 100), np.zeros(10, np.int64),
], ids=["short", "skewed", "heavy", "all_3", "all_100", "empty"])
def test_windowed_plan_equals_jax(lens):
    expand = int(lens.sum())
    assert tesc.windowed_plan(len(lens), lens, expand) == jesc.windowed_plan(
        len(lens), lens, expand)


def test_expansion_size_is_the_host_count():
    a, b = _pair("generic")
    assert tesc.expansion_size(a.indices, a.nnz, b.indptr) == _expand(a, b) == (
        jesc.expansion_size(a.indices, a.nnz, b.indptr))


def test_r6_short_tail_capacity_raises():
    """R6: JAX's windowed engine with an undersized tail_capacity returns a
    product missing partials; the port raises, and with the capacity
    windowed_plan gives it equals scipy."""
    a, b = _pair("long_b_rows")
    (ta, tb), (ja, jb) = _containers(a, b)
    expand = _expand(a, b)
    cap = tsmm.bucket_capacity(expand)
    window = 8
    tail = int(np.maximum(np.diff(b.indptr)[a.indices] - window, 0).sum())
    assert tail > 128
    ref = (a @ b).toarray()
    short = dict(window=window, expand_capacity=cap, out_capacity=cap, tail_capacity=128)
    dropped = jsmm.to_scipy(jesc.spgemm_esc_windowed(ja, jb, **short)).toarray()
    assert not np.allclose(dropped, ref, rtol=1e-5, atol=1e-8)  # the JAX fault
    with pytest.raises(ValueError, match="tail_capacity"):
        tesc.spgemm_esc_windowed(ta, tb, **short)
    with pytest.raises(ValueError, match="tail_capacity"):
        tsmm.multiply(ta, tb, window=window, expand_capacity=cap, out_capacity=cap)
    with pytest.raises(ValueError, match="expand_capacity"):
        tesc.spgemm_esc(ta, tb, expand_capacity=expand - 1, out_capacity=cap)
    got = tesc.spgemm_esc_windowed(ta, tb, window=window, expand_capacity=cap,
                                   tail_capacity=tsmm.bucket_capacity(tail), out_capacity=cap)
    np.testing.assert_array_equal(_scipy(got).toarray() != 0, ref != 0)
    np.testing.assert_allclose(got.todense().numpy(), ref, **TOL)


def test_structural_zeros_kept():
    """Gustavson structure: an entry whose partials cancel exactly stays."""
    a = sp.csr_matrix(np.array([[1.0, -1.0], [0.0, 2.0]]))
    b = sp.csr_matrix(np.array([[1.0, 0.0], [1.0, 0.0]]))
    (ta, tb), (ja, jb) = _containers(a, b)
    kw = dict(expand_capacity=128, out_capacity=128)
    got = tesc.spgemm_esc(ta, tb, **kw)
    assert got.indptr.tolist() == [0, 1, 2]
    assert_same_csr(got, jesc.spgemm_esc(ja, jb, **kw))
