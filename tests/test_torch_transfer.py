"""The download layer on the CPU: the full triangle's index rebuild against
its old arithmetic, the symmetric dense route through it against the JAX
package and scipy, and the staged copy loop of ``fetch_np`` driven with
unpinned staging buffers and a small chunk.

The staged loop runs on the card through pinned buffers and a copy stream;
``tests/test_torch_cuda.py`` holds it there against ``.cpu().numpy()``.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_matrix_mult_tpu as jsmm
import sparse_matrix_mult_tpu_torch as tsmm
from sparse_matrix_mult_tpu_torch import api
from sparse_matrix_mult_tpu_torch.utils import transfer
from sparse_matrix_mult_tpu_torch.utils.transfer import fetch_np, staged_fetch

ORACLE = dict(rtol=1e-5, atol=1e-8)
ON_DEVICE = dict(auto_calibrate_link=False, link_fixed_s=1e-9, link_up_bytes_per_s=1e15,
                 link_down_bytes_per_s=1e15, host_rate_base=1.0)
CHUNK_BYTES = 64  # 16 float32 or int32 elements, 8 float64


def _old_full_triu_csr(values, indptr, m):
    """The rebuild as the route wrote it before: two repeats, an arange and
    int64 temporaries."""
    nnz = len(values)
    counts = np.diff(indptr)
    rows = np.repeat(np.arange(m, dtype=np.int64), counts)
    indices = (
        np.arange(nnz, dtype=np.int64) - np.repeat(indptr[:-1].astype(np.int64), counts) + rows
    ).astype(np.int32)
    return sp.csr_matrix((values, indices, indptr), shape=(m, m))


@pytest.mark.parametrize("m", [1, 2, 7, 300, 2048])
def test_full_triu_rebuild_equals_the_old_arithmetic(m):
    indptr = np.concatenate([[0], np.cumsum(np.arange(m, 0, -1))]).astype(np.int32)
    values = np.random.default_rng(m).standard_normal(int(indptr[-1]))
    got = api._full_triu_csr(values, indptr, m)
    want = _old_full_triu_csr(values, indptr, m)
    assert got.shape == (m, m)
    assert got.indices.dtype == np.int32 and got.indptr.dtype == np.int32
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.toarray(), np.triu(got.toarray()))
    assert got.nnz == m * (m + 1) // 2


def test_symmetric_full_triangle_equals_jax_and_scipy(monkeypatch):
    """A dense symmetric product past host_extract_limit takes
    _fetch_full_triu (values only, indices rebuilt on the host)."""
    a = sp.random(160, 120, density=0.3, format="csr", random_state=5)
    b = sp.random(120, 160, density=0.3, format="csr", random_state=6)
    ref = sp.triu(a @ b, format="csr")
    assert ref.nnz == 160 * 161 // 2  # non-negative values: the triangle is full
    calls = []
    real = api._fetch_full_triu
    monkeypatch.setattr(api, "_fetch_full_triu", lambda c, nnz: calls.append(nnz) or real(c, nnz))
    saved_t, saved_j = tsmm.get_config(), jsmm.get_config()
    try:
        tsmm.set_config(**ON_DEVICE, host_compute_limit=0, host_extract_limit=1000)
        jsmm.set_config(**ON_DEVICE, host_compute_limit=0, host_extract_limit=1000)
        got = tsmm.sparse_matrix_multiply(a, b, symmetric=True, device="cpu")
        route = tsmm.get_last_route()
        want = jsmm.sparse_matrix_multiply(a, b, symmetric=True)
    finally:
        tsmm.set_config(saved_t)
        jsmm.set_config(saved_j)
    assert route == "dense" and calls == [ref.nnz]
    assert sp.isspmatrix_csr(got) and got.dtype == np.float64
    for other in (want.tocsr(), ref):
        other.sort_indices()
        np.testing.assert_array_equal(got.indptr, other.indptr)
        np.testing.assert_array_equal(got.indices, other.indices)
        np.testing.assert_allclose(got.data, other.data, **ORACLE)


def _staging():
    return [torch.zeros(CHUNK_BYTES, dtype=torch.uint8) for _ in range(2)]


def _chunk(dtype) -> int:
    return CHUNK_BYTES // torch.empty((), dtype=dtype).element_size()


@pytest.mark.parametrize("edge", ["empty", "one", "chunk_less_one", "chunk", "three_chunks_and_5"])
@pytest.mark.parametrize("src_dtype,dtype", [(torch.float32, np.float64),
                                             (torch.float32, None),
                                             (torch.float64, None),
                                             (torch.int32, None),
                                             (torch.int32, np.int64)])
def test_staged_fetch_at_the_chunk_edges(edge, src_dtype, dtype):
    chunk = _chunk(src_dtype)
    n = dict(empty=0, one=1, chunk_less_one=chunk - 1, chunk=chunk,
             three_chunks_and_5=3 * chunk + 5)[edge]
    gen = torch.Generator().manual_seed(n)
    if src_dtype == torch.int32:
        x = torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32, generator=gen)
    else:
        x = torch.randn(n, generator=gen).to(src_dtype) * 1e3
    got = staged_fetch(x, dtype, _staging())
    want = x.numpy() if dtype is None else x.numpy().astype(dtype)
    assert got.dtype == want.dtype and got.shape == (n,)
    np.testing.assert_array_equal(got, want)


def test_staged_fetch_of_a_non_contiguous_tensor_keeps_its_shape():
    base = torch.arange(7 * 13, dtype=torch.float32).reshape(7, 13)
    x = base.t()[2:, ::2]  # (11, 4), neither row- nor column-contiguous
    assert not x.is_contiguous()
    got = staged_fetch(x, np.float64, _staging())
    assert got.shape == (11, 4) and got.dtype == np.float64
    np.testing.assert_array_equal(got, x.contiguous().numpy().astype(np.float64))


def test_staged_fetch_results_never_alias_the_staging_buffers():
    staging = _staging()
    n = 3 * _chunk(torch.float32) + 5
    first_x = torch.arange(n, dtype=torch.float32)
    first = staged_fetch(first_x, None, staging)
    kept = first.copy()
    second = staged_fetch(-first_x - 1, None, staging)
    np.testing.assert_array_equal(first, kept)
    np.testing.assert_array_equal(second, -kept - 1)
    for buf in staging:
        assert not np.shares_memory(first, buf.numpy())
        assert not np.shares_memory(second, buf.numpy())


def test_fetch_np_on_the_cpu_takes_the_plain_path(monkeypatch):
    """One positional argument behaves as before; with a dtype the cast
    follows.  The CPU never reaches the staging ring."""
    monkeypatch.setattr(transfer, "_ring", lambda device: pytest.fail("staged on the CPU"))
    x = torch.linspace(-1.0, 1.0, 1000, dtype=torch.float32)
    plain = fetch_np(x)
    assert plain.dtype == np.float32 and np.shares_memory(plain, x.numpy())
    cast = fetch_np(x, np.float64)
    assert cast.dtype == np.float64
    np.testing.assert_array_equal(cast, x.numpy().astype(np.float64))
    assert np.shares_memory(fetch_np(x, np.float32), x.numpy())


def test_to_scipy_casts_the_values_in_the_download():
    a = sp.random(50, 40, density=0.2, format="csr", random_state=3, dtype=np.float32)
    packed = tsmm.from_scipy(a, dtype=torch.float32, device="cpu")
    plain = tsmm.to_scipy(packed)
    cast = api._to_scipy_f64(packed)
    assert plain.dtype == np.float32 and cast.dtype == np.float64
    np.testing.assert_array_equal(cast.indptr, a.indptr)
    np.testing.assert_array_equal(cast.indices, a.indices)
    np.testing.assert_array_equal(cast.data, a.data.astype(np.float64))
