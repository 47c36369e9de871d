"""The port's CSR container against the JAX package's, on identical inputs."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import sparse_matrix_mult_tpu as jsmm
import sparse_matrix_mult_tpu_torch as tsmm
from sparse_matrix_mult_tpu.ops.convert import csr_row_ids as jax_csr_row_ids
from sparse_matrix_mult_tpu.utils.transfer import fine_capacity as jax_fine_capacity
from sparse_matrix_mult_tpu_torch.ops.convert import csr_row_ids
from sparse_matrix_mult_tpu_torch.utils.transfer import fine_capacity

SHAPES = [(1, 1, 1.0), (7, 300, 0.1), (64, 64, 0.0), (120, 90, 0.3), (33, 500, 0.02)]


def _jax_to_port(c):
    return tsmm.CSRMatrix.from_numpy(
        np.asarray(c.indptr), np.asarray(c.indices), np.asarray(c.values), c.shape, device="cpu"
    )


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m,n,d", SHAPES)
def test_from_scipy_to_scipy_round_trip(m, n, d, dtype):
    a = sp.random(m, n, density=d, format="csr", random_state=3)
    c = tsmm.from_scipy(a, dtype=dtype, device="cpu")
    assert c.capacity == tsmm.bucket_capacity(a.nnz)
    assert c.indptr.dtype == c.indices.dtype == torch.int32 and c.dtype == dtype
    assert int(c.nnz) == a.nnz
    assert torch.all(c.indices[a.nnz:] == 0) and torch.all(c.values[a.nnz:] == 0)
    back = tsmm.to_scipy(c)
    np.testing.assert_array_equal(back.indptr, a.indptr)
    np.testing.assert_array_equal(back.indices, a.indices)
    np.testing.assert_array_equal(back.data, a.data.astype(back.dtype))


@pytest.mark.parametrize("m,n,d", SHAPES)
def test_from_numpy_of_jax_container_equals_from_scipy(m, n, d):
    """The JAX container's padded arrays, taken as they are, build the same
    container as the port's own upload."""
    a = sp.random(m, n, density=d, format="csr", random_state=4)
    jc = jsmm.from_scipy(a)
    pc = _jax_to_port(jc)
    own = tsmm.from_scipy(a, device="cpu")
    assert pc.shape == own.shape and pc.capacity == own.capacity == jc.capacity
    for field in ("indptr", "indices", "values"):
        assert torch.equal(getattr(pc, field), getattr(own, field)), field


def test_from_scipy_dedups_and_checks_capacity():
    a = sp.csr_matrix((np.array([1.0, 2.0, 3.0]), np.array([1, 1, 0]), np.array([0, 2, 3])),
                      shape=(2, 2))
    c = tsmm.from_scipy(a, device="cpu")
    assert int(c.nnz) == 2 and c.values[0].item() == 3.0
    with pytest.raises(ValueError):
        tsmm.from_scipy(sp.random(10, 10, density=0.5, format="csr"), capacity=4, device="cpu")


def test_capacity_buckets_equal_jax():
    for n in list(range(0, 2100, 7)) + [2**k + j for k in range(8, 31) for j in (-1, 0, 1)]:
        assert tsmm.bucket_capacity(n) == jsmm.bucket_capacity(n), n
        assert fine_capacity(n) == jax_fine_capacity(n), n
    assert tsmm.bucket_capacity(5, minimum=1) == jsmm.bucket_capacity(5, minimum=1)


@pytest.mark.parametrize("m,n,d", SHAPES)
def test_row_ids_equal_jax(m, n, d):
    a = sp.random(m, n, density=d, format="csr", random_state=5)
    jc = jsmm.from_scipy(a)
    pc = _jax_to_port(jc)
    np.testing.assert_array_equal(pc.row_ids().numpy(), np.asarray(jc.row_ids()))
    np.testing.assert_array_equal(csr_row_ids(pc).numpy(), np.asarray(jax_csr_row_ids(jc)))


@pytest.mark.parametrize("capacity", [4096, 37])
def test_from_dense_equals_jax(capacity):
    a = sp.random(40, 60, density=0.2, format="csr", random_state=6).toarray()
    jc = jsmm.from_dense(jnp.asarray(a), capacity)
    pc = tsmm.from_dense(torch.from_numpy(a), capacity)
    for field in ("indptr", "indices", "values"):
        np.testing.assert_array_equal(getattr(pc, field).numpy(), np.asarray(getattr(jc, field)))


@pytest.mark.parametrize("m,n,d", SHAPES)
def test_todense_and_transpose_dense_equal_jax(m, n, d):
    a = sp.random(m, n, density=d, format="csr", random_state=8)
    c, j = tsmm.from_scipy(a, device="cpu"), jsmm.from_scipy(a)
    np.testing.assert_array_equal(c.todense().numpy(), np.asarray(j.todense()))
    np.testing.assert_array_equal(c.transpose_dense().numpy(), np.asarray(j.transpose_dense()))
    assert c.todense(torch.float32).dtype == torch.float32


def test_todense_sums_duplicate_entries():
    c = tsmm.CSRMatrix.from_numpy([0, 3, 3], [1, 1, 0, 0], [1.0, 2.0, 4.0, 0.0], (2, 2),
                                  device="cpu")
    assert c.todense().tolist() == [[4.0, 3.0], [0.0, 0.0]]


@pytest.mark.parametrize("capacity", [128, 512, 4096])
def test_with_capacity_equals_jax(capacity):
    a = sp.random(40, 50, density=0.1, format="csr", random_state=9)
    c, j = tsmm.from_scipy(a, device="cpu"), jsmm.from_scipy(a)
    got, want = c.with_capacity(capacity), j.with_capacity(capacity)
    assert got.capacity == capacity == want.capacity
    for field in ("indptr", "indices", "values"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))
    assert c.with_capacity(c.capacity) is c
