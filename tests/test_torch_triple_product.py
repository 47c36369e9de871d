"""The port's triple product H . Q . H^T (ops/triple_product.py and
``sparse_matrix_multiply(..., use_triple_product=True)``) against the JAX
package's and scipy, on the CPU.

Both packages multiply in f64 here; only the summation order differs, hence
rtol = 1e-10, atol = 1e-12.  Against scipy the reference's oracle holds
(rtol = 1e-5, atol = 1e-8).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_matrix_mult_tpu as jsmm
import sparse_matrix_mult_tpu_torch as tsmm
from sparse_matrix_mult_tpu.ops.triple_product import triple_product_dense as jax_triple
from sparse_matrix_mult_tpu_torch.ops import triple_product as ttriple
from sparse_matrix_mult_tpu_torch.ops.kernels import LAUNCHES

TOL = dict(rtol=1e-10, atol=1e-12)
ORACLE = dict(rtol=1e-5, atol=1e-8)
# (m, n, density): H is m x n, Q is n x n
SHAPES = [(80, 80, 0.15), (60, 90, 0.1)]


def _operands(m, n, d, seed, signed=False):
    h = sp.random(m, n, density=d, format="csr", random_state=seed)
    q = sp.random(n, n, density=d, format="csr", random_state=seed + 1)
    if signed:
        h.data = 2.0 * h.data - 1.0
        q.data = 2.0 * q.data - 1.0
    return h, q


def _containers(mat):
    j = jsmm.from_scipy(mat)
    t = tsmm.CSRMatrix.from_numpy(*(np.asarray(x) for x in (j.indptr, j.indices, j.values)),
                                  j.shape, device="cpu")
    return j, t


def _expected(h, q, compute_full_matrix):
    c = (h @ q @ h.T).toarray()
    return np.triu(c) + np.triu(c, 1).T if compute_full_matrix else np.triu(c)


@pytest.fixture
def config():
    """Restore both packages' configurations after a test changes them."""
    saved_t, saved_j = tsmm.get_config(), jsmm.get_config()
    yield
    tsmm.set_config(saved_t)
    jsmm.set_config(saved_j)


@pytest.mark.parametrize("compute_full_matrix", [0, 1])
@pytest.mark.parametrize("m,n,d", SHAPES)
def test_triple_product_dense_equals_jax(m, n, d, compute_full_matrix):
    h, q = _operands(m, n, d, 1, signed=True)
    (jh, th), (jq, tq) = _containers(h), _containers(q)
    got = ttriple.triple_product_dense(th, tq, compute_full_matrix)
    assert got.dtype == torch.float64 and got.shape == (m, m)
    want = np.asarray(jax_triple(jh, jq, compute_full_matrix))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), _expected(h, q, compute_full_matrix), **ORACLE)
    if compute_full_matrix:
        assert torch.equal(got, got.T)
    else:
        assert not torch.tril(got, -1).any()


@pytest.mark.parametrize("precision", ["fast", "split", "strict"])
def test_every_policy_is_native_f64_on_the_cpu(precision):
    h, q = _operands(50, 70, 0.2, 3, signed=True)
    (jh, th), (jq, tq) = _containers(h), _containers(q)
    got = tsmm.triple_product(th, tq, 1, precision=precision)
    want = np.asarray(jsmm.triple_product(jh, jq, 1, precision=precision))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("route", ["host", "triple"])
@pytest.mark.parametrize("compute_full_matrix", [0, 1])
@pytest.mark.parametrize("m,n,d", SHAPES)
def test_sparse_matrix_multiply_equals_jax_and_scipy(m, n, d, compute_full_matrix, route, config):
    h, q = _operands(m, n, d, 5)
    if route == "triple":  # past the host limit; neither cost model may send it back
        tsmm.set_config(host_compute_limit=0, auto_calibrate_link=False, host_rate_base=1e-3)
        jsmm.set_config(host_compute_limit=0, auto_calibrate_link=False, host_rate_base=1e-3)
    kw = dict(use_triple_product=True, compute_full_matrix=compute_full_matrix)
    got = tsmm.sparse_matrix_multiply(h, q, device="cpu", **kw)
    assert tsmm.get_last_route() == route
    want = jsmm.sparse_matrix_multiply(h, q, **kw)
    assert jsmm.get_last_route() == route
    assert isinstance(got, np.ndarray) and got.dtype == np.float64 and got.shape == (m, m)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _expected(h, q, compute_full_matrix), **ORACLE)


def test_output_format_is_ignored(config):
    h, q = _operands(40, 40, 0.2, 7)
    tsmm.set_config(host_compute_limit=0, auto_calibrate_link=False, host_rate_base=1e-3)
    got = tsmm.sparse_matrix_multiply(h, q, output_format="sparse", use_triple_product=True,
                                      device="cpu")
    assert isinstance(got, np.ndarray)
    np.testing.assert_allclose(got, _expected(h, q, 0), **ORACLE)


def test_empty_operand_returns_zeros():
    h = sp.csr_matrix((30, 20))
    q = sp.random(20, 20, density=0.2, format="csr", random_state=8)
    for a, b in ((h, q), (sp.random(30, 20, density=0.2, random_state=9), sp.csr_matrix((20, 20)))):
        got = tsmm.sparse_matrix_multiply(a, b, use_triple_product=True, device="cpu")
        assert tsmm.get_last_route() == "empty"
        np.testing.assert_array_equal(got, jsmm.sparse_matrix_multiply(a, b, use_triple_product=True))
        assert got.shape == (30, 30) and not got.any()


def test_errors_match_jax():
    h = sp.random(30, 20, density=0.2, format="csr", random_state=10)
    cases = [
        dict(matrix_b=sp.random(20, 25, density=0.2, format="csr", random_state=11)),  # B.cols != A.cols
        dict(matrix_b=sp.random(20, 20, density=0.2, format="csr", random_state=12),
             compute_full_matrix=2),
        dict(matrix_b=sp.random(25, 20, density=0.2, format="csr", random_state=13)),  # inner dims
    ]
    for kw in cases:
        with pytest.raises(ValueError) as t_err:
            tsmm.sparse_matrix_multiply(h, use_triple_product=True, device="cpu", **kw)
        with pytest.raises(ValueError) as j_err:
            jsmm.sparse_matrix_multiply(h, use_triple_product=True, **kw)
        assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("compute_full_matrix", [0, 1])
@pytest.mark.parametrize("m,n,d", SHAPES)
def test_k1_branch_on_the_cpu(m, n, d, compute_full_matrix, monkeypatch):
    """The card's FAST branch (K3 twice, H.Q, K1 with transpose_b) forced on
    the CPU: the plain versions in float32, within 1e-5 * (|H| |Q| |H|^T) of
    the f64 product, and no kernel launched."""
    monkeypatch.setattr(ttriple, "_triu_kernel_ok", lambda *args: True)
    h, q = _operands(m, n, d, 14, signed=True)
    th, tq = tsmm.from_scipy(h, device="cpu"), tsmm.from_scipy(q, device="cpu")
    before = dict(LAUNCHES)
    got = ttriple.triple_product_dense(th, tq, compute_full_matrix).numpy()
    assert LAUNCHES == before
    bound = 1e-5 * (abs(h) @ abs(q) @ abs(h).T).toarray()
    if compute_full_matrix:
        bound = np.triu(bound) + np.triu(bound, 1).T
    assert np.all(np.abs(got - _expected(h, q, compute_full_matrix)) <= bound)
    if not compute_full_matrix:
        assert not np.tril(got, -1).any()
