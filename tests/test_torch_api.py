"""The port's public API against the JAX package's and scipy, on the CPU.

At 600^2, d = 0.3 both packages take the dense route; non-negative
``sp.random`` values leave no cancellation zeros, so the structure must be
identical and the values agree in f64 to summation order.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_matrix_mult_tpu as jsmm
import sparse_matrix_mult_tpu_torch as tsmm
from sparse_matrix_mult_tpu_torch import api

TOL = dict(rtol=1e-12, atol=1e-12)
# Both packages route by the same host/device cost model (tests/test_torch_cost_model.py);
# these settings price the device at nothing in either (tests/test_large_sparse.py), so
# the routes these tests assert do not hang on the link a calibration measures.
ON_DEVICE = dict(auto_calibrate_link=False, link_fixed_s=1e-9, link_up_bytes_per_s=1e15,
                 link_down_bytes_per_s=1e15, host_rate_base=1.0)


@pytest.fixture(scope="module")
def operands():
    a = sp.random(600, 600, density=0.3, format="csr", random_state=1)
    b = sp.random(600, 600, density=0.3, format="csr", random_state=2)
    return a, b, (a @ b).tocsr()


@pytest.fixture(autouse=True)
def config():
    """Pin both packages' cost models on the device, and restore both
    configurations after the test."""
    saved_t, saved_j = tsmm.get_config(), jsmm.get_config()
    tsmm.set_config(**ON_DEVICE)
    jsmm.set_config(**ON_DEVICE)
    yield tsmm.set_config
    tsmm.set_config(saved_t)
    jsmm.set_config(saved_j)


def _check_sparse(got, want, ref):
    assert sp.isspmatrix_csr(got) and got.dtype == np.float64
    got.sort_indices()
    for other in (want, ref):
        other = other.tocsr()
        other.sort_indices()
        np.testing.assert_array_equal(got.indptr, other.indptr)
        np.testing.assert_array_equal(got.indices, other.indices)
        np.testing.assert_allclose(got.data, other.data, **TOL)


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("output_format", ["sparse", "dense"])
def test_dense_route_equals_jax_and_scipy(operands, output_format, symmetric):
    a, b, ref = operands
    ref = sp.triu(ref, format="csr") if symmetric else ref
    got = tsmm.sparse_matrix_multiply(a, b, output_format, symmetric, device="cpu")
    assert tsmm.get_last_route() == "dense"
    want = jsmm.sparse_matrix_multiply(a, b, output_format, symmetric)
    assert jsmm.get_last_route() == "dense"
    if output_format == "sparse":
        _check_sparse(got, want, ref)
    else:
        assert isinstance(got, np.ndarray) and got.dtype == np.float64
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, ref.toarray(), **TOL)


@pytest.mark.parametrize("symmetric", [False, True])
def test_device_extraction_equals_jax(operands, symmetric, config):
    """Below host_extract_limit the output goes through the device extraction
    (K2 for the symmetric product, K4 otherwise) instead of the host pack."""
    a, b, ref = operands
    config(host_extract_limit=1000)
    jsmm.set_config(host_extract_limit=1000)
    ref = sp.triu(ref, format="csr") if symmetric else ref
    got = tsmm.sparse_matrix_multiply(a, b, symmetric=symmetric, device="cpu")
    want = jsmm.sparse_matrix_multiply(a, b, symmetric=symmetric)
    assert tsmm.get_last_route() == jsmm.get_last_route() == "dense"
    _check_sparse(got, want, ref)


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("output_format", ["sparse", "dense"])
def test_host_short_circuit_equals_jax(output_format, symmetric):
    a = sp.random(300, 300, density=0.02, format="csr", random_state=3)
    b = sp.random(300, 300, density=0.02, format="csr", random_state=4)
    got = tsmm.sparse_matrix_multiply(a, b, output_format, symmetric, device="cpu")
    assert tsmm.get_last_route() == "host"
    want = jsmm.sparse_matrix_multiply(a, b, output_format, symmetric)
    assert jsmm.get_last_route() == "host"
    if output_format == "sparse":
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.data, want.data)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("symmetric", [False, True])
def test_multiply_device_api_equals_jax(symmetric):
    a_sp = sp.random(200, 200, density=0.1, format="csr", random_state=5)
    b_sp = sp.random(200, 200, density=0.1, format="csr", random_state=6)
    ja, jb = jsmm.from_scipy(a_sp), jsmm.from_scipy(b_sp)
    ta, tb = tsmm.from_scipy(a_sp, device="cpu"), tsmm.from_scipy(b_sp, device="cpu")
    cap = tsmm.bucket_capacity(200 * 200)
    dense = tsmm.multiply(ta, tb, output_format="dense", symmetric=symmetric)
    np.testing.assert_allclose(
        dense.numpy(), np.asarray(jsmm.multiply(ja, jb, output_format="dense", symmetric=symmetric)),
        **TOL,
    )
    got = tsmm.multiply(ta, tb, symmetric=symmetric, out_capacity=cap)
    want = jsmm.multiply(ja, jb, symmetric=symmetric, out_capacity=cap)
    assert isinstance(got, tsmm.CSRMatrix) and got.capacity == cap
    _check_sparse(tsmm.to_scipy(got), jsmm.to_scipy(want), jsmm.to_scipy(want))


def test_validation_errors_match_jax(operands):
    a, b, _ = operands
    rect = sp.random(600, 300, density=0.1, format="csr", random_state=7)
    cases = [
        dict(matrix_a=a, matrix_b=rect.T.tocsr()[:200]),  # inner dimensions differ
        dict(matrix_a=a, matrix_b=b, output_format="coo"),
        dict(matrix_a=a, matrix_b=b, compute_full_matrix=2),
        dict(matrix_a=a, matrix_b=b, imem_size="big"),
        dict(matrix_a=a, matrix_b=rect, symmetric=True),
    ]
    for kw in cases:
        with pytest.raises(ValueError) as t_err:
            tsmm.sparse_matrix_multiply(**kw, device="cpu")
        with pytest.raises(ValueError) as j_err:
            jsmm.sparse_matrix_multiply(**kw)
        assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError):
        tsmm.multiply(tsmm.from_scipy(a, device="cpu"), tsmm.from_scipy(b, device="cpu"))
    with pytest.raises(ValueError):
        tsmm.multiply(tsmm.from_scipy(a, device="cpu"), tsmm.from_scipy(b, device="cpu"),
                      output_format="coo")


@pytest.mark.parametrize("output_format", ["sparse", "dense"])
def test_empty_operand_and_zero_notice(output_format, capsys):
    a = sp.csr_matrix((50, 40))
    b = sp.random(40, 30, density=0.2, format="csr", random_state=8)
    got = tsmm.sparse_matrix_multiply(a, b, output_format, device="cpu")
    assert tsmm.get_last_route() == "empty" and got.shape == (50, 30)
    assert (got.nnz if sp.issparse(got) else np.count_nonzero(got)) == 0
    assert tsmm.sparse_matrix_multiply(a, b, use_triple_product=True, device="cpu").shape == (50, 50)
    # A product of disjoint structure is zero without an empty operand: the notice.
    c = sp.csr_matrix(([1.0], ([0], [0])), shape=(3, 3))
    d = sp.csr_matrix(([1.0], ([1], [1])), shape=(3, 3))
    capsys.readouterr()
    tsmm.sparse_matrix_multiply(c, d, output_format, device="cpu")
    assert "Multiplication resulted in a zero matrix." in capsys.readouterr().out


def test_imem_size_scales_the_esc_budget(config):
    """imem_size rescales the budget the expansion is compared against: with
    a budget at this problem's expansion the ESC rung is chosen, below it
    the dense route; each equals JAX's route and product."""
    a = sp.random(2000, 2000, density=0.01, format="csr", random_state=9)
    b = sp.random(2000, 2000, density=0.01, format="csr", random_state=10)
    expand = int((np.diff(b.indptr)[a.indices]).sum())
    config(esc_expand_limit=expand, use_binned_esc=False)
    jsmm.set_config(esc_expand_limit=expand, use_binned_esc=False)
    for imem_size, route in ((5, "esc_windowed"), (4, "dense")):
        got = tsmm.sparse_matrix_multiply(a, b, imem_size=imem_size, device="cpu")
        assert tsmm.get_last_route() == route
        want = jsmm.sparse_matrix_multiply(a, b, imem_size=imem_size)
        assert jsmm.get_last_route() == route
        _check_sparse(got, want, (a @ b).tocsr())


def test_unported_rungs_raise(operands, config):
    """The sparse-output rungs below the dense route (which raised
    NotImplementedError until the port carried them), each against JAX's
    route label and product (both pinned off the host cost model)."""
    a, b, _ = operands

    def both(x, y, route):
        got = tsmm.sparse_matrix_multiply(x, y, device="cpu")
        assert tsmm.get_last_route() == route
        want = jsmm.sparse_matrix_multiply(x, y)
        assert jsmm.get_last_route() == route
        _check_sparse(got, want, (x @ y).tocsr())

    # ESC: an expansion above the host limit, within the binned budget and
    # under a quarter of the panel.
    sparse_a = sp.random(2000, 2000, density=0.01, format="csr", random_state=11)
    sparse_b = sp.random(2000, 2000, density=0.01, format="csr", random_state=12)
    both(sparse_a, sparse_b, "esc_binned")
    # keep_structure sends every non-host problem to ESC (on the operands'
    # leading blocks: JAX takes ~1 s per 10^6 partials on the CPU).
    config(keep_structure=True)
    jsmm.set_config(keep_structure=True)
    both(a[:200, :200], b[:200, :200], "esc_windowed")
    # Row chunks: the operands' panels exceed the dense-path limit.
    limits = dict(keep_structure=False, dense_path_limit=200_000, esc_expand_limit=1000,
                  binned_expand_limit=1000)
    config(**limits)
    jsmm.set_config(**limits)
    tall = sp.random(1000, 300, density=0.3, format="csr", random_state=13)
    small = sp.random(300, 300, density=0.3, format="csr", random_state=14)
    both(tall, small, "dense_chunks")
    limits = dict(dense_path_limit=100_000, esc_expand_limit=100_000)
    config(**limits)
    jsmm.set_config(**limits)
    both(a[:100, :300], b[:300], "esc_chunks")
    assert api.get_last_route_detail()["chunks"] > 1


@pytest.mark.parametrize("output_format", ["sparse", "dense"])
def test_bsr_route_returns_the_product_on_the_cpu(output_format, config):
    """Block-sparse operands, which go to the BSR kernels on the CUDA device
    (decided on the host), return A @ B through route "bsr" on the CPU when
    the route is forced (the kernels' plain versions, in float32)."""
    blocks = [sp.random(128, 128, density=1.0, random_state=s) for s in range(4)]
    a = sp.block_diag(blocks, format="csr")  # 4 of 16 blocks occupied
    b = sp.random(512, 512, density=0.3, format="csr", random_state=15)
    assert not api._bsr_route_ok(a, "cuda")  # the H100's cutoff, 0: the dense route
    config(cuda_bsr_occupancy_cutoff=0.25)
    assert api._bsr_route_ok(a, "cuda") and not api._bsr_route_ok(a, "cpu")
    config(force_bsr=True)
    got = tsmm.sparse_matrix_multiply(a, b, output_format, device="cpu")
    assert tsmm.get_last_route() == "bsr"
    got = got.toarray() if output_format == "sparse" else got
    assert got.dtype == np.float64
    ref = (a @ b).toarray()
    bound = 1e-5 * (abs(a) @ abs(b)).toarray()  # f32 products, relative to |A| @ |B|
    assert np.all(np.abs(got - ref) <= bound)


def test_multiply_esc_keywords_raise():
    """multiply(plan=...), multiply(expand_capacity=..., window=...) and the
    classic ESC (which raised NotImplementedError until the port carried
    them) give JAX's products; the keyword errors that remain raise."""
    from sparse_matrix_mult_tpu.ops.spgemm_binned import binned_plan as jplan
    from sparse_matrix_mult_tpu_torch.ops import binned_plan

    a_sp = sp.random(50, 50, density=0.1, format="csr", random_state=16)
    a, ja = tsmm.from_scipy(a_sp, device="cpu"), jsmm.from_scipy(a_sp)
    want = jsmm.to_scipy(jsmm.multiply(ja, ja, out_capacity=4096, expand_capacity=4096))
    plan = binned_plan(a_sp.indptr, a_sp.indices, a_sp.indptr)
    assert plan is not None
    for kw in (dict(plan=plan), dict(expand_capacity=4096),
               dict(expand_capacity=4096, window=8, tail_capacity=1024)):
        got = tsmm.multiply(a, a, out_capacity=4096, **kw)
        _check_sparse(tsmm.to_scipy(got), want, (a_sp @ a_sp).tocsr())
    got = jsmm.multiply(ja, ja, out_capacity=4096,
                        plan=jplan(a_sp.indptr, a_sp.indices, a_sp.indptr))
    _check_sparse(jsmm.to_scipy(got), want, want)
    with pytest.raises(ValueError, match="expand_capacity"):
        tsmm.multiply(a, a, out_capacity=4096, window=8)
    with pytest.raises(ValueError, match="expand_capacity"):
        tsmm.multiply(a, a, out_capacity=4096, tail_capacity=1024)
    with pytest.raises(ValueError, match="out_capacity"):
        tsmm.multiply(a, a, plan=plan)


def test_upload_dtype_follows_the_device():
    """FAST problems go up as float32 on CUDA; the CPU keeps native f64."""
    a = sp.random(100, 100, density=0.1, format="csr", random_state=17)
    assert api._upload_dtype(a, a, "cuda") == (torch.float32, "fast")
    assert api._upload_dtype(a, a, "cpu") == (None, None)
    assert tsmm.get_config().device == "cuda"
