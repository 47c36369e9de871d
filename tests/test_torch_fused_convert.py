"""The fused conversions K7 ``dense_to_csr_fused`` and K8
``csr_to_dense_fused`` (plain versions, on the CPU) against the JAX
package's fused Pallas kernels run in interpret mode, on identical inputs,
and against K4/K3 and scipy.  The CUDA kernels are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from sparse_matrix_mult_tpu import from_scipy as jax_from_scipy
from sparse_matrix_mult_tpu.ops.pallas.convert_kernels import (
    csr_to_dense_fused as jax_csr_to_dense_fused,
    dense_to_csr_fused as jax_dense_to_csr_fused,
)
from sparse_matrix_mult_tpu_torch.ops.kernels import LAUNCHES
from sparse_matrix_mult_tpu_torch.ops.kernels import convert_kernels as ck

# (rows, cols, density, lane, scan_group): the cases of test_pallas_convert.py
CASES = [
    (16, 300, 0.2, 256, 4),
    (37, 1000, 0.1, 512, 4),
    (8, 128, 0.0, 128, 2),
    (100, 513, 0.5, 256, 4),
    (5, 64, 1.0, 128, 2),
    (200, 200, 0.05, 256, 8),
    (63, 190, 0.3, 128, 3),
]


def _t(x):
    return torch.from_numpy(np.array(x))


def _capacity(nnz: int) -> int:
    return max(128, 1 << (max(nnz, 1) - 1).bit_length())


def _signed(m, n, d, seed, dtype):
    """Values of both signs, exact in float32."""
    a = sp.random(m, n, density=d, format="csr", random_state=seed)
    a.data = (2.0 * a.data - 1.0).astype(np.float32).astype(np.float64)
    return a, a.toarray().astype(dtype)


def _assert_same(got, want):
    for g, w, field in zip(got, want, ("indptr", "indices", "values")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=field)


@pytest.mark.parametrize("m,n,d,lane,gs", CASES)
def test_dense_to_csr_fused_plain_matches_pallas(m, n, d, lane, gs):
    """f32: the same indptr, indices and values, bit for bit, padding included."""
    _, dense = _signed(m, n, d, 1, np.float32)
    cap = _capacity(int(np.count_nonzero(dense)))
    want = jax_dense_to_csr_fused(jnp.asarray(dense), cap, lane=lane)
    got = ck.dense_to_csr_fused(_t(dense), cap, lane=lane)
    assert got[2].dtype == torch.float32
    _assert_same(got, want)


@pytest.mark.parametrize("m,n,d,lane,gs", CASES)
def test_csr_to_dense_fused_plain_matches_pallas(m, n, d, lane, gs):
    """f32, from the JAX package's own padded container: bit-identical."""
    a = sp.random(m, n, density=d, format="csr", random_state=2)
    dev = jax_from_scipy(a, dtype=jnp.float32)
    want = np.asarray(jax_csr_to_dense_fused(dev.indptr, dev.indices, dev.values, (m, n),
                                             lane=lane))
    got = ck.csr_to_dense_fused(_t(dev.indptr), _t(dev.indices), _t(dev.values), (m, n),
                                lane=lane)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,n,d,lane,gs", CASES)
def test_fused_f64_roundtrip_matches_scipy(m, n, d, lane, gs):
    a, dense = _signed(m, n, d, 3, np.float64)
    ref = sp.csr_matrix(dense)
    indptr, indices, values = ck.dense_to_csr_fused(_t(dense), _capacity(ref.nnz), lane=lane)
    assert values.dtype == torch.float64
    nnz = int(indptr[-1])
    assert nnz == ref.nnz
    np.testing.assert_array_equal(indptr.numpy(), ref.indptr)
    np.testing.assert_array_equal(indices[:nnz].numpy(), ref.indices)
    np.testing.assert_array_equal(values[:nnz].numpy(), ref.data)
    assert not indices[nnz:].any() and not values[nnz:].any()
    back = ck.csr_to_dense_fused(indptr, indices, values, (m, n), lane=lane)
    np.testing.assert_array_equal(back.numpy(), dense)


@pytest.mark.parametrize("m,n,d,lane,gs", CASES)
def test_fused_equal_k4_and_k3(m, n, d, lane, gs):
    """K7 equals K4 and K8 equals K3, truncation at capacity < nnz included
    (the JAX fused extraction leaves that case undefined)."""
    _, dense = _signed(m, n, d, 4, np.float32)
    c = _t(dense)
    nnz = int(np.count_nonzero(dense))
    for cap in (max(nnz // 2, 1), max(nnz - 1, 0), _capacity(nnz)):
        got = ck.dense_to_csr_fused(c, cap, lane=lane)
        want = ck.dense_to_csr(c, cap)
        for g, w in zip(got, want):
            assert torch.equal(g, w), cap
        assert int(got[0][-1]) == min(nnz, cap)
    indptr, indices, values = ck.dense_to_csr(c, _capacity(nnz))
    assert torch.equal(ck.csr_to_dense_fused(indptr, indices, values, (m, n), lane=lane),
                       ck.csr_to_dense(indptr, indices, values, (m, n)))


@pytest.mark.parametrize("shape", [(37, 1000), (63, 190), (1, 1), (3, 40000)])
def test_results_do_not_depend_on_the_lane(shape):
    m, n = shape
    _, dense = _signed(m, n, 0.3, 5, np.float64)
    c = _t(dense)
    cap = _capacity(int(np.count_nonzero(dense)))
    outs = [ck.dense_to_csr_fused(c, cap, lane=lane) for lane in (32, 128, 2048, 8192, 1 << 16)]
    for out in outs[1:]:
        for g, w in zip(out, outs[0]):
            assert torch.equal(g, w)
    dense_back = [ck.csr_to_dense_fused(*outs[0], shape, lane=lane) for lane in (32, 8192)]
    assert torch.equal(dense_back[0], c) and torch.equal(dense_back[1], c)


@pytest.mark.parametrize("shape", [(0, 5), (5, 0), (0, 0)])
def test_empty_matrices(shape):
    c = torch.zeros(shape)
    indptr, indices, values = ck.dense_to_csr_fused(c, 16)
    assert indptr.shape == (shape[0] + 1,) and not indptr.any()
    assert not indices.any() and not values.any()
    assert ck.csr_to_dense_fused(indptr, indices, values, shape).shape == shape


@pytest.mark.parametrize("lane", [0, 16, 31, 96, 1000, -64, 8192.0])
def test_bad_lane_raises(lane):
    c = torch.ones((4, 4))
    indptr, indices, values = ck.dense_to_csr(c, 16)
    error = TypeError if isinstance(lane, float) else ValueError
    with pytest.raises(error):
        ck.dense_to_csr_fused(c, 16, lane=lane)
    with pytest.raises(error):
        ck.csr_to_dense_fused(indptr, indices, values, (4, 4), lane=lane)


def test_bad_inputs_raise():
    with pytest.raises(TypeError):
        ck.dense_to_csr_fused(torch.ones((4, 4), dtype=torch.int32), 16)
    with pytest.raises(TypeError):
        ck.dense_to_csr_fused(torch.ones((4, 4), dtype=torch.float16), 16)
    with pytest.raises(ValueError):
        ck.dense_to_csr_fused(torch.ones(16), 16)
    with pytest.raises(ValueError):  # not contiguous
        ck.dense_to_csr_fused(torch.ones((4, 4)).T[:, :3], 16)
    with pytest.raises(ValueError):
        ck.dense_to_csr_fused(torch.ones((4, 4)), -1)
    with pytest.raises(ValueError):  # neither on the CPU nor on CUDA
        ck.dense_to_csr_fused(torch.empty((4, 4), device="meta"), 16)
    indptr, indices, values = ck.dense_to_csr(torch.ones((4, 4)), 16)
    with pytest.raises(TypeError):
        ck.csr_to_dense_fused(indptr.long(), indices, values, (4, 4))
    with pytest.raises(TypeError):
        ck.csr_to_dense_fused(indptr, indices, values.half(), (4, 4))
    with pytest.raises(ValueError):
        ck.csr_to_dense_fused(indptr, indices, values, (5, 4))


def test_cpu_tensors_launch_nothing():
    before = dict(LAUNCHES)
    c = torch.eye(40)
    ck.csr_to_dense_fused(*ck.dense_to_csr_fused(c, 64), (40, 40))
    assert LAUNCHES == before
