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


# n > lane and lane dividing no row: rows straddle flat-rows.
STRADDLE_CASES = [(4, 700, 0.3, 256), (2, 1500, 0.2, 512), (7, 300, 0.5, 128)]


@pytest.mark.parametrize("m,n,d,lane", STRADDLE_CASES)
def test_dense_to_csr_fused_plain_matches_pallas_across_flat_rows(m, n, d, lane):
    _, dense = _signed(m, n, d, 6, np.float32)
    cap = _capacity(int(np.count_nonzero(dense)))
    want = jax_dense_to_csr_fused(jnp.asarray(dense), cap, lane=lane)
    _assert_same(ck.dense_to_csr_fused(_t(dense), cap, lane=lane), want)


def _scipy_truncated(dense, cap):
    """The first ``cap`` entries of scipy's CSR, indptr clamped, zero padding."""
    ref = sp.csr_matrix(dense)
    kept = min(ref.nnz, cap)
    indices = np.zeros(cap, np.int32)
    values = np.zeros(cap, dense.dtype)
    indices[:kept] = ref.indices[:kept]
    values[:kept] = ref.data[:kept]
    return np.minimum(ref.indptr, cap), indices, values


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n,d,lane", STRADDLE_CASES + [(30, 1000, 0.1, 32)])
def test_dense_to_csr_fused_truncates_like_k4(m, n, d, lane, dtype):
    """capacity inside a flat-row, at one entry and at 0 (the JAX fused
    extraction needs capacity >= nnz): K4's plain version and scipy."""
    _, dense = _signed(m, n, d, 7, dtype)
    live = (dense.reshape(-1) != 0).astype(np.int64)
    per_row = np.add.reduceat(live, np.arange(0, live.size, lane))
    r = len(per_row) // 2
    inside = int(per_row[:r].sum()) + int(per_row[r]) // 2
    for cap in (inside, 1, 0):
        got = ck.dense_to_csr_fused(_t(dense), cap, lane=lane)
        for g, w in zip(got, ck.dense_to_csr_plain(_t(dense), cap)):
            assert torch.equal(g, w), cap
        _assert_same(got, _scipy_truncated(dense, cap))


# K7's tiles at shapes, element sizes, addresses (their remainder modulo 16)
# and SM counts: small matrices (one tile, tiles shrunk to spread), the
# 12,288^2 main-path shape, and more than 2^31 elements.
TILING_SHAPES = [(1, 1), (5, 64), (37, 1000), (1000, 1000), (4097, 3), (12_288, 12_288),
                 (2, 2**30 + 64)]


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("m,n", TILING_SHAPES)
def test_extract_tiling_covers_the_matrix_once(m, n, itemsize, sms):
    for address in range(0, 16, itemsize):
        t = ck._extract_tiling(m, n, itemsize, address, sms)
        # Every tile starts 16-byte aligned and copies a multiple of 16 bytes.
        assert t.lead * itemsize == address
        assert t.span_bytes % 16 == 0 and t.tile_bytes % ck.EXTRACT_QUANTUM == 0
        assert t.tile_bytes & (t.tile_bytes - 1) == 0 and t.tile_bytes <= ck.EXTRACT_TILE
        # The tiles cover the span once, and the span the matrix.
        assert (t.n_tiles - 1) * t.tile_bytes < t.span_bytes <= t.n_tiles * t.tile_bytes
        assert (t.lead + m * n) * itemsize <= t.span_bytes < (t.lead + m * n) * itemsize + 16
        # The rings fit the shared-memory budget, with a stage to load while
        # one is written.
        assert 2 <= t.stages <= ck.EXTRACT_MAX_STAGES
        assert t.stages * t.tile_bytes * ck.EXTRACT_CTAS_PER_SM <= ck.EXTRACT_RING <= 200 * 1024
        assert t.ctas == sms * ck.EXTRACT_CTAS_PER_SM
    # A tile is no larger than an SM's share, unless that is below the quantum.
    t = ck._extract_tiling(m, n, itemsize, 0, sms)
    assert t.tile_bytes == ck.EXTRACT_QUANTUM or t.tile_bytes <= -(-t.span_bytes // sms)
