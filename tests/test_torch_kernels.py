"""The port's kernels (plain PyTorch versions, on the CPU) against the JAX
package's Pallas kernels run in interpret mode, on identical inputs.

K1 matmul_triu (both branches), K3 csr_to_dense, K4 dense_to_csr and K2
dense_to_csr_triu (also at widths whose rows are not 16-byte aligned, in f32
and f64); and K3's flat tiling, which the CUDA kernel walks.
The CUDA versions are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from sparse_matrix_mult_tpu import from_scipy as jax_from_scipy
from sparse_matrix_mult_tpu.ops.convert import dense_to_csr as jax_dense_to_csr
from sparse_matrix_mult_tpu.ops.pallas.convert_kernels import (
    csr_to_dense_pallas,
    dense_to_csr_pallas,
    dense_to_csr_triu_staged,
)
from sparse_matrix_mult_tpu.ops.pallas.triu_matmul import matmul_triu as jax_matmul_triu
from sparse_matrix_mult_tpu_torch.ops.kernels import convert_kernels as ck
from sparse_matrix_mult_tpu_torch.ops.kernels import triu_matmul as tm

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


def _assert_same_csr(got, want):
    for g, w, field in zip(got, want, ("indptr", "indices", "values")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=field)


@pytest.mark.parametrize("split3", [False, True])
@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("m,k", [(300, 500), (256, 256), (100, 700)])
def test_matmul_triu_plain_matches_pallas(m, k, transpose_b, split3):
    """Upper triangle only.  HIGHEST (f32): within rtol 1e-5 relative to
    |A||B| of the Pallas kernel.  split3: within 2^-16 (|A||B|) + 1e-6 of
    the Pallas split3 kernel and of the exact product (the JAX test's
    bound)."""
    rng = np.random.default_rng(m + k)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((m, k) if transpose_b else (k, m)).astype(np.float32)
    want = np.triu(np.asarray(jax_matmul_triu(
        jnp.asarray(a), jnp.asarray(b), transpose_b=transpose_b, tile=128, kblock=128,
        split3=split3,
    )))
    got = torch.triu(tm.matmul_triu(_t(a), _t(b), transpose_b=transpose_b,
                                    split3=split3)).numpy()
    bt = b.T if transpose_b else b
    scale = np.triu(np.abs(a) @ np.abs(bt))
    assert got.shape == want.shape == (m, m)
    if not split3:
        assert np.all(np.abs(got - want) <= 1e-5 * scale)
        return
    bound = 2.0**-16 * scale + 1e-6
    assert np.all(np.abs(got - want) <= bound)
    assert np.all(np.abs(got - np.triu(a.astype(np.float64) @ bt.astype(np.float64))) <= bound)


@pytest.mark.parametrize("m,n,d,lane,gs", CASES)
def test_csr_to_dense_plain_matches_pallas(m, n, d, lane, gs):
    """K3's plain version is bit-identical to the Pallas densify."""
    a = sp.random(m, n, density=d, format="csr", random_state=2)
    dev = jax_from_scipy(a, dtype=jnp.float32)
    want = np.asarray(csr_to_dense_pallas(dev.indptr, dev.indices, dev.values, (m, n), lane=lane))
    got = ck.csr_to_dense(_t(dev.indptr), _t(dev.indices), _t(dev.values), (m, n))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("truncate", [False, True])
@pytest.mark.parametrize("m,n,d,lane,gs", CASES)
def test_dense_to_csr_plain_matches_pallas(m, n, d, lane, gs, truncate):
    """K4's plain version: identical indptr/indices/values, zero padding
    included, and the same truncation when capacity < nnz."""
    a = sp.random(m, n, density=d, format="csr", random_state=1)
    dense = np.asarray(a.todense(), np.float32)
    cap = max(a.nnz // 2, 1) if truncate else _capacity(a.nnz)
    want = dense_to_csr_pallas(jnp.asarray(dense), cap, lane=lane)
    got = ck.dense_to_csr(_t(dense), cap)
    _assert_same_csr(got, want)
    assert int(got[0][-1]) == min(a.nnz, cap)


@pytest.mark.parametrize("truncate", [False, True])
@pytest.mark.parametrize("m,n,d,lane,gs", CASES)
def test_dense_to_csr_triu_plain_matches_staircase(m, n, d, lane, gs, truncate):
    """K2's plain version against the staircase extraction on an m x m upper
    triangle of each case's density."""
    a = sp.random(m, m, density=d, format="csr", random_state=4)
    dense = np.triu(np.asarray(a.todense(), np.float32))
    nnz = int(np.count_nonzero(dense))
    cap = max(nnz // 2, 1) if truncate else _capacity(nnz)
    want = dense_to_csr_triu_staged(jnp.asarray(dense), cap, strip=64, lane=256, scan_group=gs)
    got = ck.dense_to_csr(_t(dense), cap, triu=True)
    _assert_same_csr(got, want)


def test_dense_to_csr_triu_ignores_lower_triangle():
    """K2 scans columns col >= row only, whatever the lower triangle holds."""
    rng = np.random.default_rng(0)
    full = rng.standard_normal((50, 50))
    got = ck.dense_to_csr(torch.from_numpy(full), 2048, triu=True)
    want = ck.dense_to_csr(torch.from_numpy(np.triu(full)), 2048)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_versions_keep_dtype(dtype):
    a = sp.random(30, 40, density=0.2, format="csr", random_state=5)
    dense = torch.from_numpy(a.toarray()).to(dtype)
    indptr, indices, values = ck.dense_to_csr(dense, 512)
    assert values.dtype == dtype and indices.dtype == torch.int32 and indptr.dtype == torch.int32
    back = ck.csr_to_dense(indptr, indices, values, (30, 40))
    assert back.dtype == dtype
    assert torch.equal(back, dense)


def test_wrappers_reject_other_devices_and_types():
    """A tensor that is neither on the CPU nor on CUDA raises; so do wrong
    dtypes and shapes (no silent fallback)."""
    meta = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError):
        ck.dense_to_csr(meta, 16)
    with pytest.raises(ValueError):
        tm.matmul_triu(meta, meta)
    with pytest.raises(TypeError):
        ck.dense_to_csr(torch.zeros((4, 4), dtype=torch.int32), 16)
    with pytest.raises(ValueError):
        ck.dense_to_csr(torch.zeros((4, 5)), 16, triu=True)
    with pytest.raises(ValueError):
        tm.matmul_triu(torch.zeros((4, 3)), torch.zeros((4, 4)))
    with pytest.raises(TypeError):
        ck.csr_to_dense(torch.zeros(5, dtype=torch.int64), torch.zeros(4, dtype=torch.int32),
                        torch.zeros(4), (4, 4))


# (m, n, itemsize, SMs): n not a multiple of 4 (f32) or 2 (f64), rows wider
# than a 32 KB tile, m * n not a multiple of the tile, m or n = 1, and the
# main path's shapes (the 10k operand, the inversion's H and Q).
TILING_CASES = [
    (1, 1, 4, 132), (1, 1, 8, 132), (7, 13, 4, 132), (7, 13, 8, 132), (3, 9999, 4, 132),
    (5, 12_345, 8, 132), (100_001, 1, 4, 132), (1, 100_001, 8, 132), (1000, 33, 4, 4),
    (10_000, 10_000, 4, 132), (4096, 16_384, 4, 132), (16_384, 16_384, 4, 132),
    (12_289, 12_287, 8, 132), (64, 64, 4, 1),
]


@pytest.mark.parametrize("m,n,itemsize,sms", TILING_CASES)
def test_densify_tiling_covers_the_output_once(m, n, itemsize, sms):
    """K3's tiles cover [0, m n) once, in order, each CTA a contiguous range
    of them; every start is 16-byte aligned, no tile exceeds a shared
    buffer, and no CTA is left without a tile."""
    tile, per_cta, ctas = ck._densify_tiling(m, n, itemsize, sms)
    assert tile > 0 and tile * itemsize <= ck.DENSIFY_BUFFER
    assert (tile * itemsize) % 16 == 0  # tile t starts at t * tile * itemsize bytes
    n_tiles = -(-(m * n) // tile)
    starts = np.arange(n_tiles, dtype=np.int64) * tile
    ends = np.minimum(starts + tile, m * n)
    assert starts[0] == 0 and ends[-1] == m * n
    assert np.all(ends > starts) and np.all(starts[1:] == ends[:-1])
    owned = [range(b * per_cta, min((b + 1) * per_cta, n_tiles)) for b in range(ctas)]
    assert all(len(r) > 0 for r in owned) and sum(map(len, owned)) == n_tiles
    assert 1 <= ctas <= min(n_tiles, sms * ck.DENSIFY_CTAS_PER_SM)
    if m * n * itemsize >= sms * ck.DENSIFY_CTAS_PER_SM * ck.DENSIFY_BUFFER:
        assert tile * itemsize == ck.DENSIFY_BUFFER
        assert ctas > (sms * ck.DENSIFY_CTAS_PER_SM) // 2


@pytest.mark.parametrize("truncate", [False, True])
@pytest.mark.parametrize("triu", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [1, 3, 5, 33, 130])
def test_dense_to_csr_plain_at_unaligned_widths_matches_jax(n, dtype, triu, truncate):
    """K2/K4's plain version at widths whose rows are not 16-byte aligned
    (n * itemsize not a multiple of 16), where the CUDA kernel splits each
    row into a scalar head, 16-byte vectors and a scalar tail: against the
    JAX package's extraction (its XLA path with ``keep``, whose indptr counts
    past the capacity and is clamped here) and, in f32, its Pallas kernels."""
    rng = np.random.default_rng(n + 7 * triu)
    m = n if triu else n + 4
    dense = ((rng.random((m, n)) < 0.5) * rng.standard_normal((m, n))).astype(dtype)
    keep = np.triu(dense != 0) if triu else dense != 0
    nnz = int(keep.sum())
    cap = max(nnz // 2, 1) if truncate else _capacity(nnz)
    got = ck.dense_to_csr(torch.from_numpy(dense), cap, triu=triu)
    want = jax_dense_to_csr(jnp.asarray(dense), cap, keep=jnp.asarray(keep))
    assert got[2].dtype == torch.from_numpy(dense).dtype
    _assert_same_csr(got, (np.minimum(np.asarray(want.indptr), cap), want.indices, want.values))
    assert int(got[0][-1]) == min(nnz, cap)
    if dtype == np.float32:  # the Pallas extraction takes f32 only
        if triu:
            pallas = dense_to_csr_triu_staged(jnp.asarray(np.triu(dense)), cap, strip=64,
                                              lane=256, scan_group=4)
        else:
            pallas = dense_to_csr_pallas(jnp.asarray(dense), cap)
        _assert_same_csr(got, pallas)

