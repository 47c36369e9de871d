"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, at small and ragged shapes (the main path's shapes are checked by
chip_smoke.py).

Needs an NVIDIA GPU with nvcc: every test skips without one.  On the card,
from the repository root (this file imports no JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparse_matrix_mult_tpu_torch as tsmm
from sparse_matrix_mult_tpu_torch.ops.convert import csr_to_dense
from sparse_matrix_mult_tpu_torch.ops.kernels import LAUNCHES
from sparse_matrix_mult_tpu_torch.ops.kernels import bsr_spgemm as kb
from sparse_matrix_mult_tpu_torch.ops.kernels import convert_kernels as ck
from sparse_matrix_mult_tpu_torch.ops.kernels import triu_matmul as tm
from sparse_matrix_mult_tpu_torch.ops.matmul import full_fp32

pytestmark = pytest.mark.cuda

SHAPES = [(1, 1), (5, 64), (37, 1000), (129, 257), (300, 300), (1000, 33)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _random(m, n, density, seed, dtype, device):
    """Values of both signs: the extraction keeps every nonzero, not only positives."""
    a = sp.random(m, n, density=density, format="csr", random_state=seed)
    a.data = 2.0 * a.data - 1.0
    return a, torch.from_numpy(a.toarray()).to(dtype).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n", SHAPES)
def test_csr_to_dense_kernel(cuda, m, n, dtype):
    a = sp.random(m, n, density=0.3, format="csr", random_state=1)
    c = tsmm.from_scipy(a, dtype=dtype, device=cuda)
    before = LAUNCHES["csr_to_dense"]
    got = ck.csr_to_dense(c.indptr, c.indices, c.values, c.shape)
    torch.cuda.synchronize()
    assert LAUNCHES["csr_to_dense"] == before + 1
    assert torch.equal(got, ck.csr_to_dense_plain(c.indptr, c.indices, c.values, c.shape))


# K3's edges: n not a multiple of 4 (f32) or 2 (f64), rows wider than a 32 KB
# tile, m n not a multiple of the tile (a ragged tail below 16 bytes), m or
# n = 1, many narrow rows in one tile.
K3_EDGE_SHAPES = [(3, 9999), (5, 12_345), (2, 40_003), (100_001, 1), (1, 100_001), (7, 13),
                  (1000, 33), (4097, 3), (1, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n", K3_EDGE_SHAPES)
def test_csr_to_dense_kernel_edges(cuda, m, n, dtype):
    """K3 bit for bit against its plain version and K8 at its tiling's
    edges; the entries past indptr[m] hold garbage (indices off the matrix,
    NaN values) that must never be read."""
    a = sp.random(m, n, density=0.2, format="csr", random_state=m + n)
    c = tsmm.from_scipy(a, dtype=dtype, device=cuda)
    indices, values = c.indices.clone(), c.values.clone()
    indices[a.nnz:] = 2**31 - 1
    values[a.nnz:] = float("nan")
    before = LAUNCHES["csr_to_dense"]
    got = ck.csr_to_dense(c.indptr, indices, values, c.shape)
    torch.cuda.synchronize()
    assert LAUNCHES["csr_to_dense"] == before + 1
    assert torch.equal(got, ck.csr_to_dense_plain(c.indptr, indices, values, c.shape))
    assert torch.equal(got, ck.csr_to_dense_fused(c.indptr, c.indices, c.values, c.shape))
    assert torch.equal(got.cpu(), torch.from_numpy(a.toarray()).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_csr_to_dense_kernel_on_an_empty_matrix(cuda, dtype):
    """No entries: every element written, as zero, over many tiles; a
    garbage-filled container past indptr[m] = 0 changes nothing."""
    m, n = 700, 3001
    indptr = torch.zeros(m + 1, dtype=torch.int32, device=cuda)
    indices = torch.full((64,), 5, dtype=torch.int32, device=cuda)
    values = torch.full((64,), float("nan"), dtype=dtype, device=cuda)
    got = ck.csr_to_dense(indptr, indices, values, (m, n))
    assert got.shape == (m, n) and not bool(got.any())
    assert torch.equal(got, ck.csr_to_dense_fused(indptr, indices, values, (m, n)))


@pytest.mark.parametrize("truncate", [False, True])
@pytest.mark.parametrize("triu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n", SHAPES)
def test_dense_to_csr_kernel(cuda, m, n, dtype, triu, truncate):
    if triu:
        n = m
    _, dense = _random(m, n, 0.3, 2, dtype, cuda)
    dense[0, -1] = -0.0  # a negative zero is a zero
    nnz = int(torch.count_nonzero(torch.triu(dense) if triu else dense))
    cap = max(nnz // 2, 1) if truncate else tsmm.bucket_capacity(nnz)
    got = ck.dense_to_csr(dense, cap, triu=triu)
    torch.cuda.synchronize()
    want = ck.dense_to_csr_plain(dense, cap, triu=triu)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_dense_to_csr_kernel_pads_a_large_capacity(cuda):
    _, dense = _random(8, 40, 0.2, 3, torch.float32, cuda)
    got = ck.dense_to_csr(dense, 1 << 20)
    want = ck.dense_to_csr_plain(dense, 1 << 20)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# K2/K4's edges: widths whose rows are not 16-byte aligned (a scalar head and
# tail around the 16-byte vectors), rows longer than one 2 KB segment (and
# triangles whose rows start in a later segment column), many short rows,
# and a matrix that starts 4 bytes off a 16-byte boundary.
EXTRACT_EDGE_SHAPES = [(7, 1), (3, 3), (5, 5), (33, 33), (130, 130), (9, 1030), (600, 600),
                       (4, 5000), (1100, 1100), (1030, 9)]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("truncate", [False, True])
@pytest.mark.parametrize("triu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n", EXTRACT_EDGE_SHAPES)
def test_dense_to_csr_kernel_edges(cuda, m, n, dtype, triu, truncate, offset):
    """K2/K4 bit for bit against the plain version and K7; one launch
    counted per call."""
    if triu and m != n:
        pytest.skip("triu takes a square matrix")
    _, dense = _random(m, n, 0.4, m + n, dtype, cuda)
    if offset:  # the same matrix at an address one element past a 16-byte boundary
        moved = torch.empty(m * n + offset, dtype=dtype, device=cuda)[offset:].view(m, n)
        dense = moved.copy_(dense)
    nnz = int(torch.count_nonzero(torch.triu(dense) if triu else dense))
    cap = max(nnz // 2, 1) if truncate else tsmm.bucket_capacity(nnz)
    key = "dense_to_csr_triu" if triu else "dense_to_csr"
    before = LAUNCHES[key]
    got = ck.dense_to_csr(dense, cap, triu=triu)
    torch.cuda.synchronize()
    assert LAUNCHES[key] == before + 1
    for g, w in zip(got, ck.dense_to_csr_plain(dense, cap, triu=triu)):
        assert torch.equal(g, w)
    if not triu:
        for g, w in zip(got, ck.dense_to_csr_fused(dense, cap)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("triu", [False, True])
def test_dense_to_csr_kernel_pads_a_capacity_far_above_the_entries(cuda, triu):
    _, dense = _random(130, 130, 0.05, 4, torch.float64, cuda)
    for cap in (1 << 22, 0):
        got = ck.dense_to_csr(dense, cap, triu=triu)
        for g, w in zip(got, ck.dense_to_csr_plain(dense, cap, triu=triu)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("split3", [False, True])
@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("m,k", [(1, 1), (100, 700), (129, 8), (256, 256), (300, 13), (700, 300),
                                 (1000, 65), (130, 1000)])
def test_matmul_triu_kernel(cuda, m, k, transpose_b, split3):
    """K1's HIGHEST and split3 branches against their plain versions within
    1e-5 (|A| |B|), at K = 1, 8, 13 and others off the 64-deep K-step; the
    two forms give the same bits, and split3's bits are not HIGHEST's (a K1
    that ignored ``split3`` would pass the bound)."""
    rng = np.random.default_rng(m + k)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal((m, k) if transpose_b else (k, m)).astype(np.float32))
    b = b.to(cuda)
    before = dict(LAUNCHES)
    got = torch.triu(tm.matmul_triu(a, b, transpose_b=transpose_b, split3=split3))
    torch.cuda.synchronize()
    assert LAUNCHES["matmul_triu"] == before["matmul_triu"] + 1
    assert LAUNCHES["split_bf16"] == before["split_bf16"] + 2
    want = torch.triu(tm.matmul_triu_plain(a, b, transpose_b=transpose_b, split3=split3))
    with full_fp32():
        unit = torch.triu(torch.matmul(a.abs(), (b.T if transpose_b else b).abs()))
    assert bool(((got - want).abs() <= 1e-5 * unit).all())
    other = b.T.contiguous()
    assert torch.equal(got, torch.triu(tm.matmul_triu(a, other, transpose_b=not transpose_b,
                                                      split3=split3)))
    if m > 1:
        assert not torch.equal(got, torch.triu(tm.matmul_triu(a, b, transpose_b=transpose_b,
                                                              split3=not split3)))


@pytest.mark.parametrize("split3", [False, True])
@pytest.mark.parametrize("m,k,n", [(300, 64, 700), (700, 100, 300)])
def test_matmul_triu_kernel_rectangular_output(cuda, m, k, n, split3):
    """A non-square output, wide or tall: every upper tile (ti <= tj) is
    computed."""
    rng = np.random.default_rng(m + n)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(cuda)
    got = tm.matmul_triu(a, b, split3=split3)
    want = tm.matmul_triu_plain(a, b, split3=split3)
    tiles = torch.arange(m, device=cuda)[:, None] // 128 <= torch.arange(n, device=cuda) // 128
    assert torch.allclose(got[tiles], want[tiles], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("split3", [False, True])
def test_matmul_triu_pieces_is_k1s_gemm(cuda, split3):
    """K1's GEMM alone, on the pieces of the two splits, gives K1's bits and
    counts one matmul_triu launch."""
    rng = np.random.default_rng(31)
    a = torch.from_numpy(rng.standard_normal((300, 200)).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal((200, 400)).astype(np.float32)).to(cuda)
    pieces = 2 if split3 else 3
    ap, bp = tm.split_bf16(a, pieces), tm.split_bf16(b, pieces, transpose=True)
    before = LAUNCHES["matmul_triu"]
    got = tm.matmul_triu_pieces(ap, bp, 300, 400)
    torch.cuda.synchronize()
    assert LAUNCHES["matmul_triu"] == before + 1
    tiles = torch.arange(300, device=cuda)[:, None] // 128 <= torch.arange(400, device=cuda) // 128
    assert torch.equal(got[tiles], tm.matmul_triu(a, b, split3=split3)[tiles])


@pytest.mark.parametrize("pieces", [2, 3])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("rows,k", [(1, 1), (5, 64), (129, 700), (300, 13), (1000, 333)])
def test_split_bf16_kernel(cuda, rows, k, transpose, pieces):
    """The split kernel bit for bit against its plain version, padding
    included, from an aligned operand and from one 4 bytes off alignment."""
    rng = np.random.default_rng(rows + k)
    x = rng.standard_normal((k, rows) if transpose else (rows, k)).astype(np.float32)
    x *= 10.0 ** rng.integers(-6, 7, x.shape)
    aligned = torch.from_numpy(x).to(cuda)
    shifted = torch.empty(x.size + 1, device=cuda)[1:].view(x.shape)
    shifted.copy_(aligned)
    for given in (aligned, shifted):
        before = LAUNCHES["split_bf16"]
        got = tm.split_bf16(given, pieces, transpose=transpose)
        torch.cuda.synchronize()
        assert LAUNCHES["split_bf16"] == before + 1
        assert torch.equal(got, tm.split_bf16_plain(given, pieces, transpose=transpose))


def test_fast_multiply_takes_split3(cuda):
    """multiply(precision="fast", symmetric=True) on a dense-enough product
    takes K1's split3 branch (two splits and one K1 launch) and stays within
    the f64 oracle; AUTO takes the HIGHEST branch with the same launches."""
    a_sp = sp.random(1200, 1000, density=0.3, format="csr", random_state=24)
    b_sp = sp.random(1000, 1200, density=0.3, format="csr", random_state=25)
    a, b = tsmm.from_scipy(a_sp, device=cuda), tsmm.from_scipy(b_sp, device=cuda)
    ad, bd = (csr_to_dense(x, torch.float32) for x in (a, b))
    ref = np.triu((a_sp @ b_sp).toarray())
    for precision in ("fast", None):
        before = dict(LAUNCHES)
        got = tsmm.multiply(a, b, output_format="dense", symmetric=True, precision=precision)
        torch.cuda.synchronize()
        assert LAUNCHES["split_bf16"] == before["split_bf16"] + 2
        assert LAUNCHES["matmul_triu"] == before["matmul_triu"] + 1
        branch = torch.triu(tm.matmul_triu(ad, bd, split3=precision == "fast"))
        assert torch.equal(got, branch.to(got.dtype))
        np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=1e-5, atol=1e-8)


def test_kernels_reject_mismatched_inputs(cuda):
    a = torch.zeros((4, 4), device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        tm.matmul_triu(a, a)
    with pytest.raises(ValueError):  # not contiguous
        ck.dense_to_csr(torch.zeros((4, 4), device=cuda).T[:, :3], 16)
    with pytest.raises(ValueError):  # one operand on the CPU
        tm.matmul_triu(torch.zeros((4, 4), device=cuda), torch.zeros((4, 4)))


@pytest.fixture
def tf32_on():
    """PyTorch's global TF32 switch turned on, as a user may leave it."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    yield
    torch.set_float32_matmul_precision(prev)


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("precision", ["fast", "split", "strict"])
def test_precision_policies_ignore_global_tf32(cuda, tf32_on, precision, symmetric):
    """Every policy of the dense route stays within the f64 oracle with TF32
    switched on globally: the f32 products run in full FP32 regardless."""
    a_sp = sp.random(1100, 900, density=0.3, format="csr", random_state=6)
    b_sp = sp.random(900, 1100, density=0.3, format="csr", random_state=7)
    a = tsmm.from_scipy(a_sp, device=cuda)
    b = tsmm.from_scipy(b_sp, device=cuda)
    got = tsmm.multiply(a, b, output_format="dense", symmetric=symmetric, precision=precision)
    ref = (a_sp @ b_sp).toarray()
    np.testing.assert_allclose(got.cpu().numpy(), np.triu(ref) if symmetric else ref,
                               rtol=1e-5, atol=1e-8)


def test_symmetric_multiply_on_the_card(cuda):
    """The public entry point on the card, at a size where the product goes
    through K3, K1 and K2, against scipy at the reference tolerance."""
    a = sp.random(2500, 2500, density=0.1, format="csr", random_state=4)
    b = sp.random(2500, 2500, density=0.1, format="csr", random_state=5)
    before = dict(LAUNCHES)
    got = tsmm.sparse_matrix_multiply(a, b, symmetric=True, device="cuda")
    assert tsmm.get_last_route() == "dense"
    for key in ("csr_to_dense", "matmul_triu", "dense_to_csr_triu"):
        assert LAUNCHES[key] > before[key], key
    ref = sp.triu(a @ b, format="csr")
    assert got.nnz == ref.nnz
    np.testing.assert_allclose(got.toarray(), ref.toarray(), rtol=1e-5, atol=1e-8)


def _block_sparse(nbr, nbc, occ, seed, b=128):
    """Dense f32 matrix whose occupied blocks (a fraction ``occ``, at least
    one) hold standard-normal values."""
    rng = np.random.default_rng(seed)
    mask = rng.random((nbr, nbc)) < occ
    mask[rng.integers(nbr), rng.integers(nbc)] = True
    dense = np.zeros((nbr * b, nbc * b), np.float32)
    for i, j in zip(*np.nonzero(mask)):
        dense[i * b:(i + 1) * b, j * b:(j + 1) * b] = rng.standard_normal((b, b))
    return dense


def _ragged(rows, cols, seed):
    rng = np.random.default_rng(seed)
    dense = np.zeros((rows, cols), np.float32)
    dense[: rows // 2, : cols // 2] = rng.standard_normal((rows // 2, cols // 2))
    dense[-1, -1] = 3.0
    return dense


def _bsr(dense, device, capacity=None):
    return tsmm.bsr_from_scipy(sp.csr_matrix(dense), 128, dtype=torch.float32,
                               block_capacity=capacity, device=device)


def _assert_within_bound(got, want, ad, bd, device):
    """|got - want| <= 1e-5 * (|A| @ |B|) elementwise (f64 bound on the card)."""
    a64 = torch.from_numpy(np.abs(ad).astype(np.float64)).to(device)
    b64 = torch.from_numpy(np.abs(bd).astype(np.float64)).to(device)
    bound = 1e-5 * (a64 @ b64)
    assert not torch.isnan(got).any()
    assert bool(((got.double() - want.double()).abs() <= bound).all())


def _k5_operands(case):
    rng = np.random.default_rng(9)
    if case == "ragged":
        ad = _ragged(200, 300, 1)
    elif case == "empty_block_rows":
        ad = np.zeros((4 * 128, 2 * 128), np.float32)
        ad[2 * 128:3 * 128, :128] = rng.standard_normal((128, 128))
    else:
        ad = _block_sparse(*case, seed=sum(case[:2]))
    return ad, rng.standard_normal((ad.shape[1], 333)).astype(np.float32)


# (block-rows, block-columns, occupancy); (2, 7, 1.0) runs block-rows of 7
# blocks, 14 K-steps through a ring of 2 stages.
@pytest.mark.parametrize("case", [(1, 1, 1.0), (3, 4, 0.5), (5, 3, 0.6), (2, 7, 1.0), "ragged",
                                  "empty_block_rows"])
def test_bsr_matmul_dense_kernel(cuda, case):
    """K5 (two splits and the GEMM) within 1e-5 (|A| |B|) of its plain
    version, empty block-rows exactly zero; its GEMM alone on the pieces
    gives the same bits."""
    ad, bd = _k5_operands(case)
    a = _bsr(ad, cuda)
    b = torch.from_numpy(bd).to(cuda)
    before = dict(LAUNCHES)
    got = kb.bsr_matmul_dense(a, b)
    torch.cuda.synchronize()
    assert LAUNCHES["bsr_matmul_dense"] == before["bsr_matmul_dense"] + 1
    assert LAUNCHES["split_bf16"] == before["split_bf16"] + 2
    assert got.shape == (ad.shape[0], bd.shape[1])
    _assert_within_bound(got, kb.bsr_matmul_dense_plain(a, b), ad, bd, cuda)
    empty = np.repeat(np.diff(a.indptr.cpu().numpy()) == 0, 128)[: ad.shape[0]]
    assert bool((got[torch.from_numpy(empty).to(cuda)] == 0).all())
    ap, bp = kb.bsr_split(a, b)
    assert torch.equal(kb.bsr_matmul_dense_pieces(ap, bp, a, bd.shape[1]), got)
    _assert_within_bound(kb.bsr_matmul_dense_pieces_plain(ap, bp, a, bd.shape[1]), got, ad, bd,
                         cuda)


def test_bsr_matmul_dense_kernel_is_highest(cuda):
    """K5 at HIGHEST, like K1: non-negative operands (no cancellation), max
    |got - ref| / |ref| against the f64 product at most 1e-6 over K = 896."""
    rng = np.random.default_rng(35)
    ad = np.abs(_block_sparse(4, 7, 0.5, seed=35))
    bd = rng.random((7 * 128, 300)).astype(np.float32)
    got = kb.bsr_matmul_dense(_bsr(ad, cuda), torch.from_numpy(bd).to(cuda)).double()
    ref = torch.from_numpy(ad.astype(np.float64) @ bd.astype(np.float64)).to(cuda)
    live = ref > 0
    assert bool((got[~live] == 0).all())
    assert float(((got - ref).abs()[live] / ref[live]).max()) <= 1e-6


def test_bsr_matmul_dense_kernel_on_a_truncated_container(cuda):
    """``bsr_from_dense`` with 5 slots for 12 nonzero blocks: the kernel
    reads only the stored blocks, as the plain version does, and block-row
    2 (every block past the capacity) is zero."""
    ad = _block_sparse(3, 4, 1.0, seed=34)
    a = tsmm.bsr_from_dense(torch.from_numpy(ad).to(cuda), 5)
    assert int(a.nblocks) == 12 and a.block_capacity == 5
    bd = np.random.default_rng(8).standard_normal((4 * 128, 200)).astype(np.float32)
    b = torch.from_numpy(bd).to(cuda)
    got = kb.bsr_matmul_dense(a, b)
    _assert_within_bound(got, kb.bsr_matmul_dense_plain(a, b), ad, bd, cuda)
    assert bool((got[2 * 128:] == 0).all())


def test_bsr_matmul_dense_kernel_reads_only_the_rows_it_needs(cuda):
    """B with NaN rows past A's column count (inside A's last partial block
    and beyond it): the kernel gives the product of B's first rows."""
    ad, bd = _k5_operands("ragged")  # A is 200 x 300
    a = _bsr(ad, cuda)
    extra = np.vstack([bd, np.full((100, bd.shape[1]), np.nan, np.float32)])
    got = kb.bsr_matmul_dense(a, torch.from_numpy(extra).to(cuda))
    plain = kb.bsr_matmul_dense_plain(a, torch.from_numpy(bd).to(cuda))
    _assert_within_bound(got, plain, ad, bd, cuda)


def _k6_operands(case):
    if case == "ragged":
        ad, bd = _ragged(200, 300, 2), _ragged(300, 250, 3)
    elif case == "empty_block_rows":
        ad = _block_sparse(4, 3, 0.5, seed=4)
        ad[:128] = 0
        ad[3 * 128:] = 0
        ad[128:256, :128] = 1.0
        bd = _block_sparse(3, 4, 0.5, seed=5)
    elif case == "long_run":  # every output block a run of 6 pairs
        ad = _block_sparse(2, 6, 1.0, seed=7)
        bd = _block_sparse(6, 2, 1.0, seed=8)
    elif case == "single_pair":
        ad = np.zeros((3 * 128, 3 * 128), np.float32)
        bd = np.zeros((3 * 128, 3 * 128), np.float32)
        ad[:128, 128:256] = 1.0
        bd[128:256, 256:] = 2.0
    else:
        nbr, nbk, nbc = case
        ad = _block_sparse(nbr, nbk, 0.5, seed=nbr + nbk)
        bd = _block_sparse(nbk, nbc, 0.5, seed=nbk + nbc + 1)
    return ad, bd


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("case", [(1, 1, 1), (3, 4, 3), (5, 3, 4), "ragged", "empty_block_rows",
                                  "single_pair", "long_run"])
def test_bsr_bsr_matmul_dense_kernel(cuda, case, padded):
    """Against the plain version, on the real pairs or the planner's padded
    tables; output blocks no pair visits are exactly zero.  One call is two
    splits, the run check and the GEMM; the GEMM alone on the pieces gives
    K6's bits, within 1e-6 (|A| |B|) of the six passes of those pieces."""
    ad, bd = _k6_operands(case)
    a_sp, b_sp = sp.csr_matrix(ad), sp.csr_matrix(bd)
    plan = kb.bsr_pair_plan(a_sp, b_sp, 128)
    n = None if padded else plan["n_pairs"]
    tables = [torch.from_numpy(plan[k][:n]).to(cuda) for k in ("pa", "pb", "ci", "cj", "first")]
    mask = torch.from_numpy(plan["mask"]).to(cuda)
    a, b = _bsr(ad, cuda), _bsr(bd, cuda)
    before = dict(LAUNCHES)
    got = kb.bsr_bsr_matmul_dense(a, b, *tables, mask)
    torch.cuda.synchronize()
    for key, more in (("bsr_bsr_matmul_dense", 1), ("bsr_pair_runs", 1), ("split_bf16", 2)):
        assert LAUNCHES[key] == before[key] + more, key
    assert got.shape == (ad.shape[0], bd.shape[1])
    _assert_within_bound(got, kb.bsr_bsr_matmul_dense_plain(a, b, *tables, mask), ad, bd, cuda)
    visited = np.repeat(np.repeat(plan["mask"], 128, axis=0), 128, axis=1)
    visited = torch.from_numpy(visited[: ad.shape[0], : bd.shape[1]]).to(cuda)
    assert bool((got[~visited] == 0).all())
    ap, bp = kb.bsr_bsr_split(a, b)
    assert torch.equal(kb.bsr_bsr_matmul_dense_pieces(ap, bp, a, b, *tables, mask), got)
    six = kb.bsr_bsr_matmul_dense_pieces_plain(ap, bp, a, b, *tables, mask)
    unit = torch.from_numpy(np.abs(ad).astype(np.float64) @ np.abs(bd).astype(np.float64)).to(cuda)
    assert bool(((got.double() - six.double()).abs() <= 1e-6 * unit).all())
    runs = kb.bsr_pair_runs(a, b, *tables[:4])
    for g, w in zip(runs, kb.bsr_pair_runs_plain(a, b, *tables[:4])):
        assert torch.equal(g, w)


def test_bsr_bsr_matmul_dense_kernel_writes_every_block(cuda, monkeypatch):
    """The output is allocated uninitialised: here every f32 matrix that
    ``torch.empty`` hands out is NaN-filled, so a block the kernel failed to
    write (visited or not, masked out or not) would show as NaN."""
    real_empty = torch.empty

    def nan_empty(*shape, **kw):
        out = real_empty(*shape, **kw)
        return out.fill_(float("nan")) if out.dtype == torch.float32 and out.ndim == 2 else out

    ad, bd = _k6_operands("empty_block_rows")
    plan = kb.bsr_pair_plan(sp.csr_matrix(ad), sp.csr_matrix(bd), 128)
    tables = [torch.from_numpy(plan[k]).to(cuda) for k in ("pa", "pb", "ci", "cj", "first")]
    a, b = _bsr(ad, cuda), _bsr(bd, cuda)
    mask = torch.from_numpy(plan["mask"]).to(cuda)
    masked = mask.clone()
    masked.view(-1)[int(torch.nonzero(mask.view(-1))[0])] = False  # a visited block masked out
    for m in (mask, masked):
        want = kb.bsr_bsr_matmul_dense_plain(a, b, *tables, m)
        monkeypatch.setattr(torch, "empty", nan_empty)
        got = kb.bsr_bsr_matmul_dense(a, b, *tables, m)
        monkeypatch.setattr(torch, "empty", real_empty)
        assert not bool(torch.isnan(got).any())
        _assert_within_bound(got, want, ad, bd, cuda)
        assert torch.equal(got == 0, want == 0)


def test_bsr_bsr_matmul_dense_kernel_syncs_once(cuda):
    """One K6 call reads one flag word on the host, and nothing else."""
    ad, bd = _k6_operands((3, 4, 3))
    plan = kb.bsr_pair_plan(sp.csr_matrix(ad), sp.csr_matrix(bd), 128)
    tables = [torch.from_numpy(plan[k]).to(cuda) for k in ("pa", "pb", "ci", "cj", "first")]
    mask = torch.from_numpy(plan["mask"]).to(cuda)
    a, b = _bsr(ad, cuda), _bsr(bd, cuda)
    kb.bsr_bsr_matmul_dense(a, b, *tables, mask)  # warm: the build, first launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            kb.bsr_bsr_matmul_dense(a, b, *tables, mask)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in caught]


def test_bsr_bsr_matmul_dense_kernel_rejects_unsorted_tables(cuda):
    ad, bd = _k6_operands((3, 4, 3))
    plan = kb.bsr_pair_plan(sp.csr_matrix(ad), sp.csr_matrix(bd), 128)
    n = plan["n_pairs"]
    tables = [torch.from_numpy(plan[k][:n][::-1].copy()).to(cuda)
              for k in ("pa", "pb", "ci", "cj", "first")]
    a, b = _bsr(ad, cuda), _bsr(bd, cuda)
    with pytest.raises(ValueError):
        kb.bsr_bsr_matmul_dense(a, b, *tables, torch.from_numpy(plan["mask"]).to(cuda))


def test_bsr_kernels_reject_other_types_and_block_sizes(cuda):
    ad = _block_sparse(2, 2, 1.0, seed=6)
    a64 = tsmm.bsr_from_scipy(sp.csr_matrix(ad), 128, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        kb.bsr_matmul_dense(a64, torch.ones((256, 8), dtype=torch.float64, device=cuda))
    a = _bsr(ad, cuda)
    with pytest.raises(TypeError):
        kb.bsr_matmul_dense(a, torch.ones((256, 8), dtype=torch.float64, device=cuda))
    small = tsmm.bsr_from_scipy(sp.csr_matrix(ad), 64, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError):
        kb.bsr_matmul_dense(small, torch.ones((256, 8), device=cuda))
    plan = kb.bsr_pair_plan(sp.csr_matrix(ad), sp.csr_matrix(ad), 64)
    tables = [torch.from_numpy(plan[k]).to(cuda) for k in ("pa", "pb", "ci", "cj", "first")]
    with pytest.raises(ValueError):
        kb.bsr_bsr_matmul_dense(small, small, *tables, torch.from_numpy(plan["mask"]).to(cuda))
    plan = kb.bsr_pair_plan(sp.csr_matrix(ad), sp.csr_matrix(ad), 128)
    tables = [torch.from_numpy(plan[k]).to(cuda) for k in ("pa", "pb", "ci", "cj", "first")]
    with pytest.raises(TypeError):
        kb.bsr_bsr_matmul_dense(a64, a64, *tables, torch.from_numpy(plan["mask"]).to(cuda))
    mask = torch.from_numpy(plan["mask"]).to(cuda)
    for i, bad in ((0, a.block_capacity), (1, -1), (2, a.nbr + 1), (3, a.nbc)):
        wrong = [t.clone() for t in tables]
        wrong[i][0] = bad  # a slot past the capacity, a block off the output
        with pytest.raises(IndexError):
            kb.bsr_bsr_matmul_dense(a, a, *wrong, mask)


@pytest.mark.parametrize("kind,key", [("bsr_x_dense", "bsr_matmul_dense"),
                                      ("bsr_x_bsr", "bsr_bsr_matmul_dense")])
@pytest.mark.parametrize("output_format", ["sparse", "dense"])
def test_bsr_route_on_the_card(cuda, kind, key, output_format):
    """A block-sparse A (4 of 16 blocks) takes route "bsr" through K5 (B
    uniform) or K6 (B = A), against scipy."""
    a = sp.block_diag([sp.random(128, 128, density=1.0, random_state=s) for s in range(4)],
                      format="csr")
    b = a if kind == "bsr_x_bsr" else sp.random(512, 512, density=0.3, format="csr",
                                                random_state=7)
    before = dict(LAUNCHES)
    got = tsmm.sparse_matrix_multiply(a, b, output_format, device="cuda")
    assert tsmm.get_last_route() == "bsr"
    assert LAUNCHES[key] > before[key]
    got = got.toarray() if output_format == "sparse" else got
    ref = (a @ b).toarray()
    assert np.all(np.abs(got - ref) <= 1e-5 * (abs(a) @ abs(b)).toarray())


# K7 and K8, the fused conversions: (rows, cols, density, lane), the cases of
# test_pallas_convert.py, then many flat-rows (a long look-back chain), tiles
# of 64 KB and 128 KB of shared memory, and flat-rows longer than the tile.
FUSED_CASES = [
    (16, 300, 0.2, 256), (37, 1000, 0.1, 512), (8, 128, 0.0, 128), (100, 513, 0.5, 256),
    (5, 64, 1.0, 128), (200, 200, 0.05, 256), (63, 190, 0.3, 128),
    (1000, 1000, 0.3, 32), (700, 900, 0.4, 16384), (300, 1000, 0.2, 1 << 16),
    (1, 1, 1.0, 8192),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n,d,lane", FUSED_CASES)
def test_dense_to_csr_fused_kernel(cuda, m, n, d, lane, dtype):
    """K7 against its plain version and K4, bit for bit: at a capacity with
    room to pad, at capacity < nnz and at capacity 0."""
    _, dense = _random(m, n, d, 11, dtype, cuda)
    dense[0, -1] = -0.0  # a negative zero is a zero
    nnz = int(torch.count_nonzero(dense))
    for cap in (tsmm.bucket_capacity(nnz), max(nnz // 2, 1), 0):
        before = LAUNCHES["dense_to_csr_fused"]
        got = ck.dense_to_csr_fused(dense, cap, lane=lane)
        torch.cuda.synchronize()
        assert LAUNCHES["dense_to_csr_fused"] == before + 1
        for g, p, k in zip(got, ck.dense_to_csr_fused_plain(dense, cap), ck.dense_to_csr(dense, cap)):
            assert torch.equal(g, p) and torch.equal(g, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n,d,lane", FUSED_CASES)
def test_csr_to_dense_fused_kernel(cuda, m, n, d, lane, dtype):
    """K8 against its plain version and K3, bit for bit; the padding past
    indptr[-1] holds garbage that must be ignored."""
    a = sp.random(m, n, density=d, format="csr", random_state=12)
    c = tsmm.from_scipy(a, dtype=dtype, device=cuda)
    values = c.values.clone()
    values[a.nnz:] = float("nan")
    before = LAUNCHES["csr_to_dense_fused"]
    got = ck.csr_to_dense_fused(c.indptr, c.indices, values, c.shape, lane=lane)
    torch.cuda.synchronize()
    assert LAUNCHES["csr_to_dense_fused"] == before + 1
    assert torch.equal(got, ck.csr_to_dense_fused_plain(c.indptr, c.indices, values, c.shape))
    assert torch.equal(got, ck.csr_to_dense(c.indptr, c.indices, c.values, c.shape))


def test_fused_kernels_do_not_depend_on_the_lane(cuda):
    _, dense = _random(1200, 1300, 0.3, 13, torch.float32, cuda)
    cap = tsmm.bucket_capacity(int(torch.count_nonzero(dense)))
    outs = [ck.dense_to_csr_fused(dense, cap, lane=lane) for lane in (32, 2048, 8192, 16384, 1 << 17)]
    for out in outs[1:]:
        for g, w in zip(out, outs[0]):
            assert torch.equal(g, w)
    for lane in (32, 8192, 1 << 17):
        assert torch.equal(ck.csr_to_dense_fused(*outs[0], dense.shape, lane=lane), dense)


def test_fused_kernels_reject_bad_inputs(cuda):
    dense = torch.ones((4, 4), device=cuda)
    with pytest.raises(ValueError):
        ck.dense_to_csr_fused(dense, 16, lane=48)
    with pytest.raises(ValueError):  # not contiguous
        ck.dense_to_csr_fused(dense.T[:, :3], 16)
    with pytest.raises(ValueError):  # one array on the CPU
        ck.csr_to_dense_fused(torch.zeros(5, dtype=torch.int32), torch.zeros(4, dtype=torch.int32,
                              device=cuda), torch.zeros(4, device=cuda), (4, 4))


def _bits(t):
    """The bit patterns of a float tensor: NaN compares equal to itself."""
    return t.view(torch.int32 if t.element_size() == 4 else torch.int64)


def _k7_against_plain_and_k4(dense, cap, lane=ck.LANE, plain=True):
    """K7 bit for bit against K4 and (unless the matrix is too large for it)
    its plain version, one launch counted."""
    before = LAUNCHES["dense_to_csr_fused"]
    got = ck.dense_to_csr_fused(dense, cap, lane=lane)
    torch.cuda.synchronize()
    assert LAUNCHES["dense_to_csr_fused"] == before + 1
    wants = [ck.dense_to_csr(dense, cap)] + ([ck.dense_to_csr_fused_plain(dense, cap)] if plain else [])
    for want in wants:
        for g, w, field in zip(got, want, ("indptr", "indices", "values")):
            assert torch.equal(_bits(g) if field == "values" else g,
                               _bits(w) if field == "values" else w), (field, cap, lane)
    return got


# Rows that straddle flat-rows and K7's tiles (n > lane, n no multiple of it),
# lane 32 and lane 2^17 (past any tile), many rows shorter than a vector.
K7_SHAPES = [(37, 5000, 2048), (300, 9999, 4096), (3, 70_001, 32), (5, 40_000, 1 << 17),
             (2000, 777, 1 << 17), (4097, 3, 32), (700, 900, 16384)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n,lane", K7_SHAPES)
def test_dense_to_csr_fused_kernel_rows_across_flat_rows(cuda, m, n, lane, dtype):
    """At a capacity with room to pad, one that ends among the entries, and 0."""
    _, dense = _random(m, n, 0.3, m + n, dtype, cuda)
    nnz = int(torch.count_nonzero(dense))
    for cap in (tsmm.bucket_capacity(nnz), nnz // 2 + 17, 0):
        _k7_against_plain_and_k4(dense, cap, lane)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_dense_to_csr_fused_kernel_off_a_16_byte_boundary(cuda, offset):
    """A matrix that starts `offset` f32 elements past a 16-byte boundary:
    the tiles are shifted, the elements before and after it are masked."""
    m, n = 1500, 2049
    _, dense = _random(m, n, 0.3, offset, torch.float32, cuda)
    moved = torch.full((m * n + offset + 3,), 7.0, device=cuda)[offset:offset + m * n].view(m, n)
    moved.copy_(dense)
    cap = tsmm.bucket_capacity(int(torch.count_nonzero(dense)))
    _k7_against_plain_and_k4(moved, cap)


@pytest.mark.parametrize("lane", [32, 8192])
def test_dense_to_csr_fused_kernel_capacity_inside_a_flat_row(cuda, lane):
    _, dense = _random(600, 1000, 0.2, 5, torch.float32, cuda)
    live = (dense.reshape(-1) != 0).long()
    per_row = live[: live.numel() // lane * lane].view(-1, lane).sum(1)
    r = per_row.numel() // 2
    r += int(torch.nonzero(per_row[r:] >= 2)[0])
    cap = int(per_row[:r].sum()) + int(per_row[r]) // 2  # strictly inside flat-row r
    got = _k7_against_plain_and_k4(dense, cap, lane)
    assert int(got[0][-1]) == cap


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dense_to_csr_fused_kernel_all_zero_and_one_last_element(cuda, dtype):
    dense = torch.zeros((1000, 1003), dtype=dtype, device=cuda)
    for cap in (0, 64):
        assert not _k7_against_plain_and_k4(dense, cap)[0].any()
    dense[-1, -1] = 2.5
    for cap in (0, 1, 64):
        indptr, indices, values = _k7_against_plain_and_k4(dense, cap)
    assert int(indptr[-1]) == 1 and int(indptr[-2]) == 0
    assert int(indices[0]) == 1002 and float(values[0]) == 2.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dense_to_csr_fused_kernel_keeps_nan_and_drops_negative_zero(cuda, dtype):
    _, dense = _random(500, 700, 0.1, 6, dtype, cuda)
    dense[::7, ::3] = -0.0
    dense[100] = -0.0
    dense[3, 5] = dense[-1, -1] = dense[0, 0] = float("nan")
    nnz = int(torch.count_nonzero(dense))
    indptr, indices, values = _k7_against_plain_and_k4(dense, tsmm.bucket_capacity(nnz))
    assert int(indptr[-1]) == nnz and int(indptr[101] - indptr[100]) == 0
    assert int(torch.isnan(values).sum()) == 3


def test_dense_to_csr_fused_kernel_back_to_back(cuda):
    """50 calls queued with no synchronize between them, the shapes taking
    turns so that a call has more tiles than the one before: each call's
    status words and ticket start from zero."""
    mats = [_random(m, n, 0.3, i, torch.float32, cuda)[1]
            for i, (m, n) in enumerate([(1000, 1000), (3000, 2000), (77, 5000)])]
    caps = [tsmm.bucket_capacity(int(torch.count_nonzero(x))) for x in mats]
    outs = [ck.dense_to_csr_fused(mats[i % 3], caps[i % 3]) for i in range(50)]
    torch.cuda.synchronize()
    wants = [ck.dense_to_csr(x, cap) for x, cap in zip(mats, caps)]
    for i, out in enumerate(outs):
        for g, w in zip(out, wants[i % 3]):
            assert torch.equal(g, w), i


def test_dense_to_csr_fused_kernel_past_2_to_the_31_elements(cuda):
    """(2, 2^30 + 64) f32, 8.6 GB: flat positions past 2^31 and 32-bit
    columns past 2^30, against the known entries and K4 (the plain version
    would take far more memory)."""
    m, n = 2, 2**30 + 64
    entries = [(0, 7, 1.5), (0, 2**30 + 60, -2.0), (1, 0, 3.0), (1, 2**30 - 3, 4.0),
               (1, 2**30 + 63, 5.0)]
    dense = torch.zeros((m, n), device=cuda)
    for r, c, v in entries:
        dense[r, c] = v
    for cap in (8, 4):
        indptr, indices, values = _k7_against_plain_and_k4(dense, cap, plain=False)
        kept = entries[:cap]
        assert indptr.tolist() == [0, min(2, cap), min(5, cap)]
        assert indices.tolist() == [c for _, c, _ in kept] + [0] * (cap - len(kept))
        assert values.tolist() == [v for _, _, v in kept] + [0.0] * (cap - len(kept))
    del dense


def _f64_triple(h, q, device):
    h64 = torch.from_numpy(h.toarray()).to(device)
    q64 = torch.from_numpy(q.toarray()).to(device)
    c = h64 @ q64 @ h64.T
    bound = 1e-5 * (h64.abs() @ q64.abs() @ h64.abs().T)
    return c, bound


@pytest.mark.parametrize("compute_full_matrix", [0, 1])
@pytest.mark.parametrize("precision", ["fast", "split", "strict"])
def test_triple_product_on_the_card(cuda, precision, compute_full_matrix):
    """FAST (K3 twice, H.Q, K1 transpose_b: m^2 > 2^20), SPLIT and STRICT
    against the f64 product on the card, within 1e-5 * (|H| |Q| |H|^T)."""
    h = sp.random(1100, 900, density=0.1, format="csr", random_state=14)
    q = sp.random(900, 900, density=0.1, format="csr", random_state=15)
    h.data = 2.0 * h.data - 1.0
    th, tq = tsmm.from_scipy(h, device=cuda), tsmm.from_scipy(q, device=cuda)
    before = dict(LAUNCHES)
    got = tsmm.triple_product(th, tq, compute_full_matrix, precision=precision)
    torch.cuda.synchronize()
    assert got.dtype == torch.float64 and got.shape == (1100, 1100)
    if precision == "fast":
        assert LAUNCHES["csr_to_dense"] == before["csr_to_dense"] + 2
        assert LAUNCHES["matmul_triu"] == before["matmul_triu"] + 1
    c, bound = _f64_triple(h, q, cuda)
    want = torch.triu(c)
    if compute_full_matrix:
        want = want + torch.triu(c, 1).T
        bound = torch.triu(bound) + torch.triu(bound, 1).T
        assert torch.equal(got, got.T)
    else:
        assert not torch.tril(got, -1).any()
    assert bool(((got - want).abs() <= bound).all())


def test_triple_route_on_the_card(cuda):
    """sparse_matrix_multiply(use_triple_product=True) takes route "triple"
    through K3 twice and K1, against scipy at the reference tolerance."""
    h = sp.random(1500, 1200, density=0.05, format="csr", random_state=16)
    q = sp.random(1200, 1200, density=0.05, format="csr", random_state=17)
    before = dict(LAUNCHES)
    got = tsmm.sparse_matrix_multiply(h, q, use_triple_product=True, compute_full_matrix=1,
                                      device="cuda")
    assert tsmm.get_last_route() == "triple"
    assert LAUNCHES["csr_to_dense"] == before["csr_to_dense"] + 2
    assert LAUNCHES["matmul_triu"] == before["matmul_triu"] + 1
    c = (h @ q @ h.T).toarray()
    np.testing.assert_allclose(got, np.triu(c) + np.triu(c, 1).T, rtol=1e-5, atol=1e-8)


def test_invert_on_the_card(cuda):
    """The inversion in float32 on the card (K1 with rectangular operands)
    against the f64 formulas, within 1e-3 of each result's largest entry."""
    from sparse_matrix_mult_tpu_torch.models.inversion import invert, posterior_covariance

    rng = np.random.default_rng(18)
    n_obs, n_state = 1100, 2000
    h = sp.random(n_obs, n_state, density=0.02, format="csr", random_state=19)
    a = sp.random(n_state, n_state, density=0.005, format="csr", random_state=20)
    q = (a + a.T) * 0.5
    q = (q + sp.diags(1.0 + np.asarray(abs(q).sum(axis=1)).ravel())).tocsr()
    y, x0, r = rng.standard_normal(n_obs), rng.standard_normal(n_state), 0.5 + rng.random(n_obs)
    th, tq = tsmm.from_scipy(h, device=cuda), tsmm.from_scipy(q, device=cuda)
    args = [torch.from_numpy(v).to(cuda) for v in (y, x0, r)]
    before = LAUNCHES["matmul_triu"]
    got = invert(th, tq, *args)
    assert LAUNCHES["matmul_triu"] == before + 1
    p_full = posterior_covariance(th, tq, args[2])
    h64 = torch.from_numpy(h.toarray()).to(cuda)
    q64 = torch.from_numpy(q.toarray()).to(cuda)
    y64, x064, r64 = (torch.from_numpy(v).to(cuda) for v in (y, x0, r))
    s = h64 @ q64 @ h64.T + torch.diag(r64)
    qht = q64 @ h64.T
    x_post = x064 + qht @ torch.linalg.solve(s, y64 - h64 @ x064)
    p = q64 - qht @ torch.linalg.solve(s, qht.T)
    for name, g, w in (("x_post", got.x_post, x_post), ("p_diag", got.p_diag, torch.diagonal(p)),
                       ("s", got.s, s), ("posterior_covariance", p_full, p)):
        assert g.dtype == torch.float32, name
        assert float((g.double() - w).abs().max()) <= 1e-3 * float(w.abs().max()), name


def test_cuda_tensors_never_reach_a_plain_version(cuda, monkeypatch):
    """With every plain version replaced by one that raises, the kernels'
    entry points and the triple product still run on CUDA tensors, and each
    launch is counted."""
    for module in (ck, tm, kb):
        for name in dir(module):
            if name.endswith("_plain"):
                monkeypatch.setattr(module, name, _raise_plain(name))
    _, dense = _random(300, 400, 0.3, 21, torch.float32, cuda)
    before = dict(LAUNCHES)
    csr = ck.dense_to_csr_fused(dense, 1 << 16)
    back = ck.csr_to_dense_fused(*csr, dense.shape)
    csr4 = ck.dense_to_csr(dense, 1 << 16)
    ck.csr_to_dense(*csr4, dense.shape)
    h = tsmm.from_scipy(sp.random(1100, 800, density=0.1, random_state=22), device=cuda)
    q = tsmm.from_scipy(sp.random(800, 800, density=0.1, random_state=23), device=cuda)
    tsmm.triple_product(h, q, 1, precision="fast")
    ad, bd = _k6_operands((3, 4, 3))
    plan = kb.bsr_pair_plan(sp.csr_matrix(ad), sp.csr_matrix(bd), 128)
    kb.bsr_bsr_matmul_dense(_bsr(ad, cuda), _bsr(bd, cuda),
                            *[torch.from_numpy(plan[k]).to(cuda) for k in ("pa", "pb", "ci", "cj",
                                                                            "first")],
                            torch.from_numpy(plan["mask"]).to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(back, dense)
    for key, n in (("dense_to_csr_fused", 1), ("csr_to_dense_fused", 1), ("dense_to_csr", 1),
                   ("csr_to_dense", 3), ("matmul_triu", 1), ("split_bf16", 4),
                   ("bsr_pair_runs", 1), ("bsr_bsr_matmul_dense", 1)):
        assert LAUNCHES[key] == before[key] + n, key


def _raise_plain(name):
    def plain(*args, **kwargs):
        raise AssertionError(f"{name} ran on a CUDA tensor")
    return plain


def _esc_operands(seed, m=700, k=500, n=600, da=0.01, db=0.02):
    a = sp.random(m, k, density=da, format="csr", random_state=seed)
    b = sp.random(k, n, density=db, format="csr", random_state=seed + 1)
    a.data = 2 * a.data - 1  # cancellations possible: structure is Gustavson's, not scipy's
    return a, b


def _esc_call(engine, a_sp, b_sp, device, symmetric):
    """One call of ``engine`` on containers of ``a_sp``, ``b_sp`` (f32) on ``device``."""
    from sparse_matrix_mult_tpu_torch.ops.spgemm_binned import binned_plan, spgemm_esc_binned
    from sparse_matrix_mult_tpu_torch.ops.spgemm_esc import (
        spgemm_esc, spgemm_esc_windowed, windowed_plan)

    a = tsmm.from_scipy(a_sp, dtype=torch.float32, device=device)
    b = tsmm.from_scipy(b_sp, dtype=torch.float32, device=device)
    expand = int(np.diff(b_sp.indptr)[a_sp.indices].sum())
    cap = tsmm.bucket_capacity(expand)
    kw = dict(out_capacity=cap, symmetric=symmetric, row_offset=11)
    if engine == "binned":
        plan = binned_plan(a_sp.indptr, a_sp.indices, b_sp.indptr, lane_width=1024)
        return lambda: spgemm_esc_binned(a, b, *plan.device_args(device), window=plan.window,
                                         **kw)
    if engine == "windowed":
        window, tail = windowed_plan(a_sp.nnz, np.diff(b_sp.indptr)[a_sp.indices], expand)
        return lambda: spgemm_esc_windowed(a, b, window=window, expand_capacity=cap,
                                           tail_capacity=tsmm.bucket_capacity(tail), **kw)
    return lambda: spgemm_esc(a, b, expand_capacity=cap, **kw)


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("engine", ["binned", "windowed", "classic"])
def test_esc_engines_on_the_card(cuda, engine, symmetric):
    """Each ESC engine on the card against the same function on the CPU:
    identical indptr and indices, f32 values within 1e-6 of (|A| |B|), and
    two calls on the card give the same bits."""
    a_sp, b_sp = _esc_operands(41)
    on_card = _esc_call(engine, a_sp, b_sp, cuda, symmetric)
    got, again = on_card(), on_card()
    want = _esc_call(engine, a_sp, b_sp, "cpu", symmetric)()
    nnz = int(want.nnz)
    assert nnz > 0 and torch.equal(got.indptr.cpu(), want.indptr)
    assert torch.equal(got.indices.cpu()[:nnz], want.indices[:nnz])
    for field in ("indptr", "indices", "values"):
        assert torch.equal(getattr(got, field), getattr(again, field)), field
    c = tsmm.to_scipy(want)
    abs_ab = np.asarray((abs(a_sp) @ abs(b_sp)).todense())
    rows = np.repeat(np.arange(c.shape[0]), np.diff(c.indptr))
    limit = 1e-6 * abs_ab[rows, c.indices]
    diff = np.abs(got.values.cpu().numpy()[:nnz].astype(np.float64) - want.values.numpy()[:nnz])
    assert np.all(diff <= limit)


@pytest.mark.parametrize("engine,syncs", [("binned", 0), ("windowed", 1), ("classic", 1)])
def test_esc_engines_host_syncs(cuda, engine, syncs):
    """The binned engine makes no host sync; the windowed and classic ones
    make one (the counts that size the expansion)."""
    a_sp, b_sp = _esc_operands(43)
    call = _esc_call(engine, a_sp, b_sp, cuda, False)
    call()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # The mode's own notice ("... a prototype feature ...") is not a sync.
    assert sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught) == syncs


@pytest.mark.parametrize("route,limits", [
    ("esc_binned", dict()),
    ("esc_windowed", dict(use_binned_esc=False)),
    ("esc", dict(use_binned_esc=False, dense_path_limit=1000)),
    ("esc_chunks", dict(dense_path_limit=1000, esc_expand_limit=4000, binned_expand_limit=4000)),
    ("dense_chunks", dict(dense_path_limit=150_000, esc_expand_limit=8, binned_expand_limit=8)),
])
def test_sparse_output_ladder_on_the_card(cuda, route, limits):
    """Each rung through sparse_matrix_multiply on the card: the route, and
    identical structure with values in the oracle against scipy (non-negative
    operands: no cancellation)."""
    a = sp.random(400, 300, density=0.01, format="csr", random_state=51)
    b = sp.random(300, 400, density=0.02 if route != "esc" else 0.4, format="csr",
                  random_state=52)
    saved = tsmm.get_config()
    tsmm.set_config(host_compute_limit=0, **limits)
    try:
        for symmetric in (False, True):
            got = tsmm.sparse_matrix_multiply(a, b, symmetric=symmetric, device="cuda")
            assert tsmm.get_last_route() == route
            ref = (a @ b).tocsr()
            ref = sp.triu(ref, format="csr") if symmetric else ref
            ref.sort_indices()
            assert np.array_equal(got.indptr, ref.indptr)
            assert np.array_equal(got.indices, ref.indices)
            assert np.allclose(got.data, ref.data, rtol=1e-5, atol=1e-8)
    finally:
        tsmm.set_config(saved)
