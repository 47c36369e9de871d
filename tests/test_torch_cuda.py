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
from sparse_matrix_mult_tpu_torch.ops.kernels import full_matmul as fm
from sparse_matrix_mult_tpu_torch.ops.kernels import triu_matmul as tm
from sparse_matrix_mult_tpu_torch.ops.matmul import full_fp32, policy_matmul
from sparse_matrix_mult_tpu_torch.ops.triple_product import triple_product_dense

pytestmark = pytest.mark.cuda

SHAPES = [(1, 1), (5, 64), (37, 1000), (129, 257), (300, 300), (1000, 33)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def on_device():
    """The cost model priced off, so sparse_matrix_multiply keeps the device
    routes these tests assert; the configuration restored afterwards."""
    saved = tsmm.get_config()
    tsmm.set_config(auto_calibrate_link=False, link_fixed_s=1e-9, link_up_bytes_per_s=1e15,
                    link_down_bytes_per_s=1e15, host_rate_base=1.0, host_partial_rate=1.0,
                    scipy_partial_rate=1.0)
    yield
    tsmm.set_config(saved)


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


# (m, k, n): one entry; off the tile and K-step edges; crossing both; a ring
# slot's panel; a larger product of many tiles.
FULL_SHAPES = [(1, 1, 1), (130, 200, 70), (257, 65, 129), (48, 25, 300), (700, 1000, 1100)]


def _launched(before: dict) -> dict:
    return {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}


@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("m,k,n", FULL_SHAPES)
def test_matmul_full_kernel(cuda, m, k, n, transpose_b):
    """The full GEMM against its plain version (the six passes of the same
    pieces) within 1e-6 of (|A| |B|) and against FP32 torch.matmul within
    1e-5; both forms give the same bits, its upper tiles are K1's; two
    splits and one GEMM launched."""
    rng = np.random.default_rng(m + 3 * k + 7 * n)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(cuda)
    bt = b.T.contiguous()
    before = dict(LAUNCHES)
    got = fm.matmul_full(a, bt if transpose_b else b, transpose_b=transpose_b)
    torch.cuda.synchronize()
    assert _launched(before) == {"matmul_full": 1, "split_bf16": 2}
    with full_fp32():
        unit = torch.matmul(a.abs(), b.abs())
        ref = torch.matmul(a, b)
    assert bool(((got - fm.matmul_full_plain(a, b)).abs() <= 1e-6 * unit).all())
    assert bool(((got - ref).abs() <= 1e-5 * unit).all())
    assert torch.equal(got, fm.matmul_full(a, b if transpose_b else bt, transpose_b=not transpose_b))
    tiles = torch.arange(m, device=cuda)[:, None] // 128 <= torch.arange(n, device=cuda) // 128
    assert torch.equal(got[tiles], tm.matmul_triu(a, b)[tiles])


def test_matmul_full_long_k_within_its_six_passes(cuda):
    """At K = 16,384 of positive terms (256 K-steps, where plain fp32 adds
    of each step into the accumulator drift to ~1e-6) the compensated
    kernel stays within 1e-6 of (|A| |B|) of the six passes of its pieces
    summed in f64, and K1 HIGHEST gives the same bits on its tiles."""
    rng = np.random.default_rng(16_384)
    a = torch.from_numpy(rng.random((256, 16_384), dtype=np.float32)).to(cuda)
    b = torch.from_numpy(rng.random((16_384, 256), dtype=np.float32)).to(cuda)
    ap, bp = tm.split_bf16(a, 3), tm.split_bf16(b, 3, transpose=True)
    got = fm.matmul_full_pieces(ap, bp, 256, 256)
    exact = torch.zeros((256, 256), dtype=torch.float64, device=cuda)
    for pa, pb in ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)):
        exact += ap[pa, :256].double() @ bp[pb, :256].double().T
    unit = a.double() @ b.double()
    assert float(((got.double() - exact).abs() / unit).max()) <= 1e-6
    tiles = torch.arange(256, device=cuda)[:, None] // 128 <= torch.arange(256, device=cuda) // 128
    assert torch.equal(got[tiles], tm.matmul_triu_pieces(ap, bp, 256, 256)[tiles])


def test_matmul_full_on_empty_operands(cuda):
    """m, n or K of 0: zeros, nothing launched."""
    for m, k, n in ((0, 5, 3), (4, 0, 3), (4, 5, 0)):
        before = dict(LAUNCHES)
        got = fm.matmul_full(torch.ones((m, k), device=cuda), torch.ones((k, n), device=cuda))
        assert _launched(before) == {}
        assert got.shape == (m, n) and not got.any()
    with pytest.raises(TypeError):
        fm.matmul_full(torch.ones((4, 5), device=cuda, dtype=torch.float64),
                       torch.ones((5, 3), device=cuda, dtype=torch.float64))


def test_policy_matmul_fast_is_one_full_gemm(cuda):
    """policy_matmul FAST on the card: two splits and one full GEMM, the
    bits of matmul_full; a transposed view of B takes the transpose_b form
    (the same bits, the same launches)."""
    rng = np.random.default_rng(41)
    a = torch.from_numpy(rng.standard_normal((300, 200)).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal((200, 257)).astype(np.float32)).to(cuda)
    want = fm.matmul_full(a, b)
    for given in (b, b.T.contiguous().T):
        before = dict(LAUNCHES)
        got = policy_matmul(a, given, "fast")
        torch.cuda.synchronize()
        assert _launched(before) == {"matmul_full": 1, "split_bf16": 2}
        assert torch.equal(got, want)


def test_highest_triple_shares_h_pieces(cuda):
    """The HIGHEST triple on the card: K3 twice, three splits (H once, Q,
    T), one full GEMM for H.Q and K1 for T.H^T; within 1e-5 of
    (|H| |Q| |H|^T) of the f64 product."""
    h_sp = sp.random(1100, 1000, density=0.1, format="csr", random_state=42)
    q_sp = sp.random(1000, 1000, density=0.1, format="csr", random_state=43)
    h_sp.data = 2.0 * h_sp.data - 1.0
    h = tsmm.from_scipy(h_sp, dtype=torch.float32, device=cuda)
    q = tsmm.from_scipy(q_sp, dtype=torch.float32, device=cuda)
    before = dict(LAUNCHES)
    got = triple_product_dense(h, q, 0)
    torch.cuda.synchronize()
    assert _launched(before) == {"csr_to_dense": 2, "split_bf16": 3, "matmul_full": 1,
                                 "matmul_triu": 1}
    want = np.triu((h_sp @ q_sp @ h_sp.T).toarray())
    bound = 1e-5 * np.triu((abs(h_sp) @ abs(q_sp) @ abs(h_sp).T).toarray())
    assert np.all(np.abs(got.cpu().numpy() - want) <= bound)


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


def test_symmetric_multiply_on_the_card(cuda, on_device):
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
    uniform) or K6 (B = A) once the cutoff admits it (the default, 0, sends
    it to the dense route), against scipy."""
    a = sp.block_diag([sp.random(128, 128, density=1.0, random_state=s) for s in range(4)],
                      format="csr")
    b = a if kind == "bsr_x_bsr" else sp.random(512, 512, density=0.3, format="csr",
                                                random_state=7)
    before = dict(LAUNCHES)
    saved = tsmm.get_config()
    tsmm.set_config(cuda_bsr_occupancy_cutoff=0.25)
    try:
        got = tsmm.sparse_matrix_multiply(a, b, output_format, device="cuda")
    finally:
        tsmm.set_config(saved)
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


def test_triple_route_on_the_card(cuda, on_device):
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
    for module in (ck, tm, kb, fm):
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
                   ("csr_to_dense", 3), ("matmul_triu", 1), ("matmul_full", 1),
                   ("split_bf16", 6),
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
    ("esc_binned", dict(binned_esc_on_cuda=True)),
    ("esc_windowed", dict()),
    ("esc", dict(use_binned_esc=False, dense_path_limit=1000)),
    ("esc_chunks", dict(dense_path_limit=1000, esc_expand_limit=4000, binned_expand_limit=4000)),
    ("dense_chunks", dict(dense_path_limit=150_000, esc_expand_limit=8, binned_expand_limit=8)),
])
def test_sparse_output_ladder_on_the_card(cuda, on_device, route, limits):
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


# ---------------------------------------------------------------------------
# The multi-device layer: a 4-slot mesh on one card against a 4-slot CPU
# mesh (f32 on the card, f64 on the CPU: held to the reference oracle).
# ---------------------------------------------------------------------------


def _slot_meshes(cuda):
    from sparse_matrix_mult_tpu_torch.parallel.mesh import row_mesh

    return row_mesh([cuda] * 4), row_mesh(["cpu"] * 4)


def _close_dense(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.allclose(got, want, rtol=1e-5, atol=1e-8)


def _close_csr(got, want):
    """Identical structure (non-negative operands: nothing cancels), values
    in the oracle."""
    got, want = got.to_scipy(), want.to_scipy()
    assert np.array_equal(got.indptr, want.indptr)
    assert np.array_equal(got.indices, want.indices)
    assert np.allclose(got.data, want.data, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("ring", ["dense", "dense_symmetric", "csr", "csr_symmetric_flops",
                                  "sparse", "sparse_symmetric", "triple", "triple_full",
                                  "triple_sparse", "triple_sparse_full", "ring_matmul"])
def test_rings_on_a_slot_mesh_of_one_card(cuda, ring):
    from sparse_matrix_mult_tpu_torch.parallel import distributed as td

    gpu, cpu = _slot_meshes(cuda)
    a = sp.random(300, 300, density=0.05, format="csr", random_state=61)
    b = sp.random(300, 300, density=0.05, format="csr", random_state=62)
    h = sp.random(90, 300, density=0.05, format="csr", random_state=63)
    runs = {
        "dense": lambda m: td.spgemm_dense_distributed(a, b, mesh=m),
        "dense_symmetric": lambda m: td.spgemm_dense_distributed(a, b, symmetric=True, mesh=m),
        "csr": lambda m: td.spgemm_csr_distributed(a, b, mesh=m),
        "csr_symmetric_flops": lambda m: td.spgemm_csr_distributed(a, b, symmetric=True, mesh=m,
                                                                    balance="flops"),
        "sparse": lambda m: td.spgemm_csr_distributed_sparse(a, b, mesh=m),
        "sparse_symmetric": lambda m: td.spgemm_csr_distributed_sparse(a, b, symmetric=True,
                                                                       mesh=m),
        "triple": lambda m: td.triple_product_distributed(h, b, 0, mesh=m),
        "triple_full": lambda m: td.triple_product_distributed(h, b, 1, mesh=m),
        "triple_sparse": lambda m: td.triple_product_distributed_sparse(h, b, 0, mesh=m),
        "triple_sparse_full": lambda m: td.triple_product_distributed_sparse(h, b, 1, mesh=m),
        "ring_matmul": lambda m: td.ring_matmul(torch.from_numpy(a.toarray()),
                                                torch.from_numpy(b.toarray()[:, :77]), m),
    }
    before = dict(LAUNCHES)
    got = runs[ring](gpu)
    torch.cuda.synchronize()
    launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    want = runs[ring](cpu)
    if isinstance(got, td.ShardedCSR):
        assert all(t.device.type == "cuda" for t in got.values)
        _close_csr(got, want)
    else:
        assert all(p.device.type == "cuda" for p in got.panels)
        _close_dense(got, want)
    densifies = ring in ("dense", "dense_symmetric", "csr", "csr_symmetric_flops", "triple",
                         "triple_full")
    assert launched["csr_to_dense"] == (8 if densifies else 0)  # A's panel, B's block per slot
    assert launched["dense_to_csr"] == (4 if ring.startswith("csr") else 0)
    if ring == "triple_sparse":  # deterministic: the same bits twice
        again = runs[ring](gpu)
        assert all(torch.equal(p, again.panels[s]) for s, p in got.local_shards().items())


def test_k3_k4_at_slot_shapes(cuda):
    """K3 on every slot's A panel and B block, K4 on its C panel, bit for
    bit against their plain versions."""
    from sparse_matrix_mult_tpu_torch.parallel import distributed as td

    gpu, _ = _slot_meshes(cuda)
    a = sp.random(1000, 700, density=0.05, format="csr", random_state=64)
    b = sp.random(700, 900, density=0.05, format="csr", random_state=65)
    sa, sb = td.shard_csr(a, gpu), td.shard_csr(b, gpu)
    for s in range(4):
        for x, rows, cols in ((sa, sa.rows_pad, 700), (sb, sb.rows_pad, 900)):
            csr = (x.indptrs[s], x.indices[s], x.values[s], (rows, cols))
            assert torch.equal(ck.csr_to_dense(*csr), ck.csr_to_dense_plain(*csr))
    panels = td._dense_panels(gpu, sa, sb)
    for panel in panels:
        got = ck.dense_to_csr(panel, sa.rows_pad * 900)
        for g, w in zip(got, ck.dense_to_csr_plain(panel, sa.rows_pad * 900)):
            assert torch.equal(g, w)


def test_row_mesh_takes_every_card(cuda):
    from sparse_matrix_mult_tpu_torch.parallel.mesh import row_mesh

    mesh = row_mesh()
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


def test_kernels_on_a_card_that_is_not_current(cuda):
    """Every wrapper makes its tensors' card current for the launch: K3, K8,
    K4, K2, K7, K1 and matmul_full on cuda:1 while cuda:0 is current, against their
    plain versions (the runtime launches on the current card; before the
    wrappers set it, a 4-card mesh read another card's memory)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    torch.cuda.set_device(0)
    card = torch.device("cuda", 1)
    a = tsmm.from_scipy(sp.random(300, 257, density=0.1, format="csr", random_state=71),
                        dtype=torch.float32, device=card)
    csr = (a.indptr, a.indices, a.values, a.shape)
    dense = ck.csr_to_dense(*csr)
    assert torch.equal(dense, ck.csr_to_dense_plain(*csr))
    assert torch.equal(ck.csr_to_dense_fused(*csr), dense)
    want = ck.dense_to_csr_plain(dense, 8192)
    for got in (ck.dense_to_csr(dense, 8192), ck.dense_to_csr_fused(dense, 8192)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    sq = dense[:257]
    assert all(torch.equal(g, w) for g, w in zip(ck.dense_to_csr(sq, 8192, triu=True),
                                                 ck.dense_to_csr_plain(sq, 8192, triu=True)))
    got = torch.triu(tm.matmul_triu(sq, sq))
    with full_fp32():
        unit = torch.triu(torch.matmul(sq.abs(), sq.abs()))
    assert bool(((got - torch.triu(tm.matmul_triu_plain(sq, sq))).abs() <= 1e-5 * unit).all())
    full = fm.matmul_full(dense, dense, transpose_b=True)
    with full_fp32():
        unit = torch.matmul(dense.abs(), dense.abs().T)
    assert bool(((full - fm.matmul_full_plain(dense, dense, transpose_b=True)).abs()
                 <= 1e-6 * unit).all())
    torch.cuda.synchronize(card)
    assert torch.cuda.current_device() == 0


# fetch_np's download: 200 MB, just past a chunk edge, and small (pageable
# below STAGE_MIN_BYTES; the last case staged only when cast), in each dtype
# the routes download, with and without the f64 cast.
STAGED_CASES = [(torch.float32, 50_000_000), (torch.float64, 25_000_000),
                (torch.int32, 50_000_000), (torch.float32, 3 * (32 << 20) // 4 + 5),
                (torch.int32, 9 * (32 << 20) // 4 + 1), (torch.float32, 0),
                (torch.float64, 1), (torch.int32, 1000), (torch.float32, (2 << 20) // 8)]


@pytest.mark.parametrize("dtype,n", STAGED_CASES,
                         ids=[f"{str(d)[6:]}_{n}" for d, n in STAGED_CASES])
def test_staged_fetch_is_the_pageable_download_bit_for_bit(cuda, dtype, n):
    from sparse_matrix_mult_tpu_torch.utils.transfer import fetch_np

    gen = torch.Generator(device=cuda).manual_seed(n)
    if dtype == torch.int32:
        x = torch.randint(-2**31, 2**31 - 1, (n,), dtype=dtype, device=cuda, generator=gen)
    else:
        x = torch.randn(n, dtype=dtype, device=cuda, generator=gen)
    x = x * 3  # queued on the current stream just before the download
    want = x.cpu().numpy()
    got = fetch_np(x)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if dtype != torch.int32:
        cast = fetch_np(x, np.float64)
        assert cast.dtype == np.float64 and np.array_equal(cast, want.astype(np.float64))
    x.neg_()
    again = fetch_np(x)
    assert np.array_equal(got, want) and np.array_equal(again, -want)


def test_staged_fetch_on_a_card_that_is_not_current(cuda):
    """The staged copies run on the tensor's own card, after its queued work."""
    from sparse_matrix_mult_tpu_torch.utils.transfer import fetch_np

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    torch.cuda.set_device(0)
    card = torch.device("cuda", 1)
    x = torch.arange(20_000_000, dtype=torch.float32, device=card) * 0.5
    got = fetch_np(x, np.float64)
    assert np.array_equal(got, x.cpu().numpy().astype(np.float64))
    assert torch.cuda.current_device() == 0
