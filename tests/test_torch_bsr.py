"""The port's BSR route against the JAX package's, on the CPU.

The BSR containers, the pair planner, K5's and K6's plain versions (against
the Pallas kernels run in interpret mode, on the identical padded arrays
carried across with ``BSRMatrix.from_numpy``) and ``sparse_matrix_multiply``
on route ``"bsr"`` (``force_bsr`` / ``force_pallas_bsr``).  Both packages
compute the route in float32, so values are held to 1e-5 * (|A| @ |B|)
elementwise, against each other and against a numpy f64 product.  The CUDA
kernels are held to the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import sparse_matrix_mult_tpu as jsmm
import sparse_matrix_mult_tpu.api as jax_api
import sparse_matrix_mult_tpu_torch as tsmm
from sparse_matrix_mult_tpu.ops.pallas.bsr_spgemm import bsr_bsr_matmul_dense as jax_k6
from sparse_matrix_mult_tpu.ops.pallas.bsr_spgemm import bsr_matmul_dense as jax_k5
from sparse_matrix_mult_tpu.ops.pallas.bsr_spgemm import bsr_pair_plan as jax_pair_plan
from sparse_matrix_mult_tpu_torch import api
from sparse_matrix_mult_tpu_torch.ops.kernels import bsr_spgemm as kb
from sparse_matrix_mult_tpu_torch.ops.kernels import triu_matmul as tm

RTOL = 1e-5  # of |A| @ |B|, elementwise: f32 products summed in another order
PLAN_KEYS = ("pa", "pb", "ci", "cj", "first")


def block_sparse(nbr, nbc, occ, b=128, seed=0, inner_density=0.3):
    """Dense (nbr*b, nbc*b) f32 matrix whose occupied blocks (a fraction
    ``occ``) hold standard-normal values at ``inner_density``."""
    r = np.random.default_rng(seed)
    mask = r.random((nbr, nbc)) < occ
    dense = np.zeros((nbr * b, nbc * b), np.float32)
    for i, j in zip(*np.nonzero(mask)):
        blk = r.standard_normal((b, b)).astype(np.float32)
        blk *= r.random((b, b)) < inner_density
        dense[i * b:(i + 1) * b, j * b:(j + 1) * b] = blk
    return dense


# tests/test_bsr.py's CASES: (block-rows, block-columns, block occupancy).
CASES = [
    (3, 4, 0.5),
    (4, 4, 0.25),
    (2, 2, 0.0),  # empty matrix
    (5, 3, 1.0),  # fully dense blocks
]


def _port(jc):
    return tsmm.BSRMatrix.from_numpy(np.asarray(jc.indptr), np.asarray(jc.indices),
                                     np.asarray(jc.blocks), jc.shape, device="cpu")


def _assert_same_bsr(pc, jc):
    assert pc.shape == tuple(jc.shape)
    for field in ("indptr", "indices", "blocks"):
        np.testing.assert_array_equal(getattr(pc, field).numpy(), np.asarray(getattr(jc, field)),
                                      err_msg=field)


def _within(got, want, bound, what):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= bound), f"{what}: max excess {float(np.max(err - bound))}"


def _bound(ad, bd):
    return RTOL * (np.abs(ad.astype(np.float64)) @ np.abs(bd.astype(np.float64)))


# ---------------------------------------------------------------------------
# Containers and the pair plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nbr,nbc,occ", CASES)
def test_bsr_from_scipy_equals_jax(nbr, nbc, occ, dtype):
    ad = block_sparse(nbr, nbc, occ, seed=nbr * 10 + nbc).astype(dtype)
    a = sp.csr_matrix(ad)
    jc = jsmm.bsr_from_scipy(a, 128, dtype=jnp.dtype(dtype))
    pc = tsmm.bsr_from_scipy(a, 128, dtype=torch.from_numpy(ad).dtype, device="cpu")
    _assert_same_bsr(pc, jc)
    _assert_same_bsr(_port(jc), jc)
    assert pc.nbr == jc.nbr and pc.nbc == jc.nbc and pc.block_capacity == jc.block_capacity
    assert int(pc.nblocks) == int(jc.nblocks) and pc.block_size == 128
    np.testing.assert_array_equal(pc.block_rows().numpy(), np.asarray(jc.block_rows()))
    np.testing.assert_array_equal(tsmm.bsr_to_dense(pc).numpy(), ad)


@pytest.mark.parametrize("shape,block_size,capacity", [
    ((200, 300), 128, None),  # neither dimension a multiple of the block
    ((200, 300), 64, None),
    ((130, 129), 128, 16),  # capacity given, larger than needed
    ((256, 384), 128, None),  # empty matrix
])
def test_bsr_from_scipy_ragged_shapes_equal_jax(shape, block_size, capacity):
    rng = np.random.default_rng(2)
    ad = np.zeros(shape, np.float32)
    if shape != (256, 384):
        ad[:100, :120] = rng.standard_normal((100, 120))
        ad[shape[0] - 1, shape[1] - 1] = 3.0
    a = sp.csr_matrix(ad)
    jc = jsmm.bsr_from_scipy(a, block_size, dtype=jnp.float32, block_capacity=capacity)
    pc = tsmm.bsr_from_scipy(a, block_size, dtype=torch.float32, block_capacity=capacity,
                             device="cpu")
    _assert_same_bsr(pc, jc)
    np.testing.assert_array_equal(pc.block_rows().numpy(), np.asarray(jc.block_rows()))
    np.testing.assert_array_equal(tsmm.bsr_to_dense(pc).numpy(), ad)
    with pytest.raises(ValueError):
        tsmm.bsr_from_scipy(sp.csr_matrix(np.ones((256, 256))), 128, block_capacity=2,
                            device="cpu")


@pytest.mark.parametrize("truncate", [False, True])
@pytest.mark.parametrize("nbr,nbc,occ", CASES)
def test_bsr_from_dense_and_to_dense_equal_jax(nbr, nbc, occ, truncate):
    ad = block_sparse(nbr, nbc, occ, seed=nbr + nbc)
    occupied = int(np.count_nonzero(np.abs(ad).reshape(nbr, 128, nbc, 128).sum(axis=(1, 3))))
    cap = max(1, occupied // 2) if truncate else nbr * nbc
    jc = jsmm.bsr_from_dense(jnp.asarray(ad), cap)
    pc = tsmm.bsr_from_dense(torch.from_numpy(ad), cap)
    _assert_same_bsr(pc, jc)
    back = tsmm.bsr_to_dense(pc).numpy()
    np.testing.assert_array_equal(back, np.asarray(jsmm.bsr_to_dense(jc)))
    if not truncate:
        np.testing.assert_array_equal(back, ad)


def test_bsr_from_dense_ragged_shape_equals_jax():
    rng = np.random.default_rng(3)
    ad = np.zeros((200, 300), np.float32)
    ad[150:, 250:] = rng.standard_normal((50, 50))
    jc = jsmm.bsr_from_dense(jnp.asarray(ad), 6)
    pc = tsmm.bsr_from_dense(torch.from_numpy(ad), 6)
    _assert_same_bsr(pc, jc)
    np.testing.assert_array_equal(tsmm.bsr_to_dense(pc).numpy(), ad)


def _ragged_pair():
    rng = np.random.default_rng(5)
    ad = np.zeros((200, 300), np.float32)
    ad[:100, :130] = rng.standard_normal((100, 130))
    bd = np.zeros((300, 250), np.float32)
    bd[:130, 128:] = rng.standard_normal((130, 122))
    return ad, bd


# (block-rows, contraction blocks, block-columns, occupancy of A, of B)
PAIR_CASES = [
    (3, 4, 3, 0.5, 0.4),
    (4, 3, 5, 0.25, 0.25),
    (2, 2, 2, 1.0, 1.0),
    (3, 3, 3, 0.0, 0.5),  # empty A: no plan
    (3, 3, 2, 0.5, 0.0),  # empty B: no plan
]


def _pair_operands(case):
    if case == "ragged":
        return _ragged_pair()
    if case == "empty_block_rows":  # A's block-rows 0 and 3 empty
        ad = block_sparse(4, 3, 0.5, seed=4)
        ad[:128] = 0
        ad[3 * 128:] = 0
        ad[128:256, :128] = 1.0
        return ad, block_sparse(3, 4, 0.5, seed=5)
    if case == "single_pair":  # A block (0, 1) meets B block (1, 2) only
        ad = np.zeros((3 * 128, 3 * 128), np.float32)
        bd = np.zeros((3 * 128, 3 * 128), np.float32)
        ad[:128, 128:256] = 1.0
        bd[128:256, 256:] = 2.0
        return ad, bd
    if case == "long_run":  # every output block a run of 5 pairs
        return block_sparse(2, 5, 1.0, seed=8), block_sparse(5, 2, 1.0, seed=9)
    nbr, nbk, nbc, occ_a, occ_b = case
    return (block_sparse(nbr, nbk, occ_a, seed=7 * nbr + nbk),
            block_sparse(nbk, nbc, occ_b, seed=11 * nbk + nbc))


@pytest.mark.parametrize("case", PAIR_CASES + ["ragged"])
def test_pair_plan_equals_jax(case):
    ad, bd = _pair_operands(case)
    a, b = sp.csr_matrix(ad), sp.csr_matrix(bd)
    want = jax_pair_plan(a, b, 128)
    got = kb.bsr_pair_plan(a, b, 128)
    if want is None:
        assert got is None
        return
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
    # The shared-conversion form gives the same plan.
    shared = kb.bsr_pair_plan(a, b, 128, bs_a=tsmm.types_bsr._tobsr_padded(a, 128),
                              bs_b=tsmm.types_bsr._tobsr_padded(b, 128))
    for key in want:
        np.testing.assert_array_equal(np.asarray(shared[key]), np.asarray(want[key]), err_msg=key)


# ---------------------------------------------------------------------------
# K5 and K6 plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _k5_operands(case):
    rng = np.random.default_rng(1)
    if case == "ragged":
        ad = np.zeros((200, 300), np.float32)
        ad[:128, :128] = rng.standard_normal((128, 128))
        ad[150, 250] = 3.0
        return ad, rng.standard_normal((300, 190)).astype(np.float32)
    if case == "empty_block_rows":
        ad = np.zeros((4 * 128, 2 * 128), np.float32)
        ad[2 * 128:3 * 128, :128] = rng.standard_normal((128, 128))  # block-row 2 only
        return ad, rng.standard_normal((2 * 128, 128)).astype(np.float32)
    nbr, nbc, occ = case
    ad = block_sparse(nbr, nbc, occ, seed=nbr * 10 + nbc)
    return ad, rng.standard_normal((nbc * 128, 300)).astype(np.float32)


@pytest.mark.parametrize("case", CASES + ["ragged", "empty_block_rows"])
def test_bsr_matmul_dense_plain_matches_pallas(case):
    ad, bd = _k5_operands(case)
    jc = jsmm.bsr_from_scipy(sp.csr_matrix(ad), 128, dtype=jnp.float32)
    want = np.asarray(jax_k5(jc, jnp.asarray(bd)))
    got = kb.bsr_matmul_dense(_port(jc), torch.from_numpy(bd))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (ad.shape[0], bd.shape[1])
    bound = _bound(ad, bd)
    _within(got.numpy(), want, bound, "K5 plain vs Pallas")
    _within(got.numpy(), ad.astype(np.float64) @ bd.astype(np.float64), bound, "K5 plain vs f64")
    empty_rows = np.repeat(np.diff(np.asarray(jc.indptr)) == 0, 128)[: ad.shape[0]]
    assert np.all(got.numpy()[empty_rows] == 0)
    assert torch.equal(tsmm.bsr_multiply_dense(_port(jc), torch.from_numpy(bd)), got)


def test_bsr_matmul_dense_reads_only_the_rows_it_needs():
    """B with more rows than A has columns: the extra rows are not used."""
    ad, bd = _k5_operands("ragged")
    extra = np.vstack([bd, np.full((50, bd.shape[1]), np.nan, np.float32)])
    pc = tsmm.bsr_from_scipy(sp.csr_matrix(ad), 128, dtype=torch.float32, device="cpu")
    got = kb.bsr_matmul_dense(pc, torch.from_numpy(extra))
    assert torch.equal(got, kb.bsr_matmul_dense(pc, torch.from_numpy(bd)))
    with pytest.raises(ValueError):
        kb.bsr_matmul_dense(pc, torch.from_numpy(bd[:299]))


def test_bsr_matmul_dense_plain_on_a_truncated_container_matches_pallas():
    """``bsr_from_dense`` with fewer slots than nonzero blocks: ``indptr``
    counts every block, and both packages multiply only the stored ones.
    A block-row whose blocks all lie past the capacity is zero in the port;
    the Pallas kernel never writes it (NaN in interpret mode), so the two
    are compared on the block-rows that keep a block."""
    ad = block_sparse(3, 4, 1.0, seed=34)
    bd = np.random.default_rng(8).standard_normal((4 * 128, 200)).astype(np.float32)
    jc = jsmm.bsr_from_dense(jnp.asarray(ad), 5)  # block-row 0 whole, one block of row 1
    assert int(jc.nblocks) == 12 and jc.block_capacity == 5
    want = np.asarray(jax_k5(jc, jnp.asarray(bd)))
    pc = _port(jc)
    got = kb.bsr_matmul_dense(pc, torch.from_numpy(bd)).numpy()
    stored = tsmm.bsr_to_dense(pc).numpy()
    assert not np.array_equal(stored, ad)  # blocks were dropped
    bound = _bound(stored, bd)
    kept = 2 * 128  # block-rows 0 and 1
    _within(got[:kept], want[:kept], bound[:kept], "K5 plain vs Pallas, truncated")
    _within(got, stored.astype(np.float64) @ bd.astype(np.float64), bound, "K5 plain vs f64")
    assert np.all(got[kept:] == 0)


def _k5_containers(case):
    """(JAX container, port container, A as stored, B) of a K5 case; the
    truncated case keeps 5 of 12 blocks (block-rows 0 and 1 only)."""
    if case == "truncated":
        ad = block_sparse(3, 4, 1.0, seed=34)
        bd = np.random.default_rng(8).standard_normal((4 * 128, 200)).astype(np.float32)
        jc = jsmm.bsr_from_dense(jnp.asarray(ad), 5)
    else:
        ad, bd = _k5_operands(case)
        jc = jsmm.bsr_from_scipy(sp.csr_matrix(ad), 128, dtype=jnp.float32)
    pc = _port(jc)
    return jc, pc, tsmm.bsr_to_dense(pc).numpy(), bd


@pytest.mark.parametrize("case", CASES + ["ragged", "empty_block_rows", "truncated"])
def test_bsr_matmul_dense_pieces_plain_matches_pallas(case):
    """K5's GEMM alone (its plain version: the six passes of the bf16
    pieces over A's stored blocks) on bsr_split's pieces, against the
    Pallas K5 (HIGHEST) and the f64 product.  The Pallas kernel leaves the
    block-rows past a truncated capacity unwritten, so there the port must
    give zeros instead."""
    jc, pc, stored, bd = _k5_containers(case)
    want = np.asarray(jax_k5(jc, jnp.asarray(bd)))
    ap, bp = kb.bsr_split(pc, torch.from_numpy(bd))
    got = kb.bsr_matmul_dense_pieces(ap, bp, pc, bd.shape[1])
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    got = got.numpy()
    bound = _bound(stored, bd)
    kept = 2 * 128 if case == "truncated" else got.shape[0]
    _within(got[:kept], want[:kept], bound[:kept], "K5 pieces vs Pallas")
    _within(got, stored.astype(np.float64) @ bd.astype(np.float64), bound, "K5 pieces vs f64")
    assert np.all(got[kept:] == 0)
    empty_rows = np.repeat(np.diff(np.asarray(jc.indptr)) == 0, 128)[: got.shape[0]]
    assert np.all(got[empty_rows] == 0)


def test_bsr_split_reads_only_the_rows_it_needs():
    """B with NaN rows from A's column count on: B's pieces are zero there
    (K = 300 of A's 384 padded columns), and A's pieces hold its blocks
    exactly."""
    ad, bd = _k5_operands("ragged")  # A is 200 x 300
    pc = tsmm.bsr_from_scipy(sp.csr_matrix(ad), 128, dtype=torch.float32, device="cpu")
    extra = np.vstack([bd, np.full((60, bd.shape[1]), np.nan, np.float32)])
    ap, bp = kb.bsr_split(pc, torch.from_numpy(extra))
    assert tuple(ap.shape) == (3, pc.block_capacity * 128, 128)
    assert tuple(bp.shape) == (3, 256, 3 * 128)
    assert not torch.isnan(bp.float()).any()
    assert bool((bp[:, :, 300:] == 0).all()) and bool((bp[:, 190:] == 0).all())
    assert torch.equal(bp, tm.split_bf16(torch.from_numpy(bd), 3, transpose=True, k_pad=384))
    whole = ap.float().sum(dim=0).reshape(pc.blocks.shape)
    assert torch.equal(whole, pc.blocks)  # three pieces hold an f32 exactly


def test_bsr_matmul_dense_pieces_rejects_mismatched_pieces():
    ad, bd = _k5_operands("ragged")
    pc = tsmm.bsr_from_scipy(sp.csr_matrix(ad), 128, dtype=torch.float32, device="cpu")
    ap, bp = kb.bsr_split(pc, torch.from_numpy(bd))
    with pytest.raises(ValueError):  # K padded to 320, not to A's 384 columns
        kb.bsr_matmul_dense_pieces(ap, tm.split_bf16(torch.from_numpy(bd), 3, transpose=True),
                                   pc, bd.shape[1])
    with pytest.raises(ValueError):  # more columns than the pieces hold
        kb.bsr_matmul_dense_pieces(ap, bp, pc, 257)
    with pytest.raises(ValueError):  # two pieces
        kb.bsr_matmul_dense_pieces(ap[:2], bp[:2], pc, bd.shape[1])


def _jax_k6(jca, jcb, plan):
    return np.asarray(jax_k6(jca, jcb, *(jnp.asarray(plan[k]) for k in PLAN_KEYS),
                             jnp.asarray(plan["mask"])))


def _port_tables(plan, n=None):
    return [torch.from_numpy(plan[k][:n]) for k in PLAN_KEYS] + [torch.from_numpy(plan["mask"])]


@pytest.mark.parametrize("case", PAIR_CASES[:3] + ["ragged"])
def test_bsr_bsr_matmul_dense_plain_matches_pallas(case):
    ad, bd = _pair_operands(case)
    a, b = sp.csr_matrix(ad), sp.csr_matrix(bd)
    plan = kb.bsr_pair_plan(a, b, 128)
    jca = jsmm.bsr_from_scipy(a, 128, dtype=jnp.float32)
    jcb = jsmm.bsr_from_scipy(b, 128, dtype=jnp.float32)
    want = _jax_k6(jca, jcb, plan)
    got = kb.bsr_bsr_matmul_dense(_port(jca), _port(jcb), *_port_tables(plan, plan["n_pairs"]))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (ad.shape[0], bd.shape[1])
    bound = _bound(ad, bd)
    _within(got.numpy(), want, bound, "K6 plain vs Pallas")
    _within(got.numpy(), ad.astype(np.float64) @ bd.astype(np.float64), bound, "K6 plain vs f64")
    # The JAX planner's padded tables (padding pairs in the dummy block-row)
    # give the same result as the real pairs alone.
    assert torch.equal(kb.bsr_bsr_matmul_dense(_port(jca), _port(jcb), *_port_tables(plan)), got)


# K6's cases: real or padded tables, ragged shapes, empty block-rows, a single
# pair, runs of 5 pairs.
K6_CASES = PAIR_CASES[:3] + ["ragged", "empty_block_rows", "single_pair", "long_run"]


def _k6_setup(case, padded):
    """(A, B, the port's containers of both, the plan, its tables)."""
    ad, bd = _pair_operands(case)
    a, b = sp.csr_matrix(ad), sp.csr_matrix(bd)
    plan = kb.bsr_pair_plan(a, b, 128)
    jca = jsmm.bsr_from_scipy(a, 128, dtype=jnp.float32)
    jcb = jsmm.bsr_from_scipy(b, 128, dtype=jnp.float32)
    tables = _port_tables(plan, None if padded else plan["n_pairs"])
    return ad, bd, jca, jcb, plan, tables


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("case", K6_CASES)
def test_bsr_bsr_matmul_dense_pieces_plain_matches_pallas(case, padded):
    """K6's GEMM alone (its plain version: the six passes of the bf16 pieces
    of both operands' stored blocks) on bsr_bsr_split's pieces, against the
    Pallas K6 (HIGHEST, interpret mode) and the f64 product, within 1e-5 of
    (|A| |B|); unvisited blocks exactly zero."""
    ad, bd, jca, jcb, plan, tables = _k6_setup(case, padded)
    if case == "long_run":
        assert np.diff(np.flatnonzero(np.r_[plan["first"][: plan["n_pairs"]], 1])).min() >= 4
    want = _jax_k6(jca, jcb, plan)
    pa, pb = _port(jca), _port(jcb)
    ap, bp = kb.bsr_bsr_split(pa, pb)
    got = kb.bsr_bsr_matmul_dense_pieces(ap, bp, pa, pb, *tables)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (ad.shape[0],
                                                                               bd.shape[1])
    bound = _bound(ad, bd)
    _within(got.numpy(), want, bound, "K6 pieces vs Pallas")
    _within(got.numpy(), ad.astype(np.float64) @ bd.astype(np.float64), bound, "K6 pieces vs f64")
    _within(got.numpy(), kb.bsr_bsr_matmul_dense(pa, pb, *tables).numpy(), bound,
            "K6 pieces vs K6 plain")
    visited = np.repeat(np.repeat(plan["mask"], 128, axis=0), 128, axis=1)
    assert np.all(got.numpy()[~visited[: ad.shape[0], : bd.shape[1]]] == 0)


@pytest.mark.parametrize("case", ["ragged", (3, 4, 3, 0.5, 0.4), "long_run"])
def test_bsr_bsr_split_matches_split_bf16_plain(case):
    """A's pieces are split_bf16_plain of its stored blocks in rows form; B's
    of its stored blocks transposed as one matrix, whose columns [128 s, 128 s
    + 128) hold block s transposed (three pieces hold an f32 exactly)."""
    ad, bd = _pair_operands(case)
    pa = tsmm.bsr_from_scipy(sp.csr_matrix(ad), 128, dtype=torch.float32, device="cpu")
    pb = tsmm.bsr_from_scipy(sp.csr_matrix(bd), 128, dtype=torch.float32, device="cpu")
    ap, bp = kb.bsr_bsr_split(pa, pb)
    assert torch.equal(ap, tm.split_bf16_plain(pa.blocks.reshape(-1, 128), 3))
    assert torch.equal(bp, tm.split_bf16_plain(pb.blocks.reshape(-1, 128), 3, transpose=True))
    assert tuple(ap.shape) == (3, pa.block_capacity * 128, 128)
    assert tuple(bp.shape) == (3, 128, pb.block_capacity * 128)
    assert torch.equal(ap.float().sum(dim=0).reshape(pa.blocks.shape), pa.blocks)
    whole = bp.float().sum(dim=0)
    for slot in range(pb.block_capacity):
        assert torch.equal(whole[:, slot * 128:(slot + 1) * 128].T, pb.blocks[slot])


def _runs_by_walking_first(plan):
    """Each output block's [start, end) in the real pairs, from a walk of the
    run-start flags: a block with no run starts where the next run does."""
    n = plan["n_pairs"]
    nbr, nbc = plan["mask"].shape
    heads = np.flatnonzero(plan["first"][:n])
    ends = np.r_[heads[1:], n]
    runs = {int(plan["ci"][h]) * nbc + int(plan["cj"][h]): (int(h), int(e))
            for h, e in zip(heads, ends)}
    bounds = np.zeros(nbr * nbc + 1, np.int32)
    nxt = n
    for block in range(nbr * nbc, -1, -1):
        if block in runs:
            nxt = runs[block][0]
            assert runs[block][1] == bounds[block + 1]  # the run ends where the next block starts
        bounds[block] = nxt
    return bounds


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("case", K6_CASES)
def test_bsr_pair_runs_plain_matches_a_walk_of_first(case, padded):
    """K6's run bounds (plain version) against a numpy walk of ``first``, on
    the real pairs and on the planner's padded tables (whose padding lies
    past the last block's run); good tables raise no flag."""
    _, _, jca, jcb, plan, tables = _k6_setup(case, padded)
    bounds, flag = kb.bsr_pair_runs(_port(jca), _port(jcb), *tables[:4])
    assert bounds.dtype == torch.int32 and flag.dtype == torch.int32
    np.testing.assert_array_equal(bounds.numpy(), _runs_by_walking_first(plan))
    assert int(flag) == 0


def test_bsr_pair_runs_flags_bad_tables():
    """Bit 1: a slot past either capacity or a block off the output (the
    padding's block-row nbr is allowed); bit 2: keys out of order."""
    _, _, jca, jcb, plan, tables = _k6_setup((3, 4, 3, 0.5, 0.4), False)
    a, b = _port(jca), _port(jcb)
    for i, bad in ((0, a.block_capacity), (0, -1), (1, b.block_capacity), (1, -1),
                   (2, a.nbr + 1), (2, -1), (3, b.nbc), (3, -1)):
        wrong = [t.clone() for t in tables[:4]]
        wrong[i][0] = bad
        assert int(kb.bsr_pair_runs(a, b, *wrong)[1]) & 1, (i, bad)
    last = [t.clone() for t in tables[:4]]
    last[2][-1] = a.nbr  # the dummy block-row, as padding
    last[3][-1] = 0
    assert int(kb.bsr_pair_runs(a, b, *last)[1]) == 0
    swapped = [t.clone() for t in tables[:4]]
    for t in swapped:
        t[0], t[-1] = int(t[-1]), int(t[0])
    assert int(kb.bsr_pair_runs(a, b, *swapped)[1]) == 2


def _with_nan_padding(m):
    blocks = m.blocks.clone()
    blocks[int(m.nblocks):] = float("nan")
    return tsmm.BSRMatrix(indptr=m.indptr, indices=m.indices, blocks=blocks, shape=m.shape)


def test_bsr_bsr_unvisited_blocks_are_zero_not_nan():
    """Output blocks no pair visits are exactly zero, whatever the padding
    blocks of the containers hold."""
    ad = block_sparse(3, 3, 0.0)
    bd = block_sparse(3, 3, 0.0)
    ad[:128, 128:256] = 1.0  # A block (0, 1)
    bd[128:256, 256:] = 2.0  # B block (1, 2): only output block (0, 2) is visited
    a, b = sp.csr_matrix(ad), sp.csr_matrix(bd)
    plan = kb.bsr_pair_plan(a, b, 128)
    assert plan["n_pairs"] == 1 and plan["mask"].sum() == 1
    pa = tsmm.bsr_from_scipy(a, 128, dtype=torch.float32, block_capacity=4, device="cpu")
    pb = tsmm.bsr_from_scipy(b, 128, dtype=torch.float32, block_capacity=4, device="cpu")
    nan_pad = [_with_nan_padding(m) for m in (pa, pb)]
    got = kb.bsr_bsr_matmul_dense(*nan_pad, *_port_tables(plan, 1)).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(got, ad @ bd)
    assert np.all(got[128:] == 0) and np.all(got[:128, :256] == 0)


def test_bsr_wrappers_reject_bad_inputs():
    a = tsmm.bsr_from_scipy(sp.csr_matrix(block_sparse(2, 2, 1.0)), 128, dtype=torch.float32,
                            device="cpu")
    plan = kb.bsr_pair_plan(sp.csr_matrix(block_sparse(2, 2, 1.0)),
                            sp.csr_matrix(block_sparse(2, 2, 1.0)), 128)
    tables = _port_tables(plan)
    with pytest.raises(ValueError):  # mask of the wrong shape
        kb.bsr_bsr_matmul_dense(a, a, *tables[:5], torch.zeros((3, 2), dtype=torch.bool))
    with pytest.raises(ValueError):  # tables of different lengths
        kb.bsr_bsr_matmul_dense(a, a, tables[0][:1], *tables[1:])
    meta = tsmm.BSRMatrix(a.indptr.to("meta"), a.indices.to("meta"), a.blocks.to("meta"), a.shape)
    with pytest.raises(ValueError):  # neither the CPU nor CUDA
        kb.bsr_matmul_dense(meta, torch.zeros((256, 8), device="meta"))


# ---------------------------------------------------------------------------
# sparse_matrix_multiply on route "bsr"
# ---------------------------------------------------------------------------


@pytest.fixture
def config():
    """Restore both packages' configurations after a test changes them."""
    saved_t, saved_j = tsmm.get_config(), jsmm.get_config()
    yield
    tsmm.set_config(saved_t)
    jsmm.set_config(saved_j)


@pytest.fixture
def forced_bsr(config):
    tsmm.set_config(force_bsr=True)
    jsmm.set_config(force_pallas_bsr=True)


@pytest.fixture
def spies(monkeypatch):
    """Which BSR kernel each package's route called: the port's K5/K6
    drivers, and the JAX route's jitted K5/K6 products."""
    calls = {"port": [], "jax": []}

    def spy(module, name, side, kernel):
        real = getattr(module, name)

        def wrapped(*args, **kw):
            calls[side].append(kernel)
            return real(*args, **kw)

        monkeypatch.setattr(module, name, wrapped)

    spy(api, "bsr_matmul_dense", "port", "K5")
    spy(api, "bsr_bsr_matmul_dense", "port", "K6")
    spy(jax_api, "_bsr_product_jit", "jax", "K5")
    spy(jax_api, "_bsr_bsr_product_jit", "jax", "K6")
    return calls


def _api_operands(kind):
    """Block-sparse A (dense blocks); B block-sparse too (K6) or uniform (K5)."""
    a = block_sparse(4, 4, 0.3, seed=7, inner_density=1.0).astype(np.float64)  # 4 blocks
    if kind == "bsr_x_bsr":
        b = block_sparse(4, 4, 0.3, seed=6, inner_density=1.0).astype(np.float64)  # 3 blocks
    else:
        b = sp.random(512, 512, density=0.05, format="csr", random_state=6).toarray()
    return sp.csr_matrix(a), sp.csr_matrix(b)


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("output_format", ["sparse", "dense"])
@pytest.mark.parametrize("kind,kernel", [("bsr_x_bsr", "K6"), ("bsr_x_dense", "K5")])
def test_api_bsr_route_equals_jax(forced_bsr, spies, kind, kernel, output_format, symmetric):
    a, b = _api_operands(kind)
    got = tsmm.sparse_matrix_multiply(a, b, output_format, symmetric, device="cpu")
    assert tsmm.get_last_route() == "bsr"
    want = jsmm.sparse_matrix_multiply(a, b, output_format, symmetric)
    assert jsmm.get_last_route() == "bsr"
    assert spies["port"] == spies["jax"] == [kernel]
    ad, bd = a.toarray(), b.toarray()
    ref = ad @ bd
    bound = _bound(ad, bd)
    if symmetric:
        ref, bound = np.triu(ref), np.triu(bound)
    if output_format == "sparse":
        assert sp.isspmatrix_csr(got) and got.dtype == np.float64
        got.sort_indices()
        want = want.tocsr()
        want.sort_indices()
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        got, want = got.toarray(), want.toarray()
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    _within(got, want, bound, "port vs JAX")
    _within(got, ref, bound, "port vs f64")
    if symmetric:
        assert np.all(np.tril(got, -1) == 0)


def test_api_kernel_choice_follows_the_pair_count(forced_bsr, spies):
    """B block-sparse but every A block meets every B block-column: the plan
    is no cheaper than BSR x dense (the 0.9 rule), so both packages take K5."""
    ad = np.zeros((512, 512))
    ad[:128, :128] = 1.0
    bd = np.zeros((512, 512))
    bd[:128, :] = 2.0  # B's block-row 0 fully occupied: occupancy 0.25
    a, b = sp.csr_matrix(ad), sp.csr_matrix(bd)
    got = tsmm.sparse_matrix_multiply(a, b, "dense", device="cpu")
    want = jsmm.sparse_matrix_multiply(a, b, "dense")
    assert spies["port"] == spies["jax"] == ["K5"]
    np.testing.assert_array_equal(got, ad @ bd)
    np.testing.assert_array_equal(got, want)


def test_api_bsr_route_sorts_unsorted_indices(forced_bsr):
    """R1: CSR input with unsorted column indices (and scipy's sorted flag
    cleared) gives A @ B on the BSR route, against scipy."""
    a, b = _api_operands("bsr_x_dense")
    ref = (a @ b).toarray()
    rng = np.random.default_rng(4)
    data, indices = a.data.copy(), a.indices.copy()
    for r in range(a.shape[0]):
        lo, hi = a.indptr[r], a.indptr[r + 1]
        perm = lo + rng.permutation(hi - lo)
        data[lo:hi], indices[lo:hi] = a.data[perm], a.indices[perm]
    shuffled = sp.csr_matrix((data, indices, a.indptr.copy()), shape=a.shape)
    shuffled.has_sorted_indices = False
    assert not np.array_equal(shuffled.indices, a.indices)
    bound = _bound(a.toarray(), b.toarray())
    for output_format in ("sparse", "dense"):
        got = tsmm.sparse_matrix_multiply(shuffled, b, output_format, device="cpu")
        assert tsmm.get_last_route() == "bsr"
        _within(got.toarray() if sp.issparse(got) else got, ref, bound, output_format)


# ---------------------------------------------------------------------------
# Routing and the occupancy scan
# ---------------------------------------------------------------------------


def _occupancy_matrices():
    yield sp.csr_matrix(block_sparse(3, 4, 0.5, seed=1))
    yield sp.csr_matrix(block_sparse(5, 3, 1.0, seed=2))
    yield sp.csr_matrix((256, 384))
    yield sp.random(300, 200, density=0.01, format="csr", random_state=3)
    yield sp.random(1000, 700, density=0.001, format="csr", random_state=4)
    yield sp.block_diag([np.ones((128, 128))] * 4, format="csr")


@pytest.mark.parametrize("block_size", [128, 64])
def test_block_occupancy_equals_jax(block_size):
    for i, mat in enumerate(_occupancy_matrices()):
        want = jax_api.block_occupancy(mat, block_size)
        assert api.block_occupancy(mat, block_size) == want, i
        assert api.block_occupancy(mat.tocoo(), block_size) == want, i  # other formats
        assert api.block_occupancy(mat, block_size) == want, i  # JAX's cached answer


def test_occupancy_sees_in_place_pattern_edits():
    """R4: an in-place edit of ``indices`` that keeps nnz, shape and the four
    indices the JAX fingerprint samples gives the fresh occupancy (the port
    caches nothing), where the JAX cache answers with the stale one."""
    n = 5
    mat = sp.csr_matrix((np.ones(n), np.arange(n), np.r_[np.arange(n + 1), np.full(507, n)]),
                        shape=(512, 512))  # rows 0-4, all in block (0, 0)
    stale = api.block_occupancy(mat, 128)
    assert stale == 1 / 16
    assert jax_api.block_occupancy(mat, 128) == stale
    mat.indices[1] = 300  # row 1 moves to block (0, 2); idx[0], idx[2], idx[-1] kept
    fresh = api.block_occupancy(sp.csr_matrix(mat.toarray()), 128)  # a new object
    assert fresh == 2 / 16
    assert api.block_occupancy(mat, 128) == fresh
    assert jax_api.block_occupancy(mat, 128) == stale  # the fault the port repairs


def test_bsr_route_follows_config(config):
    a = sp.block_diag([sp.random(128, 128, density=1.0, random_state=s) for s in range(4)],
                      format="csr")  # 4 of 16 blocks occupied
    uniform = sp.random(600, 600, density=0.3, format="csr", random_state=1)
    assert not api._bsr_route_ok(a, "cuda")  # the H100's cutoff, 0: never on CUDA
    tsmm.set_config(cuda_bsr_occupancy_cutoff=0.25)
    assert api._bsr_route_ok(a, "cuda") and not api._bsr_route_ok(a, "cpu")
    assert not api._bsr_route_ok(uniform, "cuda")  # every block occupied: dense route
    assert not api._bsr_route_ok(sp.csr_matrix(a[:255]), "cuda")  # fewer than 2x2 blocks
    tsmm.set_config(cuda_bsr_occupancy_cutoff=0.2)
    assert not api._bsr_route_ok(a, "cuda")
    tsmm.set_config(cuda_bsr_occupancy_cutoff=0.25, use_bsr=False)
    assert not api._bsr_route_ok(a, "cuda")
    tsmm.set_config(force_bsr=True)
    assert not api._bsr_route_ok(a, "cuda")  # use_bsr off wins
    tsmm.set_config(use_bsr=True)
    assert api._bsr_route_ok(uniform, "cpu") and api._bsr_route_ok(a[:100, :100], "cpu")
    # A block size the CUDA kernels cannot take keeps CUDA requests on the
    # dense route; forcing the route still reaches the plain versions.
    tsmm.set_config(force_bsr=False, block_size=64)
    assert not api._bsr_route_ok(a, "cuda")
    tsmm.set_config(force_bsr=True)
    assert api._bsr_route_ok(a, "cuda") and api._bsr_route_ok(a, "cpu")


def test_dense_operands_keep_the_dense_route(config):
    """Uniformly sparse operands (the headline's kind) never take the BSR
    route unless it is forced (the cost model priced off the host)."""
    tsmm.set_config(auto_calibrate_link=False, link_fixed_s=1e-9, link_up_bytes_per_s=1e15,
                    link_down_bytes_per_s=1e15, host_rate_base=1.0)
    a = sp.random(600, 600, density=0.3, format="csr", random_state=1)
    b = sp.random(600, 600, density=0.3, format="csr", random_state=2)
    tsmm.sparse_matrix_multiply(a, b, symmetric=True, device="cpu")
    assert tsmm.get_last_route() == "dense"
