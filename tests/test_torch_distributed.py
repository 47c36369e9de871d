"""The port's row mesh, ingestion and dense-panel rings against the JAX
package's (``parallel/distributed.py``), on the CPU in f64.

An S-slot ``row_mesh(["cpu"] * S)`` of the port runs against JAX's mesh of
S virtual CPU devices (``tests/conftest.py``), with the same operands, the
same bounds and the same shards: ``shard_csr`` array for array, the CSR
ring's ``indptr`` and live ``indices`` equal shard for shard, values at
rtol = atol = 1e-12.  S = 8, 3 and 2 cover the bidirectional schedule
(an even ring, an odd one with its skipped last step, one exchange).
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import Mesh

import sparse_matrix_mult_tpu as jsmm
import sparse_matrix_mult_tpu.parallel.distributed as jd
import sparse_matrix_mult_tpu_torch as tsmm
import sparse_matrix_mult_tpu_torch.parallel.distributed as td
from sparse_matrix_mult_tpu_torch.parallel import mesh as tmesh
from sparse_matrix_mult_tpu_torch.parallel import partition as tpart

TOL = dict(rtol=1e-12, atol=1e-12)
SIZES = (8, 3, 2)


def meshes(s):
    """(port mesh, JAX mesh) of ``s`` slots / devices."""
    return tmesh.row_mesh(["cpu"] * s), Mesh(np.array(jax.devices()[:s]), ("rows",))


def assert_same_sharded(got, want, values_exact=False):
    """A port ShardedCSR against a JAX one: shape, bounds, capacities and
    every shard's indptr and live indices equal, values within TOL."""
    assert got.shape == tuple(want.shape)
    assert got.row_bounds == tuple(want.row_bounds)
    assert (got.n_shards, got.rows_pad, got.shard_capacity) == (
        want.n_shards, want.rows_pad, want.shard_capacity)
    ips, ixs, vvs = (np.asarray(x) for x in (want.indptrs, want.indices, want.values))
    for s, (ip, ix, vv) in got.local_shards().items():
        np.testing.assert_array_equal(ip.numpy(), ips[s])
        nnz = int(ips[s][-1])
        np.testing.assert_array_equal(ix.numpy()[:nnz], ixs[s][:nnz])
        if values_exact:
            np.testing.assert_array_equal(vv.numpy(), vvs[s])
        else:
            np.testing.assert_allclose(vv.numpy()[:nnz], vvs[s][:nnz], **TOL)


def rand(m, n, d, seed):
    return sp.random(m, n, density=d, format="csr", random_state=seed)


def skewed(m, k, seed):
    a = rand(m, k, 0.05, seed).tolil()
    a[0, :] = 1.0  # one heavy row
    return a.tocsr()


def empty_tail(m, k):
    """Entries in the first rows only: the later shards hold nothing."""
    return sp.csr_matrix((np.ones(3), np.array([1, 2, 3]),
                          np.concatenate([[0, 1, 2, 3], np.full(m - 3, 3)])), shape=(m, k))


# ---------------------------------------------------------------------------
# The mesh.
# ---------------------------------------------------------------------------


def test_row_mesh_slots():
    mesh = tmesh.row_mesh(["cpu"] * 4, axis="r")
    assert mesh.size == 4 and mesh.axis == "r"
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert mesh.local_slots() == (0, 1, 2, 3) and mesh.group is None
    assert tmesh.row_mesh(["cpu"]).axis == tsmm.get_config().mesh_axis == "rows"


def test_row_mesh_without_a_card_raises(monkeypatch):
    """No devices and no GPU: row_mesh raises and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.row_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.shard_csr(rand(8, 8, 0.5, 1))  # the default mesh of every entry point
    with pytest.raises(ValueError):
        tmesh.row_mesh([])


def test_ring_shift_hands_over_on_one_device():
    mesh = tmesh.row_mesh(["cpu"] * 5)
    blocks = [(torch.full((2,), float(s)),) for s in range(5)]
    for shift in (1, -1):
        got = tmesh.ring_shift(mesh, blocks, shift).wait()
        for d in range(5):
            assert got[d] is blocks[(d + shift) % 5]  # no copy between slots of one device


# ---------------------------------------------------------------------------
# Partitioners and ingestion.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,parts", [(10, 3), (3, 8), (0, 4), (64, 8)])
def test_partitions_match_jax(rows, parts):
    from sparse_matrix_mult_tpu.parallel import partition as jpart

    np.testing.assert_array_equal(tpart.equal_rows_partition(rows, parts),
                                  jpart.equal_rows_partition(rows, parts))
    flops = np.random.default_rng(rows).integers(0, 50, rows).astype(np.float64)
    np.testing.assert_array_equal(tpart.flop_balanced_partition(flops, parts),
                                  jpart.flop_balanced_partition(flops, parts))


@pytest.mark.parametrize("case", ["generic", "skewed", "fewer_rows", "empty_tail"])
def test_flop_shard_bounds_match_jax(case):
    a = {"generic": rand(80, 60, 0.1, 1), "skewed": skewed(80, 60, 2),
         "fewer_rows": rand(5, 60, 0.5, 3), "empty_tail": empty_tail(80, 60)}[case]
    b = rand(60, 40, 0.3, 4)
    for s in SIZES:
        got = td.flop_shard_bounds(a, b, s)
        assert got == jd.flop_shard_bounds(a, b, s)
        assert len(got) == s + 1 and got[0] == 0 and got[-1] == a.shape[0]
    pm, jm = meshes(8)
    assert td.flop_shard_bounds(a, td.shard_csr(b, pm), 8) == jd.flop_shard_bounds(
        a, jd.shard_csr(b, jm), 8)


@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("balance", ["rows", "flops"])
def test_shard_csr_matches_jax(s, balance):
    pm, jm = meshes(s)
    a = skewed(50, 37, 11)
    bounds = td.flop_shard_bounds(a, rand(37, 20, 0.2, 12), s) if balance == "flops" else None
    got = td.shard_csr(a, pm, bounds=bounds)
    want = jd.shard_csr(a, jm, bounds=bounds)
    assert_same_sharded(got, want, values_exact=True)
    assert all(t.device.type == "cpu" and t.dtype == torch.float64 for t in got.values)
    assert all(t.dtype == torch.int32 for t in got.indptrs + got.indices)
    np.testing.assert_array_equal(got.to_scipy().toarray(), a.toarray())
    # A port container and a capacity of its own go in too.
    got = td.shard_csr(tsmm.from_scipy(a, device="cpu"), pm, capacity=512)
    assert got.shard_capacity == 512
    np.testing.assert_array_equal(got.to_scipy().toarray(), a.toarray())


def test_shard_csr_rejects_what_jax_rejects():
    pm, jm = meshes(8)
    a = rand(40, 30, 0.3, 13)
    for kw in (dict(bounds=(0, 10, 40)), dict(bounds=(0,) * 8 + (41,)), dict(capacity=4)):
        with pytest.raises(ValueError):
            jd.shard_csr(a, jm, **kw)
        with pytest.raises(ValueError):
            td.shard_csr(a, pm, **kw)


def test_shard_csr_materializes_each_own_shard_once():
    pm = tmesh.row_mesh(["cpu"] * 4)
    td.TRACK_MATERIALIZATION = True
    td.MATERIALIZED_SHARDS.clear()
    try:
        td.shard_csr(rand(40, 30, 0.3, 14), pm)
        assert td.MATERIALIZED_SHARDS == [0, 1, 2, 3]
    finally:
        td.TRACK_MATERIALIZATION = False
        td.MATERIALIZED_SHARDS.clear()


# ---------------------------------------------------------------------------
# The dense ring, the CSR ring, the dense triple product and ring_matmul.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("symmetric", [False, True])
def test_dense_ring_matches_jax(s, symmetric):
    pm, jm = meshes(s)
    a, b = rand(100, 90, 0.1, 1), rand(90, 100, 0.1, 2)
    got = td.spgemm_dense_distributed(tsmm.from_scipy(a, device="cpu"), b, symmetric=symmetric,
                                      mesh=pm)
    want = jd.spgemm_dense_distributed(jsmm.from_scipy(a), b, symmetric=symmetric, mesh=jm)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)
    ref = (a @ b).toarray()
    np.testing.assert_allclose(np.asarray(got), np.triu(ref) if symmetric else ref, **TOL)
    # Row-sharded: slot s holds its own rows, on its device.
    bounds = got.bounds
    for slot, panel in got.local_shards().items():
        assert panel.shape == (bounds[slot + 1] - bounds[slot], 100)


@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("balance", ["rows", "flops"])
def test_csr_ring_matches_jax(s, symmetric, balance):
    pm, jm = meshes(s)
    m, k, n = (64, 64, 64) if symmetric else (40, 30, 50)
    a = skewed(m, k, 9)
    b = rand(k, n, 0.3, 10)
    got = td.spgemm_csr_distributed(a, b, symmetric=symmetric, mesh=pm, balance=balance)
    want = jd.spgemm_csr_distributed(a, b, symmetric=symmetric, mesh=jm, balance=balance)
    assert_same_sharded(got, want)
    ref = (a @ b).toarray()
    np.testing.assert_allclose(got.to_scipy().toarray(), np.triu(ref) if symmetric else ref,
                               **TOL)


@pytest.mark.parametrize("case", ["empty_tail", "fewer_rows", "odd_shape"])
def test_csr_ring_edges_match_jax(case):
    pm, jm = meshes(8)
    a = {"empty_tail": empty_tail(64, 64), "fewer_rows": rand(5, 64, 0.5, 11),
         "odd_shape": rand(17, 23, 0.5, 12)}[case]
    b = rand(a.shape[1], 11, 0.3, 13)
    for balance in ("rows", "flops"):
        got = td.spgemm_csr_distributed(a, b, mesh=pm, balance=balance)
        want = jd.spgemm_csr_distributed(a, b, mesh=jm, balance=balance)
        assert_same_sharded(got, want)
    got = td.spgemm_csr_distributed(a, b, mesh=pm, shard_capacity=256)
    assert got.shard_capacity == 256
    np.testing.assert_allclose(got.to_scipy().toarray(), (a @ b).toarray(), **TOL)


@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("full", [0, 1])
def test_triple_product_matches_jax(s, full):
    pm, jm = meshes(s)
    h, q = rand(60, 90, 0.1, 5), rand(90, 90, 0.1, 6)
    got = td.triple_product_distributed(h, q, compute_full_matrix=full, mesh=pm)
    want = jd.triple_product_distributed(h, q, compute_full_matrix=full, mesh=jm)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)
    ref = (h @ q @ h.T).toarray()
    np.testing.assert_allclose(np.asarray(got), np.triu(ref) + (np.triu(ref, 1).T if full else 0),
                               **TOL)


@pytest.mark.parametrize("s", SIZES)
def test_ring_matmul_matches_jax(s):
    pm, jm = meshes(s)
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((100, 72)), rng.standard_normal((72, 53))
    got = np.asarray(td.ring_matmul(torch.from_numpy(a), torch.from_numpy(b), pm))
    np.testing.assert_allclose(got, np.asarray(jd.ring_matmul(jax.numpy.asarray(a),
                                                              jax.numpy.asarray(b), jm)), **TOL)
    np.testing.assert_allclose(got, a @ b, **TOL)


def test_sharded_operands_accepted_everywhere():
    pm, jm = meshes(8)
    a, b = rand(48, 48, 0.2, 17), rand(48, 48, 0.2, 18)
    pa, pb = td.shard_csr(a, pm), td.shard_csr(b, pm)
    ja, jb = jd.shard_csr(a, jm), jd.shard_csr(b, jm)
    np.testing.assert_allclose(np.asarray(td.spgemm_dense_distributed(pa, pb, mesh=pm)),
                               np.asarray(jd.spgemm_dense_distributed(ja, jb, mesh=jm)), **TOL)
    assert_same_sharded(td.spgemm_csr_distributed(pa, pb, mesh=pm),
                        jd.spgemm_csr_distributed(ja, jb, mesh=jm))
    np.testing.assert_allclose(
        np.asarray(td.triple_product_distributed(pa, pb, compute_full_matrix=1, mesh=pm)),
        np.asarray(jd.triple_product_distributed(ja, jb, compute_full_matrix=1, mesh=jm)), **TOL)


def test_compute_only_twin_matches_jax():
    """comm=False keeps every B block on its slot: JAX's identity twin."""
    pm, jm = meshes(4)
    a, b = rand(64, 64, 0.2, 19), rand(64, 64, 0.2, 20)
    got = td._spgemm_dense(pm, td.shard_csr(a, pm), td.shard_csr(b, pm), False, comm=False)
    want = jd._spgemm_dense_jit(jm, False, comm=False)(jd.shard_csr(a, jm), jd.shard_csr(b, jm))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)
    assert not np.allclose(np.asarray(got), (a @ b).toarray())


def test_no_slot_densifies_a_full_operand(monkeypatch):
    """Every panel a slot densifies is its own (rows_pad x k) A rows or one
    (kb x n) B block -- never the full dense A or B (JAX checks its
    compiled program's temporaries for the same)."""
    s = 8
    m = k = n = 64 * s
    pm = tmesh.row_mesh(["cpu"] * s)
    a, b = rand(m, k, 0.1, 13), rand(k, n, 0.1, 14)
    shapes = []
    real = td._local_dense

    def spy(ip, ix, vv, rows, cols, dtype=None):
        out = real(ip, ix, vv, rows, cols, dtype)
        shapes.append(tuple(out.shape))
        return out

    monkeypatch.setattr(td, "_local_dense", spy)
    got = td.spgemm_dense_distributed(a, b, mesh=pm)
    assert sorted(set(shapes)) == [(64, k)] and len(shapes) == 2 * s
    assert all(p.shape == (64, n) for p in got.local_shards().values())
    np.testing.assert_allclose(np.asarray(got), (a @ b).toarray(), **TOL)


def test_errors_match_jax():
    pm, jm = meshes(8)
    a, b = rand(40, 30, 0.3, 21), rand(40, 20, 0.3, 22)
    cases = [
        lambda d, mesh: d.spgemm_dense_distributed(a, b, mesh=mesh),  # inner dims
        lambda d, mesh: d.spgemm_dense_distributed(  # A not uniformly sharded
            d.shard_csr(a, mesh, bounds=(0, 1) + (40,) * 7), a.T.tocsr(), mesh=mesh),
        lambda d, mesh: d.spgemm_csr_distributed(  # B not uniformly sharded
            a, d.shard_csr(a.T.tocsr(), mesh, bounds=(0, 1) + (30,) * 7), mesh=mesh),
        lambda d, mesh: d.triple_product_distributed(  # H not uniformly sharded
            d.shard_csr(a, mesh, bounds=(0, 1) + (40,) * 7), rand(30, 30, 0.3, 23), mesh=mesh),
    ]
    for case in cases:
        with pytest.raises(ValueError):
            case(jd, jm)
        with pytest.raises(ValueError):
            case(td, pm)
    p4 = td.shard_csr(a, tmesh.row_mesh(["cpu"] * 4))
    with pytest.raises(ValueError, match="different mesh sizes"):
        td.spgemm_csr_distributed(p4, td.shard_csr(a.T.tocsr(), pm), mesh=pm)


def test_pad_to_multiple_matches_jax():
    x = np.arange(12.0).reshape(3, 4)
    for axis, mult in ((0, 4), (1, 3), (1, 4)):
        np.testing.assert_array_equal(td.pad_to_multiple(torch.from_numpy(x), axis, mult).numpy(),
                                      np.asarray(jd.pad_to_multiple(jax.numpy.asarray(x), axis,
                                                                    mult)))
