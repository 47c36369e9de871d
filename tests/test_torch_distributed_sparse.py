"""The port's sparse-local-contraction ring and both sparse triple products
against the JAX package's (``parallel/distributed.py``), on the CPU in f64.

Port ``row_mesh(["cpu"] * S)`` against JAX's S virtual CPU devices: the
same bounds, the same capacities, each shard's ``indptr`` and live
``indices`` equal, values at rtol = atol = 1e-12; S = 8, 3 and 2 for the
bidirectional schedule.  R7 (``ROADMAP.md``): where JAX silently drops
partials past an undersized capacity, the port raises ``ValueError``.
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import Mesh

import sparse_matrix_mult_tpu.parallel.distributed as jd
import sparse_matrix_mult_tpu_torch.parallel.distributed as td
from sparse_matrix_mult_tpu.config import get_config as jget, set_config as jset
from sparse_matrix_mult_tpu_torch.config import get_config as tget, set_config as tset
from sparse_matrix_mult_tpu_torch.parallel import mesh as tmesh
from sparse_matrix_mult_tpu_torch.types import bucket_capacity
from sparse_matrix_mult_tpu_torch.utils.testing import hypersparse_random
from sparse_matrix_mult_tpu_torch.utils.transfer import fine_capacity

TOL = dict(rtol=1e-12, atol=1e-12)


def meshes(s):
    return tmesh.row_mesh(["cpu"] * s), Mesh(np.array(jax.devices()[:s]), ("rows",))


def rand(m, n, d, seed):
    return sp.random(m, n, density=d, format="csr", random_state=seed)


def assert_same_sharded(got, want):
    assert got.shape == tuple(want.shape) and got.row_bounds == tuple(want.row_bounds)
    assert (got.rows_pad, got.shard_capacity) == (want.rows_pad, want.shard_capacity)
    ips, ixs, vvs = (np.asarray(x) for x in (want.indptrs, want.indices, want.values))
    for s, (ip, ix, vv) in got.local_shards().items():
        np.testing.assert_array_equal(ip.numpy(), ips[s])
        nnz = int(ips[s][-1])
        np.testing.assert_array_equal(ix.numpy()[:nnz], ixs[s][:nnz])
        np.testing.assert_allclose(vv.numpy()[:nnz], vvs[s][:nnz], **TOL)


def both(fn_name, *args, s=8, **kw):
    """The port's and JAX's ``fn_name`` on the same arguments and meshes."""
    pm, jm = meshes(s)
    return getattr(td, fn_name)(*args, mesh=pm, **kw), getattr(jd, fn_name)(*args, mesh=jm, **kw)


def skew_pair():
    """One heavy (shard, block) pair: shard 0's rows all hit B row 0, which
    is fully dense (JAX's skew test)."""
    m = k = n = 800
    rng = np.random.default_rng(5)
    rows = np.repeat(np.arange(m), 8)
    cols = rng.integers(0, k, rows.size)
    vals = rng.standard_normal(rows.size)
    heavy = np.arange(0, m // 8)
    a = sp.coo_matrix((np.concatenate([vals, rng.standard_normal(heavy.size)]),
                       (np.concatenate([rows, heavy]),
                        np.concatenate([cols, np.zeros(heavy.size, np.int64)]))),
                      shape=(m, k)).tocsr()
    b = rand(k, n, 0.03, 6).tolil()
    b[0, :] = rng.standard_normal(n)
    return a, b.tocsr()


@pytest.mark.parametrize("s", [8, 3, 2])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("balance", ["rows", "flops"])
def test_sparse_ring_matches_jax(s, symmetric, balance):
    a, b = rand(300, 300, 0.02, 21), rand(300, 300, 0.02, 22)
    got, want = both("spgemm_csr_distributed_sparse", a, b, s=s, symmetric=symmetric,
                     balance=balance)
    assert_same_sharded(got, want)
    ref = (a @ b).toarray()
    np.testing.assert_allclose(got.to_scipy().toarray(), np.triu(ref) if symmetric else ref,
                               **TOL)


@pytest.mark.parametrize("case", ["nonsquare_skew", "empty_tail", "fewer_rows", "skew_buffer"])
def test_sparse_ring_edges_match_jax(case):
    if case == "nonsquare_skew":
        a = rand(250, 170, 0.03, 23).tolil()
        a[0, :] = 1.0
        a, b, balance = a.tocsr(), rand(170, 410, 0.05, 24), "flops"
    elif case == "empty_tail":
        m = 64
        a = sp.csr_matrix((np.ones(3), np.array([1, 2, 3]),
                           np.concatenate([[0, 1, 2, 3], np.full(m - 3, 3)])), shape=(m, m))
        b, balance = rand(m, m, 0.1, 25), "flops"
    elif case == "fewer_rows":
        a, b, balance = rand(5, 64, 0.5, 11), rand(64, 32, 0.2, 12), "flops"
    else:
        (a, b), balance = skew_pair(), "rows"
    got, want = both("spgemm_csr_distributed_sparse", a, b, balance=balance)
    assert_same_sharded(got, want)
    np.testing.assert_allclose(got.to_scipy().toarray(), (a @ b).toarray(), **TOL)


def test_skew_sizes_the_buffer_by_totals():
    """The partials buffer is sized by the shard's total work plus one step,
    not S times the heaviest step (JAX's skew fix), in both packages."""
    a, b = skew_pair()
    bounds = tuple(np.linspace(0, 800, 9).astype(int))
    e_max, tot_max = td._expand_step_capacity(a, b.indptr, 800, bounds, 8)
    assert (e_max, tot_max) == jd._expand_step_capacity(a, b.indptr, 800, bounds, 8)
    assert 8 * bucket_capacity(e_max) >= 8 * tot_max
    assert fine_capacity(tot_max) + fine_capacity(e_max) <= 2 * tot_max


@pytest.mark.parametrize("s", [8, 3])
def test_expand_step_capacity_exact(s):
    a, b = rand(100, 80, 0.1, 26), rand(80, 90, 0.1, 27)
    bounds = td._uniform_bounds(100, s)
    e_max, tot_max = td._expand_step_capacity(a, b.indptr, 80, bounds, s)
    assert (e_max, tot_max) == jd._expand_step_capacity(a, b.indptr, 80, bounds, s)
    kb = -(-80 // s)
    row_nnz = np.diff(b.indptr)
    brute_step = brute_total = 0
    for sh in range(s):
        cols = a.indices[a.indptr[bounds[sh]]:a.indptr[bounds[sh + 1]]]
        brute_total = max(brute_total, int(row_nnz[cols].sum()))
        for j in range(s):
            blk = cols[(cols >= j * kb) & (cols < (j + 1) * kb)]
            brute_step = max(brute_step, int(row_nnz[blk].sum()))
    assert (e_max, tot_max) == (brute_step, brute_total)


def test_pre_placed_operands_match_jax():
    """ShardedCSR operands with explicit capacities; without them, ValueError."""
    pm, jm = meshes(8)
    a, b = rand(160, 160, 0.03, 28), rand(160, 160, 0.03, 29)
    bounds = td.flop_shard_bounds(a, b, 8)
    e_max, tot_max = td._expand_step_capacity(a, b.indptr, 160, bounds, 8)
    caps = dict(expand_step_capacity=bucket_capacity(e_max), shard_capacity=bucket_capacity(
        tot_max))
    got = td.spgemm_csr_distributed_sparse(td.shard_csr(a, pm, bounds=bounds),
                                           td.shard_csr(b, pm), mesh=pm, **caps)
    want = jd.spgemm_csr_distributed_sparse(jd.shard_csr(a, jm, bounds=bounds),
                                            jd.shard_csr(b, jm), mesh=jm, **caps)
    assert_same_sharded(got, want)
    # A host A against a pre-placed B plans from B's gathered row pointers.
    got = td.spgemm_csr_distributed_sparse(a, td.shard_csr(b, pm), mesh=pm)
    want = jd.spgemm_csr_distributed_sparse(a, jd.shard_csr(b, jm), mesh=jm)
    assert_same_sharded(got, want)
    for d, mesh in ((td, pm), (jd, jm)):
        with pytest.raises(ValueError, match="explicit"):
            d.spgemm_csr_distributed_sparse(d.shard_csr(a, mesh), d.shard_csr(b, mesh),
                                            mesh=mesh)


def test_compute_only_twin_matches_jax():
    pm, jm = meshes(4)
    a, b = rand(120, 120, 0.05, 30), rand(120, 120, 0.05, 31)
    got = td.spgemm_csr_distributed_sparse(a, b, mesh=pm, _comm=False)
    want = jd.spgemm_csr_distributed_sparse(a, b, mesh=jm, _comm=False)
    assert_same_sharded(got, want)


@pytest.mark.parametrize("capacity", ["expand_step_capacity", "partials_capacity"])
def test_r7_short_capacity_raises(capacity):
    """R7: JAX drops the partials past an undersized step capacity or
    partials buffer and returns a wrong product; the port raises."""
    a, b = rand(120, 120, 0.1, 1), rand(120, 120, 0.1, 2)
    ref = a @ b
    size = {"expand_step_capacity": 16, "partials_capacity": 1200}[capacity]
    pm, jm = meshes(8)
    wrong = jd.spgemm_csr_distributed_sparse(a, b, mesh=jm, **{capacity: size}).to_scipy()
    assert wrong.nnz < ref.nnz and abs(wrong - ref).max() > 1
    with pytest.raises(ValueError, match=capacity):
        td.spgemm_csr_distributed_sparse(a, b, mesh=pm, **{capacity: size})


def test_r7_short_triple_capacity_raises():
    h, q = rand(60, 200, 0.05, 41), rand(200, 200, 0.05, 42)
    ref = (h @ q @ h.T).toarray()
    pm, jm = meshes(8)
    wrong = np.asarray(jd.triple_product_distributed_sparse(h, q, 1, mesh=jm,
                                                            expand_step_capacity=2))
    assert np.abs(wrong - ref).max() > 1
    with pytest.raises(ValueError, match="expand_step_capacity"):
        td.triple_product_distributed_sparse(h, q, 1, mesh=pm, expand_step_capacity=2)


def test_auto_dispatch_to_sparse_engine(monkeypatch):
    a, b = rand(200, 200, 0.05, 31), rand(200, 200, 0.05, 32)
    pm, _ = meshes(8)
    calls = []
    real = td.spgemm_csr_distributed_sparse

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(td, "spgemm_csr_distributed_sparse", spy)
    saved = tget()
    try:
        tset(dense_shard_budget_bytes=1 << 10)
        out = td.spgemm_csr_distributed(a, b, mesh=pm)
        assert calls, "the sparse engine was not dispatched"
        np.testing.assert_allclose(out.to_scipy().toarray(), (a @ b).toarray(), **TOL)
        calls.clear()
        tset(dense_shard_budget_bytes=4 << 30)
        td.spgemm_csr_distributed(a, b, mesh=pm)
        assert not calls, "a small problem stays on the dense ring"
    finally:
        tset(saved)
    assert tget().dense_shard_budget_bytes == jget().dense_shard_budget_bytes == 4 << 30


def test_large_sparse_never_densifies(monkeypatch):
    """20,000^2 at d = 5e-4: a dense (2,500 x 20,000) panel per slot would
    be 400 MB; the sparse ring densifies nothing and equals scipy."""
    m = 20_000
    a = hypersparse_random(m, m, int(5e-4 * m * m), seed=28)
    b = hypersparse_random(m, m, int(5e-4 * m * m), seed=29)

    def refuse(*args, **kw):
        raise AssertionError("the sparse ring densified a panel")

    monkeypatch.setattr(td, "_local_dense", refuse)
    pm, _ = meshes(8)
    got = td.spgemm_csr_distributed_sparse(a, b, mesh=pm).to_scipy()
    ref = a @ b
    assert got.nnz == ref.nnz
    assert abs(got - ref).max() < 1e-10


@pytest.mark.parametrize("s", [8, 3, 2])
@pytest.mark.parametrize("full", [0, 1])
def test_sparse_triple_product_matches_jax(s, full):
    h, q = rand(60, 200, 0.05, 41), rand(200, 200, 0.05, 42)
    got, want = both("triple_product_distributed_sparse", h, q, full, s=s)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)
    ref = (h @ q @ h.T).toarray()
    np.testing.assert_allclose(np.asarray(got), ref if full else np.triu(ref), **TOL)
    again = td.triple_product_distributed_sparse(h, q, full, mesh=meshes(s)[0])
    assert all(torch.equal(p, again.panels[i]) for i, p in got.local_shards().items())


def test_triple_product_auto_dispatches_to_sparse(monkeypatch):
    h, q = rand(40, 160, 0.05, 43), rand(160, 160, 0.05, 44)
    calls = []
    real = td.triple_product_distributed_sparse
    monkeypatch.setattr(td, "triple_product_distributed_sparse",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    saved_t, saved_j = tget(), jget().dense_shard_budget_bytes
    try:
        # Room for the (5 x 40) C panel, not for the dense (5 x 160) panels.
        tset(dense_shard_budget_bytes=40 * 40 * 8)
        jset(dense_shard_budget_bytes=40 * 40 * 8)
        got, want = both("triple_product_distributed", h, q, 0)
    finally:
        tset(saved_t)
        jset(dense_shard_budget_bytes=saved_j)
    assert calls
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(np.asarray(got), np.triu((h @ q @ h.T).toarray()), **TOL)


@pytest.mark.parametrize("gate", ["budget", "int32"])
def test_sparse_triple_product_gates_match_jax(gate):
    saved_t, saved_j = tget(), jget().dense_shard_budget_bytes
    if gate == "budget":
        h, budget, match = rand(64, 64, 0.1, 45), 16, "dense_shard_budget_bytes"
    else:  # rows_pad * m >= 2**31 on one slot, with the budget out of the way
        h, budget, match = sp.csr_matrix((46_341, 10)), 1 << 50, "2\\*\\*31"
    try:
        tset(dense_shard_budget_bytes=budget)
        jset(dense_shard_budget_bytes=budget)
        for d, mesh in zip((td, jd), meshes(1)):
            with pytest.raises(ValueError, match=match):
                d.triple_product_distributed_sparse(h, h.T.tocsr(), 0, mesh=mesh)
    finally:
        tset(saved_t)
        jset(dense_shard_budget_bytes=saved_j)
