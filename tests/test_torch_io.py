"""The port's persistence (``io.py``) against the JAX package's.

Both packages write the same ``.npz`` layout, so a file saved by either
loads in the other; round trips are exact; ``load_sharded_operand`` places
a partitioned save onto the port's row mesh array for array as JAX's onto
its mesh, and feeds the rings.
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import Mesh

import sparse_matrix_mult_tpu as jsmm
import sparse_matrix_mult_tpu_torch as tsmm
from sparse_matrix_mult_tpu import io as jio
from sparse_matrix_mult_tpu.parallel import distributed as jd
from sparse_matrix_mult_tpu_torch import io as tio
from sparse_matrix_mult_tpu_torch.parallel import distributed as td
from sparse_matrix_mult_tpu_torch.parallel.mesh import row_mesh

TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture
def mat():
    return sp.random(97, 53, density=0.15, format="csr", random_state=7)


def same_scipy(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data, want.data)


@pytest.mark.parametrize("writer,reader", [(tio, jio), (jio, tio), (tio, tio)])
def test_csr_files_cross_load(tmp_path, mat, writer, reader):
    path = str(tmp_path / "m.npz")
    writer.save_csr(path, mat)
    same_scipy(reader.load_csr(path), mat)


def test_save_port_container_and_dense(tmp_path, mat):
    path = str(tmp_path / "m.npz")
    tio.save_csr(path, tsmm.from_scipy(mat, device="cpu"))
    same_scipy(jio.load_csr(path), mat)
    d = np.arange(12.0).reshape(3, 4)
    tio.save_csr(str(tmp_path / "d.npz"), d)
    np.testing.assert_array_equal(tio.load_csr(str(tmp_path / "d.npz")).toarray(), d)


def test_load_csr_onto_a_device(tmp_path, mat):
    path = str(tmp_path / "m.npz")
    jio.save_csr(path, mat)
    for device in ("cpu", torch.device("cpu")):
        got = tio.load_csr(path, device=device)
        assert isinstance(got, tsmm.CSRMatrix) and got.device.type == "cpu"
        np.testing.assert_array_equal(tsmm.to_scipy(got).toarray(), mat.toarray())
    saved = tsmm.get_config()
    try:
        tsmm.set_config(device="cpu")  # device=True: Config.device
        got = tio.load_csr(path, device=True, dtype=torch.float32)
        assert got.device.type == "cpu" and got.dtype == torch.float32
    finally:
        tsmm.set_config(saved)


@pytest.mark.parametrize("writer,reader", [(tio, jio), (jio, tio)])
@pytest.mark.parametrize("flop_balanced", [False, True])
def test_partitioned_files_cross_load(tmp_path, writer, reader, flop_balanced):
    a = sp.random(64, 64, density=0.02, format="csr", random_state=1).tolil()
    a[:8] = np.ones(64)  # heavy rows
    a = a.tocsr()
    b = sp.random(64, 64, density=0.3, format="csr", random_state=2)
    prefix = str(tmp_path / "p")
    kw = dict(b_indptr=b.indptr) if flop_balanced else {}
    paths = writer.save_partitioned(prefix, a, n_shards=4, **kw)
    assert len(paths) == 4
    shards, meta = reader.load_partitioned(prefix)
    _, want_meta = jio.load_partitioned(prefix)
    assert meta == want_meta
    if flop_balanced:
        assert meta["bounds"][1] < 64 // 4 + 1
    assert sum(s.shape[0] for s in shards) == 64
    same_scipy(reader.load_sharded_result(prefix), a)
    # The port's partitioner gives the JAX one's files.
    jio.save_partitioned(str(tmp_path / "j"), a, n_shards=4, **kw)
    tio.save_partitioned(str(tmp_path / "t"), a, n_shards=4, **kw)
    for i in range(4):
        same_scipy(tio.load_csr(f"{tmp_path}/t.shard{i:05d}.npz"),
                   jio.load_csr(f"{tmp_path}/j.shard{i:05d}.npz"))


def test_partitioned_subset_load(tmp_path, mat):
    prefix = str(tmp_path / "sub")
    tio.save_partitioned(prefix, mat, n_shards=3)
    shards, meta = tio.load_partitioned(prefix, shard_ids=[1], device="cpu")
    assert len(shards) == 1 and isinstance(shards[0], tsmm.CSRMatrix)
    lo, hi = meta["bounds"][1], meta["bounds"][2]
    np.testing.assert_array_equal(tsmm.to_scipy(shards[0]).toarray(), mat[lo:hi].toarray())


def test_multiply_from_checkpoint(tmp_path):
    a = sp.random(40, 30, density=0.2, format="csr", random_state=3)
    b = sp.random(30, 25, density=0.2, format="csr", random_state=4)
    pa, pb = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    jio.save_csr(pa, a)
    jio.save_csr(pb, b)
    saved = tsmm.get_config()
    try:
        tsmm.set_config(device="cpu")
        c = tsmm.sparse_matrix_multiply(tio.load_csr(pa), tio.load_csr(pb))
    finally:
        tsmm.set_config(saved)
    np.testing.assert_allclose(c.toarray(), (a @ b).toarray(), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("n_shards", [8, 3])
def test_load_sharded_operand_matches_jax(tmp_path, n_shards):
    """Shard counts equal to the mesh's place each file on its slot; other
    counts stitch and re-shard uniformly -- array for array as JAX."""
    pm, jm = row_mesh(["cpu"] * 8), Mesh(np.array(jax.devices()[:8]), ("rows",))
    a = sp.random(48, 40, density=0.2, format="csr", random_state=7)
    b = sp.random(40, 32, density=0.2, format="csr", random_state=8)
    prefix = str(tmp_path / "op")
    tio.save_partitioned(prefix, a, n_shards=n_shards)
    got = tio.load_sharded_operand(prefix, pm)
    want = jio.load_sharded_operand(prefix, jm)
    assert got.row_bounds == tuple(want.row_bounds) and got.shard_capacity == want.shard_capacity
    for s, (ip, ix, vv) in got.local_shards().items():
        np.testing.assert_array_equal(ip.numpy(), np.asarray(want.indptrs)[s])
        np.testing.assert_array_equal(ix.numpy(), np.asarray(want.indices)[s])
        np.testing.assert_array_equal(vv.numpy(), np.asarray(want.values)[s])
    np.testing.assert_array_equal(got.to_scipy().toarray(), a.toarray())
    c = td.spgemm_dense_distributed(got, b, mesh=pm)
    np.testing.assert_allclose(np.asarray(c), np.asarray(jd.spgemm_dense_distributed(
        want, b, mesh=jm)), **TOL)
    np.testing.assert_allclose(np.asarray(c), (a @ b).toarray(), **TOL)


def test_load_sharded_operand_reads_only_what_it_needs(tmp_path, monkeypatch):
    """With the meta's shard nnz, one file per slot is opened, once."""
    a = sp.random(60, 60, density=0.1, format="csr", random_state=9)
    prefix = str(tmp_path / "op")
    tio.save_partitioned(prefix, a, n_shards=4)
    opened = []
    real = np.load
    monkeypatch.setattr(np, "load", lambda path, *x, **k: opened.append(str(path)) or
                        real(path, *x, **k))
    got = tio.load_sharded_operand(prefix, row_mesh(["cpu"] * 4))
    assert sorted(opened) == [f"{prefix}.shard{i:05d}.npz" for i in range(4)]
    np.testing.assert_array_equal(got.to_scipy().toarray(), a.toarray())


def test_jax_container_saves_for_the_port(tmp_path, mat):
    path = str(tmp_path / "j.npz")
    jio.save_csr(path, jsmm.from_scipy(mat))
    same_scipy(tio.load_csr(path), mat)
