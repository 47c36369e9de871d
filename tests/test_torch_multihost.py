"""Two ``torch.distributed`` processes (gloo, on the CPU), each with two slots
of one global 4-slot row mesh: the port's counterpart of
``tests/test_multihost.py``.

Each process builds and opens only its own shards and shard files, the
rings cross between the processes by ``batch_isend_irecv``, and each
process checks its local result shards against scipy, without gathering
the global result.
"""

import os
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = r"""
import os, sys
import numpy as np
import scipy.sparse as sp
import torch

proc_id, coordinator = int(sys.argv[1]), sys.argv[2]

from sparse_matrix_mult_tpu_torch.parallel.mesh import init_distributed, row_mesh

init_distributed(coordinator=coordinator, num_processes=2, process_id=proc_id, backend="gloo")
init_distributed(coordinator=coordinator, num_processes=2, process_id=proc_id)  # idempotent
import torch.distributed as dist

assert dist.get_world_size() == 2
mesh = row_mesh(["cpu", "cpu"])
assert mesh.size == 4 and mesh.local_slots() == (2 * proc_id, 2 * proc_id + 1), mesh
own = list(mesh.local_slots())


def check_csr(out, ref):
    assert sorted(out.local_shards()) == own
    bounds = out.row_bounds
    for s, (ip, ix, vv) in out.local_shards().items():
        r0, r1 = bounds[s], bounds[s + 1]
        nnz = int(ip[r1 - r0]) if r1 > r0 else 0
        local = sp.csr_matrix((vv[:nnz].numpy(), ix[:nnz].numpy(), ip[: r1 - r0 + 1].numpy()),
                              shape=(r1 - r0, out.shape[1]))
        want = ref[r0:r1]
        assert local.nnz == want.nnz, (s, local.nnz, want.nnz)
        d = abs(local - want)
        assert (d.max() if d.nnz else 0.0) < 1e-10


def check_dense(out, ref):
    assert sorted(out.local_shards()) == own
    for s, panel in out.local_shards().items():
        r0, r1 = out.bounds[s], out.bounds[s + 1]
        np.testing.assert_allclose(panel.numpy(), ref[r0:r1], rtol=1e-10, atol=1e-12)
"""

_WORKER = _PRELUDE + r"""
import sparse_matrix_mult_tpu_torch.parallel.distributed as td

m = k = n = 40
A = sp.random(m, k, density=0.2, format="csr", random_state=1)
B = sp.random(k, n, density=0.2, format="csr", random_state=2)
td.TRACK_MATERIALIZATION = True
td.MATERIALIZED_SHARDS.clear()
a = td.shard_csr(A, mesh)
b = td.shard_csr(B, mesh)
# Each process built only the blocks of its own slots, once per operand.
assert sorted(a.local_shards()) == own
assert sorted(set(td.MATERIALIZED_SHARDS)) == own and len(td.MATERIALIZED_SHARDS) == 4
try:
    a.to_scipy()
    raise AssertionError("to_scipy gathered shards of another process")
except ValueError:
    pass

ref = (A @ B).toarray()
check_dense(td.spgemm_dense_distributed(a, b, mesh=mesh), ref)
check_dense(td.spgemm_dense_distributed(a, b, symmetric=True, mesh=mesh), np.triu(ref))
check_csr(td.spgemm_csr_distributed(A, B, mesh=mesh, balance="flops"), sp.csr_matrix(ref))
check_csr(td.spgemm_csr_distributed_sparse(A, B, mesh=mesh, balance="flops"), A @ B)
# A host A against a pre-placed B: B's row pointers are gathered from both ranks.
check_csr(td.spgemm_csr_distributed_sparse(A, b, mesh=mesh), A @ B)
H = sp.random(30, 40, density=0.2, format="csr", random_state=3)
full = (H @ B @ H.T).toarray()
check_dense(td.triple_product_distributed(H, B, 1, mesh=mesh), np.triu(full) + np.triu(full, 1).T)
rng = np.random.default_rng(0)
x, y = rng.standard_normal((30, 22)), rng.standard_normal((22, 9))
check_dense(td.ring_matmul(torch.from_numpy(x), torch.from_numpy(y), mesh), x @ y)
print(f"proc {proc_id} OK", flush=True)
"""

_WORKER_IO = _PRELUDE + r"""
prefix_a, prefix_b = sys.argv[3], sys.argv[4]
e_step, cap_l, partials_cap = (int(x) for x in sys.argv[5:8])

from sparse_matrix_mult_tpu_torch import io as tio
from sparse_matrix_mult_tpu_torch.parallel.distributed import (
    spgemm_csr_distributed_sparse, triple_product_distributed_sparse)

# File-ingestion locality: the shard files this process opens.
opened = []
_np_load = np.load
np.load = lambda path, *x, **kw: opened.append(os.path.basename(str(path))) or _np_load(
    path, *x, **kw)
a = tio.load_sharded_operand(prefix_a, mesh=mesh)
b = tio.load_sharded_operand(prefix_b, mesh=mesh)
np.load = _np_load
ids = sorted({int(p.split(".shard")[1].split(".")[0]) for p in opened})
assert ids == own and len(opened) == 4, opened

A = tio.load_sharded_result(prefix_a)  # the oracle's global view
B = tio.load_sharded_result(prefix_b)
out = spgemm_csr_distributed_sparse(a, b, mesh=mesh, expand_step_capacity=e_step,
                                    shard_capacity=cap_l, partials_capacity=partials_cap)
check_csr(out, A @ B)

H = A[:1200]
tp = triple_product_distributed_sparse(H, B, mesh=mesh)
check_dense(tp, np.triu((H @ B @ H.T).toarray()))
print(f"proc {proc_id} OK", flush=True)
"""


def _run(tmp_path, script: str, *args, timeout: int) -> None:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    path = tmp_path / "worker.py"
    path.write_text(script)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    procs = [subprocess.Popen([sys.executable, str(path), str(i), f"localhost:{port}",
                               *map(str, args)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert f"proc {i} OK" in out, out


def test_two_process_rings(tmp_path):
    """Every ring across two gloo processes of two CPU slots each."""
    _run(tmp_path, _WORKER, timeout=150)


def test_two_process_file_ingested_sparse_engine(tmp_path):
    """save_partitioned with flop-balanced bounds at 10,000 rows; each
    process reads only its own shard files; the sparse ring with explicit
    capacities and the sparse triple product across the two processes."""
    from sparse_matrix_mult_tpu_torch import io as tio
    from sparse_matrix_mult_tpu_torch.parallel.distributed import _expand_step_capacity
    from sparse_matrix_mult_tpu_torch.types import bucket_capacity
    from sparse_matrix_mult_tpu_torch.utils.testing import hypersparse_random

    m = 10_000
    a = hypersparse_random(m, m, 100_000, seed=81)
    b = hypersparse_random(m, m, 100_000, seed=82)
    prefix_a, prefix_b = str(tmp_path / "opA"), str(tmp_path / "opB")
    tio.save_partitioned(prefix_a, a, 4, b_indptr=b.indptr)
    tio.save_partitioned(prefix_b, b, 4)
    _, meta = tio.load_partitioned(prefix_a, shard_ids=[])
    e_max, tot_max = _expand_step_capacity(a, b.indptr, m, tuple(meta["bounds"]), 4)
    e_step = bucket_capacity(e_max)
    assert np.diff(meta["bounds"]).min() > 0
    _run(tmp_path, _WORKER_IO, prefix_a, prefix_b, e_step, bucket_capacity(tot_max),
         bucket_capacity(tot_max) + e_step, timeout=300)
