#!/usr/bin/env python3
"""The rings of ``parallel/distributed.py`` across several devices or processes.

Run from the repository root:

    python3 tools/multi_gpu_check.py --procs 1 --slots 4 --same-card   # 4 slots on cuda:0
    python3 tools/multi_gpu_check.py --procs 1 --slots 4     # one process, 4 cards
    python3 tools/multi_gpu_check.py --procs 4 --slots 1     # 4 processes (NCCL), a card each
    python3 tools/multi_gpu_check.py --procs 4 --slots 1 --device cpu --small   # gloo on the CPU

Each configuration builds one global mesh of ``procs * slots`` slots
(process ``r`` owns slots ``r * slots ...``, on cards ``r * slots ...``, or
on the CPU), then runs, with pre-placed operands: the CSR ring at the
10k^2 d=0.1 symmetric headline (balance "flops"), the sparse ring at
1,000,000^2 with nnz 1e7 per operand, the dense triple product at the
inversion shape (compute_full_matrix=1: its mirror ring too) and the sparse
triple product at H 20,000 x 1,000,000 (200 per row).  Every process holds
its local shards against an f64 oracle (identical structure, values in the
reference oracle) and times each ring (host clock around the call and a
synchronisation, all processes released together by a barrier; the fastest
of 3 warm calls, the slowest process).  Process 0 prints one JSON line
``{"multi": ...}`` with the card's name and power limit.  A worker that
fails or outlives ``--timeout`` fails the run; every worker is stopped.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RTOL, ATOL = 1e-5, 1e-8
RUNS = 3


def problems(small: bool):
    """The operands, from fixed seeds (chip_smoke.py's sizes unless small)."""
    import scipy.sparse as sp

    from sparse_matrix_mult_tpu_torch.utils.testing import hypersparse_random

    n, d = (700, 0.1) if small else (10_000, 0.1)
    big, nnz = (30_000, 150_000) if small else (1_000_000, 10_000_000)
    obs, state = (96, 384) if small else (4096, 16_384)
    h_rows, per_row = (300, 5) if small else (20_000, 200)
    a = sp.random(n, n, density=d, format="csr", random_state=1)
    b = sp.random(n, n, density=d, format="csr", random_state=2)
    ha, hb = hypersparse_random(big, big, nnz, 19), hypersparse_random(big, big, nnz, 20)
    h = sp.random(obs, state, density=0.05, format="csr", random_state=31)
    q0 = sp.random(state, state, density=0.002, format="csr", random_state=32)
    q0 = ((q0 + q0.T) * 0.5).tocsr()
    q = (q0 + sp.diags(1.0 + abs(q0).sum(axis=1).A.ravel())).tocsr()
    import numpy as np

    r = np.random.default_rng(41)
    hs = sp.coo_matrix((r.uniform(size=h_rows * per_row),
                        (np.repeat(np.arange(h_rows), per_row),
                         r.integers(0, big, h_rows * per_row))), shape=(h_rows, big)).tocsr()
    return dict(headline=(a, b), sparse=(ha, hb), triple=(h, q), triple_sparse=(hs, ha))


def check_rows(what: str, got, ref, device) -> float:
    """Dense local rows against dense f64 oracle rows: the same nonzero
    structure, values in the oracle; the largest |difference|."""
    import torch

    got = got.to(device).double()
    ref = ref.to(device)
    if tuple(got.shape) != tuple(ref.shape):
        raise RuntimeError(f"{what}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.equal(got != 0, ref != 0):
        raise RuntimeError(f"{what}: structure differs from the oracle")
    if not torch.allclose(got, ref, rtol=RTOL, atol=ATOL):
        raise RuntimeError(f"{what}: outside the oracle")
    return float((got - ref).abs().max()) if got.numel() else 0.0


def csr_dense(ip, ix, vv, rows: int, cols: int):
    import torch

    from sparse_matrix_mult_tpu_torch.ops.kernels.convert_kernels import csr_to_dense_plain

    return csr_to_dense_plain(ip[: rows + 1], ix, vv, (rows, cols)) if rows else torch.zeros(
        (0, cols), dtype=vv.dtype, device=vv.device)


def f64_dense(mat, device):
    """Dense f64 tensor of a scipy matrix's rows on ``device``."""
    import torch

    return torch.from_numpy(mat.toarray()).to(device)


def worker(args) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist

    from sparse_matrix_mult_tpu_torch.parallel import distributed as td
    from sparse_matrix_mult_tpu_torch.parallel.mesh import init_distributed, row_mesh
    from sparse_matrix_mult_tpu_torch.types import bucket_capacity
    from sparse_matrix_mult_tpu_torch.utils.native import spgemm_host
    from sparse_matrix_mult_tpu_torch.utils.transfer import fine_capacity

    rank = args.rank
    cuda = args.device == "cuda"
    if not cuda:
        devices = ["cpu"] * args.slots
    elif args.same_card:
        devices = ["cuda:0"] * args.slots
    else:
        devices = [f"cuda:{rank * args.slots + i}" for i in range(args.slots)]
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(devices[0])
    if args.procs > 1:
        init_distributed(coordinator=args.coordinator, num_processes=args.procs,
                         process_id=rank, backend="nccl" if cuda else "gloo")
    mesh = row_mesh(devices)
    s_count = mesh.size
    home = torch.device(devices[0])
    ops = problems(args.small)

    def sync():
        if cuda:
            for d in devices:
                torch.cuda.synchronize(d)
        if args.procs > 1:
            dist.barrier()

    def timed(fn) -> float:
        fn()
        best = float("inf")
        for _ in range(RUNS):
            sync()
            t = time.perf_counter()
            fn()
            sync()
            best = min(best, time.perf_counter() - t)
        return best

    out, errs = {}, {}
    # CSR ring, headline, flop-balanced bounds.
    a_sp, b_sp = ops["headline"]
    bounds = td.flop_shard_bounds(a_sp, b_sp, s_count)
    pa, pb = td.shard_csr(a_sp, mesh, bounds=bounds), td.shard_csr(b_sp, mesh)
    ring = lambda: td.spgemm_csr_distributed(pa, pb, symmetric=True, mesh=mesh)  # noqa: E731
    c = ring()
    ref = torch.triu(f64_dense(a_sp, home) @ f64_dense(b_sp, home))
    errs["csr_ring"] = max(check_rows(f"csr ring slot {s}", csr_dense(
        ip, ix, vv, bounds[s + 1] - bounds[s], b_sp.shape[1]), ref[bounds[s]:bounds[s + 1]], home)
        for s, (ip, ix, vv) in c.local_shards().items())
    del c, ref
    out["csr_ring_s"] = timed(ring)
    del pa, pb

    # Sparse ring, 1M^2, pre-placed operands with the host plan's capacities.
    ha, hb = ops["sparse"]
    bounds = td.flop_shard_bounds(ha, hb, s_count)
    e_max, tot_max = td._expand_step_capacity(ha, hb.indptr, hb.shape[0], bounds, s_count)
    e_step = fine_capacity(e_max)
    caps = dict(expand_step_capacity=e_step,
                shard_capacity=bucket_capacity(min(tot_max, ha.shape[0] * hb.shape[1])),
                partials_capacity=fine_capacity(tot_max) + e_step)
    pa, pb = td.shard_csr(ha, mesh, bounds=bounds), td.shard_csr(hb, mesh)
    ring = lambda: td.spgemm_csr_distributed_sparse(pa, pb, mesh=mesh, **caps)  # noqa: E731
    c = ring()
    host = spgemm_host(ha, hb)
    worst = 0.0
    for s, (ip, ix, vv) in c.local_shards().items():
        rows = host[bounds[s]:bounds[s + 1]]
        n = int(ip[-1])
        if not (np.array_equal(ip.cpu().numpy()[: rows.shape[0] + 1], rows.indptr)
                and np.array_equal(ix[:n].cpu().numpy(), rows.indices)):
            raise RuntimeError(f"sparse ring slot {s}: structure differs from spgemm_host")
        got = vv[:n].double().cpu().numpy()
        if not np.allclose(got, rows.data, rtol=RTOL, atol=ATOL):
            raise RuntimeError(f"sparse ring slot {s}: outside the oracle")
        worst = max(worst, float(np.abs(got - rows.data).max()) if n else 0.0)
    errs["sparse_ring"] = worst
    del c, host
    out["sparse_ring_s"] = timed(ring)
    del pa, pb

    # Dense triple product, full: the mirror ring too.
    h_sp, q_sp = ops["triple"]
    ph, pq = td.shard_csr(h_sp, mesh), td.shard_csr(q_sp, mesh)
    ring = lambda: td.triple_product_distributed(ph, pq, 1, mesh=mesh)  # noqa: E731
    c = ring()
    h64 = f64_dense(h_sp, home)
    full = h64 @ f64_dense(q_sp, home) @ h64.T
    ref = torch.triu(full) + torch.triu(full, 1).T
    errs["triple_dense"] = max(check_rows(f"triple slot {s}", p, ref[c.bounds[s]:c.bounds[s + 1]],
                                          home) for s, p in c.local_shards().items())
    del c, ref, full, h64
    out["triple_dense_s"] = timed(ring)
    del ph, pq

    # Sparse triple product (T = H Q by the sparse ring, then T H^T).
    hs, qs = ops["triple_sparse"]
    ring = lambda: td.triple_product_distributed_sparse(hs, qs, 0, mesh=mesh)  # noqa: E731
    c = ring()

    def f64_csr(m):
        return torch.sparse_csr_tensor(*(torch.from_numpy(x).to(home) for x in (
            m.indptr.astype(np.int64), m.indices.astype(np.int64), m.data.astype(np.float64))),
            size=m.shape)

    if cuda:
        up = torch.triu(torch.sparse.mm(torch.sparse.mm(f64_csr(hs), f64_csr(qs)),
                                        f64_csr(hs.T.tocsr())).to_dense())
    else:
        up = torch.from_numpy(np.triu(spgemm_host(spgemm_host(hs, qs), hs.T.tocsr()).toarray()))
    errs["triple_sparse"] = max(check_rows(f"sparse triple slot {s}", p,
                                           up[c.bounds[s]:c.bounds[s + 1]], home)
                                for s, p in c.local_shards().items())
    del c, up
    out["triple_sparse_s"] = timed(ring)

    if args.procs > 1:
        gathered = [None] * args.procs
        dist.all_gather_object(gathered, (out, errs))
        out = {k: max(o[k] for o, _ in gathered) for k in out}
        errs = {k: max(e[k] for _, e in gathered) for k in errs}
        dist.destroy_process_group()
    return dict(out, max_abs_err=errs)


def launch(args) -> int:
    """Start ``procs`` workers (this script with ``--rank``), wait for all of
    them within ``--timeout``, stop any left; print process 0's line."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    base = [sys.executable, os.path.abspath(__file__), "--procs", str(args.procs), "--slots",
            str(args.slots), "--device", args.device, "--coordinator", f"localhost:{port}"]
    base += ["--small"] if args.small else []
    procs = [subprocess.Popen(base + ["--rank", str(r)], stdout=subprocess.PIPE, text=True)
             for r in range(args.procs)]
    deadline = time.monotonic() + args.timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        print(f"multi_gpu_check: worker exit codes {[p.returncode for p in procs]}",
              file=sys.stderr)
        return 1
    print(outs[0], end="")
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--procs", type=int, default=1)
    parser.add_argument("--slots", type=int, default=4, help="slots (cards) per process")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--same-card", action="store_true",
                        help="every slot on cuda:0 (one process): the one-card baseline")
    parser.add_argument("--small", action="store_true", help="CPU rehearsal sizes")
    parser.add_argument("--timeout", type=float, default=900.0)
    parser.add_argument("--rank", type=int, default=None)
    parser.add_argument("--coordinator", default=None)
    args = parser.parse_args()
    import torch

    if args.same_card and args.procs != 1:
        parser.error("--same-card runs one process")
    cards = 1 if args.same_card else args.procs * args.slots
    if args.device == "cuda" and torch.cuda.device_count() < cards:
        print(f"multi_gpu_check: needs {cards} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if args.rank is None and args.procs > 1:
        return launch(args)
    args.rank = args.rank or 0
    result = worker(args)
    if args.rank == 0:
        card = "cpu"
        if args.device == "cuda":
            card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True, text=True,
                                  check=True).stdout.strip().splitlines()[0]
        print(json.dumps({"multi": dict(procs=args.procs, slots_per_proc=args.slots,
                                        same_card=args.same_card, device=args.device,
                                        card=card, small=args.small,
                                        **result)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
