#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sparse_matrix_mult_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one line each:
  1. card    -- device name, nvidia-smi name/power limit, TF32 switched off;
  2. build   -- nvcc builds csrc/*.cu from the checkout (ptxas report shown);
  3. kernels -- each hand-written kernel against its plain PyTorch version
                on the card, at the shapes the main path gives it, with both
                times and the largest difference;
  4. main    -- the main path: three requests through sparse_matrix_multiply,
                with the launch counts zeroed just before and read just after:
                the headline (10,000^2, density 0.1, symmetric=True), a
                non-symmetric product at 12,288^2, density 0.006 (~36% dense,
                extracted by K4), and dense output at 10k.  Route "dense",
                launches per request, and each result against its oracle;
  5. sibling -- symmetric sparse output at 12,288^2 against scipy;
  6. timing  -- device-resident multiply() and end-to-end
                sparse_matrix_multiply at 10k, warm, min of 3, one profiled
                call (device busy time), and the headline's time per stage;
  7. bsr-kernels -- K5 and K6 against their plain versions at the BSR
                path's shapes (8192^2, 128^2 blocks, 10% of them occupied):
                both times, the largest difference, unvisited blocks zero;
  8. bsr-main -- the BSR path: four requests through sparse_matrix_multiply
                with block-sparse A, counts zeroed just before and read just
                after: A x B (K6), symmetric (K6, K2), A x uniform B_u (K3,
                K5) and dense output (K6).  Route "bsr", launches per
                request, and each result against an f64 oracle on the card;
  9. bsr-timing -- requests 1 and 3 end to end on the BSR route and, with
                use_bsr=False, on the dense route, warm, min of 3; and
                request 1's time per stage.

Then a JSON line of the kernels (launches summed over the two counted
paths), the nvidia-smi line, and last {"ok": true, "device": {...}}.  Any failed check exits non-zero; without a
CUDA device, or without the package beside it, it exits non-zero before any
result is printed.
"""

import json
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

import sparse_matrix_mult_tpu_torch as smt
from sparse_matrix_mult_tpu_torch import api
from sparse_matrix_mult_tpu_torch.ops.convert import csr_to_dense
from sparse_matrix_mult_tpu_torch.ops.dense_path import spgemm_dense_out
from sparse_matrix_mult_tpu_torch.ops.kernels import LAUNCHES, _build, reset_launches
from sparse_matrix_mult_tpu_torch.ops.kernels import bsr_spgemm as kb
from sparse_matrix_mult_tpu_torch.ops.kernels import convert_kernels as ck
from sparse_matrix_mult_tpu_torch.ops.kernels import triu_matmul as tm
from sparse_matrix_mult_tpu_torch.types_bsr import _tobsr_padded
from sparse_matrix_mult_tpu_torch.utils.native import expansion_size
from sparse_matrix_mult_tpu_torch.utils.transfer import (
    fetch_dense_to_csr, fetch_np, fine_capacity)

N, DENSITY = 10_000, 0.1  # the reference's headline configuration (bench.py)
SIB_N, SIB_DENSITY = 12_288, 0.006  # dense route, ~36% dense product
# BSR route: the block-structured operands of benchmarks/run.py:573-596
# (8192^2, 128^2 blocks, 10% occupied, dense standard-normal blocks), and a
# uniformly sparse B_u whose every block is occupied.
BSR_N, BSR_BLOCK, BSR_OCC, BSR_SEEDS = 8192, 128, 0.10, (21, 22)
BU_DENSITY, BU_SEED = 0.01, 23
RTOL, ATOL = 1e-5, 1e-8  # the reference's oracle tolerance
KERNEL_RUNS = 5
PATH_RUNS = 3
DEVICE = "cuda"

KERNELS = {
    # launch-counter key: (name, source, replaced TPU kernel)
    "matmul_triu": ("K1 matmul_triu", "sparse_matrix_mult_tpu_torch/csrc/triu_matmul.cu",
                    "sparse_matrix_mult_tpu/ops/pallas/triu_matmul.py:58"),
    "dense_to_csr_triu": ("K2 dense_to_csr_triu", "sparse_matrix_mult_tpu_torch/csrc/convert.cu",
                          "sparse_matrix_mult_tpu/ops/pallas/convert_kernels.py:203"),
    "csr_to_dense": ("K3 csr_to_dense", "sparse_matrix_mult_tpu_torch/csrc/convert.cu",
                     "sparse_matrix_mult_tpu/ops/pallas/convert_kernels.py:231"),
    "dense_to_csr": ("K4 dense_to_csr", "sparse_matrix_mult_tpu_torch/csrc/convert.cu",
                     "sparse_matrix_mult_tpu/ops/pallas/convert_kernels.py:176"),
    "bsr_matmul_dense": ("K5 bsr_matmul_dense", "sparse_matrix_mult_tpu_torch/csrc/bsr_spgemm.cu",
                         "sparse_matrix_mult_tpu/ops/pallas/bsr_spgemm.py:50"),
    "bsr_bsr_matmul_dense": ("K6 bsr_bsr_matmul_dense",
                             "sparse_matrix_mult_tpu_torch/csrc/bsr_spgemm.cu",
                             "sparse_matrix_mult_tpu/ops/pallas/bsr_spgemm.py:193"),
}
DENSE_PATH_KERNELS = ("matmul_triu", "dense_to_csr_triu", "csr_to_dense", "dense_to_csr")

# The main path's requests: (label, operands, sparse_matrix_multiply keywords).
MAIN_REQUESTS = (
    ("headline_symmetric_10k", "headline", dict(symmetric=True)),
    ("nonsymmetric_12288", "sibling", dict(symmetric=False)),
    ("dense_output_10k", "headline", dict(output_format="dense")),
)

# The BSR path's requests: (label, B operand, keywords, kernels it must launch).
BSR_REQUESTS = (
    ("bsr_x_bsr_8192", "b", dict(), ("bsr_bsr_matmul_dense",)),
    ("bsr_x_bsr_symmetric_8192", "b", dict(symmetric=True),
     ("bsr_bsr_matmul_dense", "dense_to_csr_triu")),
    ("bsr_x_dense_8192", "bu", dict(), ("csr_to_dense", "bsr_matmul_dense")),
    ("bsr_dense_output_8192", "b", dict(output_format="dense"), ("bsr_bsr_matmul_dense",)),
)


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def phase(name: str, t0: float, detail: str) -> None:
    print(f"[{name}] {detail} ({time.perf_counter() - t0:.2f} s)", flush=True)


def event_ms(fn, runs: int = KERNEL_RUNS) -> float:
    """Warm, then the minimum over ``runs`` of CUDA-event time around ``fn``."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def wall_s(fn, runs: int = PATH_RUNS) -> float:
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def operands(n: int, density: float, seeds):
    return [sp.random(n, n, density=density, format="csr", random_state=s) for s in seeds]


def same_csr(got, ref, what: str) -> float:
    """Identical structure and values within the oracle; returns max |diff|."""
    got = got.tocsr()
    ref = ref.tocsr()
    ref.sort_indices()
    require(got.shape == ref.shape, f"{what}: shape {got.shape} != {ref.shape}")
    require(got.nnz == ref.nnz, f"{what}: nnz {got.nnz} != {ref.nnz}")
    require(np.array_equal(got.indptr, ref.indptr), f"{what}: indptr differs")
    require(np.array_equal(got.indices, ref.indices), f"{what}: indices differ")
    require(np.allclose(got.data, ref.data, rtol=RTOL, atol=ATOL), f"{what}: values outside oracle")
    return float(np.abs(got.data - ref.data).max()) if got.nnz else 0.0


def block_sparse(seed: int):
    """BSR_N^2 scipy CSR with BSR_OCC of its BSR_BLOCK^2 blocks occupied, each
    dense with standard-normal f32 values (benchmarks/run.py:579-596)."""
    nb = BSR_N // BSR_BLOCK
    r = np.random.default_rng(seed)
    bi, bj = np.nonzero(r.random((nb, nb)) < BSR_OCC)
    blocks = r.standard_normal((len(bi), BSR_BLOCK, BSR_BLOCK)).astype(np.float32)
    shape3 = blocks.shape
    rows = np.broadcast_to(bi[:, None, None] * BSR_BLOCK + np.arange(BSR_BLOCK)[None, :, None],
                           shape3).ravel()
    cols = np.broadcast_to(bj[:, None, None] * BSR_BLOCK + np.arange(BSR_BLOCK)[None, None, :],
                           shape3).ravel()
    return sp.coo_matrix((blocks.ravel(), (rows, cols)), shape=(BSR_N, BSR_N)).tocsr()


def abs_bsr(m):
    return smt.BSRMatrix(indptr=m.indptr, indices=m.indices, blocks=m.blocks.abs(), shape=m.shape)


def csr_on_card(mat) -> torch.Tensor:
    """Dense f64 tensor of a scipy CSR on the card (scipy's own row ids)."""
    coo = mat.tocoo()
    dense = torch.zeros(mat.shape, dtype=torch.float64, device=DEVICE)
    rows = torch.from_numpy(coo.row.astype(np.int64)).to(DEVICE)
    cols = torch.from_numpy(coo.col.astype(np.int64)).to(DEVICE)
    dense[rows, cols] = torch.from_numpy(coo.data.astype(np.float64)).to(DEVICE)
    return dense


def compare_extract(c: torch.Tensor, triu: bool):
    """Kernel K2/K4 against the plain version on one matrix: both times, the
    nnz and the largest difference of the values."""
    nnz = int(torch.count_nonzero(torch.triu(c) if triu else c))
    cap = smt.bucket_capacity(nnz)
    got = ck.dense_to_csr(c, cap, triu=triu)
    ref = ck.dense_to_csr_plain(c, cap, triu=triu)
    for g, r, field in zip(got, ref, ("indptr", "indices", "values")):
        require(torch.equal(g, r), f"{'K2' if triu else 'K4'} {field} differs from plain")
    require(int(got[0][-1]) == nnz, "extraction lost entries")
    err = float((got[2] - ref[2]).abs().max())
    ms = event_ms(lambda: ck.dense_to_csr(c, cap, triu=triu))
    plain_ms = event_ms(lambda: ck.dense_to_csr_plain(c, cap, triu=triu))
    return dict(ms=ms, plain_ms=plain_ms, nnz=nnz, max_abs_err=err)


def device_busy_s(fn):
    """(device time, wall time) of one profiled call of ``fn``.  The device
    time sums the kernels and copies the profiler traced (0.0 when it saw no
    device activity); the wall time is taken inside the profiled region, so
    the profiler's own start and stop are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    # The device events themselves, as the profiler's own table totals them.
    total_us = sum(e.self_device_time_total for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    return total_us / 1e6, wall


def stage_times(a_sp, b_sp) -> dict:
    """Host-clock seconds of each stage of the headline sparse_matrix_multiply,
    calling in order the functions its dense route calls; min of PATH_RUNS + 1.
    ``_fetch_full_triu`` is timed whole and, apart, its device extraction (K2)
    and its values download; its host index rebuild is the rest."""
    best = {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best[key] = min(best.get(key, float("inf")), time.perf_counter() - t)
        return out

    for _ in range(PATH_RUNS + 1):
        timed("router_expansion_size",
              lambda: expansion_size(a_sp.indices, a_sp.nnz, b_sp.indptr))
        timed("router_bsr_occupancy_scan", lambda: api._bsr_route_ok(a_sp, DEVICE))
        dtype, _ = api._upload_dtype(a_sp, b_sp, DEVICE)
        a, b = timed("upload_from_scipy_a_b",
                     lambda: (smt.from_scipy(a_sp, dtype=dtype, device=DEVICE),
                              smt.from_scipy(b_sp, dtype=dtype, device=DEVICE)))
        c = timed("product_k3x2_k1_triu", lambda: spgemm_dense_out(a, b, symmetric=True))
        nnz = timed("count_nonzero_fetch", lambda: int(torch.count_nonzero(c)))
        csr = timed("fetch_part_extract_k2",
                    lambda: api._extract_csr(c, smt.bucket_capacity(nnz), symmetric=True))
        timed("fetch_part_values_d2h_f64",
              lambda: fetch_np(csr.values[:nnz]).astype(np.float64))
        del csr
        timed("fetch_full_triu_total", lambda: api._fetch_full_triu(c, nnz))
        del a, b, c
    best["fetch_part_index_rebuild_by_difference"] = (
        best["fetch_full_triu_total"] - best["fetch_part_extract_k2"]
        - best["fetch_part_values_d2h_f64"])
    return best


def bsr_stage_times(a_sp, b_sp):
    """Host-clock seconds of each stage of the BSR route of
    sparse_matrix_multiply(a_sp, b_sp) (request 1: K6, then the extraction
    its byte rule picks), calling in order the functions the route calls;
    min of PATH_RUNS + 1.  Returns the times and the extraction used."""
    best = {}
    bsz = smt.get_config().block_size

    def timed(key, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best[key] = min(best.get(key, float("inf")), time.perf_counter() - t)
        return out

    def occupancies():
        return api._bsr_route_ok(a_sp, DEVICE), api.block_occupancy(b_sp, bsz)

    def plan():
        bs_a, bs_b = _tobsr_padded(a_sp, bsz), _tobsr_padded(b_sp, bsz)
        return bs_a, bs_b, kb.bsr_pair_plan(a_sp, b_sp, bsz, bs_a=bs_a, bs_b=bs_b)

    def upload(bs_a, bs_b, p):
        a = smt.bsr_from_scipy(a_sp, bsz, torch.float32, padded_bsr=bs_a, device=DEVICE)
        b = smt.bsr_from_scipy(b_sp, bsz, torch.float32, padded_bsr=bs_b, device=DEVICE)
        n = p["n_pairs"]
        tables = [torch.from_numpy(p[k][:n]).to(DEVICE) for k in ("pa", "pb", "ci", "cj", "first")]
        return a, b, tables, torch.from_numpy(p["mask"]).to(DEVICE)

    for _ in range(PATH_RUNS + 1):
        timed("occupancy_scans_a_b", occupancies)
        bs_a, bs_b, p = timed("tobsr_a_b_and_pair_plan", plan)
        a, b, tables, mask = timed("upload_blocks_and_plan", lambda: upload(bs_a, bs_b, p))
        c = timed("product_k6", lambda: kb.bsr_bsr_matmul_dense(a, b, *tables, mask))
        nnz = timed("count_nonzero_fetch", lambda: int(torch.count_nonzero(c)))
        m, n = c.shape
        if m * n * c.element_size() < (4 + c.element_size()) * fine_capacity(nnz):
            extraction = "host packing"
            timed("download_and_host_pack", lambda: fetch_dense_to_csr(c, nnz=nnz))
        else:
            extraction = "K4"
            csr = timed("extract_k4", lambda: api._extract_csr(c, smt.bucket_capacity(nnz)))
            timed("download_to_scipy", lambda: smt.to_scipy(csr))
            del csr
        del a, b, tables, mask, c
    return best, extraction


def bsr_kernels(a_sp, b_sp, bu_sp) -> dict:
    """K6 (A x B over the pair plan) and K5 (A x densified B_u) against their
    plain versions, at the BSR path's shapes."""
    bsz = BSR_BLOCK
    bs_a, bs_b = _tobsr_padded(a_sp, bsz), _tobsr_padded(b_sp, bsz)
    a = smt.bsr_from_scipy(a_sp, bsz, torch.float32, padded_bsr=bs_a, device=DEVICE)
    b = smt.bsr_from_scipy(b_sp, bsz, torch.float32, padded_bsr=bs_b, device=DEVICE)
    plan = kb.bsr_pair_plan(a_sp, b_sp, bsz, bs_a=bs_a, bs_b=bs_b)
    n = plan["n_pairs"]
    tables = [torch.from_numpy(plan[k][:n]).to(DEVICE) for k in ("pa", "pb", "ci", "cj", "first")]
    mask = torch.from_numpy(plan["mask"]).to(DEVICE)
    abs_a = smt.bsr_to_dense(abs_bsr(a)).double()
    out = {}

    got = kb.bsr_bsr_matmul_dense(a, b, *tables, mask)
    plain = kb.bsr_bsr_matmul_dense_plain(a, b, *tables, mask)
    torch.cuda.synchronize()
    bound = RTOL * (abs_a @ smt.bsr_to_dense(abs_bsr(b)).double())
    err = (got.double() - plain.double()).abs()
    require(not bool(torch.isnan(got).any()), "K6 output holds NaN")
    require(bool((err <= bound).all()), "K6 outside 1e-5 of |A||B| against plain")
    visited = mask.repeat_interleave(bsz, 0).repeat_interleave(bsz, 1)[: a.shape[0], : b.shape[1]]
    require(bool((got[~visited] == 0).all()), "K6 wrote a block no pair visits")
    out["bsr_bsr_matmul_dense"] = dict(
        max_abs_err=float(err.max()),
        ms=event_ms(lambda: kb.bsr_bsr_matmul_dense(a, b, *tables, mask)),
        plain_ms=event_ms(lambda: kb.bsr_bsr_matmul_dense_plain(a, b, *tables, mask)),
        n_pairs=n, n_a_blocks=plan["n_a_blocks"], visited_blocks=int(plan["mask"].sum()),
        unvisited_zero=True)
    del got, plain, bound, err, visited

    bu = smt.from_scipy(bu_sp, dtype=torch.float32, device=DEVICE)
    bud = ck.csr_to_dense(bu.indptr, bu.indices, bu.values, bu.shape)
    got = kb.bsr_matmul_dense(a, bud)
    plain = kb.bsr_matmul_dense_plain(a, bud)
    torch.cuda.synchronize()
    bound = RTOL * (abs_a @ bud.abs().double())
    err = (got.double() - plain.double()).abs()
    require(bool((err <= bound).all()), "K5 outside 1e-5 of |A||B| against plain")
    empty = (a.indptr[1:] == a.indptr[:-1]).repeat_interleave(bsz)[: a.shape[0]]
    require(bool((got[empty] == 0).all()), "K5 left a row of an empty block-row non-zero")
    out["bsr_matmul_dense"] = dict(
        max_abs_err=float(err.max()),
        ms=event_ms(lambda: kb.bsr_matmul_dense(a, bud)),
        plain_ms=event_ms(lambda: kb.bsr_matmul_dense_plain(a, bud)),
        n_a_blocks=int(a.nblocks), empty_block_rows=int(empty.sum()) // bsz)
    return out


def check_bsr_result(label, got, oracle, bound) -> float:
    """A BSR-path result against the f64 oracle on the card: the same
    nonzero structure, values within 1e-5 * (|A| @ |B|); returns max |diff|."""
    got = torch.from_numpy(got).to(DEVICE) if isinstance(got, np.ndarray) else csr_on_card(got)
    require(tuple(got.shape) == tuple(oracle.shape), f"{label}: shape {tuple(got.shape)}")
    require(torch.equal(got != 0, oracle != 0), f"{label}: structure differs from the oracle")
    diff = (got - oracle).abs()
    require(bool((diff <= bound).all()), f"{label}: outside 1e-5 of |A||B| of the f64 oracle")
    return float(diff.max())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    # 1. card
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    phase("card", t0, f"{name} | nvidia-smi: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    _build.load()
    phase("build", t0, f"nvcc built {path}")

    # 3. kernels against their plain versions, at the main path's shapes
    t0 = time.perf_counter()
    a_sp, b_sp = operands(N, DENSITY, (1, 2))
    sa_sp, sb_sp = operands(SIB_N, SIB_DENSITY, (3, 4))
    a = smt.from_scipy(a_sp, dtype=torch.float32, device=DEVICE)
    b = smt.from_scipy(b_sp, dtype=torch.float32, device=DEVICE)
    report = {}

    ad = ck.csr_to_dense(a.indptr, a.indices, a.values, a.shape)
    bd = ck.csr_to_dense(b.indptr, b.indices, b.values, b.shape)
    k3_err = 0.0
    for got, m in ((ad, a), (bd, b)):
        plain = ck.csr_to_dense_plain(m.indptr, m.indices, m.values, m.shape)
        require(torch.equal(got, plain), "K3 differs from plain")
        k3_err = max(k3_err, float((got - plain).abs().max()))
    del plain
    report["csr_to_dense"] = dict(
        max_abs_err=k3_err,
        ms=event_ms(lambda: ck.csr_to_dense(a.indptr, a.indices, a.values, a.shape)),
        plain_ms=event_ms(lambda: ck.csr_to_dense_plain(a.indptr, a.indices, a.values, a.shape)),
    )

    c_kernel = torch.triu(tm.matmul_triu(ad, bd))
    c_plain = torch.triu(tm.matmul_triu_plain(ad, bd))
    bound = RTOL * torch.triu(torch.matmul(ad.abs(), bd.abs()))
    err = (c_kernel - c_plain).abs()
    require(bool((err <= bound).all()), "K1 outside rtol 1e-5 of |A||B| against plain")
    c_trans = torch.triu(tm.matmul_transpose_triu(ad, bd.T.contiguous()))
    require(torch.equal(c_trans, c_kernel), "K1 transpose_b differs from K1")
    report["matmul_triu"] = dict(
        max_abs_err=float(err.max()),
        ms=event_ms(lambda: tm.matmul_triu(ad, bd)),
        plain_ms=event_ms(lambda: tm.matmul_triu_plain(ad, bd)),
    )
    del c_plain, bound, err, c_trans

    # K2 at the headline's triangle (its main-path shape); K4 on the full 10k
    # product as an extra check.
    ext_10k_triu = compare_extract(c_kernel, triu=True)
    c_full = torch.matmul(ad, bd)
    ext_10k_full = compare_extract(c_full, triu=False)
    del c_full, c_kernel, ad, bd

    # K4 at its main-path shape (the ~36%-dense 12,288^2 product); K2 there too.
    sa = smt.from_scipy(sa_sp, dtype=torch.float32, device=DEVICE)
    sb = smt.from_scipy(sb_sp, dtype=torch.float32, device=DEVICE)
    c_sib = torch.matmul(csr_to_dense(sa), csr_to_dense(sb))
    ext_sib_triu = compare_extract(torch.triu(c_sib), triu=True)
    ext_sib_full = compare_extract(c_sib, triu=False)
    del c_sib, sa, sb
    report["dense_to_csr_triu"] = dict(
        max_abs_err=max(ext_10k_triu["max_abs_err"], ext_sib_triu["max_abs_err"]),
        ms=ext_10k_triu["ms"], plain_ms=ext_10k_triu["plain_ms"])
    report["dense_to_csr"] = dict(
        max_abs_err=max(ext_10k_full["max_abs_err"], ext_sib_full["max_abs_err"]),
        ms=ext_sib_full["ms"], plain_ms=ext_sib_full["plain_ms"])

    def ext(label, r):
        return f"{label} {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, nnz {r['nnz']})"

    phase("kernels", t0, " | ".join(
        [f"{KERNELS[k][0]}: {v['ms']:.3f} ms (plain {v['plain_ms']:.3f} ms)"
         for k, v in report.items() if k in ("csr_to_dense", "matmul_triu")]
        + [ext(f"K2 {N}^2 triu", ext_10k_triu), ext(f"K4 {N}^2 full", ext_10k_full),
           ext(f"K2 {SIB_N}^2 triu", ext_sib_triu),
           ext(f"K4 {SIB_N}^2 ({ext_sib_full['nnz'] / SIB_N**2:.3f} dense)", ext_sib_full)]))

    # 4. main path: the requests through the public entry point, counted
    t0 = time.perf_counter()
    ops = {"headline": (a_sp, b_sp), "sibling": (sa_sp, sb_sp)}
    results, routes, seconds, per_request = {}, {}, {}, {}
    reset_launches()
    for label, which, kw in MAIN_REQUESTS:
        before = dict(LAUNCHES)
        t = time.perf_counter()
        results[label] = smt.sparse_matrix_multiply(*ops[which], **kw)
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t
        routes[label] = smt.get_last_route()
        per_request[label] = {k: LAUNCHES[k] - before[k] for k in KERNELS}
    launches_main = dict(LAUNCHES)

    for label, route in routes.items():
        require(route == "dense", f"{label}: route {route!r} != 'dense'")
    for key in DENSE_PATH_KERNELS:
        require(launches_main[key] > 0, f"the main path launched no {KERNELS[key][0]}")
    require(launches_main["bsr_matmul_dense"] == launches_main["bsr_bsr_matmul_dense"] == 0,
            "the dense main path launched a BSR kernel")
    for key in ("matmul_triu", "dense_to_csr_triu", "csr_to_dense"):
        require(per_request["headline_symmetric_10k"][key] > 0,
                f"the headline request launched no {KERNELS[key][0]}")
    require(per_request["nonsymmetric_12288"]["dense_to_csr"] > 0,
            "the non-symmetric request launched no K4")

    c_sp = results.pop("headline_symmetric_10k")
    require(c_sp.nnz == N * (N + 1) // 2, f"nnz {c_sp.nnz} != {N * (N + 1) // 2}")
    a64 = torch.from_numpy(a_sp.toarray()).to(DEVICE)
    b64 = torch.from_numpy(b_sp.toarray()).to(DEVICE)
    oracle_full = torch.matmul(a64, b64)
    del a64, b64
    oracle = torch.triu(oracle_full)
    got = csr_on_card(c_sp)
    require(torch.equal(got != 0, oracle != 0), "headline structure differs from the oracle")
    require(torch.allclose(got, oracle, rtol=RTOL, atol=ATOL), "headline outside the oracle")
    max_rel = float(((got - oracle).abs() / oracle.abs().clamp_min(1e-300)).max())
    del got, oracle, c_sp

    sib_ref = (sa_sp @ sb_sp).tocsr()
    nonsym = results.pop("nonsymmetric_12288")
    nonsym_err = same_csr(nonsym, sib_ref, "non-symmetric request")
    nonsym_nnz = nonsym.nnz
    del nonsym

    dense_t = torch.from_numpy(results.pop("dense_output_10k")).to(DEVICE)
    require(torch.allclose(dense_t, oracle_full, rtol=RTOL, atol=ATOL), "dense output outside oracle")
    dense_err = float((dense_t - oracle_full).abs().max())
    del dense_t, oracle_full
    phase("main", t0, " | ".join([
        f"headline {N}^2 d={DENSITY} symmetric: nnz {N * (N + 1) // 2}, max rel err vs f64 "
        f"oracle {max_rel:.3e}, first call {seconds['headline_symmetric_10k']:.3f} s",
        f"non-symmetric {SIB_N}^2 d={SIB_DENSITY}: nnz {nonsym_nnz} "
        f"({nonsym_nnz / SIB_N**2:.3f} dense), max abs err {nonsym_err:.2e}, "
        f"{seconds['nonsymmetric_12288']:.3f} s",
        f"dense output {N}^2: max abs err {dense_err:.2e}, {seconds['dense_output_10k']:.3f} s",
        f"routes {routes}", f"launches by request {per_request}", f"launches {launches_main}"]))

    # 5. sibling: symmetric sparse output at 12,288^2 (K2 on a ~36%-dense product)
    t0 = time.perf_counter()
    got = smt.sparse_matrix_multiply(sa_sp, sb_sp, symmetric=True)
    require(smt.get_last_route() == "dense", f"sibling route {smt.get_last_route()!r}")
    sib_err = same_csr(got, sp.triu(sib_ref, format="csr"), "symmetric sibling")
    phase("sibling", t0, f"symmetric {SIB_N}^2: nnz {got.nnz} ({got.nnz / SIB_N**2:.3f} of "
          f"{SIB_N}^2), max abs err {sib_err:.2e}")
    del got, sib_ref

    # 6. device-resident and end-to-end timing at the headline, and its stages
    t0 = time.perf_counter()
    cap = smt.bucket_capacity(N * (N + 1) // 2)
    t_dev = wall_s(lambda: smt.multiply(a, b, output_format="sparse", symmetric=True,
                                        out_capacity=cap))
    t_e2e = wall_s(lambda: smt.sparse_matrix_multiply(a_sp, b_sp, symmetric=True))
    nnz_c = N * (N + 1) // 2
    busy, t_prof = device_busy_s(lambda: smt.sparse_matrix_multiply(a_sp, b_sp, symmetric=True))
    idle = f"{1 - busy / t_prof:.4f}" if busy > 0 else "not measured (no device time traced)"
    stages = stage_times(a_sp, b_sp)
    phase("timing", t0, f"{name} [{smi}]: multiply(sparse, symmetric) device-resident "
          f"{t_dev:.4f} s = {nnz_c / t_dev:.4e} nnz(C)/s | sparse_matrix_multiply end to end "
          f"{t_e2e:.4f} s = {nnz_c / t_e2e:.4e} nnz(C)/s | profiled call: device busy "
          f"{busy:.4f} s of {t_prof:.4f} s wall, idle share {idle} | peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print("[stages] headline sparse_matrix_multiply, host clock, min of "
          f"{PATH_RUNS + 1}: " + json.dumps(stages),
          flush=True)

    del a, b

    # 7. BSR kernels against their plain versions, at the BSR path's shapes
    t0 = time.perf_counter()
    a_bsp, b_bsp = (block_sparse(s) for s in BSR_SEEDS)
    bu_sp = sp.random(BSR_N, BSR_N, density=BU_DENSITY, format="csr", random_state=BU_SEED)
    bsr_report = bsr_kernels(a_bsp, b_bsp, bu_sp)
    report.update(bsr_report)
    k5, k6 = bsr_report["bsr_matmul_dense"], bsr_report["bsr_bsr_matmul_dense"]
    phase("bsr-kernels", t0, f"{BSR_N}^2, {BSR_BLOCK}^2 blocks: K6 {k6['ms']:.3f} ms (plain "
          f"{k6['plain_ms']:.3f}; {k6['n_pairs']} pairs, {k6['visited_blocks']} of "
          f"{(BSR_N // BSR_BLOCK) ** 2} output blocks visited, the rest exactly 0; max abs err "
          f"{k6['max_abs_err']:.2e}) | K5 {k5['ms']:.3f} ms (plain {k5['plain_ms']:.3f}; "
          f"{k5['n_a_blocks']} A blocks, {k5['empty_block_rows']} empty block-rows; max abs err "
          f"{k5['max_abs_err']:.2e})")

    # 8. BSR path: the requests through the public entry point, counted
    t0 = time.perf_counter()
    bsr_b = {"b": b_bsp, "bu": bu_sp}
    bsr_results, bsr_routes, bsr_seconds, bsr_per_request = {}, {}, {}, {}
    reset_launches()
    for label, which, kw, _ in BSR_REQUESTS:
        before = dict(LAUNCHES)
        t = time.perf_counter()
        bsr_results[label] = smt.sparse_matrix_multiply(a_bsp, bsr_b[which], **kw)
        torch.cuda.synchronize()
        bsr_seconds[label] = time.perf_counter() - t
        bsr_routes[label] = smt.get_last_route()
        bsr_per_request[label] = {k: LAUNCHES[k] - before[k] for k in KERNELS}
    launches_bsr = dict(LAUNCHES)

    for label, _, _, expected in BSR_REQUESTS:
        require(bsr_routes[label] == "bsr", f"{label}: route {bsr_routes[label]!r} != 'bsr'")
        for key in expected:
            require(bsr_per_request[label][key] > 0, f"{label} launched no {KERNELS[key][0]}")
    extraction = ("K4" if bsr_per_request["bsr_x_bsr_8192"]["dense_to_csr"] > 0
                  else "host packing")

    a64 = csr_on_card(a_bsp)
    errs = {}
    for which in ("b", "bu"):
        b64 = csr_on_card(bsr_b[which])
        oracle = torch.matmul(a64, b64)
        bound = RTOL * torch.matmul(a64.abs(), b64.abs())
        del b64
        for label, w, kw, _ in BSR_REQUESTS:
            if w != which:
                continue
            sym = kw.get("symmetric", False)
            errs[label] = check_bsr_result(label, bsr_results.pop(label),
                                           torch.triu(oracle) if sym else oracle,
                                           torch.triu(bound) if sym else bound)
        del oracle, bound
    del a64
    phase("bsr-main", t0, " | ".join(
        [f"{label}: {errs[label]:.2e} max abs err vs f64 oracle, {bsr_seconds[label]:.3f} s"
         for label, _, _, _ in BSR_REQUESTS]
        + [f"bsr_x_bsr_8192 extracted by {extraction}", f"routes {bsr_routes}",
           f"launches by request {bsr_per_request}", f"launches {launches_bsr}"]))

    # 9. BSR route against the dense route end to end, and request 1's stages
    t0 = time.perf_counter()
    e2e = {}
    for label, which in (("bsr_x_bsr_8192", "b"), ("bsr_x_dense_8192", "bu")):
        e2e[label] = {"bsr": wall_s(lambda: smt.sparse_matrix_multiply(a_bsp, bsr_b[which]))}
        require(smt.get_last_route() == "bsr", f"{label}: timed call took another route")
        saved = smt.get_config()
        smt.set_config(use_bsr=False)
        try:
            e2e[label]["dense"] = wall_s(lambda: smt.sparse_matrix_multiply(a_bsp, bsr_b[which]))
            require(smt.get_last_route() == "dense", f"{label}: use_bsr=False did not go dense")
        finally:
            smt.set_config(saved)
    bsr_stages, stage_extraction = bsr_stage_times(a_bsp, b_bsp)
    phase("bsr-timing", t0, f"{name} [{smi}]: sparse_matrix_multiply end to end, host clock, "
          f"min of {PATH_RUNS}: " + " | ".join(
              f"{label} BSR route {t['bsr']:.4f} s, dense route (use_bsr=False) {t['dense']:.4f} s"
              for label, t in e2e.items()))
    print(f"[bsr-stages] bsr_x_bsr_8192 sparse_matrix_multiply ({stage_extraction} extraction), "
          f"host clock, min of {PATH_RUNS + 1}: " + json.dumps(bsr_stages), flush=True)

    kernels = []
    by_request = {**per_request, **bsr_per_request}
    for key, (kname, source, replaces) in KERNELS.items():
        r = report[key]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches_main[key] + launches_bsr[key],
            "launches_by_request": {label: n[key] for label, n in by_request.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
