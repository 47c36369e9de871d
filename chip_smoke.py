#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sparse_matrix_mult_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one line each:
  1. card    -- device name, nvidia-smi name/power limit, TF32 switched off;
  2. build   -- nvcc builds csrc/*.cu from the checkout (ptxas report shown),
                and the HGMMA (tensor-core) and UTMALDG (TMA) instructions of
                K1, K5 and K6 and the UBLKCP (bulk copy) instructions of K3
                and K7 are counted in the SASS (cuobjdump -sass);
  3. kernels -- each hand-written kernel against its plain PyTorch version
                on the card, at the shapes the main path gives it, with both
                times, the largest difference, the kernel's bound (bytes or
                operations at the card's peak) and the time of one PyTorch
                call computing the same function (library_ms, a yardstick
                the port never calls).  K3 bit for bit against its plain
                version and K8 at every shape the counted paths densify (the
                10k and 12,288^2 operands, B_u, the inversion's H and Q),
                each timed with K8 beside it, as a whole call and as the
                device's time alone (device_ms).  K1 in both branches (HIGHEST,
                split3) and both forms (A B, A B^T), each form bit-identical
                to the other, each within 1e-5 of (|A| |B|) of its plain
                version, split3's bits unlike HIGHEST's; K1's two splits
                and its GEMM alone timed in one window; the bf16 split K1
                starts with, bit for bit; K2 and K4 bit for bit against
                their plain version at every product the counted requests
                extract (each chunk's product of request (e) of phase 13
                among them; the BSR request's triangle in phase 7);
     split3-gate -- K1's branches against the f64 oracle at the three
                configurations of benchmarks/results_accuracy_tpu.json
                (split3's error at least twice HIGHEST's, which shows that
                split3 ran), and whether the split3 gate engages at each;
  4. main    -- the main path: three requests through sparse_matrix_multiply,
                with the launch counts zeroed just before and read just after:
                the headline (10,000^2, density 0.1, symmetric=True), a
                non-symmetric product at 12,288^2, density 0.006 (~36% dense,
                extracted by K4), and dense output at 10k.  Route "dense",
                launches per request, and each result against its oracle;
     fast    -- one counted request multiply(symmetric=True,
                precision="fast") at the headline: K1's split3 branch
                through the API, against the f64 oracle;
  5. sibling -- symmetric sparse output at 12,288^2 against scipy;
  6. timing  -- device-resident multiply() (also with precision="fast") and
                end-to-end sparse_matrix_multiply at 10k, warm, min of 3, one
                profiled call (device busy time), and the headline's time
                per stage;
  7. bsr-kernels -- K5 and K6 against their plain versions at the BSR
                path's shapes (8192^2, 128^2 blocks, 10% of them occupied):
                both times, the largest difference, unvisited blocks zero;
                each one's GEMM alone bit for bit its whole call's, each
                within 1e-6 of (|A| |B|) of the six passes of its pieces
                (split3's three passes shown outside that limit for K5),
                K6's run bounds bit for bit against their plain version, and
                each one's splits, K6's run check and each GEMM timed in one
                window;
  8. bsr-main -- the BSR path: four requests through sparse_matrix_multiply
                with block-sparse A, counts zeroed just before and read just
                after: A x B (K6), symmetric (K6, K2), A x uniform B_u (K3,
                split_bf16 x2, K5) and dense output (K6); each K6 request
                splits twice and checks its pair tables once.  Route "bsr",
                launches per request, and each result against an f64 oracle
                on the card;
  9. bsr-timing -- requests 1 and 3 end to end on the BSR route and, with
                use_bsr=False, on the dense route, warm, min of 3; and
                request 1's time per stage;
     bsr-crossover -- request 1's form (A x B, sparse output) with A at
                block occupancies 0.02, 0.05, 0.10 and 0.25 (B the 10% one),
                end to end on the BSR route (force_bsr) and on the dense
                route (use_bsr=False), min of 3 each;
 10. fused-kernels -- the fused conversions' path, counted: K7
                (dense_to_csr_fused) on the 12,288^2 sibling product and the
                full 10k headline product, K8 (csr_to_dense_fused) on the
                headline operand A and the packed sibling product; each bit
                for bit against its plain version and K4/K3, K7 the same at
                three lanes, and CUDA-event times beside K4's and K3's, K7
                and K4 also as the device's time alone (K7's by kernel is
                taken in phase 3, beside K4's on the same product);
 11. triple  -- the triple product H Q H^T through sparse_matrix_multiply
                (use_triple_product=True, compute_full_matrix 0 and 1; H the
                headline A, Q 10k^2 d=0.1), counted: route "triple", K3 x2,
                split_bf16 x2 and K1 per request, each result against an
                f64 oracle on the card; then (triple-timing, triple-stages)
                end to end and device-resident triple_product (also with
                precision="fast"), warm, min of 3, K1's transpose_b form in
                both branches against its plain version (as in phase 3) at
                the second contraction, and the time per stage;
 12. inversion -- invert and posterior_covariance at n_obs 4,096, n_state
                16,384, counted (K3 x4, split_bf16 x2 and K1 per call),
                against an f64 oracle on the card computed
                with torch.linalg (x_post, p_diag, S and the posterior
                covariance within 1e-3 of each one's largest entry), with
                kappa_2(S); then (inversion-timing) both warm, min of 3,
                and K1's transpose_b form in both branches against its plain
                version (as in phase 3) at the (T, H) the inversion gives it;
 13. esc-main -- the sparse-output ladder below the dense route: six
                requests through sparse_matrix_multiply on hypersparse
                operands (non-negative values), counted, each route checked:
                (a) 200,000^2 with nnz 2e6 per operand, plain and symmetric
                ("esc_binned"), (b) the same with use_binned_esc=False and
                esc_expand_limit 2^25 ("esc_windowed"), (c) 40,000 x 50,000
                with one entry per row times 50,000^2 at d = 0.002 ("esc"),
                (d) 1,000,000^2 with nnz 7e6 per operand ("esc_chunks", its
                chunk count shown), (e) 30,000 x 10,000 at d = 0.002 times
                10,000^2 at d = 0.01 ("dense_chunks": K3 and K4 per chunk);
                the ESC requests launch no hand kernel.  Each product
                against scipy's (identical structure, values within the
                oracle); (a) twice gives the same bits;
 14. esc-timing -- (a), (b) and (d) end to end, warm, min of 3, each
                call's bits against the first's, and the stages of the
                fastest call as the router timed them ([esc-stages], one
                line each: the binned and windowed routes side by side on
                the same operands); (a)'s engine's device time by kernel;
                and each engine
                device-resident (multiply(plan=...) at (a) and at
                1,000,000^2, d = 1e-5, ~1e8 partials; the windowed engine at
                (a), the classic at (c)): the plan's host time, the engine's
                CUDA-event time against its bound (A and B read once, C
                written once), the device busy share of one profiled call,
                the peak device memory, the product against spgemm_host's,
                and two yardsticks the port never calls: cuSPARSE SpGEMM
                (torch.sparse.mm of the CSR tensors) and the host OpenMP
                kernel spgemm_host.  Then one JSON line {"esc": ...}.

Then a JSON line of the kernels (launches summed over the seven counted paths;
K2, K3 and K4 also by shape: each product or operand of a counted request is
held against the plain version in phase 3 or 7, and its launches counted).  A kernel's "ms" is its whole call on an idle stream, the
wrapper's host work included; K2-K7 add "device_ms", the same call with a
spin kernel queued before it, which leaves the device's time alone, and K2,
K4, K6 and K7 "kernels_us", its device time by kernel.  Then
the nvidia-smi line, and last {"ok": true, "device": {...}}.  Any failed
check exits non-zero; without a CUDA device, or without the package beside
it, it exits non-zero before any result is printed.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

import sparse_matrix_mult_tpu_torch as smt
from sparse_matrix_mult_tpu_torch import api
from sparse_matrix_mult_tpu_torch.ops.convert import csr_to_dense
from sparse_matrix_mult_tpu_torch.ops.dense_path import _split3_within_oracle, spgemm_dense_out
from sparse_matrix_mult_tpu_torch.ops.kernels import LAUNCHES, _build, reset_launches
from sparse_matrix_mult_tpu_torch.ops.kernels import bsr_spgemm as kb
from sparse_matrix_mult_tpu_torch.ops.kernels import convert_kernels as ck
from sparse_matrix_mult_tpu_torch.ops.kernels import triu_matmul as tm
from sparse_matrix_mult_tpu_torch.ops.matmul import full_fp32
from sparse_matrix_mult_tpu_torch.ops.spgemm_binned import spgemm_esc_binned
from sparse_matrix_mult_tpu_torch.ops.spgemm_esc import windowed_plan
from sparse_matrix_mult_tpu_torch.models.inversion import invert, posterior_covariance
from sparse_matrix_mult_tpu_torch.types_bsr import _tobsr_padded
from sparse_matrix_mult_tpu_torch.utils.native import (
    expansion_size, spgemm_host)
from sparse_matrix_mult_tpu_torch.utils.testing import hypersparse_random
from sparse_matrix_mult_tpu_torch.utils.transfer import (
    fetch_dense_to_csr, fetch_np, fine_capacity)

N, DENSITY = 10_000, 0.1  # the reference's headline configuration (bench.py)
SIB_N, SIB_DENSITY = 12_288, 0.006  # dense route, ~36% dense product
# BSR route: the block-structured operands of benchmarks/run.py:573-596
# (8192^2, 128^2 blocks, 10% occupied, dense standard-normal blocks), and a
# uniformly sparse B_u whose every block is occupied.
BSR_N, BSR_BLOCK, BSR_OCC, BSR_SEEDS = 8192, 128, 0.10, (21, 22)
CROSSOVER_OCCS = (0.02, 0.05, 0.10, 0.25)  # A's block occupancies of the crossover phase
BU_DENSITY, BU_SEED = 0.01, 23
FUSED_LANES = (2048, 8192, 16384)  # K7 must give the same output at each
TRIPLE_Q_SEED = 3  # Q of the triple product: N^2, DENSITY (benchmarks/run.py:275-277)
# Inversion-shaped problem (n_obs << n_state): H d=0.05, Q from A d=0.002.
INV_OBS, INV_STATE, INV_H_DENSITY, INV_Q_DENSITY, INV_SEED = 4096, 16_384, 0.05, 0.002, 31
INV_TOL = 1e-3  # |got - ref|_inf <= INV_TOL * |ref|_inf, float32 against the f64 oracle
RTOL, ATOL = 1e-5, 1e-8  # the reference's oracle tolerance
# The sparse-output ladder (phases 13-14), each request's operands from
# hypersparse_random.  (a) 200,000^2, nnz 2e6 each (benchmarks/run.py:305-308):
# ~2e7 partials, "esc_binned"; (b) the same with use_binned_esc=False and
# esc_expand_limit raised to ESC_WINDOWED_LIMIT: "esc_windowed"; (c) one
# entry per row of a 40,000 x 50,000 A times B 50,000^2 at d = 0.002 (~4e6
# partials, B rows of ~100 entries: no window qualifies): "esc"; (d)
# 1,000,000^2, nnz 7e6 each (~4.9e7 partials, past the binned budget):
# "esc_chunks"; (e) 30,000 x 10,000 at d = 0.002 times 10,000^2 at d = 0.01
# (m n past dense_path_limit, k n inside it, ~6e7 partials): "dense_chunks".
# Device-resident timing also at 1,000,000^2, d = 1e-5 (~1e8 partials, the
# single_chip row of benchmarks/results_large_sparse_cpu.json).
ESC_N, ESC_NNZ, ESC_SEEDS = 200_000, 2_000_000, (11, 12)
ESC_WINDOWED_LIMIT = 1 << 25
CLASSIC_M, CLASSIC_K, CLASSIC_B_NNZ, CLASSIC_SEEDS = 40_000, 50_000, 5_000_000, (13, 14)
CHUNKS_N, CHUNKS_NNZ, CHUNKS_SEEDS = 1_000_000, 7_000_000, (15, 16)
DCHUNKS_M, DCHUNKS_K, DCHUNKS_A_NNZ, DCHUNKS_B_NNZ = 30_000, 10_000, 600_000, 1_000_000
DCHUNKS_SEEDS = (17, 18)
HYPER_N, HYPER_NNZ, HYPER_SEEDS = 1_000_000, 10_000_000, (19, 20)
# K1's branches; each is held to RTOL * (|A| |B|) of its plain version.  Their
# own distance (~3e-6 of |A| |B| at 10k) is inside the noise of that
# comparison (~9e-7), so what shows that split3 ran is that its bits differ
# from HIGHEST's and that its f64-oracle error is well above HIGHEST's (3b).
K1_BRANCHES = ("highest", "split3")
SPLIT3_ERR_RATIO = 2.0  # split3's max rel err vs f64 at least this times HIGHEST's
# K5 and K6 against the six passes of their own pieces, in units of |A| |B|
# (K5's K ~ 830: f32 rounding is far below it, the three passes of split3
# ~3e-6 above it).
K5_PIECES_TOL = 1e-6
# K1's split3 branch against the f64 oracle at the configurations of
# benchmarks/results_accuracy_tpu.json (seeds 1 and 2, as benchmarks/accuracy.py).
SPLIT3_CONFIGS = ((500, 0.3), (2000, 0.05), (N, DENSITY))
# One H100 SXM at 700 W (NVIDIA's data sheet): device memory rate,
# and the dense peaks of bf16 on the tensor cores and of FP32 on the CUDA cores.
# The tensor-core kernels (K1, K5) and K6 are held to the bf16 rate of the
# passes their function needs at HIGHEST: six per f32 product.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
KERNEL_RUNS = 5
SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's clock, longer than any wrapper's host work (device_ms)
PATH_RUNS = 3
DEVICE = "cuda"

KERNELS = {
    # launch-counter key: (name, source, replaced TPU kernel)
    "matmul_triu": ("K1 matmul_triu", "sparse_matrix_mult_tpu_torch/csrc/triu_matmul.cu",
                    "sparse_matrix_mult_tpu/ops/pallas/triu_matmul.py:58"),
    "split_bf16": ("split_bf16 (K1's operand split)",
                   "sparse_matrix_mult_tpu_torch/csrc/triu_matmul.cu",
                   "sparse_matrix_mult_tpu/ops/pallas/triu_matmul.py:71"),
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
    "bsr_pair_runs": ("bsr_pair_runs (K6's table check and run bounds)",
                      "sparse_matrix_mult_tpu_torch/csrc/bsr_spgemm.cu",
                      "sparse_matrix_mult_tpu/ops/pallas/bsr_spgemm.py:196"),
    "dense_to_csr_fused": ("K7 dense_to_csr_fused",
                           "sparse_matrix_mult_tpu_torch/csrc/convert_fused.cu",
                           "sparse_matrix_mult_tpu/ops/pallas/convert_kernels.py:617"),
    "csr_to_dense_fused": ("K8 csr_to_dense_fused",
                           "sparse_matrix_mult_tpu_torch/csrc/convert_fused.cu",
                           "sparse_matrix_mult_tpu/ops/pallas/convert_kernels.py:736"),
}
DENSE_PATH_KERNELS = ("matmul_triu", "split_bf16", "dense_to_csr_triu", "csr_to_dense",
                      "dense_to_csr")
FAST_LABEL = f"multiply_fast_symmetric_{N}"  # the explicit-FAST request (K1's split3 branch)

# The main path's requests: (label, operands, sparse_matrix_multiply keywords).
MAIN_REQUESTS = (
    ("headline_symmetric_10k", "headline", dict(symmetric=True)),
    ("nonsymmetric_12288", "sibling", dict(symmetric=False)),
    ("dense_output_10k", "headline", dict(output_format="dense")),
)

# The BSR path's requests: (label, B operand, keywords, kernels it must launch).
K6_PATH = ("split_bf16", "bsr_pair_runs", "bsr_bsr_matmul_dense")  # a K6 call's kernels
BSR_REQUESTS = (
    ("bsr_x_bsr_8192", "b", dict(), K6_PATH),
    ("bsr_x_bsr_symmetric_8192", "b", dict(symmetric=True), K6_PATH + ("dense_to_csr_triu",)),
    ("bsr_x_dense_8192", "bu", dict(), ("csr_to_dense", "split_bf16", "bsr_matmul_dense")),
    ("bsr_dense_output_8192", "b", dict(output_format="dense"), K6_PATH),
)


# The ladder's requests: (label, operands, keywords, Config keywords, route).
ESC_REQUESTS = (
    ("esc_binned_a", "esc", dict(), dict(), "esc_binned"),
    ("esc_binned_symmetric_a", "esc", dict(symmetric=True), dict(), "esc_binned"),
    ("esc_windowed_b", "esc", dict(), dict(use_binned_esc=False, esc_expand_limit=ESC_WINDOWED_LIMIT),
     "esc_windowed"),
    ("esc_classic_c", "classic", dict(), dict(use_binned_esc=False), "esc"),
    ("esc_chunks_d", "chunks", dict(), dict(), "esc_chunks"),
    ("dense_chunks_e", "dchunks", dict(), dict(), "dense_chunks"),
)
# The ladder's requests timed end to end with their stages (phase 14): the
# binned and windowed routes on the same operands side by side, and the chunks.
TIMED_ESC = ("esc_binned_a", "esc_windowed_b", "esc_chunks_d")

K3_OPERAND_10K, K3_SIBLING, K3_BU = f"operand_{N}", f"sibling_operand_{SIB_N}", f"bu_{BSR_N}"
K3_INV_H, K3_INV_Q = f"inversion_h_{INV_OBS}x{INV_STATE}", f"inversion_q_{INV_STATE}"
# The dense-chunks request (e) densifies B once per chunk and each chunk of A.
K3_DCHUNK_B, K3_DCHUNK_A = f"dense_chunks_b_{DCHUNKS_K}", "dense_chunks_a_rows_{}_{}"


# The products K2 and K4 extract in the counted requests, by the labels of
# their shapes (phases 3 and 7).
K2_HEADLINE, K2_BSR = f"headline_triu_{N}", f"bsr_symmetric_triu_{BSR_N}"
K4_SIBLING, K4_DCHUNK = f"sibling_product_{SIB_N}", "dense_chunks_product_rows_{}_{}"


def extract_operands() -> dict:
    """By kernel key, the products K2 and K4 extract in each counted request,
    in order (the dense-chunks request (e) extracts each chunk's product)."""
    return {
        "dense_to_csr_triu": {"headline_symmetric_10k": (K2_HEADLINE,),
                              "bsr_x_bsr_symmetric_8192": (K2_BSR,)},
        "dense_to_csr": {
            "nonsymmetric_12288": (K4_SIBLING,),
            "dense_chunks_e": tuple(K4_DCHUNK.format(start, stop) for start, stop in
                                    dense_chunk_bounds(dense_chunks_operands()[0], DCHUNKS_K))},
    }


def k3_operands() -> dict:
    """The operands K3 densifies in each counted request, in order, by the
    labels of phase 3's K3 shapes (the triple product's H is the headline A
    and its Q a 10k^2 d=0.1 matrix too; each inversion call densifies H and
    Q twice)."""
    return {
        "headline_symmetric_10k": (K3_OPERAND_10K,) * 2,
        "nonsymmetric_12288": (K3_SIBLING,) * 2,
        "dense_output_10k": (K3_OPERAND_10K,) * 2,
        FAST_LABEL: (K3_OPERAND_10K,) * 2,
        "bsr_x_dense_8192": (K3_BU,),
        **{f"triple_{N}_full{cfm}": (K3_OPERAND_10K,) * 2 for cfm in (0, 1)},
        **{f"{call}_{INV_OBS}x{INV_STATE}": (K3_INV_H, K3_INV_Q) * 2
           for call in ("invert", "posterior_covariance")},
        "dense_chunks_e": tuple(
            label for start, stop in dense_chunk_bounds(dense_chunks_operands()[0], DCHUNKS_K)
            for label in (K3_DCHUNK_A.format(start, stop), K3_DCHUNK_B)),
    }


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def phase(name: str, t0: float, detail: str) -> None:
    print(f"[{name}] {detail} ({time.perf_counter() - t0:.2f} s)", flush=True)


def event_ms(fn, runs: int = KERNEL_RUNS, queued: bool = False) -> float:
    """Warm, then the minimum over ``runs`` of CUDA-event time around ``fn``
    on an idle stream: the time of the whole call, its wrapper's host work
    (checks, allocation, the launch call) included.  With ``queued``, a spin
    kernel queued before the start event keeps the stream busy while that
    host work runs, so the time is the device's alone (``device_ms``)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def roofline(nbytes: float, flops: float = 0.0, peak: str = "fp32") -> dict:
    """The least time the card could take for a function: the larger of its
    bytes (each input read once, each output written once) over the memory
    rate and its operations over the peak rate of their type."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[peak] * 1e3
    if by_ops > by_bytes:
        return dict(bound_ms=by_ops, bound_by="operations")
    return dict(bound_ms=by_bytes, bound_by="bytes")


def timing(r: dict) -> str:
    """A kernel's time beside its bound, share of it, plain and library times."""
    lib = "none" if r.get("library_ms") is None else f"{r['library_ms']:.3f}"
    return (f"{r['ms']:.3f} ms (bound {r['bound_ms']:.3f} ms by {r['bound_by']}, "
            f"{r['bound_ms'] / r['ms']:.1%} of it; plain {r['plain_ms']:.3f}; library {lib})")


def fp32_matmul(x, y):
    with full_fp32():
        return torch.matmul(x, y)


def k1_bound(m: int, n: int, k: int, split3: bool) -> dict:
    """K1's bound: its bf16 passes (3 or 6) over the upper tile pairs at the
    bf16 peak, or its f32 operands read and upper tiles written."""
    nti, ntj = -(-m // tm.TILE), -(-n // tm.TILE)
    rows = [min(tm.TILE, m - i * tm.TILE) for i in range(nti)]
    cols = [min(tm.TILE, n - j * tm.TILE) for j in range(ntj)]
    written = sum(rows[i] * sum(cols[i:]) for i in range(min(nti, ntj)))
    flops = 2.0 * written * k * (3 if split3 else 6)
    return dict(roofline(4.0 * (m * k + k * n + written), flops, "bf16"),
                flops_f32=2.0 * written * k)


def k1_against_plain(a, b, transpose_b: bool = False):
    """K1's two branches on (a, b) against their plain versions on the upper
    triangle, within RTOL of (|a| |b|); split3's bits must differ from
    HIGHEST's.  Returns each branch's upper triangle, and its max |kernel -
    plain| and the largest share of (|a| |b|) that reaches."""
    unit = torch.triu(fp32_matmul(a.abs(), (b.T if transpose_b else b).abs())).clamp_min(1e-30)
    got, errs = {}, {}
    for branch in K1_BRANCHES:
        split3 = branch == "split3"
        c = torch.triu(tm.matmul_triu(a, b, transpose_b, split3))
        err = (c - torch.triu(tm.matmul_triu_plain(a, b, transpose_b, split3))).abs()
        require(bool((err <= RTOL * unit).all()),
                f"K1 {branch} {tuple(a.shape)}x{tuple(b.shape)} transpose_b={transpose_b}: "
                f"outside {RTOL} of |A||B| against plain")
        got[branch] = c
        errs[branch] = dict(max_abs_err=float(err.max()), max_err_of_unit=float((err / unit).max()))
        del err
    require(not torch.equal(got["highest"], got["split3"]), "K1's split3 gave HIGHEST's bits")
    return got, errs


def k1_timed(a, b, transpose_b: bool, split3: bool, library_ms: float, m: int, n: int,
             k: int) -> dict:
    """K1's and its plain version's CUDA-event times, beside its bound and
    the library call's time."""
    return dict(ms=event_ms(lambda: tm.matmul_triu(a, b, transpose_b, split3)),
                plain_ms=event_ms(lambda: tm.matmul_triu_plain(a, b, transpose_b, split3)),
                library_ms=library_ms, **k1_bound(m, n, k, split3))


def csr_bytes(rows: int, nnz: int, elt: int = 4) -> int:
    """Bytes of a CSR matrix's indptr, and indices and values of ``nnz`` entries."""
    return 4 * (rows + 1) + (4 + elt) * nnz


def sparse_csr(ptr, idx, val, shape):
    """The torch.sparse CSR tensor of a padded CSR triple (a view, no copy)."""
    nnz = int(ptr[-1])
    return torch.sparse_csr_tensor(ptr, idx[:nnz], val[:nnz], size=tuple(shape))


SASS_OPS = ("HGMMA", "UTMALDG", "UBLKCP")  # tensor-core, TMA load, bulk copy


def sass_counts(path: str):
    """Counts of tensor-core (HGMMA), TMA (UTMALDG) and bulk-copy (UBLKCP)
    instructions in each compiled kernel of the library that has any, or
    None without cuobjdump."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    counts = {}
    for section in sass.split("Function : ")[1:]:
        found = {op: section.count(op) for op in SASS_OPS}
        if any(found.values()):
            counts[section.split(None, 1)[0]] = found
    return counts


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


def block_sparse(seed: int, occ: float = BSR_OCC):
    """BSR_N^2 scipy CSR with ``occ`` of its BSR_BLOCK^2 blocks occupied, each
    dense with standard-normal f32 values (benchmarks/run.py:579-596)."""
    nb = BSR_N // BSR_BLOCK
    r = np.random.default_rng(seed)
    bi, bj = np.nonzero(r.random((nb, nb)) < occ)
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


def kernel_device_us(fn, runs: int = 3) -> dict:
    """Device microseconds per call of ``fn``, by kernel (and copy), from
    ``torch.profiler``'s trace of ``runs`` warm calls: where a call's device
    time goes.  Each kernel's time is its mean over the launches the trace
    holds, times its launches per call: late in this long process the
    profiler was seen to drop a call's records (on an H100, one trace held
    one of three K7 launches and none of their memsets)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            # "void (anonymous namespace)::fill_rows<float, true>(float const*, ...)"
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
            name = name.removeprefix("void ").strip()
            per_call = max(1, round(e.count / runs))
            out[name] = out.get(name, 0.0) + e.device_time_total / e.count * per_call
    return out


def compare_extract(c: torch.Tensor, triu: bool):
    """Kernel K2/K4 against the plain version on one matrix: both times, the
    nnz and the largest difference of the values, the call's device time
    alone and by kernel."""
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
    lib = event_ms(lambda: (torch.triu(c) if triu else c).to_sparse_csr())
    m, n = c.shape
    read = m * (m + 1) // 2 if triu else m * n  # K2 reads the upper triangle only
    return dict(shape=[m, n], ms=ms, plain_ms=plain_ms, nnz=nnz, max_abs_err=err, library_ms=lib,
                device_ms=event_ms(lambda: ck.dense_to_csr(c, cap, triu=triu), queued=True),
                kernels_us=kernel_device_us(lambda: ck.dense_to_csr(c, cap, triu=triu)),
                **roofline(read * c.element_size() + csr_bytes(m, cap, c.element_size())))


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


def timed(best: dict, key: str, fn):
    """Run ``fn`` between two synchronisations and keep the least host-clock
    seconds seen under ``best[key]``; returns what ``fn`` returns."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    best[key] = min(best.get(key, float("inf")), time.perf_counter() - t)
    return out


def stage_times(a_sp, b_sp) -> dict:
    """Host-clock seconds of each stage of the headline sparse_matrix_multiply,
    calling in order the functions its dense route calls; min of PATH_RUNS + 1.
    ``_fetch_full_triu`` is timed whole and, apart, its device extraction (K2)
    and its values download; its host index rebuild is the rest."""
    best = {}
    for _ in range(PATH_RUNS + 1):
        timed(best, "router_expansion_size",
              lambda: expansion_size(a_sp.indices, a_sp.nnz, b_sp.indptr))
        timed(best, "router_bsr_occupancy_scan", lambda: api._bsr_route_ok(a_sp, DEVICE))
        dtype, _ = api._upload_dtype(a_sp, b_sp, DEVICE)
        a, b = timed(best, "upload_from_scipy_a_b",
                     lambda: (smt.from_scipy(a_sp, dtype=dtype, device=DEVICE),
                              smt.from_scipy(b_sp, dtype=dtype, device=DEVICE)))
        c = timed(best, "product_k3x2_k1_triu", lambda: spgemm_dense_out(a, b, symmetric=True))
        nnz = timed(best, "count_nonzero_fetch", lambda: int(torch.count_nonzero(c)))
        csr = timed(best, "fetch_part_extract_k2",
                    lambda: api._extract_csr(c, smt.bucket_capacity(nnz), symmetric=True))
        timed(best, "fetch_part_values_d2h_f64",
              lambda: fetch_np(csr.values[:nnz]).astype(np.float64))
        del csr
        timed(best, "fetch_full_triu_total", lambda: api._fetch_full_triu(c, nnz))
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
        timed(best, "occupancy_scans_a_b", occupancies)
        bs_a, bs_b, p = timed(best, "tobsr_a_b_and_pair_plan", plan)
        a, b, tables, mask = timed(best, "upload_blocks_and_plan", lambda: upload(bs_a, bs_b, p))
        c = timed(best, "product_k6", lambda: kb.bsr_bsr_matmul_dense(a, b, *tables, mask))
        nnz = timed(best, "count_nonzero_fetch", lambda: int(torch.count_nonzero(c)))
        m, n = c.shape
        if m * n * c.element_size() < (4 + c.element_size()) * fine_capacity(nnz):
            extraction = "host packing"
            timed(best, "download_and_host_pack", lambda: fetch_dense_to_csr(c, nnz=nnz))
        else:
            extraction = "K4"
            csr = timed(best, "extract_k4",
                        lambda: api._extract_csr(c, smt.bucket_capacity(nnz)))
            timed(best, "download_to_scipy", lambda: smt.to_scipy(csr))
            del csr
        del a, b, tables, mask, c
    return best, extraction


def split3_passes(ap, bp, a, n) -> torch.Tensor:
    """What a K5 that ran split3 would give: the three passes of its pieces
    whose orders sum below 2, summed in f32 over A's stored blocks."""
    k = a.shape[1]
    c = torch.zeros((a.shape[0], n), dtype=torch.float32, device=ap.device)
    blocks = ap.reshape(3, a.block_capacity, a.block_size, a.block_size).to(torch.float32)
    with full_fp32():
        for i in range(2):
            ai = smt.bsr_to_dense(dataclasses.replace(a, blocks=blocks[i]))
            for j in range(2 - i):
                c += torch.matmul(ai, bp[j, :n, :k].to(torch.float32).T)
    return c


def k6_gemm_alone(ap, bp, a, b, bounds, tables, mask, c, work):
    """K6's GEMM launched on its own (no run check, no host synchronisation),
    into ``c``, on run bounds already checked: what the wrapper launches
    last.  ``work``: its block counter, two zero int32 words (each launch
    leaves them zero).  For timing only; it counts no launch."""
    code = _build.load().smm_bsr_bsr_matmul_dense_bf16(
        bounds.data_ptr(), tables[0].data_ptr(), tables[1].data_ptr(), mask.data_ptr(),
        ap.data_ptr(), bp.data_ptr(), c.data_ptr(), work.data_ptr(), a.nbr, b.nbc,
        a.block_capacity, b.block_capacity, c.shape[0], c.shape[1], _build.stream_ptr(c.device))
    _build.check(code, "bsr_bsr_matmul_dense")


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
    del plain, visited
    # K6's run check bit for bit against its plain version; its GEMM alone on
    # the pieces gives K6's bits, within K5_PIECES_TOL of (|A| |B|) of the six
    # passes of those pieces.
    runs = kb.bsr_pair_runs(a, b, *tables[:4])
    runs_plain = kb.bsr_pair_runs_plain(a, b, *tables[:4])
    require(all(torch.equal(g, w) for g, w in zip(runs, runs_plain)) and int(runs[1]) == 0,
            "K6's run bounds differ from plain")
    ap, bp = kb.bsr_bsr_split(a, b)
    require(torch.equal(kb.bsr_bsr_matmul_dense_pieces(ap, bp, a, b, *tables, mask), got),
            "K6's GEMM alone differs from K6")
    abs_ab = bound / RTOL
    six = kb.bsr_bsr_matmul_dense_pieces_plain(ap, bp, a, b, *tables, mask)
    k6_pieces_rel = float(((got.double() - six.double()).abs() / abs_ab.clamp(min=1e-30)).max())
    require(k6_pieces_rel <= K5_PIECES_TOL,
            f"K6 {k6_pieces_rel:.2e} of |A||B| from the six passes of its pieces")
    del six, abs_ab
    block_bytes = 4 * bsz * bsz
    na, nb_b = int(a.nblocks), int(b.nblocks)
    k6_flops = 6 * 2.0 * n * bsz**3  # six bf16 passes of HIGHEST per pair
    c_gemm = torch.empty_like(got)
    work = torch.zeros(2, dtype=torch.int32, device=DEVICE)
    k6_parts = dict(
        split_a_ms=event_ms(lambda: tm.split_bf16(a.blocks.reshape(-1, bsz), 3)),
        split_b_ms=event_ms(lambda: tm.split_bf16(b.blocks.reshape(-1, bsz), 3, transpose=True)),
        runs_ms=event_ms(lambda: kb.bsr_pair_runs(a, b, *tables[:4])),
        gemm_ms=event_ms(lambda: k6_gemm_alone(ap, bp, a, b, runs[0], tables, mask, c_gemm,
                                                  work)),
        pieces_ms=event_ms(lambda: kb.bsr_bsr_matmul_dense_pieces(ap, bp, a, b, *tables, mask)),
        whole_ms=event_ms(lambda: kb.bsr_bsr_matmul_dense(a, b, *tables, mask)),
        gemm_bound_ms=roofline(2 * 3 * bsz * bsz * (na + nb_b) + 4 * a.shape[0] * b.shape[1],
                               k6_flops, "bf16")["bound_ms"])
    require(torch.equal(c_gemm, got), "K6's GEMM launched alone differs from K6")
    del ap, bp, c_gemm
    out["bsr_bsr_matmul_dense"] = dict(
        max_abs_err=float(err.max()),
        ms=event_ms(lambda: kb.bsr_bsr_matmul_dense(a, b, *tables, mask)),
        device_ms=event_ms(lambda: kb.bsr_bsr_matmul_dense(a, b, *tables, mask), queued=True),
        kernels_us=kernel_device_us(lambda: kb.bsr_bsr_matmul_dense(a, b, *tables, mask)),
        plain_ms=event_ms(lambda: kb.bsr_bsr_matmul_dense_plain(a, b, *tables, mask)),
        library_ms=None,  # PyTorch multiplies no two BSR matrices in one call
        **roofline(block_bytes * (na + nb_b) + 4 * a.shape[0] * b.shape[1], k6_flops, "bf16"),
        parts=k6_parts, pieces_rel_err=k6_pieces_rel,
        n_pairs=n, n_a_blocks=plan["n_a_blocks"], visited_blocks=int(plan["mask"].sum()),
        unvisited_zero=True)
    # The run check reads the four tables once and writes the bounds and flag.
    out["bsr_pair_runs"] = dict(
        max_abs_err=0.0, ms=k6_parts["runs_ms"],
        plain_ms=event_ms(lambda: kb.bsr_pair_runs_plain(a, b, *tables[:4])),
        library_ms=None,  # no one PyTorch call both checks the tables and finds the runs
        **roofline(16 * n + 4 * (a.nbr * b.nbc + 2)))
    del got, bound, err, runs, runs_plain

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
    # K5's parts in one window: the split of A's blocks, that of B (as
    # bsr_split makes them) and the GEMM alone on those pieces (K5's bits).
    ap, bp = kb.bsr_split(a, bud)
    n, k, nb = bud.shape[1], a.shape[1], int(a.nblocks)
    require(torch.equal(kb.bsr_matmul_dense_pieces(ap, bp, a, n), got),
            "K5's GEMM alone differs from K5")
    # K5 against the six passes of the same pieces, at a limit that the three
    # passes of split3 exceed (checked too, so that the limit can fail).
    abs_ab = bound / RTOL
    six = kb.bsr_matmul_dense_pieces_plain(ap, bp, a, n)
    pieces_rel = float(((got.double() - six.double()).abs() / abs_ab.clamp(min=1e-30)).max())
    require(pieces_rel <= K5_PIECES_TOL,
            f"K5 {pieces_rel:.2e} of |A||B| from the six passes of its pieces")
    three = split3_passes(ap, bp, a, n)
    split3_rel = float(((three.double() - six.double()).abs() / abs_ab.clamp(min=1e-30)).max())
    require(split3_rel > K5_PIECES_TOL, f"three passes only {split3_rel:.2e} from six: "
            "the pieces check could not tell them apart")
    del six, three, abs_ab
    flops = 6 * 2.0 * nb * bsz * bsz * n  # six bf16 passes of HIGHEST
    parts = dict(
        split_a_ms=event_ms(lambda: tm.split_bf16(a.blocks.reshape(-1, bsz), 3)),
        split_b_ms=event_ms(lambda: tm.split_bf16(bud[:k], 3, transpose=True, k_pad=a.nbc * bsz)),
        gemm_ms=event_ms(lambda: kb.bsr_matmul_dense_pieces(ap, bp, a, n)),
        whole_ms=event_ms(lambda: kb.bsr_matmul_dense(a, bud)),
        gemm_bound_ms=roofline(2 * (ap.numel() + bp.numel()) + 4 * a.shape[0] * n, flops,
                               "bf16")["bound_ms"])
    del ap, bp
    a_lib = torch.sparse_bsr_tensor(a.indptr, a.indices[:nb], a.blocks[:nb], size=a.shape)
    out["bsr_matmul_dense"] = dict(
        max_abs_err=float(err.max()),
        ms=event_ms(lambda: kb.bsr_matmul_dense(a, bud)),
        device_ms=event_ms(lambda: kb.bsr_matmul_dense(a, bud), queued=True),
        plain_ms=event_ms(lambda: kb.bsr_matmul_dense_plain(a, bud)),
        library_ms=event_ms(lambda: torch.matmul(a_lib, bud)),
        **roofline(block_bytes * nb + 4 * (bud.numel() + a.shape[0] * n), flops, "bf16"),
        parts=parts, pieces_rel_err=pieces_rel, split3_rel_err=split3_rel, n_a_blocks=nb,
        empty_block_rows=int(empty.sum()) // bsz)
    return out


def bsr_crossover(b_sp) -> list:
    """Request 1's form, A x B with B the 10% one, at each of CROSSOVER_OCCS
    for A (block_sparse's generator, seed BSR_SEEDS[0]): end to end on the
    BSR route (force_bsr) and on the dense route (use_bsr=False), min of
    PATH_RUNS each; the BSR route's product kernel, and the same nnz on both."""
    rows = []
    bsz = smt.get_config().block_size
    for occ in CROSSOVER_OCCS:
        a_sp = block_sparse(BSR_SEEDS[0], occ)
        plan = kb.bsr_pair_plan(a_sp, b_sp, bsz)
        row = dict(occupancy=api.block_occupancy(a_sp, bsz),
                   pairs=0 if plan is None else plan["n_pairs"])
        nnz = {}
        for route, cfg in (("bsr", dict(force_bsr=True)), ("dense", dict(use_bsr=False))):
            saved = smt.get_config()
            smt.set_config(**cfg)
            try:
                before = dict(LAUNCHES)
                row[route] = wall_s(lambda: smt.sparse_matrix_multiply(a_sp, b_sp))
                require(smt.get_last_route() == route, f"crossover at {occ}: not route {route!r}")
                nnz[route] = smt.sparse_matrix_multiply(a_sp, b_sp).nnz
                if route == "bsr":
                    row["kernel"] = ("K6" if LAUNCHES["bsr_bsr_matmul_dense"]
                                     > before["bsr_bsr_matmul_dense"] else "K5")
            finally:
                smt.set_config(saved)
        require(nnz["bsr"] == nnz["dense"], f"crossover at {occ}: nnz differs between the routes")
        rows.append(row)
    return rows


def uniform_bu():
    """The BSR path's uniformly sparse B_u (every block occupied)."""
    return sp.random(BSR_N, BSR_N, density=BU_DENSITY, format="csr", random_state=BU_SEED)


def k3_at(mat_sp) -> dict:
    """K3 on one operand the counted paths densify: bit for bit against its
    plain version and K8, and its, K8's, the plain version's and the library
    call's times beside its bound (the CSR read once, the dense written once)."""
    x = smt.from_scipy(mat_sp, dtype=torch.float32, device=DEVICE)
    csr = (x.indptr, x.indices, x.values, x.shape)
    got = ck.csr_to_dense(*csr)
    require(torch.equal(got, ck.csr_to_dense_plain(*csr)), f"K3 {x.shape} differs from plain")
    require(torch.equal(got, ck.csr_to_dense_fused(*csr)), f"K3 {x.shape} differs from K8")
    del got
    m, n = x.shape
    return dict(shape=[m, n], nnz=mat_sp.nnz, max_abs_err=0.0,
                ms=event_ms(lambda: ck.csr_to_dense(*csr)),
                k8_ms=event_ms(lambda: ck.csr_to_dense_fused(*csr)),
                device_ms=event_ms(lambda: ck.csr_to_dense(*csr), queued=True),
                k8_device_ms=event_ms(lambda: ck.csr_to_dense_fused(*csr), queued=True),
                plain_ms=event_ms(lambda: ck.csr_to_dense_plain(*csr)),
                library_ms=event_ms(lambda: sparse_csr(*csr).to_dense()),
                **roofline(csr_bytes(m, mat_sp.nnz) + 4 * m * n))


def check_bsr_result(label, got, oracle, bound) -> float:
    """A BSR-path result against the f64 oracle on the card: the same
    nonzero structure, values within 1e-5 * (|A| @ |B|); returns max |diff|."""
    got = torch.from_numpy(got).to(DEVICE) if isinstance(got, np.ndarray) else csr_on_card(got)
    require(tuple(got.shape) == tuple(oracle.shape), f"{label}: shape {tuple(got.shape)}")
    require(torch.equal(got != 0, oracle != 0), f"{label}: structure differs from the oracle")
    diff = (got - oracle).abs()
    require(bool((diff <= bound).all()), f"{label}: outside 1e-5 of |A||B| of the f64 oracle")
    return float(diff.max())


def counted(calls, results):
    """Run ``calls`` ((label, fn) pairs; ``fn`` gets the results so far) in
    order, each result into ``results``: (launches per call, seconds per
    call).  The caller zeroes the counts before the path and reads them
    after it."""
    per_call, seconds = {}, {}
    for label, fn in calls:
        before = dict(LAUNCHES)
        t = time.perf_counter()
        results[label] = fn(results)
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t
        per_call[label] = {k: LAUNCHES[k] - before[k] for k in KERNELS}
    return per_call, seconds


def request(a_sp, b_sp, **kw):
    """A call for :func:`counted`: sparse_matrix_multiply and its route."""
    return lambda _: (smt.sparse_matrix_multiply(a_sp, b_sp, **kw), smt.get_last_route())


def split_answers(answers: dict):
    """({label: result}, {label: route}) of the answers of :func:`request` calls."""
    return ({label: got for label, (got, _) in answers.items()},
            {label: route for label, (_, route) in answers.items()})


def same_arrays(got, want, what: str) -> None:
    for g, w, field in zip(got, want, ("indptr", "indices", "values")):
        require(torch.equal(g, w), f"{what}: {field} differs")


def fused_kernels(a_sp, b_sp, sa_sp, sb_sp):
    """Phase 10: K7 and K8 through their entry points at the main path's
    shapes, counted; then each output bit for bit against its plain version
    and K4/K3, K7 at three lanes, and the times: K7 and K4 in one window,
    each whole and on the device alone."""
    a = smt.from_scipy(a_sp, dtype=torch.float32, device=DEVICE)
    with full_fp32():
        c_head = torch.matmul(csr_to_dense(a), csr_to_dense(
            smt.from_scipy(b_sp, dtype=torch.float32, device=DEVICE)))
        c_sib = torch.matmul(
            csr_to_dense(smt.from_scipy(sa_sp, dtype=torch.float32, device=DEVICE)),
            csr_to_dense(smt.from_scipy(sb_sp, dtype=torch.float32, device=DEVICE)))
    nnz_head, nnz_sib = int(torch.count_nonzero(c_head)), int(torch.count_nonzero(c_sib))
    cap_head, cap_sib = smt.bucket_capacity(nnz_head), smt.bucket_capacity(nnz_sib)
    a_csr = (a.indptr, a.indices, a.values)

    out = {}
    reset_launches()
    per_call, _ = counted([
        (f"k7_sibling_{SIB_N}", lambda _: ck.dense_to_csr_fused(c_sib, cap_sib)),
        (f"k7_headline_{N}", lambda _: ck.dense_to_csr_fused(c_head, cap_head)),
        (f"k8_operand_a_{N}", lambda _: ck.csr_to_dense_fused(*a_csr, a.shape)),
        (f"k8_sibling_{SIB_N}",
         lambda done: ck.csr_to_dense_fused(*done[f"k7_sibling_{SIB_N}"], c_sib.shape)),
    ], out)
    launches = dict(LAUNCHES)
    k7_sib = out[f"k7_sibling_{SIB_N}"]
    for key in KERNELS:
        want = 2 if key in ("dense_to_csr_fused", "csr_to_dense_fused") else 0
        require(launches[key] == want, f"fused path: {launches[key]} launches of {KERNELS[key][0]}")

    for label, c, cap, nnz in ((f"k7_sibling_{SIB_N}", c_sib, cap_sib, nnz_sib),
                               (f"k7_headline_{N}", c_head, cap_head, nnz_head)):
        got = out[label]
        require(int(got[0][-1]) == nnz, f"{label}: indptr[-1] {int(got[0][-1])} != nnz {nnz}")
        same_arrays(got, ck.dense_to_csr_fused_plain(c, cap), f"{label} against plain")
        same_arrays(got, ck.dense_to_csr(c, cap), f"{label} against K4")
    for lane in FUSED_LANES:
        same_arrays(ck.dense_to_csr_fused(c_sib, cap_sib, lane=lane), k7_sib,
                    f"K7 at lane {lane}")
    a_dense = out[f"k8_operand_a_{N}"]
    require(torch.equal(a_dense, ck.csr_to_dense_fused_plain(*a_csr, a.shape)),
            "K8 on A differs from plain")
    require(torch.equal(a_dense, ck.csr_to_dense(*a_csr, a.shape)), "K8 on A differs from K3")
    sib_dense = out[f"k8_sibling_{SIB_N}"]
    require(torch.equal(sib_dense, c_sib), "K8 does not give back the sibling product")
    require(torch.equal(sib_dense, ck.csr_to_dense_fused_plain(*k7_sib, c_sib.shape)),
            "K8 on the sibling differs from plain")
    require(torch.equal(sib_dense, ck.csr_to_dense(*k7_sib, c_sib.shape)),
            "K8 on the sibling differs from K3")
    del out, a_dense, sib_dense

    times = {
        "k7_sib": event_ms(lambda: ck.dense_to_csr_fused(c_sib, cap_sib)),
        "k7_sib_device": event_ms(lambda: ck.dense_to_csr_fused(c_sib, cap_sib), queued=True),
        "k7_sib_plain": event_ms(lambda: ck.dense_to_csr_fused_plain(c_sib, cap_sib)),
        "k4_sib": event_ms(lambda: ck.dense_to_csr(c_sib, cap_sib)),
        "k4_sib_device": event_ms(lambda: ck.dense_to_csr(c_sib, cap_sib), queued=True),
        "k7_head": event_ms(lambda: ck.dense_to_csr_fused(c_head, cap_head)),
        "k7_head_device": event_ms(lambda: ck.dense_to_csr_fused(c_head, cap_head), queued=True),
        "k7_head_plain": event_ms(lambda: ck.dense_to_csr_fused_plain(c_head, cap_head)),
        "k4_head": event_ms(lambda: ck.dense_to_csr(c_head, cap_head)),
        "k4_head_device": event_ms(lambda: ck.dense_to_csr(c_head, cap_head), queued=True),
        "k8_a": event_ms(lambda: ck.csr_to_dense_fused(*a_csr, a.shape)),
        "k8_a_plain": event_ms(lambda: ck.csr_to_dense_fused_plain(*a_csr, a.shape)),
        "k3_a": event_ms(lambda: ck.csr_to_dense(*a_csr, a.shape)),
        "k8_sib": event_ms(lambda: ck.csr_to_dense_fused(*k7_sib, c_sib.shape)),
        "k8_sib_plain": event_ms(lambda: ck.csr_to_dense_fused_plain(*k7_sib, c_sib.shape)),
        "k3_sib": event_ms(lambda: ck.csr_to_dense(*k7_sib, c_sib.shape)),
    }
    for lane in FUSED_LANES:
        times[f"k7_sib_lane_{lane}"] = event_ms(
            lambda: ck.dense_to_csr_fused(c_sib, cap_sib, lane=lane))
    report = {
        # Bit for bit against the plain versions, checked above.
        "dense_to_csr_fused": dict(
            max_abs_err=0.0, ms=times["k7_sib"], plain_ms=times["k7_sib_plain"],
            device_ms=times["k7_sib_device"],
            library_ms=event_ms(lambda: c_sib.to_sparse_csr()),
            **roofline(4 * c_sib.numel() + csr_bytes(SIB_N, cap_sib))),
        "csr_to_dense_fused": dict(
            max_abs_err=0.0, ms=times["k8_a"], plain_ms=times["k8_a_plain"],
            library_ms=event_ms(lambda: sparse_csr(*a_csr, a.shape).to_dense()),
            **roofline(csr_bytes(N, a_sp.nnz) + 4 * N * N)),
    }
    t = times
    line = " | ".join([
        f"K7 {SIB_N}^2 (nnz {nnz_sib}) {timing(report['dense_to_csr_fused'])}, K4 "
        f"{t['k4_sib']:.3f}; device alone (queued) K7 {t['k7_sib_device']:.3f}, K4 "
        f"{t['k4_sib_device']:.3f}; lanes "
        + ", ".join(f"{lane}: {t[f'k7_sib_lane_{lane}']:.3f} ms" for lane in FUSED_LANES)
        + " (identical outputs)",
        f"K7 {N}^2 full product (nnz {nnz_head}) {t['k7_head']:.3f} ms, device alone "
        f"{t['k7_head_device']:.3f} (plain {t['k7_head_plain']:.3f}, K4 {t['k4_head']:.3f}, "
        f"device alone {t['k4_head_device']:.3f})",
        f"K8 {N}^2 operand A (nnz {a_sp.nnz}) {timing(report['csr_to_dense_fused'])}, K3 "
        f"{t['k3_a']:.3f}",
        f"K8 {SIB_N}^2 packed sibling {t['k8_sib']:.3f} ms (plain {t['k8_sib_plain']:.3f}, "
        f"K3 {t['k3_sib']:.3f})",
        "bit for bit against plain and K4/K3",
        f"launches by call {per_call}", f"launches {launches}"])
    return report, per_call, launches, line


def split3_gate() -> str:
    """K1's two branches against the f64 oracle at SPLIT3_CONFIGS, beside what
    the split3 gate decides for each; max rel = max |got - ref| / (|ref| +
    ATOL) over the upper triangle (benchmarks/accuracy.py's measure).
    split3's must be at least SPLIT3_ERR_RATIO times HIGHEST's."""
    lines = []
    for n, density in SPLIT3_CONFIGS:
        a_sp, b_sp = operands(n, density, (1, 2))
        a = smt.from_scipy(a_sp, dtype=torch.float32, device=DEVICE)
        b = smt.from_scipy(b_sp, dtype=torch.float32, device=DEVICE)
        ad, bd = csr_to_dense(a), csr_to_dense(b)
        ref = torch.triu(torch.matmul(csr_on_card(a_sp), csr_on_card(b_sp)))
        rel = {}
        for split3 in (False, True):
            got = torch.triu(tm.matmul_triu(ad, bd, split3=split3)).double()
            rel[split3] = float(((got - ref).abs() / (ref.abs() + ATOL)).max())
            del got
        engaged = _split3_within_oracle(a, b)
        require(rel[False] <= RTOL, f"K1 HIGHEST at {n}^2 d={density} outside rtol 1e-5")
        require(rel[True] >= SPLIT3_ERR_RATIO * rel[False],
                f"K1 split3 at {n}^2 d={density} is as close to f64 as HIGHEST: did it run?")
        require(not engaged or rel[True] <= RTOL,
                f"the split3 gate engages at {n}^2 d={density}, where split3 is outside rtol")
        lines.append(f"{n}^2 d={density}: HIGHEST {rel[False]:.3e}, split3 {rel[True]:.3e} "
                     f"({rel[True] / RTOL:.2f} rtol); the gate "
                     + ("engages split3" if engaged else "keeps HIGHEST"))
        del a, b, ad, bd, ref
    return " | ".join(lines)


def triple_oracle(h_sp, q_sp):
    """f64 H Q H^T on the card and its bound 1e-5 * (|H| |Q| |H|^T)."""
    h64, q64 = csr_on_card(h_sp), csr_on_card(q_sp)
    c = torch.matmul(torch.matmul(h64, q64), h64.T)
    bound = RTOL * torch.matmul(torch.matmul(h64.abs(), q64.abs()), h64.abs().T)
    return c, bound


def mirror(x: torch.Tensor) -> torch.Tensor:
    return torch.triu(x) + torch.triu(x, 1).T


def triple_stage_times(h_sp, q_sp) -> dict:
    """Host-clock seconds of each stage of sparse_matrix_multiply(H, Q,
    use_triple_product=True, compute_full_matrix=1), calling in order the
    functions its "triple" route calls (the FAST branch of
    triple_product_dense); min of PATH_RUNS + 1."""
    best = {}

    def hq(hd, qd):
        with full_fp32():
            return torch.matmul(hd, qd)

    for _ in range(PATH_RUNS + 1):
        timed(best, "router_expansion_size",
              lambda: expansion_size(h_sp.indices, h_sp.nnz, q_sp.indptr))
        dtype, _ = api._upload_dtype(h_sp, q_sp, DEVICE)
        h, q = timed(best, "upload_from_scipy_h_q",
                     lambda: (smt.from_scipy(h_sp, dtype=dtype, device=DEVICE),
                              smt.from_scipy(q_sp, dtype=dtype, device=DEVICE)))
        hd, qd = timed(best, "densify_k3_x2", lambda: (csr_to_dense(h, torch.float32),
                                                       csr_to_dense(q, torch.float32)))
        t_hq = timed(best, "product_h_q_cublas", lambda: hq(hd, qd))
        c = timed(best, "product_k1_t_ht", lambda: tm.matmul_triu(t_hq, hd, transpose_b=True))
        out_dtype = torch.promote_types(h.dtype, q.dtype)
        full = timed(best, "cast_triu_mirror", lambda: mirror(c.to(out_dtype)))
        timed(best, "download_d2h_cast_f64", lambda: fetch_np(full).astype(np.float64))
        del h, q, hd, qd, t_hq, c, full
    return best


def triple_phase(h_sp, q_sp, name: str, smi: str):
    """Phase 11: the triple product through sparse_matrix_multiply, counted,
    each result against the f64 oracle; then its times."""
    t0 = time.perf_counter()
    labels = [f"triple_{N}_full{cfm}" for cfm in (0, 1)]
    answers = {}
    reset_launches()
    per_call, seconds = counted(
        [(label, request(h_sp, q_sp, use_triple_product=True, compute_full_matrix=cfm))
         for cfm, label in enumerate(labels)], answers)
    launches = dict(LAUNCHES)
    results, routes = split_answers(answers)
    del answers
    c64, bound64 = triple_oracle(h_sp, q_sp)
    errs = {}
    for cfm, label in enumerate(labels):
        got, route = results.pop(label), routes[label]
        require(route == "triple", f"{label}: route {route!r} != 'triple'")
        require(per_call[label]["csr_to_dense"] == 2 and per_call[label]["matmul_triu"] == 1
                and per_call[label]["split_bf16"] == 2,
                f"{label}: launches {per_call[label]}, not K3 x2, split_bf16 x2 and K1")
        got = torch.from_numpy(got).to(DEVICE)
        require(tuple(got.shape) == (N, N) and bool(torch.isfinite(got).all()),
                f"{label}: not a finite {N}^2 result")
        want, bound = (mirror(c64), mirror(bound64)) if cfm else (torch.triu(c64),
                                                                torch.triu(bound64))
        if cfm:
            require(torch.equal(got, got.T), f"{label}: the lower triangle is not the mirror")
        else:
            require(not bool(torch.tril(got, -1).any()), f"{label}: the lower triangle is not 0")
        require(torch.allclose(got, want, rtol=RTOL, atol=ATOL), f"{label}: outside the oracle")
        diff = (got - want).abs()
        require(bool((diff <= bound).all()), f"{label}: outside 1e-5 of |H||Q||H|^T")
        errs[label] = (float(diff.max()), float((diff / want.abs().clamp_min(1e-300)).max()))
        del got, want, bound, diff
    del c64, bound64
    phase("triple", t0, " | ".join(
        [f"{label}: max abs err {e[0]:.3e}, max rel err {e[1]:.3e} vs f64 oracle, "
         f"first call {seconds[label]:.3f} s" for label, e in errs.items()]
        + [f"launches by request {per_call}", f"launches {launches}"]))

    t0 = time.perf_counter()
    e2e = {cfm: wall_s(lambda cfm=cfm: smt.sparse_matrix_multiply(
        h_sp, q_sp, use_triple_product=True, compute_full_matrix=cfm)) for cfm in (0, 1)}
    require(smt.get_last_route() == "triple", "timed triple call took another route")
    h = smt.from_scipy(h_sp, dtype=torch.float32, device=DEVICE)
    q = smt.from_scipy(q_sp, dtype=torch.float32, device=DEVICE)
    dev = {cfm: wall_s(lambda cfm=cfm: smt.triple_product(h, q, cfm)) for cfm in (0, 1)}
    dev_fast = wall_s(lambda: smt.triple_product(h, q, 1, precision="fast"))
    # K1 in its transpose_b form, both branches, at the second contraction
    # (T, H) it is given.
    hd = csr_to_dense(h, torch.float32)
    t_hq = fp32_matmul(hd, csr_to_dense(q, torch.float32))
    got, errs = k1_against_plain(t_hq, hd, transpose_b=True)
    del got
    lib = event_ms(lambda: fp32_matmul(t_hq, hd.T))
    k1t = {f"{branch}_triple_t_ht_{N}": dict(
        **errs[branch], **k1_timed(t_hq, hd, True, branch == "split3", lib, N, N, N))
        for branch in K1_BRANCHES}
    del h, q, hd, t_hq
    stages = triple_stage_times(h_sp, q_sp)
    phase("triple-timing", t0, f"{name} [{smi}]: host clock, min of {PATH_RUNS}: "
          + " | ".join(f"compute_full_matrix={cfm}: sparse_matrix_multiply end to end "
                       f"{e2e[cfm]:.4f} s, device-resident triple_product {dev[cfm]:.4f} s"
                       for cfm in (0, 1))
          + f" (precision='fast', K1 split3: {dev_fast:.4f} s) | CUDA events, min of "
          f"{KERNEL_RUNS}: " + " | ".join(
              f"K1 {form} on (T, H): {timing(r)}; against plain: max abs err "
              f"{r['max_abs_err']:.2e}, {r['max_err_of_unit']:.2e} of |T||H|^T"
              for form, r in k1t.items()))
    print(f"[triple-stages] sparse_matrix_multiply(use_triple_product=True, "
          f"compute_full_matrix=1) {N}^2, host clock, min of {PATH_RUNS + 1}: "
          + json.dumps(stages), flush=True)
    return per_call, launches, k1t


def inversion_problem():
    """The inversion-shaped problem (n_obs << n_state): H, Q (symmetric,
    strictly diagonally dominant), y, x0, r_diag, all from INV_SEED."""
    rng = np.random.default_rng(INV_SEED)
    h = sp.random(INV_OBS, INV_STATE, density=INV_H_DENSITY, format="csr", random_state=INV_SEED)
    a = sp.random(INV_STATE, INV_STATE, density=INV_Q_DENSITY, format="csr",
                  random_state=INV_SEED + 1)
    sym = ((a + a.T) * 0.5).tocsr()
    q = (sym + sp.diags(1.0 + np.asarray(abs(sym).sum(axis=1)).ravel())).tocsr()
    r_diag = 0.5 + rng.random(INV_OBS)
    y = rng.standard_normal(INV_OBS)
    x0 = rng.standard_normal(INV_STATE)
    return h, q, y, x0, r_diag


def inversion_phase(name: str, smi: str):
    """Phase 12: invert and posterior_covariance on the card, counted, against
    an f64 oracle computed here with torch.linalg; kappa_2(S) and the times."""
    t0 = time.perf_counter()
    h_sp, q_sp, y, x0, r_diag = inversion_problem()
    h = smt.from_scipy(h_sp, dtype=torch.float32, device=DEVICE)
    q = smt.from_scipy(q_sp, dtype=torch.float32, device=DEVICE)
    y_t, x0_t, r_t = (torch.from_numpy(v).to(DEVICE) for v in (y, x0, r_diag))
    label_inv = f"invert_{INV_OBS}x{INV_STATE}"
    label_cov = f"posterior_covariance_{INV_OBS}x{INV_STATE}"
    results = {}
    reset_launches()
    per_call, _ = counted([
        (label_inv, lambda _: invert(h, q, y_t, x0_t, r_t)),
        (label_cov, lambda _: posterior_covariance(h, q, r_t)),
    ], results)
    launches = dict(LAUNCHES)
    for label in (label_inv, label_cov):
        require(per_call[label]["matmul_triu"] == 1 and per_call[label]["csr_to_dense"] == 4
                and per_call[label]["split_bf16"] == 2,
                f"{label}: launches {per_call[label]}, not K3 x4, split_bf16 x2 and K1")

    h64, q64 = csr_on_card(h_sp), csr_on_card(q_sp)
    y64, x064, r64 = (torch.from_numpy(v).to(DEVICE) for v in (y, x0, r_diag))
    s64 = torch.matmul(torch.matmul(h64, q64), h64.T) + torch.diag(r64)
    qht64 = torch.matmul(q64, h64.T)
    x_post64 = x064 + torch.matmul(qht64, torch.linalg.solve(s64, y64 - torch.matmul(h64, x064)))
    p64 = q64 - torch.matmul(qht64, torch.linalg.solve(s64, qht64.T))
    del h64, qht64
    eig = torch.linalg.eigvalsh(s64)
    kappa = float(eig[-1] / eig[0])
    res, p_full = results[label_inv], results[label_cov]
    errs = {}
    for what, got, ref in (("x_post", res.x_post, x_post64),
                           ("p_diag", res.p_diag, torch.diagonal(p64)),
                           ("s", res.s, s64), ("posterior_covariance", p_full, p64)):
        require(got.dtype == torch.float32 and got.shape == ref.shape, f"{what}: {got.dtype}, "
                f"{tuple(got.shape)}")
        scale = float(ref.abs().max())
        errs[what] = float((got.double() - ref).abs().max()) / scale
        require(errs[what] <= INV_TOL, f"{what}: |got - ref|_inf = {errs[what]:.3e} of |ref|_inf,"
                f" above {INV_TOL}")
    del results, res, p_full, s64, p64, q64
    phase("inversion", t0, f"n_obs {INV_OBS}, n_state {INV_STATE}, nnz(H) {h_sp.nnz}, nnz(Q) "
          f"{q_sp.nnz}: kappa_2(S) {kappa:.4e} | |got - ref|_inf / |ref|_inf vs f64 oracle: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" | launches by request {per_call} | launches {launches}")

    t0 = time.perf_counter()
    t_inv = wall_s(lambda: invert(h, q, y_t, x0_t, r_t))
    t_cov = wall_s(lambda: posterior_covariance(h, q, r_t))
    # K1 in its transpose_b form, both branches, at the (T, H) the inversion
    # gives it: a 4,096^2 output with K = 16,384.
    hd = csr_to_dense(h, torch.float32)
    t_hq = fp32_matmul(hd, csr_to_dense(q, torch.float32))
    got, errs = k1_against_plain(t_hq, hd, transpose_b=True)
    del got
    lib = event_ms(lambda: fp32_matmul(t_hq, hd.T))
    k1i = {f"{branch}_inversion_t_ht_{INV_OBS}x{INV_STATE}": dict(
        **errs[branch],
        **k1_timed(t_hq, hd, True, branch == "split3", lib, INV_OBS, INV_OBS, INV_STATE))
        for branch in K1_BRANCHES}
    del hd, t_hq
    phase("inversion-timing", t0, f"{name} [{smi}]: device-resident, host clock, min of "
          f"{PATH_RUNS}: invert {t_inv:.4f} s | posterior_covariance {t_cov:.4f} s | CUDA "
          f"events, min of {KERNEL_RUNS}: " + " | ".join(
              f"K1 {form} on (T, H): {timing(r)}; against plain: max abs err "
              f"{r['max_abs_err']:.2e}, {r['max_err_of_unit']:.2e} of |T||H|^T"
              for form, r in k1i.items()))
    return per_call, launches, k1i


# ---------------------------------------------------------------------------
# Phases 13-14: the sparse-output ladder below the dense route.  Operands
# from utils.testing.hypersparse_random (non-negative values: no
# cancellation zeros, so scipy's structure is Gustavson's).
# ---------------------------------------------------------------------------

def hyper_pair(m: int, k: int, n: int, nnz_a: int, nnz_b: int, seeds):
    return hypersparse_random(m, k, nnz_a, seeds[0]), hypersparse_random(k, n, nnz_b, seeds[1])


def one_per_row(m: int, k: int, seed: int):
    """(m, k) CSR with one entry per row, in a uniformly random column."""
    rng = np.random.default_rng(seed)
    return sp.csr_matrix((rng.uniform(size=m), rng.integers(0, k, m), np.arange(m + 1)),
                         shape=(m, k))


def esc_operands() -> dict:
    """The ladder's operand pairs by key (see ESC_REQUESTS)."""
    return {
        "esc": hyper_pair(ESC_N, ESC_N, ESC_N, ESC_NNZ, ESC_NNZ, ESC_SEEDS),
        "classic": (one_per_row(CLASSIC_M, CLASSIC_K, CLASSIC_SEEDS[0]),
                    hypersparse_random(CLASSIC_K, CLASSIC_K, CLASSIC_B_NNZ, CLASSIC_SEEDS[1])),
        "chunks": hyper_pair(CHUNKS_N, CHUNKS_N, CHUNKS_N, CHUNKS_NNZ, CHUNKS_NNZ, CHUNKS_SEEDS),
        "dchunks": dense_chunks_operands(),
    }


def dense_chunks_operands():
    return hyper_pair(DCHUNKS_M, DCHUNKS_K, DCHUNKS_K, DCHUNKS_A_NNZ, DCHUNKS_B_NNZ,
                      DCHUNKS_SEEDS)


def dense_chunk_bounds(a_sp, n: int):
    """Row bounds of the dense-chunks route's chunks (api._sparse_out_chunked_dense)."""
    m = a_sp.shape[0]
    chunk = max(1, min(m, smt.get_config().dense_path_limit // n))
    return [(s, min(s + chunk, m)) for s in range(0, m, chunk)]


class config_set:
    """Config keywords set for the duration of a ``with`` block."""

    def __init__(self, **kw):
        self.kw = kw

    def __enter__(self):
        self.saved = smt.get_config()
        smt.set_config(**self.kw)

    def __exit__(self, *exc):
        smt.set_config(self.saved)


def esc_request(a_sp, b_sp, kw, cfg):
    """A call for :func:`counted`: sparse_matrix_multiply under ``cfg``, its
    route and the route's detail."""
    def call(_):
        with config_set(**cfg):
            got = smt.sparse_matrix_multiply(a_sp, b_sp, **kw)
        return got, (smt.get_last_route(), api.get_last_route_detail())
    return call


def same_bits(got, first, what: str) -> None:
    require(np.array_equal(got.indptr, first.indptr) and np.array_equal(got.indices, first.indices)
            and np.array_equal(got.data.view(np.uint64), first.data.view(np.uint64)),
            f"{what}: a repeated call gave other bits")


def esc_main_phase(ops: dict):
    """Phase 13: every rung of the ladder through sparse_matrix_multiply on
    the card, counted, each route checked, each product against scipy's
    (identical structure, values within the oracle), request (a) twice."""
    t0 = time.perf_counter()
    answers = {}
    reset_launches()
    per_request, seconds = counted(
        [(label, esc_request(*ops[key], kw, cfg)) for label, key, kw, cfg, _ in ESC_REQUESTS],
        answers)
    launches_esc = dict(LAUNCHES)
    details = {}
    for label, _, _, _, route in ESC_REQUESTS:
        got_route, details[label] = answers[label][1]
        require(got_route == route, f"{label}: route {got_route!r} != {route!r}")
        dense_chunks = route == "dense_chunks"
        for key in KERNELS:
            launched = per_request[label][key]
            if dense_chunks and key == "csr_to_dense":
                require(launched > 0, f"{label} launched no {KERNELS[key][0]}")
            elif not dense_chunks:
                require(launched == 0, f"{label} launched {KERNELS[key][0]}")
    require(details["esc_chunks_d"].get("chunks", 0) > 1, "esc_chunks ran one chunk")
    errs, nnz, refs = {}, {}, {}
    for label, key, kw, _, _ in ESC_REQUESTS:
        if key not in refs:
            refs[key] = (ops[key][0] @ ops[key][1]).tocsr()
        ref = sp.triu(refs[key], format="csr") if kw.get("symmetric") else refs[key]
        errs[label] = same_csr(answers[label][0], ref, label)
        nnz[label] = answers[label][0].nnz
    del refs
    kept = {label: answers[label][0] for label in TIMED_ESC}
    again = smt.sparse_matrix_multiply(*ops["esc"])
    same_bits(again, kept["esc_binned_a"], "esc_binned_a")
    del answers, again
    phase("esc-main", t0, " | ".join(
        [f"{label} ({route}{', ' + str(details[label]) if details[label] else ''}"
         f"{', esc_expand_limit ' + str(cfg['esc_expand_limit']) if 'esc_expand_limit' in cfg else ''}"
         f"{', use_binned_esc False' if cfg.get('use_binned_esc') is False else ''}): "
         f"nnz {nnz[label]}, max abs err vs scipy {errs[label]:.2e}, first call "
         f"{seconds[label]:.3f} s" for label, _, _, cfg, route in ESC_REQUESTS]
        + ["esc_binned_a twice: the same bits",
           "dense_chunks_e extracted by " + ("K4" if per_request["dense_chunks_e"]["dense_to_csr"]
                                             else "host packing"),
           f"launches by request {per_request}",
           f"launches {launches_esc}"]))
    return per_request, launches_esc, kept


def route_timing(a_sp, b_sp, cfg: dict, first, label: str) -> dict:
    """One request through sparse_matrix_multiply under ``cfg``, warm, min of
    PATH_RUNS (each call's bits against ``first``): its seconds, and the
    stages of that fastest call as the router recorded them
    (api.get_last_route_stages; a per-chunk stage summed over the chunks),
    with the rest of the call (validation, canonical copies) by difference."""
    best = None
    for _ in range(PATH_RUNS):
        with config_set(**cfg):
            t = time.perf_counter()
            got = smt.sparse_matrix_multiply(a_sp, b_sp)
            wall = time.perf_counter() - t
        same_bits(got, first, label)
        if best is None or wall < best["seconds"]:
            stages = api.get_last_route_stages()
            require(stages, f"{label}: route {smt.get_last_route()!r} recorded no stages")
            best = dict(seconds=wall, route=smt.get_last_route(), **api.get_last_route_detail(),
                        stages=dict(stages, rest=wall - sum(stages.values())))
    best["nnz_c_per_s"] = first.nnz / best["seconds"]
    return best


def peak_bytes(fn) -> int:
    """torch.cuda.max_memory_allocated() over one call of ``fn``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def resident(a_sp, b_sp, engine: str) -> dict:
    """Device-resident multiply on one pair through one ESC engine
    ("binned": plan=, the router's tile; "windowed": expand_capacity= and
    window= from windowed_plan; "classic": expand_capacity= alone): the
    plan's host time, the engine's CUDA-event time, its device busy share in
    one profiled call, the peak device memory, its bound (A and B read once,
    C written once), and beside it cuSPARSE SpGEMM (torch.sparse.mm of the
    two CSR tensors) and the host OpenMP kernel (spgemm_host), which the
    port never calls.  The product is held against spgemm_host's f64 one."""
    m, k = a_sp.shape
    n = b_sp.shape[1]
    expand = expansion_size(a_sp.indices, a_sp.nnz, b_sp.indptr)
    cap = smt.bucket_capacity(min(expand, m * n))
    t = time.perf_counter()
    if engine == "binned":
        plan = api._binned_plan_for(a_sp, b_sp, expand)
        require(plan is not None, f"no binned plan at {m}x{k} @ {k}x{n}")
        kw = dict(plan=plan)
        tile = dict(window=plan.window, lane_width=plan.lane_width, padded_slots=plan.padded)
    else:
        kw = dict(expand_capacity=smt.bucket_capacity(expand))
        tile = {}
        if engine == "windowed":
            wplan = windowed_plan(a_sp.nnz, np.diff(b_sp.indptr)[a_sp.indices], expand)
            require(wplan is not None, f"no window plan at {m}x{k} @ {k}x{n}")
            kw.update(window=wplan[0], tail_capacity=smt.bucket_capacity(wplan[1]) if wplan[1] else 0)
            tile = dict(window=wplan[0], tail=wplan[1])
    plan_s = time.perf_counter() - t
    a = smt.from_scipy(a_sp, dtype=torch.float32, device=DEVICE)
    b = smt.from_scipy(b_sp, dtype=torch.float32, device=DEVICE)
    fn = lambda: smt.multiply(a, b, out_capacity=cap, **kw)  # noqa: E731
    c = fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    peak = peak_bytes(fn)
    ms = event_ms(fn, runs=3)
    busy, wall = device_busy_s(fn)
    t = time.perf_counter()
    host = spgemm_host(a_sp, b_sp)
    host_s = time.perf_counter() - t
    got = api._to_scipy_f64(c)
    err = same_csr(got, host, f"multiply ({engine}) {m}x{k} @ {k}x{n} against spgemm_host")
    nnz_c = got.nnz
    del c, got, host
    out = dict(engine=engine, rows=m, nnz_a=a_sp.nnz, nnz_b=b_sp.nnz, n_partials=expand,
               nnz_c=nnz_c, **tile, plan_host_s=plan_s, ms=ms, partials_per_s=expand / ms * 1e3,
               device_busy_s=busy, wall_s=wall,
               device_busy_share=busy / wall if busy > 0 else None,
               peak_bytes=peak, resident_bytes_before_call=base,
               max_abs_err_vs_spgemm_host=err, spgemm_host_s=host_s,
               **roofline(csr_bytes(m, a_sp.nnz) + csr_bytes(k, b_sp.nnz)
                          + csr_bytes(m, nnz_c)))
    a_t = sparse_csr(a.indptr, a.indices, a.values, a.shape)
    b_t = sparse_csr(b.indptr, b.indices, b.values, b.shape)
    try:
        lib = torch.sparse.mm(a_t, b_t)
        out["cusparse_nnz_equal"] = int(lib._nnz()) == nnz_c
        del lib
        out["cusparse_peak_bytes"] = peak_bytes(lambda: torch.sparse.mm(a_t, b_t))
        out["cusparse_ms"] = event_ms(lambda: torch.sparse.mm(a_t, b_t), runs=3)
    except RuntimeError as e:  # a yardstick: its failure is recorded, not fatal
        out["cusparse_ms"] = None
        out["cusparse_error"] = str(e).splitlines()[0][:200]
    del a, b, a_t, b_t, kw
    torch.cuda.empty_cache()
    return out


def esc_timing_phase(ops: dict, kept: dict, name: str, smi: str) -> dict:
    """Phase 14: requests (a), (b) and (d) end to end with their stages
    (route_timing), (a)'s engine's device time by kernel, and each ESC
    engine device-resident: binned at (a) and at the 1M^2 d = 1e-5 product,
    windowed at (a), classic at (c)."""
    t0 = time.perf_counter()
    requests = {label: (key, cfg) for label, key, _, cfg, _ in ESC_REQUESTS}
    e2e = {label: route_timing(*ops[requests[label][0]], requests[label][1], kept[label], label)
           for label in TIMED_ESC}
    a_sp, b_sp = ops["esc"]
    expand = expansion_size(a_sp.indices, a_sp.nnz, b_sp.indptr)
    plan = api._binned_plan_for(a_sp, b_sp, expand)
    a = smt.from_scipy(a_sp, dtype=torch.float32, device=DEVICE)
    b = smt.from_scipy(b_sp, dtype=torch.float32, device=DEVICE)
    args = plan.device_args(DEVICE)
    engine_us = kernel_device_us(lambda: spgemm_esc_binned(
        a, b, *args, window=plan.window, out_capacity=smt.bucket_capacity(expand)))
    del a, b, args, plan
    engines = {"binned_a": resident(*ops["esc"], "binned"),
               "windowed_a": resident(*ops["esc"], "windowed"),
               "classic_c": resident(*ops["classic"], "classic")}
    hyper = hyper_pair(HYPER_N, HYPER_N, HYPER_N, HYPER_NNZ, HYPER_NNZ, HYPER_SEEDS)
    engines[f"binned_{HYPER_N}"] = resident(*hyper, "binned")
    del hyper
    esc = dict(card=name, nvidia_smi=smi, e2e=e2e, engine_kernels_us_esc_binned_a=engine_us,
               resident=engines)
    phase("esc-timing", t0, f"{name} [{smi}]: " + " | ".join(
        [f"{label} ({r['route']}) end to end {r['seconds']:.4f} s = {r['nnz_c_per_s']:.4e} "
         f"nnz(C)/s (min of {PATH_RUNS}, each call the same bits)" for label, r in e2e.items()]
        + [f"multiply {label} ({r['rows']} rows): {r['n_partials']} partials ("
           f"{', '.join(f'{key} {r[key]}' for key in ('window', 'lane_width', 'padded_slots', 'tail') if key in r)}"
           f"), plan {r['plan_host_s']:.3f} s host, "
           f"engine {r['ms']:.3f} ms ({r['partials_per_s']:.4e} partials/s; bound "
           f"{r['bound_ms']:.3f} ms by {r['bound_by']}), busy share "
           f"{r['device_busy_share'] if r['device_busy_share'] is None else round(r['device_busy_share'], 4)}, "
           f"peak {r['peak_bytes'] / 2**30:.2f} GiB; cuSPARSE "
           f"{r['cusparse_ms'] if r['cusparse_ms'] is None else round(r['cusparse_ms'], 3)} ms; "
           f"spgemm_host {r['spgemm_host_s']:.3f} s" for label, r in engines.items()]))
    for label, r in e2e.items():
        print(f"[esc-stages] {label} ({r['route']}) sparse_matrix_multiply, host clock, the "
              f"fastest of {PATH_RUNS} calls ({r['seconds']:.4f} s) as the router timed it: "
              + json.dumps(r["stages"]), flush=True)
    return esc


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
    sass = sass_counts(path)
    if sass is not None:
        for kernel, instances, ops in (("triu_gemm_kernel", 2, ("HGMMA", "UTMALDG")),
                                       ("bsr_dense_kernel", 1, ("HGMMA", "UTMALDG")),
                                       ("bsr_bsr_kernel", 1, ("HGMMA", "UTMALDG")),
                                       ("csr_to_dense_kernel", 2, ("UBLKCP",)),
                                       ("fused_extract_kernel", 2, ("UBLKCP",))):
            found = [v for k, v in sass.items() if kernel in k]
            require(len(found) == instances and all(v[op] > 0 for v in found for op in ops),
                    f"the SASS of {kernel} lacks {'/'.join(ops)}: {sass}")
    phase("build", t0, f"nvcc built {path} | {'/'.join(SASS_OPS)} instructions by kernel "
          f"(cuobjdump -sass): {sass if sass is not None else 'not counted (no cuobjdump)'}")

    # 3. kernels against their plain versions, at the main path's shapes
    t0 = time.perf_counter()
    a_sp, b_sp = operands(N, DENSITY, (1, 2))
    sa_sp, sb_sp = operands(SIB_N, SIB_DENSITY, (3, 4))
    a = smt.from_scipy(a_sp, dtype=torch.float32, device=DEVICE)
    b = smt.from_scipy(b_sp, dtype=torch.float32, device=DEVICE)
    report = {}

    # K3 at every operand the counted paths densify, bit for bit against its
    # plain version and K8; B's 10k densify checked as well.
    inv_h_sp, inv_q_sp = inversion_problem()[:2]
    dc_a_sp, dc_b_sp = dense_chunks_operands()
    k3_shapes = {label: k3_at(mat) for label, mat in (
        (K3_OPERAND_10K, a_sp), (K3_SIBLING, sa_sp), (K3_BU, uniform_bu()), (K3_INV_H, inv_h_sp),
        (K3_INV_Q, inv_q_sp), (K3_DCHUNK_B, dc_b_sp),
        *((K3_DCHUNK_A.format(start, stop), dc_a_sp[start:stop])
          for start, stop in dense_chunk_bounds(dc_a_sp, DCHUNKS_K)))}
    del inv_h_sp, inv_q_sp
    ad = ck.csr_to_dense(a.indptr, a.indices, a.values, a.shape)
    bd = ck.csr_to_dense(b.indptr, b.indices, b.values, b.shape)
    require(torch.equal(bd, ck.csr_to_dense_plain(b.indptr, b.indices, b.values, b.shape)),
            "K3 differs from plain on B")
    report["csr_to_dense"] = dict(
        max_abs_err=0.0, shapes=k3_shapes,
        **{key: k3_shapes[K3_OPERAND_10K][key]
           for key in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})

    # The split K1 starts with: bit for bit against its plain version, both
    # piece counts, both layouts; timed at the headline's A (HIGHEST, 3 pieces).
    for pieces in (2, 3):
        for x, transpose in ((ad, False), (bd, True)):
            require(torch.equal(tm.split_bf16(x, pieces, transpose=transpose),
                                tm.split_bf16_plain(x, pieces, transpose=transpose)),
                    f"split_bf16 ({pieces} pieces, transpose={transpose}) differs from plain")
    pad_n, pad_k = -(-N // tm.TILE) * tm.TILE, -(-N // tm.KSTEP) * tm.KSTEP
    report["split_bf16"] = dict(
        max_abs_err=0.0, ms=event_ms(lambda: tm.split_bf16(ad, 3)),
        plain_ms=event_ms(lambda: tm.split_bf16_plain(ad, 3)), library_ms=None,
        ms_transposed=event_ms(lambda: tm.split_bf16(bd, 3, transpose=True)),
        **roofline(4 * N * N + 2 * 3 * pad_n * pad_k))

    # K1: both branches, both forms, against the plain versions, the FP32
    # torch.matmul of the same operands beside them.
    bt = bd.T.contiguous()
    lib_ms = {"a_b": event_ms(lambda: fp32_matmul(ad, bd)),
              "a_bt": event_ms(lambda: fp32_matmul(ad, bt.T))}
    k1_got, k1_err = k1_against_plain(ad, bd)
    for branch in K1_BRANCHES:
        c_trans = torch.triu(tm.matmul_transpose_triu(ad, bt, split3=branch == "split3"))
        require(torch.equal(c_trans, k1_got[branch]), f"K1 {branch} transpose_b differs from K1")
        del c_trans
    k1_forms = {f"{branch}_{form}_{N}": dict(
        **k1_err[branch], **k1_timed(ad, x, transpose_b, branch == "split3", lib_ms[form], N, N, N))
        for branch in K1_BRANCHES for form, x, transpose_b in (("a_b", bd, False), ("a_bt", bt, True))}
    del bt
    # K1's parts in one window: the split of A, that of B (transposed) and
    # the GEMM alone on those pieces (bit for bit K1's), beside K1 whole.
    k1_parts = {}
    for branch in K1_BRANCHES:
        pieces = 2 if branch == "split3" else 3
        ap, bp = tm.split_bf16(ad, pieces), tm.split_bf16(bd, pieces, transpose=True)
        require(torch.equal(torch.triu(tm.matmul_triu_pieces(ap, bp, N, N)), k1_got[branch]),
                f"K1 {branch}: its GEMM alone differs from K1")
        k1_parts[branch] = dict(
            split_a_ms=event_ms(lambda: tm.split_bf16(ad, pieces)),
            split_bt_ms=event_ms(lambda: tm.split_bf16(bd, pieces, transpose=True)),
            gemm_ms=event_ms(lambda: tm.matmul_triu_pieces(ap, bp, N, N)),
            whole_ms=event_ms(lambda: tm.matmul_triu(ad, bd, False, pieces == 2)),
            gemm_bound_ms=k1_bound(N, N, N, pieces == 2)["bound_ms"])
        del ap, bp
    c_kernel = k1_got["highest"]  # K2's input below
    del k1_got
    highest = k1_forms[f"highest_a_b_{N}"]
    report["matmul_triu"] = dict(
        max_abs_err=k1_err["highest"]["max_abs_err"],
        max_abs_err_split3=k1_err["split3"]["max_abs_err"],
        **{key: highest[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        forms=k1_forms, parts=k1_parts)

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
    # K7's device time by kernel on the same product, here: asked in phase
    # 10, late in the run, the profiler held some or none of its records.
    k7_kernels_us = kernel_device_us(
        lambda: ck.dense_to_csr_fused(c_sib, smt.bucket_capacity(ext_sib_full["nnz"])))
    del c_sib, sa, sb
    # K4 at each chunk's product of the dense-chunks request (e), as the
    # route forms it (each chunk of A's rows times B on the dense route).
    k4_chunks = {}
    for start, stop in dense_chunk_bounds(dc_a_sp, DCHUNKS_K):
        chunk = dc_a_sp[start:stop]
        dtype, _ = api._upload_dtype(chunk, dc_b_sp, DEVICE)
        c_chunk = spgemm_dense_out(smt.from_scipy(chunk, dtype=dtype, device=DEVICE),
                                   smt.from_scipy(dc_b_sp, dtype=dtype, device=DEVICE))
        k4_chunks[K4_DCHUNK.format(start, stop)] = compare_extract(c_chunk, triu=False)
        del c_chunk
    del dc_a_sp, dc_b_sp
    timing_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "device_ms",
                   "kernels_us")
    k2_shapes = {K2_HEADLINE: ext_10k_triu, f"sibling_triu_{SIB_N}": ext_sib_triu}
    k4_shapes = {f"headline_product_{N}": ext_10k_full, K4_SIBLING: ext_sib_full, **k4_chunks}
    report["dense_to_csr_triu"] = dict(
        max_abs_err=max(r["max_abs_err"] for r in k2_shapes.values()), shapes=k2_shapes,
        **{key: ext_10k_triu[key] for key in timing_keys})
    report["dense_to_csr"] = dict(
        max_abs_err=max(r["max_abs_err"] for r in k4_shapes.values()), shapes=k4_shapes,
        **{key: ext_sib_full[key] for key in timing_keys})

    def ext(label, r):
        by_kernel = ", ".join(f"{k} {us:.1f}" for k, us in r["kernels_us"].items())
        return (f"{label} {timing(r)}, nnz {r['nnz']}; device alone (queued) "
                f"{r['device_ms']:.3f}, by kernel (us): {by_kernel}")

    phase("kernels", t0, " | ".join(
        [f"K3 {label} {r['shape'][0]}x{r['shape'][1]} (nnz {r['nnz']}): {timing(r)}; K8 "
         f"{r['k8_ms']:.3f}; device alone (queued) K3 {r['device_ms']:.3f}, K8 "
         f"{r['k8_device_ms']:.3f}" for label, r in k3_shapes.items()]
        + ["K3 bit for bit against plain and K8 at each"]
        + [f"{KERNELS[k][0]}: {timing(report[k])}" for k in ("split_bf16",)]
        + [f"split_bf16 of B^T {report['split_bf16']['ms_transposed']:.3f} ms"]
        + [f"K1 {form}: {timing(r)}" for form, r in k1_forms.items()]
        + ["K1 against plain: " + ", ".join(
            f"{branch} max abs err {e['max_abs_err']:.3e} ({e['max_err_of_unit']:.3e} of |A||B|,"
            f" limit {RTOL})" for branch, e in k1_err.items())
           + "; each branch's two forms bit-identical, split3's bits differ from HIGHEST's"]
        + [f"K1 {branch} A B parts, one window: split A {r['split_a_ms']:.3f} + split B^T "
           f"{r['split_bt_ms']:.3f} + GEMM {r['gemm_ms']:.3f} ms ({r['gemm_bound_ms'] / r['gemm_ms']:.1%}"
           f" of its bound) against K1 whole {r['whole_ms']:.3f} ms" for branch, r in k1_parts.items()]
        + [ext(f"K2 {N}^2 triu", ext_10k_triu), ext(f"K4 {N}^2 full", ext_10k_full),
           ext(f"K2 {SIB_N}^2 triu", ext_sib_triu),
           ext(f"K4 {SIB_N}^2 ({ext_sib_full['nnz'] / SIB_N**2:.3f} dense)", ext_sib_full),
           *(ext(f"K4 {label} {r['shape'][0]}x{r['shape'][1]}", r) for label, r in k4_chunks.items()),
           f"K7 {SIB_N}^2 by kernel (us): "
           + ", ".join(f"{k} {us:.1f}" for k, us in k7_kernels_us.items())]))

    # 3b. K1's branches against the f64 oracle, and the split3 gate
    t0 = time.perf_counter()
    phase("split3-gate", t0, "max rel err vs f64 oracle: " + split3_gate())

    # 4. main path: the requests through the public entry point, counted
    t0 = time.perf_counter()
    ops = {"headline": (a_sp, b_sp), "sibling": (sa_sp, sb_sp)}
    answers = {}
    reset_launches()
    per_request, seconds = counted(
        [(label, request(*ops[which], **kw)) for label, which, kw in MAIN_REQUESTS], answers)
    launches_main = dict(LAUNCHES)
    results, routes = split_answers(answers)
    del answers

    for label, route in routes.items():
        require(route == "dense", f"{label}: route {route!r} != 'dense'")
    for key in DENSE_PATH_KERNELS:
        require(launches_main[key] > 0, f"the main path launched no {KERNELS[key][0]}")
    require(launches_main["bsr_matmul_dense"] == launches_main["bsr_bsr_matmul_dense"]
            == launches_main["bsr_pair_runs"] == 0, "the dense main path launched a BSR kernel")
    for key in ("matmul_triu", "split_bf16", "dense_to_csr_triu", "csr_to_dense"):
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
    del got, c_sp

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

    # 4b. the explicit-FAST request through the device-resident API: K1's
    # split3 branch, which the term gate admits at the headline, counted
    t0 = time.perf_counter()
    require(_split3_within_oracle(a, b), "the split3 gate shuts the headline out")
    fast_answers = {}
    reset_launches()
    fast_per_request, fast_seconds = counted(
        [(FAST_LABEL, lambda _: smt.multiply(a, b, output_format="dense", symmetric=True,
                                             precision="fast"))], fast_answers)
    launches_fast = dict(LAUNCHES)
    want = {"csr_to_dense": 2, "split_bf16": 2, "matmul_triu": 1}
    require(all(launches_fast[key] == want.get(key, 0) for key in KERNELS),
            f"{FAST_LABEL}: launches {launches_fast}, not K3 x2, split_bf16 x2 and K1")
    got = fast_answers.pop(FAST_LABEL).double()
    require(torch.equal(got != 0, oracle != 0), f"{FAST_LABEL}: structure differs from the oracle")
    require(torch.allclose(got, oracle, rtol=RTOL, atol=ATOL), f"{FAST_LABEL}: outside the oracle")
    fast_rel = float(((got - oracle).abs() / oracle.abs().clamp_min(1e-300)).max())
    del got, oracle
    phase("fast", t0, f"multiply(dense, symmetric, precision='fast') {N}^2: K1 split3, max rel "
          f"err vs f64 oracle {fast_rel:.3e}, first call {fast_seconds[FAST_LABEL]:.3f} s | "
          f"launches by request {fast_per_request}")

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
    t_dev_fast = wall_s(lambda: smt.multiply(a, b, output_format="sparse", symmetric=True,
                                             out_capacity=cap, precision="fast"))
    t_e2e = wall_s(lambda: smt.sparse_matrix_multiply(a_sp, b_sp, symmetric=True))
    nnz_c = N * (N + 1) // 2
    busy, t_prof = device_busy_s(lambda: smt.sparse_matrix_multiply(a_sp, b_sp, symmetric=True))
    idle = f"{1 - busy / t_prof:.4f}" if busy > 0 else "not measured (no device time traced)"
    stages = stage_times(a_sp, b_sp)
    phase("timing", t0, f"{name} [{smi}]: multiply(sparse, symmetric) device-resident "
          f"{t_dev:.4f} s = {nnz_c / t_dev:.4e} nnz(C)/s (precision='fast', K1 split3: "
          f"{t_dev_fast:.4f} s) | sparse_matrix_multiply end to end "
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
    bu_sp = uniform_bu()
    bsr_report = bsr_kernels(a_bsp, b_bsp, bu_sp)
    report.update(bsr_report)
    # K2 at the upper triangle the symmetric BSR request extracts.
    ext_bsr = compare_extract(api._bsr_product_host(a_bsp, b_bsp, True, DEVICE), triu=True)
    report["dense_to_csr_triu"]["shapes"][K2_BSR] = ext_bsr
    report["dense_to_csr_triu"]["max_abs_err"] = max(report["dense_to_csr_triu"]["max_abs_err"],
                                                     ext_bsr["max_abs_err"])
    k5, k6 = bsr_report["bsr_matmul_dense"], bsr_report["bsr_bsr_matmul_dense"]
    phase("bsr-kernels", t0, f"{BSR_N}^2, {BSR_BLOCK}^2 blocks: K6 {timing(k6)}; "
          f"{k6['n_pairs']} pairs, {k6['visited_blocks']} of "
          f"{(BSR_N // BSR_BLOCK) ** 2} output blocks visited, the rest exactly 0; max abs err "
          f"{k6['max_abs_err']:.2e}; device alone (queued) {k6['device_ms']:.3f} ms, by kernel "
          f"(us): {', '.join(f'{k} {us:.1f}' for k, us in k6['kernels_us'].items())}; parts, one "
          f"window: split A {k6['parts']['split_a_ms']:.3f} + split B^T "
          f"{k6['parts']['split_b_ms']:.3f} + run check {k6['parts']['runs_ms']:.3f} + GEMM "
          f"{k6['parts']['gemm_ms']:.3f} ms ({k6['parts']['gemm_bound_ms'] / k6['parts']['gemm_ms']:.1%}"
          f" of its bound; run check, sync and GEMM {k6['parts']['pieces_ms']:.3f}) against K6 whole "
          f"{k6['parts']['whole_ms']:.3f} ms, its GEMM alone bit for bit K6's; against the six "
          f"passes of its pieces {k6['pieces_rel_err']:.2e} of |A||B| (limit {K5_PIECES_TOL:.0e}) "
          f"| K6's run check {timing(bsr_report['bsr_pair_runs'])}, bit for bit its plain version "
          f"| K5 {timing(k5)}; "
          f"{k5['n_a_blocks']} A blocks, {k5['empty_block_rows']} empty block-rows; max abs err "
          f"{k5['max_abs_err']:.2e}; parts, one window: split A {k5['parts']['split_a_ms']:.3f} + "
          f"split B^T {k5['parts']['split_b_ms']:.3f} + GEMM {k5['parts']['gemm_ms']:.3f} ms "
          f"({k5['parts']['gemm_bound_ms'] / k5['parts']['gemm_ms']:.1%} of its bound) against K5 "
          f"whole {k5['parts']['whole_ms']:.3f} ms, its GEMM alone bit for bit K5's; device alone "
          f"(queued) {k5['device_ms']:.3f} ms; against the six passes of its pieces "
          f"{k5['pieces_rel_err']:.2e} of |A||B| (limit {K5_PIECES_TOL:.0e}; split3's three "
          f"passes {k5['split3_rel_err']:.2e}) | K2 {BSR_N}^2 symmetric product's triangle "
          f"{timing(ext_bsr)}, nnz {ext_bsr['nnz']}, bit for bit its plain version")

    # 8. BSR path: the requests through the public entry point, counted
    t0 = time.perf_counter()
    bsr_b = {"b": b_bsp, "bu": bu_sp}
    answers = {}
    reset_launches()
    bsr_per_request, bsr_seconds = counted(
        [(label, request(a_bsp, bsr_b[which], **kw)) for label, which, kw, _ in BSR_REQUESTS],
        answers)
    launches_bsr = dict(LAUNCHES)
    bsr_results, bsr_routes = split_answers(answers)
    del answers

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
    t0 = time.perf_counter()
    crossover = bsr_crossover(b_bsp)
    phase("bsr-crossover", t0, f"{name} [{smi}]: A x B (B {BSR_OCC} occupied), "
          f"sparse_matrix_multiply end to end, host clock, min of {PATH_RUNS}: " + " | ".join(
              f"A occupancy {r['occupancy']:.4f} ({r['pairs']} pairs): BSR route {r['bsr']:.4f} s "
              f"({r['kernel']}), dense route {r['dense']:.4f} s, BSR/dense {r['bsr'] / r['dense']:.3f}"
              for r in crossover))
    del a_bsp, b_bsp, bu_sp, bsr_b

    # 10. the fused conversions K7/K8 through their own entry points, counted
    t0 = time.perf_counter()
    fused_report, fused_per_call, launches_fused, line = fused_kernels(a_sp, b_sp, sa_sp, sb_sp)
    report.update(fused_report)
    report["dense_to_csr_fused"]["kernels_us"] = k7_kernels_us  # phase 3's
    phase("fused-kernels", t0, line)

    # 11. the triple product H Q H^T (H the headline A), counted, and its times
    q_sp = sp.random(N, N, density=DENSITY, format="csr", random_state=TRIPLE_Q_SEED)
    triple_per_request, launches_triple, k1_triple = triple_phase(a_sp, q_sp, name, smi)
    report["matmul_triu"]["forms"].update(k1_triple)
    del q_sp

    # 12. the inversion workflow at n_obs << n_state, counted, and its times
    inv_per_request, launches_inv, k1_inv = inversion_phase(name, smi)
    report["matmul_triu"]["forms"].update(k1_inv)

    # 13-14. the sparse-output ladder, counted, and its times
    ops = esc_operands()
    esc_per_request, launches_esc, kept = esc_main_phase(ops)
    esc = esc_timing_phase(ops, kept, name, smi)
    del ops, kept

    kernels = []
    by_request = {**per_request, **fast_per_request, **bsr_per_request, **fused_per_call,
                  **triple_per_request, **inv_per_request, **esc_per_request}
    path_launches = (launches_main, launches_fast, launches_bsr, launches_fused, launches_triple,
                     launches_inv, launches_esc)
    k3_shapes = report["csr_to_dense"]["shapes"]
    for shape in k3_shapes.values():
        shape["launches"] = 0
    for label, counts in by_request.items():
        densified = k3_operands().get(label, ())
        require(counts["csr_to_dense"] == len(densified),
                f"{label}: {counts['csr_to_dense']} K3 launches, not one for each of {densified}")
        for operand in densified:
            k3_shapes[operand]["launches"] += 1
    for key, by_label in extract_operands().items():
        shapes = report[key]["shapes"]
        for shape in shapes.values():
            shape["launches"] = 0
        for label, counts in by_request.items():
            extracted = by_label.get(label, ())
            require(counts[key] == len(extracted),
                    f"{label}: {counts[key]} {KERNELS[key][0]} launches, not one for each of "
                    f"{extracted}")
            for operand in extracted:
                shapes[operand]["launches"] += 1
    for key, (kname, source, replaces) in KERNELS.items():
        r = report[key]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(counts[key] for counts in path_launches),
            "launches_by_request": {label: n[key] for label, n in by_request.items()},
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
            **{k: r[k] for k in ("device_ms", "kernels_us", "forms", "parts", "shapes",
                                 "pieces_rel_err", "split3_rel_err") if k in r},
        })
    print(json.dumps({"esc": esc}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
