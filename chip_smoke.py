#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sparse_matrix_mult_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one line each:
  1. card    -- device name, nvidia-smi name/power limit, TF32 switched off;
  2. build   -- nvcc builds csrc/*.cu from the checkout (ptxas report shown),
                and the HGMMA (tensor-core) and UTMALDG (TMA) instructions of
                K1, matmul_full, K5 and K6 and the UBLKCP (bulk copy)
                instructions of K3 and K7 are counted in the SASS
                (cuobjdump -sass);
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
                starts with, bit for bit; matmul_full (the JAX package's
                HIGHEST f32 jnp.dot) at every product of the counted main
                path -- the 12,288^2 A B, the triple's 10k H Q on the pieces
                H shares with K1, the inversion's Q H^T (16,384^2 times
                4,096 x 16,384 transposed), posterior_covariance's
                (Q H^T) K^T, both chunks' products of request (e), a ring
                slot's 2,500 x 2,500 x 10,000 contraction and slot 0's first
                contraction of each ring of the distributed dense triple --
                each the bits of its GEMM alone, its upper tiles K1's bits
                on the same pieces, within 1e-6 of (|A| |B|) of the six
                passes of its pieces summed in f64, and 1e-5 of its plain
                version and of FP32 torch.matmul, timed whole and alone
                beside its plain
                version, cuBLAS FP32 and the six-pass bound (faster than
                cuBLAS at 12,288^2 and 10k); K2 and K4 bit for bit against
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
                launches per request (the last two: matmul_full and
                split_bf16 x2), and each result against its oracle;
     fast    -- one counted request multiply(symmetric=True,
                precision="fast") at the headline: K1's split3 branch
                through the API, against the f64 oracle;
  5. sibling -- symmetric sparse output at 12,288^2 against scipy;
  6. timing  -- device-resident multiply() (also with precision="fast") and
                end-to-end sparse_matrix_multiply at 10k, warm, min of 3, one
                profiled call (device busy time: the union of its device
                operations over the call, benchmarks_torch/trace.py), and
                the headline's time per stage;
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
                with block-sparse A and the route named (force_bsr: on the
                H100 the router itself sends them to the dense route),
                counts zeroed just before and read just after: A x B (K6), symmetric (K6, K2), A x uniform B_u (K3,
                split_bf16 x2, K5) and dense output (K6); each K6 request
                splits twice and checks its pair tables once.  Route "bsr",
                launches per request, and each result against an f64 oracle
                on the card;
  9. bsr-timing -- requests 1 and 3 end to end on the BSR route
                (force_bsr) and as the router decides (the dense route),
                warm, min of 3; and request 1's time per stage;
     bsr-crossover -- request 1's form (A x B, sparse output) with A at
                block occupancies 0.002-0.25 at 8192^2 and 0.002 and 0.005
                at 16,384^2 (B the 10% one of each size), end to end on the
                BSR route (force_bsr) and on the dense route (use_bsr=False),
                min of 3 each (1 where the warm call took over 0.5 s), and
                the cutoff that gives (the largest
                occupancy at which the BSR route wins; 0 where it wins at
                none) beside Config.cuda_bsr_occupancy_cutoff;
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
                split_bf16 x3 (H once), matmul_full and K1 per request, and
                nothing else, each result against an
                f64 oracle on the card; then (triple-timing, triple-stages)
                end to end and device-resident triple_product (also with
                precision="fast"), warm, min of 3, K1's transpose_b form in
                both branches against its plain version (as in phase 3) at
                the second contraction, and the time per stage;
 12. inversion -- invert and posterior_covariance at n_obs 4,096, n_state
                16,384, counted (K3 x4, the triple's split_bf16 x3,
                matmul_full and K1, and Q H^T's split_bf16 x2 and
                matmul_full per call; posterior_covariance also (Q H^T) K^T's),
                against an f64 oracle on the card computed
                with torch.linalg (x_post, p_diag, S and the posterior
                covariance within 1e-3 of each one's largest entry), with
                kappa_2(S); then (inversion-timing) both warm, min of 3,
                and K1's transpose_b form in both branches against its plain
                version (as in phase 3) at the (T, H) the inversion gives it;
 13. esc-main -- the sparse-output ladder below the dense route: six
                requests through sparse_matrix_multiply on hypersparse
                operands (non-negative values), counted, each route checked:
                (a) 200,000^2 with nnz 2e6 per operand, plain and symmetric,
                with binned_esc_on_cuda ("esc_binned"), (b) the same as the
                router takes it on CUDA ("esc_windowed"), (c) 40,000 x 50,000
                with one entry per row times 50,000^2 at d = 0.002 ("esc"),
                (d) 1,000,000^2 with nnz 7e6 per operand ("esc_chunks", its
                chunk count shown), (e) 30,000 x 10,000 at d = 0.002 times
                10,000^2 at d = 0.01 ("dense_chunks": K3, split_bf16 x2,
                matmul_full and K4 per chunk; the committed model's est_dev
                beside its one call);
                the ESC requests launch no hand kernel.  Each product
                against scipy's (identical structure, values within the
                oracle); (a) twice gives the same bits;
 14. esc-timing -- (a), (b) and (d) end to end, warm, min of 3, each
                call's bits against the first's, and the stages of the
                fastest call as the router timed them ([esc-stages], one
                line each: the binned and windowed routes side by side on
                the same operands; (b)'s and (d)'s beside the stages the
                committed model prices); (a)'s engine's device time by kernel;
                and each engine
                device-resident (multiply(plan=...) at (a) and at
                1,000,000^2, d = 1e-5, ~1e8 partials; the windowed engine at
                (a), the classic at (c)): the plan's host time, the engine's
                CUDA-event time against its bound (A and B read once, C
                written once), the device busy share of one profiled call,
                the peak device memory, the product against spgemm_host's,
                and two yardsticks the port never calls: cuSPARSE SpGEMM
                (torch.sparse.mm of the CSR tensors) and the host OpenMP
                kernel spgemm_host; the cost model's est_host and est_dev
                at (c), (d) and (e), the time of its count of the entries of
                A's one-entry rows there, (d) and (e) once on the host
                route and (e) once more on its device route.
                Then one JSON line {"esc": ...}.
 15-19. dist-* -- the multi-device layer (parallel/, io.py) on a row mesh
                of DIST_SLOTS = 4 slots, all on the one card (the ring hands
                blocks between slots; no bytes cross between cards), each
                window counted: 15. dist-dense -- the dense ring and the CSR
                ring (balance "rows" and "flops") at the 10k^2 d=0.1
                symmetric headline, K3 on each slot's A panel and B block,
                matmul_full (and split_bf16 x2) on each of the DIST_SLOTS^2
                contractions and K4 on each slot's C panel, each result slot by slot
                against the f64 oracle (the CSR ones also through
                to_scipy()), no slot densifying more than its own rows, and
                K3 and K4 bit for bit against their plain versions at every
                slot's shape; 16. dist-sparse -- the sparse ring at
                1,000,000^2, nnz 1e7 per operand (balance "flops"), against
                spgemm_host and the single-device multiply (identical
                structure), and request (a)'s pair on 3 slots (an odd
                ring); 17. dist-triple -- the dense triple product at the
                inversion's H and Q (compute_full_matrix 0 and 1; K3 on each
                slot's H panel and Q block, matmul_full on each contraction
                of its two rings) and the
                sparse one at H 20,000 x 1,000,000 (200 per row) with Q the
                1M^2 operand, each slot against an f64 oracle, the sparse
                one twice with the same bits; 18. dist-io -- save_partitioned
                of the 1M^2 operand, load_sharded_operand feeding the sparse
                ring: the in-memory run's bits; 19. dist-timing -- each
                request end to end by stages (planning, ingest, ring,
                download), warm, min of 3, the ring's peak device memory,
                and the single-device port on the same products.  Then one
                JSON line {"dist": ...}.
 20. fetch -- fetch_np's staged download (two pinned staging buffers)
                against .cpu().numpy(), bit for bit, at 200 MB in f32, f64
                and int32, just past a chunk edge and in f32 at 4 KiB, 1,
                4, 16 and 32 MiB, as it is and cast to f64, on a card that
                is not current where there are two; both paths timed side
                by side, and the 200 MB f32 -> f64
                download through staging buffers of 16, 32 and 64 MiB.
                Then one JSON line {"fetch": ...} after {"cost_model": ...}.
     cost-model -- the router's host/device cost model (api._route_costs)
                fitted on this host and link: the first writes of 64 and
                128 MiB host arrays (host_page_rate, which the other rates
                are net of); fetch_np's downloads of 4 and 12 MiB cast to
                f64 into arrays under the mmap threshold (host_copy_rate;
                beside it the same kept f32 and a fit pooling both);
                spgemm_host at reuse ~1, ~10 and ~100 (JAX's sqrt(reuse)
                host_rate_base and the CUDA model's host_partial_rate and
                host_entry_rate), at two products of an A with one entry
                per row (host_copy_entry_rate, net of the partials term;
                each point's residual under the two work terms and with the
                copy term) and at two products whose output passes the mmap
                threshold (host_out_page_rate); the windowed ESC route on
                the card at four products, two of them past the threshold,
                by the stages the router times (the engine: esc_fixed_s and
                esc_engine_rate; the uploads net of their three transfers
                an operand: host_upload_rate; the window plan: esc_plan_rate;
                to_scipy net of its link, copies and fresh pages:
                host_csr_rate); the row-chunked ESC route at 18, 9 and 4
                chunks of one product and 12 of another (host_slice_rate on
                the "download" stage net of the rest of it; [chunk-stages],
                one line each: every stage priced beside the measured one,
                the priced chunk count beside the route's); the dense
                routes' host-work rates, each on its own fit points (the
                full triangle's index rebuild, f64 panels, csr_matrix of a
                small panel, scipy's triple, dense_pack), each with its
                residuals; the link probe in a fresh process (this
                script with --cold-cost-model: the cold run) and here
                (warm), each beside a directly timed 200 MiB download by
                fetch_np and upload; then [cost-sweep], one line per
                request (nine and seven held out, request (d) among them): the
                model's estimates and pick under this run's fit, the cold
                run's pick (the same fit) and the committed defaults' pick
                beside it, the host and device routes interleaved (a warm
                call each, then 3 rounds of host, device; 1 where a warm
                call took over 0.5 s; each round's host/device ratio), an
                ESC route's device stages beside the ones this run's fit
                prices, and the model's route, warm, min of 3 (1 likewise),
                the pick wrong only where the other route is faster by more
                than 1.15x (each way's least time), marked unsteady where
                its rounds fall on both sides of that margin, each result
                against scipy at the oracle, K1-K4 launched over the sweep;
                whether both runs made the same picks, the probes' ratio,
                request (a) as the model decides against the faster forced
                route, request (d)'s est_dev against its device route and
                its picks; then (demo) examples/demo_torch.py on the card,
                every line [ok].  The counted requests of phases 4, 8, 11
                and 13 print the model's est_host/est_dev; one the model
                would send to the host is pinned on its device route
                (ON_DEVICE) and named.  The link is calibrated once before
                phase 4, so no first-call time includes it.  Then one JSON
                line {"cost_model": ...}.

Then a JSON line of the kernels (launches summed over the eleven counted paths;
K2, K3 and K4 also by shape: each product or operand of a counted request is
held against the plain version in phase 3, 7, 15 or 17, and its launches counted).  A kernel's "ms" is its whole call on an idle stream, the
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
import tempfile
import time

import numpy as np
import scipy.sparse as sp
import torch

import sparse_matrix_mult_tpu_torch as smt
from sparse_matrix_mult_tpu_torch import api
from sparse_matrix_mult_tpu_torch import io as smt_io
from sparse_matrix_mult_tpu_torch.ops.convert import csr_to_dense
from sparse_matrix_mult_tpu_torch.ops.dense_path import _split3_within_oracle, spgemm_dense_out
from sparse_matrix_mult_tpu_torch.ops.kernels import LAUNCHES, _build, reset_launches
from sparse_matrix_mult_tpu_torch.ops.kernels import bsr_spgemm as kb
from sparse_matrix_mult_tpu_torch.ops.kernels import convert_kernels as ck
from sparse_matrix_mult_tpu_torch.ops.kernels import full_matmul as fm
from sparse_matrix_mult_tpu_torch.ops.kernels import triu_matmul as tm
from sparse_matrix_mult_tpu_torch.ops.matmul import full_fp32
from sparse_matrix_mult_tpu_torch.ops.spgemm_binned import spgemm_esc_binned
from sparse_matrix_mult_tpu_torch.ops.spgemm_esc import windowed_plan
from sparse_matrix_mult_tpu_torch.ops.triple_product import triple_product_dense
from sparse_matrix_mult_tpu_torch.models.inversion import invert, posterior_covariance
from sparse_matrix_mult_tpu_torch.parallel import distributed as td
from sparse_matrix_mult_tpu_torch.parallel.mesh import row_mesh
from sparse_matrix_mult_tpu_torch.types_bsr import _tobsr_padded
from sparse_matrix_mult_tpu_torch.utils.native import (
    dense_pack, expansion_size, spgemm_host)
from sparse_matrix_mult_tpu_torch.utils.testing import hypersparse_random
from sparse_matrix_mult_tpu_torch.utils.transfer import (
    STAGE_BYTES, fetch_np, fine_capacity, staged_fetch)

from benchmarks_torch.common import (
    ATOL, ON_DEVICE, RTOL, block_sparse, config_set, csr_bytes, csr_on_card, hyper_pair, mirror,
    operands, require, roofline, same_csr, triple_oracle, within_bound)
from benchmarks_torch.stages import (
    bsr_route_stages, dense_route_stages, stage_samples, triple_route_stages)
from benchmarks_torch.trace import call_timeline, op_us

N, DENSITY = 10_000, 0.1  # the reference's headline configuration (bench.py)
SIB_N, SIB_DENSITY = 12_288, 0.006  # dense route, ~36% dense product
# BSR route: the block-structured operands of benchmarks/run.py:573-596
# (8192^2, 128^2 blocks, 10% occupied, dense standard-normal blocks), and a
# uniformly sparse B_u whose every block is occupied.
BSR_N, BSR_BLOCK, BSR_OCC, BSR_SEEDS = 8192, 128, 0.10, (21, 22)
# A's block occupancies of the crossover phase, by size (B the BSR_OCC one
# of the same size): the cutoff of the BSR route on CUDA is the largest at
# which the route wins end to end.
CROSSOVER_OCCS = ((BSR_N, (0.002, 0.005, 0.01, 0.02, 0.05, 0.10, 0.25)),
                  (2 * BSR_N, (0.002, 0.005)))
BU_DENSITY, BU_SEED = 0.01, 23
FUSED_LANES = (2048, 8192, 16384)  # K7 must give the same output at each
TRIPLE_Q_SEED = 3  # Q of the triple product: N^2, DENSITY (benchmarks/run.py:275-277)
# Inversion-shaped problem (n_obs << n_state): H d=0.05, Q from A d=0.002.
INV_OBS, INV_STATE, INV_H_DENSITY, INV_Q_DENSITY, INV_SEED = 4096, 16_384, 0.05, 0.002, 31
INV_TOL = 1e-3  # |got - ref|_inf <= INV_TOL * |ref|_inf, float32 against the f64 oracle
# The sparse-output ladder (phases 13-14), each request's operands from
# hypersparse_random.  (a) 200,000^2, nnz 2e6 each (benchmarks/run.py:305-308):
# ~2e7 partials, "esc_binned" (named: BINNED); (b) the same as the router
# takes it on CUDA: "esc_windowed"; (c) one
# entry per row of a 40,000 x 50,000 A times B 50,000^2 at d = 0.002 (~4e6
# partials, B rows of ~100 entries: no window qualifies): "esc"; (d)
# 1,000,000^2, nnz 7e6 each (~4.9e7 partials, past the binned budget):
# "esc_chunks"; (e) 30,000 x 10,000 at d = 0.002 times 10,000^2 at d = 0.01
# (m n past dense_path_limit, k n inside it, ~6e7 partials): "dense_chunks".
# Device-resident timing also at 1,000,000^2, d = 1e-5 (~1e8 partials, the
# single_chip row of benchmarks/results_large_sparse_cpu.json).
ESC_N, ESC_NNZ, ESC_SEEDS = 200_000, 2_000_000, (11, 12)
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
# matmul_full (the JAX package's HIGHEST jnp.dot) against the six passes of
# its own pieces summed in f64, in units of |A| |B|; against its plain
# version (the same six passes, each an FP32 cuBLAS product, whose own
# rounding reaches 3.6e-6 of |A| |B| at posterior_covariance's (Q H^T) K^T
# on an H100) and FP32 torch.matmul RTOL, as K1 against its plain version.
FULL_PIECES_TOL = 1e-6
# K1's split3 branch against the f64 oracle at the configurations of
# benchmarks/results_accuracy_tpu.json (seeds 1 and 2, as benchmarks/accuracy.py).
SPLIT3_CONFIGS = ((500, 0.3), (2000, 0.05), (N, DENSITY))
# The tensor-core kernels (K1, K5) and K6 are held here to the bf16 rate of
# the passes their HIGHEST branch runs, six per f32 product (the benchmark,
# benchmarks_torch/work.py, holds every function to one pass).
KERNEL_RUNS = 5
SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's clock, longer than any wrapper's host work (device_ms)
PATH_RUNS = 3
DEVICE = "cuda"

KERNELS = {
    # launch-counter key: (name, source, replaced TPU kernel)
    "matmul_triu": ("K1 matmul_triu", "sparse_matrix_mult_tpu_torch/csrc/triu_matmul.cu",
                    "sparse_matrix_mult_tpu/ops/pallas/triu_matmul.py:58"),
    "matmul_full": ("matmul_full (HIGHEST f32 GEMM)",
                    "sparse_matrix_mult_tpu_torch/csrc/full_matmul.cu",
                    "sparse_matrix_mult_tpu/ops/matmul.py:58"),
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
# Each names its route (BSR_ROUTE): on the H100 the router sends block-sparse
# operands to the dense route (Config.cuda_bsr_occupancy_cutoff 0).
BSR_ROUTE = dict(force_bsr=True)
K6_PATH = ("split_bf16", "bsr_pair_runs", "bsr_bsr_matmul_dense")  # a K6 call's kernels
BSR_REQUESTS = (
    ("bsr_x_bsr_8192", "b", dict(), K6_PATH),
    ("bsr_x_bsr_symmetric_8192", "b", dict(symmetric=True), K6_PATH + ("dense_to_csr_triu",)),
    ("bsr_x_dense_8192", "bu", dict(), ("csr_to_dense", "split_bf16", "bsr_matmul_dense")),
    ("bsr_dense_output_8192", "b", dict(output_format="dense"), K6_PATH),
)


# The ladder's requests: (label, operands, keywords, Config keywords, route).
# On CUDA the binned rung runs only when named (BINNED); (b) is the default.
BINNED = dict(binned_esc_on_cuda=True)
ESC_REQUESTS = (
    ("esc_binned_a", "esc", dict(), BINNED, "esc_binned"),
    ("esc_binned_symmetric_a", "esc", dict(symmetric=True), BINNED, "esc_binned"),
    ("esc_windowed_b", "esc", dict(), dict(), "esc_windowed"),
    ("esc_classic_c", "classic", dict(), dict(use_binned_esc=False), "esc"),
    ("esc_chunks_d", "chunks", dict(), dict(), "esc_chunks"),
    ("dense_chunks_e", "dchunks", dict(), dict(), "dense_chunks"),
)
# The ladder's requests timed end to end with their stages (phase 14): the
# binned and windowed routes on the same operands side by side, and the chunks.
TIMED_ESC = ("esc_binned_a", "esc_windowed_b", "esc_chunks_d")
PRICED_ESC = ("esc_windowed_b", "esc_chunks_d")  # their stages beside the model's

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


def full_bound(m: int, n: int, k: int) -> dict:
    """matmul_full's bound: six bf16 passes of its 2 m n k flops at the bf16
    peak, or its f32 operands read and result written."""
    return dict(roofline(4.0 * (m * k + k * n + m * n), 6 * 2.0 * m * n * k, "bf16"),
                flops_f32=2.0 * m * n * k)


def six_passes_f64(ap, bp, m: int, n: int) -> torch.Tensor:
    """The six passes of the bf16 pieces summed in f64 on the card (a check
    only): each product of two pieces exact, the sums rounded to f64."""
    out = torch.zeros((m, n), dtype=torch.float64, device=ap.device)
    for pa, pb in ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)):
        out += ap[pa, :m].double() @ bp[pb, :n].double().T
    return out


def full_at(a, b, transpose_b: bool = False, pieces=None, faster: bool = False) -> dict:
    """matmul_full on (a, b) at one of the main path's shapes, on the pieces
    ``pieces`` (A's, B's) where the path shares them: the whole call the
    bits of its GEMM alone on those pieces; its upper tiles bit for bit K1's
    GEMM on the same pieces; within FULL_PIECES_TOL of (|A| |B|) of the six
    passes of the pieces summed in f64, and RTOL of its plain version and of
    FP32 torch.matmul.  Then the whole call, its GEMM alone, the plain
    version and FP32 torch.matmul timed, beside the six-pass bound; with
    ``faster`` the whole call must beat FP32 torch.matmul."""
    m, k = a.shape
    n = b.shape[0] if transpose_b else b.shape[1]
    bt = b.T if transpose_b else b
    ap, bp = pieces or (tm.split_bf16(a, 3), tm.split_bf16(b, 3, transpose=not transpose_b))
    label = f"matmul_full {m}x{k} . {k}x{n}"
    got = fm.matmul_full_pieces(ap, bp, m, n)
    require(torch.equal(got, fm.matmul_full(a, b, transpose_b)),
            f"{label}: the whole call differs from its GEMM on the pieces")
    upper = (torch.arange(m, device=a.device)[:, None] // tm.TILE
             <= torch.arange(n, device=a.device) // tm.TILE)
    require(torch.equal(got[upper], tm.matmul_triu_pieces(ap, bp, m, n)[upper]),
            f"{label}: the upper tiles differ from K1's on the same pieces")
    del upper
    unit = fp32_matmul(a.abs(), bt.abs()).clamp_min(1e-30)
    pieces_rel_err = float(((got - six_passes_f64(ap, bp, m, n)).abs() / unit).max())
    err = (got - fm.matmul_full_pieces_plain(ap, bp, m, n)).abs()
    max_abs_err, plain_rel_err = float(err.max()), float((err / unit).max())
    err = (got - fp32_matmul(a, bt)).abs()
    fp32_rel_err = float((err / unit).max())
    del err, unit, got
    require(pieces_rel_err <= FULL_PIECES_TOL, f"{label}: {pieces_rel_err:.3e} of |A||B| from "
            f"the six passes of its pieces (f64), above {FULL_PIECES_TOL}")
    require(plain_rel_err <= RTOL, f"{label}: {plain_rel_err:.3e} of |A||B| from its plain "
            f"version, above {RTOL}")
    require(fp32_rel_err <= RTOL, f"{label}: {fp32_rel_err:.3e} of |A||B| from FP32 "
            f"torch.matmul, above {RTOL}")
    r = dict(shape=[m, k, n], transpose_b=transpose_b, max_abs_err=max_abs_err,
             pieces_rel_err=pieces_rel_err, plain_rel_err=plain_rel_err,
             fp32_rel_err=fp32_rel_err,
             ms=event_ms(lambda: fm.matmul_full(a, b, transpose_b)),
             gemm_ms=event_ms(lambda: fm.matmul_full_pieces(ap, bp, m, n)),
             plain_ms=event_ms(lambda: fm.matmul_full_plain(a, b, transpose_b)),
             library_ms=event_ms(lambda: fp32_matmul(a, bt)), **full_bound(m, n, k))
    require(r["ms"] < r["library_ms"] or not faster,
            f"{label}: {r['ms']:.3f} ms, not faster than FP32 torch.matmul ({r['library_ms']:.3f})")
    return r


def full_line(label: str, r: dict) -> str:
    return (f"matmul_full {label} {'x'.join(map(str, r['shape']))}"
            f"{' (B as N x K)' if r['transpose_b'] else ''}: {timing(r)}; GEMM alone "
            f"{r['gemm_ms']:.3f} ms ({r['bound_ms'] / r['gemm_ms']:.1%} of the six-pass bound); "
            f"against the six passes of its pieces (f64) {r['pieces_rel_err']:.2e} of |A||B| "
            f"(limit {FULL_PIECES_TOL:.0e}), against its plain version {r['plain_rel_err']:.2e} "
            f"and FP32 torch.matmul {r['fp32_rel_err']:.2e} (limit {RTOL:.0e}); upper tiles bit "
            f"for bit K1's")


def dense_f32(mat) -> torch.Tensor:
    """A scipy CSR matrix as a dense f32 tensor on the card (K3)."""
    return csr_to_dense(smt.from_scipy(mat, dtype=torch.float32, device=DEVICE))


def full_main_shapes(ad, bd, sa_sp, sb_sp, dc_a_sp, dc_b_sp) -> dict:
    """:func:`full_at` at every shape the counted main path gives matmul_full,
    on operands formed as the path forms them: the non-symmetric 12,288^2
    A B; the triple's 10k H Q on the pieces H shares with K1; the
    inversion's Q H^T and posterior_covariance's (Q H^T) K^T (K^T by the
    Cholesky solve of S = H Q H^T + diag(R)); each chunk's product of the
    dense-chunks request (e); a ring slot's contraction of the distributed
    dense product (slot 0's A columns of block 1 against B's block 1); and
    slot 0's first contraction of each ring of the dense distributed triple
    at the inversion's H and Q (ring 1: H's panel columns times a Q block;
    ring 2: T's panel times H's panel transposed)."""
    shapes = {}
    x, y = dense_f32(sa_sp), dense_f32(sb_sp)
    shapes[f"nonsym_a_b_{SIB_N}"] = full_at(x, y, faster=True)
    x = dense_f32(sp.random(N, N, density=DENSITY, format="csr", random_state=TRIPLE_Q_SEED))
    shapes[f"triple_h_q_{N}"] = full_at(
        ad, x, pieces=(tm.split_bf16(ad, 3), tm.split_bf16(x, 3, transpose=True)), faster=True)
    h_sp, q_sp, _, _, r_diag = inversion_problem()
    x, y = dense_f32(h_sp), dense_f32(q_sp)
    shapes[f"inversion_q_ht_{INV_STATE}x{INV_OBS}"] = full_at(y, x, transpose_b=True)
    qht = fm.matmul_full(y, x, transpose_b=True)
    h = smt.from_scipy(h_sp, dtype=torch.float32, device=DEVICE)
    q = smt.from_scipy(q_sp, dtype=torch.float32, device=DEVICE)
    s = triple_product_dense(h, q, compute_full_matrix=1) + torch.diag(
        torch.from_numpy(r_diag).to(DEVICE, torch.float32))
    with full_fp32():
        kt = torch.cholesky_solve(qht.T, torch.linalg.cholesky(s)).contiguous()
    shapes[f"covariance_qht_kt_{INV_STATE}x{INV_OBS}"] = full_at(qht, kt)
    del x, y, qht, s, kt
    b = dense_f32(dc_b_sp)
    for start, stop in dense_chunk_bounds(dc_a_sp, DCHUNKS_K):
        shapes[f"dense_chunk_{start}_{stop}"] = full_at(dense_f32(dc_a_sp[start:stop]), b)
    del b
    rows = -(-N // DIST_SLOTS)
    shapes[f"ring_slot_{rows}x{rows}x{N}"] = full_at(
        ad[:rows, rows:2 * rows].contiguous(), bd[rows:2 * rows].contiguous())
    mesh = dist_mesh()
    hs, qs = td.shard_csr(h_sp, mesh), td.shard_csr(q_sp, mesh)
    kb, rows_pad = qs.rows_pad, hs.rows_pad
    require(DIST_SLOTS * kb == INV_STATE, "the triple's rings pad K: form the panels as they do")
    h0 = td._local_dense(hs.indptrs[0], hs.indices[0], hs.values[0], rows_pad, INV_STATE)
    q_blocks = [td._local_dense(qs.indptrs[j], qs.indices[j], qs.values[j], kb, INV_STATE)
                for j in range(DIST_SLOTS)]
    t0 = torch.zeros((rows_pad, INV_STATE), dtype=torch.float32, device=DEVICE)
    for j, block in enumerate(q_blocks):
        t0 += fm.matmul_full(h0[:, j * kb:(j + 1) * kb].contiguous(), block)
    shapes[f"dist_triple_ring1_{rows_pad}x{kb}x{INV_STATE}"] = full_at(
        h0[:, :kb].contiguous(), q_blocks[0])
    shapes[f"dist_triple_ring2_{rows_pad}x{INV_STATE}x{rows_pad}"] = full_at(
        t0, h0, transpose_b=True)
    return shapes


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


def least_stages(make) -> dict:
    """Host-clock seconds of each stage of a request, calling in order the
    functions its route calls (benchmarks_torch/stages.py): the least of
    PATH_RUNS + 1 runs."""
    return {k: min(v) for k, v in stage_samples(make, PATH_RUNS + 1, DEVICE).items()}


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


def abs_bsr(m):
    return smt.BSRMatrix(indptr=m.indptr, indices=m.indices, blocks=m.blocks.abs(), shape=m.shape)


def compare_extract(c: torch.Tensor, triu: bool, cap: int | None = None):
    """Kernel K2/K4 against the plain version on one matrix at capacity
    ``cap`` (default: the bucketed nnz): both times, the nnz and the largest
    difference of the values, the call's device time alone and by kernel."""
    nnz = int(torch.count_nonzero(torch.triu(c) if triu else c))
    cap = cap or smt.bucket_capacity(nnz)
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
    return dict(shape=[m, n], ms=ms, plain_ms=plain_ms, nnz=nnz, capacity=cap, max_abs_err=err,
                library_ms=lib,
                device_ms=event_ms(lambda: ck.dense_to_csr(c, cap, triu=triu), queued=True),
                kernels_us=op_us(lambda: ck.dense_to_csr(c, cap, triu=triu)),
                **roofline(read * c.element_size() + csr_bytes(m, cap, c.element_size())))


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
    code = _build.launch(
        "smm_bsr_bsr_matmul_dense_bf16", c.device,
        bounds.data_ptr(), tables[0].data_ptr(), tables[1].data_ptr(), mask.data_ptr(),
        ap.data_ptr(), bp.data_ptr(), c.data_ptr(), work.data_ptr(), a.nbr, b.nbc,
        a.block_capacity, b.block_capacity, c.shape[0], c.shape[1])
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
        kernels_us=op_us(lambda: kb.bsr_bsr_matmul_dense(a, b, *tables, mask)),
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
    """Request 1's form, A x B (A from block_sparse's generator, seed
    BSR_SEEDS[0]; B the BSR_OCC one, ``b_sp`` at BSR_N), at each size and A
    occupancy of CROSSOVER_OCCS: end to end on the BSR route (force_bsr) and
    on the dense route (use_bsr=False), min of PATH_RUNS each; the BSR
    route's product kernel, and the same nnz on both."""
    rows = []
    bsz = smt.get_config().block_size
    for n, occs in CROSSOVER_OCCS:
        b_n = b_sp if n == BSR_N else block_sparse(BSR_SEEDS[1], BSR_OCC, n)
        for occ in occs:
            a_sp = block_sparse(BSR_SEEDS[0], occ, n)
            plan = kb.bsr_pair_plan(a_sp, b_n, bsz)
            row = dict(n=n, occupancy=api.block_occupancy(a_sp, bsz),
                       pairs=0 if plan is None else plan["n_pairs"])
            nnz = {}
            for route, cfg in (("bsr", dict(force_bsr=True)), ("dense", dict(use_bsr=False))):
                with config_set(**cfg):
                    before = dict(LAUNCHES)
                    row[route], got, taken = best_call(
                        lambda: smt.sparse_matrix_multiply(a_sp, b_n))
                    require(taken == route, f"crossover at {n}^2, {occ}: not route {route!r}")
                    nnz[route] = got.nnz
                    del got
                    if route == "bsr":
                        row["kernel"] = ("K6" if LAUNCHES["bsr_bsr_matmul_dense"]
                                         > before["bsr_bsr_matmul_dense"] else "K5")
            require(nnz["bsr"] == nnz["dense"], f"crossover at {n}^2, {occ}: nnz differs")
            rows.append(row)
            del a_sp
        del b_n
    return rows


def crossover_cutoff(rows) -> float:
    """The largest measured A occupancy at which the BSR route wins end to
    end, or 0 where it wins at none."""
    return max([r["occupancy"] for r in rows if r["bsr"] < r["dense"]], default=0.0)


def uniform_bu():
    """The BSR path's uniformly sparse B_u (every block occupied)."""
    return sp.random(BSR_N, BSR_N, density=BU_DENSITY, format="csr", random_state=BU_SEED)


def k3_at(mat_sp) -> dict:
    """K3 on one operand the counted paths densify (:func:`k3_csr`)."""
    x = smt.from_scipy(mat_sp, dtype=torch.float32, device=DEVICE)
    return k3_csr((x.indptr, x.indices, x.values, x.shape))


def k3_same(csr) -> None:
    """K3 bit for bit against its plain version and K8 on one padded CSR."""
    got = ck.csr_to_dense(*csr)
    require(torch.equal(got, ck.csr_to_dense_plain(*csr)), f"K3 {csr[3]} differs from plain")
    require(torch.equal(got, ck.csr_to_dense_fused(*csr)), f"K3 {csr[3]} differs from K8")


def k3_csr(csr) -> dict:
    """K3 on one padded CSR (indptr, indices, values, shape): bit for bit
    against its plain version and K8, and its, K8's, the plain version's and
    the library call's times beside its bound (the CSR read once, the dense
    written once)."""
    k3_same(csr)
    m, n = csr[3]
    nnz = int(csr[0][-1])
    return dict(shape=[m, n], nnz=nnz, max_abs_err=0.0,
                ms=event_ms(lambda: ck.csr_to_dense(*csr)),
                k8_ms=event_ms(lambda: ck.csr_to_dense_fused(*csr)),
                device_ms=event_ms(lambda: ck.csr_to_dense(*csr), queued=True),
                k8_device_ms=event_ms(lambda: ck.csr_to_dense_fused(*csr), queued=True),
                plain_ms=event_ms(lambda: ck.csr_to_dense_plain(*csr)),
                library_ms=event_ms(lambda: sparse_csr(*csr).to_dense()),
                **roofline(csr_bytes(m, nnz) + csr[2].element_size() * m * n))


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


# (est_host, est_dev) of each counted request, by label, and the labels whose
# device route had to be pinned because the cost model would take the host.
MODEL_ESTIMATES, MODEL_PINNED = {}, []


def model_costs(a_sp, b_sp, **kw):
    """(est_host, est_dev) seconds the router's cost model gives a request
    (api._request_costs: the branch's expansion, download and device route)."""
    return api._request_costs(a_sp, b_sp, DEVICE, **kw)


def model_pin(label, a_sp, b_sp, **kw) -> dict:
    """Record the cost model's estimates of a counted request; the config
    that keeps it on its device route: ON_DEVICE where the model would take
    the host (the phase's line names it), else nothing."""
    MODEL_ESTIMATES[label] = model_costs(a_sp, b_sp, **kw)
    if MODEL_ESTIMATES[label][0] < MODEL_ESTIMATES[label][1]:
        MODEL_PINNED.append(label)
        return ON_DEVICE
    return {}


def pinned_like(label) -> dict:
    """The pin of counted request ``label`` (:func:`model_pin`), for another
    call on its operands."""
    return ON_DEVICE if label in MODEL_PINNED else {}


def model_note(labels) -> str:
    """The cost model's verdict on the counted requests ``labels``, for a phase line."""
    ratios = {label: round(MODEL_ESTIMATES[label][0] / MODEL_ESTIMATES[label][1], 2)
              for label in labels}
    pinned = [label for label in labels if label in MODEL_PINNED]
    return (f"cost model est_host/est_dev {ratios}: "
            + (f"model pinned on the device for {pinned}" if pinned
               else "every request on the device by the model"))


def request(label, a_sp, b_sp, cfg=None, **kw):
    """A call for :func:`counted`: sparse_matrix_multiply under ``cfg`` and
    its route, the cost model pinned where it would take the host
    (:func:`model_pin`)."""
    pin = model_pin(label, a_sp, b_sp, **kw)

    def call(_):
        with config_set(**(cfg or {}), **pin):
            return smt.sparse_matrix_multiply(a_sp, b_sp, **kw), smt.get_last_route()
    return call


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
        ref = torch.triu(torch.matmul(csr_on_card(a_sp, DEVICE), csr_on_card(b_sp, DEVICE)))
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


def triple_phase(h_sp, q_sp, name: str, smi: str):
    """Phase 11: the triple product through sparse_matrix_multiply, counted,
    each result against the f64 oracle; then its times."""
    t0 = time.perf_counter()
    labels = [f"triple_{N}_full{cfm}" for cfm in (0, 1)]
    answers = {}
    reset_launches()
    per_call, seconds = counted(
        [(label, request(label, h_sp, q_sp, use_triple_product=True, compute_full_matrix=cfm))
         for cfm, label in enumerate(labels)], answers)
    launches = dict(LAUNCHES)
    results, routes = split_answers(answers)
    del answers
    c64, bound64 = triple_oracle(h_sp, q_sp, DEVICE)
    errs = {}
    for cfm, label in enumerate(labels):
        got, route = results.pop(label), routes[label]
        require(route == "triple", f"{label}: route {route!r} != 'triple'")
        only_kernels(label, per_call[label], {"csr_to_dense": 2, "split_bf16": 3,
                                              "matmul_full": 1, "matmul_triu": 1})
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
        + [model_note(labels), f"launches by request {per_call}", f"launches {launches}"]))

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
    stages = least_stages(lambda: triple_route_stages(h_sp, q_sp, 1, DEVICE))
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
    # Each call: the triple (K3 x2, H's, Q's and T's splits, matmul_full on
    # the pieces, K1), K3 x2 and Q H^T; posterior_covariance also (Q H^T) K^T.
    for label, full in ((label_inv, 2), (label_cov, 3)):
        only_kernels(label, per_call[label], {"csr_to_dense": 4, "split_bf16": 1 + 2 * full,
                                              "matmul_full": full, "matmul_triu": 1})

    h64, q64 = csr_on_card(h_sp, DEVICE), csr_on_card(q_sp, DEVICE)
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


def esc_request(label, a_sp, b_sp, kw, cfg):
    """A call for :func:`counted`: sparse_matrix_multiply under ``cfg``, its
    route and the route's detail (the cost model pinned as in :func:`request`)."""
    pin = model_pin(label, a_sp, b_sp, **kw)

    def call(_):
        with config_set(**cfg, **pin):
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
        [(label, esc_request(label, *ops[key], kw, cfg))
         for label, key, kw, cfg, _ in ESC_REQUESTS],
        answers)
    launches_esc = dict(LAUNCHES)
    details = {}
    for label, _, _, _, route in ESC_REQUESTS:
        got_route, details[label] = answers[label][1]
        require(got_route == route, f"{label}: route {got_route!r} != {route!r}")
        dense_chunks = route == "dense_chunks"
        for key in KERNELS:
            launched = per_request[label][key]
            if dense_chunks and key in ("csr_to_dense", "matmul_full", "split_bf16"):
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
    with config_set(**BINNED, **pinned_like("esc_binned_a")):
        again = smt.sparse_matrix_multiply(*ops["esc"])
    same_bits(again, kept["esc_binned_a"], "esc_binned_a")
    del answers, again
    phase("esc-main", t0, " | ".join(
        [f"{label} ({route}{', ' + str(details[label]) if details[label] else ''}"
         f"{''.join(f', {key} {value}' for key, value in cfg.items())}): "
         f"nnz {nnz[label]}, max abs err vs scipy {errs[label]:.2e}, first call "
         f"{seconds[label]:.3f} s" for label, _, _, cfg, route in ESC_REQUESTS]
        + ["esc_binned_a twice: the same bits",
           "dense_chunks_e extracted by " + ("K4" if per_request["dense_chunks_e"]["dense_to_csr"]
                                             else "host packing"),
           f"dense_chunks_e: the committed model's est_dev "
           f"{MODEL_ESTIMATES['dense_chunks_e'][1]:.4f} s (est_host "
           f"{MODEL_ESTIMATES['dense_chunks_e'][0]:.4f} s), its one call "
           f"{seconds['dense_chunks_e']:.4f} s",
           model_note([label for label, _, _, _, _ in ESC_REQUESTS]),
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
    profiled = call_timeline(fn)
    t = time.perf_counter()
    host = spgemm_host(a_sp, b_sp)
    host_s = time.perf_counter() - t
    got = api._to_scipy_f64(c)
    err = same_csr(got, host, f"multiply ({engine}) {m}x{k} @ {k}x{n} against spgemm_host")
    nnz_c = got.nnz
    del c, got, host
    out = dict(engine=engine, rows=m, nnz_a=a_sp.nnz, nnz_b=b_sp.nnz, n_partials=expand,
               nnz_c=nnz_c, **tile, plan_host_s=plan_s, ms=ms, partials_per_s=expand / ms * 1e3,
               device_busy_s=profiled and profiled["busy_ms"] / 1e3,
               wall_s=profiled and profiled["wall_ms"] / 1e3,
               device_busy_share=profiled and profiled["busy_share"],
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


def model_c_d(ops: dict, kept_d) -> dict:
    """The cost model's estimates of requests (c), (d) and (e) as phase 13
    priced them (the committed rates), the time of the split of their output
    entries by A's row lengths (api._single_row_entries), (d) and (e) on the
    host route once, (d)'s result the oracle of ``kept_d``, the device
    route's, and (e) once more on its device route (warm), against the host
    route's result."""
    costs = {}
    for label, key in (("esc_classic_c", "classic"), ("esc_chunks_d", "chunks"),
                       ("dense_chunks_e", "dchunks")):
        a_sp, b_sp = ops[key]
        est_host, est_dev = MODEL_ESTIMATES[label]
        costs[label] = dict(est_host_s=est_host, est_dev_s=est_dev,
                            pick="host" if est_host < est_dev else "device",
                            copied=api._single_row_entries(a_sp, b_sp),
                            split_s=host_s(lambda: api._single_row_entries(a_sp, b_sp)))
    for label, key in (("esc_chunks_d", "chunks"), ("dense_chunks_e", "dchunks")):
        with config_set(**HOST_ROUTE):
            t = time.perf_counter()
            got = smt.sparse_matrix_multiply(*ops[key])
            costs[label]["host_route_s"] = time.perf_counter() - t
        require(smt.get_last_route() == "host", f"{label} under HOST_ROUTE left the host")
        if label == "dense_chunks_e":
            with config_set(**DEVICE_ROUTE):
                t = time.perf_counter()
                kept_d = smt.sparse_matrix_multiply(*ops[key])
                torch.cuda.synchronize()
                costs[label]["device_route_s"] = time.perf_counter() - t
            require(smt.get_last_route() == "dense_chunks",
                    f"{label} on its device route took {smt.get_last_route()!r}")
        costs[label]["host_route_max_abs_err"] = same_csr(kept_d, got, f"{label} against the host")
        del got
    return costs


def esc_timing_phase(ops: dict, kept: dict, name: str, smi: str) -> dict:
    """Phase 14: requests (a), (b) and (d) end to end with their stages
    (route_timing), (a)'s engine's device time by kernel, and each ESC
    engine device-resident: binned at (a) and at the 1M^2 d = 1e-5 product,
    windowed at (a), classic at (c)."""
    t0 = time.perf_counter()
    requests = {label: (key, cfg) for label, key, _, cfg, _ in ESC_REQUESTS}
    e2e = {label: route_timing(*ops[requests[label][0]],
                               {**requests[label][1], **pinned_like(label)}, kept[label], label)
           for label in TIMED_ESC}
    for label in PRICED_ESC:  # the routes the CUDA model prices by their stages
        e2e[label]["priced"] = api._request_stage_costs(*ops[requests[label][0]], DEVICE)
    a_sp, b_sp = ops["esc"]
    expand = expansion_size(a_sp.indices, a_sp.nnz, b_sp.indptr)
    plan = api._binned_plan_for(a_sp, b_sp, expand)
    a = smt.from_scipy(a_sp, dtype=torch.float32, device=DEVICE)
    b = smt.from_scipy(b_sp, dtype=torch.float32, device=DEVICE)
    args = plan.device_args(DEVICE)
    engine_us = op_us(lambda: spgemm_esc_binned(
        a, b, *args, window=plan.window, out_capacity=smt.bucket_capacity(expand)))
    del a, b, args, plan
    engines = {"binned_a": resident(*ops["esc"], "binned"),
               "windowed_a": resident(*ops["esc"], "windowed"),
               "classic_c": resident(*ops["classic"], "classic")}
    hyper = hyper_pair(HYPER_N, HYPER_N, HYPER_N, HYPER_NNZ, HYPER_NNZ, HYPER_SEEDS)
    engines[f"binned_{HYPER_N}"] = resident(*hyper, "binned")
    del hyper
    costs = model_c_d(ops, kept["esc_chunks_d"])
    esc = dict(card=name, nvidia_smi=smi, e2e=e2e, engine_kernels_us_esc_binned_a=engine_us,
               resident=engines, cost_model_c_d=costs)
    phase("esc-timing", t0, f"{name} [{smi}]: " + " | ".join(
        [f"{label} ({r['route']}) end to end {r['seconds']:.4f} s = {r['nnz_c_per_s']:.4e} "
         f"nnz(C)/s (min of {PATH_RUNS}, each call the same bits"
         f"{'; model pinned as in esc-main' if label in MODEL_PINNED else ''})"
         for label, r in e2e.items()]
        + [f"multiply {label} ({r['rows']} rows): {r['n_partials']} partials ("
           f"{', '.join(f'{key} {r[key]}' for key in ('window', 'lane_width', 'padded_slots', 'tail') if key in r)}"
           f"), plan {r['plan_host_s']:.3f} s host, "
           f"engine {r['ms']:.3f} ms ({r['partials_per_s']:.4e} partials/s; bound "
           f"{r['bound_ms']:.3f} ms by {r['bound_by']}), busy share "
           f"{r['device_busy_share'] if r['device_busy_share'] is None else round(r['device_busy_share'], 4)}, "
           f"peak {r['peak_bytes'] / 2**30:.2f} GiB; cuSPARSE "
           f"{r['cusparse_ms'] if r['cusparse_ms'] is None else round(r['cusparse_ms'], 3)} ms; "
           f"spgemm_host {r['spgemm_host_s']:.3f} s" for label, r in engines.items()]
        + [f"{label}: the committed model's est_host {c['est_host_s']:.4f} s, est_dev "
           f"{c['est_dev_s']:.4f} s -> {c['pick']} ({c['copied']} entries of one-entry rows "
           f"of A, counted in {c['split_s'] * 1e3:.4f} ms, min of {PATH_RUNS})"
           + (f"; the host route, one call, {c['host_route_s']:.4f} s, the device route "
              + (f"(dense_chunks, one warm call) {c['device_route_s']:.4f} s"
                 if "device_route_s" in c
                 else f"({e2e[label]['route']}) {e2e[label]['seconds']:.4f} s")
              if "host_route_s" in c else "") for label, c in costs.items()]))
    for label, r in e2e.items():
        priced = r.get("priced")
        print(f"[esc-stages] {label} ({r['route']}) sparse_matrix_multiply, host clock, the "
              f"fastest of {PATH_RUNS} calls ({r['seconds']:.4f} s) as the router timed it: "
              + json.dumps(r["stages"])
              + ("; priced by the committed model (est_dev "
                 f"{MODEL_ESTIMATES[label][1]:.4f} s), priced / measured s by stage: "
                 + ", ".join(f"{key} {value:.4f}/{r['stages'][key]:.4f}"
                             for key, value in priced.items()) if priced else ""), flush=True)
    return esc


# ---------------------------------------------------------------------------
# Phases 15-19: the multi-device layer (parallel/, io.py) on one card: a row
# mesh of DIST_SLOTS slots, all on the card (the machine has one), so the
# ring hands blocks between slots and moves no bytes between cards.
# ---------------------------------------------------------------------------

DIST_SLOTS, DIST_ODD_SLOTS = 4, 3
# The sparse triple product's H: 20,000 x 1,000,000 with 200 entries per row
# (Q the 1,000,000^2 operand of the sparse ring): a 5,000 x 20,000 C panel
# per slot.
DIST_H_ROWS, DIST_H_PER_ROW, DIST_H_SEED = 20_000, 200, 41


def csr_f64(mat) -> torch.Tensor:
    """The f64 torch.sparse CSR tensor of a scipy CSR, on the card."""
    return torch.sparse_csr_tensor(*(torch.from_numpy(x).to(DEVICE) for x in (
        mat.indptr.astype(np.int64), mat.indices.astype(np.int64), mat.data.astype(np.float64))),
        size=mat.shape)


def dist_mesh(slots: int = DIST_SLOTS):
    return row_mesh([DEVICE] * slots)


def per_row(m: int, k: int, per: int, seed: int):
    """(m, k) CSR with ``per`` entries per row in uniformly random columns
    (a repeated column sums), values in [0, 1)."""
    rng = np.random.default_rng(seed)
    return sp.coo_matrix((rng.uniform(size=m * per),
                          (np.repeat(np.arange(m), per), rng.integers(0, k, m * per))),
                         shape=(m, k)).tocsr()


def k3_slots(sharded, rows: int, cols: int) -> dict:
    """K3 on every slot's block of ``sharded``, densified as the rings do
    ((rows, cols)): bit for bit against its plain version and K8 at each
    slot, slot 0's block timed by :func:`k3_csr`."""
    csrs = [(ip[: rows + 1], ix, vv, (rows, cols)) for ip, ix, vv in
            sharded.local_shards().values()]
    for csr in csrs[1:]:
        k3_same(csr)
    return dict(slots=len(csrs), **k3_csr(csrs[0]))


def k4_slots(panels: list, cap: int) -> dict:
    """K4 on every slot's C panel at the ring's capacity, bit for bit against
    its plain version; slot 0's timed by :func:`compare_extract`."""
    for s, c in enumerate(panels[1:], 1):
        for g, r, field in zip(ck.dense_to_csr(c, cap), ck.dense_to_csr_plain(c, cap),
                               ("indptr", "indices", "values")):
            require(torch.equal(g, r), f"K4 slot {s} {tuple(c.shape)}: {field} differs from plain")
    return dict(slots=len(panels), **compare_extract(panels[0], triu=False, cap=cap))


def panel_close(what: str, panel: torch.Tensor, ref: torch.Tensor) -> float:
    """A slot's dense panel against its rows of the f64 oracle (on the
    card): the same nonzero structure, values within the oracle; returns
    the largest |difference|."""
    require(tuple(panel.shape) == tuple(ref.shape), f"{what}: shape {tuple(panel.shape)}")
    got = panel.double()
    require(torch.equal(got != 0, ref != 0), f"{what}: structure differs from the oracle")
    require(torch.allclose(got, ref, rtol=RTOL, atol=ATOL), f"{what}: outside the oracle")
    return float((got - ref).abs().max()) if got.numel() else 0.0


def slot_panels_close(label: str, panels: dict, bounds, want: torch.Tensor) -> float:
    """:func:`panel_close` of every slot's panel against its rows of ``want``."""
    return max(panel_close(f"{label} slot {s}", p, want[bounds[s]:bounds[s + 1]])
               for s, p in panels.items())


def slot_csr_dense(out) -> dict:
    """Each slot's CSR block of a ShardedCSR densified by K3's plain version
    (outside any counted window), trimmed to the slot's own rows."""
    bounds, n = out.row_bounds, out.shape[1]
    return {s: ck.csr_to_dense_plain(ip[: bounds[s + 1] - bounds[s] + 1], ix, vv,
                                     (bounds[s + 1] - bounds[s], n))
            for s, (ip, ix, vv) in out.local_shards().items()}


class densified_shapes:
    """The shape of every panel the rings densify inside a ``with`` block
    (a wrapper around the K3 entry point of parallel/distributed.py)."""

    def __enter__(self):
        self.shapes, self.real = [], td.csr_to_dense

        def spy(a, dtype=None):
            out = self.real(a, dtype=dtype)
            self.shapes.append(tuple(out.shape))
            return out

        td.csr_to_dense = spy
        return self.shapes

    def __exit__(self, *exc):
        td.csr_to_dense = self.real


def only_kernels(label: str, counts: dict, allowed: dict) -> None:
    """A request launched exactly ``allowed`` of each kernel and no other."""
    for key in KERNELS:
        require(counts[key] == allowed.get(key, 0), f"{label}: {counts[key]} "
                f"{KERNELS[key][0]} launches, not {allowed.get(key, 0)}")


def dist_dense_phase(a_sp, b_sp) -> dict:
    """Phase 15: the dense and CSR rings at the headline (10k^2, d = 0.1,
    symmetric) on DIST_SLOTS slots, counted (K3 on each slot's A panel and
    B block, K4 on each slot's C panel); each result against the f64 oracle
    slot by slot, the CSR ones also after to_scipy(); no slot densifies more
    than its own rows; K3 and K4 at the slots' shapes against their plain
    versions."""
    t0 = time.perf_counter()
    mesh = dist_mesh()
    flop_bounds = td.flop_shard_bounds(a_sp, b_sp, DIST_SLOTS)
    pa, pb = td.shard_csr(a_sp, mesh), td.shard_csr(b_sp, mesh)
    pa_f = td.shard_csr(a_sp, mesh, bounds=flop_bounds)
    lab_a, lab_b = f"dist_a_panel_{pa.rows_pad}x{N}", f"dist_b_block_{pb.rows_pad}x{N}"
    lab_af = f"dist_a_panel_flops_{pa_f.rows_pad}x{N}"
    lab_c, lab_cf = f"dist_c_panel_{pa.rows_pad}x{N}", f"dist_c_panel_flops_{pa_f.rows_pad}x{N}"
    labels = ("dist_dense_symmetric_10k", "dist_csr_symmetric_rows_10k",
              "dist_csr_symmetric_flops_10k")
    results = {}
    reset_launches()
    with densified_shapes() as shapes:
        per_call, seconds = counted([
            (labels[0], lambda _: td.spgemm_dense_distributed(a_sp, b_sp, symmetric=True,
                                                              mesh=mesh)),
            (labels[1], lambda _: td.spgemm_csr_distributed(a_sp, b_sp, symmetric=True,
                                                            mesh=mesh)),
            (labels[2], lambda _: td.spgemm_csr_distributed(a_sp, b_sp, symmetric=True,
                                                            mesh=mesh, balance="flops")),
        ], results)
    launches = dict(LAUNCHES)
    k3_map = {labels[0]: (lab_a, lab_b) * DIST_SLOTS, labels[1]: (lab_a, lab_b) * DIST_SLOTS,
              labels[2]: (lab_af, lab_b) * DIST_SLOTS}
    k4_map = {labels[1]: (lab_c,) * DIST_SLOTS, labels[2]: (lab_cf,) * DIST_SLOTS}
    for label in labels:
        only_kernels(label, per_call[label], {"csr_to_dense": 2 * DIST_SLOTS,
                                              "dense_to_csr": len(k4_map.get(label, ())),
                                              "matmul_full": DIST_SLOTS**2,
                                              "split_bf16": 2 * DIST_SLOTS**2})
    require(len(shapes) == 6 * DIST_SLOTS and max(r for r, _ in shapes) < N,
            f"a slot densified a full operand: panel shapes {sorted(set(shapes))}")
    require(results[labels[2]].row_bounds == flop_bounds, "flop bounds differ")

    c64 = torch.triu(torch.matmul(csr_on_card(a_sp, DEVICE), csr_on_card(b_sp, DEVICE)))
    nnz64 = int(torch.count_nonzero(c64))
    errs = {labels[0]: slot_panels_close(labels[0], results[labels[0]].local_shards(),
                                         results[labels[0]].bounds, c64)}
    for label in labels[1:]:
        out = results.pop(label)
        errs[label] = slot_panels_close(label, slot_csr_dense(out), out.row_bounds, c64)
        got = out.to_scipy()
        require(got.shape == (N, N) and got.nnz == nnz64, f"{label}: to_scipy() nnz {got.nnz} "
                f"!= the oracle's {nnz64}")
        del out, got
    del c64, results

    k3 = {lab_a: k3_slots(pa, pa.rows_pad, N), lab_b: k3_slots(pb, pb.rows_pad, N),
          lab_af: k3_slots(pa_f, pa_f.rows_pad, N)}
    k4 = {}
    for lab, a in ((lab_c, pa), (lab_cf, pa_f)):
        panels = td._dense_panels(mesh, a, pb)
        for s in range(DIST_SLOTS):
            panels[s].triu_(a.row_bounds[s])
        k4[lab] = k4_slots(panels, a.rows_pad * N)
        del panels
    del pa, pb, pa_f
    phase("dist-dense", t0, f"{DIST_SLOTS} slots on {DEVICE}, {N}^2 d={DENSITY} symmetric: "
          + " | ".join(f"{label}: max abs err {errs[label]:.3e} vs f64 oracle (structure "
                       f"equal), first call {seconds[label]:.3f} s" for label in labels)
          + f" | flop bounds {flop_bounds} | panel shapes densified {sorted(set(shapes))} | "
          + " | ".join(f"K3 {lab}: {timing(r)}, K8 {r['k8_ms']:.3f}, device alone "
                       f"{r['device_ms']:.3f}" for lab, r in k3.items())
          + " | " + " | ".join(f"K4 {lab} (nnz {r['nnz']}, capacity {r['capacity']}): "
                               f"{timing(r)}, device alone {r['device_ms']:.3f}"
                               for lab, r in k4.items())
          + f" | K3 and K4 bit for bit against plain at every slot | launches by request "
          f"{per_call} | launches {launches}")
    return dict(per_call=per_call, launches=launches, k3_map=k3_map, k4_map=k4_map,
                k3_shapes=k3, k4_shapes=k4, errs=errs, seconds=seconds)


def dist_sparse_plan(a_sp, b_sp, slots: int) -> dict:
    """The host planning of spgemm_csr_distributed_sparse for scipy
    operands: flop-balanced bounds and the three capacities."""
    bounds = td.flop_shard_bounds(a_sp, b_sp, slots)
    e_max, tot_max = td._expand_step_capacity(a_sp, b_sp.indptr, b_sp.shape[0], bounds, slots)
    e_step = fine_capacity(e_max)
    return dict(bounds=bounds, caps=dict(
        expand_step_capacity=e_step,
        shard_capacity=smt.bucket_capacity(min(tot_max, a_sp.shape[0] * b_sp.shape[1])),
        partials_capacity=fine_capacity(tot_max) + e_step))


def dist_sparse_phase(hyper, esc_pair) -> dict:
    """Phase 16: the sparse-local-contraction ring, counted: the 1M^2
    product (nnz 1e7 per operand, balance="flops") on DIST_SLOTS slots and
    request (a)'s 200,000^2 pair on DIST_ODD_SLOTS (an odd ring); no hand
    kernel runs.  Each against spgemm_host's f64 product (identical
    structure, values in the oracle), the 1M^2 one also against the
    single-device port's multiply (identical structure)."""
    t0 = time.perf_counter()
    a_sp, b_sp = hyper
    labels = ("dist_sparse_flops_1M", f"dist_sparse_{DIST_ODD_SLOTS}_slots_200k")
    mesh, mesh_odd = dist_mesh(), dist_mesh(DIST_ODD_SLOTS)
    results = {}
    reset_launches()
    per_call, seconds = counted([
        (labels[0], lambda _: td.spgemm_csr_distributed_sparse(a_sp, b_sp, mesh=mesh,
                                                               balance="flops")),
        (labels[1], lambda _: td.spgemm_csr_distributed_sparse(*esc_pair, mesh=mesh_odd,
                                                               balance="flops")),
    ], results)
    launches = dict(LAUNCHES)
    for label in labels:
        only_kernels(label, per_call[label], {})
    plan = dist_sparse_plan(a_sp, b_sp, DIST_SLOTS)
    out = results[labels[0]]
    require(out.row_bounds == plan["bounds"] and out.shard_capacity ==
            plan["caps"]["shard_capacity"], f"{labels[0]}: bounds or capacity differ from the plan")
    got = out.to_scipy()
    host = spgemm_host(a_sp, b_sp)
    errs = {labels[0]: same_csr(got, host, f"{labels[0]} against spgemm_host")}
    del host
    m, n = a_sp.shape[0], b_sp.shape[1]
    expand = expansion_size(a_sp.indices, a_sp.nnz, b_sp.indptr)
    a = smt.from_scipy(a_sp, dtype=torch.float32, device=DEVICE)
    b = smt.from_scipy(b_sp, dtype=torch.float32, device=DEVICE)
    single = api._to_scipy_f64(smt.multiply(a, b, out_capacity=smt.bucket_capacity(
        min(expand, m * n)), expand_capacity=smt.bucket_capacity(expand)))
    del a, b
    require(np.array_equal(single.indptr, got.indptr) and np.array_equal(single.indices,
                                                                          got.indices),
            f"{labels[0]}: structure differs from the single-device multiply")
    nnz = got.nnz
    del single, got
    odd = results.pop(labels[1])
    errs[labels[1]] = same_csr(odd.to_scipy(), spgemm_host(*esc_pair),
                               f"{labels[1]} against spgemm_host")
    del odd
    phase("dist-sparse", t0, " | ".join(
        [f"{labels[0]}: {DIST_SLOTS} slots, {expand} partials, nnz(C) {nnz}, bounds "
         f"{plan['bounds']}, capacities {plan['caps']}, max abs err {errs[labels[0]]:.2e} vs "
         f"spgemm_host (structure equal; equal to the single-device multiply's), first call "
         f"{seconds[labels[0]]:.3f} s",
         f"{labels[1]}: {DIST_ODD_SLOTS} slots, max abs err {errs[labels[1]]:.2e} vs "
         f"spgemm_host (structure equal), first call {seconds[labels[1]]:.3f} s",
         f"launches by request {per_call}", f"launches {launches}"]))
    return dict(per_call=per_call, launches=launches, kept=out, plan=plan, errs=errs,
                seconds=seconds)


def dist_triple_phase(q_sparse) -> dict:
    """Phase 17: both distributed triple products, counted: the dense ring
    at the inversion's H (4,096 x 16,384) and Q, compute_full_matrix 0 and
    1 (K3 on each slot's H panel and Q block), and the sparse one at H
    20,000 x 1,000,000 (200 per row) with Q the 1M^2 operand (no hand
    kernel), each slot against an f64 oracle; the sparse one twice, the
    same bits."""
    t0 = time.perf_counter()
    mesh = dist_mesh()
    h_sp, q_sp = inversion_problem()[:2]
    hs_sp = per_row(DIST_H_ROWS, HYPER_N, DIST_H_PER_ROW, DIST_H_SEED)
    labels = tuple(f"dist_triple_{INV_OBS}x{INV_STATE}_full{cfm}" for cfm in (0, 1)) + (
        f"dist_triple_sparse_{DIST_H_ROWS}x{HYPER_N}",)
    results = {}
    reset_launches()
    per_call, seconds = counted(
        [(labels[cfm], lambda _, cfm=cfm: td.triple_product_distributed(h_sp, q_sp, cfm,
                                                                         mesh=mesh))
         for cfm in (0, 1)]
        + [(labels[2], lambda _: td.triple_product_distributed_sparse(hs_sp, q_sparse, 0,
                                                                      mesh=mesh))], results)
    launches = dict(LAUNCHES)
    ph, pq = td.shard_csr(h_sp, mesh), td.shard_csr(q_sp, mesh)
    lab_h, lab_q = f"dist_h_panel_{ph.rows_pad}x{INV_STATE}", f"dist_q_block_{pq.rows_pad}x{INV_STATE}"
    k3_map = {labels[0]: (lab_h, lab_q) * DIST_SLOTS, labels[1]: (lab_h, lab_q) * DIST_SLOTS}
    for label in labels:  # the dense triple: two rings of DIST_SLOTS^2 contractions
        rings = 2 if label in k3_map else 0
        only_kernels(label, per_call[label], {"csr_to_dense": len(k3_map.get(label, ())),
                                              "matmul_full": rings * DIST_SLOTS**2,
                                              "split_bf16": 2 * rings * DIST_SLOTS**2})
    c64, _ = triple_oracle(h_sp, q_sp, DEVICE)
    errs = {}
    for cfm, label in enumerate(labels[:2]):
        out = results.pop(label)
        errs[label] = slot_panels_close(label, out.local_shards(), out.bounds,
                                        mirror(c64) if cfm else torch.triu(c64))
    del c64
    out = results.pop(labels[2])
    again = td.triple_product_distributed_sparse(hs_sp, q_sparse, 0, mesh=mesh)
    require(all(torch.equal(p, again.panels[s]) for s, p in out.local_shards().items()),
            f"{labels[2]}: a repeated call gave other bits")
    del again
    # The oracle: f64 cuSPARSE products on the card (a check the port never calls).
    up = torch.triu(torch.sparse.mm(torch.sparse.mm(csr_f64(hs_sp), csr_f64(q_sparse)),
                                    csr_f64(hs_sp.T.tocsr())).to_dense())
    errs[labels[2]] = slot_panels_close(labels[2], out.local_shards(), out.bounds, up)
    del out, up
    k3 = {lab_h: k3_slots(ph, ph.rows_pad, INV_STATE), lab_q: k3_slots(pq, pq.rows_pad, INV_STATE)}
    del ph, pq
    phase("dist-triple", t0, " | ".join(
        [f"{label}: max abs err {errs[label]:.3e} vs f64 oracle (structure equal), first call "
         f"{seconds[label]:.3f} s" for label in labels]
        + [f"{labels[2]} twice: the same bits"]
        + [f"K3 {lab}: {timing(r)}, K8 {r['k8_ms']:.3f}, device alone {r['device_ms']:.3f}"
           for lab, r in k3.items()]
        + [f"launches by request {per_call}", f"launches {launches}"]))
    return dict(per_call=per_call, launches=launches, k3_map=k3_map, k3_shapes=k3, errs=errs,
                seconds=seconds, h_sparse=hs_sp, inversion=(h_sp, q_sp))


def dist_io_phase(hyper, kept, plan) -> dict:
    """Phase 18: save_partitioned of the 1M^2 operand A (flop-balanced for
    B) into a temporary directory, then, counted, load_sharded_operand onto
    DIST_SLOTS slots feeding the sparse ring with the in-memory run's
    capacities: the same bits as the in-memory run (phase 16).  Also the
    ingest timed, warm, min of PATH_RUNS."""
    t0 = time.perf_counter()
    a_sp, b_sp = hyper
    mesh = dist_mesh()
    label = "dist_io_sparse_1M"
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "a")
        t = time.perf_counter()
        smt_io.save_partitioned(prefix, a_sp, DIST_SLOTS, b_indptr=b_sp.indptr)
        save_s = time.perf_counter() - t
        results = {}
        reset_launches()
        per_call, seconds = counted([(label, lambda _: td.spgemm_csr_distributed_sparse(
            smt_io.load_sharded_operand(prefix, mesh), b_sp, mesh=mesh, **plan["caps"]))],
            results)
        launches = dict(LAUNCHES)
        only_kernels(label, per_call[label], {})
        out = results.pop(label)
        require(out.row_bounds == kept.row_bounds, f"{label}: bounds differ from the in-memory run")
        for s, arrays in out.local_shards().items():
            for g, w, field in zip(arrays, kept.local_shards()[s], ("indptr", "indices", "values")):
                require(torch.equal(g, w), f"{label} slot {s}: {field} differs from the "
                        "in-memory run")
        del out
        ingest_s = wall_s(lambda: smt_io.load_sharded_operand(prefix, mesh))
    phase("dist-io", t0, f"{label}: save_partitioned {save_s:.3f} s ({DIST_SLOTS} files), "
          f"load_sharded_operand {ingest_s:.4f} s (warm, min of {PATH_RUNS}); the sparse ring "
          f"on it gives the in-memory run's bits, first call {seconds[label]:.3f} s | launches "
          f"by request {per_call} | launches {launches}")
    return dict(per_call=per_call, launches=launches, save_s=save_s, ingest_s=ingest_s)


def staged(stages, runs: int = PATH_RUNS) -> dict:
    """The stages ((name, fn(ctx)) pairs) in order, runs + 1 times (the
    first warms): the host-clock seconds of each between synchronisations,
    of the fastest run; its end to end is their sum.  The "ring" stage's
    peak device memory above what was allocated before it is kept too."""
    best = None
    for run in range(runs + 1):
        ctx, times = {}, {}
        for key, fn in stages:
            torch.cuda.synchronize()
            if key == "ring":
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            fn(ctx)
            torch.cuda.synchronize()
            times[key] = time.perf_counter() - t
            if key == "ring":
                ring_peak = torch.cuda.max_memory_allocated() - before
        total = sum(times.values())
        if run and (best is None or total < best["seconds"]):
            best = dict(seconds=total, stages=times, ring_peak_bytes=ring_peak)
        del ctx
    return best


def dist_timing_phase(a_sp, b_sp, hyper, triple, name: str, smi: str) -> dict:
    """Phase 19: each request end to end by stages (staged(): planning,
    ingest, ring, download), warm, min of PATH_RUNS, with the ring's peak
    device memory; and the same products through the single-device port
    (sparse_matrix_multiply, scipy in and out) for scale."""
    t0 = time.perf_counter()
    mesh = dist_mesh()
    ha_sp, hb_sp = hyper
    h_sp, q_sp = triple["inversion"]
    hs_sp = triple["h_sparse"]

    def ingest(a, b, bounds=None):
        return lambda c: c.update(a=td.shard_csr(a, mesh, bounds=c.get("bounds", bounds)),
                                  b=td.shard_csr(b, mesh))

    def plan_sparse(c):
        c.update(dist_sparse_plan(ha_sp, hb_sp, DIST_SLOTS))

    requests = {
        "dist_dense_symmetric_10k": [
            ("ingest", ingest(a_sp, b_sp)),
            ("ring", lambda c: c.update(out=td.spgemm_dense_distributed(
                c["a"], c["b"], symmetric=True, mesh=mesh))),
            ("download", lambda c: np.asarray(c["out"]))],
        "dist_csr_symmetric_rows_10k": [
            ("ingest", ingest(a_sp, b_sp)),
            ("ring", lambda c: c.update(out=td.spgemm_csr_distributed(
                c["a"], c["b"], symmetric=True, mesh=mesh))),
            ("download", lambda c: c["out"].to_scipy())],
        "dist_csr_symmetric_flops_10k": [
            ("planning", lambda c: c.update(bounds=td.flop_shard_bounds(a_sp, b_sp,
                                                                         DIST_SLOTS))),
            ("ingest", ingest(a_sp, b_sp)),
            ("ring", lambda c: c.update(out=td.spgemm_csr_distributed(
                c["a"], c["b"], symmetric=True, mesh=mesh))),
            ("download", lambda c: c["out"].to_scipy())],
        "dist_sparse_flops_1M": [
            ("planning", plan_sparse),
            ("ingest", ingest(ha_sp, hb_sp)),
            ("ring", lambda c: c.update(out=td.spgemm_csr_distributed_sparse(
                c["a"], c["b"], mesh=mesh, **c["caps"]))),
            ("download", lambda c: c["out"].to_scipy())],
        f"dist_triple_{INV_OBS}x{INV_STATE}_full0": [
            ("ring", lambda c: c.update(out=td.triple_product_distributed(h_sp, q_sp, 0,
                                                                          mesh=mesh))),
            ("download", lambda c: np.asarray(c["out"]))],
        f"dist_triple_sparse_{DIST_H_ROWS}x{HYPER_N}": [
            ("ring", lambda c: c.update(out=td.triple_product_distributed_sparse(
                hs_sp, ha_sp, 0, mesh=mesh))),
            ("download", lambda c: np.asarray(c["out"]))],
    }
    timings = {label: staged(stages) for label, stages in requests.items()}
    single = {"sparse_matrix_multiply_symmetric_10k": wall_s(
                  lambda: smt.sparse_matrix_multiply(a_sp, b_sp, symmetric=True)),
              "sparse_matrix_multiply_1M": wall_s(lambda: smt.sparse_matrix_multiply(*hyper))}
    single_route = smt.get_last_route()
    phase("dist-timing", t0, f"{name} [{smi}]: {DIST_SLOTS} slots on one card, host clock, "
          f"warm, min of {PATH_RUNS}: " + " | ".join(
              f"{label} end to end {r['seconds']:.4f} s (" + ", ".join(
                  f"{k} {v:.4f}" for k, v in r["stages"].items())
              + f"), ring peak {r['ring_peak_bytes'] / 2**30:.2f} GiB"
              for label, r in timings.items())
          + " | single-device port, scipy in and out: " + ", ".join(
              f"{label} {s:.4f} s" for label, s in single.items())
          + f" (the 1M^2 one on route {single_route!r})")
    return dict(card=name, nvidia_smi=smi, slots=DIST_SLOTS, requests=timings,
                single_device_s=single, single_device_route_1M=single_route)


def dist_phases(a_sp, b_sp, esc_pair, name: str, smi: str) -> dict:
    """Phases 15-19; what the kernels line needs of them."""
    dense = dist_dense_phase(a_sp, b_sp)
    hyper = hyper_pair(HYPER_N, HYPER_N, HYPER_N, HYPER_NNZ, HYPER_NNZ, HYPER_SEEDS)
    sparse = dist_sparse_phase(hyper, esc_pair)
    triple = dist_triple_phase(hyper[0])
    io = dist_io_phase(hyper, sparse.pop("kept"), sparse["plan"])
    timings = dist_timing_phase(a_sp, b_sp, hyper, triple, name, smi)
    parts = (dense, sparse, triple, io)
    return dict(
        per_call={k: v for part in parts for k, v in part["per_call"].items()},
        launches=[part["launches"] for part in parts],
        k3_map={**dense["k3_map"], **triple["k3_map"]}, k4_map=dense["k4_map"],
        k3_shapes={**dense["k3_shapes"], **triple["k3_shapes"]}, k4_shapes=dense["k4_shapes"],
        summary=dict(timing=timings, sparse_plan=sparse["plan"],
                     max_abs_err={**dense["errs"], **sparse["errs"], **triple["errs"]},
                     first_call_s={**dense["seconds"], **sparse["seconds"], **triple["seconds"]},
                     io=dict(save_s=io["save_s"], ingest_s=io["ingest_s"])))


# ---------------------------------------------------------------------------
# Phase 20 (cost-model): the router's host/device cost model (api._route_costs)
# re-fitted on this machine's host and PCIe link, a crossover sweep over its
# three branches, and the port's demo on the card.
# ---------------------------------------------------------------------------

LINK_BYTES = 200 << 20  # the directly timed fetch_np download beside the probe
# The sizes of the first writes (host_page_rate), and of the float32 tensors
# whose downloads cast to f64 (host_copy_rate) land in arrays under the mmap
# threshold.
PAGE_POINTS = (64 << 20, 128 << 20)
COPY_POINTS = (4 << 20, 12 << 20)
# fetch_np's staged download against .cpu().numpy() (phase 20's fetch line):
# 200 MB in each dtype the routes download, just past a chunk edge, and f32
# from 4 KiB to 32 MiB (where the pageable copy might win); the 200 MB f32
# download cast to f64 also through staging buffers of each size.
FETCH_CASES = ((torch.float32, 50_000_000), (torch.float64, 25_000_000),
               (torch.int32, 50_000_000), (torch.float32, 3 * STAGE_BYTES // 4 + 5),
               *((torch.float32, nbytes // 4) for nbytes in (
                   4 << 10, 1 << 20, 4 << 20, 16 << 20, 32 << 20)))
STAGE_SIZES = (16 << 20, 32 << 20, 64 << 20)
PICK_MARGIN = 1.15  # a pick is wrong only where the other route is faster by more than this
SLOW_CALL_S = 0.5  # a sweep call slower than this is timed once after its warm call
# spgemm_host partials/s at rising reuse (partials per output entry), each
# operand pair: (label, kind, n, nnz or density, seeds).  reuse ~1: two
# pairs of hypersparse_random operands, on either side of the sweep's small
# hypersparse requests; ~10 and ~100: sp.random at rising density.
# Every output here stays under the mmap threshold (no fresh pages).
HOST_RATE_POINTS = (
    ("hyper_40k_reuse1", "hyper", 40_000, 160_000, (131, 132)),
    ("hyper_90k_reuse1", "hyper", 90_000, 360_000, (117, 118)),
    ("random_1000_d0.1_reuse10", "random", 1000, 0.1, (63, 64)),
    ("random_1000_d0.316_reuse100", "random", 1000, 0.316, (65, 66)),
)
# spgemm_host at A's rows of one stored entry, each a copy of one B row
# (host_copy_entry_rate, net of the partials term): one_per_row(m, k) times
# a k^2 hypersparse_random B, n = (m, k) and the size nnz(B), B rows of ~100
# and ~50 entries; request (c) stays held out.  Outputs under the threshold.
COPY_ENTRY_POINTS = (
    ("one_per_row_20k_x_30k", "one_per_row", (20_000, 30_000), 3_000_000, (121, 122)),
    ("one_per_row_30k_x_10k", "one_per_row", (30_000, 10_000), 500_000, (123, 124)),
)
# spgemm_host's outputs past the threshold (host_out_page_rate): these
# products' times net of the work terms fitted on HOST_RATE_POINTS.
OUT_PAGE_POINTS = (("hyper_100k_reuse1", "hyper", 100_000, 1_000_000, (61, 62)),
                   ("hyper_150k", "hyper", 150_000, 1_500_000, (89, 90)))
# The fit points of the other host-work rates of the CUDA cost model (none
# of them (d) or a COST_SWEEP request): the products the ESC route runs,
# whose stages fit the window plan, the uploads, the engine and to_scipy,
# results both past the mmap threshold (OUT_PAGE_POINTS) and under it; the
# row-chunked products (label, operands, imem_size, Config keywords), whose
# "download" and "stitch" stages fit the row slice and the stitch's copies:
# hyper_150k at 18 and 9 chunks, and at 4 of request (d)'s chunk size (the
# binned budget off, as the classic rung's failure leaves it),
# hyper_100k_reuse1 at 12, and 800,000^2 with 5.6e6 entries per operand
# (3.9e7 partials, 10 chunks at the default budget: the row-chunked route at
# (d)'s scale on other operands); the full triangles
# whose indices _fetch_full_triu rebuilds; the f32 panel cast to f64 and the
# product toarray and np.triu write; the small panels csr_matrix packs; the
# triples whose (H Q) H^T scipy multiplies.
ESC_POINTS = OUT_PAGE_POINTS + (("hyper_30k", "hyper", 30_000, 120_000, (111, 112)),
                                ("hyper_40k", "hyper", 40_000, 160_000, (131, 132)))
# host_slice_rate and stitch_copy_rate are fitted on the products cut at the
# default ESC budget (imem_size 5), whose parts are the size the router
# prices at it; the smaller parts of imem_size 1 and 2 slice faster per
# entry, and check the per-chunk terms.
FREE_RATE = 1e15  # the rate of a term its fit points show no cost for
CHUNK_POINTS = (("hyper_150k_imem1", OUT_PAGE_POINTS[1], 1, {}),
                ("hyper_150k_imem2", OUT_PAGE_POINTS[1], 2, {}),
                ("hyper_150k_4_chunks", OUT_PAGE_POINTS[1], 5, dict(use_binned_esc=False)),
                ("hyper_100k_reuse1_imem1", OUT_PAGE_POINTS[0], 1, {}),
                ("hyper_800k", ("hyper_800k", "hyper", 800_000, 5_600_000, (141, 142)), 5, {}))
TRIU_POINTS = (4000, 6000)
F64_PRODUCT = ("random_4096_d0.005", "random", 4096, 0.005, (91, 92))
DENSE_CSR_POINTS = (("random_2048_d0.02", "random", 2048, 0.02, (93, 94)),
                    ("random_1024_d0.03", "random", 1024, 0.03, (95, 96)))
SCIPY_POINTS = (("random_1500_d0.02", "random", 1500, 0.02, (97, 98)),
                ("random_1200_d0.03", "random", 1200, 0.03, (99, 100)))
# The crossover sweep: (label, kind, n, nnz or density, seeds, keywords),
# expansions 8e5 ... 5.6e7 on the sparse branch, two dense-output and three
# triple requests (H, Q both n^2); the last seven are held out (HELD_OUT: the
# sweep was not looked at when the rates were chosen), request (d), 4.9e7
# partials on the row-chunked ESC route, the last.  Their device routes
# launch K1-K4: sparse_random_3000 is extracted by K4,
# sparse_random_2500_symmetric (~63% of its triangle filled: packed CSR is
# the smaller download) by K2 after K3 and K1, dense_random_3000_symmetric
# runs K1, the triples K3 x2 and K1.
COST_SWEEP = (
    ("sparse_hyper_50k", "hyper", 50_000, 200_000, (67, 68), dict()),
    ("sparse_random_3000", "random", 3000, 0.01, (69, 70), dict()),
    ("sparse_random_2500_symmetric", "random", 2500, 0.02, (73, 74), dict(symmetric=True)),
    ("sparse_hyper_200k", "hyper", ESC_N, ESC_NNZ, ESC_SEEDS, dict()),  # request (a)
    ("sparse_random_2500", "random", 2500, 0.06, (75, 76), dict()),
    ("dense_random_3000_symmetric", "random", 3000, 0.01, (69, 70),
     dict(output_format="dense", symmetric=True)),
    ("dense_random_2500", "random", 2500, 0.06, (75, 76), dict(output_format="dense")),
    ("triple_random_2000", "random", 2000, 0.01, (77, 78), dict(use_triple_product=True)),
    ("triple_random_2500_full", "random", 2500, 0.01, (79, 80),
     dict(use_triple_product=True, compute_full_matrix=1)),
    ("sparse_hyper_120k", "hyper", 120_000, 1_200_000, (101, 102), dict()),
    ("sparse_classic_c", "classic", CLASSIC_M, CLASSIC_B_NNZ, CLASSIC_SEEDS, dict()),  # (c)
    ("sparse_random_1800", "random", 1800, 0.02, (103, 104), dict()),
    ("triple_random_4000_full", "random", 4000, 0.01, (105, 106),
     dict(use_triple_product=True, compute_full_matrix=1)),
    ("sparse_hyper_70k", "hyper", 70_000, 350_000, (113, 114), dict()),
    ("sparse_random_4000_symmetric", "random", 4000, 0.01, (115, 116), dict(symmetric=True)),
    ("sparse_chunks_d", "hyper", CHUNKS_N, CHUNKS_NNZ, CHUNKS_SEEDS, dict()),  # request (d)
)
HELD_OUT = {"sparse_hyper_120k", "sparse_classic_c", "sparse_random_1800",
            "triple_random_4000_full", "sparse_hyper_70k", "sparse_random_4000_symmetric",
            "sparse_chunks_d"}
HOST_ROUTE = dict(host_compute_limit=1 << 62)  # every request to spgemm_host / scipy
DEVICE_ROUTE = dict(host_compute_limit=0, **ON_DEVICE)  # as the port's tests force it
COLD_FLAG = "--cold-cost-model"  # the fresh process of phase 20 (cold_picks)


def cost_operands(kind: str, n: int, size, seeds):
    if kind == "hyper":
        return hyper_pair(n, n, n, size, size, seeds)
    if kind == "classic":  # request (c): one entry per row of A, n x CLASSIC_K
        return (one_per_row(n, CLASSIC_K, seeds[0]),
                hypersparse_random(CLASSIC_K, CLASSIC_K, size, seeds[1]))
    if kind == "one_per_row":  # n = (m, k): one entry per row of A, B k^2
        return one_per_row(*n, seeds[0]), hypersparse_random(n[1], n[1], size, seeds[1])
    return operands(n, size, seeds)


def best_call(fn, runs: int = PATH_RUNS):
    """Warm, then the minimum over ``runs`` host-clock seconds of ``fn``
    (synchronised; one run where the warm call took over SLOW_CALL_S, which
    is no near-tie): (seconds, the last result, its route)."""
    t0 = time.perf_counter()
    got = fn()
    torch.cuda.synchronize()
    if time.perf_counter() - t0 > SLOW_CALL_S:
        runs = 1
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best, got, smt.get_last_route()


def forced_rounds(call, fitted: dict) -> dict:
    """``call`` on the host route and the device route under ``fitted``,
    interleaved: one warm call each, then PATH_RUNS rounds of host, device
    (one round where a warm call took over SLOW_CALL_S, which is no
    near-tie), each synchronised, host clock.  Each way's seconds by round,
    its route and last result, and the device route's last host stages."""
    ways = (("host", HOST_ROUTE), ("device", DEVICE_ROUTE))
    out = {"host": [], "device": [], "routes": {}, "results": {}, "stages": {}}

    def run(way, cfg):
        with config_set(**fitted), config_set(**cfg):
            t0 = time.perf_counter()
            out["results"][way] = call()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            out["routes"][way] = smt.get_last_route()
            if way == "device":  # on the ESC routes
                out["stages"] = {k: round(v, 4) for k, v in api.get_last_route_stages().items()}
        return seconds

    warm = [run(way, cfg) for way, cfg in ways]
    for _ in range(1 if max(warm) > SLOW_CALL_S else PATH_RUNS):
        for way, cfg in ways:
            out[way].append(run(way, cfg))
    return out


def host_s(fn, runs: int = PATH_RUNS) -> float:
    """Warm, then the least host-clock seconds of ``fn`` over ``runs`` calls
    (host work only: no device synchronisation)."""
    fn()
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def link_phase() -> dict:
    """The calibrated link terms beside directly timed LINK_BYTES transfers,
    and what the probe's terms predict for them (the download by fetch_np
    with its host copy and its result's fresh pages at the configured
    rates)."""
    t0 = time.perf_counter()
    terms = dict(api._calibrate_link(DEVICE))
    calibrate_s = time.perf_counter() - t0
    x = torch.ones(LINK_BYTES // 4, dtype=torch.float32, device=DEVICE)
    down_s = wall_s(lambda: fetch_np(x))
    h = np.ones(LINK_BYTES // 4, np.float32)
    up_s = wall_s(lambda: torch.from_numpy(h).to(DEVICE))
    del x, h
    cfg = smt.get_config()
    predicted_down = (terms["link_fixed_s"] + LINK_BYTES / terms["link_down_bytes_per_s"]
                      + LINK_BYTES / cfg.host_copy_rate
                      + api._fresh(LINK_BYTES) / cfg.host_fetch_page_rate)
    predicted_up = terms["link_fixed_s"] + LINK_BYTES / terms["link_up_bytes_per_s"]
    return dict(calibrated=terms, calibrate_s=calibrate_s, bytes=LINK_BYTES,
                down_s=down_s, down_bytes_per_s=LINK_BYTES / down_s,
                down_predicted_s=predicted_down, down_miss=down_s / predicted_down,
                up_s=up_s, up_bytes_per_s=LINK_BYTES / up_s,
                up_predicted_s=predicted_up, up_miss=up_s / predicted_up)


def link_line(link: dict) -> str:
    cal = link["calibrated"]
    return (f"link_fixed_s {cal['link_fixed_s']:.3e}, up {cal['link_up_bytes_per_s']:.4e} B/s, "
            f"down {cal['link_down_bytes_per_s']:.4e} B/s (probe {link['calibrate_s']:.4f} s); "
            f"{LINK_BYTES >> 20} MiB by fetch_np, min of {PATH_RUNS}: down {link['down_s']:.4f} s "
            f"({link['down_bytes_per_s']:.4e} B/s; the probe predicts "
            f"{link['down_predicted_s']:.4f} s, x{link['down_miss']:.2f}), up {link['up_s']:.4f} s "
            f"({link['up_bytes_per_s']:.4e} B/s; predicted {link['up_predicted_s']:.4f} s, "
            f"x{link['up_miss']:.2f})")


def rate_fit(points: dict, key: str) -> dict:
    """The rate of one host-work term: the geometric mean of its points'
    rates (least squares in log space), each point's relative residual."""
    rate = float(np.exp(np.mean([np.log(p[key]) for p in points.values()])))
    return dict(rate=rate, points=points,
                residuals={label: p[key] / rate - 1.0 for label, p in points.items()})


def host_rate_fit() -> dict:
    """spgemm_host at each HOST_RATE_POINTS, COPY_ENTRY_POINTS and
    OUT_PAGE_POINTS pair (warm, min of PATH_RUNS): on HOST_RATE_POINTS JAX's
    sqrt(reuse) model's host_rate_base (least squares in log space, the
    CPU's formula) and the CUDA model's work terms, partials at
    host_partial_rate and output entries at host_entry_rate (least squares
    in relative error); on COPY_ENTRY_POINTS the entries of A's rows of one
    stored entry (api._single_row_entries) net of those terms
    (host_copy_entry_rate, :func:`rate_fit`); on OUT_PAGE_POINTS the fresh
    pages of the output net of the three work terms (host_out_page_rate).
    Each work point's residual under the two work terms and under the
    three."""
    points = {}
    for label, kind, n, size, seeds in HOST_RATE_POINTS + COPY_ENTRY_POINTS + OUT_PAGE_POINTS:
        a_sp, b_sp = cost_operands(kind, n, size, seeds)
        expand = expansion_size(a_sp.indices, a_sp.nnz, b_sp.indptr)
        m, n = a_sp.shape[0], b_sp.shape[1]
        reuse = max(expand / max(api._est_result_nnz(expand, m, n), 1), 1.0)
        seconds, got, _ = best_call(lambda: spgemm_host(a_sp, b_sp, n_partials=expand))
        points[label] = dict(partials=expand, nnz=got.nnz, reuse=reuse, seconds=seconds,
                             copied=api._single_row_entries(a_sp, b_sp),
                             fresh_bytes=api._fresh(4 * got.nnz, 8 * got.nnz),
                             partials_per_s=expand / seconds)
        del a_sp, b_sp, got
    work = {label: points[label] for label, *_ in HOST_RATE_POINTS + COPY_ENTRY_POINTS}
    require(all(p["fresh_bytes"] == 0 for p in work.values()),
            "a HOST_RATE_POINTS or COPY_ENTRY_POINTS output passes the mmap threshold")
    two_term = [points[label] for label, *_ in HOST_RATE_POINTS]
    logs = [np.log(p["partials_per_s"]) - 0.5 * np.log(p["reuse"]) for p in two_term]
    base = float(np.exp(np.mean(logs)))
    rows = np.array([[p["partials"], p["nnz"]] for p in two_term])
    rows = rows / np.array([p["seconds"] for p in two_term])[:, None]
    inv = np.linalg.lstsq(rows, np.ones(len(rows)), rcond=None)[0]
    require(bool((inv > 0).all()), f"spgemm_host's two-term fit is not positive: {inv}")
    copies = {}
    for label, *_ in COPY_ENTRY_POINTS:
        p = points[label]
        rest_s = p["partials"] * inv[0] + (p["nnz"] - p["copied"]) * inv[1]
        p["rate"] = p["copied"] / max(p["seconds"] - rest_s, 1e-6)
        copies[label] = p
    copy = rate_fit(copies, "rate")

    def work_s(p):  # the three work terms
        return (p["partials"] * inv[0] + p["copied"] / copy["rate"]
                + (p["nnz"] - p["copied"]) * inv[1])

    for p in two_term:
        p["residual"] = p["partials_per_s"] / (base * p["reuse"] ** 0.5) - 1.0
    for p in work.values():
        p["two_term_residual"] = (p["partials"] * inv[0] + p["nnz"] * inv[1]) / p["seconds"] - 1.0
        p["copy_term_residual"] = work_s(p) / p["seconds"] - 1.0
    pages = {}
    for label, *_ in OUT_PAGE_POINTS:
        p = points[label]
        p["work_s"] = work_s(p)
        p["rate"] = p["fresh_bytes"] / max(p["seconds"] - p["work_s"], 1e-6)
        pages[label] = p
    return dict(points=work, host_rate_base=base, host_partial_rate=float(1 / inv[0]),
                host_entry_rate=float(1 / inv[1]), host_copy_entry_rate=copy,
                host_out_page_rate=rate_fit(pages, "rate"))


def host_page_fit() -> dict:
    """host_page_rate: np.ones of each PAGE_POINTS size (a fresh array past
    the mmap threshold each time, warm, min of PATH_RUNS) net of filling a
    written array of that size (:func:`rate_fit`)."""
    points = {}
    for nbytes in PAGE_POINTS:
        written = np.ones(nbytes // 8)
        fill_s = host_s(lambda: written.fill(2.0))
        seconds = host_s(lambda: np.ones(nbytes // 8))
        points[f"ones_{nbytes >> 20}_mib"] = dict(bytes=nbytes, seconds=seconds, fill_s=fill_s,
                                                  rate=nbytes / max(seconds - fill_s, 1e-6))
        del written
    return rate_fit(points, "rate")


def host_copy_fit() -> dict:
    """host_copy_rate: fetch_np of a float32 tensor of each COPY_POINTS size
    cast to f64, as the routes download their values (the staged download
    into a result under the mmap threshold, whose pages the warm calls have
    written; warm, min of PATH_RUNS), net of what the link terms just
    calibrated predict for it; in bytes of the result per second
    (:func:`rate_fit`).  The same downloads kept f32 (an index download) are
    timed beside them, and a fit of all the points is kept as ``pooled``,
    with its residuals."""
    terms = api._calibrate_link(DEVICE)
    points = {}
    for nbytes in COPY_POINTS:
        x = torch.ones(nbytes // 4, dtype=torch.float32, device=DEVICE)
        for label, dtype, host_bytes in (("f32", None, nbytes), ("f64", np.float64, 2 * nbytes)):
            require(api._fresh(host_bytes) == 0, f"a COPY_POINTS result of {host_bytes} bytes "
                    "passes the mmap threshold")
            seconds = wall_s(lambda: fetch_np(x, dtype))
            link_s = terms["link_fixed_s"] + nbytes / terms["link_down_bytes_per_s"]
            points[f"fetch_{nbytes >> 20}_mib_{label}"] = dict(
                bytes=nbytes, host_bytes=host_bytes, seconds=seconds, link_s=link_s,
                rate=host_bytes / max(seconds - link_s, 1e-6))
        del x
    cast = {label: p for label, p in points.items() if label.endswith("_f64")}
    return dict(rate_fit(cast, "rate"), pooled=rate_fit(points, "rate"))


def fetch_phase(name: str, smi: str) -> dict:
    """fetch_np's staged download held against ``.cpu().numpy()`` bit for bit
    at each FETCH_CASES size, as it is and cast to f64, and on a card that is
    not current where the machine has two; both paths timed side by side
    (host clock, synchronised, warm, min of PATH_RUNS), the 200 MB f32 -> f64
    download also through pinned staging buffers of each STAGE_SIZES size."""
    t0 = time.perf_counter()
    rows = {}
    for dtype, n in FETCH_CASES:
        gen = torch.Generator(device=DEVICE).manual_seed(n)
        if dtype == torch.int32:
            x = torch.randint(-2**31, 2**31 - 1, (n,), dtype=dtype, device=DEVICE, generator=gen)
        else:
            x = torch.randn(n, dtype=dtype, device=DEVICE, generator=gen)
        label = f"{str(dtype)[6:]}_{n}"
        want = x.cpu().numpy()
        require(np.array_equal(fetch_np(x), want), f"fetch {label}: staged != .cpu().numpy()")
        row = dict(bytes=n * x.element_size(), pageable_s=wall_s(lambda: x.cpu().numpy()),
                   staged_s=wall_s(lambda: fetch_np(x)))
        if dtype != torch.int32:
            require(np.array_equal(fetch_np(x, np.float64), want.astype(np.float64)),
                    f"fetch {label}: staged f64 != .cpu().numpy().astype(f64)")
            row.update(pageable_f64_s=wall_s(lambda: x.cpu().numpy().astype(np.float64)),
                       staged_f64_s=wall_s(lambda: fetch_np(x, np.float64)))
        rows[label] = row
        del x, want
    n = FETCH_CASES[0][1]
    x = torch.randn(n, device=DEVICE, generator=torch.Generator(device=DEVICE).manual_seed(n))
    stream = torch.cuda.Stream()
    by_stage = {}
    for nbytes in STAGE_SIZES:
        buffers = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=True) for _ in range(2)]
        by_stage[f"{nbytes >> 20}_mib"] = wall_s(
            lambda: staged_fetch(x, np.float64, buffers, stream))
        del buffers
    del x
    other = "not checked (one card)"
    if torch.cuda.device_count() > 1:
        card = torch.device("cuda", 1)
        x = torch.randn(n, device=card, generator=torch.Generator(device=card).manual_seed(7))
        require(torch.cuda.current_device() == 0
                and np.array_equal(fetch_np(x, np.float64), x.cpu().numpy().astype(np.float64)),
                "fetch on cuda:1 with cuda:0 current: staged != .cpu().numpy()")
        other = "cuda:1 with cuda:0 current: identical"
        del x
    phase("fetch", t0, f"{name} [{smi}]: fetch_np staged (two {STAGE_BYTES >> 20} MiB pinned "
          f"buffers) against .cpu().numpy(), identical bits; host clock, min of {PATH_RUNS}: "
          + "; ".join(
              f"{label} ({r['bytes'] / 1e6:.1f} MB): pageable {r['pageable_s']:.4f} s, staged "
              f"{r['staged_s']:.4f} s" + (
                  f"; cast to f64: pageable + astype {r['pageable_f64_s']:.4f} s, staged "
                  f"{r['staged_f64_s']:.4f} s" if "staged_f64_s" in r else "")
              for label, r in rows.items())
          + f" | {FETCH_CASES[0][1] * 4 / 1e6:.0f} MB f32 -> f64 by staging buffer: "
          + ", ".join(f"{k} {v:.4f} s" for k, v in by_stage.items()) + f" | another card: {other}")
    return dict(card=name, nvidia_smi=smi, stage_bytes=STAGE_BYTES, cases=rows,
                f64_by_stage_buffer_s=by_stage, other_card=other)


def route_stages(a_sp, b_sp, cfg: dict, **kw) -> dict:
    """sparse_matrix_multiply on its device route under ``cfg`` (DEVICE_ROUTE),
    warm, then PATH_RUNS calls (host clock, synchronised): each stage's least
    seconds as the router timed it (api.get_last_route_stages), the least
    whole call's, the route, its detail and the result's entries."""
    stages, best = {}, float("inf")
    with config_set(**cfg), config_set(**DEVICE_ROUTE):
        for run in range(PATH_RUNS + 1):
            t0 = time.perf_counter()
            got = smt.sparse_matrix_multiply(a_sp, b_sp, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            nnz = got.nnz
            del got
            if run:  # the first call warms
                best = min(best, seconds)
                for key, value in api.get_last_route_stages().items():
                    stages[key] = min(stages.get(key, float("inf")), value)
        route, detail = smt.get_last_route(), api.get_last_route_detail()
    return dict(stages=stages, seconds=best, route=route, nnz=nnz, **detail)


def esc_route_fit(copy_rate: float) -> dict:
    """The ESC route's rates on the stages the router times, on ESC_POINTS
    (:func:`route_stages`): the engine as esc_fixed_s plus partials at
    esc_engine_rate; the uploads net of their link term (api._upload_cost:
    three synchronous transfers per operand, the bytes) at
    host_upload_rate; the window plan at esc_plan_rate (:func:`rate_fit`);
    to_scipy net of its link term and its host copies at ``copy_rate``
    (api._to_scipy_cost) as entries at host_csr_rate plus its arrays'
    fresh pages at host_fetch_page_rate (the two least squares in relative
    error: the results under the mmap threshold set the first, those past
    it the second; each point's residual).  Where the points show one of
    the two no cost (in a long process fresh pages can cost nothing
    measurable), that term is priced free (FREE_RATE) and the other fitted
    alone."""
    terms = api._calibrate_link(DEVICE)
    inf = float("inf")
    net = smt.get_config().replace(host_upload_rate=inf, host_copy_rate=copy_rate,
                                   host_fetch_page_rate=inf, host_csr_rate=inf)
    engine, upload, plan, csr = {}, {}, {}, {}
    for label, kind, n, size, seeds in ESC_POINTS:
        a_sp, b_sp = cost_operands(kind, n, size, seeds)
        r = route_stages(a_sp, b_sp, {})
        require(r["route"] == "esc_windowed", f"{label}: route {r['route']!r}")
        st, val, nnz = r["stages"], api._value_bytes(a_sp, b_sp, DEVICE), r["nnz"]
        entries = a_sp.nnz + b_sp.nnz
        engine[label] = dict(partials=expansion_size(a_sp.indices, a_sp.nnz, b_sp.indptr),
                             seconds=st["engine"])
        link_s = api._upload_cost(entries, 2, val, terms, net)
        upload[label] = dict(entries=entries, seconds=st["upload"], link_s=link_s,
                             rate=entries / max(st["upload"] - link_s, 1e-6))
        plan[label] = dict(a_entries=a_sp.nnz, seconds=st["windowed_plan"],
                           rate=a_sp.nnz / st["windowed_plan"])
        csr[label] = dict(entries=nnz, seconds=st["download"],
                          fresh_bytes=api._fresh(4 * nnz, 8 * nnz),
                          link_and_copies_s=api._to_scipy_cost(nnz, val, terms, net))
        del a_sp, b_sp
    require(any(p["fresh_bytes"] for p in csr.values())
            and not all(p["fresh_bytes"] for p in csr.values()),
            "ESC_POINTS' results must lie both under and past the mmap threshold")
    rows = np.array([[1.0 / p["seconds"], p["partials"] / p["seconds"]] for p in engine.values()])
    fixed, inv = np.linalg.lstsq(rows, np.ones(len(rows)), rcond=None)[0]
    require(fixed > 0 and inv > 0, f"the ESC engine's fit is not positive: {fixed}, {inv}")
    for p in engine.values():
        p["residual"] = (fixed + p["partials"] * inv) / p["seconds"] - 1.0
    rest = {label: max(p["seconds"] - p["link_and_copies_s"], 1e-6) for label, p in csr.items()}
    rows = np.array([[p["entries"], p["fresh_bytes"]] for p in csr.values()])
    rows = rows / np.array([rest[label] for label in csr])[:, None]
    ones = np.ones(len(rows))
    coef = np.linalg.lstsq(rows, ones, rcond=None)[0]
    if coef.min() <= 0:  # a term these points show no cost for is priced free
        keep = coef > 0
        coef = np.zeros(2)
        coef[keep] = np.linalg.lstsq(rows[:, keep], ones, rcond=None)[0]
    per_entry, per_byte = coef
    require(per_entry > 0 and per_byte >= 0,
            f"to_scipy's rest and fresh pages fit: {per_entry}, {per_byte}")
    pages = {}
    page_rate = 1.0 / per_byte if per_byte > 0 else FREE_RATE
    for label, p in csr.items():
        p["rate"] = p["entries"] / max(rest[label] - p["fresh_bytes"] * per_byte, 1e-6)
        p["residual"] = (p["entries"] * per_entry + p["fresh_bytes"] * per_byte
                         + p["link_and_copies_s"]) / p["seconds"] - 1.0
        if p["fresh_bytes"]:
            net_s = max(rest[label] - p["entries"] * per_entry, 1e-6)
            pages[label] = dict(p, rate=p["fresh_bytes"] / net_s)
    residuals = {label: p["residual"] for label, p in csr.items()}
    return dict(esc_fixed_s=float(fixed), esc_engine_rate=float(1 / inv), engine=engine,
                host_upload_rate=rate_fit(upload, "rate"), esc_plan_rate=rate_fit(plan, "rate"),
                host_csr_rate=dict(points=csr, residuals=residuals, rate=float(1 / per_entry)),
                host_fetch_page_rate=dict(points=pages, rate=float(page_rate),
                                          residuals={label: residuals[label] for label in pages}))


def chunk_route_fit(fitted: dict) -> dict:
    """host_slice_rate and stitch_copy_rate on the row-chunked products of
    CHUNK_POINTS (:func:`route_stages` at each point's imem_size and Config
    keywords; :func:`rate_fit` each on the points cut at the default
    budget, every point's residual beside it): the "download" stage net of
    what the model prices there without the slice under ``fitted`` (each
    chunk's to_scipy, the parts' fresh pages), and the "stitch" stage net
    of its two copies' fresh pages, in the result's entries per second (two
    per entry for the stitch); then each point's device stages priced with
    the fitted rates beside the measured ones, the priced chunk count beside
    the route's."""
    inf = float("inf")
    slices, stitches, pairs = {}, {}, {}
    for label, (_, kind, n, size, seeds), imem, cfg in CHUNK_POINTS:
        a_sp, b_sp = cost_operands(kind, n, size, seeds)
        r = route_stages(a_sp, b_sp, cfg, imem_size=imem)
        require(r["route"] == "esc_chunks", f"{label}: route {r['route']!r}")
        with config_set(**fitted, **cfg, host_slice_rate=inf):
            free = api._request_stage_costs(a_sp, b_sp, DEVICE, imem_size=imem)
            limit = api._esc_limit(imem)
        expand = expansion_size(a_sp.indices, a_sp.nnz, b_sp.indptr)
        st, nnz = r["stages"], r["nnz"]
        slices[label] = dict(entries=nnz, chunks=r["chunks"], priced_chunks=-(-expand // limit),
                             seconds=st["download"], measured=st, call_s=r["seconds"],
                             rate=nnz / max(st["download"] - free["download"], 1e-6))
        pages_s = 2 * api._ENTRY_BYTES * nnz / fitted["host_page_rate"]
        stitches[label] = dict(entries=nnz, seconds=st["stitch"], pages_s=pages_s,
                               rate=2 * nnz / max(st["stitch"] - pages_s, 1e-6))
        pairs[label] = a_sp, b_sp, imem, cfg
    default = [label for label, _, imem, _ in CHUNK_POINTS if imem == 5]
    require(default, "no CHUNK_POINTS product is cut at the default ESC budget")
    fits = {key: dict(rate_fit({label: points[label] for label in default}, "rate"),
                      points=points)
            for key, points in (("host_slice_rate", slices), ("stitch_copy_rate", stitches))}
    for f in fits.values():
        f["residuals"] = {label: p["rate"] / f["rate"] - 1.0 for label, p in f["points"].items()}
    for label, (a_sp, b_sp, imem, cfg) in pairs.items():
        p = slices[label]
        with config_set(**fitted, **cfg, **{key: f["rate"] for key, f in fits.items()}):
            p["priced"] = api._request_stage_costs(a_sp, b_sp, DEVICE, imem_size=imem)
        measured = sum(p["measured"][key] for key in p["priced"])
        p["total_residual"] = sum(p["priced"].values()) / measured - 1.0
    del pairs
    return fits


def chunk_lines(fit: dict) -> list:
    """One [chunk-stages] line per CHUNK_POINTS product: its stages priced
    with the fitted host_slice_rate and stitch_copy_rate beside the measured
    ones (``fit``: the host_slice_rate fit)."""
    return [f"[chunk-stages] {label}: {p['chunks']} chunks (priced {p['priced_chunks']}), "
            f"{p['entries']:.4e} entries, call {p['call_s']:.4f} s; priced / measured s by stage: "
            + ", ".join(f"{key} {value:.4f}/{p['measured'][key]:.4f}"
                        for key, value in p["priced"].items())
            + f"; priced total over measured {p['total_residual']:+.3f}"
            for label, p in fit["points"].items()]


def pooled_line(work: dict) -> str:
    pooled = work["host_copy_rate"]["pooled"]
    return f"{pooled['rate']:.4e}/s (" + ", ".join(
        f"{label} {pooled['points'][label]['rate']:.4e}, residual {res:+.3f}"
        for label, res in pooled["residuals"].items()) + ")"


def host_work_fit(sa_sp, sb_sp, page_rate: float) -> dict:
    """The dense routes' host-work rates of the CUDA cost model, each on its
    fit points (host clock, warm, min of PATH_RUNS; :func:`rate_fit`; the
    f64 passes' net of their arrays' fresh pages at ``page_rate``); and
    dense_pack's on the SIB_N^2 sibling panel (host_pack_rate, as JAX
    prices the pack)."""
    triu = {}
    for m in TRIU_POINTS:
        indptr = np.concatenate([[0], np.cumsum(np.arange(m, 0, -1, dtype=np.int64))])
        indptr = indptr.astype(np.int32)
        values = np.ones(int(indptr[-1]))
        seconds = host_s(lambda: api._full_triu_csr(values, indptr, m))
        triu[f"triangle_{m}"] = dict(entries=len(values), seconds=seconds,
                                     rate=len(values) / seconds)
        del values
    f64 = {}
    label, kind, n, size, seeds = F64_PRODUCT
    c_sp = spgemm_host(*cost_operands(kind, n, size, seeds))
    f64[f"toarray_{label}"] = dict(elements=n * n, seconds=host_s(lambda: c_sp.toarray()))
    dense = c_sp.toarray()
    f64[f"triu_{label}"] = dict(elements=n * n, seconds=host_s(lambda: np.triu(dense)))
    del c_sp, dense
    for p in f64.values():
        p["rate"] = p["elements"] / max(p["seconds"] - api._fresh(8 * p["elements"]) / page_rate,
                                        1e-6)
    dense_csr = {}
    for label, kind, n, size, seeds in DENSE_CSR_POINTS:
        panel = spgemm_host(*cost_operands(kind, n, size, seeds)).toarray()
        seconds = host_s(lambda: sp.csr_matrix(panel))
        dense_csr[label] = dict(elements=panel.size, seconds=seconds, rate=panel.size / seconds)
        del panel
    scipy = {}
    for label, kind, n, size, seeds in SCIPY_POINTS:
        h_sp, q_sp = cost_operands(kind, n, size, seeds)
        hq = h_sp @ q_sp
        ht = h_sp.T.tocsr()
        partials = (expansion_size(h_sp.indices, h_sp.nnz, q_sp.indptr)
                    + expansion_size(hq.indices, hq.nnz, ht.indptr))
        seconds = host_s(lambda: (h_sp @ q_sp) @ h_sp.T)
        scipy[label] = dict(partials=partials, seconds=seconds, rate=partials / seconds)
        del h_sp, q_sp, hq, ht
    a = smt.from_scipy(sa_sp, dtype=torch.float32, device=DEVICE)
    b = smt.from_scipy(sb_sp, dtype=torch.float32, device=DEVICE)
    pack_panel = fetch_np(spgemm_dense_out(a, b))
    del a, b
    pack_s = host_s(lambda: dense_pack(pack_panel))
    pack = {f"sibling_panel_{SIB_N}": dict(elements=pack_panel.size, seconds=pack_s,
                                           rate=pack_panel.size / pack_s)}
    del pack_panel
    return dict(triu_rebuild_rate=rate_fit(triu, "rate"), host_f64_rate=rate_fit(f64, "rate"),
                dense_csr_rate=rate_fit(dense_csr, "rate"),
                scipy_partial_rate=rate_fit(scipy, "rate"), host_pack_rate=rate_fit(pack, "rate"))


def sweep_oracle(a_sp, b_sp, kw):
    """scipy's answer to a sweep request: CSR for a sparse output, else dense."""
    if kw.get("use_triple_product"):
        c = (a_sp @ b_sp @ a_sp.T).toarray()
        return np.triu(c) + np.triu(c, 1).T if kw.get("compute_full_matrix") else np.triu(c)
    if kw.get("output_format") == "dense":
        c = (a_sp @ b_sp).toarray()
        return np.triu(c) if kw.get("symmetric") else c
    c = (a_sp @ b_sp).tocsr()
    return sp.triu(c, format="csr") if kw.get("symmetric") else c


def sweep_result_ok(label, got, want) -> float:
    """A sweep result against scipy's at the oracle; returns max |diff|."""
    if sp.issparse(want):
        return same_csr(got, want, label)
    require(got.shape == want.shape and np.allclose(got, want, rtol=RTOL, atol=ATOL),
            f"{label}: outside the oracle")
    return float(np.abs(got - want).max())


def model_picks(cfg: dict) -> dict:
    """The cost model's pick for each COST_SWEEP request under the config
    ``cfg`` sets, with this process's link terms:
    {label: (est_host, est_dev, pick)}."""
    picks = {}
    with config_set(**cfg):
        for label, kind, n, size, seeds, kw in COST_SWEEP:
            est_host, est_dev = model_costs(*cost_operands(kind, n, size, seeds), **kw)
            picks[label] = (est_host, est_dev, "host" if est_host < est_dev else "device")
    return picks


def cold_run(fitted: dict) -> dict:
    """Phase 20's probe and picks in a fresh process (this script with
    COLD_FLAG): its link terms, its 200 MiB transfers and its pick for each
    COST_SWEEP request under ``fitted``."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), COLD_FLAG,
                           json.dumps(fitted)], cwd=root, capture_output=True, text=True,
                          timeout=600)
    lines = proc.stdout.strip().splitlines()
    require(proc.returncode == 0 and lines and lines[-1].startswith('{"cold"'),
            f"the cold cost-model run: exit {proc.returncode}, {proc.stdout[-2000:]!r} "
            f"{proc.stderr[-2000:]!r}")
    return json.loads(lines[-1])["cold"]


def cold_main(fitted_json: str) -> int:
    """The fresh process of :func:`cold_run`: one JSON line {"cold": ...}."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    fitted = json.loads(fitted_json)
    t0 = time.perf_counter()
    with config_set(**fitted):
        link = link_phase()
    picks = model_picks(fitted)
    print(json.dumps({"cold": dict(link=link, picks=picks, seconds=time.perf_counter() - t0)}))
    return 0


def pick_verdict(pick: str, host_rounds, device_rounds) -> dict:
    """Whether ``pick`` ("host" or "device") is right: its route's least
    time within PICK_MARGIN of the other's.  A wrong pick is ``unsteady``
    where its rounds fall on both sides of the margin; ``ratios``: each
    round's host/device seconds."""
    ratios = [h / d for h, d in zip(host_rounds, device_rounds)]
    picked = [r if pick == "host" else 1 / r for r in ratios]
    best = {"host": min(host_rounds), "device": min(device_rounds)}
    right = best[pick] <= PICK_MARGIN * best["device" if pick == "host" else "host"]
    return dict(right=right, unsteady=not right and min(picked) <= PICK_MARGIN < max(picked),
                ratios=ratios)


def crossover_sweep(fitted: dict, cold: dict) -> tuple:
    """Each COST_SWEEP request on the host route and the device route,
    interleaved (:func:`forced_rounds`), and as the model decides (warm,
    :func:`best_call`) under this run's ``fitted`` rates, with the model's
    estimates and pick, the cold run's pick and the committed defaults'
    pick beside it; a pick is wrong where the other route is faster by more
    than PICK_MARGIN (each way's least time), and also ``unsteady`` where
    its rounds fall on both sides of the margin; each result
    against scipy; the hand kernels' launches over the sweep (counts zeroed
    just before it)."""
    rows = []
    reset_launches()
    for label, kind, n, size, seeds, kw in COST_SWEEP:
        a_sp, b_sp = cost_operands(kind, n, size, seeds)
        default_host, default_dev = model_costs(a_sp, b_sp, **kw)
        with config_set(**fitted):
            est_host, est_dev = model_costs(a_sp, b_sp, **kw)
            priced = {} if set(kw) - {"symmetric"} else api._request_stage_costs(
                a_sp, b_sp, DEVICE, **kw)
        call = lambda: smt.sparse_matrix_multiply(a_sp, b_sp, **kw)  # noqa: E731
        want = sweep_oracle(a_sp, b_sp, kw)
        times, routes, errs = {}, {}, {}
        rounds = forced_rounds(call, fitted)
        for way in ("host", "device"):
            times[way] = min(rounds[way])
            routes[way] = rounds["routes"][way]
            errs[way] = sweep_result_ok(f"{label} ({way})", rounds["results"][way], want)
        stages = rounds["stages"]
        del rounds["results"]
        with config_set(**fitted):
            times["model"], got, routes["model"] = best_call(call)
        errs["model"] = sweep_result_ok(f"{label} (model)", got, want)
        del got, want
        pick = "host" if est_host < est_dev else "device"
        default_pick = "host" if default_host < default_dev else "device"
        verdict = pick_verdict(pick, rounds["host"], rounds["device"])
        ratios = verdict["ratios"]
        require(routes["host"] == "host" and routes["device"] != "host",
                f"{label}: forced routes {routes}")
        require((routes["model"] == "host") == (pick == "host"),
                f"{label}: the model picked {pick} but the router took {routes['model']}")
        faster = "host" if times["host"] < times["device"] else "device"
        r = dict(label=label, held_out=label in HELD_OUT,
                 partials=int(expansion_size(a_sp.indices, a_sp.nnz, b_sp.indptr)), **kw,
                 est_host_s=est_host, est_dev_s=est_dev, pick=pick,
                 cold_pick=cold["picks"][label][2],
                 default_pick=default_pick,
                 default_pick_right=pick_verdict(default_pick, rounds["host"],
                                                 rounds["device"])["right"],
                 device_stages=stages, priced_device_stages=priced,
                 host_s=times["host"], device_s=times["device"], model_s=times["model"],
                 host_rounds_s=rounds["host"], device_rounds_s=rounds["device"],
                 host_over_device_rounds=ratios,
                 device_route=routes["device"], model_route=routes["model"], faster=faster,
                 pick_right=verdict["right"], unsteady=verdict["unsteady"], max_abs_err=errs)
        rows.append(r)
        print(f"[cost-sweep] {label}{' (held out)' if r['held_out'] else ''}: "
              f"{r['partials']:.4e} partials | est_host {est_host:.4e} s, est_dev {est_dev:.4e} s "
              f"-> {pick} (cold run: {r['cold_pick']}; committed defaults: {r['default_pick']}) | "
              f"host route {r['host_s']:.4f} s, device route ({r['device_route']}) "
              f"{r['device_s']:.4f} s (min of {len(ratios)} interleaved rounds, host/device "
              f"each round {[round(x, 3) for x in ratios]}), as the model decides "
              f"({r['model_route']}) "
              f"{r['model_s']:.4f} s{f' (device route stages {stages})' if stages else ''}"
              + (" (priced: " + ", ".join(f"{key} {value:.4f}" for key, value in priced.items())
                 + ")" if priced else "") + " | "
              f"faster: {faster} by "
              f"x{max(times['host'], times['device']) / min(times['host'], times['device']):.2f}, "
              f"{'right' if r['pick_right'] else 'WRONG'} pick (margin {PICK_MARGIN})"
              f"{' unsteady' if r['unsteady'] else ''} | max abs err vs scipy {errs}", flush=True)
    launches = dict(LAUNCHES)
    for key in DENSE_PATH_KERNELS:
        require(launches[key] > 0, f"the cost-model sweep launched no {KERNELS[key][0]}")
    return rows, launches


def demo_on_card() -> list:
    """examples/demo_torch.py on the card, in its own process: every line [ok]."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, os.path.join(root, "examples", "demo_torch.py"),
                           "--device", DEVICE], cwd=root, capture_output=True, text=True,
                          timeout=600)
    lines = proc.stdout.strip().splitlines()
    require(proc.returncode == 0 and lines and all(line.startswith("[ok]") for line in lines),
            f"demo_torch.py: exit {proc.returncode}, output {proc.stdout!r} {proc.stderr[-2000:]!r}")
    return lines


def cost_model_phase(sa_sp, sb_sp, name: str, smi: str) -> dict:
    """Phase 20: the host-work rates fitted on their points, the probe and
    the picks in a fresh process (cold), the probe beside LINK_BYTES
    transfers here (warm), the crossover sweep under the fitted rates with
    both runs' picks, the demo."""
    t0 = time.perf_counter()
    page = host_page_fit()
    copy = host_copy_fit()
    fit = host_rate_fit()
    dev = esc_route_fit(copy["rate"])
    work = dict(host_work_fit(sa_sp, sb_sp, page["rate"]), host_page_rate=page,
                host_out_page_rate=fit["host_out_page_rate"], host_copy_rate=copy,
                **{key: dev[key] for key in ("host_upload_rate", "esc_plan_rate", "host_csr_rate",
                                             "host_fetch_page_rate")})
    fitted = dict(host_rate_base=fit["host_rate_base"], host_partial_rate=fit["host_partial_rate"],
                  host_entry_rate=fit["host_entry_rate"],
                  host_copy_entry_rate=fit["host_copy_entry_rate"]["rate"],
                  esc_fixed_s=dev["esc_fixed_s"],
                  esc_engine_rate=dev["esc_engine_rate"],
                  **{key: f["rate"] for key, f in work.items()})
    work.update(chunk_route_fit(fitted))
    fitted.update(host_slice_rate=work["host_slice_rate"]["rate"],
                  stitch_copy_rate=work["stitch_copy_rate"]["rate"])
    cold = cold_run(fitted)
    with config_set(**fitted):
        link = link_phase()
    threads = dict(cpu_count=os.cpu_count(), omp_num_threads=os.environ.get("OMP_NUM_THREADS"),
                   torch_threads=torch.get_num_threads())
    down_ratio = (link["calibrated"]["link_down_bytes_per_s"]
                  / cold["link"]["calibrated"]["link_down_bytes_per_s"])
    phase("cost-model", t0, f"{name} [{smi}] | host {threads} | link, this process (warm): "
          f"{link_line(link)} | a fresh process (cold, {cold['seconds']:.1f} s): "
          f"{link_line(cold['link'])} | probe download warm/cold x{down_ratio:.3f} | "
          "spgemm_host, min of 3: " + "; ".join(
              f"{label}: {p['partials']:.4e} partials, {p['nnz']:.4e} entries "
              f"({p['copied']:.4e} of one-entry rows), reuse {p['reuse']:.2f}, "
              f"{p['seconds']:.4f} s, {p['partials_per_s']:.4e}/s, residual "
              + (f"{p['residual']:+.3f} (sqrt-reuse), " if "residual" in p else "")
              + f"{p['two_term_residual']:+.3f} (two work terms), "
              f"{p['copy_term_residual']:+.3f} (with the copy term)"
              for label, p in fit["points"].items())
          + f" | fit host_rate_base {fit['host_rate_base']:.4e} (the CPU's formula); "
          f"host_partial_rate {fit['host_partial_rate']:.4e}, host_entry_rate "
          f"{fit['host_entry_rate']:.4e}, host_copy_entry_rate "
          f"{fit['host_copy_entry_rate']['rate']:.4e} (net of the partials term: "
          + ", ".join(f"{label} {p['rate']:.4e}"
                      for label, p in fit["host_copy_entry_rate"]["points"].items())
          + f") | the windowed ESC route's engine stage, min of {PATH_RUNS}: "
          + "; ".join(f"{label}: {p['partials']:.4e} partials, {p['seconds']:.4f} s, residual "
                      f"{p['residual']:+.3f}" for label, p in dev["engine"].items())
          + f": esc_fixed_s {dev['esc_fixed_s']:.4e}, esc_engine_rate {dev['esc_engine_rate']:.4e}"
          + " | " + " | ".join(
              f"{key} {f['rate']:.4e}/s (" + ", ".join(
                  f"{label} {f['points'][label]['rate']:.4e} "
                  f"({f['points'][label]['seconds']:.4f} s), residual {res:+.3f}"
                  for label, res in f["residuals"].items()) + ")"
              for key, f in work.items())
          + " | host_copy_rate of all its points, f32 too: " + pooled_line(work))
    for line in chunk_lines(work["host_slice_rate"]):
        print(line, flush=True)
    t1 = time.perf_counter()
    rows, launches = crossover_sweep(fitted, cold)
    wrong = [r["label"] for r in rows if not r["pick_right"]]
    unsteady = [r["label"] for r in rows if r["unsteady"]]
    same = all(r["pick"] == r["cold_pick"] for r in rows)
    default_wrong = [r["label"] for r in rows if not r["default_pick_right"]]
    a_row = next(r for r in rows if r["label"] == "sparse_hyper_200k")
    d_row = next(r for r in rows if r["label"] == "sparse_chunks_d")
    phase("cost-sweep", t1, f"{len(rows)} requests ({len(HELD_OUT)} held out), this run's fit: "
          f"{len(wrong)} wrong picks {wrong} (unsteady: {unsteady}) | same picks cold and warm: "
          f"{'yes' if same else 'no'} | the committed defaults would pick wrong at "
          f"{default_wrong} (by the same times) | probe download "
          f"rate warm/cold x{down_ratio:.3f}; 200 MiB download over the probe's prediction: warm "
          f"x{link['down_miss']:.2f}, cold x{cold['link']['down_miss']:.2f} | request (a) as the "
          f"model decides ({a_row['model_route']}) {a_row['model_s']:.4f} s, x"
          f"{a_row['model_s'] / min(a_row['host_s'], a_row['device_s']):.3f} the faster forced "
          f"route | request (d): est_dev {d_row['est_dev_s']:.4f} s against its device route "
          f"{d_row['device_s']:.4f} s (x{d_row['est_dev_s'] / d_row['device_s']:.3f}), picked "
          f"{d_row['pick']} (cold {d_row['cold_pick']}, defaults {d_row['default_pick']}), as the "
          f"model decides ({d_row['model_route']}) {d_row['model_s']:.4f} s | launches over the "
          f"sweep {launches}")
    t1 = time.perf_counter()
    demo = demo_on_card()
    phase("demo", t1, f"examples/demo_torch.py --device {DEVICE}: {len(demo)} lines, all [ok]; "
          f"last: {demo[-1]}")
    return dict(card=name, nvidia_smi=smi, host=threads, link=link, cold=cold, host_rate=fit,
                host_work=work, engine=dev["engine"], fitted=fitted, sweep=rows,
                launches=launches, wrong_picks=wrong, unsteady_picks=unsteady,
                default_wrong_picks=default_wrong,
                same_picks=same,
                probe_down_warm_over_cold=down_ratio,
                phase_s=time.perf_counter() - t0)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    t_start = time.perf_counter()

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
                                       ("full_gemm_kernel", 1, ("HGMMA", "UTMALDG")),
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

    full_shapes = full_main_shapes(ad, bd, sa_sp, sb_sp, dc_a_sp, dc_b_sp)
    main_full = full_shapes[f"nonsym_a_b_{SIB_N}"]
    report["matmul_full"] = dict(
        shapes=full_shapes, **{key: main_full[key] for key in (
            "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})

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
    k7_kernels_us = op_us(
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
        + [full_line(label, r) for label, r in full_shapes.items()]
        + [ext(f"K2 {N}^2 triu", ext_10k_triu), ext(f"K4 {N}^2 full", ext_10k_full),
           ext(f"K2 {SIB_N}^2 triu", ext_sib_triu),
           ext(f"K4 {SIB_N}^2 ({ext_sib_full['nnz'] / SIB_N**2:.3f} dense)", ext_sib_full),
           *(ext(f"K4 {label} {r['shape'][0]}x{r['shape'][1]}", r) for label, r in k4_chunks.items()),
           f"K7 {SIB_N}^2 by kernel (us): "
           + ", ".join(f"{k} {us:.1f}" for k, us in k7_kernels_us.items())]))

    # 3b. K1's branches against the f64 oracle, and the split3 gate
    t0 = time.perf_counter()
    phase("split3-gate", t0, "max rel err vs f64 oracle: " + split3_gate())

    # 4. main path: the requests through the public entry point, counted.  The
    # process's first routing decision would calibrate the card's link
    # (api._calibrate_link); it is done here, before the requests, and timed.
    t0 = time.perf_counter()
    link_first = dict(api._calibrate_link(DEVICE))
    calibration_s = time.perf_counter() - t0
    ops = {"headline": (a_sp, b_sp), "sibling": (sa_sp, sb_sp)}
    answers = {}
    reset_launches()
    per_request, seconds = counted(
        [(label, request(label, *ops[which], **kw)) for label, which, kw in MAIN_REQUESTS],
        answers)
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
    for label, full in (("headline_symmetric_10k", 0), ("nonsymmetric_12288", 1),
                        ("dense_output_10k", 1)):
        require(per_request[label]["matmul_full"] == full and per_request[label]["split_bf16"] == 2,
                f"{label}: launches {per_request[label]}, not matmul_full x{full} and "
                "split_bf16 x2")

    c_sp = results.pop("headline_symmetric_10k")
    require(c_sp.nnz == N * (N + 1) // 2, f"nnz {c_sp.nnz} != {N * (N + 1) // 2}")
    a64 = torch.from_numpy(a_sp.toarray()).to(DEVICE)
    b64 = torch.from_numpy(b_sp.toarray()).to(DEVICE)
    oracle_full = torch.matmul(a64, b64)
    del a64, b64
    oracle = torch.triu(oracle_full)
    got = csr_on_card(c_sp, DEVICE)
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
        f"routes {routes}", model_note([label for label, _, _ in MAIN_REQUESTS]),
        f"link calibrated before the first request (api._calibrate_link, {calibration_s:.4f} s: "
        f"no first-call time here includes it) {link_first}",
        f"launches by request {per_request}", f"launches {launches_main}"]))

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
    with config_set(**model_pin("sibling_symmetric_12288", sa_sp, sb_sp, symmetric=True)):
        got = smt.sparse_matrix_multiply(sa_sp, sb_sp, symmetric=True)
    require(smt.get_last_route() == "dense", f"sibling route {smt.get_last_route()!r}")
    sib_err = same_csr(got, sp.triu(sib_ref, format="csr"), "symmetric sibling")
    phase("sibling", t0, f"symmetric {SIB_N}^2: nnz {got.nnz} ({got.nnz / SIB_N**2:.3f} of "
          f"{SIB_N}^2), max abs err {sib_err:.2e} | {model_note(['sibling_symmetric_12288'])}")
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
    profiled = call_timeline(lambda: smt.sparse_matrix_multiply(a_sp, b_sp, symmetric=True))
    if profiled is None:
        busy = t_prof = 0.0
        idle = "not measured (no device time traced)"
    else:
        busy, t_prof = profiled["busy_ms"] / 1e3, profiled["wall_ms"] / 1e3
        idle = f"{profiled['idle_share']:.4f}"
    stages = least_stages(lambda: dense_route_stages(a_sp, b_sp, True, DEVICE))
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
    a_bsp, b_bsp = (block_sparse(s, BSR_OCC, BSR_N) for s in BSR_SEEDS)
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
        [(label, request(label, a_bsp, bsr_b[which], BSR_ROUTE, **kw))
         for label, which, kw, _ in BSR_REQUESTS],
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

    a64 = csr_on_card(a_bsp, DEVICE)
    errs = {}
    for which in ("b", "bu"):
        b64 = csr_on_card(bsr_b[which], DEVICE)
        oracle = torch.matmul(a64, b64)
        bound = RTOL * torch.matmul(a64.abs(), b64.abs())
        del b64
        for label, w, kw, _ in BSR_REQUESTS:
            if w != which:
                continue
            sym = kw.get("symmetric", False)
            errs[label] = within_bound(label, bsr_results.pop(label),
                                           torch.triu(oracle) if sym else oracle,
                                           torch.triu(bound) if sym else bound)
        del oracle, bound
    del a64
    phase("bsr-main", t0, " | ".join(
        [f"{label}: {errs[label]:.2e} max abs err vs f64 oracle, {bsr_seconds[label]:.3f} s"
         for label, _, _, _ in BSR_REQUESTS]
        + [f"bsr_x_bsr_8192 extracted by {extraction}", f"routes {bsr_routes}",
           model_note([label for label, _, _, _ in BSR_REQUESTS]),
           f"launches by request {bsr_per_request}", f"launches {launches_bsr}"]))

    # 9. BSR route against the dense route end to end, and request 1's stages
    t0 = time.perf_counter()
    e2e = {}
    for label, which in (("bsr_x_bsr_8192", "b"), ("bsr_x_dense_8192", "bu")):
        with config_set(**BSR_ROUTE):
            e2e[label] = {"bsr": wall_s(lambda: smt.sparse_matrix_multiply(a_bsp, bsr_b[which]))}
        require(smt.get_last_route() == "bsr", f"{label}: timed call took another route")
        e2e[label]["dense"] = wall_s(lambda: smt.sparse_matrix_multiply(a_bsp, bsr_b[which]))
        require(smt.get_last_route() == "dense", f"{label}: the router did not go dense")
    with config_set(**BSR_ROUTE):
        bsr_stages = least_stages(lambda: bsr_route_stages(a_bsp, b_bsp, False, DEVICE))
    phase("bsr-timing", t0, f"{name} [{smi}]: sparse_matrix_multiply end to end, host clock, "
          f"min of {PATH_RUNS}: " + " | ".join(
              f"{label} BSR route (force_bsr) {t['bsr']:.4f} s, dense route (as the router "
              f"decides) {t['dense']:.4f} s"
              for label, t in e2e.items()))
    print(f"[bsr-stages] bsr_x_bsr_8192 sparse_matrix_multiply, host clock, min of "
          f"{PATH_RUNS + 1}: " + json.dumps(bsr_stages), flush=True)
    t0 = time.perf_counter()
    crossover = bsr_crossover(b_bsp)
    cutoff = crossover_cutoff(crossover)
    phase("bsr-crossover", t0, f"{name} [{smi}]: A x B (B {BSR_OCC} occupied), "
          f"sparse_matrix_multiply end to end, host clock, min of {PATH_RUNS} (one run after the "
          f"warm call where that took over {SLOW_CALL_S} s): " + " | ".join(
              f"{r['n']}^2, A occupancy {r['occupancy']:.4f} ({r['pairs']} pairs): BSR route "
              f"{r['bsr']:.4f} s ({r['kernel']}), dense route {r['dense']:.4f} s, BSR/dense "
              f"{r['bsr'] / r['dense']:.3f}" for r in crossover)
          + f" | the cutoff this gives: {cutoff} (Config.cuda_bsr_occupancy_cutoff "
          f"{smt.get_config().cuda_bsr_occupancy_cutoff})")
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
    esc_pair = ops["esc"]
    del ops, kept

    # 15-19. the multi-device layer on a mesh of DIST_SLOTS slots of the card
    dist = dist_phases(a_sp, b_sp, esc_pair, name, smi)
    del esc_pair

    # 20. fetch_np's staged download against the pageable one; the router's
    # cost model re-fitted on this host and link, its crossover sweep, and
    # the demo on the card
    fetch = fetch_phase(name, smi)
    cost = cost_model_phase(sa_sp, sb_sp, name, smi)
    cost["link_first"] = dict(calibrated=link_first, calibrate_s=calibration_s)
    cost["counted_requests"] = {label: dict(est_host_s=e[0], est_dev_s=e[1],
                                            pinned=label in MODEL_PINNED)
                                for label, e in MODEL_ESTIMATES.items()}
    report["csr_to_dense"]["shapes"].update(dist["k3_shapes"])
    report["dense_to_csr"]["shapes"].update(dist["k4_shapes"])
    k3_by_request = {**k3_operands(), **dist["k3_map"]}
    extracted_by_request = extract_operands()
    extracted_by_request["dense_to_csr"].update(dist["k4_map"])

    kernels = []
    by_request = {**per_request, **fast_per_request, **bsr_per_request, **fused_per_call,
                  **triple_per_request, **inv_per_request, **esc_per_request, **dist["per_call"]}
    path_launches = (launches_main, launches_fast, launches_bsr, launches_fused, launches_triple,
                     launches_inv, launches_esc, *dist["launches"])
    k3_shapes = report["csr_to_dense"]["shapes"]
    for shape in k3_shapes.values():
        shape["launches"] = 0
    for label, counts in by_request.items():
        densified = k3_by_request.get(label, ())
        require(counts["csr_to_dense"] == len(densified),
                f"{label}: {counts['csr_to_dense']} K3 launches, not one for each of {densified}")
        for operand in densified:
            k3_shapes[operand]["launches"] += 1
    for key, by_label in extracted_by_request.items():
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
    print(json.dumps({"dist": dist["summary"]}))
    print(json.dumps({"cost_model": cost}))
    print(json.dumps({"fetch": fetch}))
    phase("total", t_start, "chip_smoke.py, every phase")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == COLD_FLAG:
        sys.exit(cold_main(sys.argv[2]))
    sys.exit(main())
