// Block-sparse (BSR, 128x128 blocks) products for Hopper (sm_90a).
//
// Replaces these Pallas TPU kernels of sparse_matrix_mult_tpu/ops/pallas/bsr_spgemm.py:
//   K5  _kernel     (BSR A x dense B -> dense)                 -> bsr_dense_kernel
//   K6  _kernel_bb  (BSR A x BSR B -> dense over planned pairs) -> pair_runs_kernel,
//                                                                  bsr_bsr_kernel
//
// K5 computes C = A_bsr . B with A's zero blocks skipped, at HIGHEST
// precision as the TPU kernel does (precision=HIGHEST: the six-pass bf16
// product on the MXU).  Bound: tensor-core operations.  Every stored A block
// meets each 128-wide column tile of B: 2 * 128^2 * N flops per block, six
// bf16 passes at the card's 989 TFLOP/s (0.68 ms at 8192^2 with 10% of the
// blocks occupied), far above its bytes.  Design:
//   * The wrapper splits A's stored blocks (cap, 128, 128) into three bf16
//     pieces, rows form, (3, cap * 128, 128), and B's first K rows,
//     transposed, into K-major pieces (3, n_pad, nbc * 128); rows of B from
//     K on are never read and their pieces are zero.
//   * bsr_dense_kernel runs the shared tensor-core core of hopper_gemm.cuh
//     (the one K1 runs) with a gathered K: one CTA per (block-row br,
//     128-wide column tile j); its K loop walks the block slots
//     min(indptr[br], cap) .. min(indptr[br + 1], cap), two 64-deep K-steps
//     per block, loading A's piece p of slot s at (kk, p * cap * 128 +
//     s * 128) and B's at (indices[s] * 128 + kk, p * n_pad + j * 128).
//   * The column tile runs fastest over the grid, so the CTAs in flight
//     walk one or two block-rows against every column tile of B and share
//     those block-rows' A blocks in L2.  Measured at 8192^2 with 10% of the
//     blocks occupied on an H100 (tools/compare_checkouts.py): 1.36 ms
//     for K5 whole against 1.57 ms with the block-row fastest (the CTAs in
//     flight sharing B's column panels instead), the same bits.
//   * Every output entry is written: a block-row with no stored block (or
//     none inside the capacity) runs no K-step and stores a zero tile.  Only
//     the first `cap` slots are read, as the TPU grid does: an indptr that
//     counts blocks past the capacity (bsr_from_dense with fewer slots than
//     nonzero blocks) loses those blocks and reads nothing out of bounds.
//
// K6 computes C = A_bsr . B_bsr over the planned block pairs (pa, pb, ci,
// cj), sorted by output block, at HIGHEST precision as the TPU kernel does:
// the same six bf16 passes on the tensor cores as K5.  Bound: bytes, the
// dense output written once and the stored blocks read once (0.097 ms at
// 8192^2 with 10% of the blocks occupied, 2,929 pairs; the six passes of
// its 2 * 128^3 flops per pair take 0.075 ms at 989 TFLOP/s).  Design:
//   * The TPU kernel walks a sequential grid of pairs and keeps the output
//     tile in VMEM across a run of pairs that share it.  GPU blocks run
//     unordered, so here one CTA owns one output block (bi, bj) and walks
//     its run of pairs, [bounds[b], bounds[b + 1]) with b = bi * nbc + bj.
//   * pair_runs_kernel finds every block's run by binary search in the
//     sorted keys ci * nbc + cj (the planner's padding pairs, in block-row
//     nbr, sort last and are never reached), and checks every table entry
//     in the same launch: a slot past either capacity or a block off the
//     output sets bit 1 of a flag word, keys out of order bit 2.  The wrapper
//     launches the GEMM, then reads the flag (its one host synchronisation)
//     and raises on a bad table.  The GEMM is safe to run on one: it reads
//     only bounds[0 .. nbr * nbc], each pair's run lies inside the tables,
//     and a slot is only a TMA coordinate, whose box past the pieces is
//     zero-filled, never read.
//   * bsr_bsr_kernel runs the tensor-core core of hopper_gemm.cuh with a
//     pair schedule: two 64-deep K-steps per pair, loading A's piece p of
//     pair q at (kk, p * cap_a * 128 + pa[q] * 128) and B's at
//     (pb[q] * 128 + kk, p * 128).  A's pieces are its stored blocks in rows
//     form, (3, cap_a * 128, 128); B's are its stored blocks transposed as
//     one (cap_b * 128, 128) matrix, (3, 128, cap_b * 128), whose columns
//     [s * 128, s * 128 + 128) are block s transposed: the K-major form the
//     core loads, with no per-block transpose.
//   * Every output entry is written once: a block that no pair visits, or
//     that the visited-block mask leaves out, runs no K-step and stores a
//     zero tile (as K5's empty block-rows), so the output needs no zero fill.
//   * A run is short (2,929 pairs over 2,100 visited blocks at 8192^2), so
//     a CTA per block paid its prologue, first loads and 64 KB epilogue in
//     turn, one CTA per SM (0.244 ms for the GEMM, measured on an H100).  The
//     kernel is persistent instead: one CTA per SM runs block after block
//     through one ring, the producer loading the next block's pairs while
//     the consumers store the last tile.  Blocks are claimed on demand from
//     a counter in device memory: walking blocks c, c + 132, ... in a fixed
//     order left the CTAs with uneven shares of the pairs (a block has 0 to
//     ~6), and the whole call was slower than with a CTA per block (0.50
//     against 0.37 ms, tools/compare_checkouts.py on an H100).  The blocks
//     in flight are ~132 consecutive ones, so they share one or two
//     block-rows of A in L2.

#include "hopper_gemm.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int kBlock = kTile;  // BSR block edge = output tile edge

// K5's schedule: block-row br's stored slots [start, start + nblk) against
// column tile tj, two K-steps per block.
struct BsrSchedule {
  const int32_t* __restrict__ indices;
  int start, nblk, a_rows, n_pad, tj;  // a_rows = cap * 128: rows of one piece of A
  __device__ int steps() const { return 2 * nblk; }
  __device__ int2 a_at(int ks, int p) const {
    return make_int2((ks % 2) * kStep, p * a_rows + (start + ks / 2) * kBlock);
  }
  __device__ int2 b_at(int ks, int p) const {
    return make_int2(__ldg(indices + start + ks / 2) * kBlock + (ks % 2) * kStep,
                     p * n_pad + tj * kBlock);
  }
};

// grid.x = nbr * (column tiles of B); the column tile runs fastest.
__global__ void __launch_bounds__(kGemmThreads, 1)
bsr_dense_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b, const int32_t* __restrict__ indptr,
                 const int32_t* __restrict__ indices, float* __restrict__ c, int cap, int m,
                 int n, int n_pad) {
  const int tiles = n_pad / kBlock, br = blockIdx.x / tiles, tj = blockIdx.x % tiles;
  const int start = min(indptr[br], cap);
  const int nblk = max(min(indptr[br + 1], cap) - start, 0);
  float acc[64];
  if (gemm_tile<3>(map_a, map_b, BsrSchedule{indices, start, nblk, cap * kBlock, n_pad, tj}, acc)) {
    store_tile(acc, c, m, n, br * kBlock, tj * kBlock);
  }
}

// K6's schedule: the n pairs from lo of one output block, two K-steps each.
// A slot is only ever a TMA coordinate: one past the pieces (a table entry
// the run check refuses, the call raising after the launch) loads zeros.
struct PairSchedule {
  const int32_t* __restrict__ pa;
  const int32_t* __restrict__ pb;
  int lo, n, a_rows;  // a_rows = cap_a * 128: rows of one piece of A
  __device__ int steps() const { return 2 * n; }
  __device__ int2 a_at(int ks, int p) const {
    const unsigned slot = (unsigned)__ldg(pa + lo + ks / 2);
    return make_int2((ks % 2) * kStep, (int)((unsigned)(p * a_rows) + slot * kBlock));
  }
  __device__ int2 b_at(int ks, int p) const {
    const unsigned slot = (unsigned)__ldg(pb + lo + ks / 2);
    return make_int2((int)(slot * kBlock + (ks % 2) * kStep), p * kBlock);
  }
};

// Sort key of output block (i, j); 64-bit, so entries off the output stay ordered.
__device__ __forceinline__ int64_t pair_key(const int32_t* __restrict__ ci,
                                            const int32_t* __restrict__ cj, int64_t q,
                                            int64_t nbc) {
  return (int64_t)ci[q] * nbc + cj[q];
}

// Thread t checks pair t (t < n) and finds the run start of output block t
// (t <= nbr * nbc): the first pair whose key is at least t.
__global__ void __launch_bounds__(256)
pair_runs_kernel(const int32_t* __restrict__ pa, const int32_t* __restrict__ pb,
                 const int32_t* __restrict__ ci, const int32_t* __restrict__ cj, int64_t n,
                 int64_t cap_a, int64_t cap_b, int64_t nbr, int64_t nbc,
                 int32_t* __restrict__ bounds, int32_t* __restrict__ flag) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) {
    int bad = 0;
    if (pa[t] < 0 || pa[t] >= cap_a || pb[t] < 0 || pb[t] >= cap_b || ci[t] < 0 ||
        ci[t] > nbr || cj[t] < 0 || cj[t] >= nbc) {
      bad |= 1;  // the dummy block-row nbr of the padding is allowed
    }
    if (t > 0 && pair_key(ci, cj, t - 1, nbc) > pair_key(ci, cj, t, nbc)) bad |= 2;
    if (bad) atomicOr(flag, bad);
  }
  if (t <= nbr * nbc) {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (pair_key(ci, cj, mid, nbc) < t) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    bounds[t] = (int32_t)lo;
  }
}

constexpr int kClaims = 4;  // depth of a CTA's ring of claimed output blocks

// Persistent, one CTA per SM, with the output blocks handed out on demand:
// the producer claims block blockIdx.x first, then the next unclaimed one
// from the counter work[0] (block b = bi * nbc + bj, so the blocks in flight
// share a block-row of A) once the last block's loads are issued, and passes
// each claim to the consumers through a small ring of block ids.  Its loads of the next
// block's pairs overlap the consumers' store of the last tile; a block with
// no pair (or masked out) stores a zero tile.  A claim past the last block
// ends the CTA; the last CTA to end resets work[0] and work[1] to 0, so the
// kernel can be launched again on the same words.
__global__ void __launch_bounds__(kGemmThreads, 1)
bsr_bsr_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b, const int32_t* __restrict__ bounds,
               const int32_t* __restrict__ pa, const int32_t* __restrict__ pb,
               const bool* __restrict__ mask, float* __restrict__ c, unsigned* __restrict__ work,
               int nbr, int nbc, int cap_a, int m, int n) {
  __shared__ int claimed[kClaims];
  __shared__ __align__(8) uint64_t claim_bars[2 * kClaims];  // full, then empty
  const uint32_t claim_full = smem_u32(claim_bars), claim_empty = claim_full + 8 * kClaims;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kClaims; ++i) {
      mbar_init(claim_full + 8 * i, 1);
      mbar_init(claim_empty + 8 * i, kConsumerWarps);
    }
  }
  const RingSmem<3> r = ring_setup<3>();  // its __syncthreads publishes the barriers above
  const int blocks = nbr * nbc;
  auto schedule = [&](int b) {
    const int lo = bounds[b];
    return PairSchedule{pa, pb, lo, mask[b] ? bounds[b + 1] - lo : 0, cap_a * kBlock};
  };
  int g = 0;  // ring steps so far
  if (threadIdx.x / 32 == kConsumerWarps) {  // producer
    if (threadIdx.x % 32 == 0) {
      prefetch_maps(map_a, map_b);
      for (int t = 0;; ++t) {
        const int slot = t % kClaims;
        if (t >= kClaims) mbar_wait(claim_empty + 8 * slot, ((t / kClaims) - 1) & 1);
        const int b = t == 0 ? (int)blockIdx.x : (int)(gridDim.x + atomicAdd(work, 1u));
        claimed[slot] = b;
        mbar_arrive(claim_full + 8 * slot);  // release: the consumers read claimed[slot]
        if (b >= blocks) break;
        const PairSchedule sched = schedule(b);
        produce(r, map_a, map_b, sched, g);
        g += sched.steps();
      }
      __threadfence();  // this CTA's claims before its count of the CTAs done
      if (atomicAdd(work + 1, 1u) == gridDim.x - 1) {  // every CTA has made its last claim
        __threadfence();
        work[0] = 0;
        work[1] = 0;
      }
    }
    return;
  }
  float acc[64];
  for (int t = 0;; ++t) {
    const int slot = t % kClaims;
    mbar_wait(claim_full + 8 * slot, (t / kClaims) & 1);
    const int b = *(volatile int*)&claimed[slot];
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(claim_empty + 8 * slot);
    if (b >= blocks) break;
    const PairSchedule sched = schedule(b);
    consume(r, sched, g, acc);
    store_tile(acc, c, m, n, (b / nbc) * kBlock, (b % nbc) * kBlock);
    g += sched.steps();
  }
  end_turns(g);
}

}  // namespace

extern "C" {

// indptr (nbr + 1), indices (cap): A's block structure, logical rows m;
// ap: A's stored blocks split into 3 bf16 pieces, (3, cap * 128, 128); bp:
// B's pieces, K-major, (3, n_pad, k_pad) with k_pad = 128 * A's block
// columns; c: (m, n) f32, every entry written.
int smm_bsr_matmul_dense_bf16(const void* indptr, const void* indices, const void* ap,
                              const void* bp, void* c, int64_t nbr, int64_t cap, int64_t m,
                              int64_t n, int64_t n_pad, int64_t k_pad, void* stream) {
  if (n_pad % kBlock != 0 || k_pad % kBlock != 0 || k_pad <= 0 || cap <= 0 ||
      3 * cap * kBlock >= INT32_MAX || 3 * n_pad >= INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t grid = nbr * (n_pad / kBlock);
  if (grid == 0) return 0;
  if (grid > INT32_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  if (!tensor_map(&map_a, ap, 3 * cap * kBlock, kBlock) ||
      !tensor_map(&map_b, bp, 3 * n_pad, k_pad)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = raise_smem_limit_once(bsr_dense_kernel, Ring<3>::smem);
  if (err != cudaSuccess) return (int)err;
  bsr_dense_kernel<<<(unsigned)grid, kGemmThreads, Ring<3>::smem, (cudaStream_t)stream>>>(
      map_a, map_b, (const int32_t*)indptr, (const int32_t*)indices, (float*)c, (int)cap,
      (int)m, (int)n, (int)n_pad);
  return (int)cudaGetLastError();
}

// pa, pb, ci, cj: n pair table entries; bounds (nbr * nbc + 1) and flag:
// see pair_runs_kernel.  flag is three words, zeroed here: the check's flag,
// then the two words of K6's block counter (smm_bsr_bsr_matmul_dense_bf16).
int smm_bsr_pair_runs(const void* pa, const void* pb, const void* ci, const void* cj, int64_t n,
                      int64_t cap_a, int64_t cap_b, int64_t nbr, int64_t nbc, void* bounds,
                      void* flag, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(flag, 0, 3 * sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  const int64_t threads = (n > nbr * nbc + 1 ? n : nbr * nbc + 1);
  const int64_t grid = (threads + 255) / 256;
  if (grid > INT32_MAX || n > INT32_MAX) return (int)cudaErrorInvalidValue;
  pair_runs_kernel<<<(unsigned)grid, 256, 0, s>>>(
      (const int32_t*)pa, (const int32_t*)pb, (const int32_t*)ci, (const int32_t*)cj, n, cap_a,
      cap_b, nbr, nbc, (int32_t*)bounds, (int32_t*)flag);
  return (int)cudaGetLastError();
}

// bounds (nbr * nbc + 1) from smm_bsr_pair_runs on checked tables; mask
// (nbr, nbc) bool; ap: A's stored blocks split into 3 bf16 pieces, (3,
// cap_a * 128, 128); bp: B's, (3, 128, cap_b * 128); c: (m, n) f32, every
// entry written; work: two words, zero (smm_bsr_pair_runs zeroes them, and
// each launch leaves them zero), the kernel's block counter.
int smm_bsr_bsr_matmul_dense_bf16(const void* bounds, const void* pa, const void* pb,
                                  const void* mask, const void* ap, const void* bp, void* c,
                                  void* work, int64_t nbr, int64_t nbc, int64_t cap_a,
                                  int64_t cap_b, int64_t m, int64_t n, void* stream) {
  if (cap_a <= 0 || cap_b <= 0 || 3 * cap_a * kBlock >= INT32_MAX ||
      cap_b * kBlock >= INT32_MAX || nbr * kBlock < m || nbc * kBlock < n) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t blocks = nbr * nbc;
  if (blocks == 0) return 0;
  if (blocks > INT32_MAX / 2) return (int)cudaErrorInvalidValue;  // claims run past it
  CUtensorMap map_a, map_b;
  if (!tensor_map(&map_a, ap, 3 * cap_a * kBlock, kBlock) ||
      !tensor_map(&map_b, bp, 3 * kBlock, cap_b * kBlock)) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = raise_smem_limit_once(bsr_bsr_kernel, Ring<3>::smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(blocks < sms ? blocks : sms);  // one CTA per SM
  bsr_bsr_kernel<<<grid, kGemmThreads, Ring<3>::smem, (cudaStream_t)stream>>>(
      map_a, map_b, (const int32_t*)bounds, (const int32_t*)pa, (const int32_t*)pb,
      (const bool*)mask, (float*)c, (unsigned*)work, (int)nbr, (int)nbc, (int)cap_a, (int)m,
      (int)n);
  return (int)cudaGetLastError();
}

// From triu_matmul.cu, in the same library.
int smm_split_bf16(const void* x, void* out, int64_t rows, int64_t k, int64_t rows_pad,
                   int64_t k_pad, int pieces, int transpose, void* stream);

// A whole K6 call, its five launches in one host call: a_blocks (cap_a, 128,
// 128) and b_blocks (cap_b, 128, 128) f32; ap (3, cap_a * 128, 128) and bp
// (3, 128, cap_b * 128) receive the pieces (smm_split_bf16 of A's blocks in
// rows form, of B's transposed); pa, pb, ci, cj: n pair table entries;
// bounds (nbr * nbc + 1), state (three words) and c as above.
int smm_bsr_bsr_matmul_dense_f32(const void* a_blocks, const void* b_blocks, void* ap, void* bp,
                                 const void* pa, const void* pb, const void* ci, const void* cj,
                                 int64_t n_pairs, const void* mask, void* bounds, void* state,
                                 void* c, int64_t nbr, int64_t nbc, int64_t cap_a, int64_t cap_b,
                                 int64_t m, int64_t n, void* stream) {
  int err = smm_split_bf16(a_blocks, ap, cap_a * kBlock, kBlock, cap_a * kBlock, kBlock, 3, 0,
                           stream);
  if (err == 0) {
    err = smm_split_bf16(b_blocks, bp, kBlock, cap_b * kBlock, kBlock, cap_b * kBlock, 3, 1,
                         stream);
  }
  if (err == 0) {
    err = smm_bsr_pair_runs(pa, pb, ci, cj, n_pairs, cap_a, cap_b, nbr, nbc, bounds, state,
                            stream);
  }
  if (err == 0) {
    err = smm_bsr_bsr_matmul_dense_bf16(bounds, pa, pb, mask, ap, bp, c,
                                        (int32_t*)state + 1, nbr, nbc, cap_a, cap_b, m, n,
                                        stream);
  }
  return err;
}

}  // extern "C"
