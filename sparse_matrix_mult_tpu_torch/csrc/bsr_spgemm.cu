// Block-sparse (BSR, 128x128 blocks) products for Hopper (sm_90a).
//
// Replaces these Pallas TPU kernels of sparse_matrix_mult_tpu/ops/pallas/bsr_spgemm.py:
//   K5  _kernel     (BSR A x dense B -> dense)                 -> bsr_dense_kernel
//   K6  _kernel_bb  (BSR A x BSR B -> dense over planned pairs) -> bsr_bsr_kernel
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
// K6 runs FP32 FMAs on the CUDA cores (TF32 cannot meet the rtol = 1e-5
// oracle).  Bound: FP32 arithmetic, each pair a 2 * 128^3-flop block
// product.  Design:
//   * The TPU kernel walks a sequential grid of pairs and keeps the output
//     tile in VMEM across a run of pairs that share it.  GPU blocks run
//     unordered, so here one thread block owns one run of consecutive pairs
//     that share an output block (the run heads are the pairs flagged
//     `first`) and accumulates the tile in registers, storing it once.
//   * Each block product is staged through shared memory in 128x8 slabs of A
//     and 8x128 slabs of B, the next slab prefetched into registers while the
//     current one is multiplied, over the concatenated K ranges of the run's
//     pairs.
//   * 256 threads each hold an 8x8 accumulator over rows trow + 16*i and
//     columns tcol + 16*j: conflict-free shared reads, coalesced stores.
//   * Output blocks no pair visits are zero-filled by the caller and never
//     written.  Ragged edges are bounds-checked.

#include "hopper_gemm.cuh"

namespace {

constexpr int kBlock = kTile;                     // BSR block edge = output tile edge
constexpr int kSlab = 8;                          // K depth staged per step
constexpr int kSlabs = kBlock / kSlab;            // 16 steps per block product
constexpr int kPer = 8;                           // accumulator rows/cols per thread
constexpr int kSide = kBlock / kPer;              // 16 threads along each tile edge
constexpr int kThreads = kSide * kSide;           // 256
constexpr int kLoads = kBlock * kSlab / kThreads; // 4 elements of each slab per thread
constexpr int kPad = 4;
constexpr int64_t kBlockElems = (int64_t)kBlock * kBlock;

// Columns [k0, k0 + kSlab) of a contiguous 128x128 block: e -> (e / kSlab, e % kSlab).
__device__ __forceinline__ void load_a_slab(const float* __restrict__ blk, int k0,
                                            float (&r)[kLoads]) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    r[i] = blk[(e / kSlab) * kBlock + k0 + e % kSlab];
  }
}

// Rows [k0, k0 + kSlab) of a contiguous 128x128 block: e -> (e / kBlock, e % kBlock).
__device__ __forceinline__ void load_b_block_slab(const float* __restrict__ blk, int k0,
                                                  float (&r)[kLoads]) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    r[i] = blk[(k0 + e / kBlock) * kBlock + e % kBlock];
  }
}

// Stores the A slab transposed (s[k][row]) and the B slab as is (s[k][col]).
__device__ __forceinline__ void store_slabs(float (*as)[kBlock + kPad], float (*bs)[kBlock + kPad],
                                            const float (&ra)[kLoads], const float (&rb)[kLoads]) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    as[e % kSlab][e / kSlab] = ra[i];
    bs[e / kBlock][e % kBlock] = rb[i];
  }
}

__device__ __forceinline__ void fma_slab(const float (*as)[kBlock + kPad],
                                         const float (*bs)[kBlock + kPad], int trow, int tcol,
                                         float (&acc)[kPer][kPer]) {
#pragma unroll
  for (int k = 0; k < kSlab; ++k) {
    float a[kPer], b[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) a[i] = as[k][trow + kSide * i];
#pragma unroll
    for (int j = 0; j < kPer; ++j) b[j] = bs[k][tcol + kSide * j];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void store_tile(float* __restrict__ c, int M, int N, int row0, int col0,
                                           int trow, int tcol, const float (&acc)[kPer][kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = row0 + trow + kSide * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int col = col0 + tcol + kSide * j;
      if (col < N) c[(int64_t)r * N + col] = acc[i][j];
    }
  }
}

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

// Step t of the K6 slab loop: slab t % kSlabs of pair first + t / kSlabs.
__device__ __forceinline__ void load_k6_step(const int32_t* __restrict__ pa,
                                             const int32_t* __restrict__ pb,
                                             const float* __restrict__ a_blocks,
                                             const float* __restrict__ b_blocks, int first, int t,
                                             float (&ra)[kLoads], float (&rb)[kLoads]) {
  const int p = first + t / kSlabs, k0 = (t % kSlabs) * kSlab;
  load_a_slab(a_blocks + (int64_t)pa[p] * kBlockElems, k0, ra);
  load_b_block_slab(b_blocks + (int64_t)pb[p] * kBlockElems, k0, rb);
}

// grid.x = number of runs; run r is pairs [bounds[r], bounds[r + 1]).
__global__ void __launch_bounds__(kThreads)
bsr_bsr_kernel(const int32_t* __restrict__ bounds, const int32_t* __restrict__ pa,
               const int32_t* __restrict__ pb, const int32_t* __restrict__ ci,
               const int32_t* __restrict__ cj, const float* __restrict__ a_blocks,
               const float* __restrict__ b_blocks, float* __restrict__ c, int nbr, int M, int N) {
  const int first = bounds[blockIdx.x];
  const int bi = ci[first], bj = cj[first];
  if (bi >= nbr) return;  // padding pairs of a padded plan: the dummy block-row
  const int steps = (bounds[blockIdx.x + 1] - first) * kSlabs;

  __shared__ float as[kSlab][kBlock + kPad];
  __shared__ float bs[kSlab][kBlock + kPad];
  const int trow = threadIdx.x / kSide, tcol = threadIdx.x % kSide;

  float acc[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0.f;

  float ra[kLoads], rb[kLoads];
  load_k6_step(pa, pb, a_blocks, b_blocks, first, 0, ra, rb);
  for (int t = 0; t < steps; ++t) {
    store_slabs(as, bs, ra, rb);
    __syncthreads();
    if (t + 1 < steps) load_k6_step(pa, pb, a_blocks, b_blocks, first, t + 1, ra, rb);
    fma_slab(as, bs, trow, tcol, acc);
    __syncthreads();
  }
  store_tile(c, M, N, bi * kBlock, bj * kBlock, trow, tcol, acc);
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
  cudaError_t err = cudaFuncSetAttribute(bsr_dense_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<3>::smem);
  if (err != cudaSuccess) return (int)err;
  bsr_dense_kernel<<<(unsigned)grid, kGemmThreads, Ring<3>::smem, (cudaStream_t)stream>>>(
      map_a, map_b, (const int32_t*)indptr, (const int32_t*)indices, (float*)c, (int)cap,
      (int)m, (int)n, (int)n_pad);
  return (int)cudaGetLastError();
}

// bounds (n_runs + 1): run boundaries into the pair tables pa/pb/ci/cj;
// a_blocks, b_blocks (cap, 128, 128); c: (m, n), zero-filled by the caller.
int smm_bsr_bsr_matmul_dense_f32(const void* bounds, const void* pa, const void* pb,
                                 const void* ci, const void* cj, const void* a_blocks,
                                 const void* b_blocks, void* c, int64_t n_runs, int64_t nbr,
                                 int64_t m, int64_t n, void* stream) {
  if (n_runs > 0) {
    bsr_bsr_kernel<<<(unsigned)n_runs, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)bounds, (const int32_t*)pa, (const int32_t*)pb, (const int32_t*)ci,
        (const int32_t*)cj, (const float*)a_blocks, (const float*)b_blocks, (float*)c, (int)nbr,
        (int)m, (int)n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
