// Block-sparse (BSR, 128x128 blocks) FP32 products for Hopper (sm_90a).
//
// Replaces these Pallas TPU kernels of sparse_matrix_mult_tpu/ops/pallas/bsr_spgemm.py:
//   K5  _kernel     (BSR A x dense B -> dense)                 -> bsr_dense_kernel
//   K6  _kernel_bb  (BSR A x BSR B -> dense over planned pairs) -> bsr_bsr_kernel
//
// Bound: FP32 arithmetic.  Every stored A block meets a 128x128 tile of B
// (K5: one per column tile of B; K6: one per planned pair), i.e. 2*128^3
// flops for 128 KB of operands, far above the card's FP32 ridge point.  As in
// K1 (triu_matmul.cu), TF32 cannot meet the rtol = 1e-5 oracle, so every
// product is an FP32 FMA on the CUDA cores.  Design:
//   * The TPU kernels walk a sequential grid of block slots (K5) or pairs
//     (K6) and keep the output tile in VMEM across a run of slots that share
//     it.  GPU blocks run unordered, so here one thread block owns one output
//     tile and runs the whole accumulation itself: K5, one block per
//     (block-row of A, 128-wide column tile of B), walking the block-row's
//     blocks through indptr; K6, one block per run of consecutive pairs that
//     share an output block (the run heads are the pairs flagged `first`).
//     The tile is accumulated in registers and stored once.
//   * Each block product is staged through shared memory in 128x8 slabs of A
//     and 8x128 slabs of B, the next slab prefetched into registers while the
//     current one is multiplied -- K1's slab loop, run over the concatenated
//     K ranges of the blocks (K5) or pairs (K6) of the tile.  A and K6's B
//     blocks are contiguous 128x128 arrays; K5 reads rows
//     [bcol*128, bcol*128 + 128) of the dense B inside the tile's columns.
//   * 256 threads each hold an 8x8 accumulator over rows trow + 16*i and
//     columns tcol + 16*j: conflict-free shared reads, coalesced stores.
//   * Zero blocks cost nothing.  K5 blocks whose block-row holds no block
//     store a zero tile, so the output needs no separate fill; K6's output
//     is zero-filled by the caller and unvisited blocks are never written.
//     Ragged edges (shapes that are not multiples of 128) are bounds-checked.
//   * K5 reads only the first `cap` block slots, as the TPU grid does: an
//     indptr that counts blocks past the capacity (bsr_from_dense with fewer
//     slots than nonzero blocks) loses those blocks and reads nothing out of
//     bounds.  Rows of B at or past K (A's column count) are read as zero.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;                       // BSR block edge = output tile edge
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

// Rows [row0, row0 + kSlab) and columns [col0, col0 + 128) of a row-major
// (K, N) matrix, zero outside it (a block column id out of range included).
__device__ __forceinline__ void load_b_dense_slab(const float* __restrict__ b, int K, int N,
                                                  int row0, int col0, float (&r)[kLoads]) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int gk = row0 + e / kBlock, gc = col0 + e % kBlock;
    r[i] = ((unsigned)gk < (unsigned)K && gc < N) ? b[(int64_t)gk * N + gc] : 0.f;
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

// Step t of the K5 slab loop: slab t % kSlabs of the block-row's block t / kSlabs.
__device__ __forceinline__ void load_k5_step(const int32_t* __restrict__ indices,
                                             const float* __restrict__ blocks,
                                             const float* __restrict__ b, int K, int N, int start,
                                             int col0, int t, float (&ra)[kLoads],
                                             float (&rb)[kLoads]) {
  const int s = start + t / kSlabs, k0 = (t % kSlabs) * kSlab;
  load_a_slab(blocks + (int64_t)s * kBlockElems, k0, ra);
  load_b_dense_slab(b, K, N, indices[s] * kBlock + k0, col0, rb);
}

// grid.x = nbr * (column tiles of B); the block-row index runs fastest, so
// the blocks in flight share a few column tiles of B in L2.
__global__ void __launch_bounds__(kThreads)
bsr_dense_kernel(const int32_t* __restrict__ indptr, const int32_t* __restrict__ indices,
                 const float* __restrict__ blocks, const float* __restrict__ b,
                 float* __restrict__ c, int nbr, int cap, int M, int K, int N) {
  const int br = blockIdx.x % nbr, col0 = (blockIdx.x / nbr) * kBlock;
  const int start = min(indptr[br], cap);
  const int steps = (min(indptr[br + 1], cap) - start) * kSlabs;

  __shared__ float as[kSlab][kBlock + kPad];
  __shared__ float bs[kSlab][kBlock + kPad];
  const int trow = threadIdx.x / kSide, tcol = threadIdx.x % kSide;

  float acc[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0.f;

  float ra[kLoads], rb[kLoads];
  if (steps > 0) load_k5_step(indices, blocks, b, K, N, start, col0, 0, ra, rb);
  for (int t = 0; t < steps; ++t) {
    store_slabs(as, bs, ra, rb);
    __syncthreads();
    if (t + 1 < steps) load_k5_step(indices, blocks, b, K, N, start, col0, t + 1, ra, rb);
    fma_slab(as, bs, trow, tcol, acc);
    __syncthreads();
  }
  store_tile(c, M, N, br * kBlock, col0, trow, tcol, acc);
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

// indptr (nbr + 1), indices (cap), blocks (cap, 128, 128): A, logical rows m
// and columns k; b: (>= k, n) row-major, rows from k on not read;
// c: (m, n), every entry written.
int smm_bsr_matmul_dense_f32(const void* indptr, const void* indices, const void* blocks,
                             const void* b, void* c, int64_t nbr, int64_t cap, int64_t m,
                             int64_t k, int64_t n, void* stream) {
  const int64_t grid = nbr * ((n + kBlock - 1) / kBlock);
  if (grid > 0) {
    bsr_dense_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)indptr, (const int32_t*)indices, (const float*)blocks, (const float*)b,
        (float*)c, (int)nbr, (int)cap, (int)m, (int)k, (int)n);
  }
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
