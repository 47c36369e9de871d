// Full-tile GEMM for Hopper (sm_90a) on the tensor cores: C = A . B (or
// A . B^T) over every 128x128 output tile, in HIGHEST's six bf16 passes with
// fp32 accumulation.
//
// Replaces no Pallas kernel: it stands for XLA's
// jnp.dot(..., precision="highest") on f32 operands in the JAX package,
// which the TPU runs as six bf16 passes on its matrix unit:
//   ops/matmul.py::policy_matmul (FAST, and SPLIT's three products; the
//     dense route, dense_chunks and the rings' per-slot contractions),
//   ops/triple_product.py (H . Q, and the chained and SPLIT branches),
//   models/inversion.py (Q H^T and (Q H^T) K^T).
// Each f32 operand is split into three bf16 pieces x = x0 + x1 + x2
// (exact; smm_split_bf16 in triu_matmul.cu) and the passes 20, 11, 02, 10,
// 01, 00 (piece of A, piece of B) are summed; the dropped terms are below
// f32 rounding.
//
// Bound: tensor-core operations.  2 m n k flops, six times, at the card's
// 989 TFLOP/s of bf16: 22.5 ms at 12,288^3, 12.1 ms at 10,000^3 (55.4 and
// 29.9 ms at the 67 TFLOP/s of FP32 FMAs on the CUDA cores, where cuBLAS
// ran these products before).  Operand bytes are far below that line.
// Design:
//   * The wrapper splits A in rows form and B K-major (B of the (K, N) form
//     transposed through shared memory by the split), so both forms are one
//     GEMM over K-major (3, rows_pad, k_pad) pieces, rows padded to 128 and
//     K to the 64-deep K-step with zeros.
//   * One CTA per output tile, every tile of (m_pad / 128) x (n_pad / 128),
//     walked in groups of 8 tile rows and column by column inside a group,
//     so that the CTAs in flight share their A panels (8 rows) and B panels
//     (8 CTAs each) in L2.
//   * Each CTA runs K1's tensor-core core (hopper_gemm.cuh) on its tile
//     with a contiguous K, through the same TileSchedule and launcher: a
//     producer thread's TMA loads into an mbarrier ring, two consumer
//     warpgroups of wgmma m64n128k16, the wgmma accumulator added into fp32
//     registers (Kahan-compensated) after every 64-deep K-step.  A tile K1
//     also computes gets K1's bits.
//   * The epilogue stores the fp32 tile straight from the registers, masked
//     to the (m, n) matrix.

#include "hopper_gemm.cuh"

namespace {

// The tile of block p: groups of kGroup tile rows in order (the last may
// hold fewer); inside a group, column by column, the group's rows in each.
__device__ __forceinline__ void tile_of(int p, int nti, int ntj, int& ti, int& tj) {
  const int g0 = (p / (kGroup * ntj)) * kGroup;
  const int rows = min(kGroup, nti - g0);
  const int rest = p - g0 * ntj;
  ti = g0 + rest % rows;
  tj = rest / rows;
}

// c (m x n, row-major) = sum over the passes of A_pieces[pa] . B_pieces[pb]^T;
// the pieces are (P * rows_pad, k_pad) bf16 arrays behind the tensor maps.
template <int P>
__global__ void __launch_bounds__(kGemmThreads, 1)
full_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b, float* __restrict__ c, int m, int n,
                 int m_pad, int n_pad, int nk, int nti, int ntj) {
  int ti, tj;
  tile_of(blockIdx.x, nti, ntj, ti, tj);
  float acc[64];
  if (gemm_tile<P>(map_a, map_b, TileSchedule{ti, tj, m_pad, n_pad, nk}, acc)) {
    store_tile(acc, c, m, n, ti * kTile, tj * kTile);
  }
}

template <int P>
int gemm(const void* ap, const void* bp, void* c, int64_t m, int64_t n, int64_t m_pad,
         int64_t n_pad, int64_t k_pad, cudaStream_t stream) {
  const int64_t nti = m_pad / kTile, ntj = n_pad / kTile, tiles = nti * ntj;
  if (kGroup * ntj > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;  // tile_of's int math
  return launch_tile_gemm<P>(full_gemm_kernel<P>, tiles, ap, bp, m_pad, n_pad, k_pad, stream,
                             (float*)c, (int)m, (int)n, (int)m_pad, (int)n_pad,
                             (int)(k_pad / kStep), (int)nti, (int)ntj);
}

}  // namespace

extern "C" {

// ap, bp: the three pieces of A (m x K) and of B as (N x K), from
// smm_split_bf16; c: (m, n) f32, every entry written.
int smm_matmul_full_bf16(const void* ap, const void* bp, void* c, int64_t m, int64_t n,
                         int64_t m_pad, int64_t n_pad, int64_t k_pad, int pieces, void* stream) {
  if (m_pad % kTile != 0 || n_pad % kTile != 0 || k_pad % kStep != 0 || k_pad <= 0 ||
      m > m_pad || n > n_pad) {
    return (int)cudaErrorInvalidValue;
  }
  if (pieces == 3) return gemm<3>(ap, bp, c, m, n, m_pad, n_pad, k_pad, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
