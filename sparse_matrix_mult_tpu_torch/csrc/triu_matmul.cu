// Upper-tile-only GEMM for Hopper (sm_90a) on the tensor cores: C = A @ B or
// C = A @ B^T, computed only on the 128x128 output tiles (ti, tj) with
// ti <= tj, in split-bf16 arithmetic with fp32 accumulation.
//
// Replaces the Pallas TPU kernel
//   K1  sparse_matrix_mult_tpu/ops/pallas/triu_matmul.py::_kernel
// (driven by _matmul_triu_impl / matmul_triu / matmul_transpose_triu) in both
// of its branches:
//   * HIGHEST -- a full f32 product.  Each f32 operand is split into three
//     bf16 pieces x = x0 + x1 + x2 (exact), and the six passes 20, 11, 02,
//     10, 01, 00 (piece of A, piece of B) are summed; the dropped terms are
//     below f32 rounding.  This is the six-pass bf16 product the TPU runs.
//   * split3 -- two bf16 halves x ~= hi + lo, three passes lh, hl, hh, the
//     lo*lo term dropped, exactly as the TPU kernel's split3 branch.
//
// Bound: tensor-core operations.  At the 10k headline the 3,160 upper tile
// pairs (128^2, edge tiles by their valid area) with K = 10,000 hold 1.013e12
// flops of the f32 product; at the card's 989 TFLOP/s of bf16 that is 6.14 ms
// for six passes and 3.07 ms for three (15.1 ms at the 67 TFLOP/s of FP32
// FMAs on the CUDA cores, which the f32 kernel this replaces was held to).
// Design:
//   * split_rows_kernel / split_cols_kernel write the P bf16 pieces of an
//     f32 operand K-major, as a (P, rows_pad, k_pad) array with rows padded
//     to 128 and K to the 64-deep K-step, zeros in the padding.  B of the
//     untransposed form (K, N) is transposed through shared memory so both
//     its reads and the pieces' writes are coalesced.  After that both forms
//     of K1 are one GEMM over K-major operands; the split is bandwidth-bound
//     (~0.3 ms at 10k for P = 3).
//   * The grid is the list of upper tile pairs, walked in groups of 8 tile
//     rows and column by column inside a group, so the CTAs in flight share
//     their A panels (8 rows) and B panels (up to 8 CTAs each) in L2.  The
//     strictly-lower tiles are neither loaded nor multiplied and are left
//     unwritten; the caller applies triu.
//   * Each CTA runs the shared tensor-core core of hopper_gemm.cuh on its
//     pair, with a contiguous K: a producer thread's TMA loads into an
//     mbarrier ring, two consumer warpgroups of wgmma m64n128k16, the wgmma
//     accumulator added into fp32 registers (Kahan-compensated) after
//     every 64-deep K-step.
//   * The epilogue stores the fp32 tile straight from the registers, a
//     32-byte sector per row and instruction.

#include "hopper_gemm.cuh"

namespace {

constexpr int kSplitThreads = 256;

// ---------------------------------------------------------------- split ----

// Writes the P bf16 pieces of 8 consecutive K values (one 16-byte store per
// piece): each piece is the bf16 rounding of what the earlier ones left.
template <int P>
__device__ __forceinline__ void store_pieces(float (&v)[8], __nv_bfloat16* dst,
                                             int64_t piece_stride) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat16 h0 = __float2bfloat16_rn(v[2 * i]);
      const __nv_bfloat16 h1 = __float2bfloat16_rn(v[2 * i + 1]);
      v[2 * i] -= __bfloat162float(h0);  // exact in f32
      v[2 * i + 1] -= __bfloat162float(h1);
      w[i] = (uint32_t)__bfloat16_as_ushort(h0) | ((uint32_t)__bfloat16_as_ushort(h1) << 16);
    }
    *reinterpret_cast<uint4*>(dst + p * piece_stride) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// x is (rows, k) row-major; out[p][r][kk] = piece p of x[r][kk].
template <int P>
__global__ void __launch_bounds__(kSplitThreads)
split_rows_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ out, int64_t rows,
                  int64_t k, int64_t rows_pad, int64_t k_pad, int vec) {
  const int64_t groups = k_pad / 8;
  const int64_t idx = (int64_t)blockIdx.x * kSplitThreads + threadIdx.x;
  if (idx >= rows_pad * groups) return;
  const int64_t r = idx / groups, k0 = (idx - r * groups) * 8;
  float v[8];
  if (vec && r < rows && k0 + 8 <= k) {
    const float4* src = reinterpret_cast<const float4*>(x + r * k + k0);
    const float4 lo = src[0], hi = src[1];
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = (r < rows && k0 + i < k) ? x[r * k + k0 + i] : 0.f;
  }
  store_pieces<P>(v, out + r * k_pad + k0, rows_pad * k_pad);
}

// x is (k, rows) row-major (B of the untransposed form); out[p][r][kk] =
// piece p of x[kk][r], through a 64x64 tile of shared memory.
template <int P>
__global__ void __launch_bounds__(kSplitThreads)
split_cols_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ out, int64_t rows,
                  int64_t k, int64_t rows_pad, int64_t k_pad) {
  __shared__ float tile[kStep][kStep + 1];  // [kk][r]
  const int64_t k0 = (int64_t)blockIdx.x * kStep, r0 = (int64_t)blockIdx.y * kStep;
  for (int i = threadIdx.x; i < kStep * kStep; i += kSplitThreads) {
    const int kk = i / kStep, rr = i % kStep;
    const int64_t gk = k0 + kk, gr = r0 + rr;
    tile[kk][rr] = (gk < k && gr < rows) ? x[gk * rows + gr] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kStep * (kStep / 8); i += kSplitThreads) {
    const int rr = i / (kStep / 8), g = i % (kStep / 8);
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = tile[g * 8 + j][rr];
    store_pieces<P>(v, out + (r0 + rr) * k_pad + k0 + g * 8, rows_pad * k_pad);
  }
}

// ------------------------------------------------------------------ GEMM ----

// The upper tile pair of block p: groups of kGroup tile rows in order; inside
// a group, columns tj from the group's first row on, and in each column the
// group's rows ti <= tj.
__device__ __forceinline__ void pair_of(int p, int diag, int ntj, int& ti, int& tj) {
  for (int g0 = 0;; g0 += kGroup) {
    const int rows = min(kGroup, diag - g0);
    const int tri = rows * (rows + 1) / 2;  // columns g0 .. g0 + rows - 1
    const int total = tri + (ntj - g0 - rows) * rows;
    if (p < total) {
      if (p < tri) {
        int t = 0;
        while (p > t) {  // column t holds t + 1 pairs
          p -= t + 1;
          ++t;
        }
        ti = g0 + p;
        tj = g0 + t;
      } else {
        p -= tri;
        ti = g0 + p % rows;
        tj = g0 + rows + p / rows;
      }
      return;
    }
    p -= total;
  }
}

// c (m x n, row-major) on the upper tile pairs = sum over the passes of
// A_pieces[pa] . B_pieces[pb]^T; the pieces are (P * rows_pad, k_pad) bf16
// arrays behind the tensor maps.
template <int P>
__global__ void __launch_bounds__(kGemmThreads, 1)
triu_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b, float* __restrict__ c, int m, int n,
                 int m_pad, int n_pad, int nk, int diag, int ntj) {
  int ti, tj;
  pair_of(blockIdx.x, diag, ntj, ti, tj);
  float acc[64];
  if (gemm_tile<P>(map_a, map_b, TileSchedule{ti, tj, m_pad, n_pad, nk}, acc)) {
    store_tile(acc, c, m, n, ti * kTile, tj * kTile);
  }
}

// ------------------------------------------------------------------ host ----

template <int P>
int split(const void* x, void* out, int64_t rows, int64_t k, int64_t rows_pad, int64_t k_pad,
          int transpose, cudaStream_t stream) {
  const float* src = (const float*)x;
  __nv_bfloat16* dst = (__nv_bfloat16*)out;
  if (transpose) {
    if (rows_pad / kStep > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)(k_pad / kStep), (unsigned)(rows_pad / kStep));
    split_cols_kernel<P><<<grid, kSplitThreads, 0, stream>>>(src, dst, rows, k, rows_pad, k_pad);
  } else {
    const int64_t work = rows_pad * (k_pad / 8);
    const int vec = (k % 4 == 0) && ((uintptr_t)x % 16 == 0);
    split_rows_kernel<P><<<(unsigned)((work + kSplitThreads - 1) / kSplitThreads), kSplitThreads,
                           0, stream>>>(src, dst, rows, k, rows_pad, k_pad, vec);
  }
  return (int)cudaGetLastError();
}

template <int P>
int gemm(const void* ap, const void* bp, void* c, int64_t m, int64_t n, int64_t m_pad,
         int64_t n_pad, int64_t k_pad, cudaStream_t stream) {
  const int64_t nti = m_pad / kTile, ntj = n_pad / kTile;
  const int64_t diag = nti < ntj ? nti : ntj;
  int64_t pairs = 0;
  for (int64_t g0 = 0; g0 < diag; g0 += kGroup) {
    const int64_t rows = diag - g0 < kGroup ? diag - g0 : kGroup;
    pairs += rows * (rows + 1) / 2 + (ntj - g0 - rows) * rows;
  }
  return launch_tile_gemm<P>(triu_gemm_kernel<P>, pairs, ap, bp, m_pad, n_pad, k_pad, stream,
                             (float*)c, (int)m, (int)n, (int)m_pad, (int)n_pad,
                             (int)(k_pad / kStep), (int)diag, (int)ntj);
}

}  // namespace

extern "C" {

// x: f32 (rows, k) row-major, or (k, rows) with transpose; out: bf16 (pieces,
// rows_pad, k_pad) with rows_pad a multiple of 128 and k_pad of 64.
int smm_split_bf16(const void* x, void* out, int64_t rows, int64_t k, int64_t rows_pad,
                   int64_t k_pad, int pieces, int transpose, void* stream) {
  if (rows_pad % kTile != 0 || k_pad % kStep != 0 || rows_pad < rows || k_pad < k) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (pieces == 2) return split<2>(x, out, rows, k, rows_pad, k_pad, transpose, s);
  if (pieces == 3) return split<3>(x, out, rows, k, rows_pad, k_pad, transpose, s);
  return (int)cudaErrorInvalidValue;
}

// ap, bp: the pieces of A (m x K) and of B as (N x K), from smm_split_bf16;
// c: (m, n) f32, written on the upper tile pairs only.
int smm_matmul_triu_bf16(const void* ap, const void* bp, void* c, int64_t m, int64_t n,
                         int64_t m_pad, int64_t n_pad, int64_t k_pad, int pieces, void* stream) {
  if (m_pad % kTile != 0 || n_pad % kTile != 0 || k_pad % kStep != 0 || k_pad <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (pieces == 2) return gemm<2>(ap, bp, c, m, n, m_pad, n_pad, k_pad, (cudaStream_t)stream);
  if (pieces == 3) return gemm<3>(ap, bp, c, m, n, m_pad, n_pad, k_pad, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
