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
//   * One producer warp starts TMA loads (128B-swizzled 128x64 bf16 tiles)
//     of all P pieces of A's and B's K-step into a ring of shared-memory
//     stages (2 of 96 KB for P = 3, 3 of 64 KB for P = 2), with full/empty
//     mbarriers.  Two consumer warpgroups each run wgmma m64n128k16 (bf16 in,
//     fp32 out, both operands from shared memory, K-major) on 64 rows of the
//     tile, small terms first.
//   * Tensor-core accumulation aligns and truncates; kept in the wgmma
//     accumulator over all of K, that bias reaches ~3e-5 relative at the
//     triple product's and the inversion's shapes (measured on an H100
//     with a variant built that way), outside the rtol 1e-5 oracle.  So the
//     wgmma accumulator holds one K-step only and is added to an fp32
//     register accumulator by CUDA-core adds (round to nearest) after each
//     K-step, at no measured cost in time.
//   * The epilogue stores the fp32 tile straight from the registers, a
//     32-byte sector per row and instruction.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;                      // output tile edge, rows of a TMA tile
constexpr int kStep = 64;                       // K depth of a stage: 128 bytes of bf16
constexpr int kTileBytes = kTile * kStep * 2;   // one piece of one operand in a stage
constexpr int kGroup = 8;                       // tile rows walked together
constexpr int kConsumerWarps = 8;               // two warpgroups
constexpr int kGemmThreads = (kConsumerWarps + 1) * 32;  // + one producer warp
constexpr int kSplitThreads = 256;

template <int P>
struct Ring {
  static constexpr int stages = P == 3 ? 2 : 3;
  static constexpr int stage_bytes = 2 * P * kTileBytes;
  static constexpr int smem = stages * stage_bytes + 1024 + 2 * stages * 8;
};

// Pieces of the pass t, small terms first: P = 3 runs 20, 11, 02, 10, 01, 00;
// P = 2 runs 10 (lh), 01 (hl), 00 (hh).
__host__ __device__ constexpr int passes(int P) { return P == 3 ? 6 : 3; }
__host__ __device__ constexpr int pass_a(int P, int t) {
  return P == 3 ? (t == 0 ? 2 : t == 1 ? 1 : t == 3 ? 1 : 0) : (t == 0 ? 1 : 0);
}
__host__ __device__ constexpr int pass_b(int P, int t) {
  return P == 3 ? (t == 1 ? 1 : t == 2 ? 2 : t == 4 ? 1 : 0) : (t == 1 ? 1 : 0);
}

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

// ------------------------------------------------------------ Hopper PTX ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Returns once the phase of parity `parity` has completed.  A wait that
// outlasts 2^26 polls (seconds; a stage normally lands in microseconds) traps,
// so a pipeline fault ends the launch with an error instead of hanging it.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major, 128B-swizzled tile whose
// 8-row atoms (8 x 128 bytes) lie 1024 bytes apart; the tile is 1024-aligned.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving register accesses across the async wgmma.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 fp32, spread over the warpgroup) = A (64 x 16) . B^T (16 x 128),
// plus d itself unless scale_d is 0; A and B bf16, K-major, in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
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
  using R = Ring<P>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = raw + ((1024 - (raw & 1023)) & 1023);  // 1024-aligned stage ring
  const uint32_t full = base + R::stages * R::stage_bytes;     // mbarriers, 8 bytes each
  const uint32_t empty = full + R::stages * 8;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int ti, tj;
  pair_of(blockIdx.x, diag, ntj, ti, tj);

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // producer
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&map_a)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&map_b)) : "memory");
      for (int ks = 0; ks < nk; ++ks) {
        const int s = ks % R::stages;
        if (ks >= R::stages) mbar_wait(empty + 8 * s, ((ks / R::stages) - 1) & 1);
        const uint32_t stage = base + s * R::stage_bytes;
        mbar_expect_tx(full + 8 * s, R::stage_bytes);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          tma_load(stage + p * kTileBytes, &map_a, full + 8 * s, ks * kStep,
                   p * m_pad + ti * kTile);
          tma_load(stage + (P + p) * kTileBytes, &map_b, full + 8 * s, ks * kStep,
                   p * n_pad + tj * kTile);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile.
  const int wg = warp / 4;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

  for (int ks = 0; ks < nk; ++ks) {
    const int s = ks % R::stages;
    mbar_wait(full + 8 * s, (ks / R::stages) & 1);
    const uint32_t a_tiles = base + s * R::stage_bytes + wg * (kTile / 2) * kStep * 2;
    const uint32_t b_tiles = base + s * R::stage_bytes + P * kTileBytes;
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < passes(P); ++t) {
      const uint64_t da = smem_desc(a_tiles + pass_a(P, t) * kTileBytes);
      const uint64_t db = smem_desc(b_tiles + pass_b(P, t) * kTileBytes);
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk) {  // 32 bytes further along K each
        wgmma_m64n128k16(part, da + 2 * kk, db + 2 * kk, (t > 0 || kk > 0) ? 1 : 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(part);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }

  // Register j of a thread holds row 16 (warp % 4) + lane / 4 + 8 ((j / 2) % 2)
  // and column 8 (j / 4) + 2 (lane % 4) + j % 2 of the warpgroup's 64 x 128.
  const int r0 = ti * kTile + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int c0 = tj * kTile + 2 * (lane % 4);
  const bool even_n = (n & 1) == 0;
#pragma unroll
  for (int j = 0; j < 64; j += 2) {
    const int r = r0 + 8 * ((j / 2) % 2);
    const int col = c0 + 8 * (j / 4);
    if (r < m && col < n) {
      float* dst = c + (int64_t)r * n + col;
      if (even_n) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[j], acc[j + 1]);
      } else {
        dst[0] = acc[j];
        if (col + 1 < n) dst[1] = acc[j + 1];
      }
    }
  }
}

// ------------------------------------------------------------------ host ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, taken through the runtime so the
// library links the runtime only.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess) fn = (EncodeTiled)ptr;
  }
  return fn;
}

// Tensor map of a (rows, k_pad) bf16 array: 128 x 64 boxes, 128B swizzle.
bool tensor_map(CUtensorMap* map, const void* ptr, int64_t rows, int64_t k_pad) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)k_pad, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k_pad * 2};
  const cuuint32_t box[2] = {kStep, kTile};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

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
  if (pairs == 0) return 0;
  CUtensorMap map_a, map_b;
  if (!tensor_map(&map_a, ap, P * m_pad, k_pad) || !tensor_map(&map_b, bp, P * n_pad, k_pad)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      triu_gemm_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<P>::smem);
  if (err != cudaSuccess) return (int)err;
  triu_gemm_kernel<P><<<(unsigned)pairs, kGemmThreads, Ring<P>::smem, stream>>>(
      map_a, map_b, (float*)c, (int)m, (int)n, (int)m_pad, (int)n_pad, (int)(k_pad / kStep),
      (int)diag, (int)ntj);
  return (int)cudaGetLastError();
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
