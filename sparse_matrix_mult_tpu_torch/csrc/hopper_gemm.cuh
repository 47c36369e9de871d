// The split-bf16 tensor-core GEMM core that K1 (triu_matmul.cu), K5 and K6
// (bsr_spgemm.cu) share, for Hopper (sm_90a).
//
// A CTA computes one 128x128 fp32 output tile as the sum over P bf16 pieces
// of each operand: sum over the passes (pa, pb) of A_pa . B_pb^T, where both
// operands are K-major (P * rows, k_pad) bf16 arrays behind TMA tensor maps
// (128 x 64 boxes, 128B swizzle).  P = 3 runs HIGHEST's six passes 20, 11,
// 02, 10, 01, 00 (a full f32 product); P = 2 runs split3's 10, 01, 00.
//
//   * One producer warp starts TMA loads of all P pieces of A's and B's
//     64-deep K-step into a ring of shared-memory stages (2 of 96 KB for
//     P = 3, 3 of 64 KB for P = 2), with full/empty mbarriers.
//   * Two consumer warpgroups each run wgmma m64n128k16 (bf16 in, fp32 out,
//     both operands from shared memory) on 64 rows of the tile, small terms
//     first.
//   * Tensor-core accumulation aligns and truncates; kept in the wgmma
//     accumulator over a long K that bias leaves the rtol 1e-5 oracle (~3e-5
//     relative at the triple product's and the inversion's shapes, measured
//     on an H100).  So the wgmma accumulator holds one K-step only and is
//     added to an fp32 register accumulator (round to nearest) after each.
//   * For P = 3 (a full f32 product) that add is compensated (Kahan):
//     plain, its rounding grows with the number of K-steps and reached
//     1.2e-6 of |A| |B| at K = 16,384 (the distributed triple's second
//     ring, measured on an H100), above the 1e-6 the six passes are held
//     to.  What the add rounded off starts the wgmma accumulator of the
//     next K-step; between K-steps it waits in 32 registers as bf16 pairs
//     (their rounding leaves 2^-9 of it).  Kept as 64 floats it took the
//     consumers past the 168 registers a thread of this CTA can have and
//     spilled (setmaxnreg does not raise what ptxas allocates); kept in
//     shared memory it was slower still.  P = 2 (split3, whose dropped
//     term is ~2^-16) adds plainly.
//   * The two consumer warpgroups take turns issuing their wgmmas (named
//     barriers), so that one's adds overlap the other's products.
//
// What differs between the kernels is the schedule, a struct with
//   int  steps() const           -- the tile's number of 64-deep K-steps;
//   int2 a_at(int ks, int p)     -- (K column, row) of A's box of piece p at step ks;
//   int2 b_at(int ks, int p)     -- the same for B.
// A kernel with one tile per CTA picks it, builds its schedule, calls
// gemm_tile and stores the tile with store_tile; K1 and matmul_full share
// TileSchedule (their tile over all of K) and launch_tile_gemm, and differ
// only in which tiles their blocks map to.  A persistent kernel sets
// the ring up once (ring_setup) and runs produce / consume on each of its
// tiles in turn, counting the ring's steps across tiles, so the producer
// loads a tile's first K-steps while the consumers store the tile before;
// its consumers call end_turns after their last tile.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mbarrier.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int kTile = 128;                      // output tile edge, rows of a TMA box
constexpr int kStep = 64;                       // K depth of a stage: 128 bytes of bf16
constexpr int kTileBytes = kTile * kStep * 2;   // one piece of one operand in a stage
constexpr int kConsumerWarps = 8;               // two warpgroups
constexpr int kGemmThreads = (kConsumerWarps + 1) * 32;  // + one producer warp
constexpr int kGroup = 8;  // tile rows walked together, so CTAs in flight share panels in L2

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

// ------------------------------------------------------------ Hopper PTX ----

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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The bf16 halves of w: the low one is the first (an exact widening).
__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float* out) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xFFFF0000u);
}

// ------------------------------------------------------------------ core ----

// The ring of stages in dynamic shared memory (1024-aligned) and its full /
// empty mbarriers, initialised by the whole CTA.
template <int P>
struct RingSmem {
  uint32_t base, full, empty;
};

template <int P>
__device__ __forceinline__ RingSmem<P> ring_setup() {
  using R = Ring<P>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  RingSmem<P> r;
  r.base = raw + ((1024 - (raw & 1023)) & 1023);  // 1024-aligned stage ring
  r.full = r.base + R::stages * R::stage_bytes;   // mbarriers, 8 bytes each
  r.empty = r.full + R::stages * 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::stages; ++s) {
      mbar_init(r.full + 8 * s, 1);
      mbar_init(r.empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The producer (one thread): TMA loads of the schedule's K-steps, which are
// the ring's steps g0, g0 + 1, ... counted over every tile the CTA has run.
template <int P, class Schedule>
__device__ __forceinline__ void produce(const RingSmem<P>& r, const CUtensorMap& map_a,
                                        const CUtensorMap& map_b, const Schedule& sched,
                                        int g0) {
  using R = Ring<P>;
  const int nk = sched.steps();
  for (int ks = 0; ks < nk; ++ks) {
    const int g = g0 + ks, s = g % R::stages;
    if (g >= R::stages) mbar_wait(r.empty + 8 * s, ((g / R::stages) - 1) & 1);
    const uint32_t stage = r.base + s * R::stage_bytes;
    mbar_expect_tx(r.full + 8 * s, R::stage_bytes);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int2 at = sched.a_at(ks, p), bt = sched.b_at(ks, p);
      tma_load(stage + p * kTileBytes, &map_a, r.full + 8 * s, at.x, at.y);
      tma_load(stage + (P + p) * kTileBytes, &map_b, r.full + 8 * s, bt.x, bt.y);
    }
  }
}

// The two consumer warpgroups take turns on the tensor cores (named
// barriers 1 and 2): warpgroup wg waits for its turn before it issues a
// K-step's wgmmas and hands the turn over once they are issued.  The tensor
// cores take them in that order, so one warpgroup's adds into acc overlap
// the other's products instead of both adding while the tensor cores idle.
__device__ __forceinline__ void wait_turn(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void pass_turn(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg) : "memory");
}

// After a consumer's last K-step: warpgroup 0 takes the turn the last
// K-step of warpgroup 1 handed over, so that every barrier completes.
__device__ __forceinline__ void end_turns(int steps) {
  if (threadIdx.x / 128 == 0 && steps > 0) wait_turn(0);
}

// The consumers (256 threads): the schedule's K-steps from ring step g0 on,
// summed into acc (their part of the tile, see store_tile).
template <int P, class Schedule>
__device__ __forceinline__ void consume(const RingSmem<P>& r, const Schedule& sched, int g0,
                                        float (&acc)[64]) {
  using R = Ring<P>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nk = sched.steps();
  // Warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile.
  const int wg = warp / 4;
  constexpr bool compensated = P == 3;
  float part[64];
  uint32_t rest[32];  // compensated: what the adds into acc rounded off, bf16 pairs
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) rest[j] = 0;

  for (int ks = 0; ks < nk; ++ks) {
    const int g = g0 + ks, s = g % R::stages;
    mbar_wait(r.full + 8 * s, (g / R::stages) & 1);
    const uint32_t a_tiles = r.base + s * R::stage_bytes + wg * (kTile / 2) * kStep * 2;
    const uint32_t b_tiles = r.base + s * R::stage_bytes + P * kTileBytes;
    if (compensated) {
#pragma unroll
      for (int j = 0; j < 32; ++j) unpack_bf16x2(rest[j], part + 2 * j);
    }
    fence_regs(part);
    if (g > 0 || wg == 1) wait_turn(wg);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < passes(P); ++t) {
      const uint64_t da = smem_desc(a_tiles + pass_a(P, t) * kTileBytes);
      const uint64_t db = smem_desc(b_tiles + pass_b(P, t) * kTileBytes);
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk) {  // 32 bytes further along K each
        wgmma_m64n128k16(part, da + 2 * kk, db + 2 * kk, (compensated || t > 0 || kk > 0) ? 1 : 0);
      }
    }
    wgmma_commit();
    pass_turn(wg);
    wgmma_wait_all();
    fence_regs(part);
    __syncwarp();
    if (lane == 0) mbar_arrive(r.empty + 8 * s);
    if (compensated) {  // Kahan: acc takes part, what it rounded off starts the next step
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float left[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * j + e;
          const float sum = acc[i] + part[i];
          left[e] = part[i] - (sum - acc[i]);
          acc[i] = sum;
        }
        rest[j] = pack_bf16x2(left[0], left[1]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
  }
  if (compensated) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      unpack_bf16x2(rest[j], part + 2 * j);
      acc[2 * j] += part[2 * j];
      acc[2 * j + 1] += part[2 * j + 1];
    }
  }
}

__device__ __forceinline__ void prefetch_maps(const CUtensorMap& map_a, const CUtensorMap& map_b) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&map_a)) : "memory");
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&map_b)) : "memory");
}

// Runs the schedule's K loop for one 128x128 tile.  Returns true in the 256
// consumer threads, whose acc then holds their part of the tile (see
// store_tile), and false in the producer warp.  Needs Ring<P>::smem bytes of
// dynamic shared memory and kGemmThreads threads.
template <int P, class Schedule>
__device__ __forceinline__ bool gemm_tile(const CUtensorMap& map_a, const CUtensorMap& map_b,
                                          const Schedule& sched, float (&acc)[64]) {
  const RingSmem<P> r = ring_setup<P>();
  if (threadIdx.x / 32 == kConsumerWarps) {  // producer
    if (threadIdx.x % 32 == 0) {
      prefetch_maps(map_a, map_b);
      produce(r, map_a, map_b, sched, 0);
    }
    return false;
  }
  consume(r, sched, 0, acc);
  end_turns(sched.steps());
  return true;
}

// The tile (ti, tj) over all of K, contiguous.
struct TileSchedule {
  int ti, tj, m_pad, n_pad, nk;
  __device__ int steps() const { return nk; }
  __device__ int2 a_at(int ks, int p) const { return make_int2(ks * kStep, p * m_pad + ti * kTile); }
  __device__ int2 b_at(int ks, int p) const { return make_int2(ks * kStep, p * n_pad + tj * kTile); }
};

// Stores a consumer thread's part of the tile whose top-left entry is
// (row0, col0) into c (m x n, row-major), inside the matrix only: register
// j holds row 16 (warp % 4) + lane / 4 + 8 ((j / 2) % 2) and column
// 8 (j / 4) + 2 (lane % 4) + j % 2 of its warpgroup's 64 x 128.
__device__ __forceinline__ void store_tile(const float (&acc)[64], float* __restrict__ c, int m,
                                           int n, int row0, int col0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = row0 + (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
  const int c0 = col0 + 2 * (lane % 4);
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
// Boxes reaching past the array read zeros.
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

// Launches `kernel`, a one-tile-per-CTA GEMM whose first two parameters are
// the tensor maps of A's and B's P pieces ((P * m_pad, k_pad) and
// (P * n_pad, k_pad) bf16, as TileSchedule reads them), on `blocks` CTAs
// with `args` after the maps.  Returns a cudaError_t.
template <int P, class Kernel, class... Args>
int launch_tile_gemm(Kernel* kernel, int64_t blocks, const void* ap, const void* bp,
                     int64_t m_pad, int64_t n_pad, int64_t k_pad, cudaStream_t stream,
                     Args... args) {
  if (blocks == 0) return 0;
  const int64_t rows_pad = m_pad > n_pad ? m_pad : n_pad;  // TMA rows are int32
  if (blocks > 0x7FFFFFFF || P * rows_pad > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  if (!tensor_map(&map_a, ap, P * m_pad, k_pad) || !tensor_map(&map_b, bp, P * n_pad, k_pad)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = raise_smem_limit_once(kernel, Ring<P>::smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kGemmThreads, Ring<P>::smem, stream>>>(map_a, map_b, args...);
  return (int)cudaGetLastError();
}

}  // namespace
