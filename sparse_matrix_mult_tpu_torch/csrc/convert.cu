// CSR <-> dense conversion kernels for Hopper (sm_90a).
//
// Replaces these Pallas TPU kernels of sparse_matrix_mult_tpu/ops/pallas/convert_kernels.py:
//   K3  _distribute_kernel          (CSR -> dense)           -> csr_to_dense_kernel
//   K4  _concentrate_kernel         (dense -> packed CSR)    -> count_rows, scan_counts,
//                                                              fill_rows<T, false>
//   K2  _concentrate_payload_kernel (upper-triangular dense
//        -> packed CSR, staircase)                         -> count_rows, scan_counts,
//                                                              fill_rows<T, true>
//
// Bound: device-memory bandwidth.  Each element is read once per pass and
// each entry written once; there is no arithmetic to speak of.  The TPU
// kernels route entries through log2(L) shift networks on (R, L) lane views
// and stitch the lane runs with an XLA scan, because scatter and
// dynamic-offset stores are near-serial or do not lower there.  On Hopper a
// scatter is a plain store, so the designs are direct.
//
// K3 (csr_to_dense_kernel): its bound is the CSR read once plus the dense
// matrix written once (0.143 ms at the 10k operand, 1e7 entries, on an H100;
// the dense write is 83% of it).  A kernel that zero-fills the matrix in
// device memory and then scatters into it writes every line twice and,
// with the matrix far larger than L2, reads most of them back in between.
// So every dense element is written exactly once, from shared memory:
//   * Persistent CTAs (several per SM) each walk a contiguous range of flat
//     tiles of the row-major output, tile t covering elements
//     [t * tile, (t + 1) * tile), at 16-byte-aligned starts.  A wide row
//     spans several tiles; a narrow one shares a tile with its neighbours.
//   * Each CTA has two shared buffers.  It zeroes one with 16-byte stores
//     and scatters the tile's run of entries into it while the other drains
//     to device memory through an asynchronous bulk copy
//     (cp.async.bulk.global.shared::cta, issued by one thread, one bulk
//     group per tile); a buffer is reused only after its copy has read it
//     (cp.async.bulk.wait_group.read 1), and fence.proxy.async orders the
//     threads' shared stores before the copy.  A tile's store overlaps the
//     next tile's scatter.
//   * The run.  Entries are sorted by flat position, so a tile's run starts
//     where the previous tile's ended: only a CTA's first tile searches
//     (lower_bound in its first row).  The run is scanned in passes of
//     kDensifyPass entries, each thread taking kDensifyPer consecutive ones
//     (loaded before the buffer is free, for the first pass) and finding
//     its first entry's row once among the few rows the tile spans, then
//     walking forward.  The first entry past the tile's end (atomicMin in
//     shared memory) is the next tile's start; the scan stops at the end
//     of the tile's last row, so capacity padding past indptr[m] is never
//     read.  Without this chaining, a tile's two dependent binary searches
//     in device memory were most of its time (measured on an H100, PERF.md).
//   * A bulk copy needs a 16-byte-aligned address and a multiple of 16
//     bytes, so the ragged tail of the last tile (m * n * itemsize not a
//     multiple of 16) is written with plain stores.
// K2/K4 (count_rows, scan_counts, fill_rows; three launches from two C calls).
// Bound: bytes, the matrix (its upper triangle for K2) read once and the
// packed CSR written once: 0.22 ms at the 10k triangle, 0.34 ms at a
// 12,288^2 matrix with 5.4e7 nonzeros.  Two passes read the matrix twice,
// which the bound leaves room for (~0.28 ms at the triangle); what held the
// first design (one 4-byte load per lane per step, at most 128 bytes in
// flight per warp) back was latency, so this one keeps more bytes in flight:
//   * One warp per row.  A row's segment [c0, n) (c0 = row for the
//     triangle) is a scalar head up to the first 16-byte boundary (a row's
//     start is aligned only when n * itemsize is), 16-byte vectors (float4,
//     double2), and a scalar tail.  Each lane loads kExtractUnroll vectors
//     per step, 32 * 16 * kExtractUnroll = 2 KB in flight per warp.
//   * count_rows counts each lane's nonzeros and sums them over the warp
//     into indptr[row + 1]; scan_counts (one CTA) turns those counts into
//     indptr in place: the exclusive scan, 64-bit, clamped at capacity.  No
//     host-side scan sits between the passes.
//   * fill_rows re-reads the row the same way, loading the next step while
//     it writes the current one, and writes each nonzero's (col, value) from
//     indptr[row] in column order: a lane's V elements are V consecutive
//     columns, so the entries before element e of lane L are those of the
//     lanes below L (one ballot per element position, counted over the lanes
//     below) and those of its own elements before e.  A step's entries are
//     ranked into a per-warp shared buffer (one spare word per 32, so the
//     lanes' stores, V slots apart, hit distinct banks) and written from
//     there by consecutive lanes.  Written straight from the lanes, each
//     store instruction covered 512 bytes at a 16-byte stride, and K2 took
//     0.84 ms at the 10k triangle against the scalar design's 0.57 (device
//     alone, on an H100).
//     Writes at or past capacity are dropped, a row stops once its next
//     entry would be past it, and the same launch zero-fills [indptr[m],
//     capacity).  Flat offsets are 64-bit.
//   * On an H100 the fill moves its read and write bytes at 2.5-2.6 TB/s, so
//     the count pass (the matrix's second read) is the gap to the bound.
//     Single-pass versions that find each piece's offset by decoupled
//     look-back were slower even than the first two-pass design at 12,288^2
//     (tools/compare_checkouts.py, PERF.md): with a warp per 2 KB row
//     segment, thousands of scans in flight each looked back across hundreds
//     of unfinished predecessors (1.6x its time); with a CTA per 64 KB tile,
//     staged in shared memory by cp.async, a tile's load, scan and write ran
//     in turn (1.15x).

#include <cuda_runtime.h>
#include <stdint.h>

#include "extract.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_ptr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__host__ __device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

constexpr int64_t kDensifyMaxTile = 96 * 1024;  // largest tile: a CTA's two buffers fit an SM
constexpr int kDensifyMinCtas = 3;  // CTAs per SM the registers must allow (32 KB tiles fill an SM)
constexpr int kDensifyPer = 4;                   // consecutive entries per thread per pass
constexpr int64_t kDensifyPass = (int64_t)kThreads * kDensifyPer;

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst), "r"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// Until at most one bulk group (the latest tile's) still reads shared memory.
__device__ __forceinline__ void bulk_wait_read_all_but_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// First position in a[lo, hi) whose value is >= key (a sorted).
__device__ __forceinline__ int64_t lower_bound(const int32_t* __restrict__ a, int64_t lo, int64_t hi,
                                               int64_t key) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// CTA b walks tiles [b * per_cta, (b + 1) * per_cta) of tile_elems elements
// each (tile_elems * sizeof(T) a multiple of 16 bytes); its two buffers sit
// at 0 and tile_elems * sizeof(T) in dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads, kDensifyMinCtas)
csr_to_dense_kernel(const int32_t* __restrict__ indptr, const int32_t* __restrict__ indices,
                    const T* __restrict__ values, T* __restrict__ dense, int64_t m, int64_t n,
                    int64_t tile_elems, int64_t per_cta) {
  extern __shared__ __align__(128) unsigned char densify_smem[];
  __shared__ long long s_next[2];  // the next tile's run start, one per buffer
  const int tid = threadIdx.x;
  const int64_t total = m * n;
  const int64_t n_tiles = (total + tile_elems - 1) / tile_elems;
  const int64_t t_first = (int64_t)blockIdx.x * per_cta;
  const int64_t t_stop = lmin(t_first + per_cta, n_tiles);
  if (t_first >= t_stop) return;
  const int64_t tile_bytes = tile_elems * (int64_t)sizeof(T);
  int64_t f0 = t_first * tile_elems;
  if (tid == 0) {
    const int64_t r = f0 / n;
    s_next[1] = lower_bound(indices, indptr[r], indptr[r + 1], f0 - r * n);
  }
  __syncthreads();
  int64_t s = s_next[1];  // the current tile's run start
  for (int64_t t = t_first; t < t_stop; ++t, f0 += tile_elems) {
    const int buf = (int)((t - t_first) & 1);
    unsigned char* raw = densify_smem + buf * tile_bytes;
    T* tile = reinterpret_cast<T*>(raw);
    const int64_t len = lmin(tile_elems, total - f0), end = f0 + len;
    const int64_t r0 = f0 / n, r1 = (end - 1) / n;  // rows of the first and last element
    const int64_t hi = indptr[r1 + 1];              // the run lies in [s, hi)
    for (int64_t q = s;; q += kDensifyPass) {
      int64_t p = q + tid * kDensifyPer;
      const int64_t stop = lmin(p + kDensifyPer, hi);
      int32_t col[kDensifyPer];
      T val[kDensifyPer];
#pragma unroll
      for (int u = 0; u < kDensifyPer; ++u) {
        if (p + u < stop) {
          col[u] = indices[p + u];
          val[u] = values[p + u];
        }
      }
      if (q == s) {  // the first pass: the buffer, zeroed, once its last copy has read it
        if (tid == 0) {
          bulk_wait_read_all_but_one();
          s_next[buf] = hi;
        }
        __syncthreads();
        for (int64_t i = tid; i < (len * (int64_t)sizeof(T) + 15) / 16; i += kThreads) {
          reinterpret_cast<uint4*>(raw)[i] = make_uint4(0, 0, 0, 0);
        }
        __syncthreads();
      }
      int found = 0;
      if (p < stop) {
        int64_t lo = r0, top = r1;  // p's row: the last one starting at or before p
        while (lo < top) {
          const int64_t mid = (lo + top + 1) >> 1;
          if (indptr[mid] <= p) {
            lo = mid;
          } else {
            top = mid - 1;
          }
        }
        int64_t row = lo, next = lo == r1 ? hi : indptr[lo + 1];
#pragma unroll
        for (int u = 0; u < kDensifyPer; ++u) {
          if (p + u < stop) {
            while (next <= p + u) next = indptr[++row + 1];  // forward over the rows it passes
            const int64_t local = row * n + col[u] - f0;
            if (local >= len) {  // past the tile: the next tile's run starts here
              atomicMin(&s_next[buf], (long long)(p + u));
              found = 1;
              break;
            }
            tile[local] = val[u];
          }
        }
      }
      if (__syncthreads_or(found) || q + kDensifyPass >= hi) break;
    }
    s = s_next[buf];
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // shared stores -> the copy
    __syncthreads();
    const int64_t bytes = len * (int64_t)sizeof(T), bulk = bytes & ~(int64_t)15;
    if (tid == 0) {
      if (bulk > 0) bulk_store(dense + f0, smem_ptr(raw), (uint32_t)bulk);
      bulk_commit();
    }
    for (int64_t i = bulk / (int64_t)sizeof(T) + tid; i < len; i += kThreads) {
      dense[f0 + i] = tile[i];  // the ragged tail of the last tile
    }
  }
  if (tid == 0) bulk_wait_all();
}

constexpr int kExtractUnroll = 4;  // 16-byte vectors per lane per step
constexpr int kScanThreads = 1024;

// A row's segment [c0, n): `head` scalars up to the first 16-byte boundary,
// `nvec` vectors of V elements from column c0 + head, then the scalar tail
// from column `tail`.
template <typename T>
struct RowSegment {
  static constexpr int V = 16 / sizeof(T);
  int64_t c0, head, nvec, tail;
  __device__ RowSegment(const T* row, int64_t c0_, int64_t n) : c0(c0_) {
    const int64_t mis = (int64_t)((reinterpret_cast<uintptr_t>(row + c0) / sizeof(T)) % V);
    head = lmin(mis ? V - mis : 0, n - c0);
    nvec = (n - c0 - head) / V;
    tail = c0 + head + nvec * V;
  }
};

// Step v0 of a segment: lane's vectors v0 + u * 32 + lane, zero past the end.
template <typename T>
__device__ __forceinline__ void load_step(const uint4* __restrict__ vin, int64_t v0, int64_t nvec,
                                          int lane, Vec16<T> (&x)[kExtractUnroll]) {
#pragma unroll
  for (int u = 0; u < kExtractUnroll; ++u) {
    const int64_t v = v0 + u * kWarp + lane;
    x[u].raw = v < nvec ? __ldg(vin + v) : make_uint4(0, 0, 0, 0);
  }
}

// Row r's nonzeros (columns [r, n) for the triangle) into indptr[r + 1].
template <typename T, bool kTriu>
__global__ void __launch_bounds__(kThreads)
count_rows(const T* __restrict__ dense, int64_t m, int64_t n, int32_t* __restrict__ indptr) {
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= m) return;
  const T* in = dense + row * n;
  const RowSegment<T> seg(in, kTriu ? row : 0, n);
  int count = 0;
  if (lane < seg.head) count += in[seg.c0 + lane] != T(0);
  const uint4* vin = reinterpret_cast<const uint4*>(in + seg.c0 + seg.head);
  for (int64_t v0 = 0; v0 < seg.nvec; v0 += kWarp * kExtractUnroll) {
    Vec16<T> x[kExtractUnroll];
    load_step<T>(vin, v0, seg.nvec, lane, x);
#pragma unroll
    for (int u = 0; u < kExtractUnroll; ++u) {
#pragma unroll
      for (int e = 0; e < RowSegment<T>::V; ++e) count += x[u].e[e] != T(0);
    }
  }
  if (lane < n - seg.tail) count += in[seg.tail + lane] != T(0);
  count = __reduce_add_sync(kFull, count);
  if (lane == 0) indptr[row + 1] = count;
}

// indptr[1..m] hold the row counts; rewrites them, and indptr[0], as the
// exclusive scan clamped at capacity.  One CTA: thread t scans its
// contiguous chunk of rows after a block scan of the chunks' sums.
__global__ void __launch_bounds__(kScanThreads)
scan_counts(int32_t* __restrict__ indptr, int64_t m, int64_t capacity) {
  __shared__ long long warp_sums[kScanThreads / kWarp];
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int64_t per = (m + kScanThreads - 1) / kScanThreads;
  const int64_t lo = lmin((int64_t)tid * per, m), hi = lmin(lo + per, m);
  long long sum = 0;
  for (int64_t r = lo; r < hi; ++r) sum += indptr[r + 1];
  long long incl = sum;  // inclusive scan over the warp, then over the warps' sums
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const long long y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == kWarp - 1) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    long long w = warp_sums[lane];
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const long long y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  long long run = incl - sum + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int64_t r = lo; r < hi; ++r) {
    run += indptr[r + 1];
    indptr[r + 1] = (int32_t)(run < capacity ? run : capacity);
  }
  if (tid == 0) indptr[0] = 0;
}

// Up to 32 scalars from column c (lane i takes c + i, i < len), ranked by ballot.
template <typename T>
__device__ __forceinline__ void fill_scalars(const T* __restrict__ in, int64_t c, int64_t len,
                                             int lane, unsigned below, int64_t capacity,
                                             int64_t& pos, int32_t* __restrict__ indices,
                                             T* __restrict__ values) {
  const T v = lane < len ? in[c + lane] : T(0);
  const bool live = v != T(0);
  const unsigned mask = __ballot_sync(kFull, live);
  const int64_t dst = pos + __popc(mask & below);
  if (live && dst < capacity) {
    indices[dst] = (int32_t)(c + lane);
    values[dst] = v;
  }
  pos += __popc(mask);
}

// indptr holds the exclusive scan of the counts, clamped at capacity.
template <typename T, bool kTriu>
__global__ void __launch_bounds__(kThreads)
fill_rows(const T* __restrict__ dense, int64_t m, int64_t n, const int32_t* __restrict__ indptr,
          int64_t capacity, int32_t* __restrict__ indices, T* __restrict__ values) {
  constexpr int V = RowSegment<T>::V;
  constexpr int kStepVecs = kWarp * kExtractUnroll;  // vectors of a warp's step
  constexpr int kStaged = staged_words(kStepVecs * V);
  // A warp's entries of one step, in column order (staged), written out from
  // here with consecutive lanes on consecutive positions.
  __shared__ int32_t s_col[kWarpsPerBlock][kStaged];
  __shared__ T s_val[kWarpsPerBlock][kStaged];
  const int warp = threadIdx.x / kWarp;
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  const int lane = threadIdx.x % kWarp;
  if (row < m) {
    const T* in = dense + row * n;
    const unsigned below = (1u << lane) - 1u;  // lanes ranked before this one
    const RowSegment<T> seg(in, kTriu ? row : 0, n);
    int64_t pos = indptr[row];
    fill_scalars(in, seg.c0, seg.head, lane, below, capacity, pos, indices, values);
    const uint4* vin = reinterpret_cast<const uint4*>(in + seg.c0 + seg.head);
    Vec16<T> x[kExtractUnroll];
    load_step<T>(vin, 0, seg.nvec, lane, x);
    for (int64_t v0 = 0; v0 < seg.nvec && pos < capacity; v0 += kStepVecs) {
      Vec16<T> next[kExtractUnroll];  // in flight while this step is ranked and written
      load_step<T>(vin, v0 + kStepVecs, seg.nvec, lane, next);
      int total = 0;  // the step's entries so far
#pragma unroll
      for (int u = 0; u < kExtractUnroll; ++u) {
        int before = 0, here = 0;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const unsigned mask = __ballot_sync(kFull, x[u].e[e] != T(0));
          before += __popc(mask & below);
          here += __popc(mask);
        }
        int slot = total + before;
        const int64_t col = seg.c0 + seg.head + (v0 + u * kWarp + lane) * V;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (x[u].e[e] != T(0)) {
            s_col[warp][staged(slot)] = (int32_t)(col + e);
            s_val[warp][staged(slot)] = x[u].e[e];
            ++slot;
          }
        }
        total += here;
      }
      __syncwarp();
      const int keep = (int)lmin(total, capacity - pos);
      for (int k = lane; k < keep; k += kWarp) {
        indices[pos + k] = s_col[warp][staged(k)];
        values[pos + k] = s_val[warp][staged(k)];
      }
      __syncwarp();  // the buffer is read before the next step fills it
      pos += total;
#pragma unroll
      for (int u = 0; u < kExtractUnroll; ++u) x[u] = next[u];
    }
    fill_scalars(in, seg.tail, n - seg.tail, lane, below, capacity, pos, indices, values);
  }
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = indptr[m] + (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < capacity;
       p += stride) {
    indices[p] = 0;
    values[p] = T(0);
  }
}

inline unsigned row_blocks(int64_t m) { return (unsigned)((m + kWarpsPerBlock - 1) / kWarpsPerBlock); }

template <typename T>
int csr_to_dense(const void* indptr, const void* indices, const void* values, void* dense,
                 int64_t m, int64_t n, int64_t tile_elems, int64_t per_cta, int64_t ctas,
                 void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  const int64_t tile_bytes = tile_elems * (int64_t)sizeof(T);
  if (tile_bytes <= 0 || tile_bytes % 16 != 0 || tile_bytes > kDensifyMaxTile) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t n_tiles = (m * n + tile_elems - 1) / tile_elems;
  if (per_cta <= 0 || ctas <= 0 || ctas > INT32_MAX || ctas * per_cta < n_tiles ||
      (ctas - 1) * per_cta >= n_tiles || (uintptr_t)dense % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = (int)(2 * tile_bytes);
  const cudaError_t err =
      raise_smem_limit_once(csr_to_dense_kernel<T>, (int)(2 * kDensifyMaxTile));
  if (err != cudaSuccess) return (int)err;
  csr_to_dense_kernel<T><<<(unsigned)ctas, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)indptr, (const int32_t*)indices, (const T*)values, (T*)dense, m, n,
      tile_elems, per_cta);
  return (int)cudaGetLastError();
}

// Count and scan: indptr of the packed CSR, clamped at capacity.
template <typename T, bool kTriu>
int dense_count(const T* dense, int64_t m, int64_t n, int64_t capacity, int32_t* indptr,
                cudaStream_t stream) {
  if (m < 0 || n < 0 || capacity < 0 || capacity > INT32_MAX) return (int)cudaErrorInvalidValue;
  if (m > 0) {
    count_rows<T, kTriu><<<row_blocks(m), kThreads, 0, stream>>>(dense, m, n, indptr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  scan_counts<<<1, kScanThreads, 0, stream>>>(indptr, m, capacity);
  return (int)cudaGetLastError();
}

// Fill, after dense_count on the same indptr.
template <typename T, bool kTriu>
int dense_fill(const T* dense, int64_t m, int64_t n, int64_t capacity, const int32_t* indptr,
               int32_t* indices, T* values, cudaStream_t stream) {
  if (m < 0 || n < 0 || capacity < 0 || capacity > INT32_MAX) return (int)cudaErrorInvalidValue;
  // Enough blocks for one warp per row, and for the padding fill when the
  // rows are few and the capacity large.
  int64_t pad_blocks = (capacity + kThreads - 1) / kThreads;
  if (pad_blocks > 4096) pad_blocks = 4096;
  int64_t blocks = row_blocks(m);
  if (blocks < pad_blocks) blocks = pad_blocks;
  if (blocks > 0) {
    fill_rows<T, kTriu><<<(unsigned)blocks, kThreads, 0, stream>>>(dense, m, n, indptr, capacity,
                                                                   indices, values);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* smm_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// dense: (m, n), 16-byte aligned; tiles of tile_elems elements (a multiple
// of 16 bytes, at most 96 KB) covering m * n, per_cta consecutive ones for
// each of ctas persistent CTAs (the last CTA may have fewer, none has none).
int smm_csr_to_dense_f32(const void* indptr, const void* indices, const void* values, void* dense,
                         int64_t m, int64_t n, int64_t tile_elems, int64_t per_cta, int64_t ctas,
                         void* stream) {
  return csr_to_dense<float>(indptr, indices, values, dense, m, n, tile_elems, per_cta, ctas,
                             stream);
}

int smm_csr_to_dense_f64(const void* indptr, const void* indices, const void* values, void* dense,
                         int64_t m, int64_t n, int64_t tile_elems, int64_t per_cta, int64_t ctas,
                         void* stream) {
  return csr_to_dense<double>(indptr, indices, values, dense, m, n, tile_elems, per_cta, ctas,
                              stream);
}

// dense: (m, n) row-major; indptr (m + 1), indices and values (capacity):
// the packed CSR of its nonzeros, or of its upper triangle with triu.  A
// conversion is smm_dense_count_* (count and scan into indptr), then
// smm_dense_fill_* on the same indptr: the caller allocates the entries
// while the count runs.
int smm_dense_count_f32(const void* dense, int64_t m, int64_t n, int triu, int64_t capacity,
                        void* indptr, void* stream) {
  const float* d = (const float*)dense;
  const cudaStream_t s = (cudaStream_t)stream;
  return triu ? dense_count<float, true>(d, m, n, capacity, (int32_t*)indptr, s)
              : dense_count<float, false>(d, m, n, capacity, (int32_t*)indptr, s);
}

int smm_dense_count_f64(const void* dense, int64_t m, int64_t n, int triu, int64_t capacity,
                        void* indptr, void* stream) {
  const double* d = (const double*)dense;
  const cudaStream_t s = (cudaStream_t)stream;
  return triu ? dense_count<double, true>(d, m, n, capacity, (int32_t*)indptr, s)
              : dense_count<double, false>(d, m, n, capacity, (int32_t*)indptr, s);
}

int smm_dense_fill_f32(const void* dense, int64_t m, int64_t n, int triu, int64_t capacity,
                       const void* indptr, void* indices, void* values, void* stream) {
  const float* d = (const float*)dense;
  const int32_t* p = (const int32_t*)indptr;
  const cudaStream_t s = (cudaStream_t)stream;
  return triu ? dense_fill<float, true>(d, m, n, capacity, p, (int32_t*)indices, (float*)values, s)
              : dense_fill<float, false>(d, m, n, capacity, p, (int32_t*)indices, (float*)values,
                                         s);
}

int smm_dense_fill_f64(const void* dense, int64_t m, int64_t n, int triu, int64_t capacity,
                       const void* indptr, void* indices, void* values, void* stream) {
  const double* d = (const double*)dense;
  const int32_t* p = (const int32_t*)indptr;
  const cudaStream_t s = (cudaStream_t)stream;
  return triu ? dense_fill<double, true>(d, m, n, capacity, p, (int32_t*)indices,
                                         (double*)values, s)
              : dense_fill<double, false>(d, m, n, capacity, p, (int32_t*)indices,
                                          (double*)values, s);
}

}  // extern "C"
