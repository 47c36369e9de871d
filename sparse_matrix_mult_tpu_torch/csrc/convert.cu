// CSR <-> dense conversion kernels for Hopper (sm_90a).
//
// Replaces these Pallas TPU kernels of sparse_matrix_mult_tpu/ops/pallas/convert_kernels.py:
//   K3  _distribute_kernel          (CSR -> dense)           -> csr_to_dense_kernel
//   K4  _concentrate_kernel         (dense -> packed CSR)    -> count_rows/fill_rows<T, false>
//   K2  _concentrate_payload_kernel (upper-triangular dense
//        -> packed CSR, staircase)                         -> count_rows/fill_rows<T, true>
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
// K2/K4: pass 1 counts each row's nonzeros with a warp ballot/popc per 32
// columns (columns [row, n) for the triangle); an exclusive scan
// (torch.cumsum, between the passes) gives indptr; pass 2 writes each row's
// (col, value) pairs in column order from indptr[row], ranking lanes inside
// the warp with the same ballot.  Writes are clamped at capacity, and the
// same launch zero-fills [indptr[m], capacity).  One warp per row keeps the
// reads of a row coalesced (32 consecutive elements per step); flat offsets
// are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T, bool kTriu>
__global__ void __launch_bounds__(kThreads)
count_rows(const T* __restrict__ dense, int64_t m, int64_t n, int32_t* __restrict__ counts) {
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= m) return;
  const T* in = dense + row * n;
  int32_t count = 0;
  for (int64_t base = kTriu ? row : 0; base < n; base += kWarp) {
    const int64_t c = base + lane;
    const bool live = c < n && in[c] != T(0);
    count += __popc(__ballot_sync(kFull, live));
  }
  if (lane == 0) counts[row] = count;
}

// indptr holds the exclusive scan of the counts, clamped at capacity.
template <typename T, bool kTriu>
__global__ void __launch_bounds__(kThreads)
fill_rows(const T* __restrict__ dense, int64_t m, int64_t n, const int32_t* __restrict__ indptr,
          int64_t capacity, int32_t* __restrict__ indices, T* __restrict__ values) {
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row < m) {
    const T* in = dense + row * n;
    const unsigned below = (1u << lane) - 1u;  // lanes ranked before this one
    int64_t pos = indptr[row];
    for (int64_t base = kTriu ? row : 0; base < n && pos < capacity; base += kWarp) {
      const int64_t c = base + lane;
      const T v = c < n ? in[c] : T(0);
      const bool live = v != T(0);
      const unsigned mask = __ballot_sync(kFull, live);
      const int64_t dst = pos + __popc(mask & below);
      if (live && dst < capacity) {
        indices[dst] = (int32_t)c;
        values[dst] = v;
      }
      pos += __popc(mask);
    }
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
  // The shared-memory limit is raised once per device, to the largest tile
  // pair, not on every call: the call's host time counts on the main path.
  constexpr int kMaxDevices = 64;
  static int smem_set[kMaxDevices];  // 1 once this device's limit is raised
  const int smem = (int)(2 * tile_bytes);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices || !smem_set[device]) {
    err = cudaFuncSetAttribute(csr_to_dense_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(2 * kDensifyMaxTile));
    if (err != cudaSuccess) return (int)err;
    if (device < kMaxDevices) smem_set[device] = 1;
  }
  csr_to_dense_kernel<T><<<(unsigned)ctas, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)indptr, (const int32_t*)indices, (const T*)values, (T*)dense, m, n,
      tile_elems, per_cta);
  return (int)cudaGetLastError();
}

template <typename T>
int dense_count(const void* dense, int64_t m, int64_t n, int triu, void* counts, void* stream) {
  if (m > 0) {
    if (triu) {
      count_rows<T, true><<<row_blocks(m), kThreads, 0, (cudaStream_t)stream>>>(
          (const T*)dense, m, n, (int32_t*)counts);
    } else {
      count_rows<T, false><<<row_blocks(m), kThreads, 0, (cudaStream_t)stream>>>(
          (const T*)dense, m, n, (int32_t*)counts);
    }
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dense_fill(const void* dense, int64_t m, int64_t n, int triu, const void* indptr,
               int64_t capacity, void* indices, void* values, void* stream) {
  // Enough blocks for one warp per row, and for the padding fill when the
  // rows are few and the capacity large.
  int64_t pad_blocks = (capacity + kThreads - 1) / kThreads;
  if (pad_blocks > 4096) pad_blocks = 4096;
  int64_t blocks = row_blocks(m);
  if (blocks < pad_blocks) blocks = pad_blocks;
  if (blocks > 0) {
    if (triu) {
      fill_rows<T, true><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (const T*)dense, m, n, (const int32_t*)indptr, capacity, (int32_t*)indices, (T*)values);
    } else {
      fill_rows<T, false><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (const T*)dense, m, n, (const int32_t*)indptr, capacity, (int32_t*)indices, (T*)values);
    }
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

int smm_dense_count_f32(const void* dense, int64_t m, int64_t n, int triu, void* counts,
                        void* stream) {
  return dense_count<float>(dense, m, n, triu, counts, stream);
}

int smm_dense_count_f64(const void* dense, int64_t m, int64_t n, int triu, void* counts,
                        void* stream) {
  return dense_count<double>(dense, m, n, triu, counts, stream);
}

int smm_dense_fill_f32(const void* dense, int64_t m, int64_t n, int triu, const void* indptr,
                       int64_t capacity, void* indices, void* values, void* stream) {
  return dense_fill<float>(dense, m, n, triu, indptr, capacity, indices, values, stream);
}

int smm_dense_fill_f64(const void* dense, int64_t m, int64_t n, int triu, const void* indptr,
                       int64_t capacity, void* indices, void* values, void* stream) {
  return dense_fill<double>(dense, m, n, triu, indptr, capacity, indices, values, stream);
}

}  // extern "C"
