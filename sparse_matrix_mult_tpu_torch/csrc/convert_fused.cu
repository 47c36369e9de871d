// Single-pass dense <-> packed CSR conversions for Hopper (sm_90a).
//
// Replaces these Pallas TPU kernels of sparse_matrix_mult_tpu/ops/pallas/convert_kernels.py:
//   K7  _fused_extract_kernel  (dense -> packed CSR)  -> fused_extract_kernel<T>
//   K8  _fused_densify_kernel  (packed CSR -> dense)  -> fused_densify_kernel<T>
//
// Both cut the row-major flat view of the (m, n) matrix into flat-rows of
// `lane` elements, the TPU kernels' grid unit: a flat-row may hold part of one
// row or several rows.  One CTA per flat-row; flat positions are 64-bit.
//
// Bound: device-memory bandwidth.  K7 reads the matrix once and writes each
// entry once; K8 reads each entry once and writes the matrix once.
//
// K7.  The TPU kernel gets each flat-row's output offset from an XLA cumsum
// before the kernel, then compacts the flat-row with a shift network and
// accumulates it into the two aligned output blocks its run straddles.  Here
// count, scan and fill are one launch:
//   * a CTA takes the next flat-row from an atomic ticket, not from blockIdx,
//     so every flat-row it waits on belongs to a CTA that is already running;
//   * it stages the flat-row in shared memory while it counts the nonzeros
//     (warp ballots), publishes the count, and finds its offset by decoupled
//     look-back over its predecessors' status words (Merrill & Garland,
//     "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016).
//     Flag and value share one 64-bit word, so no reader sees one without
//     the other;
//   * it compacts the staged flat-row in order, ranking lanes with ballots and
//     __popc as K2/K4 do, writes (flat % n, value) from its offset (entries at
//     or past `capacity` are dropped) and writes indptr[r], clamped at
//     capacity, for every row r whose first element lies in the flat-row;
//   * CTAs whose ticket lies past the last flat-row wait for its inclusive
//     prefix (nnz) and zero the capacity padding.
// A flat-row larger than the shared tile (kMaxTileBytes) stages its head and
// reads the rest from device memory twice.
//
// K8.  The TPU kernel routes each flat-row's run from two packed blocks through
// a shift network, after an XLA pass that builds the flat destination of every
// entry (cumsum + searchsorted).  Here no such array is built: a CTA finds its
// run by binary search in the first and last row's indices, scatters it into a
// zeroed shared tile, and stores the tile once, coalesced.  Every dense
// element is written exactly once, with no separate zero-fill.  A flat-row
// larger than the tile is done in tile-sized pieces.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kMaxTileBytes = 128 * 1024;  // shared tile of one CTA
constexpr int64_t kPadBlocks = 264;            // CTAs that zero the padding (2 per SM)

constexpr unsigned long long kFlagAggregate = 1ull << 62;  // the flat-row's own count
constexpr unsigned long long kFlagPrefix = 2ull << 62;     // count of every entry up to its end
constexpr unsigned long long kValueMask = (1ull << 62) - 1;

__host__ __device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  return *(const volatile unsigned long long*)p;
}

__device__ __forceinline__ void publish(unsigned long long* p, unsigned long long word) {
  __threadfence();
  *(volatile unsigned long long*)p = word;
}

// Exclusive prefix of flat-row t (t > 0): sums the predecessors' published
// counts, newest first, until one holds an inclusive prefix.  Every
// predecessor holds an earlier ticket, so it is running or done and publishes
// its count without waiting on anything.
__device__ int64_t look_back(const unsigned long long* status, int64_t t) {
  int64_t prefix = 0;
  for (int64_t j = t - 1; j >= 0;) {
    const unsigned long long w = load_status(status + j);
    if (w == 0) {  // not published yet
      __nanosleep(32);
      continue;
    }
    prefix += (int64_t)(w & kValueMask);
    if (w & kFlagPrefix) break;
    --j;
  }
  return prefix;
}

// status: n_tiles + 1 zeroed words; status[n_tiles] is the ticket counter.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_extract_kernel(const T* __restrict__ dense, int64_t m, int64_t n, int64_t lane,
                     int64_t tile_elems, int64_t n_tiles, int64_t capacity,
                     unsigned long long* status, int32_t* __restrict__ indptr,
                     int32_t* __restrict__ indices, T* __restrict__ values) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  __shared__ int64_t s_ticket, s_offset;
  __shared__ int32_t s_warp[2][kWarps];
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane_id = tid % kWarp;

  if (tid == 0) s_ticket = (int64_t)atomicAdd(status + n_tiles, 1ull);
  __syncthreads();
  const int64_t t = s_ticket;

  if (t >= n_tiles) {  // a padding CTA: zero [min(nnz, capacity), capacity)
    if (tid == 0) {
      unsigned long long w;
      while (!((w = load_status(status + n_tiles - 1)) & kFlagPrefix)) __nanosleep(128);
      s_offset = (int64_t)(w & kValueMask);
    }
    __syncthreads();
    const int64_t stride = (int64_t)(gridDim.x - n_tiles) * kThreads;
    for (int64_t p = lmin(s_offset, capacity) + (t - n_tiles) * kThreads + tid; p < capacity;
         p += stride) {
      indices[p] = 0;
      values[p] = T(0);
    }
    return;
  }

  const int64_t base = t * lane;
  const int64_t len = lmin(lane, m * n - base);
  const int64_t staged = lmin(len, tile_elems);

  // Count, staging the head of the flat-row in shared memory.
  int32_t count = 0;  // this warp's nonzeros, the same in every lane
  for (int64_t i0 = 0; i0 < len; i0 += kThreads) {
    const int64_t i = i0 + tid;
    T v = T(0);
    if (i < len) {
      v = dense[base + i];
      if (i < staged) tile[i] = v;
    }
    count += __popc(__ballot_sync(kFull, v != T(0)));
  }
  if (lane_id == 0) s_warp[0][warp] = count;
  __syncthreads();

  // Scan: publish the count, look back for the offset, publish the prefix.
  if (tid == 0) {
    int64_t aggregate = 0;
    for (int w = 0; w < kWarps; ++w) aggregate += s_warp[0][w];
    int64_t offset = 0;
    if (t > 0) {
      publish(status + t, kFlagAggregate | (unsigned long long)aggregate);
      offset = look_back(status, t);
    }
    publish(status + t, kFlagPrefix | (unsigned long long)(offset + aggregate));
    s_offset = offset;
    if (t == n_tiles - 1) indptr[m] = (int32_t)lmin(offset + aggregate, capacity);
  }
  __syncthreads();

  // Fill, in flat order.  col follows this thread's element: + kThreads per chunk.
  const unsigned below = (1u << lane_id) - 1u;
  const int64_t step = kThreads % n;
  int64_t col = (base + tid) % n;
  int64_t running = s_offset;
  int buf = 0;  // s_warp is double-buffered: one __syncthreads per chunk
  for (int64_t i0 = 0; i0 < len; i0 += kThreads) {
    const int64_t i = i0 + tid;
    T v = T(0);
    if (i < len) v = i < staged ? tile[i] : dense[base + i];
    const bool live = v != T(0);
    const unsigned mask = __ballot_sync(kFull, live);
    if (lane_id == 0) s_warp[buf][warp] = __popc(mask);
    __syncthreads();
    int32_t before = 0, chunk = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int32_t c = s_warp[buf][w];
      before += w < warp ? c : 0;
      chunk += c;
    }
    const int64_t rank = running + before + __popc(mask & below);  // nonzeros before flat i
    if (live && rank < capacity) {
      indices[rank] = (int32_t)col;
      values[rank] = v;
    }
    if (i < len && col == 0) indptr[(base + i) / n] = (int32_t)lmin(rank, capacity);
    running += chunk;
    col += step;
    if (col >= n) col -= n;
    buf ^= 1;
  }
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_densify_kernel(const int32_t* __restrict__ indptr, const int32_t* __restrict__ indices,
                     const T* __restrict__ values, T* __restrict__ dense, int64_t m, int64_t n,
                     int64_t lane, int64_t tile_elems) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  __shared__ int64_t s_run[2];
  const int tid = threadIdx.x;
  const int64_t row_start = (int64_t)blockIdx.x * lane;
  const int64_t row_end = lmin(row_start + lane, m * n);
  for (int64_t f0 = row_start; f0 < row_end; f0 += tile_elems) {
    const int64_t len = lmin(tile_elems, row_end - f0);
    const int64_t r0 = f0 / n;              // row of the first element
    const int64_t r1 = (f0 + len - 1) / n;  // row of the last
    // The run: entries of row r0 from column f0 % n on, through those of row
    // r1 before column (f0 + len - 1) % n + 1.  Two warps search its ends.
    if (tid == 0) s_run[0] = lower_bound(indices, indptr[r0], indptr[r0 + 1], f0 - r0 * n);
    if (tid == kWarp) s_run[1] = lower_bound(indices, indptr[r1], indptr[r1 + 1], f0 + len - r1 * n);
    for (int64_t i = tid; i < len; i += kThreads) tile[i] = T(0);
    __syncthreads();
    const int64_t stop = s_run[1];
    for (int64_t p = s_run[0] + tid; p < stop; p += kThreads) {
      int64_t lo = r0, hi = r1;  // the entry's row: the last one starting at or before p
      while (lo < hi) {
        const int64_t mid = (lo + hi + 1) >> 1;
        if (indptr[mid] <= p) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      const int64_t local = lo * n + indices[p] - f0;
      if (local >= 0 && local < len) tile[local] = values[p];  // always, for valid CSR
    }
    __syncthreads();
    for (int64_t i = tid; i < len; i += kThreads) dense[f0 + i] = tile[i];
    __syncthreads();  // the tile is read before the next piece zeroes it
  }
}

template <typename T>
int64_t tile_elems_for(int64_t lane) {
  return lmin(lane, kMaxTileBytes / (int64_t)sizeof(T));
}

template <typename T>
int dense_to_csr_fused(const void* dense, int64_t m, int64_t n, int64_t lane, int64_t capacity,
                       void* status, void* indptr, void* indices, void* values, void* stream) {
  const int64_t total = m * n;
  if (total <= 0 || lane <= 0) return (int)cudaErrorInvalidValue;
  const int64_t n_tiles = (total + lane - 1) / lane;
  const int64_t pad = lmin((capacity + kThreads - 1) / kThreads, kPadBlocks);
  if (n_tiles + pad > INT_MAX) return (int)cudaErrorInvalidValue;
  const int64_t tile_elems = tile_elems_for<T>(lane);
  const int smem = (int)(tile_elems * (int64_t)sizeof(T));
  const cudaError_t err = raise_smem_limit_once(fused_extract_kernel<T>, (int)kMaxTileBytes);
  if (err != cudaSuccess) return (int)err;
  fused_extract_kernel<T><<<(unsigned)(n_tiles + pad), kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)dense, m, n, lane, tile_elems, n_tiles, capacity, (unsigned long long*)status,
      (int32_t*)indptr, (int32_t*)indices, (T*)values);
  return (int)cudaGetLastError();
}

template <typename T>
int csr_to_dense_fused(const void* indptr, const void* indices, const void* values, void* dense,
                       int64_t m, int64_t n, int64_t lane, void* stream) {
  const int64_t total = m * n;
  if (total <= 0 || lane <= 0) return (int)cudaErrorInvalidValue;
  const int64_t n_tiles = (total + lane - 1) / lane;
  if (n_tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  const int64_t tile_elems = tile_elems_for<T>(lane);
  const int smem = (int)(tile_elems * (int64_t)sizeof(T));
  const cudaError_t err = raise_smem_limit_once(fused_densify_kernel<T>, (int)kMaxTileBytes);
  if (err != cudaSuccess) return (int)err;
  fused_densify_kernel<T><<<(unsigned)n_tiles, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)indptr, (const int32_t*)indices, (const T*)values, (T*)dense, m, n, lane,
      tile_elems);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int smm_dense_to_csr_fused_f32(const void* dense, int64_t m, int64_t n, int64_t lane,
                               int64_t capacity, void* status, void* indptr, void* indices,
                               void* values, void* stream) {
  return dense_to_csr_fused<float>(dense, m, n, lane, capacity, status, indptr, indices, values,
                                   stream);
}

int smm_dense_to_csr_fused_f64(const void* dense, int64_t m, int64_t n, int64_t lane,
                               int64_t capacity, void* status, void* indptr, void* indices,
                               void* values, void* stream) {
  return dense_to_csr_fused<double>(dense, m, n, lane, capacity, status, indptr, indices, values,
                                    stream);
}

int smm_csr_to_dense_fused_f32(const void* indptr, const void* indices, const void* values,
                               void* dense, int64_t m, int64_t n, int64_t lane, void* stream) {
  return csr_to_dense_fused<float>(indptr, indices, values, dense, m, n, lane, stream);
}

int smm_csr_to_dense_fused_f64(const void* indptr, const void* indices, const void* values,
                               void* dense, int64_t m, int64_t n, int64_t lane, void* stream) {
  return csr_to_dense_fused<double>(indptr, indices, values, dense, m, n, lane, stream);
}

}  // extern "C"
