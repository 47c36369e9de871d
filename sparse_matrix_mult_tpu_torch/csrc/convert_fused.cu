// Single-pass dense <-> packed CSR conversions for Hopper (sm_90a).
//
// Replaces these Pallas TPU kernels of sparse_matrix_mult_tpu/ops/pallas/convert_kernels.py:
//   K7  _fused_extract_kernel  (dense -> packed CSR)  -> fused_extract_kernel<T>
//   K8  _fused_densify_kernel  (packed CSR -> dense)  -> fused_densify_kernel<T>
//
// The TPU kernels cut the row-major flat view of the (m, n) matrix into
// flat-rows of `lane` elements, their grid unit (a flat-row may hold part of
// one row or several rows).  Neither output depends on `lane`.  Flat
// positions are 64-bit.
//
// Bound: device-memory bandwidth.  K7 reads the matrix once and writes each
// entry once; K8 reads each entry once and writes the matrix once.
//
// K7.  The TPU kernel gets each flat-row's output offset from an XLA count
// and cumsum before the kernel, then compacts the flat-row with a shift
// network into the two aligned output blocks its run straddles.  Here count,
// scan and fill are one launch that reads the matrix once:
//   * The unit of work is a tile of the matrix's 16-byte-aligned span (from
//     the 16-byte chunk of its first element to that of its last), a
//     multiple of 4 KB (convert_kernels._extract_tiling).  Tiles and
//     flat-rows nest: lane and tile are powers of two, so a long flat-row is
//     several tiles and a short one shares a tile with its neighbours (when
//     the matrix starts off a 16-byte boundary the tiles are shifted by
//     those few elements).  The elements of the span's first and last chunk
//     that lie outside the matrix are read (no allocation ends inside a
//     16-byte chunk) and masked.
//   * Persistent CTAs, three per SM, each of four roles: a producer warp, a
//     count warp, a scan warp and kExtractWarps fill warps, linked per
//     stage of a ring in shared memory by mbarriers (loaded, counted,
//     offset known, filled), with no barrier of the whole CTA per tile.
//     The producer claims tiles from an atomic ticket and loads each into a
//     free stage by one 1-D bulk copy (cp.async.bulk ...
//     mbarrier::complete_tx).  The count warp counts each tile as it lands
//     (16-byte reads from shared memory, a count per fill warp's slice, and
//     the row and column where each slice starts) and publishes the tile's
//     aggregate at once.  The scan warp looks back for
//     the tile's offset and publishes its inclusive prefix.  Fill warp w
//     writes the contiguous w-th slice once the offset is known, and the
//     stage is loaded again once every slice is written.
//     Why (measured on an H100, PERF.md): the fill is bound by its own
//     instructions, so an SM wants the warps of several CTAs; and a
//     look-back on a fill warp, or counts made by the fill warps, tied each
//     tile's aggregate to the pace of its CTA's fill, and so every CTA's
//     look-back to the slowest fill.
//   * The look-back (decoupled, Merrill & Garland, "Single-pass Parallel
//     Prefix Scan with Decoupled Look-back", 2016) is one warp's: it reads 32
//     predecessors' status words per probe, finds the nearest inclusive
//     prefix by ballot and sums the aggregates after it by warp reduction.
//     Flag and value share one 64-bit word, so no reader sees one without
//     the other.
//   * The fill: a warp's offset is the tile's plus the counts of the warps
//     before it.  Each 16-byte step of the warp's slice is ranked by ballot
//     (lanes below, then the lane's own elements) into a per-warp staged
//     buffer (extract.cuh) and written from there by consecutive lanes to
//     consecutive entries.  Entries at or past `capacity` are dropped;
//     indptr[r], clamped at capacity, is written for each row r whose first
//     element lies in the tile, indptr[m] by the last tile's CTA.
//   * Once a CTA's ticket is past the last tile, its warps wait for the
//     last tile's inclusive prefix (nnz) and zero their share of
//     [min(nnz, capacity), capacity) while other CTAs still fill.
//   * The status words and the ticket are zeroed by a memset on the same
//     stream inside the one C call.
// Why the chain cannot stall: a ticket is taken only by a running CTA, in
// claim order, and its load starts at once; each role takes a CTA's tiles
// in that order.  Take the smallest tile t whose inclusive prefix is
// unpublished.  Its CTA's count warp waits on nothing but loads, so it
// counts t and publishes the aggregate; every tile before t has its
// prefix, so the CTA's scan warp is done with its earlier tiles and its
// look-back for t finds t - 1's prefix in one probe.  So t's prefix is
// published, and by induction every tile's.  A look-back waits on other
// CTAs' counts, which wait only on loads, never on fills.
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

#include "extract.cuh"
#include "mbarrier.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kMaxTileBytes = 128 * 1024;  // K8's shared tile

__host__ __device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

// ------------------------------------------------------------------- K7 ----

constexpr int kExtractWarps = 8;               // warps that fill a tile, a slice each
constexpr int kScanWarp = kExtractWarps;       // the warp that looks back
constexpr int kCountWarp = kScanWarp + 1;      // the warp that counts
constexpr int kProducerWarp = kCountWarp + 1;  // the warp that claims and loads
constexpr int kConsumerThreads = kProducerWarp * kWarp;  // all but the producer
constexpr int kExtractThreads = kConsumerThreads + kWarp;
constexpr int64_t kTileQuantum = 16 * kWarp * kExtractWarps;  // 4 KB: a vector per fill lane
constexpr int kMaxStages = 8;
constexpr int64_t kMaxRingBytes = 200 * 1024;  // the ring's most; the staged buffers are static
constexpr uint32_t kMaxPolls = 1u << 26;  // a spin this long (seconds) is a fault: trap

constexpr unsigned long long kFlagAggregate = 1ull << 62;  // the tile's own count
constexpr unsigned long long kFlagPrefix = 2ull << 62;     // count of every entry up to its end
constexpr unsigned long long kValueMask = (1ull << 62) - 1;

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}

__device__ __forceinline__ void publish(unsigned long long* p, unsigned long long w) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}

// One thread: `bytes` (a multiple of 16) from global `src` (16-byte aligned)
// into shared `dst`, completing `bytes` of the mbarrier's transaction count.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Stores v at shared address `addr` where p holds.  Written out so that the
// compiler predicates the store instead of branching around it and
// rebuilding the address (it did both under the register limit).
__device__ __forceinline__ void st_shared_if(bool p, uint32_t addr, uint32_t v) {
  asm volatile("{\n.reg .pred q;\nsetp.ne.b32 q, %0, 0;\n@q st.shared.b32 [%1], %2;\n}"
               ::"r"((int)p), "r"(addr), "r"(v)
               : "memory");
}
__device__ __forceinline__ void st_shared_if(bool p, uint32_t addr, float v) {
  st_shared_if(p, addr, __float_as_uint(v));
}
__device__ __forceinline__ void st_shared_if(bool p, uint32_t addr, double v) {
  asm volatile("{\n.reg .pred q;\nsetp.ne.b32 q, %0, 0;\n@q st.shared.b64 [%1], %2;\n}"
               ::"r"((int)p), "r"(addr), "l"(__double_as_longlong(v))
               : "memory");
}

// All warps but the producer (named barrier 1).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumerThreads) : "memory");
}

template <typename T>
struct ExtractArgs {
  const unsigned char* span;  // 16-byte aligned; the matrix's element 0 is `lead` elements in
  int64_t lead, m, n, total, span_bytes, tile_bytes, n_tiles, capacity;
  double inv_n;  // 1 / n, for the row of a flat position
  int stages;
  unsigned long long* status;  // n_tiles status words, then the ticket counter; zeroed
  int32_t* indptr;
  int32_t* indices;
  T* values;
};

// Exclusive prefix of tile t > 0, by one warp: 32 predecessors' status words
// per probe, the newest in lane 0.  The nearest inclusive prefix (by ballot)
// ends the walk; the aggregates after it are summed by warp reduction.  A
// probe that meets an unpublished word among those it needs is retried.
__device__ int64_t look_back(const unsigned long long* status, int64_t t, int lane) {
  int64_t prefix = 0;
  uint32_t polls = 0;
  for (int64_t hi = t - 1;;) {
    const int64_t j = hi - lane;
    // Before tile 0 lies an inclusive prefix of 0.
    const unsigned long long w = j >= 0 ? load_status(status + j) : kFlagPrefix;
    const unsigned done = __ballot_sync(kFull, (w & kFlagPrefix) != 0);
    const unsigned need = done ? (done & (0u - done)) * 2u - 1u : kFull;  // lanes to sum
    if (__ballot_sync(kFull, w == 0) & need) {
      if (++polls == kMaxPolls) __trap();
      __nanosleep(32);
      continue;
    }
    int64_t v = (need >> lane) & 1u ? (int64_t)(w & kValueMask) : 0;
#pragma unroll
    for (int d = kWarp / 2; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
    prefix += v;
    if (done) return prefix;
    hi -= kWarp;
  }
}

// Element f of the flat view is an entry.  kEdge: the tile reaches past the
// matrix (the span's first or last tile), so f is checked; inside, only the
// value is.
template <typename T, bool kEdge>
__device__ __forceinline__ bool is_entry(T x, int64_t f, int64_t total) {
  return (!kEdge || (f >= 0 && f < total)) && x != T(0);
}

// This warp's nonzeros in its slice of the stage holding tile t.
template <typename T, bool kEdge>
__device__ __forceinline__ int count_slice(const ExtractArgs<T>& a, const uint4* stage, int64_t t,
                                           int warp, int lane) {
  constexpr int V = 16 / sizeof(T);
  const int64_t per_warp = a.tile_bytes / 16 / kExtractWarps;  // vectors, a multiple of 32
  const int64_t flat0 = t * (a.tile_bytes / (int64_t)sizeof(T)) - a.lead;
  int c = 0;
#pragma unroll 4
  for (int64_t v = warp * per_warp + lane; v < (warp + 1) * per_warp; v += kWarp) {
    Vec16<T> x;
    x.raw = stage[v];
#pragma unroll
    for (int e = 0; e < V; ++e) c += is_entry<T, kEdge>(x.e[e], flat0 + v * V + e, a.total);
  }
  return __reduce_add_sync(kFull, c);
}

// Row and column of flat element f >= 0.  The quotient by the double
// reciprocal is exact or off by one below 2^52.
template <typename T>
__device__ __forceinline__ void row_col(const ExtractArgs<T>& a, int64_t f, int64_t& row,
                                        int64_t& col) {
  row = (int64_t)((double)f * a.inv_n);
  col = f - row * a.n;
  while (col < 0) col += a.n, --row;
  while (col >= a.n) col -= a.n, ++row;
}

// Moves (row, col) on to a column past the row's end.
__device__ __forceinline__ void wrap(int64_t n, int64_t& row, int64_t& col) {
  if (col >= n) {
    if (col < 2 * n) {
      col -= n, ++row;
    } else {
      const int64_t q = col / n;
      col -= q * n, row += q;
    }
  }
}

// Writes this warp's slice of tile t, whose first element lies in row `row`
// at column `col` (before the matrix's element 0, the first slice of the
// first tile only: row 0, col < 0, counting up to 0) and whose first entry
// goes to `pos`: 16-byte steps ranked by ballot into the warp's staged
// buffer, written out by consecutive lanes; indptr of every row that starts
// in the slice.  Each lane carries its vector's row and column from step to
// step (32 V elements on).
template <typename T, bool kEdge>
__device__ __forceinline__ void fill_slice(const ExtractArgs<T>& a, const uint4* stage, int64_t t,
                                           int warp, int lane, int64_t pos, int64_t row,
                                           int64_t col, int32_t* s_col, T* s_val) {
  constexpr int V = 16 / sizeof(T);
  constexpr int64_t kStepElems = kWarp * V;
  const unsigned below = (1u << lane) - 1u;  // lanes ranked before this one
  const int64_t per_warp = a.tile_bytes / 16 / kExtractWarps;
  const int64_t v_first = warp * per_warp + lane;
  int64_t f = t * (a.tile_bytes / (int64_t)sizeof(T)) - a.lead + v_first * V;
  col += lane * V;
  wrap(a.n, row, col);
  const uint32_t col_base = smem_u32(s_col), val_base = smem_u32(s_val);
  for (int64_t v = v_first; v < (warp + 1) * per_warp; v += kWarp) {
    Vec16<T> x;
    x.raw = stage[v];
    bool live[V];
    int before = 0, here = 0;  // the step's entries in lanes below this one, in all lanes
#pragma unroll
    for (int e = 0; e < V; ++e) {
      live[e] = is_entry<T, kEdge>(x.e[e], f + e, a.total);
      const unsigned mask = __ballot_sync(kFull, live[e]);
      before += __popc(mask & below);
      here += __popc(mask);
    }
    int slot = before;
    if (col >= 0 && col + V <= a.n) {  // the vector lies in one row: a row start is element 0
      if (col == 0 && (!kEdge || f < a.total)) {
        a.indptr[row] = (int32_t)lmin(pos + slot, a.capacity);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const uint32_t at = (uint32_t)staged(slot);
        st_shared_if(live[e], col_base + 4 * at, (uint32_t)(col + e));
        st_shared_if(live[e], val_base + (uint32_t)sizeof(T) * at, x.e[e]);
        slot += live[e];
      }
      col += V;
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (col == 0 && (!kEdge || (f + e >= 0 && f + e < a.total))) {
          a.indptr[row] = (int32_t)lmin(pos + slot, a.capacity);
        }
        const uint32_t at = (uint32_t)staged(slot);
        st_shared_if(live[e], col_base + 4 * at, (uint32_t)col);
        st_shared_if(live[e], val_base + (uint32_t)sizeof(T) * at, x.e[e]);
        slot += live[e];
        if (++col == a.n) col = 0, ++row;
      }
    }
    // On to this lane's next vector.
    f += kStepElems;
    col += kStepElems - V;
    wrap(a.n, row, col);
    __syncwarp();
    const int64_t room = a.capacity - pos;
    const int keep = room <= 0 ? 0 : (int)lmin(here, room);
    int32_t* const out_col = a.indices + pos;
    T* const out_val = a.values + pos;
#pragma unroll
    for (int j = 0; j < V; ++j) {  // a step holds at most 32 V entries
      const int k = j * kWarp + lane;
      if (k < keep) {
        out_col[k] = s_col[staged(k)];
        out_val[k] = s_val[staged(k)];
      }
    }
    __syncwarp();  // the buffer is read before the next step fills it
    pos += here;
  }
}

// Tile t reaches past the matrix: it is the span's first (when the matrix
// starts off a 16-byte boundary) or its last.
template <typename T>
__device__ __forceinline__ bool edge(const ExtractArgs<T>& a, int64_t t) {
  const int64_t elems = a.tile_bytes / (int64_t)sizeof(T);
  return t * elems < a.lead || (t + 1) * elems - a.lead > a.total;
}

// Zeroes p[lo, hi): thread `worker` of `workers`, 16-byte stores between a
// scalar head and tail.
template <typename U>
__device__ void zero_range(U* p, int64_t lo, int64_t hi, int64_t worker, int64_t workers) {
  constexpr int64_t W = 16 / sizeof(U);
  const int64_t mis = (int64_t)((reinterpret_cast<uintptr_t>(p + lo) / sizeof(U)) % W);
  const int64_t a = lmin(lo + (W - mis) % W, hi);
  const int64_t b = a + (hi - a) / W * W;
  for (int64_t i = lo + worker; i < a; i += workers) p[i] = U(0);
  for (int64_t i = b + worker; i < hi; i += workers) p[i] = U(0);
  uint4* vec = reinterpret_cast<uint4*>(p + a);
  for (int64_t i = worker; i < (b - a) / W; i += workers) vec[i] = make_uint4(0, 0, 0, 0);
}

// Dynamic shared memory: the ring, a.stages stages of a.tile_bytes.
template <typename T>
__global__ void __launch_bounds__(kExtractThreads, 3) fused_extract_kernel(const ExtractArgs<T> a) {
  constexpr int kSlots = staged_words(kWarp * 16 / (int)sizeof(T));  // one staged step
  extern __shared__ __align__(128) unsigned char ring[];
  // Per stage: loaded (full), counted, offset known (ready), filled (empty).
  __shared__ __align__(8) uint64_t s_full[kMaxStages], s_counted[kMaxStages];
  __shared__ __align__(8) uint64_t s_ready[kMaxStages], s_empty[kMaxStages];
  __shared__ int64_t s_tile[kMaxStages];                   // the stage's tile (>= n_tiles: none)
  __shared__ int32_t s_count[kMaxStages][kExtractWarps];  // the nonzeros of each slice
  __shared__ int64_t s_offset[kMaxStages];                 // the tile's first entry
  __shared__ int64_t s_row[kMaxStages][kExtractWarps];    // row and column of each slice's
  __shared__ int64_t s_col0[kMaxStages][kExtractWarps];   // first element
  __shared__ int64_t s_nnz;
  __shared__ int32_t s_col[kExtractWarps][kSlots];
  __shared__ T s_val[kExtractWarps][kSlots];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int S = a.stages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_u32(&s_full[s]), 1);
      mbar_init(smem_u32(&s_counted[s]), 1);
      mbar_init(smem_u32(&s_ready[s]), 1);
      mbar_init(smem_u32(&s_empty[s]), kExtractWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kProducerWarp) {  // claim, then load, tile after tile
    if (lane != 0) return;
    for (int64_t i = 0;; ++i) {
      const int s = (int)(i % S);
      if (i >= S) mbar_wait(smem_u32(&s_empty[s]), (uint32_t)((i / S - 1) & 1));
      const int64_t t = (int64_t)atomicAdd(a.status + a.n_tiles, 1ull);
      s_tile[s] = t;  // released to the other warps by the arrive below
      const uint32_t full = smem_u32(&s_full[s]);
      if (t >= a.n_tiles) {
        mbar_arrive(full);
        return;
      }
      const int64_t start = t * a.tile_bytes;
      const uint32_t bytes = (uint32_t)lmin(a.tile_bytes, a.span_bytes - start);
      mbar_expect_tx(full, bytes);
      bulk_load(smem_u32(ring + s * a.tile_bytes), a.span + start, bytes, full);
    }
  }

  // Ring step i sits in stage i % S; each barrier's phase for it has parity
  // (i / S) & 1.  No barrier can run a phase ahead: a stage is loaded again
  // only once every fill warp has released it.
  for (int64_t i = 0;; ++i) {
    const int s = (int)(i % S);
    const uint32_t parity = (uint32_t)((i / S) & 1);
    mbar_wait(smem_u32(&s_full[s]), parity);
    const int64_t t = s_tile[s];
    if (t >= a.n_tiles) break;
    const uint4* stage = reinterpret_cast<const uint4*>(ring + s * a.tile_bytes);
    if (warp == kCountWarp) {  // each slice's nonzeros and start; the aggregate, at once
      int64_t aggregate = 0;
      for (int w = 0; w < kExtractWarps; ++w) {
        const int c = edge(a, t) ? count_slice<T, true>(a, stage, t, w, lane)
                                 : count_slice<T, false>(a, stage, t, w, lane);
        if (lane == 0) s_count[s][w] = c;
        aggregate += c;
      }
      if (lane < kExtractWarps) {  // where each slice starts, for the fill warps
        const int64_t f = t * (a.tile_bytes / (int64_t)sizeof(T)) - a.lead +
                          lane * (a.tile_bytes / kExtractWarps / (int64_t)sizeof(T));
        int64_t row = 0, col = f;
        if (f >= 0) row_col(a, f, row, col);
        s_row[s][lane] = row;
        s_col0[s][lane] = col;
      }
      __syncwarp();
      if (lane == 0) {
        publish(a.status + t, (t == 0 ? kFlagPrefix : kFlagAggregate) | aggregate);
        mbar_arrive(smem_u32(&s_counted[s]));
      }
    } else if (warp == kScanWarp) {  // the offset, then the inclusive prefix
      const int64_t offset = t == 0 ? 0 : look_back(a.status, t, lane);
      mbar_wait(smem_u32(&s_counted[s]), parity);
      const int64_t aggregate =
          __reduce_add_sync(kFull, lane < kExtractWarps ? s_count[s][lane] : 0);
      if (lane == 0) {
        if (t > 0) publish(a.status + t, kFlagPrefix | (unsigned long long)(offset + aggregate));
        if (t == a.n_tiles - 1) a.indptr[a.m] = (int32_t)lmin(offset + aggregate, a.capacity);
        s_offset[s] = offset;
        mbar_arrive(smem_u32(&s_ready[s]));
      }
    } else {  // fill warp: its slice, from the tile's offset and the slices before it
      mbar_wait(smem_u32(&s_ready[s]), parity);
      const int32_t c = lane < warp ? s_count[s][lane] : 0;
      const int64_t pos = s_offset[s] + __reduce_add_sync(kFull, c);
      const int64_t row = s_row[s][warp], col = s_col0[s][warp];
      if (edge(a, t)) {
        fill_slice<T, true>(a, stage, t, warp, lane, pos, row, col, s_col[warp], s_val[warp]);
      } else {
        fill_slice<T, false>(a, stage, t, warp, lane, pos, row, col, s_col[warp], s_val[warp]);
      }
      if (lane == 0) mbar_arrive(smem_u32(&s_empty[s]));
    }
  }

  // No tile left: zero this CTA's share of the padding once nnz is known.
  if (threadIdx.x == 0) {
    unsigned long long w;
    for (uint32_t polls = 0; !((w = load_status(a.status + a.n_tiles - 1)) & kFlagPrefix); ++polls) {
      if (polls == kMaxPolls) __trap();
      __nanosleep(128);
    }
    s_nnz = (int64_t)(w & kValueMask);
  }
  consumer_sync();
  const int64_t lo = lmin(s_nnz, a.capacity);
  const int64_t worker = (int64_t)blockIdx.x * kConsumerThreads + threadIdx.x;
  const int64_t workers = (int64_t)gridDim.x * kConsumerThreads;
  zero_range(a.indices, lo, a.capacity, worker, workers);
  zero_range(a.values, lo, a.capacity, worker, workers);
}

// ------------------------------------------------------------------- K8 ----

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

// K7 over the tiles convert_kernels._extract_tiling gives: `span` is the
// matrix's address rounded down to 16 bytes, `lead` the elements before the
// matrix there; status holds n_tiles + 1 words.
template <typename T>
int dense_to_csr_fused(const void* span, int64_t lead, int64_t m, int64_t n, int64_t capacity,
                       int64_t tile_bytes, int64_t stages, int64_t ctas, void* status,
                       void* indptr, void* indices, void* values, void* stream) {
  constexpr int64_t V = 16 / sizeof(T);
  const int64_t total = m * n;
  if (m <= 0 || n <= 0 || lead < 0 || lead >= V || (uintptr_t)span % 16 != 0 || capacity < 0 ||
      capacity > INT32_MAX || tile_bytes <= 0 || tile_bytes % kTileQuantum != 0 || stages < 2 ||
      stages > kMaxStages || stages * tile_bytes > kMaxRingBytes || ctas <= 0 || ctas > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t span_bytes = ((lead + total) * (int64_t)sizeof(T) + 15) / 16 * 16;
  const int64_t n_tiles = (span_bytes + tile_bytes - 1) / tile_bytes;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(status, 0, (size_t)(n_tiles + 1) * 8, s);
  if (err != cudaSuccess) return (int)err;
  err = raise_smem_limit_once(fused_extract_kernel<T>, (int)kMaxRingBytes);
  if (err != cudaSuccess) return (int)err;
  const ExtractArgs<T> a{(const unsigned char*)span, lead, m, n, total, span_bytes, tile_bytes,
                         n_tiles, capacity, 1.0 / (double)n, (int)stages,
                         (unsigned long long*)status, (int32_t*)indptr, (int32_t*)indices,
                         (T*)values};
  fused_extract_kernel<T><<<(unsigned)ctas, kExtractThreads, (size_t)(stages * tile_bytes), s>>>(a);
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

int smm_dense_to_csr_fused_f32(const void* span, int64_t lead, int64_t m, int64_t n,
                               int64_t capacity, int64_t tile_bytes, int64_t stages, int64_t ctas,
                               void* status, void* indptr, void* indices, void* values,
                               void* stream) {
  return dense_to_csr_fused<float>(span, lead, m, n, capacity, tile_bytes, stages, ctas, status,
                                   indptr, indices, values, stream);
}

int smm_dense_to_csr_fused_f64(const void* span, int64_t lead, int64_t m, int64_t n,
                               int64_t capacity, int64_t tile_bytes, int64_t stages, int64_t ctas,
                               void* status, void* indptr, void* indices, void* values,
                               void* stream) {
  return dense_to_csr_fused<double>(span, lead, m, n, capacity, tile_bytes, stages, ctas, status,
                                    indptr, indices, values, stream);
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
