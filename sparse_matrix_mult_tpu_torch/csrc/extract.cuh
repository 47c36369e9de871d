// What the dense -> packed CSR extractions share: K2/K4 (convert.cu,
// fill_rows) and K7 (convert_fused.cu, fused_extract_kernel) both load the
// matrix in 16-byte vectors and rank a step's nonzeros by ballot into a
// per-warp shared buffer, which consecutive lanes then write to consecutive
// entries of the packed CSR.

#pragma once

#include <cuda_runtime.h>

namespace {

// 16 bytes of the matrix: one vector load of 16 / sizeof(T) elements.
template <typename T>
union Vec16 {
  uint4 raw;
  T e[16 / sizeof(T)];
};

// Where entry `slot` of a warp's staged step lies in its shared buffer: one
// spare word after every 32, so that lanes ranking V entries each (slots V
// apart) store to distinct banks, and 32 consecutive slots read back
// conflict-free.
__device__ __forceinline__ int staged(int slot) { return slot + (slot >> 5); }

// Words of a staged buffer that holds `entries` entries.
__host__ __device__ constexpr int staged_words(int entries) { return entries + entries / 32; }

}  // namespace
