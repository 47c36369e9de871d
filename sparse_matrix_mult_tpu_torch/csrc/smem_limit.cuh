// The one place the kernels raise their dynamic shared-memory limit.
//
// A kernel that takes more than 48 KB of dynamic shared memory needs
// cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
// bytes) before its first launch on a device.  The attribute stays set, so it
// is raised once per kernel and device, to the most the kernel ever takes:
// a launch's host time counts on the main path, and the call costs host time
// on every launch otherwise.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace {

// Raises the limit of the kernel whose entry is `kernel` to `bytes` unless
// this was done for it on the current device already.  Thread-safe: the
// ctypes calls that reach it may come from several host threads.
inline cudaError_t raise_smem_limit_at(const void* kernel, int bytes) {
  struct Done {
    const void* kernel;
    int device;
  };
  constexpr int kSlots = 64;
  static std::mutex lock;
  static Done done[kSlots];
  static int n_done = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < n_done; ++i) {
    if (done[i].kernel == kernel && done[i].device == device) return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && n_done < kSlots) done[n_done++] = Done{kernel, device};
  return err;
}

template <typename Kernel>
inline cudaError_t raise_smem_limit_once(Kernel* kernel, int bytes) {
  return raise_smem_limit_at(reinterpret_cast<const void*>(kernel), bytes);
}

}  // namespace
