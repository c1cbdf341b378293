// Dynamic shared memory above the default 48 KB must be granted to a
// kernel, on each device, before a launch that uses it
// (cudaFuncSetAttribute, cudaFuncAttributeMaxDynamicSharedMemorySize).
// The grant is a CUDA runtime call on the host's launch path, so the C
// entry points grant through grant_shared_bytes: once per kernel and
// device, and again only when a launch needs more than the most granted
// so far (a launch with less than its kernel's grant runs as it is).

#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace speedy {

inline cudaError_t grant_shared_bytes(const void* kernel, size_t bytes) {
  struct Grant {
    const void* kernel;
    int device;
    size_t bytes;
  };
  constexpr int kSlots = 128;  // kernels x devices; past it every launch grants
  static Grant granted[kSlots];
  static int n_granted = 0;
  static std::mutex mu;

  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  Grant* g = nullptr;
  for (int i = 0; i < n_granted && g == nullptr; ++i)
    if (granted[i].kernel == kernel && granted[i].device == device) g = &granted[i];
  if (g != nullptr && g->bytes >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  if (g == nullptr && n_granted < kSlots) {
    g = &granted[n_granted++];
    g->kernel = kernel;
    g->device = device;
  }
  if (g != nullptr) g->bytes = bytes;
  return cudaSuccess;
}

template <typename Kernel>
inline cudaError_t grant_shared_bytes(Kernel* kernel, size_t bytes) {
  return grant_shared_bytes(reinterpret_cast<const void*>(kernel), bytes);
}

}  // namespace speedy
