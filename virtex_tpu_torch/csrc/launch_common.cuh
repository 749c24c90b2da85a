// What every launcher of the kernels does before a launch: the opt-in to
// more than 48 KB of dynamic shared memory.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <map>
#include <mutex>
#include <utility>

namespace virtex {

// Opts `kernel` into `smem` bytes of dynamic shared memory on the current
// device, which a launch above 48 KB needs. The attribute is per device, so
// the opt-in is kept per (kernel, device), and made only when a launch needs
// more than that pair has opted into: a launch inside a CUDA-graph capture,
// which follows an eager launch of the same size, makes no attribute call.
inline cudaError_t opt_in_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static std::mutex lock;
  static std::map<std::pair<const void*, int>, size_t> opted_in;
  std::lock_guard<std::mutex> hold(lock);
  size_t& done = opted_in[{kernel, device}];
  if (smem <= done) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess) done = smem;
  return err;
}

template <typename Kernel>
cudaError_t opt_in_smem(Kernel* kernel, size_t smem) {
  return opt_in_smem(reinterpret_cast<const void*>(kernel), smem);
}

}  // namespace virtex
