// Host helper shared by the flash-attention launchers (flash_fwd.cu,
// flash_bwd.cu): raise a kernel's dynamic shared-memory limit once per
// (kernel, device).
//
// cudaFuncSetAttribute acts on the current device only, so the record is
// kept per device. It is set on the first launch on a device, which runs
// eagerly: a CUDA-graph capture of a later launch then records the launch
// alone. A mutex keeps two threads' first launches from racing.

#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <set>
#include <utility>

namespace dl4j_smem {

inline cudaError_t set_max_dynamic_smem(const void* kernel, int bytes) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> done;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({kernel, device})) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.insert({kernel, device});
  return err;
}

}  // namespace dl4j_smem
