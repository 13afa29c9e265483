// The dynamic shared-memory ceiling of a kernel, set once.
//
// `cudaFuncAttributeMaxDynamicSharedMemorySize` is the kernel's own, shared
// by every host thread: the learner and the actors launch the same kernel
// at once. So a kernel whose shared memory depends on its template
// parameters alone sets it once per instantiation and device, to that one
// fixed size, and never per call (a call setting its own size can lower
// it under another thread's launch, which is then refused).

#pragma once

#include <cuda_runtime.h>

#include <mutex>

constexpr int kMaxDevices = 64;

// Sets Kernel's ceiling to `bytes` on the current device, the first time
// for each device; returns that first call's result every time.
template <auto Kernel>
cudaError_t set_smem_ceiling_once(int device, int bytes) {
  static std::once_flag done[kMaxDevices];
  static cudaError_t result[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(done[device], [&] {
    result[device] =
        cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  });
  return result[device];
}
