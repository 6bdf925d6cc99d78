// Dynamic shared memory above the 48 KB default, opted in once for each
// device and kernel instantiation.
//
// A launch that asks for more than 48 KB of dynamic shared memory fails
// unless cudaFuncSetAttribute(kernel,
// cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) was called for that
// kernel on the launching device: the runtime keeps function attributes
// per device. A launcher keeps one SmemOptIn for each instantiation it
// launches with more and calls it before each launch; it sets the
// attribute the first time the current device (cudaGetDevice, which the
// wrappers switch to the tensors' device) launches the kernel, and never
// again on that device, so a CUDA-graph capture on a device that has
// opted in sees launches only. The opt-in itself stays out of any
// capture: on a capturing stream a device that has not opted in yet gets
// cudaErrorStreamCaptureUnsupported, so launch once before capturing.

#pragma once

#include <atomic>
#include <cuda_runtime.h>

class SmemOptIn {
 public:
  static constexpr int kMaxDevices = 64;

  // Opt `kernel` in to `bytes` on the current device unless it has been
  // there; `stream` is the launch's stream. Returns cudaSuccess or the
  // error to report.
  cudaError_t operator()(const void* kernel, int bytes, cudaStream_t stream) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (opted_[dev].load(std::memory_order_acquire)) return cudaSuccess;
    cudaStreamCaptureStatus cap = cudaStreamCaptureStatusNone;
    e = cudaStreamIsCapturing(stream, &cap);
    if (e != cudaSuccess) return e;
    if (cap != cudaStreamCaptureStatusNone) return cudaErrorStreamCaptureUnsupported;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    opted_[dev].store(true, std::memory_order_release);
    return cudaSuccess;
  }

 private:
  std::atomic<bool> opted_[kMaxDevices] = {};
};
