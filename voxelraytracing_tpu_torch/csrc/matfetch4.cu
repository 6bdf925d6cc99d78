// Per-ray material fetch for Hopper (sm_90a): the hit id of each flags word
// -> emission, scatter, r, g, b planes, one thread per ray.
//
// Replaces the TPU kernel voxelraytracing_tpu/ops/wavefront3.py:_mat_kernel
// (launched by _matfetch through pl.pallas_call), which gathers each
// channel lane-locally from the [10,128] LUT rows and picks the row of the
// pair by bit 7 of the id. Here the LUT (5 KB) sits in shared memory and
// channel k of id v is its word k*256 + v: the row pair is one contiguous
// 256-entry table.
//
// What bounds it: memory. Each ray reads one flags word and writes five
// f32 planes, 24 bytes, against no arithmetic; at 1080p that is 50 MB,
// about 15 us at 3.35 TB/s. Design: a grid-stride loop over at most 2048
// blocks of 256 threads, so the LUT is staged a few thousand times, not
// once per 256 rays; consecutive threads read and write consecutive words.

#include "march4_common.cuh"

namespace {

using namespace v4;

constexpr int kMatThreads = 256;
constexpr int kMaxBlocks = 2048;

__global__ void __launch_bounds__(kMatThreads)
matfetch4_kernel(const float* __restrict__ mlut, const int* __restrict__ fl,
                 float* __restrict__ out, int n) {
  __shared__ float lut[kMatLut];
  for (int i = threadIdx.x; i < kMatLut; i += kMatThreads) lut[i] = mlut[i];
  __syncthreads();
  const size_t plane = static_cast<size_t>(n);
  for (int i = blockIdx.x * kMatThreads + threadIdx.x; i < n; i += gridDim.x * kMatThreads) {
    const int vox = (fl[i] >> 17) & 0xFF;
    for (int k = 0; k < 5; ++k) out[k * plane + i] = lut[k * 256 + vox];
  }
}

}  // namespace

// Fetch the materials of `n` flags words on `stream` into `out`
// f32[5, n] (emission, scatter, r, g, b). Returns the launch's CUDA error
// (0 = cudaSuccess); the caller raises on anything else.
extern "C" int matfetch4_launch(const float* mlut, const int* fl, float* out, int n,
                                cudaStream_t stream) {
  if (n <= 0) return 0;
  int blocks = (n + kMatThreads - 1) / kMatThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  matfetch4_kernel<<<blocks, kMatThreads, 0, stream>>>(mlut, fl, out, n);
  return static_cast<int>(cudaGetLastError());
}
