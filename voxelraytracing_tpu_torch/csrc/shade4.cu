// Split shade for Hopper (sm_90a): the raw state planes of a primary
// march (and the shadow leg's hit plane) -> packed RGBA8, one thread per
// pixel.
//
// Replaces the TPU kernel voxelraytracing_tpu/ops/wavefront3.py:
// _shade_kernel (launched by _shade through pl.pallas_call): unpack the
// flags, close the water interval at min(ts, t_exit), LUT colour, face
// tints, step heatmap, shadow ambient (scal[34]), sky and sun disc,
// water overlay. Like the TPU kernel it regenerates each pixel's camera
// direction and slab exit from the scalar row instead of reading them
// from memory, and it shades through the same device function as the
// fused kernel (march4_common.cuh), so the split frame equals the fused
// one bit for bit.
//
// What bounds it: memory. Each pixel reads 20 bytes of planes (ts, flags,
// water, water-enter, shadow) and writes 4, against a few dozen flops and
// one powf; at 1080p that is 50 MB, about 15 us at 3.35 TB/s. Design: one
// thread per pixel over 16x8-pixel tiles, planes in image order so each
// warp's loads and stores are contiguous, scalar row and LUT in shared
// memory.

#include "march4_common.cuh"

namespace {

using namespace v4;

__global__ void __launch_bounds__(kThreads)
shade4_kernel(const float* __restrict__ scal, const float* __restrict__ lut,
              const float* __restrict__ ts, const int* __restrict__ fl,
              const float* __restrict__ wa, const float* __restrict__ we,
              const int* __restrict__ sh, int* __restrict__ packed, int height, int width,
              int show_steps, float max_steps) {
  __shared__ float s[kScal];
  __shared__ float clut[6 * kRow];
  stage(s, scal, nullptr, nullptr, clut, lut);
  const int px = blockIdx.x * kTileW + (threadIdx.x % kTileW);
  const int py = blockIdx.y * kTileH + (threadIdx.x / kTileW);
  if (px >= width || py >= height) return;
  const size_t o = static_cast<size_t>(py) * width + px;

  float dx, dy, dz;
  camera_dir(s, px, py, dx, dy, dz);
  const float t_exit = make_ray(s[0], s[1], s[2], dx, dy, dz, s[3]).t_exit;
  const int f = fl[o];
  const bool hit = ((f >> 1) & 1) != 0;
  const float wen = we[o];
  const float water = wa[o] + (wen >= 0.0f ? fminf(ts[o], t_exit) - wen : 0.0f);
  const float shm = (sh != nullptr && sh[o] != 0 && hit) ? s[34] : 1.0f;
  packed[o] = static_cast<int>(shade_rgba8(s, clut, dx, dy, dz, hit, (f >> 2) & 7,
                                           (f >> 17) & 0xFF, water, (f >> 5) & 0xFFF,
                                           show_steps, max_steps, shm));
}

}  // namespace

// Shade one frame on `stream`; `sh` (i32[height,width], non-zero =
// shadowed) is null without shadows. Returns cudaGetLastError() after the
// launch (0 = cudaSuccess); the caller raises on anything else.
extern "C" int shade4_launch(const float* scal, const float* lut, const float* ts, const int* fl,
                             const float* wa, const float* we, const int* sh, int* packed,
                             int height, int width, int show_steps, float max_steps,
                             cudaStream_t stream) {
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH);
  shade4_kernel<<<grid, kThreads, 0, stream>>>(scal, lut, ts, fl, wa, we, sh, packed, height,
                                               width, show_steps, max_steps);
  return static_cast<int>(cudaGetLastError());
}
