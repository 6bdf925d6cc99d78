// Fused v4 frame for Hopper (sm_90a): march the bit-plane world and shade
// each pixel to packed RGBA8; with shadows, a hit ray re-marches toward
// the sun in the same lane before it is shaded.
//
// Replaces the fused modes of the TPU kernel
// voxelraytracing_tpu/ops/wavefront4.py:_march_kernel4 (launched by
// _march4 through pl.pallas_call): the primary leg, the fused_shadow leg
// (:1280-1339) with the shadow multiply of shade_store (:946-953), and the
// sparse-table mode (`sparse=True`, :747-806). The TPU kernel marches
// 64-tile blocks in serve rounds against a VMEM cache it fills by async
// DMA; that cache, its min-chain picks and the warm token are schedule and
// change no pixel. Each ray here marches on its own from start to end, so
// any schedule gives the same pixels: the kernel is free to choose which
// lane marches which pixel, and when.
//
// What bounds it: instruction issue. Every step of a ray is a fixed chain
// of float work (the position o + d*t, three floors, the DDA exits of
// three axes) around up to four dependent table loads (window meta word
// -> [sparse: row index] -> brick meta word -> solid and liquid words),
// and the 1080p bench frame takes 21.2 million of them. The tables are
// small enough to stay in L1/L2: the step costs the same when they do not
// fit L2 (the 16-chunk world), so loads are not the limit. Divergence is
// small: the lanes of an 8x4 pixel group take, step-weighted, 95% of the
// steps of their longest lane (PERF.md §6). The design therefore cuts
// the instructions of a step and keeps every operation that rounds: the
// step (march4_common.cuh march_step, shared with planes4.cu and
// pathtrace4.cu) takes the exact power-of-two cell inverse, tests the
// world bounds on the voxel coordinates with one unsigned compare an
// axis, and leaves the exit-axis mask to the end of the leg; and one warp
// marches an 8x4 pixel group (a block, four groups side by side), whose
// rays diverge less than a 16x2 row pair's.
// Persistent warps that refill ended lanes and a register memo of the
// last table words were tried and lost on this card, and the probes
// (csrc/probes3.cu) found a shared-memory row gather no faster than __ldg
// on L2 hits, so no rows are staged (PERF.md §6). Every float operation is
// the plain version's, in its order, so every pixel is bit-equal to
// march_fused4_ref and to the split frame (planes4.cu + shade4.cu).
// The per-frame constants (scalar row, global pair plane, colour LUT) sit
// in shared memory; the tables are read through the read-only path. The
// shadow leg and the sparse tables are template switches.

#include "march4_common.cuh"

namespace {

using namespace v4;

constexpr int kGroupW = 8;  // a warp's pixels: 8 x 4
constexpr int kGroupH = 4;
constexpr int kWarps = kThreads / 32;  // a block: kWarps groups side by side
// blocks an SM must hold: a budget of 64 registers a thread (the four
// instantiations use 48-56, with no spills)
constexpr int kMinBlocks = 8;

template <bool kShadows, bool kSparse>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
march_fused4_kernel(const float* __restrict__ scal, const int* __restrict__ gw2,
                    const float* __restrict__ lut, const int* __restrict__ sw_cont,
                    const int* __restrict__ wmeta_pad, int* __restrict__ packed,
                    int* __restrict__ flags, int height, int width, int nw, int ns, int gs,
                    int show_steps, float max_steps) {
  __shared__ float s[kScal];
  __shared__ unsigned gpair[2 * kRow];
  __shared__ float clut[6 * kRow];
  stage(s, scal, gpair, gw2, clut, lut);

  // warp w of block (bx, by) marches the 8x4 pixel group (bx * kWarps +
  // w, by)
  const int lane = threadIdx.x & 31;
  const int px = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kGroupW + lane % kGroupW;
  const int py = blockIdx.y * kGroupH + lane / kGroupW;
  if (px >= width || py >= height) return;

  const World w = make_world(gpair, sw_cont, wmeta_pad, nw, ns, gs, s[3]);
  const float v = s[3];
  const int step_cap = step_cap_of(s);
  float dx, dy, dz;
  camera_dir(s, px, py, dx, dy, dz);
  const Ray r = make_ray(s[0], s[1], s[2], dx, dy, dz, v);

  // ---- primary leg: a whole tile inside the frame, camera strictly in the world
  const bool in_w0 = s[0] > 0.0f && s[0] < v && s[1] > 0.0f && s[1] < v && s[2] > 0.0f && s[2] < v;
  const Leg c = march_leg<kSparse>(w, r, tile_valid(s, px, py) && in_w0 && 0 < step_cap, step_cap);
  const int vox = c.hit ? decode_vox<kSparse>(w, r, c.t) : 0;

  // ---- shadow leg (_shadow_prep4 op order): rebase the hit point along
  // the face normal, aim at the sun position (scal 34-36), re-march
  float shm = 1.0f;
  if (kShadows && c.hit) {
    const float nx = -sign_of(dx) * static_cast<float>(c.axm & 1);
    const float ny = -sign_of(dy) * static_cast<float>((c.axm >> 1) & 1);
    const float nz = -sign_of(dz) * static_cast<float>((c.axm >> 2) & 1);
    const float hx = r.ox + dx * c.t + nx * 1e-3f;
    const float hy = r.oy + dy * c.t + ny * 1e-3f;
    const float hz = r.oz + dz * c.t + nz * 1e-3f;
    const float svx = s[34] - hx;
    const float svy = s[35] - hy;
    const float svz = s[36] - hz;
    const float sn = sqrtf(svx * svx + svy * svy + svz * svz);
    const Ray sr = make_ray(hx, hy, hz, svx / sn, svy / sn, svz / sn, v);
    const bool ins0 = hx > 0.0f && hx < v && hy > 0.0f && hy < v && hz > 0.0f && hz < v;
    if (march_leg<kSparse>(w, sr, ins0, step_cap).hit) shm = s[37];
  }

  // ---- shade (the open water interval closes at t)
  float water = c.water;
  if (c.wenter >= 0.0f) water = water + (c.t - c.wenter);
  const size_t o = static_cast<size_t>(py) * width + px;
  packed[o] = static_cast<int>(
      shade_rgba8(s, clut, dx, dy, dz, c.hit, c.axm, vox, water, c.stp, show_steps, max_steps, shm));
  flags[o] = encode_flags(c.hit, c.axm, c.stp, vox, dx, dy, dz);
}

}  // namespace

#ifndef MARCH4_HOST_TEST  // tests/torch_march4_host.cpp builds the code above for the CPU
// Launch one frame on `stream`: a 128-thread block for each 32x4 pixels.
// `shadows` selects the shadow leg, `sparse` the sparse-table
// instantiation. Returns cudaGetLastError() after the launch (0 =
// cudaSuccess); the caller raises on anything else.
extern "C" int march_fused4_launch(const float* scal, const int* gw2, const float* lut,
                                   const int* sw_cont, const int* wmeta_pad, int* packed,
                                   int* flags, int height, int width, int nw, int ns, int gs,
                                   int show_steps, float max_steps, int shadows, int sparse,
                                   cudaStream_t stream) {
  const dim3 grid((width + kWarps * kGroupW - 1) / (kWarps * kGroupW),
                  (height + kGroupH - 1) / kGroupH);
  auto kern = shadows ? (sparse ? march_fused4_kernel<true, true> : march_fused4_kernel<true, false>)
                      : (sparse ? march_fused4_kernel<false, true> : march_fused4_kernel<false, false>);
  if (grid.x > 0 && grid.y > 0)
    kern<<<grid, kThreads, 0, stream>>>(scal, gw2, lut, sw_cont, wmeta_pad, packed, flags,
                                        height, width, nw, ns, gs, show_steps, max_steps);
  return static_cast<int>(cudaGetLastError());
}
#endif  // MARCH4_HOST_TEST
