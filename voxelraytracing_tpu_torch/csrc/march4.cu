// Fused v4 frame for Hopper (sm_90a): march the bit-plane world and shade
// each pixel to packed RGBA8, one thread per pixel; with shadows, a hit
// ray re-marches toward the sun in the same thread before it is shaded.
//
// Replaces the fused modes of the TPU kernel
// voxelraytracing_tpu/ops/wavefront4.py:_march_kernel4 (launched by
// _march4 through pl.pallas_call): the primary leg, and the fused_shadow
// leg (:1280-1339) with the shadow multiply of shade_store (:946-953).
// The TPU kernel marches 64-tile blocks in serve rounds against a VMEM
// cache it fills by async DMA, and runs the shadow leg on the same warm
// cache; that cache, its min-chain picks and the warm token are schedule
// and change no pixel. Here each ray marches on its own from start to end,
// reading the tables straight from global memory through the read-only
// path (march4_common.cuh holds the march and the shade).
//
// What bounds it: every step of a ray issues up to four dependent global
// loads (window meta -> subwindow meta -> solid/liquid words), and the
// threads of a warp take different numbers of steps (sky rays leave after
// a few window jumps; grazing terrain rays take hundreds), so the kernel
// is latency- and divergence-bound, not bandwidth-bound. The shadow leg
// adds a second divergent march for the hit pixels only. The design keeps
// the per-frame constants (scalar row, global pair plane, color LUT) in
// shared memory, lets the tables of small worlds live in the 50 MB L2,
// and maps a 16x8-pixel tile to each 128-thread block, so the threads of
// a warp trace two neighbouring pixel rows and mostly walk the same
// cells; the shadow rays of neighbouring hits start close together and
// head for the same sun, so they stay coherent too. The shadow leg is a
// template switch, so the unshadowed frame keeps its own registers. No
// TMA, wgmma or shared-memory staging of the tables yet.
//
// The sparse mode of the TPU kernel (`sparse=True`, :747-806) is the
// other template switch: sparse tables (PreparedGrid4Sparse) hold content
// rows only for non-jump subwindows, and each subwindow's row index sits
// in lanes 64-127 of its window's meta row, which the march reads anyway
// (march4_common.cuh content_row). On the TPU the index rides the cached
// window row into the serve; here it costs one dependent load before the
// subwindow's brick meta, and the 80-chunk world's tables shrink from
// ~15 GB to tens of MB.

#include "march4_common.cuh"

namespace {

using namespace v4;

template <bool kShadows, bool kSparse>
__global__ void __launch_bounds__(kThreads)
march_fused4_kernel(const float* __restrict__ scal, const int* __restrict__ gw2,
                    const float* __restrict__ lut, const int* __restrict__ sw_cont,
                    const int* __restrict__ wmeta_pad, int* __restrict__ packed,
                    int* __restrict__ flags, int height, int width, int nw, int ns,
                    int gs, int show_steps, float max_steps) {
  __shared__ float s[kScal];
  __shared__ unsigned gpair[2 * kRow];
  __shared__ float clut[6 * kRow];
  stage(s, scal, gpair, gw2, clut, lut);

  const int px = blockIdx.x * kTileW + (threadIdx.x % kTileW);
  const int py = blockIdx.y * kTileH + (threadIdx.x / kTileW);
  if (px >= width || py >= height) return;

  float dx, dy, dz;
  camera_dir(s, px, py, dx, dy, dz);
  const World w{gpair, sw_cont, wmeta_pad, nw, ns, gs, (nw + (1 << gs) - 1) >> gs, s[3]};
  const float v = s[3];
  const Ray r = make_ray(s[0], s[1], s[2], dx, dy, dz, v);
  const int step_cap = step_cap_of(s);

  // ---- primary leg: a whole tile inside the frame, camera strictly in the world
  const bool in_w0 = s[0] > 0.0f && s[0] < v && s[1] > 0.0f && s[1] < v && s[2] > 0.0f && s[2] < v;
  const Leg c =
      march_leg<kSparse>(w, r, tile_valid(s, px, py) && in_w0 && 0 < step_cap, step_cap);
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

template <bool kShadows, bool kSparse>
void launch(dim3 grid, cudaStream_t stream, const float* scal, const int* gw2, const float* lut,
            const int* sw_cont, const int* wmeta_pad, int* packed, int* flags, int height,
            int width, int nw, int ns, int gs, int show_steps, float max_steps) {
  march_fused4_kernel<kShadows, kSparse><<<grid, kThreads, 0, stream>>>(
      scal, gw2, lut, sw_cont, wmeta_pad, packed, flags, height, width, nw, ns, gs, show_steps,
      max_steps);
}

}  // namespace

// Launch one frame on `stream`; `shadows` selects the shadow leg, `sparse`
// the sparse-table instantiation. Returns cudaGetLastError() after the
// launch (0 = cudaSuccess); the caller raises on anything else.
extern "C" int march_fused4_launch(const float* scal, const int* gw2, const float* lut,
                                   const int* sw_cont, const int* wmeta_pad, int* packed,
                                   int* flags, int height, int width, int nw, int ns, int gs,
                                   int show_steps, float max_steps, int shadows, int sparse,
                                   cudaStream_t stream) {
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH);
  auto fn = shadows ? (sparse ? launch<true, true> : launch<true, false>)
                    : (sparse ? launch<false, true> : launch<false, false>);
  fn(grid, stream, scal, gw2, lut, sw_cont, wmeta_pad, packed, flags, height, width, nw, ns, gs,
     show_steps, max_steps);
  return static_cast<int>(cudaGetLastError());
}
