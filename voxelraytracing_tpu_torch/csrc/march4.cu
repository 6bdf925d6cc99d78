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
// the instructions of a step and keeps every operation that rounds:
//   * the cell inverse is the exact power of two that march_leg's
//     1.0f / cell rounds to, not a division;
//   * inside_world is tested on the voxel coordinates the step needs
//     anyway: for a world edge v of whole voxels, 0 <= x < v is
//     0 <= floor(x) < v, one unsigned compare an axis;
//   * the exit-axis mask is computed once, from the last step's exits,
//     when the leg ends, not at every step;
//   * one warp marches an 8x4 pixel group (a block, four groups side by
//     side): its rays diverge less than a 16x2 row pair's.
// Persistent warps that refill ended lanes and a register memo of the
// last table words were tried and lost on this card, and the probes
// (csrc/probes3.cu) found a shared-memory row gather no faster than __ldg
// on L2 hits, so no rows are staged (PERF.md §6). Every float operation is
// march_leg's (march4_common.cuh), in its order, so every pixel is
// bit-equal to march_fused4_ref and to the split frame (planes4.cu +
// shade4.cu). march_step is a copy of march_leg's loop body until
// planes4.cu and pathtrace4.cu take it too (ROADMAP queue 2b).
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

// One step of a march leg: march_leg's loop body, with the cell inverse
// taken as the exact power of two that 1.0f / cell rounds to, and
// inside_world tested on the voxel coordinates: for a world edge v of
// whole voxels and a position x that is not NaN, 0 <= x < v is
// 0 <= floor(x) < v (an infinite x converts to INT_MIN or INT_MAX and
// fails the unsigned compare; march keeps NaN positions out, since a NaN
// converts to 0 here, unlike in inside_world). Returns false once the
// leg has ended (hit, slab exit, world exit or step cap), with c.t clamped
// to the slab exit as march_leg leaves it. `dtx, dty, dtz` carry the last
// step's exits; c.axm is left for the caller (march).
template <bool kSparse>
__device__ __forceinline__ bool march_step(const World& w, const Ray& r, Leg& c, float& dtx,
                                           float& dty, float& dtz, int step_cap,
                                           unsigned vcells, float wcell, float wicell) {
  const float pxf = r.ox + r.dx * c.t;
  const float pyf = r.oy + r.dy * c.t;
  const float pzf = r.oz + r.dz * c.t;
  const int vx = static_cast<int>(floorf(pxf));
  const int vy = static_cast<int>(floorf(pyf));
  const int vz = static_cast<int>(floorf(pzf));
  if (!(c.t < r.t_exit) || c.stp >= step_cap || static_cast<unsigned>(vx) >= vcells ||
      static_cast<unsigned>(vy) >= vcells || static_cast<unsigned>(vz) >= vcells) {
    c.t = fminf(c.t, r.t_exit);
    return false;
  }
  const int gsh = 6 + w.gs;
  const int wg = (vx >> gsh) + (vy >> gsh) * w.nwg + (vz >> gsh) * w.nwg * w.nwg;
  const unsigned g = (w.gpair[wg >> 4] >> ((wg & 15) * 2)) & 3u;
  float cell, icell;
  bool liquid, hit_now = false;
  if (g & 1u) {                         // window (super-cell) jump
    cell = wcell;
    icell = wicell;
    liquid = (g & 2u) != 0;
  } else {
    const int wi = (vx >> 6) + (vy >> 6) * w.nw + (vz >> 6) * w.nw * w.nw;
    const int s_loc = ((vx >> 4) & 3) + ((vy >> 4) & 3) * 4 + ((vz >> 4) & 3) * 16;
    const unsigned sw =
        (ld(w.wmeta_pad + static_cast<size_t>(wi) * kRow + (s_loc >> 4)) >> ((s_loc & 15) * 2)) &
        3u;
    const int* row = (sw & 1u) ? nullptr : content_row<kSparse>(w, wi, s_loc, vx, vy, vz);
    if (!row) {                         // subwindow jump, or no sparse row: empty
      cell = 16.0f;
      icell = 0.0625f;
      liquid = (sw & 2u) != 0;
    } else {
      const int b_loc = ((vx >> 2) & 3) + ((vy >> 2) & 3) * 4 + ((vz >> 2) & 3) * 16;
      const unsigned br = (ld(row + 6 * kRow + (b_loc >> 4)) >> ((b_loc & 15) * 2)) & 3u;
      if (br & 1u) {                    // brick skip
        cell = 4.0f;
        icell = 0.25f;
        liquid = (br & 2u) != 0;
      } else {                          // voxel test
        const int l = (vx & 15) + (vy & 15) * 16 + (vz & 15) * 256;
        hit_now = ((ld(row + (l >> 5)) >> (l & 31)) & 1u) != 0;
        liquid = ((ld(row + kRow + (l >> 5)) >> (l & 31)) & 1u) != 0;
        cell = 1.0f;
        icell = 1.0f;
      }
    }
  }
  // water interval: close it on leaving liquid, open it on marching in
  if (c.wenter >= 0.0f && !liquid) {
    c.water = c.water + (c.t - c.wenter);
    c.wenter = -1.0f;
  }
  c.stp += 1;
  if (hit_now) {
    c.hit = true;
    c.t = fminf(c.t, r.t_exit);
    return false;
  }
  if (liquid && c.wenter < 0.0f) c.wenter = c.t;
  dtx = axis_exit(pxf, r.gfx, r.isx, r.bgx, cell, icell);
  dty = axis_exit(pyf, r.gfy, r.isy, r.bgy, cell, icell);
  dtz = axis_exit(pzf, r.gfz, r.isz, r.bgz, cell, icell);
  c.t = c.t + fminf(dtx, fminf(dty, dtz)) + kEpsT;
  return true;
}

// A march leg from t = EPS_T (march_leg's carry and result): steps until
// the leg ends; the exit-axis mask is that of the last step taken (NaN
// exits before the first step: no axis). Both callers start a leg only
// from an origin strictly inside the world, and a t that is not finite
// fails t < t_exit before its position is used, so a position is NaN only
// if the direction is: such a ray takes no step, as in march_leg, whose
// inside_world is false on NaN.
template <bool kSparse>
__device__ __forceinline__ Leg march(const World& w, const Ray& r, bool active, int step_cap,
                                     unsigned vcells, float wcell, float wicell) {
  Leg c;
  c.t = kEpsT;
  c.water = 0.0f;
  c.wenter = -1.0f;
  c.stp = 0;
  c.axm = 0;
  c.hit = false;
  float dtx = __int_as_float(0x7fffffff), dty = dtx, dtz = dtx;
  if (active && r.dx == r.dx && r.dy == r.dy && r.dz == r.dz) {
    while (march_step<kSparse>(w, r, c, dtx, dty, dtz, step_cap, vcells, wcell, wicell)) {
    }
  } else {
    c.t = fminf(c.t, r.t_exit);
  }
  const float dt = fminf(dtx, fminf(dty, dtz));
  c.axm = (dtx <= dt ? 1 : 0) | (dty <= dt ? 2 : 0) | (dtz <= dt ? 4 : 0);
  return c;
}

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

  const World w{gpair, sw_cont, wmeta_pad, nw, ns, gs, (nw + (1 << gs) - 1) >> gs, s[3]};
  const float v = s[3];
  const unsigned vcells = static_cast<unsigned>(v);
  const float wcell = static_cast<float>(64 << gs);
  const float wicell = 1.0f / wcell;  // a power of two: exact
  const int step_cap = step_cap_of(s);
  float dx, dy, dz;
  camera_dir(s, px, py, dx, dy, dz);
  const Ray r = make_ray(s[0], s[1], s[2], dx, dy, dz, v);

  // ---- primary leg: a whole tile inside the frame, camera strictly in the world
  const bool in_w0 = s[0] > 0.0f && s[0] < v && s[1] > 0.0f && s[1] < v && s[2] > 0.0f && s[2] < v;
  const Leg c = march<kSparse>(w, r, tile_valid(s, px, py) && in_w0 && 0 < step_cap, step_cap,
                               vcells, wcell, wicell);
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
    if (march<kSparse>(w, sr, ins0, step_cap, vcells, wcell, wicell).hit) shm = s[37];
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
