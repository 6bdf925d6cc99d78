// Device functions shared by the v4 kernels for Hopper (sm_90a): the
// camera ray, one march leg through the bit-plane world, the hit-id decode,
// the flags word, the per-pixel shade epilogue and the path tracer's leg
// end.
//
// march4.cu (fused frame, with or without the shadow leg), planes4.cu
// (state-plane march), shade4.cu (split shade) and pathtrace4.cu
// (one-launch path tracer) all build on these, so the fused and the split
// frame share one march and one shade, and both path tracers one march:
// built alike
// (--fmad=false, IEEE division and sqrt), they agree bit for bit, as the
// JAX package's fused and split dispatches do. Every multiply and add
// rounds on its own in the op order of the JAX kernel
// (voxelraytracing_tpu/ops/wavefront4.py:_march_kernel4) and of the plain
// PyTorch versions: positions o + d*t and the DDA exits land on voxel
// faces, where one ulp flips floor().
//
// Layouts (int32 words holding the JAX package's uint32 bits):
//   scal      f32[43]: 0-2 origin, 3 world edge v, 4-5 2/W 2/H, 6-11 proj
//             affine, 12-20 view rows, 21 band y0, 23 step cap, 25-26
//             tile counts tx ty, 27-29 sun dir, 30 sun intensity, 31-33
//             sky; the fused row then has 34-36 sun position and 37 the
//             shadow ambient, the split shade row the ambient at 34
//   gw2       [256]: global (jump|liquid) pair plane, window wg at word
//             wg>>4, shift (wg&15)*2
//   lut       f32[6,128]: color rows r0 r1 g0 g1 b0 b1 (row pair = ids
//             0-127 | 128-255)
//   sw_cont   [Ns^3,7,128]: rows solid | liquid | pid0..3 | interleaved
//             brick meta (words 0-3) + palette (words 4-7); sparse tables
//             hold [R,7,128] content rows (subwindow id at meta word 8)
//   wmeta_pad [Nw^3,1,128]: interleaved subwindow meta (words 0-3); sparse
//             tables add the content row of local subwindow s = sx + sy*4
//             + sz*16 at word 64 + s (-1: no row, an empty subwindow)
//   per-pixel planes and outputs: [height, width] in image order
//
// The table mode is a template switch (kSparse) of march_leg and
// decode_vox: a dense subwindow's row is its id, a sparse one's is read
// from its window's meta row, one dependent load more a voxel-level step.
// Row offsets are size_t: 80-chunk dense tables would pass 2^31 words.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace v4 {

constexpr int kTileW = 16;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kScal = 43;
constexpr int kRow = 128;              // words per table row
constexpr int kSubRows = 7;            // rows per subwindow in sw_cont
constexpr float kEpsT = 1e-3f;         // EPS_T
constexpr float kBig = 1e9f;           // _BIG
constexpr float kBigIv = 9900000.0f;   // 0.99 * _BIG_IV
constexpr int kCapNone = 1000000000;   // step cap when scal[23] <= 0.5

__device__ __forceinline__ unsigned ld(const int* p) {
  return static_cast<unsigned>(__ldg(p));
}

// min(a, b) as torch.minimum takes it: a NaN in either gives NaN (fminf
// would drop it); one min.NaN instruction on the card.
__device__ __forceinline__ float min_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return a != a ? a : (b != b ? b : fminf(a, b));
#endif
}

// The inverse of a direction component held at least 1e-7 from 0, as
// torch.clamp holds it: a NaN component stays NaN.
__device__ __forceinline__ float inv_dir(float c) {
  return 1.0f / (c >= 0.0f ? fmaxf(c, 1e-7f) : min_nan(c, -1e-7f));
}

// DDA distance to the exit face of the current cell along one axis.
__device__ __forceinline__ float axis_exit(float pc, float sgf, float ivs,
                                          bool big, float cell, float icell) {
  const float ps = pc * sgf;
  const float b = floorf(ps * icell) + 1.0f;
  return big ? kBig : (b * cell - ps) * ivs;
}

// x clamped to [lo, hi] as torch.clamp and jnp.clip clamp: a NaN stays NaN
// (fminf and fmaxf would drop it). A select outside every step loop.
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float sstep(float e0, float inv_span, float x) {
  const float q = clamp_nan((x - e0) * inv_span, 0.0f, 1.0f);
  return q * q * (3.0f - 2.0f * q);
}

// A channel's byte: a NaN channel (a NaN direction's sky) is byte 0, as
// XLA converts NaN to an integer; the cast alone gives 0 on CUDA but
// INT_MIN on x86, whose host build runs this code in the tests.
__device__ __forceinline__ unsigned q8(float c) {
  const float q = clamp_nan(c, 0.0f, 1.0f) * 255.0f;
  return q == q ? static_cast<unsigned>(static_cast<int>(q)) : 0u;
}

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ int step_cap_of(const float* s) {
  return s[23] > 0.5f ? static_cast<int>(s[23]) : kCapNone;
}

__device__ __forceinline__ bool inside_world(float x, float y, float z, float v) {
  return x >= 0.0f && y >= 0.0f && z >= 0.0f && x < v && y < v && z < v;
}

// A whole 16x8 tile inside the frame (scal[25-26] = tile counts).
__device__ __forceinline__ bool tile_valid(const float* s, int px, int py) {
  return static_cast<float>(px / kTileW) < s[25] && static_cast<float>(py / kTileH) < s[26];
}

// Camera ray of pixel (px, py): wavefront3._ray_dirs op order, divided by
// the IEEE sqrt of the squared length.
__device__ __forceinline__ void camera_dir(const float* s, int px, int py, float& dx,
                                           float& dy, float& dz) {
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py) + s[21];
  const float x = fx * s[4] - 1.0f;
  const float y = fy * s[5] - 1.0f;
  const float ex = x * s[6] - y * s[7] + s[8];
  const float ey = x * s[9] - y * s[10] + s[11];
  dx = ex * s[12] + ey * s[15] - s[18];
  dy = ex * s[13] + ey * s[16] - s[19];
  dz = ex * s[14] + ey * s[17] - s[20];
  const float nrm = sqrtf(dx * dx + dy * dy + dz * dz);
  dx = dx / nrm;
  dy = dy / nrm;
  dz = dz / nrm;
}

// The bit-plane world: the pair plane in shared memory, the tables in
// global memory (read-only path); its edge v in voxels (a whole number)
// and its window (super-cell) edge with that edge's exact inverse.
struct World {
  const unsigned* gpair;
  const int* sw_cont;
  const int* wmeta_pad;
  int nw, ns, gs, nwg;
  float v;
  unsigned vcells;
  float wcell, wicell;
};

__device__ __forceinline__ World make_world(const unsigned* gpair, const int* sw_cont,
                                            const int* wmeta_pad, int nw, int ns, int gs,
                                            float v) {
  const float wcell = static_cast<float>(64 << gs);
  return World{gpair, sw_cont, wmeta_pad, nw, ns, gs, (nw + (1 << gs) - 1) >> gs, v,
               static_cast<unsigned>(v), wcell, 1.0f / wcell};  // a power of two: exact
}

// The slab exit of a ray from (ox, oy, oz) with inverse directions
// (ivx, ivy, ivz) through the world [0, v)^3, capped at 4v + 16
// (wavefront4.py _make_leg): make_ray's t_exit, and the start test of
// planes4.cu's camera marks, which builds no Ray. NaN when an origin or
// direction component is NaN, as in the plain version (both operands of
// each fmaxf are NaN together).
__device__ __forceinline__ float slab_exit(float ox, float oy, float oz, float ivx, float ivy,
                                           float ivz, float v) {
  const float slx = fmaxf((0.0f - ox) * ivx, (v - ox) * ivx);
  const float sly = fmaxf((0.0f - oy) * ivy, (v - oy) * ivy);
  const float slz = fmaxf((0.0f - oz) * ivz, (v - oz) * ivz);
  return min_nan(min_nan(slx, min_nan(sly, slz)), 4.0f * v + 16.0f);
}

// A ray and its per-ray DDA constants (wavefront4.py _make_leg).
struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float gfx, gfy, gfz, isx, isy, isz;
  bool bgx, bgy, bgz;
  float t_exit;
};

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz, float dx, float dy,
                                        float dz, float v) {
  Ray r;
  r.ox = ox;
  r.oy = oy;
  r.oz = oz;
  r.dx = dx;
  r.dy = dy;
  r.dz = dz;
  const float ivx = inv_dir(dx), ivy = inv_dir(dy), ivz = inv_dir(dz);
  const float sx = dx > 0.0f ? 1.0f : 0.0f;
  const float sy = dy > 0.0f ? 1.0f : 0.0f;
  const float sz = dz > 0.0f ? 1.0f : 0.0f;
  r.gfx = sx + sx - 1.0f;
  r.gfy = sy + sy - 1.0f;
  r.gfz = sz + sz - 1.0f;
  r.isx = ivx * r.gfx;
  r.isy = ivy * r.gfy;
  r.isz = ivz * r.gfz;
  r.bgx = fabsf(ivx) >= kBigIv;
  r.bgy = fabsf(ivy) >= kBigIv;
  r.bgz = fabsf(ivz) >= kBigIv;
  r.t_exit = slab_exit(ox, oy, oz, ivx, ivy, ivz, v);
  return r;
}

// Whether a ray that is active at start takes its first step: at
// t = EPS_T it lies inside the world and before its slab exit.
__device__ __forceinline__ bool leg_starts(const Ray& r, float v, int step_cap) {
  return kEpsT < r.t_exit && 0 < step_cap &&
         inside_world(r.ox + r.dx * kEpsT, r.oy + r.dy * kEpsT, r.oz + r.dz * kEpsT, v);
}

// The carry of one march leg: final t (clamped to the slab exit), hit,
// exit-axis mask, water length of the closed liquid intervals, start of
// the open one (-1 if none) and step count.
struct Leg {
  float t, water, wenter;
  int stp, axm;
  bool hit;
};

// The content row of the subwindow holding voxel (vx, vy, vz), local
// subwindow s_loc of window wi: dense tables index it by subwindow id;
// sparse tables read it from word 64 + s_loc of the window's meta row
// (wavefront4.py sparse mode, :747-806). A sparse index of -1 gives
// nullptr, never a read out of the table: there is no row for a jump
// subwindow, nor for any subwindow of a window no chunk was ever
// installed in (the builder leaves that window's meta at 0), and the
// march reads such a subwindow as empty, which it is.
template <bool kSparse>
__device__ __forceinline__ const int* content_row(const World& w, int wi, int s_loc, int vx,
                                                  int vy, int vz) {
  if (kSparse) {
    const int ridx = __ldg(w.wmeta_pad + static_cast<size_t>(wi) * kRow + 64 + s_loc);
    return ridx < 0 ? nullptr : w.sw_cont + static_cast<size_t>(ridx) * (kSubRows * kRow);
  }
  const int sid = (vx >> 4) + (vy >> 4) * w.ns + (vz >> 4) * w.ns * w.ns;
  return w.sw_cont + static_cast<size_t>(sid) * (kSubRows * kRow);
}

// One step of a march leg (wavefront4.py classify + step, for one ray):
// the step is classified from position alone — global window
// (super-cell) jump, subwindow jump from the window meta, brick skip from
// the subwindow meta, else a voxel bit test — and advances by the DDA exit
// of its cell plus EPS_T. A sparse subwindow without a content row
// marches as an empty jump. Every float operation is the plain version's,
// in its order, with two exact shortcuts: the cell inverse is the power
// of two that 1.0f / cell rounds to, and the world test is made on the
// voxel coordinates the step needs anyway: for a world edge v of whole
// voxels and a position x that is not NaN, 0 <= x < v is
// 0 <= floor(x) < v (an infinite x converts to INT_MIN or INT_MAX and
// fails the unsigned compare; march_leg keeps NaN positions out, since a
// NaN converts to 0 on the card, where inside_world is false). Returns
// false once the leg has ended (hit, slab exit, world exit or step cap),
// with c.t clamped to the slab exit. `dtx, dty, dtz` carry the last
// step's exits; march_leg derives the exit-axis mask from them.
template <bool kSparse>
__device__ __forceinline__ bool march_step(const World& w, const Ray& r, Leg& c, float& dtx,
                                           float& dty, float& dtz, int step_cap) {
  const float pxf = r.ox + r.dx * c.t;
  const float pyf = r.oy + r.dy * c.t;
  const float pzf = r.oz + r.dz * c.t;
  const int vx = static_cast<int>(floorf(pxf));
  const int vy = static_cast<int>(floorf(pyf));
  const int vz = static_cast<int>(floorf(pzf));
  if (!(c.t < r.t_exit) || c.stp >= step_cap || static_cast<unsigned>(vx) >= w.vcells ||
      static_cast<unsigned>(vy) >= w.vcells || static_cast<unsigned>(vz) >= w.vcells) {
    c.t = fminf(c.t, r.t_exit);
    return false;
  }
  const int gsh = 6 + w.gs;
  const int wg = (vx >> gsh) + (vy >> gsh) * w.nwg + (vz >> gsh) * w.nwg * w.nwg;
  const unsigned g = (w.gpair[wg >> 4] >> ((wg & 15) * 2)) & 3u;
  float cell, icell;
  bool liquid, hit_now = false;
  if (g & 1u) {                         // window (super-cell) jump
    cell = w.wcell;
    icell = w.wicell;
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

// One march leg from t = EPS_T: steps (march_step) until hit, exit or
// stp >= step_cap; the exit-axis mask is that of the last step taken (no
// axis before the first: the exits start NaN). Every kernel of the v4
// family marches through this loop, so the fused frame, the split frame
// and the path tracer step alike. Every caller starts a leg from a finite
// origin (camera rays, bundles and shadow rays strictly inside the world,
// a bounce from its hit point), and a t that is not finite fails
// t < t_exit before its position is used, so a position is NaN only if
// the direction is: such a ray takes no step, as inside_world (false on
// NaN) has it in the plain version.
template <bool kSparse = false>
__device__ __forceinline__ Leg march_leg(const World& w, const Ray& r, bool active,
                                         int step_cap) {
  Leg c;
  c.t = kEpsT;
  c.water = 0.0f;
  c.wenter = -1.0f;
  c.stp = 0;
  c.axm = 0;
  c.hit = false;
  float dtx = __int_as_float(0x7fffffff), dty = dtx, dtz = dtx;
  if (active && r.dx == r.dx && r.dy == r.dy && r.dz == r.dz) {
    while (march_step<kSparse>(w, r, c, dtx, dty, dtz, step_cap)) {
    }
  } else {
    c.t = min_nan(c.t, r.t_exit);  // NaN for a NaN direction, as in the plain version
  }
  const float dt = fminf(dtx, fminf(dty, dtz));
  c.axm = (dtx <= dt ? 1 : 0) | (dty <= dt ? 2 : 0) | (dtz <= dt ? 4 : 0);
  return c;
}

// Hit id at t: 4 palette-index bits + the subwindow palette byte, from
// the hit subwindow's content row (0 if a sparse row is missing).
template <bool kSparse = false>
__device__ __forceinline__ int decode_vox(const World& w, const Ray& r, float t) {
  const int vx = static_cast<int>(floorf(r.ox + r.dx * t));
  const int vy = static_cast<int>(floorf(r.oy + r.dy * t));
  const int vz = static_cast<int>(floorf(r.oz + r.dz * t));
  const int wi = kSparse ? (vx >> 6) + (vy >> 6) * w.nw + (vz >> 6) * w.nw * w.nw : 0;
  const int s_loc = kSparse ? ((vx >> 4) & 3) + ((vy >> 4) & 3) * 4 + ((vz >> 4) & 3) * 16 : 0;
  const int* row = content_row<kSparse>(w, wi, s_loc, vx, vy, vz);
  if (kSparse && !row) return 0;
  const int l = (vx & 15) + (vy & 15) * 16 + (vz & 15) * 256;
  int pidx = 0;
  for (int b = 0; b < 4; ++b)
    pidx |= static_cast<int>((ld(row + (2 + b) * kRow + (l >> 5)) >> (l & 31)) & 1u) << b;
  const unsigned pal = ld(row + 6 * kRow + 4 + (pidx >> 2));
  return static_cast<int>((pal >> ((pidx & 3) * 8)) & 0xFFu);
}

// Flags word (wavefront3._FL_*): 1 hit, 2-4 axis mask, 5-16 steps, 17-24
// hit id, 25-27 direction signs; bit 0 (still active) is 0 once a leg ends.
__device__ __forceinline__ int encode_flags(bool hit, int axm, int stp, int vox, float dx,
                                            float dy, float dz) {
  const int sgn = (dx > 0.0f ? 1 : 0) | (dy > 0.0f ? 2 : 0) | (dz > 0.0f ? 4 : 0);
  return (hit ? 1 << 1 : 0) | (axm << 2) | (min(stp, 0xFFF) << 5) | (vox << 17) | (sgn << 25);
}

// Shade one pixel to packed RGBA8 (wavefront4.py shade_store and
// wavefront3._shade_kernel op order): LUT colour, face tints, step
// heatmap, shadow factor `shm` (1, or the ambient for a shadowed hit;
// x * 1.0f == x, so an unshadowed pixel is unchanged), sky and sun disc,
// water overlay.
__device__ __forceinline__ unsigned shade_rgba8(const float* s, const float* clut, float dx,
                                                float dy, float dz, bool hit, int axm, int vox,
                                                float water, int stp, int show_steps,
                                                float max_steps, float shm) {
  float cr = clut[0 * 256 + vox], cg = clut[1 * 256 + vox], cb = clut[2 * 256 + vox];
  float tint = (axm & 1) ? 0.5f : 1.0f;
  tint = tint * ((axm & 4) ? 0.7f : 1.0f);
  tint = tint * (((axm & 2) && dy > 0.0f) ? 0.2f : 1.0f);
  cr = cr * tint;
  cg = cg * tint;
  cb = cb * tint;
  if (show_steps) {
    const float f = clamp_nan(static_cast<float>(stp) / max_steps, 0.0f, 1.0f);
    cr = cg = cb = f;
  }
  cr = cr * shm;
  cg = cg * shm;
  cb = cb * shm;
  const float gts = sstep(-0.01f, 100.0f, dy);
  const float grad_t = powf(sstep(0.0f, 2.5f, dy), 0.35f);
  const float sun_dot = dx * s[27] + dy * s[28] + dz * s[29];
  const float sun = ((sun_dot > 0.99f && gts >= 1.0f) ? 1.0f : 0.0f) * s[30];
  const float sr = 0.03f + ((1.0f + (s[31] - 1.0f) * grad_t) - 0.03f) * gts + sun;
  const float sg = 0.03f + ((0.3f + (s[32] - 0.3f) * grad_t) - 0.03f) * gts + sun;
  const float sb = 0.03f + ((0.0f + (s[33] - 0.0f) * grad_t) - 0.03f) * gts + sun;
  float r = hit ? cr : sr, gc = hit ? cg : sg, b = hit ? cb : sb;
  if (water != 0.0f) {
    const float factor = clamp_nan(water * (1.0f / 14.0f), 0.8f, 1.0f);
    const float keep = 1.0f - factor;
    r = r * keep + 0.2f * factor;
    gc = gc * keep + 0.5f * factor;
    b = b * keep + 1.0f * factor;
  }
  return q8(r) | (q8(gc) << 8) | (q8(b) << 16) | 0xFF000000u;
}

// Stage the scalar row (and, where given, the pair plane and the colour
// LUT) of one frame in shared memory; blocks have kThreads threads.
__device__ __forceinline__ void stage(float* s, const float* scal, unsigned* gpair,
                                      const int* gw2, float* clut, const float* lut) {
  const int tid = threadIdx.x;
  if (tid < kScal) s[tid] = scal[tid];
  if (gpair) {
    gpair[tid] = static_cast<unsigned>(gw2[tid]);
    gpair[tid + kRow] = static_cast<unsigned>(gw2[tid + kRow]);
  }
  if (clut)
    for (int i = tid; i < 6 * kRow; i += kThreads) clut[i] = lut[i];
  __syncthreads();
}

// ---- path tracing (pathtrace4.cu): the end of one leg, in the op order of
// voxelraytracing_tpu/ops/pathtrace4.py:transition (:573-694) and of the
// plain versions (ops/pathtrace3.py _leg_shade, _bounce_rays).
//
// PT scalar row: 0-26 as above, 27-29 sun POSITION (world-local), 30 sun
// intensity, 31-33 sky colour, 34-37 the key's 16-bit seed quads.
// Material LUT f32[10,128]: channel k (emission, scatter, r, g, b) of hit
// id v at flat word k*256 + v.

constexpr int kMatLut = 10 * kRow;
constexpr unsigned kGolden = 0x9E3779B9u;
constexpr float kTwoPi = 0x1.921fb6p+2f;  // f32(2*pi)
constexpr float kEpsN = 0.004f;          // bounce-origin nudge, f32(4 * 1e-3)

// A path's throughput and gathered radiance.
struct PathCarry {
  float cr, cg, cb, lr, lg, lb;
};

// Draw j of a ray: the murmur3 finalizer of rid ^ base ^ j*0x632BE5AB, its
// top 23 bits mapped into (0, 1) (never 0, so log is finite).
__device__ __forceinline__ float hash_u01(unsigned rid, unsigned base, unsigned j) {
  unsigned h = rid ^ base ^ (j * 0x632BE5ABu);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return static_cast<float>(static_cast<int>(h >> 9)) * (1.0f / 8388608.0f) +
         (1.0f / 16777216.0f);
}

// Sky radiance along a ray, the sun disc seen from its origin.
__device__ __forceinline__ void sky_rgb(const float* s, const Ray& r, float& sr, float& sg,
                                        float& sb) {
  const float gts = sstep(-0.01f, 100.0f, r.dy);
  const float grad_t = powf(sstep(0.0f, 2.5f, r.dy), 0.35f);
  const float svx = s[27] - r.ox;
  const float svy = s[28] - r.oy;
  const float svz = s[29] - r.oz;
  const float sn = sqrtf(svx * svx + svy * svy + svz * svz);
  const float sdot = (r.dx * svx + r.dy * svy + r.dz * svz) / sn;
  const float sun = ((sdot > 0.99f && gts >= 1.0f) ? 1.0f : 0.0f) * s[30];
  sr = 0.03f + ((1.0f + (s[31] - 1.0f) * grad_t) - 0.03f) * gts + sun;
  sg = 0.03f + ((0.3f + (s[32] - 0.3f) * grad_t) - 0.03f) * gts + sun;
  sb = 0.03f + ((0.0f + (s[33] - 0.0f) * grad_t) - 0.03f) * gts + sun;
}

// The end of a leg of a live path: Beer-Lambert absorption along the leg's
// water (0.35, 0.08, 0.04 per voxel), then the sky for a miss, or the hit
// voxel's emission and albedo. The plain versions add a zero where a term
// does not apply; the sums start at +0 and so are never -0, for which
// alone x + 0 != x, so skipping those adds changes no bit.
__device__ __forceinline__ void leg_shade(const float* s, const float* lut, PathCarry& p,
                                          const Ray& r, bool hit, float water, int vox) {
  p.cr = p.cr * expf(-water * 0.35f);
  p.cg = p.cg * expf(-water * 0.08f);
  p.cb = p.cb * expf(-water * 0.04f);
  if (!hit) {
    float sr, sg, sb;
    sky_rgb(s, r, sr, sg, sb);
    p.lr = p.lr + p.cr * sr;
    p.lg = p.lg + p.cg * sg;
    p.lb = p.lb + p.cb * sb;
    return;
  }
  const float e = lut[vox], mr = lut[2 * 256 + vox], mg = lut[3 * 256 + vox],
              mb = lut[4 * 256 + vox];
  p.lr = p.lr + p.cr * e * mr;
  p.lg = p.lg + p.cg * e * mg;
  p.lb = p.lb + p.cb * e * mb;
  p.cr = p.cr * mr;
  p.cg = p.cg * mg;
  p.cb = p.cb * mb;
}

// The next ray of a path that hit at t: a unit-sphere Box-Muller sample
// about the face normal (-sign(d) on the exit axes, -d when there are
// none), mixed with the mirror reflection by the material's scatter; the
// origin is the hit point with its crossing coordinates snapped to their
// face, nudged kEpsN along the normal. `base` keys the draws.
__device__ __forceinline__ Ray bounce_ray(const Ray& r, float t, int axm, float scat,
                                          unsigned rid, unsigned base, float v) {
  float nx = -sign_of(r.dx) * static_cast<float>(axm & 1);
  float ny = -sign_of(r.dy) * static_cast<float>((axm >> 1) & 1);
  float nz = -sign_of(r.dz) * static_cast<float>((axm >> 2) & 1);
  if (nx == 0.0f && ny == 0.0f && nz == 0.0f) {
    nx = -r.dx;
    ny = -r.dy;
    nz = -r.dz;
  }
  const float u1 = hash_u01(rid, base, 0), u2 = hash_u01(rid, base, 1);
  const float u3 = hash_u01(rid, base, 2), u4 = hash_u01(rid, base, 3);
  const float r1 = sqrtf(-2.0f * logf(u1));
  const float a1 = u2 * kTwoPi;
  const float r2 = sqrtf(-2.0f * logf(u3));
  const float a2 = u4 * kTwoPi;
  float vx = r1 * cosf(a1), vy = r1 * sinf(a1), vz = r2 * cosf(a2);
  const float rn = fmaxf(sqrtf(vx * vx + vy * vy + vz * vz), 1e-6f);
  vx = vx / rn;
  vy = vy / rn;
  vz = vz / rn;
  float dfx = nx + vx, dfy = ny + vy, dfz = nz + vz;
  const float dn = sqrtf(dfx * dfx + dfy * dfy + dfz * dfz);
  const float dnm = fmaxf(dn, 1e-6f);
  dfx = dn > 1e-6f ? dfx / dnm : nx;
  dfy = dn > 1e-6f ? dfy / dnm : ny;
  dfz = dn > 1e-6f ? dfz / dnm : nz;
  const float dot = r.dx * nx + r.dy * ny + r.dz * nz;
  const float spx = r.dx - 2.0f * dot * nx;
  const float spy = r.dy - 2.0f * dot * ny;
  const float spz = r.dz - 2.0f * dot * nz;
  const float keep = 1.0f - scat;
  float ndx = dfx * scat + spx * keep, ndy = dfy * scat + spy * keep,
        ndz = dfz * scat + spz * keep;
  const float nn = sqrtf(ndx * ndx + ndy * ndy + ndz * ndz);
  const float nnm = fmaxf(nn, 1e-6f);
  ndx = nn > 1e-6f ? ndx / nnm : nx;
  ndy = nn > 1e-6f ? ndy / nnm : ny;
  ndz = nn > 1e-6f ? ndz / nnm : nz;
  float hx = r.ox + r.dx * t, hy = r.oy + r.dy * t, hz = r.oz + r.dz * t;
  if (axm & 1) hx = floorf(hx + 0.5f);
  if (axm & 2) hy = floorf(hy + 0.5f);
  if (axm & 4) hz = floorf(hz + 0.5f);
  return make_ray(hx + nx * kEpsN, hy + ny * kEpsN, hz + nz * kEpsN, ndx, ndy, ndz, v);
}

}  // namespace v4
