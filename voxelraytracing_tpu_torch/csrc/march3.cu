// The v3 round-serviced march for Hopper (sm_90a): one launch marches every
// 64-tile program of a frame (8,192 rays) through the windows and
// subwindows that the host put into that program's cache block, and
// returns the rays' state and a want-list per tile for the host's next
// service round.
//
// Replaces the TPU kernel voxelraytracing_tpu/ops/wavefront3.py:
// _march_kernel (launched by _march through pl.pallas_call). Plain version:
// ops/wavefront3.py march3_ref; the host round loop that serves the wants
// is ops/wavefront3.py _trace_frame.
//
// Unlike the v4 kernels, a ray here cannot read the world tables: it reads
// only its program's cache block, so which rays finish in a launch depends
// on what that block holds, and the reductions of the TPU kernel decide
// which rays step at all. The design keeps each of their scopes:
//   * a program is a cluster of two 1,024-thread blocks on two SMs, each
//     with its own copy of the 101x128-word cache block (51,712 bytes) in
//     dynamic shared memory, read by every step. The program-wide "some
//     ray can progress" (`go`, :680) and pass-through test (`any_active`,
//     :988), and so the sub-round count, are a __syncthreads_or in each
//     block whose results the blocks write into each other's shared
//     memory (DSMEM) across one cluster barrier;
//   * warp w of block b owns tile 32b + w of the program, each thread 4
//     rays: ray k of a thread is lanes 32k + lane. A tile's reductions —
//     the subwindow its rays step in (`tsid`, the smallest cached id a
//     stalled ray needs, :650-653), its window want and prefetch wants
//     (:855-881) — are warp min-reductions over 4 rays a thread, and each
//     32-lane group's immediate want (:858-867) one at a fixed k.
// What bounds it: not bytes (the state planes are read and written once a
// launch) but the instructions of each ray's start, each sub-round's
// boundary and each step, and the dependent shared-memory bit gathers of a
// step. So each is done once where the TPU kernel's order allows:
//   * a ray's terms (direction, inverse direction, slab exit; per-ray
//     origins) are derived once a launch into shared memory planes, while
//     the cache block's copies (cp.async) are in flight;
//   * its carry (t, water, water-enter and a word of active, hit, exit
//     axes, id and steps) stays in registers from the first sub-round to
//     the last, and the state planes are written once;
//   * a boundary classifies only active rays (an inactive ray adds nothing
//     to a reduction), and resolves a cached window or subwindow slot (the
//     last of equal ids, as the TPU compare chain leaves it) only where the
//     step reads it: not in a jumpable global window, not past a jumpable
//     subwindow;
//   * the cell inverse is the exact power of two that 1.0f / cell rounds
//     to, not a division;
//   * a ray that does not move in a step cannot move later in the
//     sub-round (its position, and so its classification, stays), so it
//     stops stepping there; that changes no result.
// Built with --fmad=false: every multiply and add rounds on its own as in
// the plain version, so positions on voxel faces floor alike.

#include "march4_common.cuh"
#include "smem_optin.cuh"

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#ifndef DYN_SMEM  // the host stand-in (tests/torch_cuda_host.h) gives each block its own
#define DYN_SMEM(name) extern __shared__ __align__(16) unsigned char name[]
#endif

namespace {

namespace cg = cooperative_groups;
using v4::kBig;
using v4::kBigIv;
using v4::kCapNone;
using v4::kEpsT;

constexpr int kBlk = 64;          // tiles per program
constexpr int kLanes = 128;       // rays per tile
constexpr int kCluster = 2;       // blocks per program
constexpr int kThreads3 = 1024;   // a block: 32 warps, a tile each
constexpr int kTilesB = kBlk / kCluster;
constexpr int kRaysB = kTilesB * kLanes;
constexpr int kRays = 4;          // rays per thread
constexpr int kNwc = 8;           // cached windows per program
constexpr int kNsc = 16;          // cached subwindows per program
constexpr int kMcRows = 5 + 6 * kNsc;
constexpr int kMcWords = kMcRows * kLanes;
constexpr int kBigi = 0x3FFFFFFF;
constexpr int kScal3 = 27;
constexpr int kScalPad = 28;
// rows of a program's cache block
constexpr int kRowGj = 0, kRowGl = 1, kRowWm = 2, kRowSm = 3, kRowIds = 4;
constexpr int kRowSol = 5, kRowLiq = 5 + kNsc, kRowPid = 5 + 2 * kNsc;
constexpr unsigned kFull = 0xFFFFFFFFu;
// the ray planes in shared memory, kRaysB floats each; per-ray bundles add
// their origins
constexpr int kPDx = 0, kPDy = 1, kPDz = 2, kPIvx = 3, kPIvy = 4, kPIvz = 5, kPTex = 6;
constexpr int kPOx = 7, kPOy = 8, kPOz = 9;

struct Prog {
  const unsigned* mc;  // the cache block, in shared memory
  int nw, ns, gs, nwg;
  float v, wcell, wicell;
};

struct Ray3 {
  float ox, oy, oz, dx, dy, dz, ivx, ivy, ivz, t_exit;
  bool sx, sy, sz;
};

// A ray's carry between sub-rounds; packed in registers as t, water,
// water-enter and a word: bit 0 active, 1 hit, 2-4 exit axes, 5-12 id,
// 13-31 steps.
struct Carry {
  float t, water, wenter;
  int axm, vox, stp;
  bool act, hit;
};

__device__ __forceinline__ unsigned pack(const Carry& c) {
  return (c.act ? 1u : 0u) | (c.hit ? 2u : 0u) | (static_cast<unsigned>(c.axm) << 2) |
         (static_cast<unsigned>(c.vox) << 5) | (static_cast<unsigned>(c.stp) << 13);
}

__device__ __forceinline__ Carry unpack(float t, float water, float wenter, unsigned f) {
  Carry c;
  c.t = t;
  c.water = water;
  c.wenter = wenter;
  c.act = (f & 1u) != 0;
  c.hit = (f & 2u) != 0;
  c.axm = static_cast<int>((f >> 2) & 7u);
  c.vox = static_cast<int>((f >> 5) & 0xFFu);
  c.stp = static_cast<int>(f >> 13);
  return c;
}

struct Cls {
  float px, py, pz;
  int vx, vy, vz, w, wslot, s, sslot;
  bool gj, gl, swj, swl;
};

__device__ __forceinline__ unsigned bit_of(const unsigned* row, int word, int sh) {
  word = min(max(word, 0), kLanes - 1);
  return (row[word] >> sh) & 1u;
}

// The slot of x among n ids (n a multiple of 4, 16-byte aligned): the last
// of equal ones, as the TPU compare chain leaves it; -1 if none or x < 0.
__device__ __forceinline__ int last_slot(const unsigned* ids, int n, int x) {
  int slot = -1;
#pragma unroll
  for (int k = 0; k < n; k += 4) {
    const int4 q = *reinterpret_cast<const int4*>(ids + k);
    slot = q.x == x ? k : slot;
    slot = q.y == x ? k + 1 : slot;
    slot = q.z == x ? k + 2 : slot;
    slot = q.w == x ? k + 3 : slot;
  }
  return x >= 0 ? slot : -1;
}

// Everything a step derives from the position at t (wavefront3.py
// :594-641): voxel, window and subwindow ids and the global-plane bits;
// outside a jumpable global window the cached window slot and its
// subwindow bits; with need_sslot, where the window is cached and the
// subwindow not jumpable, the cached subwindow slot. Every caller reads
// the slots and subwindow bits only there.
__device__ __forceinline__ Cls classify(const Prog& p, const Ray3& r, float t, bool need_sslot) {
  Cls c;
  c.px = r.ox + r.dx * t;
  c.py = r.oy + r.dy * t;
  c.pz = r.oz + r.dz * t;
  c.vx = static_cast<int>(floorf(c.px));
  c.vy = static_cast<int>(floorf(c.py));
  c.vz = static_cast<int>(floorf(c.pz));
  const int nw = p.nw, gs = p.gs, nwg = p.nwg;
  c.w = (c.vx >> 6) + (c.vy >> 6) * nw + (c.vz >> 6) * nw * nw;
  const int wg = gs ? (c.vx >> (6 + gs)) + (c.vy >> (6 + gs)) * nwg + (c.vz >> (6 + gs)) * nwg * nwg
                    : c.w;
  c.gj = bit_of(p.mc + kRowGj * kLanes, wg >> 5, wg & 31) != 0;
  c.gl = bit_of(p.mc + kRowGl * kLanes, wg >> 5, wg & 31) != 0;
  c.s = (c.vx >> 4) + (c.vy >> 4) * p.ns + (c.vz >> 4) * p.ns * p.ns;
  c.wslot = -1;
  c.sslot = -1;
  c.swj = c.swl = false;
  if (!c.gj) {
    c.wslot = last_slot(p.mc + kRowIds * kLanes, kNwc, c.w);
    if (c.wslot >= 0) {
      const int s_loc = ((c.vx >> 4) & 3) + ((c.vy >> 4) & 3) * 4 + ((c.vz >> 4) & 3) * 16;
      const int mbase = c.wslot * 8 + (s_loc >> 5);
      c.swj = bit_of(p.mc + kRowWm * kLanes, mbase, s_loc & 31) != 0;
      c.swl = bit_of(p.mc + kRowWm * kLanes, mbase + 2, s_loc & 31) != 0;
      if (need_sslot && !c.swj) c.sslot = last_slot(p.mc + kRowIds * kLanes + kNwc, kNsc, c.s);
    }
  }
  return c;
}

// Distance to the next cell plane along one axis (wavefront3.py:751-766):
// floor+1 for a positive direction, ceil-1 for a negative one.
__device__ __forceinline__ float axis3(float pc, float ivc, bool sgn, float cell, float icell) {
  const float q = pc * icell;
  const float b = sgn ? floorf(q) + 1.0f : ceilf(q) - 1.0f;
  const float dt = (b * cell - pc) * ivc;
  return fabsf(ivc) >= kBigIv ? kBig : dt;
}

// The terms of ray i of the block from its shared-memory planes.
template <bool kPerRay>
__device__ __forceinline__ Ray3 ray_at(const float* rp, const float* s, int i) {
  Ray3 r;
  if (kPerRay) {
    r.ox = rp[kPOx * kRaysB + i];
    r.oy = rp[kPOy * kRaysB + i];
    r.oz = rp[kPOz * kRaysB + i];
  } else {
    r.ox = s[0];
    r.oy = s[1];
    r.oz = s[2];
  }
  r.dx = rp[kPDx * kRaysB + i];
  r.dy = rp[kPDy * kRaysB + i];
  r.dz = rp[kPDz * kRaysB + i];
  r.ivx = rp[kPIvx * kRaysB + i];
  r.ivy = rp[kPIvy * kRaysB + i];
  r.ivz = rp[kPIvz * kRaysB + i];
  r.t_exit = rp[kPTex * kRaysB + i];
  r.sx = r.dx > 0.0f;
  r.sy = r.dy > 0.0f;
  r.sz = r.dz > 0.0f;
  return r;
}

// One step of an active ray inside the tile's subwindow `tsid` (cache slot
// `tslot`, `match` false when it is not cached): wavefront3.py:683-785.
// Returns whether the ray marched (it then stays active).
__device__ __forceinline__ bool step3(const Prog& p, const Ray3& r, Carry& c, int tsid,
                                      int tslot, bool match, int cap) {
  const Cls k = classify(p, r, c.t, false);
  const float v = p.v;
  if (!(c.t < r.t_exit) || !(k.px >= 0.0f && k.py >= 0.0f && k.pz >= 0.0f && k.px < v &&
                             k.py < v && k.pz < v) ||
      !(c.stp < cap)) {
    c.act = false;
    return false;
  }
  const bool case1 = k.gj;
  const bool case2 = !k.gj && k.wslot >= 0 && k.swj;
  const bool case3 = !k.gj && k.wslot >= 0 && !k.swj && k.s == tsid;
  bool br_jump = false, br_liq = false, vsolid = false, vliq = false;
  if (case3) {
    const int b_loc = ((k.vx >> 2) & 3) + ((k.vy >> 2) & 3) * 4 + ((k.vz >> 2) & 3) * 16;
    const int bbase = tslot * 8 + (b_loc >> 5);
    const unsigned* sm = p.mc + kRowSm * kLanes;
    br_jump = bit_of(sm, bbase, b_loc & 31) != 0;
    br_liq = bit_of(sm, bbase + 2, b_loc & 31) != 0;
    const int l = (k.vx & 15) + (k.vy & 15) * 16 + (k.vz & 15) * 256;
    vsolid = match && bit_of(p.mc + (kRowSol + tslot) * kLanes, l >> 5, l & 31) != 0;
    vliq = match && bit_of(p.mc + (kRowLiq + tslot) * kLanes, l >> 5, l & 31) != 0;
  }
  const bool in_br = case3 && br_jump;
  const bool in_vox = case3 && !br_jump;
  const bool hit_now = in_vox && vsolid;
  const bool march = case1 || case2 || in_br || (in_vox && !vsolid);
  const bool liquid = case1 ? k.gl : case2 ? k.swl : in_br ? br_liq : vliq;

  if ((march || hit_now) && c.wenter >= 0.0f && !liquid) {
    c.water = c.water + (c.t - c.wenter);
    c.wenter = -1.0f;
  }
  if (march && liquid && c.wenter < 0.0f) c.wenter = c.t;
  if (march) {
    // the cell and its inverse, an exact power of two
    const float cell = case1 ? p.wcell : case2 ? 16.0f : in_br ? 4.0f : 1.0f;
    const float icell = case1 ? p.wicell : case2 ? 0.0625f : in_br ? 0.25f : 1.0f;
    const float dtx = axis3(k.px, r.ivx, r.sx, cell, icell);
    const float dty = axis3(k.py, r.ivy, r.sy, cell, icell);
    const float dtz = axis3(k.pz, r.ivz, r.sz, cell, icell);
    const float dt = fminf(dtx, fminf(dty, dtz));
    c.axm = (dtx <= dt ? 1 : 0) | (dty <= dt ? 2 : 0) | (dtz <= dt ? 4 : 0);
    c.t = c.t + dt + kEpsT;
  }
  if (march || hit_now) c.stp += 1;
  c.hit = c.hit || hit_now;
  c.act = !hit_now;
  return march;
}

// The pack id of a hit at t from the tile's composed palette-index rows and
// its subwindow's palette word (wavefront3.py:884-908).
__device__ __forceinline__ int decode3(const Prog& p, const Ray3& r, float t, int tslot,
                                       bool match) {
  const int vx = static_cast<int>(floorf(r.ox + r.dx * t));
  const int vy = static_cast<int>(floorf(r.oy + r.dy * t));
  const int vz = static_cast<int>(floorf(r.oz + r.dz * t));
  const int l = (vx & 15) + (vy & 15) * 16 + (vz & 15) * 256;
  int pidx = 0;
  for (int b = 0; b < 4; ++b)
    if (match)
      pidx |= static_cast<int>(bit_of(p.mc + (kRowPid + tslot * 4 + b) * kLanes, l >> 5, l & 31))
              << b;
  const int wi = min(max(tslot * 8 + 4 + (pidx >> 2), 0), kLanes - 1);
  const unsigned pal = p.mc[kRowSm * kLanes + wi];
  return static_cast<int>((pal >> ((pidx & 3) * 8)) & 0xFFu);
}

// A ray's want walk (wavefront3.py:787-853): up to `lookahead` cells ahead
// from t, the first uncached window (where the walk stops) and the first
// uncached subwindows (ch[0] the immediate stall, ch[1..3] prefetch).
__device__ __forceinline__ void walk3(const Prog& p, const Ray3& r, float t, bool act,
                                      int lookahead, int& wwid, int (&ch)[4]) {
  float tw = t;
  bool alive = act;
  wwid = -1;
  ch[0] = ch[1] = ch[2] = ch[3] = -1;
  for (int j = 0; j < lookahead; ++j) {
    const Cls c = classify(p, r, tw, true);
    alive = alive && tw < r.t_exit;
    const bool wun = alive && !c.gj && c.wslot < 0;
    if (wwid < 0 && wun) wwid = c.w;
    alive = alive && !wun;
    const bool fresh = alive && !c.gj && !c.swj && c.sslot < 0 && c.s != ch[0] &&
                       c.s != ch[1] && c.s != ch[2] && c.s != ch[3];
    if (j == 0) {
      if (fresh) ch[0] = c.s;
    } else if (fresh) {
      if (ch[1] < 0) ch[1] = c.s;
      else if (ch[2] < 0) ch[2] = c.s;
      else if (ch[3] < 0) ch[3] = c.s;
    }
    if (j + 1 < lookahead) {
      const float cell = c.gj ? p.wcell : 16.0f;
      const float icell = c.gj ? p.wicell : 0.0625f;
      const float dt = fminf(axis3(c.px, r.ivx, r.sx, cell, icell),
                             fminf(axis3(c.py, r.ivy, r.sy, cell, icell),
                                   axis3(c.pz, r.ivz, r.sz, cell, icell)));
      if (alive) tw = tw + dt + kEpsT;
    }
  }
}

__device__ __forceinline__ int or_none(int x) { return x >= 0 ? x : kBigi; }
__device__ __forceinline__ int none_of(int m) { return m < kBigi ? m : -1; }

// x ORed over the program's two blocks: each block's __syncthreads_or goes
// into word `rank` of every block's pair `parity` (DSMEM), read after the
// cluster barrier. The pairs alternate: a block writes pair `parity` again
// two calls later, after the barrier between, which every reader of this
// call has reached.
__device__ __forceinline__ bool cluster_or(const cg::cluster_group& cl, int* orf, int rank,
                                           int& parity, bool x) {
  const int b = __syncthreads_or(x);
  if (threadIdx.x < kCluster)
    cl.map_shared_rank(orf, threadIdx.x)[parity * kCluster + rank] = b;
  cl.sync();
  bool r = false;
#pragma unroll
  for (int j = 0; j < kCluster; ++j) r = r || orf[parity * kCluster + j] != 0;
  parity ^= 1;
  return r;
}

template <bool kPerRay>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads3, 1)
march3_kernel(const float* __restrict__ scal, const int* __restrict__ mc,
              const float* __restrict__ rays, const int* __restrict__ tmap,
              const float* __restrict__ ts_in, const int* __restrict__ fl_in,
              const float* __restrict__ wa_in, const float* __restrict__ we_in,
              float* __restrict__ ts, int* __restrict__ fl, float* __restrict__ wa,
              float* __restrict__ we, int* __restrict__ want, int T, int nw, int ns, int nsx,
              int sub_rounds, int sub_steps, int lookahead) {
  DYN_SMEM(dsm);
  unsigned* smc = reinterpret_cast<unsigned*>(dsm);
  float* s = reinterpret_cast<float*>(smc + kMcWords);
  int* orf = reinterpret_cast<int*>(s + kScalPad);
  float* rp = reinterpret_cast<float*>(orf + 2 * kCluster);
  const cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int prog = blockIdx.x / kCluster;
  const int tile = prog * kBlk + rank * kTilesB + warp;  // this warp's tile
  const int* blk = mc + static_cast<size_t>(prog) * kMcWords;
  // the cache block: copies in flight (cp.async) while the rays' terms are
  // derived, from the scalar row in global memory
  for (int i = tid; i < kMcWords; i += kThreads3) __pipeline_memcpy_async(smc + i, blk + i, 4);
  __pipeline_commit();
  if (tid < kScal3) s[tid] = scal[tid];

  int gs = 0;
  while (((nw + (1 << gs) - 1) >> gs) > 16) ++gs;
  const float wcell = static_cast<float>(64 << gs);
  const float v = scal[3];
  const Prog p{smc, nw, ns, gs, (nw + (1 << gs) - 1) >> gs, v, wcell, 1.0f / wcell};
  const int cap = scal[23] > 0.5f ? static_cast<int>(scal[23]) : kCapNone;
  const int srd = scal[22] > 0.5f ? static_cast<int>(scal[22]) : sub_rounds;
  const bool init = !kPerRay && scal[24] > 0.5f;
  const size_t plane = static_cast<size_t>(T) * kLanes;
  auto off = [&](int k) { return static_cast<size_t>(tile) * kLanes + k * 32 + lane; };
  auto idx = [&](int k) { return warp * kLanes + k * 32 + lane; };
  // the frame tile of a camera ray (a compacted grid's from the tile map)
  int txi = 0, tyi = 0;
  if (!kPerRay) {
    const int tg = tmap ? tmap[static_cast<size_t>(tile) * 8] : tile;
    const int sb = tg / kBlk, l = tg - sb * kBlk;
    txi = (sb % nsx) * 8 + l % 8;
    tyi = (sb / nsx) * 8 + l / 8;
  }
  // round-0 activity of a camera ray: a whole tile, the camera strictly
  // inside the world (wavefront3.py:956-971)
  const bool init_act = static_cast<float>(txi) < scal[25] && static_cast<float>(tyi) < scal[26] &&
                        scal[0] > 0.0f && scal[0] < v && scal[1] > 0.0f && scal[1] < v &&
                        scal[2] > 0.0f && scal[2] < v;

  // the ray terms, once; the start carry: killed at the cap, outside the
  // world or past the slab
  bool any = false;
  float ct[kRays], cw[kRays], ce[kRays];
  unsigned cf[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const size_t o = off(k);
    const int i = idx(k);
    Ray3 r;
    if (kPerRay) {
      r.ox = rays[o];
      r.oy = rays[plane + o];
      r.oz = rays[2 * plane + o];
      r.dx = rays[3 * plane + o];
      r.dy = rays[4 * plane + o];
      r.dz = rays[5 * plane + o];
      rp[kPOx * kRaysB + i] = r.ox;
      rp[kPOy * kRaysB + i] = r.oy;
      rp[kPOz * kRaysB + i] = r.oz;
    } else {
      r.ox = scal[0];
      r.oy = scal[1];
      r.oz = scal[2];
      const int ln = k * 32 + lane;
      v4::camera_dir(scal, txi * 16 + ln % 16, tyi * 8 + ln / 16, r.dx, r.dy, r.dz);
    }
    r.ivx = v4::inv_dir(r.dx);
    r.ivy = v4::inv_dir(r.dy);
    r.ivz = v4::inv_dir(r.dz);
    const float slx = fmaxf((0.0f - r.ox) * r.ivx, (v - r.ox) * r.ivx);
    const float sly = fmaxf((0.0f - r.oy) * r.ivy, (v - r.oy) * r.ivy);
    const float slz = fmaxf((0.0f - r.oz) * r.ivz, (v - r.oz) * r.ivz);
    r.t_exit = fminf(fminf(slx, fminf(sly, slz)), 4.0f * v + 16.0f);
    rp[kPDx * kRaysB + i] = r.dx;
    rp[kPDy * kRaysB + i] = r.dy;
    rp[kPDz * kRaysB + i] = r.dz;
    rp[kPIvx * kRaysB + i] = r.ivx;
    rp[kPIvy * kRaysB + i] = r.ivy;
    rp[kPIvz * kRaysB + i] = r.ivz;
    rp[kPTex * kRaysB + i] = r.t_exit;
    Carry c;
    if (init) {
      c = Carry{kEpsT, 0.0f, -1.0f, 0, 0, 0, init_act, false};
    } else {
      c.t = ts_in[o];
      c.water = wa_in[o];
      c.wenter = we_in[o];
      const int f = fl_in[o];
      c.act = (f & 1) != 0;
      c.hit = ((f >> 1) & 1) != 0;
      c.axm = (f >> 2) & 7;
      c.stp = (f >> 5) & 0xFFF;
      c.vox = (f >> 17) & 0xFF;
    }
    any = any || c.act;
    const float px = r.ox + r.dx * c.t, py = r.oy + r.dy * c.t, pz = r.oz + r.dz * c.t;
    const bool inw = px >= 0.0f && py >= 0.0f && pz >= 0.0f && px < v && py < v && pz < v;
    c.act = c.act && c.stp < cap && inw && c.t < r.t_exit;
    ct[k] = c.t;
    cw[k] = c.water;
    ce[k] = c.wenter;
    cf[k] = pack(c);
  }
  __pipeline_wait_prior(0);
  cl.sync();  // the cache block in place, and every block of the cluster started

  // a program with no active ray passes its state through
  int parity = 0;
  if (!cluster_or(cl, orf, rank, parity, any)) {
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const size_t o = off(k);
      ts[o] = ts_in[o];
      fl[o] = fl_in[o];
      wa[o] = wa_in[o];
      we[o] = we_in[o];
    }
    if (lane < 8) want[static_cast<size_t>(tile) * 8 + lane] = -1;
    return;
  }

  // the tile's subwindow for the next sub-round, and whether any ray of
  // the program can progress (wavefront3.py:643-681); a thread reads only
  // its own rays' planes, so no barrier guards them
  int tsid = -1, tslot = 0;
  bool match = false;
  auto boundary = [&]() {
    int rmin = kBigi;
    bool base_can[kRays], need[kRays];
    int sv[kRays];
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      base_can[k] = need[k] = false;
      sv[k] = 0;
      if (cf[k] & 1u) {
        const Cls q = classify(p, ray_at<kPerRay>(rp, s, idx(k)), ct[k], true);
        need[k] = !q.gj && q.wslot >= 0 && !q.swj;
        if (need[k] && q.sslot >= 0) rmin = min(rmin, q.s);
        base_can[k] = q.gj || (q.wslot >= 0 && q.swj);
        sv[k] = q.s;
      }
    }
    tsid = none_of(__reduce_min_sync(kFull, rmin));
    const int sl = last_slot(smc + kRowIds * kLanes + kNwc, kNsc, tsid);
    tslot = max(sl, 0);
    match = sl >= 0;
    bool can = false;
#pragma unroll
    for (int k = 0; k < kRays; ++k) can = can || base_can[k] || (need[k] && sv[k] == tsid);
    return cluster_or(cl, orf, rank, parity, can);
  };

  bool go = boundary();
  for (int sr = 0; sr < srd && go; ++sr) {
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const Ray3 r = ray_at<kPerRay>(rp, s, idx(k));
      Carry c = unpack(ct[k], cw[k], ce[k], cf[k]);
      for (int j = 0; c.act && j < sub_steps; ++j)
        if (!step3(p, r, c, tsid, tslot, match, cap)) break;
      if (c.hit && c.vox == 0) c.vox = decode3(p, r, c.t, tslot, match);
      c.t = fminf(c.t, r.t_exit);
      c.act = c.act && c.stp < cap;
      ct[k] = c.t;
      cw[k] = c.water;
      ce[k] = c.wenter;
      cf[k] = pack(c);
    }
    // the boundary after the last sub-round would pick rows nothing reads
    go = sr + 1 < srd && boundary();
  }

  // wants, then the flags word (wavefront3.py:855-882, :1022-1041)
  int wmin = kBigi;
  int dmin[3] = {kBigi, kBigi, kBigi};
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const size_t o = off(k);
    const Ray3 r = ray_at<kPerRay>(rp, s, idx(k));
    const Carry c = unpack(ct[k], cw[k], ce[k], cf[k]);
    int wwid = -1, ch[4] = {-1, -1, -1, -1};
    if (c.act) walk3(p, r, c.t, true, lookahead, wwid, ch);
    const int g = __reduce_min_sync(kFull, or_none(ch[0]));
    if (lane == 0) want[static_cast<size_t>(tile) * 8 + k] = none_of(g);
    wmin = min(wmin, or_none(wwid));
    for (int d = 0; d < 3; ++d) dmin[d] = min(dmin[d], or_none(ch[d + 1]));
    const int sgn = (r.sx ? 1 : 0) | (r.sy ? 2 : 0) | (r.sz ? 4 : 0);
    ts[o] = c.t;
    wa[o] = c.water;
    we[o] = c.wenter;
    fl[o] = (c.act ? 1 : 0) | (c.hit ? 2 : 0) | (c.axm << 2) | (min(c.stp, 0xFFF) << 5) |
            (c.vox << 17) | (sgn << 25);
  }
  const int wm = __reduce_min_sync(kFull, wmin);
  int dm[3];
  for (int d = 0; d < 3; ++d) dm[d] = __reduce_min_sync(kFull, dmin[d]);
  if (lane == 0) {
    int* wr = want + static_cast<size_t>(tile) * 8;
    wr[4] = none_of(wm);
    for (int d = 0; d < 3; ++d) wr[5 + d] = none_of(dm[d]);
  }
}

}  // namespace

// Dynamic shared memory of a block: the cache block, the scalar row, the
// cluster's OR words and the ray planes (10 with per-ray bundles, else 7).
inline int march3_smem_bytes(bool per_ray) {
  return static_cast<int>(sizeof(unsigned)) *
         (kMcWords + kScalPad + 2 * kCluster + (per_ray ? 10 : 7) * kRaysB);
}

// Above the 48 KB default: each instantiation opts in once on each device
// (smem_optin.cuh).
inline cudaError_t march3_optin(bool per_ray, cudaStream_t stream) {
  static SmemOptIn optin[2];
  const void* kernel = per_ray ? reinterpret_cast<const void*>(march3_kernel<true>)
                               : reinterpret_cast<const void*>(march3_kernel<false>);
  return optin[per_ray ? 1 : 0](kernel, march3_smem_bytes(per_ray), stream);
}

#ifndef MARCH3_HOST_TEST
// One launch of the v3 march on `stream`: T/64 clusters of two 1,024-thread
// blocks. scal f32[27]; mc i32[T/64,101,128]; rays f32[6,T,128] or null
// (camera rays); tmap i32[T,8] or null; the state planes in (ts, fl, wa,
// we) and out, each [T,128]; want i32[T,8]. Returns the launch's CUDA error
// (0 = cudaSuccess); the caller raises on anything else.
extern "C" int march3_launch(const float* scal, const int* mc, const float* rays,
                             const int* tmap, const float* ts_in, const int* fl_in,
                             const float* wa_in, const float* we_in, float* ts, int* fl,
                             float* wa, float* we, int* want, int T, int nw, int ns, int nsx,
                             int sub_rounds, int sub_steps, int lookahead, cudaStream_t stream) {
  const cudaError_t e = march3_optin(rays != nullptr, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kernel = rays ? march3_kernel<true> : march3_kernel<false>;
  kernel<<<(T / kBlk) * kCluster, kThreads3, march3_smem_bytes(rays != nullptr), stream>>>(
      scal, mc, rays, tmap, ts_in, fl_in, wa_in, we_in, ts, fl, wa, we, want, T, nw, ns, nsx,
      sub_rounds, sub_steps, lookahead);
  return static_cast<int>(cudaGetLastError());
}
#endif
