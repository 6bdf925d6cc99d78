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
//   * one block of 1,024 threads per program, the whole program on one
//     SM: the block's 101x128-word cache (51,712 bytes, dynamic shared
//     memory above the 48 KB default) is staged once and read by every
//     step; the program-wide "some ray can progress" (`go`, :680), the
//     pass-through test (`any_active`, :988) and so the sub-round count
//     are __syncthreads_or over the block;
//   * warp w owns the two tiles (128-lane rows) 2w and 2w+1, each thread
//     8 rays: ray k of a thread is row 2w + k/4, lanes 32(k%4) + lane. A
//     tile's reductions — the subwindow its rays step in (`tsid`, the
//     smallest cached id a stalled ray needs, :650-653), its window want
//     and prefetch wants (:855-881) — are warp min-reductions over 4 rays
//     a thread, and each 32-lane group's immediate want (:858-867) is one
//     warp reduction at a fixed k.
// The rays' carry between sub-rounds (t, water, water-enter, and the
// active/hit/axes/id/steps word) lives in the output planes, which each
// thread re-reads for its own rays; the flags word is packed at the end.
// Within a sub-round a ray that does not move in a step cannot move later
// in it (its position, and so its classification, stays), so it stops
// stepping there; that changes no result.
//
// What bounds it: the dependent shared-memory bit gathers of every step
// (classify, brick meta, voxel bit) and the divergence of a warp's rays,
// latency rather than bandwidth; each launch streams the state planes
// (36 bytes a ray in and out, plus 24 for per-ray bundles) and re-reads
// them once per sub-round from L2. Built with --fmad=false: every multiply
// and add rounds on its own as in the plain version, so positions on voxel
// faces floor alike.

#include "march4_common.cuh"

namespace {

using v4::kBig;
using v4::kBigIv;
using v4::kCapNone;
using v4::kEpsT;

constexpr int kBlk = 64;          // tiles per program
constexpr int kLanes = 128;       // rays per tile
constexpr int kThreads3 = 1024;
constexpr int kRays = 8;          // rays per thread
constexpr int kNwc = 8;           // cached windows per program
constexpr int kNsc = 16;          // cached subwindows per program
constexpr int kMcRows = 5 + 6 * kNsc;
constexpr int kMcWords = kMcRows * kLanes;
constexpr int kBigi = 0x3FFFFFFF;
constexpr int kScal3 = 27;
// rows of a program's cache block
constexpr int kRowGj = 0, kRowGl = 1, kRowWm = 2, kRowSm = 3, kRowIds = 4;
constexpr int kRowSol = 5, kRowLiq = 5 + kNsc, kRowPid = 5 + 2 * kNsc;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Prog {
  const unsigned* mc;  // the cache block, in shared memory
  int nw, ns, gs, nwg;
  float v;
};

struct Ray3 {
  float ox, oy, oz, dx, dy, dz, ivx, ivy, ivz, t_exit;
  bool sx, sy, sz;
};

// A ray's carry between sub-rounds. In the flags plane during the march:
// bit 0 active, 1 hit, 2-4 exit axes, 5-12 id, 13-31 steps.
struct Carry {
  float t, water, wenter;
  int axm, vox, stp;
  bool act, hit;
};

struct Cls {
  float px, py, pz;
  int vx, vy, vz, w, wslot, s, sslot;
  bool gj, gl, swj, swl;
};

__device__ __forceinline__ unsigned bit_of(const unsigned* row, int word, int sh) {
  word = min(max(word, 0), kLanes - 1);
  return (row[word] >> sh) & 1u;
}

// Everything a step derives from the position at t (wavefront3.py
// :594-641): voxel, window and subwindow ids, global-plane bits, the
// cached window slot and its subwindow bits, the cached subwindow slot
// (the last of equal slots, as the TPU compare chain leaves it).
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
  c.wslot = -1;
  for (int k = 0; k < kNwc; ++k) {
    const int id = static_cast<int>(p.mc[kRowIds * kLanes + k]);
    if (c.w == id && id >= 0) c.wslot = k;
  }
  const int s_loc = ((c.vx >> 4) & 3) + ((c.vy >> 4) & 3) * 4 + ((c.vz >> 4) & 3) * 16;
  const int mbase = max(c.wslot, 0) * 8 + (s_loc >> 5);
  c.swj = bit_of(p.mc + kRowWm * kLanes, mbase, s_loc & 31) != 0;
  c.swl = bit_of(p.mc + kRowWm * kLanes, mbase + 2, s_loc & 31) != 0;
  c.s = (c.vx >> 4) + (c.vy >> 4) * p.ns + (c.vz >> 4) * p.ns * p.ns;
  c.sslot = -1;
  if (need_sslot)
    for (int k = 0; k < kNsc; ++k) {
      const int id = static_cast<int>(p.mc[kRowIds * kLanes + kNwc + k]);
      if (c.s == id && id >= 0) c.sslot = k;
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

// The ray of flat index o (tile `tile`, lane `ln`): a per-ray bundle's, or
// the camera ray of its pixel (the frame tile from the tile map in a
// compacted grid); inverse directions, signs and slab exit.
template <bool kPerRay>
__device__ __forceinline__ Ray3 load_ray(const float* s, const float* rays, const int* tmap,
                                         size_t plane, size_t o, int tile, int ln, int nsx) {
  Ray3 r;
  if (kPerRay) {
    r.ox = rays[o];
    r.oy = rays[plane + o];
    r.oz = rays[2 * plane + o];
    r.dx = rays[3 * plane + o];
    r.dy = rays[4 * plane + o];
    r.dz = rays[5 * plane + o];
  } else {
    r.ox = s[0];
    r.oy = s[1];
    r.oz = s[2];
    const int tg = tmap ? tmap[static_cast<size_t>(tile) * 8] : tile;
    const int sb = tg / kBlk, l = tg - sb * kBlk;
    const int txi = (sb % nsx) * 8 + l % 8, tyi = (sb / nsx) * 8 + l / 8;
    v4::camera_dir(s, txi * 16 + ln % 16, tyi * 8 + ln / 16, r.dx, r.dy, r.dz);
  }
  r.ivx = v4::inv_dir(r.dx);
  r.ivy = v4::inv_dir(r.dy);
  r.ivz = v4::inv_dir(r.dz);
  r.sx = r.dx > 0.0f;
  r.sy = r.dy > 0.0f;
  r.sz = r.dz > 0.0f;
  const float v = s[3];
  const float slx = fmaxf((0.0f - r.ox) * r.ivx, (v - r.ox) * r.ivx);
  const float sly = fmaxf((0.0f - r.oy) * r.ivy, (v - r.oy) * r.ivy);
  const float slz = fmaxf((0.0f - r.oz) * r.ivz, (v - r.oz) * r.ivz);
  r.t_exit = fminf(fminf(slx, fminf(sly, slz)), 4.0f * v + 16.0f);
  return r;
}

__device__ __forceinline__ Carry load_carry(const float* ts, const int* fl, const float* wa,
                                            const float* we, size_t o) {
  Carry c;
  c.t = ts[o];
  c.water = wa[o];
  c.wenter = we[o];
  const unsigned f = static_cast<unsigned>(fl[o]);
  c.act = (f & 1u) != 0;
  c.hit = (f & 2u) != 0;
  c.axm = static_cast<int>((f >> 2) & 7u);
  c.vox = static_cast<int>((f >> 5) & 0xFFu);
  c.stp = static_cast<int>(f >> 13);
  return c;
}

__device__ __forceinline__ void store_carry(float* ts, int* fl, float* wa, float* we, size_t o,
                                            const Carry& c) {
  ts[o] = c.t;
  wa[o] = c.water;
  we[o] = c.wenter;
  fl[o] = static_cast<int>((c.act ? 1u : 0u) | (c.hit ? 2u : 0u) |
                           (static_cast<unsigned>(c.axm) << 2) |
                           (static_cast<unsigned>(c.vox) << 5) |
                           (static_cast<unsigned>(c.stp) << 13));
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
  const int b_loc = ((k.vx >> 2) & 3) + ((k.vy >> 2) & 3) * 4 + ((k.vz >> 2) & 3) * 16;
  const int bbase = tslot * 8 + (b_loc >> 5);
  const unsigned* sm = p.mc + kRowSm * kLanes;
  const bool br_jump = bit_of(sm, bbase, b_loc & 31) != 0;
  const bool br_liq = bit_of(sm, bbase + 2, b_loc & 31) != 0;
  const int l = (k.vx & 15) + (k.vy & 15) * 16 + (k.vz & 15) * 256;
  const bool vsolid = match && bit_of(p.mc + (kRowSol + tslot) * kLanes, l >> 5, l & 31) != 0;
  const bool vliq = match && bit_of(p.mc + (kRowLiq + tslot) * kLanes, l >> 5, l & 31) != 0;

  const bool case1 = k.gj;
  const bool case2 = !k.gj && k.wslot >= 0 && k.swj;
  const bool case3 = !k.gj && k.wslot >= 0 && !k.swj && k.s == tsid;
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
    const float cell = case1 ? static_cast<float>(64 << p.gs) : case2 ? 16.0f : in_br ? 4.0f : 1.0f;
    const float icell = 1.0f / cell;
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
      const float cell = c.gj ? static_cast<float>(64 << p.gs) : 16.0f;
      const float icell = 1.0f / cell;
      const float dt = fminf(axis3(c.px, r.ivx, r.sx, cell, icell),
                             fminf(axis3(c.py, r.ivy, r.sy, cell, icell),
                                   axis3(c.pz, r.ivz, r.sz, cell, icell)));
      if (alive) tw = tw + dt + kEpsT;
    }
  }
}

__device__ __forceinline__ int or_none(int x) { return x >= 0 ? x : kBigi; }
__device__ __forceinline__ int none_of(int m) { return m < kBigi ? m : -1; }

template <bool kPerRay>
__global__ void __launch_bounds__(kThreads3, 1)
march3_kernel(const float* __restrict__ scal, const int* __restrict__ mc,
              const float* __restrict__ rays, const int* __restrict__ tmap,
              const float* __restrict__ ts_in, const int* __restrict__ fl_in,
              const float* __restrict__ wa_in, const float* __restrict__ we_in,
              float* __restrict__ ts, int* __restrict__ fl, float* __restrict__ wa,
              float* __restrict__ we, int* __restrict__ want, int T, int nw, int ns, int nsx,
              int sub_rounds, int sub_steps, int lookahead) {
  extern __shared__ unsigned smc[];
  __shared__ float s[kScal3];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* blk = mc + static_cast<size_t>(blockIdx.x) * kMcWords;
  for (int i = tid; i < kMcWords; i += kThreads3) smc[i] = static_cast<unsigned>(blk[i]);
  if (tid < kScal3) s[tid] = scal[tid];
  __syncthreads();

  int gs = 0;
  while (((nw + (1 << gs) - 1) >> gs) > 16) ++gs;
  const Prog p{smc, nw, ns, gs, (nw + (1 << gs) - 1) >> gs, s[3]};
  const float v = s[3];
  const int cap = s[23] > 0.5f ? static_cast<int>(s[23]) : kCapNone;
  const int srd = s[22] > 0.5f ? static_cast<int>(s[22]) : sub_rounds;
  const bool init = !kPerRay && s[24] > 0.5f;
  const int row0 = blockIdx.x * kBlk + warp * 2;  // this warp's two tiles
  const size_t plane = static_cast<size_t>(T) * kLanes;
  auto tile_of = [&](int k) { return row0 + (k >> 2); };
  auto lane_of = [&](int k) { return (k & 3) * 32 + lane; };
  auto off = [&](int k) { return static_cast<size_t>(tile_of(k)) * kLanes + lane_of(k); };
  auto ray = [&](int k) {
    return load_ray<kPerRay>(s, rays, tmap, plane, off(k), tile_of(k), lane_of(k), nsx);
  };
  // round-0 activity of a camera ray: a whole tile, the camera strictly
  // inside the world (wavefront3.py:956-971)
  auto init_active = [&](int k) {
    const int tg = tmap ? tmap[static_cast<size_t>(tile_of(k)) * 8] : tile_of(k);
    const int sb = tg / kBlk, l = tg - sb * kBlk;
    const int txi = (sb % nsx) * 8 + l % 8, tyi = (sb / nsx) * 8 + l / 8;
    return static_cast<float>(txi) < s[25] && static_cast<float>(tyi) < s[26] && s[0] > 0.0f &&
           s[0] < v && s[1] > 0.0f && s[1] < v && s[2] > 0.0f && s[2] < v;
  };

  // a program with no active ray passes its state through
  bool any = false;
  for (int k = 0; k < kRays; ++k) any |= init ? init_active(k) : (fl_in[off(k)] & 1) != 0;
  if (!__syncthreads_or(any)) {
    for (int k = 0; k < kRays; ++k) {
      const size_t o = off(k);
      ts[o] = ts_in[o];
      fl[o] = fl_in[o];
      wa[o] = wa_in[o];
      we[o] = we_in[o];
    }
    if (lane < 16) want[static_cast<size_t>(row0) * 8 + lane] = -1;
    return;
  }

  // the start carry: killed at the cap, outside the world or past the slab
  for (int k = 0; k < kRays; ++k) {
    const size_t o = off(k);
    const Ray3 r = ray(k);
    Carry c;
    if (init) {
      c = Carry{kEpsT, 0.0f, -1.0f, 0, 0, 0, init_active(k), false};
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
    const float px = r.ox + r.dx * c.t, py = r.oy + r.dy * c.t, pz = r.oz + r.dz * c.t;
    const bool inw = px >= 0.0f && py >= 0.0f && pz >= 0.0f && px < v && py < v && pz < v;
    c.act = c.act && c.stp < cap && inw && c.t < r.t_exit;
    store_carry(ts, fl, wa, we, o, c);
  }

  // each tile's subwindow for the next sub-round, and whether any ray of
  // the program can progress (wavefront3.py:643-681)
  int tsid[2], tslot[2];
  bool match[2];
  auto boundary = [&]() {
    int rmin[2] = {kBigi, kBigi};
    bool base_can[kRays], need[kRays];
    int sv[kRays];
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const Carry c = load_carry(ts, fl, wa, we, off(k));
      const Cls q = classify(p, ray(k), c.t, true);
      need[k] = c.act && !q.gj && q.wslot >= 0 && !q.swj;
      if (need[k] && q.sslot >= 0) rmin[k >> 2] = min(rmin[k >> 2], q.s);
      base_can[k] = c.act && (q.gj || (q.wslot >= 0 && q.swj));
      sv[k] = q.s;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tsid[i] = none_of(__reduce_min_sync(kFull, rmin[i]));
      tslot[i] = 0;
      match[i] = false;
      for (int k = 0; k < kNsc; ++k) {
        const int id = static_cast<int>(smc[kRowIds * kLanes + kNwc + k]);
        if (tsid[i] == id && id >= 0) {
          tslot[i] = k;
          match[i] = true;
        }
      }
    }
    bool can = false;
#pragma unroll
    for (int k = 0; k < kRays; ++k) can |= base_can[k] || (need[k] && sv[k] == tsid[k >> 2]);
    return __syncthreads_or(can) != 0;
  };

  bool go = boundary();
  for (int sr = 0; sr < srd && go; ++sr) {
    for (int k = 0; k < kRays; ++k) {
      const size_t o = off(k);
      const int i = k >> 2;
      const Ray3 r = ray(k);
      Carry c = load_carry(ts, fl, wa, we, o);
      for (int j = 0; c.act && j < sub_steps; ++j)
        if (!step3(p, r, c, tsid[i], tslot[i], match[i], cap)) break;
      if (c.hit && c.vox == 0) c.vox = decode3(p, r, c.t, tslot[i], match[i]);
      c.t = fminf(c.t, r.t_exit);
      c.act = c.act && c.stp < cap;
      store_carry(ts, fl, wa, we, o, c);
    }
    go = boundary();
  }

  // wants, then the flags word (wavefront3.py:855-882, :1022-1041)
  int wmin[2] = {kBigi, kBigi};
  int dmin[2][3] = {{kBigi, kBigi, kBigi}, {kBigi, kBigi, kBigi}};
  for (int k = 0; k < kRays; ++k) {
    const size_t o = off(k);
    const int i = k >> 2;
    const Ray3 r = ray(k);
    const Carry c = load_carry(ts, fl, wa, we, o);
    int wwid, ch[4];
    walk3(p, r, c.t, c.act, lookahead, wwid, ch);
    const int g = __reduce_min_sync(kFull, or_none(ch[0]));
    if (lane == 0) want[static_cast<size_t>(tile_of(k)) * 8 + (k & 3)] = none_of(g);
    wmin[i] = min(wmin[i], or_none(wwid));
    for (int d = 0; d < 3; ++d) dmin[i][d] = min(dmin[i][d], or_none(ch[d + 1]));
    const int sgn = (r.sx ? 1 : 0) | (r.sy ? 2 : 0) | (r.sz ? 4 : 0);
    fl[o] = (c.act ? 1 : 0) | (c.hit ? 2 : 0) | (c.axm << 2) | (min(c.stp, 0xFFF) << 5) |
            (c.vox << 17) | (sgn << 25);
  }
  for (int i = 0; i < 2; ++i) {
    const int wm = __reduce_min_sync(kFull, wmin[i]);
    int dm[3];
    for (int d = 0; d < 3; ++d) dm[d] = __reduce_min_sync(kFull, dmin[i][d]);
    if (lane == 0) {
      int* wr = want + static_cast<size_t>(row0 + i) * 8;
      wr[4] = none_of(wm);
      for (int d = 0; d < 3; ++d) wr[5 + d] = none_of(dm[d]);
    }
  }
}

}  // namespace

// One launch of the v3 march on `stream`: T/64 blocks of 1,024 threads.
// scal f32[27]; mc i32[T/64,101,128]; rays f32[6,T,128] or null (camera
// rays); tmap i32[T,8] or null; the state planes in (ts, fl, wa, we) and
// out, each [T,128]; want i32[T,8]. Returns the launch's CUDA error
// (0 = cudaSuccess); the caller raises on anything else.
extern "C" int march3_launch(const float* scal, const int* mc, const float* rays,
                             const int* tmap, const float* ts_in, const int* fl_in,
                             const float* wa_in, const float* we_in, float* ts, int* fl,
                             float* wa, float* we, int* want, int T, int nw, int ns, int nsx,
                             int sub_rounds, int sub_steps, int lookahead, cudaStream_t stream) {
  const int smem = kMcWords * static_cast<int>(sizeof(unsigned));
  auto kernel = rays ? march3_kernel<true> : march3_kernel<false>;
  // the cache block is above the 48 KB default: opt in once per
  // instantiation (never again, so a CUDA-graph capture sees launches only)
  static bool opted[2] = {false, false};
  if (!opted[rays ? 1 : 0]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted[rays ? 1 : 0] = true;
  }
  kernel<<<T / kBlk, kThreads3, smem, stream>>>(scal, mc, rays, tmap, ts_in, fl_in, wa_in, we_in,
                                                ts, fl, wa, we, want, T, nw, ns, nsx, sub_rounds,
                                                sub_steps, lookahead);
  return static_cast<int>(cudaGetLastError());
}
