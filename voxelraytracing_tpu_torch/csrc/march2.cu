// The v2 fused wavefront march for Hopper (sm_90a): one service round of
// the v1 brick/voxel DDA over a frame of 16x8-pixel tiles (128 rays a
// tile, 256 tiles a program), each ray stepping only through the windows
// and bricks that the host put into its program's cache, and a want-list
// per tile for the host's next round.
//
// Replaces the TPU kernel voxelraytracing_tpu/ops/wavefront2.py:
// _march_kernel (launched by _march through pl.pallas_call). Plain version:
// ops/wavefront2.py march2_ref; the host round loop that serves the wants
// is ops/wavefront2.py _trace_frame.
//
// The scopes of the TPU kernel's reductions decide which rays step, so the
// design keeps each of them:
//   * the program (256 tiles, 32,768 rays) runs its 12-step sub-rounds
//     while ANY of its rays can step (`go`, :421-423, :444), and every ray
//     of a running program takes the steps, also one that cannot march: a
//     level-1 ray whose position left its brick is demoted, and a ray past
//     its slab exit retires, as soon as any tile of its program steps.
//     A round is one launch: a program is a cluster of eight 1,024-thread
//     blocks on eight SMs, and each `go` is a __syncthreads_or in each
//     block whose results the blocks write into each other's shared
//     memory (DSMEM) across one cluster barrier;
//   * warp w of block b owns tile 32b + w of the program, each thread 4
//     rays: ray k of a thread is lanes 32k + lane. The tile's window
//     (`twid`, the smallest cached window a brick-level ray stands in,
//     :210-214) and its wanted window (:387-391) are warp min-reductions
//     over 4 rays a thread; the 8 brick slots are mins over aligned
//     16-lane groups (:232-235, group 2k + lane / 16), "first group j
//     wins" fixes each ray's slot (:244-245), and the 16 brick wants are
//     mins over 8-lane groups (:398-404);
//   * the step reads the tile's window rows and each group's brick content
//     (:246-257) straight from the program's cache in shared memory, by
//     the tile's window slot and each group's brick slot.
// What bounds it: the state planes cross device memory once a round (40
// bytes a ray each way, 12 of directions), and the instructions of each
// boundary and each step with their dependent shared-memory reads. On an
// H100 about 15 clusters of eight fit at once, so a 1080p round (64
// programs) runs in five waves (chip_profile.py). So:
//   * the ten state planes and the directions are read once into shared
//     memory, stay there across the sub-rounds, and are written once; an
//     inactive ray takes no step (its step changes nothing);
//   * a ray steps only while a step changes it: a step is a function of
//     the ray's state and its tile's rows, so a step that leaves its steps,
//     level and activity as they were leaves all of it, and so would every
//     later step of the sub-round (as the plain version's working set);
//   * a cached brick's slot (the last of equal ids) is a lookup in a
//     128-entry hash of the program's 64 brick ids, built once a launch.
// Built with --fmad=false and in the plain version's op order: positions
// o + d*t land on voxel faces, where one ulp flips floor().

#include "march4_common.cuh"
#include "smem_optin.cuh"

#include <cooperative_groups.h>

#ifndef DYN_SMEM  // the host stand-in (tests/torch_cuda_host.h) gives each block its own
#define DYN_SMEM(name) extern __shared__ __align__(16) unsigned char name[]
#endif

namespace {

namespace cg = cooperative_groups;
using v4::kBig;
using v4::kBigIv;
using v4::kEpsT;

constexpr int kBlk2 = 256;        // tiles per program
constexpr int kLanes = 128;       // rays per tile
constexpr int kCluster2 = 8;      // blocks per program
constexpr int kThreads2 = 1024;   // a block: 32 warps, a tile each
constexpr int kTilesB = kBlk2 / kCluster2;
constexpr int kRaysB = kTilesB * kLanes;
constexpr int kRays = 4;          // rays per thread
constexpr int kNw = 8;            // cached windows per program
constexpr int kNb = 64;           // cached bricks per program
constexpr int kHash = 128;        // brick-id hash entries
constexpr int kWantB = 16;        // brick wants per tile
constexpr int kSubSteps = 12;     // march steps a sub-round
constexpr int kBigi = 0x3FFFFFFF;
constexpr unsigned kFull = 0xFFFFFFFFu;

// The ten state planes of a frame, in the order of the JAX kernel.
struct Planes {
  float* t;
  int* act;
  int* hit;
  int* lvl;
  int* cb;
  int* ax;
  int* vox;
  float* wat;
  float* wen;
  int* stp;
};

// A block's shared memory: its program's context and cache, each tile's
// brick-slot groups, and the state planes and directions of its 4,096
// rays.
struct Smem2 {
  unsigned gj[kLanes], gl[kLanes];  // global jumpable / all-liquid window bits
  int wid[kNw], bid[kNb];           // cached window and brick ids
  int hkey[kHash], hval[kHash];     // brick id -> its last slot
  unsigned bwc[kNw * kLanes], lwc[kNw * kLanes];  // cached windows' descend, liquid rows
  unsigned cnt[kNb * 16];           // cached bricks' content
  float scal[8];
  int orf[2 * kCluster2];           // the cluster's OR words
  int grp[kTilesB * 8];             // each tile's groups: (brick << 6) | slot, kBigi none
  float t[kRaysB], wat[kRaysB], wen[kRaysB], dx[kRaysB], dy[kRaysB], dz[kRaysB];
  int act[kRaysB], hit[kRaysB], lvl[kRaysB], cb[kRaysB], ax[kRaysB], vox[kRaysB],
      stp[kRaysB];
};

struct State {
  float t, wat, wen;
  int lvl, cb, ax, vox, stp;
  bool act, hit;
};

struct Ray2 {
  float dx, dy, dz, ivx, ivy, ivz, t_exit;
  bool sx, sy, sz;
};

// What the steps read of the program beside the cache: the scalar row
// (ox, oy, oz, n_liquid, v) and the world's edges in windows and bricks.
struct Ctx {
  float ox, oy, oz, v;
  int n_liquid, nb, bg_side;
};

__device__ __forceinline__ State load_state(const Smem2& sm, int i) {
  State s;
  s.t = sm.t[i];
  s.act = sm.act[i] != 0;
  s.hit = sm.hit[i] != 0;
  s.lvl = sm.lvl[i];
  s.cb = sm.cb[i];
  s.ax = sm.ax[i];
  s.vox = sm.vox[i];
  s.wat = sm.wat[i];
  s.wen = sm.wen[i];
  s.stp = sm.stp[i];
  return s;
}

__device__ __forceinline__ void store_state(Smem2& sm, int i, const State& s) {
  sm.t[i] = s.t;
  sm.act[i] = s.act ? 1 : 0;
  sm.hit[i] = s.hit ? 1 : 0;
  sm.lvl[i] = s.lvl;
  sm.cb[i] = s.cb;
  sm.ax[i] = s.ax;
  sm.vox[i] = s.vox;
  sm.wat[i] = s.wat;
  sm.wen[i] = s.wen;
  sm.stp[i] = s.stp;
}

// Inverse direction, signs and slab exit of a direction.
__device__ __forceinline__ Ray2 ray_of(const Ctx& c, float dx, float dy, float dz) {
  Ray2 r;
  r.dx = dx;
  r.dy = dy;
  r.dz = dz;
  r.ivx = v4::inv_dir(r.dx);
  r.ivy = v4::inv_dir(r.dy);
  r.ivz = v4::inv_dir(r.dz);
  r.sx = r.dx > 0.0f;
  r.sy = r.dy > 0.0f;
  r.sz = r.dz > 0.0f;
  const float slx = fmaxf((0.0f - c.ox) * r.ivx, (c.v - c.ox) * r.ivx);
  const float sly = fmaxf((0.0f - c.oy) * r.ivy, (c.v - c.oy) * r.ivy);
  const float slz = fmaxf((0.0f - c.oz) * r.ivz, (c.v - c.oz) * r.ivz);
  r.t_exit = fminf(fminf(slx, fminf(sly, slz)), 4.0f * c.v + 16.0f);
  return r;
}

// Brick coordinates of the position at t and the window id they lie in.
struct Pos {
  float px, py, pz;
  int bx, by, bz, wflat;
};

__device__ __forceinline__ Pos pos_at(const Ctx& c, float dx, float dy, float dz, float t) {
  Pos q;
  q.px = c.ox + dx * t;
  q.py = c.oy + dy * t;
  q.pz = c.oz + dz * t;
  q.bx = static_cast<int>(floorf(q.px * 0.25f));
  q.by = static_cast<int>(floorf(q.py * 0.25f));
  q.bz = static_cast<int>(floorf(q.pz * 0.25f));
  // unsigned arithmetic wraps as the plain version's int32 does
  q.wflat = static_cast<int>(static_cast<unsigned>(q.bx >> 4) +
                             static_cast<unsigned>(q.by >> 4) * c.nb +
                             static_cast<unsigned>(q.bz >> 4) * c.nb * c.nb);
  return q;
}

// Global jumpable (or all-liquid) bit of window `wflat` (:153-159).
__device__ __forceinline__ bool win_bit(const unsigned* plane, int wflat) {
  const int word = min(max(wflat >> 5, 0), kLanes - 1);
  return ((plane[word] >> (wflat & 31)) & 1u) != 0;
}

// The window cache slot of x: the last of equal ids, -1 if none or x < 0.
__device__ __forceinline__ int win_slot(const int* wid, int x) {
  int slot = -1;
#pragma unroll
  for (int k = 0; k < kNw; k += 4) {
    const int4 q = *reinterpret_cast<const int4*>(wid + k);
    slot = q.x == x ? k : slot;
    slot = q.y == x ? k + 1 : slot;
    slot = q.z == x ? k + 2 : slot;
    slot = q.w == x ? k + 3 : slot;
  }
  return x >= 0 ? slot : -1;
}

__device__ __forceinline__ int brick_hash(int id) {
  return static_cast<int>((static_cast<unsigned>(id) * 2654435761u) >> 25);
}

// The content-cache index of a brick: the last matching slot, -1 if none
// (:161-167), from the hash (at most 64 of its 128 entries are used, so a
// probe ends at an empty one).
__device__ __forceinline__ int cidx_of(const Smem2& sm, int brick) {
  if (brick < 0) return -1;
  for (int h = brick_hash(brick);; h = (h + 1) & (kHash - 1)) {
    const int k = sm.hkey[h];
    if (k == brick) return sm.hval[h];
    if (k == -1) return -1;
  }
}

// DDA distances to the next cell planes (:169-184).
__device__ __forceinline__ float axis2(float pc, float ivc, bool sgn, float cell, float icell) {
  const float q = pc * icell;
  const float b = sgn ? floorf(q) + 1.0f : ceilf(q) - 1.0f;
  const float dt = (b * cell - pc) * ivc;
  return fabsf(ivc) >= kBigIv ? kBig : dt;
}

__device__ __forceinline__ float dda3(const Ray2& r, float px, float py, float pz, float cell,
                                      float icell, int& axm) {
  const float dtx = axis2(px, r.ivx, r.sx, cell, icell);
  const float dty = axis2(py, r.ivy, r.sy, cell, icell);
  const float dtz = axis2(pz, r.ivz, r.sz, cell, icell);
  const float dt = fminf(dtx, fminf(dty, dtz));
  axm = (dtx <= dt ? 1 : 0) | (dty <= dt ? 2 : 0) | (dtz <= dt ? 4 : 0);
  return dt;
}

// One step of the brick phase then the voxel phase (:265-370). The tile's
// rows: its window `twid` at cache slot `kt` (-1: not cached, zero rows),
// and its 8 brick-slot groups `grp`.
__device__ __forceinline__ void step(const Ctx& c, const Smem2& sm, const Ray2& r, int twid,
                                     int kt, const int* grp, State& s, int& sidx) {
  const int pre_lvl = s.lvl, pre_cb = s.cb;
  const float t0 = s.t;
  const Pos q = pos_at(c, r.dx, r.dy, r.dz, t0);
  const int lin = (q.bx & 15) + (q.by & 15) * 16 + (q.bz & 15) * 256;
  const int widx = lin >> 5;
  const int vx = static_cast<int>(floorf(q.px));
  const int vy = static_cast<int>(floorf(q.py));
  const int vz = static_cast<int>(floorf(q.pz));
  const int vlin = (vx & 3) + (vy & 3) * 4 + (vz & 3) * 16;
  const unsigned word = kt >= 0 ? sm.bwc[kt * kLanes + widx] : 0u;
  const unsigned lword = kt >= 0 ? sm.lwc[kt * kLanes + widx] : 0u;
  const int g = grp[max(sidx, 0)];
  const unsigned vword = g < kBigi ? sm.cnt[(g & 63) * 16 + (vlin >> 2)] : 0u;

  // brick phase (ops/wavefront.py:_post_brick)
  bool active = s.act && (t0 < r.t_exit);
  const int fb = static_cast<int>(static_cast<unsigned>(q.bx) +
                                  static_cast<unsigned>(q.by) * c.bg_side +
                                  static_cast<unsigned>(q.bz) * c.bg_side * c.bg_side);
  if (active && s.lvl == 1 && fb != s.cb) {
    s.lvl = 0;
    sidx = -1;
  }
  const bool bl = active && s.lvl == 0;
  const bool g_jump = win_bit(sm.gj, q.wflat);
  const bool g_liq = win_bit(sm.gl, q.wflat);
  const bool in_tile = q.wflat == twid;
  const bool match_b = bl && (g_jump || in_tile);
  const int shift = lin & 31;
  const bool descend = !g_jump && in_tile && ((word >> shift) & 1u) != 0;
  const bool liq_bit = ((lword >> shift) & 1u) != 0;
  const bool brick_liq = g_jump ? g_liq : liq_bit;
  if (match_b && descend) {
    s.lvl = 1;
    s.cb = fb;
    sidx = -1;
  }
  const bool bstep = match_b && !descend;
  const bool leave_b = bstep && s.wen >= 0.0f && !brick_liq;
  s.wat = s.wat + (leave_b ? t0 - s.wen : 0.0f);
  if (leave_b) s.wen = -1.0f;
  if (bstep && brick_liq && s.wen < 0.0f) s.wen = t0;
  if (bstep) {
    int axm;
    const float dt = g_jump ? dda3(r, q.px, q.py, q.pz, 64.0f, 1.0f / 64.0f, axm)
                            : dda3(r, q.px, q.py, q.pz, 4.0f, 0.25f, axm);
    s.t = t0 + dt + kEpsT;
    s.ax = axm;
  }
  s.stp += match_b ? 1 : 0;

  // voxel phase (ops/wavefront.py:_post_voxel)
  const float t1 = s.t;
  const float px2 = c.ox + r.dx * t1;
  const float py2 = c.oy + r.dy * t1;
  const float pz2 = c.oz + r.dz * t1;
  const bool match_v = active && s.lvl == 1 && sidx >= 0 && pre_lvl == 1 && pre_cb == s.cb;
  const int vx2 = static_cast<int>(floorf(px2));
  const int vy2 = static_cast<int>(floorf(py2));
  const int vz2 = static_cast<int>(floorf(pz2));
  const int vlin2 = (vx2 & 3) + (vy2 & 3) * 4 + (vz2 & 3) * 16;
  const int rid = static_cast<int>((vword >> ((vlin2 & 3) * 8)) & 0xFFu);
  const bool is_air = rid == 0;
  const bool is_liq = rid >= 1 && rid <= c.n_liquid;
  const bool solid = match_v && !is_air && !is_liq;
  s.hit = s.hit || solid;
  active = active && !solid;
  if (solid) s.vox = rid;
  const bool leave_v = match_v && s.wen >= 0.0f && !is_liq;
  s.wat = s.wat + (leave_v ? t1 - s.wen : 0.0f);
  if (leave_v) s.wen = -1.0f;
  if (match_v && is_liq && s.wen < 0.0f) s.wen = t1;
  if (match_v && (is_air || is_liq)) {
    int axm;
    const float dt = dda3(r, px2, py2, pz2, 1.0f, 1.0f, axm);
    s.t = t1 + dt + kEpsT;
    s.ax = axm;
  }
  s.stp += match_v ? 1 : 0;
  s.act = active;
}

// x ORed over the program's eight blocks: each block's __syncthreads_or
// goes into word `rank` of every block's set `parity` (DSMEM), read after
// the cluster barrier. The sets alternate: a block writes set `parity`
// again two calls later, after the barrier between, which every reader of
// this call has reached.
__device__ __forceinline__ bool cluster_or(const cg::cluster_group& cl, int* orf, int rank,
                                           int& parity, bool x) {
  const int b = __syncthreads_or(x);
  if (threadIdx.x < kCluster2)
    cl.map_shared_rank(orf, threadIdx.x)[parity * kCluster2 + rank] = b;
  cl.sync();
  bool r = false;
#pragma unroll
  for (int j = 0; j < kCluster2; ++j) r = r || orf[parity * kCluster2 + j] != 0;
  parity ^= 1;
  return r;
}

// One round of every program: its sub-rounds while it can march, then the
// wants. A tile with no active ray passes its planes through as they were.
__global__ void __cluster_dims__(kCluster2, 1, 1) __launch_bounds__(kThreads2, 1)
march2_kernel(const float* __restrict__ scal, const float* __restrict__ dx,
              const float* __restrict__ dy, const float* __restrict__ dz,
              const int* __restrict__ gj, const int* __restrict__ gl,
              const int* __restrict__ wid, const int* __restrict__ bwc,
              const int* __restrict__ lwc, const int* __restrict__ bid,
              const int* __restrict__ cnt, Planes in, Planes out, int* __restrict__ want_win,
              int* __restrict__ want_br, int nb, int bg_side, int sub_rounds) {
  DYN_SMEM(dsm);
  Smem2& sm = *reinterpret_cast<Smem2*>(dsm);
  const cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int prog = blockIdx.x / kCluster2;
  const int tile = prog * kBlk2 + rank * kTilesB + warp;  // this warp's tile
  int* grp = sm.grp + warp * 8;
  auto off = [&](int k) { return static_cast<size_t>(tile) * kLanes + k * 32 + lane; };
  auto idx = [&](int k) { return warp * kLanes + k * 32 + lane; };

  // the program's context and cache; the planes and directions, once
  if (tid < kLanes) {
    sm.gj[tid] = static_cast<unsigned>(gj[tid]);
    sm.gl[tid] = static_cast<unsigned>(gl[tid]);
    sm.hkey[tid] = -1;
  }
  if (tid < kNw) sm.wid[tid] = wid[prog * kNw + tid];
  if (tid < kNb) sm.bid[tid] = bid[prog * kNb + tid];
  if (tid < 8) sm.scal[tid] = scal[tid];
  const size_t cache = static_cast<size_t>(prog) * kNw * kLanes;
  sm.bwc[tid] = static_cast<unsigned>(bwc[cache + tid]);
  sm.lwc[tid] = static_cast<unsigned>(lwc[cache + tid]);
  sm.cnt[tid] = static_cast<unsigned>(cnt[static_cast<size_t>(prog) * kNb * 16 + tid]);
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const size_t o = off(k);
    const int i = idx(k);
    sm.t[i] = in.t[o];
    sm.act[i] = in.act[o];
    sm.hit[i] = in.hit[o];
    sm.lvl[i] = in.lvl[o];
    sm.cb[i] = in.cb[o];
    sm.ax[i] = in.ax[o];
    sm.vox[i] = in.vox[o];
    sm.wat[i] = in.wat[o];
    sm.wen[i] = in.wen[o];
    sm.stp[i] = in.stp[o];
    sm.dx[i] = dx[o];
    sm.dy[i] = dy[o];
    sm.dz[i] = dz[o];
  }
  __syncthreads();
  // the brick-id hash: each id's last slot, inserted in parallel
  if (tid < kNb) {
    const int id = sm.bid[tid];
    bool last = id >= 0;
    for (int j = tid + 1; j < kNb; ++j) last = last && sm.bid[j] != id;
    if (last) {
      int h = brick_hash(id);
      while (atomicCAS(&sm.hkey[h], -1, id) != -1) h = (h + 1) & (kHash - 1);
      sm.hval[h] = tid;
    }
  }
  cl.sync();  // the hash in place, and every block of the cluster started

  const Ctx c{sm.scal[0], sm.scal[1], sm.scal[2], sm.scal[4],
              static_cast<int>(sm.scal[3]), nb, bg_side};
  bool tact = false;
#pragma unroll
  for (int k = 0; k < kRays; ++k) tact = tact || sm.act[idx(k)] != 0;
  const bool tile_any = __any_sync(kFull, tact);

  // The tile rows (:186-263) from the state: the tile's window `twid` and
  // its slot `kt`, the brick-slot groups, each ray's slot (plus one, 4
  // bits a ray, in `sp`), and whether some ray of the program can march.
  int twid = -1, kt = -1, parity = 0;
  unsigned sp = 0;
  auto boundary = [&]() {
    int wmin = kBigi;
    int comb[kRays], wf[kRays];
    bool gjb[kRays], vm[kRays];
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const int i = idx(k);
      wf[k] = 0;
      gjb[k] = vm[k] = false;
      comb[k] = kBigi;
      if (sm.act[i] != 0) {
        const Pos q = pos_at(c, sm.dx[i], sm.dy[i], sm.dz[i], sm.t[i]);
        wf[k] = q.wflat;
        gjb[k] = win_bit(sm.gj, q.wflat);
        if (sm.lvl[i] == 0 && !gjb[k] && win_slot(sm.wid, q.wflat) >= 0)
          wmin = min(wmin, q.wflat);
        if (sm.lvl[i] == 1) {
          const int ci = cidx_of(sm, sm.cb[i]);
          vm[k] = ci >= 0;
          if (vm[k]) comb[k] = static_cast<int>((static_cast<unsigned>(sm.cb[i]) << 6) | ci);
        }
      }
    }
    wmin = __reduce_min_sync(kFull, wmin);
    twid = wmin < kBigi ? wmin : -1;
    kt = win_slot(sm.wid, twid);
    int g[8];
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      g[2 * k] = __reduce_min_sync(kFull, lane < 16 ? comb[k] : kBigi);
      g[2 * k + 1] = __reduce_min_sync(kFull, lane >= 16 ? comb[k] : kBigi);
    }
    if (lane == 0)
      for (int j = 0; j < 8; ++j) grp[j] = g[j];
    bool can = false;
    sp = 0;
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const int i = idx(k);
      const int cbk = sm.cb[i], lv = sm.lvl[i];
      int sidx = -1;
      if (vm[k])
        for (int j = 7; j >= 0; --j)
          if (cbk == (g[j] < kBigi ? g[j] >> 6 : -1)) sidx = j;
      sp |= static_cast<unsigned>(sidx + 1) << (4 * k);
      can = can || (sm.act[i] != 0 &&
                    ((lv == 0 && (gjb[k] || wf[k] == twid)) || (lv == 1 && sidx >= 0)));
    }
    // the barrier inside orders the group words before the steps read them
    return cluster_or(cl, sm.orf, rank, parity, can);
  };

  bool go = boundary();
  for (int sr = 0; sr < sub_rounds && go; ++sr) {
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const int i = idx(k);
      if (sm.act[i] == 0) continue;  // an inactive ray's step changes nothing
      State s = load_state(sm, i);
      const Ray2 r = ray_of(c, sm.dx[i], sm.dy[i], sm.dz[i]);
      int sidx = static_cast<int>((sp >> (4 * k)) & 15u) - 1;
      for (int j = 0; j < kSubSteps; ++j) {
        const int stp0 = s.stp, lvl0 = s.lvl;
        step(c, sm, r, twid, kt, grp, s, sidx);
        if (!s.act || (s.stp == stp0 && s.lvl == lvl0)) break;
      }
      store_state(sm, i, s);
    }
    // the boundary after the last sub-round would pick rows nothing reads
    go = sr + 1 < sub_rounds && boundary();
  }

  // the tile's wants (:372-405): its smallest uncached window a brick-level
  // ray stands in, and the smallest uncached brick of each 8-lane group
  int wmin = kBigi;
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int i = idx(k);
    int wk = kBigi, bk = kBigi;
    if (sm.act[i] != 0) {
      const Pos q = pos_at(c, sm.dx[i], sm.dy[i], sm.dz[i], sm.t[i]);
      if (sm.lvl[i] == 0 && !win_bit(sm.gj, q.wflat) && win_slot(sm.wid, q.wflat) < 0)
        wk = q.wflat;
      if (sm.lvl[i] == 1 && cidx_of(sm, sm.cb[i]) < 0) bk = sm.cb[i];
    }
    wmin = min(wmin, wk);
    for (int sh = 1; sh <= 4; sh <<= 1) bk = min(bk, __shfl_xor_sync(kFull, bk, sh));
    if ((lane & 7) == 0)
      want_br[static_cast<size_t>(tile) * kWantB + 4 * k + (lane >> 3)] = bk < kBigi ? bk : -1;
  }
  wmin = __reduce_min_sync(kFull, wmin);
  if (lane == 0) want_win[tile] = wmin < kBigi ? wmin : -1;

  // the planes, once; a tile with an active ray holds active and hit as 0/1
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const size_t o = off(k);
    const int i = idx(k);
    out.t[o] = sm.t[i];
    out.act[o] = tile_any ? (sm.act[i] != 0 ? 1 : 0) : sm.act[i];
    out.hit[o] = tile_any ? (sm.hit[i] != 0 ? 1 : 0) : sm.hit[i];
    out.lvl[o] = sm.lvl[i];
    out.cb[o] = sm.cb[i];
    out.ax[o] = sm.ax[i];
    out.vox[o] = sm.vox[i];
    out.wat[o] = sm.wat[i];
    out.wen[o] = sm.wen[i];
    out.stp[o] = sm.stp[i];
  }
}

}  // namespace

constexpr int kMarch2Smem = static_cast<int>(sizeof(Smem2));

// Above the 48 KB default: the kernel opts in once on each device
// (smem_optin.cuh).
inline cudaError_t march2_optin(cudaStream_t stream) {
  static SmemOptIn optin;
  return optin(reinterpret_cast<const void*>(march2_kernel), kMarch2Smem, stream);
}

#ifndef MARCH2_HOST_TEST
// One round of the v2 march: one launch on `stream` of T/256 clusters of
// eight 1,024-thread blocks. Returns a cudaError_t (0 = cudaSuccess).
extern "C" int march2_launch(const float* scal, const float* dx, const float* dy,
                             const float* dz, const int* gj, const int* gl, const int* wid,
                             const int* bwc, const int* lwc, const int* bid, const int* cnt,
                             float* t_in, int* act_in, int* hit_in, int* lvl_in, int* cb_in,
                             int* ax_in, int* vox_in, float* wat_in, float* wen_in, int* stp_in,
                             float* t, int* act, int* hit, int* lvl, int* cb, int* ax, int* vox,
                             float* wat, float* wen, int* stp, int* want_win, int* want_br,
                             int T, int nb, int bg_side, int sub_rounds, cudaStream_t stream) {
  const Planes in{t_in, act_in, hit_in, lvl_in, cb_in, ax_in, vox_in, wat_in, wen_in, stp_in};
  const Planes out{t, act, hit, lvl, cb, ax, vox, wat, wen, stp};
  const cudaError_t e = march2_optin(stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  march2_kernel<<<(T / kBlk2) * kCluster2, kThreads2, kMarch2Smem, stream>>>(
      scal, dx, dy, dz, gj, gl, wid, bwc, lwc, bid, cnt, in, out, want_win, want_br, nb,
      bg_side, sub_rounds);
  return static_cast<int>(cudaGetLastError());
}
#endif
