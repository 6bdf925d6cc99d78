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
//     A frame is therefore 1 + sub_rounds launches over all tiles: the
//     first ORs each program's starting `go` into a flag; sub-round s
//     steps the tiles whose program's flag s is set and ORs the program's
//     flag s + 1 from the state it leaves (the tile rows are a pure
//     function of the state and the caches, so each launch recomputes
//     them); the last also writes the wants;
//   * one 128-thread block per tile, a ray a thread: the tile's window
//     (`twid`, the smallest cached window a brick-level ray stands in,
//     :210-214) and its wanted window (:387-391) are block min-reductions;
//     the 8 brick slots are butterfly mins over aligned 16-lane groups
//     (:232-235), "first group j wins" fixes each ray's slot (:244-245),
//     and the 16 brick wants are mins over 8-lane groups (:398-404): warp
//     shuffles;
//   * the tile's composed rows — the window's descend and liquid rows and
//     the 8-slot content row, 16 words of the brick cached at each group's
//     slot (:246-257) — go to shared memory, read by every step.
// Built with --fmad=false and in the plain version's op order: positions
// o + d*t land on voxel faces, where one ulp flips floor().
//
// What bounds it: the state planes, read and written once a sub-round
// (40 bytes a ray each way, plus the directions), and the dependent
// shared-memory reads of every step; a ray whose program runs takes all 12
// steps of the sub-round, as on the TPU.

#include "march4_common.cuh"

namespace {

using v4::kBig;
using v4::kBigIv;
using v4::kEpsT;

constexpr int kBlk2 = 256;        // tiles per program
constexpr int kLanes = 128;       // rays per tile
constexpr int kNw = 8;            // cached windows per program
constexpr int kNb = 64;           // cached bricks per program
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

struct State {
  float t, wat, wen;
  int lvl, cb, ax, vox, stp;
  bool act, hit;
};

struct Ray2 {
  float dx, dy, dz, ivx, ivy, ivz, t_exit;
  bool sx, sy, sz;
};

// What one launch reads of its program: the scalar row (ox, oy, oz,
// n_liquid, v), the global window bits and the cache ids, in shared memory.
struct Ctx {
  float ox, oy, oz, v;
  int n_liquid, nb, bg_side;
  const unsigned* gj;  // [128]
  const unsigned* gl;  // [128]
  const int* wid;      // [8]
  const int* bid;      // [64]
};

__device__ __forceinline__ State load_state(const Planes& p, size_t o) {
  State s;
  s.t = p.t[o];
  s.act = p.act[o] != 0;
  s.hit = p.hit[o] != 0;
  s.lvl = p.lvl[o];
  s.cb = p.cb[o];
  s.ax = p.ax[o];
  s.vox = p.vox[o];
  s.wat = p.wat[o];
  s.wen = p.wen[o];
  s.stp = p.stp[o];
  return s;
}

__device__ __forceinline__ void store_state(const Planes& p, size_t o, const State& s) {
  p.t[o] = s.t;
  p.act[o] = s.act ? 1 : 0;
  p.hit[o] = s.hit ? 1 : 0;
  p.lvl[o] = s.lvl;
  p.cb[o] = s.cb;
  p.ax[o] = s.ax;
  p.vox[o] = s.vox;
  p.wat[o] = s.wat;
  p.wen[o] = s.wen;
  p.stp[o] = s.stp;
}

__device__ __forceinline__ Ray2 load_ray(const Ctx& c, const float* dx, const float* dy,
                                         const float* dz, size_t o) {
  Ray2 r;
  r.dx = dx[o];
  r.dy = dy[o];
  r.dz = dz[o];
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

__device__ __forceinline__ Pos pos_at(const Ctx& c, const Ray2& r, float t) {
  Pos q;
  q.px = c.ox + r.dx * t;
  q.py = c.oy + r.dy * t;
  q.pz = c.oz + r.dz * t;
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

__device__ __forceinline__ bool win_cached(const Ctx& c, int wflat) {
  bool m = false;
  for (int k = 0; k < kNw; ++k) m = m || (wflat == c.wid[k] && c.wid[k] >= 0);
  return m;
}

// The content-cache index of a brick: the last matching slot, -1 if none
// (:161-167).
__device__ __forceinline__ int cidx_of(const Ctx& c, int brick) {
  int ci = -1;
  for (int k = 0; k < kNb; ++k)
    if (brick == c.bid[k] && c.bid[k] >= 0) ci = k;
  return ci;
}

// Minimum of x over the block's 128 threads. `red` is 4 words of shared
// memory; the leading barrier lets earlier readers of it (and of the
// group-min words written after a call) finish first.
__device__ __forceinline__ int block_min(int x, int* red) {
  x = __reduce_min_sync(kFull, x);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  return min(min(red[0], red[1]), min(red[2], red[3]));
}

// Shared memory of a tile block.
struct Smem {
  unsigned gj[kLanes], gl[kLanes], bw[kLanes], lw[kLanes], slot[kLanes];
  int wid[kNw], bid[kNb], comb[8], red[4];
};

// The tile rows (:186-263) from the state: the tile's window `twid`, each
// ray's brick slot `sidx` and whether it can march; with `rows`, the
// composed window rows and content row land in shared memory.
__device__ __forceinline__ void boundary(const Ctx& c, Smem& sm, const Ray2& r, const State& s,
                                         const int* bwc, const int* lwc, const int* cnt,
                                         bool rows, int& twid, int& sidx, bool& can) {
  const int lane = threadIdx.x;
  const Pos q = pos_at(c, r, s.t);
  const bool g_jump = win_bit(c.gj, q.wflat);
  const bool wcached = win_cached(c, q.wflat);
  const int wkey = (s.act && s.lvl == 0 && !g_jump && wcached) ? q.wflat : kBigi;
  const int wmin = block_min(wkey, sm.red);
  twid = wmin < kBigi ? wmin : -1;

  const int cidx = cidx_of(c, s.cb);
  const bool vmask = s.act && s.lvl == 1 && cidx >= 0;
  int comb = vmask ? (s.cb << 6) | cidx : kBigi;
  for (int sh = 1; sh <= 8; sh <<= 1) comb = min(comb, __shfl_xor_sync(kFull, comb, sh));
  if ((lane & 15) == 0) sm.comb[lane >> 4] = comb;
  __syncthreads();
  sidx = -1;
  for (int j = 0; j < 8; ++j) {
    const int cj = sm.comb[j];
    const int bsel = cj < kBigi ? cj >> 6 : -1;
    if (vmask && s.cb == bsel && sidx < 0) sidx = j;
  }
  if (rows) {
    int kt = -1;
    for (int k = 0; k < kNw; ++k)
      if (twid == c.wid[k] && c.wid[k] >= 0) kt = k;
    sm.bw[lane] = kt >= 0 ? static_cast<unsigned>(bwc[kt * kLanes + lane]) : 0u;
    sm.lw[lane] = kt >= 0 ? static_cast<unsigned>(lwc[kt * kLanes + lane]) : 0u;
    const int cj = sm.comb[lane >> 4];
    const int csel = cj < kBigi ? cj & 63 : -1;
    sm.slot[lane] = csel >= 0 ? static_cast<unsigned>(cnt[csel * 16 + (lane & 15)]) : 0u;
    __syncthreads();
  }
  can = s.act && ((s.lvl == 0 && (g_jump || q.wflat == twid)) || (s.lvl == 1 && sidx >= 0));
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

// One step of the brick phase then the voxel phase (:265-370).
__device__ __forceinline__ void step(const Ctx& c, const Smem& sm, const Ray2& r, int twid,
                                     State& s, int& sidx) {
  const int pre_lvl = s.lvl, pre_cb = s.cb;
  const float t0 = s.t;
  const Pos q = pos_at(c, r, t0);
  const int lin = (q.bx & 15) + (q.by & 15) * 16 + (q.bz & 15) * 256;
  const int widx = lin >> 5;
  const int vx = static_cast<int>(floorf(q.px));
  const int vy = static_cast<int>(floorf(q.py));
  const int vz = static_cast<int>(floorf(q.pz));
  const int vlin = (vx & 3) + (vy & 3) * 4 + (vz & 3) * 16;
  const int vidx = max(sidx, 0) * 16 + (vlin >> 2);
  const unsigned word = sm.bw[widx], lword = sm.lw[widx], vword = sm.slot[vidx];

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
  const bool g_jump = win_bit(c.gj, q.wflat);
  const bool g_liq = win_bit(c.gl, q.wflat);
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

// The tile's wants (:372-405): its smallest uncached window a brick-level
// ray stands in, and the smallest uncached brick of each 8-lane group.
__device__ __forceinline__ void wants(const Ctx& c, Smem& sm, const Ray2& r, const State& s,
                                      int tile, int* want_win, int* want_br) {
  const int lane = threadIdx.x;
  const Pos q = pos_at(c, r, s.t);
  const bool g_jump = win_bit(c.gj, q.wflat);
  const bool wcached = win_cached(c, q.wflat);
  const int wkey = (s.act && s.lvl == 0 && !g_jump && !wcached) ? q.wflat : kBigi;
  const int wmin = block_min(wkey, sm.red);
  if (lane == 0) want_win[tile] = wmin < kBigi ? wmin : -1;
  int comb = (s.act && s.lvl == 1 && cidx_of(c, s.cb) < 0) ? s.cb : kBigi;
  for (int sh = 1; sh <= 4; sh <<= 1) comb = min(comb, __shfl_xor_sync(kFull, comb, sh));
  if ((lane & 7) == 0)
    want_br[static_cast<size_t>(tile) * kWantB + (lane >> 3)] = comb < kBigi ? comb : -1;
}

__device__ __forceinline__ Ctx load_ctx(Smem& sm, const float* scal, const int* gj, const int* gl,
                                        const int* wid, const int* bid, int prog, int nb,
                                        int bg_side) {
  const int lane = threadIdx.x;
  sm.gj[lane] = static_cast<unsigned>(gj[lane]);
  sm.gl[lane] = static_cast<unsigned>(gl[lane]);
  if (lane < kNw) sm.wid[lane] = wid[prog * kNw + lane];
  if (lane < kNb) sm.bid[lane] = bid[prog * kNb + lane];
  __syncthreads();
  Ctx c;
  c.ox = scal[0];
  c.oy = scal[1];
  c.oz = scal[2];
  c.n_liquid = static_cast<int>(scal[3]);
  c.v = scal[4];
  c.nb = nb;
  c.bg_side = bg_side;
  c.gj = sm.gj;
  c.gl = sm.gl;
  c.wid = sm.wid;
  c.bid = sm.bid;
  return c;
}

// Each program's starting `go` (:444): flag 1 where some ray of it can
// march with the caches of this round.
__global__ void __launch_bounds__(kLanes) march2_go_kernel(
    const float* __restrict__ scal, const float* __restrict__ dx, const float* __restrict__ dy,
    const float* __restrict__ dz, const int* __restrict__ gj, const int* __restrict__ gl,
    const int* __restrict__ wid, const int* __restrict__ bid, Planes in, int* __restrict__ go,
    int nb, int bg_side) {
  __shared__ Smem sm;
  const int tile = blockIdx.x, prog = tile / kBlk2;
  const size_t o = static_cast<size_t>(tile) * kLanes + threadIdx.x;
  const Ctx c = load_ctx(sm, scal, gj, gl, wid, bid, prog, nb, bg_side);
  const Ray2 r = load_ray(c, dx, dy, dz, o);
  const State s = load_state(in, o);
  int twid, sidx;
  bool can;
  boundary(c, sm, r, s, nullptr, nullptr, nullptr, false, twid, sidx, can);
  if (__syncthreads_or(can) && threadIdx.x == 0) go[prog] = 1;
}

// Sub-round `sub` of every tile: 12 steps where the program's flag `sub`
// is set, then the program's next flag; the first sub-round reads the
// input planes, later ones the output planes in place; the last writes the
// wants.
__global__ void __launch_bounds__(kLanes) march2_sub_kernel(
    const float* __restrict__ scal, const float* __restrict__ dx, const float* __restrict__ dy,
    const float* __restrict__ dz, const int* __restrict__ gj, const int* __restrict__ gl,
    const int* __restrict__ wid, const int* __restrict__ bwc, const int* __restrict__ lwc,
    const int* __restrict__ bid, const int* __restrict__ cnt, Planes in, Planes out,
    int* __restrict__ want_win, int* __restrict__ want_br, int* __restrict__ go, int n_prog,
    int sub, int sub_rounds, int nb, int bg_side) {
  __shared__ Smem sm;
  const int tile = blockIdx.x, prog = tile / kBlk2;
  const bool run = go[sub * n_prog + prog] != 0;
  const bool first = sub == 0, last = sub == sub_rounds - 1;
  if (!run && !first && !last) return;  // the state already sits in `out`
  const size_t o = static_cast<size_t>(tile) * kLanes + threadIdx.x;
  const Ctx c = load_ctx(sm, scal, gj, gl, wid, bid, prog, nb, bg_side);
  const Ray2 r = load_ray(c, dx, dy, dz, o);
  State s = load_state(first ? in : out, o);
  if (run) {
    int twid, sidx;
    bool can;
    boundary(c, sm, r, s, bwc + static_cast<size_t>(prog) * kNw * kLanes,
             lwc + static_cast<size_t>(prog) * kNw * kLanes,
             cnt + static_cast<size_t>(prog) * kNb * 16, true, twid, sidx, can);
    for (int k = 0; k < kSubSteps; ++k) step(c, sm, r, twid, s, sidx);
    boundary(c, sm, r, s, nullptr, nullptr, nullptr, false, twid, sidx, can);
    if (__syncthreads_or(can) && threadIdx.x == 0) go[(sub + 1) * n_prog + prog] = 1;
  }
  if (first || run) store_state(out, o, s);
  if (last) wants(c, sm, r, s, tile, want_win, want_br);
}

}  // namespace

// One round of the v2 march: 1 + sub_rounds launches on `stream`. `go`
// holds (sub_rounds + 1) x n_prog zeroed words. Returns a cudaError_t.
extern "C" int march2_launch(const float* scal, const float* dx, const float* dy,
                             const float* dz, const int* gj, const int* gl, const int* wid,
                             const int* bwc, const int* lwc, const int* bid, const int* cnt,
                             float* t_in, int* act_in, int* hit_in, int* lvl_in, int* cb_in,
                             int* ax_in, int* vox_in, float* wat_in, float* wen_in, int* stp_in,
                             float* t, int* act, int* hit, int* lvl, int* cb, int* ax, int* vox,
                             float* wat, float* wen, int* stp, int* want_win, int* want_br,
                             int* go, int T, int nb, int bg_side, int sub_rounds,
                             cudaStream_t stream) {
  const Planes in{t_in, act_in, hit_in, lvl_in, cb_in, ax_in, vox_in, wat_in, wen_in, stp_in};
  const Planes out{t, act, hit, lvl, cb, ax, vox, wat, wen, stp};
  const int n_prog = T / kBlk2;
  march2_go_kernel<<<T, kLanes, 0, stream>>>(scal, dx, dy, dz, gj, gl, wid, bid, in, go, nb,
                                             bg_side);
  cudaError_t e = cudaGetLastError();
  for (int s = 0; s < sub_rounds && e == cudaSuccess; ++s) {
    march2_sub_kernel<<<T, kLanes, 0, stream>>>(scal, dx, dy, dz, gj, gl, wid, bwc, lwc, bid, cnt,
                                                in, out, want_win, want_br, go, n_prog, s,
                                                sub_rounds, nb, bg_side);
    e = cudaGetLastError();
  }
  return static_cast<int>(e);
}
