// One-launch path tracer for Hopper (sm_90a): each block traces, for
// every sample, the camera rays of its 16x8 tile and then the bounce legs
// of the paths still live, shading each leg's end, and writes the f32
// radiance averaged over the samples.
//
// Replaces the TPU kernel voxelraytracing_tpu/ops/pathtrace4.py:_pt_kernel4
// (launched by _pt_frame4 through pl.pallas_call). The TPU kernel keeps a
// 64-tile block's rays in one program: serve rounds against a VMEM cache,
// per-ray transitions at round boundaries, stragglers shaded as sky when
// `rounds` runs out. The cache and the rounds are schedule; this kernel is
// the converged semantics: every leg runs to its end (march4_common.cuh
// march_leg, from t = EPS_T), then the leg end runs in the TPU kernel's op
// order (leg_shade, bounce_ray). The draws key on the superblock-tiled ray
// id tg*128 + lane of the pixel, on the path's bounces left (the counter)
// and on the sample's base from the key's seed quads, as on the TPU.
//
// What bounds it: instruction issue in the march steps, as in march4.cu,
// and the divergence of the bounce legs. The camera leg is coherent (an
// 8x4 pixel group a warp steps, step-weighted, 95% of its longest lane's
// steps at 1080p); a bounce leg is not: scattered rays walk different
// cells and end at different steps, and a warp runs until its longest
// path ends (33% at 1080p), while most pixels' paths ended at the sky.
// The leg end adds a few dozen flops and up to ten transcendentals (expf
// x3, powf for a miss; logf x2, sinf, cosf x2, sqrtf for a bounce), IEEE
// throughout (--fmad=false, no fast math). Design: a 128-thread block a
// tile; the shared march step (march4_common.cuh march_step); the camera
// leg a lane a pixel, four 8x4 pixel groups a tile, one a warp; for each
// bounce leg the block queues its live paths (a path whose last leg
// missed has ended) in lane order and hands them to lanes 0, 1, ..., so
// as few whole warps as the live count needs march them, each path's ray
// and carry staged in shared memory (7 KB) and its radiance returned to
// its pixel's slot; scalar row, pair plane and the 5 KB material LUT in
// shared memory. Compaction gains little where a tile's paths end alike
// (sky or ground), and lanes refilled from a queue of two or four tiles
// lost to it on this card (PERF.md §6).

#include "march4_common.cuh"

namespace {

using namespace v4;

constexpr int kGroupW = 8;  // a warp's camera rays: 8 x 4 pixels, four groups a tile in 2x2
constexpr int kGroupH = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;
// blocks an SM must hold: a budget of 64 registers a thread
constexpr int kMinBlocks = 8;

// A block's paths, one a pixel of its 16x8 tile: slot li holds, for the
// pixel of tile lane li, the ray of the path's next leg and the path's
// carry. Bounce leg j marches the slots queued in q[j & 1] and queues
// those that go on in q[(j + 1) & 1]; the queue counts rotate through
// three words, so a word is cleared two legs before it is filled, with a
// block barrier between every use.
struct Paths {
  float o[3][kRow], d[3][kRow], p[6][kRow];
  int q[2][kRow];
  int n[3];
};

// The ray a slot holds, its constants derived again (make_ray of the same
// origin and direction: the same bits).
__device__ __forceinline__ Ray slot_ray(const Paths& ps, int slot, float v) {
  return make_ray(ps.o[0][slot], ps.o[1][slot], ps.o[2][slot], ps.d[0][slot], ps.d[1][slot],
                  ps.d[2][slot], v);
}

// The end of a leg with `bl` bounces left of the path in `slot`, whose
// ray r marched to c: shade it into the path's carry (leg_shade); a hit
// with bounces left scatters the path's next ray into the slot
// (bounce_ray, keyed on the pixel's ray id rid0 + slot and on
// sbase ^ bl * kGolden). Returns whether the path goes on.
__device__ __forceinline__ bool leg_end(const float* s, const float* lut, const World& w,
                                        Paths& ps, int slot, const Ray& r, const Leg& c, int bl,
                                        unsigned rid0, unsigned sbase) {
  const int vox = c.hit ? decode_vox(w, r, c.t) : 0;
  const float water = c.water + (c.wenter >= 0.0f ? fminf(c.t, r.t_exit) - c.wenter : 0.0f);
  PathCarry p{ps.p[0][slot], ps.p[1][slot], ps.p[2][slot],
              ps.p[3][slot], ps.p[4][slot], ps.p[5][slot]};
  leg_shade(s, lut, p, r, c.hit, water, vox);
  ps.p[0][slot] = p.cr;
  ps.p[1][slot] = p.cg;
  ps.p[2][slot] = p.cb;
  ps.p[3][slot] = p.lr;
  ps.p[4][slot] = p.lg;
  ps.p[5][slot] = p.lb;
  if (!c.hit || bl == 0) return false;
  const Ray nr = bounce_ray(r, c.t, c.axm, lut[256 + vox], rid0 + static_cast<unsigned>(slot),
                            sbase ^ (static_cast<unsigned>(bl) * kGolden), w.v);
  ps.o[0][slot] = nr.ox;
  ps.o[1][slot] = nr.oy;
  ps.o[2][slot] = nr.oz;
  ps.d[0][slot] = nr.dx;
  ps.d[1][slot] = nr.dy;
  ps.d[2][slot] = nr.dz;
  return true;
}

// Queue the slots of the warp's lanes that are `live`, in lane order (all
// lanes call it).
__device__ __forceinline__ void push_warp(bool live, int slot, int* q, int* n) {
  const unsigned m = __ballot_sync(kFull, live);
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0 && m != 0u) base = atomicAdd(n, __popc(m));
  base = __shfl_sync(kFull, base, 0);
  if (live) q[base + __popc(m & ((1u << lane) - 1u))] = slot;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
pt4_kernel(const float* __restrict__ scal, const int* __restrict__ gw2,
           const float* __restrict__ mlut, const int* __restrict__ sw_cont,
           const int* __restrict__ wmeta_pad, float* __restrict__ out, int height, int width,
           int nw, int ns, int gs, int bounces, int samples, float inv_s) {
  __shared__ float s[kScal];
  __shared__ unsigned gpair[2 * kRow];
  __shared__ float lut[kMatLut];
  __shared__ Paths ps;
  for (int i = threadIdx.x; i < kMatLut; i += kThreads) lut[i] = mlut[i];
  stage(s, scal, gpair, gw2, nullptr, nullptr);

  // warp g marches the camera rays of the tile's 8x4 group (g % 2, g / 2)
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int li = ((g >> 1) * kGroupH + lane / kGroupW) * kTileW + (g & 1) * kGroupW +
                 lane % kGroupW;
  const int px = blockIdx.x * kTileW + li % kTileW;
  const int py = blockIdx.y * kTileH + li / kTileW;
  const bool in_frame = px < width && py < height;
  const bool valid = in_frame && tile_valid(s, px, py);

  const World w = make_world(gpair, sw_cont, wmeta_pad, nw, ns, gs, s[3]);
  const float v = s[3];
  const int step_cap = step_cap_of(s);
  const bool in_w0 =
      s[0] > 0.0f && s[0] < v && s[1] > 0.0f && s[1] < v && s[2] > 0.0f && s[2] < v;
  // the superblock-major id of the tile's lane 0
  const int nsx = (static_cast<int>(s[25]) + 7) / 8;
  const int txi = blockIdx.x, tyi = blockIdx.y;
  const unsigned rid0 = (((tyi / 8) * nsx + txi / 8) * 64 + (tyi % 8) * 8 + txi % 8) * 128u;
  const unsigned k0 = static_cast<unsigned>(static_cast<int>(s[34])) +
                      (static_cast<unsigned>(static_cast<int>(s[35])) << 16);
  const unsigned k1 = static_cast<unsigned>(static_cast<int>(s[36])) +
                      (static_cast<unsigned>(static_cast<int>(s[37])) << 16);
  float rr = 0.0f, rg = 0.0f, rb = 0.0f;
  for (int sample = 0; sample < samples; ++sample) {
    const unsigned sbase = k0 ^ (k1 * kGolden) ^ (static_cast<unsigned>(sample) * 0x7FEB352Du);
    if (threadIdx.x == 0) ps.n[0] = ps.n[1] = 0;
    for (int i = 0; i < 3; ++i) {
      ps.p[i][li] = 1.0f;
      ps.p[3 + i][li] = 0.0f;
    }
    __syncthreads();
    // the camera leg, each lane its own pixel
    bool live = false;
    if (valid) {
      float dx, dy, dz;
      camera_dir(s, px, py, dx, dy, dz);
      const Ray r = make_ray(s[0], s[1], s[2], dx, dy, dz, v);
      live = leg_end(s, lut, w, ps, li, r, march_leg(w, r, in_w0, step_cap), bounces, rid0,
                     sbase);
    }
    push_warp(live, li, ps.q[0], &ps.n[0]);
    // the bounce legs: leg j's live paths, queued by the leg before it, go
    // to lanes 0, 1, ..., so as few whole warps as they need march them
    for (int j = 0, bl = bounces - 1; bl >= 0; ++j, --bl) {
      __syncthreads();
      const int n = ps.n[j % 3];
      if (n == 0) break;
      if (threadIdx.x == 0) ps.n[(j + 2) % 3] = 0;
      const bool has = static_cast<int>(threadIdx.x) < n;
      const int slot = has ? ps.q[j & 1][threadIdx.x] : 0;
      bool on = false;
      if (has) {
        const Ray r = slot_ray(ps, slot, v);
        on = leg_end(s, lut, w, ps, slot, r, march_leg(w, r, true, step_cap), bl, rid0, sbase);
      }
      push_warp(on, slot, ps.q[(j + 1) & 1], &ps.n[(j + 1) % 3]);
    }
    __syncthreads();
    rr = rr + ps.p[3][li];
    rg = rg + ps.p[4][li];
    rb = rb + ps.p[5][li];
  }
  if (!in_frame) return;
  const size_t o = (static_cast<size_t>(py) * width + px) * 3;
  out[o] = rr * inv_s;
  out[o + 1] = rg * inv_s;
  out[o + 2] = rb * inv_s;
}

}  // namespace

#ifndef PT4_HOST_TEST  // tests/torch_pt4_host.cpp builds the code above for the CPU
// Path-trace one frame on `stream` into `out` f32[height, width, 3]:
// `samples` paths of up to `bounces` bounces a pixel, scaled by `inv_s`
// (f32 of 1/samples). Returns the launch's CUDA error (0 = cudaSuccess);
// the caller raises on anything else.
extern "C" int pt4_launch(const float* scal, const int* gw2, const float* mlut, const int* sw_cont,
                          const int* wmeta_pad, float* out, int height, int width, int nw, int ns,
                          int gs, int bounces, int samples, float inv_s, cudaStream_t stream) {
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH);
  pt4_kernel<<<grid, kThreads, 0, stream>>>(scal, gw2, mlut, sw_cont, wmeta_pad, out, height,
                                            width, nw, ns, gs, bounces, samples, inv_s);
  return static_cast<int>(cudaGetLastError());
}
#endif  // PT4_HOST_TEST
