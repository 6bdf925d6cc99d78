// One-launch path tracer for Hopper (sm_90a): each pixel's thread traces,
// for every sample, its camera ray and then its bounce legs, shading each
// leg's end, and writes the f32 radiance averaged over the samples.
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
// What bounds it: the march, as in march4.cu (dependent table loads and a
// warp's divergent step counts), made worse by the bounce legs: scattered
// rays of one warp walk different cells and end at different steps, and a
// warp runs until its last path is done. The leg end adds a few dozen
// flops and up to ten transcendentals (expf x3, powf for a miss; logf x2,
// sinf, cosf x2, sqrtf for a bounce), IEEE throughout (--fmad=false, no
// fast math). Design: one thread per pixel over 16x8-pixel tiles of 128
// threads; scalar row, pair plane and the 5 KB material LUT in shared
// memory; the path (throughput, radiance, ray) in registers across legs
// and samples, so no plane goes to memory between legs.

#include "march4_common.cuh"

namespace {

using namespace v4;

__global__ void __launch_bounds__(kThreads)
pt4_kernel(const float* __restrict__ scal, const int* __restrict__ gw2,
           const float* __restrict__ mlut, const int* __restrict__ sw_cont,
           const int* __restrict__ wmeta_pad, float* __restrict__ out, int height, int width,
           int nw, int ns, int gs, int bounces, int samples, float inv_s) {
  __shared__ float s[kScal];
  __shared__ unsigned gpair[2 * kRow];
  __shared__ float lut[kMatLut];
  for (int i = threadIdx.x; i < kMatLut; i += kThreads) lut[i] = mlut[i];
  stage(s, scal, gpair, gw2, nullptr, nullptr);

  const int px = blockIdx.x * kTileW + (threadIdx.x % kTileW);
  const int py = blockIdx.y * kTileH + (threadIdx.x / kTileW);
  if (px >= width || py >= height) return;

  float rr = 0.0f, rg = 0.0f, rb = 0.0f;
  if (tile_valid(s, px, py)) {
    const World w{gpair, sw_cont, wmeta_pad, nw, ns, gs, (nw + (1 << gs) - 1) >> gs, s[3]};
    const float v = s[3];
    const int step_cap = step_cap_of(s);
    float dx, dy, dz;
    camera_dir(s, px, py, dx, dy, dz);
    const bool in_w0 =
        s[0] > 0.0f && s[0] < v && s[1] > 0.0f && s[1] < v && s[2] > 0.0f && s[2] < v;
    // superblock-major tile index of the pixel, and its lane
    const int txi = px / kTileW, tyi = py / kTileH;
    const int nsx = (static_cast<int>(s[25]) + 7) / 8;
    const unsigned tg = ((tyi / 8) * nsx + txi / 8) * 64 + (tyi % 8) * 8 + txi % 8;
    const unsigned rid = tg * 128u + static_cast<unsigned>((py % kTileH) * kTileW + px % kTileW);
    const unsigned k0 = static_cast<unsigned>(static_cast<int>(s[34])) +
                        (static_cast<unsigned>(static_cast<int>(s[35])) << 16);
    const unsigned k1 = static_cast<unsigned>(static_cast<int>(s[36])) +
                        (static_cast<unsigned>(static_cast<int>(s[37])) << 16);
    for (int sample = 0; sample < samples; ++sample) {
      const unsigned sbase = k0 ^ (k1 * kGolden) ^ (static_cast<unsigned>(sample) * 0x7FEB352Du);
      Ray r = make_ray(s[0], s[1], s[2], dx, dy, dz, v);
      bool act = in_w0;
      PathCarry p{1.0f, 1.0f, 1.0f, 0.0f, 0.0f, 0.0f};
      for (int bl = bounces;; --bl) {
        const Leg c = march_leg(w, r, act, step_cap);
        const int vox = c.hit ? decode_vox(w, r, c.t) : 0;
        const float water = c.water + (c.wenter >= 0.0f ? fminf(c.t, r.t_exit) - c.wenter : 0.0f);
        leg_shade(s, lut, p, r, c.hit, water, vox);
        if (!c.hit || bl == 0) break;
        r = bounce_ray(r, c.t, c.axm, lut[256 + vox], rid,
                       sbase ^ (static_cast<unsigned>(bl) * kGolden), v);
        act = true;
      }
      rr = rr + p.lr;
      rg = rg + p.lg;
      rb = rb + p.lb;
    }
  }
  const size_t o = (static_cast<size_t>(py) * width + px) * 3;
  out[o] = rr * inv_s;
  out[o + 1] = rg * inv_s;
  out[o + 2] = rb * inv_s;
}

}  // namespace

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
