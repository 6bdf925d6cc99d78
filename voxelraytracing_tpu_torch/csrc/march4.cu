// Fused v4 primary frame for Hopper (sm_90a): march the bit-plane world
// and shade each pixel to packed RGBA8, one thread per pixel.
//
// Replaces the fused primary mode of the TPU kernel
// voxelraytracing_tpu/ops/wavefront4.py:_march_kernel4 (launched by
// _march4 through pl.pallas_call). The TPU kernel marches 64-tile blocks
// in serve rounds against a VMEM cache it fills by async DMA; that cache,
// its min-chain picks and the warm token are schedule and change no pixel.
// Here each ray marches on its own from start to end, reading the tables
// straight from global memory through the read-only path.
//
// What bounds it: every step of a ray issues up to four dependent global
// loads (window meta -> subwindow meta -> solid/liquid words), and the
// threads of a warp take different numbers of steps (sky rays leave after
// a few window jumps; grazing terrain rays take hundreds), so the kernel
// is latency- and divergence-bound, not bandwidth-bound. The design keeps
// the per-frame constants (scalar row, global pair plane, color LUT) in
// shared memory, lets the tables of small worlds live in the 50 MB L2,
// and maps a 16x8-pixel tile to each 128-thread block, so the threads of
// a warp trace two neighbouring pixel rows and mostly walk the same
// cells. No TMA, wgmma or shared-memory staging of the tables yet.
//
// Arithmetic: built with --fmad=false and IEEE division and sqrt, so each
// multiply and add rounds on its own in the op order of the plain PyTorch
// version (march_fused4_ref) and of the JAX kernel: positions o + d*t and
// the DDA exits land on voxel faces, where one ulp flips floor().
//
// Layouts (int32 words holding the JAX package's uint32 bits):
//   scal      f32[43]: 0-2 origin, 3 world edge v, 4-5 2/W 2/H, 6-11 proj
//             affine, 12-20 view rows, 21 band y0, 23 step cap, 25-26
//             tile counts tx ty, 27-29 sun dir, 30 sun intensity, 31-33 sky
//   gw2       [256]: global (jump|liquid) pair plane, window wg at word
//             wg>>4, shift (wg&15)*2
//   lut       f32[6,128]: color rows r0 r1 g0 g1 b0 b1 (row pair = ids
//             0-127 | 128-255)
//   sw_cont   [Ns^3,7,128]: rows solid | liquid | pid0..3 | interleaved
//             brick meta (words 0-3) + palette (words 4-7)
//   wmeta_pad [Nw^3,1,128]: interleaved subwindow meta (words 0-3)
//   packed, flags: [height, width] outputs in image order

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

__device__ __forceinline__ float inv_dir(float c) {
  const float c2 = c >= 0.0f ? fmaxf(c, 1e-7f) : fminf(c, -1e-7f);
  return 1.0f / c2;
}

// DDA distance to the exit face of the current cell along one axis.
__device__ __forceinline__ float axis_exit(float pc, float sgf, float ivs,
                                          bool big, float cell, float icell) {
  const float ps = pc * sgf;
  const float b = floorf(ps * icell) + 1.0f;
  return big ? kBig : (b * cell - ps) * ivs;
}

__device__ __forceinline__ float sstep(float e0, float inv_span, float x) {
  float q = (x - e0) * inv_span;
  q = fminf(fmaxf(q, 0.0f), 1.0f);
  return q * q * (3.0f - 2.0f * q);
}

__device__ __forceinline__ unsigned q8(float c) {
  return static_cast<unsigned>(static_cast<int>(fminf(fmaxf(c, 0.0f), 1.0f) * 255.0f));
}

__global__ void __launch_bounds__(kThreads)
march_fused4_kernel(const float* __restrict__ scal, const int* __restrict__ gw2,
                    const float* __restrict__ lut, const int* __restrict__ sw_cont,
                    const int* __restrict__ wmeta_pad, int* __restrict__ packed,
                    int* __restrict__ flags, int height, int width, int nw, int ns,
                    int gs, int show_steps, float max_steps) {
  __shared__ float s[kScal];
  __shared__ unsigned gpair[2 * kRow];
  __shared__ float clut[6 * kRow];
  const int tid = threadIdx.x;
  if (tid < kScal) s[tid] = scal[tid];
  gpair[tid] = static_cast<unsigned>(gw2[tid]);
  gpair[tid + kRow] = static_cast<unsigned>(gw2[tid + kRow]);
  for (int i = tid; i < 6 * kRow; i += kThreads) clut[i] = lut[i];
  __syncthreads();

  const int px = blockIdx.x * kTileW + (tid % kTileW);
  const int py = blockIdx.y * kTileH + (tid / kTileW);
  if (px >= width || py >= height) return;

  // ---- camera ray (wavefront3._ray_dirs op order, divide by sqrt)
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py) + s[21];
  const float x = fx * s[4] - 1.0f;
  const float y = fy * s[5] - 1.0f;
  const float ex = x * s[6] - y * s[7] + s[8];
  const float ey = x * s[9] - y * s[10] + s[11];
  float dx = ex * s[12] + ey * s[15] - s[18];
  float dy = ex * s[13] + ey * s[16] - s[19];
  float dz = ex * s[14] + ey * s[17] - s[20];
  const float nrm = sqrtf(dx * dx + dy * dy + dz * dz);
  dx = dx / nrm;
  dy = dy / nrm;
  dz = dz / nrm;

  // ---- per-ray constants
  const float ox = s[0], oy = s[1], oz = s[2], v = s[3];
  const float ivx = inv_dir(dx), ivy = inv_dir(dy), ivz = inv_dir(dz);
  const float sx = dx > 0.0f ? 1.0f : 0.0f;
  const float sy = dy > 0.0f ? 1.0f : 0.0f;
  const float sz = dz > 0.0f ? 1.0f : 0.0f;
  const float gfx = sx + sx - 1.0f, gfy = sy + sy - 1.0f, gfz = sz + sz - 1.0f;
  const float isx = ivx * gfx, isy = ivy * gfy, isz = ivz * gfz;
  const bool bgx = fabsf(ivx) >= kBigIv;
  const bool bgy = fabsf(ivy) >= kBigIv;
  const bool bgz = fabsf(ivz) >= kBigIv;
  const float slx = fmaxf((0.0f - ox) * ivx, (v - ox) * ivx);
  const float sly = fmaxf((0.0f - oy) * ivy, (v - oy) * ivy);
  const float slz = fmaxf((0.0f - oz) * ivz, (v - oz) * ivz);
  const float t_exit = fminf(fminf(slx, fminf(sly, slz)), 4.0f * v + 16.0f);
  const int step_cap = s[23] > 0.5f ? static_cast<int>(s[23]) : kCapNone;
  const int nwg = (nw + (1 << gs) - 1) >> gs;

  // ---- start: a whole tile inside the frame, camera strictly in the world
  const bool val_t = static_cast<float>(px / kTileW) < s[25] &&
                     static_cast<float>(py / kTileH) < s[26];
  const bool in_w0 = ox > 0.0f && ox < v && oy > 0.0f && oy < v && oz > 0.0f && oz < v;
  float t = kEpsT, water = 0.0f, wenter = -1.0f;
  int stp = 0, axm = 0;
  bool hit = false;
  bool active = val_t && in_w0 && 0 < step_cap;

  // ---- march (wavefront4.py classify + step, one ray)
  while (active) {
    const float pxf = ox + dx * t;
    const float pyf = oy + dy * t;
    const float pzf = oz + dz * t;
    if (!(t < t_exit) || stp >= step_cap || !(pxf >= 0.0f && pyf >= 0.0f && pzf >= 0.0f &&
                                             pxf < v && pyf < v && pzf < v))
      break;
    const int vx = static_cast<int>(floorf(pxf));
    const int vy = static_cast<int>(floorf(pyf));
    const int vz = static_cast<int>(floorf(pzf));
    const int wg = (vx >> (6 + gs)) + (vy >> (6 + gs)) * nwg + (vz >> (6 + gs)) * nwg * nwg;
    const unsigned g = (gpair[wg >> 4] >> ((wg & 15) * 2)) & 3u;
    float cell;
    bool liquid, hit_now = false;
    if (g & 1u) {                       // window (super-cell) jump
      cell = static_cast<float>(64 << gs);
      liquid = (g & 2u) != 0;
    } else {
      const int w = (vx >> 6) + (vy >> 6) * nw + (vz >> 6) * nw * nw;
      const int s_loc = ((vx >> 4) & 3) + ((vy >> 4) & 3) * 4 + ((vz >> 4) & 3) * 16;
      const unsigned sw =
          (ld(wmeta_pad + static_cast<size_t>(w) * kRow + (s_loc >> 4)) >> ((s_loc & 15) * 2)) & 3u;
      if (sw & 1u) {                    // subwindow jump
        cell = 16.0f;
        liquid = (sw & 2u) != 0;
      } else {
        const int sid = (vx >> 4) + (vy >> 4) * ns + (vz >> 4) * ns * ns;
        const int* row = sw_cont + static_cast<size_t>(sid) * (kSubRows * kRow);
        const int b_loc = ((vx >> 2) & 3) + ((vy >> 2) & 3) * 4 + ((vz >> 2) & 3) * 16;
        const unsigned br = (ld(row + 6 * kRow + (b_loc >> 4)) >> ((b_loc & 15) * 2)) & 3u;
        if (br & 1u) {                  // brick skip
          cell = 4.0f;
          liquid = (br & 2u) != 0;
        } else {                        // voxel test
          const int l = (vx & 15) + (vy & 15) * 16 + (vz & 15) * 256;
          hit_now = ((ld(row + (l >> 5)) >> (l & 31)) & 1u) != 0;
          liquid = ((ld(row + kRow + (l >> 5)) >> (l & 31)) & 1u) != 0;
          cell = 1.0f;
        }
      }
    }
    // water interval: close it on leaving liquid, open it on marching in
    if (wenter >= 0.0f && !liquid) {
      water = water + (t - wenter);
      wenter = -1.0f;
    }
    stp += 1;
    if (hit_now) {
      hit = true;
      break;
    }
    if (liquid && wenter < 0.0f) wenter = t;
    const float icell = 1.0f / cell;
    const float dtx = axis_exit(pxf, gfx, isx, bgx, cell, icell);
    const float dty = axis_exit(pyf, gfy, isy, bgy, cell, icell);
    const float dtz = axis_exit(pzf, gfz, isz, bgz, cell, icell);
    const float dt = fminf(dtx, fminf(dty, dtz));
    axm = (dtx <= dt ? 1 : 0) | (dty <= dt ? 2 : 0) | (dtz <= dt ? 4 : 0);
    t = t + dt + kEpsT;
  }
  t = fminf(t, t_exit);

  // ---- hit id: 4 palette-index bits + the subwindow palette byte
  int vox = 0;
  if (hit) {
    const int vx = static_cast<int>(floorf(ox + dx * t));
    const int vy = static_cast<int>(floorf(oy + dy * t));
    const int vz = static_cast<int>(floorf(oz + dz * t));
    const int sid = (vx >> 4) + (vy >> 4) * ns + (vz >> 4) * ns * ns;
    const int* row = sw_cont + static_cast<size_t>(sid) * (kSubRows * kRow);
    const int l = (vx & 15) + (vy & 15) * 16 + (vz & 15) * 256;
    int pidx = 0;
    for (int b = 0; b < 4; ++b)
      pidx |= static_cast<int>((ld(row + (2 + b) * kRow + (l >> 5)) >> (l & 31)) & 1u) << b;
    const unsigned pal = ld(row + 6 * kRow + 4 + (pidx >> 2));
    vox = static_cast<int>((pal >> ((pidx & 3) * 8)) & 0xFFu);
  }

  // ---- shade (wavefront4.py shade_store op order)
  if (wenter >= 0.0f) water = water + (t - wenter);
  float cr = clut[0 * 256 + vox], cg = clut[1 * 256 + vox], cb = clut[2 * 256 + vox];
  float tint = (axm & 1) ? 0.5f : 1.0f;
  tint = tint * ((axm & 4) ? 0.7f : 1.0f);
  tint = tint * (((axm & 2) && dy > 0.0f) ? 0.2f : 1.0f);
  cr = cr * tint;
  cg = cg * tint;
  cb = cb * tint;
  if (show_steps) {
    const float f = fminf(fmaxf(static_cast<float>(stp) / max_steps, 0.0f), 1.0f);
    cr = cg = cb = f;
  }
  const float gts = sstep(-0.01f, 100.0f, dy);
  const float grad_t = powf(sstep(0.0f, 2.5f, dy), 0.35f);
  const float sun_dot = dx * s[27] + dy * s[28] + dz * s[29];
  const float sun = ((sun_dot > 0.99f && gts >= 1.0f) ? 1.0f : 0.0f) * s[30];
  const float sr = 0.03f + ((1.0f + (s[31] - 1.0f) * grad_t) - 0.03f) * gts + sun;
  const float sg = 0.03f + ((0.3f + (s[32] - 0.3f) * grad_t) - 0.03f) * gts + sun;
  const float sb = 0.03f + ((0.0f + (s[33] - 0.0f) * grad_t) - 0.03f) * gts + sun;
  float r = hit ? cr : sr, gc = hit ? cg : sg, b = hit ? cb : sb;
  if (water != 0.0f) {
    const float factor = fminf(fmaxf(water * (1.0f / 14.0f), 0.8f), 1.0f);
    const float keep = 1.0f - factor;
    r = r * keep + 0.2f * factor;
    gc = gc * keep + 0.5f * factor;
    b = b * keep + 1.0f * factor;
  }
  const size_t o = static_cast<size_t>(py) * width + px;
  packed[o] = static_cast<int>(q8(r) | (q8(gc) << 8) | (q8(b) << 16) | 0xFF000000u);
  const int sgn = (dx > 0.0f ? 1 : 0) | (dy > 0.0f ? 2 : 0) | (dz > 0.0f ? 4 : 0);
  flags[o] = (hit ? 1 << 1 : 0) | (axm << 2) | (min(stp, 0xFFF) << 5) | (vox << 17) | (sgn << 25);
}

}  // namespace

// Launch one frame on `stream`. Returns cudaGetLastError() after the
// launch (0 = cudaSuccess); the caller raises on anything else.
extern "C" int march_fused4_launch(const float* scal, const int* gw2, const float* lut,
                                   const int* sw_cont, const int* wmeta_pad, int* packed,
                                   int* flags, int height, int width, int nw, int ns, int gs,
                                   int show_steps, float max_steps, cudaStream_t stream) {
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH);
  march_fused4_kernel<<<grid, kThreads, 0, stream>>>(scal, gw2, lut, sw_cont, wmeta_pad, packed,
                                                     flags, height, width, nw, ns, gs, show_steps,
                                                     max_steps);
  return static_cast<int>(cudaGetLastError());
}
