// State-plane v4 march for Hopper (sm_90a): march camera rays or per-ray
// (origin, direction) bundles through the bit-plane world and write the
// raw per-ray planes — t, flags, water length, water-enter — without
// shading, one thread per ray.
//
// Replaces the state-plane mode (fused=False) of the TPU kernel
// voxelraytracing_tpu/ops/wavefront4.py:_march_kernel4 (launched by
// _march4 through pl.pallas_call), from fresh starts: camera rays
// synthesized from the scalar row (scal[24]), or per-ray bundles
// (`rays` f32[6,T,128]) with the init of _trace_frame4 (:1692-1703).
// The split frame, trace_wavefront4 and trace_wavefront4_rays run on it.
// As in march4.cu, the TPU serve rounds and VMEM cache are schedule and
// are not carried over; each ray marches on its own (march4_common.cuh).
//
// The TPU kernel works on 64-tile blocks (128x64-pixel superblocks) and
// passes the input state planes through unchanged when no ray of the
// block is active at start (wavefront4.py:883-892, :995); otherwise every
// ray's t is clamped to its slab exit and its flags carry the direction
// signs. Those raw planes are the function's output (the split shade
// reads them; for a camera outside the world the untouched state is all
// zero), so this file keeps that rule in kernels launched by their own C
// entries on the caller's stream: the mark pass writes one byte for each
// 16x8 tile, 1 where a ray of the tile takes a first step (every tile
// written, so no clearing pass), and march_planes4_kernel reads the 64
// marks of its superblock before it marches.
//
// What bounds it: as march4.cu, instruction issue in the march steps
// (a fixed chain of float work around dependent table loads), with the
// divergence of a warp's rays; the per-ray bundles and the four f32/i32
// planes add 41 bytes a ray of streaming traffic, small beside a march of
// about ten steps a ray. The mark pass reads the bundle once more (25
// bytes a ray) and does no march. Design: march_fused4's (march4.cu) on
// the state planes: the shared step (march4_common.cuh march_step, with
// the exact cell inverse, the integer bounds test and one exit-axis mask
// a leg); a 128-thread block for each 16x8 tile, laid out as four 8x4
// pixel groups in 2x2, one a warp (their rays diverge less than a 16x2
// row pair's; a warp's bundle loads and plane stores are four 32-byte
// runs); a budget of 64 registers a thread; scalar row and pair plane in
// shared memory, tables through the read-only path. Sparse tables (the
// TPU kernel's sparse=True, :747-806) are a template switch of the march
// (march4_common.cuh content_row); the marks read no tables and have none.
//
// The marks of camera rays (touched4_camera_kernel) read nothing but the
// scalar row: a short chain of float work a ray (the camera direction
// with its IEEE sqrt and divisions, three reciprocals, the slab exit).
// A block a tile would spend its time scheduling 16,200 blocks at 1080p
// and staging the row, and every ray's chain would run. The mark is an
// OR, the same in any order, so the kernel evaluates as few rays as
// decide it: a warp for each 32 tiles, 4 warps a block, the row read
// once a block; a launch whose camera is not strictly inside the world
// or whose step cap is 0 writes zeros without ray math; each lane first
// tries one ray of one tile, which decides the tile whenever that ray
// starts, as every ray of a camera inside the world does unless it is
// within EPS_T of a face; the warp then takes each tile left open 32
// rays at a time, in four passes that each spread over the tile, to the
// first that starts.
// Only the start test's arithmetic is done (no Ray). The marks of
// bundles (touched4_rays_kernel) must read every ray's 25 bytes, which
// bounds them, and keep the block a tile.

#include "march4_common.cuh"

namespace {

using namespace v4;

constexpr int kSbTx = 8;              // superblock (one TPU block of 64 tiles), tiles
constexpr int kSbTy = 8;
constexpr int kFlZero = -0x30000000;  // flags read from an all-zero state plane
constexpr int kGroupW = 8;            // a warp's pixels: 8 x 4, four to a tile in 2x2
constexpr int kGroupH = 4;
// blocks an SM must hold: a budget of 64 registers a thread
constexpr int kMinBlocks = 8;

// The ray of pixel (px, py) and whether it is active at start: camera
// rays need a valid tile and the camera strictly inside the world;
// bundle rays their own origin strictly inside, their active flag and a
// valid tile.
template <bool kPerRay>
__device__ __forceinline__ Ray pixel_ray(const float* s, const float* origins, const float* dirs,
                                         const unsigned char* active, int px, int py, int width,
                                         bool& fl0) {
  const float v = s[3];
  float ox, oy, oz, dx, dy, dz;
  bool on;
  if (kPerRay) {
    const size_t o3 = (static_cast<size_t>(py) * width + px) * 3;
    ox = origins[o3];
    oy = origins[o3 + 1];
    oz = origins[o3 + 2];
    dx = dirs[o3];
    dy = dirs[o3 + 1];
    dz = dirs[o3 + 2];
    on = active[static_cast<size_t>(py) * width + px] != 0;
  } else {
    ox = s[0];
    oy = s[1];
    oz = s[2];
    camera_dir(s, px, py, dx, dy, dz);
    on = true;
  }
  fl0 = on && tile_valid(s, px, py) && ox > 0.0f && ox < v && oy > 0.0f && oy < v &&
        oz > 0.0f && oz < v;
  return make_ray(ox, oy, oz, dx, dy, dz, v);
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMarkWarps = 4;  // warps a camera-mark block, 32 tiles each
constexpr int kMarkPasses = kThreads / 32;
constexpr int kRepX = 8;       // a tile's representative pixel: its centre
constexpr int kRepY = 4;

// The camera marks' grid: a block for each 32 kMarkWarps tiles.
constexpr int camera_mark_blocks(int tiles) {
  return (tiles + 32 * kMarkWarps - 1) / (32 * kMarkWarps);
}

// Whether the camera ray of pixel (px, py) takes a first step, given the
// launch's uniform part (camera strictly inside the world, step cap > 0):
// at t = EPS_T it lies inside the world and before its slab exit, in the
// op order of make_ray and leg_starts.
__device__ __forceinline__ bool camera_ray_starts(const float* s, int px, int py) {
  float dx, dy, dz;
  camera_dir(s, px, py, dx, dy, dz);
  const float v = s[3];
  if (!inside_world(s[0] + dx * kEpsT, s[1] + dy * kEpsT, s[2] + dz * kEpsT, v)) return false;
  return kEpsT < slab_exit(s[0], s[1], s[2], inv_dir(dx), inv_dir(dy), inv_dir(dz), v);
}

// Whether the camera ray of pixel (px, py) of the frame starts.
__device__ __forceinline__ bool pixel_starts(const float* s, int px, int py, int height,
                                             int width) {
  return px < width && py < height && camera_ray_starts(s, px, py);
}

// Pass 1, camera rays: marks[tile] = 1 where a ray of the tile takes a
// first step, else 0; tile t = ty * tiles_x + tx, every tile of the launch written.
// Warp w of block b takes tiles 32 g to 32 g + 31 for g = b * kMarkWarps
// + w (camera_mark_blocks). Lane l first
// evaluates the representative pixel (kRepX, kRepY) of tile 32 g + l:
// for a camera inside the world every ray starts but within EPS_T of a
// face, so this one ray a tile decides almost every tile. The warp then
// takes the tiles left open one by one, all its lanes together: in pass
// j (0-3) lane l evaluates pixel (2 (l % 8) + j % 2, 2 (l / 8) + j / 2)
// of the tile, so each pass spans it, and the warp stops after the
// first pass in which a ray starts.
__global__ void __launch_bounds__(kMarkWarps * 32)
touched4_camera_kernel(const float* __restrict__ scal, unsigned char* __restrict__ marks,
                       int height, int width, int tiles_x, int tiles) {
  __shared__ float s[kScal];
  if (threadIdx.x < kScal) s[threadIdx.x] = scal[threadIdx.x];
  __syncthreads();
  const float v = s[3];
  const bool live = s[0] > 0.0f && s[0] < v && s[1] > 0.0f && s[1] < v && s[2] > 0.0f &&
                    s[2] < v && 0 < step_cap_of(s);
  const int lane = threadIdx.x & 31;
  const int t0 = (blockIdx.x * kMarkWarps + (threadIdx.x >> 5)) * 32;
  if (t0 >= tiles) return;  // the whole warp
  const int t = t0 + lane;
  const int x0 = (t % tiles_x) * kTileW, y0 = (t / tiles_x) * kTileH;
  const bool valid = live && t < tiles && tile_valid(s, x0, y0);
  bool any = valid && pixel_starts(s, x0 + kRepX, y0 + kRepY, height, width);
  const int lx = 2 * (lane & 7), ly = 2 * (lane >> 3);
  for (unsigned open = __ballot_sync(kFull, valid && !any); open; open &= open - 1) {
    const int k = __ffs(open) - 1;
    const int tk = t0 + k;
    const int xk = (tk % tiles_x) * kTileW + lx, yk = (tk / tiles_x) * kTileH + ly;
    bool hit = false;
    for (int j = 0; j < kMarkPasses && !hit; ++j)
      hit = __any_sync(kFull, pixel_starts(s, xk + (j & 1), yk + (j >> 1), height, width));
    if (lane == k) any = hit;
  }
  if (t < tiles) marks[t] = any ? 1 : 0;
}

// Pass 1, bundles: marks[tile] = 1 where a ray of the tile is active at
// start and takes a first step, else 0; a block for each tile.
__global__ void __launch_bounds__(kThreads)
touched4_rays_kernel(const float* __restrict__ scal, const float* __restrict__ origins,
                     const float* __restrict__ dirs, const unsigned char* __restrict__ active,
                     unsigned char* __restrict__ marks, int height, int width) {
  __shared__ float s[kScal];
  stage(s, scal, nullptr, nullptr, nullptr, nullptr);
  const int px = blockIdx.x * kTileW + (threadIdx.x % kTileW);
  const int py = blockIdx.y * kTileH + (threadIdx.x / kTileW);
  bool act0 = false;
  if (px < width && py < height) {
    bool fl0;
    const Ray r = pixel_ray<true>(s, origins, dirs, active, px, py, width, fl0);
    act0 = fl0 && leg_starts(r, s[3], step_cap_of(s));
  }
  const bool any = __syncthreads_or(act0);
  if (threadIdx.x == 0) marks[blockIdx.y * gridDim.x + blockIdx.x] = any ? 1 : 0;
}

// Pass 2: march every ray of a superblock with a marked tile; pass the
// start state of any other superblock through. kSparse: sparse tables.
template <bool kPerRay, bool kSparse>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
march_planes4_kernel(const float* __restrict__ scal, const int* __restrict__ gw2,
                     const int* __restrict__ sw_cont, const int* __restrict__ wmeta_pad,
                     const float* __restrict__ origins, const float* __restrict__ dirs,
                     const unsigned char* __restrict__ active,
                     const unsigned char* __restrict__ marks, float* __restrict__ ts,
                     int* __restrict__ fl, float* __restrict__ wa, float* __restrict__ we,
                     int height, int width, int nw, int ns, int gs) {
  __shared__ float s[kScal];
  __shared__ unsigned gpair[2 * kRow];
  stage(s, scal, gpair, gw2, nullptr, nullptr);
  // the first 64 threads read the marks of the superblock's 8x8 tiles
  bool marked = false;
  if (threadIdx.x < kSbTx * kSbTy) {
    const unsigned tx = blockIdx.x / kSbTx * kSbTx + threadIdx.x % kSbTx;
    const unsigned ty = blockIdx.y / kSbTy * kSbTy + threadIdx.x / kSbTx;
    marked = tx < gridDim.x && ty < gridDim.y && marks[ty * gridDim.x + tx] != 0;
  }
  const bool on = __syncthreads_or(marked);
  // warp g of the block marches the 8x4 group (g % 2, g / 2) of its tile
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int px = blockIdx.x * kTileW + (g & 1) * kGroupW + lane % kGroupW;
  const int py = blockIdx.y * kTileH + (g >> 1) * kGroupH + lane / kGroupW;
  if (px >= width || py >= height) return;
  const size_t o = static_cast<size_t>(py) * width + px;

  bool fl0;
  const Ray r = pixel_ray<kPerRay>(s, origins, dirs, active, px, py, width, fl0);
  if (!on) {
    // the TPU block's input state: zero planes for camera rays, the
    // fresh start (EPS_T, active bit, no water) for bundles
    ts[o] = kPerRay ? kEpsT : 0.0f;
    fl[o] = kPerRay ? (fl0 ? 1 : 0) : kFlZero;
    wa[o] = 0.0f;
    we[o] = kPerRay ? -1.0f : 0.0f;
    return;
  }
  const World w = make_world(gpair, sw_cont, wmeta_pad, nw, ns, gs, s[3]);
  const Leg c = march_leg<kSparse>(w, r, fl0, step_cap_of(s));
  const int vox = c.hit ? decode_vox<kSparse>(w, r, c.t) : 0;
  ts[o] = c.t;
  fl[o] = encode_flags(c.hit, c.axm, c.stp, vox, r.dx, r.dy, r.dz);
  wa[o] = c.water;
  we[o] = c.wenter;
}

}  // namespace

#ifndef PLANES4_HOST_TEST  // tests/torch_planes4_host.cpp builds the code above for the CPU
namespace {

dim3 tile_grid(int height, int width) {
  return dim3((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH);
}

template <bool kPerRay, bool kSparse>
void launch_planes(dim3 grid, cudaStream_t stream, const float* scal, const int* gw2,
                   const int* sw_cont, const int* wmeta_pad, const float* origins,
                   const float* dirs, const unsigned char* active, const unsigned char* marks,
                   float* ts, int* fl, float* wa, float* we, int height, int width, int nw, int ns,
                   int gs) {
  march_planes4_kernel<kPerRay, kSparse><<<grid, kThreads, 0, stream>>>(
      scal, gw2, sw_cont, wmeta_pad, origins, dirs, active, marks, ts, fl, wa, we, height, width,
      nw, ns, gs);
}

}  // namespace

// Mark the tiles of one frame's rays on `stream`: camera rays when
// `origins` is null, else the bundle origins/dirs f32[height,width,3] with
// `active` u8[height,width]. `marks` is u8[ceil(height/8), ceil(width/16)].
// Returns the launch's CUDA error (0 = cudaSuccess); the caller raises on
// anything else.
extern "C" int touched4_launch(const float* scal, const float* origins, const float* dirs,
                               const unsigned char* active, unsigned char* marks, int height,
                               int width, cudaStream_t stream) {
  const dim3 grid = tile_grid(height, width);
  if (origins) {
    touched4_rays_kernel<<<grid, kThreads, 0, stream>>>(scal, origins, dirs, active, marks,
                                                        height, width);
  } else {
    const int tiles = static_cast<int>(grid.x * grid.y);
    touched4_camera_kernel<<<camera_mark_blocks(tiles), kMarkWarps * 32, 0, stream>>>(
        scal, marks, height, width, static_cast<int>(grid.x), tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

// March one frame's rays on `stream`, with the rays as in touched4_launch
// and the marks it wrote; `sparse` selects the sparse-table instantiation.
// Returns the launch's CUDA error.
extern "C" int march_planes4_launch(const float* scal, const int* gw2, const int* sw_cont,
                                    const int* wmeta_pad, const float* origins,
                                    const float* dirs, const unsigned char* active,
                                    const unsigned char* marks, float* ts, int* fl, float* wa,
                                    float* we, int height, int width, int nw, int ns, int gs,
                                    int sparse, cudaStream_t stream) {
  auto fn = origins ? (sparse ? launch_planes<true, true> : launch_planes<true, false>)
                    : (sparse ? launch_planes<false, true> : launch_planes<false, false>);
  fn(tile_grid(height, width), stream, scal, gw2, sw_cont, wmeta_pad, origins, dirs, active,
     marks, ts, fl, wa, we, height, width, nw, ns, gs);
  return static_cast<int>(cudaGetLastError());
}
#endif  // PLANES4_HOST_TEST
