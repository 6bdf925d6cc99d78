// Runs the touched4 kernels and march_planes4_kernel (csrc/planes4.cu, their
// device code only: the CUDA launchers are left out under
// PLANES4_HOST_TEST) on the CPU over tests/torch_cuda_host.h.
//   torch_planes4_host IN OUT
// IN: int32 height width nw ns gs sparse rows per_ray march, then
// scal f32[43],
// gw2 i32[256], sw_cont i32[rows, 7, 128], wmeta_pad i32[nw^3, 1, 128];
// with per_ray the bundle origins, dirs f32[height, width, 3] and active
// u8[height, width]; then the marks the march reads, u8[ty, tx] (ty, tx
// the tile counts). march 0 runs the marks alone (the planes stay as
// filled). OUT: the marks touched4_camera_kernel (touched4_rays_kernel
// with per_ray) writes, u8[ty, tx], then ts f32, fl i32, wa f32, we f32
// [height, width].
#include <cstdio>
#include <vector>

#include "torch_cuda_host.h"
#define PLANES4_HOST_TEST
#include "planes4.cu"

template <class T>
static std::vector<T> read(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (fread(v.data(), sizeof(T), n, f) != n) throw "short input";
  return v;
}

int main(int argc, char** argv) {
  if (argc != 3) return 2;
  FILE* f = fopen(argv[1], "rb");
  if (!f) return 2;
  const auto hdr = read<int>(f, 9);
  const int height = hdr[0], width = hdr[1], nw = hdr[2], ns = hdr[3], gs = hdr[4];
  const int sparse = hdr[5], rows = hdr[6], per_ray = hdr[7];
  const size_t n = static_cast<size_t>(height) * width;
  const unsigned tx = (width + kTileW - 1) / kTileW, ty = (height + kTileH - 1) / kTileH;
  const auto scal = read<float>(f, 43);
  const auto gw2 = read<int>(f, 256);
  const auto swc = read<int>(f, static_cast<size_t>(rows) * 7 * 128);
  const auto wmp = read<int>(f, static_cast<size_t>(nw) * nw * nw * 128);
  const auto origins = read<float>(f, per_ray ? 3 * n : 0);
  const auto dirs = read<float>(f, per_ray ? 3 * n : 0);
  const auto active = read<unsigned char>(f, per_ray ? n : 0);
  const auto marks_in = read<unsigned char>(f, static_cast<size_t>(tx) * ty);
  fclose(f);
  const float* o = per_ray ? origins.data() : nullptr;
  const float* d = per_ray ? dirs.data() : nullptr;
  const unsigned char* a = per_ray ? active.data() : nullptr;
  std::vector<unsigned char> marks(marks_in.size(), 0x7e);
  std::vector<float> ts(n, -7.0f), wa(n, -7.0f), we(n, -7.0f);
  std::vector<int> fl(n, 0x7eadbeef);
  // the launchers' grids: camera marks on camera_mark_blocks, else a
  // block for each 16x8 tile
  if (per_ray)
    host_launch(tx, ty, kThreads, touched4_rays_kernel, scal.data(), o, d, a, marks.data(),
                height, width);
  else
    host_launch(camera_mark_blocks(static_cast<int>(tx * ty)), 1, kMarkWarps * 32,
                touched4_camera_kernel, scal.data(), marks.data(), height, width,
                static_cast<int>(tx), static_cast<int>(tx * ty));
  auto kern = per_ray ? (sparse ? march_planes4_kernel<true, true> : march_planes4_kernel<true, false>)
                      : (sparse ? march_planes4_kernel<false, true> : march_planes4_kernel<false, false>);
  if (hdr[8])
    host_launch(tx, ty, kThreads, kern, scal.data(), gw2.data(), swc.data(), wmp.data(), o, d,
                a, marks_in.data(), ts.data(), fl.data(), wa.data(), we.data(), height, width,
                nw, ns, gs);
  FILE* out = fopen(argv[2], "wb");
  if (!out) return 2;
  fwrite(marks.data(), 1, marks.size(), out);
  fwrite(ts.data(), 4, n, out);
  fwrite(fl.data(), 4, n, out);
  fwrite(wa.data(), 4, n, out);
  fwrite(we.data(), 4, n, out);
  fclose(out);
  return 0;
}
