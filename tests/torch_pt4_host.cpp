// Runs pt4_kernel (csrc/pathtrace4.cu, its device code only: the CUDA
// launcher is left out under PT4_HOST_TEST) on the CPU over
// tests/torch_cuda_host.h.
//   torch_pt4_host IN OUT
// IN: int32 height width nw ns gs bounces samples, float inv_s, then scal
// f32[43], gw2 i32[256], mlut f32[10, 128], sw_cont i32[ns^3, 7, 128],
// wmeta_pad i32[nw^3, 1, 128]. OUT: the radiance f32[height, width, 3].
#include <cstdio>
#include <vector>

#include "torch_cuda_host.h"
#define PT4_HOST_TEST
#include "pathtrace4.cu"

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
  const auto hdr = read<int>(f, 7);
  const int height = hdr[0], width = hdr[1], nw = hdr[2], ns = hdr[3], gs = hdr[4];
  const int bounces = hdr[5], samples = hdr[6];
  const float inv_s = read<float>(f, 1)[0];
  const auto scal = read<float>(f, 43);
  const auto gw2 = read<int>(f, 256);
  const auto mlut = read<float>(f, 1280);
  const auto swc = read<int>(f, static_cast<size_t>(ns) * ns * ns * 7 * 128);
  const auto wmp = read<int>(f, static_cast<size_t>(nw) * nw * nw * 128);
  fclose(f);
  std::vector<float> out(static_cast<size_t>(height) * width * 3, -7.0f);
  // the launcher's grid: a block for each 16x8 tile
  host_launch((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH, kThreads, pt4_kernel,
              scal.data(), gw2.data(), mlut.data(), swc.data(), wmp.data(), out.data(), height,
              width, nw, ns, gs, bounces, samples, inv_s);
  FILE* o = fopen(argv[2], "wb");
  if (!o) return 2;
  fwrite(out.data(), 4, out.size(), o);
  fclose(o);
  return 0;
}
