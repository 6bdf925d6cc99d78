// Runs march_fused4_kernel (csrc/march4.cu, its device code only: the
// CUDA launcher is left out under MARCH4_HOST_TEST) on the CPU over
// tests/torch_cuda_host.h.
//   torch_march4_host IN OUT
// IN: int32 height width nw ns gs show_steps shadows sparse rows, float
// max_steps, then scal f32[43], gw2 i32[256], lut f32[768], sw_cont
// i32[rows, 7, 128], wmeta_pad i32[nw^3, 1, 128]. OUT: packed, then
// flags, i32[height, width].
#include <cstdio>
#include <thread>
#include <vector>

#include "torch_cuda_host.h"
#define MARCH4_HOST_TEST
#include "march4.cu"

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
  const int show = hdr[5], shadows = hdr[6], sparse = hdr[7], rows = hdr[8];
  const float max_steps = read<float>(f, 1)[0];
  const auto scal = read<float>(f, 43);
  const auto gw2 = read<int>(f, 256);
  const auto lut = read<float>(f, 768);
  const auto swc = read<int>(f, static_cast<size_t>(rows) * 7 * 128);
  const auto wmp = read<int>(f, static_cast<size_t>(nw) * nw * nw * 128);
  fclose(f);
  std::vector<int> packed(static_cast<size_t>(height) * width, 0x7eadbeef);
  std::vector<int> flags(packed.size(), 0x7eadbeef);
  auto kern = shadows ? (sparse ? march_fused4_kernel<true, true> : march_fused4_kernel<true, false>)
                      : (sparse ? march_fused4_kernel<false, true> : march_fused4_kernel<false, false>);
  // the launcher's grid: a block for each kWarps x 1 pixel groups
  const int grid_x = (width + kWarps * kGroupW - 1) / (kWarps * kGroupW);
  const int grid_y = (height + kGroupH - 1) / kGroupH;
  for (int by = 0; by < grid_y; ++by)
    for (int bx = 0; bx < grid_x; ++bx) {
      std::barrier<> bar(kThreads);
      host_block_barrier = &bar;
      std::vector<std::thread> threads;
      for (int t = 0; t < kThreads; ++t)
        threads.emplace_back([&, t] {
          threadIdx.x = t;
          blockIdx.x = bx;
          blockIdx.y = by;
          kern(scal.data(), gw2.data(), lut.data(), swc.data(), wmp.data(), packed.data(),
               flags.data(), height, width, nw, ns, gs, show, max_steps);
        });
      for (auto& th : threads) th.join();
    }
  FILE* o = fopen(argv[2], "wb");
  if (!o) return 2;
  fwrite(packed.data(), 4, packed.size(), o);
  fwrite(flags.data(), 4, flags.size(), o);
  fclose(o);
  return 0;
}
