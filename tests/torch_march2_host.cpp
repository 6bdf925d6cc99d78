// Runs march2_kernel (csrc/march2.cu, its device code only: the CUDA
// launcher is left out under MARCH2_HOST_TEST) on the CPU over
// tests/torch_cuda_host.h, each program's cluster of eight 1,024-thread
// blocks together.
//   torch_march2_host IN OUT
//   torch_march2_host optin   (csrc/smem_optin.cuh through march2_optin)
// IN: int32 T nb bg_side sub_rounds, then scal f32[8], dx dy dz f32[T,128],
// gj gl i32[128], wid i32[T/256,8], bwc lwc i32[T/256,8,128], bid
// i32[T/256,64], cnt i32[T/256,8,128], the ten state planes [T,128]
// (t active hit level cur_brick axmask vox water wenter steps).
// OUT: the ten state planes, want_win i32[T], want_br i32[T,16].
#include <cstdio>
#include <string>
#include <vector>

#include "torch_cuda_host.h"
#define MARCH2_HOST_TEST
#include "march2.cu"

template <class T>
static std::vector<T> read(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (fread(v.data(), sizeof(T), n, f) != n) throw "short input";
  return v;
}

// The opt-in on devices 0 and 1, each launch made twice, then under
// capture (device 0, opted in; device 2, not), then device 2 outside the
// capture. Prints each call's error code ("rc dev 0 code"), the block's
// shared bytes ("bytes 0 n") and each recorded cudaFuncSetAttribute
// ("set dev 0 attr value").
static int optin_report() {
  auto call = [](int dev, bool capturing) {
    host_device = dev;
    host_capturing = capturing;
    printf("rc %d 0 %d\n", dev, static_cast<int>(march2_optin(nullptr)));
  };
  for (int dev = 0; dev < 2; ++dev)
    for (int rep = 0; rep < 2; ++rep) call(dev, false);
  call(0, true);
  call(2, true);
  call(2, false);
  printf("bytes 0 %d\n", kMarch2Smem);
  for (const HostFuncAttr& a : host_func_attrs)
    printf("set %d 0 %d %d\n", a.device, a.attr, a.value);
  return 0;
}

int main(int argc, char** argv) {
  if (argc == 2 && std::string(argv[1]) == "optin") return optin_report();
  if (argc != 3) return 2;
  FILE* f = fopen(argv[1], "rb");
  if (!f) return 2;
  const auto h = read<int>(f, 4);
  const int T = h[0], nb = h[1], bg_side = h[2], sub_rounds = h[3];
  const size_t n = static_cast<size_t>(T) * 128, np = T / kBlk2;
  const auto scal = read<float>(f, 8);
  const auto dx = read<float>(f, n), dy = read<float>(f, n), dz = read<float>(f, n);
  const auto gj = read<int>(f, 128), gl = read<int>(f, 128);
  const auto wid = read<int>(f, np * 8);
  const auto bwc = read<int>(f, np * 1024), lwc = read<int>(f, np * 1024);
  const auto bid = read<int>(f, np * 64);
  const auto cnt = read<int>(f, np * 1024);
  // ten planes in, ten out, as 32-bit words
  std::vector<std::vector<int>> pin, pout;
  for (int k = 0; k < 10; ++k) {
    pin.push_back(read<int>(f, n));
    pout.emplace_back(n, 0x7eadbeef);
  }
  fclose(f);
  auto planes = [](std::vector<std::vector<int>>& p) {
    auto fp = [&](int k) { return reinterpret_cast<float*>(p[k].data()); };
    return Planes{fp(0),       p[1].data(), p[2].data(), p[3].data(), p[4].data(),
                  p[5].data(), p[6].data(), fp(7),       fp(8),       p[9].data()};
  };
  std::vector<int> want_win(T, 0x7eadbeef), want_br(static_cast<size_t>(T) * 16, 0x7eadbeef);
  host_launch_cluster(np * kCluster2, kCluster2, kThreads2, kMarch2Smem,
                      march2_kernel, scal.data(), dx.data(), dy.data(), dz.data(), gj.data(),
                      gl.data(), wid.data(), bwc.data(), lwc.data(), bid.data(), cnt.data(),
                      planes(pin), planes(pout), want_win.data(), want_br.data(), nb, bg_side,
                      sub_rounds);
  FILE* o = fopen(argv[2], "wb");
  if (!o) return 2;
  for (const auto& p : pout) fwrite(p.data(), 4, n, o);
  fwrite(want_win.data(), 4, want_win.size(), o);
  fwrite(want_br.data(), 4, want_br.size(), o);
  fclose(o);
  return 0;
}
