// Runs march3_kernel (csrc/march3.cu, its device code only: the CUDA
// launcher is left out under MARCH3_HOST_TEST) on the CPU over
// tests/torch_cuda_host.h, each program's cluster of two 1,024-thread
// blocks together.
//   torch_march3_host IN OUT
//   torch_march3_host optin   (csrc/smem_optin.cuh through march3_optin)
// IN: int32 T nw ns nsx sub_rounds sub_steps lookahead has_rays has_tmap,
// then scal f32[27], mc i32[T/64,101,128], rays f32[6,T,128] (has_rays),
// tmap i32[T,8] (has_tmap), ts f32, fl i32, wa f32, we f32 [T,128].
// OUT: ts, fl, wa, we [T,128], then want i32[T,8].
#include <cstdio>
#include <string>
#include <vector>

#include "torch_cuda_host.h"
#define MARCH3_HOST_TEST
#include "march3.cu"

template <class T>
static std::vector<T> read(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (fread(v.data(), sizeof(T), n, f) != n) throw "short input";
  return v;
}

// The opt-in of both instantiations on devices 0 and 1, each launch made
// twice, then under capture (device 0, opted in; device 2, not), then
// device 2 outside the capture. Prints each call's error code ("rc dev
// per_ray code"), the block's shared bytes of each instantiation ("bytes
// per_ray n") and each recorded cudaFuncSetAttribute ("set dev per_ray
// attr value").
static int optin_report() {
  auto call = [](int dev, bool per_ray, bool capturing) {
    host_device = dev;
    host_capturing = capturing;
    printf("rc %d %d %d\n", dev, per_ray ? 1 : 0, static_cast<int>(march3_optin(per_ray, nullptr)));
  };
  for (int dev = 0; dev < 2; ++dev)
    for (int per_ray = 0; per_ray < 2; ++per_ray)
      for (int rep = 0; rep < 2; ++rep) call(dev, per_ray != 0, false);
  call(0, false, true);
  call(2, true, true);
  call(2, true, false);
  for (int per_ray = 0; per_ray < 2; ++per_ray)
    printf("bytes %d %d\n", per_ray, march3_smem_bytes(per_ray != 0));
  const void* bundles = reinterpret_cast<const void*>(march3_kernel<true>);
  for (const HostFuncAttr& a : host_func_attrs)
    printf("set %d %d %d %d\n", a.device, a.kernel == bundles ? 1 : 0, a.attr, a.value);
  return 0;
}

int main(int argc, char** argv) {
  if (argc == 2 && std::string(argv[1]) == "optin") return optin_report();
  if (argc != 3) return 2;
  FILE* f = fopen(argv[1], "rb");
  if (!f) return 2;
  const auto h = read<int>(f, 9);
  const int T = h[0], nw = h[1], ns = h[2], nsx = h[3], sub_rounds = h[4], sub_steps = h[5];
  const int lookahead = h[6], has_rays = h[7], has_tmap = h[8];
  const size_t n = static_cast<size_t>(T) * 128;
  const auto scal = read<float>(f, 27);
  const auto mc = read<int>(f, static_cast<size_t>(T / kBlk) * kMcWords);
  const auto rays = read<float>(f, has_rays ? 6 * n : 0);
  const auto tmap = read<int>(f, has_tmap ? static_cast<size_t>(T) * 8 : 0);
  const auto ts_in = read<float>(f, n);
  const auto fl_in = read<int>(f, n);
  const auto wa_in = read<float>(f, n);
  const auto we_in = read<float>(f, n);
  fclose(f);
  std::vector<float> ts(n), wa(n), we(n);
  std::vector<int> fl(n), want(static_cast<size_t>(T) * 8, 0x7eadbeef);
  auto kern = has_rays ? march3_kernel<true> : march3_kernel<false>;
  host_launch_cluster(T / kBlk * kCluster, kCluster, kThreads3, march3_smem_bytes(has_rays),
                      kern, scal.data(), mc.data(),
                      has_rays ? rays.data() : nullptr, has_tmap ? tmap.data() : nullptr,
                      ts_in.data(), fl_in.data(), wa_in.data(), we_in.data(), ts.data(),
                      fl.data(), wa.data(), we.data(), want.data(), T, nw, ns, nsx, sub_rounds,
                      sub_steps, lookahead);
  FILE* o = fopen(argv[2], "wb");
  if (!o) return 2;
  fwrite(ts.data(), 4, n, o);
  fwrite(fl.data(), 4, n, o);
  fwrite(wa.data(), 4, n, o);
  fwrite(we.data(), 4, n, o);
  fwrite(want.data(), 4, want.size(), o);
  fclose(o);
  return 0;
}
