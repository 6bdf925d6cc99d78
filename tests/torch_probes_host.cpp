// Runs col_gather_kernel and extract_sum_kernel (csrc/probes3.cu, its
// device code only: the cp.async kernel and the CUDA launchers are left out
// under PROBES3_HOST_TEST) on the CPU over tests/torch_cuda_host.h, at the
// launchers' grids.
//   torch_probes_host col_gather IN OUT
//     IN: int32 rows blk, tab i32[rows, 128], idx i32[blk, 128];
//     OUT: i32[blk, 128]
//   torch_probes_host extract_sum IN OUT
//     IN: int32 rows, v i32[rows, 128]; OUT: i32[8, 128]
#include <cstdio>
#include <string>
#include <vector>

#include "torch_cuda_host.h"
#define PROBES3_HOST_TEST
#include "probes3.cu"

template <class T>
static std::vector<T> read(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (fread(v.data(), sizeof(T), n, f) != n) throw "short input";
  return v;
}

int main(int argc, char** argv) {
  if (argc != 4) return 2;
  const std::string which = argv[1];
  FILE* f = fopen(argv[2], "rb");
  if (!f) return 2;
  std::vector<int> out;
  if (which == "col_gather") {
    const auto hdr = read<int>(f, 2);
    const int rows = hdr[0], blk = hdr[1];
    const auto tab = read<int>(f, static_cast<size_t>(rows) * kRow);
    const auto idx = read<int>(f, static_cast<size_t>(blk) * kRow);
    out.assign(idx.size(), 0x7eadbeef);
    host_launch(col_gather_blocks(blk), 1, kColThreads, col_gather_kernel, tab.data(),
                reinterpret_cast<const int4*>(idx.data()), reinterpret_cast<int4*>(out.data()),
                blk * kRowVec);
  } else if (which == "extract_sum") {
    const int rows = read<int>(f, 1)[0];
    const auto v = read<int>(f, static_cast<size_t>(rows) * kRow);
    out.assign(8 * kRow, 0x7eadbeef);
    host_launch(1, 1, kSumThreads, extract_sum_kernel, v.data(),
                reinterpret_cast<int4*>(out.data()));
  } else {
    return 2;
  }
  fclose(f);
  FILE* o = fopen(argv[3], "wb");
  if (!o) return 2;
  fwrite(out.data(), 4, out.size(), o);
  fclose(o);
  return 0;
}
