// Runs probe kernels of csrc/probes3.cu (its device code only: the PTX
// helpers and the CUDA launchers are left out under PROBES3_HOST_TEST) on
// the CPU over tests/torch_cuda_host.h, at the launchers' grids.
//   torch_probes_host col_gather IN OUT
//     IN: int32 rows blk, tab i32[rows, 128], idx i32[blk, 128];
//     OUT: i32[blk, 128]
//   torch_probes_host row_loop IN OUT
//     IN: int32 rows blk, tab i32[rows, 128], idx i32[blk, 128];
//     OUT: i32[blk, 128]
//   torch_probes_host extract_sum IN OUT
//     IN: int32 rows, v i32[rows, 128]; OUT: i32[8, 128]
//   torch_probes_host gather_rows_async IN OUT
//     IN: int32 rows nb pipelined, tab i32[rows, 128], ids i32[nb, 16];
//     OUT: i32[nb, 16, 128]
//   torch_probes_host bar_short|bar_long|bar_parity
//     a barrier misused on purpose: exits through abort() with a message
#include <cstdio>
#include <cstdlib>
#include <mutex>
#include <string>
#include <vector>

#include "torch_cuda_host.h"

// Stand-ins for probes3.cu's PTX helpers. A bulk copy is a memcpy that
// lands at once. The mbarrier keeps, in its own 8 bytes, the parity of
// its phase, the arrivals it still expects and the bytes armed but not
// yet copied; one lock guards it, since the lanes are threads. Where the
// card would spin for good, the stand-in aborts with a message: a wait on
// a phase that has not completed (the kernel's lanes meet before every
// wait, so every copy of that phase has been issued by then: too few
// bytes copied, or the wrong parity). It is stricter than the card in one
// point, which the kernel keeps: a copy lands only on bytes already armed.
struct HostBar {
  int32_t tx;         // bytes armed minus bytes copied, this phase
  uint16_t pending;   // arrivals still expected this phase
  uint8_t count;      // arrivals a phase
  uint8_t phase;      // parity of the current phase
};
static_assert(sizeof(HostBar) == sizeof(uint64_t));
static std::mutex host_bar_lock;

[[noreturn]] static void host_bar_fault(const char* what, const HostBar& h) {
  std::fprintf(stderr,
               "mbarrier: %s (block %u, thread %u; phase %u, %u arrivals and %d bytes "
               "outstanding): the card would hang or misread here\n",
               what, blockIdx.x, threadIdx.x, h.phase, h.pending, h.tx);
  std::abort();
}

// Runs `op` on the barrier's state under the lock, then completes the
// phase if nothing is outstanding.
template <class F>
static void host_bar_update(uint64_t* bar, F op) {
  std::lock_guard<std::mutex> g(host_bar_lock);
  HostBar h;
  std::memcpy(&h, bar, sizeof h);
  op(h);
  if (h.pending == 0 && h.tx == 0) {
    h.phase ^= 1;
    h.pending = h.count;
  }
  std::memcpy(bar, &h, sizeof h);
}

static void host_bulk_check(const void* a, const void* b, unsigned bytes) {
  if (reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16 || bytes % 16) {
    std::fprintf(stderr, "cp.async.bulk: addresses and size must be multiples of 16\n");
    std::abort();
  }
}

void mbar_init(uint64_t* bar, unsigned count) {
  std::lock_guard<std::mutex> g(host_bar_lock);
  const HostBar h{0, static_cast<uint16_t>(count), static_cast<uint8_t>(count), 0};
  std::memcpy(bar, &h, sizeof h);
}

void mbar_arm(uint64_t* bar, unsigned bytes) {
  host_bar_update(bar, [&](HostBar& h) {
    if (h.pending == 0) host_bar_fault("an arrival that the phase does not expect", h);
    h.tx += static_cast<int32_t>(bytes);
    --h.pending;
  });
}

void mbar_wait(uint64_t* bar, unsigned parity) {
  std::lock_guard<std::mutex> g(host_bar_lock);
  HostBar h;
  std::memcpy(&h, bar, sizeof h);
  if (h.phase == (parity & 1)) host_bar_fault("a wait on a phase that has not completed", h);
}

void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  host_bulk_check(dst, src, bytes);
  std::memcpy(dst, src, bytes);
  host_bar_update(bar, [&](HostBar& h) {
    h.tx -= static_cast<int32_t>(bytes);
    if (h.tx < 0) host_bar_fault("a copy of more bytes than were armed", h);
  });
}

void bulk_store(void* dst, const void* src, unsigned bytes) {
  host_bulk_check(dst, src, bytes);
  std::memcpy(dst, src, bytes);
}

#define PROBES3_HOST_TEST
#include "probes3.cu"

template <class T>
static std::vector<T> read(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (fread(v.data(), sizeof(T), n, f) != n) throw "short input";
  return v;
}

// One thread misuses a barrier as `which` says; every case aborts.
static void bar_misuse(const std::string& which) {
  alignas(16) static int src[kRow], dst[2 * kRow];
  static uint64_t bar;
  host_launch(1, 1, 1, [which] {
    mbar_init(&bar, 1);
    if (which == "bar_short") {  // 1 KB armed, 512 bytes copied
      mbar_arm(&bar, 2 * kRowBytes);
      bulk_load(dst, src, kRowBytes, &bar);
      mbar_wait(&bar, 0);
    } else if (which == "bar_long") {  // 512 bytes armed, 1 KB copied
      mbar_arm(&bar, kRowBytes);
      bulk_load(dst, src, kRowBytes, &bar);
      bulk_load(dst + kRow, src, kRowBytes, &bar);
    } else {  // the second row waited on the first row's parity
      for (int k = 0; k < 2; ++k) {
        mbar_arm(&bar, kRowBytes);
        bulk_load(dst + k * kRow, src, kRowBytes, &bar);
        mbar_wait(&bar, 0);
      }
    }
  });
}

int main(int argc, char** argv) {
  if (argc == 2) {
    bar_misuse(argv[1]);
    return 0;
  }
  if (argc != 4) return 2;
  const std::string which = argv[1];
  FILE* f = fopen(argv[2], "rb");
  if (!f) return 2;
  std::vector<int> out;
  if (which == "col_gather" || which == "row_loop") {
    const auto hdr = read<int>(f, 2);
    const int rows = hdr[0], blk = hdr[1];
    const auto tab = read<int>(f, static_cast<size_t>(rows) * kRow);
    const auto idx = read<int>(f, static_cast<size_t>(blk) * kRow);
    out.assign(idx.size(), 0x7eadbeef);
    if (which == "col_gather")
      host_launch(col_gather_blocks(blk), 1, kColThreads, col_gather_kernel, tab.data(),
                  reinterpret_cast<const int4*>(idx.data()), reinterpret_cast<int4*>(out.data()),
                  blk * kRowVec);
    else
      host_launch(row_loop_blocks(blk), 1, kLoopRows * 32, row_loop_kernel,
                  reinterpret_cast<const int4*>(tab.data()), idx.data(),
                  reinterpret_cast<int4*>(out.data()), blk);
  } else if (which == "extract_sum") {
    const int rows = read<int>(f, 1)[0];
    const auto v = read<int>(f, static_cast<size_t>(rows) * kRow);
    out.assign(8 * kRow, 0x7eadbeef);
    host_launch(1, 1, kSumThreads, extract_sum_kernel, v.data(),
                reinterpret_cast<int4*>(out.data()));
  } else if (which == "gather_rows_async") {
    const auto hdr = read<int>(f, 3);
    const int rows = hdr[0], nb = hdr[1];
    const auto tab = read<int>(f, static_cast<size_t>(rows) * kRow);
    const auto ids = read<int>(f, static_cast<size_t>(nb) * kIds);
    out.assign(static_cast<size_t>(nb) * kIds * kRow, 0x7eadbeef);
    host_launch(nb, 1, 32,
                hdr[2] ? gather_rows_async_kernel<true> : gather_rows_async_kernel<false>,
                ids.data(), reinterpret_cast<const int4*>(tab.data()),
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
