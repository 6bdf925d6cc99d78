// A host stand-in for the CUDA runtime that lets a kernel of the port's
// csrc/ run on the CPU (tests/test_torch_march4_host.py,
// tests/test_torch_probes_host.py): host_launch runs each block's threads
// as std::threads, one block at a time; __syncthreads is a barrier among
// them, __reduce_add_sync one among a warp's; __shared__ arrays are static
// (one block runs at a time), __ldg a plain load. Built with
// -ffp-contract=off, as the kernels are with --fmad=false.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <deque>
#include <thread>
#include <vector>

using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static

struct HostDim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local HostDim3 threadIdx, blockIdx;
inline HostDim3 blockDim, gridDim;

struct int4 {
  int x, y, z, w;
};
struct float4 {
  float x, y, z, w;
};
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }

// The block's barrier, and each warp's barrier and exchange slots.
struct HostWarp {
  explicit HostWarp(std::ptrdiff_t lanes) : bar(lanes) {}
  std::barrier<> bar;
  unsigned slot[32] = {};
};
inline std::barrier<>* host_block_barrier = nullptr;
inline std::deque<HostWarp>* host_block_warps = nullptr;

inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }

// The sum over the calling warp (all its threads must call it).
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  HostWarp& w = (*host_block_warps)[threadIdx.x / 32];
  w.slot[threadIdx.x % 32] = v;
  w.bar.arrive_and_wait();
  unsigned s = 0;
  for (unsigned x : w.slot) s += x;
  w.bar.arrive_and_wait();  // every lane has read before a slot is reused
  return s;
}

template <class T>
inline T __ldg(const T* p) {
  return *p;
}
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
}

// Run kernel(args...) as every thread of a grid_x x grid_y grid of
// `threads`-thread blocks, one block after another.
template <class K, class... A>
void host_launch(unsigned grid_x, unsigned grid_y, unsigned threads, K kernel, A... args) {
  gridDim = {grid_x, grid_y, 1};
  blockDim = {threads, 1, 1};
  for (unsigned by = 0; by < grid_y; ++by)
    for (unsigned bx = 0; bx < grid_x; ++bx) {
      std::barrier<> bar(threads);
      std::deque<HostWarp> warps;
      for (unsigned w = 0; w < threads; w += 32) warps.emplace_back(min(32u, threads - w));
      host_block_barrier = &bar;
      host_block_warps = &warps;
      std::vector<std::thread> pool;
      for (unsigned t = 0; t < threads; ++t)
        pool.emplace_back([=] {
          threadIdx = {t, 0, 0};
          blockIdx = {bx, by, 0};
          kernel(args...);
        });
      for (auto& th : pool) th.join();
    }
}
