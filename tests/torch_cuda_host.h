// A host stand-in for the CUDA runtime that lets a kernel of the port's
// csrc/ run on the CPU (tests/test_torch_march4_host.py): each block's
// threads are std::threads, __syncthreads a barrier among them, __shared__
// arrays static (one block runs at a time), __ldg a plain load. Built
// with -ffp-contract=off, as the kernels are with --fmad=false.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>

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
inline std::barrier<>* host_block_barrier = nullptr;

inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
}
