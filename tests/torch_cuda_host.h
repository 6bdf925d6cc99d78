// A host stand-in for the CUDA runtime that lets a kernel of the port's
// csrc/ run on the CPU (tests/test_torch_march4_host.py,
// tests/test_torch_planes4_host.py, tests/test_torch_pt4_host.py,
// tests/test_torch_probes_host.py, tests/test_torch_march3_host.py,
// tests/test_torch_march2_host.py): a block's threads run as std::threads;
// __syncthreads (and __syncthreads_or) is a barrier among them, __syncwarp
// and the warp intrinsics (ballot, shuffles, reductions) one among a
// warp's; __ldg is a plain load, atomicAdd a locked add. host_launch runs
// one block at a time on one pool of threads, and aborts a launch that
// stops making progress (where the card would hang); __shared__ arrays
// are static. The runtime calls of csrc/smem_optin.cuh record what they
// set.
// host_launch_cluster runs the blocks of a thread-block cluster together,
// each with its own dynamic shared memory (DYN_SMEM), and gives them
// cooperative_groups' cluster: its rank, its barrier and the mapping of a
// shared address into another block of the cluster. cp.async copies
// (cuda_pipeline.h) are plain copies. Built with
// -ffp-contract=off, as the kernels are with --fmad=false.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <condition_variable>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __cluster_dims__(...)
#define __restrict__
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

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

// A warp's barrier and exchange slots.
struct HostWarp {
  explicit HostWarp(std::ptrdiff_t lanes) : bar(lanes) {}
  std::barrier<> bar;
  unsigned slot[32] = {};
};

// A block: its barrier, its warps, its dynamic shared memory and the
// rotating words of __syncthreads_or.
struct HostBlock {
  HostBlock(unsigned threads, std::size_t smem_bytes) : bar(threads), smem(smem_bytes) {
    for (unsigned w = 0; w < threads; w += 32) warps.emplace_back(min(32u, threads - w));
  }
  std::barrier<> bar;
  std::deque<HostWarp> warps;
  std::vector<unsigned char> smem;
  std::atomic<int> acc[3] = {};
};

// The blocks of one cluster, and the barrier of all their threads.
struct HostCluster {
  explicit HostCluster(std::ptrdiff_t threads) : bar(threads) {}
  std::barrier<> bar;
  std::vector<HostBlock*> blocks;
};

inline thread_local HostBlock* host_block = nullptr;
inline thread_local HostCluster* host_cluster = nullptr;
inline thread_local unsigned host_rank = 0;
inline thread_local unsigned host_or_calls = 0;

// A kernel's dynamic shared memory: its block's own buffer.
#define DYN_SMEM(name) unsigned char* name = host_block->smem.data()

inline void __syncthreads() { host_block->bar.arrive_and_wait(); }
inline HostWarp& host_warp() { return host_block->warps[threadIdx.x / 32]; }
inline void __syncwarp(unsigned = 0xffffffffu) { host_warp().bar.arrive_and_wait(); }

// Nonzero when p is nonzero for some thread of the block. Call n ORs into
// word n % 3 and thread 0 clears word (n + 1) % 3 before the barrier: the
// last reads of that word (call n - 2) ended before call n - 1's barrier.
inline int __syncthreads_or(int p) {
  HostBlock& b = *host_block;
  const unsigned n = host_or_calls++;
  if (threadIdx.x == 0) b.acc[(n + 1) % 3].store(0);
  if (p) b.acc[n % 3].fetch_or(1);
  b.bar.arrive_and_wait();
  return b.acc[n % 3].load();
}

// Every lane's 32-bit word of the calling warp (all its threads call it).
inline const unsigned* host_exchange(unsigned v) {
  HostWarp& w = host_warp();
  w.slot[threadIdx.x % 32] = v;
  w.bar.arrive_and_wait();
  return w.slot;
}
inline void host_exchange_done() { host_warp().bar.arrive_and_wait(); }

// The sum over the calling warp.
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  const unsigned* s = host_exchange(v);
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r += s[i];
  host_exchange_done();  // every lane has read before a slot is reused
  return r;
}

// The minimum over the calling warp, as signed words.
inline int __reduce_min_sync(unsigned, int v) {
  const unsigned* s = host_exchange(static_cast<unsigned>(v));
  int r = static_cast<int>(s[0]);
  for (int i = 1; i < 32; ++i) r = min(r, static_cast<int>(s[i]));
  host_exchange_done();
  return r;
}

// Whether p is nonzero for some lane of the calling warp.
inline int __any_sync(unsigned, int p) {
  const unsigned* s = host_exchange(p != 0);
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= s[i];
  host_exchange_done();
  return static_cast<int>(r);
}

// Bit k set where lane k's p is nonzero.
inline unsigned __ballot_sync(unsigned, int p) {
  const unsigned* s = host_exchange(p != 0);
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= s[i] << i;
  host_exchange_done();
  return r;
}

inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }

// The word of lane `src`.
template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  static_assert(sizeof(T) == 4);
  unsigned u;
  std::memcpy(&u, &v, 4);
  const unsigned* s = host_exchange(u);
  u = s[src & 31];
  host_exchange_done();
  T r;
  std::memcpy(&r, &u, 4);
  return r;
}

// The word of lane (lane ^ m).
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int m) {
  static_assert(sizeof(T) == 4);
  unsigned u;
  std::memcpy(&u, &v, 4);
  const unsigned* s = host_exchange(u);
  u = s[(threadIdx.x % 32) ^ static_cast<unsigned>(m)];
  host_exchange_done();
  T r;
  std::memcpy(&r, &u, 4);
  return r;
}

inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }

inline int atomicCAS(int* p, int expected, int desired) {
  __atomic_compare_exchange_n(p, &expected, desired, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST);
  return expected;
}

// cp.async's primitives (cuda_pipeline.h): the copy lands at once, so
// commit and wait have nothing to do.
inline void __pipeline_memcpy_async(void* dst, const void* src, std::size_t size,
                                    std::size_t = 0) {
  std::memcpy(dst, src, size);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(std::size_t) {}

// The runtime calls of csrc/smem_optin.cuh: a current device the driver
// sets (host_device), whether every stream is capturing (host_capturing),
// and cudaFuncSetAttribute, which records each call for the driver to
// show. Error codes and enumerators carry the CUDA runtime's values.
using cudaStream_t = void*;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidDevice = 101,
                   cudaErrorStreamCaptureUnsupported = 900 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaStreamCaptureStatus { cudaStreamCaptureStatusNone = 0,
                               cudaStreamCaptureStatusActive = 1 };
struct HostFuncAttr {
  int device;
  const void* kernel;
  int attr, value;
};
inline int host_device = 0;
inline bool host_capturing = false;
inline std::vector<HostFuncAttr> host_func_attrs;
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = host_device;
  return cudaSuccess;
}
inline cudaError_t cudaStreamIsCapturing(cudaStream_t, cudaStreamCaptureStatus* status) {
  *status = host_capturing ? cudaStreamCaptureStatusActive : cudaStreamCaptureStatusNone;
  return cudaSuccess;
}
inline cudaError_t cudaFuncSetAttribute(const void* kernel, cudaFuncAttribute attr, int value) {
  host_func_attrs.push_back({host_device, kernel, static_cast<int>(attr), value});
  return cudaSuccess;
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

namespace cooperative_groups {
// The calling block's cluster (host_launch_cluster's blocks).
struct cluster_group {
  unsigned block_rank() const { return host_rank; }
  void sync() const { host_cluster->bar.arrive_and_wait(); }
  // The address in block `rank` of the cluster that `p`, an address in
  // the calling block's dynamic shared memory, names there.
  template <class T>
  T* map_shared_rank(T* p, unsigned rank) const {
    const auto off = reinterpret_cast<unsigned char*>(p) - host_block->smem.data();
    return reinterpret_cast<T*>(host_cluster->blocks[rank]->smem.data() + off);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups

// Run kernel(args...) as every thread of a grid of grid_x blocks of
// `threads` threads, in clusters of `cluster` blocks (grid_x a multiple of
// it) with `smem_bytes` of dynamic shared memory each: the blocks of a
// cluster together, one cluster after another.
template <class K, class... A>
void host_launch_cluster(unsigned grid_x, unsigned cluster, unsigned threads,
                         std::size_t smem_bytes, K kernel, A... args) {
  gridDim = {grid_x, 1, 1};
  blockDim = {threads, 1, 1};
  for (unsigned c0 = 0; c0 < grid_x; c0 += cluster) {
    HostCluster cl(static_cast<std::ptrdiff_t>(cluster) * threads);
    std::deque<HostBlock> blocks;
    for (unsigned r = 0; r < cluster; ++r) {
      blocks.emplace_back(threads, smem_bytes);
      cl.blocks.push_back(&blocks.back());
    }
    std::vector<std::thread> pool;
    for (unsigned r = 0; r < cluster; ++r)
      for (unsigned t = 0; t < threads; ++t)
        pool.emplace_back([=, &cl] {
          threadIdx = {t, 0, 0};
          blockIdx = {c0 + r, 0, 0};
          host_block = cl.blocks[r];
          host_cluster = &cl;
          host_rank = r;
          kernel(args...);
        });
    for (auto& th : pool) th.join();
  }
}

// Run kernel(args...) as every thread of a grid_x x grid_y grid of
// `threads`-thread blocks, one block after another, on one pool of
// `threads` std::threads (thread t of every block). A launch in which no
// thread finishes a block for `timeout_s` seconds waits on a barrier or
// a warp collective that some thread never reaches (one that returned
// early or took another branch), where the card would hang: the process
// aborts with a message.
template <class K, class... A>
void host_launch(unsigned grid_x, unsigned grid_y, unsigned threads, K kernel, A... args) {
  constexpr int timeout_s = 60;
  gridDim = {grid_x, grid_y, 1};
  blockDim = {threads, 1, 1};
  const unsigned nblocks = grid_x * grid_y;
  std::deque<HostBlock> blocks;
  for (unsigned b = 0; b < nblocks; ++b) blocks.emplace_back(threads, 0);
  std::barrier<> next(threads);  // every thread is done with a block before the next
  std::mutex mu;
  std::condition_variable cv;
  unsigned long done = 0;
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < threads; ++t)
    pool.emplace_back([&, t] {
      threadIdx = {t, 0, 0};
      for (unsigned b = 0; b < nblocks; ++b) {
        blockIdx = {b % grid_x, b / grid_x, 0};
        host_block = &blocks[b];
        kernel(args...);
        {
          std::lock_guard<std::mutex> lock(mu);
          ++done;
        }
        cv.notify_one();
        next.arrive_and_wait();
      }
    });
  {
    std::unique_lock<std::mutex> lock(mu);
    for (unsigned long seen = 0; seen < static_cast<unsigned long>(nblocks) * threads;
         seen = done) {
      if (!cv.wait_for(lock, std::chrono::seconds(timeout_s), [&] { return done != seen; })) {
        std::fprintf(stderr, "host_launch: no thread finished a block for %d s: a barrier or "
                     "warp collective waits on a thread that never reaches it, where the "
                     "card would hang\n", timeout_s);
        std::abort();
      }
    }
  }
  for (auto& th : pool) th.join();
}
