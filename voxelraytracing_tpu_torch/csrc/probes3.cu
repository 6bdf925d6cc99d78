// Hopper counterparts of the TPU primitive probes (sm_90a): timing
// kernels of single primitives, each computing what its TPU probe
// computes, at the probe's shapes.
//
// Replaces the Pallas kernels of the two probe scripts:
//   experiments/v3_probe_prims.py
//     k_smem (:22, call :31)    -> gather_rows_smem_kernel
//     k_dma (:43, call :55)     -> gather_rows_async_kernel<kPipelined>
//     k_extract (:68, call :77) -> extract_sum_kernel
//     k_pass (:98, call :103)   -> pass7_kernel
//   experiments/v3_probe_subgather.py
//     k_gather (:10, call :25)  -> col_gather_kernel
//     k_loop (:13, call :25)    -> row_loop_kernel
//
// Some TPU probes repeat one block's work in every program of a grid
// (the grid runs in order on one core, every program writing the same
// output block). On this card the programs would all run at once, so the
// repeat is pure loss: extract_sum and col_gather compute their function
// once; row_loop still runs the probe's 256 programs.
//
// What each probes on this card, and what bounds it:
//   * gather_rows_smem: out[i, k, :] = tab[ids[i, k], :] for a block's 16
//     ids, staged in shared memory (the TPU probe's SMEM scalars), one warp
//     a row, 16-byte loads through the read-only path. Bytes: the rows,
//     the ids and the output. (The TPU kernel k_smem does not trace as
//     written, see the Python module; this is its intended function.)
//   * gather_rows_async: the same function as k_dma computes it: each row
//     copied by cp.async (16 B a lane) into shared memory, then one
//     coalesced store of the 16 rows. kPipelined = false waits for each
//     row before asking for the next (the probe's start(); wait()), true
//     keeps all 16 in flight. Bytes, or the latency of the serial chain.
//   * extract_sum: the wrapping int32 sum of v[0:64, 0], broadcast to an
//     (8, 128) block, by one block: 64 threads load one scalar each, two
//     warp reductions and a sum of the two partials in shared memory, then
//     each of 256 threads stores 16 bytes of the block. A launch and two
//     dependent memory round trips; its bytes are ~4.4 KB.
//   * pass7: seven f32 planes copied through, 64 rows a block (the probe's
//     508 programs), 16-byte loads and stores. Bytes: 2 x 7 planes.
//   * col_gather: out[j, l] = tab[idx[j, l], l] (take_along_axis), a grid
//     sized to the [blk, 128] output: each thread loads 4 ids of one row
//     in one coalesced 16-byte load, makes 4 independent __ldg gathers
//     from the L2-resident table, and stores 16 coalesced bytes. Latency
//     of the id load and the dependent gather; its bytes are ~97 KB.
//   * row_loop: out[j, :] = tab[idx[j, 0], :], the ids read in a loop, one
//     warp a row; every program writes the same block (the probe's 256).
//     Bytes.
//
// Every kernel takes ids in [0, rows): the wrappers do not read the ids
// (that would need a host sync inside the timed call).
//
// tests/torch_probes_host.cpp builds this file for the CPU with
// PROBES3_HOST_TEST defined, which leaves out the cp.async kernel and the
// CUDA launchers: keep any new CUDA-only code inside that #ifndef.

#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int kRow = 128;          // int32 words a table row
constexpr int kRowVec = kRow / 4;  // 16-byte vectors a row: one a lane
constexpr int kIds = 16;           // rows a gather block
constexpr int kExtract = 64;       // scalars summed by extract_sum
constexpr int kSumThreads = 8 * kRowVec;  // extract_sum: a 16-byte store each
constexpr int kPassRows = 64;      // rows a pass7 block
constexpr int kColThreads = 128;   // col_gather threads a block, 4 words each
constexpr unsigned kFull = 0xffffffffu;

// col_gather's grid: one thread for each 16 bytes of the [blk, 128] output
constexpr int col_gather_blocks(int blk) {
  return (blk * kRowVec + kColThreads - 1) / kColThreads;
}

__global__ void __launch_bounds__(128) gather_rows_smem_kernel(const int* __restrict__ ids,
                                                               const int4* __restrict__ tab,
                                                               int4* __restrict__ out) {
  __shared__ int sid[kIds];
  if (threadIdx.x < kIds) sid[threadIdx.x] = __ldg(ids + blockIdx.x * kIds + threadIdx.x);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = warp; k < kIds; k += 4)
    out[(static_cast<size_t>(blockIdx.x) * kIds + k) * kRowVec + lane] =
        __ldg(tab + static_cast<size_t>(sid[k]) * kRowVec + lane);
}

// One block of kSumThreads: thread t < 64 loads v[t, 0]; the sum is taken
// as unsigned, so it wraps as JAX's int32 sum does.
__global__ void __launch_bounds__(kSumThreads) extract_sum_kernel(const int* __restrict__ v,
                                                                  int4* __restrict__ out) {
  __shared__ unsigned part[kExtract / 32];
  const int t = threadIdx.x;
  if (t < kExtract) {  // whole warps
    const unsigned s = __reduce_add_sync(kFull, static_cast<unsigned>(__ldg(v + t * kRow)));
    if ((t & 31) == 0) part[t >> 5] = s;
  }
  __syncthreads();
  unsigned total = 0;
#pragma unroll
  for (int k = 0; k < kExtract / 32; ++k) total += part[k];
  const int s = static_cast<int>(total);
  out[t] = make_int4(s, s, s, s);
}

struct Planes7 {
  const float4* in[7];
  float4* out[7];
};

__global__ void __launch_bounds__(256) pass7_kernel(Planes7 p, int rows) {
  const size_t n = static_cast<size_t>(rows) * kRowVec;
  const size_t b0 = static_cast<size_t>(blockIdx.x) * kPassRows * kRowVec;
  for (int i = threadIdx.x; i < kPassRows * kRowVec; i += blockDim.x) {
    const size_t o = b0 + i;
    if (o >= n) break;
#pragma unroll
    for (int k = 0; k < 7; ++k) p.out[k][o] = __ldg(p.in[k] + o);
  }
}

// Thread i owns output words 4i..4i+3: row i / 32, lanes 4(i % 32) on.
__global__ void __launch_bounds__(kColThreads) col_gather_kernel(const int* __restrict__ tab,
                                                                 const int4* __restrict__ idx,
                                                                 int4* __restrict__ out,
                                                                 int n_vec) {
  const int i = blockIdx.x * kColThreads + threadIdx.x;
  if (i >= n_vec) return;
  const int4 id = __ldg(idx + i);
  const int* col = tab + (i % kRowVec) * 4;
  out[i] = make_int4(__ldg(col + static_cast<size_t>(id.x) * kRow),
                     __ldg(col + static_cast<size_t>(id.y) * kRow + 1),
                     __ldg(col + static_cast<size_t>(id.z) * kRow + 2),
                     __ldg(col + static_cast<size_t>(id.w) * kRow + 3));
}

__global__ void __launch_bounds__(128) row_loop_kernel(const int4* __restrict__ tab,
                                                       const int* __restrict__ idx,
                                                       int4* __restrict__ out, int blk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = warp; j < blk; j += 4)
    out[j * kRowVec + lane] =
        __ldg(tab + static_cast<size_t>(__ldg(idx + j * kRow)) * kRowVec + lane);
}

}  // namespace

#ifndef PROBES3_HOST_TEST
namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One warp a block: lane l copies bytes 16l..16l+15 of each row and
// stores the same bytes, so no lane reads another's copy.
template <bool kPipelined>
__global__ void __launch_bounds__(32) gather_rows_async_kernel(const int* __restrict__ ids,
                                                               const int4* __restrict__ tab,
                                                               int4* __restrict__ out) {
  __shared__ __align__(16) int4 buf[kIds * kRowVec];
  const int lane = threadIdx.x;
  const int* bid = ids + blockIdx.x * kIds;
  for (int k = 0; k < kIds; ++k) {
    cp_async16(&buf[k * kRowVec + lane], tab + static_cast<size_t>(__ldg(bid + k)) * kRowVec + lane);
    cp_async_commit();
    if (!kPipelined) cp_async_wait_all();
  }
  cp_async_wait_all();
  __syncwarp();
  int4* o = out + static_cast<size_t>(blockIdx.x) * kIds * kRowVec;
  for (int k = 0; k < kIds; ++k) o[k * kRowVec + lane] = buf[k * kRowVec + lane];
}

// Does nothing: its launch is the floor under every kernel's time.
__global__ void empty_kernel() {}

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// Each launcher enqueues one launch on `stream` and returns
// cudaGetLastError() (0 = cudaSuccess); the caller raises on anything
// else. Tables are int32 [rows, 128]; outputs are written whole.

// out[nb, 16, 128] = tab[ids[nb, 16], :]
extern "C" int gather_rows_smem_launch(const int* ids, const int* tab, int* out, int nb,
                                       cudaStream_t stream) {
  gather_rows_smem_kernel<<<nb, 128, 0, stream>>>(ids, reinterpret_cast<const int4*>(tab),
                                                  reinterpret_cast<int4*>(out));
  return last_error();
}

// the same function by cp.async row copies, serial or pipelined
extern "C" int gather_rows_async_launch(const int* ids, const int* tab, int* out, int nb,
                                        int pipelined, cudaStream_t stream) {
  auto kern = pipelined ? gather_rows_async_kernel<true> : gather_rows_async_kernel<false>;
  kern<<<nb, 32, 0, stream>>>(ids, reinterpret_cast<const int4*>(tab),
                              reinterpret_cast<int4*>(out));
  return last_error();
}

// out[8, 128] = wrapping sum of v[0:64, 0], by one block
extern "C" int extract_sum_launch(const int* v, int* out, cudaStream_t stream) {
  extract_sum_kernel<<<1, kSumThreads, 0, stream>>>(v, reinterpret_cast<int4*>(out));
  return last_error();
}

// out_k[rows, 128] = in_k for the seven f32 planes k
extern "C" int pass7_launch(const float* i0, const float* i1, const float* i2, const float* i3,
                            const float* i4, const float* i5, const float* i6, float* o0,
                            float* o1, float* o2, float* o3, float* o4, float* o5, float* o6,
                            int rows, cudaStream_t stream) {
  Planes7 p;
  const float* in[7] = {i0, i1, i2, i3, i4, i5, i6};
  float* out[7] = {o0, o1, o2, o3, o4, o5, o6};
  for (int k = 0; k < 7; ++k) {
    p.in[k] = reinterpret_cast<const float4*>(in[k]);
    p.out[k] = reinterpret_cast<float4*>(out[k]);
  }
  pass7_kernel<<<(rows + kPassRows - 1) / kPassRows, 256, 0, stream>>>(p, rows);
  return last_error();
}

// out[blk, 128] = take_along_axis(tab, idx, 0), one thread for each 16
// bytes of the output
extern "C" int col_gather_launch(const int* tab, const int* idx, int* out, int blk,
                                 cudaStream_t stream) {
  if (blk > 0)
    col_gather_kernel<<<col_gather_blocks(blk), kColThreads, 0, stream>>>(
        tab, reinterpret_cast<const int4*>(idx), reinterpret_cast<int4*>(out), blk * kRowVec);
  return last_error();
}

// out[j, :] = tab[idx[j, 0], :] for j < blk, by `programs` blocks
extern "C" int row_loop_launch(const int* tab, const int* idx, int* out, int blk, int programs,
                               cudaStream_t stream) {
  row_loop_kernel<<<programs, 128, 0, stream>>>(reinterpret_cast<const int4*>(tab), idx,
                                                reinterpret_cast<int4*>(out), blk);
  return last_error();
}

// one launch of a kernel that does nothing
extern "C" int empty_launch(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return last_error();
}
#endif  // PROBES3_HOST_TEST
