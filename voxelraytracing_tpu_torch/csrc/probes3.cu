// Hopper counterparts of the TPU primitive probes (sm_90a): timing
// kernels of single primitives, each computing what its TPU probe
// computes, at the probe's shapes and program counts.
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
//     (8, 128) block. A warp reads the tile row by row (16 B a lane) and
//     pulls each row's first word out of lane 0 with __shfl_sync, as the
//     probe pulls a scalar out of a vector register. Every program writes
//     the same block. Latency (64 dependent extracts), not bytes.
//   * pass7: seven f32 planes copied through, 64 rows a block (the probe's
//     508 programs), 16-byte loads and stores. Bytes: 2 x 7 planes.
//   * col_gather: out[j, l] = tab[idx[j, l], l], one thread a lane, a
//     per-lane __ldg gather from the L2-resident table; every program
//     writes the same [64, 128] block (the probe's grid of 256). Bytes.
//   * row_loop: out[j, :] = tab[idx[j, 0], :], the ids read in a loop, one
//     warp a row; every program writes the same block. Bytes.
//
// Every kernel takes ids in [0, rows): the wrappers do not read the ids
// (that would need a host sync inside the timed call).

#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int kRow = 128;          // int32 words a table row
constexpr int kRowVec = kRow / 4;  // 16-byte vectors a row: one a lane
constexpr int kIds = 16;           // rows a gather block
constexpr int kExtract = 64;       // scalars summed by extract_sum
constexpr int kPassRows = 64;      // rows a pass7 block
constexpr unsigned kFull = 0xffffffffu;

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

__global__ void __launch_bounds__(128) extract_sum_kernel(const int4* __restrict__ v,
                                                          int* __restrict__ out) {
  __shared__ unsigned total;
  if (threadIdx.x < 32) {
    unsigned acc = 0;  // unsigned: the sum wraps as JAX's int32 sum does
    for (int j = 0; j < kExtract; ++j) {
      const int4 w = __ldg(v + j * kRowVec + threadIdx.x);
      acc += static_cast<unsigned>(__shfl_sync(kFull, w.x, 0));
    }
    if (threadIdx.x == 0) total = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 8 * kRow; i += blockDim.x) out[i] = static_cast<int>(total);
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

__global__ void __launch_bounds__(kRow) col_gather_kernel(const int* __restrict__ tab,
                                                          const int* __restrict__ idx,
                                                          int* __restrict__ out, int blk) {
  const int l = threadIdx.x;
#pragma unroll 8
  for (int j = 0; j < blk; ++j)
    out[j * kRow + l] = __ldg(tab + static_cast<size_t>(__ldg(idx + j * kRow + l)) * kRow + l);
}

__global__ void __launch_bounds__(128) row_loop_kernel(const int4* __restrict__ tab,
                                                       const int* __restrict__ idx,
                                                       int4* __restrict__ out, int blk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = warp; j < blk; j += 4)
    out[j * kRowVec + lane] =
        __ldg(tab + static_cast<size_t>(__ldg(idx + j * kRow)) * kRowVec + lane);
}

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

// out[8, 128] = wrapping sum of v[0:64, 0], by `programs` blocks
extern "C" int extract_sum_launch(const int* v, int* out, int programs, cudaStream_t stream) {
  extract_sum_kernel<<<programs, 128, 0, stream>>>(reinterpret_cast<const int4*>(v), out);
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

// out[blk, 128] = take_along_axis(tab, idx, 0), by `programs` blocks
extern "C" int col_gather_launch(const int* tab, const int* idx, int* out, int blk, int programs,
                                 cudaStream_t stream) {
  col_gather_kernel<<<programs, kRow, 0, stream>>>(tab, idx, out, blk);
  return last_error();
}

// out[j, :] = tab[idx[j, 0], :] for j < blk, by `programs` blocks
extern "C" int row_loop_launch(const int* tab, const int* idx, int* out, int blk, int programs,
                               cudaStream_t stream) {
  row_loop_kernel<<<programs, 128, 0, stream>>>(reinterpret_cast<const int4*>(tab), idx,
                                                reinterpret_cast<int4*>(out), blk);
  return last_error();
}
