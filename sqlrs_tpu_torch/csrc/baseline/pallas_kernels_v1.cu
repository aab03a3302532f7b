// BASELINE, not part of the engine: the first version of these kernels
// (commit 47aecc6), kept unchanged but for its symbol names (suffix _v1)
// so that chip_smoke.py can build it beside the current kernels and time
// both in one run. No path of sqlrs_tpu_torch loads it.
//
// The two in-block steps of the star rollup's rank stage: the Hopper kernels
// behind sqlrs_tpu_torch/ops/pallas_kernels.py (`row_rank_ge`,
// `masked_row_sum`).
//
// Replace sqlrs_tpu/ops/pallas_kernels.py::_rank_kernel and
// ::_masked_sum_kernel. Those run one grid step per query on the TPU's
// sequential grid, with the query's block index scalar-prefetched so that
// each step's BlockSpec DMA fetches the data-dependent (8, 128) tile that
// holds the row, and reduce the row in a (1, 128) vector.
//
//   row_rank_ge   : out[i] = #{ j < 128 : x2d[b_i][j] >= q[i] }
//   masked_row_sum: out[i] = sum_{ j < rem[i] } x2d[b_i][j]   (int32, wraps)
//   with b_i = clamp(block_idx[i], 0, nb - 1)
//
// What bounds it on the H100: memory latency. Each query reads one
// data-dependent 512-byte row, so the work is a batch of independent
// gathers with a few integer operations each.
//
// What the design does about it: one warp per query, eight per block, so
// many rows are in flight on every SM. Lane l reads words l, l+32, l+64 and
// l+96 of the row, each load coalesced across the warp into 128 contiguous
// bytes, and a shuffle reduction sums the lanes' partial counts. The sum
// runs in uint32, which wraps exactly as the reference's int32 sum does.
//
// Built with nvcc into a plain C shared library and called through ctypes
// (sqlrs_tpu_torch/utils/cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#define SQLRS_ROW 128

__device__ __forceinline__ unsigned int warp_sum(unsigned int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the row of query w, its block index clamped into [0, nb)
__device__ __forceinline__ const int32_t* query_row(const int32_t* x2d, long long nb,
                                                    const int32_t* block_idx,
                                                    long long w) {
  long long b = block_idx[w];
  b = b < 0 ? 0 : (b >= nb ? nb - 1 : b);
  return x2d + b * SQLRS_ROW;
}

__global__ void row_rank_ge_kernel_v1(const int32_t* __restrict__ x2d, long long nb,
                                   const int32_t* __restrict__ block_idx,
                                   const int32_t* __restrict__ queries,
                                   long long nq, int32_t* __restrict__ out) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= nq) return;  // the whole warp shares w
  const int32_t* row = query_row(x2d, nb, block_idx, w);
  const int32_t q = queries[w];
  unsigned int c = 0;
#pragma unroll
  for (int j = 0; j < SQLRS_ROW; j += 32) c += row[lane + j] >= q ? 1u : 0u;
  c = warp_sum(c);
  if (lane == 0) out[w] = (int32_t)c;
}

__global__ void masked_row_sum_kernel_v1(const int32_t* __restrict__ x2d, long long nb,
                                      const int32_t* __restrict__ block_idx,
                                      const int32_t* __restrict__ rem,
                                      long long nq, int32_t* __restrict__ out) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= nq) return;
  const int32_t* row = query_row(x2d, nb, block_idx, w);
  const int32_t r = rem[w];
  unsigned int s = 0;
#pragma unroll
  for (int j = 0; j < SQLRS_ROW; j += 32)
    if (lane + j < r) s += (unsigned int)row[lane + j];
  s = warp_sum(s);
  if (lane == 0) out[w] = (int32_t)s;
}

static int launch_checks(long long nb, long long nq, int block) {
  if (nb < 1 || nq < 1 || block < 32 || block % 32 != 0 || block > 1024)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Each entry launches its kernel on `stream` with `block` threads a block
// (block / 32 queries) and returns a cudaError_t: the result of
// cudaGetLastError() right after the launch, or the reason the launch was
// not made.
extern "C" int sqlrs_row_rank_ge_v1(const void* sp2d, long long nb,
                                 const void* block_idx, const void* queries,
                                 long long nq, void* out, int block,
                                 void* stream) {
  int bad = launch_checks(nb, nq, block);
  if (bad) return bad;
  const long long qpb = block / 32;
  row_rank_ge_kernel_v1<<<(unsigned int)((nq + qpb - 1) / qpb), block, 0,
                       (cudaStream_t)stream>>>(
      (const int32_t*)sp2d, nb, (const int32_t*)block_idx,
      (const int32_t*)queries, nq, (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int sqlrs_masked_row_sum_v1(const void* v2d, long long nb,
                                    const void* block_idx, const void* rem,
                                    long long nq, void* out, int block,
                                    void* stream) {
  int bad = launch_checks(nb, nq, block);
  if (bad) return bad;
  const long long qpb = block / 32;
  masked_row_sum_kernel_v1<<<(unsigned int)((nq + qpb - 1) / qpb), block, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)v2d, nb, (const int32_t*)block_idx,
      (const int32_t*)rem, nq, (int32_t*)out);
  return (int)cudaGetLastError();
}
