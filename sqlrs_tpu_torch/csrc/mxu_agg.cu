// Dense-group sums and counts: the Hopper kernel behind
// sqlrs_tpu_torch/ops/mxu_agg.py (`dense_group_sums`).
//
// Replaces sqlrs_tpu/ops/mxu_agg.py::_mxu_kernel, the Pallas kernel that
// computes count(*) and sum(v) per dense group id with one-hot bf16 matmuls
// on the TPU's matrix unit (gid = hi * 256 + lo, 8-bit value limbs, f32
// accumulators carry-split every 32K rows, assembled into int64 outside the
// kernel). This port keeps the contract, not that formulation: on the H100
// the same result is an integer histogram with exact int64 totals.
//
//   inputs : gid int32 (n)   a value outside [0, G) is a miss
//            vals int32 (n)
//   outputs: sums int64 (G), counts int64 (G)   zeroed by the wrapper
//
// What bounds it on the H100: G up to 65536 groups do not fit one block's
// shared memory (a 64-bit sum and a 32-bit count per group is 768 KB at
// G = 2^16, against 227 KB). And the star rollup's keys are zipf-skewed:
// about 28% of the rows land on two groups, so one global atomic per row
// would serialise on those two addresses.
//
// What the design does about it: the group domain is cut into tiles of at
// most 8192 groups (96 KB of shared counters), one tile per blockIdx.y.
// Each block walks its share of the rows with a grid-stride loop (coalesced
// 4-byte loads, row offsets in 64 bits), skips the rows outside its tile,
// and adds the others with shared-memory atomics; at the end only the
// non-empty cells of the tile reach global memory, one 64-bit atomic each.
// Every tile reads the whole input, so the kernel reads G / 8192 times the
// 8 bytes a row (2.1 GB at G = 2^16 and 2^25 rows). Sums accumulate as
// two's-complement uint64, exact for any int32 values; counts as uint32 per
// block (the wrapper keeps n < 2^31). Integer atomics are exact in any
// order, so the result equals the plain PyTorch version bit for bit.
//
// Built with nvcc into a plain C shared library and called through ctypes
// (sqlrs_tpu_torch/utils/cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#define SQLRS_MAX_TILE 8192
#define SQLRS_MAX_GROUPS 65536

__global__ void dense_group_sums_kernel(const int32_t* __restrict__ gid,
                                        const int32_t* __restrict__ vals,
                                        long long n, int G, int tile,
                                        unsigned long long* __restrict__ sums,
                                        unsigned long long* __restrict__ counts) {
  extern __shared__ unsigned long long smem_u64[];
  const int lo = blockIdx.y * tile;
  const int width = min(tile, G - lo);
  unsigned long long* s_sum = smem_u64;                                   // [width]
  unsigned int* s_cnt = reinterpret_cast<unsigned int*>(s_sum + width);   // [width]

  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    s_sum[i] = 0ull;
    s_cnt[i] = 0u;
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    // unsigned difference: a miss (< 0 or >= G) or another tile's group
    // lands at or above width
    const unsigned int off = (unsigned int)gid[r] - (unsigned int)lo;
    if (off >= (unsigned int)width) continue;
    atomicAdd(&s_cnt[off], 1u);
    const int v = vals[r];
    if (v) atomicAdd(&s_sum[off], (unsigned long long)(long long)v);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    const unsigned int c = s_cnt[i];
    if (c) {
      atomicAdd(&counts[lo + i], (unsigned long long)c);
      atomicAdd(&sums[lo + i], s_sum[i]);
    }
  }
}

// Launches the kernel on `stream` over a (grid_x, ceil(G / tile)) grid.
// sums and counts must hold zeros. Returns a cudaError_t: the result of
// cudaGetLastError() right after the launch, or the reason the launch was
// not made.
extern "C" int sqlrs_dense_group_sums(const void* gid, const void* vals,
                                      long long n, int G, int tile, void* sums,
                                      void* counts, int grid_x, int block,
                                      void* stream) {
  if (n < 0 || n >= (1ll << 31) || G < 1 || G > SQLRS_MAX_GROUPS || tile < 1 ||
      tile > SQLRS_MAX_TILE || grid_x < 1 || block < 1)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (G + tile - 1) / tile;
  const size_t smem = (size_t)tile * (sizeof(unsigned long long) + sizeof(unsigned int));
  cudaError_t err = cudaFuncSetAttribute(
      dense_group_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dense_group_sums_kernel<<<dim3(grid_x, n_tiles), block, smem,
                            (cudaStream_t)stream>>>(
      (const int32_t*)gid, (const int32_t*)vals, n, G, tile,
      (unsigned long long*)sums, (unsigned long long*)counts);
  return (int)cudaGetLastError();
}
