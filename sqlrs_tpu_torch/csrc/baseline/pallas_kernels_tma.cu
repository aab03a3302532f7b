// VARIANT, not part of the engine: the rank stage's two in-block kernels
// (csrc/pallas_kernels.cu) with each tile's rows staged in shared memory by
// TMA bulk copies. Built and timed only by csrc/baseline/variants.py; no
// path of sqlrs_tpu_torch loads it. Same contract and C entry points as
// csrc/pallas_kernels.cu, for a 16-B aligned x2d only (vec must be 1).
//
// The card's counterpart of the Pallas kernel's scalar-prefetched per-step
// tile DMA (sqlrs_tpu/ops/pallas_kernels.py:71-89): a warp owns a ring of
// two tile buffers of 32 rows (16 KB each) and one mbarrier a buffer. While
// it reduces tile t from one buffer, the bulk copies of its next tile's
// rows (cp.async.bulk global -> shared, completion counted in bytes on the
// buffer's mbarrier) fill the other. Lane 0 arms the barrier with the
// tile's byte count; each lane issues the copy of its own query's row
// (masked_row_sum: only the 16-B chunks below rem). The reduction reads the
// buffer with the same 8-lanes-a-query mapping as the register kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#define SQLRS_ROW 128
#define SQLRS_TILE 32
#define SQLRS_ROUNDS 8
#define TMA_WARPS 2                          // warps a block
#define TILE_BYTES (SQLRS_TILE * SQLRS_ROW * 4)
#define SMEM_BYTES (TMA_WARPS * 2 * TILE_BYTES + TMA_WARPS * 2 * 8)

enum { OP_RANK = 0, OP_SUM = 1 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// spins on the barrier's phase; traps (a launch error, not a hang) if the
// copies never land
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 24)) asm volatile("trap;");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the bytes of its query's row that a lane copies: the whole row, or the
// 16-B chunks below rem
template <int OP>
__device__ __forceinline__ uint32_t row_bytes(bool live, int32_t s) {
  if (!live) return 0;
  if (OP == OP_RANK) return SQLRS_ROW * 4;
  const int chunks = s <= 0 ? 0 : (s >= SQLRS_ROW ? SQLRS_ROW / 4 : (s + 3) / 4);
  return (uint32_t)chunks * 16;
}

// tile t's rows into buf: lane l's query row to buf row l
template <int OP>
__device__ __forceinline__ void issue_tile(const int32_t* __restrict__ x2d, long long nb,
                                           const int32_t* __restrict__ block_idx,
                                           const int32_t* __restrict__ scalar, long long nq,
                                           long long t, int32_t* buf, uint64_t* bar, int lane) {
  const long long i = t * SQLRS_TILE + lane;
  const bool live = i < nq;
  long long b = live ? (long long)block_idx[i] : 0;
  b = b < 0 ? 0 : (b >= nb ? nb - 1 : b);
  const uint32_t bytes = row_bytes<OP>(live, live ? scalar[i] : 0);
  const uint32_t total = __reduce_add_sync(0xffffffffu, bytes);
  if (lane == 0) mbar_arrive_expect_tx(bar, total);
  if (bytes) bulk_copy(buf + lane * SQLRS_ROW, x2d + b * SQLRS_ROW, bytes, bar);
}

template <int OP>
__global__ void __launch_bounds__(TMA_WARPS * 32)
rank_stage_tma_kernel(const int32_t* __restrict__ x2d, long long nb,
                      const int32_t* __restrict__ block_idx, const int32_t* __restrict__ scalar,
                      long long nq, int32_t* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int group = lane >> 3;
  const int sub = lane & 7;
  int32_t* bufs = reinterpret_cast<int32_t*>(smem + (size_t)w * 2 * TILE_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + TMA_WARPS * 2 * TILE_BYTES) + 2 * w;
  if (lane == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  const long long warps = (long long)gridDim.x * TMA_WARPS;
  const long long tiles = (nq + SQLRS_TILE - 1) / SQLRS_TILE;
  long long t = (long long)blockIdx.x * TMA_WARPS + w;
  if (t < tiles) issue_tile<OP>(x2d, nb, block_idx, scalar, nq, t, bufs, &bars[0], lane);
  uint32_t phase = 0;  // bit k: the parity to wait for on buffer k
  int k = 0;
  for (; t < tiles; t += warps, k ^= 1) {
    if (t + warps < tiles)
      issue_tile<OP>(x2d, nb, block_idx, scalar, nq, t + warps,
                     bufs + (k ^ 1) * (TILE_BYTES / 4), &bars[k ^ 1], lane);
    const long long i = t * SQLRS_TILE + lane;
    const bool live = i < nq;
    const int32_t s = live ? scalar[i] : 0;
    mbar_wait(&bars[k], (phase >> k) & 1u);
    phase ^= 1u << k;
    const int32_t* buf = bufs + k * (TILE_BYTES / 4);
    int32_t mine = 0;
#pragma unroll
    for (int r = 0; r < SQLRS_ROUNDS; ++r) {
      const int j = 4 * r + group;
      const int32_t js = __shfl_sync(0xffffffffu, s, j);
      const int4* row = reinterpret_cast<const int4*>(buf + j * SQLRS_ROW);
      unsigned int a = 0;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int c = sub + 8 * kk;
        if (OP == OP_RANK) {
          const int4 v = row[c];
          a += (v.x >= js) + (v.y >= js) + (v.z >= js) + (v.w >= js);
        } else if (4 * c < js) {
          const int4 v = row[c];
          a += (4 * c < js ? (unsigned int)v.x : 0u) + (4 * c + 1 < js ? (unsigned int)v.y : 0u) +
               (4 * c + 2 < js ? (unsigned int)v.z : 0u) +
               (4 * c + 3 < js ? (unsigned int)v.w : 0u);
        }
      }
      a += __shfl_xor_sync(0xffffffffu, a, 4);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      const unsigned int got = __shfl_sync(0xffffffffu, a, (lane & 3) << 3);
      if ((lane >> 2) == r) mine = (int32_t)got;
    }
    if (live) out[i] = mine;
    // every lane's reads of this buffer before the next bulk copy into it
    __syncwarp();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
}

static const void* kernel_of(int op) {
  return op == OP_RANK ? (const void*)rank_stage_tma_kernel<OP_RANK>
                       : (const void*)rank_stage_tma_kernel<OP_SUM>;
}

extern "C" int sqlrs_rank_stage_grid(int op, int vec, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  if (!vec) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel_of(op), cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of(op), TMA_WARPS * 32,
                                                      SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  *grid = sms * (per_sm > 0 ? per_sm : 1);
  return 0;
}

template <int OP>
static int launch(const void* x2d, long long nb, const void* block_idx, const void* scalar,
                  long long nq, void* out, int vec, int grid, void* stream) {
  if (nb < 1 || nq < 1 || grid < 1 || !vec || ((uintptr_t)x2d & 15))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (nq + SQLRS_TILE - 1) / SQLRS_TILE;
  const long long need = (tiles + TMA_WARPS - 1) / TMA_WARPS;
  const unsigned int blocks = (unsigned int)(need < grid ? need : grid);
  rank_stage_tma_kernel<OP><<<blocks, TMA_WARPS * 32, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const int32_t*)x2d, nb, (const int32_t*)block_idx, (const int32_t*)scalar, nq,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int sqlrs_row_rank_ge(const void* sp2d, long long nb, const void* block_idx,
                                 const void* queries, long long nq, void* out, int vec,
                                 int grid, void* stream) {
  return launch<OP_RANK>(sp2d, nb, block_idx, queries, nq, out, vec, grid, stream);
}

extern "C" int sqlrs_masked_row_sum(const void* v2d, long long nb, const void* block_idx,
                                    const void* rem, long long nq, void* out, int vec,
                                    int grid, void* stream) {
  return launch<OP_SUM>(v2d, nb, block_idx, rem, nq, out, vec, grid, stream);
}
