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
//   inputs : keys int32 or int64 (n)   group id = key - key_min, in 64 bits
//            valid bool (n) or none    a false row is a miss
//            vals int32 or int64 (n)
//   outputs: sums int64 (G), counts int64 (G)   zeroed by the wrapper
//   A row is a miss when it is not valid or its key lies outside
//   [key_min, key_min + G). The rebase is done in 64 bits before anything
//   is narrowed, so a key 2^32 away from the domain never wraps into it.
//
// What bounds it on the H100: the bytes of the columns, read once (17 B a
// row for int64 keys and values and a mask): 0.17 ms at 2^25 rows and the
// card's 3.35 TB/s. In the way stand the group domain (2^16 groups at 12 B
// of counters are 768 KB, against 227 KB of shared memory a block) and the
// zipf skew of the star rollup's keys (18% of the rows on id 0, 10% on the
// last id), which serialises atomics on a few addresses.
//
// The design:
//   a. The domain is interleaved over T = ceil(G / 8192) owners: id g lives
//      in owner g % T, slot g / T, so the hot head of a skewed domain (ids 0,
//      1, 2, ...) spreads over all owners. An owner's slots are 8192 * 12 B
//      = 96 KB of shared memory at most (u64 sum, u32 count).
//   b. Before any atomic, the lanes of a warp that hold the same id find each
//      other (__match_any_sync). Each group of at least agg_min lanes sums
//      its values in registers with one full-warp __reduce_add_sync per
//      16-bit piece (exact in 64 bits), in a warp-uniform loop over those
//      groups, and its lowest lane issues one count and one sum atomic; the
//      lanes of a smaller group add their own rows. agg_min is 2 where
//      updates cross the cluster (a remote atomic costs more than a warp
//      sum) and 8 where one CTA owns the whole domain (a local atomic costs
//      less). (__reduce_add_sync with a mask that differs between lanes runs
//      once per distinct mask, so per-group masks are avoided.)
//   c. The T owners of one copy of the domain form a thread block cluster
//      (T <= 8, portable). Every CTA streams an equal share of the rows
//      (a warp-uniform grid-stride loop, 4 consecutive rows a thread, 16-byte
//      loads where the pointers are aligned) and sends each aggregated update
//      to the owning CTA's shared memory through distributed shared memory.
//      cluster.sync() after zeroing and before the flush, so no CTA exits
//      while another still writes to it. So the input is read once.
//   d. The rebase, the miss test and the narrowing are done in registers, on
//      the columns as the executor stores them.
//   e. Where the caller bounds the values (0 <= v < 2^val_bits) and
//      2 * bits(n) + val_bits <= 64, the count rides in the high bits of the
//      sum's 64-bit cell: one remote atomic per update instead of two.
// At the end each CTA adds its non-empty slots to global memory, one 64-bit
// atomic each for the count and the sum. Sums accumulate as two's-complement
// uint64, exact while the int64 sum does not wrap; counts as uint32 per CTA
// (the wrapper keeps n < 2^31). Integer atomics are exact in any order, so
// the result equals the plain PyTorch version bit for bit.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: 0.651 ms
// on the star rollup's stored columns (2^25 zipf rows, G = 2^16, int64
// keys and values, a mask, val_bits 7), 26% of the 0.171 ms bound; the
// first version of this kernel with the route's former prelude took
// 6.869 ms in the same run. What holds it back is the remote (DSMEM)
// atomics for each warp's distinct ids: in csrc/baseline/variants.py a
// copy that sends every update to its own CTA runs in 0.445 ms and one
// with no atomics in 0.251 ms (against 0.638 ms). Uniform keys without a
// value bound (two remote atomics a row) take 0.867 ms on int32 gids,
// where the first version took 0.754 ms (PERF.md).
//
// Built with nvcc into a plain C shared library and called through ctypes
// (sqlrs_tpu_torch/utils/cuda_build.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define SQLRS_MAX_SLOTS 8192
#define SQLRS_MAX_GROUPS 65536
#define SQLRS_BLOCK 512

// rows r..r+3 of p; rows at or past n read as 0
template <typename T>
__device__ __forceinline__ void load_quad(const T* __restrict__ p, long long r,
                                          long long n, bool vec, T out[4]) {
  if (vec && r + 3 < n) {
    if constexpr (sizeof(T) == 8) {
      const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(p + r));
      const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(p + r + 2));
      out[0] = (T)a.x; out[1] = (T)a.y; out[2] = (T)b.x; out[3] = (T)b.y;
    } else if constexpr (sizeof(T) == 4) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(p + r));
      out[0] = (T)a.x; out[1] = (T)a.y; out[2] = (T)a.z; out[3] = (T)a.w;
    } else {
      const uchar4 a = __ldg(reinterpret_cast<const uchar4*>(p + r));
      out[0] = (T)a.x; out[1] = (T)a.y; out[2] = (T)a.z; out[3] = (T)a.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = r + j < n ? p[r + j] : (T)0;
  }
}

// The sum of v over the whole warp (every lane calls), exact modulo 2^64:
// 16-bit pieces, so 32 of them cannot carry out of 32 bits. A full-warp
// mask keeps __reduce_add_sync one instruction; a mask that differs between
// lanes runs once for each distinct mask.
__device__ __forceinline__ unsigned long long warp_sum(int32_t v) {
  const unsigned int lo = __reduce_add_sync(0xFFFFFFFFu, (unsigned int)v & 0xFFFFu);
  const int hi = __reduce_add_sync(0xFFFFFFFFu, v >> 16);
  return (unsigned long long)lo + ((unsigned long long)(long long)hi << 16);
}

__device__ __forceinline__ unsigned long long warp_sum(int64_t v) {
  const unsigned long long x = (unsigned long long)v;
  const unsigned int a = __reduce_add_sync(0xFFFFFFFFu, (unsigned int)(x & 0xFFFFu));
  const unsigned int b = __reduce_add_sync(0xFFFFFFFFu, (unsigned int)((x >> 16) & 0xFFFFu));
  const unsigned int c = __reduce_add_sync(0xFFFFFFFFu, (unsigned int)((x >> 32) & 0xFFFFu));
  const int d = __reduce_add_sync(0xFFFFFFFFu, (int)(v >> 48));
  return (unsigned long long)a + ((unsigned long long)b << 16) +
         ((unsigned long long)c << 32) + ((unsigned long long)(long long)d << 48);
}

template <typename KeyT, typename ValT, bool HAS_VALID>
__global__ void __launch_bounds__(SQLRS_BLOCK, 2)
dense_group_sums_kernel(const KeyT* __restrict__ keys,
                        const uint8_t* __restrict__ valid, long long key_min,
                        const ValT* __restrict__ vals, long long n, int G,
                        int owners, int slots, bool vec, int sum_bits, int agg_min,
                        unsigned long long* __restrict__ sums,
                        unsigned long long* __restrict__ counts) {
  extern __shared__ unsigned long long smem_u64[];
  unsigned long long* s_sum = smem_u64;                                   // [slots]
  unsigned int* s_cnt = reinterpret_cast<unsigned int*>(s_sum + slots);   // [slots]
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned int rank = cluster.block_rank();  // this CTA owns ids g % owners == rank

  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    s_sum[i] = 0ull;
    s_cnt[i] = 0u;
  }
  cluster.sync();  // every owner zeroed before any update reaches it

  const int lane = threadIdx.x & 31;
  const long long quads = (n + 3) >> 2;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  // warp-uniform bounds: every lane of a warp runs every step, as
  // __match_any_sync over the full warp needs
  for (long long q0 = warp * 32; q0 < quads; q0 += n_warps * 32) {
    const long long r = (q0 + lane) * 4;
    KeyT k[4];
    ValT v[4];
    uint8_t ok[4];
    load_quad(keys, r, n, vec, k);
    load_quad(vals, r, n, vec, v);
    if constexpr (HAS_VALID) load_quad(valid, r, n, vec, ok);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned long long off =
          (unsigned long long)(long long)k[j] - (unsigned long long)key_min;
      bool hit = r + j < n && off < (unsigned long long)G;
      if constexpr (HAS_VALID) hit = hit && ok[j] != 0;
      const unsigned int id = hit ? (unsigned int)off : 0xFFFFFFFFu;
      const unsigned int peers = __match_any_sync(0xFFFFFFFFu, id);
      const bool leader = hit && lane == __ffs(peers) - 1;
      const bool big = __popc(peers) >= agg_min;
      const ValT mine = hit ? v[j] : (ValT)0;
      unsigned long long total = (unsigned long long)(long long)mine;
      // the groups of agg_min or more lanes, one full-warp sum each (a
      // skewed warp has a few; a uniform one almost never has any); the
      // lanes of a smaller group add their own rows
      unsigned int multi = __ballot_sync(0xFFFFFFFFu, leader && big);
      while (multi) {
        const int first = __ffs(multi) - 1;
        multi &= multi - 1;
        const unsigned int group = __shfl_sync(0xFFFFFFFFu, peers, first);
        const unsigned long long s = warp_sum((group >> lane) & 1u ? mine : (ValT)0);
        if (lane == first) total = s;
      }
      if (hit && (leader || !big)) {
        const unsigned int owner = id % (unsigned int)owners;
        const unsigned int slot = id / (unsigned int)owners;
        const unsigned int count = big ? __popc(peers) : 1u;
        if (sum_bits) {  // packed: one atomic carries the count and the sum
          atomicAdd(cluster.map_shared_rank(s_sum, owner) + slot,
                    ((unsigned long long)count << sum_bits) + total);
        } else {
          atomicAdd(cluster.map_shared_rank(s_cnt, owner) + slot, count);
          if (total) atomicAdd(cluster.map_shared_rank(s_sum, owner) + slot, total);
        }
      }
    }
  }
  cluster.sync();  // every update in before any owner flushes and exits

  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    const unsigned long long cell = s_sum[s];
    const unsigned long long c = sum_bits ? cell >> sum_bits : s_cnt[s];
    if (c) {
      // only ids < G were ever added, so a ragged last slot stays empty
      const int g = s * owners + (int)rank;
      atomicAdd(&counts[g], c);
      atomicAdd(&sums[g], sum_bits ? cell & ((1ull << sum_bits) - 1) : cell);
    }
  }
}

template <typename KeyT, typename ValT, bool HAS_VALID>
static cudaError_t launch(const void* keys, const void* valid, long long key_min,
                          const void* vals, long long n, int G, int sum_bits,
                          void* sums, void* counts, cudaStream_t stream) {
  auto kern = dense_group_sums_kernel<KeyT, ValT, HAS_VALID>;
  const int owners = (G + SQLRS_MAX_SLOTS - 1) / SQLRS_MAX_SLOTS;
  const int slots = (G + owners - 1) / owners;
  const size_t smem = (size_t)slots * (sizeof(unsigned long long) + sizeof(unsigned int));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // the smallest group worth a warp sum: a remote atomic costs more than
  // a sum, a local one less (both measured on the H100, PERF.md)
  const int agg_min = owners > 1 ? 2 : 8;
  const bool vec = (uintptr_t)keys % 16 == 0 && (uintptr_t)vals % 16 == 0 &&
                   (!HAS_VALID || (uintptr_t)valid % 4 == 0);

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = owners;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(owners, 1, 1);
  config.blockDim = dim3(SQLRS_BLOCK, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  // as many clusters as can be resident at once, and no more than the rows
  // need (one step of a CTA covers 4 * SQLRS_BLOCK rows)
  int resident = 0;
  err = cudaOccupancyMaxActiveClusters(&resident, kern, &config);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  const long long per_cluster = 4ll * SQLRS_BLOCK * owners;
  const long long needed = (n + per_cluster - 1) / per_cluster;
  const long long clusters = needed < 1 ? 1 : (needed < resident ? needed : resident);
  config.gridDim = dim3((unsigned int)(clusters * owners), 1, 1);
  err = cudaLaunchKernelEx(&config, kern, (const KeyT*)keys, (const uint8_t*)valid,
                           key_min, (const ValT*)vals, n, G, owners, slots, vec,
                           sum_bits, agg_min, (unsigned long long*)sums, (unsigned long long*)counts);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Launches the kernel on `stream`. key_bytes and val_bytes are 4 or 8
// (int32 or int64); valid is a bool array or NULL. val_bits > 0 is the
// caller's word that 0 <= v < 2^val_bits for every row (0: no bound); where
// 2 * bits(n) + val_bits <= 64, a cell's count and sum share one 64-bit
// word (the sum in the low bits(n) + val_bits bits), so each update is one
// atomic instead of two. sums and counts must hold zeros. Returns a cudaError_t: the launch's result and then
// cudaGetLastError(), or the reason the launch was not made (a cluster
// shape the card refuses included).
extern "C" int sqlrs_dense_group_sums(const void* keys, int key_bytes,
                                      const void* valid, long long key_min,
                                      const void* vals, int val_bytes,
                                      int val_bits, long long n, int G,
                                      void* sums, void* counts, void* stream) {
  if (n < 0 || n >= (1ll << 31) || G < 1 || G > SQLRS_MAX_GROUPS || val_bits < 0 ||
      val_bits > 63)
    return (int)cudaErrorInvalidValue;
  const int n_bits = 64 - __builtin_clzll((unsigned long long)n | 1ull);
  const int sum_bits = val_bits > 0 && 2 * n_bits + val_bits <= 64 ? n_bits + val_bits : 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int which = (key_bytes == 8 ? 4 : key_bytes == 4 ? 0 : -100) +
                    (val_bytes == 8 ? 2 : val_bytes == 4 ? 0 : -100) +
                    (valid != nullptr ? 1 : 0);
  switch (which) {
    case 0: return (int)launch<int32_t, int32_t, false>(keys, valid, key_min, vals, n, G, sum_bits, sums, counts, s);
    case 1: return (int)launch<int32_t, int32_t, true>(keys, valid, key_min, vals, n, G, sum_bits, sums, counts, s);
    case 2: return (int)launch<int32_t, int64_t, false>(keys, valid, key_min, vals, n, G, sum_bits, sums, counts, s);
    case 3: return (int)launch<int32_t, int64_t, true>(keys, valid, key_min, vals, n, G, sum_bits, sums, counts, s);
    case 4: return (int)launch<int64_t, int32_t, false>(keys, valid, key_min, vals, n, G, sum_bits, sums, counts, s);
    case 5: return (int)launch<int64_t, int32_t, true>(keys, valid, key_min, vals, n, G, sum_bits, sums, counts, s);
    case 6: return (int)launch<int64_t, int64_t, false>(keys, valid, key_min, vals, n, G, sum_bits, sums, counts, s);
    case 7: return (int)launch<int64_t, int64_t, true>(keys, valid, key_min, vals, n, G, sum_bits, sums, counts, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
