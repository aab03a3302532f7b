// Exact grouped histogram for small group domains: the Hopper kernel behind
// sqlrs_tpu_torch/ops/mxu_grouped.py (`grouped_histogram`).
//
// Replaces sqlrs_tpu/ops/mxu_grouped.py::_kernel, the Pallas kernel that sums
// a count channel and 8-bit limb channels per group with one-hot bf16
// matmuls on the TPU's matrix unit (carry-split f32 accumulators, plus a
// running minimum of each group's first 2048-row block and a (G, 2048)
// gather afterwards to find the exact first row). This port keeps the
// contract, not that formulation: on the H100 the same result is an integer
// histogram with exact int64 totals.
//
//   inputs : gid int32 (n)            a value outside [0, G) is a miss
//            words int32 (n_words, n)  24-bit value words, row-major
//            limb plan (word, shift)   channel 1+i sums (words[w_i] >> s_i) & 255
//   outputs: totals int64 (nch, G)     channel 0 counts the in-range rows
//            first_row int64 (G)       smallest row with that gid, or INT64_MAX
//
// What bounds it on the H100: memory traffic. Each row is read once,
// (1 + n_words) * 4 bytes, and costs a handful of integer operations, so the
// kernel is a streaming pass at best at the card's 3.35 TB/s (0.057 ms at
// TPC-H Q1's SF1 shape). In the way stand shared-memory atomics: Q1 has 4
// groups and 15 channels, and about half its rows fall in one group, so a
// warp's atomic on a channel replays about 16 times on one address.
//
// The design:
//   - Each thread takes 4 consecutive rows at a time: 16-byte loads of gid
//     and of each word where the tensors allow it (aligned, n % 4 == 0), and
//     each word is loaded once for all the channels cut from it.
//   - Small domains (a block's per-thread histograms, (nch * 4 + 8) * G
//     bytes a thread, fit 96 KB; Q1: 272 B): every thread owns its
//     histogram in shared memory, laid out [cell][thread], so a row costs a
//     load, an add and a store per channel: no atomic, no replay, no bank
//     conflict, whatever the skew. A thread meets its rows in increasing
//     order, so its first row of a group is the first it sees. At the end
//     one warp per cell sums the block's copies (shuffles) and adds the
//     total to global memory. The grid is what fits at once on the card.
//   - Larger domains: per-warp private histograms, uint32 [copies][nch][G],
//     where copies of nch * G cells fit a 32 KB budget (one copy at least),
//     merged once per block. Warp aggregation: the lanes holding one gid find
//     each other (__match_any_sync); the group's lowest lane adds the
//     group's count (__popc of the match). A group of at least 16 lanes sums
//     each channel's limbs with one full-warp __reduce_add_sync, in a
//     warp-uniform loop over those groups, and its lowest lane issues one
//     atomic per channel; the lanes of a smaller group add their own limbs
//     (a few replays cost less than a warp sum). The lowest lane's row is the
//     group's smallest, so it alone updates the first row (atomicMin after a
//     read: rows only decrease, so a stale read costs at most a redundant
//     atomicMin).
//   Only nonzero totals reach global memory, one 64-bit atomic each.
// A block covers at most 2^24 rows (the wrapper and the launch check), and
// 255 * 2^24 < 2^32, so no 32-bit cell overflows, in any copy.
// Integer atomics are exact in any order, so the totals equal the plain
// PyTorch version bit for bit.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: 0.113 ms
// at TPC-H Q1's SF1 shape (6,003,276 rows, Q1's group ids, 15 channels over
// 7 words: the per-thread path), 51% of the 0.057 ms bound; the first
// version of this kernel took 0.226 ms in the same run (PERF.md).
//
// Built with nvcc into a plain C shared library and called through ctypes
// (sqlrs_tpu_torch/utils/cuda_build.py).

#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

#define SQLRS_MAX_LIMBS 31  // nch <= 32: the count channel + 31 limb channels
#define SQLRS_MAX_GROUPS 1024
#define SQLRS_COPY_BUDGET (32 * 1024)  // bytes of per-warp histogram copies
#define SQLRS_PRIVATE_BUDGET (96 * 1024)  // bytes of per-thread histograms a block
// the smallest group worth a warp sum per channel: below it, a shared
// atomic's replays cost less (measured on the H100 at Q1's shape, PERF.md)
#define SQLRS_AGG_MIN_LANES 16

struct LimbPlan {
  int word[SQLRS_MAX_LIMBS];
  int shift[SQLRS_MAX_LIMBS];
};

// rows r..r+3 of p; rows at or past n read as -1
__device__ __forceinline__ void load_quad(const int32_t* __restrict__ p, long long r,
                                          long long n, bool vec, int out[4]) {
  if (vec && r + 3 < n) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(p + r));
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = r + j < n ? p[r + j] : -1;
  }
}

// Small domains: every thread owns a histogram, uint32 [nch * G] cells and
// int64 first rows [G], laid out [cell][thread] in shared memory, so a row
// costs a load, an add and a store per channel, with no atomic and no bank
// conflict. Each warp then merges cells across the block's threads.
__global__ void grouped_histogram_private_kernel(const int32_t* __restrict__ gid,
                                                 const int32_t* __restrict__ words,
                                                 long long n, int n_limbs, LimbPlan plan,
                                                 int G, bool vec,
                                                 unsigned long long* __restrict__ totals,
                                                 long long* __restrict__ first_row) {
  extern __shared__ unsigned long long smem_u64[];
  const int T = blockDim.x, t = threadIdx.x;
  const int cells = (1 + n_limbs) * G;
  long long* p_first = reinterpret_cast<long long*>(smem_u64);           // [G][T]
  unsigned int* p_acc = reinterpret_cast<unsigned int*>(p_first + G * T);  // [cells][T]
  for (int i = 0; i < cells; ++i) p_acc[i * T + t] = 0u;
  for (int i = 0; i < G; ++i) p_first[i * T + t] = LLONG_MAX;

  const long long quads = (n + 3) >> 2;
  for (long long q = (long long)blockIdx.x * T + t; q < quads; q += (long long)gridDim.x * T) {
    const long long r = q * 4;
    int g[4];
    load_quad(gid, r, n, vec, g);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if ((unsigned int)g[j] >= (unsigned int)G) continue;  // a miss, or past the end
      p_acc[g[j] * T + t] += 1u;
      // a thread meets its rows in increasing order: its first is its least
      long long* f = &p_first[g[j] * T + t];
      if (*f == LLONG_MAX) *f = r + j;
    }
    int cur = -1;
    int w[4];
    for (int c = 0; c < n_limbs; ++c) {
      if (plan.word[c] != cur) {  // each word once for all its channels
        cur = plan.word[c];
        load_quad(words + (long long)cur * n, r, n, vec, w);
      }
      const int shift = plan.shift[c];
      unsigned int* chan = p_acc + (c + 1) * G * T + t;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if ((unsigned int)g[j] < (unsigned int)G) chan[g[j] * T] += ((unsigned int)w[j] >> shift) & 255u;
    }
  }
  __syncthreads();

  // one warp per cell: lanes read consecutive threads' copies
  const int lane = t & 31, warp = t >> 5, n_warps = T >> 5;
  for (int i = warp; i < cells; i += n_warps) {
    unsigned long long v = 0;
    for (int k = lane; k < T; k += 32) v += p_acc[i * T + k];
    for (int o = 16; o; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
    if (lane == 0 && v) atomicAdd(&totals[i], v);
  }
  for (int i = warp; i < G; i += n_warps) {
    long long f = LLONG_MAX;
    for (int k = lane; k < T; k += 32) f = min(f, p_first[i * T + k]);
    for (int o = 16; o; o >>= 1) f = min(f, __shfl_down_sync(0xFFFFFFFFu, f, o));
    if (lane == 0 && f != LLONG_MAX) atomicMin(&first_row[i], f);
  }
}

__global__ void grouped_histogram_kernel(const int32_t* __restrict__ gid,
                                         const int32_t* __restrict__ words,
                                         long long n, int n_limbs, LimbPlan plan,
                                         int G, int copies, bool vec,
                                         unsigned long long* __restrict__ totals,
                                         long long* __restrict__ first_row) {
  extern __shared__ unsigned long long smem_u64[];
  long long* s_first = reinterpret_cast<long long*>(smem_u64);            // [G]
  unsigned int* s_acc = reinterpret_cast<unsigned int*>(s_first + G);     // [copies][nch][G]
  const int nch = 1 + n_limbs;
  const int cells = nch * G;

  for (int i = threadIdx.x; i < copies * cells; i += blockDim.x) s_acc[i] = 0u;
  for (int i = threadIdx.x; i < G; i += blockDim.x) s_first[i] = LLONG_MAX;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  unsigned int* acc = s_acc + ((threadIdx.x >> 5) % copies) * cells;  // this warp's copy
  const long long quads = (n + 3) >> 2;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  // warp-uniform bounds: every lane of a warp runs every step, as
  // __match_any_sync over the full warp needs
  for (long long q0 = warp * 32; q0 < quads; q0 += n_warps * 32) {
    const long long r = (q0 + lane) * 4;
    int g[4];
    load_quad(gid, r, n, vec, g);
    unsigned int id[4], peers[4], multi[4];
    bool leader[4], adds[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // a miss (< 0 or >= G, or past the end) gets an id no hit has
      id[j] = (unsigned int)g[j] < (unsigned int)G ? (unsigned int)g[j] : 0xFFFFFFFFu;
      peers[j] = __match_any_sync(0xFFFFFFFFu, id[j]);
      leader[j] = id[j] != 0xFFFFFFFFu && lane == __ffs(peers[j]) - 1;
      const bool big = __popc(peers[j]) >= SQLRS_AGG_MIN_LANES;
      multi[j] = __ballot_sync(0xFFFFFFFFu, leader[j] && big);
      adds[j] = id[j] != 0xFFFFFFFFu && (leader[j] || !big);
      if (leader[j]) {
        atomicAdd(&acc[id[j]], (unsigned int)__popc(peers[j]));
        const long long row = r + j;  // the group's smallest row
        if (row < *((volatile long long*)&s_first[id[j]])) atomicMin(&s_first[id[j]], row);
      }
    }
    int cur = -1;
    int w[4];
    for (int c = 0; c < n_limbs; ++c) {
      if (plan.word[c] != cur) {  // each word once for all its channels
        cur = plan.word[c];
        load_quad(words + (long long)cur * n, r, n, vec, w);
      }
      const int shift = plan.shift[c];
      unsigned int* chan = acc + (c + 1) * G;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned int limb = id[j] != 0xFFFFFFFFu ? ((unsigned int)w[j] >> shift) & 255u : 0u;
        unsigned int total = limb;
        for (unsigned int m = multi[j]; m; m &= m - 1) {
          const int first = __ffs(m) - 1;
          const unsigned int group = __shfl_sync(0xFFFFFFFFu, peers[j], first);
          const unsigned int s = __reduce_add_sync(0xFFFFFFFFu, (group >> lane) & 1u ? limb : 0u);
          if (lane == first) total = s;
        }
        if (adds[j] && total) atomicAdd(&chan[id[j]], total);
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    unsigned long long v = 0;
    for (int k = 0; k < copies; ++k) v += s_acc[k * cells + i];
    if (v) atomicAdd(&totals[i], v);
  }
  for (int i = threadIdx.x; i < G; i += blockDim.x) {
    const long long f = s_first[i];
    if (f != LLONG_MAX) atomicMin(&first_row[i], f);
  }
}

// Launches the kernel on `stream`. totals must hold zeros and first_row
// LLONG_MAX (the wrapper allocates both). Returns a cudaError_t: the result
// of cudaGetLastError() right after the launch, or the reason the launch
// was not made.
extern "C" int sqlrs_grouped_histogram(const void* gid, const void* words,
                                       long long n, int n_words,
                                       const int* plan_word,
                                       const int* plan_shift, int n_limbs,
                                       int G, void* totals, void* first_row,
                                       int grid, int block, void* stream) {
  if (n < 0 || n_limbs < 0 || n_limbs > SQLRS_MAX_LIMBS || G < 1 ||
      G > SQLRS_MAX_GROUPS || grid < 1 || block < 32 || block % 32 != 0)
    return (int)cudaErrorInvalidValue;
  LimbPlan plan;
  for (int i = 0; i < n_limbs; ++i) {
    if (plan_word[i] < 0 || plan_word[i] >= n_words || plan_shift[i] < 0 ||
        plan_shift[i] > 24)
      return (int)cudaErrorInvalidValue;
    plan.word[i] = plan_word[i];
    plan.shift[i] = plan_shift[i];
  }
  for (int i = n_limbs; i < SQLRS_MAX_LIMBS; ++i) plan.word[i] = plan.shift[i] = 0;
  const bool vec = (uintptr_t)gid % 16 == 0 && (uintptr_t)words % 16 == 0 && n % 4 == 0;
  const size_t cell_bytes = (size_t)(1 + n_limbs) * G * sizeof(unsigned int);
  const size_t private_smem = (size_t)block * (cell_bytes + G * sizeof(long long));
  cudaError_t err;
  if (private_smem <= SQLRS_PRIVATE_BUDGET) {
    err = cudaFuncSetAttribute(grouped_histogram_private_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)private_smem);
    if (err != cudaSuccess) return (int)err;
    // no more blocks than fit at once (each does an equal share), and enough
    // that none covers more than 2^24 rows
    int per_sm = 0, dev = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, grouped_histogram_private_kernel, block, private_smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    long long blocks = (long long)per_sm * sms;
    if (blocks > grid) blocks = grid;
    const long long least = (n + (1ll << 24) - 1) >> 24;
    if (blocks < least) blocks = least;
    grouped_histogram_private_kernel<<<(unsigned int)blocks, block, private_smem,
                                       (cudaStream_t)stream>>>(
        (const int32_t*)gid, (const int32_t*)words, n, n_limbs, plan, G, vec,
        (unsigned long long*)totals, (long long*)first_row);
    return (int)cudaGetLastError();
  }
  int copies = (int)(SQLRS_COPY_BUDGET / cell_bytes);
  copies = copies < 1 ? 1 : (copies > block / 32 ? block / 32 : copies);
  const size_t smem = (size_t)G * sizeof(long long) + copies * cell_bytes;
  err = cudaFuncSetAttribute(
      grouped_histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  grouped_histogram_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const int32_t*)gid, (const int32_t*)words, n, n_limbs, plan, G, copies, vec,
      (unsigned long long*)totals, (long long*)first_row);
  return (int)cudaGetLastError();
}
