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
// kernel is a streaming pass at best at the card's 3.35 TB/s.
//
// What the design does about it: a grid-stride loop over rows (coalesced
// 4-byte loads, row offsets in 64 bits), and one histogram per block in
// dynamic shared memory, uint32 [nch][G] plus int64 first rows [G], so the
// per-row atomics stay on the SM and only nch * G adds per block reach
// global memory. A block covers at most 2^24 rows (the wrapper checks), and
// 255 * 2^24 < 2^32, so no 32-bit cell overflows. Integer atomics are exact
// in any order, so the totals equal the plain PyTorch version bit for bit.
//
// Built with nvcc into a plain C shared library and called through ctypes
// (sqlrs_tpu_torch/utils/cuda_build.py).

#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

#define SQLRS_MAX_LIMBS 31  // nch <= 32: the count channel + 31 limb channels
#define SQLRS_MAX_GROUPS 1024

struct LimbPlan {
  int word[SQLRS_MAX_LIMBS];
  int shift[SQLRS_MAX_LIMBS];
};

__global__ void grouped_histogram_kernel(const int32_t* __restrict__ gid,
                                         const int32_t* __restrict__ words,
                                         long long n, int n_limbs, LimbPlan plan,
                                         int G,
                                         unsigned long long* __restrict__ totals,
                                         long long* __restrict__ first_row) {
  extern __shared__ unsigned long long smem_u64[];
  long long* s_first = reinterpret_cast<long long*>(smem_u64);            // [G]
  unsigned int* s_acc = reinterpret_cast<unsigned int*>(s_first + G);     // [nch][G]
  const int nch = 1 + n_limbs;

  for (int i = threadIdx.x; i < nch * G; i += blockDim.x) s_acc[i] = 0u;
  for (int i = threadIdx.x; i < G; i += blockDim.x) s_first[i] = LLONG_MAX;
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const int g = gid[r];
    if ((unsigned int)g >= (unsigned int)G) continue;  // miss: < 0 or >= G
    atomicAdd(&s_acc[g], 1u);
    for (int c = 0; c < n_limbs; ++c) {
      const unsigned int w = (unsigned int)words[(long long)plan.word[c] * n + r];
      const unsigned int limb = (w >> plan.shift[c]) & 255u;
      if (limb) atomicAdd(&s_acc[(c + 1) * G + g], limb);
    }
    // each thread meets its rows in increasing order and first rows only
    // decrease, so a stale read can only cost a redundant atomicMin
    if (r < *((volatile long long*)&s_first[g])) atomicMin(&s_first[g], r);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < nch * G; i += blockDim.x) {
    const unsigned int v = s_acc[i];
    if (v) atomicAdd(&totals[i], (unsigned long long)v);
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
      G > SQLRS_MAX_GROUPS || grid < 1 || block < 1)
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
  const size_t smem = (size_t)G * sizeof(long long) +
                      (size_t)(1 + n_limbs) * G * sizeof(unsigned int);
  cudaError_t err = cudaFuncSetAttribute(
      grouped_histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  grouped_histogram_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const int32_t*)gid, (const int32_t*)words, n, n_limbs, plan, G,
      (unsigned long long*)totals, (long long*)first_row);
  return (int)cudaGetLastError();
}
