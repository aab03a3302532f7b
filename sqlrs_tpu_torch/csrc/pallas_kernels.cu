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
// Rows need not be sorted: the kernels count lanes, as the reference does,
// and never search a row.
//
// What bounds it on the H100: the bytes of the rows the queries land on
// (512 B a row; for masked_row_sum only the 32-B sectors below rem), read
// as data-dependent gathers, so memory latency unless enough rows are in
// flight. Measured (PERF.md): row_rank_ge at 2^17 uniform queries runs at
// the rate the card's memory gives such 512-B gathers, whatever the depth;
// masked_row_sum and both kernels at the rank stage's 2^16 boundary
// queries wait on the chain of round trips a tile makes. The first version
// (csrc/baseline/pallas_kernels_v1.cu) gave each query a warp: every lane
// first loaded the same block index and query, and only after that round
// trip the row, one query's row in flight a warp.
//
// What the design does about it:
//   - A warp takes a tile of 32 queries. Lane l loads query l's block index
//     and operand in one coalesced load each and clamps in registers: the
//     index round trip is paid once a tile.
//   - 8 lanes a query, four queries a round, eight rounds a tile. Lane s of
//     a group loads 16-B chunks s, s + 8, s + 16, s + 24 of the row (each
//     chunk load is 128 contiguous bytes across the group). The row address
//     and operand come from the owning lane by __shfl_sync.
//   - SQLRS_DEPTH rounds are in flight a warp: round r + 1's loads are
//     issued before round r is reduced (two rounds, eight rows). A deeper
//     ring of rounds costs registers and so resident warps
//     (csrc/baseline/variants.py times depths 1, 3, 4 and 8).
//   - A 3-step shuffle reduction inside each 8-lane group; each result moves
//     to its query's lane, and the warp writes one coalesced 128-B store.
//   - masked_row_sum loads only the chunks below rem (chunk c when 4c < rem)
//     and masks the lanes of a partial chunk. Its sum runs in uint32, which
//     wraps exactly as the reference's int32 sum does.
//   - A persistent grid: the launcher is given SMs x resident blocks
//     (sqlrs_rank_stage_grid, queried once a device by the wrapper), cut to
//     the tiles there are; warps grid-stride over 32-query tiles.
//   - A base that is not 16-B aligned (a contiguous view at an odd element
//     offset) takes the scalar-load instantiation of the same kernel
//     (VEC = false): four 4-byte loads for each 16-B chunk.
//
// A variant that stages each tile's rows in shared memory by TMA bulk
// copies (cp.async.bulk on an mbarrier, one tile ahead) is timed against
// this one by csrc/baseline/variants.py and loses at every shape measured
// (PERF.md): six warps an SM fit its two 16-KB tile buffers each.
//
// Built with nvcc into a plain C shared library and called through ctypes
// (sqlrs_tpu_torch/utils/cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#define SQLRS_ROW 128     // lanes a row
#define SQLRS_TILE 32     // queries a warp takes at once, one a lane
#define SQLRS_ROUNDS 8    // rounds a tile: four queries a round, 8 lanes each
#define SQLRS_DEPTH 2     // rounds in flight a warp
#define SQLRS_BLOCK 256   // threads a block

enum { OP_RANK = 0, OP_SUM = 1 };

// one round of one lane: its four 16-B chunks (c = sub + 8k) of the row of
// query 4r + group, and that query's operand
struct Round {
  int4 v[4];
  int32_t s;
};

template <bool VEC>
__device__ __forceinline__ int4 load_chunk(const int32_t* __restrict__ row, int c) {
  if (VEC) return __ldg(reinterpret_cast<const int4*>(row) + c);
  const int32_t* p = row + 4 * c;
  return make_int4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// round r's loads for this lane: the row and operand of query 4r + group
// come from that query's lane; chunks a query does not need stay zero
template <int OP, bool VEC>
__device__ __forceinline__ Round load_round(const int32_t* __restrict__ x2d, int b, int32_t s,
                                            bool live, int r, int group, int sub) {
  const int j = 4 * r + group;
  const int jb = __shfl_sync(0xffffffffu, b, j);
  Round o;
  o.s = __shfl_sync(0xffffffffu, s, j);
  const bool jlive = __shfl_sync(0xffffffffu, (int)live, j) != 0;
  const int32_t* row = x2d + (long long)jb * SQLRS_ROW;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = sub + 8 * k;
    const bool need = jlive && (OP == OP_RANK || 4 * c < o.s);
    o.v[k] = need ? load_chunk<VEC>(row, c) : make_int4(0, 0, 0, 0);
  }
  return o;
}

// this lane's part of round r's answer: its lanes >= the query, or its
// lanes below rem, summed in uint32
template <int OP>
__device__ __forceinline__ unsigned int lane_part(const Round& o, int sub) {
  unsigned int a = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int32_t e[4] = {o.v[k].x, o.v[k].y, o.v[k].z, o.v[k].w};
    const int base = 4 * (sub + 8 * k);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (OP == OP_RANK)
        a += e[u] >= o.s ? 1u : 0u;
      else
        a += base + u < o.s ? (unsigned int)e[u] : 0u;
    }
  }
  return a;
}

template <int OP, bool VEC>
__global__ void __launch_bounds__(SQLRS_BLOCK)
rank_stage_kernel(const int32_t* __restrict__ x2d, long long nb,
                  const int32_t* __restrict__ block_idx, const int32_t* __restrict__ scalar,
                  long long nq, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int group = lane >> 3;
  const int sub = lane & 7;
  const long long warps = (long long)gridDim.x * (SQLRS_BLOCK / 32);
  const long long tiles = (nq + SQLRS_TILE - 1) / SQLRS_TILE;
  for (long long t = (long long)blockIdx.x * (SQLRS_BLOCK / 32) + (threadIdx.x >> 5);
       t < tiles; t += warps) {
    // the whole warp shares t, so every shuffle below has all 32 lanes
    const long long i = t * SQLRS_TILE + lane;
    const bool live = i < nq;
    long long b = live ? (long long)block_idx[i] : 0;
    b = b < 0 ? 0 : (b >= nb ? nb - 1 : b);
    const int32_t s = live ? scalar[i] : 0;
    int32_t mine = 0;
    Round ring[SQLRS_DEPTH];  // registers: every index is known once unrolled
#pragma unroll
    for (int r = 0; r + 1 < SQLRS_DEPTH; ++r)
      ring[r] = load_round<OP, VEC>(x2d, (int)b, s, live, r, group, sub);
#pragma unroll
    for (int r = 0; r < SQLRS_ROUNDS; ++r) {
      // round r + DEPTH - 1's loads go out before round r is reduced
      if (r + SQLRS_DEPTH - 1 < SQLRS_ROUNDS)
        ring[(r + SQLRS_DEPTH - 1) % SQLRS_DEPTH] =
            load_round<OP, VEC>(x2d, (int)b, s, live, r + SQLRS_DEPTH - 1, group, sub);
      unsigned int a = lane_part<OP>(ring[r % SQLRS_DEPTH], sub);
      a += __shfl_xor_sync(0xffffffffu, a, 4);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      // query l's answer is round l / 4's, in group l % 4
      const unsigned int got = __shfl_sync(0xffffffffu, a, (lane & 3) << 3);
      if ((lane >> 2) == r) mine = (int32_t)got;
    }
    if (live) out[i] = mine;
  }
}

template <int OP, bool VEC>
static int launch(const void* x2d, long long nb, const void* block_idx, const void* scalar,
                  long long nq, void* out, int grid, cudaStream_t stream) {
  const long long tiles = (nq + SQLRS_TILE - 1) / SQLRS_TILE;
  const long long need = (tiles + SQLRS_BLOCK / 32 - 1) / (SQLRS_BLOCK / 32);
  const unsigned int blocks = (unsigned int)(need < grid ? need : grid);
  rank_stage_kernel<OP, VEC><<<blocks, SQLRS_BLOCK, 0, stream>>>(
      (const int32_t*)x2d, nb, (const int32_t*)block_idx, (const int32_t*)scalar, nq,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

static int launch_op(int op, const void* x2d, long long nb, const void* block_idx,
                     const void* scalar, long long nq, void* out, int vec, int grid,
                     void* stream) {
  if (nb < 1 || nq < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  if (vec && ((uintptr_t)x2d & 15)) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  if (op == OP_RANK)
    return vec ? launch<OP_RANK, true>(x2d, nb, block_idx, scalar, nq, out, grid, st)
               : launch<OP_RANK, false>(x2d, nb, block_idx, scalar, nq, out, grid, st);
  return vec ? launch<OP_SUM, true>(x2d, nb, block_idx, scalar, nq, out, grid, st)
             : launch<OP_SUM, false>(x2d, nb, block_idx, scalar, nq, out, grid, st);
}

// The persistent grid of kernel `op` (0 row_rank_ge, 1 masked_row_sum) in
// its `vec` form on the current device: SMs x resident blocks. Returns a
// cudaError_t.
extern "C" int sqlrs_rank_stage_grid(int op, int vec, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const void* k = op == OP_RANK
                      ? (vec ? (const void*)rank_stage_kernel<OP_RANK, true>
                             : (const void*)rank_stage_kernel<OP_RANK, false>)
                      : (vec ? (const void*)rank_stage_kernel<OP_SUM, true>
                             : (const void*)rank_stage_kernel<OP_SUM, false>);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, SQLRS_BLOCK, 0);
  if (e != cudaSuccess) return (int)e;
  *grid = sms * (per_sm > 0 ? per_sm : 1);
  return 0;
}

// Each entry launches its kernel on `stream` and returns a cudaError_t: the
// result of cudaGetLastError() right after the launch, or the reason the
// launch was not made. vec = 1 takes 16-B loads and needs a 16-B aligned
// x2d; grid is at most the blocks launched (sqlrs_rank_stage_grid's).
extern "C" int sqlrs_row_rank_ge(const void* sp2d, long long nb, const void* block_idx,
                                 const void* queries, long long nq, void* out, int vec,
                                 int grid, void* stream) {
  return launch_op(OP_RANK, sp2d, nb, block_idx, queries, nq, out, vec, grid, stream);
}

extern "C" int sqlrs_masked_row_sum(const void* v2d, long long nb, const void* block_idx,
                                    const void* rem, long long nq, void* out, int vec,
                                    int grid, void* stream) {
  return launch_op(OP_SUM, v2d, nb, block_idx, rem, nq, out, vec, grid, stream);
}
