"""Timing-only variants of the histogram and rank-stage kernels, on one NVIDIA GPU.

    python3 sqlrs_tpu_torch/csrc/baseline/variants.py [rank] [agg] [hist]

(no argument: all three kernel families).

Measurement only: no path of sqlrs_tpu_torch reaches this file. It builds
the current csrc/mxu_agg.cu, csrc/mxu_grouped.cu and csrc/pallas_kernels.cu,
their first versions (csrc/baseline/*_v1.cu), copies of the current sources
with one part changed by text substitution, and the rank stage's TMA
variant (csrc/baseline/pallas_kernels_tma.cu), into build/kernels/variants/,
and times each on inputs made from a seed with numpy: kernels 1 and 2 with
CUDA events (the median of 5 runs of 10 back-to-back calls), kernels 3 and 4
by device time (torch.profiler's kernel records over 20 calls, variants
timed in a palindrome: first ... tma, tma ... first, each pair's mean).
The variants answer what bounds each kernel and pick its constants; some
of kernel 2's compute wrong totals on purpose (`local`, `no_atomic`) and
are never compared with anything.

dense_group_sums (2^25 rows, bench.py's zipf(1.2) keys over 2^16 groups
and other key sets, int32 gids alone and int64 keys + values + mask):
  first        the first version (tiles over blockIdx.y, no aggregation)
  group_masks  warp sums with __reduce_add_sync over each group's own mask
  agg2, agg8   the smallest group worth a warp sum fixed at 2 or 8 lanes
  current      the source as it stands (2 lanes across a cluster, else 8)
  local        every update to the CTA's own shared memory (no DSMEM)
  no_atomic    no update at all: loads, match and warp sums only
each with val_bits 0 (count and sum in two cells) and 7 (one packed cell).

grouped_histogram (TPC-H Q1's SF1 shape: 6,003,276 rows, 4 groups, 15
channels over 7 words; Q1-like, uniform and one-dominant group ids):
  first        the first version (one block histogram, a shared atomic a
               row and channel)
  shared2      the per-warp, warp-aggregated path with 2-lane groups
  shared16     the same with 16-lane groups (the larger domains' path)
  current      the source as it stands (the per-thread path at Q1's size)

row_rank_ge / masked_row_sum (S1: bench.py's star sorted as pack32 (k << 7
| v) in (2^18, 128) blocks with the 2^16 + 1 boundary queries; S2: the same
blocks, 2^17 queries uniform over the rows), each checked against the
plain version before it is timed:
  first        the first version (a warp a query)
  int4         a warp a 32-query tile, 8 lanes a query with 16-B loads, one
               round in flight (SQLRS_DEPTH 1: the next round's loads are
               issued only after this round's reduction)
  current      the source as it stands (SQLRS_DEPTH 2)
  depth3, depth4, depth8
               the same with 3, 4 or all 8 rounds of a tile in flight
  minb4        current with __launch_bounds__(256, 4): at most 64 registers,
               four resident blocks an SM
  tma          each tile's rows staged in shared memory by cp.async.bulk,
               one tile ahead, on an mbarrier a buffer
each with the L2 flushed before every call (a 128-MB read) and back to
back; then the wrapper's host us a call at S1 against the steps it took
before its host cost was cut (first_wrapper).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
sys.path.insert(0, ROOT)  # the plain versions the rank variants are checked against
CSRC = os.path.join(ROOT, "sqlrs_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "kernels", "variants")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC"]

AGG_MIN = "const int agg_min = owners > 1 ? 2 : 8;"
OWNER = "const unsigned int owner = id % (unsigned int)owners;"
PACKED_ADD = """          atomicAdd(cluster.map_shared_rank(s_sum, owner) + slot,
                    ((unsigned long long)count << sum_bits) + total);"""
COUNT_ADD = "atomicAdd(cluster.map_shared_rank(s_cnt, owner) + slot, count);"
SUM_ADD = "if (total) atomicAdd(cluster.map_shared_rank(s_sum, owner) + slot, total);"
WARP_LOOP_START = "      unsigned int multi = __ballot_sync(0xFFFFFFFFu, leader && big);"
WARP_LOOP_END = "        if (lane == first) total = s;\n      }\n"
KERNEL_START = "template <typename KeyT, typename ValT, bool HAS_VALID>\n__global__"
# the group's sum over its own mask: 16-bit pieces as warp_sum takes them
GROUP_MASK_SUM = """
__device__ __forceinline__ unsigned long long group_sum(unsigned int m, int32_t v) {
  const unsigned int lo = __reduce_add_sync(m, (unsigned int)v & 0xFFFFu);
  const int hi = __reduce_add_sync(m, v >> 16);
  return (unsigned long long)lo + ((unsigned long long)(long long)hi << 16);
}
__device__ __forceinline__ unsigned long long group_sum(unsigned int m, int64_t v) {
  const unsigned long long x = (unsigned long long)v;
  const unsigned int a = __reduce_add_sync(m, (unsigned int)(x & 0xFFFFu));
  const unsigned int b = __reduce_add_sync(m, (unsigned int)((x >> 16) & 0xFFFFu));
  const unsigned int c = __reduce_add_sync(m, (unsigned int)((x >> 32) & 0xFFFFu));
  const int d = __reduce_add_sync(m, (int)(v >> 48));
  return (unsigned long long)a + ((unsigned long long)b << 16) +
         ((unsigned long long)c << 32) + ((unsigned long long)(long long)d << 48);
}

"""

DEPTH = "#define SQLRS_DEPTH 2"
PRIVATE_BUDGET = "#define SQLRS_PRIVATE_BUDGET (96 * 1024)"
AGG_MIN_LANES = "#define SQLRS_AGG_MIN_LANES 16"


def _read(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _edit(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise AssertionError(f"variant edit not found: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def _group_masks(src: str) -> str:
    """Replace the warp-uniform loop over groups with one sum per lane over
    its own group's mask (every lane of a group calls with that mask)."""
    a = src.index(WARP_LOOP_START)
    b = src.index(WARP_LOOP_END, a) + len(WARP_LOOP_END)
    src = src[:a] + "      total = group_sum(peers, mine);\n" + src[b:]
    return _edit(src, [(KERNEL_START, GROUP_MASK_SUM + KERNEL_START),
                       (AGG_MIN, "const int agg_min = 2;")])


def sources() -> dict[str, str]:
    agg = _read("mxu_agg.cu")
    hist = _read("mxu_grouped.cu")
    rank = _read("pallas_kernels.cu")
    return {
        "rank_first": _read("baseline/pallas_kernels_v1.cu"),
        "rank_int4": _edit(rank, [(DEPTH, "#define SQLRS_DEPTH 1")]),
        "rank_current": rank,
        "rank_depth3": _edit(rank, [(DEPTH, "#define SQLRS_DEPTH 3")]),
        "rank_depth4": _edit(rank, [(DEPTH, "#define SQLRS_DEPTH 4")]),
        "rank_depth8": _edit(rank, [(DEPTH, "#define SQLRS_DEPTH 8")]),
        "rank_minb4": _edit(rank, [("__launch_bounds__(SQLRS_BLOCK)",
                                    "__launch_bounds__(SQLRS_BLOCK, 4)")]),
        "rank_tma": _read("baseline/pallas_kernels_tma.cu"),
        "agg_first": _read("baseline/mxu_agg_v1.cu"),
        "agg_group_masks": _group_masks(agg),
        "agg_agg2": _edit(agg, [(AGG_MIN, "const int agg_min = 2;")]),
        "agg_agg8": _edit(agg, [(AGG_MIN, "const int agg_min = 8;")]),
        "agg_current": agg,
        "agg_local": _edit(agg, [(OWNER, "const unsigned int owner = rank;")]),
        "agg_no_atomic": _edit(agg, [(PACKED_ADD, ""), (COUNT_ADD, ""), (SUM_ADD, "")]),
        "hist_first": _read("baseline/mxu_grouped_v1.cu"),
        "hist_shared2": _edit(hist, [(PRIVATE_BUDGET, "#define SQLRS_PRIVATE_BUDGET 0"),
                                     (AGG_MIN_LANES, "#define SQLRS_AGG_MIN_LANES 2")]),
        "hist_shared16": _edit(hist, [(PRIVATE_BUDGET, "#define SQLRS_PRIVATE_BUDGET 0")]),
        "hist_current": hist,
    }


def build(name: str, src: str) -> ctypes.CDLL:
    from torch.utils.cpp_extension import CUDA_HOME

    cu = os.path.join(OUT, name + ".cu")
    so = os.path.join(OUT, name + ".so")
    with open(cu, "w") as f:
        f.write(src)
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if name.startswith("rank_") else [])
    proc = subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), *flags, "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            print(f"{name}: {line.strip()}", flush=True)
    return ctypes.CDLL(so)


def cuda_ms(fn, reps: int = 5, per: int = 10) -> float:
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / per)
    return float(np.median(times))


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: cudaError {err}")


def time_dense(libs, dev) -> None:
    c = ctypes
    n, G = 1 << 25, 1 << 16
    rng = np.random.default_rng(0)
    key_sets = {
        "zipf": np.minimum(rng.zipf(1.2, n), G) - 1,
        "uniform": rng.integers(0, G, n),
        "zipf_G8192": np.minimum(rng.zipf(1.2, n), 8192) - 1,
        "one_id": np.zeros(n, np.int64),
    }
    v64 = torch.from_numpy(rng.integers(0, 100, n)).to(dev)
    v32 = v64.to(torch.int32)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    sums = torch.zeros(G, dtype=torch.int64, device=dev)
    counts = torch.zeros(G, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for kname, keys in key_sets.items():
        g = 8192 if kname == "zipf_G8192" else G
        k64 = torch.from_numpy(keys).to(dev)
        k32 = k64.to(torch.int32)
        first = libs["agg_first"].sqlrs_dense_group_sums_v1
        first.restype = c.c_int
        first.argtypes = [c.c_void_p, c.c_void_p, c.c_longlong, c.c_int, c.c_int, c.c_void_p,
                          c.c_void_p, c.c_int, c.c_int, c.c_void_p]
        tiles = -(-g // min(g, 8192))
        grid_x = -(-2 * torch.cuda.get_device_properties(dev).multi_processor_count // tiles)
        t = cuda_ms(lambda: _check(first(k32.data_ptr(), v32.data_ptr(), n, g, min(g, 8192),
                                         sums.data_ptr(), counts.data_ptr(), grid_x, 1024,
                                         stream), "agg_first"))
        print(f"dense_group_sums {kname:10s} first         int32 alone {t:.3f} ms", flush=True)
        for name in ("agg_group_masks", "agg_agg2", "agg_agg8", "agg_current", "agg_local",
                     "agg_no_atomic"):
            fn = libs[name].sqlrs_dense_group_sums
            fn.restype = c.c_int
            fn.argtypes = [c.c_void_p, c.c_int, c.c_void_p, c.c_longlong, c.c_void_p, c.c_int,
                           c.c_int, c.c_longlong, c.c_int, c.c_void_p, c.c_void_p, c.c_void_p]
            for vb in (0, 7):
                t32 = cuda_ms(lambda: _check(fn(k32.data_ptr(), 4, None, 0, v32.data_ptr(), 4, vb,
                                                n, g, sums.data_ptr(), counts.data_ptr(),
                                                stream), name))
                t64 = cuda_ms(lambda: _check(fn(k64.data_ptr(), 8, valid.data_ptr(), 0,
                                                v64.data_ptr(), 8, vb, n, g, sums.data_ptr(),
                                                counts.data_ptr(), stream), name))
                print(f"dense_group_sums {kname:10s} {name[4:]:13s} val_bits {vb}: int32 alone "
                      f"{t32:.3f} ms, int64 keys + values + mask {t64:.3f} ms", flush=True)


def time_histogram(libs, dev) -> None:
    c = ctypes
    n, G = 6_003_276, 4
    rng = np.random.default_rng(0)
    words = torch.from_numpy(rng.integers(0, 1 << 24, (7, n), dtype=np.int32)).to(dev)
    plan = [(0, 0), (1, 0), (1, 8), (1, 16), (2, 0), (2, 8), (2, 16), (3, 0), (4, 0), (4, 8),
            (4, 16), (5, 0), (5, 8), (6, 0)]
    pw = (c.c_int * 14)(*[w for w, _ in plan])
    ps = (c.c_int * 14)(*[s for _, s in plan])
    gid_sets = {
        "q1_like": rng.choice(4, n, p=[0.25, 0.007, 0.493, 0.25]),
        "uniform": rng.integers(0, 4, n),
        "dominant": np.where(rng.random(n) < 0.9, 1, rng.integers(0, 4, n)),
    }
    totals = torch.zeros(15, G, dtype=torch.int64, device=dev)
    first_row = torch.zeros(G, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    grid = 4 * torch.cuda.get_device_properties(dev).multi_processor_count
    for gname, gid_np in gid_sets.items():
        gid = torch.from_numpy(gid_np.astype(np.int32)).to(dev)
        for name in ("hist_first", "hist_shared2", "hist_shared16", "hist_current"):
            lib = libs[name]
            fn = lib.sqlrs_grouped_histogram_v1 if name == "hist_first" else lib.sqlrs_grouped_histogram
            fn.restype = c.c_int
            fn.argtypes = [c.c_void_p, c.c_void_p, c.c_longlong, c.c_int, c.POINTER(c.c_int),
                           c.POINTER(c.c_int), c.c_int, c.c_int, c.c_void_p, c.c_void_p,
                           c.c_int, c.c_int, c.c_void_p]
            t = cuda_ms(lambda: _check(fn(gid.data_ptr(), words.data_ptr(), n, 7, pw, ps, 14, G,
                                          totals.data_ptr(), first_row.data_ptr(), grid, 256,
                                          stream), name))
            print(f"grouped_histogram {gname:9s} {name[5:]:9s} {t:.3f} ms", flush=True)


def device_ms(fn, match: str, calls: int = 20, flush=None) -> float:
    """Device milliseconds per call of fn(), which launches one kernel whose
    name holds `match`: the mean duration of torch.profiler's records of
    that kernel over `calls` calls, after two warm-up calls. The profiler
    may drop a record or two of a window (seen on the H100); a trace with
    fewer than half the calls' records is taken again, at most three times,
    and more records than calls raise. With `flush`, flush() runs before
    each call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA") and match in e.key]
        us = sum(float(getattr(e, "self_device_time_total", 0) or
                       getattr(e, "self_cuda_time_total", 0) or 0) for e in events)
        n = sum(e.count for e in events)
        if n > calls:
            raise AssertionError(f"{n} launches of {match} in {calls} calls")
        if us > 0 and 2 * n >= calls:
            return us / 1e3 / n
    raise AssertionError(f"torch.profiler traced {n} records of {match} for {calls} calls")


def host_us(fn, calls: int = 1024, batch: int = 32) -> float:
    """Host us per call: the host clock over `calls` calls in runs of
    `batch`, each followed by an untimed synchronize."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(calls // batch):
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / (calls // batch * batch) * 1e6


def first_wrapper(lib, name: str):
    """The steps of the wrapper before its host cost was cut (ops/
    pallas_kernels.py as of the first kernels), on every call: each input
    check, the library's attribute and argtypes looked up, a
    torch.cuda.device context and a torch.cuda.current_stream object, then
    the first kernel's launch (256 threads)."""
    c = ctypes

    def run(x2d, block_idx, scalar):
        if x2d.dtype != torch.int32 or x2d.dim() != 2 or x2d.shape[1] != 128:
            raise ValueError("the blocks must be an int32 tensor (nb, 128)")
        if x2d.shape[0] < 1 or not x2d.is_contiguous():
            raise ValueError("the blocks must be contiguous and hold at least one row")
        for t in (block_idx, scalar):
            if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
                raise ValueError("block_idx and the operand must be contiguous 1-D int32")
        if block_idx.shape != scalar.shape:
            raise ValueError("block_idx and the per-query operand differ in length")
        if not (x2d.device == block_idx.device == scalar.device):
            raise ValueError("all operands must be on one device")
        if x2d.device.type != "cuda" or scalar.shape[0] == 0:
            raise ValueError("a CUDA tensor with queries, as timed here")
        fn = getattr(lib, f"sqlrs_{name}_v1")
        if fn.argtypes is None:
            fn.restype = c.c_int
            fn.argtypes = [c.c_void_p, c.c_longlong, c.c_void_p, c.c_void_p, c.c_longlong,
                           c.c_void_p, c.c_int, c.c_void_p]
        dev = x2d.device
        nq = int(scalar.shape[0])
        out = torch.empty(nq, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(x2d.data_ptr(), int(x2d.shape[0]), block_idx.data_ptr(),
                     scalar.data_ptr(), nq, out.data_ptr(), 256, stream)
        _check(err, name)
        return out
    return run


def rank_launcher(lib, name: str, entry: str, dev):
    """f(x2d, b, s) -> out for one rank variant, launched as its source
    launches it (the first version: 256 threads, a warp a query; the others:
    their persistent grid)."""
    c = ctypes
    if name == "rank_first":
        fn = getattr(lib, entry + "_v1")
        fn.restype = c.c_int
        fn.argtypes = [c.c_void_p, c.c_longlong, c.c_void_p, c.c_void_p, c.c_longlong,
                       c.c_void_p, c.c_int, c.c_void_p]
        extra = (256,)
    else:
        fn = getattr(lib, entry)
        fn.restype = c.c_int
        fn.argtypes = [c.c_void_p, c.c_longlong, c.c_void_p, c.c_void_p, c.c_longlong,
                       c.c_void_p, c.c_int, c.c_int, c.c_void_p]
        query = lib.sqlrs_rank_stage_grid
        query.restype = c.c_int
        query.argtypes = [c.c_int, c.c_int, c.POINTER(c.c_int)]
        grid = c.c_int(0)
        _check(query(0 if entry == "sqlrs_row_rank_ge" else 1, 1, c.byref(grid)), name)
        extra = (1, grid.value)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(x2d, b, s):
        out = torch.empty(s.shape[0], dtype=torch.int32, device=dev)
        _check(fn(x2d.data_ptr(), x2d.shape[0], b.data_ptr(), s.data_ptr(), s.shape[0],
                  out.data_ptr(), *extra, stream), name)
        return out
    return run


def time_rank(libs, dev) -> None:
    from sqlrs_tpu_torch.ops.pallas_kernels import masked_row_sum_plain, row_rank_ge_plain

    n, G, vb = 1 << 25, 1 << 16, 7
    rng = np.random.default_rng(0)  # bench.py's star
    gid = torch.from_numpy(np.minimum(rng.zipf(1.2, n), G) - 1).to(dev)
    v = torch.from_numpy(rng.integers(0, 100, n)).to(dev)
    sp = torch.sort(((gid << vb) | v).to(torch.int32)).values
    nb = n // 128
    sp2d, v2d = sp.view(nb, 128), (sp & ((1 << vb) - 1)).view(nb, 128)
    q1 = torch.arange(G + 1, dtype=torch.int32, device=dev) << vb
    b_rank = torch.clamp(torch.searchsorted(sp2d[:, 0].contiguous(), q1) - 1, 0, nb - 1)
    ranks = torch.searchsorted(sp, q1)
    b_sum = torch.clamp(ranks // 128, 0, nb - 1).to(torch.int32)
    rem1 = (ranks % 128).to(torch.int32)
    rng = np.random.default_rng(1)
    nq2 = 1 << 17
    b2 = torch.from_numpy(rng.integers(0, nb, nq2).astype(np.int32)).to(dev)
    q2 = sp2d[b2.long(), torch.from_numpy(rng.integers(0, 128, nq2)).to(dev)] + torch.from_numpy(
        rng.integers(-2, 3, nq2).astype(np.int32)).to(dev)
    rem2 = torch.from_numpy(rng.integers(0, 129, nq2).astype(np.int32)).to(dev)
    shapes = {
        "S1": {"sqlrs_row_rank_ge": (sp2d, b_rank.to(torch.int32), q1),
               "sqlrs_masked_row_sum": (v2d, b_sum, rem1)},
        "S2": {"sqlrs_row_rank_ge": (sp2d, b2, q2), "sqlrs_masked_row_sum": (v2d, b2, rem2)},
    }
    plain = {"sqlrs_row_rank_ge": row_rank_ge_plain, "sqlrs_masked_row_sum": masked_row_sum_plain}
    names = ("rank_first", "rank_int4", "rank_current", "rank_depth3", "rank_depth4",
             "rank_depth8", "rank_minb4", "rank_tma")
    symbol = {"rank_first": "_kernel_v1", "rank_tma": "rank_stage_tma_kernel"}
    flush_buf = torch.ones(1 << 25, dtype=torch.int32, device=dev)  # 128 MB read: L2 emptied
    for shape, entries in shapes.items():
        for entry, args in entries.items():
            runs = {name: rank_launcher(libs[name], name, entry, dev) for name in names}
            exp = plain[entry](*args)
            for name, run in runs.items():
                if not torch.equal(run(*args), exp):
                    raise AssertionError(f"{name} {entry} != plain at {shape}")
            for label, flush in (("L2 flushed", flush_buf.sum), ("back to back", None)):
                times = dict.fromkeys(names, 0.0)
                for name in names + names[::-1]:
                    times[name] += device_ms(lambda: runs[name](*args), flush=flush,
                                             match=symbol.get(name, "rank_stage_kernel")) / 2
                print(f"{entry[6:]:14s} {shape} (nq {args[1].shape[0]}), {label}: " + ", ".join(
                    f"{name[5:]} {t:.4f} ms" for name, t in times.items()) +
                    " (device, == plain)", flush=True)
    # the wrapper's host cost: the steps before the cut against the current
    # wrapper, in turns, at S1
    from sqlrs_tpu_torch.ops import pallas_kernels

    for entry, args in shapes["S1"].items():
        name = entry[6:]
        before, now = first_wrapper(libs["rank_first"], name), getattr(pallas_kernels, name)
        b1, n1, n2, b2 = (host_us(lambda: f(*args)) for f in (before, now, now, before))
        print(f"{name:14s} S1 host a call: wrapper as first written {(b1 + b2) / 2:.1f} us, "
              f"now {(n1 + n2) / 2:.1f} us (host clock over 1024 calls, in turns)", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    os.makedirs(OUT, exist_ok=True)
    families = sys.argv[1:] or ["rank", "agg", "hist"]
    srcs = {k: v for k, v in sources().items() if k.split("_")[0] in families}
    with ThreadPoolExecutor(len(srcs)) as pool:
        libs = dict(zip(srcs, pool.map(build, srcs, srcs.values())))
    for family, timer in (("rank", time_rank), ("agg", time_dense), ("hist", time_histogram)):
        if family in families:
            timer(libs, dev)
    print(f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
