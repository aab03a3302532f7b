"""Timing-only variants of the two histogram kernels, on one NVIDIA GPU.

    python3 sqlrs_tpu_torch/csrc/baseline/variants.py

Measurement only: no path of sqlrs_tpu_torch reaches this file. It builds
the current csrc/mxu_agg.cu and csrc/mxu_grouped.cu, their first versions
(csrc/baseline/*_v1.cu), and copies of the current sources with one part
changed by text substitution, into build/kernels/variants/, and times each
with CUDA events (the median of 5 runs of 10 back-to-back calls) on inputs
made from a seed with numpy. The variants answer what bounds each kernel
and pick its constants; most of them compute wrong totals on purpose
(`local`, `no_atomic`) and are never compared with anything.

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
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
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
    return {
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
    proc = subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS, "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    os.makedirs(OUT, exist_ok=True)
    srcs = sources()
    with ThreadPoolExecutor(len(srcs)) as pool:
        libs = dict(zip(srcs, pool.map(build, srcs, srcs.values())))
    time_dense(libs, dev)
    time_histogram(libs, dev)
    print(f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
