"""Smoke run of sqlrs_tpu_torch on one NVIDIA GPU: build, kernel checks,
TPC-H Q1/Q6 at scale factor 1, the star rollup at bench.py's size, and all
22 TPC-H queries at scale factor 1, all through
`Database(device="cuda").run`, then the sharded engine over 4 shards on
the same card, in one process and over torch.distributed, and last the
SQL fuzz corpus on the card against the port's CPU run.

    python3 chip_smoke.py

(`--mp-child SPEC` is how phase 10 starts its processes.)

Phases, each printing one line or a few:
  1. build       — nvcc builds every kernel source in sqlrs_tpu_torch/csrc/,
                   and the first versions of kernels 1-4 kept in
                   csrc/baseline/ (built and launched only here), into
                   build/kernels/, one nvcc process for each source, all
                   started together (the times include nvcc).
  2. kernel      — each kernel against its plain PyTorch version on the card,
                   on inputs made from a seed with numpy, at small and ragged
                   shapes and at the shapes of the main path; integer results
                   must be equal bit for bit (tolerance 0). Times at the main
                   path's shapes: Q1's for grouped_histogram (its group ids
                   from the SF1 lineitem), the star rollup's for
                   dense_group_sums (2^25 rows, 2^16 groups), and for
                   row_rank_ge / masked_row_sum two shapes: S1, the star
                   rollup's rank stage (the sorted pack32 array as (2^18,
                   128) blocks, 2^16 + 1 boundary queries), and S2, the same
                   blocks under 2^17 queries uniform over the rows. Each
                   kernel: CUDA-event ms (per call over runs of 10 calls back
                   to back), device ms (the mean of torch.profiler's records
                   of the kernel) and the wrapper's host us per call (host
                   clock over 1024 calls). Every kernel is timed in turns with its first
                   version (first, current, current, first): kernels 1 and 2
                   by CUDA events, 3 and 4 by device time at S1 and S2. Each
                   bound is bytes, each read or written once, at 3.35 TB/s
                   (kernel 4: only the 32-B sectors below the largest rem a
                   row gets).
  3. tpch_sf1    — lineitem's Q1/Q6 columns at SF1 (about 6.0M rows, made
                   with numpy by the TPC-H rules), loaded into the port and
                   queried: one cold run, three warm runs. Results are
                   checked against a numpy oracle (counts and sum_qty
                   exactly, other values to rel 1e-9), and Q1 must have gone
                   through grouped_histogram.
  4. star_rollup — bench.py's star schema: fact f(k, v) of 2^25 rows with
                   zipf(1.2) keys into a dim d(k) of 2^16 keys, dense or
                   spread, and the TPC-H SF1 rollup of lineitem ⋈ orders by
                   order key. Each query: one cold run, three warm runs, the
                   route it logs, and its rows against a numpy oracle,
                   exactly (revenue bit for bit against the integer-cents sum
                   / 10^4). The dense ORDER BY query must have gone through
                   dense_group_sums once per run.
  5. profile     — the dense ORDER BY rollup under torch.profiler: device
                   time by kernel, launches, syncs and busy share per run.
  6. tpch22      — all 8 TPC-H tables at SF1 from the port's copy of the
                   generator (sqlrs_tpu_torch/benchmarks/tpch_dbgen.py, seed
                   printed), the columns the 22 queries read loaded into
                   Database(device="cuda"); the load must have interned
                   through the native string interner (data/strings.py's
                   own build of native/interner.cpp), and the line
                   `intern: native` gives the load's seconds and its
                   interning's beside the Python path's on the same string
                   columns (a fresh unbound StringDictionary()); each query
                   one cold and three warm runs, its rows, routes, kernel
                   launches and peak device memory. Every query's rows must equal the port's
                   own CPU run on the same tables (benchmarks/tpch.py's
                   rule: floats rel 1e-9 or abs 1e-6), with equal routes;
                   Q3, Q4 and Q18 must match numpy oracles; Q1 must log
                   hashagg_mxu and launch grouped_histogram.
  7. profile     — the 22's slowest warm query under torch.profiler, then
                   one pass over all 22: device time by kernel and by aten
                   op, and the host ops.
  8. dist        — the sharded engine (sqlrs_tpu_torch/parallel/) over a
                   mesh of 4 shards that share the one card
                   (make_mesh(4, devices=["cuda:0"] * 4)): bench.py's star
                   through the four join + GROUP BY strategies of
                   parallel/dist_ops.py, each equal to numpy exactly; then
                   the 22 TPC-H queries at SF1 on phase 6's tables through
                   Database(mesh=...), one cold and two warm runs each, every
                   run's rows equal to phase 6's single-device rows by the
                   same rule, with warm ms beside the single-device ms, the
                   join strategies, kernel launches, peak device memory and
                   a profiled run's syncs; then a profile of the sharded
                   suite with the collectives and the rank stage annotated.

  9. the remaining modules (printed as phases profile_ops, unsigned and
                   csv): utils/profiling.py on phase 6's database (after
                   phase 7) and on phase 8's (after it): the 22 with the
                   profile on, each statement's (op, depth, rows_out) list
                   equal to phase 6's CPU run (which ran with the profile
                   on), every root's rows_out equal to its result's rows,
                   host self time by query and by operator kind, the warm
                   pass with the profile off/on/on/off, and a
                   profiling.trace() of Q1 that must hold
                   grouped_histogram. The unsigned types: a table of 2^24
                   rows (UTINYINT..UBIGINT, numpy seed 0, ~1% NULLs) and a
                   2^16-row join table, six queries (kernel 1's GROUP BY,
                   the sorted GROUP BY of full-range UBIGINT, ORDER BY e
                   both ways, wrapping arithmetic and / % folded to sums,
                   the join, cast to DOUBLE), each against an exact numpy
                   oracle, the port's CPU run and 4 shards on the card,
                   beside the same GROUP BY on signed columns. The native
                   CSV loader: TPC-H lineitem at SF 0.1 as CSV, read by the
                   native loader and by read_csv_file (equal, both timed),
                   Q1/Q6 from it equal to the numpy-loaded table; then
                   `python -m sqlrs_tpu_torch.cli --device cuda` on it, its
                   table text equal to pretty_table of Database.run's.

 10. the multi-process layer (printed as phases comparison_strategies and
                   multiprocess): make_join_groupby's 'hash', 'sorted' and
                   'sorted_packed' on bench.py's dense and spread star beside
                   'direct' (kernel 2 on the dense one), each exact against
                   numpy, and mxu_groupby_dense_xla bit-equal to kernel 2 at
                   2^25 x 2^16 with both timed (CUDA events, device time).
                   Then phase 6's tables, pickled once into a temporary
                   directory, and child processes of this script (each with
                   a timeout, all killed past it): two processes over gloo,
                   each with 2 shards on the card (CUDA tensors staged
                   through host memory), run bench.py's star through the
                   broadcast, shuffle_checked, salted_checked and ring
                   strategies (exact against numpy) and all 22 queries, one
                   cold and one warm run each; a one-rank NCCL group with 4
                   shards runs the star and Q3, Q5, Q12, Q13, Q18, Q22; two
                   NCCL ranks, one a card, only with two cards (else the
                   line `nccl_2rank: not run (1 card)`). Every process's rows
                   must equal phase 6's single-device rows by the phase's
                   rule; printed beside phase 8's ms: warm ms, bytes across
                   processes, host staging ms, peak memory a process, join
                   strategies, kernel launches.

 11. fuzz        — (run between phases 5 and 6, while the string
                   dictionary is small: a new LIKE pattern evaluates over
                   the whole dictionary, about a second a pattern once phase
                   6 has interned TPC-H's strings) the engine-vs-engine fuzz
                   corpus
                   (sqlrs_tpu_torch/benchmarks/sql_fuzz.py): the cases
                   the fast tests hold to the JAX package on the CPU (40 small, 4
                   medium, one large at 2^17 fact rows) and 4 large seeds at
                   2^18, each loaded into the port on the CPU, on the card
                   and over 4 shards on the card. Every statement runs once
                   on the CPU and twice on each card engine: the card's rows
                   must equal the CPU run's (floats rel 1e-9) and each repeat
                   must equal its first run bit for bit. Prints statements,
                   differences (with seed and SQL), kernel 1's and kernel
                   2's launches (both > 0 required), routes, join strategies
                   (shuffle required), the seconds by engine and the
                   phase's seconds.

Then one JSON line about the kernels, and last one JSON line
{"ok": true, "device": {...}}. Any failure raises, and the process exits
non-zero. Without CUDA it exits non-zero before printing anything.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20260101
SF1_ORDERS = 1_500_000
SF1_PARTS = 200_000
CURRENTDATE = "1995-06-17"
STAR_ROWS = 1 << 25     # bench.py's fact table
STAR_GROUPS = 1 << 16   # and its dim table
KERNEL_SOURCES = ("mxu_grouped", "mxu_agg", "pallas_kernels")
# the first versions of kernels 1-4, built only here, to be timed in turns
# with the current ones in this run
BASELINE_SOURCES = ("baseline/mxu_grouped_v1", "baseline/mxu_agg_v1",
                    "baseline/pallas_kernels_v1")
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's device memory rate
REPO = os.path.dirname(os.path.abspath(__file__))

Q1 = """
select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
       sum(l_extendedprice) as sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
       avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
       avg(l_discount) as avg_disc, count(*) as count_order
from lineitem
where l_shipdate <= date '1998-09-02'
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""

Q6 = """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1995-01-01'
  and l_discount between 0.05 and 0.07
  and l_quantity < 24
"""


STAR_SQL = {
    "dense_order": ("select d.k, sum(f.v), count(*) from f join d on f.k = d.k "
                    "group by d.k order by d.k", "order_agg_join_direct_dense_mxu"),
    "dense_firstapp": ("select d.k, sum(f.v), count(*) from f join d on f.k = d.k "
                       "group by d.k", "agg_join_firstapp_dense"),
    "spread_order": ("select ds.k, sum(fs.v), count(*) from fs join ds on fs.k = ds.k "
                     "group by ds.k order by ds.k", "order_agg_join_direct"),
}

ROLLUP_SQL = """
select o_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue
from lineitem join orders on l_orderkey = o_orderkey
group by o_orderkey
order by o_orderkey
"""


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, per: int = 1) -> float:
    """Milliseconds per call of fn() by CUDA events, after two warm-up
    calls: the median over reps samples, each a run of `per` calls back to
    back divided by per (so that, for a short kernel, the host's time to
    enqueue one call does not land between the events)."""
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / per)
    return float(np.median(times))


def bound_ms(n_bytes: float) -> float:
    """The least time to move n_bytes through device memory at its rate."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def in_turns(old, new, reps: int = 5, per: int = 10):
    """(new ms, old ms): old, new, new, old, each timed by cuda_ms, and the
    mean of each pair."""
    o1, n1, n2, o2 = (cuda_ms(f, reps, per) for f in (old, new, new, old))
    return (n1 + n2) / 2, (o1 + o2) / 2


def _c_fn(source: str, symbol: str, argtypes):
    import ctypes

    from sqlrs_tpu_torch.utils.cuda_build import load_kernel_library

    fn = getattr(load_kernel_library(source), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def v1_dense_group_sums(gid, vals, G: int):
    """The first kernel 2 (csrc/baseline/mxu_agg_v1.cu) on int32 gid and
    vals, launched as its wrapper launched it: 8192-group tiles over
    blockIdx.y, about two blocks per SM in all."""
    import ctypes

    c = ctypes
    fn = _c_fn("baseline/mxu_agg_v1", "sqlrs_dense_group_sums_v1", [
        c.c_void_p, c.c_void_p, c.c_longlong, c.c_int, c.c_int, c.c_void_p,
        c.c_void_p, c.c_int, c.c_int, c.c_void_p])
    n = int(gid.shape[0])
    tile = min(G, 8192)
    n_tiles = -(-G // tile)
    sms = torch.cuda.get_device_properties(gid.device).multi_processor_count
    grid_x = max(1, min(-(-n // 1024), -(-2 * sms // n_tiles)))
    sums = torch.zeros(G, dtype=torch.int64, device=gid.device)
    counts = torch.zeros(G, dtype=torch.int64, device=gid.device)
    err = fn(gid.data_ptr(), vals.data_ptr(), n, G, tile, sums.data_ptr(),
             counts.data_ptr(), grid_x, 1024, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"first kernel 2 launch failed: cudaError {err}")
    return sums, counts


def v1_grouped_histogram(gid, words, plan, G: int):
    """The first kernel 1 (csrc/baseline/mxu_grouped_v1.cu), launched as its
    wrapper launched it: 256 threads, four blocks per SM."""
    import ctypes

    c = ctypes
    fn = _c_fn("baseline/mxu_grouped_v1", "sqlrs_grouped_histogram_v1", [
        c.c_void_p, c.c_void_p, c.c_longlong, c.c_int, c.POINTER(c.c_int),
        c.POINTER(c.c_int), c.c_int, c.c_int, c.c_void_p, c.c_void_p, c.c_int,
        c.c_int, c.c_void_p])
    n, nl = int(gid.shape[0]), len(plan)
    sms = torch.cuda.get_device_properties(gid.device).multi_processor_count
    grid = max(max(1, min(-(-n // 256), 4 * sms)), -(-n // (1 << 24)))
    totals = torch.zeros(1 + nl, G, dtype=torch.int64, device=gid.device)
    first = torch.full((G,), 2**63 - 1, dtype=torch.int64, device=gid.device)
    pw = (c.c_int * max(nl, 1))(*[w for w, _ in plan])
    ps = (c.c_int * max(nl, 1))(*[s for _, s in plan])
    err = fn(gid.data_ptr(), words.data_ptr(), n, int(words.shape[0]), pw, ps, nl, G,
             totals.data_ptr(), first.data_ptr(), grid, 256,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"first kernel 1 launch failed: cudaError {err}")
    return totals, first


# ---- phase 2: the kernel against its plain version -------------------------


def histogram_inputs(rng, n: int, G: int, n_limbs: int, dev, saturate: bool):
    """gid with ~1/8 misses (-1 and G), words of random 24-bit values (or
    all 0xFFFFFF, every limb 255), and a limb plan over them."""
    gid = rng.integers(0, G, n, dtype=np.int32)
    miss = rng.random(n) < 0.125
    gid[miss] = np.where(rng.random(int(miss.sum())) < 0.5, -1, G).astype(np.int32)
    n_words = max(1, -(-n_limbs // 3))
    if saturate:
        words = np.full((n_words, n), 0xFFFFFF, np.int32)
    else:
        words = rng.integers(0, 1 << 24, (n_words, n), dtype=np.int32)
        words[:, ::7] = 0xFFFFFF
    plan = [(j // 3, (j % 3) * 8) for j in range(n_limbs)]
    return (
        torch.from_numpy(gid).to(dev),
        torch.from_numpy(words).to(dev),
        plan,
    )


def q1_group_ids(li) -> np.ndarray:
    """Q1's group of each lineitem row, as the histogram sees it: the four
    (returnflag, linestatus) pairs that occur as 0..3, and -1 for a row the
    ship-date filter drops."""
    from sqlrs_tpu_torch.types.values import date_str_to_days

    pair = np.searchsorted(np.array(["A", "N", "R"]), li["l_returnflag"]) * 2 + (
        li["l_linestatus"] == "O")
    gid = np.array([0, -1, 1, 2, 3, -1], np.int32)[pair]  # AF, NF, NO, RF
    gid[li["l_shipdate"] > date_str_to_days("1998-09-02")] = -1
    return gid


def phase_kernel(dev, card: str, li: dict) -> dict:
    """li: the SF1 lineitem whose Q1 the main path aggregates."""
    n_main = len(li["l_quantity"])
    from sqlrs_tpu_torch.ops.mxu_grouped import (
        grouped_histogram,
        grouped_histogram_plain,
    )

    rng = np.random.default_rng(SEED)
    max_err = 0
    cases = 0
    for n in (1, 2047, 2049, n_main):
        for G in (1, 4, 1000, 1024):
            for nch in (1, 15, 32):
                for saturate in ((False, True) if n == 2049 else (False,)):
                    gid, words, plan = histogram_inputs(
                        rng, n, G, nch - 1, dev, saturate
                    )
                    tk, fk = grouped_histogram(gid, words, plan, G)
                    tp, fp = grouped_histogram_plain(gid, words, plan, G)
                    torch.cuda.synchronize()
                    if not (torch.equal(tk, tp) and torch.equal(fk, fp)):
                        raise AssertionError(
                            f"kernel != plain at n={n} G={G} nch={nch} "
                            f"saturate={saturate}"
                        )
                    err = max(
                        int((tk - tp).abs().max()),
                        int((fk != fp).sum()),
                    )
                    max_err = max(max_err, err)
                    cases += 1
    # every row a miss
    gid = torch.full((4097,), -1, dtype=torch.int32, device=dev)
    words = torch.zeros((1, 4097), dtype=torch.int32, device=dev)
    tk, fk = grouped_histogram(gid, words, [(0, 0)], 4)
    if int(tk.abs().sum()) != 0 or int((fk != 2**63 - 1).sum()) != 0:
        raise AssertionError("all-miss input gave nonzero totals")
    cases += 1

    # Q1's shape: G=4, 15 channels over 7 words
    n = n_main
    words = torch.from_numpy(rng.integers(0, 1 << 24, (7, n), dtype=np.int32)).to(dev)
    plan = [(0, 0), (1, 0), (1, 8), (1, 16), (2, 0), (2, 8), (2, 16), (3, 0),
            (4, 0), (4, 8), (4, 16), (5, 0), (5, 8), (6, 0)]
    # skew: one group with 90% of the rows, then every row in one group
    dominant = np.where(rng.random(n) < 0.9, 1, rng.integers(0, 4, n)).astype(np.int32)
    for what, g_np in (("one dominant group", dominant),
                       ("every row in one group", np.full(n, 2, np.int32))):
        g_t = torch.from_numpy(g_np).to(dev)
        tk, fk = grouped_histogram(g_t, words, plan, 4)
        tp, fp = grouped_histogram_plain(g_t, words, plan, 4)
        torch.cuda.synchronize()
        if not (torch.equal(tk, tp) and torch.equal(fk, fp)):
            raise AssertionError(f"grouped_histogram != plain with {what}")
        cases += 1
    q1_gid = q1_group_ids(li)
    shares = np.bincount(q1_gid[q1_gid >= 0], minlength=4) / n
    gid = torch.from_numpy(q1_gid).to(dev)
    tk, fk = grouped_histogram(gid, words, plan, 4)
    t1, f1 = v1_grouped_histogram(gid, words, plan, 4)
    if not (torch.equal(tk, t1) and torch.equal(fk, f1)):
        raise AssertionError("grouped_histogram != the first kernel at Q1's shape")
    ms, v1_ms = in_turns(lambda: v1_grouped_histogram(gid, words, plan, 4),
                         lambda: grouped_histogram(gid, words, plan, 4))
    plain_ms = cuda_ms(lambda: grouped_histogram_plain(gid, words, plan, 4), 5)
    dev_ms = device_ms(lambda: grouped_histogram(gid, words, plan, 4), "grouped_histogram")
    hus = host_us(lambda: grouped_histogram(gid, words, plan, 4))
    bound = bound_ms(n * 4 * (1 + 7) + (1 + len(plan) + 1) * 4 * 8)
    print(
        f"phase kernel: grouped_histogram == plain bit for bit in {cases} cases; "
        f"at Q1's shape (n={n}, G=4 with Q1's group ids, shares "
        f"{', '.join(f'{x:.3f}' for x in shares)}, nch=15, 7 words): kernel {ms:.3f} ms, first "
        f"kernel {v1_ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound:.3f} ms "
        f"({bound / ms:.1%} of it); the kernel's device time {dev_ms:.4f} ms a call "
        f"(torch.profiler), "
        f"host {hus:.1f} us a call [{card}]",
        flush=True,
    )
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "library_ms": None, "baseline_ms": v1_ms, "device_ms": dev_ms, "host_us": hus}


def dense_inputs(rng, n: int, G: int, hi: int, dev, saturate: bool = False):
    """gid with misses below (-1, INT32_MIN) and above (G) the domain,
    values below hi (or all 2^24 - 1)."""
    gid = rng.integers(0, G, n, dtype=np.int32)
    gid[::9] = -1
    gid[4::11] = G
    gid[7::13] = np.iinfo(np.int32).min
    if saturate:
        vals = np.full(n, (1 << 24) - 1, np.int32)
    else:
        vals = rng.integers(0, hi, n, dtype=np.int32)
    return torch.from_numpy(gid).to(dev), torch.from_numpy(vals).to(dev)


def keyed_inputs(rng, n: int, G: int, kdt, vdt, key_min: int, masked: bool,
                 skew: str, dev, val_bits=None):
    """Stored-column inputs: keys in [key_min, key_min + G) with the given
    skew (zipf(1.2), every row on one id, hot ids at both ends, uniform),
    misses just outside the domain and, for int64 keys, 2^32 away from it;
    values of both signs, or in [0, 2^val_bits) with every seventh at the
    top; a validity mask when asked."""
    if skew == "zipf":
        gid = np.minimum(rng.zipf(1.2, n), G) - 1
    elif skew == "one_id":
        gid = np.full(n, G // 3, np.int64)
    elif skew == "ends":
        gid = np.where(rng.random(n) < 0.5, 0, G - 1)
        gid[::3] = rng.integers(0, G, len(gid[::3]))
    else:
        gid = rng.integers(0, G, n)
    keys = gid.astype(np.int64) + key_min
    if kdt == np.int64:
        keys[5::17] += 1 << 32
        keys[6::17] -= 1 << 32
    keys[7::19] = key_min - 1
    keys[8::19] = key_min + G
    if val_bits is not None:
        vals = rng.integers(0, 1 << val_bits, n)
        vals[::7] = (1 << val_bits) - 1
    elif vdt == np.int64:
        vals = rng.integers(-(1 << 40), 1 << 40, n)
    else:
        vals = rng.integers(-(1 << 31), (1 << 31) - 1, n)
    out = [torch.from_numpy(keys.astype(kdt)).to(dev), torch.from_numpy(vals.astype(vdt)).to(dev)]
    out.append(torch.from_numpy(rng.random(n) < 0.75).to(dev) if masked else None)
    return out


def phase_dense_kernel(dev, card: str, star: dict) -> dict:
    """dense_group_sums against its plain version: int32 gids as the first
    kernel took them, the stored-column contract (int32 and int64 keys and
    values, key_min with keys 2^32 away, invalid rows), and skews at 1, 2,
    5 and 8 interleaved owners. Then timed at the star rollup's shape, in
    turns with the first kernel: the kernel alone on int32 gids, and the
    whole step on the stored int64 columns and mask against the route's
    former prelude plus the first kernel."""
    from sqlrs_tpu_torch.ops.mxu_agg import dense_group_sums, dense_group_sums_plain

    rng = np.random.default_rng(SEED + 1)
    max_err, cases = 0, 0

    def check(keys, vals, G, what, key_min=0, valid=None, val_bits=None):
        nonlocal max_err, cases
        sk, ck = dense_group_sums(keys, vals, G, key_min=key_min, valid=valid,
                                  val_bits=val_bits)
        sp, cp = dense_group_sums_plain(keys, vals, G, key_min=key_min, valid=valid)
        torch.cuda.synchronize()
        if not (torch.equal(sk, sp) and torch.equal(ck, cp)):
            raise AssertionError(f"dense_group_sums != plain at {what}")
        max_err = max(max_err, int((sk - sp).abs().max()), int((ck - cp).abs().max()))
        cases += 1
        return sk, ck

    for n in (1, 2047, 2049, STAR_ROWS):
        for G in (1, 256, 4097, STAR_GROUPS):
            for hi in (1 << 7, 1 << 24):
                gid, vals = dense_inputs(rng, n, G, hi, dev)
                check(gid, vals, G, f"n={n} G={G} values<{hi}")
    gid, vals = dense_inputs(rng, 100_003, STAR_GROUPS, 0, dev, saturate=True)
    check(gid, vals, STAR_GROUPS, "every value 2^24 - 1")
    gid = torch.full((70_001,), -1, dtype=torch.int32, device=dev)
    sk, ck = check(gid, vals[:70_001], STAR_GROUPS, "every row a miss")
    if int(ck.sum()) != 0 or int(sk.abs().sum()) != 0:
        raise AssertionError("all-miss input gave nonzero totals")
    for kdt in (np.int32, np.int64):
        for vdt in (np.int32, np.int64):
            for masked in (False, True):
                key_min = (1 << 32) + 7 if kdt == np.int64 else -5
                keys, vals, valid = keyed_inputs(rng, 1_000_003, STAR_GROUPS, kdt, vdt,
                                                 key_min, masked, "uniform", dev)
                check(keys, vals, STAR_GROUPS, f"keys {kdt.__name__} values "
                      f"{vdt.__name__} key_min {key_min} mask {masked}", key_min, valid)
    # 1, 2, 5, 8 owners; signed values (a count and a sum in two cells),
    # then values in [0, 2^7) and [0, 2^20) with val_bits given: 4M rows are
    # 22 bits, so 22 + 22 + 20 = 64 fills the packed cell exactly
    for G in (8192, 8193, 40000, STAR_GROUPS):
        for skew in ("zipf", "one_id", "ends"):
            for val_bits in (None, 7, 20):
                keys, vals, valid = keyed_inputs(rng, 4_000_037, G, np.int64, np.int64,
                                                 -(1 << 40), True, skew, dev, val_bits)
                check(keys, vals, G, f"G={G} {skew} keys, val_bits {val_bits}",
                      -(1 << 40), valid, val_bits)

    # the star rollup's stored columns: BIGINT keys (the dense dim's keys
    # are 0..2^16-1, so key_min = 0), BIGINT values below 100 (the route
    # passes val_bits 7), and the keys' mask
    G, key_min, val_bits = STAR_GROUPS, 0, 7
    keys64 = torch.from_numpy(star["gid"]).to(dev)
    vals64 = torch.from_numpy(star["v"]).to(dev)
    valid = torch.ones(STAR_ROWS, dtype=torch.bool, device=dev)
    check(keys64, vals64, G, "the star rollup's columns", key_min, valid, val_bits)
    gid32, vals32 = keys64.to(torch.int32), vals64.to(torch.int32)
    sk, ck = check(gid32, vals32, G, "the star rollup's gids", val_bits=val_bits)
    s1, c1 = v1_dense_group_sums(gid32, vals32, G)
    if not (torch.equal(sk, s1) and torch.equal(ck, c1)):
        raise AssertionError("dense_group_sums != the first kernel at the star shape")

    def v1_step():
        # the route's former prelude (fused_route.py's mask, mxu_agg.py's
        # int64 rebase and int32 casts), then the first kernel
        fk = torch.where(valid, keys64, key_min - 1)
        k64 = fk - key_min
        inr = (k64 >= 0) & (k64 < G)
        k32 = torch.where(inr, k64, -1).to(torch.int32)
        return v1_dense_group_sums(k32, vals64.to(torch.int32).contiguous(), G)

    alone_ms, alone_v1_ms = in_turns(lambda: v1_dense_group_sums(gid32, vals32, G),
                                     lambda: dense_group_sums(gid32, vals32, G,
                                                              val_bits=val_bits))
    ms, v1_ms = in_turns(v1_step, lambda: dense_group_sums(
        keys64, vals64, G, key_min=key_min, valid=valid, val_bits=val_bits))
    plain_ms = cuda_ms(lambda: dense_group_sums_plain(
        keys64, vals64, G, key_min=key_min, valid=valid), 5)
    wf = vals64.to(torch.float64)
    library_ms = cuda_ms(lambda: (torch.bincount(keys64, minlength=G),
                                  torch.bincount(keys64, weights=wf, minlength=G)), 5)

    def step():
        return dense_group_sums(keys64, vals64, G, key_min=key_min, valid=valid,
                                val_bits=val_bits)

    dev_ms, hus = device_ms(step, "dense_group_sums_kernel"), host_us(step)
    bound = bound_ms(STAR_ROWS * (8 + 8 + 1) + G * 16)
    alone_bound = bound_ms(STAR_ROWS * (4 + 4) + G * 16)
    print(
        f"phase kernel: dense_group_sums == plain bit for bit in {cases} cases; at "
        f"the star rollup's shape (n={STAR_ROWS}, G={G}, zipf keys): whole step "
        f"(int64 keys and values, mask) {ms:.3f} ms, first kernel with the former "
        f"prelude {v1_ms:.3f} ms, plain {plain_ms:.3f} ms, torch.bincount pair "
        f"{library_ms:.3f} ms, bound {bound:.3f} ms ({bound / ms:.1%} of it); kernel "
        f"alone on int32 gids {alone_ms:.3f} ms, first kernel {alone_v1_ms:.3f} ms, "
        f"bound {alone_bound:.3f} ms ({alone_bound / alone_ms:.1%}); the step's kernel: "
        f"device {dev_ms:.4f} ms a call (torch.profiler), host {hus:.1f} us a call [{card}]",
        flush=True,
    )
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "library_ms": library_ms, "baseline_ms": v1_ms, "device_ms": dev_ms,
            "host_us": hus}


def rank_inputs(rng, nq: int, dev, nb: int = 64, sorted_rows: bool = True, offset: int = 0):
    """Rows (sorted, or not), block indices with some below 0 and some at or
    above nb, queries below, on and above the lanes, rem with every edge
    (-5, 0, 1, 127, 128, 200). offset > 0 puts the rows at that element
    offset into a larger buffer: a multiple of 4 keeps a 16-B aligned base,
    an odd one does not."""
    x = rng.integers(-50_000, 50_000, nb * 128).astype(np.int32)
    sp2d = (np.sort(x) if sorted_rows else x).reshape(nb, 128)
    b = rng.integers(0, nb, nq).astype(np.int32)
    q = rng.integers(-60_000, 60_000, nq).astype(np.int32)
    q[::4] = sp2d[b[::4], 64]
    q[1::9] = np.iinfo(np.int32).min
    q[2::9] = np.iinfo(np.int32).max
    b[3::11] = -3
    b[5::13] = nb + 2
    rem = rng.integers(0, 129, nq).astype(np.int32)
    rem[::5] = 0
    rem[1::5] = 128
    for i, r in enumerate((-5, 1, 127, 200)):
        rem[2 + i::7 + 2 * i] = r
    v2d = rng.integers(-(1 << 31), (1 << 31) - 1, (nb, 128)).astype(np.int32)
    rows = []
    for a in (sp2d, v2d):
        t = torch.from_numpy(a).to(dev)
        if offset:
            buf = torch.zeros(offset + nb * 128, dtype=torch.int32, device=dev)
            buf[offset:] = t.reshape(-1)
            t = buf[offset:].view(nb, 128)
        rows.append(t)
    return rows + [torch.from_numpy(a).to(dev) for a in (b, q, rem)]


def device_ms(fn, match: str, calls: int = 20, flush=None, at_least: float = 0.0) -> float:
    """Device milliseconds per call of fn(), which launches one kernel whose
    name holds `match`: the mean duration of torch.profiler's records of
    that kernel over `calls` calls, after two warm-up calls. The profiler
    may drop records of a window (seen on the H100, up to 12 of 20 three
    windows in a row); a trace with fewer than half the calls' records, or
    with a mean under `at_least` ms (a time the kernel cannot take, such as
    half its time by CUDA events), is taken again, at most six times; then
    the records of all the windows are pooled, and fewer than `calls` of
    them, or a mean under `at_least`, raise. More records than calls in a
    window raise. With `flush`, flush() runs before each call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    torch.cuda.synchronize()
    pooled_us, pooled_n = 0.0, 0
    for _ in range(6):
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
        if us > 0 and 2 * n >= calls and us / 1e3 / n >= at_least:
            return us / 1e3 / n
        pooled_us, pooled_n = pooled_us + us, pooled_n + n
    if pooled_n >= calls and pooled_us / 1e3 / pooled_n >= at_least:
        return pooled_us / 1e3 / pooled_n
    raise AssertionError(f"torch.profiler traced {pooled_n} records of {match} for "
                         f"{6 * calls} calls, {pooled_us / 1e3:.4f} ms in all (at least "
                         f"{at_least:.4f} ms a call)")


def l2_flusher(dev):
    """A read of 128 MB, more than twice the H100's 50 MB L2, which leaves
    none of a kernel's rows there and no dirty lines to write back."""
    buf = torch.ones(1 << 25, dtype=torch.int32, device=dev)
    return lambda: buf.sum()


def host_us(fn, calls: int = 1024, batch: int = 32) -> float:
    """Host microseconds per call of fn(): the host clock over `calls` calls,
    in runs of `batch` with a synchronize (untimed) after each, so that the
    launch queue never fills and the clock reads the host's own cost."""
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


def v1_rank_fns():
    """The first kernels 3 and 4 (csrc/baseline/pallas_kernels_v1.cu),
    launched as their wrapper launched them: a warp a query, 256 threads."""
    import ctypes

    c = ctypes
    fns = {name: _c_fn("baseline/pallas_kernels_v1", f"sqlrs_{name}_v1", [
        c.c_void_p, c.c_longlong, c.c_void_p, c.c_void_p, c.c_longlong, c.c_void_p,
        c.c_int, c.c_void_p]) for name in ("row_rank_ge", "masked_row_sum")}

    def make(name):
        fn = fns[name]

        def run(x2d, b, s):
            out = torch.empty(s.shape[0], dtype=torch.int32, device=x2d.device)
            err = fn(x2d.data_ptr(), x2d.shape[0], b.data_ptr(), s.data_ptr(), s.shape[0],
                     out.data_ptr(), 256, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"first {name} launch failed: cudaError {err}")
            return out
        return run

    return {name: make(name) for name in fns}


def rank_bound_ms(x2d, b, scalar, lanes_below: bool) -> float:
    """The bytes bound of one call: each distinct row a query lands on read
    once (the whole 512 B, or with lanes_below only its 32-B sectors below
    the largest rem that lands on it), and 12 B a query (block index,
    operand, answer)."""
    nb = x2d.shape[0]
    rows = torch.clamp(b.to(torch.int64), 0, nb - 1)
    if lanes_below:
        top = torch.zeros(nb, dtype=torch.int64, device=b.device).scatter_reduce_(
            0, rows, torch.clamp(scalar.to(torch.int64), 0, 128), "amax")
        n_bytes = int(((top + 7) // 8).sum()) * 32
    else:
        n_bytes = torch.unique(rows).numel() * 512
    return bound_ms(n_bytes + 12 * b.shape[0])


def phase_rank_kernels(dev, card: str, star: dict) -> dict:
    """row_rank_ge and masked_row_sum against their plain versions: ragged
    query counts, unsorted rows, one row, block indices outside [0, nb), rem
    of every edge, and rows at an aligned and a misaligned offset; then at
    two shapes, each also against the first kernels. S1, the star rollup's
    rank stage: the sorted pack32 array (k << 7 | v) as (2^18, 128) blocks
    and the 2^16 + 1 dense boundary queries d << 7, with the block of each
    query as the stage finds it (the block minima below it) and its
    in-block position. S2, uniform: the same blocks, 2^17 queries on rows
    uniform over the 2^18, each a lane of its row +- 2, rem uniform in
    [0, 128]. At each: device ms per call (torch.profiler) in turns with the
    first kernels, the wrapper's host us per call, the end-to-end CUDA-event
    ms, the plain version's ms and each kernel's bytes bound."""
    from sqlrs_tpu_torch.ops.pallas_kernels import (
        masked_row_sum,
        masked_row_sum_plain,
        row_rank_ge,
        row_rank_ge_plain,
    )

    rng = np.random.default_rng(SEED + 2)
    max_err, cases = 0, 0
    v1 = v1_rank_fns()

    def check(sp2d, v2d, b, q, rem, what, first=False):
        nonlocal max_err, cases
        before = (row_rank_ge.launches, masked_row_sum.launches)
        rk, rp = row_rank_ge(sp2d, b, q), row_rank_ge_plain(sp2d, b, q)
        mk, mp = masked_row_sum(v2d, b, rem), masked_row_sum_plain(v2d, b, rem)
        torch.cuda.synchronize()
        if (row_rank_ge.launches, masked_row_sum.launches) != (before[0] + 1, before[1] + 1):
            raise AssertionError(f"rank-stage kernels not launched once each at {what}")
        if not (torch.equal(rk, rp) and torch.equal(mk, mp)):
            raise AssertionError(f"rank-stage kernels != plain at {what}")
        if first and not (torch.equal(rk, v1["row_rank_ge"](sp2d, b, q))
                          and torch.equal(mk, v1["masked_row_sum"](v2d, b, rem))):
            raise AssertionError(f"rank-stage kernels != the first kernels at {what}")
        max_err = max(max_err, int((rk - rp).abs().max()), int((mk - mp).abs().max()))
        cases += 1
        return rk, mk

    for nq in (1, 3, 4, 5, 31, 32, 33, 129, 1000, 65537):
        check(*rank_inputs(rng, nq, dev), what=f"nq={nq}")
    check(*rank_inputs(rng, 1000, dev, sorted_rows=False), what="unsorted rows")
    check(*rank_inputs(rng, 129, dev, nb=1), what="nb=1")
    check(*rank_inputs(rng, 1000, dev, offset=128), what="an aligned row-offset view")
    check(*rank_inputs(rng, 1000, dev, offset=3), what="a misaligned view")

    vb = 7
    packed = (torch.from_numpy(star["gid"].astype(np.int32)).to(dev) << vb) | torch.from_numpy(
        star["v"].astype(np.int32)).to(dev)
    sp = torch.sort(packed).values
    nb = sp.shape[0] // 128
    sp2d = sp.view(nb, 128)
    q = torch.arange(STAR_GROUPS + 1, dtype=torch.int32, device=dev) << vb
    c = torch.searchsorted(sp2d[:, 0].contiguous(), q, side="left")
    b_rank = torch.clamp(c - 1, 0, nb - 1).to(torch.int32)
    ranks = torch.searchsorted(sp, q, side="left")
    b_sum = torch.clamp(ranks // 128, 0, nb - 1).to(torch.int32)
    rem = (ranks % 128).to(torch.int32)
    v2d = sp2d & ((1 << vb) - 1)
    rk, _ = check(sp2d, v2d, b_rank, q, rem, "S1 (rank blocks)", first=True)
    _, mk = check(sp2d, v2d, b_sum, q, rem, "S1 (prefix blocks)", first=True)
    # the in-block steps recompose the stage's answers: the rank of each
    # boundary, and the value prefix sum below it
    n = sp.shape[0]
    rank_left = torch.where(c == 0, 0, n - ((nb - c) * 128 + rk.to(torch.int64)))
    if not torch.equal(rank_left, ranks):
        raise AssertionError("row_rank_ge does not recompose searchsorted")
    block_prefix = torch.cumsum(v2d.sum(1, dtype=torch.int64), 0) - v2d.sum(1, dtype=torch.int64)
    prefix = torch.where(ranks >= n, v2d.sum(dtype=torch.int64),
                         block_prefix[b_sum.long()] + mk.to(torch.int64))
    full = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum((sp & ((1 << vb) - 1)).to(torch.int64), 0)])
    if not torch.equal(prefix, full[ranks]):
        raise AssertionError("masked_row_sum does not recompose the value prefix sums")

    nq2 = 1 << 17
    b2 = torch.from_numpy(rng.integers(0, nb, nq2).astype(np.int32)).to(dev)
    lane2 = torch.from_numpy(rng.integers(0, 128, nq2)).to(dev)
    q2 = sp2d[b2.long(), lane2] + torch.from_numpy(rng.integers(-2, 3, nq2).astype(np.int32)).to(dev)
    rem2 = torch.from_numpy(rng.integers(0, 129, nq2).astype(np.int32)).to(dev)
    check(sp2d, v2d, b2, q2, rem2, "S2", first=True)

    shapes = {"S1": {"row_rank_ge": (sp2d, b_rank, q), "masked_row_sum": (v2d, b_sum, rem)},
              "S2": {"row_rank_ge": (sp2d, b2, q2), "masked_row_sum": (v2d, b2, rem2)}}
    kernels = {"row_rank_ge": (row_rank_ge, row_rank_ge_plain),
               "masked_row_sum": (masked_row_sum, masked_row_sum_plain)}
    flush = l2_flusher(dev)
    res = {}
    for shape, args in shapes.items():
        for name, (kern, plain) in kernels.items():
            x2d, b, s = args[name]
            r = res[shape, name] = {}
            # in turns with the first kernel: with the L2 flushed before each
            # call (the rows come from device memory, as the bound assumes),
            # then back to back (what stays in the 50 MB L2 is hit)
            first, cur = (lambda: v1[name](x2d, b, s)), (lambda: kern(x2d, b, s))
            for key, fl in (("", flush), ("_warm", None)):
                t = [device_ms(f, flush=fl, match=m) for f, m in (
                    (first, "_kernel_v1"), (cur, "rank_stage_kernel"),
                    (cur, "rank_stage_kernel"), (first, "_kernel_v1"))]
                r["device_ms" + key] = (t[1] + t[2]) / 2
                r["baseline_ms" + key] = (t[0] + t[3]) / 2
            r.update(host_us=host_us(lambda: kern(x2d, b, s)),
                     ms=cuda_ms(lambda: kern(x2d, b, s), 5, 10),
                     plain_ms=cuda_ms(lambda: plain(x2d, b, s), 5, 10),
                     bound_ms=rank_bound_ms(x2d, b, s, name == "masked_row_sum"))
    print(f"phase kernel: row_rank_ge and masked_row_sum == plain bit for bit in "
          f"{cases} cases each (and == the first kernels at S1 and S2), and recompose "
          f"the rank stage's ranks and prefix sums [{card}]", flush=True)
    for (shape, name), r in res.items():
        nq_s = shapes[shape][name][1].shape[0]
        print(f"  {shape} {name} (sp2d ({nb}, 128), {nq_s} queries): device "
              f"{r['device_ms']:.4f} ms, first kernel {r['baseline_ms']:.4f} ms (L2 "
              f"flushed before each call; back to back {r['device_ms_warm']:.4f} and "
              f"{r['baseline_ms_warm']:.4f} ms; in turns, torch.profiler); host "
              f"{r['host_us']:.1f} us a call; CUDA events {r['ms']:.4f} ms; plain "
              f"{r['plain_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_ms'] / r['device_ms']:.1%} of the flushed device time) [{card}]",
              flush=True)
    # no one PyTorch call computes either
    out = {}
    for name in kernels:
        r1, r2 = res["S1", name], res["S2", name]
        out[name] = {"max_abs_err": max_err, "library_ms": None,
                     **{k: r1[k] for k in ("ms", "plain_ms", "bound_ms", "baseline_ms",
                                           "device_ms", "device_ms_warm", "host_us")},
                     **{f"s2_{k}": r2[k] for k in ("bound_ms", "baseline_ms", "device_ms",
                                                   "device_ms_warm", "host_us")}}
    return out


# ---- phase 3: TPC-H Q1/Q6 at SF1 -------------------------------------------


def gen_lineitem(seed: int):
    """lineitem's Q1/Q6 columns and its order key, and orders' key, at SF1
    by the TPC-H rules (spec §4.2.3), as benchmarks/tpch_dbgen.py applies
    them: sparse order keys (8 of every 32), 1-7 lines per order, quantity
    1-50, discount 0.00-0.10, tax 0.00-0.08, extendedprice = quantity x
    p_retailprice, ship date 1-121 days after the order date, receipt date
    1-30 days after shipping, returnflag R/A if received by CURRENTDATE else
    N, linestatus O if shipped after CURRENTDATE else F."""
    from sqlrs_tpu_torch.types.values import date_str_to_days

    rng = np.random.default_rng(seed)
    O, P = SF1_ORDERS, SF1_PARTS
    oi = np.arange(O, dtype=np.int64)
    o_key = (oi >> 3) * 32 + (oi & 7) + 1  # sparse: 8 of every 32 keys
    o_date = rng.integers(
        date_str_to_days("1992-01-01"), date_str_to_days("1998-08-02") + 1, O
    )
    per_order = rng.integers(1, 8, O)
    L = int(per_order.sum())
    l_odate = np.repeat(o_date, per_order)
    pk = rng.integers(1, P + 1, L)
    p_retail = (90000 + ((pk // 10) % 20001) + 100 * (pk % 1000)) / 100.0
    qty = rng.integers(1, 51, L)
    price = np.round(qty * p_retail, 2)
    disc = rng.integers(0, 11, L) / 100.0
    tax = rng.integers(0, 9, L) / 100.0
    ship = l_odate + rng.integers(1, 122, L)
    receipt = ship + rng.integers(1, 31, L)
    cur = date_str_to_days(CURRENTDATE)
    rflag = np.where(receipt <= cur, np.where(rng.random(L) < 0.5, "R", "A"), "N")
    lstatus = np.where(ship > cur, "O", "F")
    lineitem = {
        "l_orderkey": np.repeat(o_key, per_order),
        "l_quantity": qty.astype(np.int64),
        "l_extendedprice": price,
        "l_discount": disc,
        "l_tax": tax,
        "l_returnflag": rflag,
        "l_linestatus": lstatus,
        "l_shipdate": ship.astype(np.int32),
    }
    return lineitem, {"o_orderkey": o_key}


def oracle_q1(li):
    from sqlrs_tpu_torch.types.values import date_str_to_days

    m = li["l_shipdate"] <= date_str_to_days("1998-09-02")
    rows = []
    for rf in sorted(set(li["l_returnflag"][m].tolist())):
        for ls in sorted(set(li["l_linestatus"][m].tolist())):
            g = m & (li["l_returnflag"] == rf) & (li["l_linestatus"] == ls)
            cnt = int(g.sum())
            if cnt == 0:
                continue
            q = li["l_quantity"][g]
            p = li["l_extendedprice"][g]
            d = li["l_discount"][g]
            t = li["l_tax"][g]
            rows.append((
                rf, ls, int(q.sum()), float(p.sum()),
                float((p * (1 - d)).sum()), float((p * (1 - d) * (1 + t)).sum()),
                float(q.sum() / cnt), float(p.sum() / cnt), float(d.sum() / cnt),
                cnt,
            ))
    return rows


def oracle_q6(li):
    from sqlrs_tpu_torch.types.values import date_str_to_days

    s = li["l_shipdate"]
    d = li["l_discount"]
    m = (
        (s >= date_str_to_days("1994-01-01"))
        & (s < date_str_to_days("1995-01-01"))
        & (d >= 0.05) & (d <= 0.07)
        & (li["l_quantity"] < 24)
    )
    return [(float((li["l_extendedprice"][m] * d[m]).sum()),)]


def check_rows(got, exp, exact_cols, name: str) -> None:
    if len(got) != len(exp):
        raise AssertionError(f"{name}: {len(got)} rows, expected {len(exp)}")
    for i, (g, e) in enumerate(zip(got, exp)):
        if len(g) != len(e):
            raise AssertionError(f"{name} row {i}: width {len(g)} != {len(e)}")
        for j, (gv, ev) in enumerate(zip(g, e)):
            if isinstance(ev, float) and j not in exact_cols:
                ok = gv is not None and abs(gv - ev) <= 1e-9 * max(abs(ev), 1e-300)
            else:
                ok = gv == ev
            if not ok:
                raise AssertionError(f"{name} row {i} col {j}: {gv!r} != {ev!r}")


def timed_query(db, sql: str):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = db.run(sql)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    rows = [tuple(r) for b in batches for r in b.to_pylist()]
    return rows, ms


def phase_tpch(dev, card: str, li: dict, orders: dict, gen_s: float):
    """Returns (grouped_histogram launches in the Q1/Q6 runs, the database,
    which also holds orders for the star phase's rollup)."""
    import sqlrs_tpu_torch
    from sqlrs_tpu_torch.ops.mxu_grouped import grouped_histogram
    from sqlrs_tpu_torch.types import LogicalType as LT

    t0 = time.perf_counter()
    n = len(li["l_quantity"])
    types = {
        "l_orderkey": LT.BIGINT,
        "l_quantity": LT.BIGINT, "l_extendedprice": LT.DOUBLE,
        "l_discount": LT.DOUBLE, "l_tax": LT.DOUBLE,
        "l_returnflag": LT.VARCHAR, "l_linestatus": LT.VARCHAR,
        "l_shipdate": LT.DATE,
    }
    db = sqlrs_tpu_torch.Database(device=dev)
    db.create_memory_table_numpy(
        "lineitem", [(c, types[c]) for c in li], [li[c] for c in li]
    )
    db.create_memory_table_numpy("orders", [("o_orderkey", LT.BIGINT)], [orders["o_orderkey"]])
    load_s = time.perf_counter() - t0
    exp1, exp6 = oracle_q1(li), oracle_q6(li)

    # the main path: counts from here on are the path's own launches
    grouped_histogram.launches = 0
    db.last_fused_routes = []
    times: dict[str, list[float]] = {"q1": [], "q6": []}
    for _ in range(4):  # one cold run, then three warm runs
        rows1, ms1 = timed_query(db, Q1)
        rows6, ms6 = timed_query(db, Q6)
        times["q1"].append(ms1)
        times["q6"].append(ms6)
        check_rows(rows1, exp1, exact_cols={2, 9}, name="Q1")
        check_rows(rows6, exp6, exact_cols=set(), name="Q6")
    launches = grouped_histogram.launches
    if "hashagg_mxu" not in db.last_fused_routes:
        raise AssertionError(f"Q1 did not take hashagg_mxu: {db.last_fused_routes}")
    if launches < 4:
        raise AssertionError(f"grouped_histogram launched {launches} times in 4 Q1 runs")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(
        f"phase tpch_sf1: lineitem {n} rows (made in {gen_s:.1f} s, loaded in "
        f"{load_s:.1f} s); "
        f"Q1 cold {times['q1'][0]:.1f} ms, warm "
        f"{', '.join(f'{t:.1f}' for t in times['q1'][1:])} ms; "
        f"Q6 cold {times['q6'][0]:.1f} ms, warm "
        f"{', '.join(f'{t:.1f}' for t in times['q6'][1:])} ms; "
        f"{len(exp1)} Q1 groups match the numpy oracle; kernel launches {launches}; "
        f"peak device memory {peak_gb:.2f} GB [{card}]",
        flush=True,
    )
    return launches, db


# ---- phase 4: the star rollup ---------------------------------------------


def gen_star(seed: int = 0) -> dict:
    """bench.py's fact table: gid = min(zipf(1.2), 2^16) - 1 and v uniform
    in [0, 100), numpy seed 0 as bench.py draws them."""
    rng = np.random.default_rng(seed)
    gid = np.minimum(rng.zipf(1.2, STAR_ROWS), STAR_GROUPS).astype(np.int64) - 1
    v = rng.integers(0, 100, STAR_ROWS).astype(np.int64)
    return {"gid": gid, "v": v}


def batch_arrays(batches):
    """(data, valid) numpy arrays per column of a one-batch result."""
    (b,) = batches
    return [(c.data.cpu().numpy(), c.valid.cpu().numpy()) for c in b.columns]


def check_columns(got, exp, name: str) -> None:
    """Every column valid and equal to the oracle, bit for bit."""
    if len(got) != len(exp):
        raise AssertionError(f"{name}: {len(got)} columns, expected {len(exp)}")
    for j, ((data, valid), e) in enumerate(zip(got, exp)):
        if data.shape != e.shape or data.dtype != e.dtype or not valid.all():
            raise AssertionError(
                f"{name} col {j}: {data.dtype}{data.shape} (all valid: {valid.all()}), "
                f"expected {e.dtype}{e.shape}"
            )
        if not np.array_equal(data.view(np.int64), e.view(np.int64)):
            bad = int(np.flatnonzero(data != e)[0])
            raise AssertionError(f"{name} col {j} row {bad}: {data[bad]!r} != {e[bad]!r}")


def run_query(db, sql: str, route: str, exp, name: str, runs: list) -> None:
    """One run: time db.run to a synchronised device, then check the route
    and every value against the oracle."""
    db.last_fused_routes = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = db.run(sql)
    torch.cuda.synchronize()
    runs.append((time.perf_counter() - t0) * 1e3)
    if db.last_fused_routes != [route]:
        raise AssertionError(f"{name} logged {db.last_fused_routes}, expected [{route!r}]")
    check_columns(batch_arrays(batches), exp, name)


def phase_star(dev, card: str, star: dict, tpch_db, li: dict, orders: dict) -> dict:
    """Returns each kernel's launches in the star queries' runs."""
    import sqlrs_tpu_torch
    from sqlrs_tpu_torch.ops import pallas_kernels
    from sqlrs_tpu_torch.ops.mxu_agg import dense_group_sums
    from sqlrs_tpu_torch.types import LogicalType as LT

    gid, v = star["gid"], star["v"]
    dense_keys = np.arange(STAR_GROUPS, dtype=np.int64)
    spread_keys = dense_keys * 1013904223 + 12345
    sums = np.bincount(gid, weights=v, minlength=STAR_GROUPS).astype(np.int64)
    counts = np.bincount(gid, minlength=STAR_GROUPS).astype(np.int64)
    live = counts > 0
    exp_dense = [dense_keys[live], sums[live], counts[live]]
    exp_spread = [spread_keys[live], sums[live], counts[live]]

    t0 = time.perf_counter()
    db = sqlrs_tpu_torch.Database(device=dev)
    db.create_memory_table_numpy("f", [("k", LT.BIGINT), ("v", LT.BIGINT)], [dense_keys[gid], v])
    db.create_memory_table_numpy("d", [("k", LT.BIGINT)], [dense_keys])
    db.create_memory_table_numpy("fs", [("k", LT.BIGINT), ("v", LT.BIGINT)], [spread_keys[gid], v])
    db.create_memory_table_numpy("ds", [("k", LT.BIGINT)], [spread_keys])
    load_s = time.perf_counter() - t0

    # the rollup's oracle: integer cents, price_cents * (100 - disc_cents)
    # per line, summed per order (lines of one order are adjacent), / 10^4
    cents = np.round(li["l_extendedprice"] * 100).astype(np.int64) * (
        100 - np.round(li["l_discount"] * 100).astype(np.int64))
    starts = np.flatnonzero(np.r_[True, li["l_orderkey"][1:] != li["l_orderkey"][:-1]])
    exact = np.add.reduceat(cents, starts)
    if len(exact) != len(orders["o_orderkey"]):
        raise AssertionError("an order without lines")
    exp_rollup = [orders["o_orderkey"], exact.astype(np.float64) / 1e4]

    # the main path: counts from here on are the path's own launches
    torch.cuda.reset_peak_memory_stats(dev)
    dense_group_sums.launches = 0
    pallas_kernels.row_rank_ge.launches = 0
    pallas_kernels.masked_row_sum.launches = 0
    times: dict[str, list[float]] = {}
    for name, (sql, route) in STAR_SQL.items():
        exp = exp_spread if name.startswith("spread") else exp_dense
        for i in range(4):  # one cold run, then three warm runs
            before = dense_group_sums.launches
            run_query(db, sql, route, exp, name, times.setdefault(name, []))
            if name == "dense_order" and dense_group_sums.launches != before + 1:
                raise AssertionError(f"run {i} of {name} did not launch dense_group_sums once")
    for _ in range(4):
        run_query(tpch_db, ROLLUP_SQL, "order_agg_join_direct", exp_rollup,
                  "tpch_rollup", times.setdefault("tpch_rollup", []))
    launches = {
        "dense_group_sums": dense_group_sums.launches,
        "row_rank_ge": pallas_kernels.row_rank_ge.launches,
        "masked_row_sum": pallas_kernels.masked_row_sum.launches,
    }
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(
        f"phase star_rollup: fact {STAR_ROWS} rows x dim {STAR_GROUPS} keys "
        f"({int(live.sum())} groups hit; loaded in {load_s:.1f} s), lineitem "
        f"{len(li['l_orderkey'])} x orders {len(orders['o_orderkey'])} rows",
        flush=True,
    )
    for name, ts in times.items():
        route = STAR_SQL[name][1] if name in STAR_SQL else "order_agg_join_direct"
        print(
            f"  {name}: route {route}; cold {ts[0]:.1f} ms, warm "
            f"{', '.join(f'{t:.1f}' for t in ts[1:])} ms; rows match the numpy "
            f"oracle exactly",
            flush=True,
        )
    print(
        f"  launches: dense_group_sums {launches['dense_group_sums']} (4 dense "
        f"ORDER BY runs); row_rank_ge {launches['row_rank_ge']}, masked_row_sum "
        f"{launches['masked_row_sum']} (no production path calls them, as in "
        f"the reference); peak device memory {peak_gb:.2f} GB [{card}]",
        flush=True,
    )
    return launches, db


# ---- phase 5: a profile of the dense ORDER BY rollup ----------------------

_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


# the port's functions whose share of a TPC-H run the profile reports: each
# is wrapped in a torch.profiler.record_function range, here only and only
# while the profiler runs (every caller looks the name up at call time)
PROFILED_FUNCTIONS = (
    "ops.sort._lex_argsort", "ops.grouped_agg._lex_argsort", "ops.join._lex_argsort",
    "ops.grouped_agg._agg_phase1", "ops.grouped_agg._agg_phase2",
    "ops.pipelines._sorted_ranks_left", "ops.join._pairs_phase_a", "ops.join._expand_body",
    "ops.mxu_grouped.mxu_grouped_aggregate", "exec.fused_route.try_agg_join_route",
    "exec.fused_route.try_order_agg_join_route", "ops.elementwise.like_match",
    "ops.elementwise.substring_column",
)


def _annotated(names):
    """Wrap each `module.attr` of sqlrs_tpu_torch in a record_function
    range; returns the undo list."""
    import importlib

    undo = []
    for path in names:
        mod_name, attr = path.rsplit(".", 1)
        mod = importlib.import_module(f"sqlrs_tpu_torch.{mod_name}")
        fn = getattr(mod, attr)

        def wrapped(*a, _fn=fn, _name=path, **k):
            with torch.profiler.record_function(_name):
                return _fn(*a, **k)

        setattr(mod, attr, wrapped)
        undo.append((mod, attr, fn))
    return undo


def phase_profile(card: str, label: str, run, runs: int = 5, functions=(),
                  warmups: int = 2, timed: int = 5) -> None:
    """run(): one warm run of a query. `warmups` runs, the median of `timed`
    unprofiled warm runs, then torch.profiler over `runs` more: device time
    by kernel, kernel launches, stream syncs and host-to-device copies per
    run, and the busy share (device kernel time over the profiled wall
    time); with `functions`, also each named port function's share."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmups):
        run()
    warm = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    undo = _annotated(functions)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(runs):
                run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, attr, fn in undo:
            setattr(mod, attr, fn)
    events = prof.key_averages()

    def device_us(e) -> float:
        return float(getattr(e, "self_device_time_total", 0) or
                     getattr(e, "self_cuda_time_total", 0) or 0)

    def device_us_incl(e) -> float:
        return float(getattr(e, "device_time_total", 0) or
                     getattr(e, "cuda_time_total", 0) or 0)

    # a record_function range shows twice: on the host (the kernels launched
    # inside it) and on the device (its span there), which is not a kernel
    kernels = sorted(((e.key, device_us(e), e.count) for e in events
                      if str(e.device_type).endswith("CUDA") and device_us(e) > 0
                      and e.key not in functions),
                     key=lambda k: -k[1])
    calls = {e.key: e.count for e in events}
    device_ms = sum(us for _, us, _ in kernels) / 1e3 / runs
    if device_ms == 0:
        raise AssertionError("torch.profiler traced no device time")
    print(
        f"phase profile: {label} warm {float(np.median(warm)):.3f} ms "
        f"(median of {timed} unprofiled: {', '.join(f'{t:.3f}' for t in warm)}); profiled "
        f"over {runs} runs: device {device_ms:.3f} ms per run, busy share "
        f"{device_ms * runs / wall_ms:.3f}, kernel launches "
        f"{sum(calls.get(c, 0) for c in _LAUNCH_CALLS) / runs:.1f}, stream syncs "
        f"{sum(calls.get(c, 0) for c in _SYNC_CALLS) / runs:.1f}, cudaMemcpyAsync "
        f"{calls.get('cudaMemcpyAsync', 0) / runs:.1f} per run [{card}]",
        flush=True,
    )
    for name, us, count in kernels[:12]:
        print(f"  {us / 1e3 / runs:8.3f} ms  x{count / runs:6.1f}  {name[:110]}", flush=True)
    ops = sorted(((e.key, device_us_incl(e), e.count) for e in events
                  if e.key.startswith("aten::") and device_us_incl(e) > 0),
                 key=lambda k: -k[1])
    print("  by aten op (device time of the kernels each launches, nested ops "
          "counted in each):", flush=True)
    for name, us, count in ops[:10]:
        print(f"  {us / 1e3 / runs:8.3f} ms  x{count / runs:6.1f}  {name}", flush=True)
    if functions:
        print("  by port function (device time of the kernels launched inside, "
              "nested calls counted in each; host ms inclusive):", flush=True)
        for e in sorted((e for e in events if e.key in functions
                         and not str(e.device_type).endswith("CUDA")),
                        key=lambda e: -device_us_incl(e)):
            print(f"  {device_us_incl(e) / 1e3 / runs:8.3f} ms  x{e.count / runs:6.1f}  "
                  f"{e.key} (host {e.cpu_time_total / 1e3 / runs:.3f} ms)", flush=True)
    host = sorted(((e.key, float(e.self_cpu_time_total), e.count) for e in events
                   if e.self_cpu_time_total > 0), key=lambda k: -k[1])
    print(f"  host: {sum(us for _, us, _ in host) / 1e3 / runs:.3f} ms per run in traced "
          f"host ops (the rest of the wall time is Python); the largest:", flush=True)
    for name, us, count in host[:8]:
        print(f"  {us / 1e3 / runs:8.3f} ms  x{count / runs:6.1f}  {name[:110]}", flush=True)


# ---- phase 6: the 22 TPC-H queries at SF1 ----------------------------------

TPCH22_SF = 1.0
TPCH22_SEED = SEED
TPCH22_ROUTES = {1: "hashagg_mxu", 3: "agg_join_firstapp", 18: "agg_join_firstapp"}


def tpch_statements(qn: int) -> list[str]:
    """The statements of query qn (Q15 is its view, the query and the drop)."""
    from sqlrs_tpu_torch.benchmarks import tpch_queries

    q = tpch_queries.ALL[qn]
    return q if isinstance(q, list) else [q]


def tpch_run(db, qn: int):
    """(rows, ms): the rows of the last statement that returns a schema, as
    benchmarks/tpch.py's run_query takes them, and the milliseconds of
    db.run over the statements to a synchronised device (the rows are read
    back to the host after the clock stops)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [db.run(stmt) for stmt in tpch_statements(qn)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for batches in outs:
        out = [tuple(r) for b in batches for r in b.to_pylist()]
        if out or (batches and batches[0].columns):
            rows = out
    return rows, ms


def tpch_compare(got, exp, name: str) -> None:
    """benchmarks/tpch.py's compare rule: floats to rel 1e-9 or abs 1e-6,
    everything else exactly; raises on the first difference."""
    import math

    if len(got) != len(exp):
        raise AssertionError(f"{name}: {len(got)} rows, expected {len(exp)}")
    for i, (g, e) in enumerate(zip(got, exp)):
        if len(g) != len(e):
            raise AssertionError(f"{name} row {i}: width {len(g)} != {len(e)}")
        for j, (gv, ev) in enumerate(zip(g, e)):
            if isinstance(ev, float) or isinstance(gv, float):
                ok = (gv is None and ev is None) or (
                    gv is not None and ev is not None
                    and math.isclose(float(gv), float(ev), rel_tol=1e-9, abs_tol=1e-6))
            else:
                ok = gv == ev
            if not ok:
                raise AssertionError(f"{name} row {i} col {j}: {gv!r} != {ev!r}")


def unread_columns(tables) -> list[str]:
    """The generated columns that no query text names."""
    import re

    from sqlrs_tpu_torch.benchmarks import tpch_queries

    words = set()
    for q in tpch_queries.ALL.values():
        for stmt in q if isinstance(q, list) else [q]:
            words |= set(re.findall(r"[a-z_]+", stmt))
    return [c for cols in tables.values() for c in cols if c not in words]


def oracle_tpch_q3(t):
    """Q3 in numpy: BUILDING customers' orders before 1995-03-15, their
    lines shipped after it, revenue per order, top 10 by revenue desc then
    order date."""
    from sqlrs_tpu_torch.types.values import date_str_to_days

    c, o, li = t["customer"], t["orders"], t["lineitem"]
    day = date_str_to_days("1995-03-15")
    cust = c["c_custkey"][c["c_mktsegment"] == "BUILDING"]
    okeys = o["o_orderkey"][np.isin(o["o_custkey"], cust) & (o["o_orderdate"] < day)]
    m = (li["l_shipdate"] > day) & np.isin(li["l_orderkey"], okeys)
    keys, inv = np.unique(li["l_orderkey"][m], return_inverse=True)
    rev = np.bincount(inv, weights=(li["l_extendedprice"] * (1 - li["l_discount"]))[m])
    pos = np.searchsorted(o["o_orderkey"], keys)
    dates, prio = o["o_orderdate"][pos], o["o_shippriority"][pos]
    top = np.lexsort((dates, -rev))[:10]
    return [(int(keys[i]), float(rev[i]), int(dates[i]), int(prio[i])) for i in top]


def oracle_tpch_q4(t):
    """Q4 in numpy: orders of 1993 Q3 with a line committed before its
    receipt, counted per priority."""
    from sqlrs_tpu_torch.types.values import date_str_to_days

    o, li = t["orders"], t["lineitem"]
    m = ((o["o_orderdate"] >= date_str_to_days("1993-07-01"))
         & (o["o_orderdate"] < date_str_to_days("1993-10-01")))
    late = np.unique(li["l_orderkey"][li["l_commitdate"] < li["l_receiptdate"]])
    prios, counts = np.unique(o["o_orderpriority"][m & np.isin(o["o_orderkey"], late)],
                              return_counts=True)
    return [(str(p), int(n)) for p, n in zip(prios, counts)]


def oracle_tpch_q18(t):
    """Q18 in numpy: orders whose lines sum to more than 300 units, with
    their customer, top 100 by total price desc then order date."""
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    keys, inv = np.unique(li["l_orderkey"], return_inverse=True)
    qty = np.bincount(inv, weights=li["l_quantity"]).astype(np.int64)
    big, bq = keys[qty > 300], qty[qty > 300]
    pos = np.searchsorted(o["o_orderkey"], big)
    cust = o["o_custkey"][pos]
    cpos = np.searchsorted(c["c_custkey"], cust)
    price, dates = o["o_totalprice"][pos], o["o_orderdate"][pos]
    top = np.lexsort((dates, -price))[:100]
    return [(str(c["c_name"][cpos[i]]), int(cust[i]), int(big[i]), int(dates[i]),
             float(price[i]), int(bq[i])) for i in top]


class timed_interning:
    """Sums the seconds the global dictionary's intern_many takes while the
    block runs: `with timed_interning() as secs:` ... `secs[0]`."""

    def __enter__(self):
        from sqlrs_tpu_torch.data.strings import GLOBAL_STRINGS

        self.secs = [0.0]
        inner = GLOBAL_STRINGS.intern_many

        def intern_many(strings):
            t0 = time.perf_counter()
            try:
                return inner(strings)
            finally:
                self.secs[0] += time.perf_counter() - t0

        GLOBAL_STRINGS.intern_many = intern_many
        return self.secs

    def __exit__(self, *exc):
        from sqlrs_tpu_torch.data.strings import GLOBAL_STRINGS

        del GLOBAL_STRINGS.intern_many  # the class's method again
        return False


def intern_report(tables: dict, load_s: float, intern_s: float, card: str) -> None:
    """Phase 6's string interning: the load went through the native interner
    (the global dictionary must have bound it), timed against the Python
    path on the same string columns, through a fresh unbound
    StringDictionary() in this process."""
    from sqlrs_tpu_torch.data.strings import GLOBAL_STRINGS, StringDictionary

    if not GLOBAL_STRINGS.native_bound:
        raise AssertionError("phase tpch22: the native string interner did not bind "
                             "(GLOBAL_STRINGS is on the Python path)")
    cols = [a for t in tables.values() for a in t.values() if a.dtype.kind == "U"]
    cells = sum(len(a) for a in cols)
    py = StringDictionary()
    t0 = time.perf_counter()
    py_codes = [py.intern_many(a) for a in cols]
    py_s = time.perf_counter() - t0
    # the same strings, whichever path interned them
    for a, codes in zip(cols[:3], py_codes[:3]):
        back = [py.lookup(int(c)) for c in codes[:1000]]
        if back != a[:1000].tolist():
            raise AssertionError("the Python-path dictionary decodes other strings")
    lib = os.path.basename(GLOBAL_STRINGS._native._name)
    print(f"  intern: native ({lib}); the SF1 tables loaded in {load_s:.2f} s, of it "
          f"{intern_s:.2f} s interning {cells} string cells of {len(cols)} columns "
          f"({len(py)} distinct); the same columns through the Python path (a fresh "
          f"StringDictionary()): {py_s:.2f} s [{card}]", flush=True)


def phase_tpch22(dev, card: str) -> dict:
    """All 22 TPC-H queries at SF1 through Database(device="cuda").run: one
    cold and three warm runs each, timed to a synchronised device, then the
    same queries through Database(device="cpu") on the same tables (with
    SQLRS_TPU_MXU=interpret, so that the CPU run takes the same routes with
    the kernels' plain versions): rows by benchmarks/tpch.py's rule and
    route logs must be equal. Q3, Q4 and Q18 are also held to numpy
    oracles. Returns each kernel's launches in the cuda runs, the cuda
    database, and the query with the longest median warm time."""
    import os

    import sqlrs_tpu_torch
    from sqlrs_tpu_torch.benchmarks import tpch_dbgen
    from sqlrs_tpu_torch.ops import pallas_kernels
    from sqlrs_tpu_torch.ops.mxu_agg import dense_group_sums
    from sqlrs_tpu_torch.ops.mxu_grouped import grouped_histogram

    t0 = time.perf_counter()
    tables = tpch_dbgen.gen_tables(TPCH22_SF, seed=TPCH22_SEED)
    gen_s = time.perf_counter() - t0
    skip = unread_columns(tables)
    for cols in tables.values():
        for cn in skip:
            cols.pop(cn, None)
    t0 = time.perf_counter()
    db = sqlrs_tpu_torch.Database(device=dev)
    with timed_interning() as intern_s:
        tpch_dbgen.load_into(db, tables)
    load_s = time.perf_counter() - t0
    intern_report(tables, load_s, intern_s[0], card)
    # the tables' device copies are made at their first scan: make them
    # now, so that a cold run finds its tables on the card
    t0 = time.perf_counter()
    for name in tables:
        db.catalog.table(name).storage.scan(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    sizes = ", ".join(f"{n} {len(next(iter(c.values())))}" for n, c in tables.items())
    print(f"phase tpch22: SF {TPCH22_SF}, seed {TPCH22_SEED}: {sizes} rows (made in "
          f"{gen_s:.1f} s, loaded in {load_s:.1f} s, copied to the card in "
          f"{upload_s:.1f} s); columns no query reads, left out: {', '.join(skip)}",
          flush=True)
    oracles = {3: oracle_tpch_q3, 4: oracle_tpch_q4, 18: oracle_tpch_q18}

    # the main path: counts from here on are the path's own launches
    grouped_histogram.launches = 0
    dense_group_sums.launches = 0
    pallas_kernels.row_rank_ge.launches = 0
    pallas_kernels.masked_row_sum.launches = 0
    results = {}
    for qn in range(1, 23):
        torch.cuda.reset_peak_memory_stats(dev)
        h0, d0 = grouped_histogram.launches, dense_group_sums.launches
        times, rows = [], None
        for _ in range(4):  # one cold run, then three warm runs
            db.last_fused_routes = []
            got, ms = tpch_run(db, qn)
            times.append(ms)
            if rows is not None and got != rows:
                raise AssertionError(f"Q{qn}: a warm run gave other rows than the cold run")
            rows = got
        routes = list(db.last_fused_routes)
        want = TPCH22_ROUTES.get(qn)
        if want is not None and want not in routes:
            raise AssertionError(f"Q{qn} logged {routes}, expected {want!r} among them")
        if qn in oracles:
            tpch_compare(rows, oracles[qn](tables), f"Q{qn} (numpy oracle)")
        results[qn] = {
            "rows": rows, "routes": routes, "ms": times,
            "hist": grouped_histogram.launches - h0, "dense": dense_group_sums.launches - d0,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        }
    launches = {"grouped_histogram": grouped_histogram.launches,
                "dense_group_sums": dense_group_sums.launches,
                "row_rank_ge": pallas_kernels.row_rank_ge.launches,
                "masked_row_sum": pallas_kernels.masked_row_sum.launches}
    if results[1]["hist"] < 4:
        raise AssertionError(f"Q1 launched grouped_histogram {results[1]['hist']} times in 4 runs")

    # the comparison leg: the same tables and queries on the CPU
    t0 = time.perf_counter()
    saved = os.environ.get("SQLRS_TPU_MXU")
    os.environ["SQLRS_TPU_MXU"] = "interpret"
    try:
        cpu_db = sqlrs_tpu_torch.Database(device="cpu")
        tpch_dbgen.load_into(cpu_db, tables)
        # with the profile on: phase 9 holds the card's operator lists to these
        cpu_db.profile_enabled = True
        cpu_ops = {}
        for qn in range(1, 23):
            cpu_db.last_fused_routes = []
            cpu_rows, _ms, profs, _n = tpch_run_profiled(cpu_db, qn)
            cpu_ops[qn] = op_lists(profs)
            tpch_compare(results[qn]["rows"], cpu_rows, f"Q{qn} (cuda vs cpu)")
            if cpu_db.last_fused_routes != results[qn]["routes"]:
                raise AssertionError(f"Q{qn}: routes {results[qn]['routes']} on cuda, "
                                     f"{cpu_db.last_fused_routes} on the cpu")
    finally:
        if saved is None:
            os.environ.pop("SQLRS_TPU_MXU")
        else:
            os.environ["SQLRS_TPU_MXU"] = saved
    cpu_s = time.perf_counter() - t0
    for qn, r in results.items():
        ms = r["ms"]
        print(
            f"  Q{qn}: cold {ms[0]:.1f} ms, warm {', '.join(f'{t:.1f}' for t in ms[1:])} ms; "
            f"{len(r['rows'])} rows; routes {r['routes']}; grouped_histogram {r['hist']}, "
            f"dense_group_sums {r['dense']}; peak device memory {r['peak_gb']:.2f} GB",
            flush=True,
        )
    total_warm = sum(float(np.median(r["ms"][1:])) for r in results.values())
    print(
        f"  all 22 match the cpu run (device=cpu, {cpu_s:.1f} s with its load) by "
        f"benchmarks/tpch.py's rule, with equal routes; Q3, Q4, Q18 match numpy oracles; "
        f"sum of warm medians {total_warm:.1f} ms; launches grouped_histogram "
        f"{launches['grouped_histogram']}, dense_group_sums {launches['dense_group_sums']} [{card}]",
        flush=True,
    )
    slowest = max(results, key=lambda q: float(np.median(results[q]["ms"][1:])))
    return launches, db, slowest, tables, results, cpu_ops


# ---- phase 8: the sharded engine, 4 shards on one card --------------------

DIST_SHARDS = 4
# the sharded engine's functions the profile reports besides phase 7's: the
# collectives, the rank stage's callers and the per-shard operators
DIST_FUNCTIONS = PROFILED_FUNCTIONS + (
    "parallel.collectives.all_to_all", "parallel.collectives.psum",
    "parallel.collectives.psum_scatter", "parallel.collectives.all_gather",
    "parallel.collectives.ppermute", "parallel.collectives.reduce_sum",
    "parallel.collectives.reduce_max", "parallel.collectives.gather",
    "ops.grouped_agg.partial_grouped_fixed", "parallel.dist_join.broadcast_agg_join",
    "parallel.dist_join.ring_agg_join", "parallel.dist_join.shuffle_join_phase_a",
    "parallel.dist_join.shuffle_join_phase_b", "parallel.dist_ops.dist_sort_rows",
)


def _kernel_counts() -> dict:
    from sqlrs_tpu_torch.ops import pallas_kernels
    from sqlrs_tpu_torch.ops.mxu_agg import dense_group_sums
    from sqlrs_tpu_torch.ops.mxu_grouped import grouped_histogram

    return {"grouped_histogram": grouped_histogram.launches,
            "dense_group_sums": dense_group_sums.launches,
            "row_rank_ge": pallas_kernels.row_rank_ge.launches,
            "masked_row_sum": pallas_kernels.masked_row_sum.launches}


def _zero_kernel_counts() -> None:
    from sqlrs_tpu_torch.ops import pallas_kernels
    from sqlrs_tpu_torch.ops.mxu_agg import dense_group_sums
    from sqlrs_tpu_torch.ops.mxu_grouped import grouped_histogram

    for fn in (grouped_histogram, dense_group_sums, pallas_kernels.row_rank_ge,
               pallas_kernels.masked_row_sum):
        fn.launches = 0


def phase_dist_star(dev, card: str, star: dict, mesh) -> None:
    """bench.py's star (2^25 fact rows, 2^16 dense dim keys) through the
    four join + GROUP BY strategies of parallel/dist_ops.py over the mesh:
    each one cold and two warm runs, its (sums, counts) equal to numpy's
    exactly."""
    from sqlrs_tpu_torch.parallel import dist_ops

    gid, v = star["gid"], star["v"]
    keys = np.arange(STAR_GROUPS, dtype=np.int64)
    exp_s = np.bincount(gid, weights=v, minlength=STAR_GROUPS).astype(np.int64)
    exp_c = np.bincount(gid, minlength=STAR_GROUPS).astype(np.int64)
    fk = torch.from_numpy(keys[gid]).to(dev)
    fv = torch.from_numpy(v).to(dev)
    dk = torch.from_numpy(keys).to(dev)
    g = STAR_GROUPS
    # a (sender, receiver) bucket's even share, doubled; the checked
    # strategies grow it by 4 until nothing overflows
    cap0 = 2 * STAR_ROWS // (mesh.size * mesh.size)
    strategies = {
        "broadcast": lambda: dist_ops.dist_join_groupby_broadcast(mesh, fk, fv, dk, g),
        "shuffle_checked": lambda: dist_ops.dist_join_groupby_shuffle_checked(
            mesh, fk, fv, dk, g, bucket_capacity=cap0),
        "salted_checked": lambda: dist_ops.dist_join_groupby_salted_checked(
            mesh, fk, fv, dk, g, bucket_capacity=cap0, hot_capacity=1024),
        "ring": lambda: dist_ops.dist_join_groupby_ring(mesh, fk, fv, dk, g),
    }
    print(f"phase dist_star: fact {STAR_ROWS} rows x dim {STAR_GROUPS} keys over "
          f"{mesh.size} shards ({mesh}); starting bucket capacity {cap0}", flush=True)
    for name, fn in strategies.items():
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for _ in range(3):  # one cold run, then two warm runs
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sums, cnts = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if not (np.array_equal(sums.cpu().numpy(), exp_s)
                    and np.array_equal(cnts.cpu().numpy(), exp_c)):
                raise AssertionError(f"dist_join_groupby_{name} != numpy")
        print(f"  {name}: cold {times[0]:.1f} ms, warm {times[1]:.1f}, {times[2]:.1f} ms; "
              f"sums and counts equal numpy's exactly; peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB [{card}]", flush=True)


def phase_dist_tpch(dev, card: str, mesh, tables, single: dict) -> dict:
    """All 22 TPC-H queries at SF1 through Database(mesh=mesh).run on the
    tables of phase 6: one cold and two warm runs each, every run's rows
    equal to phase 6's single-device rows by benchmarks/tpch.py's rule
    (floats rel 1e-9 or abs 1e-6, the rest exact). Then one profiled warm
    run of each query (syncs, launches, device time) and a profile of the
    whole sharded suite. Returns each kernel's launches in the timed runs,
    which are this path's, the database and each query's results (phase 10
    prints its times beside them)."""
    import sqlrs_tpu_torch
    from sqlrs_tpu_torch.benchmarks import tpch_dbgen

    t0 = time.perf_counter()
    db = sqlrs_tpu_torch.Database(mesh=mesh)
    tpch_dbgen.load_into(db, tables)
    for name in tables:
        db.catalog.table(name).storage.scan(dev)
    torch.cuda.synchronize()
    print(f"phase dist_tpch: SF {TPCH22_SF} over {mesh.size} shards that share one card "
          f"({mesh}); loaded in {time.perf_counter() - t0:.1f} s", flush=True)

    _zero_kernel_counts()  # the sharded path: counts from here on are its own
    results = {}
    for qn in range(1, 23):
        torch.cuda.reset_peak_memory_stats(dev)
        before = _kernel_counts()
        times = []
        for _ in range(3):  # one cold run, then two warm runs
            got, ms = tpch_run(db, qn)
            times.append(ms)
            tpch_compare(got, single[qn]["rows"], f"Q{qn} (sharded vs single device)")
        after = _kernel_counts()
        results[qn] = {
            "ms": times, "strategies": list(db.last_join_strategies),
            "launches": {k: after[k] - before[k] for k in after},
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        }
    launches = _kernel_counts()

    from torch.profiler import ProfilerActivity, profile

    for qn in range(1, 23):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tpch_run(db, qn)
        calls, dev_us = {}, 0.0
        for e in prof.key_averages():
            calls[e.key] = calls.get(e.key, 0) + e.count
            if str(e.device_type).endswith("CUDA"):
                dev_us += float(getattr(e, "self_device_time_total", 0)
                                or getattr(e, "self_cuda_time_total", 0) or 0)
        results[qn]["syncs"] = sum(calls.get(c, 0) for c in _SYNC_CALLS)
        results[qn]["kernel_launches"] = sum(calls.get(c, 0) for c in _LAUNCH_CALLS)
        results[qn]["device_ms"] = dev_us / 1e3

    for qn, r in results.items():
        ms, one = r["ms"], single[qn]["ms"]
        lc = ", ".join(f"{k} {n}" for k, n in r["launches"].items())
        print(
            f"  Q{qn}: warm {float(np.median(ms[1:])):.1f} ms sharded (cold {ms[0]:.1f}, warm "
            f"{', '.join(f'{t:.1f}' for t in ms[1:])}) vs {float(np.median(one[1:])):.1f} ms "
            f"on one device; strategies {r['strategies']}; launches {lc}; peak device "
            f"memory {r['peak_gb']:.2f} GB; profiled run: {r['syncs']} stream syncs, "
            f"{r['kernel_launches']} kernel launches, device {r['device_ms']:.1f} ms",
            flush=True,
        )
    dist_sum = sum(float(np.median(r["ms"][1:])) for r in results.values())
    one_sum = sum(float(np.median(single[q]["ms"][1:])) for q in results)
    print(
        f"  all 22 match the single-device rows in every run; sum of warm medians "
        f"{dist_sum:.1f} ms sharded vs {one_sum:.1f} ms on one device; launches "
        f"{', '.join(f'{k} {n}' for k, n in launches.items())}; peak device memory "
        f"{max(r['peak_gb'] for r in results.values()):.2f} GB at most [{card}]",
        flush=True,
    )
    phase_profile(card, f"all 22 TPC-H queries at SF {TPCH22_SF} over {mesh.size} shards "
                  "on one card, one after another",
                  lambda: [db.run(stmt) for qn in range(1, 23) for stmt in tpch_statements(qn)],
                  runs=1, functions=DIST_FUNCTIONS, warmups=0, timed=1)
    return launches, db, results


# ---- phase 9: the remaining modules on the card ---------------------------

UNSIGNED_ROWS = 1 << 24
UNSIGNED_JOIN_ROWS = 1 << 16
UNSIGNED_SEED = 0
UNSIGNED_SQL = {
    # kernel 1's path: sums of unsigned columns over 64 keys
    "grouped_kernel1": "select k, count(*), sum(a), sum(b), sum(c), sum(d), avg(c) "
                       "from u group by k order by k",
    # e spans [0, 2^64): kernel 1's value guard turns it down, the sorted
    # GROUP BY takes it
    "grouped_sorted": "select k, sum(e), min(e), max(e) from u group by k order by k",
    "order_asc": "select e, k from u where e is not null order by e limit 10",
    "order_desc": "select e, k from u where e is not null order by e desc limit 10",
    # wrapping + - * and unsigned / % at each width, folded to sums
    "arith_checksum": "select sum(a * a + a), sum(b * b - b), sum(c * c + c), "
                      "sum(e * e + e), sum(-c), sum(e - d), "
                      "sum(a / cast(7 as tinyint unsigned)), "
                      "sum(b % cast(1000 as smallint unsigned)), "
                      "sum(c / cast(12345 as int unsigned)), "
                      "sum(d % cast(65537 as bigint unsigned)), "
                      "sum(e / cast(1000003 as bigint unsigned)), "
                      "sum(e % cast(4294967311 as bigint unsigned)) from u",
    "join": "select count(*), sum(w), sum(k) from u join v on u.e = v.e2",
    "cast_double": "select sum(cast(e as double)), min(cast(e as double)), "
                   "max(cast(e as double)), sum(cast(c as double)) from u",
}
# the same GROUP BY on signed columns holding the same values, for the
# unsigned path's cost
SIGNED_SQL = ("select k, count(*), sum(a), sum(b), sum(c), sum(d), avg(c) "
              "from s group by k order by k")
CSV_SF = 0.1  # lineitem for the CSV loader: SF1 cut to 0.1 (the Python reader takes minutes at 6M rows)


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def gen_unsigned(n: int, seed: int = UNSIGNED_SEED) -> dict:
    """Table u: k INTEGER in [0, 64); a UTINYINT, b USMALLINT, c UINTEGER
    over their full ranges; d UBIGINT in [0, 2^36); e UBIGINT over [0,
    2^64); about 1% NULLs in every column. Table v: 2^16 rows of u's
    non-NULL e (distinct rows, numbered by w)."""
    rng = np.random.default_rng(seed)
    cols = {
        "k": ("INTEGER", rng.integers(0, 64, n).astype(np.int32)),
        "a": ("UTINYINT", rng.integers(0, 2**8, n, dtype=np.uint64).astype(np.uint8)),
        "b": ("USMALLINT", rng.integers(0, 2**16, n, dtype=np.uint64).astype(np.uint16)),
        "c": ("UINTEGER", rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)),
        "d": ("UBIGINT", rng.integers(0, 2**36, n, dtype=np.uint64)),
        "e": ("UBIGINT", rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)),
    }
    valid = {c: rng.random(n) >= 0.01 for c in cols}
    ev = np.flatnonzero(valid["e"])
    pick = rng.choice(ev, min(UNSIGNED_JOIN_ROWS, len(ev)), replace=False)
    v = {"e2": ("UBIGINT", cols["e"][1][pick]),
         "w": ("BIGINT", np.arange(len(pick), dtype=np.int64))}
    return {"u": (cols, valid), "v": (v, {})}


def load_unsigned(db, data: dict, signed: bool = False) -> None:
    """Tables u and v into db (import_tables: numpy uint* in); with
    `signed`, table s instead: u's k, a, b, c, d as SMALLINT, INTEGER,
    BIGINT, BIGINT (the same values and NULLs)."""
    from sqlrs_tpu_torch.storage.memory import import_tables

    if signed:
        cols, valid = data["u"]
        as_signed = {"k": "INTEGER", "a": "SMALLINT", "b": "INTEGER", "c": "BIGINT",
                     "d": "BIGINT"}
        import_tables(db, {"s": [
            (c, t, cols[c][1].astype(np.int64), valid[c]) for c, t in as_signed.items()
        ]})
        return
    import_tables(db, {
        name: [(c, t, a, valid.get(c)) for c, (t, a) in cols.items()]
        for name, (cols, valid) in data.items()
    })


def _usum(x) -> int:
    """The sum of uint64 values modulo 2^64, as the engine's UBIGINT sum."""
    return int(np.sum(x.astype(np.uint64), dtype=np.uint64))


def oracle_unsigned(data: dict) -> dict:
    """Each UNSIGNED_SQL query in numpy, with exact uint semantics: uint
    arithmetic wraps at its width, sums modulo 2^64; NULL rows left out."""
    cols, valid = data["u"]
    k, kv = cols["k"][1], valid["k"]
    a, b, c, d, e = (cols[x][1] for x in "abcde")
    va, vb, vc, vd, ve = (valid[x] for x in "abcde")
    out = {}
    with np.errstate(over="ignore"):
        # rows grouped by k (NULL first, as ORDER BY k puts it), each
        # group a slice of the rows sorted by k
        kk = np.where(kv, k.astype(np.int64), -1)
        perm = np.argsort(kk, kind="stable")
        keys, starts = np.unique(kk[perm], return_index=True)
        ends = np.append(starts[1:], len(perm))
        g1, g2 = [], []
        for key, lo, hi in zip(keys.tolist(), starts.tolist(), ends.tolist()):
            rows = perm[lo:hi]

            def vals(x, vx):
                return x[rows][vx[rows]]

            cs_ = vals(c, vc)
            g1.append((None if key < 0 else key, len(rows), _usum(vals(a, va)),
                       _usum(vals(b, vb)), _usum(cs_), _usum(vals(d, vd)),
                       float(int(cs_.astype(np.uint64).sum())) / len(cs_)))
            es = vals(e, ve)
            g2.append((None if key < 0 else key, _usum(es), int(es.min()), int(es.max())))
        out["grouped_kernel1"], out["grouped_sorted"] = g1, g2
        idx = np.flatnonzero(ve)

        def krow(i):
            return int(k[i]) if kv[i] else None

        def top10(key):
            # the rows whose key is among the 10 least (ties included), in
            # the stable order: by key, then by row
            cut = np.partition(key, 9)[9]
            cand = idx[key <= cut]
            return cand[np.lexsort((cand, key[key <= cut]))][:10]

        ee = e[idx]
        out["order_asc"] = [(int(e[i]), krow(i)) for i in top10(ee)]
        out["order_desc"] = [(int(e[i]), krow(i)) for i in top10(~ee)]
        ed = ve & vd
        out["arith_checksum"] = [(
            _usum((a * a + a)[va]), _usum((b * b - b)[vb]), _usum((c * c + c)[vc]),
            _usum((e * e + e)[ve]), _usum((-c)[vc]), _usum((e - d)[ed]),
            _usum((a // np.uint8(7))[va]), _usum((b % np.uint16(1000))[vb]),
            _usum((c // np.uint32(12345))[vc]), _usum((d % np.uint64(65537))[vd]),
            _usum((e // np.uint64(1000003))[ve]), _usum((e % np.uint64(4294967311))[ve]),
        )]
        vcols, _ = data["v"]
        e2, w = vcols["e2"][1], vcols["w"][1]
        # each u row with e among v's e2: the v rows it matches (e2 distinct
        # rows of u, so one e2 value may repeat only if u's e does)
        srt = np.argsort(e2, kind="stable")
        e2s, ws = e2[srt], w[srt]
        lo = np.searchsorted(e2s, e[ve], "left")
        hi = np.searchsorted(e2s, e[ve], "right")
        m = hi > lo
        wpre = np.concatenate([[0], np.cumsum(ws)])
        n_m = (hi - lo)[m]
        ku = np.where(kv[ve], k[ve], 0).astype(np.int64)[m]
        out["join"] = [(int(n_m.sum()), int((wpre[hi[m]] - wpre[lo[m]]).sum()),
                        int((ku * n_m).sum()))]
        ef = e[ve].astype(np.float64)
        out["cast_double"] = [(float(ef.sum()), float(ef.min()), float(ef.max()),
                               float(c[vc].astype(np.float64).sum()))]
    return out


def _rows(batches) -> list:
    return [tuple(r) for b in batches for r in b.to_pylist()]


def _timed_rows(db, sql: str, dev):
    _sync(dev)
    t0 = time.perf_counter()
    batches = db.run(sql)
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    return _rows(batches), ms


def phase_unsigned(dev, card: str, n: int = UNSIGNED_ROWS, shards: int = 4) -> int:
    """The unsigned deployment: tables u (n rows) and v, each UNSIGNED_SQL
    query one cold and three warm runs on the card, its rows against the
    numpy oracle (integers exactly, DOUBLE to rel 1e-9), against the port's
    CPU run of the same SQL (SQLRS_TPU_MXU=interpret: the same routes with
    the kernels' plain versions) and against `shards` shards on the card.
    The kernel-1 query must log hashagg_mxu and launch grouped_histogram.
    Returns grouped_histogram's launches on the card's single-device runs."""
    import sqlrs_tpu_torch
    from sqlrs_tpu_torch.ops.mxu_grouped import grouped_histogram
    from sqlrs_tpu_torch.parallel.mesh import make_mesh

    on_card = torch.device(dev).type == "cuda"
    t0 = time.perf_counter()
    data = gen_unsigned(n)
    exp = oracle_unsigned(data)
    gen_s = time.perf_counter() - t0
    db = sqlrs_tpu_torch.Database(device=dev)
    load_unsigned(db, data)
    load_unsigned(db, data, signed=True)
    for name in ("u", "v", "s"):
        db.catalog.table(name).storage.scan(dev)
    _sync(dev)
    print(f"phase unsigned: table u {n} rows (k INTEGER, a UTINYINT, b USMALLINT, "
          f"c UINTEGER, d UBIGINT < 2^36, e UBIGINT over [0, 2^64), ~1% NULLs each), "
          f"v {len(data['v'][0]['w'][1])} rows, numpy seed {UNSIGNED_SEED}; made with "
          f"their numpy oracle in {gen_s:.1f} s", flush=True)

    grouped_histogram.launches = 0  # this path's own launches from here
    results = {}
    for name, sql in UNSIGNED_SQL.items():
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        h0 = grouped_histogram.launches
        times, rows = [], None
        for _ in range(4):  # one cold run, then three warm runs
            db.last_fused_routes = []
            got, ms = _timed_rows(db, sql, dev)
            times.append(ms)
            if rows is not None and got != rows:
                raise AssertionError(f"unsigned {name}: a warm run gave other rows")
            rows = got
        tpch_compare(rows, exp[name], f"unsigned {name} (numpy oracle)")
        results[name] = {
            "rows": rows, "ms": times, "routes": list(db.last_fused_routes),
            "hist": grouped_histogram.launches - h0,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else 0.0,
        }
    launches = grouped_histogram.launches
    k1 = results["grouped_kernel1"]
    if "hashagg_mxu" not in k1["routes"] or (on_card and k1["hist"] < 4):
        raise AssertionError(f"unsigned grouped_kernel1: routes {k1['routes']}, "
                             f"{k1['hist']} grouped_histogram launches in 4 runs")
    if results["grouped_sorted"]["routes"]:
        raise AssertionError("unsigned grouped_sorted took " +
                             str(results["grouped_sorted"]["routes"]))
    signed = []
    for _ in range(4):
        signed.append(_timed_rows(db, SIGNED_SQL, dev)[1])
    if _timed_rows(db, SIGNED_SQL, dev)[0] != k1["rows"]:
        raise AssertionError("the signed copy's GROUP BY gave other rows")

    # the port's CPU run of the same SQL
    t0 = time.perf_counter()
    saved = os.environ.get("SQLRS_TPU_MXU")
    os.environ["SQLRS_TPU_MXU"] = "interpret"
    try:
        cpu_db = sqlrs_tpu_torch.Database(device="cpu")
        load_unsigned(cpu_db, data)
        for name, sql in UNSIGNED_SQL.items():
            cpu_db.last_fused_routes = []
            tpch_compare(results[name]["rows"], _rows(cpu_db.run(sql)),
                         f"unsigned {name} (card vs cpu)")
            if cpu_db.last_fused_routes != results[name]["routes"]:
                raise AssertionError(f"unsigned {name}: routes {results[name]['routes']} "
                                     f"on the card, {cpu_db.last_fused_routes} on the cpu")
    finally:
        if saved is None:
            os.environ.pop("SQLRS_TPU_MXU")
        else:
            os.environ["SQLRS_TPU_MXU"] = saved
    del cpu_db
    cpu_s = time.perf_counter() - t0

    # the sharded engine over `shards` shards on the same device
    t0 = time.perf_counter()
    mesh = make_mesh(shards, devices=[dev] * shards)
    dist_db = sqlrs_tpu_torch.Database(mesh=mesh)
    load_unsigned(dist_db, data)
    dist_ms = {}
    for name, sql in UNSIGNED_SQL.items():
        ms = []
        for _ in range(2):
            got, t = _timed_rows(dist_db, sql, dev)
            tpch_compare(got, results[name]["rows"], f"unsigned {name} (sharded vs one device)")
            ms.append(t)
        dist_ms[name] = ms
    del dist_db
    dist_s = time.perf_counter() - t0

    for name, r in results.items():
        ms = r["ms"]
        print(f"  {name}: cold {ms[0]:.1f} ms, warm {', '.join(f'{t:.1f}' for t in ms[1:])} "
              f"ms (median {float(np.median(ms[1:])):.1f}); {len(r['rows'])} rows; routes "
              f"{r['routes']}; grouped_histogram {r['hist']}; peak device memory "
              f"{r['peak_gb']:.2f} GB; {shards} shards warm {dist_ms[name][1]:.1f} ms "
              f"(cold {dist_ms[name][0]:.1f})", flush=True)
    print(f"  the same GROUP BY on signed columns (SMALLINT, INTEGER, BIGINT, BIGINT): "
          f"warm {', '.join(f'{t:.1f}' for t in signed[1:])} ms (median "
          f"{float(np.median(signed[1:])):.1f}) against unsigned "
          f"{float(np.median(k1['ms'][1:])):.1f} ms", flush=True)
    print(f"  all {len(results)} match the numpy oracle (integers exactly, doubles rel "
          f"1e-9), the cpu run ({cpu_s:.1f} s with its load) with equal routes, and "
          f"{shards} shards on the card ({dist_s:.1f} s with the load); grouped_histogram "
          f"{launches} launches [{card}]", flush=True)
    return launches


def tpch_run_profiled(db, qn: int):
    """(rows as tpch_run takes them, ms, [each statement's QueryProfile],
    [each statement's result row count]) with db's profile on."""
    _sync(db.device)
    t0 = time.perf_counter()
    outs, profs = [], []
    for stmt in tpch_statements(qn):
        outs.append(db.run(stmt))
        profs.append(db.last_profile)
    _sync(db.device)
    ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for batches in outs:
        out = [tuple(r) for b in batches for r in b.to_pylist()]
        if out or (batches and batches[0].columns):
            rows = out
    return rows, ms, profs, [sum(b.num_rows for b in bs) for bs in outs]


def op_lists(profs) -> list:
    return [[(s.op, s.depth, s.rows_out) for s in p.ops] for p in profs]


def _op_kind(op: str) -> str:
    return op.split("(")[0].strip()


def _suite_passes(db, profile: bool) -> float:
    """One warm pass over the 22 with the profile on or off: its ms."""
    db.profile_enabled = profile
    _sync(db.device)
    t0 = time.perf_counter()
    for qn in range(1, 23):
        for stmt in tpch_statements(qn):
            db.run(stmt)
    _sync(db.device)
    return (time.perf_counter() - t0) * 1e3


def phase_profiled22(card: str, label: str, db, results: dict, cpu_ops=None,
                     trace_dir=None, rounds: int = 1) -> int:
    """The 22 with db.profile_enabled on: per query the operator count,
    the sum of the operators' host self time against the root's wall and
    db.run's wall, the three operators with the most host self time; for
    the suite host self ms by operator kind; the root's rows_out against the
    result's row count; with cpu_ops, each statement's (op, depth, rows_out)
    list equal to the CPU database's. Then the warm pass with the profile
    off, on, on, off, `rounds` times (its overhead: the mean of the on
    passes less that of the off passes), and with trace_dir a torch.profiler
    trace of Q1 that must hold grouped_histogram. Returns
    grouped_histogram's launches in this phase."""
    from sqlrs_tpu_torch.ops.mxu_grouped import grouped_histogram
    from sqlrs_tpu_torch.utils import profiling

    grouped_histogram.launches = 0
    db.profile_enabled = True
    by_kind: dict = {}
    print(f"phase profile_ops: {label}, the 22 with Database.profile_enabled on "
          f"(host-clock self time of an operator: launching its work plus its syncs)",
          flush=True)
    total_self = total_wall = 0.0
    for qn in range(1, 23):
        rows, ms, profs, counts = tpch_run_profiled(db, qn)
        tpch_compare(rows, results[qn]["rows"], f"Q{qn} (profiled run)")
        ops = op_lists(profs)
        if cpu_ops is not None and ops != cpu_ops[qn]:
            raise AssertionError(f"Q{qn}: the operator lists differ from the cpu run's")
        for p, n_rows in zip(profs, counts):
            if p.ops and p.ops[-1].rows_out != n_rows:
                raise AssertionError(f"Q{qn}: root rows_out {p.ops[-1].rows_out} != "
                                     f"{n_rows} result rows")
        all_ops = [s for p in profs for s in p.ops]
        self_s = sum(s.self_s for s in all_ops)
        root_s = sum(p.ops[-1].wall_s for p in profs if p.ops)
        for s in all_ops:
            by_kind[_op_kind(s.op)] = by_kind.get(_op_kind(s.op), 0.0) + s.self_s
        top = sorted(all_ops, key=lambda s: -s.self_s)[:3]
        total_self += self_s
        total_wall += ms / 1e3
        print(f"  Q{qn}: {len(all_ops)} operators; host self {self_s * 1e3:.1f} ms of the "
              f"roots' {root_s * 1e3:.1f} ms and db.run's {ms:.1f} ms; most: "
              + "; ".join(f"{s.op[:40]} {s.self_s * 1e3:.1f} ms" for s in top), flush=True)
    kinds = sorted(by_kind.items(), key=lambda kv: -kv[1])
    print(f"  suite: host self {total_self * 1e3:.1f} ms of {total_wall * 1e3:.1f} ms; by "
          "operator kind: " + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in kinds), flush=True)
    if cpu_ops is not None:
        print("  every statement's (op, depth, rows_out) list equals the cpu run's; "
              "every root's rows_out equals its result's row count", flush=True)
    order = (False, True, True, False) * rounds
    passes = [_suite_passes(db, p) for p in order]
    off = float(np.mean([t for t, p in zip(passes, order) if not p]))
    on = float(np.mean([t for t, p in zip(passes, order) if p]))
    print(f"  warm passes of the 22, profile {' / '.join('on' if p else 'off' for p in order)}: "
          f"{', '.join(f'{t:.1f}' for t in passes)} ms; overhead {on - off:+.1f} ms "
          f"({(on / off - 1) * 100:+.1f}%) [{card}]", flush=True)
    db.profile_enabled = False
    if trace_dir is not None:
        import json as _json

        with profiling.trace(trace_dir):
            for stmt in tpch_statements(1):
                db.run(stmt)
            _sync(db.device)
        path = os.path.join(trace_dir, "trace.json")
        with open(path) as f:
            names = {str(e.get("name", "")) for e in _json.load(f)["traceEvents"]}
        hits = sorted(n for n in names if "grouped_histogram" in n) or ["none"]
        if db.device.type == "cuda" and hits == ["none"]:
            raise AssertionError(f"the trace of Q1 ({path}) holds no grouped_histogram kernel")
        print(f"  trace of Q1 through utils/profiling.trace: {os.path.relpath(path, REPO)}, "
              f"{len(names)} distinct event names, kernel {hits[0][:60]}", flush=True)
    print(f"  grouped_histogram launches in this phase: {grouped_histogram.launches}",
          flush=True)
    return grouped_histogram.launches


def write_table_csv(cols: dict, path: str) -> None:
    """A generated table as CSV: dates ISO, doubles by repr (round trip),
    the rest as text; quoting by the csv module."""
    import csv

    from sqlrs_tpu_torch.benchmarks.tpch_dbgen import type_name

    texts = []
    for c, a in cols.items():
        t = type_name(c, a)
        if t == "DATE":
            texts.append(np.datetime_as_string(a.astype("datetime64[D]")).tolist())
        elif t == "DOUBLE":
            texts.append([repr(x) for x in a.tolist()])
        else:
            texts.append(a.astype(str).tolist())
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(list(cols))
        w.writerows(zip(*texts))


def phase_csv_cli(dev, card: str, tmpdir: str) -> int:
    """TPC-H lineitem at SF CSV_SF, seed SEED, written as CSV: the native
    loader (built from native/csv_loader.cpp at first use) must be
    available and give read_csv_file's table column for column; both load
    times; Q1 and Q6 on the card from the CSV-loaded table equal to the
    same data loaded from numpy; then `python -m sqlrs_tpu_torch.cli
    --device <dev> --csv-dir <tmpdir> -c <Q6>` in a subprocess must print
    pretty_table's text of Database.run of the same SQL. Returns
    grouped_histogram's launches in the Q1 runs."""
    import sqlrs_tpu_torch
    from sqlrs_tpu_torch.benchmarks import tpch_dbgen
    from sqlrs_tpu_torch.ops.mxu_grouped import grouped_histogram
    from sqlrs_tpu_torch.storage import native_loader
    from sqlrs_tpu_torch.storage.csv import read_csv_file
    from sqlrs_tpu_torch.utils.render import batch_to_rows, pretty_table

    t0 = time.perf_counter()
    li = tpch_dbgen.gen_tables(CSV_SF, seed=SEED)["lineitem"]
    path = os.path.join(tmpdir, "lineitem.csv")
    write_table_csv(li, path)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not native_loader.native_available():
        raise AssertionError("the native CSV loader did not build or load")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    a = native_loader.read_csv_native(path)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = read_csv_file(path)
    python_s = time.perf_counter() - t0
    if a.names != b.names or a.types != b.types or a.num_rows != b.num_rows:
        raise AssertionError(f"native {a.names} {a.types} {a.num_rows} != python "
                             f"{b.names} {b.types} {b.num_rows}")
    for i, name in enumerate(a.names):
        da, va = a.host_column(i)
        db_, vb = b.host_column(i)
        if da.dtype != db_.dtype or not np.array_equal(va, vb) or not np.array_equal(
                da[va], db_[vb]):
            raise AssertionError(f"column {name}: the native loader differs from read_csv_file")
    print(f"phase csv: TPC-H lineitem at SF {CSV_SF} (cut from SF1: the Python reader "
          f"takes minutes at 6M rows), seed {SEED}: {a.num_rows} rows x {len(a.names)} "
          f"columns, {os.path.getsize(path) / 1e6:.1f} MB of CSV (made in {gen_s:.1f} s); "
          f"native loader built/loaded in {build_s:.2f} s "
          f"({os.path.basename(native_loader.library_path())}); load {native_s:.2f} s native "
          f"against {python_s:.2f} s read_csv_file, every column equal", flush=True)

    csv_db = sqlrs_tpu_torch.Database(device=dev)
    t0 = time.perf_counter()
    csv_db.create_csv_table("lineitem", path)  # load_csv: the native path
    load_s = time.perf_counter() - t0
    np_db = sqlrs_tpu_torch.Database(device=dev)
    tpch_dbgen.load_into(np_db, {"lineitem": li})
    grouped_histogram.launches = 0
    for qn in (1, 6):
        sql = tpch_statements(qn)[0]
        got, ms = _timed_rows(csv_db, sql, dev)
        exp = _rows(np_db.run(sql))
        if got != exp:
            raise AssertionError(f"Q{qn}: the CSV-loaded table's rows differ from numpy's")
        print(f"  Q{qn} on {dev} from the CSV-loaded table ({load_s:.2f} s through "
              f"Database.create_csv_table): {len(got)} rows equal to the numpy-loaded "
              f"table's; cold {ms:.1f} ms", flush=True)
    launches = grouped_histogram.launches
    if torch.device(dev).type == "cuda" and launches < 1:
        raise AssertionError("Q1 from the CSV table did not launch grouped_histogram")

    q6 = tpch_statements(6)[0]
    batches = csv_db.run(q6)
    want = pretty_table(batches[0].schema.names, batch_to_rows(batches[0]))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sqlrs_tpu_torch.cli", "--device", str(torch.device(dev).type),
         "--csv-dir", tmpdir, "-c", q6],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    table = "\n".join(ln for ln in proc.stdout.splitlines() if ln[:1] in ("+", "|"))
    if table != want:
        raise AssertionError(f"the CLI printed\n{proc.stdout}\nexpected\n{want}")
    timing = [ln for ln in proc.stdout.splitlines() if ln.startswith("time consumed")]
    print(f"  python -m sqlrs_tpu_torch.cli --device {torch.device(dev).type} --csv-dir "
          f"<tmp> -c <Q6>: exit 0 in {cli_s:.1f} s (process, import, CSV load and query); "
          f"its table equals pretty_table of Database.run's; {timing[0] if timing else ''}; "
          f"grouped_histogram launches in Q1 from both tables: {launches} [{card}]", flush=True)
    return launches


# ---- phase 10: multi-process execution and the comparison strategies ------

MP_PROCS, MP_SHARDS = 2, 2       # gloo: two processes, two shards each, one card
NCCL_SHARDS = 4                  # the one-rank NCCL group's local shards
NCCL_QUERIES = (3, 5, 12, 13, 18, 22)
MP_TIMEOUT_S = 480               # each group of child processes, all killed past it


def mp_child(spec: dict) -> int:
    """One process of phase 10 (`chip_smoke.py --mp-child SPEC`): joins the
    process group, builds the flat mesh of its `shards` shards on its card,
    runs bench.py's star through the four strategies (each one cold and one
    warm run, exact against numpy, or raises) and then the TPC-H queries on
    the tables the parent wrote (one cold and one warm run each), and
    writes rows, times, bytes across processes, host staging time, join
    strategies, peak memory and kernel launches to spec["out"]."""
    import pickle

    import torch.distributed as dist

    import sqlrs_tpu_torch
    from sqlrs_tpu_torch.benchmarks import tpch_dbgen
    from sqlrs_tpu_torch.parallel import dist_ops
    from sqlrs_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    dev = torch.device("cuda", spec["card"])
    torch.cuda.set_device(dev)
    os.environ["LOCAL_RANK"] = str(spec["card"])
    initialize_distributed(spec["init"], spec["n_proc"], spec["rank"],
                           backend=spec["backend"])
    mesh = make_mesh(devices=[dev] * spec["shards"])
    out = {"rank": spec["rank"], "mesh": repr(mesh), "star": {}, "tpch": {}}
    _zero_kernel_counts()

    star = gen_star()
    gid, v = star["gid"], star["v"]
    keys = np.arange(STAR_GROUPS, dtype=np.int64)
    exp_s = np.bincount(gid, weights=v, minlength=STAR_GROUPS).astype(np.int64)
    exp_c = np.bincount(gid, minlength=STAR_GROUPS).astype(np.int64)
    fk, fv, dk = (torch.from_numpy(a).to(dev) for a in (keys[gid], v, keys))
    g = STAR_GROUPS
    cap0 = 2 * STAR_ROWS // (mesh.size * mesh.size)
    strategies = {
        "broadcast": lambda: dist_ops.dist_join_groupby_broadcast(mesh, fk, fv, dk, g),
        "shuffle_checked": lambda: dist_ops.dist_join_groupby_shuffle_checked(
            mesh, fk, fv, dk, g, bucket_capacity=cap0),
        "salted_checked": lambda: dist_ops.dist_join_groupby_salted_checked(
            mesh, fk, fv, dk, g, bucket_capacity=cap0, hot_capacity=1024),
        "ring": lambda: dist_ops.dist_join_groupby_ring(mesh, fk, fv, dk, g),
    }
    for name, fn in strategies.items():
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for _ in range(2):  # one cold run, then one warm run
            mesh.reset_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sums, cnts = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if not (np.array_equal(sums.cpu().numpy(), exp_s)
                    and np.array_equal(cnts.cpu().numpy(), exp_c)):
                raise AssertionError(f"{spec['label']} rank {spec['rank']}: "
                                     f"dist_join_groupby_{name} != numpy")
        out["star"][name] = {"ms": times, "bytes": mesh.stats["bytes"],
                             "staging_s": mesh.stats["staging_s"],
                             "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    del fk, fv, dk, star, sums, cnts
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with open(spec["tables"], "rb") as f:
        tables = pickle.load(f)
    db = sqlrs_tpu_torch.Database(mesh=mesh)
    tpch_dbgen.load_into(db, tables)
    for name in tables:
        db.catalog.table(name).storage.scan(dev)
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    for qn in spec["queries"]:
        torch.cuda.reset_peak_memory_stats(dev)
        ms = []
        for _ in range(2):  # one cold run, then one warm run
            mesh.reset_stats()
            rows, t = tpch_run(db, qn)
            ms.append(t)
        out["tpch"][qn] = {
            "rows": rows, "ms": ms, "bytes": mesh.stats["bytes"],
            "staging_s": mesh.stats["staging_s"],
            "strategies": list(db.last_join_strategies),
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        }
    out["launches"] = _kernel_counts()
    with open(spec["out"], "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def run_children(label: str, tmpdir: str, backend: str, n_proc: int, shards: int,
                 cards: list, queries, tables_path: str) -> list:
    """Start n_proc phase-10 children on one file:// rendezvous and wait for
    them, all killed when MP_TIMEOUT_S passes; raises with a child's output
    when one fails. Returns their results in rank order."""
    import pickle

    outs = [os.path.join(tmpdir, f"{label}_{r}.pkl") for r in range(n_proc)]
    procs = []
    for r in range(n_proc):
        spec = {"label": label, "rank": r, "n_proc": n_proc, "shards": shards,
                "card": cards[r], "backend": backend, "init": f"file://{tmpdir}/rdv_{label}",
                "queries": list(queries), "tables": tables_path, "out": outs[r]}
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--mp-child",
             json.dumps(spec)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO))
    deadline = time.monotonic() + MP_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"{label} rank {r} exited {p.returncode}:\n{log[-6000:]}")
    results = []
    for path in outs:
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return results


def _report_children(label: str, card: str, results: list, single: dict, dist: dict) -> dict:
    """Holds every child's rows to phase 6's single-device rows, prints the
    star and per-query lines, and returns the children's kernel launches."""
    for res in results:
        for qn, r in res["tpch"].items():
            tpch_compare(r["rows"], single[qn]["rows"],
                         f"Q{qn} ({label} rank {res['rank']} vs single device)")
    loads = ", ".join(f"{r['load_s']:.1f}" for r in results)
    print(f"  {label}: {len(results)} process(es), {results[0]['mesh']}; tables loaded "
          f"in {loads} s", flush=True)
    for name in results[0]["star"]:
        rs = [r["star"][name] for r in results]
        print(f"    star {name}: cold {max(x['ms'][0] for x in rs):.1f} ms, warm "
              f"{max(x['ms'][1] for x in rs):.1f} ms (slowest process); equal numpy's "
              f"exactly in every process; bytes across processes {sum(x['bytes'] for x in rs)}, "
              f"host staging {max(x['staging_s'] for x in rs) * 1e3:.1f} ms; peak device "
              f"memory {max(x['peak_gb'] for x in rs):.2f} GB a process [{card}]", flush=True)
    total, total_dist = 0.0, 0.0
    for qn in results[0]["tpch"]:
        rs = [r["tpch"][qn] for r in results]
        warm = max(x["ms"][1] for x in rs)
        one = float(np.median(single[qn]["ms"][1:]))
        d4 = float(np.median(dist[qn]["ms"][1:]))
        total += warm
        total_dist += d4
        print(f"    Q{qn}: warm {warm:.1f} ms (cold {max(x['ms'][0] for x in rs):.1f}) vs "
              f"{d4:.1f} ms on phase 8's 4 single-controller shards = {warm / d4:.2f}x, "
              f"{one:.1f} ms on one device; bytes "
              f"across processes {sum(x['bytes'] for x in rs)}, host staging "
              f"{max(x['staging_s'] for x in rs) * 1e3:.1f} ms; peak "
              f"{max(x['peak_gb'] for x in rs):.2f} GB a process; strategies "
              f"{rs[0]['strategies']}", flush=True)
    print(f"    {len(results[0]['tpch'])} queries equal the single-device rows in every "
          f"process; sum of warm ms {total:.1f} vs {total_dist:.1f} on phase 8's shards "
          f"[{card}]", flush=True)
    launches = {k: 0 for k in results[0]["launches"]}
    for res in results:
        for k, n in res["launches"].items():
            launches[k] += n
    return launches


def device_total_ms(fn, calls: int = 3) -> float:
    """Device milliseconds per call of fn(): the sum of every CUDA kernel
    record torch.profiler traced over `calls` calls, after one warm-up; a
    trace with no records is taken again, at most three times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(float(getattr(e, "self_device_time_total", 0) or
                       getattr(e, "self_cuda_time_total", 0) or 0)
                 for e in prof.key_averages() if str(e.device_type).endswith("CUDA"))
        if us > 0:
            return us / 1e3 / calls
    raise AssertionError("torch.profiler traced no device time")


def phase_comparison_strategies(dev, card: str, star: dict) -> dict:
    """make_join_groupby's 'hash', 'sorted' and 'sorted_packed' on bench.py's
    dense and spread star beside 'direct' (kernel 2 on the dense star):
    one cold and two warm runs each, exact against numpy. Then
    mxu_groupby_dense_xla (the one-hot product formulation) against
    kernel 2 at 2^25 rows x 2^16 groups: bit-equal, CUDA-event ms and
    device ms of each. Returns kernel 2's launches in the strategy runs."""
    from sqlrs_tpu_torch.ops.mxu_agg import dense_group_sums, mxu_groupby_dense_xla
    from sqlrs_tpu_torch.ops.pipelines import make_join_groupby

    gid, v = star["gid"], star["v"]
    dense = np.arange(STAR_GROUPS, dtype=np.int64)
    exp_s = np.bincount(gid, weights=v, minlength=STAR_GROUPS).astype(np.int64)
    exp_c = np.bincount(gid, minlength=STAR_GROUPS).astype(np.int64)
    fv = torch.from_numpy(v).to(dev)
    print(f"phase comparison_strategies: fact {STAR_ROWS} rows x dim {STAR_GROUPS} keys",
          flush=True)
    _zero_kernel_counts()
    for layout, dim in (("dense", dense), ("spread", dense * 1013904223 + 12345)):
        fk = torch.from_numpy(dim[gid]).to(dev)
        dk = torch.from_numpy(dim).to(dev)
        meta = {"key_max": int(dim.max()), "val_max": 99}
        if layout == "dense":
            meta.update(dim_min=0, dim_max=STAR_GROUPS - 1)
        calls = {
            "direct": lambda: make_join_groupby(STAR_GROUPS)(fk, fv, dk, **meta),
            "hash": lambda: make_join_groupby(STAR_GROUPS, "hash")(fk, fv, dk),
            "sorted": lambda: make_join_groupby(STAR_GROUPS, "sorted")(fk, fv, dk),
            "sorted_packed": lambda: make_join_groupby(STAR_GROUPS, "sorted_packed")(
                fk, fv, dk, val_bits=7),
        }
        parts = []
        for name, fn in calls.items():
            times = []
            for _ in range(3):  # one cold run, then two warm runs
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sums, cnts = fn()[:2]
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                if not (np.array_equal(sums.cpu().numpy(), exp_s)
                        and np.array_equal(cnts.cpu().numpy(), exp_c)):
                    raise AssertionError(f"make_join_groupby {name!r} ({layout}) != numpy")
            parts.append(f"{name} {float(np.median(times[1:])):.2f} ms (cold {times[0]:.1f})")
        print(f"  {layout}: warm " + "; ".join(parts) + f"; each equal numpy's exactly [{card}]",
              flush=True)
    launches = _kernel_counts()
    if launches["dense_group_sums"] < 3:
        raise AssertionError("'direct' on the dense star did not launch dense_group_sums")

    keys = torch.from_numpy(gid).to(dev)
    xs, xc = mxu_groupby_dense_xla(keys, fv, STAR_GROUPS, 7)
    ks, kc = dense_group_sums(keys, fv, STAR_GROUPS)
    if not (torch.equal(xs, ks) and torch.equal(xc, kc)
            and np.array_equal(xs.cpu().numpy(), exp_s)):
        raise AssertionError("mxu_groupby_dense_xla != dense_group_sums")
    xla_ms = cuda_ms(lambda: mxu_groupby_dense_xla(keys, fv, STAR_GROUPS, 7), reps=3)
    k2_ms = cuda_ms(lambda: dense_group_sums(keys, fv, STAR_GROUPS), reps=5, per=10)
    xla_dev = device_total_ms(lambda: mxu_groupby_dense_xla(keys, fv, STAR_GROUPS, 7))
    k2_dev = device_ms(lambda: dense_group_sums(keys, fv, STAR_GROUPS), "dense_group_sums",
                       at_least=k2_ms / 2)
    print(f"  mxu_groupby_dense_xla vs dense_group_sums at {STAR_ROWS} x {STAR_GROUPS}: "
          f"bit-equal (and equal numpy's); {xla_ms:.2f} ms vs {k2_ms:.3f} ms by CUDA events, "
          f"device {xla_dev:.2f} ms vs {k2_dev:.3f} ms [{card}]", flush=True)
    return launches


def phase_multiprocess(dev, card: str, tmpdir: str, tables_path: str, single: dict,
                       dist: dict) -> dict:
    """Phase 10: the sharded engine over several processes. Two processes
    (gloo, each with 2 shards on this card, CUDA tensors staged through host
    memory) run the star's strategies and all 22 queries; a one-rank NCCL
    group with 4 shards runs the star and six queries; two NCCL ranks, one
    a card, only where there are two cards. Every child's rows must equal
    phase 6's single-device rows. Returns the children's kernel launches."""
    print(f"phase multiprocess: the sharded engine over torch.distributed; tables "
          f"from {os.path.basename(tables_path)} ({os.path.getsize(tables_path) / 1e9:.2f} GB)",
          flush=True)
    t0 = time.perf_counter()
    launches = _report_children(
        "gloo_2proc", card,
        run_children("gloo_2proc", tmpdir, "gloo", MP_PROCS, MP_SHARDS, [0] * MP_PROCS,
                     range(1, 23), tables_path),
        single, dist)
    nccl = _report_children(
        "nccl_1rank", card,
        run_children("nccl_1rank", tmpdir, "nccl", 1, NCCL_SHARDS, [0], NCCL_QUERIES,
                     tables_path),
        single, dist)
    for k, n in nccl.items():
        launches[k] += n
    if torch.cuda.device_count() >= 2:
        two = _report_children(
            "nccl_2rank", card,
            run_children("nccl_2rank", tmpdir, "nccl", 2, 2, [0, 1], NCCL_QUERIES,
                         tables_path),
            single, dist)
        for k, n in two.items():
            launches[k] += n
    else:
        print("  nccl_2rank: not run (1 card)", flush=True)
    print(f"  phase multiprocess took {time.perf_counter() - t0:.1f} s; launches "
          f"{', '.join(f'{k} {n}' for k, n in launches.items())} [{card}]", flush=True)
    return launches


# ---- phase 11: the engine-vs-engine fuzz corpus on the card ----------------

FUZZ_LARGE_SEEDS = range(4)  # 2^18 fact rows each, besides the fast tests' corpus


def phase_fuzz(dev, card: str) -> dict:
    """The fuzz corpus (sqlrs_tpu_torch/benchmarks/sql_fuzz.py): the fast
    tests' cases (which they hold to the JAX package on the CPU) and 2^18-row
    large seeds, each loaded into the port on the CPU, on the card and over
    4 shards on the card. Every statement runs once on the CPU and twice
    on each card engine: each card result must equal the CPU run's by
    sql_fuzz.difference (floats rel 1e-9), and each repeat its first run
    bit for bit. SQLRS_TPU_MXU=interpret makes the CPU run take the kernels'
    routes with their plain versions, as the fast tests do; on the card the
    routes launch the kernels. Returns each kernel's launches in the phase
    (the card runs only)."""
    import sqlrs_tpu_torch
    from sqlrs_tpu_torch.benchmarks import sql_fuzz
    from sqlrs_tpu_torch.parallel.mesh import make_mesh
    from sqlrs_tpu_torch.storage.memory import import_tables
    from sqlrs_tpu_torch.utils.render import batch_to_rows

    t_phase = time.perf_counter()
    mesh = make_mesh(DIST_SHARDS, devices=[dev] * DIST_SHARDS)
    cases = list(sql_fuzz.fast_tier_cases()) + [
        sql_fuzz.gen_case(seed, "large") for seed in FUZZ_LARGE_SEEDS
    ]
    saved = os.environ.get("SQLRS_TPU_MXU")
    os.environ["SQLRS_TPU_MXU"] = "interpret"
    _zero_kernel_counts()
    n_run = n_raise = 0
    engine_s = dict.fromkeys(("load", "cpu", "cuda", "shards"), 0.0)
    diffs, routes, strategies = [], set(), set()
    per_size = {}
    try:
        for case in cases:
            t0 = time.perf_counter()
            cpu = sqlrs_tpu_torch.Database(device="cpu")
            gpu = sqlrs_tpu_torch.Database(device=dev)
            sharded = sqlrs_tpu_torch.Database(mesh=mesh)
            for db in (cpu, gpu, sharded):
                import_tables(db, case.tables)
            engine_s["load"] += time.perf_counter() - t0

            def run(key, db, sql):
                t1 = time.perf_counter()
                out = sql_fuzz.outcome(db, sql, batch_to_rows)
                engine_s[key] += time.perf_counter() - t1
                return out

            for sql in case.statements:
                gpu.last_fused_routes = []
                c = run("cpu", cpu, sql)
                g1, g2 = run("cuda", gpu, sql), run("cuda", gpu, sql)
                s1, s2 = run("shards", sharded, sql), run("shards", sharded, sql)
                routes.update(gpu.last_fused_routes or [])
                strategies.update(sharded.last_join_strategies or [])
                n_run += 1
                n_raise += c[0] == "error"
                for what, a, b, rel in (("cuda", c, g1, 1e-9), ("cuda repeat", g1, g2, 0.0),
                                        ("4 shards", c, s1, 1e-9),
                                        ("4 shards repeat", s1, s2, 0.0)):
                    d = sql_fuzz.difference(a, b, rel)
                    if d is not None:
                        diffs.append((case.seed, case.size, what, sql, d))
            del cpu, gpu, sharded
            n, s = per_size.get(case.size, (0, 0.0))
            per_size[case.size] = (n + len(case.statements), s + time.perf_counter() - t0)
    finally:
        if saved is None:
            os.environ.pop("SQLRS_TPU_MXU")
        else:
            os.environ["SQLRS_TPU_MXU"] = saved
    torch.cuda.empty_cache()
    launches = _kernel_counts()
    secs = time.perf_counter() - t_phase
    sizes = ", ".join(f"{k} {n} statements in {t:.1f} s" for k, (n, t) in per_size.items())
    print(f"phase fuzz: {len(cases)} cases (the fast tests' {len(cases) - len(FUZZ_LARGE_SEEDS)} and "
          f"{len(FUZZ_LARGE_SEEDS)} large at 2^18 fact rows); {n_run} statements, each once "
          f"on the cpu and twice on cuda and over {DIST_SHARDS} shards on the card ({sizes}); "
          f"{n_raise} refused by every engine alike; differences {len(diffs)}; "
          f"grouped_histogram {launches['grouped_histogram']}, dense_group_sums "
          f"{launches['dense_group_sums']} launches; seconds by engine "
          f"{ {k: round(v, 1) for k, v in engine_s.items()} }; routes {sorted(routes)}; "
          f"strategies {sorted(strategies)}; {secs:.1f} s [{card}]", flush=True)
    for seed, size, what, sql, d in diffs[:20]:
        print(f"  DIFFERENCE seed {seed} {size} ({what}): {sql}\n    {d[:600]}", flush=True)
    if diffs:
        raise AssertionError(f"phase fuzz: {len(diffs)} differences")
    if launches["grouped_histogram"] == 0:
        raise AssertionError("phase fuzz: grouped_histogram was never launched")
    if launches["dense_group_sums"] == 0:
        raise AssertionError("phase fuzz: dense_group_sums was never launched")
    if "shuffle" not in strategies:
        raise AssertionError(f"phase fuzz: no shuffle join among {sorted(strategies)}")
    return launches


def write_tables(tables: dict, tmpdir: str) -> str:
    """Pickle the tables (numpy columns) once for phase 10's children."""
    import pickle

    path = os.path.join(tmpdir, "tpch_sf1.pkl")
    with open(path, "wb") as f:
        pickle.dump(tables, f, protocol=pickle.HIGHEST_PROTOCOL)
    return path


def build_all() -> None:
    """Build every kernel source at once: one nvcc process each."""
    from concurrent.futures import ThreadPoolExecutor

    from sqlrs_tpu_torch.utils.cuda_build import BUILD_INFO, load_kernel_library

    sources = KERNEL_SOURCES + BASELINE_SOURCES
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(load_kernel_library, sources))
    print(f"phase build: {len(sources)} sources in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name in sources:
        info = BUILD_INFO[name]
        ptxas = [ln.strip() for ln in info["log"].splitlines() if "ptxas info" in ln]
        print(f"  {name}.cu: nvcc {info['seconds']:.2f} s; {' | '.join(ptxas)}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import sqlrs_tpu_torch  # noqa: F401  (fails outside the repository)

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}", flush=True)
    build_all()

    t0 = time.perf_counter()
    li, orders = gen_lineitem(SEED)
    gen_s = time.perf_counter() - t0
    star = gen_star()
    k1 = phase_kernel(dev, card, li)
    k2 = phase_dense_kernel(dev, card, star)
    k34 = phase_rank_kernels(dev, card, star)
    hist_launches, tpch_db = phase_tpch(dev, card, li, orders, gen_s)
    launches, star_db = phase_star(dev, card, star, tpch_db, li, orders)
    phase_profile(card, "dense ORDER BY rollup",
                  lambda: star_db.run(STAR_SQL["dense_order"][0]))
    del star_db, tpch_db
    # phase 11 runs here, while the string dictionary is small: every new
    # LIKE pattern evaluates over the whole dictionary, about a second per
    # pattern once phase 6 has interned TPC-H's 2.3M strings
    launches_fuzz = phase_fuzz(dev, card)
    launches22, db22, slowest, tables22, results22, cpu_ops22 = phase_tpch22(dev, card)
    phase_profile(card, f"TPC-H Q{slowest} at SF {TPCH22_SF} (the slowest warm query)",
                  lambda: [db22.run(stmt) for stmt in tpch_statements(slowest)], runs=3)
    phase_profile(card, f"all 22 TPC-H queries at SF {TPCH22_SF}, one after another",
                  lambda: [db22.run(stmt) for qn in range(1, 23)
                           for stmt in tpch_statements(qn)], runs=1,
                  functions=PROFILED_FUNCTIONS)
    import tempfile

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.path.join(REPO, "build"))
    os.makedirs(os.path.join(tmp.name, "csv"))
    hist_launches += phase_profiled22(
        card, f"TPC-H SF {TPCH22_SF} on one device", db22, results22, cpu_ops22,
        trace_dir=os.path.join(tmp.name, "trace"), rounds=3)
    del db22
    torch.cuda.empty_cache()
    from sqlrs_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(DIST_SHARDS, devices=[dev] * DIST_SHARDS)
    phase_dist_star(dev, card, star, mesh)
    launches_dist, dist_db, results_dist = phase_dist_tpch(dev, card, mesh, tables22, results22)
    hist_launches += phase_profiled22(
        card, f"TPC-H SF {TPCH22_SF} over {mesh.size} shards on one card (dist: labels)",
        dist_db, results22)
    del dist_db
    # phase 10's children read phase 6's tables from here, the same bytes each
    tables_path = write_tables(tables22, tmp.name)
    del tables22
    torch.cuda.empty_cache()
    hist_launches += phase_unsigned(dev, card)
    hist_launches += phase_csv_cli(dev, card, os.path.join(tmp.name, "csv"))
    launches_b = phase_comparison_strategies(dev, card, star)
    del star
    launches_mp = phase_multiprocess(dev, card, tmp.name, tables_path, results22, results_dist)
    tmp.cleanup()
    for extra in (launches22, launches_dist, launches_b, launches_mp, launches_fuzz):
        hist_launches += extra["grouped_histogram"]
        for name in ("dense_group_sums", "row_rank_ge", "masked_row_sum"):
            launches[name] += extra[name]

    def entry(name, source, replaces, launches, k):
        # k: the contract's times, then device_ms / host_us (and for kernels
        # 3 and 4 the S2 times) from phase 2
        return {"name": name, "route": "cuda", "source": f"sqlrs_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "bound_by": "bytes", **k}

    print(json.dumps({"kernels": [
        entry("grouped_histogram", "mxu_grouped.cu", "sqlrs_tpu/ops/mxu_grouped.py:154",
              hist_launches, k1),
        entry("dense_group_sums", "mxu_agg.cu", "sqlrs_tpu/ops/mxu_agg.py:64",
              launches["dense_group_sums"], k2),
        # no production path calls these two, as in the reference: their
        # count over the star rollup's runs stays 0
        entry("row_rank_ge", "pallas_kernels.cu", "sqlrs_tpu/ops/pallas_kernels.py:57",
              launches["row_rank_ge"], k34["row_rank_ge"]),
        entry("masked_row_sum", "pallas_kernels.cu", "sqlrs_tpu/ops/pallas_kernels.py:140",
              launches["masked_row_sum"], k34["masked_row_sum"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--mp-child":
        sys.exit(mp_child(json.loads(sys.argv[2])))
    sys.exit(main())
