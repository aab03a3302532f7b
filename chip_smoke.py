"""Smoke run of sqlrs_tpu_torch on one NVIDIA GPU: build, kernel checks,
TPC-H Q1/Q6 at scale factor 1, and the star rollup at bench.py's size, all
through `Database(device="cuda").run`.

    python3 chip_smoke.py

Phases, each printing one line or a few:
  1. build       — nvcc builds every kernel source in sqlrs_tpu_torch/csrc/
                   into build/kernels/, one nvcc process for each source, all
                   started together (the times include nvcc).
  2. kernel      — each kernel against its plain PyTorch version on the card,
                   on inputs made from a seed with numpy, at small and ragged
                   shapes and at the shapes of the main path; integer results
                   must be equal bit for bit (tolerance 0). Times are medians
                   of CUDA-event timings at the main path's shapes: Q1's for
                   grouped_histogram, the star rollup's for dense_group_sums
                   (2^25 rows, 2^16 groups), and the star rollup's rank stage
                   for row_rank_ge / masked_row_sum (the sorted pack32 array
                   as (2^18, 128) blocks, 2^16 + 1 boundary queries).
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

Then one JSON line about the kernels, and last one JSON line
{"ok": true, "device": {...}}. Any failure raises, and the process exits
non-zero. Without CUDA it exits non-zero before printing anything.
"""

from __future__ import annotations

import json
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


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of fn() by CUDA events, after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


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


def phase_kernel(dev, card: str, n_main: int) -> dict:
    """n_main: the row count of the table the main path aggregates."""
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

    # timing at Q1's shape: G=4, 15 channels over 7 words
    n = n_main
    gid = torch.from_numpy(rng.integers(0, 4, n, dtype=np.int32)).to(dev)
    words = torch.from_numpy(rng.integers(0, 1 << 24, (7, n), dtype=np.int32)).to(dev)
    plan = [(0, 0), (1, 0), (1, 8), (1, 16), (2, 0), (2, 8), (2, 16), (3, 0),
            (4, 0), (4, 8), (4, 16), (5, 0), (5, 8), (6, 0)]
    ms = cuda_ms(lambda: grouped_histogram(gid, words, plan, 4), 20)
    plain_ms = cuda_ms(lambda: grouped_histogram_plain(gid, words, plan, 4), 20)
    gb = n * 4 * (1 + 7) / 1e9
    print(
        f"phase kernel: grouped_histogram == plain bit for bit in {cases} cases; "
        f"at Q1's shape (n={n}, G=4, nch=15, 7 words): kernel {ms:.3f} ms "
        f"({gb / (ms / 1e3):.0f} GB/s of input), plain {plain_ms:.3f} ms "
        f"[{card}]",
        flush=True,
    )
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


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


def phase_dense_kernel(dev, card: str, star: dict) -> dict:
    """dense_group_sums against its plain version, then timed at the star
    rollup's shape (the bench's zipf keys as gids, its values)."""
    from sqlrs_tpu_torch.ops.mxu_agg import dense_group_sums, dense_group_sums_plain

    rng = np.random.default_rng(SEED + 1)
    max_err, cases = 0, 0

    def check(gid, vals, G, what):
        nonlocal max_err, cases
        sk, ck = dense_group_sums(gid, vals, G)
        sp, cp = dense_group_sums_plain(gid, vals, G)
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

    gid = torch.from_numpy(star["gid"].astype(np.int32)).to(dev)
    vals = torch.from_numpy(star["v"].astype(np.int32)).to(dev)
    ms = cuda_ms(lambda: dense_group_sums(gid, vals, STAR_GROUPS), 20)
    plain_ms = cuda_ms(lambda: dense_group_sums_plain(gid, vals, STAR_GROUPS), 20)
    gb = STAR_ROWS * 8 / 1e9
    print(
        f"phase kernel: dense_group_sums == plain bit for bit in {cases} cases; at "
        f"the star rollup's shape (n={STAR_ROWS}, G={STAR_GROUPS}, zipf keys): "
        f"kernel {ms:.3f} ms ({gb / (ms / 1e3):.0f} GB/s of input, read "
        f"{-(-STAR_GROUPS // 8192)} times), plain {plain_ms:.3f} ms [{card}]",
        flush=True,
    )
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def rank_inputs(rng, nq: int, dev):
    nb = 64
    sp2d = np.sort(rng.integers(-50_000, 50_000, nb * 128).astype(np.int32)).reshape(nb, 128)
    b = rng.integers(0, nb, nq).astype(np.int32)
    q = rng.integers(-60_000, 60_000, nq).astype(np.int32)
    q[::4] = sp2d[b[::4], 64]
    rem = rng.integers(0, 129, nq).astype(np.int32)
    rem[::3] = 0
    rem[1::3] = 128
    v2d = rng.integers(-(1 << 31), (1 << 31) - 1, (nb, 128)).astype(np.int32)
    return [torch.from_numpy(a).to(dev) for a in (sp2d, v2d, b, q, rem)]


def phase_rank_kernels(dev, card: str, star: dict) -> dict:
    """row_rank_ge and masked_row_sum against their plain versions at ragged
    query counts and at the star rollup's rank stage: the sorted pack32
    array (k << 7 | v) as (2^18, 128) blocks and the 2^16 + 1 dense
    boundary queries d << 7, with the block of each query as the stage
    finds it (the block minima below it) and its in-block position."""
    from sqlrs_tpu_torch.ops.pallas_kernels import (
        masked_row_sum,
        masked_row_sum_plain,
        row_rank_ge,
        row_rank_ge_plain,
    )

    rng = np.random.default_rng(SEED + 2)
    max_err, cases = 0, 0

    def check(sp2d, v2d, b, q, rem, what):
        nonlocal max_err, cases
        rk, rp = row_rank_ge(sp2d, b, q), row_rank_ge_plain(sp2d, b, q)
        mk, mp = masked_row_sum(v2d, b, rem), masked_row_sum_plain(v2d, b, rem)
        torch.cuda.synchronize()
        if not (torch.equal(rk, rp) and torch.equal(mk, mp)):
            raise AssertionError(f"rank-stage kernels != plain at {what}")
        max_err = max(max_err, int((rk - rp).abs().max()), int((mk - mp).abs().max()))
        cases += 1
        return rk, mk

    for nq in (1, 31, 33, 1000, 65537):
        check(*rank_inputs(rng, nq, dev), what=f"nq={nq}")

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
    rk, _ = check(sp2d, v2d, b_rank, q, rem, "the rank stage's shape (rank blocks)")
    _, mk = check(sp2d, v2d, b_sum, q, rem, "the rank stage's shape (prefix blocks)")
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

    times = {
        "row_rank_ge": cuda_ms(lambda: row_rank_ge(sp2d, b_rank, q), 20),
        "row_rank_ge_plain": cuda_ms(lambda: row_rank_ge_plain(sp2d, b_rank, q), 20),
        "masked_row_sum": cuda_ms(lambda: masked_row_sum(v2d, b_sum, rem), 20),
        "masked_row_sum_plain": cuda_ms(lambda: masked_row_sum_plain(v2d, b_sum, rem), 20),
    }
    print(
        f"phase kernel: row_rank_ge and masked_row_sum == plain bit for bit in "
        f"{cases} cases each, and recompose the rank stage's ranks and prefix "
        f"sums; at the rank stage's shape (sp2d ({nb}, 128), {q.shape[0]} "
        f"queries): row_rank_ge {times['row_rank_ge']:.3f} ms, plain "
        f"{times['row_rank_ge_plain']:.3f} ms; masked_row_sum "
        f"{times['masked_row_sum']:.3f} ms, plain "
        f"{times['masked_row_sum_plain']:.3f} ms [{card}]",
        flush=True,
    )
    return {"max_abs_err": max_err, **times}


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
    return launches


def build_all() -> None:
    """Build every kernel source at once: one nvcc process each."""
    from concurrent.futures import ThreadPoolExecutor

    from sqlrs_tpu_torch.utils.cuda_build import BUILD_INFO, load_kernel_library

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(load_kernel_library, KERNEL_SOURCES))
    print(f"phase build: {len(KERNEL_SOURCES)} sources in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name in KERNEL_SOURCES:
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
    k1 = phase_kernel(dev, card, len(li["l_quantity"]))
    k2 = phase_dense_kernel(dev, card, star)
    k34 = phase_rank_kernels(dev, card, star)
    hist_launches, tpch_db = phase_tpch(dev, card, li, orders, gen_s)
    launches = phase_star(dev, card, star, tpch_db, li, orders)

    def entry(name, source, replaces, launches, err, ms, plain_ms):
        return {"name": name, "route": "cuda", "source": f"sqlrs_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms}

    print(json.dumps({"kernels": [
        entry("grouped_histogram", "mxu_grouped.cu", "sqlrs_tpu/ops/mxu_grouped.py:154",
              hist_launches, k1["max_abs_err"], k1["ms"], k1["plain_ms"]),
        entry("dense_group_sums", "mxu_agg.cu", "sqlrs_tpu/ops/mxu_agg.py:64",
              launches["dense_group_sums"], k2["max_abs_err"], k2["ms"], k2["plain_ms"]),
        # no production path calls these two, as in the reference: their
        # count over the star rollup's runs stays 0
        entry("row_rank_ge", "pallas_kernels.cu", "sqlrs_tpu/ops/pallas_kernels.py:57",
              launches["row_rank_ge"], k34["max_abs_err"], k34["row_rank_ge"],
              k34["row_rank_ge_plain"]),
        entry("masked_row_sum", "pallas_kernels.cu", "sqlrs_tpu/ops/pallas_kernels.py:140",
              launches["masked_row_sum"], k34["max_abs_err"], k34["masked_row_sum"],
              k34["masked_row_sum_plain"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
