"""Smoke run of sqlrs_tpu_torch on one NVIDIA GPU: build, kernel check, and
TPC-H Q1/Q6 at scale factor 1 through `Database(device="cuda").run`.

    python3 chip_smoke.py

Phases, each printing one line:
  1. build    — nvcc builds every kernel of the path from sqlrs_tpu_torch/csrc/
                into build/kernels/ (the time includes nvcc).
  2. kernel   — each kernel against its plain PyTorch version on the card, on
                inputs made from a seed with numpy, at small and ragged
                shapes and at the row count of the SF1 table; integer results
                must be equal bit for bit (tolerance 0). Times are medians of
                CUDA-event timings at the shape TPC-H Q1 gives the kernel.
  3. tpch_sf1 — lineitem's Q1/Q6 columns at SF1 (about 6.0M rows, made with
                numpy by the TPC-H rules), loaded into the port and queried:
                one cold run, three warm runs. Results are checked against a
                numpy oracle (counts and sum_qty exactly, other values to
                rel 1e-9), and Q1 must have gone through the kernel.

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


# ---- phase 3: TPC-H Q1/Q6 at SF1 -------------------------------------------


def gen_lineitem(seed: int):
    """lineitem's Q1/Q6 columns at SF1 by the TPC-H rules (spec §4.2.3), as
    benchmarks/tpch_dbgen.py applies them: 1-7 lines per order, quantity
    1-50, discount 0.00-0.10, tax 0.00-0.08, extendedprice = quantity x
    p_retailprice, ship date 1-121 days after the order date, receipt date
    1-30 days after shipping, returnflag R/A if received by CURRENTDATE else
    N, linestatus O if shipped after CURRENTDATE else F."""
    from sqlrs_tpu_torch.types.values import date_str_to_days

    rng = np.random.default_rng(seed)
    O, P = SF1_ORDERS, SF1_PARTS
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
    return {
        "l_quantity": qty.astype(np.int64),
        "l_extendedprice": price,
        "l_discount": disc,
        "l_tax": tax,
        "l_returnflag": rflag,
        "l_linestatus": lstatus,
        "l_shipdate": ship.astype(np.int32),
    }


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


def phase_tpch(dev, card: str, li: dict, gen_s: float) -> int:
    import sqlrs_tpu_torch
    from sqlrs_tpu_torch.ops.mxu_grouped import grouped_histogram
    from sqlrs_tpu_torch.types import LogicalType as LT

    t0 = time.perf_counter()
    n = len(li["l_quantity"])
    types = {
        "l_quantity": LT.BIGINT, "l_extendedprice": LT.DOUBLE,
        "l_discount": LT.DOUBLE, "l_tax": LT.DOUBLE,
        "l_returnflag": LT.VARCHAR, "l_linestatus": LT.VARCHAR,
        "l_shipdate": LT.DATE,
    }
    db = sqlrs_tpu_torch.Database(device=dev)
    db.create_memory_table_numpy(
        "lineitem", [(c, types[c]) for c in li], [li[c] for c in li]
    )
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
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import sqlrs_tpu_torch  # noqa: F401  (fails outside the repository)
    from sqlrs_tpu_torch.utils.cuda_build import BUILD_INFO, load_kernel_library

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}", flush=True)

    t0 = time.perf_counter()
    load_kernel_library("mxu_grouped")
    info = BUILD_INFO["mxu_grouped"]
    ptxas = [ln.strip() for ln in info["log"].splitlines() if "ptxas info" in ln]
    print(
        f"phase build: mxu_grouped.cu in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {info['seconds']:.2f} s); {' | '.join(ptxas)}",
        flush=True,
    )

    t0 = time.perf_counter()
    li = gen_lineitem(SEED)
    gen_s = time.perf_counter() - t0
    k = phase_kernel(dev, card, len(li["l_quantity"]))
    launches = phase_tpch(dev, card, li, gen_s)

    print(json.dumps({"kernels": [{
        "name": "grouped_histogram",
        "route": "cuda",
        "source": "sqlrs_tpu_torch/csrc/mxu_grouped.cu",
        "replaces": "sqlrs_tpu/ops/mxu_grouped.py:154",
        "launches": launches,
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
