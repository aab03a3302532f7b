"""The plain reference: the 22 TPC-H queries in NumPy over the generated
columns, for any substitution parameters.

Each `oracle(qn, tables, fields)` returns the query's expected rows as a
list of tuples in the engine's output column order: floats as float,
dates as epoch-day ints, strings as str, NULL as None. It follows the
pandas oracles the repository keeps beside the JAX package, query by query,
with their joins written as key lookups (every TPC-H join here is a
foreign key into a unique key) and their GROUP BYs as sorts. It reads
nothing of the program: it computes from the numpy tables that the engine
loaded too.

Floating point: every DOUBLE column is read in the dtype the tables hold
it in, and every sum and product stays in that dtype (integer columns that
meet a double are cast to it), so `with_float(tables, np.float32)` gives
the same reference computed in float32: the control of the comparison.
"""

from __future__ import annotations

import numpy as np

_EPOCH = np.datetime64("1970-01-01", "D")


def D(s: str) -> int:
    """Days since 1970-01-01 of an ISO date."""
    return int((np.datetime64(s, "D") - _EPOCH).astype(np.int64))


def with_float(tables: dict, dtype) -> dict:
    """The tables with every float64 column cast to `dtype`."""
    return {t: {c: (a.astype(dtype) if a.dtype == np.float64 else a) for c, a in cols.items()}
            for t, cols in tables.items()}


def _ft(t) -> np.dtype:
    return t["lineitem"]["l_extendedprice"].dtype


def year(days: np.ndarray) -> np.ndarray:
    return (np.asarray(days).astype("datetime64[D]").astype("datetime64[Y]")
            .astype(np.int64) + 1970)


def lookup(keys: np.ndarray, table_keys: np.ndarray) -> np.ndarray:
    """For each key, the row of `table_keys` (unique) holding it, or -1.
    Dense non-negative integer keys (every TPC-H key) go through a table of
    positions; others through a sort."""
    keys = np.asarray(keys)
    if (table_keys.dtype.kind in "iu" and keys.dtype.kind in "iu" and len(table_keys)
            and table_keys.min() >= 0 and table_keys.max() <= 16 * len(table_keys) + (1 << 20)):
        pos = np.full(int(table_keys.max()) + 2, -1, np.int64)
        pos[table_keys] = np.arange(len(table_keys))
        return pos[np.clip(keys, -1, len(pos) - 1)]
    order = np.argsort(table_keys, kind="stable")
    srt = table_keys[order]
    pos = np.clip(np.searchsorted(srt, keys), 0, max(len(srt) - 1, 0))
    if len(srt) == 0:
        return np.full(len(keys), -1, np.int64)
    return np.where(srt[pos] == keys, order[pos], -1)


def like(a: np.ndarray, pattern: str) -> np.ndarray:
    """SQL LIKE for patterns of '%'-separated literal parts with at most
    two parts between the first and the last '%' (every TPC-H pattern)."""
    parts = pattern.split("%")
    if "_" in pattern or len(parts) > 4:
        raise ValueError(f"LIKE pattern {pattern!r} is outside what this oracle reads")
    a = np.asarray(a)
    if len(parts) == 1:
        return a == pattern
    head, mid, tail = parts[0], parts[1:-1], parts[-1]
    ok = np.char.startswith(a, head) if head else np.ones(len(a), bool)
    if tail:
        ok &= np.char.endswith(a, tail)
    mid = [m for m in mid if m]
    if len(mid) == 1:
        ok &= np.char.find(a, mid[0]) >= 0
    elif len(mid) == 2:
        # some first part before some second part: the first part's first
        # place and the second's last (prefix and suffix take no room here:
        # every pattern with two inner parts has neither)
        if head or tail:
            raise ValueError(f"LIKE pattern {pattern!r} is outside what this oracle reads")
        i = np.char.find(a, mid[0])
        j = np.char.rfind(a, mid[1])
        ok &= (i >= 0) & (j >= i + len(mid[0]))
    return ok


def _codes(a: np.ndarray) -> np.ndarray:
    """Keys that sort as `a` does: one-character strings as their code
    points (a fast numeric sort), everything else as it is."""
    a = np.asarray(a)
    if a.dtype.kind == "U" and a.dtype.itemsize == 4:
        return a.view(np.uint32)
    return a


class Groups:
    """GROUP BY over key columns: groups in ascending key order (the first
    key most significant), each row's group, and per-group reductions in
    the values' own dtype."""

    def __init__(self, *keys: np.ndarray) -> None:
        if len(keys) == 1:
            combined = _codes(keys[0])
        else:
            combined = np.zeros(len(keys[0]), np.int64)
            for k in keys:
                uniq, inv = np.unique(_codes(k), return_inverse=True)
                combined = combined * max(len(uniq), 1) + inv.reshape(-1)
        uniq, first, inv = np.unique(combined, return_index=True, return_inverse=True)
        self.n = len(uniq)
        self.first = first
        self.inv = inv.reshape(-1)
        self._order = None

    def key(self, a: np.ndarray) -> np.ndarray:
        return np.asarray(a)[self.first]

    def _sorted(self):
        if self._order is None:
            self._order = np.argsort(self.inv, kind="stable")
            self._starts = np.searchsorted(self.inv[self._order], np.arange(self.n))
        return self._order, self._starts

    def _reduce(self, ufunc, v: np.ndarray) -> np.ndarray:
        if self.n == 0:
            return np.zeros(0, v.dtype)
        order, starts = self._sorted()
        return ufunc.reduceat(v[order], starts)

    def sum(self, v: np.ndarray) -> np.ndarray:
        v = np.asarray(v)
        if v.dtype == np.float64:
            return np.bincount(self.inv, weights=v, minlength=self.n)
        return self._reduce(np.add, v)

    def count(self) -> np.ndarray:
        return np.bincount(self.inv, minlength=self.n).astype(np.int64)

    def min(self, v: np.ndarray) -> np.ndarray:
        return self._reduce(np.minimum, np.asarray(v))

    def max(self, v: np.ndarray) -> np.ndarray:
        return self._reduce(np.maximum, np.asarray(v))

    def nunique(self, v: np.ndarray) -> np.ndarray:
        uniq, code = np.unique(_codes(v), return_inverse=True)
        pairs = np.unique(self.inv * max(len(uniq), 1) + code.reshape(-1))
        return np.bincount(pairs // max(len(uniq), 1), minlength=self.n).astype(np.int64)


def rank(a: np.ndarray) -> np.ndarray:
    """Each value's rank in ascending order (equal values, equal ranks)."""
    return np.unique(a, return_inverse=True)[1].reshape(-1)


def order(*keys) -> np.ndarray:
    """Row order by (array, descending) keys, the first most significant;
    ties keep their input order."""
    cols = []
    for a, desc in reversed(keys):
        r = rank(a) if np.asarray(a).dtype.kind in "US" else np.asarray(a)
        cols.append(-r if desc else r)
    if not cols or len(cols[0]) == 0:
        return np.zeros(0, np.int64)
    return np.lexsort(cols)


def rows(*cols) -> list[tuple]:
    out = []
    for c in cols:
        c = np.asarray(c)
        if c.dtype.kind == "f":
            out.append([float(x) for x in c])
        elif c.dtype.kind in "iu":
            out.append([int(x) for x in c])
        else:
            out.append([str(x) for x in c])
    return list(zip(*out)) if out else []


def _scalar(v, n: int):
    """A SUM over n rows: NULL over none."""
    return [(None,)] if n == 0 else [(float(v),)]


# ---- the queries -----------------------------------------------------------

def q1(t, p):
    li = t["lineitem"]
    m = li["l_shipdate"] <= D(p["D1"])
    ft = _ft(t)
    qty = li["l_quantity"][m]
    price = li["l_extendedprice"][m]
    disc = li["l_discount"][m]
    tax = li["l_tax"][m]
    g = Groups(li["l_returnflag"][m], li["l_linestatus"][m])
    dp = price * (1 - disc)
    cnt = g.count()
    return rows(g.key(li["l_returnflag"][m]), g.key(li["l_linestatus"][m]), g.sum(qty),
                g.sum(price), g.sum(dp), g.sum(dp * (1 + tax)),
                g.sum(qty.astype(ft)) / cnt, g.sum(price) / cnt, g.sum(disc) / cnt, cnt)


def q2(t, p):
    ps, s, n, r, pa = t["partsupp"], t["supplier"], t["nation"], t["region"], t["part"]
    s_row = lookup(ps["ps_suppkey"], s["s_suppkey"])
    n_row = lookup(s["s_nationkey"][s_row], n["n_nationkey"])
    r_row = lookup(n["n_regionkey"][n_row], r["r_regionkey"])
    inreg = r["r_name"][r_row] == p["REGION"]
    cost = ps["ps_supplycost"]
    g = Groups(ps["ps_partkey"][inreg])
    minc_keys = g.key(ps["ps_partkey"][inreg])
    p_row = lookup(ps["ps_partkey"], pa["p_partkey"])
    want = (pa["p_size"] == int(p["SIZE"])) & np.char.endswith(pa["p_type"], p["TYPE"])
    m = inreg & want[p_row]
    mins = g.min(cost[inreg])
    best = mins[lookup(ps["ps_partkey"][m], minc_keys)]
    m_idx = np.flatnonzero(m)[cost[m] == best]
    sr, nr, pr = s_row[m_idx], n_row[m_idx], p_row[m_idx]
    o = order((s["s_acctbal"][sr], True), (n["n_name"][nr], False),
              (s["s_name"][sr], False), (pa["p_partkey"][pr], False))[:100]
    sr, nr, pr = sr[o], nr[o], pr[o]
    return rows(s["s_acctbal"][sr], s["s_name"][sr], n["n_name"][nr], pa["p_partkey"][pr],
                pa["p_mfgr"][pr], s["s_address"][sr], s["s_phone"][sr], s["s_comment"][sr])


def q3(t, p):
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    day = D(p["DATE"])
    lm = li["l_shipdate"] > day
    o_row = lookup(li["l_orderkey"][lm], o["o_orderkey"])
    c_row = lookup(o["o_custkey"][o_row], c["c_custkey"])
    m = (o["o_orderdate"][o_row] < day) & (c["c_mktsegment"][c_row] == p["SEGMENT"])
    okey = li["l_orderkey"][lm][m]
    rev = (li["l_extendedprice"][lm] * (1 - li["l_discount"][lm]))[m]
    g = Groups(okey)
    orow = o_row[m][g.first]
    sums = g.sum(rev)
    k = order((sums, True), (o["o_orderdate"][orow], False))[:10]
    return rows(g.key(okey)[k], sums[k], o["o_orderdate"][orow][k],
                o["o_shippriority"][orow][k])


def q4(t, p):
    o, li = t["orders"], t["lineitem"]
    m = (o["o_orderdate"] >= D(p["DATE"])) & (o["o_orderdate"] < D(p["DATE_END"]))
    late = np.unique(li["l_orderkey"][li["l_commitdate"] < li["l_receiptdate"]])
    sel = m & np.isin(o["o_orderkey"], late)
    g = Groups(o["o_orderpriority"][sel])
    return rows(g.key(o["o_orderpriority"][sel]), g.count())


def q5(t, p):
    c, o, li, s, n, r = (t[k] for k in ("customer", "orders", "lineitem", "supplier",
                                         "nation", "region"))
    o_row = lookup(li["l_orderkey"], o["o_orderkey"])
    od = o["o_orderdate"][o_row]
    m = (od >= D(p["DATE"])) & (od < D(p["DATE_END"]))
    o_row = o_row[m]
    c_row = lookup(o["o_custkey"][o_row], c["c_custkey"])
    s_row = lookup(li["l_suppkey"][m], s["s_suppkey"])
    same = c["c_nationkey"][c_row] == s["s_nationkey"][s_row]
    n_row = lookup(s["s_nationkey"][s_row], n["n_nationkey"])
    r_row = lookup(n["n_regionkey"][n_row], r["r_regionkey"])
    keep = same & (r["r_name"][r_row] == p["REGION"])
    rev = (li["l_extendedprice"][m] * (1 - li["l_discount"][m]))[keep]
    names = n["n_name"][n_row][keep]
    g = Groups(names)
    sums = g.sum(rev)
    k = order((sums, True))
    return rows(g.key(names)[k], sums[k])


def q6(t, p):
    li = t["lineitem"]
    lo, hi = float(p["DISC_LO"]), float(p["DISC_HI"])
    disc = li["l_discount"]
    m = ((li["l_shipdate"] >= D(p["DATE"])) & (li["l_shipdate"] < D(p["DATE_END"]))
         & (disc >= disc.dtype.type(lo)) & (disc <= disc.dtype.type(hi))
         & (li["l_quantity"] < int(p["QUANTITY"])))
    return _scalar((li["l_extendedprice"][m] * disc[m]).sum(), int(m.sum()))


def q7(t, p):
    li, s, o, c, n = (t[k] for k in ("lineitem", "supplier", "orders", "customer", "nation"))
    m = (li["l_shipdate"] >= D("1995-01-01")) & (li["l_shipdate"] <= D("1996-12-31"))
    s_row = lookup(li["l_suppkey"][m], s["s_suppkey"])
    o_row = lookup(li["l_orderkey"][m], o["o_orderkey"])
    c_row = lookup(o["o_custkey"][o_row], c["c_custkey"])
    sn = n["n_name"][lookup(s["s_nationkey"][s_row], n["n_nationkey"])]
    cn = n["n_name"][lookup(c["c_nationkey"][c_row], n["n_nationkey"])]
    a, b = p["NATION1"], p["NATION2"]
    keep = ((sn == a) & (cn == b)) | ((sn == b) & (cn == a))
    yr = year(li["l_shipdate"][m][keep])
    vol = (li["l_extendedprice"][m] * (1 - li["l_discount"][m]))[keep]
    sn, cn = sn[keep], cn[keep]
    g = Groups(sn, cn, yr)
    return rows(g.key(sn), g.key(cn), g.key(yr), g.sum(vol))


def q8(t, p):
    pa, li, s, o, c, n, r = (t[k] for k in ("part", "lineitem", "supplier", "orders",
                                             "customer", "nation", "region"))
    p_row = lookup(li["l_partkey"], pa["p_partkey"])
    m = pa["p_type"][p_row] == p["TYPE"]
    o_row = lookup(li["l_orderkey"][m], o["o_orderkey"])
    od = o["o_orderdate"][o_row]
    m2 = (od >= D("1995-01-01")) & (od <= D("1996-12-31"))
    o_row = o_row[m2]
    c_row = lookup(o["o_custkey"][o_row], c["c_custkey"])
    n1 = lookup(c["c_nationkey"][c_row], n["n_nationkey"])
    reg = r["r_name"][lookup(n["n_regionkey"][n1], r["r_regionkey"])]
    keep = reg == p["REGION"]
    lsel = np.flatnonzero(m)[m2][keep]
    s_row = lookup(li["l_suppkey"][lsel], s["s_suppkey"])
    nation = n["n_name"][lookup(s["s_nationkey"][s_row], n["n_nationkey"])]
    vol = li["l_extendedprice"][lsel] * (1 - li["l_discount"][lsel])
    yr = year(o["o_orderdate"][o_row][keep])
    g = Groups(yr)
    own = np.where(nation == p["NATION"], vol, vol.dtype.type(0))
    return rows(g.key(yr), g.sum(own) / g.sum(vol))


def q9(t, p):
    pa, li, s, ps, o, n = (t[k] for k in ("part", "lineitem", "supplier", "partsupp",
                                           "orders", "nation"))
    green = like(pa["p_name"], f"%{p['COLOR']}%")
    m = green[lookup(li["l_partkey"], pa["p_partkey"])]
    lp, ls = li["l_partkey"][m], li["l_suppkey"][m]
    span = int(max(ps["ps_suppkey"].max(), ls.max() if len(ls) else 0)) + 1
    ps_row = lookup(lp * span + ls, ps["ps_partkey"] * span + ps["ps_suppkey"])
    s_row = lookup(ls, s["s_suppkey"])
    o_row = lookup(li["l_orderkey"][m], o["o_orderkey"])
    nation = n["n_name"][lookup(s["s_nationkey"][s_row], n["n_nationkey"])]
    yr = year(o["o_orderdate"][o_row])
    ft = _ft(t)
    amount = (li["l_extendedprice"][m] * (1 - li["l_discount"][m])
              - ps["ps_supplycost"][ps_row] * li["l_quantity"][m].astype(ft))
    g = Groups(nation, yr)
    sums = g.sum(amount)
    k = order((g.key(nation), False), (g.key(yr), True))
    return rows(g.key(nation)[k], g.key(yr)[k], sums[k])


def q10(t, p):
    c, o, li, n = (t[k] for k in ("customer", "orders", "lineitem", "nation"))
    lm = li["l_returnflag"] == "R"
    o_row = lookup(li["l_orderkey"][lm], o["o_orderkey"])
    od = o["o_orderdate"][o_row]
    m = (od >= D(p["DATE"])) & (od < D(p["DATE_END"]))
    c_row = lookup(o["o_custkey"][o_row[m]], c["c_custkey"])
    rev = (li["l_extendedprice"][lm] * (1 - li["l_discount"][lm]))[m]
    g = Groups(c["c_custkey"][c_row])
    crow = c_row[g.first]
    sums = g.sum(rev)
    k = order((sums, True))[:20]
    crow = crow[k]
    nn = n["n_name"][lookup(c["c_nationkey"][crow], n["n_nationkey"])]
    return rows(c["c_custkey"][crow], c["c_name"][crow], sums[k], c["c_acctbal"][crow], nn,
                c["c_address"][crow], c["c_phone"][crow], c["c_comment"][crow])


def q11(t, p):
    ps, s, n = t["partsupp"], t["supplier"], t["nation"]
    s_row = lookup(ps["ps_suppkey"], s["s_suppkey"])
    nat = n["n_name"][lookup(s["s_nationkey"][s_row], n["n_nationkey"])]
    m = nat == p["NATION"]
    ft = _ft(t)
    v = ps["ps_supplycost"][m] * ps["ps_availqty"][m].astype(ft)
    thresh = v.sum() * ft.type(float(p["FRACTION"]))
    g = Groups(ps["ps_partkey"][m])
    sums = g.sum(v)
    keys = g.key(ps["ps_partkey"][m])
    keep = sums > thresh
    sums, keys = sums[keep], keys[keep]
    k = order((sums, True))
    return rows(keys[k], sums[k])


def q12(t, p):
    o, li = t["orders"], t["lineitem"]
    modes = (p["SHIPMODE1"], p["SHIPMODE2"])
    m = (np.isin(li["l_shipmode"], modes)
         & (li["l_commitdate"] < li["l_receiptdate"]) & (li["l_shipdate"] < li["l_commitdate"])
         & (li["l_receiptdate"] >= D(p["DATE"])) & (li["l_receiptdate"] < D(p["DATE_END"])))
    pri = o["o_orderpriority"][lookup(li["l_orderkey"][m], o["o_orderkey"])]
    hi = np.isin(pri, ["1-URGENT", "2-HIGH"]).astype(np.int64)
    mode = li["l_shipmode"][m]
    g = Groups(mode)
    return rows(g.key(mode), g.sum(hi), g.sum(1 - hi))


def q13(t, p):
    c, o = t["customer"], t["orders"]
    keep = ~like(o["o_comment"], f"%{p['WORD1']}%{p['WORD2']}%")
    c_row = lookup(o["o_custkey"][keep], c["c_custkey"])
    per_cust = np.bincount(c_row[c_row >= 0], minlength=len(c["c_custkey"])).astype(np.int64)
    g = Groups(per_cust)
    counts = g.count()
    k = order((counts, True), (g.key(per_cust), True))
    return rows(g.key(per_cust)[k], counts[k])


def q14(t, p):
    li, pa = t["lineitem"], t["part"]
    m = (li["l_shipdate"] >= D(p["DATE"])) & (li["l_shipdate"] < D(p["DATE_END"]))
    promo = np.char.startswith(pa["p_type"], "PROMO")[lookup(li["l_partkey"][m],
                                                              pa["p_partkey"])]
    rev = li["l_extendedprice"][m] * (1 - li["l_discount"][m])
    if not m.any():
        return [(None,)]
    ft = rev.dtype.type
    return [(float(ft(100.0) * np.where(promo, rev, ft(0)).sum() / rev.sum()),)]


def q15(t, p):
    li, s = t["lineitem"], t["supplier"]
    m = (li["l_shipdate"] >= D(p["DATE"])) & (li["l_shipdate"] < D(p["DATE_END"]))
    rev = li["l_extendedprice"][m] * (1 - li["l_discount"][m])
    g = Groups(li["l_suppkey"][m])
    sums = g.sum(rev)
    keys = g.key(li["l_suppkey"][m])
    if len(sums) == 0:
        return []
    top = sums == sums.max()
    srow = lookup(keys[top], s["s_suppkey"])
    k = order((s["s_suppkey"][srow], False))
    srow = srow[k]
    return rows(s["s_suppkey"][srow], s["s_name"][srow], s["s_address"][srow],
                s["s_phone"][srow], sums[top][k])


def q16(t, p):
    ps, pa, s = t["partsupp"], t["part"], t["supplier"]
    sizes = [int(x) for x in p["SIZES"].split(",")]
    pm = ((pa["p_brand"] != p["BRAND"]) & ~np.char.startswith(pa["p_type"], p["TYPE"])
          & np.isin(pa["p_size"], sizes))
    bad = s["s_suppkey"][like(s["s_comment"], "%Customer%Complaints%")]
    p_row = lookup(ps["ps_partkey"], pa["p_partkey"])
    m = pm[p_row] & ~np.isin(ps["ps_suppkey"], bad)
    pr = p_row[m]
    brand, typ, size = pa["p_brand"][pr], pa["p_type"][pr], pa["p_size"][pr]
    g = Groups(brand, typ, size)
    cnt = g.nunique(ps["ps_suppkey"][m])
    kb, kt, ks = g.key(brand), g.key(typ), g.key(size)
    k = order((cnt, True), (kb, False), (kt, False), (ks, False))
    return rows(kb[k], kt[k], ks[k], cnt[k])


def q17(t, p):
    li, pa = t["lineitem"], t["part"]
    ft = _ft(t)
    g = Groups(li["l_partkey"])
    avg = g.sum(li["l_quantity"].astype(ft)) / g.count()
    thresh = ft.type(0.2) * avg[g.inv]
    want = (pa["p_brand"] == p["BRAND"]) & (pa["p_container"] == p["CONTAINER"])
    m = want[lookup(li["l_partkey"], pa["p_partkey"])] & (li["l_quantity"] < thresh)
    if not m.any():
        return [(None,)]
    return [(float(li["l_extendedprice"][m].sum() / ft.type(7.0)),)]


def q18(t, p):
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    g = Groups(li["l_orderkey"])
    qty = g.sum(li["l_quantity"])
    big = g.key(li["l_orderkey"])[qty > int(p["QUANTITY"])]
    o_row = lookup(big, o["o_orderkey"])
    o_row = o_row[o_row >= 0]
    c_row = lookup(o["o_custkey"][o_row], c["c_custkey"])
    keep = c_row >= 0
    o_row, c_row = o_row[keep], c_row[keep]
    sq = qty[lookup(o["o_orderkey"][o_row], g.key(li["l_orderkey"]))]
    k = order((o["o_totalprice"][o_row], True), (o["o_orderdate"][o_row], False))[:100]
    o_row, c_row, sq = o_row[k], c_row[k], sq[k]
    return rows(c["c_name"][c_row], c["c_custkey"][c_row], o["o_orderkey"][o_row],
                o["o_orderdate"][o_row], o["o_totalprice"][o_row], sq)


def q19(t, p):
    li, pa = t["lineitem"], t["part"]
    lm = (np.isin(li["l_shipmode"], ["AIR", "AIR REG"])
          & (li["l_shipinstruct"] == "DELIVER IN PERSON"))
    pr = lookup(li["l_partkey"][lm], pa["p_partkey"])
    brand, cont, size = pa["p_brand"][pr], pa["p_container"][pr], pa["p_size"][pr]
    q = li["l_quantity"][lm]
    hit = np.zeros(len(pr), bool)
    for i, (kind, top) in enumerate((("SM", 5), ("MED", 10), ("LG", 15)), start=1):
        conts = [f"{kind} {x}" for x in (("CASE", "BOX", "PACK", "PKG") if kind != "MED"
                                          else ("BAG", "BOX", "PKG", "PACK"))]
        lo = int(p[f"QUANTITY{i}"])
        hit |= ((brand == p[f"BRAND{i}"]) & np.isin(cont, conts) & (q >= lo)
                & (q <= lo + 10) & (size >= 1) & (size <= top))
    rev = (li["l_extendedprice"][lm] * (1 - li["l_discount"][lm]))[hit]
    return _scalar(rev.sum(), int(hit.sum()))


def q20(t, p):
    pa, ps, li, s, n = (t[k] for k in ("part", "partsupp", "lineitem", "supplier", "nation"))
    forest = np.char.startswith(pa["p_name"], p["COLOR"])
    lm = (li["l_shipdate"] >= D(p["DATE"])) & (li["l_shipdate"] < D(p["DATE_END"]))
    span = int(max(ps["ps_suppkey"].max(), li["l_suppkey"].max())) + 1
    lkey = li["l_partkey"][lm] * span + li["l_suppkey"][lm]
    g = Groups(lkey)
    half = 0.5 * g.sum(li["l_quantity"][lm])
    ps_ok = forest[lookup(ps["ps_partkey"], pa["p_partkey"])]
    pkey = ps["ps_partkey"] * span + ps["ps_suppkey"]
    at = lookup(pkey, g.key(lkey)) if g.n else np.full(len(pkey), -1)
    has = at >= 0
    ok = ps_ok & has & (ps["ps_availqty"] > np.where(has, half[np.maximum(at, 0)] if g.n else 0, 0))
    supp = np.unique(ps["ps_suppkey"][ok])
    nat = n["n_name"][lookup(s["s_nationkey"], n["n_nationkey"])]
    m = np.isin(s["s_suppkey"], supp) & (nat == p["NATION"])
    k = order((s["s_name"][m], False))
    return rows(s["s_name"][m][k], s["s_address"][m][k])


def q21(t, p):
    s, li, o, n = t["supplier"], t["lineitem"], t["orders"], t["nation"]
    okey, skey = li["l_orderkey"], li["l_suppkey"]
    late = li["l_receiptdate"] > li["l_commitdate"]
    g_all = Groups(okey)
    nsup = g_all.nunique(skey)
    g_late = Groups(okey[late])
    nsup_late = g_late.nunique(skey[late])
    ns = nsup[g_all.inv]
    at = lookup(okey, g_late.key(okey[late]))
    nl = np.where(at >= 0, nsup_late[np.maximum(at, 0)], 0)
    status = o["o_orderstatus"][lookup(okey, o["o_orderkey"])]
    s_row = lookup(skey, s["s_suppkey"])
    nat = n["n_name"][lookup(s["s_nationkey"][s_row], n["n_nationkey"])]
    # a late line of an order with another supplier, and no other late one
    m = late & (status == "F") & (nat == p["NATION"]) & (ns > 1) & (nl == 1)
    names = s["s_name"][s_row[m]]
    g = Groups(names)
    cnt = g.count()
    k = order((cnt, True), (g.key(names), False))[:100]
    return rows(g.key(names)[k], cnt[k])


def q22(t, p):
    c, o = t["customer"], t["orders"]
    codes = [x.strip().strip("'") for x in p["CODES"].split(",")]
    cc = c["c_phone"].astype("U2")
    base = np.isin(cc, codes)
    bal = c["c_acctbal"]
    pos = base & (bal > 0.0)
    avg = bal[pos].sum() / bal.dtype.type(int(pos.sum()))
    sel = base & (bal > avg) & ~np.isin(c["c_custkey"], o["o_custkey"])
    g = Groups(cc[sel])
    return rows(g.key(cc[sel]), g.count(), g.sum(bal[sel]))


ORACLES = {i: globals()[f"q{i}"] for i in range(1, 23)}


def oracle(qn: int, tables: dict, fields: dict) -> list[tuple]:
    """Query qn's expected rows over `tables` with these fields."""
    return ORACLES[qn](tables, fields)
