"""TPC-H data generator (dbgen-faithful, vectorized numpy).

Replaces round 1's "dbgen-lite": all 8 tables with their FULL column sets
and the spec's distributions (TPC-H v3 §4.2.2-4.2.3; the reference only
scaffolds the real dbgen via `make tpch`, reference Makefile:46-70):

- row counts: supplier 10K·SF, part 200K·SF, partsupp 4/part,
  customer 150K·SF, orders 1.5M·SF (sparse keys, 8 of every 32),
  lineitem 1-7 per order (≈6M·SF);
- o_custkey skips every custkey divisible by 3 (⅓ of customers have no
  orders — Q13/Q22 depend on this);
- ps_suppkey spreads each part over 4 suppliers with the spec's formula;
- l_extendedprice = quantity · p_retailprice (spec price formula);
- ship/commit/receipt dates hang off o_orderdate with the spec offsets;
  returnflag/linestatus derive from the 1995-06-17 currentdate;
- o_orderstatus / o_totalprice derive from the order's lineitems;
- comment text is a vectorized word soup with the query-relevant patterns
  injected at spec rates: 'special … requests' in o_comment (Q13),
  'Customer … Complaints' in s_comment (Q16); p_name draws from the color
  word list ('forest…' prefix for Q20, '…green…' for Q9).

Everything is generated as numpy columns, so the per-query oracles
(perfbench/reference/tpch_oracle.py) compute from the same arrays the
engine loads.

The benchmark's frozen copy of sqlrs_tpu_torch/benchmarks/tpch_dbgen.py's
`gen_tables`: it draws the same random numbers in the same order and gives
equal arrays (values and dtypes) for the same scale factor and seed, but
builds the text columns in one pass each (`_join_words` writes each row's
words into a byte matrix, one vectorised copy per word slot, where the
original adds one `np.char.add` column at a time), derives the order totals
with `np.bincount` (the same sequential sums as `np.add.at`), and computes
dates with numpy's calendar. It imports nothing of the program.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

CURRENTDATE = "1995-06-17"

NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
SHIPINSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_S1 = ["SM", "MED", "LG", "JUMBO", "WRAP"]
CONTAINER_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]

# TPC-H p_name color words (spec appendix) — 'forest' (Q20) and 'green'
# (Q9) included
P_NAME_WORDS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished", "chartreuse",
    "chiffon", "chocolate", "coral", "cornflower", "cornsilk", "cream", "cyan",
    "dark", "deep", "dim", "dodger", "drab", "firebrick", "floral", "forest",
    "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
    "hot", "indian", "ivory", "khaki", "lace", "lavender", "lawn", "lemon",
    "light", "lime", "linen", "magenta", "maroon", "medium", "metallic",
    "midnight", "mint", "misty", "moccasin", "navajo", "navy", "olive", "orange",
    "orchid", "pale", "papaya", "peach", "peru", "pink", "plum", "powder",
    "puff", "purple", "red", "rose", "rosy", "royal", "saddle", "salmon",
    "sandy", "seashell", "sienna", "sky", "slate", "smoke", "snow", "spring",
    "steel", "tan", "thistle", "tomato", "turquoise", "violet", "wheat",
    "white", "yellow",
]

# comment vocabulary (TPC-H grammar words, minus the injected pattern words)
_COMMENT_WORDS = [
    "packages", "carefully", "quickly", "slyly", "furiously", "blithely",
    "deposits", "instructions", "accounts", "foxes", "pinto", "beans",
    "theodolites", "dependencies", "excuses", "platelets", "asymptotes",
    "courts", "dolphins", "multipliers", "sauternes", "warthogs", "frets",
    "dinos", "attainments", "somas", "Tiresias", "patterns", "forges",
    "braids", "hockey", "players", "frays", "warhorses", "dugouts",
    "notornis", "epitaphs", "pearls", "tithes", "waters", "orbits",
    "gifts", "sheaves", "depths", "sentiments", "decoys", "realms", "pains",
    "grouches", "escapades", "sleep", "wake", "haggle", "nag", "use", "boost",
    "affix", "detect", "integrate", "cajole", "across", "against", "along",
    "among", "around", "at", "atop", "beside", "besides", "between", "beyond",
    "by", "despite", "during", "except", "final", "ironic", "even", "bold",
    "brave", "daring", "express", "regular", "special-case",
]


_EPOCH = np.datetime64("1970-01-01", "D")
_CHUNK = 1 << 19  # rows a block of _join_words builds at once
_THREADS = 4  # blocks built at once


def _date(s: str) -> int:
    """Days since 1970-01-01 of an ISO date (proleptic Gregorian)."""
    return int((np.datetime64(s, "D") - _EPOCH).astype(np.int64))


def _join_words(words: np.ndarray, idx: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Row i is " ".join(words[idx[i, :counts[i]]]), as a 'U' array of the
    width that concatenating idx.shape[1] word columns with spaces gives.

    Each row is written into a byte matrix with room for one word more than
    it holds; word slot j of every row is one vectorised copy of a padded
    word (its leading space, its bytes, zeros after) to the row's current
    end, through a view that sees a word-sized item at every byte offset.
    The zeros a copy leaves after its word are overwritten by the next
    word or are the row's padding. Blocks of rows are built on a few
    threads (numpy's copies release the interpreter lock)."""
    n, k = idx.shape
    wmax = words.dtype.itemsize // 4
    width = k * wmax + k - 1
    enc = [w.encode("ascii") for w in words.tolist()]
    lens = np.array([len(b) for b in enc], dtype=np.int64)
    pad = np.zeros((len(enc), wmax + 1), np.uint8)
    pad[:, 0] = ord(" ")
    for i, b in enumerate(enc):
        pad[i, 1:1 + len(b)] = np.frombuffer(b, np.uint8)
    item = np.dtype(f"V{wmax + 1}")
    pad_v = pad.view(item).ravel()
    stride = width + wmax + 2
    out = np.empty(n, f"U{width}")

    def block(lo: int) -> None:
        hi = min(lo + _CHUNK, n)
        m = hi - lo
        buf = np.zeros(m * stride + wmax + 1, np.uint8)
        slots = np.ndarray((len(buf) - wmax,), dtype=item, buffer=buf, strides=(1,))
        base = np.arange(m, dtype=np.int64) * stride
        ix, cnt = idx[lo:hi], counts[lo:hi]
        # a row's text starts at byte 1 of its stretch: slot 0's leading
        # space lands in byte 0, outside the text
        slots[base] = pad_v[ix[:, 0]]
        end = base + 1 + lens[ix[:, 0]]
        for j in range(1, k):
            act = np.flatnonzero(cnt > j)
            w = ix[act, j]
            slots[end[act]] = pad_v[w]
            end[act] += lens[w] + 1
        rows = buf[: m * stride].reshape(m, stride)[:, 1:1 + width]
        out[lo:hi] = rows.astype(np.uint32).view(f"U{width}").ravel()

    starts = range(0, n, _CHUNK)
    if n <= _CHUNK:
        for lo in starts:
            block(lo)
    else:
        with ThreadPoolExecutor(_THREADS) as pool:
            for fut in [pool.submit(block, lo) for lo in starts]:
                fut.result()
    return out


def _word_soup(rng, n: int, min_words: int, max_words: int) -> np.ndarray:
    """n random comments: up to max_words words of the comment vocabulary,
    at least min_words, joined by spaces."""
    words = np.array(_COMMENT_WORDS)
    idx = rng.integers(0, len(words), (n, max_words))
    counts = rng.integers(min_words, max_words + 1, n)
    return _join_words(words, idx, counts)


def _inject(rng, comments: np.ndarray, rows: np.ndarray, w1: str, w2: str) -> None:
    """Overwrite comments[rows] with '<pre> w1 <mid> w2 <post>' so that
    LIKE '%w1%w2%' matches exactly those rows (vocabulary excludes w1/w2)."""
    words = np.array(_COMMENT_WORDS)
    m = len(rows)
    if m == 0:
        return
    pre = words[rng.integers(0, len(words), m)]
    mid = words[rng.integers(0, len(words), m)]
    post = words[rng.integers(0, len(words), m)]
    txt = pre
    for part in (np.full(m, w1), mid, np.full(m, w2), post):
        txt = np.char.add(np.char.add(txt, " "), part)
    comments[rows] = txt


def _phones(rng, nationkeys: np.ndarray) -> np.ndarray:
    n = len(nationkeys)
    cc = np.char.add((nationkeys + 10).astype("U2"), "-")
    p1 = rng.integers(100, 1000, n).astype("U3")
    p2 = rng.integers(100, 1000, n).astype("U3")
    p3 = rng.integers(1000, 10000, n).astype("U4")
    out = cc
    for part, sep in ((p1, "-"), (p2, "-"), (p3, "")):
        out = np.char.add(np.char.add(out, part), sep)
    return out


def _numbered(prefix: str, keys: np.ndarray) -> np.ndarray:
    """prefix + the key in nine digits, zero-filled (keys below 10^9)."""
    n = len(keys)
    head = np.frombuffer(prefix.encode("ascii"), np.uint8)
    width = len(head) + 9
    m = np.empty((n, width), np.uint8)
    m[:, : len(head)] = head
    k = np.asarray(keys, np.int64)
    for p in range(9):
        m[:, width - 1 - p] = ord("0") + (k // 10**p) % 10
    return m.view(f"S{width}").ravel().astype(f"U{width}")


def gen_tables(sf: float, seed: int = 0) -> dict:
    """All 8 TPC-H tables as {table: {column: np.ndarray}}."""
    rng = np.random.default_rng(seed)
    S = max(int(10_000 * sf), 10)
    P = max(int(200_000 * sf), 40)
    C = max(int(150_000 * sf), 30)
    O = max(int(1_500_000 * sf), 150)

    t = {}

    # ---- region / nation -------------------------------------------------
    t["region"] = {
        "r_regionkey": np.arange(5, dtype=np.int64),
        "r_name": np.array(REGIONS),
        "r_comment": _word_soup(rng, 5, 4, 10),
    }
    n_name = np.array([n for n, _ in NATIONS])
    n_region = np.array([r for _, r in NATIONS], dtype=np.int64)
    t["nation"] = {
        "n_nationkey": np.arange(25, dtype=np.int64),
        "n_name": n_name,
        "n_regionkey": n_region,
        "n_comment": _word_soup(rng, 25, 4, 10),
    }

    # ---- supplier --------------------------------------------------------
    sk = np.arange(1, S + 1, dtype=np.int64)
    s_nation = rng.integers(0, 25, S)
    s_comment = _word_soup(rng, S, 4, 10)
    # 5 per 10,000 suppliers carry the Q16 complaint pattern
    n_complaints = max(int(round(S * 5 / 10_000)), 1)
    complain_rows = rng.choice(S, n_complaints, replace=False)
    _inject(rng, s_comment, complain_rows, "Customer", "Complaints")
    t["supplier"] = {
        "s_suppkey": sk,
        "s_name": _numbered("Supplier#", sk),
        "s_address": _word_soup(rng, S, 2, 4),
        "s_nationkey": s_nation,
        "s_phone": _phones(rng, s_nation),
        "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, S), 2),
        "s_comment": s_comment,
    }

    # ---- part ------------------------------------------------------------
    pk = np.arange(1, P + 1, dtype=np.int64)
    colors = np.array(P_NAME_WORDS)
    name_idx = rng.integers(0, len(colors), (P, 5))
    p_name = _join_words(colors, name_idx, np.full(P, 5))
    mfgr = rng.integers(1, 6, P)
    brand = mfgr * 10 + rng.integers(1, 6, P)
    p_type = np.array(TYPE_S1)[rng.integers(0, 6, P)]
    p_type = np.char.add(np.char.add(p_type, " "), np.array(TYPE_S2)[rng.integers(0, 5, P)])
    p_type = np.char.add(np.char.add(p_type, " "), np.array(TYPE_S3)[rng.integers(0, 5, P)])
    p_container = np.char.add(
        np.char.add(np.array(CONTAINER_S1)[rng.integers(0, 5, P)], " "),
        np.array(CONTAINER_S2)[rng.integers(0, 8, P)],
    )
    # spec retail price formula (§4.2.3)
    p_retail = (90000 + ((pk // 10) % 20001) + 100 * (pk % 1000)) / 100.0
    t["part"] = {
        "p_partkey": pk,
        "p_name": p_name,
        "p_mfgr": np.char.add("Manufacturer#", mfgr.astype("U1")),
        "p_brand": np.char.add("Brand#", brand.astype("U2")),
        "p_type": p_type,
        "p_size": rng.integers(1, 51, P),
        "p_container": p_container,
        "p_retailprice": p_retail,
        "p_comment": _word_soup(rng, P, 2, 5),
    }

    # ---- partsupp --------------------------------------------------------
    ps_pk = np.repeat(pk, 4)
    i4 = np.tile(np.arange(4, dtype=np.int64), P)
    # spec supplier-spread formula: s = (p + i*(S/4 + (p-1)/S)) % S + 1
    ps_sk = (ps_pk + i4 * (S // 4 + (ps_pk - 1) // S)) % S + 1
    t["partsupp"] = {
        "ps_partkey": ps_pk,
        "ps_suppkey": ps_sk,
        "ps_availqty": rng.integers(1, 10_000, 4 * P),
        "ps_supplycost": np.round(rng.uniform(1.00, 1000.00, 4 * P), 2),
        "ps_comment": _word_soup(rng, 4 * P, 4, 12),
    }

    # ---- customer --------------------------------------------------------
    ck = np.arange(1, C + 1, dtype=np.int64)
    c_nation = rng.integers(0, 25, C)
    t["customer"] = {
        "c_custkey": ck,
        "c_name": _numbered("Customer#", ck),
        "c_address": _word_soup(rng, C, 2, 4),
        "c_nationkey": c_nation,
        "c_phone": _phones(rng, c_nation),
        "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, C), 2),
        "c_mktsegment": np.array(SEGMENTS)[rng.integers(0, 5, C)],
        "c_comment": _word_soup(rng, C, 4, 12),
    }

    # ---- orders ----------------------------------------------------------
    oi = np.arange(O, dtype=np.int64)
    o_key = (oi >> 3) * 32 + (oi & 7) + 1  # sparse: 8 of every 32 keys
    cands = ck[ck % 3 != 0]  # a third of customers never order (Q13/Q22)
    o_cust = cands[rng.integers(0, len(cands), O)]
    d_lo = _date("1992-01-01")
    d_hi = _date("1998-08-02")  # ENDDATE - 151 days
    o_date = rng.integers(d_lo, d_hi + 1, O)
    o_comment = _word_soup(rng, O, 4, 12)
    n_special = int(O * 0.01)  # ~1% carry the Q13 pattern
    special_rows = rng.choice(O, n_special, replace=False)
    _inject(rng, o_comment, special_rows, "special", "requests")

    # ---- lineitem --------------------------------------------------------
    per_order = rng.integers(1, 8, O)
    L = int(per_order.sum())
    l_order = np.repeat(o_key, per_order)
    l_odate = np.repeat(o_date, per_order)
    starts = np.cumsum(per_order) - per_order
    l_lineno = np.arange(L, dtype=np.int64) - np.repeat(starts, per_order) + 1
    l_pk = rng.integers(1, P + 1, L)
    li4 = rng.integers(0, 4, L)
    l_sk = (l_pk + li4 * (S // 4 + (l_pk - 1) // S)) % S + 1
    l_qty = rng.integers(1, 51, L)
    l_price = np.round(l_qty * p_retail[l_pk - 1], 2)
    l_disc = rng.integers(0, 11, L) / 100.0
    l_tax = rng.integers(0, 9, L) / 100.0
    l_ship = l_odate + rng.integers(1, 122, L)
    l_commit = l_odate + rng.integers(30, 91, L)
    l_receipt = l_ship + rng.integers(1, 31, L)
    cur = _date(CURRENTDATE)
    returned = l_receipt <= cur
    l_rflag = np.where(returned, np.where(rng.random(L) < 0.5, "R", "A"), "N")
    l_status = np.where(l_ship > cur, "O", "F")

    # order-derived columns
    # np.bincount sums each order's lines in row order from 0.0, as
    # np.add.at does: the same float64 sums
    line_net = l_price * (1 - l_disc) * (1 + l_tax)
    l_oi = np.repeat(oi, per_order)
    o_total = np.round(np.bincount(l_oi, weights=line_net, minlength=O), 2)
    n_open = np.bincount(l_oi, weights=(l_status == "O"), minlength=O).astype(np.int64)
    o_status = np.where(
        n_open == per_order, "O", np.where(n_open == 0, "F", "P")
    )

    t["orders"] = {
        "o_orderkey": o_key,
        "o_custkey": o_cust,
        "o_orderstatus": o_status,
        "o_totalprice": o_total,
        "o_orderdate": o_date,
        "o_orderpriority": np.array(PRIORITIES)[rng.integers(0, 5, O)],
        "o_clerk": _numbered("Clerk#", rng.integers(1, max(int(1000 * sf), 2), O)),
        "o_shippriority": np.zeros(O, dtype=np.int64),
        "o_comment": o_comment,
    }
    t["lineitem"] = {
        "l_orderkey": l_order,
        "l_partkey": l_pk,
        "l_suppkey": l_sk,
        "l_linenumber": l_lineno,
        "l_quantity": l_qty,
        "l_extendedprice": l_price,
        "l_discount": l_disc,
        "l_tax": l_tax,
        "l_returnflag": l_rflag,
        "l_linestatus": l_status,
        "l_shipdate": l_ship,
        "l_commitdate": l_commit,
        "l_receiptdate": l_receipt,
        "l_shipinstruct": np.array(SHIPINSTRUCT)[rng.integers(0, 4, L)],
        "l_shipmode": np.array(SHIPMODES)[rng.integers(0, 7, L)],
        "l_comment": _word_soup(rng, L, 2, 6),
    }
    return t
