"""Seeded random tables and SQL statements for engine-vs-engine fuzzing.

`gen_case(seed, size)` returns a `FuzzCase`: tables as plain numpy columns
with validity masks, in `storage.memory.import_tables`'s form
({table: [(column, type name, values, validity)]}), and a list of SQL
statements over them. The same seed and size always give the same case.
The same corpus feeds tests/test_torch_fuzz.py (the JAX package, this
package on the CPU and over 4 CPU shards) and `chip_smoke.py`'s `fuzz`
phase (this package on the card, one device and 4 shards, against its own
CPU run).

Sizes:
- `small`: 2-4 tables of at most 64 rows;
- `medium`: 2-4 tables of 4,096 rows;
- `large`: a fact table `f` of 2^18 rows (or `fact_rows`) whose group keys
  span at most 1024 values, a dim table `d` of unique dense keys, and a
  table `e` of 2^17 unique ids that half match the fact's. Its statements
  take the histogram GROUP BY (kernel 1), the fused star rollup with ORDER
  BY over a dense dim (kernel 2) and, over shards, the `shuffle` join.

Every table has the same nine columns:
  k  BIGINT   join key (duplicates, misses across tables, NULLs)
  g  INTEGER  group key of few values (ties)
  v  BIGINT   non-negative quantity
  x  DOUBLE   signed quarter steps (sums exact in any order)
  y  DOUBLE   positive, full precision (sums depend on the order)
  s  VARCHAR  words of a small pool (several cardinalities)
  dt DATE     days in 1995-1996
  b  BOOLEAN
  u  UINTEGER (UBIGINT in some small cases, values past 2^63)
and each column draws its NULL share from {0, 10%, 50%}, except the large
tier's fact `v`, dim `k` and `e.id`, which the kernels' paths need whole.

Strings carry a suffix unique to the case, so a case's strings are new to
a process's dictionaries whatever ran before; two engines that load the
same case in the same order then give its strings codes in the same order.

Statements use only SQL the reference's parser and binder accept:
projections with arithmetic and CASE; WHERE trees of comparisons,
BETWEEN, IN lists, LIKE, IS [NOT] NULL, AND/OR/NOT; join trees of 2-4
tables (inner, left, right, full, cross) with residual ON terms; IN / NOT
IN subqueries (NULLs on either side), correlated EXISTS / NOT EXISTS,
scalar and correlated scalar subqueries, derived tables; grouped and
ungrouped aggregates, DISTINCT aggregates, GROUP BY on 1-3 keys, HAVING;
ORDER BY (ties included) with and without LIMIT; SELECT DISTINCT.

numpy only: nothing here imports torch, jax or either engine.
"""

from __future__ import annotations

import dataclasses
import datetime
import re

import numpy as np

SIZES = ("small", "medium", "large")
MEDIUM_ROWS = 4096
LARGE_FACT_ROWS = 1 << 18
LARGE_DIM_ROWS = 1000
LARGE_E_ROWS = 1 << 17

WORDS = [
    "apple", "banana", "cherry", "date", "elder", "fig", "grape", "kiwi",
    "lemon", "mango", "nectar", "olive", "peach", "pear", "quince", "rasp",
]
NULL_SHARES = (0.0, 0.1, 0.5)
_EPOCH = datetime.date(1970, 1, 1)
_DAY0 = (datetime.date(1995, 1, 1) - _EPOCH).days
_DAYS = 731

_INTS = ("k", "g", "v")
_KEYS = ("g", "s", "b", "dt", "k", "u")
_UNSTABLE = re.compile(r"(sum|avg)\((distinct )?a\d\.y\b")


@dataclasses.dataclass
class FuzzCase:
    seed: int
    size: str
    tables: dict  # name -> [(column, type name, values, validity)]
    statements: list

    def table_rows(self) -> dict:
        return {t: len(cols[0][2]) for t, cols in self.tables.items()}


def _valid(rng, n: int, share: float) -> np.ndarray:
    if share == 0.0:
        return np.ones(n, np.bool_)
    return rng.random(n) >= share


def _date_sql(day: int) -> str:
    return f"date '{(_EPOCH + datetime.timedelta(days=int(day))).isoformat()}'"


def _make_table(rng, n, key_lo, key_span, words, unsigned, whole=()):
    """The nine columns of one table, n rows. `whole` names columns kept
    free of NULLs."""
    def share(c):
        return 0.0 if c in whole else float(rng.choice(NULL_SHARES))

    cols = []
    k = rng.integers(key_lo, key_lo + key_span, n)
    cols.append(("k", "BIGINT", k.astype(np.int64), _valid(rng, n, share("k"))))
    g = rng.integers(0, int(rng.choice([3, 5, 8])), n)
    cols.append(("g", "INTEGER", g.astype(np.int32), _valid(rng, n, share("g"))))
    v = rng.integers(0, int(rng.choice([10, 100, 1000])), n)
    cols.append(("v", "BIGINT", v.astype(np.int64), _valid(rng, n, share("v"))))
    x = rng.integers(-200, 201, n) / 4.0
    cols.append(("x", "DOUBLE", x, _valid(rng, n, share("x"))))
    y = rng.random(n) * 1000.0 + 1e-3
    cols.append(("y", "DOUBLE", y, _valid(rng, n, share("y"))))
    n_words = int(rng.choice([3, 8, len(words)]))
    s = np.asarray(words)[rng.integers(0, n_words, n)]
    cols.append(("s", "VARCHAR", s, _valid(rng, n, share("s"))))
    dt = _DAY0 + rng.integers(0, int(rng.choice([12, _DAYS])), n)
    cols.append(("dt", "DATE", dt.astype(np.int32), _valid(rng, n, share("dt"))))
    b = rng.random(n) < 0.5
    cols.append(("b", "BOOLEAN", b, _valid(rng, n, share("b"))))
    if unsigned == "UBIGINT":
        u = rng.integers(0, 1 << 62, n).astype(np.uint64) * np.uint64(3)
        u[rng.random(n) < 0.3] = rng.integers(0, 50, 1).astype(np.uint64)[0]
    else:
        u = rng.integers(0, int(rng.choice([16, 4_000_000_000])), n).astype(np.uint32)
    cols.append(("u", unsigned, u, _valid(rng, n, share("u"))))
    return cols


def _tables(rng, size: str, tag: str, fact_rows: int):
    words = [f"{w}_{tag}" for w in WORDS]
    if size == "large":
        nd = LARGE_DIM_ROWS
        f = _make_table(rng, fact_rows, 0, nd + 24, words, "UINTEGER", whole=("v",))
        f[0] = ("k", "BIGINT", rng.integers(0, nd + 24, fact_rows).astype(np.int64),
                _valid(rng, fact_rows, 0.1))
        f.insert(0, ("id", "BIGINT", np.arange(fact_rows, dtype=np.int64), None))
        d = _make_table(rng, nd, 0, nd, words, "UINTEGER", whole=("k",))
        d[0] = ("k", "BIGINT", rng.permutation(nd).astype(np.int64), None)
        ne = LARGE_E_ROWS
        e = _make_table(rng, ne, 0, nd, words, "UINTEGER")
        ids = rng.choice(2 * max(fact_rows, ne), ne, replace=False).astype(np.int64)
        e.insert(0, ("id", "BIGINT", ids, None))
        return {"f": f, "d": d, "e": e}
    n_tables = int(rng.integers(2, 5))
    out = {}
    for t in range(n_tables):
        n = MEDIUM_ROWS if size == "medium" else 64
        # medium keys span ≥ 1024 values (about 4 rows a key), so a join
        # tree of 4 tables stays near 4096 * 4^3 rows
        span = (int(rng.choice([1024, 2048])) if size == "medium"
                else int(rng.choice([4, 8, 16])))
        lo = int(rng.integers(0, max(span // 4, 2)))
        unsigned = ("UBIGINT" if size == "small" and rng.random() < 0.5
                    else "UINTEGER")
        out[f"t{t}"] = _make_table(rng, n, lo, span, words, unsigned)
    return out


class _Gen:
    """Statement generator over one case's tables."""

    def __init__(self, rng, tables: dict, size: str):
        self.rng = rng
        self.size = size
        self.tables = tables
        self.names = list(tables)
        self.types = {
            t: {c: tn for c, tn, _v, _m in cols} for t, cols in tables.items()
        }
        self.values = {
            t: {c: v for c, _tn, v, _m in cols} for t, cols in tables.items()
        }

    # ---- small helpers ----------------------------------------------------
    def pick(self, seq):
        return seq[int(self.rng.integers(0, len(seq)))]

    def chance(self, p: float) -> bool:
        return bool(self.rng.random() < p)

    def sample_value(self, table: str, col: str):
        vals = self.values[table][col]
        return vals[int(self.rng.integers(0, len(vals)))]

    def literal(self, table: str, col: str, v=None) -> str:
        """A literal of the column's type near one of its values (`v`, or a
        sampled one)."""
        tn = self.types[table][col]
        if v is None:
            v = self.sample_value(table, col)
        if tn == "VARCHAR":
            return f"'{v}'"
        if tn == "DATE":
            return _date_sql(int(v) + int(self.rng.integers(-3, 4)))
        if tn == "BOOLEAN":
            return "true" if v else "false"
        if tn == "DOUBLE":
            return repr(float(np.round(float(v) + self.pick([0.0, 0.25, -0.5]), 2)))
        if tn in ("UINTEGER", "UBIGINT"):
            return str(int(v))
        return str(int(v) + int(self.rng.integers(-1, 2)))

    def like_pattern(self, table: str) -> str:
        w = str(self.sample_value(table, "s"))
        i = int(self.rng.integers(1, 4))
        return self.pick([
            f"'{w[:i]}%'",
            f"'%{w[i:i + 2]}%'",
            f"'_{w[1:i + 1]}%'",
            f"'%{w[-3:]}'",
            f"'{w}'",
        ])

    # ---- scalar expressions ---------------------------------------------------
    def num_expr(self, a: str) -> str:
        c = self.pick(["g", "v", "k", "x", "y"])
        r = self.rng.random()
        if r < 0.55:
            return f"{a}.{c}"
        if r < 0.7:
            return f"{a}.{c} + {int(self.rng.integers(1, 10))}"
        if r < 0.8:
            return f"{a}.{c} * {int(self.rng.integers(2, 4))}"
        if r < 0.9:
            return f"{a}.{self.pick(_INTS)} % {int(self.rng.integers(2, 7))}"
        return f"{a}.g + {a}.v"

    def proj_expr(self, a: str, t: str) -> str:
        r = self.rng.random()
        if r < 0.55:
            return f"{a}.{self.pick(['k', 'g', 'v', 'x', 'y', 's', 'dt', 'b', 'u'])}"
        if r < 0.75:
            return self.num_expr(a)
        if r < 0.82:
            return f"{a}.v / {self.pick([2, 3, 0])}"
        if r < 0.88:
            return (f"case when {a}.g > {int(self.rng.integers(0, 4))} then {a}.s "
                    f"else '{self.sample_value(t, 's')}' end")
        if r < 0.94:
            return f"{a}.s || '!'"
        return f"extract(month from {a}.dt)"

    # ---- predicates -------------------------------------------------------------
    def atom(self, a: str, t: str) -> str:
        r = self.rng.random()
        c = self.pick(["k", "g", "v", "x", "y", "s", "dt", "b", "u"])
        op = self.pick(["=", "<>", "<", "<=", ">", ">="])
        if r < 0.35:
            if c == "b":
                return self.pick([f"{a}.b", f"not {a}.b", f"{a}.b = {self.literal(t, 'b')}"])
            return f"{a}.{c} {op} {self.literal(t, c)}"
        if r < 0.45:
            if c == "b":
                c = "g"
            lo_v, hi_v = sorted([self.sample_value(t, c), self.sample_value(t, c)])
            lo, hi = self.literal(t, c, lo_v), self.literal(t, c, hi_v)
            neg = "not " if self.chance(0.2) else ""
            return f"{a}.{c} {neg}between {lo} and {hi}"
        if r < 0.57:
            c = self.pick(["k", "g", "s", "v", "dt"])
            items = ", ".join(self.literal(t, c) for _ in range(int(self.rng.integers(1, 5))))
            neg = "not " if self.chance(0.3) else ""
            return f"{a}.{c} {neg}in ({items})"
        if r < 0.67:
            neg = "not " if self.chance(0.3) else ""
            return f"{a}.s {neg}like {self.like_pattern(t)}"
        if r < 0.79:
            neg = "not " if self.chance(0.5) else ""
            return f"{a}.{c} is {neg}null"
        if r < 0.9:
            return f"{self.num_expr(a)} {op} {int(self.rng.integers(0, 40))}"
        return f"{a}.x {op} {a}.y - 500"

    def pred(self, aliases, depth=0) -> str:
        a, t = self.pick(aliases)
        r = self.rng.random()
        if depth < 2 and r < 0.25:
            return f"({self.pred(aliases, depth + 1)} and {self.pred(aliases, depth + 1)})"
        if depth < 2 and r < 0.4:
            return f"({self.pred(aliases, depth + 1)} or {self.pred(aliases, depth + 1)})"
        if depth < 2 and r < 0.45:
            return f"not ({self.pred(aliases, depth + 1)})"
        return self.atom(a, t)

    # ---- FROM clauses -----------------------------------------------------------
    def join_tree(self, n: int, allow_cross: bool):
        """(from clause, [(alias, table)]) over n distinct tables. The large
        tier joins the fact only to the dim (on k) and to e (on the unique
        id), so no join multiplies the fact's rows."""
        if self.size == "large":
            kind = self.pick(["join", "join", "left join", "right join"])
            sql = f"f a0 {kind} d a1 on a0.k = a1.k"
            if n > 2:
                sql += f" {self.pick(['join', 'left join'])} e a2 on a0.id = a2.id"
            return sql, [("a0", "f"), ("a1", "d"), ("a2", "e")][:n]
        tabs = list(self.rng.permutation(self.names)[:n])
        aliases = [(f"a{i}", t) for i, t in enumerate(tabs)]
        sql = f"{tabs[0]} a0"
        for i in range(1, n):
            a, t = aliases[i]
            kind = self.pick(["join", "join", "left join", "right join", "full join"]
                             + (["cross join"] if allow_cross else []))
            if kind == "cross join":
                sql += f" cross join {t} {a}"
                continue
            other = aliases[int(self.rng.integers(0, i))][0]
            on = f"{other}.k = {a}.k"
            r = self.rng.random()
            if r < 0.2:
                on += f" and {other}.g = {a}.g"
            elif r < 0.35:
                on += f" and {other}.x < {a}.y - {int(self.rng.integers(0, 600))}"
            elif r < 0.45:
                on += f" and {a}.v > {int(self.rng.integers(0, 20))}"
            sql += f" {kind} {t} {a} on {on}"
        return sql, aliases

    # ---- aggregates -------------------------------------------------------------
    def agg(self, aliases) -> str:
        a, t = self.pick(aliases)
        fn = self.pick(["count", "sum", "min", "max", "avg", "count_star", "distinct"])
        if fn == "count_star":
            return "count(*)"
        if fn == "distinct":
            f2 = self.pick(["count", "sum", "count"])
            c = "s" if f2 == "count" and self.chance(0.5) else self.pick(["g", "v", "k"])
            return f"{f2}(distinct {a}.{c})"
        if fn in ("min", "max"):
            c = self.pick(["k", "g", "v", "x", "y", "s", "dt", "u"])
            return f"{fn}({a}.{c})"
        if fn == "count":
            return f"count({a}.{self.pick(['k', 's', 'x', 'b', 'u'])})"
        c = self.pick(["v", "g", "x", "y", "k"])
        if self.chance(0.2):
            return f"{fn}({a}.{c} * 2)"
        return f"{fn}({a}.{c})"

    # ---- statement families -----------------------------------------------------
    def order_limit(self, names: list, force_limit: bool = False) -> str:
        out = ""
        if names and (force_limit or self.chance(0.6)):
            keys = list(self.rng.permutation(names)[: int(self.rng.integers(1, min(3, len(names)) + 1))])
            out += " order by " + ", ".join(
                f"{k}{self.pick(['', ' desc', ' asc'])}" for k in keys
            )
        if force_limit or self.chance(0.3):
            out += f" limit {int(self.rng.integers(1, 20))}"
            if self.chance(0.2):
                out += f" offset {int(self.rng.integers(0, 5))}"
        return out

    def select_list(self, exprs):
        """(select list, the names ORDER BY may use). A sum or average of
        y depends on the order of its additions, which engines may take
        differently: two groups equal in exact arithmetic may then sort
        either way, so such a column is never a sort key."""
        names = [f"c{i}" for i in range(len(exprs))]
        sel = ", ".join(f"{e} as {n}" for e, n in zip(exprs, names))
        return sel, [n for e, n in zip(exprs, names) if not _UNSTABLE.search(e)]

    def f_filter(self) -> str:
        t = self.pick(self.names)
        al = [("a0", t)]
        exprs = [self.proj_expr("a0", t) for _ in range(int(self.rng.integers(1, 5)))]
        sel, names = self.select_list(exprs)
        where = f" where {self.pred(al)}" if self.chance(0.85) else ""
        return f"select {sel} from {t} a0{where}{self.order_limit(names, self.size != 'small')}"

    def f_join(self) -> str:
        n = int(self.rng.integers(2, min(4, len(self.names)) + 1))
        frm, al = self.join_tree(n, allow_cross=self.size == "small")
        exprs = []
        for _ in range(int(self.rng.integers(1, 5))):
            a, t = self.pick(al)
            exprs.append(f"{a}.{self.pick(['k', 'g', 'v', 'x', 's', 'dt', 'u', 'b'])}")
        sel, names = self.select_list(exprs)
        where = f" where {self.pred(al)}" if self.chance(0.5) else ""
        return f"select {sel} from {frm}{where}{self.order_limit(names, self.size != 'small')}"

    def group_keys(self, al):
        keys = []
        for _ in range(int(self.rng.integers(1, 4))):
            a, t = self.pick(al)
            c = self.pick(list(_KEYS) if self.size == "small" else ["g", "s", "b", "dt", "g"])
            e = f"{a}.{c}"
            if e not in keys:
                keys.append(e)
        return keys

    def f_group(self) -> str:
        if len(self.names) > 1 and self.chance(0.5):
            n = int(self.rng.integers(2, min(3, len(self.names)) + 1))
            frm, al = self.join_tree(n, allow_cross=False)
        else:
            t = self.pick(self.names)
            frm, al = f"{t} a0", [("a0", t)]
        keys = self.group_keys(al)
        aggs = [self.agg(al) for _ in range(int(self.rng.integers(1, 4)))]
        sel, names = self.select_list(keys + aggs)
        where = f" where {self.pred(al)}" if self.chance(0.5) else ""
        having = ""
        if self.chance(0.3):
            having = self.pick([
                f" having count(*) > {int(self.rng.integers(0, 4))}",
                f" having {self.pick(aggs)} is not null",
                f" having sum({al[0][0]}.v) > {int(self.rng.integers(0, 50))}",
            ])
        return (f"select {sel} from {frm}{where} group by {', '.join(keys)}"
                f"{having}{self.order_limit(names)}")

    def f_ungrouped(self) -> str:
        t = self.pick(self.names)
        al = [("a0", t)]
        aggs = [self.agg(al) for _ in range(int(self.rng.integers(1, 5)))]
        sel, _names = self.select_list(aggs)
        where = f" where {self.pred(al)}" if self.chance(0.6) else ""
        return f"select {sel} from {t} a0{where}"

    def f_distinct(self) -> str:
        t = self.pick(self.names)
        al = [("a0", t)]
        cols = list(dict.fromkeys(
            f"a0.{self.pick(['g', 's', 'b', 'k', 'dt', 'v'])}"
            for _ in range(int(self.rng.integers(1, 4)))
        ))
        sel, names = self.select_list(cols)
        where = f" where {self.pred(al)}" if self.chance(0.5) else ""
        return f"select distinct {sel} from {t} a0{where}{self.order_limit(names)}"

    def f_subquery(self) -> str:
        if self.size == "large":
            t0, t1 = "f", self.pick(["d", "e"])
        else:
            t0, t1 = list(self.rng.permutation(self.names)[:2])
        al0, al1 = [("a0", t0)], [("a1", t1)]
        r = self.rng.random()
        inner_where = f" where {self.pred(al1)}" if self.chance(0.5) else ""
        if r < 0.3:
            c = self.pick(["k", "g", "s"])
            neg = "not " if self.chance(0.5) else ""
            cond = f"a0.{c} {neg}in (select a1.{c} from {t1} a1{inner_where})"
        elif r < 0.55:
            neg = "not " if self.chance(0.5) else ""
            extra = f" and {self.pred(al1)}" if self.chance(0.5) else ""
            cond = f"{neg}exists (select * from {t1} a1 where a1.k = a0.k{extra})"
        elif r < 0.7:
            c = self.pick(["x", "v", "y"])
            cond = (f"a0.{c} {self.pick(['>', '<', '>='])} "
                    f"(select {self.pick(['avg', 'min', 'max'])}(a1.{c}) from {t1} a1{inner_where})")
        elif r < 0.85:
            c = self.pick(["v", "x"])
            cond = (f"a0.{c} {self.pick(['>', '<='])} "
                    f"(select {self.pick(['min', 'max', 'sum'])}(a1.{c}) from {t1} a1 "
                    f"where a1.k = a0.k)")
        else:
            cond = f"a0.v in (select a1.v * 2 from {t1} a1 where a1.k = a0.k)"
        if self.chance(0.3):
            cond = f"{cond} and {self.pred(al0)}"
        if self.chance(0.4):
            keys = self.group_keys(al0)[:2]
            sel, names = self.select_list(keys + [self.agg(al0)])
            return (f"select {sel} from {t0} a0 where {cond} group by {', '.join(keys)}"
                    f"{self.order_limit(names)}")
        exprs = [self.proj_expr("a0", t0) for _ in range(int(self.rng.integers(1, 4)))]
        sel, names = self.select_list(exprs)
        return f"select {sel} from {t0} a0 where {cond}{self.order_limit(names, self.size != 'small')}"

    def f_derived(self) -> str:
        t = self.pick(self.names)
        al = [("a0", t)]
        key = self.pick(["a0.g", "a0.s", "a0.k"])
        agg = self.pick(["sum(a0.v)", "count(*)", "max(a0.x)", "avg(a0.x)"])
        where = f" where {self.pred(al)}" if self.chance(0.5) else ""
        inner = f"select {key} as dk, {agg} as dv from {t} a0{where} group by {key}"
        r = self.rng.random()
        if r < 0.5 and len(self.names) > 1:
            t1 = self.pick([n for n in self.names if n != t])
            kind = self.pick(["join", "left join"])
            kcol = key.split(".")[1]
            sel, names = self.select_list(["q.dk", "q.dv", f"a1.{self.pick(['v', 'x', 's'])}"])
            return (f"select {sel} from ({inner}) q {kind} {t1} a1 on q.dk = a1.{kcol}"
                    f"{self.order_limit(names, self.size != 'small')}")
        sel, names = self.select_list(["q.dk", "q.dv"])
        return (f"select {sel} from ({inner}) q where q.dv is not null"
                f"{self.order_limit(names)}")

    # ---- the large tier's targeted families ---------------------------------------
    def f_histogram(self) -> str:
        """GROUP BY over the whole fact table, keys spanning ≤ 1024 values,
        sum/count/avg only: kernel 1's path (2^17 rows or more)."""
        keys = self.pick([["a0.g"], ["a0.k"], ["a0.g", "a0.b"], ["a0.s"], ["a0.dt"]])
        aggs = ["count(*)"] + [
            self.pick(["sum(a0.v)", "avg(a0.x)", "count(a0.y)", "sum(a0.g)", "avg(a0.v)", "sum(a0.x)"])
            for _ in range(int(self.rng.integers(1, 4)))
        ]
        sel, names = self.select_list(keys + aggs)
        order = f" order by {', '.join(names[:len(keys)])}" if self.chance(0.5) else ""
        # no WHERE: a filter compacts the rows below kernel 1's threshold
        return f"select {sel} from f a0 group by {', '.join(keys)}{order}"

    def f_star(self) -> str:
        """Fact ⋈ dim on the dense dim key, grouped by the key: the fused
        star rollup; with ORDER BY and one integer sum, kernel 2's path."""
        r = self.rng.random()
        if r < 0.5:
            return ("select a0.k as c0, sum(a0.v) as c1 from f a0 join d a1 "
                    "on a0.k = a1.k group by a0.k order by c0"
                    + self.pick(["", " desc", " limit 50", " desc limit 50"]))
        agg = self.pick(["sum(a0.v)", "count(*)", "min(a0.v)", "max(a0.x)", "avg(a0.v)"])
        order = " order by c0" if self.chance(0.5) else ""
        return (f"select a0.k as c0, {agg} as c1, count(*) as c2 from f a0 join d a1 "
                f"on a0.k = a1.k group by a0.k{order}")

    def f_shuffle(self) -> str:
        """Fact ⋈ e on the unique id: a build side of 2^17 rows, which the
        sharded engine exchanges (`shuffle`)."""
        where = f" where {self.atom('a1', 'e')}" if self.chance(0.5) else ""
        if self.chance(0.5):
            return (f"select count(*) as c0, sum(a0.v) as c1, sum(a1.v) as c2, min(a1.s) as c3 "
                    f"from f a0 join e a1 on a0.id = a1.id{where}")
        return (f"select a1.g as c0, count(*) as c1, sum(a0.x) as c2 from f a0 join e a1 "
                f"on a0.id = a1.id{where} group by a1.g order by c0")


_FAMILIES = [
    ("f_filter", 2), ("f_join", 3), ("f_group", 4), ("f_ungrouped", 1),
    ("f_distinct", 1), ("f_subquery", 3), ("f_derived", 1),
]


# The corpus the fast tests run against the JAX package (tests/test_torch_fuzz*.py)
# and chip_smoke.py's fuzz phase runs again on the card.
SMALL_SEEDS = range(40)
MEDIUM_SEEDS = range(4)
MEDIUM_STATEMENTS = 6
LARGE_TIER1 = {"seed": 0, "n_statements": 5, "fact_rows": 1 << 17}


def fast_tier_cases():
    """The fast tests' corpus, case by case: 40 small seeds of 12 statements, 4
    medium seeds of 6, and the large seed at exactly 2^17 fact rows."""
    for seed in SMALL_SEEDS:
        yield gen_case(seed, "small")
    for seed in MEDIUM_SEEDS:
        yield gen_case(seed, "medium", n_statements=MEDIUM_STATEMENTS)
    yield gen_case(size="large", **LARGE_TIER1)


def gen_case(seed: int, size: str = "small", n_statements: int | None = None,
             fact_rows: int = LARGE_FACT_ROWS) -> FuzzCase:
    """The tables and statements of one fuzz case (deterministic)."""
    if size not in SIZES:
        raise ValueError(f"size must be one of {SIZES}, got {size!r}")
    rng = np.random.default_rng([seed, SIZES.index(size)])
    tables = _tables(rng, size, f"{size[0]}{seed}", fact_rows)
    gen = _Gen(rng, tables, size)
    if size == "large":
        n_statements = 8 if n_statements is None else n_statements
        fixed = [gen.f_histogram(), gen.f_star(), gen.f_shuffle()]
        if n_statements > 3:
            fixed.append("select a0.k as c0, sum(a0.v) as c1 from f a0 join d a1 "
                         "on a0.k = a1.k group by a0.k order by c0")
        targeted = ["f_histogram", "f_star", "f_shuffle", "f_subquery", "f_group",
                    "f_join", "f_derived", "f_distinct"]
        while len(fixed) < n_statements:
            fixed.append(getattr(gen, gen.pick(targeted))())
        return FuzzCase(seed, size, tables, fixed[:n_statements])
    n_statements = 12 if n_statements is None else n_statements
    names = [f for f, _w in _FAMILIES]
    weights = np.array([w for _f, w in _FAMILIES], np.float64)
    weights /= weights.sum()
    stmts = []
    for _ in range(n_statements):
        fam = names[int(rng.choice(len(names), p=weights))]
        stmts.append(getattr(gen, fam)())
    return FuzzCase(seed, size, tables, stmts)


# ---- running and comparing --------------------------------------------------
#
# Engine-neutral: a result is read through the engine's own renderer, so
# the JAX package and this one are compared by the same code.

_FLOAT_TYPES = ("DOUBLE", "FLOAT")


def outcome(db, sql: str, render):
    """("ok", [(type names, column names, rendered rows, values)]) or
    ("error", exception type name, message): errors are part of the
    behaviour compared."""
    try:
        batches = db.run(sql)
    except Exception as e:  # noqa: BLE001 - the error IS the outcome
        if any(c.__name__ == "ProgramError" for c in type(e).__mro__):
            raise  # a failed capture or replay of the port's programs is no outcome
        return ("error", type(e).__name__, str(e))
    return ("ok", [
        ([t.name for t in b.schema.types], list(b.schema.names), render(b), b.to_pylist())
        for b in batches
    ])


def _close(a: float, b: float, rel: float) -> bool:
    if a == b or (a != a and b != b):
        return True
    return abs(a - b) <= rel * max(abs(a), abs(b))


def difference(expected, got, rel: float = 1e-9) -> str | None:
    """None when two outcomes agree, else what differs. The rule: both
    raise (with the same exception type), or both return batches with the
    same types and names whose non-float cells render identically, row
    order included, and whose DOUBLE/FLOAT cells agree to `rel` (rel=0:
    bit for bit, by the shortest round-trip text)."""
    if expected[0] != got[0]:
        return f"expected {expected[0]} {expected[1:]!s:.300}, got {got[0]} {got[1:]!s:.300}"
    if expected[0] == "error":
        return None if expected[1] == got[1] else f"errors differ: {expected[1:]} vs {got[1:]}"
    eb, gb = expected[1], got[1]
    if len(eb) != len(gb):
        return f"{len(eb)} batches against {len(gb)}"
    for (et, en, erows, evals), (gt, gn, grows, gvals) in zip(eb, gb):
        if et != gt or en != gn:
            return f"schema {list(zip(en, et))} against {list(zip(gn, gt))}"
        if len(erows) != len(grows):
            return f"{len(erows)} rows against {len(grows)}"
        for i, (er, gr, ev, gv) in enumerate(zip(erows, grows, evals, gvals)):
            for t, a, b, x, y in zip(et, er, gr, ev, gv):
                if t in _FLOAT_TYPES and x is not None and y is not None and rel > 0:
                    ok = _close(float(x), float(y), rel)
                else:
                    ok = a == b
                if not ok:
                    return f"row {i}: {er} against {gr}"
    return None
