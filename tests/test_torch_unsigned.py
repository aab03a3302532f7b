"""The unsigned types UTINYINT, USMALLINT, UINTEGER and UBIGINT in
sqlrs_tpu_torch against the reference (sqlrs_tpu, numpy uint8..uint64 under
jnp's wrapping unsigned semantics).

The port holds UTINYINT as uint8, USMALLINT in int32, UINTEGER in int64 and
UBIGINT as the int64 bit pattern (data/batch.py). The same tables, made
from numpy with a seed, go through both engines: non-float columns render
identically, DOUBLE values agree to rel 1e-9, errors have the same type
and text, and route logs are equal. Where the reference fails (its sorted
GROUP BY passes the uint64 sentinel 2^64-1 into a jitted program and
raises OverflowError once the block path runs), the port is held to an
exact numpy oracle instead.
"""

import numpy as np
import pytest

import sqlrs_tpu
import sqlrs_tpu_torch
from sqlrs_tpu.catalog.catalog import ColumnDefinition as RefColDef
from sqlrs_tpu.storage.memory import DataTable as RefTable
from sqlrs_tpu.types import LogicalType as RefLT
from sqlrs_tpu.utils.render import batch_to_rows as ref_rows
from sqlrs_tpu_torch.catalog.catalog import ColumnDefinition
from sqlrs_tpu_torch.data import Column
from sqlrs_tpu_torch.data.batch import storage_np, torch_dtype_for
from sqlrs_tpu_torch.storage.memory import DataTable, import_tables
from sqlrs_tpu_torch.types import LogicalType as LT
from sqlrs_tpu_torch.utils.render import batch_to_rows as port_rows

_FLOAT_TYPES = ("DOUBLE", "FLOAT")
U64 = 2**64

# boundary values of UBIGINT on both sides of 2^63
EDGES = [0, 1, 2**53 + 1, 2**63 - 1, 2**63, 2**63 + 1, 2**63 + 2**11 + 1, U64 - 1]


def _add_table(db, mod_table, mod_coldef, lt, name, cols, valids):
    """cols: [(name, type name, numpy array)]; valids: {name: bool array}."""
    types = [lt[t] for _c, t, _a in cols]
    t = mod_table([c for c, _t, _a in cols], types)
    n = len(cols[0][2])
    t.append_numpy(
        [a for _c, _t, a in cols],
        [valids.get(c, np.ones(n, np.bool_)) for c, _t, _a in cols],
    )
    db.catalog.create_table(
        name, [mod_coldef(c, ty) for (c, _t, _a), ty in zip(cols, types)], t
    )


def _make(ref, port, name, cols, valids=None):
    valids = valids or {}
    if ref is not None:
        _add_table(ref, RefTable, RefColDef, RefLT, name, cols, valids)
    for db in port if isinstance(port, (list, tuple)) else [port]:
        _add_table(db, DataTable, ColumnDefinition, LT, name, cols, valids)


def _outcome(db, sql, render):
    try:
        bs = db.run(sql)
    except Exception as e:  # errors are part of the behaviour compared
        return ("error", type(e).__name__, str(e))
    return ("ok", bs, render)


def _rows_equal(rb, pb):
    """Rendered rows equal, DOUBLE/FLOAT to rel 1e-9."""
    assert len(rb) == len(pb)
    for x, y in zip(rb, pb):
        types = [t.name for t in x.schema.types]
        assert types == [t.name for t in y.schema.types]
        assert x.schema.names == y.schema.names
        r_text, p_text = ref_rows(x), port_rows(y)
        assert len(r_text) == len(p_text)
        for rt, pt, rv, pv in zip(r_text, p_text, x.to_pylist(), y.to_pylist()):
            for t, a, b, u, v in zip(types, rt, pt, rv, pv):
                if t in _FLOAT_TYPES and u is not None and v is not None:
                    assert v == pytest.approx(u, rel=1e-9, abs=0), (rt, pt)
                else:
                    assert a == b, (rt, pt)


def _same(ref, port, sql):
    r = _outcome(ref, sql, ref_rows)
    p = _outcome(port, sql, port_rows)
    assert r[0] == p[0], (r, p)
    if r[0] == "error":
        assert p[1:] == r[1:]
    else:
        _rows_equal(r[1], p[1])
    return p


# ---- a small table with every width's edge values ----------------------------

SMALL = {
    "a": ("UTINYINT", np.uint8, [0, 255, 128, 1, 0, 7, 200, 3]),
    "b": ("USMALLINT", np.uint16, [0, 65535, 32768, 1, 0, 300, 60000, 9]),
    "c": ("UINTEGER", np.uint32, [0, 2**32 - 1, 2**31, 1, 0, 70000, 4 * 10**9, 11]),
    "e": ("UBIGINT", np.uint64, [0, U64 - 1, 2**63, 1, 0, 2**63 - 1, 2**63 + 1, 2**53 + 1]),
    "i": ("INTEGER", np.int32, [1, -1, 2, 3, 0, 4, 5, -7]),
    "g": ("BIGINT", np.int64, [5, -2**63, 2**62, 3, 0, -1, 7, 2**53]),
}
SMALL_VALID = np.array([1, 1, 1, 1, 0, 1, 1, 1], np.bool_)


@pytest.fixture(scope="module")
def small_dbs():
    ref = sqlrs_tpu.Database()
    port = sqlrs_tpu_torch.Database(device="cpu")
    cols = [(c, t, np.array(v, dtype=d)) for c, (t, d, v) in SMALL.items()]
    _make(ref, port, "u", cols, {c: SMALL_VALID for c in SMALL})
    return ref, port


SMALL_SQL = [
    "select * from u",
    # wrap at each width
    "select a + a, b + b, c + c, e + e from u",
    "select a - 1, b - 1, c - 1, e - 1 from u",
    "select a * a, b * b, c * c, e * e from u",
    "select a * 255 + b, b * 65535, c * 4294967295, e * 3 from u",
    "select -a, -b, -c, -e from u",
    # unsigned / and % at each width (the same unsigned type on both sides)
    "select a / cast(3 as tinyint unsigned), b / cast(7 as smallint unsigned), "
    "c / cast(1000 as int unsigned), e / cast(3 as bigint unsigned) from u",
    "select a % cast(3 as tinyint unsigned), b % cast(10 as smallint unsigned), "
    "c % cast(9 as int unsigned), e % cast(7 as bigint unsigned) from u",
    "select e / e, e % e, a / a, c % c from u",
    "select e / (e - 1), e % (e - 1), e / (e + 1), e % (e + 1) from u",
    "select a / 3, b / 7, c / 1000, e / 3 from u",
    # comparisons, mixed signedness widened before the compare
    "select e from u where e > 9223372036854775807",
    "select e from u where e < 9223372036854775807",
    "select e, i from u where e > i",
    "select c, i from u where c > i",
    "select b, i from u where b = i",
    "select e, g from u where e >= g",
    "select a < b, c >= e, e <> a, b <= c from u",
    "select e from u where e in (1, 9223372036854775807)",
    "select e from u where e between 1 and 9223372036854775807",
    "select case when a > 100 then e else c end, case when e > 5 then a end from u",
    # literals at and above INT64_MAX
    "select 9223372036854775807, 9223372036854775808, 18446744073709551615",
    "select e from u where e > 9223372036854775808",
    # ORDER BY, LIMIT, DISTINCT
    "select e from u order by e",
    "select e from u order by e desc",
    "select a, b, c from u order by c desc, a",
    "select e from u order by e limit 3",
    "select distinct e from u order by e",
    # GROUP BY keys and aggregates
    "select e, count(*) from u group by e",
    "select a, count(*), sum(i) from u group by a order by a",
    "select b % cast(2 as smallint unsigned) as k, sum(c), count(e) from u group by k",
    "select sum(a), sum(b), sum(c), sum(e), count(e) from u",
    "select avg(a), avg(b), avg(c), avg(e) from u",
    "select min(a), max(a), min(b), max(b), min(c), max(c), min(e), max(e) from u",
    "select count(distinct e), count(distinct a), sum(distinct c) from u",
    "select a > 100 as hi, sum(e), min(e), max(e), avg(e) from u group by hi",
    "select i, min(e), max(e), sum(e) from u group by i order by i",
    # joins on unsigned keys
    "select x.e, y.i from u x join u y on x.e = y.e order by x.e",
    "select x.a, y.c from u x join u y on x.c = y.c order by x.a",
    "select x.b from u x where x.e in (select e from u where e > 2)",
    "select x.a, y.a from u x left join u y on x.a = y.a + cast(1 as tinyint unsigned)",
    # casts across the types, checked and safe
    "select cast(e as double), cast(e as float), cast(c as double), cast(a as double) from u",
    "select cast(e as bigint) from u",
    "select cast(e as bigint) from u where e < 9223372036854775808",
    "select cast(g as bigint unsigned) from u",
    "select cast(g as bigint unsigned) from u where g >= 0",
    "select cast(i as int unsigned) from u",
    "select cast(i as int unsigned) from u where i >= 0",
    "select cast(c as smallint unsigned) from u",
    "select cast(b as tinyint) from u where b < 128",
    "select cast(a as varchar), cast(e as varchar) from u",
    "select cast(cast(e as varchar) as bigint unsigned) from u",
    "select cast(cast(c as double) as int unsigned) from u",
    "select cast(a as smallint unsigned) + b from u",
]


@pytest.mark.parametrize("sql", SMALL_SQL, ids=[s[:70] for s in SMALL_SQL])
def test_unsigned_sql_matches_reference(small_dbs, sql):
    ref, port = small_dbs
    ref.last_fused_routes, port.last_fused_routes = [], []
    _same(ref, port, sql)
    assert port.last_fused_routes == ref.last_fused_routes


DDL_CASES = [
    # insert_table.slt: `insert into t3(v1) values (1481)` on TINYINT UNSIGNED
    "insert into t3(v1) values (1481)",
    "insert into t3(v1) values (-1)",
    "insert into t3(v2) values (65536)",
    "insert into t3(v3) values (4294967296)",
    "insert into t3(v4) values (-1)",
    "insert into t3 values (255, 65535, 4294967295, 9223372036854775807)",
    "insert into t3 values (0, 0, 0, 0), (1, 2, 3, 4)",
    "select * from t3",
    "select v1 + v1, v2 * v2, v3 - v4 from t3",
    "create table t4 as select v1, v4 from t3 where v1 > 0",
    "select * from t4",
    "insert into t4 select v2, v3 from t3",
]


def test_ddl_and_insert_overflow_errors():
    ref = sqlrs_tpu.Database()
    port = sqlrs_tpu_torch.Database(device="cpu")
    ddl = (
        "create table t3(v1 tinyint unsigned, v2 smallint unsigned, "
        "v3 int unsigned, v4 bigint unsigned)"
    )
    ref.run(ddl)
    port.run(ddl)
    outcomes = [_same(ref, port, sql)[0] for sql in DDL_CASES]
    # every overflow is a statement error; the last narrows USMALLINT
    # 65535 into UTINYINT
    assert outcomes == ["error"] * 5 + ["ok"] * 6 + ["error"]
    assert port.run_lines("select count(*) from t3") == ["3"]


@pytest.mark.parametrize("v", EDGES)
def test_ubigint_to_double_rounds_once(small_dbs, v):
    """UBIGINT -> DOUBLE/FLOAT round as numpy's uint64 conversions do."""
    port = sqlrs_tpu_torch.Database(device="cpu")
    ref = sqlrs_tpu.Database()
    _make(ref, port, "x", [("e", "UBIGINT", np.array([v], np.uint64))])
    _same(ref, port, "select cast(e as double), cast(e as float) from x")
    ((d, f),) = port.run("select cast(e as double), cast(e as float) from x")[0].to_pylist()
    assert d == float(np.array([v], np.uint64).astype(np.float64)[0])
    assert f == float(np.array([v], np.uint64).astype(np.float32)[0])


def test_host_boundary_round_trip():
    """numpy uint* in (Column.from_numpy, create_memory_table_numpy,
    import_tables), the same uint* values out (to_pylist, data_np)."""
    rng = np.random.default_rng(7)
    arrays = {
        LT.UTINYINT: np.array([0, 255, 17], np.uint8),
        LT.USMALLINT: np.array([0, 65535, 40000], np.uint16),
        LT.UINTEGER: np.array([0, 2**32 - 1, 3 * 10**9], np.uint32),
        LT.UBIGINT: np.array(EDGES, np.uint64),
    }
    for t, a in arrays.items():
        col = Column.from_numpy(t, a, device="cpu")
        assert col.data.dtype == torch_dtype_for(t)
        out = col.data_np()
        assert out.dtype == a.dtype and np.array_equal(out, a)
        assert col.to_pylist() == [int(x) for x in a]
        assert [col.scalar_at(i).value for i in range(len(a))] == [int(x) for x in a]
        assert np.array_equal(storage_np(t, a), col.data.numpy())
    db = sqlrs_tpu_torch.Database(device="cpu")
    db.create_memory_table_numpy(
        "m", [(t.name.lower(), t) for t in arrays], [a[:3] for a in arrays.values()]
    )
    assert db.run_lines("select * from m") == [
        "0 0 0 0", "255 65535 4294967295 1", "17 40000 3000000000 9007199254740993"
    ]
    e = rng.integers(0, U64 - 1, 100, dtype=np.uint64, endpoint=True)
    valid = rng.random(100) > 0.2
    import_tables(db, {"n": [("e", "UBIGINT", e, valid)]})
    (b,) = db.run("select e from n")
    assert b.to_pylist() == [[int(x)] if ok else [None] for x, ok in zip(e, valid)]


def test_rendering():
    port = sqlrs_tpu_torch.Database(device="cpu")
    ref = sqlrs_tpu.Database()
    _make(ref, port, "r", [
        ("a", "UTINYINT", np.array([255], np.uint8)),
        ("b", "USMALLINT", np.array([65535], np.uint16)),
        ("c", "UINTEGER", np.array([2**32 - 1], np.uint32)),
        ("e", "UBIGINT", np.array([U64 - 1], np.uint64)),
    ])
    expect = ["255 65535 4294967295 18446744073709551615"]
    assert port.run_lines("select * from r") == expect == ref.run_lines("select * from r")
    sql = "select e + cast(1 as bigint unsigned), e * e, e + 1 from r"
    assert port.run_lines(sql) == ["0 1 1.8446744073709552e+19"] == ref.run_lines(sql)


# ---- 2^17 rows: kernel 1's path (plain version here), the sorted path ------------

N_BIG = 1 << 17


def _big_cols(seed=0):
    rng = np.random.default_rng(seed)
    n = N_BIG
    cols = [
        ("k", "INTEGER", rng.integers(0, 64, n).astype(np.int32)),
        ("a", "UTINYINT", rng.integers(0, 256, n).astype(np.uint8)),
        ("b", "USMALLINT", rng.integers(0, 2**16, n).astype(np.uint16)),
        ("c", "UINTEGER", rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)),
        ("d", "UBIGINT", rng.integers(0, 2**36, n, dtype=np.uint64)),
        ("e", "UBIGINT", rng.integers(0, U64 - 1, n, dtype=np.uint64, endpoint=True)),
        # straddles 2^63: the value stats must see these as large values
        ("h", "UBIGINT", np.uint64(2**63 - 2**20) + rng.integers(0, 2**21, n, dtype=np.uint64)),
    ]
    valids = {c: rng.random(n) > 0.01 for c, _t, _a in cols}
    return cols, valids


@pytest.fixture(scope="module")
def big_dbs():
    ref = sqlrs_tpu.Database()
    port = sqlrs_tpu_torch.Database(device="cpu")
    sharded = sqlrs_tpu_torch.Database(device="cpu", n_devices=8)
    cols, valids = _big_cols()
    _make(ref, [port, sharded], "u", cols, valids)
    rng = np.random.default_rng(1)
    e = dict((c, a) for c, _t, a in cols)["e"]
    sel = rng.choice(N_BIG, 1 << 12, replace=False)
    v = [("e2", "UBIGINT", e[sel]), ("w", "BIGINT", np.arange(len(sel), dtype=np.int64))]
    _make(ref, [port, sharded], "v", v)
    return ref, port, sharded, cols, valids


@pytest.fixture(autouse=True)
def _mxu_interpret(monkeypatch):
    # kernel 1's plain version in the port, the reference's Pallas kernel
    # in interpret mode, at the default 2^17-row threshold
    monkeypatch.setenv("SQLRS_TPU_MXU", "interpret")


BIG_SQL = [
    "select k, count(*), sum(a), sum(b), sum(c), sum(d), avg(c) from u group by k order by k",
    "select k, sum(d), avg(d), count(d) from u where a > 100 group by k",
    "select e from u order by e limit 5",
    "select e from u order by e desc limit 5",
    "select h from u where h >= 9223372036854775807 order by h limit 5",
    "select sum(a * b), sum(c * c), sum(e * e), sum(c / cast(7 as int unsigned)), "
    "sum(e % cast(1000 as bigint unsigned)), sum(b % cast(100 as smallint unsigned)) from u",
    "select count(*), sum(w) from u join v on u.e = v.e2",
    "select a, count(*), sum(e) from u group by a order by a limit 5",
    "select b % cast(7 as smallint unsigned) as g, sum(c), max(e), max(h) from u "
    "group by g order by g",
    "select count(distinct a), count(distinct h) from u",
    "select min(e), max(e), min(h), max(h), sum(h), avg(h) from u",
]


@pytest.mark.parametrize("sql", BIG_SQL, ids=[s[:70] for s in BIG_SQL])
def test_big_unsigned_matches_reference(big_dbs, sql):
    ref, port, sharded, _c, _v = big_dbs
    ref.last_fused_routes, port.last_fused_routes = [], []
    p = _same(ref, port, sql)
    assert port.last_fused_routes == ref.last_fused_routes
    if sql.startswith("select k, count(*)"):
        assert port.last_fused_routes == ["hashagg_mxu"]  # kernel 1's path
    # 8 CPU shards give the single-device rows
    _rows_equal(p[1], sharded.run(sql))


def _oracle_group_ubigint(cols, valids, col):
    """k -> (sum mod 2^64, min, max, avg) over the valid rows of `col`,
    NULL keys as their own group; exact Python integers."""
    data = dict((c, a) for c, _t, a in cols)
    k, kv = data["k"], valids["k"]
    v, vv = data[col], valids[col]
    out = {}
    for key in [None] + sorted(set(k[kv].tolist())):
        rows = ~kv if key is None else (kv & (k == key))
        vals = [int(x) for x in v[rows & vv]]
        out[key] = (sum(vals) % U64, min(vals), max(vals), sum(vals) / len(vals))
    return out


@pytest.mark.parametrize("col", ["e", "h"])
def test_big_grouped_ubigint_against_oracle(big_dbs, col):
    """sum/min/max/avg of UBIGINT on both sides of 2^63 by the sorted-run
    path, one device and 8 shards, against exact integers. (The reference
    raises OverflowError here: its min/max sentinel 2^64-1 does not fit
    the int64 argument of its block-path program.)"""
    ref, port, sharded, cols, valids = big_dbs
    sql = f"select k, sum({col}), min({col}), max({col}), avg({col}) from u group by k order by k"
    with pytest.raises(OverflowError):
        ref.run(sql)
    oracle = _oracle_group_ubigint(cols, valids, col)
    for db in (port, sharded):
        db.last_fused_routes = []
        (b,) = db.run(sql)
        assert db.last_fused_routes == []  # the value guard turns kernel 1 down
        rows = b.to_pylist()
        assert len(rows) == len(oracle)
        for key, s, lo, hi, avg in rows:
            es, elo, ehi, eavg = oracle[key]
            assert (s, lo, hi) == (es, elo, ehi)
            assert avg == pytest.approx(eavg, rel=1e-9)


def test_big_ungrouped_ubigint_against_oracle(big_dbs):
    _ref, port, sharded, cols, valids = big_dbs
    data = dict((c, a) for c, _t, a in cols)
    for col in ("e", "h"):
        vals = [int(x) for x in data[col][valids[col]]]
        expect = [sum(vals) % U64, min(vals), max(vals)]
        sql = f"select sum({col}), min({col}), max({col}), avg({col}) from u"
        for db in (port, sharded):
            ((s, lo, hi, avg),) = db.run(sql)[0].to_pylist()
            assert [s, lo, hi] == expect
            assert avg == pytest.approx(sum(vals) / len(vals), rel=1e-9)
