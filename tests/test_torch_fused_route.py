"""The fused star-rollup route (sqlrs_tpu_torch/exec/fused_route.py) against
the reference route (sqlrs_tpu/exec/fused_route.py): the same SQL and data
through sqlrs_tpu.Database (JAX on the CPU, the dense-group Pallas kernel in
interpret mode where SQLRS_TPU_MXU=interpret) and
sqlrs_tpu_torch.Database(device="cpu").

Where the reference routes, the port must log the same route names and give
the same rows: integer columns and k-dp decimal sums identical, other
floats to rel 1e-12 (payload sums are taken in another order). Where the
reference runs its general join path instead, so does the port: no route
logged by either, and the same rows (floats to rel 1e-12). These are the
SQL families of tests/test_fused_route.py.
"""

import numpy as np
import pytest

import sqlrs_tpu
import sqlrs_tpu_torch
from sqlrs_tpu.data import DeviceBatch as RefBatch
from sqlrs_tpu.data import Schema as RefSchema
from sqlrs_tpu.types import LogicalType as RefLT
from sqlrs_tpu_torch.data import DeviceBatch, Schema
from sqlrs_tpu_torch.exec.executor import Executor
from sqlrs_tpu_torch.types import LogicalType as LT

SQL = ("select d.k, sum(f.v), count(*) from f join d on f.k = d.k "
       "group by d.k order by d.k")
MISS = 10_000_019


def _dbs(tables):
    """tables: name -> ([(column, type name)], {column: python list})."""
    ref, port = sqlrs_tpu.Database(), sqlrs_tpu_torch.Database(device="cpu")
    for name, (cols, data) in tables.items():
        ref.create_memory_table(name, RefBatch.from_pydict(
            RefSchema.of([(c, RefLT[t]) for c, t in cols]), data))
        port.create_memory_table(name, DeviceBatch.from_pydict(
            Schema.of([(c, LT[t]) for c, t in cols]), data, device="cpu"))
    return ref, port


def _fact_dim(fk, fv, dim, fk_list=None):
    return _dbs({
        "f": ([("k", "BIGINT"), ("v", "BIGINT")],
              {"k": fk.tolist() if fk_list is None else fk_list, "v": fv.tolist()}),
        "d": ([("k", "BIGINT")], {"k": np.asarray(dim).tolist()}),
    })


def _mk(fact_rows, dim_keys, seed=0, null_every=None):
    """tests/test_fused_route.py's _mk_db: fact keys drawn from the dim
    keys, every 7th a miss above them, values in [0, 1000)."""
    rng = np.random.default_rng(seed)
    dim = np.asarray(dim_keys, dtype=np.int64)
    fk = dim[rng.integers(0, len(dim), fact_rows)].astype(np.int64)
    fk[::7] = MISS
    fv = rng.integers(0, 1000, fact_rows).astype(np.int64)
    fk_list = fk.tolist()
    if null_every:
        fk_list = [None if i % null_every == 0 else v for i, v in enumerate(fk_list)]
    return _fact_dim(fk, fv, dim, fk_list)


def _rows(batches):
    return [(b.schema.types, r) for b in batches for r in b.to_pylist()]


def _same(ref, port, sql, rel=0.0):
    """Run sql through both; equal rows (floats to `rel`) and equal route
    logs. Returns the routes."""
    ref.last_fused_routes, port.last_fused_routes = [], []
    rb, pb = ref.run(sql), port.run(sql)
    assert [b.schema.names for b in rb] == [b.schema.names for b in pb], sql
    r_rows, p_rows = _rows(rb), _rows(pb)
    assert len(r_rows) == len(p_rows), sql
    for (types, rr), (_, pr) in zip(r_rows, p_rows):
        for t, x, y in zip(types, rr, pr):
            if t.name in ("DOUBLE", "FLOAT") and x is not None and y is not None and rel:
                assert y == pytest.approx(x, rel=rel, abs=0), (sql, rr, pr)
            else:
                assert x == y, (sql, rr, pr)
    assert port.last_fused_routes == ref.last_fused_routes, sql
    return list(ref.last_fused_routes)


def _unrouted(ref, port, sql):
    """The reference runs sql on its general path (no route); so does the
    port, with the same rows and no route logged either."""
    assert _same(ref, port, sql, rel=1e-12) == [], sql


@pytest.mark.parametrize("dim_keys", [
    np.arange(64) + 100,            # dense span
    np.arange(64) * 13 + 5,         # sparse
    np.arange(64) * 977 - 3000,     # negative keys
], ids=["dense", "sparse", "negative"])
@pytest.mark.parametrize("order", [" order by d.k", ""], ids=["ordered", "firstapp"])
def test_route_matches_reference(dim_keys, order):
    ref, port = _mk(5000, dim_keys, seed=1)
    sql = ("select d.k, sum(f.v), count(*) from f join d on f.k = d.k "
           "group by d.k" + order)
    assert _same(ref, port, sql)


def test_null_fact_keys_and_count_v():
    ref, port = _mk(3000, np.arange(32) + 7, seed=2, null_every=11)
    assert _same(ref, port, "select d.k, count(f.v), sum(f.v) from f join d "
                 "on f.k = d.k group by d.k order by d.k")


def test_group_on_fact_side_key():
    ref, port = _mk(2000, np.arange(16) * 3, seed=3)
    assert _same(ref, port, "select f.k, count(*) from f join d on f.k = d.k "
                 "group by f.k order by f.k")


def test_route_numpy_oracle():
    rng = np.random.default_rng(5)
    dim = (np.arange(48) * 7 + 1).astype(np.int64)
    gid = rng.integers(0, 48, 4096)
    fv = rng.integers(0, 100, 4096).astype(np.int64)
    ref, port = _fact_dim(dim[gid], fv, dim)
    assert _same(ref, port, SQL)
    exp_s, exp_c = np.zeros(48, np.int64), np.zeros(48, np.int64)
    np.add.at(exp_s, gid, fv)
    np.add.at(exp_c, gid, 1)
    assert port.run_lines(SQL) == [
        f"{k} {s} {c}" for k, s, c in zip(dim, exp_s, exp_c) if c > 0
    ]


def test_min_max_avg():
    ref, port = _mk(4000, np.arange(40) * 3 + 11, seed=6)
    assert _same(ref, port, "select d.k, min(f.v), max(f.v), avg(f.v), count(*) "
                 "from f join d on f.k = d.k group by d.k order by d.k")


@pytest.mark.parametrize("sql", [
    # fact on the left (dim right): the dim table's original row order
    "select d.k, sum(f.v), count(*) from f join d on f.k = d.k group by d.k",
    # fact on the right (dim left): the first matching fact row
    "select d.k, sum(f.v), count(*) from d join f on f.k = d.k group by d.k",
    # avg and negative values (payload sums need no packing)
    "select d.k, avg(f.v), count(f.v) from f join d on f.k = d.k group by d.k",
], ids=["fact_left", "fact_right", "avg"])
def test_firstapp_order(sql):
    dim = np.array([50, 7, 93, 22, 68, 1, 39, 84, 15, 61], dtype=np.int64)
    rng = np.random.default_rng(8)
    fk = dim[rng.integers(0, len(dim), 3000)].copy()
    fk[::9] = 999
    fv = rng.integers(-50, 50, 3000).astype(np.int64)
    ref, port = _fact_dim(fk, fv, dim)
    assert any("firstapp" in r for r in _same(ref, port, sql))


@pytest.fixture(scope="module")
def named_dim_dbs():
    rng = np.random.default_rng(12)
    dim = np.array([30, 4, 18, 92, 55, 11, 73, 47], dtype=np.int64)
    names = [" containerA", None, "containerC", "d", "e", "f", "g", "h"]
    fk = dim[rng.integers(0, len(dim), 2500)].copy()
    fk[::9] = 999
    fv = rng.integers(-40, 80, 2500).astype(np.int64)
    return _dbs({
        "f": ([("k", "BIGINT"), ("v", "BIGINT")], {"k": fk.tolist(), "v": fv.tolist()}),
        "d": ([("k", "BIGINT"), ("name", "VARCHAR")], {"k": dim.tolist(), "name": names}),
    })


@pytest.mark.parametrize("sql,route", [
    # extra dim group columns (functionally dependent on the key)
    ("select d.k, d.name, sum(f.v) from f join d on f.k = d.k "
     "group by d.k, d.name order by d.k", "order_agg_join_direct"),
    ("select d.k, d.name, sum(f.v), count(*) from f join d on f.k = d.k "
     "group by d.k, d.name", "agg_join_firstapp"),
    ("select d.k, d.name, count(*) from d join f on f.k = d.k "
     "group by d.k, d.name", "agg_join_firstapp"),
    # the key at any position of the GROUP BY list
    ("select d.name, d.k, sum(f.v), count(*) from f join d "
     "on f.k = d.k group by d.name, d.k", "agg_join_firstapp"),
    ("select d.name, f.k, sum(f.v) from f join d on f.k = d.k "
     "group by d.name, f.k", "agg_join_firstapp"),
    ("select d.k, f.k, count(*) from f join d on f.k = d.k "
     "group by d.k, f.k", "agg_join_firstapp"),
    # ORDER BY a dim attribute: the ordered route bails, the first-
    # appearance route fires under the general ORDER BY
    ("select d.name, d.k, sum(f.v) from f join d on f.k = d.k "
     "group by d.name, d.k order by d.name", "agg_join_firstapp"),
])
def test_dim_group_columns(named_dim_dbs, sql, route):
    routes = _same(*named_dim_dbs, sql)
    assert any(route in r for r in routes), routes


@pytest.mark.parametrize("sql", [
    "select d.k, sum(f.v * 2 + 1), count(*) from f join d on f.k = d.k "
    "group by d.k order by d.k",
    "select d.k, sum(f.v * 3), avg(f.v * 3) from f join d on f.k = d.k "
    "group by d.k",
    # two different value expressions: the second rides as a payload
    "select d.k, sum(f.v + f.v), avg(f.v * 3) from f join d "
    "on f.k = d.k group by d.k",
])
def test_value_expressions(sql):
    assert _same(*_mk(2000, np.arange(24) * 5 + 2, seed=14), sql)


@pytest.fixture(scope="module")
def multi_dbs():
    rng = np.random.default_rng(21)
    dim = (np.arange(32) * 3 + 4).astype(np.int64)
    fk = dim[rng.integers(0, len(dim), 4000)].copy()
    fk[::13] = MISS
    fa = rng.integers(0, 500, 4000).astype(np.int64)
    fb = rng.integers(-80, 80, 4000).astype(np.int64)
    return _dbs({
        "f": ([("k", "BIGINT"), ("a", "BIGINT"), ("b", "BIGINT")],
              {"k": fk.tolist(), "a": fa.tolist(), "b": fb.tolist()}),
        "d": ([("k", "BIGINT")], {"k": dim.tolist()}),
    })


@pytest.mark.parametrize("sql,route", [
    ("select d.k, sum(f.a), min(f.a), max(f.a), sum(f.b), avg(f.b), "
     "count(*) from f join d on f.k = d.k group by d.k order by d.k",
     "order_agg_join_direct"),
    ("select d.k, sum(f.b), sum(f.a), count(*) from f join d "
     "on f.k = d.k group by d.k order by d.k", "order_agg_join_direct"),
    ("select d.k, sum(f.a), sum(f.b), avg(f.a), count(f.b) "
     "from f join d on f.k = d.k group by d.k", "agg_join_firstapp"),
    ("select d.k, sum(f.a * 2 + f.b), sum(f.b), min(f.a) from f join d "
     "on f.k = d.k group by d.k order by d.k", "order_agg_join_direct"),
])
def test_multi_value_columns(multi_dbs, sql, route):
    routes = _same(*multi_dbs, sql)
    assert any(route in r for r in routes), routes


@pytest.mark.parametrize("sql", [
    # two different min/max expressions cannot both pack
    "select d.k, min(f.a), max(f.b) from f join d on f.k = d.k "
    "group by d.k order by d.k",
    # two different DISTINCT expressions cannot both pack
    "select d.k, count(distinct f.a), sum(distinct f.a + 1) "
    "from f join d on f.k = d.k group by d.k order by d.k",
    # ineligible shapes: left join, a residual across both sides, and
    # DISTINCT without ORDER BY
    "select d.k, sum(f.a) from d left join f on f.k=d.k group by d.k order by d.k",
    "select d.k, sum(f.a) from f join d on f.k=d.k and f.a > d.k "
    "group by d.k order by d.k",
    "select d.k, count(distinct f.a) from f join d on f.k=d.k group by d.k",
    # a float DISTINCT (would need value-equality packing)
    "select d.k, count(distinct f.a * 0.5) from f join d on f.k = d.k "
    "group by d.k order by d.k",
], ids=["two_minmax", "two_distinct", "left_join", "cross_residual",
        "distinct_unordered", "float_distinct"])
def test_ineligible_shapes_take_the_general_operators(multi_dbs, sql):
    """Shapes the route turns down run the general join and GROUP BY, in
    the port as in the reference."""
    _unrouted(*multi_dbs, sql)


@pytest.fixture(scope="module")
def nullable_dbs():
    rng = np.random.default_rng(31)
    dim = (np.arange(24) * 2 + 1).astype(np.int64)
    n = 3000
    fk = dim[rng.integers(0, len(dim), n)].copy()
    fk[::17] = MISS
    fv = rng.integers(-30, 120, n)
    vals = [None if i % 5 == 0 else int(v) for i, v in enumerate(fv)]
    # key 1 (dim[0]) gets ONLY NULL values: its sums/min/max render NULL
    vals = [None if k == dim[0] else v for k, v in zip(fk.tolist(), vals)]
    fw = rng.integers(0, 15, n)
    wvals = [None if i % 4 == 0 else int(v) for i, v in enumerate(fw)]
    wvals = [None if k == dim[0] else v for k, v in zip(fk.tolist(), wvals)]
    return _dbs({
        "f": ([("k", "BIGINT"), ("v", "BIGINT"), ("w", "BIGINT")],
              {"k": fk.tolist(), "v": vals, "w": wvals}),
        "d": ([("k", "BIGINT")], {"k": dim.tolist()}),
    })


@pytest.mark.parametrize("sql", [
    "select d.k, sum(f.v), count(f.v), count(*) from f join d "
    "on f.k = d.k group by d.k order by d.k",
    "select d.k, avg(f.v), count(f.v) from f join d on f.k = d.k group by d.k",
    # sentinel mode: NULL-able min/max/DISTINCT pack NULLs above the range
    "select d.k, min(f.w), max(f.w), sum(f.w), count(*) from f join d "
    "on f.k = d.k group by d.k order by d.k",
    "select d.k, count(distinct f.w), sum(distinct f.w), avg(f.w) "
    "from f join d on f.k = d.k group by d.k order by d.k",
    "select d.k, max(f.w), sum(f.v), count(f.v) from f join d "
    "on f.k = d.k group by d.k order by d.k",
])
def test_nullable_value_columns(nullable_dbs, sql):
    assert _same(*nullable_dbs, sql)


@pytest.fixture(scope="module")
def distinct_case():
    rng = np.random.default_rng(41)
    dim = (np.arange(20) * 4 + 3).astype(np.int64)
    fk = dim[rng.integers(0, len(dim), 2500)].copy()
    fk[::11] = MISS
    fv = rng.integers(0, 12, 2500).astype(np.int64)  # few values: many dups
    return _fact_dim(fk, fv, dim), fk, fv


@pytest.mark.parametrize("sql", [
    "select d.k, count(distinct f.v), count(*) from f join d "
    "on f.k = d.k group by d.k order by d.k",
    "select d.k, sum(distinct f.v), sum(f.v) from f join d "
    "on f.k = d.k group by d.k order by d.k",
    "select d.k, avg(distinct f.v), min(f.v), max(f.v) from f join d "
    "on f.k = d.k group by d.k order by d.k",
])
def test_distinct_aggregates(distinct_case, sql):
    (ref, port), _, _ = distinct_case
    assert _same(ref, port, sql)


def test_distinct_numpy_oracle(distinct_case):
    (_, port), fk, fv = distinct_case
    port.last_fused_routes = []
    got = port.run_lines("select d.k, count(distinct f.v) from f join d "
                         "on f.k = d.k group by d.k order by d.k")
    assert port.last_fused_routes
    exp = {}
    for k, v in zip(fk[fk != MISS], fv[fk != MISS]):
        exp.setdefault(int(k), set()).add(int(v))
    assert got == [f"{k} {len(vs)}" for k, vs in sorted(exp.items())]


def test_multi_value_numpy_oracle():
    rng = np.random.default_rng(22)
    dim = np.arange(20, dtype=np.int64) + 3
    gid = rng.integers(0, len(dim), 2048)
    fa = rng.integers(0, 90, 2048).astype(np.int64)
    fb = rng.integers(-40, 40, 2048).astype(np.int64)
    ref, port = _dbs({
        "f": ([("k", "BIGINT"), ("a", "BIGINT"), ("b", "BIGINT")],
              {"k": dim[gid].tolist(), "a": fa.tolist(), "b": fb.tolist()}),
        "d": ([("k", "BIGINT")], {"k": dim.tolist()}),
    })
    sql = ("select d.k, sum(f.a), sum(f.b), count(*) from f join d "
           "on f.k = d.k group by d.k order by d.k")
    assert _same(ref, port, sql)
    sa, sb, cnt = (np.zeros(len(dim), np.int64) for _ in range(3))
    np.add.at(sa, gid, fa)
    np.add.at(sb, gid, fb)
    np.add.at(cnt, gid, 1)
    assert port.run_lines(sql) == [
        f"{k} {x} {y} {c}" for k, x, y, c in zip(dim, sa, sb, cnt) if c > 0
    ]


@pytest.mark.parametrize("sql", [
    # DESC: the kernel's ascending output, reversed
    "select d.k, sum(f.v) from f join d on f.k=d.k group by d.k order by d.k desc",
    "select d.k, min(f.v), count(distinct f.v) from f join d on f.k=d.k "
    "group by d.k order by d.k desc",
    # a single-side residual is pushed into the fact scan and then routes
    "select d.k, sum(f.v), count(*) from f join d on f.k=d.k and f.v > 10 "
    "group by d.k order by d.k",
    "select d.k, sum(f.v), count(*) from f join d on f.k=d.k "
    "where f.v > 10 group by d.k order by d.k",
])
def test_desc_and_pushed_residual(sql):
    routes = _same(*_mk(1500, np.arange(16) + 1, seed=4), sql)
    assert any("order_agg_join_direct" in r for r in routes), routes


def _scan_counter(monkeypatch):
    calls = []
    original = Executor._exec_TableScan

    def counting(self, op):
        calls.append(op.function_name)
        return original(self, op)

    monkeypatch.setattr(Executor, "_exec_TableScan", counting)
    return calls


def test_duplicate_dim_keys_raise_after_one_scan_each(monkeypatch):
    """Duplicate 'dim' keys must not route (pairs multiply): both engines
    run their general join, with the same rows. The route executes both
    children before its stats show the duplicates; the ORDER BY route, then
    the GROUP BY route, then the general path all ask for them again, and
    the one-shot route cache must hand the same batches back instead of
    scanning twice."""
    ref, port = _dbs({
        "f": ([("k", "BIGINT"), ("v", "BIGINT")],
              {"k": [1, 1, 2, 3], "v": [10, 20, 30, 40]}),
        "d": ([("k", "BIGINT")], {"k": [1, 1, 2]}),
    })
    ref.last_fused_routes = []
    assert ref.run_lines(SQL) == ["1 60 4", "2 30 1"]
    assert not ref.last_fused_routes
    calls = _scan_counter(monkeypatch)
    port.last_fused_routes = []
    assert port.run_lines(SQL) == ["1 60 4", "2 30 1"]
    assert port.last_fused_routes == []
    assert len(calls) == 2, calls


def test_routed_query_scans_each_table_once(monkeypatch):
    ref, port = _mk(500, np.arange(8) + 1, seed=9)
    calls = _scan_counter(monkeypatch)
    assert _same(ref, port, SQL)
    assert len(calls) == 2, calls


def test_route_fuzz_differential():
    """tests/test_fused_route.py's seeded fuzz: random dim spans, NULL
    densities, value ranges and aggregate lists. Where the reference routes
    the port must match it; where it does not, both run the general path
    to the same rows."""
    rng = np.random.default_rng(77)
    agg_pool = [
        "sum(f.a)", "sum(f.b)", "count(f.a)", "count(f.b)", "count(*)",
        "avg(f.a)", "avg(f.b)", "min(f.a)", "max(f.a)",
        "sum(f.a + f.b)", "count(distinct f.a)", "sum(distinct f.a)",
    ]
    fired_total = 0
    for case in range(10):
        g = int(rng.integers(4, 40))
        dense = bool(rng.integers(0, 2))
        base = int(rng.integers(-50, 50))
        dim = (np.arange(g) + base if dense
               else np.cumsum(rng.integers(1, 9, g)) + base).astype(np.int64)
        n = int(rng.integers(200, 1500))
        fk = dim[rng.integers(0, g, n)].copy()
        fk[:: int(rng.integers(5, 15))] = dim.max() + 7
        fa = rng.integers(0, int(rng.integers(2, 200)), n).astype(np.int64)
        fb = rng.integers(-100, 100, n).astype(np.int64)
        null_a = int(rng.integers(0, 3))
        avals = [None if (null_a and i % (null_a * 7) == 0) else int(v)
                 for i, v in enumerate(fa)]
        ref, port = _dbs({
            "f": ([("k", "BIGINT"), ("a", "BIGINT"), ("b", "BIGINT")],
                  {"k": fk.tolist(), "a": avals, "b": fb.tolist()}),
            "d": ([("k", "BIGINT")], {"k": dim.tolist()}),
        })
        aggs = ", ".join(rng.choice(agg_pool, int(rng.integers(1, 5)), replace=False))
        order = " order by d.k" if rng.integers(0, 2) else ""
        sql = f"select d.k, {aggs} from f join d on f.k = d.k group by d.k{order}"
        ref.last_fused_routes = []
        ref.run(sql)
        if ref.last_fused_routes:
            assert _same(ref, port, sql), (case, sql)
            fired_total += 1
        else:
            _unrouted(ref, port, sql)
    assert fired_total >= 5, f"routes fired in only {fired_total}/10 cases"


def test_varchar_key_routes_firstapp():
    """VARCHAR join keys (dictionary codes, one dictionary for both tables)
    route through the first-appearance variant; the ORDER BY variant bails
    and the general ORDER BY sorts the routed rows."""
    ref, port = _dbs({
        "f": ([("name", "VARCHAR"), ("v", "BIGINT")],
              {"name": ["mid", "zeta", "zeta", "nope", "beta", None, "mid", "alpha"],
               "v": [1, 2, 3, 4, 5, 6, 7, 8]}),
        "d": ([("name", "VARCHAR")], {"name": ["zeta", "alpha", "mid", "omega", "beta"]}),
    })
    sql = ("select d.name, sum(f.v), count(*) from f join d "
           "on f.name = d.name group by d.name")
    assert any("firstapp" in r for r in _same(ref, port, sql))
    assert port.run_lines(sql) == ["zeta 5 2", "alpha 8 1", "mid 8 2", "beta 5 1"]
    routes = _same(ref, port, sql + " order by d.name")
    assert not any("order_agg" in r for r in routes), routes


@pytest.fixture(scope="module")
def composite_case():
    rng = np.random.default_rng(55)
    k1 = np.repeat(np.arange(6, dtype=np.int64) * 3 + 10, 4)
    k2 = np.tile(np.array([2, 5, 7, 11], dtype=np.int64), 6)
    n = 4000
    pick = rng.integers(0, len(k1), n)
    fk1, fk2 = k1[pick].copy(), k2[pick].copy()
    fk1[::9] = 999          # major miss
    fk2[::7] = 100          # minor OUT OF the dim span (would alias if unmasked)
    fk2[3::13] = 6          # minor in span but not a dim value
    fv = rng.integers(0, 50, n).astype(np.int64)
    k1l = fk1.tolist()
    k1l[5] = None           # NULL major key
    dbs = _dbs({
        "f": ([("a", "BIGINT"), ("b", "BIGINT"), ("v", "BIGINT")],
              {"a": k1l, "b": fk2.tolist(), "v": fv.tolist()}),
        "d": ([("a", "BIGINT"), ("b", "BIGINT")], {"a": k1.tolist(), "b": k2.tolist()}),
    })
    return dbs, (k1, k2, fk1, fk2, fv)


_CK = "from f join d on f.a = d.a and f.b = d.b group by d.a, d.b"


@pytest.mark.parametrize("sql,route", [
    (f"select d.a, d.b, sum(f.v), count(*) {_CK} order by d.a, d.b",
     "order_agg_join_direct"),
    (f"select d.a, d.b, min(f.v), max(f.v), count(distinct f.v) {_CK} "
     "order by d.a, d.b", "order_agg_join_direct"),
    (f"select d.a, d.b, sum(f.v) {_CK} order by d.a desc, d.b desc",
     "order_agg_join_direct"),
    (f"select d.a, d.b, sum(f.v), avg(f.v) {_CK}", "agg_join_firstapp"),
    ("select f.a, f.b, count(*) from f join d on f.a = d.a and "
     "f.b = d.b group by f.a, f.b order by f.a, f.b", "order_agg_join_direct"),
    # ORDER BY one key / mixed directions: the ordered route bails, the
    # first-appearance route fires under the general ORDER BY
    (f"select d.a, d.b, sum(f.v) {_CK} order by d.a", "agg_join_firstapp"),
    (f"select d.a, d.b, sum(f.v) {_CK} order by d.a, d.b desc", "agg_join_firstapp"),
])
def test_composite_key_routes(composite_case, sql, route):
    routes = _same(*composite_case[0], sql)
    assert any(route in r and "_ck2" in r for r in routes), routes


def test_composite_key_oracle_and_fallback(composite_case):
    (ref, port), (k1, k2, fk1, fk2, fv) = composite_case
    port.last_fused_routes = []
    got = port.run_lines(f"select d.a, d.b, sum(f.v), count(*) {_CK} order by d.a, d.b")
    assert port.last_fused_routes
    dimset = set(zip(k1.tolist(), k2.tolist()))
    exp = {}
    for i in range(len(fv)):
        kk = (int(fk1[i]), int(fk2[i]))
        if i != 5 and kk in dimset:
            s, c = exp.get(kk, (0, 0))
            exp[kk] = (s + int(fv[i]), c + 1)
    assert got == [f"{a} {b} {s} {c}" for (a, b), (s, c) in sorted(exp.items())]
    # a group column that is not both key columns: no route at all
    _unrouted(ref, port, "select d.a, count(*) from f join d on f.a = d.a "
              "and f.b = d.b group by d.a")


@pytest.mark.parametrize("seed", range(300, 306))
def test_composite_key_fuzz(seed):
    rng = np.random.default_rng(seed)
    g1, g2 = int(rng.integers(2, 8)), int(rng.integers(2, 8))
    k1 = np.repeat(np.arange(g1, dtype=np.int64) * int(rng.integers(1, 5))
                   + int(rng.integers(-9, 9)), g2)
    k2 = np.tile(np.cumsum(rng.integers(1, 4, g2)).astype(np.int64), g1)
    n = int(rng.integers(200, 1200))
    pick = rng.integers(0, len(k1), n)
    fk1, fk2 = k1[pick].copy(), k2[pick].copy()
    fk1[:: int(rng.integers(5, 11))] = k1.max() + 2
    fk2[:: int(rng.integers(6, 13))] = k2.max() + 7
    fv = rng.integers(-40, 90, n).astype(np.int64)
    ref, port = _dbs({
        "f": ([("a", "BIGINT"), ("b", "BIGINT"), ("v", "BIGINT")],
              {"a": fk1.tolist(), "b": fk2.tolist(), "v": fv.tolist()}),
        "d": ([("a", "BIGINT"), ("b", "BIGINT")], {"a": k1.tolist(), "b": k2.tolist()}),
    })
    aggs = rng.choice(["sum(f.v)", "count(*)", "avg(f.v)", "count(f.v)"],
                      int(rng.integers(1, 4)), replace=False)
    order = ["", " order by d.a, d.b",
             " order by d.a desc, d.b desc"][int(rng.integers(0, 3))]
    sql = (f"select d.a, d.b, {', '.join(aggs)} from f join d "
           f"on f.a = d.a and f.b = d.b group by d.a, d.b{order}")
    assert _same(ref, port, sql), sql


@pytest.mark.parametrize("sql,route", [
    ("select d.dt, sum(f.v), count(*) from f join d on f.dt = d.dt "
     "group by d.dt order by d.dt", "order_agg_join_direct"),
    ("select d.dt, min(f.v), max(f.v) from f join d on f.dt = d.dt "
     "group by d.dt order by d.dt desc", "order_agg_join_direct"),
    ("select d.dt, avg(f.v) from f join d on f.dt = d.dt group by d.dt",
     "agg_join_firstapp"),
])
def test_date_key_routes(sql, route):
    setup = (
        "create table f(dt date, v int);"
        "insert into f values (date '2024-01-01', 3), (date '2024-01-02', 5), "
        "(date '2024-01-01', 7), (date '2030-05-05', 9), (null, 11);"
        "create table d(dt date);"
        "insert into d values (date '2024-01-01'), (date '2024-01-02'), "
        "(date '2024-01-03')"
    )
    ref, port = sqlrs_tpu.Database(), sqlrs_tpu_torch.Database(device="cpu")
    ref.run(setup)
    port.run(setup)
    assert any(route in r for r in _same(ref, port, sql))


@pytest.fixture(scope="module")
def float_dbs():
    rng = np.random.default_rng(91)
    dim = (np.arange(28) * 3 + 2).astype(np.int64)
    n = 3000
    fk = dim[rng.integers(0, len(dim), n)].copy()
    fk[::8] = MISS
    fv = rng.integers(-400, 400, n) / 4.0  # 2-dp decimals (dyadic)
    fw = rng.integers(0, 90, n).astype(np.int64)
    vals = [None if i % 6 == 0 else float(v) for i, v in enumerate(fv)]
    return _dbs({
        "f": ([("k", "BIGINT"), ("x", "DOUBLE"), ("w", "BIGINT")],
              {"k": fk.tolist(), "x": fv.tolist(), "w": fw.tolist()}),
        "fn": ([("k", "BIGINT"), ("x", "DOUBLE")], {"k": fk.tolist(), "x": vals}),
        "d": ([("k", "BIGINT")], {"k": dim.tolist()}),
    })


@pytest.mark.parametrize("sql,route", [
    ("select d.k, sum(f.x), count(*) from f join d on f.k = d.k "
     "group by d.k order by d.k", "order_agg_join_direct"),
    ("select d.k, sum(f.x), min(f.w), max(f.w) from f join d "
     "on f.k = d.k group by d.k order by d.k", "order_agg_join_direct"),
    ("select d.k, sum(f.x * 2.0 + 1.0), avg(f.x), count(*) from f "
     "join d on f.k = d.k group by d.k order by d.k", "order_agg_join_direct"),
    ("select d.k, sum(f.x), avg(f.x), count(*) from f join d "
     "on f.k = d.k group by d.k", "agg_join_firstapp"),
    ("select d.k, sum(fn.x), count(fn.x), avg(fn.x) from fn join d "
     "on fn.k = d.k group by d.k order by d.k", "order_agg_join_direct"),
    # min/max over a float measure: the two-key tv kernel
    ("select d.k, min(f.x) from f join d on f.k = d.k "
     "group by d.k order by d.k", "_tv"),
    ("select d.k, min(f.x), max(f.x), sum(f.x), avg(f.x), count(*) "
     "from f join d on f.k = d.k group by d.k order by d.k", "_tv"),
    ("select d.k, max(f.x), sum(f.w) from f join d on f.k = d.k "
     "group by d.k order by d.k", "_tv"),
    ("select d.k, min(fn.x), max(fn.x), sum(fn.x), count(fn.x) "
     "from fn join d on fn.k = d.k group by d.k order by d.k", "_tv"),
    ("select d.k, min(f.x), max(f.x) from f join d on f.k = d.k "
     "group by d.k order by d.k desc", "_tv"),
])
def test_float_measures(float_dbs, sql, route):
    routes = _same(*float_dbs, sql)
    assert any(route in r for r in routes), routes


def test_float_measures_numpy_oracle():
    """Non-decimal DOUBLE sums (f64 payload prefix sums): the reference and
    numpy to rel 1e-12."""
    rng = np.random.default_rng(92)
    dim = np.arange(16, dtype=np.int64) + 1
    gid = rng.integers(0, len(dim), 2000)
    fv = rng.uniform(900.0, 105000.0, 2000) * (1 - rng.uniform(0, 0.1, 2000))
    ref, port = _dbs({
        "f": ([("k", "BIGINT"), ("x", "DOUBLE")], {"k": dim[gid].tolist(), "x": fv.tolist()}),
        "d": ([("k", "BIGINT")], {"k": dim.tolist()}),
    })
    sql = "select d.k, sum(f.x) from f join d on f.k = d.k group by d.k order by d.k"
    assert _same(ref, port, sql, rel=1e-12)
    got = port.run(sql)[0].columns[1].data.numpy()
    exp = np.zeros(len(dim))
    np.add.at(exp, gid, fv)
    np.testing.assert_allclose(got, exp, rtol=1e-12)


def test_semi_join_q18_shape_routes_above_the_semi_join():
    """An IN-subquery pushed below the star join (the Q18 shape): both
    engines route the join above the general semi join, to the same rows
    and route names."""
    rng = np.random.default_rng(97)
    dim = (np.arange(30) * 2 + 4).astype(np.int64)
    fk = dim[rng.integers(0, len(dim), 3000)].copy()
    fk[::9] = MISS
    ref, port = _dbs({
        "f": ([("k", "BIGINT"), ("x", "DOUBLE")],
              {"k": fk.tolist(), "x": (rng.integers(-200, 200, 3000) / 4.0).tolist()}),
        "d": ([("k", "BIGINT")], {"k": dim.tolist()}),
        "s": ([("k", "BIGINT")], {"k": dim[::3].tolist() + [999999]}),
    })
    sql = ("select d.k, sum(f.x), count(*) from f join d on f.k = d.k "
           "where d.k in (select k from s) group by d.k")
    assert any("firstapp" in r for r in _same(ref, port, sql, rel=1e-12))


def test_mxu_variant_under_interpret_and_disabled(monkeypatch):
    """SQLRS_TPU_MXU=interpret selects the dense-group variant on any device
    (the port's plain version here, the reference's Pallas kernel in
    interpret mode); =0 disables it. Route names and rows must agree."""
    monkeypatch.setenv("SQLRS_TPU_MXU", "interpret")
    ref, port = _mk(5000, np.arange(64) + 100, seed=51)
    routed = _same(ref, port, SQL)
    assert routed == ["order_agg_join_direct_dense_mxu"]
    # NULL fact keys mask below the domain
    routes = _same(*_mk(3000, np.arange(32) + 7, seed=52, null_every=9), SQL)
    assert routes == ["order_agg_join_direct_dense_mxu"]
    # min/max present: not eligible, the packed sort fires
    routes = _same(ref, port, "select d.k, sum(f.v), min(f.v) from f join d "
                   "on f.k = d.k group by d.k order by d.k")
    assert routes == ["order_agg_join_direct_dense"]
    # disabled: the sort kernel, the same rows
    monkeypatch.setenv("SQLRS_TPU_MXU", "0")
    mxu_rows = port.run_lines(SQL)
    assert _same(ref, port, SQL) == ["order_agg_join_direct_dense"]
    assert port.run_lines(SQL) == mxu_rows


def test_decimal_sums_exact_at_scale():
    """Routed sums of k-dp decimal DOUBLE measures run in exact scaled-int
    arithmetic: at 2^18 rows and 1024 groups each routed sum equals the
    Decimal-exact value to the last bit, in both engines."""
    from decimal import Decimal

    rng = np.random.default_rng(55)
    n, g = 1 << 18, 1 << 10
    gid = rng.integers(0, g, n)
    dim = np.arange(g, dtype=np.int64) * 7 + 3
    fk = dim[gid]
    price = np.round(rng.uniform(900, 10500, n), 2)
    disc = np.round(rng.uniform(0, 0.1, n), 2)
    ref, port = sqlrs_tpu.Database(), sqlrs_tpu_torch.Database(device="cpu")
    for db, T in ((ref, RefLT), (port, LT)):
        db.create_memory_table_numpy(
            "f", [("k", T.BIGINT), ("p", T.DOUBLE), ("d", T.DOUBLE)], [fk, price, disc]
        )
        db.create_memory_table_numpy("dm", [("k", T.BIGINT)], [dim])
    sql = ("select dm.k, sum(f.p * (1 - f.d)) from f join dm on f.k = dm.k "
           "group by dm.k order by dm.k")
    assert _same(ref, port, sql) == ["order_agg_join_direct"]
    cents = np.round(price * 100).astype(np.int64) * (100 - np.round(disc * 100).astype(np.int64))
    acc = np.zeros(g, np.int64)
    np.add.at(acc, gid, cents)
    for line in port.run_lines(sql):
        kstr, vstr = line.split()
        exact = float(Decimal(int(acc[(int(kstr) - 3) // 7])) / Decimal(10 ** 4))
        assert float(vstr) == exact, (line, exact)


def test_packed_values_of_32_bits_and_more():
    """A packable value of 32 or more bits: the reference shifts by
    31 - val_bits unguarded and raises; the port packs into int64 and sums
    exactly (numpy oracle)."""
    rng = np.random.default_rng(0)
    dim = np.arange(16, dtype=np.int64) * 3 + 1
    gid = rng.integers(0, 16, 3000)
    fv = rng.integers(0, 1 << 36, 3000).astype(np.int64)
    ref, port = _fact_dim(dim[gid], fv, dim)
    sql = ("select d.k, sum(f.v), min(f.v), max(f.v), count(distinct f.v) "
           "from f join d on f.k = d.k group by d.k order by d.k")
    with pytest.raises(ValueError, match="negative shift count"):
        ref.run(sql)
    port.last_fused_routes = []
    got = port.run_lines(sql)
    assert port.last_fused_routes == ["order_agg_join_direct"]
    exp = []
    for i, k in enumerate(dim):
        v = fv[gid == i]
        if len(v):
            exp.append(f"{k} {v.sum()} {v.min()} {v.max()} {len(set(v.tolist()))}")
    assert got == exp
