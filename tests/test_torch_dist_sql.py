"""SQL through the sharded engine: sqlrs_tpu_torch.Database(n_devices=8,
device="cpu") against the port's single-device engine and the JAX
single-device engine (sqlrs_tpu.Database()), on the same tables.

The query families of tests/test_dist_sql.py, on in-repo tables shaped
like its CSV ones (employee, department, state, t1, t2: NULL salaries,
duplicate names, a department without employees), and its randomized,
HAVING, prepared-statement, DDL/DML, ORDER BY, skew (`salted`), `ring`,
`broadcast_fused`, DISTINCT and ring-exchange cases. Every result must
render identically in the three engines; a DOUBLE may differ at rel 1e-9
(sharded partial sums add in another order). The join-strategy logs
(`last_join_strategies`) must hold the names the reference's tests assert;
the slow-marked tests compare them with the reference's own sharded
engine. All 22 TPC-H queries at SF 0.002 run over 8 shards and equal the
port's single-device run by benchmarks/tpch.py's rule.
"""

import math

import numpy as np
import pytest
import torch

import sqlrs_tpu
import sqlrs_tpu_torch
from benchmarks import tpch
from sqlrs_tpu_torch.benchmarks import tpch_dbgen as port_dbgen
from sqlrs_tpu_torch.errors import ExecutorError

N_DEV = 8

TABLES = [
    "create table employee(id int, first_name varchar, last_name varchar, state varchar,"
    " salary int, department_id int)",
    "insert into employee values"
    " (1, 'Bill', 'Hopkins', 'CA', 120, 1), (2, 'Gregg', 'Langford', 'CO', 90, 2),"
    " (3, 'John', 'Travis', 'CO', null, 1), (4, 'Von', 'Mill', 'CA', 210, 3),"
    " (5, 'Ann', 'Hopkins', 'NY', 75, 2), (6, 'Zoe', 'Travis', 'CA', 150, 9),"
    " (7, 'Max', 'Gray', null, 300, 1), (8, 'Eve', 'Mill', 'TX', null, 3),"
    " (9, 'Sam', 'Langford', 'CO', 101, 2), (10, 'Ivy', 'Hopkins', 'CA', 99, null),"
    " (11, 'Bill', 'Stone', 'NY', 120, 1)",
    "create table department(id int, department_name varchar)",
    "insert into department values (1, 'Marketing'), (2, 'Engineering'), (3, 'Sales'),"
    " (4, 'Legal')",
    "create table state(state_code varchar, state_name varchar)",
    "insert into state values ('CA', 'California'), ('CO', 'Colorado'), ('NY', 'New York'),"
    " ('WA', 'Washington')",
    "create table t1(a int, b int, c int)",
    "insert into t1 values (0, 4, 7), (1, 5, 8), (2, 6, 9), (2, 5, 1), (3, null, 2),"
    " (1, 5, 3)",
    "create table t2(a int, b int, c int)",
    "insert into t2 values (10, 2, 7), (20, 2, 5), (30, 3, 6), (2, 5, 1), (1, 5, 4),"
    " (1, 5, 0)",
]

QUERIES = [
    "select * from employee",
    "select first_name, salary from employee where salary > 100",
    "select id, id + 1, -id from employee where last_name = 'Hopkins'",
    "select * from employee where salary is null",
    "select first_name from employee where state in ('CA', 'CO')",
    "select a from t1 where a between 1 and 2",
    "select sum(salary), count(*), count(salary), min(salary), max(salary), avg(salary)"
    " from employee",
    "select count(*) from employee where salary > 100",
    "select min(first_name), max(last_name) from employee",
    "select sum(salary) from employee where salary < 0",
    "select state, sum(salary) from employee group by state",
    "select state, count(*), count(salary), min(salary), max(salary), avg(salary)"
    " from employee group by state",
    "select last_name, state, sum(id) from employee group by last_name, state",
    "select state, min(first_name), max(first_name) from employee group by state",
    "select salary, count(*) from employee group by salary",
    "select b, sum(a), max(c) from t1 group by b",
    "select * from employee join department on employee.department_id = department.id",
    "select * from employee left join department on employee.department_id = department.id",
    "select * from employee right join department on employee.department_id = department.id",
    "select * from employee full join department on employee.department_id = department.id",
    "select * from t1 join t2 on t1.a = t2.a and t1.b = t2.b",
    "select * from employee join department on employee.department_id = department.id"
    " and employee.salary > 100",
    "select first_name, department_name, state_name from employee"
    " join department on employee.department_id = department.id"
    " join state on employee.state = state.state_code",
    "select department_name, sum(salary), count(*) from employee"
    " join department on employee.department_id = department.id group by department_name",
    "select first_name from employee limit 2",
    "select first_name from employee limit 2 offset 1",
    "select id from employee where salary > 100 limit 1 offset 1",
    "select distinct state from employee",
    "select distinct last_name, state from employee",
    "select first_name, department_name from employee"
    " join department on employee.department_id = department.id"
    " order by first_name desc limit 2",
    # DISTINCT aggregates, delegated to the standard executor
    "select count(distinct last_name), sum(distinct salary) from employee",
    "select state, count(distinct last_name) from employee group by state",
    # semi / anti joins (the mark-join path)
    "select first_name from employee where department_id in (select id from department"
    " where department_name <> 'Sales')",
    "select first_name from employee where department_id not in (select id from department)",
    "select first_name from employee where exists (select * from state"
    " where state.state_code = employee.state)",
]


def _render_equal(got: list, exp: list) -> bool:
    """Equal renderings, except that a float token may differ at rel 1e-9."""
    if len(got) != len(exp):
        return False
    for g, e in zip(got, exp):
        if g == e:
            continue
        gt, et = g.split(" "), e.split(" ")
        if len(gt) != len(et):
            return False
        for a, b in zip(gt, et):
            if a == b:
                continue
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                return False
            if not ("." in a + b or "e" in a + b) or not math.isclose(fa, fb, rel_tol=1e-9):
                return False
    return True


def _engines(stmts=(), **knobs):
    """(sharded port, single-device port, JAX single device), each with the
    statements run and the knobs set on the sharded one."""
    db8 = sqlrs_tpu_torch.Database(n_devices=N_DEV, device="cpu")
    db1 = sqlrs_tpu_torch.Database(device="cpu")
    dbj = sqlrs_tpu.Database()
    for k, v in knobs.items():
        setattr(db8, k, v)
    for db in (db8, db1, dbj):
        for s in stmts:
            db.run(s)
    return db8, db1, dbj


def _check(engines, sql: str) -> list:
    db8, db1, dbj = engines
    got = db8.run_lines(sql)
    assert _render_equal(got, db1.run_lines(sql)), sql
    assert _render_equal(got, dbj.run_lines(sql)), sql
    return list(db8.last_join_strategies)


@pytest.fixture(scope="module")
def engines():
    return _engines(TABLES)


def test_database_mesh_rule():
    db = sqlrs_tpu_torch.Database(n_devices=N_DEV, device="cpu")
    assert db.mesh.size == N_DEV and db.device == torch.device("cpu")
    assert all(d == torch.device("cpu") for d in db.mesh.devices)
    if not torch.cuda.is_available():
        for kw in ({"n_devices": 2}, {"n_devices": 1, "device": "cuda"}):
            with pytest.raises(ExecutorError):
                sqlrs_tpu_torch.Database(**kw)


@pytest.mark.parametrize("sql", QUERIES)
def test_sharded_matches_single_device(engines, sql):
    _check(engines, sql)


def test_sharded_prepared_statements(engines):
    """ClientContext prepared statements go through the session's mesh."""
    db8, db1, _ = engines
    sql = "select state, count(*) from employee group by state"
    ctx = db8.connect()
    prepared = ctx.prepare(sql)
    assert ctx.execute_prepared(prepared).lines() == db1.run_lines(sql)


def test_sharded_having(engines):
    _check(engines, "select state, sum(salary) from employee group by state"
                    " having sum(salary) > 100")


def test_sharded_order_by(engines):
    for sql in [
        "select * from employee order by salary",
        "select * from employee order by salary desc",
        "select first_name, state from employee order by state, first_name desc",
        "select * from employee order by salary limit 2 offset 1",
        "select a, b from t1 order by b desc, a",
    ]:
        _check(engines, sql)


def test_sharded_ddl_dml_roundtrip():
    db = sqlrs_tpu_torch.Database(n_devices=N_DEV, device="cpu")
    db.run("create table t(v int, w varchar)")
    db.run("insert into t values (1, 'a'), (2, 'b'), (3, null)")
    assert db.run_lines("select sum(v), count(w) from t") == ["6 2"]
    assert db.run_lines("select v from t where w = 'b'") == ["2"]
    db.run("insert into t values (4, 'b')")
    assert db.run_lines("select v from t where w = 'b' order by v desc") == ["4", "2"]


def _fact_dim_rows(seed=42, n=6007, nd=97):
    rng = np.random.default_rng(seed)
    fk = np.minimum(rng.zipf(1.4, n), nd * 2)
    fv = rng.integers(-50, 50, n)
    fx = rng.integers(-400, 400, n) / 8.0
    fnull = rng.random(n) < 0.05
    rows_f = ",".join(
        f"({'null' if m else k},{v},{x})" for k, v, x, m in zip(fk, fv, fx, fnull))
    rows_d = ",".join(f"({k},'grp{k}')" for k in range(1, nd + 1))
    return [
        "create table fact(k int, v int, x double)", "create table dim(k int, name varchar)",
        f"insert into fact values {rows_f}", f"insert into dim values {rows_d}",
    ]


def test_sharded_randomized_scale():
    """Thousands of zipf-keyed fact rows with NULL keys against a dim table:
    the GROUP BY capacity retry, multi-slot probe strips, outer joins."""
    e = _engines(_fact_dim_rows())
    for sql in [
        "select name, sum(v), count(*), min(v), max(v) from fact join dim on fact.k = dim.k"
        " group by name",
        "select name, sum(x), avg(x), min(x) from fact join dim on fact.k = dim.k group by name",
        "select k, count(*), avg(v) from fact group by k",
        "select count(*) from fact left join dim on fact.k = dim.k",
        "select count(*), sum(fact.k) from fact right join dim on fact.k = dim.k",
        "select sum(v), sum(x) from fact where k > 50",
        "select k, v from fact where x > 40 order by k desc, v",
    ]:
        _check(e, sql)
    e[0].dist_join_policy = "broadcast"
    assert _check(e, "select name, sum(v) from fact join dim on fact.k = dim.k"
                     " group by name") == ["broadcast"]


def test_sharded_order_by_scale():
    rng = np.random.default_rng(12)
    n = 5000
    rows = ",".join(f"({a},{b})" for a, b in zip(rng.integers(0, 40, n),
                                               rng.integers(-1000, 1000, n)))
    e = _engines(["create table s(v int, w int)", f"insert into s values {rows}"])
    for sql in [
        "select v, w from s where w > 0 order by v",
        "select v, w from s order by v desc, w",
        "select v from s order by v limit 17 offset 5",
    ]:
        _check(e, sql)


def _skew_ddl(seed, n, g, hot, mul, add):
    rng = np.random.default_rng(seed)
    gid = np.where(rng.random(n) < hot, 0, rng.integers(1, g, n)) if hot else \
        rng.integers(0, g, n)
    vals = rng.integers(-100, 1000, n)
    rows_f = ",".join(f"({k * mul + add},{v})" for k, v in zip(gid, vals))
    rows_d = ",".join(f"({k * mul + add},{k * 7})" for k in range(g))
    return ["create table fact(k int, v int)", "create table dim(k int, d int)",
            f"insert into fact values {rows_f}", f"insert into dim values {rows_d}"]


def test_sharded_skew_routes_through_salted():
    """A hot fact key trips the shuffle join's skew detector (hot probe rows
    salted round-robin, hot build rows replicated); results and
    first-appearance group order stay exact."""
    e = _engines(_skew_ddl(11, 6000, 50, 0.7, 3, 1), dist_join_policy="shuffle",
                 dist_hot_min=16)
    strategies = _check(e, "select dim.d, sum(fact.v), count(*) from dim join fact"
                           " on fact.k = dim.k group by dim.d")
    assert "salted" in strategies, strategies


def test_sharded_ring_exchange_shuffle_join():
    """dist_exchange_ring stages the shuffle join's probe exchange in ring
    hops: the same rows as the monolithic exchange and one device."""
    ddl = _skew_ddl(23, 5000, 60, 0, 5, 2)
    q = ("select dim.d, sum(fact.v), count(*) from dim join fact on fact.k = dim.k"
         " group by dim.d order by dim.d")
    mono = _engines(ddl, dist_join_policy="shuffle")
    ring = _engines(ddl, dist_join_policy="shuffle", dist_exchange_ring=True)
    assert "shuffle" in _check(mono, q)
    assert "shuffle" in _check(ring, q)
    assert ring[0].run_lines(q) == mono[0].run_lines(q)
    q2 = "select fact.v, dim.d from dim join fact on fact.k = dim.k where fact.v > 900"
    assert _check(ring, q2) == ["shuffle"]


def test_sharded_auto_picks_shuffle_for_a_large_build():
    """Under the auto policy a build side with ≥ dist_shuffle_min_build live
    rows and (shards - 1) x its rows above the probe side's is shuffled."""
    ddl = _skew_ddl(4, 300, 200, 0, 2, 0)
    e = _engines(ddl, dist_shuffle_min_build=100)
    assert _check(e, "select dim.d, fact.v from dim join fact on fact.k = dim.k") == ["shuffle"]
    e[0].dist_shuffle_min_build = 1 << 16
    assert _check(e, "select dim.d, fact.v from dim join fact on fact.k = dim.k") == ["broadcast"]


RING_TABLES = [
    "create table dim(k int, u int, g int)",
    "create table fact(k int, v int, s varchar)",
    "insert into dim values " + ",".join(f"({k % 7},{k},{(k * 13) % 5})" for k in range(20)),
    "insert into fact values " + ",".join(
        f"({'null' if i % 37 == 0 else i % 9},{'null' if i % 11 == 0 else i},"
        f"{'null' if i % 13 == 0 else repr(f'w{i % 23:02d}')})" for i in range(300)),
]
RING_QUERIES = [
    "select dim.g, sum(fact.v), count(*), count(fact.v), min(fact.v), max(fact.v)"
    " from dim join fact on fact.k = dim.k group by dim.g",
    "select dim.u, sum(fact.v) from dim join fact on fact.k = dim.u group by dim.u",
    "select dim.g, count(*) from dim join fact on fact.k = dim.k group by dim.g"
    " order by count(*) desc, dim.g limit 3",
    "select dim.g, min(fact.s), max(fact.s) from dim join fact on fact.k = dim.k"
    " group by dim.g",
]


def test_sharded_ring_agg_over_join():
    """The fused aggregate-over-join: `ring` when forced, `broadcast_fused`
    for a small build under auto, `ring` again once dist_ring_min_build is
    1, `broadcast` under the explicit broadcast policy; exact throughout,
    NULL keys, NULL arguments, duplicate dim keys and first-appearance order
    included."""
    e = _engines(RING_TABLES, dist_join_policy="ring")
    for q in RING_QUERIES:
        assert "ring" in _check(e, q), q
    e[0].dist_join_policy = "auto"
    for q in RING_QUERIES:
        assert "broadcast_fused" in _check(e, q), q
    e[0].dist_ring_min_build = 1
    assert _check(e, RING_QUERIES[0]) == ["ring"]
    del e[0].dist_ring_min_build
    e[0].dist_join_policy = "broadcast"
    assert _check(e, RING_QUERIES[0]) == ["broadcast"]


def _composite_tables():
    rows_d = ",".join(f"({k % 6},{k % 4},{k},{(k * 11) % 7})" for k in range(24))
    parts = []
    for i in range(400):
        a = "null" if i % 29 == 0 else str(i % 6)
        v = "null" if i % 13 == 0 else str(i % 100)
        parts.append(f"({a},{i % 4},{v},{(i % 89) * 0.25 + 900.0},{i * 0.1})")
    return ["create table dim(a int, b int, u int, g int)",
            "create table fact(a int, b int, v int, x double, y double)",
            f"insert into dim values {rows_d}", f"insert into fact values {','.join(parts)}"]


def test_sharded_ring_avg_float_composite():
    """avg, DOUBLE measures (y: non-dyadic, so the shards' partial sums may
    differ in the last bits) and two-key joins on the ring; a DISTINCT not
    refined by the join key leaves the fused path."""
    e = _engines(_composite_tables(), dist_join_policy="ring")
    for q in [
        "select dim.g, avg(fact.v), count(fact.v) from dim join fact on fact.a = dim.a"
        " group by dim.g",
        "select dim.g, sum(fact.x), avg(fact.x), sum(fact.y), avg(fact.y) from dim join fact"
        " on fact.a = dim.a group by dim.g",
        "select dim.g, sum(fact.v), count(*) from dim join fact on fact.a = dim.a"
        " and fact.b = dim.b group by dim.g",
        "select dim.g, avg(fact.x), min(fact.v), max(fact.y) from dim join fact"
        " on fact.a = dim.a and fact.b = dim.b group by dim.g",
    ]:
        assert "ring" in _check(e, q), q
    strategies = _check(e, "select dim.g, count(distinct fact.v) from dim join fact"
                           " on fact.a = dim.a group by dim.g")
    assert "ring" not in strategies


def _distinct_tables():
    rng = np.random.default_rng(17)
    nd, nf = 24, 800
    rows_d = ",".join(f"({k},{k % 5})" for k in list(range(nd)) + [3, 7])
    parts = []
    for i in range(nf):
        k, v = int(rng.integers(0, nd + 6)), int(rng.integers(-9, 9))
        x = int(rng.integers(-40, 40)) / 4.0
        parts.append(f"({k},{'NULL' if i % 11 == 0 else v},{x})")
    return ["create table dim(k int, g int)", "create table fact(k int, v int, x double)",
            f"insert into dim values {rows_d}", f"insert into fact values {','.join(parts)}"]


DISTINCT_QUERIES = [
    "select dim.k, count(distinct fact.v), count(*) from dim join fact on fact.k = dim.k"
    " group by dim.k",
    "select dim.k, sum(distinct fact.v), avg(distinct fact.v) from dim join fact"
    " on fact.k = dim.k group by dim.k",
    "select dim.k, dim.g, count(distinct fact.v), sum(fact.v) from dim join fact"
    " on fact.k = dim.k group by dim.k, dim.g",
    "select dim.k, count(distinct fact.x), sum(distinct fact.x) from dim join fact"
    " on fact.k = dim.k group by dim.k",
]


@pytest.mark.parametrize("policy,tag", [("auto", "broadcast_fused"), ("ring", "ring")])
def test_sharded_distinct_on_the_fused_path(policy, tag):
    """count/sum/avg(DISTINCT) over a join whose groups the join key refines
    stay fused (locally deduped pairs exchanged by key hash, then a second
    fused pass); other DISTINCT groupings fall back."""
    e = _engines(_distinct_tables(), dist_join_policy=policy)
    for q in DISTINCT_QUERIES:
        assert tag in _check(e, q), q
    strategies = _check(e, "select dim.g, count(distinct fact.v) from dim join fact"
                           " on fact.k = dim.k group by dim.g")
    assert not any(s in ("ring", "broadcast_fused") for s in strategies)


def test_sharded_float_join_key_rollup_leaves_the_fused_path():
    """The fused aggregate-over-join answers each dim key k with the fact
    rows in [k, k + 1), which is one key only for integers: a rollup over a
    single float join key takes the general join instead (the reference's
    sharded engine fuses it and adds 1.5's rows to 1.0's group)."""
    e = _engines([
        "create table dim(k double, g int)", "create table fact(k double, v int)",
        "insert into dim values (1.0, 10), (1.5, 20), (2.0, 30), (null, 40)",
        "insert into fact values (1.0, 1), (1.5, 100), (1.5, 100), (2.0, 5000), (null, 7)",
    ])
    q = "select dim.g, sum(fact.v), count(*) from dim join fact on fact.k = dim.k group by dim.g"
    for policy in ("auto", "ring"):
        e[0].dist_join_policy = policy
        assert _check(e, q) == ["broadcast"]
    assert e[0].run_lines(q) == ["10 1 1", "20 200 2", "30 5000 1"]


@pytest.mark.parametrize("policy,tag", [("auto", "broadcast_fused"), ("ring", "ring")])
def test_sharded_fused_float_min_max(policy, tag):
    """The fused aggregate-over-join's min/max take a float argument
    through its sort order (the reference's sharded engine truncates it to
    an integer key, so 1.2 and 1.7 tie there and min returns 1.7)."""
    e = _engines([
        "create table dim(k int, g int)", "create table fact(k int, x double)",
        "insert into dim values (1, 10), (2, 20)",
        "insert into fact values (1, 1.7), (1, 1.2), (2, 5.9), (2, 5.1), (1, 1.5),"
        " (2, -0.25), (1, null)",
    ], dist_join_policy=policy)
    q = ("select dim.g, min(fact.x), max(fact.x), count(fact.x) from dim join fact"
         " on fact.k = dim.k group by dim.g")
    assert _check(e, q) == [tag]
    assert e[0].run_lines(q) == ["10 1.2 1.7 3", "20 -0.25 5.9 3"]


# ---- the reference's own sharded engine: the same strategies (slow) ----------


def _strategy_cases():
    return [
        (RING_TABLES, {"dist_join_policy": "ring"}, RING_QUERIES),
        (RING_TABLES, {}, RING_QUERIES),
        (_composite_tables(), {"dist_join_policy": "ring"},
         ["select dim.g, avg(fact.y), min(fact.v) from dim join fact on fact.a = dim.a"
          " and fact.b = dim.b group by dim.g"]),
        (_distinct_tables(), {}, DISTINCT_QUERIES),
        (_skew_ddl(11, 6000, 50, 0.7, 3, 1), {"dist_join_policy": "shuffle", "dist_hot_min": 16},
         ["select dim.d, sum(fact.v), count(*) from dim join fact on fact.k = dim.k"
          " group by dim.d"]),
        (TABLES, {}, QUERIES),
    ]


@pytest.mark.slow
@pytest.mark.parametrize("case", range(6))
def test_strategies_equal_the_reference_sharded_engine(case):
    stmts, knobs, queries = _strategy_cases()[case]
    db8 = sqlrs_tpu_torch.Database(n_devices=N_DEV, device="cpu")
    ref8 = sqlrs_tpu.Database(n_devices=N_DEV)
    for db in (db8, ref8):
        for k, v in knobs.items():
            setattr(db, k, v)
        for s in stmts:
            db.run(s)
    for q in queries:
        assert _render_equal(db8.run_lines(q), ref8.run_lines(q)), q
        assert db8.last_join_strategies == ref8.last_join_strategies, q


# ---- the 22 TPC-H queries over 8 shards --------------------------------------

SF = 0.002


@pytest.fixture(scope="module")
def tpch_dbs():
    tables = port_dbgen.gen_tables(SF, seed=3)
    db8 = sqlrs_tpu_torch.Database(n_devices=N_DEV, device="cpu")
    db1 = sqlrs_tpu_torch.Database(device="cpu")
    for db in (db8, db1):
        port_dbgen.load_into(db, tables)
    return db8, db1


@pytest.mark.parametrize("qn", range(1, 23))
def test_tpch_query_sharded_matches_single_device(tpch_dbs, qn):
    db8, db1 = tpch_dbs
    got = tpch.run_query(db8, qn)
    exp = tpch.run_query(db1, qn)
    issues = tpch.compare(got, exp, qn)
    assert not issues, issues[:5]
