"""Query profiling (sqlrs_tpu_torch/utils/profiling.py) against the
reference's (sqlrs_tpu/utils/profiling.py).

The same SQL and data go through sqlrs_tpu.Database(profile=True) and
sqlrs_tpu_torch.Database(profile=True, device="cpu"), on one device and
over 8 CPU shards in both engines. Each statement's operator list, as
(op label, depth, rows_out) in the order the operators finished, must be
the reference's: the labels are the plan's explain lines, the depths come
from the operator boundary's stack (the fused-route bail-out and delegated operators
re-enter the executor), and rows_out is the batch's row count (the live
rows of a sharded batch). Times are host-clock and are not compared.
"""

import numpy as np
import pytest

import sqlrs_tpu
import sqlrs_tpu_torch
from benchmarks import tpch_dbgen, tpch_queries
from sqlrs_tpu_torch.benchmarks import tpch_dbgen as port_dbgen
from sqlrs_tpu_torch.utils import profiling

SF = 0.002
FAST = [4, 6, 13, 15, 16, 17, 18, 22]  # tests/test_tpch.py's fast tier

SETUP = """
create table t(a int, b bigint, c double, s varchar, d date);
insert into t values
  (1, 10, 1.5, 'apple', '2020-01-31'), (2, null, -2.25, 'banana', '2021-02-28'),
  (3, 30, null, null, null), (1, 40, 0.5, 'cherry', '1999-12-31'),
  (5, -7, 3.0, 'apple', '2000-02-29'), (2, 25, 0.0, 'date', '2024-02-29');
create table u(k int, v double);
insert into u select a, c from t where a < 3;
insert into u(k) values (9);
create view w as select a, b from t where b > 0
"""

# the in-repo SQL families: scans, filters, projections, ORDER BY/LIMIT,
# ungrouped and grouped aggregates, the joins and subqueries, DML, views
FAMILIES = [
    "select a, sum(b) from t group by a",
    "select a, b * 2 + 1, -c from t where a > 1",
    "select s from t where s like 'a%' or s like '%rr%'",
    "select a, b, s from t order by a desc, b",
    "select a from t limit 2 offset 3",
    "select a, s from t order by s desc limit 2",
    "select count(*), sum(b), min(s), avg(c) from t where a > 1",
    "select s, count(*), sum(b), avg(b) from t group by s",
    "select a, count(distinct s), min(c) from t group by a order by a",
    "select count(distinct a) from t",
    "select t.a, u.v from t join u on t.a = u.k order by t.a",
    "select t.a, u.v from t left join u on t.a = u.k",
    "select t.a from t, u where t.a < u.k",
    "select a from t where a in (select k from u)",
    "select a from t where a not in (select k from u where k < 3)",
    "select a from t where exists (select 1 from u where u.k = t.a)",
    "select u.k, sum(t.b), count(*) from t join u on t.a = u.k group by u.k order by u.k",
    "select * from w",
    "insert into u values (7, 7.5)",
    "explain select a from t where a > 1",
]


def _ops(db):
    return [(s.op, s.depth, s.rows_out) for s in db.last_profile.ops]


def _run_both(ref, port, sql):
    for st in sql if isinstance(sql, list) else [sql]:
        rb, pb = ref.run(st), port.run(st)
    return rb, pb


@pytest.fixture(scope="module")
def family_dbs():
    ref = sqlrs_tpu.Database(profile=True)
    port = sqlrs_tpu_torch.Database(profile=True, device="cpu")
    ref.run(SETUP)
    port.run(SETUP)
    return ref, port


@pytest.fixture(scope="module")
def family_dbs_sharded():
    ref = sqlrs_tpu.Database(profile=True, n_devices=8)
    port = sqlrs_tpu_torch.Database(profile=True, n_devices=8, device="cpu")
    ref.run(SETUP)
    port.run(SETUP)
    return ref, port


@pytest.mark.parametrize("sql", FAMILIES, ids=[s[:50] for s in FAMILIES])
def test_family_operator_lists(family_dbs, sql):
    ref, port = family_dbs
    rb, pb = _run_both(ref, port, sql)
    assert _ops(port) == _ops(ref)
    if pb:  # the root's rows_out is the result's row count
        assert port.last_profile.ops[-1].rows_out == pb[0].num_rows


SHARDED_FAMILIES = [FAMILIES[i] for i in (0, 1, 4, 6, 7, 10)]


@pytest.mark.parametrize(
    "sql", SHARDED_FAMILIES, ids=[s[:50] for s in SHARDED_FAMILIES]
)
def test_family_operator_lists_sharded(family_dbs_sharded, sql):
    ref, port = family_dbs_sharded
    _run_both(ref, port, sql)
    ops = _ops(port)
    assert ops == _ops(ref)
    assert any(op.startswith("dist:") for op, _d, _r in ops)


@pytest.fixture(scope="module")
def tpch_tables():
    return port_dbgen.gen_tables(SF, seed=3)


@pytest.fixture(scope="module")
def tpch_dbs(tpch_tables):
    ref = sqlrs_tpu.Database(profile=True)
    tpch_dbgen.load_into(ref, tpch_tables)
    port = sqlrs_tpu_torch.Database(profile=True, device="cpu")
    port_dbgen.load_into(port, tpch_tables)
    return ref, port


@pytest.fixture(scope="module")
def tpch_dbs_sharded(tpch_tables):
    ref = sqlrs_tpu.Database(profile=True, n_devices=8)
    tpch_dbgen.load_into(ref, tpch_tables)
    port = sqlrs_tpu_torch.Database(profile=True, n_devices=8, device="cpu")
    port_dbgen.load_into(port, tpch_tables)
    return ref, port


@pytest.mark.parametrize("qn", FAST)
def test_tpch_operator_lists(tpch_dbs, qn):
    ref, port = tpch_dbs
    ref.last_fused_routes, port.last_fused_routes = [], []
    _run_both(ref, port, tpch_queries.ALL[qn])
    assert _ops(port) == _ops(ref)
    assert port.last_fused_routes == ref.last_fused_routes


@pytest.mark.parametrize("qn", FAST)
def test_tpch_operator_lists_sharded(tpch_dbs_sharded, qn):
    ref, port = tpch_dbs_sharded
    _run_both(ref, port, tpch_queries.ALL[qn])
    assert _ops(port) == _ops(ref)


def test_profile_env_var(monkeypatch):
    monkeypatch.setenv("SQLRS_TPU_PROFILE", "1")
    db = sqlrs_tpu_torch.Database(device="cpu")
    assert db.profile_enabled and db.last_profile is None
    db.run("create table z(a int); insert into z values (1), (2), (3)")
    db.run("select a from z where a > 1")
    assert [s.op.split("(")[0] for s in reversed(db.last_profile.ops)] == [
        "Projection", "Filter", "TableScan"
    ]
    monkeypatch.setenv("SQLRS_TPU_PROFILE", "0")
    assert not sqlrs_tpu_torch.Database(device="cpu").profile_enabled


def test_profile_off_by_default():
    db = sqlrs_tpu_torch.Database(device="cpu")
    db.run("create table z(a int); insert into z values (1)")
    db.run("select a from z")
    assert db.profile_enabled is False and db.last_profile is None


def test_report_text_matches_reference_layout(family_dbs):
    """report(): the same header and columns as the reference's, root
    first, labels indented by depth; only the times differ."""
    ref, port = family_dbs
    sql = "select s, count(*) from t where a > 1 group by s"
    _run_both(ref, port, sql)
    r_lines = ref.last_profile.report().splitlines()
    p_lines = port.last_profile.report().splitlines()
    assert p_lines[0] == r_lines[0]
    assert p_lines[0].split() == ["operator", "rows_out", "self_ms", "rows/s"]
    assert len(p_lines) == len(r_lines)
    for r, p in zip(r_lines[1:], p_lines[1:]):
        assert p[:55] == r[:55]  # label and rows_out columns
        assert len(p) == len(r) or len(p.split()) == len(r.split())
    assert p_lines[1].startswith("Projection") or p_lines[1].startswith("HashAgg")
    assert p_lines[-1].lstrip().startswith("TableScan")
    assert p_lines[-1].startswith("  ")


def test_measure_self_time_arithmetic():
    """A parent's self time is its wall time less its direct children's."""
    import time

    prof = profiling.QueryProfile()

    def measure(label):  # the operator boundary, without a span
        return profiling.operator(prof, label, None, "")

    with measure("root"):
        with measure("child") as c:
            time.sleep(0.02)
            with measure("grandchild"):
                time.sleep(0.02)
            c.rows_out = 5
        time.sleep(0.01)
    grand, child, root = prof.ops
    assert (root.depth, child.depth, grand.depth) == (0, 1, 2)
    assert child.rows_out == 5
    assert child.self_s == pytest.approx(child.wall_s - grand.wall_s, abs=1e-9)
    assert root.self_s == pytest.approx(root.wall_s - child.wall_s, abs=1e-9)
    assert root.wall_s >= child.wall_s >= grand.wall_s > 0.015


def test_trace_writes_chrome_trace(tmp_path):
    db = sqlrs_tpu_torch.Database(device="cpu")
    db.run("create table z(a int); insert into z values (1), (2)")
    with profiling.trace(str(tmp_path / "trace")):
        db.run("select sum(a) from z")
    import json

    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    # the statement's spans, a track of their own on the records' clock
    spans = [e for e in events if e.get("pid") == "sqlrs_tpu_torch spans"]
    assert [e["name"] for e in spans if e["cat"] == "session"] == ["statement"]
    root = next(e for e in spans if e["name"] == "statement")
    ops = [e for e in events if str(e.get("name", "")).startswith("aten::")]
    assert all(root["ts"] <= e["ts"] and e["ts"] + e["dur"] <= root["ts"] + root["dur"]
               for e in ops)


def test_streaming_limit_touches_chunks_not_table():
    """tests/test_sql_extended.py's counterpart: LIMIT over a scan→filter
    pipeline runs in bounded chunks, so the profiled TableScan row counts
    stay O(limit-chunk), never O(table)."""
    db = sqlrs_tpu_torch.Database(profile=True, device="cpu")
    n = 300_000
    db.create_memory_table_numpy(
        "big", [("a", sqlrs_tpu_torch.types.LogicalType.BIGINT)],
        [np.arange(n, dtype=np.int64)],
    )
    batches = db.run("select a from big where a % 2 = 0 limit 10")
    rows = [t[0] for b in batches for t in b.to_pylist()]
    assert rows == [0, 2, 4, 6, 8, 10, 12, 14, 16, 18]
    scanned = sum(
        s.rows_out for s in db.last_profile.ops if s.op.lstrip().startswith("TableScan")
    )
    assert 0 < scanned <= 4096, scanned

    batches = db.run("select a from big where a < 5 limit 10 offset 3")
    rows = [t[0] for b in batches for t in b.to_pylist()]
    assert rows == [3, 4]
