"""The port's main path end to end: the same SQL and data through
sqlrs_tpu.Database (JAX on the CPU, its Pallas kernel in interpret mode)
and sqlrs_tpu_torch.Database(device="cpu").

Non-float columns must render identically; DOUBLE/FLOAT values agree to
rel 1e-12 (sums are taken in another order). Group and row order are part
of the output.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import sqlrs_tpu
import sqlrs_tpu_torch
from benchmarks import tpch_dbgen, tpch_queries
from sqlrs_tpu.utils.render import batch_to_rows as ref_rows
from sqlrs_tpu_torch.storage.memory import import_tables
from sqlrs_tpu_torch.utils.render import batch_to_rows as port_rows

_FLOAT_TYPES = ("DOUBLE", "FLOAT")


@pytest.fixture(autouse=True)
def _mxu_interpret(monkeypatch):
    monkeypatch.setenv("SQLRS_TPU_MXU", "interpret")
    monkeypatch.setenv("SQLRS_TPU_MXU_AGG_MIN_ROWS", "0")


def _type_name(col: str, arr: np.ndarray) -> str:
    """tpch_dbgen.load_into's typing rules, as a type name."""
    if col in tpch_dbgen._DATE_COLS:
        return "DATE"
    if col in tpch_dbgen._DOUBLE_COLS:
        return "DOUBLE"
    if arr.dtype.kind in ("U", "O"):
        return "VARCHAR"
    return "BIGINT"


def _as_import(tables: dict) -> dict:
    return {
        name: [
            (c, _type_name(c, a), a.astype(np.int32) if _type_name(c, a) == "DATE" else a, None)
            for c, a in cols.items()
        ]
        for name, cols in tables.items()
    }


@pytest.fixture(scope="module")
def tpch_dbs():
    tables = {"lineitem": tpch_dbgen.gen_tables(0.01, seed=0)["lineitem"]}
    assert len(tables["lineitem"]["l_orderkey"]) == 60_465
    ref = sqlrs_tpu.Database()
    tpch_dbgen.load_into(ref, tables)
    port = sqlrs_tpu_torch.Database(device="cpu")
    import_tables(port, _as_import(tables))
    return ref, port


def _compare_batches(ref_batches, port_batches):
    assert len(ref_batches) == len(port_batches)
    for rb, pb in zip(ref_batches, port_batches):
        types = [t.name for t in rb.schema.types]
        assert types == [t.name for t in pb.schema.types]
        assert rb.schema.names == pb.schema.names
        r_text, p_text = ref_rows(rb), port_rows(pb)
        assert len(r_text) == len(p_text)
        r_vals, p_vals = rb.to_pylist(), pb.to_pylist()
        for rt, pt, rv, pv in zip(r_text, p_text, r_vals, p_vals):
            for t, a, b, x, y in zip(types, rt, pt, rv, pv):
                if t in _FLOAT_TYPES and x is not None and y is not None:
                    assert y == pytest.approx(x, rel=1e-12, abs=0), (rt, pt)
                else:
                    assert a == b, (rt, pt)


def _run_both(ref, port, sql):
    return ref.run(sql), port.run(sql)


@pytest.mark.parametrize("q", [1, 6])
def test_tpch_q1_q6_sf001(tpch_dbs, q):
    ref, port = tpch_dbs
    ref.last_fused_routes = []
    port.last_fused_routes = []
    rb, pb = _run_both(ref, port, tpch_queries.ALL[q])
    assert rb and rb[0].num_rows > 0
    _compare_batches(rb, pb)
    if q == 1:
        assert "hashagg_mxu" in ref.last_fused_routes
        assert "hashagg_mxu" in port.last_fused_routes
        assert pb[0].num_rows == 4


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

SQL_CASES = [
    # the README example
    "select a, sum(b) from t group by a",
    # filter / project / expressions
    "select a, b * 2 + 1, -c, c / 2 from t where a > 1",
    "select a / 2, a % 2, b / 0 from t",
    "select s, s || '!', substring(s from 2 for 3) from t",
    "select s from t where s like 'a%' or s like '%rr%'",
    "select s from t where s not like '_a%'",
    "select d, d + interval '1' month, d - interval '1' day from t",
    "select extract(year from d), extract(month from d), extract(day from d) from t",
    "select a from t where c is null or s is null",
    "select case when c > 1 then 'big' when c > 0 then 'small' else 'neg' end from t",
    "select cast(a as double) / 4, cast(c as int), cast(a as varchar) from t",
    "select a from t where s > 'b' and s <= 'cherry'",
    "select a, b from t where b between 0 and 30 and a in (1, 2, 3)",
    # ORDER BY and LIMIT
    "select a, b, s from t order by a desc, b",
    "select s, c from t order by s, c desc",
    "select d from t order by d desc",
    "select a, c from t order by c",
    "select a from t limit 3",
    "select a from t limit 2 offset 3",
    "select a, s from t order by s desc limit 2",
    "select a from t where a > 1 limit 1",
    # ungrouped aggregates, with and without a fused filter
    "select count(*), count(b), sum(b), min(b), max(b), avg(b) from t",
    "select sum(c), min(c), max(c), avg(c), min(s), max(s) from t",
    "select count(*), sum(b), min(s) from t where a > 100",
    "select sum(b) + 1 from t where a > 1",
    # small-domain GROUP BY (the histogram path)
    "select s, count(*), sum(b), avg(b) from t group by s",
    "select a, s, count(*) from t where c >= 0 group by a, s",
    "select a, sum(c) from t group by a order by a",
    "select s, count(*) from t where a > 100 group by s",
    # the DML results and the view
    "select k, v from u",
    "select * from w",
    "select 1 + 2, 'x', null",
]


@pytest.fixture(scope="module")
def sql_dbs():
    ref = sqlrs_tpu.Database()
    port = sqlrs_tpu_torch.Database(device="cpu")
    ref.run(SETUP)
    port.run(SETUP)
    return ref, port


@pytest.mark.parametrize("sql", SQL_CASES, ids=[s[:60] for s in SQL_CASES])
def test_sql_differential(sql_dbs, sql):
    ref, port = sql_dbs
    _compare_batches(*_run_both(ref, port, sql))


def test_ddl_drop_and_create_table_as():
    script = (
        "create table x(a int, s varchar); insert into x values (2, 'b'), (1, 'a');"
        "create table y as select a * 10 as a10, s from x;"
        "drop table x; drop table if exists x; drop view if exists nothing"
    )
    ref, port = sqlrs_tpu.Database(), sqlrs_tpu_torch.Database(device="cpu")
    ref.run(script)
    port.run(script)
    assert ref.run_lines("select * from y order by a10") == port.run_lines(
        "select * from y order by a10"
    ) == ["10 a", "20 b"]
    with pytest.raises(sqlrs_tpu_torch.SqlrsError):
        port.run("select * from x")


def test_import_tables_round_trip(sql_dbs):
    """The reference's table t, exported as plain numpy + type names and
    imported into a fresh port database, reads back identically."""
    from sqlrs_tpu.data.strings import GLOBAL_STRINGS as REF_STRINGS

    ref, _ = sql_dbs
    entry = ref.catalog.table("t")
    cols = []
    for i, (name, t) in enumerate(zip(entry.storage.names, entry.storage.types)):
        data, valid = entry.storage.host_column(i)
        if t.name == "VARCHAR":
            data = np.array(REF_STRINGS.decode(data, valid), dtype=object)
        cols.append((name, t.name, data, valid))
    port = sqlrs_tpu_torch.Database(device="cpu")
    import_tables(port, {"t": cols})
    _compare_batches(ref.run("select * from t"), port.run("select * from t"))


def test_port_imports_no_jax():
    """Every module of the port imports, and none of them brings in jax,
    the JAX package or the top-level benchmarks package; chip_smoke.py
    names none of them in an import either."""
    import ast
    import pathlib

    code = (
        "import importlib, pkgutil, sys, sqlrs_tpu_torch\n"
        "for m in pkgutil.walk_packages(sqlrs_tpu_torch.__path__, 'sqlrs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'sqlrs_tpu', 'benchmarks')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
    tree = ast.parse((pathlib.Path(__file__).parents[1] / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "sqlrs_tpu", "benchmarks"}, roots


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(sqlrs_tpu_torch.ExecutorError, match="CUDA"):
        sqlrs_tpu_torch.Database(device="cuda")


def test_default_device_without_cuda_raises():
    """Database() runs on the card by default, and never falls back to the
    CPU when there is none."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(sqlrs_tpu_torch.ExecutorError, match="CUDA"):
        sqlrs_tpu_torch.Database()


@pytest.mark.parametrize(
    "sql,what",
    [
        ("select t.a from t join u on t.a = u.k", "hash join"),
        ("select t.a from t, u", "cross join"),
        ("select a from t where a in (select k from u)", "semi join"),
        ("select count(distinct a) from t", "ungrouped DISTINCT"),
        ("select a, min(c) from t group by a", "sorted-run grouped aggregation"),
    ],
)
def test_unported_operators_raise(sql_dbs, sql, what):
    """The operators that once raised "not yet ported" now run: the same
    rows and route log as the reference."""
    ref, port = sql_dbs
    ref.last_fused_routes, port.last_fused_routes = [], []
    _compare_batches(*_run_both(ref, port, sql))
    assert port.last_fused_routes == ref.last_fused_routes, what


@pytest.mark.parametrize("kwargs", [{"n_devices": 2}], ids=["n_devices"])
def test_unported_database_options_raise(kwargs, tmp_path, monkeypatch):
    """The database options that once raised "not yet ported" work:
    n_devices (the sharded engine, here 2 shards on the CPU) and its
    multi-process layer. Without a process group make_multihost_mesh is the
    (1, n) view and initialize_distributed asks for its coordinator; inside
    a one-process gloo group the mesh's collectives go through
    torch.distributed and a query gives the single-controller rows.
    (profile=True is ported: see tests/test_torch_profiling.py.)"""
    import torch.distributed as dist

    from sqlrs_tpu_torch.parallel import mesh

    single = sqlrs_tpu_torch.Database(device="cpu", **kwargs)
    assert single.mesh.size == 2 and single.mesh.group is None
    mh = mesh.make_multihost_mesh(devices=["cpu"] * 2)
    assert mh.shape == {"host": 1, "device": 2} and mh.size == 2
    for var in ("SQLRS_TPU_COORDINATOR", "SQLRS_TPU_NUM_PROCESSES", "SQLRS_TPU_PROCESS_ID",
                "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(sqlrs_tpu_torch.ExecutorError, match="coordinator address"):
        mesh.initialize_distributed()

    sql = "select k % 3, sum(v), count(*) from t group by k % 3 order by 1"
    tables = {"t": [("k", "BIGINT", np.arange(100), None),
                    ("v", "DOUBLE", np.linspace(0.1, 9.9, 100), None)]}
    import_tables(single, tables)
    mesh.initialize_distributed(f"file://{tmp_path}/rdv", 1, 0, backend="gloo")
    try:
        mesh.initialize_distributed()  # a no-op
        one = mesh.make_mesh(devices=["cpu"] * 2)
        assert (one.size, one.n_proc, one.offset) == (2, 1, 0) and one.group is not None
        grouped = sqlrs_tpu_torch.Database(mesh=one)
        import_tables(grouped, tables)
        assert grouped.run_lines(sql) == single.run_lines(sql)
        with pytest.raises(sqlrs_tpu_torch.ExecutorError, match="3 shards asked"):
            mesh.make_mesh(3, devices=["cpu"] * 2)
    finally:
        dist.destroy_process_group()
    assert mesh.make_mesh(devices=["cpu"] * 2).group is None


CSV_TEXT = (
    "id,name,score,ok,dt\n"
    "1,ann,1.25,true,2021-03-04\n"
    "2,,,false,\n"
    "3,bob,-7.5,,1999-12-31\n"
    "4,cy,0,true,2000-02-29\n"
)

CSV_QUERIES = [
    "select * from read_csv('{p}')",
    "select name, score from read_csv('{p}', header=>true, delim=>',') where id > 1",
    "select * from csvt order by score desc",
    "select count(*), sum(score), min(dt) from csvt",
    "show tables",
    "describe csvt",
    "select * from sqlrs_columns()",
]


@pytest.mark.parametrize("sql", CSV_QUERIES, ids=[q[:40] for q in CSV_QUERIES])
def test_csv_and_table_functions(tmp_path, sql):
    p = tmp_path / "people.csv"
    p.write_text(CSV_TEXT)
    ref = sqlrs_tpu.Database(base_dir=str(tmp_path))
    port = sqlrs_tpu_torch.Database(base_dir=str(tmp_path), device="cpu")
    ref.create_csv_table("csvt", str(p))
    port.create_csv_table("csvt", str(p))
    q = sql.format(p=p)
    _compare_batches(ref.run(q), port.run(q))


def test_client_context_prepared_and_pending():
    ref, port = sqlrs_tpu.Database(), sqlrs_tpu_torch.Database(device="cpu")
    for db in (ref, port):
        db.run("create table t(a int, b int); insert into t values (1,10),(2,20),(3,30)")
    r_ctx, p_ctx = ref.connect(), port.connect()
    r_prep, p_prep = r_ctx.prepare("select sum(b) from t"), p_ctx.prepare("select sum(b) from t")
    for db in (ref, port):
        db.run("insert into t values (4, 40)")
    assert r_ctx.execute_prepared(r_prep).lines() == p_ctx.execute_prepared(p_prep).lines() == ["100"]
    res = p_ctx.query("select a, b from t where a > 1")
    assert res.names == ["a", "b"] and res.row_count() == 3
    assert [r.lines() for r in p_ctx.query_all("select 1; select a from t limit 1")] == [
        r.lines() for r in r_ctx.query_all("select 1; select a from t limit 1")
    ]
    p1 = p_ctx.pending_query("select a from t")
    p_ctx.pending_query("select b from t")
    with pytest.raises(sqlrs_tpu_torch.ExecutorError):
        p1.execute()
