"""The JAX package's own SQL-level test expectations, as data.

Each `Case` restates one test of the JAX package's tests (its `source`
names it, `tests/<file>::<test>[param]`): the statements the test runs and
the result it asserts, exactly as it asserts it — `run_lines` text, row
tuples, an error class name (`BinderError`, `ExecutorError`, `TypeError_`),
route names in `db.last_fused_routes`, a bound on `db.last_profile`, or a
relation between two runs (the fused route's result equal to the general
path's). Where the test builds its tables from a seeded numpy generator,
the case's table function draws the same numbers in the same order and,
where the test computes an oracle, computes the same oracle here.

The corpus holds three engines to the same expectations:
- tests/test_torch_sql_cases.py runs every case through the JAX package
  (`sqlrs_tpu.Database()`) and through this package on the CPU
  (`Database(device="cpu")`), and over 4 CPU shards;
- `chip_smoke.py`'s `sql_cases` phase runs every case on the card, through
  `Database(device="cuda")` and over 4 shards that share the card.

`run_case(case, engine, tmpdir)` interprets a case against one engine; it
is given the engine's package module and factories, so this file imports
nothing of either package (numpy only).

Sources, in order: tests/test_subqueries.py (27 cases),
test_sql_extended.py (19), test_fused_route.py (31), test_session.py (8),
test_expressions.py (9), test_storage.py (5) and test_types.py (3).

Translations and what is left out:
- test_expressions.py builds `Column`s by hand. Its cases here are SQL over
  a table of the same values (`select l and r from kb`); the checked
  narrowing cast's `safe=True` half has no SQL form and calls
  `ops.elementwise.cast_column` on a column on the engine's device.
- test_types.py: the three SQL-visible tests (literal typing, cast
  overflow, render); the six type-lattice tests (max_logical_type,
  implicit casts, civil dates) are host code, run against the port by
  tests/test_torch_frontend.py.
- test_storage.py: the three CSV tests and the two `DataTable` tests;
  `test_native_loader_matches_python` reads the upstream sqlrs project's
  tests/csv/employee.csv, which is not part of this repository, and is
  left out (the native loader is held to the Python reader by
  tests/test_torch_native_loader.py).
- A test's `pytest.raises(Exception)` is stated as the class the JAX
  package raises (`BinderError` for a dropped view).

Over shards (`Engine.sharded`): the sharded engine logs no fused routes
(`last_fused_routes` is the single-device executor's), and its LIMIT reads
every shard whole (the streaming LIMIT is the single-device executor's
pull loop), so route and scan-bound checks apply to one device only. Every
other expectation holds over shards too, and `same_outputs` holds a shard
run to the single-device run step by step besides.

The array-level JAX tests (tests/test_{grouped_agg,kernels,mxu_grouped,
pallas}.py) are not SQL; each has a counterpart among the port's tests on
the same inputs from the same seeds (tests/test_torch_<file>.py::<test>):
- test_grouped_agg.py: test_differential_vs_legacy[*] -> grouped_agg::
  test_differential_vs_legacy_reference_inputs[*];
  test_varchar_keys_and_minmax -> grouped_agg::
  test_varchar_keys_and_minmax_reference_inputs; test_empty_input,
  test_single_group -> grouped_agg:: the same names;
  test_fused_filter_last_group_key_not_from_dead_row and
  test_fused_filter_dead_null_key_row -> grouped_agg::
  test_fused_filter_regressions; test_filter_fused_into_aggregate_
  matches_compacted, test_distinct_aggregates_sorted_path,
  test_distinct_aggregate_with_filter_fusion, test_distinct_varchar_count
  -> grouped_agg:: the same names.
- test_kernels.py: test_build_table_assigns_unique_slots -> hash::
  test_build_table_equals_reference; test_hash_group_aggregate_matches_
  numpy -> hash::test_hash_group_aggregate_equals_reference[int64];
  test_hash_join_pairs_matches_numpy_and_order -> hash::
  test_hash_join_pairs_equal_reference_in_order[None];
  test_join_pairs_no_hash_collision_false_matches -> hash::
  test_hash_join_pairs_reject_hash_collisions; test_fused_join_groupby_
  pipeline, test_packed_pipeline_matches_plain, test_direct_pipeline_
  misses_and_odd_sizes, test_direct_pipeline_dense_boundary_sharing ->
  pipelines:: the same names; test_sort_based_filter_compaction -> sort::
  the same name; test_mxu_groupby_dense_matches_numpy -> mxu_agg::
  test_mxu_groupby_dense_matches_numpy_reference_inputs;
  test_match_counts_pack2_differential -> join:: the same name.
- test_mxu_grouped.py: test_differential_int_sum_first_appearance,
  test_signed_bias_boundaries, test_value_at_limb_boundary,
  test_group_cap_boundary -> mxu_grouped:: the same names (their cases
  as parameters); test_double_fixed_point_and_products,
  test_null_keys_and_alive_mask -> mxu_grouped::<name>_reference_inputs;
  test_sql_differential_q1_shape -> mxu_grouped:: the same name;
  test_mxu_eligible_boundaries, test_mxu_kernel_at_group_cap_2_16 ->
  mxu_agg:: the same names.
- test_pallas.py: test_row_rank_ge[*], test_masked_row_sum ->
  pallas_kernels::test_row_rank_ge_reference_inputs[*],
  test_masked_row_sum_reference_inputs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import os
from decimal import Decimal
from typing import Any, Callable, Optional

import numpy as np

# ---------------------------------------------------------------------------
# the case format
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Step:
    """One statement (or one call) of a case and what it must give.

    op:
      "run"      Database.run; no result checked (setup), unless `error`.
      "lines"    Database.run_lines == expect.
      "rows"     [tuple(r) for every batch's to_pylist()] == expect.
      "batches"  [(names, num_rows) for each result batch] == expect.
      "types"    the result's column type names == expect.
      "explain"  the optimized_logical_plan section of Database.explain holds
                 every string of expect["has"] and none of expect["lacks"].
      "report"   Database.last_profile.report() holds every string of expect.
      "query"    ClientContext.query: expect's keys among names, lines,
                 row_count, rows are compared.
      "query_all"  ClientContext.query_all(sql)[-1].rows() == expect.
      "prepare"  ClientContext.prepare, kept under `label`.
      "execute_prepared"  the prepared statement named by `sql`; its lines
                 == expect.
      "pending"  ClientContext.pending_query, kept under `label`.
      "execute_pending"   the pending result named by `sql`; its row_count
                 == expect, or it raises `error`.
      "interrupt"  ClientContext.interrupt().
      "cli_new"  a new Cli over the database; expect: its enable_v2.
      "cli"      Cli.run_sql(sql), its output captured; expect's keys:
                 contains (strings in the output), enable_v2, has_context.
      "csv"      write `sql` as a CSV file and read it with
                 storage.csv.read_csv_file(path, CsvConfig(**arg)); expect's
                 keys among names, types, num_rows, rows (the scan's
                 to_pylist()).
      "datatable"  storage.memory.DataTable(arg["names"], arg["types"]), one
                 append_rows call a list of arg["appends"], then expect:
                 num_rows, and scans [(projection, bounds, names or None,
                 rows or None, num_rows)].
      "cast_column"  ops.elementwise.cast_column on a column of arg["type"]
                 made of arg["values"], to arg["to"], safe=arg["safe"];
                 expect its to_pylist(), or `error`.
      "scalar_cast"  ScalarValue.integer_literal(arg["value"]).cast_to(
                 arg["to"], safe=True).is_null == expect.
    rerun_with: database attributes under which the statement runs a second
      time; both runs must give the same lines (the fused route against the
      general path: {"enable_fused_route": False}).
    routes: conditions on the first run's `last_fused_routes` (one device
      only): ("fired",), ("not_fired",), ("any", *subs) — one route holds
      every sub, ("none", sub), ("any_endswith", s), ("none_endswith", s).
    scanned_max: 0 < the profile's TableScan rows_out <= scanned_max (one
      device only).
    label: the step's output is kept under this name for `same_as` and the
      case's `check`.
    same_as: the label of an earlier step whose output this one must equal.
    db: which of the case's databases runs the step.
    env: environment for this step on top of the case's (None unsets).
    """

    sql: str = ""
    op: str = "lines"
    expect: Any = None
    error: Optional[str] = None
    arg: Any = None
    rerun_with: Optional[dict] = None
    routes: tuple = ()
    scanned_max: Optional[int] = None
    label: Optional[str] = None
    same_as: Optional[str] = None
    db: str = "main"
    env: Optional[dict] = None


@dataclasses.dataclass(frozen=True)
class Case:
    """One test of the JAX package's tests.

    tables: {database name: tables in storage.memory.import_tables' form},
      loaded before the steps; a database no step names is not made.
    profile: names of the databases made with profile=True.
    env: environment for the whole case (None unsets a variable).
    check: a function of the labelled outputs, for assertions that relate
      several results; it raises AssertionError.
    """

    source: str
    steps: tuple
    tables: dict = dataclasses.field(default_factory=dict)
    profile: tuple = ()
    env: dict = dataclasses.field(default_factory=dict)
    check: Optional[Callable[[dict], None]] = None

    @property
    def id(self) -> str:
        return self.source.removeprefix("tests/")

    @property
    def file(self) -> str:
        return self.source.split("::")[0].removeprefix("tests/")


def S(sql: str = "", expect: Any = None, **kw) -> Step:
    """A Step; `op` defaults to "lines" when an expectation is given, else
    "run"."""
    if "op" not in kw:
        kw["op"] = "lines" if expect is not None else "run"
    return Step(sql=sql, expect=expect, **kw)


def col(name: str, tname: str, values):
    """One column in import_tables' form from a Python list in which None
    is NULL (stored as 0 under a false validity)."""
    values = list(values)
    valid = np.array([v is not None for v in values], np.bool_)
    filled = [0 if v is None else v for v in values]
    if tname == "VARCHAR":
        arr = np.array([("" if v is None else v) for v in values], dtype=object)
    else:
        arr = np.asarray(filled)
    return (name, tname, arr, None if valid.all() else valid)


NO_ROUTE = {"enable_fused_route": False}
FIRED = (("fired",),)
NOT_FIRED = (("not_fired",),)


def both(sql: str, routes=FIRED, **kw) -> Step:
    """The fused route's differential (test_fused_route._both_ways): the
    statement routed, then with the route off; equal lines, and `routes` on
    the routed run's log."""
    return Step(sql=sql, op="lines", rerun_with=NO_ROUTE, routes=routes, **kw)


# ---------------------------------------------------------------------------
# tests/test_subqueries.py
# ---------------------------------------------------------------------------

_SUB_FIXTURE = (
    S("create table o(okey int, ckey int, prio varchar)"),
    S("insert into o values (1,1,'HI'),(2,1,'LO'),(3,2,'HI'),(4,3,'LO')"),
    S("create table l(okey int, qty int)"),
    S("insert into l values (1,5),(1,7),(2,1),(4,9)"),
)
_LI = (
    S("create table li(pk int, sk int, qty int)"),
    S("insert into li values (1,10,4),(1,10,6),(1,20,20),(2,10,10),(3,30,2)"),
)


def _sub(name: str, *steps, **kw) -> Case:
    return Case(f"tests/test_subqueries.py::{name}", _SUB_FIXTURE + tuple(steps), **kw)


def _comma_join_oracle_random() -> Case:
    rng = np.random.default_rng(7)
    a = rng.integers(0, 20, 200)
    b = rng.integers(0, 20, 150)
    v = rng.integers(-50, 50, 150)
    m = v > 0
    counts = np.bincount(a, minlength=20)
    exp = sum(int(v[i]) * counts[b[i]] for i in range(150) if m[i])
    tables = {"main": {
        "ta": [("k", "BIGINT", a, None)],
        "tb": [("k", "BIGINT", b, None), ("v", "BIGINT", v, None)],
    }}
    return Case(
        "tests/test_subqueries.py::test_comma_join_oracle_random",
        (S("select sum(tb.v) from ta, tb where ta.k = tb.k and tb.v > 0", [str(exp)]),),
        tables=tables,
    )


def _semi_anti_randomized(seed: int) -> Case:
    rng = np.random.default_rng(seed)
    n_o, n_i = 300, 200
    o_k = rng.integers(0, 40, n_o)
    i_k = rng.integers(0, 40, n_i)
    o_null = rng.random(n_o) < 0.1
    i_null = rng.random(n_i) < 0.05
    rows_o = ",".join(f"({'null' if o_null[i] else int(o_k[i])},{i})" for i in range(n_o))
    rows_i = ",".join(f"({'null' if i_null[i] else int(i_k[i])})" for i in range(n_i))
    inner_set = set(i_k[~i_null].tolist())
    inner_has_null = bool(i_null.any())
    exp_in = [str(i) for i in range(n_o) if not o_null[i] and o_k[i] in inner_set]
    if inner_has_null:
        exp_not_in = []
    else:
        exp_not_in = [str(i) for i in range(n_o) if not o_null[i] and o_k[i] not in inner_set]
    exp_not_exists = [str(i) for i in range(n_o) if o_null[i] or o_k[i] not in inner_set]
    return Case(
        f"tests/test_subqueries.py::test_semi_anti_randomized_differential[{seed}]",
        (
            S("create table outer_t(k int, pos int)"),
            S("create table inner_t(k int)"),
            S(f"insert into outer_t values {rows_o}"),
            S(f"insert into inner_t values {rows_i}"),
            S("select pos from outer_t where k in (select k from inner_t)", exp_in),
            S("select pos from outer_t where k not in (select k from inner_t)", exp_not_in),
            S("select pos from outer_t o where exists "
              "(select * from inner_t i where i.k = o.k)", exp_in),
            S("select pos from outer_t o where not exists "
              "(select * from inner_t i where i.k = o.k)", exp_not_exists),
        ),
    )


def _correlated_not_in_oracle() -> Case:
    rng = np.random.default_rng(11)
    n1, n2 = 120, 90
    x = rng.integers(0, 8, n1)
    k1 = rng.integers(0, 5, n1)
    xn = rng.random(n1) < 0.15
    y = rng.integers(0, 8, n2)
    k2 = rng.integers(0, 5, n2)
    yn = rng.random(n2) < 0.1
    exp = []
    for i in range(n1):
        group = [(None if yn[j] else int(y[j])) for j in range(n2) if k2[j] == k1[i]]
        if not group:
            exp.append(str(i))  # NOT IN over an empty set is TRUE
            continue
        if xn[i] or None in group:
            continue  # UNKNOWN
        if int(x[i]) not in group:
            exp.append(str(i))
    return Case(
        "tests/test_subqueries.py::test_correlated_not_in_oracle",
        (
            S("create table t1(x int, k int, pos int)"),
            S("create table t2(y int, k int)"),
            S("insert into t1 values " + ",".join(
                f"({'null' if xn[i] else int(x[i])},{int(k1[i])},{i})" for i in range(n1))),
            S("insert into t2 values " + ",".join(
                f"({'null' if yn[i] else int(y[i])},{int(k2[i])})" for i in range(n2))),
            S("select pos from t1 where x not in (select y from t2 where t2.k = t1.k)", exp),
        ),
    )


def subquery_cases() -> list:
    no_cross = {"has": ["Join(inner"], "lacks": ["CrossJoin"]}
    return [
        _sub("test_exists_correlated", S(
            "select okey from o where exists "
            "(select * from l where l.okey = o.okey and l.qty > 4)", ["1", "4"])),
        _sub("test_not_exists", S(
            "select okey from o where not exists (select * from l where l.okey = o.okey)",
            ["3"])),
        _sub("test_in_subquery", S(
            "select okey from o where okey in (select okey from l where qty > 2)",
            ["1", "4"])),
        _sub("test_not_in_subquery", S(
            "select okey from o where okey not in (select okey from l)", ["3"])),
        _sub("test_not_in_null_aware",
             S("insert into l values (null, 2)"),
             S("select okey from o where okey not in (select okey from l)", [])),
        _sub("test_not_in_empty_inner", S(
            "select okey from o where okey not in (select okey from l where qty > 100)",
            ["1", "2", "3", "4"])),
        _sub("test_in_grouped_having_inner", S(
            "select okey from o where okey in "
            "(select okey from l group by okey having sum(qty) > 10)", ["1"])),
        _sub("test_exists_with_inequality_residual", *_LI, S(
            "select pk, sk from li l1 where exists "
            "(select * from li l2 where l2.pk = l1.pk and l2.sk <> l1.sk)",
            ["1 10", "1 10", "1 20"])),
        _sub("test_correlated_scalar_single_key", *_LI, S(
            "select sum(qty) from li where qty < "
            "(select 0.5 * avg(qty) from li l2 where l2.pk = li.pk)", ["4"])),
        _sub("test_correlated_scalar_two_keys", *_LI, S(
            "select pk, sk from li l0 where qty > "
            "(select 0.5*sum(qty) from li l2 where l2.pk = l0.pk and l2.sk = l0.sk) "
            "and qty > 4", ["1 10", "1 20", "2 10"])),
        _sub("test_correlated_scalar_empty_group_is_null", S(
            "select okey from o where okey <= "
            "(select sum(qty) from l where l.okey = o.okey)", ["1", "4"])),
        _sub("test_scalar_subquery_in_having", S(
            "select ckey, sum(okey) from o group by ckey "
            "having sum(okey) > (select 0.8 * max(okey) from o)", ["3 4"])),
        _sub("test_view_lifecycle",
             S("create view v1 (a, total) as select okey, sum(qty) from l group by okey"),
             S("select a, total from v1 where total = (select max(total) from v1)",
               ["1 12"]),
             S("drop view v1"),
             S("select * from v1", error="BinderError"),
             S("drop view if exists v1")),
        _sub("test_cte", S(
            "with rev (a, t) as (select okey, sum(qty) from l group by okey) "
            "select a from rev where t > 8 order by a", ["1", "4"])),
        _sub("test_substring_and_concat", S(
            "select substring(prio from 1 for 1), prio || '!' from o order by okey",
            ["H HI!", "L LO!", "H HI!", "L LO!"])),
        _sub("test_substring_in_list", S(
            "select count(*) from o where substring(prio from 1 for 1) in ('H')", ["2"])),
        _sub("test_comma_join_becomes_hash_join",
             S("select o.okey, l.qty from o, l where o.okey = l.okey",
               ["1 5", "1 7", "2 1", "4 9"]),
             S("select o.okey from o, l where o.okey = l.okey", no_cross, op="explain")),
        _comma_join_oracle_random(),
        *[_semi_anti_randomized(seed) for seed in (0, 1, 2)],
        _sub("test_uncorrelated_exists",
             S("select okey from o where exists (select 1 from l)", ["1", "2", "3", "4"]),
             S("select okey from o where not exists (select 1 from l)", []),
             S("select okey from o where exists (select 1 from l where qty > 100)", []),
             S("select okey from o where not exists (select 1 from l where qty > 100)",
               ["1", "2", "3", "4"])),
        Case("tests/test_subqueries.py::test_correlated_not_in_three_valued", (
            S("create table t1(x int, k int)"),
            S("create table t2(y int, k int)"),
            S("insert into t1 values (1,1),(3,1),(10,1),(3,2),(7,9)"),
            S("insert into t2 values (10,1),(11,1),(3,2),(null,2)"),
            S("select x from t1 where x not in (select y from t2 where t2.k = t1.k)",
              ["1", "3", "7"]),
            S("insert into t1 values (null, 1), (null, 9)"),
            S("select k from t1 where x not in (select y from t2 where t2.k = t1.k)",
              ["1", "1", "9", "9"]),
            S("select x from t1 where k = 2 and "
              "x not in (select y from t2 where t2.k = t1.k and y is not null)", []),
            S("insert into t1 values (99, 2)"),
            S("select x from t1 where k = 2 and "
              "x not in (select y from t2 where t2.k = t1.k)", []),
        )),
        _correlated_not_in_oracle(),
        Case("tests/test_subqueries.py::test_view_does_not_capture_use_site_cte", (
            S("create table base(a int)"),
            S("insert into base values (1),(2)"),
            S("create view v as select a from base"),
            S("with base(a) as (select 99) select a from v order by a", ["1", "2"]),
            S("with base(a) as (select 99) select a from base", ["99"]),
        )),
        Case("tests/test_subqueries.py::test_correlation_edge_cases", (
            S("create table a(x int, y int)"),
            S("insert into a values (1,10),(2,20),(3,30)"),
            S("create table b(x int, z int)"),
            S("insert into b values (1,5),(1,6),(2,100),(3,1)"),
            S("select x from a where y > (select sum(z) from b where b.x = a.x) "
              "and exists (select * from b where b.x = a.x and z < 10)", ["3"]),
            S("select x from a where exists (select * from b where b.x = a.x and "
              "b.z > (select avg(z) from b b2 where b2.x = b.x))", ["1"]),
            S("select x from a where exists (select * from b where b.x = a.x and "
              "z > (select min(z) from b))", ["1", "2"]),
            S("select x from a where y in (select z * 2 from b where b.x = a.x)", ["1"]),
        )),
        Case("tests/test_subqueries.py::test_factor_or_common_plan_shape", (
            S("create table f(k int, q int)"),
            S("create table d(k int, size int)"),
            S("insert into f values (1,5),(2,15)"),
            S("insert into d values (1,3),(2,8)"),
            S("select count(*) from f, d where (f.k = d.k and q < 10 and size < 5) "
              "or (f.k = d.k and q >= 10 and size >= 5)", ["2"]),
            S("select count(*) from f, d where (f.k = d.k and q < 10 and size < 5) "
              "or (f.k = d.k and q >= 10 and size >= 5)", no_cross, op="explain"),
        )),
    ]


# ---------------------------------------------------------------------------
# tests/test_sql_extended.py
# ---------------------------------------------------------------------------

_EXT_FIXTURE = (
    S("""create table o(id int, status varchar, price double, d date);
        insert into o values
         (1, 'shipped', 10.5, '1995-03-15'), (2, 'pending', 20.0, '1996-07-01'),
         (3, 'shipped', 5.25, '1995-12-31'), (4, NULL, 7.0, '1997-01-01'),
         (5, 'cancelled', 100.0, '1995-06-30')"""),
)

EXTENDED_SQL = [
    ("select id from o where price between 7 and 25", ["1", "2", "4"]),
    ("select id from o where price not between 7 and 25", ["3", "5"]),
    ("select id from o where id in (1, 3, 5)", ["1", "3", "5"]),
    ("select id from o where id not in (1, 3, 5)", ["2", "4"]),
    ("select id from o where status like 'ship%'", ["1", "3"]),
    ("select id from o where status like '%end%'", ["2"]),
    ("select id from o where status like '_ancelled'", ["5"]),
    ("select id from o where status not like 'ship%'", ["2", "5"]),
    ("select id from o where status is null", ["4"]),
    ("select id from o where status is not null", ["1", "2", "3", "5"]),
    ("select id, case when price > 50 then 'big' when price > 10 then 'mid'"
     " else 'small' end from o", ["1 mid", "2 mid", "3 small", "4 small", "5 big"]),
    ("select case status when 'shipped' then 1 else 0 end from o",
     ["1", "0", "1", "0", "0"]),
    ("select case when id = 1 then 7 end from o", ["7", "NULL", "NULL", "NULL", "NULL"]),
    ("select id from o where extract(year from d) = 1995", ["1", "3", "5"]),
    ("select extract(month from d), extract(day from d) from o where id = 1", ["3 15"]),
    ("select sum(case when status = 'shipped' then price else 0 end) from o", ["15.75"]),
    ("select id from o where status like 'ship.ed'", []),
]


def _chunked_residual_join() -> Case:
    rng = np.random.default_rng(5)
    n_l, n_r = 400, 700
    rows_l = ",".join(
        f"({int(k)},{int(v)})"
        for k, v in zip(rng.integers(0, 25, n_l), rng.integers(0, 100, n_l))
    )
    rows_r = ",".join(
        f"({int(k)},{int(v)})"
        for k, v in zip(rng.integers(0, 25, n_r), rng.integers(0, 100, n_r))
    )
    budget = {"join_pair_budget": 512}  # ~11K pairs here -> many chunks
    return Case("tests/test_sql_extended.py::test_chunked_residual_join_pairs", (
        S("create table a(k int, x int)"),
        S("create table b(k int, y int)"),
        S(f"insert into a values {rows_l}"),
        S(f"insert into b values {rows_r}"),
        S("select * from a join b on a.k = b.k and a.x < b.y", rerun_with=budget),
        S("select a.k, sum(b.y) from a join b on a.k = b.k and a.x + b.y > 120"
          " group by a.k", rerun_with=budget),
        S("select count(*) from a left join b on a.k = b.k and a.x < b.y - 5",
          rerun_with=budget),
    ))


def extended_cases() -> list:
    out = [
        Case(f"tests/test_sql_extended.py::test_extended_sql[{sql[:48]}]",
             _EXT_FIXTURE + (S(sql, expected),))
        for sql, expected in EXTENDED_SQL
    ]
    out.append(Case(
        "tests/test_sql_extended.py::test_streaming_limit_touches_chunks_not_table",
        (
            S("select a from big where a % 2 = 0 limit 10",
              [(i,) for i in range(0, 20, 2)], op="rows", scanned_max=4096),
            S("select a from big where a < 5 limit 10 offset 3", [(3,), (4,)], op="rows"),
            S("select a from big limit 0", [(["a"], 0)], op="batches"),
        ),
        tables={"main": {"big": [("a", "BIGINT", np.arange(300_000, dtype=np.int64), None)]}},
        profile=("main",),
    ))
    out.append(_chunked_residual_join())
    return out


# ---------------------------------------------------------------------------
# tests/test_fused_route.py
# ---------------------------------------------------------------------------

STAR_SQL = ("select d.k, sum(f.v), count(*) from f join d on f.k = d.k "
            "group by d.k order by d.k")
MISS = 10_000_019  # a fact key above every dim key


def _mk_db(fact_rows, dim_keys, seed=0, null_every=None) -> dict:
    """test_fused_route._mk_db's tables: fact f(k, v), dim d(k)."""
    rng = np.random.default_rng(seed)
    dim = np.asarray(dim_keys, dtype=np.int64)
    gid = rng.integers(0, len(dim), fact_rows)
    fk = dim[gid].astype(np.int64)
    fk[::7] = MISS
    fv = rng.integers(0, 1000, fact_rows).astype(np.int64)
    fk_list = fk.tolist()
    if null_every:
        fk_list = [None if i % null_every == 0 else v for i, v in enumerate(fk_list)]
    return {
        "f": [col("k", "BIGINT", fk_list), ("v", "BIGINT", fv, None)],
        "d": [("k", "BIGINT", dim, None)],
    }


def _fd(f_cols, dim, d_extra=()) -> dict:
    """A fact table of the given columns and a dim d(k, extra...)."""
    return {"f": list(f_cols), "d": [("k", "BIGINT", np.asarray(dim, np.int64), None),
                                     *d_extra]}


def _route(name: str, steps, tables=None, **kw) -> Case:
    return Case(f"tests/test_fused_route.py::{name}", tuple(steps),
                tables={"main": tables} if tables is not None else {}, **kw)


def _route_oracle() -> Case:
    rng = np.random.default_rng(5)
    dim = (np.arange(48) * 7 + 1).astype(np.int64)
    n = 4096
    gid = rng.integers(0, 48, n)
    fk = dim[gid]
    fv = rng.integers(0, 100, n).astype(np.int64)
    exp_s = np.zeros(48, np.int64)
    exp_c = np.zeros(48, np.int64)
    np.add.at(exp_s, gid, fv)
    np.add.at(exp_c, gid, 1)
    exp = [f"{k} {s} {c}" for k, s, c in zip(dim, exp_s, exp_c) if c > 0]
    return _route("test_route_oracle", [S(STAR_SQL, exp, routes=FIRED)],
                  _fd([("k", "BIGINT", fk, None), ("v", "BIGINT", fv, None)], dim))


_FIRSTAPP = [
    ("select d.k, sum(f.v), count(*) from f join d on f.k = d.k group by d.k", "fact_left"),
    ("select d.k, sum(f.v), count(*) from d join f on f.k = d.k group by d.k", "fact_right"),
    ("select d.k, avg(f.v), count(f.v) from f join d on f.k = d.k group by d.k", "avg"),
]


def _firstapp(sql: str, name: str) -> Case:
    dim = np.array([50, 7, 93, 22, 68, 1, 39, 84, 15, 61], dtype=np.int64)
    rng = np.random.default_rng(8)
    n = 3000
    gid = rng.integers(0, len(dim), n)
    fk = dim[gid].copy()
    fk[::9] = 999  # misses
    fv = rng.integers(-50, 50, n).astype(np.int64)
    return _route(f"test_firstapp_route_matches_general_path[{name}]",
                  [both(sql, (("any", "firstapp"),))],
                  _fd([("k", "BIGINT", fk, None), ("v", "BIGINT", fv, None)], dim))


def _extra_dim_group_columns() -> Case:
    rng = np.random.default_rng(12)
    dim = np.array([30, 4, 18, 92, 55, 11, 73, 47], dtype=np.int64)
    names = [" containerA", None, "containerC", "d", "e", "f", "g", "h"]
    n = 2500
    gid = rng.integers(0, len(dim), n)
    fk = dim[gid]
    fv = rng.integers(0, 80, n).astype(np.int64)
    return _route("test_route_extra_dim_group_columns", [
        both("select d.k, d.name, sum(f.v) from f join d on f.k = d.k "
             "group by d.k, d.name order by d.k", (("any", "order_agg_join_direct"),)),
        both("select d.k, d.name, sum(f.v), count(*) from f join d on f.k = d.k "
             "group by d.k, d.name", (("any", "agg_join_firstapp"),)),
        both("select d.k, d.name, count(*) from d join f on f.k = d.k "
             "group by d.k, d.name", (("any", "agg_join_firstapp"),)),
    ], _fd([("k", "BIGINT", fk, None), ("v", "BIGINT", fv, None)], dim,
           [col("name", "VARCHAR", names)]))


def _multi_value_columns() -> Case:
    rng = np.random.default_rng(21)
    dim = (np.arange(32) * 3 + 4).astype(np.int64)
    n = 4000
    gid = rng.integers(0, len(dim), n)
    fk = dim[gid].copy()
    fk[::13] = MISS
    fa = rng.integers(0, 500, n).astype(np.int64)
    fb = rng.integers(-80, 80, n).astype(np.int64)
    direct, firstapp = (("any", "order_agg_join_direct"),), (("any", "agg_join_firstapp"),)
    return _route("test_route_multi_value_columns", [
        both("select d.k, sum(f.a), min(f.a), max(f.a), sum(f.b), avg(f.b), "
             "count(*) from f join d on f.k = d.k group by d.k order by d.k", direct),
        both("select d.k, sum(f.b), sum(f.a), count(*) from f join d "
             "on f.k = d.k group by d.k order by d.k", direct),
        both("select d.k, sum(f.a), sum(f.b), avg(f.a), count(f.b) "
             "from f join d on f.k = d.k group by d.k", firstapp),
        both("select d.k, sum(f.a * 2 + f.b), sum(f.b), min(f.a) from f join d "
             "on f.k = d.k group by d.k order by d.k", direct),
        both("select d.k, min(f.a), max(f.b) from f join d on f.k = d.k "
             "group by d.k order by d.k", NOT_FIRED),
    ], _fd([("k", "BIGINT", fk, None), ("a", "BIGINT", fa, None),
            ("b", "BIGINT", fb, None)], dim))


def _nullable_value_columns() -> Case:
    rng = np.random.default_rng(31)
    dim = (np.arange(24) * 2 + 1).astype(np.int64)
    n = 3000
    gid = rng.integers(0, len(dim), n)
    fk = dim[gid].copy()
    fk[::17] = MISS
    fv = rng.integers(-30, 120, n)
    vals = [None if i % 5 == 0 else int(v) for i, v in enumerate(fv)]
    vals = [None if k == dim[0] else v for k, v in zip(fk.tolist(), vals)]
    fw = rng.integers(0, 15, n)
    wvals = [None if i % 4 == 0 else int(v) for i, v in enumerate(fw)]
    wvals = [None if k == dim[0] else v for k, v in zip(fk.tolist(), wvals)]
    return _route("test_route_nullable_value_columns", [
        both("select d.k, sum(f.v), count(f.v), count(*) from f join d "
             "on f.k = d.k group by d.k order by d.k"),
        both("select d.k, avg(f.v), count(f.v) from f join d on f.k = d.k "
             "group by d.k"),
        both("select d.k, min(f.w), max(f.w), sum(f.w), count(*) from f join d "
             "on f.k = d.k group by d.k order by d.k"),
        both("select d.k, count(distinct f.w), sum(distinct f.w), avg(f.w) "
             "from f join d on f.k = d.k group by d.k order by d.k"),
        both("select d.k, max(f.w), sum(f.v), count(f.v) from f join d "
             "on f.k = d.k group by d.k order by d.k"),
    ], _fd([("k", "BIGINT", fk, None), col("v", "BIGINT", vals),
            col("w", "BIGINT", wvals)], dim))


def _distinct_aggregates() -> Case:
    rng = np.random.default_rng(41)
    dim = (np.arange(20) * 4 + 3).astype(np.int64)
    n = 2500
    gid = rng.integers(0, len(dim), n)
    fk = dim[gid].copy()
    fk[::11] = MISS
    fv = rng.integers(0, 12, n).astype(np.int64)
    hit = fk != MISS
    exp = {}
    for k, v in zip(fk[hit], fv[hit]):
        exp.setdefault(int(k), set()).add(int(v))
    oracle = [f"{k} {len(vs)}" for k, vs in sorted(exp.items())]
    return _route("test_route_distinct_aggregates", [
        both("select d.k, count(distinct f.v), count(*) from f join d "
             "on f.k = d.k group by d.k order by d.k"),
        both("select d.k, sum(distinct f.v), sum(f.v) from f join d "
             "on f.k = d.k group by d.k order by d.k"),
        both("select d.k, avg(distinct f.v), min(f.v), max(f.v) from f join d "
             "on f.k = d.k group by d.k order by d.k"),
        S("select d.k, count(distinct f.v) from f join d on f.k = d.k "
          "group by d.k order by d.k", oracle, routes=FIRED),
        both("select d.k, count(distinct f.v), sum(distinct f.v + 1) "
             "from f join d on f.k = d.k group by d.k order by d.k", NOT_FIRED),
    ], _fd([("k", "BIGINT", fk, None), ("v", "BIGINT", fv, None)], dim))


def _multi_value_oracle() -> Case:
    rng = np.random.default_rng(22)
    dim = np.arange(20, dtype=np.int64) + 3
    n = 2048
    gid = rng.integers(0, len(dim), n)
    fk = dim[gid]
    fa = rng.integers(0, 90, n).astype(np.int64)
    fb = rng.integers(-40, 40, n).astype(np.int64)
    sa = np.zeros(len(dim), np.int64)
    sb = np.zeros(len(dim), np.int64)
    cnt = np.zeros(len(dim), np.int64)
    np.add.at(sa, gid, fa)
    np.add.at(sb, gid, fb)
    np.add.at(cnt, gid, 1)
    exp = [f"{k} {x} {y} {c}" for k, x, y, c in zip(dim, sa, sb, cnt) if c > 0]
    return _route("test_route_multi_value_oracle", [
        S("select d.k, sum(f.a), sum(f.b), count(*) from f join d "
          "on f.k = d.k group by d.k order by d.k", exp, routes=FIRED),
    ], _fd([("k", "BIGINT", fk, None), ("a", "BIGINT", fa, None),
            ("b", "BIGINT", fb, None)], dim))


def _route_fuzz_differential() -> Case:
    rng = np.random.default_rng(77)
    agg_pool = [
        "sum(f.a)", "sum(f.b)", "count(f.a)", "count(f.b)", "count(*)",
        "avg(f.a)", "avg(f.b)", "min(f.a)", "max(f.a)",
        "sum(f.a + f.b)", "count(distinct f.a)", "sum(distinct f.a)",
    ]
    tables, steps = {}, []
    for case in range(10):
        g = int(rng.integers(4, 40))
        dense = bool(rng.integers(0, 2))
        base = int(rng.integers(-50, 50))
        dim = (np.arange(g) + base if dense
               else np.cumsum(rng.integers(1, 9, g)) + base).astype(np.int64)
        n = int(rng.integers(200, 1500))
        gid = rng.integers(0, g, n)
        fk = dim[gid].copy()
        fk[:: int(rng.integers(5, 15))] = dim.max() + 7  # misses
        a_max = int(rng.integers(2, 200))
        fa = rng.integers(0, a_max, n).astype(np.int64)
        fb = rng.integers(-100, 100, n).astype(np.int64)
        null_a = int(rng.integers(0, 3))  # 0: none
        avals = [None if (null_a and i % (null_a * 7) == 0) else int(v)
                 for i, v in enumerate(fa)]
        n_aggs = int(rng.integers(1, 5))
        aggs = ", ".join(rng.choice(agg_pool, n_aggs, replace=False))
        order = " order by d.k" if rng.integers(0, 2) else ""
        db = f"case{case}"
        tables[db] = _fd([("k", "BIGINT", fk, None), col("a", "BIGINT", avals),
                          ("b", "BIGINT", fb, None)], dim)
        steps.append(both(f"select d.k, {aggs} from f join d on f.k = d.k "
                          f"group by d.k{order}", routes=(), db=db, label=f"case{case}"))

    def fired_in_most(out: dict) -> None:
        if out["sharded"]:
            return  # the sharded engine logs no fused routes
        fired = sum(bool(out[f"case{c}:routes"]) for c in range(10))
        assert fired >= 5, f"routes fired in only {fired}/10 cases"

    return Case("tests/test_fused_route.py::test_route_fuzz_differential", tuple(steps),
                tables=tables, check=fired_in_most)


def _composite_key_routes() -> Case:
    rng = np.random.default_rng(55)
    k1 = np.repeat(np.arange(6, dtype=np.int64) * 3 + 10, 4)
    k2 = np.tile(np.array([2, 5, 7, 11], dtype=np.int64), 6)
    n = 4000
    pick = rng.integers(0, len(k1), n)
    fk1 = k1[pick].copy()
    fk2 = k2[pick].copy()
    fk1[::9] = 999          # major miss
    fk2[::7] = 100          # minor out of the dim's span
    fk2[3::13] = 6          # minor in span but not a dim value
    fv = rng.integers(0, 50, n).astype(np.int64)
    k1l = fk1.tolist()
    k1l[5] = None           # NULL major key
    valid = np.ones(n, bool)
    valid[5] = False
    exp = {}
    dimset = set(zip(k1.tolist(), k2.tolist()))
    for i in range(n):
        if not valid[i]:
            continue
        kk = (int(fk1[i]), int(fk2[i]))
        if kk in dimset:
            s, c = exp.get(kk, (0, 0))
            exp[kk] = (s + int(fv[i]), c + 1)
    oracle = [f"{a} {b} {s} {c}" for (a, b), (s, c) in sorted(exp.items())]
    base = "from f join d on f.a = d.a and f.b = d.b group by d.a, d.b"
    direct = (("any", "order_agg_join_direct", "_ck2"),)
    no_order = (("none", "order_agg"),)
    tables = {
        "f": [col("a", "BIGINT", k1l), ("b", "BIGINT", fk2, None), ("v", "BIGINT", fv, None)],
        "d": [("a", "BIGINT", k1, None), ("b", "BIGINT", k2, None)],
    }
    return _route("test_composite_key_routes", [
        both(f"select d.a, d.b, sum(f.v), count(*) {base} order by d.a, d.b", direct),
        both(f"select d.a, d.b, min(f.v), max(f.v), count(distinct f.v) {base} "
             "order by d.a, d.b", direct),
        both(f"select d.a, d.b, sum(f.v) {base} order by d.a desc, d.b desc", direct),
        both(f"select d.a, d.b, sum(f.v), avg(f.v) {base}",
             (("any", "agg_join_firstapp", "_ck2"),)),
        both("select f.a, f.b, count(*) from f join d on f.a = d.a and "
             "f.b = d.b group by f.a, f.b order by f.a, f.b", direct),
        S(f"select d.a, d.b, sum(f.v), count(*) {base} order by d.a, d.b", oracle,
          routes=FIRED),
        both(f"select d.a, d.b, sum(f.v) {base} order by d.a", no_order),
        both(f"select d.a, d.b, sum(f.v) {base} order by d.a, d.b desc", no_order),
        both("select d.a, count(*) from f join d on f.a = d.a and f.b = d.b "
             "group by d.a", NOT_FIRED),
    ], tables)


def _composite_key_fuzz() -> Case:
    tables, steps = {}, []
    for seed in range(300, 306):
        rng = np.random.default_rng(seed)
        g1, g2 = int(rng.integers(2, 8)), int(rng.integers(2, 8))
        k1 = np.repeat(np.arange(g1, dtype=np.int64) * int(rng.integers(1, 5))
                       + int(rng.integers(-9, 9)), g2)
        k2 = np.tile(np.cumsum(rng.integers(1, 4, g2)).astype(np.int64), g1)
        n = int(rng.integers(200, 1200))
        pick = rng.integers(0, len(k1), n)
        fk1, fk2 = k1[pick].copy(), k2[pick].copy()
        fk1[:: int(rng.integers(5, 11))] = k1.max() + 2
        fk2[:: int(rng.integers(6, 13))] = k2.max() + 7  # out-of-span minors
        fv = rng.integers(-40, 90, n).astype(np.int64)
        aggs = rng.choice(["sum(f.v)", "count(*)", "avg(f.v)", "count(f.v)"],
                          int(rng.integers(1, 4)), replace=False)
        order = ["", " order by d.a, d.b",
                 " order by d.a desc, d.b desc"][int(rng.integers(0, 3))]
        db = f"seed{seed}"
        tables[db] = {
            "f": [("a", "BIGINT", fk1, None), ("b", "BIGINT", fk2, None),
                  ("v", "BIGINT", fv, None)],
            "d": [("a", "BIGINT", k1, None), ("b", "BIGINT", k2, None)],
        }
        steps.append(both(f"select d.a, d.b, {', '.join(aggs)} from f join d "
                          f"on f.a = d.a and f.b = d.b group by d.a, d.b{order}", db=db))
    return Case("tests/test_fused_route.py::test_composite_key_fuzz", tuple(steps),
                tables=tables)


def _route_float_measures() -> Case:
    rng = np.random.default_rng(91)
    dim = (np.arange(28) * 3 + 2).astype(np.int64)
    n = 3000
    gid = rng.integers(0, len(dim), n)
    fk = dim[gid].copy()
    fk[::8] = MISS
    fv = rng.integers(-400, 400, n) / 4.0  # exact dyadic values
    fw = rng.integers(0, 90, n).astype(np.int64)
    vals = [None if i % 6 == 0 else float(v) for i, v in enumerate(fv)]
    direct, firstapp = (("any", "order_agg_join_direct"),), (("any", "agg_join_firstapp"),)
    tv = (("any", "_tv"),)
    tables = {
        "f": [("k", "BIGINT", fk, None), ("x", "DOUBLE", fv, None), ("w", "BIGINT", fw, None)],
        "fn": [("k", "BIGINT", fk, None), col("x", "DOUBLE", vals)],
        "d": [("k", "BIGINT", dim, None)],
    }
    return _route("test_route_float_measures", [
        both("select d.k, sum(f.x), count(*) from f join d on f.k = d.k "
             "group by d.k order by d.k", direct),
        both("select d.k, sum(f.x), min(f.w), max(f.w) from f join d "
             "on f.k = d.k group by d.k order by d.k", direct),
        both("select d.k, sum(f.x * 2.0 + 1.0), avg(f.x), count(*) from f "
             "join d on f.k = d.k group by d.k order by d.k", direct),
        both("select d.k, sum(f.x), avg(f.x), count(*) from f join d "
             "on f.k = d.k group by d.k", firstapp),
        both("select d.k, sum(fn.x), count(fn.x), avg(fn.x) from fn join d "
             "on fn.k = d.k group by d.k order by d.k", direct),
        both("select d.k, min(f.x) from f join d on f.k = d.k "
             "group by d.k order by d.k", tv),
        both("select d.k, min(f.x), max(f.x), sum(f.x), avg(f.x), count(*) "
             "from f join d on f.k = d.k group by d.k order by d.k", tv),
        both("select d.k, max(f.x), sum(f.w) from f join d on f.k = d.k "
             "group by d.k order by d.k", tv),
        both("select d.k, min(fn.x), max(fn.x), sum(fn.x), count(fn.x) "
             "from fn join d on fn.k = d.k group by d.k order by d.k", tv),
        both("select d.k, min(f.x), max(f.x) from f join d on f.k = d.k "
             "group by d.k order by d.k desc", tv),
        both("select d.k, count(distinct f.x) from f join d on f.k = d.k "
             "group by d.k order by d.k", NOT_FIRED),
    ], tables)


def _route_float_oracle() -> Case:
    rng = np.random.default_rng(92)
    dim = np.arange(16, dtype=np.int64) + 1
    n = 2000
    gid = rng.integers(0, len(dim), n)
    fk = dim[gid]
    fv = rng.uniform(900.0, 105000.0, n) * (1 - rng.uniform(0, 0.1, n))
    exp = np.zeros(len(dim))
    np.add.at(exp, gid, fv)

    def sums_close(out: dict) -> None:
        # the JAX test reads the raw column; the rendered text is its
        # shortest round-trip repr, so parsing it gives the same doubles
        got = np.array([float(line.split()[1]) for line in out["sums"]])
        np.testing.assert_allclose(got, exp, rtol=1e-12)

    return _route("test_route_float_oracle", [
        S("select d.k, sum(f.x) from f join d on f.k = d.k group by d.k order by d.k",
          op="lines", routes=FIRED, label="sums"),
    ], _fd([("k", "BIGINT", fk, None), ("x", "DOUBLE", fv, None)], dim), check=sums_close)


def _group_key_any_position() -> Case:
    rng = np.random.default_rng(93)
    dim = np.array([30, 4, 18, 92, 55, 11, 73, 47], dtype=np.int64)
    names = ["nA", "nB", None, "nD", "nE", "nF", "nG", "nH"]
    n = 2500
    gid = rng.integers(0, len(dim), n)
    fk = dim[gid].copy()
    fk[::9] = 999
    fv = rng.integers(-40, 80, n).astype(np.int64)
    return _route("test_route_group_key_any_position", [
        both("select d.name, d.k, sum(f.v), count(*) from f join d "
             "on f.k = d.k group by d.name, d.k"),
        both("select d.name, f.k, sum(f.v) from f join d on f.k = d.k "
             "group by d.name, f.k"),
        both("select d.k, f.k, count(*) from f join d on f.k = d.k "
             "group by d.k, f.k"),
        both("select d.name, d.k, sum(f.v) from f join d on f.k = d.k "
             "group by d.name, d.k order by d.name", (("none", "order_agg"),)),
    ], _fd([("k", "BIGINT", fk, None), ("v", "BIGINT", fv, None)], dim,
           [col("name", "VARCHAR", names)]))


def _semi_join_pushdown() -> Case:
    rng = np.random.default_rng(97)
    dim = (np.arange(30) * 2 + 4).astype(np.int64)
    n = 3000
    gid = rng.integers(0, len(dim), n)
    fk = dim[gid].copy()
    fk[::9] = MISS
    fv = rng.integers(-200, 200, n) / 4.0  # exact dyadic DOUBLEs
    tables = _fd([("k", "BIGINT", fk, None), ("x", "DOUBLE", fv, None)], dim)
    tables["s"] = [("k", "BIGINT", np.array(dim[::3].tolist() + [999999], np.int64), None)]
    firstapp = (("any", "firstapp"),)

    def partition(out: dict) -> None:
        first = {k: [r.split()[0] for r in out[k]] for k in ("in_dim", "in_fact", "not_in", "base")}
        assert first["in_dim"] == first["in_fact"], (first["in_dim"], first["in_fact"])
        keys_in, keys_not = set(first["in_dim"]), set(first["not_in"])
        assert not (keys_in & keys_not), keys_in & keys_not
        assert keys_in | keys_not == set(first["base"])

    return _route("test_semi_join_pushdown_routes_q18_shape", [
        both("select d.k, sum(f.x), count(*) from f join d on f.k = d.k "
             "where d.k in (select k from s) group by d.k", firstapp, label="in_dim"),
        both("select d.k, sum(f.x) from f join d on f.k = d.k "
             "where f.k in (select k from s) group by d.k", firstapp, label="in_fact"),
        both("select d.k, sum(f.x) from f join d on f.k = d.k "
             "where d.k not in (select k from s) group by d.k", firstapp, label="not_in"),
        S("select d.k, sum(f.x) from f join d on f.k = d.k group by d.k", op="lines",
          label="base"),
    ], tables, check=partition)


def _route_mxu_kernel() -> Case:
    interp = {"SQLRS_TPU_MXU": "interpret"}
    sql3 = ("select d.k, sum(f.v), min(f.v) from f join d on f.k = d.k "
            "group by d.k order by d.k")
    return Case("tests/test_fused_route.py::test_route_mxu_kernel_matches_general_path", (
        both(STAR_SQL, (("any_endswith", "_mxu"),), label="routed", env=interp),
        both(STAR_SQL, (("any_endswith", "_mxu"),), db="db2", env=interp),
        both(sql3, (("fired",), ("none_endswith", "_mxu")), env=interp),
        both(STAR_SQL, (("fired",), ("none_endswith", "_mxu")), same_as="routed",
             env={"SQLRS_TPU_MXU": "0"}),
    ), tables={"main": _mk_db(5000, np.arange(64) + 100, seed=51),
               "db2": _mk_db(3000, np.arange(32) + 7, seed=52, null_every=9)})


def _decimal_sums_exact_at_scale() -> Case:
    rng = np.random.default_rng(55)
    n, g = 1 << 20, 1 << 10
    gid = rng.integers(0, g, n)
    dim = np.arange(g, dtype=np.int64) * 7 + 3
    fk = dim[gid]
    price = np.round(rng.uniform(900, 10500, n), 2)
    disc = np.round(rng.uniform(0, 0.1, n), 2)
    # Decimal-exact oracle: integer cents products, summed per key
    cents = np.rint(price * 100).astype(np.int64) * (100 - np.rint(disc * 100).astype(np.int64))
    acc = np.zeros(g, np.int64)
    np.add.at(acc, gid, cents)

    def exact(out: dict) -> None:
        for line in out["sums"][:64]:
            kstr, vstr = line.split()
            want = float(Decimal(int(acc[(int(kstr) - 3) // 7])) / Decimal(10 ** 4))
            assert float(vstr) == want, (line, want)

    tables = {
        "f": [("k", "BIGINT", fk, None), ("p", "DOUBLE", price, None), ("d", "DOUBLE", disc, None)],
        "dm": [("k", "BIGINT", dim, None)],
    }
    return _route("test_route_decimal_sums_exact_at_scale", [
        S("select dm.k, sum(f.p * (1 - f.d)) from f join dm on f.k = dm.k "
          "group by dm.k order by dm.k", op="lines", routes=FIRED, label="sums"),
    ], tables, check=exact)


def fused_route_cases() -> list:
    out = [
        _route(f"test_route_matches_general_path[dim_keys{i}]", [both(STAR_SQL)],
               _mk_db(5000, keys, seed=1))
        for i, keys in enumerate([np.arange(64) + 100, np.arange(64) * 13 + 5,
                                  np.arange(64) * 977 - 3000])
    ]
    out += [
        _route("test_route_with_null_fact_keys_and_count_v", [both(
            "select d.k, count(f.v), sum(f.v) from f join d on f.k = d.k "
            "group by d.k order by d.k")], _mk_db(3000, np.arange(32) + 7, seed=2, null_every=11)),
        _route("test_route_group_on_fact_side_key", [both(
            "select f.k, count(*) from f join d on f.k = d.k group by f.k order by f.k")],
            _mk_db(2000, np.arange(16) * 3, seed=3)),
        _route_oracle(),
        _route("test_route_min_max_avg", [both(
            "select d.k, min(f.v), max(f.v), avg(f.v), count(*) "
            "from f join d on f.k = d.k group by d.k order by d.k")],
            _mk_db(4000, np.arange(40) * 3 + 11, seed=6)),
        *[_firstapp(sql, name) for sql, name in _FIRSTAPP],
        _extra_dim_group_columns(),
        _route("test_route_value_expression", [
            both("select d.k, sum(f.v * 2 + 1), count(*) from f join d on f.k = d.k "
                 "group by d.k order by d.k"),
            both("select d.k, sum(f.v * 3), avg(f.v * 3) from f join d on f.k = d.k "
                 "group by d.k"),
            both("select d.k, sum(f.v + f.v), avg(f.v * 3) from f join d "
                 "on f.k = d.k group by d.k"),
        ], _mk_db(2000, np.arange(24) * 5 + 2, seed=14)),
        _multi_value_columns(),
        _nullable_value_columns(),
        _distinct_aggregates(),
        _multi_value_oracle(),
        _route("test_desc_order_routes_direct", [
            both("select d.k, sum(f.v) from f join d on f.k=d.k "
                 "group by d.k order by d.k desc", (("any", "order_agg_join_direct"),)),
            both("select d.k, min(f.v), count(distinct f.v) from f join d on f.k=d.k "
                 "group by d.k order by d.k desc", (("any", "order_agg_join_direct"),)),
        ], _mk_db(1000, np.arange(16) + 1, seed=4)),
        _route("test_single_side_on_residual_is_pushed_and_routes", [
            both("select d.k, sum(f.v), count(*) from f join d "
                 "on f.k=d.k and f.v > 10 group by d.k order by d.k", label="routed"),
            S("select d.k, sum(f.v), count(*) from f join d on f.k=d.k "
              "where f.v > 10 group by d.k order by d.k", op="lines", same_as="routed"),
        ], _mk_db(1500, np.arange(16) + 1, seed=4)),
        _route("test_ineligible_shapes_fall_back", [
            both("select d.k, sum(f.v) from d left join f on f.k=d.k "
                 "group by d.k order by d.k", NOT_FIRED),
            both("select d.k, sum(f.v) from f join d on f.k=d.k and f.v > d.k "
                 "group by d.k order by d.k", NOT_FIRED),
            both("select d.k, count(distinct f.v) from f join d on f.k=d.k "
                 "group by d.k", NOT_FIRED),
        ], _mk_db(1000, np.arange(16) + 1, seed=4)),
        _route("test_duplicate_dim_keys_fall_back_with_pair_multiplicity", [
            S(STAR_SQL, ["1 60 4", "2 30 1"], routes=NOT_FIRED),
        ], {"f": [("k", "BIGINT", np.array([1, 1, 2, 3]), None),
                  ("v", "BIGINT", np.array([10, 20, 30, 40]), None)],
            "d": [("k", "BIGINT", np.array([1, 1, 2]), None)]}),
        _route_fuzz_differential(),
        _route("test_varchar_key_routes_firstapp", [
            both("select d.name, sum(f.v), count(*) from f join d "
                 "on f.name = d.name group by d.name", (("any", "firstapp"),),
                 expect=["zeta 5 2", "alpha 8 1", "mid 8 2", "beta 5 1"]),
            both("select d.name, sum(f.v), count(*) from f join d "
                 "on f.name = d.name group by d.name order by d.name",
                 (("none", "order_agg"),)),
        ], {"f": [col("name", "VARCHAR", ["mid", "zeta", "zeta", "nope", "beta", None,
                                          "mid", "alpha"]),
                  ("v", "BIGINT", np.arange(1, 9), None)],
            "d": [col("name", "VARCHAR", ["zeta", "alpha", "mid", "omega", "beta"])]}),
        _composite_key_routes(),
        _composite_key_fuzz(),
        _route("test_date_key_routes", [
            S("create table f(dt date, v int)"),
            S("insert into f values (date '2024-01-01', 3), "
              "(date '2024-01-02', 5), (date '2024-01-01', 7), "
              "(date '2030-05-05', 9), (null, 11)"),
            S("create table d(dt date)"),
            S("insert into d values (date '2024-01-01'), (date '2024-01-02'), "
              "(date '2024-01-03')"),
            both("select d.dt, sum(f.v), count(*) from f join d on f.dt = d.dt "
                 "group by d.dt order by d.dt", (("any", "order_agg_join_direct"),)),
            both("select d.dt, min(f.v), max(f.v) from f join d on f.dt = d.dt "
                 "group by d.dt order by d.dt desc", (("any", "order_agg_join_direct"),)),
            both("select d.dt, avg(f.v) from f join d on f.dt = d.dt group by d.dt",
                 (("any", "agg_join_firstapp"),)),
        ]),
        _route_float_measures(),
        _route_float_oracle(),
        _group_key_any_position(),
        _semi_join_pushdown(),
        _route_mxu_kernel(),
        _decimal_sums_exact_at_scale(),
    ]
    return out


# ---------------------------------------------------------------------------
# tests/test_session.py
# ---------------------------------------------------------------------------

_SESSION_FIXTURE = (
    S("create table t(a int, b int); insert into t values (1,10),(2,20),(3,30)"),
)


def _explain_keys(out: dict) -> None:
    rows = out["explain"]["rows"]
    assert [r[0] for r in rows] == ["logical_plan", "optimized_logical_plan", "physical_plan"]
    vals = {r[0]: r[1] for r in rows}
    assert "TableScan" in vals["physical_plan"]
    assert all(v.strip() for v in vals.values())


def session_cases() -> list:
    def case(name, *steps, **kw):
        return Case(f"tests/test_session.py::{name}", _SESSION_FIXTURE + steps, **kw)

    return [
        case("test_query_roundtrip", S(
            "select a, b from t where a > 1",
            {"names": ["a", "b"], "lines": ["2 20", "3 30"], "row_count": 2}, op="query")),
        case("test_prepared_statement_reexecution",
             S("select sum(b) from t", op="prepare", label="prep"),
             S("prep", ["60"], op="execute_prepared"),
             S("insert into t values (4, 40)"),
             S("prep", ["100"], op="execute_prepared")),
        case("test_pending_invalidated_by_next_query",
             S("select a from t", op="pending", label="p1"),
             S("select b from t", op="pending", label="p2"),
             S("p1", op="execute_pending", error="ExecutorError"),
             S("p2", 3, op="execute_pending")),
        case("test_interrupt",
             S("select a from t", op="pending", label="p"),
             S(op="interrupt"),
             S("p", op="execute_pending", error="ExecutorError")),
        Case("tests/test_session.py::test_profile_report", (
            S("create table t(a int); insert into t values (1),(2)", db="d2"),
            S("select a from t where a > 1", db="d2"),
            S(op="report", expect=["TableScan", "Filter"], db="d2"),
        ), profile=("d2",)),
        case("test_cli_engine_personality_toggle",
             S(op="cli_new", expect=False),
             S("select a from t where a > 1", {"contains": ["2", "3"]}, op="cli"),
             S("enable_v2", {"contains": ["enable sqlrs v2"], "enable_v2": True}, op="cli"),
             S("select a from t where a > 1", {"contains": ["2", "3"], "has_context": True},
               op="cli"),
             S(op="cli_new", expect=True, env={"ENABLE_V2": "1"}),
             env={"ENABLE_V2": None}),
        case("test_v2_explain_populates_plan_strings",
             S("explain select a from t where b > 15", op="query", label="explain"),
             check=_explain_keys),
        case("test_v2_multi_statement", S(
            "insert into t values (4, 40); select sum(a) from t", [["10"]], op="query_all")),
    ]


# ---------------------------------------------------------------------------
# tests/test_expressions.py, tests/test_types.py (SQL-visible), test_storage.py
# ---------------------------------------------------------------------------


def expression_cases() -> list:
    def case(name, *steps):
        return Case(f"tests/test_expressions.py::{name}", steps)

    kleene = (
        S("create table kb(l boolean, r boolean)"),
        S("insert into kb values (true,true),(true,false),(true,null),(false,false),"
          "(false,null),(null,true),(null,null),(false,true),(null,false)"),
    )
    T, F, N = True, False, None
    return [
        case("test_kleene_and", *kleene, S(
            "select l and r from kb", [(v,) for v in (T, F, N, F, F, N, N, F, F)], op="rows")),
        case("test_kleene_or", *kleene, S(
            "select l or r from kb", [(v,) for v in (T, T, T, F, N, T, N, T, N)], op="rows")),
        case("test_arithmetic_null_propagation",
             S("create table ki(l int, r int); insert into ki values (1,10),(null,20),(3,null)"),
             S("select l + r from ki", [(11,), (None,), (None,)], op="rows")),
        case("test_integer_division_truncates_and_div_zero_null",
             S("create table kd(l int, r int); insert into kd values (7,2),(-7,2),(5,0)"),
             S("select l / r from kd", [(3,), (-3,), (None,)], op="rows")),
        case("test_string_comparison_via_ranks",
             S("create table ks(a varchar, b varchar); "
               "insert into ks values ('1000','20'),('abc','abd'),('b','b')"),
             S("select a > b from ks", [(False,), (False,), (False,)], op="rows"),
             S("select a <= b from ks", [(True,), (True,), (True,)], op="rows"),
             S("select a = b from ks", [(False,), (False,), (True,)], op="rows")),
        case("test_cast_narrowing_checked",
             S("create table kc(a int); insert into kc values (100),(1481)"),
             S("select cast(a as tinyint unsigned) from kc", op="rows", error="TypeError_"),
             S(op="cast_column", error="TypeError_",
               arg={"type": "INTEGER", "values": [100, 1481], "to": "UTINYINT", "safe": False}),
             S(op="cast_column", expect=[100, None],
               arg={"type": "INTEGER", "values": [100, 1481], "to": "UTINYINT", "safe": True})),
        case("test_cast_int_to_varchar_roundtrip",
             S("create table kv(a bigint); insert into kv values (1),(null),(42)"),
             S("select cast(a as varchar) from kv", [("1",), (None,), ("42",)], op="rows")),
        case("test_date_plus_interval_day_and_month",
             S("select date '2021-01-02' + interval '1' day", ["2021-01-03"]),
             S("select date '2021-01-31' + interval '1' month", ["2021-02-28"])),
        case("test_date_minus_interval_day_reference_quirk",
             S("select date '1998-12-01' - interval '1' day", ["1998-11-29"])),
    ]


def type_cases() -> list:
    return [
        Case("tests/test_types.py::test_integer_literal_typing_i32_first", (
            S("select 5", ["INTEGER"], op="types"),
            S(f"select {2**40}", ["BIGINT"], op="types"),
        )),
        Case("tests/test_types.py::test_cast_overflow_raises", (
            S("select cast(1481 as tinyint unsigned)", error="TypeError_"),
            S(op="scalar_cast", expect=True, arg={"value": 1481, "to": "UTINYINT"}),
        )),
        Case("tests/test_types.py::test_render_scalar", (
            S("select null", ["NULL"]),
            S("select true", ["true"]),
            S("select ''", ["(empty)"]),
            S("select 2.3", ["2.3"]),
            S("select 1100.2", ["1100.2"]),
            S("select 2.0", ["2"]),
            S("select cast(5.099999904632568 as float)", ["5.1"]),
            S("select date '2021-01-03'", ["2021-01-03"]),
        )),
    ]


def storage_cases() -> list:
    def case(name, *steps):
        return Case(f"tests/test_storage.py::{name}", steps)

    return [
        case("test_csv_inference_and_nulls", S(
            "a,b,c,d,e\n1,1.5,true,2020-01-02,hi\n2,,false,,\n\n", op="csv", arg={},
            expect={"types": ["BIGINT", "DOUBLE", "BOOLEAN", "DATE", "VARCHAR"],
                    "num_rows": 2,
                    "cells": [((0, 0), 1), ((0, 2), True), ((0, 4), "hi"),
                              ((1, 1), None), ((1, 3), None), ((1, 4), "")]})),
        case("test_csv_quoting", S(
            'a,b\n"x,y",2\n"he said ""hi""",3\n', op="csv", arg={},
            expect={"cells": [((0, 0), "x,y"), ((1, 0), 'he said "hi"')]})),
        case("test_csv_no_header_and_delim", S(
            "1|x\n2|y\n", op="csv", arg={"has_header": False, "delimiter": "|"},
            expect={"names": ["column_1", "column_2"], "types": ["BIGINT", "VARCHAR"]})),
        case("test_datatable_scan_bounds_projection", S(
            op="datatable",
            arg={"names": ["a", "b"], "types": ["BIGINT", "VARCHAR"],
                 "appends": [[[("BIGINT", i), ("VARCHAR", f"s{i}")] for i in range(10)]]},
            expect={"scans": [([1], (3, 4), ["b"], [["s3"], ["s4"], ["s5"], ["s6"]], 4),
                              (None, (20, 5), None, None, 0)]})),
        case("test_datatable_tile_growth", S(
            op="datatable",
            arg={"names": ["a"], "types": ["BIGINT"],
                 "appends": [[[("BIGINT", i)]] for i in range(5)]},
            expect={"num_rows": 5,
                    "scans": [(None, None, None, [[i] for i in range(5)], 5)]})),
    ]


def is_program_error(e: BaseException) -> bool:
    """A failed capture or replay of the port's programs (its ProgramError,
    named so that this module imports neither package): never an outcome."""
    return any(c.__name__ == "ProgramError" for c in type(e).__mro__)


def all_cases() -> list:
    """Every case, in the order of the sources above."""
    return (subquery_cases() + extended_cases() + fused_route_cases() + session_cases()
            + expression_cases() + storage_cases() + type_cases())


SOURCE_FILES = ("test_subqueries.py", "test_sql_extended.py", "test_fused_route.py",
                "test_session.py", "test_expressions.py", "test_storage.py", "test_types.py")


# ---------------------------------------------------------------------------
# the interpreter
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Engine:
    """How run_case reaches one engine.

    pkg: the package module (its submodules are found by name, so both
      packages' trees serve); new_db(profile) makes a Database;
      load_tables(db, tables) loads import_tables' form; device: the torch
      device of this package's array calls, None for the JAX package (whose
      calls take no device); sharded: the Database runs over shards."""

    name: str
    pkg: Any
    new_db: Callable[[bool], Any]
    load_tables: Callable[[Any, dict], None]
    device: Any = None
    sharded: bool = False

    def module(self, path: str):
        return importlib.import_module(f"{self.pkg.__name__}.{path}")

    def dev_kw(self) -> dict:
        return {} if self.device is None else {"device": self.device}


class CaseFailure(AssertionError):
    """A step, or a case's check, missed its expectation."""


_SQL_OPS = ("run", "lines", "rows", "batches", "types", "explain", "report")
_UNSET = object()


@contextlib.contextmanager
def _environ(env: Optional[dict]):
    """Set (None: unset) the variables of `env`, and restore them after."""
    saved = {}
    try:
        for k, v in (env or {}).items():
            saved[k] = os.environ.get(k)
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _routes_ok(conds, fired: list) -> Optional[str]:
    for cond in conds:
        kind, args = cond[0], cond[1:]
        if kind == "fired":
            ok = bool(fired)
        elif kind == "not_fired":
            ok = not fired
        elif kind == "any":
            ok = any(all(s in r for s in args) for r in fired)
        elif kind == "none":
            ok = not any(args[0] in r for r in fired)
        elif kind == "any_endswith":
            ok = any(r.endswith(args[0]) for r in fired)
        elif kind == "none_endswith":
            ok = not any(r.endswith(args[0]) for r in fired)
        else:
            raise ValueError(f"unknown route condition {cond}")
        if not ok:
            return f"route condition {cond} fails on {fired}"
    return None


class _Run:
    """The state of one case on one engine: its databases, session objects
    and labelled outputs."""

    def __init__(self, case: Case, engine: Engine, tmpdir: str):
        self.case, self.engine, self.tmpdir = case, engine, tmpdir
        self.dbs, self.ctxs, self.kept = {}, {}, {}
        self.cli = None
        self.outputs = []  # one entry a step: what the step gave
        self.labelled = {}

    def db(self, name: str):
        if name not in self.dbs:
            db = self.engine.new_db(name in self.case.profile)
            tables = self.case.tables.get(name)
            if tables:
                self.engine.load_tables(db, tables)
            self.dbs[name] = db
        return self.dbs[name]

    def ctx(self, name: str):
        if name not in self.ctxs:
            self.ctxs[name] = self.db(name).connect()
        return self.ctxs[name]

    # -- one step ----------------------------------------------------------

    def execute(self, step: Step):
        """The step's output, as the expectation states it."""
        op, eng = step.op, self.engine
        if op in _SQL_OPS:
            db = self.db(step.db)
            if op == "run":
                db.run(step.sql)
                return None
            if op == "lines":
                return db.run_lines(step.sql)
            if op == "rows":
                return [tuple(r) for b in db.run(step.sql) for r in b.to_pylist()]
            if op == "batches":
                return [(list(b.schema.names), b.num_rows) for b in db.run(step.sql)]
            if op == "types":
                return [f.type.name for b in db.run(step.sql) for f in b.schema.fields]
            if op == "explain":
                return db.explain(step.sql).split("=== optimized_logical_plan ===")[1]
            return db.last_profile.report()
        if op in ("query", "query_all", "prepare", "pending", "interrupt"):
            ctx = self.ctx(step.db)
            if op == "query":
                res = ctx.query(step.sql)
                return {"names": list(res.names), "lines": res.lines(),
                        "row_count": res.row_count(), "rows": res.rows()}
            if op == "query_all":
                return ctx.query_all(step.sql)[-1].rows()
            if op == "interrupt":
                ctx.interrupt()
                return None
            self.kept[step.label] = (ctx.prepare if op == "prepare" else ctx.pending_query)(
                step.sql)
            return None
        if op == "execute_prepared":
            return self.ctx(step.db).execute_prepared(self.kept[step.sql]).lines()
        if op == "execute_pending":
            return self.kept[step.sql].execute().row_count()
        if op == "cli_new":
            self.cli = eng.module("cli").Cli(self.db(step.db))
            return self.cli.enable_v2
        if op == "cli":
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                self.cli.run_sql(step.sql)
            return {"output": buf.getvalue(), "enable_v2": self.cli.enable_v2,
                    "has_context": self.cli._context is not None}
        if op == "csv":
            csv = eng.module("storage.csv")
            path = os.path.join(self.tmpdir, f"case{len(self.outputs)}.csv")
            with open(path, "w") as f:
                f.write(step.sql)
            t = csv.read_csv_file(path, csv.CsvConfig(**step.arg))
            return {"names": list(t.names), "types": [x.name for x in t.types],
                    "num_rows": t.num_rows, "rows": t.scan(**eng.dev_kw()).to_pylist()}
        if op == "datatable":
            return self._datatable(step.arg)
        if op == "cast_column":
            a = step.arg
            types = eng.module("types")
            t = types.LogicalType[a["type"]]
            c = eng.module("data").Column.from_scalars(
                t, [types.ScalarValue(t, v) for v in a["values"]], **eng.dev_kw())
            out = eng.module("ops.elementwise").cast_column(
                c, types.LogicalType[a["to"]], safe=a["safe"])
            return out.to_pylist()
        if op == "scalar_cast":
            types = eng.module("types")
            v = types.ScalarValue.integer_literal(step.arg["value"])
            return v.cast_to(types.LogicalType[step.arg["to"]], safe=True).is_null
        raise ValueError(f"unknown op {op!r}")

    def _datatable(self, arg: dict) -> dict:
        eng = self.engine
        types = eng.module("types")
        t = eng.module("storage.memory").DataTable(
            arg["names"], [types.LogicalType[x] for x in arg["types"]])
        for rows in arg["appends"]:
            t.append_rows([[types.ScalarValue(types.LogicalType[tn], v) for tn, v in row]
                           for row in rows])
        scans = []
        for projection, bounds, *_ in self.current.expect["scans"]:
            b = t.scan(**eng.dev_kw(), projection=projection, bounds=bounds)
            scans.append((list(b.schema.names), b.to_pylist(), b.num_rows))
        return {"num_rows": t.num_rows, "scans": scans}

    # -- checks ------------------------------------------------------------

    def compare(self, step: Step, got) -> Optional[str]:
        """None if `got` meets the step's expectation, else what differs."""
        exp = step.expect
        if exp is None:
            return None
        if step.op == "explain":
            missing = [s for s in exp["has"] if s not in got]
            present = [s for s in exp["lacks"] if s in got]
            return None if not (missing or present) else (
                f"plan lacks {missing} or holds {present}:\n{got}")
        if step.op == "report":
            missing = [s for s in exp if s not in got]
            return None if not missing else f"report lacks {missing}:\n{got}"
        if step.op == "query":
            bad = {k: (got[k], v) for k, v in exp.items() if got[k] != v}
            return None if not bad else f"(got, want) {bad}"
        if step.op == "cli":
            bad = [s for s in exp.get("contains", ()) if s not in got["output"]]
            bad += [f"{k}={got[k]}" for k in ("enable_v2", "has_context")
                    if k in exp and got[k] != exp[k]]
            return None if not bad else f"cli: {bad} in {got}"
        if step.op == "csv":
            bad = {k: (got[k], exp[k]) for k in ("names", "types", "num_rows")
                   if k in exp and got[k] != exp[k]}
            for (r, c), v in exp.get("cells", ()):
                cell = got["rows"][r][c]
                if cell != v or (v is True and cell is not True):
                    bad[f"cell {r},{c}"] = (cell, v)
            return None if not bad else f"(got, want) {bad}"
        if step.op == "datatable":
            bad = []
            if "num_rows" in exp and got["num_rows"] != exp["num_rows"]:
                bad.append(("num_rows", got["num_rows"], exp["num_rows"]))
            for (names, rows, n), (_p, _b, e_names, e_rows, e_n) in zip(got["scans"], exp["scans"]):
                if (e_names is not None and names != e_names) or (
                        e_rows is not None and rows != e_rows) or n != e_n:
                    bad.append(((names, rows, n), (e_names, e_rows, e_n)))
            return None if not bad else f"(got, want) {bad}"
        return None if got == exp else f"got {got!r}\nwant {exp!r}"

    def step(self, i: int, step: Step) -> None:
        """Run one step and hold it to its expectation (raise CaseFailure)."""
        self.current = step
        eng = self.engine
        where = f"{self.case.id} step {i} ({step.op} {step.sql[:80]!r}) on {eng.name}"
        db = self.db(step.db) if step.op in _SQL_OPS else None
        with _environ(step.env):
            if db is not None:
                db.last_fused_routes = []
            if step.error is not None:
                try:
                    got = self.execute(step)
                except Exception as e:  # the step's stated error class, and no other
                    if is_program_error(e):
                        raise  # a failed capture or replay is never an expected error
                    if type(e).__name__ != step.error:
                        raise CaseFailure(f"{where}: raised {type(e).__name__} ({e}), "
                                          f"want {step.error}") from e
                    self.outputs.append(("error", step.error))
                    return
                raise CaseFailure(f"{where}: gave {got!r}, want {step.error}")
            got = self.execute(step)
            fired = list(getattr(db, "last_fused_routes", None) or [])
            again = got
            if step.rerun_with is not None:
                saved = {k: getattr(db, k, _UNSET) for k in step.rerun_with}
                try:
                    for k, v in step.rerun_with.items():
                        setattr(db, k, v)
                    again = self.execute(step)
                finally:
                    for k, v in saved.items():
                        if v is _UNSET:
                            delattr(db, k)
                        else:
                            setattr(db, k, v)
        # host text with timings in it is held to its expectation only
        self.outputs.append(None if step.op in ("report", "cli") else
                            got if again == got else (got, again))
        if step.label is not None:
            self.labelled[step.label] = got
            self.labelled[f"{step.label}:routes"] = fired
        if again != got:
            raise CaseFailure(f"{where}: differs under {step.rerun_with}:\n{got!r}\n{again!r}")
        bad = self.compare(step, got)
        if bad is not None:
            raise CaseFailure(f"{where}: {bad}")
        if step.same_as is not None and got != self.labelled[step.same_as]:
            raise CaseFailure(f"{where}: differs from step {step.same_as!r}:\n"
                              f"{got!r}\n{self.labelled[step.same_as]!r}")
        if eng.sharded:
            return
        bad = _routes_ok(step.routes, fired)
        if bad is not None:
            raise CaseFailure(f"{where}: {bad}")
        if step.scanned_max is not None:
            scanned = sum(s.rows_out for s in db.last_profile.ops
                          if s.op.lstrip().startswith("TableScan"))
            if not 0 < scanned <= step.scanned_max:
                raise CaseFailure(f"{where}: scanned {scanned} rows, want (0, "
                                  f"{step.scanned_max}]")


def run_case(case: Case, engine: Engine, tmpdir: str) -> list:
    """Run every step of `case` on `engine`; raise CaseFailure at the first
    step that misses its expectation. Returns each step's output (for a
    shard run to be held to a single-device run by same_outputs)."""
    run = _Run(case, engine, tmpdir)
    run.labelled["sharded"] = engine.sharded
    with _environ(case.env):
        for i, step in enumerate(case.steps):
            run.step(i, step)
    if case.check is not None:
        try:
            case.check(run.labelled)
        except AssertionError as e:
            raise CaseFailure(f"{case.id} on {engine.name}: {e}") from e
    return run.outputs


def _close(a, b, rel: float) -> bool:
    """Equal, but numbers written in text or held as floats may differ by
    `rel` (float sums over shards add in another order)."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or abs(a - b) <= rel * max(abs(a), abs(b))
    if isinstance(a, str) and isinstance(b, str):
        if a == b:
            return True
        ta, tb = a.split(), b.split()
        if len(ta) != len(tb) or len(ta) == 0:
            return False
        for x, y in zip(ta, tb):
            if x == y:
                continue
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                return False
            if not _close(fx, fy, rel):
                return False
        return True
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y, rel) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k], rel) for k in a)
    return a == b


def same_outputs(case: Case, single: list, sharded: list, rel: float = 1e-9) -> Optional[str]:
    """None if the shard run's outputs equal the single-device run's (text
    numbers to `rel`), else the first step that differs."""
    if len(single) != len(sharded):
        return f"{case.id}: {len(sharded)} outputs over shards, {len(single)} on one device"
    for i, (a, b) in enumerate(zip(single, sharded)):
        if not _close(a, b, rel):
            return f"{case.id} step {i}: one device {a!r}\nshards {b!r}"
    return None
