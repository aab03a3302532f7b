"""sqlrs_tpu_torch/ops/join.py against sqlrs_tpu/ops/join.py, and every join
operator of the executor through SQL in both engines.

The same keys, made from a seed with numpy (NULL keys, duplicates, alive
masks, empty sides), go through the reference's `pair_ranges`,
`expand_pairs`, `_try_pack2` and `match_counts` (XLA on the CPU) and the
port's (PyTorch on the CPU). Then SQL for inner, left, right, full and
cross joins, semi, anti and mark joins, NOT IN with a NULL, residuals, and
residuals through the chunked path (a small `join_pair_budget` on both
engines); the cases of tests/test_subqueries.py and
tests/test_sql_extended.py are among them.

Tolerances: pair indices, counts and integer, DATE and VARCHAR results
exact (row order is part of the output: probe-row-major with build rows in
insertion order); DOUBLE results to rel 1e-9. Route logs
(`last_fused_routes`) must equal the reference's.
"""

import math

import numpy as np
import pytest
import torch

import sqlrs_tpu
import sqlrs_tpu_torch
from sqlrs_tpu.data import Column as RefColumn
from sqlrs_tpu.ops import join as ref_join
from sqlrs_tpu.types import LogicalType as RLT
from sqlrs_tpu_torch.data import Column as PortColumn
from sqlrs_tpu_torch.ops import join as port_join
from sqlrs_tpu_torch.types import LogicalType as PLT

REL = 1e-9


def _col(tname, data, valid):
    import jax.numpy as jnp

    data, valid = np.asarray(data), np.asarray(valid, bool)
    return (
        RefColumn(RLT[tname], jnp.asarray(data), jnp.asarray(valid)),
        PortColumn(PLT[tname], torch.from_numpy(data.copy()), torch.from_numpy(valid.copy())),
    )


def _keys(rng, n, hi, null_p, tname="BIGINT", dtype=np.int64):
    return _col(tname, rng.integers(0, hi, n).astype(dtype), rng.random(n) >= null_p)


def _np(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()


PAIR_CASES = [
    "dups_nulls", "alive", "two_keys", "empty_left", "empty_right", "no_match",
    "all_null", "double_keys",
]


@pytest.mark.parametrize("case", PAIR_CASES)
def test_pair_ranges_and_expand(case):
    rng = np.random.default_rng(PAIR_CASES.index(case))
    nl, nr = (0 if case == "empty_left" else 300), (0 if case == "empty_right" else 400)
    null_p = 1.0 if case == "all_null" else 0.1
    lk = [_keys(rng, nl, 40, null_p)]
    rk = [_keys(rng, nr, 40 if case != "no_match" else 1, null_p)]
    if case == "no_match":
        rk = [_col("BIGINT", np.full(nr, 1000), np.ones(nr, bool))]
    if case == "two_keys":
        lk.append(_keys(rng, nl, 3, 0.05, "INTEGER", np.int32))
        rk.append(_keys(rng, nr, 3, 0.05, "INTEGER", np.int32))
    if case == "double_keys":
        lk = [_col("DOUBLE", rng.integers(0, 30, nl) / 4.0, rng.random(nl) > 0.1)]
        rk = [_col("DOUBLE", rng.integers(0, 30, nr) / 4.0, rng.random(nr) > 0.1)]
    la = ra = (None, None)
    a = np.ones(nl, bool)
    if case == "alive":
        import jax.numpy as jnp

        a = rng.random(nl) > 0.3
        b = rng.random(nr) > 0.3
        la = ((jnp.asarray(a), jnp.ones(nl, bool)), (torch.from_numpy(a), torch.ones(nl, dtype=torch.bool)))
        ra = ((jnp.asarray(b), jnp.ones(nr, bool)), (torch.from_numpy(b), torch.ones(nr, dtype=torch.bool)))
    r = ref_join.pair_ranges([c[0] for c in lk], [c[0] for c in rk], la[0], ra[0])
    p = port_join.pair_ranges([c[1] for c in lk], [c[1] for c in rk], la[1], ra[1])
    assert (r is None) == (p is None)
    if r is None:
        return
    assert r[3] == p[3]
    for x, y in zip(r[:2], p[:2]):
        assert np.array_equal(_np(x), _np(y))
    # the build order past the valid build rows is never read
    n_valid = int((np.logical_and.reduce([c[1].valid.numpy() for c in lk]) & a).sum())
    assert np.array_equal(_np(r[2])[:n_valid], _np(p[2])[:n_valid])
    rl, rr = ref_join.expand_pairs(*r)
    pl, pr_ = port_join.expand_pairs(*p)
    assert np.array_equal(_np(rl), _np(pl)) and np.array_equal(_np(rr), _np(pr_))
    # build alive masks count like validity: match counts agree too
    if la[0] is None:
        rc = ref_join.match_counts([c[0] for c in lk], [c[0] for c in rk])
        pc = port_join.match_counts([c[1] for c in lk], [c[1] for c in rk])
    else:
        rc = ref_join.match_counts([c[0] for c in lk], [c[0] for c in rk], build_alive=la[0])
        pc = port_join.match_counts([c[1] for c in lk], [c[1] for c in rk], build_alive=la[1])
    assert np.array_equal(_np(rc), _np(pc))


@pytest.mark.parametrize("case", ["fits", "too_wide", "float", "no_valid"])
def test_try_pack2(case):
    rng = np.random.default_rng(3)
    n = 500
    hi2 = (1 << 40) if case == "too_wide" else 50
    lk1, rk1 = _keys(rng, n, 1 << 30 if case == "too_wide" else 1000, 0.05), _keys(rng, n, 1000, 0.05)
    lk2, rk2 = _keys(rng, n, hi2, 0.05), _keys(rng, n, 50, 0.05)
    if case == "float":
        lk2 = _col("DOUBLE", rng.random(n), np.ones(n, bool))
    if case == "no_valid":
        lk1 = _col("BIGINT", np.zeros(n, np.int64), np.zeros(n, bool))
        rk1 = _col("BIGINT", np.zeros(n, np.int64), np.zeros(n, bool))

    def ops(side):
        from sqlrs_tpu.ops.sort import orderable_key as ref_ok
        from sqlrs_tpu_torch.ops.sort import orderable_key as port_ok

        ok = ref_ok if side == 0 else port_ok
        out_l, out_r = [], []
        for lc, rc in ((lk1, rk1), (lk2, rk2)):
            k, v = ok(lc[side])
            rk_, rv = ok(rc[side])
            out_l += [v, k]
            out_r += [rv, rk_.astype(k.dtype) if side == 0 else rk_.to(k.dtype)]
        return out_l, out_r

    r = ref_join._try_pack2(*ops(0))
    p = port_join._try_pack2(*ops(1))
    assert (r is None) == (p is None)
    assert (p is None) == (case != "fits")
    if r is not None:
        for a, b in zip(r[0] + r[1], p[0] + p[1]):
            assert np.array_equal(_np(a), _np(b))


# ---- through SQL -------------------------------------------------------------


def _eq(x, y):
    if isinstance(x, float) and isinstance(y, float):
        return math.isclose(x, y, rel_tol=REL, abs_tol=0.0)
    return x == y


def _same(ref, port, sql):
    ref.last_fused_routes, port.last_fused_routes = [], []
    rb, pb = ref.run(sql), port.run(sql)
    assert [b.schema.names for b in rb] == [b.schema.names for b in pb], sql
    r_rows = [r for b in rb for r in b.to_pylist()]
    p_rows = [r for b in pb for r in b.to_pylist()]
    assert len(r_rows) == len(p_rows), (sql, len(r_rows), len(p_rows))
    for rr, pr in zip(r_rows, p_rows):
        assert all(_eq(x, y) for x, y in zip(rr, pr)), (sql, rr, pr)
    assert port.last_fused_routes == ref.last_fused_routes, sql
    return p_rows


SUBQ_SETUP = """
create table o(okey int, ckey int, prio varchar);
insert into o values (1,1,'HI'),(2,1,'LO'),(3,2,'HI'),(4,3,'LO');
create table l(okey int, qty int);
insert into l values (1,5),(1,7),(2,1),(4,9);
create table li(pk int, sk int, qty int);
insert into li values (1,10,4),(1,10,6),(1,20,20),(2,10,10),(3,30,2);
create table ln(okey int, qty int);
insert into ln values (1,5),(null,2);
create table t1(x int, k int);
insert into t1 values (1,1),(3,1),(10,1),(3,2),(7,9),(null,1),(null,9),(99,2);
create table t2(y int, k int);
insert into t2 values (10,1),(11,1),(3,2),(null,2);
create table a(x int, y int);
insert into a values (1,10),(2,20),(3,30);
create table b(x int, z int);
insert into b values (1,5),(1,6),(2,100),(3,1);
create table e(id int, name varchar, dept int);
insert into e values (1,'ann',10),(2,'bob',20),(3,'cy',null),(4,'dee',40);
create table d(dept int, dname varchar);
insert into d values (20,'Marketing'),(30,'Finance'),(10,'Engineering'),(20,'Sales')
"""

SUBQ_CASES = [
    # tests/test_subqueries.py
    "select okey from o where exists (select * from l where l.okey = o.okey and l.qty > 4)",
    "select okey from o where not exists (select * from l where l.okey = o.okey)",
    "select okey from o where okey in (select okey from l where qty > 2)",
    "select okey from o where okey not in (select okey from l)",
    "select okey from o where okey not in (select okey from ln)",
    "select okey from o where okey not in (select okey from l where qty > 100)",
    "select okey from o where okey in (select okey from l group by okey having sum(qty) > 10)",
    "select pk, sk from li l1 where exists "
    "(select * from li l2 where l2.pk = l1.pk and l2.sk <> l1.sk)",
    "select pk, sk from li l1 where not exists "
    "(select * from li l2 where l2.pk = l1.pk and l2.sk <> l1.sk)",
    "select sum(qty) from li where qty < (select 0.5 * avg(qty) from li l2 where l2.pk = li.pk)",
    "select pk, sk from li l0 where qty > (select 0.5*sum(qty) from li l2 "
    "where l2.pk = l0.pk and l2.sk = l0.sk) and qty > 4",
    "select okey from o where okey <= (select sum(qty) from l where l.okey = o.okey)",
    "select ckey, sum(okey) from o group by ckey having sum(okey) > (select 0.8 * max(okey) from o)",
    "select o.okey, l.qty from o, l where o.okey = l.okey",
    "select okey from o where exists (select 1 from l)",
    "select okey from o where not exists (select 1 from l)",
    "select okey from o where exists (select 1 from l where qty > 100)",
    "select okey from o where not exists (select 1 from l where qty > 100)",
    "select x from t1 where x not in (select y from t2 where t2.k = t1.k)",
    "select k from t1 where x not in (select y from t2 where t2.k = t1.k)",
    "select x from t1 where k = 2 and x not in (select y from t2 where t2.k = t1.k and y is not null)",
    "select x from t1 where x not in (select y from t2 where t2.k = t1.k and y > x - 20)",
    "select x from a where y > (select sum(z) from b where b.x = a.x) "
    "and exists (select * from b where b.x = a.x and z < 10)",
    "select x from a where exists (select * from b where b.x = a.x and "
    "b.z > (select avg(z) from b b2 where b2.x = b.x))",
    "select x from a where exists (select * from b where b.x = a.x and z > (select min(z) from b))",
    "select x from a where y in (select z * 2 from b where b.x = a.x)",
    "select count(*) from a, b where (a.x = b.x and y < 15 and z < 50) "
    "or (a.x = b.x and y >= 15 and z >= 50)",
    # inner / outer / cross joins, with and without residuals
    "select e.name, d.dname from e join d on e.dept = d.dept",
    "select e.name, d.dname from e left join d on e.dept = d.dept",
    "select e.name, d.dname from e right join d on e.dept = d.dept",
    "select e.name, d.dname from e full join d on e.dept = d.dept",
    "select e.name, d.dname from e full join d on e.dept = d.dept and e.id < 3",
    "select e.name, d.dname from e left join d on e.dept = d.dept and d.dname > 'M'",
    "select e.name, d.dname from e join d on e.dept = d.dept and e.id + d.dept > 25",
    "select e.name, d.dname from e, d",
    "select e.name, count(*) from e, d where e.dept < d.dept group by e.name",
    "select a.x, b.z from a join b on a.x = b.x and a.y > b.z order by b.z desc",
    "select e.name from e where e.dept in (select dept from d where dname like '%a%')",
    # correlation only in the residual; a cross join with an empty side
    "select x from t1 where x not in (select y from t2 where t2.y > t1.k)",
    "select e.name, x.dname from e, (select * from d where dept > 1000) x",
]


@pytest.fixture(scope="module")
def subq_dbs():
    ref, port = sqlrs_tpu.Database(), sqlrs_tpu_torch.Database(device="cpu")
    ref.run(SUBQ_SETUP)
    port.run(SUBQ_SETUP)
    return ref, port


@pytest.mark.parametrize("sql", SUBQ_CASES, ids=[s[:60] for s in SUBQ_CASES])
def test_join_sql(subq_dbs, sql):
    _same(*subq_dbs, sql)


@pytest.mark.parametrize("sql,expected", [
    ("select e.name, x.dname from e left join (select * from d where dept > 1000) x "
     "on e.dept = x.dept", [("ann", None), ("bob", None), ("cy", None), ("dee", None)]),
    ("select x.name, d.dname from (select * from e where id > 100) x full join d "
     "on x.dept = d.dept",
     [(None, "Marketing"), (None, "Finance"), (None, "Engineering"), (None, "Sales")]),
])
def test_outer_join_empty_side(subq_dbs, sql, expected):
    """An outer join whose other side is empty: every row NULL-extended.
    The reference's gather from the empty side raises here, so the rows
    are held to the hand-computed answer."""
    _, port = subq_dbs
    assert [tuple(r) for b in port.run(sql) for r in b.to_pylist()] == expected


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_semi_anti_randomized(seed):
    """tests/test_subqueries.py's randomized EXISTS/NOT EXISTS/IN/NOT IN,
    NULL keys on both sides, plus the correlated NOT IN oracle shape."""
    rng = np.random.default_rng(seed)
    n_o, n_i = 300, 200
    o_k, i_k = rng.integers(0, 40, n_o), rng.integers(0, 40, n_i)
    o_null, i_null = rng.random(n_o) < 0.1, rng.random(n_i) < 0.05
    c_k = rng.integers(0, 5, n_i)
    setup = (
        "create table outer_t(k int, pos int, c int); create table inner_t(k int, c int);"
        "insert into outer_t values " + ",".join(
            f"({'null' if o_null[i] else int(o_k[i])},{i},{i % 5})" for i in range(n_o))
        + "; insert into inner_t values " + ",".join(
            f"({'null' if i_null[i] else int(i_k[i])},{int(c_k[i])})" for i in range(n_i))
    )
    ref, port = sqlrs_tpu.Database(), sqlrs_tpu_torch.Database(device="cpu")
    ref.run(setup)
    port.run(setup)
    for sql in (
        "select pos from outer_t where k in (select k from inner_t)",
        "select pos from outer_t where k not in (select k from inner_t)",
        "select pos from outer_t where k not in (select k from inner_t where k is not null)",
        "select pos from outer_t o where exists (select * from inner_t i where i.k = o.k)",
        "select pos from outer_t o where not exists (select * from inner_t i where i.k = o.k)",
        "select pos from outer_t o where k not in (select k from inner_t i where i.c = o.c)",
        "select pos from outer_t o where exists "
        "(select * from inner_t i where i.k = o.k and i.c <> o.c)",
        "select pos from outer_t o where exists "
        "(select * from inner_t i where i.k = o.k and i.c < o.c)",
    ):
        _same(ref, port, sql)


def test_chunked_residual_join_pairs():
    """tests/test_sql_extended.py's chunked residual join: with a small
    join_pair_budget on both engines the pair set expands and filters in
    chunks; rows equal the reference's chunked run and the port's unchunked
    run, emission order included."""
    rng = np.random.default_rng(5)
    n_l, n_r = 400, 700
    rows_l = ",".join(f"({int(k)},{int(v)})"
                      for k, v in zip(rng.integers(0, 25, n_l), rng.integers(0, 100, n_l)))
    rows_r = ",".join(f"({int(k)},{int(v)})"
                      for k, v in zip(rng.integers(0, 25, n_r), rng.integers(0, 100, n_r)))
    setup = (f"create table a(k int, x int); create table b(k int, y int);"
             f"insert into a values {rows_l}; insert into b values {rows_r}")
    ref, port = sqlrs_tpu.Database(), sqlrs_tpu_torch.Database(device="cpu")
    plain = sqlrs_tpu_torch.Database(device="cpu")
    for db in (ref, port, plain):
        db.run(setup)
    ref.join_pair_budget = port.join_pair_budget = 512  # ~11K pairs: many chunks
    for q in (
        "select * from a join b on a.k = b.k and a.x < b.y",
        "select a.k, sum(b.y) from a join b on a.k = b.k and a.x + b.y > 120 group by a.k",
        "select count(*) from a left join b on a.k = b.k and a.x < b.y - 5",
        "select a.k, b.y from a full join b on a.k = b.k and a.x > b.y + 90",
    ):
        rows = _same(ref, port, q)
        assert rows == [r for bt in plain.run(q) for r in bt.to_pylist()], q


def test_large_two_key_mark_packs():
    """A two-key mark join above _PACK2_MIN_ROWS packs both keys into one
    sort operand (the Q21 shape's equal-pair count): the same rows."""
    rng = np.random.default_rng(17)
    n = (1 << 20) + 5
    pk, sk = rng.integers(0, 1 << 18, n), rng.integers(0, 8, n)
    ref, port = sqlrs_tpu.Database(), sqlrs_tpu_torch.Database(device="cpu")
    for db, T in ((ref, RLT), (port, PLT)):
        db.create_memory_table_numpy("li", [("pk", T.BIGINT), ("sk", T.BIGINT)], [pk, sk])
    rows = _same(ref, port, "select count(*) from li l1 where exists "
                 "(select * from li l2 where l2.pk = l1.pk and l2.sk <> l1.sk)")
    assert rows[0][0] > 0
