"""sqlrs_tpu_torch/ops/grouped_agg.py and ops/grouping.py against the JAX
package's, and the general GROUP BY through SQL in both engines.

The same inputs, made from a seed with numpy, go through the reference's
`sorted_grouped_aggregate` (XLA on the CPU) and the port's (PyTorch on the
CPU); the cases are those of tests/test_grouped_agg.py, with the group
count chosen to put phase 2 in DENSE mode (r_cap * 64 >= n) or in block
mode, and each case asserts which one it ran. Then the same shapes through
SQL, and the legacy path (multi-argument and ungrouped DISTINCT).

Tolerances: group order, integer, DATE and VARCHAR results exact; DOUBLE
results to rel 1e-9 (sums are prefix differences, taken in another
association order). Route logs (`last_fused_routes`) must equal the
reference's, with SQLRS_TPU_MXU_AGG_MIN_ROWS at its default and at 0.
"""

import math

import numpy as np
import pytest
import torch

import sqlrs_tpu
import sqlrs_tpu_torch
from sqlrs_tpu.data import Column as RefColumn
from sqlrs_tpu.ops import grouped_agg as ref_ga
from sqlrs_tpu.ops import grouping as ref_grouping
from sqlrs_tpu.types import LogicalType as RLT
from sqlrs_tpu.types import ScalarValue as RSV
from sqlrs_tpu_torch.data import Column as PortColumn
from sqlrs_tpu_torch.ops import grouped_agg as port_ga
from sqlrs_tpu_torch.ops import grouping as port_grouping
from sqlrs_tpu_torch.ops.hash_table import next_pow2
from sqlrs_tpu_torch.types import LogicalType as PLT
from sqlrs_tpu_torch.types import ScalarValue as PSV

REL = 1e-9


def _both(tname, values):
    """(reference Column, port Column) of the same Python values (None is
    NULL; strings intern into each engine's own dictionary)."""
    rt, pt = RLT[tname], PLT[tname]
    ref = RefColumn.from_scalars(rt, [RSV(rt, v) for v in values])
    port = PortColumn.from_scalars(pt, [PSV(pt, v) for v in values], device="cpu")
    return ref, port


def _eq(x, y):
    if isinstance(x, float) and isinstance(y, float):
        return math.isclose(x, y, rel_tol=REL, abs_tol=0.0) or (math.isnan(x) and math.isnan(y))
    return x == y


def _assert_cols(ref_cols, port_cols):
    assert len(ref_cols) == len(port_cols)
    for r, p in zip(ref_cols, port_cols):
        assert r.type.name == p.type.name
        rl, pl = r.to_pylist(), p.to_pylist()
        assert len(rl) == len(pl)
        for i, (x, y) in enumerate(zip(rl, pl)):
            assert _eq(x, y), (i, x, y)


def _run_both(keys, specs, alive=None):
    """keys: [(ref, port)] column pairs; specs: (name, (ref, port) pair or
    None, type name[, distinct]). Returns n_groups after asserting equal
    outputs."""
    ref_specs = [
        (s[0], s[1][0] if s[1] else None, RLT[s[2]]) + tuple(s[3:]) for s in specs
    ]
    port_specs = [
        (s[0], s[1][1] if s[1] else None, PLT[s[2]]) + tuple(s[3:]) for s in specs
    ]
    import jax.numpy as jnp

    r_alive = None if alive is None else jnp.asarray(alive)
    p_alive = None if alive is None else torch.from_numpy(np.asarray(alive).copy())
    rg, ra, rn = ref_ga.sorted_grouped_aggregate([k[0] for k in keys], ref_specs, alive=r_alive)
    pg, pa, pn = port_ga.sorted_grouped_aggregate([k[1] for k in keys], port_specs, alive=p_alive)
    assert rn == pn
    _assert_cols(rg, pg)
    _assert_cols(ra, pa)
    return pn


def _dense(n_groups: int, n: int) -> bool:
    return next_pow2(max(n_groups, 8)) * 64 >= n


@pytest.mark.parametrize("mode,kmax,n", [("dense", 200, 3000), ("block", 20, 6000)])
@pytest.mark.parametrize("nkeys", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_differential_int_keys(seed, nkeys, mode, kmax, n):
    rng = np.random.default_rng(seed)
    k2max = kmax if nkeys == 1 else 2  # block mode keeps the domain small
    keys = [
        _both("BIGINT", [None if rng.random() < 0.07 else int(rng.integers(0, kmax))
                         for _ in range(n)])
    ]
    if nkeys == 2:
        keys.append(_both("INTEGER", [None if rng.random() < 0.07 else int(rng.integers(0, k2max))
                                      for _ in range(n)]))
    v = _both("BIGINT", [None if rng.random() < 0.1 else int(rng.integers(-50, 50))
                         for _ in range(n)])
    d = _both("DOUBLE", [None if rng.random() < 0.1 else float(rng.normal() * 1e3)
                         for _ in range(n)])
    specs = [
        ("count", None, "BIGINT"), ("count", v, "BIGINT"), ("sum", v, "BIGINT"),
        ("min", v, "BIGINT"), ("max", v, "BIGINT"), ("avg", v, "DOUBLE"),
        ("sum", d, "DOUBLE"), ("min", d, "DOUBLE"), ("max", d, "DOUBLE"),
    ]
    n_groups = _run_both(keys, specs)
    assert _dense(n_groups, n) == (mode == "dense"), n_groups


@pytest.mark.parametrize("mode,n", [("dense", 300), ("block", 4000)])
def test_varchar_keys_and_minmax(mode, n):
    rng = np.random.default_rng(7)
    words = ["alpha", "beta", "gamma", "", "delta", None]
    kvals = [words[rng.integers(0, len(words))] for _ in range(n)]
    svals = [None if rng.random() < 0.2 else words[rng.integers(0, 5)] for _ in range(n)]
    flags = [None if rng.random() < 0.1 else bool(rng.integers(0, 2)) for _ in range(n)]
    k, s, b = _both("VARCHAR", kvals), _both("VARCHAR", svals), _both("BOOLEAN", flags)
    n_groups = _run_both(
        [k, b],
        [("min", s, "VARCHAR"), ("max", s, "VARCHAR"), ("count", None, "BIGINT"),
         ("count", s, "BIGINT")],
    )
    assert _dense(n_groups, n) == (mode == "dense")


def test_empty_input():
    k = _both("BIGINT", [])
    assert _run_both([k], [("count", None, "BIGINT"), ("sum", k, "BIGINT")]) == 0


@pytest.mark.parametrize("n", [100, 20000])
def test_single_group(n):
    k = _both("BIGINT", [5] * n)
    v = _both("BIGINT", list(range(n)))
    assert _run_both([k], [("sum", v, "BIGINT"), ("min", v, "BIGINT"),
                           ("max", v, "BIGINT")]) == 1


@pytest.mark.parametrize("n", [7, 5000])
def test_alive_mask_dead_tail_rows(n):
    """A fused filter: dead rows (a NULL key and the largest key among
    them) sort to the tail and must not leak into the last live group."""
    rng = np.random.default_rng(9)
    kv = [None if rng.random() < 0.1 else int(rng.integers(0, 30)) for _ in range(n)]
    kv[-1] = 10_000
    kv[-2] = None
    alive = rng.random(n) < 0.6
    alive[-2:] = False
    k = _both("BIGINT", kv)
    v = _both("DOUBLE", [float(x) for x in rng.integers(-9, 9, n)])
    _run_both([k], [("sum", v, "DOUBLE"), ("count", None, "BIGINT"),
                    ("max", v, "DOUBLE")], alive=alive)


def test_all_rows_dead():
    k = _both("BIGINT", [1, 2, 3])
    assert _run_both([k], [("count", None, "BIGINT")], alive=np.zeros(3, bool)) == 0


@pytest.mark.parametrize("mode,n", [("dense", 500), ("block", 6000)])
def test_shared_argument_distinct(mode, n):
    rng = np.random.default_rng(5)
    k = _both("BIGINT", [None if rng.random() < 0.08 else int(rng.integers(0, 12))
                         for _ in range(n)])
    v = _both("BIGINT", [None if rng.random() < 0.15 else int(rng.integers(0, 9))
                         for _ in range(n)])
    n_groups = _run_both([k], [
        ("count", v, "BIGINT", True), ("sum", v, "BIGINT", True),
        ("avg", v, "DOUBLE", True), ("count", v, "BIGINT"), ("sum", v, "BIGINT"),
    ])
    assert _dense(n_groups, n) == (mode == "dense")


def test_group_ids_and_dedup_mask():
    """The legacy path's group ids (first-appearance numbering) and the
    DISTINCT dedup mask, against the reference's."""
    rng = np.random.default_rng(13)
    n = 2000
    k1 = _both("BIGINT", [None if rng.random() < 0.1 else int(rng.integers(0, 15)) for _ in range(n)])
    k2 = _both("VARCHAR", [None if rng.random() < 0.1 else "abc"[rng.integers(0, 3)] for _ in range(n)])
    v = _both("DOUBLE", [None if rng.random() < 0.1 else float(rng.integers(0, 5)) / 2 for _ in range(n)])
    r_gid, r_n = ref_grouping.group_ids([k1[0], k2[0]])
    p_gid, p_n = port_grouping.group_ids([k1[1], k2[1]])
    assert r_n == p_n
    assert np.array_equal(np.asarray(r_gid), p_gid.numpy())
    r_mask = ref_grouping.dedup_mask([v[0]], r_gid)
    p_mask = port_grouping.dedup_mask([v[1]], p_gid)
    assert np.array_equal(np.asarray(r_mask), p_mask.numpy())


@pytest.mark.parametrize("g_cap", [8, 1024])
@pytest.mark.parametrize("n", [1, 300, 2000])
def test_partial_grouped_fixed_matches_reference(n, g_cap):
    """The sharded GROUP BY's per-shard core: the same runs, keys, first
    rows, live flags, states, run count and overflow flag as the
    reference's (float states to rel 1e-9), dead rows and NULL keys
    included; g_cap 8 overflows."""
    import jax.numpy as jnp

    from sqlrs_tpu.ops.sort import orderable_key as ref_key
    from sqlrs_tpu_torch.ops.sort import orderable_key as port_key

    rng = np.random.default_rng(n + g_cap)
    k1 = _both("BIGINT", [None if rng.random() < 0.1 else int(rng.integers(-20, 20))
                          for _ in range(n)])
    k2 = _both("VARCHAR", [None if rng.random() < 0.1 else "xyz"[rng.integers(0, 3)]
                           for _ in range(n)])
    v = _both("BIGINT", [None if rng.random() < 0.1 else int(rng.integers(-99, 99))
                         for _ in range(n)])
    d = _both("DOUBLE", [None if rng.random() < 0.1 else float(np.round(rng.uniform(-500, 500), 2))
                         for _ in range(n)])
    s = _both("VARCHAR", [None if rng.random() < 0.2 else "abcd"[rng.integers(0, 4)] * 2
                          for _ in range(n)])
    alive = rng.random(n) < 0.85
    row_idx = (np.arange(n) * 3 + 11).astype(np.int64)

    def side(i, key, np_mod, i64, f64, i32, alive_, rows):
        keys = [(key(c[i])[0], c[i].valid, c[i].data) for c in (k1, k2)]
        aggs = [("count_star", None, None, None, None)]
        for kind, c, dt in (("count", v, i64), ("sum", v, i64), ("avg", d, f64),
                            ("min", v, i64), ("max", d, f64), ("sum", d, f64)):
            aggs.append((kind, c[i].data, c[i].valid, None, dt))
        for kind in ("vmin", "vmax"):
            aggs.append((kind, s[i].data, s[i].valid, key(s[i])[0], i32))
        return keys, aggs, alive_, rows

    rk, ra, r_alive, r_rows = side(0, ref_key, jnp, jnp.int64, jnp.float64, jnp.int32,
                                   jnp.asarray(alive), jnp.asarray(row_idx))
    pk, pa, p_alive, p_rows = side(1, port_key, torch, torch.int64, torch.float64,
                                   torch.int32, torch.from_numpy(alive),
                                   torch.from_numpy(row_idx))
    r = ref_ga.partial_grouped_fixed(r_alive, r_rows, rk, ra, g_cap)
    p = port_ga.partial_grouped_fixed(p_alive, p_rows, pk, pa, g_cap)
    assert int(r[4]) == int(p[4]) and bool(r[5]) == bool(p[5])
    assert bool(p[5]) == (int(p[4]) > g_cap)
    live = np.asarray(r[2])
    assert np.array_equal(live, p[2].numpy())
    assert np.array_equal(np.asarray(r[1]), p[1].numpy())
    for (rd, rv), (pd, pv) in zip(r[0], p[0]):
        assert np.array_equal(np.asarray(rv), pv.numpy())
        assert np.array_equal(np.asarray(rd)[live], pd.numpy()[live])
    for rs, ps in zip(r[3], p[3]):
        assert rs.keys() == ps.keys()
        for key in rs:
            x, y = np.asarray(rs[key]), ps[key].numpy()
            if x.dtype.kind == "f":
                assert np.allclose(y[live], x[live], rtol=1e-9, atol=0), key
            else:
                assert np.array_equal(y[live], x[live]), key


@pytest.mark.parametrize("dtype", ["float64", "float32", "int64", "int32"])
@pytest.mark.parametrize("n,n_groups", [(0, 3), (1, 1), (5000, 37), (5000, 4999)])
def test_seg_sum_matches_reference(dtype, n, n_groups):
    """The legacy path's per-group sums: integers exactly, floats in a
    fixed order (a stable sort by group, then the fixed-order prefix sum)
    to rel 1e-9 (1e-4 for FLOAT) of the group's sum of magnitudes plus 8
    ulps of the prefix's (a difference of prefix sums errs with the
    prefix); empty groups sum to 0."""
    import jax.numpy as jnp

    rng = np.random.default_rng(n + n_groups)
    gid = rng.integers(0, max(n_groups - 2, 1), n).astype(np.int32)
    if np.dtype(dtype).kind == "f":
        data = (np.round(rng.uniform(-500, 500, n), 2) * 10.0 ** rng.integers(0, 3, n))
        data = data.astype(dtype)
    else:
        data = rng.integers(-(2**20), 2**20, n).astype(dtype)
    valid = rng.random(n) < 0.9
    exp = np.asarray(ref_grouping.seg_sum(
        jnp.asarray(data), jnp.asarray(valid), jnp.asarray(gid), n_groups))
    got = port_grouping.seg_sum(
        torch.from_numpy(data), torch.from_numpy(valid), torch.from_numpy(gid), n_groups
    ).numpy()
    assert got.dtype == exp.dtype and got.shape == exp.shape
    if np.dtype(dtype).kind == "f":
        rel = 1e-9 if dtype == "float64" else 1e-4
        scale = np.abs(np.where(valid, data, 0)).astype(np.float64)
        mag = np.zeros(n_groups)
        np.add.at(mag, gid, scale)
        bound = rel * mag + 8 * np.finfo(dtype).eps * mag.sum()
        assert np.all(np.abs(got.astype(np.float64) - exp) <= bound)
    else:
        assert np.array_equal(got, exp)


# ---- through SQL -------------------------------------------------------------


def _dbs(n, seed=21):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 50, n)
    v = rng.integers(-100, 100, n)
    x = np.round(rng.uniform(-500, 500, n), 2)
    s = np.array(["s%d" % i for i in rng.integers(0, 7, n)])
    ref, port = sqlrs_tpu.Database(), sqlrs_tpu_torch.Database(device="cpu")
    for db, T in ((ref, RLT), (port, PLT)):
        db.create_memory_table_numpy(
            "t", [("k", T.BIGINT), ("v", T.BIGINT), ("x", T.DOUBLE), ("s", T.VARCHAR)],
            [k, v, x, s],
        )
    return ref, port


def _same(ref, port, sql):
    ref.last_fused_routes, port.last_fused_routes = [], []
    rb, pb = ref.run(sql), port.run(sql)
    r_rows = [r for b in rb for r in b.to_pylist()]
    p_rows = [r for b in pb for r in b.to_pylist()]
    assert len(r_rows) == len(p_rows), sql
    for rr, pr in zip(r_rows, p_rows):
        assert all(_eq(x, y) for x, y in zip(rr, pr)), (sql, rr, pr)
    assert port.last_fused_routes == ref.last_fused_routes, sql
    return list(port.last_fused_routes)


SQL_CASES = [
    "select k, sum(v), count(*), min(v), max(v) from t where v > 10 group by k",
    "select k, sum(x), avg(x), min(x), max(x) from t group by k",
    "select s, k % 3, count(*), sum(v) from t group by s, k % 3",
    "select s, min(s), max(s), count(distinct k) from t group by s",
    "select k, count(distinct v), sum(distinct v), count(v) from t where x > 0 group by k",
    "select k, avg(distinct x) from t group by k",
    # the legacy path: two DISTINCT arguments, and ungrouped DISTINCT
    "select k, count(distinct v), count(distinct s), sum(x) from t group by k",
    "select s, count(distinct v), avg(distinct x), min(v), max(x), min(k) from t group by s",
    "select count(distinct v), sum(distinct k), min(s) from t",
    "select sum(distinct x), count(distinct s) from t where v > 50",
    "select count(distinct v) from t where v > 1000",
    # GROUP BY over no rows
    "select k, sum(v) from t where v > 1000 group by k",
]


@pytest.fixture(scope="module")
def sql_dbs():
    return _dbs(6000)


@pytest.mark.parametrize("sql", SQL_CASES, ids=[s[:50] for s in SQL_CASES])
def test_sql_group_by(sql_dbs, sql):
    assert _same(*sql_dbs, sql) == []


def test_fused_filter_regressions():
    """tests/test_grouped_agg.py's dead-row regressions through SQL."""
    setup = ("create table a(k int, v int); insert into a values (1,1),(2,1),(3,0);"
             "create table b(k int, v int); insert into b values (1,1),(null,0)")
    ref, port = sqlrs_tpu.Database(), sqlrs_tpu_torch.Database(device="cpu")
    ref.run(setup)
    port.run(setup)
    _same(ref, port, "select k, sum(v) from a where v=1 group by k")
    _same(ref, port, "select k, count(v) from b where v=1 group by k")
    assert port.run_lines("select k, sum(v) from a where v=1 group by k") == ["1 1", "2 1"]
    assert port.run_lines("select k, count(v) from b where v=1 group by k") == ["1 1"]


@pytest.mark.parametrize("min_rows", [None, "0"], ids=["default", "zero"])
def test_route_log_with_threshold(monkeypatch, min_rows):
    """SQLRS_TPU_MXU=interpret: below the row threshold both engines take
    the sorted path and log nothing; at 0 both take the histogram path and
    log hashagg_mxu (where its eligibility holds)."""
    monkeypatch.setenv("SQLRS_TPU_MXU", "interpret")
    if min_rows is None:
        monkeypatch.delenv("SQLRS_TPU_MXU_AGG_MIN_ROWS", raising=False)
    else:
        monkeypatch.setenv("SQLRS_TPU_MXU_AGG_MIN_ROWS", min_rows)
    ref, port = _dbs(3000, seed=4)
    routes = _same(ref, port, "select s, count(*), sum(v), avg(x) from t group by s")
    assert routes == ([] if min_rows is None else ["hashagg_mxu"])
    # min() is not the histogram's: the sorted path, whatever the threshold
    assert _same(ref, port, "select s, min(v) from t group by s") == []
