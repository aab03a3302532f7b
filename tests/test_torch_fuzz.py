"""Engine-vs-engine SQL fuzzing (tests/torch_fuzz_harness.py): the same
seeded tables and statements (sqlrs_tpu_torch/benchmarks/sql_fuzz.py)
through the JAX package on the CPU, the port on the CPU and the port over 4
CPU shards, with 0 differences allowed.

This file holds the generator's own checks, the 4 medium seeds (4,096 rows
a table) and the large seed at exactly 2^17 fact rows, which takes kernel
1's histogram GROUP BY (interpret mode: its plain version, in both
engines), the fused star rollup's kernel 2 variant and the sharded
`shuffle` join, each asserted. The 40 small seeds are split over
tests/test_torch_fuzz_small_{a,b}.py, so that the reference's compiles
(about a second a statement) spread over the test workers. More seeds and
the 2^18-row large tier are slow-marked.
"""

import numpy as np
import pytest

from sqlrs_tpu_torch.benchmarks import sql_fuzz
from tests.torch_fuzz_harness import check_case, mxu_interpret  # noqa: F401


@pytest.mark.parametrize("size", sql_fuzz.SIZES)
def test_gen_case_is_deterministic(size):
    kw = {"fact_rows": 1 << 12} if size == "large" else {}
    a, b = sql_fuzz.gen_case(3, size, **kw), sql_fuzz.gen_case(3, size, **kw)
    assert a.statements == b.statements
    assert list(a.tables) == list(b.tables)
    for name in a.tables:
        for (c1, t1, v1, m1), (c2, t2, v2, m2) in zip(a.tables[name], b.tables[name]):
            assert (c1, t1) == (c2, t2)
            np.testing.assert_array_equal(v1, v2)
            np.testing.assert_array_equal(
                np.ones(len(v1), bool) if m1 is None else m1,
                np.ones(len(v2), bool) if m2 is None else m2,
            )


def test_fast_tier_corpus():
    """The corpus the fuzz files and the card's fuzz phase share: 40 small
    seeds of 12 statements, 4 medium of 6, one large at exactly 2^17 rows,
    and the small files cover every small seed once."""
    import glob
    import os
    import re

    cases = list(sql_fuzz.fast_tier_cases())
    assert [c.size for c in cases] == ["small"] * 40 + ["medium"] * 4 + ["large"]
    assert sum(len(c.statements) for c in cases) == 40 * 12 + 4 * 6 + 5
    assert cases[-1].table_rows()["f"] == 1 << 17
    seen = []
    here = os.path.dirname(os.path.abspath(__file__))
    for path in sorted(glob.glob(os.path.join(here, "test_torch_fuzz_small_*.py"))):
        with open(path) as f:
            lo, hi = map(int, re.search(r"range\((\d+), (\d+)\)", f.read()).groups())
        seen.extend(range(lo, hi))
    assert seen == list(sql_fuzz.SMALL_SEEDS)


def test_gen_case_shapes():
    types = {"BIGINT", "INTEGER", "DOUBLE", "VARCHAR", "DATE", "BOOLEAN"}
    for seed in range(20):
        case = sql_fuzz.gen_case(seed, "small")
        assert 2 <= len(case.tables) <= 4
        assert all(n <= 64 for n in case.table_rows().values())
        assert len(case.statements) == 12
        for cols in case.tables.values():
            got = {t for _c, t, _v, _m in cols}
            assert types <= got and got & {"UINTEGER", "UBIGINT"}
    medium = sql_fuzz.gen_case(0, "medium")
    assert set(medium.table_rows().values()) == {sql_fuzz.MEDIUM_ROWS}
    large = sql_fuzz.gen_case(0, "large")
    rows = large.table_rows()
    assert rows["f"] == sql_fuzz.LARGE_FACT_ROWS and rows["e"] == sql_fuzz.LARGE_E_ROWS
    d_keys = dict((c, v) for c, _t, v, _m in large.tables["d"])["k"]
    assert len(np.unique(d_keys)) == len(d_keys)
    f_cols = {c: (v, m) for c, _t, v, m in large.tables["f"]}
    assert f_cols["k"][0].max() - f_cols["k"][0].min() < 1024
    assert f_cols["v"][1].all()


def test_order_by_never_uses_an_order_dependent_float_sum():
    gen = sql_fuzz._Gen(np.random.default_rng(0), sql_fuzz.gen_case(0, "small").tables, "small")
    _sel, names = gen.select_list(["a0.g", "sum(a0.y)", "avg(a1.y * 2)", "sum(a0.x)", "max(a0.y)"])
    assert names == ["c0", "c3", "c4"]


@pytest.mark.parametrize("seed", sql_fuzz.MEDIUM_SEEDS)
def test_fuzz_medium(seed):
    check_case(sql_fuzz.gen_case(seed, "medium", n_statements=sql_fuzz.MEDIUM_STATEMENTS))


def test_fuzz_large_2p17():
    """Exactly 2^17 fact rows: kernel 1's row threshold, the fused route's
    dense ORDER BY variant (kernel 2) and the sharded shuffle join."""
    out = check_case(sql_fuzz.gen_case(size="large", **sql_fuzz.LARGE_TIER1))
    assert "hashagg_mxu" in out["routes"], out["routes"]
    assert "order_agg_join_direct_dense_mxu" in out["routes"], out["routes"]
    assert "shuffle" in out["strategies"], out["strategies"]


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(40, 200))
def test_fuzz_small_slow(seed):
    check_case(sql_fuzz.gen_case(seed, "small"))


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(4, 16))
def test_fuzz_medium_slow(seed):
    check_case(sql_fuzz.gen_case(seed, "medium"))


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(4))
def test_fuzz_large(seed):
    out = check_case(sql_fuzz.gen_case(seed, "large"))
    assert "hashagg_mxu" in out["routes"], out["routes"]
    assert "shuffle" in out["strategies"], out["strategies"]
