"""The 22 TPC-H queries through sqlrs_tpu_torch.Database(device="cpu").

Data: the port's copy of the generator (sqlrs_tpu_torch/benchmarks/
tpch_dbgen.py) at SF 0.002, seed 3, loaded through its `load_into`. Every
query is held to the independent pandas oracle of benchmarks/tpch_oracle.py
with benchmarks/tpch.py's `compare` rule (floats rel 1e-9 or abs 1e-6;
everything else exact). The reference's fast set (tests/test_tpch.py's
FAST) also runs through sqlrs_tpu.Database on the same tables: the rows
agree by the same rule and the route logs (`last_fused_routes`) are equal.
The copies of the generator and of the query texts are held to the
originals: every array equal, every text identical.
"""

import numpy as np
import pytest

import sqlrs_tpu
import sqlrs_tpu_torch
from benchmarks import tpch, tpch_dbgen, tpch_oracle, tpch_queries
from sqlrs_tpu_torch.benchmarks import tpch_dbgen as port_dbgen
from sqlrs_tpu_torch.benchmarks import tpch_queries as port_queries

SF = 0.002
FAST = [4, 6, 13, 15, 16, 17, 18, 22]  # tests/test_tpch.py's fast tier


@pytest.fixture(scope="module")
def tables():
    return port_dbgen.gen_tables(SF, seed=3)


@pytest.fixture(scope="module")
def port_db(tables):
    db = sqlrs_tpu_torch.Database(device="cpu")
    port_dbgen.load_into(db, tables)
    return db


@pytest.fixture(scope="module")
def ref_db(tables):
    db = sqlrs_tpu.Database()
    tpch_dbgen.load_into(db, tables)
    return db


def test_generator_and_queries_are_copies(tables):
    orig = tpch_dbgen.gen_tables(SF, seed=3)
    assert tables.keys() == orig.keys()
    for name in orig:
        assert tables[name].keys() == orig[name].keys(), name
        for col in orig[name]:
            a, b = tables[name][col], orig[name][col]
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, col)
    assert port_queries.ALL == tpch_queries.ALL
    for col in list(orig["lineitem"]) + list(orig["orders"]):
        arr = orig["lineitem"].get(col, orig["orders"].get(col))
        tn = port_dbgen.type_name(col, arr)
        assert tn == ("DATE" if col in tpch_dbgen._DATE_COLS else
                      "DOUBLE" if col in tpch_dbgen._DOUBLE_COLS else
                      "VARCHAR" if arr.dtype.kind in "UO" else "BIGINT"), col


@pytest.mark.parametrize("qn", range(1, 23))
def test_query_matches_oracle(port_db, tables, qn):
    got = tpch.run_query(port_db, qn)
    exp = tpch_oracle.ORACLES[qn](tables)
    issues = tpch.compare(got, exp, qn)
    assert not issues, issues[:5]


@pytest.mark.parametrize("qn", FAST)
def test_fast_set_matches_reference(port_db, ref_db, qn):
    port_db.last_fused_routes, ref_db.last_fused_routes = [], []
    got = tpch.run_query(port_db, qn)
    exp = tpch.run_query(ref_db, qn)
    issues = tpch.compare(got, exp, qn)
    assert not issues, issues[:5]
    assert port_db.last_fused_routes == ref_db.last_fused_routes
