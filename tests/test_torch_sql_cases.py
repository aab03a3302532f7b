"""The JAX package's SQL-level test expectations
(sqlrs_tpu_torch/benchmarks/sql_cases.py: the tests of
tests/test_subqueries.py, test_sql_extended.py, test_fused_route.py,
test_session.py, test_expressions.py, test_storage.py and test_types.py),
one test a case, held on the JAX package (`sqlrs_tpu.Database()`), the port
on the CPU (`Database(device="cpu")`) and the port over 4 CPU shards
(`Database(n_devices=4, device="cpu")`).

Each engine must meet every expectation of the case on its own; the shard
run must besides give what the port's single-device run gave, step by step
(numbers in text to rel 1e-9). `chip_smoke.py`'s `sql_cases` phase applies
the same rules on the card.

One file: the JAX package's compiles, nearly all of its time, are shared
between the cases of one process, and a file of this many tests is among
the first that the test workers take (xdist's loadfile takes files with
more tests first), away from tests/test_torch_multiprocess.py's children.
"""

import pytest

import sqlrs_tpu
import sqlrs_tpu_torch
from sqlrs_tpu_torch.benchmarks import sql_cases
from sqlrs_tpu_torch.storage.memory import import_tables
from tests.torch_fuzz_harness import ref_import

N_SHARDS = 4

JAX = sql_cases.Engine("jax", sqlrs_tpu, lambda profile: sqlrs_tpu.Database(profile=profile),
                       ref_import)
PORT_CPU = sql_cases.Engine(
    "port cpu", sqlrs_tpu_torch,
    lambda profile: sqlrs_tpu_torch.Database(profile=profile, device="cpu"),
    import_tables, device="cpu")
PORT_SHARDS = sql_cases.Engine(
    f"port {N_SHARDS} cpu shards", sqlrs_tpu_torch,
    lambda profile: sqlrs_tpu_torch.Database(profile=profile, n_devices=N_SHARDS, device="cpu"),
    import_tables, device="cpu", sharded=True)

CASES = sql_cases.all_cases()


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_sql_case(case, tmp_path):
    sql_cases.run_case(case, JAX, str(tmp_path))
    single = sql_cases.run_case(case, PORT_CPU, str(tmp_path))
    sharded = sql_cases.run_case(case, PORT_SHARDS, str(tmp_path))
    diff = sql_cases.same_outputs(case, single, sharded)
    assert diff is None, diff


def test_corpus_covers_the_sources():
    """Every case names a test of one of the seven source files, no two
    cases the same test, and the corpus holds at least 95 of them."""
    ids = [c.id for c in CASES]
    assert len(ids) == len(set(ids))
    assert {c.file for c in CASES} == set(sql_cases.SOURCE_FILES)
    assert len(CASES) >= 95
