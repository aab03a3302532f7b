"""The port's host frontend (parser, binder, HEP optimizer, physical planner,
EXPLAIN rendering) against the JAX package's checked-in plan goldens:
sqlrs_tpu_torch must render every plan in tests/plan_goldens.GOLDEN_QUERIES
exactly as tests/goldens/plans.snapshot records it for sqlrs_tpu."""

import pytest

import sqlrs_tpu_torch
from tests import plan_goldens


def _snapshot_sections() -> dict[str, str]:
    with open(plan_goldens.SNAPSHOT) as f:
        text = f.read()
    sections = {}
    for part in text.split("==== ")[1:]:
        name, _, body = part.partition("\n")
        sections[name] = body.rstrip()
    return sections


@pytest.fixture(scope="module")
def port_db():
    db = sqlrs_tpu_torch.Database(device="cpu")
    db.run("create table t1(a int, b int, c int)")
    db.run("create table t2(a int, b int, c int)")
    return db


@pytest.mark.parametrize(
    "name,sql", plan_goldens.GOLDEN_QUERIES, ids=[n for n, _ in plan_goldens.GOLDEN_QUERIES]
)
def test_port_plan_matches_golden(port_db, name, sql):
    want = _snapshot_sections()[name]
    got = f"-- {sql}\n{port_db.explain(sql).rstrip()}"
    assert got == want
