"""The harness of the engine-vs-engine SQL fuzz tests (tests/test_torch_fuzz*.py).

Each case (sqlrs_tpu_torch/benchmarks/sql_fuzz.py, seeded) is loaded into
the JAX package (sqlrs_tpu.Database on the CPU, its Pallas kernels in
interpret mode), the port on the CPU (`device="cpu"`) and the port over 4
CPU shards (`n_devices=4, device="cpu"`), and every statement runs through
the three. The rule (sql_fuzz.difference): both raise the same exception
type, or both return the same types and names, non-float cells rendered
identically with row order part of the output, and DOUBLE/FLOAT cells
equal to rel 1e-9 (sums are taken in other orders).

Where the reference raises on SQL that has an answer, and the case is one
ROADMAP §3 lists under "Reference behaviour" (KNOWN_REFERENCE_FAULTS), the
port's answer is held to the port's sharded run instead and the case is
counted; nothing is left out of the corpus.
"""

import numpy as np
import pytest

import sqlrs_tpu
import sqlrs_tpu_torch
from sqlrs_tpu.catalog.catalog import ColumnDefinition as RefColDef
from sqlrs_tpu.data.strings import GLOBAL_STRINGS as REF_STRINGS
from sqlrs_tpu.storage.memory import DataTable as RefTable
from sqlrs_tpu.types import LogicalType as RefLT
from sqlrs_tpu.utils.render import batch_to_rows as ref_rows
from sqlrs_tpu_torch.benchmarks import sql_fuzz
from sqlrs_tpu_torch.storage.memory import import_tables
from sqlrs_tpu_torch.utils.render import batch_to_rows as port_rows

N_SHARDS = 4


def _outer_join_with_an_empty_side(sql: str, err) -> bool:
    """The reference's outer-join tail gathers from a 0-length array when
    one side is empty (ROADMAP §3; tests/test_torch_join.py::
    test_outer_join_empty_side)."""
    return (
        err[1] == "TypeError"
        and "in gather op is out of range" in err[2]
        and any(j in sql for j in ("left join", "right join", "full join"))
    )


KNOWN_REFERENCE_FAULTS = {"outer join with an empty side": _outer_join_with_an_empty_side}


@pytest.fixture(autouse=True)
def mxu_interpret(monkeypatch):
    """Both engines select their kernel paths on the CPU and run the plain
    versions there (the reference's Pallas interpret mode)."""
    monkeypatch.setenv("SQLRS_TPU_MXU", "interpret")


def ref_import(db, tables: dict) -> None:
    """storage.memory.import_tables, for the reference's classes: the same
    interning calls in the same order, so a case's strings get their codes
    in the same order in both dictionaries."""
    for name, cols in tables.items():
        types = [RefLT[tname] for _c, tname, _v, _m in cols]
        table = RefTable([c for c, _t, _v, _m in cols], types)
        datas, valids = [], []
        for (_c, _tn, values, valid), t in zip(cols, types):
            values = np.asarray(values)
            n = len(values)
            valid = np.ones(n, np.bool_) if valid is None else np.asarray(valid, np.bool_)
            if t == RefLT.VARCHAR:
                if not valid.all():
                    values = [s if ok else None for s, ok in zip(values.tolist(), valid.tolist())]
                values = REF_STRINGS.intern_many(values)
            datas.append(values)
            valids.append(valid)
        table.append_numpy(datas, valids)
        db.catalog.create_table(
            name, [RefColDef(c, t) for (c, *_r), t in zip(cols, types)], table
        )


def run_case(case) -> dict:
    """Every statement of `case` through the three engines."""
    ref = sqlrs_tpu.Database()
    ref_import(ref, case.tables)
    port = sqlrs_tpu_torch.Database(device="cpu")
    import_tables(port, case.tables)
    sharded = sqlrs_tpu_torch.Database(n_devices=N_SHARDS, device="cpu")
    import_tables(sharded, case.tables)
    out = {"diffs": [], "all_raise": 0, "known": [], "routes": [], "strategies": []}
    for sql in case.statements:
        port.last_fused_routes = []
        r = sql_fuzz.outcome(ref, sql, ref_rows)
        p = sql_fuzz.outcome(port, sql, port_rows)
        s = sql_fuzz.outcome(sharded, sql, port_rows)
        out["routes"].extend(port.last_fused_routes or [])
        out["strategies"].extend(getattr(sharded, "last_join_strategies", None) or [])
        known = next(
            (name for name, test in KNOWN_REFERENCE_FAULTS.items()
             if r[0] == "error" and p[0] == "ok" and test(sql, r)),
            None,
        )
        if known is not None:
            out["known"].append((known, sql))
        else:
            d = sql_fuzz.difference(r, p)
            if d is not None:
                out["diffs"].append((case.seed, case.size, "port", sql, d))
        d = sql_fuzz.difference(p, s)
        if d is not None:
            out["diffs"].append((case.seed, case.size, "sharded", sql, d))
        if r[0] == p[0] == s[0] == "error":
            out["all_raise"] += 1
    return out


def check_case(case) -> dict:
    """run_case, then: no difference, and nearly every statement runs (a
    statement all three engines refuse counts only as agreement, and a
    corpus of refusals would test nothing)."""
    out = run_case(case)
    assert not out["diffs"], "\n".join(map(str, out["diffs"]))
    assert out["all_raise"] <= len(case.statements) // 4, out["all_raise"]
    return out
