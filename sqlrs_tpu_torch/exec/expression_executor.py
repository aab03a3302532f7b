"""Expression executor: resolved BoundExpr tree → device Column.

The vectorized evaluator (reference src/executor/evaluator.rs:13 eval_column;
v2 src/execution/expression_executor.rs:11-40). Dispatches to the tensor
functions in sqlrs_tpu_torch/ops/elementwise.py; execute_exprs_fused runs an
expression list as one program (utils/programs.py), as the JAX package
compiles it into one jitted XLA program.
"""

from __future__ import annotations

import torch

from sqlrs_tpu_torch.binder.expression import (
    BoundCast,
    BoundComparison,
    BoundConjunction,
    BoundConstant,
    BoundExpr,
    BoundFunction,
    BoundNot,
    BoundReference,
    visit_expr,
)
from sqlrs_tpu_torch.data import Column, DeviceBatch
from sqlrs_tpu_torch.errors import ExecutorError
from sqlrs_tpu_torch.ops import elementwise as ew
from sqlrs_tpu_torch.types import Interval, LogicalType, ScalarValue
from sqlrs_tpu_torch.utils import programs


class _Rows:
    """The batch a program body evaluates over: only the columns the
    expressions reference are its inputs (the others are None)."""

    def __init__(self, columns, num_rows: int, device) -> None:
        self.columns = columns
        self.num_rows = num_rows
        self.device = device


def execute_exprs_fused(exprs, batch: DeviceBatch) -> list[Column]:
    """Evaluate a LIST of expressions over a batch as ONE program
    (utils/programs.py): one submission instead of one launch per
    elementwise node. The reference's execute_exprs_fused
    (sqlrs_tpu/exec/expression_executor.py:34-103) and its signature: the
    expression reprs, the referenced columns' types, dtypes and lengths,
    the row count and the dictionary's length (the last two in every
    program key).

    Pure column selections submit nothing. An expression list that would
    read the host (string casts, ||, checked narrowing casts, a code map or
    rank table not yet on the device) runs eagerly: `_host_work` decides it
    from the tree before any capture, where the reference pins an eager
    fallback after a trace failure."""
    return _run_exprs(exprs, batch, False)


def execute_predicate(expr: BoundExpr, batch: DeviceBatch) -> tuple[Column, int]:
    """A predicate and the number of rows where it is TRUE: the predicate's
    program also counts them, and the count is one host read."""
    keep, count = _run_exprs([expr], batch, True)
    return keep, int(count)


def _run_exprs(exprs, batch, with_count: bool):
    def eager():
        outs = [execute_expr(e, batch) for e in exprs]
        if not with_count:
            return outs
        return outs[0], torch.logical_and(outs[0].data, outs[0].valid).sum()

    if (
        not programs.enabled()
        or programs.nested()
        or batch.num_rows == 0
        or not batch.columns
        or not exprs
    ):
        return eager()
    if not with_count and all(isinstance(e, BoundReference) for e in exprs):
        return [batch.columns[e.index] for e in exprs]
    why = _host_work(exprs, batch.device)
    if why is not None:
        programs.route_eagerly(why)
        return eager()
    refs: set[int] = set()
    for e in exprs:
        visit_expr(e, lambda x: refs.add(x.index) if isinstance(x, BoundReference) else None)
    refs_l = sorted(refs)
    types = [batch.schema.fields[i].type for i in refs_l]
    n, width, dev, e_list = batch.num_rows, len(batch.columns), batch.device, list(exprs)

    def body(datas, valids):
        cols = [None] * width
        for i, t, d, v in zip(refs_l, types, datas, valids):
            cols[i] = Column(t, d, v)
        rows = _Rows(cols, n, dev)
        outs = [execute_expr(e, rows) for e in e_list]
        res = tuple((c.type, c.data, c.valid) for c in outs)
        if with_count:
            return res, torch.logical_and(outs[0].data, outs[0].valid).sum()
        return res

    out = programs.run(
        "exec.expression_executor.execute_exprs_fused",
        body,
        (
            tuple(batch.columns[i].data for i in refs_l),
            tuple(batch.columns[i].valid for i in refs_l),
        ),
        (tuple(repr(e) for e in exprs), tuple(refs_l), tuple(types), width, n, with_count),
    )
    if with_count:
        ((t, d, v),), count = out
        return Column(t, d, v), count
    return [Column(t, d, v) for t, d, v in out]


def _host_work(exprs, device) -> str | None:
    """Why evaluating `exprs` would read the host, or None: decided from
    the expression trees and the dictionary's device caches, before any
    capture."""
    from sqlrs_tpu_torch.data.strings import GLOBAL_STRINGS
    from sqlrs_tpu_torch.types.types import can_implicit_cast

    found: list[str] = []

    def check(e):
        if isinstance(e, BoundCast):
            src, dst = e.child.return_type(), e.target
            if src == dst or src == LogicalType.SQLNULL:
                return
            if src.is_numeric() and dst.is_numeric():
                if dst.is_integral() and not e.try_cast and not can_implicit_cast(src, dst):
                    found.append("checked narrowing cast")
                return
            if src == LogicalType.BOOLEAN and dst.is_numeric():
                return
            found.append("cast on the host")
        elif isinstance(e, BoundFunction):
            if e.op == "concat":
                found.append("|| (host dictionary work)")
            elif e.op == "like":
                key = ew.like_key(e.args[1].value.value)
                if not GLOBAL_STRINGS.has_device_table(key, device):
                    found.append("LIKE table build")
            elif e.op == "substring":
                key = ew.substring_key(
                    int(e.args[1].value.value),
                    int(e.args[2].value.value) if len(e.args) > 2 else None,
                )
                if not GLOBAL_STRINGS.has_device_table(key, device):
                    found.append("substring code map build")
        elif isinstance(e, BoundComparison) and e.op not in ("=", "!="):
            if (e.left.return_type() == LogicalType.VARCHAR
                    and not GLOBAL_STRINGS.has_device_ranks(device)):
                found.append("rank table build")

    for e in exprs:
        visit_expr(e, check)
    return found[0] if found else None


def execute_expr(expr: BoundExpr, batch: DeviceBatch) -> Column:
    if isinstance(expr, BoundReference):
        return batch.columns[expr.index]
    if isinstance(expr, BoundConstant):
        v = expr.value
        t = v.type if v.type != LogicalType.SQLNULL else LogicalType.SQLNULL
        return Column.broadcast(v, t, batch.num_rows, device=batch.device)
    if isinstance(expr, BoundCast):
        child = execute_expr(expr.child, batch)
        return ew.cast_column(child, expr.target, safe=expr.try_cast)
    if isinstance(expr, BoundComparison):
        left = execute_expr(expr.left, batch)
        right = execute_expr(expr.right, batch)
        return ew.compare(expr.op, left, right)
    if isinstance(expr, BoundConjunction):
        cols = [execute_expr(a, batch) for a in expr.args]
        out = cols[0]
        for c in cols[1:]:
            out = ew.kleene_and(out, c) if expr.op == "AND" else ew.kleene_or(out, c)
        return out
    if isinstance(expr, BoundNot):
        return ew.logical_not(execute_expr(expr.child, batch))
    if isinstance(expr, BoundFunction):
        return _execute_function(expr, batch)
    from sqlrs_tpu_torch.binder.expression import BoundCase, BoundIsNull

    if isinstance(expr, BoundIsNull):
        return ew.is_null(execute_expr(expr.child, batch), expr.negated)
    if isinstance(expr, BoundCase):
        conds = [execute_expr(c, batch) for c in expr.conditions]
        results = [execute_expr(r, batch) for r in expr.results]
        return ew.case_when(conds, results, expr.type)
    raise ExecutorError(f"cannot execute expression {type(expr).__name__}")


def _execute_function(expr: BoundFunction, batch: DeviceBatch) -> Column:
    if expr.op in ("+", "-", "*", "/", "%"):
        left = execute_expr(expr.args[0], batch)
        right = execute_expr(expr.args[1], batch)
        return ew.arithmetic(expr.op, expr.type, left, right)
    if expr.op == "neg":
        return ew.negate(execute_expr(expr.args[0], batch))
    if expr.op in ("date+", "date-"):
        dates = execute_expr(expr.args[0], batch)
        interval = _constant_interval(expr.args[1])
        sign = 1 if expr.op == "date+" else -1
        return ew.date_add_interval(dates, interval, sign)
    if expr.op == "like":
        col = execute_expr(expr.args[0], batch)
        pattern = expr.args[1]
        return ew.like_match(col, pattern.value.value)
    if expr.op.startswith("extract_"):
        col = execute_expr(expr.args[0], batch)
        return ew.extract_date_field(col, expr.op.removeprefix("extract_"))
    if expr.op == "substring":
        col = execute_expr(expr.args[0], batch)
        start = int(expr.args[1].value.value)
        length = (
            int(expr.args[2].value.value) if len(expr.args) > 2 else None
        )
        return ew.substring_column(col, start, length)
    if expr.op == "concat":
        left = execute_expr(expr.args[0], batch)
        right = execute_expr(expr.args[1], batch)
        return ew.concat_columns(left, right)
    raise ExecutorError(f"unknown function kernel {expr.op}")


def _constant_interval(expr: BoundExpr) -> Interval:
    if isinstance(expr, BoundConstant) and isinstance(expr.value.value, Interval):
        return expr.value.value
    raise ExecutorError("INTERVAL operands must be constants")


def execute_scalar(expr: BoundExpr, device) -> ScalarValue:
    """Evaluate a row-independent expression on a 1-row dummy batch on
    `device` (reference src/execution/util.rs:34)."""
    from sqlrs_tpu_torch.data import Schema

    dummy = DeviceBatch(Schema(()), [], 1, device)
    col = execute_expr(expr, dummy)
    return col.scalar_at(0)
