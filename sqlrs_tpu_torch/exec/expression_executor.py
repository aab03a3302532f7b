"""Expression executor: resolved BoundExpr tree → device Column.

The vectorized evaluator (reference src/executor/evaluator.rs:13 eval_column;
v2 src/execution/expression_executor.rs:11-40). Dispatches to the tensor
functions in sqlrs_tpu_torch/ops/elementwise.py, eagerly.
"""

from __future__ import annotations

from sqlrs_tpu_torch.binder.expression import (
    BoundCast,
    BoundComparison,
    BoundConjunction,
    BoundConstant,
    BoundExpr,
    BoundFunction,
    BoundNot,
    BoundReference,
)
from sqlrs_tpu_torch.data import Column, DeviceBatch
from sqlrs_tpu_torch.errors import ExecutorError
from sqlrs_tpu_torch.ops import elementwise as ew
from sqlrs_tpu_torch.types import Interval, LogicalType, ScalarValue


def execute_exprs_fused(exprs, batch: DeviceBatch) -> list[Column]:
    """Evaluate a list of expressions over a batch. The JAX package compiles
    the list into one program (with a per-plan jit cache); PyTorch runs
    eagerly, so this is the plain loop and the name stays for the callers."""
    return [execute_expr(e, batch) for e in exprs]


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
