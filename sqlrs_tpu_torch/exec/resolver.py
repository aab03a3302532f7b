"""ColumnBindingResolver: (table_index, column_index) → positional references.

Bottom-up pass over the logical plan rewriting every BoundColumnRef into a
BoundReference{index} against the child operator's output bindings (reference
src/execution/column_binding_resolver.rs:7-38, and the v1 InputRefRewriter,
src/optimizer/input_ref_rewriter.rs:13-302). Joins resolve their equi-key
sides against the matching child and the residual filter against the merged
left++right layout (reference src/optimizer/input_ref_rewriter.rs:117-181).
"""

from __future__ import annotations

from sqlrs_tpu_torch.binder.expression import (
    BoundColumnRef,
    BoundExpr,
    BoundReference,
    ColumnBinding,
    rewrite_expr,
)
from sqlrs_tpu_torch.errors import PlannerError
from sqlrs_tpu_torch.plan.logical import (
    LogicalAggregate,
    LogicalExpressionGet,
    LogicalFilter,
    LogicalJoin,
    LogicalOperator,
    LogicalOrder,
    LogicalProjection,
)


def _resolve_against(expr: BoundExpr, bindings: list[ColumnBinding]) -> BoundExpr:
    index_of = {b: i for i, b in enumerate(bindings)}

    def f(e):
        if isinstance(e, BoundColumnRef):
            i = index_of.get(e.binding)
            if i is None:
                raise PlannerError(
                    f"failed to resolve column binding {e.binding} "
                    f"against {bindings}"
                )
            return BoundReference(i, e.type, e.column_name)
        return None

    return rewrite_expr(expr, f)


def resolve_column_bindings(op: LogicalOperator) -> None:
    """Mutates the plan in place; after this every expression holds only
    BoundReference leaves and the executor is purely positional."""
    for c in op.children:
        resolve_column_bindings(c)

    if isinstance(op, LogicalJoin):
        lb = op.children[0].output_bindings()
        rb = op.children[1].output_bindings()
        op.on = [
            (_resolve_against(l, lb), _resolve_against(r, rb)) for l, r in op.on
        ]
        if op.filter is not None:
            op.filter = _resolve_against(op.filter, lb + rb)
        return
    if isinstance(op, LogicalExpressionGet):
        return  # constant rows, no column refs
    if isinstance(
        op, (LogicalProjection, LogicalFilter, LogicalOrder, LogicalAggregate)
    ):
        if isinstance(op, LogicalProjection):
            # snapshot bindings before exprs turn positional (pass-through
            # projections derive their bindings from the exprs)
            op.frozen_bindings = op.output_bindings()
        child_bindings = op.children[0].output_bindings()
        exprs = [_resolve_against(e, child_bindings) for e in op.expressions()]
        op.set_expressions(exprs)
        return
    # Get / Limit / DummyScan / ColumnDataScan / CreateTable / Insert /
    # Explain hold no resolvable column refs
    return
