"""Physical plan: kernel-choice wrappers over the resolved logical plan.

Mirrors the reference's PhysicalRewriter decisions (reference
src/optimizer/physical_rewriter.rs:15-78): Join → HashJoin unless Cross;
Aggregate → SimpleAgg iff no group-by else HashAgg; everything else 1:1
(reference src/optimizer/plan_node/physical_*.rs and the v2
PhysicalPlanGenerator, src/execution/physical_plan_generator.rs:18-36).

The generator runs the ColumnBindingResolver first, so physical expressions
are purely positional.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from sqlrs_tpu_torch.binder.expression import BoundAggregate, BoundExpr
from sqlrs_tpu_torch.errors import PlannerError
from sqlrs_tpu_torch.exec.resolver import resolve_column_bindings
from sqlrs_tpu_torch.plan import logical as L
from sqlrs_tpu_torch.types import LogicalType


@dataclass
class PhysicalOperator:
    children: list["PhysicalOperator"] = field(default_factory=list)
    names: list[str] = field(default_factory=list)
    types: list[LogicalType] = field(default_factory=list)

    def op_name(self) -> str:
        return type(self).__name__.removeprefix("Physical")

    def explain_line(self) -> str:
        return self.op_name()


@dataclass
class PhysicalTableScan(PhysicalOperator):
    function_name: str = ""
    bind_data: Any = None
    projection: Optional[list[int]] = None
    bounds: Optional[tuple[int, int]] = None

    def explain_line(self):
        return f"TableScan({self.function_name}, cols: {self.names})"


@dataclass
class PhysicalDummyScan(PhysicalOperator):
    pass


@dataclass
class PhysicalExpressionScan(PhysicalOperator):
    expr_types: list[LogicalType] = field(default_factory=list)
    expr_rows: list[list[BoundExpr]] = field(default_factory=list)


@dataclass
class PhysicalColumnDataScan(PhysicalOperator):
    batch: Any = None


@dataclass
class PhysicalProjection(PhysicalOperator):
    exprs: list[BoundExpr] = field(default_factory=list)

    def explain_line(self):
        return f"Projection({[e.name() for e in self.exprs]})"


@dataclass
class PhysicalFilter(PhysicalOperator):
    predicate: Optional[BoundExpr] = None

    def explain_line(self):
        return f"Filter({self.predicate.name()})"


@dataclass
class PhysicalLimit(PhysicalOperator):
    limit: Optional[int] = None
    offset: Optional[int] = None

    def explain_line(self):
        return f"Limit(limit: {self.limit}, offset: {self.offset})"


@dataclass
class PhysicalOrder(PhysicalOperator):
    items: list[tuple[BoundExpr, bool]] = field(default_factory=list)

    def explain_line(self):
        return f"Order({[(e.name(), 'asc' if a else 'desc') for e, a in self.items]})"


@dataclass
class PhysicalSimpleAgg(PhysicalOperator):
    aggregates: list[BoundAggregate] = field(default_factory=list)

    def explain_line(self):
        return f"SimpleAgg({[a.name() for a in self.aggregates]})"


@dataclass
class PhysicalHashAgg(PhysicalOperator):
    groups: list[BoundExpr] = field(default_factory=list)
    aggregates: list[BoundAggregate] = field(default_factory=list)

    def explain_line(self):
        return (
            f"HashAgg(groups: {[g.name() for g in self.groups]}, "
            f"aggs: {[a.name() for a in self.aggregates]})"
        )


@dataclass
class PhysicalHashJoin(PhysicalOperator):
    join_type: str = "inner"
    on: list[tuple[BoundExpr, BoundExpr]] = field(default_factory=list)
    filter: Optional[BoundExpr] = None
    left_width: int = 0
    left_types: list[LogicalType] = field(default_factory=list)
    right_types: list[LogicalType] = field(default_factory=list)
    null_aware: bool = False  # anti: NOT IN three-valued semantics

    def explain_line(self):
        s = f"HashJoin({self.join_type}, on: {[(l.name(), r.name()) for l, r in self.on]}"
        if self.filter is not None:
            s += f", filter: {self.filter.name()}"
        return s + ")"


@dataclass
class PhysicalCrossJoin(PhysicalOperator):
    left_width: int = 0


@dataclass
class PhysicalCreateTable(PhysicalOperator):
    schema_name: str = "main"
    table_name: str = ""
    column_names: list[str] = field(default_factory=list)
    column_types: list[LogicalType] = field(default_factory=list)


@dataclass
class PhysicalInsert(PhysicalOperator):
    table_name: str = ""
    expected_types: list[LogicalType] = field(default_factory=list)
    column_index_map: list[Optional[int]] = field(default_factory=list)


@dataclass
class PhysicalExplain(PhysicalOperator):
    plan_strings: dict[str, str] = field(default_factory=dict)


@dataclass
class PhysicalCreateView(PhysicalOperator):
    schema_name: str = "main"
    view_name: str = ""
    column_names: list[str] = field(default_factory=list)
    query_ast: Any = None


@dataclass
class PhysicalDrop(PhysicalOperator):
    kind: str = "table"
    name: str = ""
    schema_name: str = "main"
    if_exists: bool = False


def explain_tree(op: PhysicalOperator, indent: int = 0) -> str:
    lines = ["  " * indent + op.explain_line()]
    for c in op.children:
        lines.append(explain_tree(c, indent + 1))
    return "\n".join(lines)


class PhysicalPlanGenerator:
    """Logical → physical lowering (reference
    src/execution/physical_plan_generator.rs:18: resolve refs, resolve types,
    per-op lowering)."""

    def create_plan(self, op: L.LogicalOperator) -> PhysicalOperator:
        resolve_column_bindings(op)
        return self._lower(op)

    def _lower(self, op: L.LogicalOperator) -> PhysicalOperator:
        kids = [self._lower(c) for c in op.children]
        names, types = op.output_names(), op.output_types()

        if isinstance(op, L.LogicalGet):
            return PhysicalTableScan(
                children=kids,
                names=names,
                types=types,
                function_name=op.function_name,
                bind_data=op.bind_data,
                projection=op.projection,
                bounds=op.bounds,
            )
        if isinstance(op, L.LogicalDummyScan):
            return PhysicalDummyScan(children=kids)
        if isinstance(op, L.LogicalExpressionGet):
            return PhysicalExpressionScan(
                children=kids,
                names=names,
                types=types,
                expr_types=op.expr_types,
                expr_rows=op.expr_rows,
            )
        if isinstance(op, L.LogicalColumnDataScan):
            return PhysicalColumnDataScan(
                children=kids, names=names, types=types, batch=op.batch
            )
        if isinstance(op, L.LogicalProjection):
            return PhysicalProjection(
                children=kids, names=names, types=types, exprs=op.exprs
            )
        if isinstance(op, L.LogicalFilter):
            return PhysicalFilter(
                children=kids,
                names=kids[0].names,
                types=kids[0].types,
                predicate=op.predicate,
            )
        if isinstance(op, L.LogicalLimit):
            return PhysicalLimit(
                children=kids,
                names=kids[0].names,
                types=kids[0].types,
                limit=op.limit,
                offset=op.offset,
            )
        if isinstance(op, L.LogicalOrder):
            return PhysicalOrder(
                children=kids,
                names=kids[0].names,
                types=kids[0].types,
                items=op.items,
            )
        if isinstance(op, L.LogicalAggregate):
            # kernel choice (reference physical_rewriter.rs:49-62)
            if not op.groups:
                return PhysicalSimpleAgg(
                    children=kids, names=names, types=types, aggregates=op.aggregates
                )
            return PhysicalHashAgg(
                children=kids,
                names=names,
                types=types,
                groups=op.groups,
                aggregates=op.aggregates,
            )
        if isinstance(op, L.LogicalJoin):
            # kernel choice (reference physical_rewriter.rs:20-31)
            return PhysicalHashJoin(
                children=kids,
                names=names,
                types=types,
                join_type=op.join_type,
                on=op.on,
                filter=op.filter,
                left_width=len(op.children[0].output_types()),
                left_types=op.children[0].output_types(),
                right_types=op.children[1].output_types(),
                null_aware=op.null_aware,
            )
        if isinstance(op, L.LogicalCrossJoin):
            return PhysicalCrossJoin(
                children=kids,
                names=names,
                types=types,
                left_width=len(op.children[0].output_types()),
            )
        if isinstance(op, L.LogicalCreateTable):
            return PhysicalCreateTable(
                children=kids,
                schema_name=op.schema_name,
                table_name=op.table_name,
                column_names=op.column_names,
                column_types=op.column_types,
            )
        if isinstance(op, L.LogicalInsert):
            return PhysicalInsert(
                children=kids,
                table_name=op.table_name,
                expected_types=op.expected_types,
                column_index_map=op.column_index_map,
            )
        if isinstance(op, L.LogicalCreateView):
            return PhysicalCreateView(
                children=kids,
                schema_name=op.schema_name,
                view_name=op.view_name,
                column_names=op.column_names,
                query_ast=op.query_ast,
            )
        if isinstance(op, L.LogicalDrop):
            return PhysicalDrop(
                children=kids,
                kind=op.kind,
                name=op.name,
                schema_name=op.schema_name,
                if_exists=op.if_exists,
            )
        if isinstance(op, L.LogicalExplain):
            return PhysicalExplain(
                children=kids,
                names=names,
                types=types,
                plan_strings=op.plan_strings,
            )
        raise PlannerError(f"cannot lower {type(op).__name__}")
