"""Logical operator algebra.

Union of the reference's two plan algebras: the v2 LogicalOperator enum
(reference src/planner_v2/operator/mod.rs:35-45: CreateTable, DummyScan,
ExpressionGet, Insert, Get, Projection, Explain, Filter, Limit) extended with
the v1-only operators it lacks (Join, CrossJoin, Aggregate, Order, Distinct —
reference src/optimizer/plan_node/mod.rs:101-123).

Column identity is v2-style (table_index, column_index) bindings
(reference src/planner_v2/binder/binding.rs:12); every operator reports its
output bindings/types/names, and `resolve_operator_types` equivalents are
the output_types() methods (reference src/planner_v2/operator/mod.rs:141).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from sqlrs_tpu_torch.binder.expression import (
    BoundAggregate,
    BoundExpr,
    ColumnBinding,
)
from sqlrs_tpu_torch.types import LogicalType


@dataclass
class LogicalOperator:
    children: list["LogicalOperator"] = field(default_factory=list)

    # ---- schema ----------------------------------------------------------

    def output_bindings(self) -> list[ColumnBinding]:
        return self.children[0].output_bindings() if self.children else []

    def output_types(self) -> list[LogicalType]:
        return self.children[0].output_types() if self.children else []

    def output_names(self) -> list[str]:
        return self.children[0].output_names() if self.children else []

    # ---- expressions (for visitors / rewriters) ---------------------------

    def expressions(self) -> list[BoundExpr]:
        return []

    def set_expressions(self, exprs: list[BoundExpr]) -> None:
        assert not exprs

    def op_name(self) -> str:
        return type(self).__name__.removeprefix("Logical")

    def explain_line(self) -> str:
        return self.op_name()


@dataclass
class LogicalGet(LogicalOperator):
    """Table scan through a table function (reference
    src/planner_v2/operator/logical_get.rs:9 carries {table_idx,
    TableFunction, bind_data, returned_types, names}); `projection` and
    `bounds` land here via pushdown (reference
    src/optimizer/plan_node/logical_table_scan.rs:8-16)."""

    table_index: int = 0
    function_name: str = ""
    bind_data: Any = None  # TableFunctionBindData
    returned_types: list[LogicalType] = field(default_factory=list)
    returned_names: list[str] = field(default_factory=list)
    projection: Optional[list[int]] = None
    bounds: Optional[tuple[int, int]] = None  # (offset, limit)

    def _cols(self) -> list[int]:
        return self.projection if self.projection is not None else list(
            range(len(self.returned_types))
        )

    def output_bindings(self):
        return [ColumnBinding(self.table_index, c) for c in self._cols()]

    def output_types(self):
        return [self.returned_types[c] for c in self._cols()]

    def output_names(self):
        return [self.returned_names[c] for c in self._cols()]

    def explain_line(self):
        s = f"Get({self.function_name}, cols: {self.output_names()}"
        if self.bounds is not None:
            s += f", bounds: {self.bounds}"
        return s + ")"


@dataclass
class LogicalDummyScan(LogicalOperator):
    """One-row zero-column scan for FROM-less selects (reference
    src/execution/volcano_executor/dummy_scan.rs:13)."""

    table_index: int = 0


@dataclass
class LogicalExpressionGet(LogicalOperator):
    """VALUES lists (reference src/planner_v2/operator/ LogicalExpressionGet)."""

    table_index: int = 0
    expr_types: list[LogicalType] = field(default_factory=list)
    expr_rows: list[list[BoundExpr]] = field(default_factory=list)

    def output_bindings(self):
        return [ColumnBinding(self.table_index, i) for i in range(len(self.expr_types))]

    def output_types(self):
        return list(self.expr_types)

    def output_names(self):
        return [f"col{i}" for i in range(len(self.expr_types))]

    def expressions(self):
        return [e for row in self.expr_rows for e in row]

    def set_expressions(self, exprs):
        k = len(self.expr_types)
        self.expr_rows = [exprs[i : i + k] for i in range(0, len(exprs), k)]


@dataclass
class LogicalProjection(LogicalOperator):
    table_index: int = 0
    exprs: list[BoundExpr] = field(default_factory=list)
    names: list[str] = field(default_factory=list)
    # Pruning projections inserted by the column-pruning rules are
    # "pass-through": every expr is a bare ColumnRef and the output KEEPS the
    # original bindings, so ancestors' (table, column) references still
    # resolve (the reference's v1 works on named columns and has no such
    # distinction; this is the binding-based equivalent).
    passthrough: bool = False
    # set by the ColumnBindingResolver before exprs are rewritten to
    # positional references (passthrough bindings derive from the exprs)
    frozen_bindings: Optional[list[ColumnBinding]] = None

    def output_bindings(self):
        if self.frozen_bindings is not None:
            return list(self.frozen_bindings)
        if self.passthrough:
            return [e.binding for e in self.exprs]  # all BoundColumnRef
        return [ColumnBinding(self.table_index, i) for i in range(len(self.exprs))]

    def output_types(self):
        return [e.return_type() for e in self.exprs]

    def output_names(self):
        return list(self.names)

    def expressions(self):
        return list(self.exprs)

    def set_expressions(self, exprs):
        self.exprs = list(exprs)

    def explain_line(self):
        return f"Projection({[e.name() for e in self.exprs]})"


@dataclass
class LogicalFilter(LogicalOperator):
    predicate: Optional[BoundExpr] = None

    def expressions(self):
        return [self.predicate]

    def set_expressions(self, exprs):
        (self.predicate,) = exprs

    def explain_line(self):
        return f"Filter({self.predicate.name()})"


@dataclass
class LogicalAggregate(LogicalOperator):
    """Group-by + aggregates; DISTINCT is planned as group-by-all with no
    aggregates (reference src/planner/select.rs:29-32)."""

    table_index: int = 0
    groups: list[BoundExpr] = field(default_factory=list)
    aggregates: list[BoundAggregate] = field(default_factory=list)

    def output_bindings(self):
        n = len(self.groups) + len(self.aggregates)
        return [ColumnBinding(self.table_index, i) for i in range(n)]

    def output_types(self):
        return [e.return_type() for e in self.groups] + [
            a.return_type() for a in self.aggregates
        ]

    def output_names(self):
        return [e.name() for e in self.groups] + [a.name() for a in self.aggregates]

    def expressions(self):
        return list(self.groups) + list(self.aggregates)

    def set_expressions(self, exprs):
        k = len(self.groups)
        self.groups = list(exprs[:k])
        self.aggregates = list(exprs[k:])

    def explain_line(self):
        return (
            f"Aggregate(groups: {[g.name() for g in self.groups]}, "
            f"aggs: {[a.name() for a in self.aggregates]})"
        )


JOIN_TYPES = ("inner", "left", "right", "full", "cross", "semi", "anti")


@dataclass
class LogicalJoin(LogicalOperator):
    """Equi-join with residual filter. `on` holds extracted equi-key pairs
    and `filter` the residual non-equi condition, datafusion-style
    (reference src/binder/table/join.rs:40,161 JoinCondition::On{on,filter}).

    semi/anti are the decorrelated EXISTS / IN-subquery forms (no reference
    analogue — the reference binds only FROM-alias and scalar subqueries,
    src/binder/table/subquery.rs:84): they emit LEFT rows only, preserving
    left order. `null_aware` anti implements NOT IN three-valued semantics
    (any NULL on the right ⇒ empty result; NULL probe values never pass)."""

    join_type: str = "inner"
    on: list[tuple[BoundExpr, BoundExpr]] = field(default_factory=list)
    filter: Optional[BoundExpr] = None
    null_aware: bool = False

    def output_bindings(self):
        if self.join_type in ("semi", "anti"):
            return self.children[0].output_bindings()
        return self.children[0].output_bindings() + self.children[1].output_bindings()

    def output_types(self):
        if self.join_type in ("semi", "anti"):
            return self.children[0].output_types()
        return self.children[0].output_types() + self.children[1].output_types()

    def output_names(self):
        if self.join_type in ("semi", "anti"):
            return self.children[0].output_names()
        return self.children[0].output_names() + self.children[1].output_names()

    def expressions(self):
        out: list[BoundExpr] = []
        for l, r in self.on:
            out.extend((l, r))
        if self.filter is not None:
            out.append(self.filter)
        return out

    def set_expressions(self, exprs):
        k = len(self.on)
        self.on = [(exprs[2 * i], exprs[2 * i + 1]) for i in range(k)]
        self.filter = exprs[2 * k] if len(exprs) > 2 * k else None

    def explain_line(self):
        s = f"Join({self.join_type}, on: {[(l.name(), r.name()) for l, r in self.on]}"
        if self.filter is not None:
            s += f", filter: {self.filter.name()}"
        return s + ")"


@dataclass
class LogicalCrossJoin(LogicalOperator):
    def output_bindings(self):
        return self.children[0].output_bindings() + self.children[1].output_bindings()

    def output_types(self):
        return self.children[0].output_types() + self.children[1].output_types()

    def output_names(self):
        return self.children[0].output_names() + self.children[1].output_names()


@dataclass
class LogicalOrder(LogicalOperator):
    # (expr, ascending) pairs; schema passthrough
    items: list[tuple[BoundExpr, bool]] = field(default_factory=list)

    def expressions(self):
        return [e for e, _ in self.items]

    def set_expressions(self, exprs):
        self.items = [(e, asc) for e, (_, asc) in zip(exprs, self.items)]

    def explain_line(self):
        return f"Order({[(e.name(), 'asc' if a else 'desc') for e, a in self.items]})"


@dataclass
class LogicalLimit(LogicalOperator):
    """limit/offset pre-evaluated to host ints at bind time (reference
    src/planner_v2/binder/statement/bind_result_modifier.rs:41-78)."""

    limit: Optional[int] = None
    offset: Optional[int] = None

    def explain_line(self):
        return f"Limit(limit: {self.limit}, offset: {self.offset})"


@dataclass
class LogicalCreateTable(LogicalOperator):
    schema_name: str = "main"
    table_name: str = ""
    column_names: list[str] = field(default_factory=list)
    column_types: list[LogicalType] = field(default_factory=list)
    # CTAS when a child is present

    def output_bindings(self):
        return []

    def output_types(self):
        return []

    def output_names(self):
        return []


@dataclass
class LogicalInsert(LogicalOperator):
    table_name: str = ""
    schema_name: str = "main"
    # expected_types[i] = declared type of table column i;
    # column_index_map[i] = which child-output column feeds table column i
    # (None => NULL fill), replicating the reference's Reference/Constant
    # reorder exprs (reference src/execution/volcano_executor/insert.rs:22-98)
    expected_types: list[LogicalType] = field(default_factory=list)
    column_index_map: list[Optional[int]] = field(default_factory=list)

    def output_bindings(self):
        return []

    def output_types(self):
        return []

    def output_names(self):
        return []


@dataclass
class LogicalCreateView(LogicalOperator):
    view_name: str = ""
    schema_name: str = "main"
    column_names: list[str] = field(default_factory=list)
    query_ast: Any = None  # ast.SelectStmt, re-bound at each use site

    def output_bindings(self):
        return []

    def output_types(self):
        return []

    def output_names(self):
        return []


@dataclass
class LogicalDrop(LogicalOperator):
    kind: str = "table"  # "table" | "view"
    name: str = ""
    schema_name: str = "main"
    if_exists: bool = False

    def output_bindings(self):
        return []

    def output_types(self):
        return []

    def output_names(self):
        return []


@dataclass
class LogicalExplain(LogicalOperator):
    table_index: int = 0
    stmt_type: str = "select"
    plan_strings: dict[str, str] = field(default_factory=dict)

    def output_bindings(self):
        return [ColumnBinding(self.table_index, 0), ColumnBinding(self.table_index, 1)]

    def output_types(self):
        return [LogicalType.VARCHAR, LogicalType.VARCHAR]

    def output_names(self):
        return ["explain_key", "explain_value"]


@dataclass
class LogicalColumnDataScan(LogicalOperator):
    """Pre-materialized result rows (show tables / describe / explain output,
    reference src/execution/volcano_executor/column_data_scan.rs:10)."""

    table_index: int = 0
    names: list[str] = field(default_factory=list)
    types: list[LogicalType] = field(default_factory=list)
    batch: Any = None  # DeviceBatch

    def output_bindings(self):
        return [ColumnBinding(self.table_index, i) for i in range(len(self.types))]

    def output_types(self):
        return list(self.types)

    def output_names(self):
        return list(self.names)


def explain_tree(op: LogicalOperator, indent: int = 0) -> str:
    """Render a plan tree (reference src/util/tree_render.rs:156-188)."""
    lines = ["  " * indent + op.explain_line()]
    for c in op.children:
        lines.append(explain_tree(c, indent + 1))
    return "\n".join(lines)
