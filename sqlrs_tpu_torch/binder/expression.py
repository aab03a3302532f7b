"""Bound expression IR.

Mirrors the reference v2's 7 BoundExpression variants (reference
src/planner_v2/binder/expression/mod.rs:31-39): ColumnRef, Constant,
Reference, Cast, Function, Comparison, Conjunction — plus aggregates (v1
carries them as AggFunc bound exprs, reference src/binder/expression/
agg_func.rs:37) and NOT. ColumnRefs are (table_index, column_index) pairs
(reference src/planner_v2/binder/bind_context.rs:12) resolved to positional
References by the ColumnBindingResolver before execution.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from sqlrs_tpu_torch.types import LogicalType, ScalarValue


@dataclass(frozen=True)
class ColumnBinding:
    table_index: int
    column_index: int


@dataclass(frozen=True)
class BoundExpr:
    def return_type(self) -> LogicalType:
        raise NotImplementedError

    def name(self) -> str:
        raise NotImplementedError

    def children(self) -> tuple["BoundExpr", ...]:
        return ()

    def with_children(self, children: tuple["BoundExpr", ...]) -> "BoundExpr":
        assert not children
        return self


@dataclass(frozen=True)
class BoundColumnRef(BoundExpr):
    binding: ColumnBinding
    type: LogicalType
    column_name: str

    def return_type(self) -> LogicalType:
        return self.type

    def name(self) -> str:
        return self.column_name


@dataclass(frozen=True)
class BoundReference(BoundExpr):
    """Positional index into the input batch (post-resolution)."""

    index: int
    type: LogicalType
    column_name: str = ""

    def return_type(self) -> LogicalType:
        return self.type

    def name(self) -> str:
        return self.column_name


@dataclass(frozen=True)
class BoundConstant(BoundExpr):
    value: ScalarValue

    def return_type(self) -> LogicalType:
        return self.value.type

    def name(self) -> str:
        return str(self.value)


@dataclass(frozen=True)
class BoundCast(BoundExpr):
    child: BoundExpr
    target: LogicalType
    try_cast: bool = False

    def return_type(self) -> LogicalType:
        return self.target

    def name(self) -> str:
        return self.child.name()

    def children(self):
        return (self.child,)

    def with_children(self, children):
        return BoundCast(children[0], self.target, self.try_cast)


@dataclass(frozen=True)
class BoundFunction(BoundExpr):
    """Scalar function with an overload already resolved (arith, date math)."""

    function_name: str
    op: str  # kernel selector: + - * / %
    args: tuple[BoundExpr, ...]
    type: LogicalType

    def return_type(self) -> LogicalType:
        return self.type

    def name(self) -> str:
        return f"{self.args[0].name()} {self.op} {self.args[1].name()}" if len(
            self.args
        ) == 2 else f"{self.function_name}({', '.join(a.name() for a in self.args)})"

    def children(self):
        return self.args

    def with_children(self, children):
        return BoundFunction(self.function_name, self.op, tuple(children), self.type)


@dataclass(frozen=True)
class BoundComparison(BoundExpr):
    op: str  # = != < <= > >=
    left: BoundExpr
    right: BoundExpr

    def return_type(self) -> LogicalType:
        return LogicalType.BOOLEAN

    def name(self) -> str:
        return f"{self.left.name()} {self.op} {self.right.name()}"

    def children(self):
        return (self.left, self.right)

    def with_children(self, children):
        return BoundComparison(self.op, children[0], children[1])


@dataclass(frozen=True)
class BoundConjunction(BoundExpr):
    op: str  # AND | OR
    args: tuple[BoundExpr, ...]

    def return_type(self) -> LogicalType:
        return LogicalType.BOOLEAN

    def name(self) -> str:
        def part(a: BoundExpr) -> str:
            # parenthesize a nested conjunction of the other op — without
            # this, mixed AND/OR trees render ambiguously in explain output
            if isinstance(a, BoundConjunction) and a.op != self.op:
                return f"({a.name()})"
            return a.name()

        return f" {self.op} ".join(part(a) for a in self.args)

    def children(self):
        return self.args

    def with_children(self, children):
        return BoundConjunction(self.op, tuple(children))


@dataclass(frozen=True)
class BoundNot(BoundExpr):
    child: BoundExpr

    def return_type(self) -> LogicalType:
        return LogicalType.BOOLEAN

    def name(self) -> str:
        return f"NOT {self.child.name()}"

    def children(self):
        return (self.child,)

    def with_children(self, children):
        return BoundNot(children[0])


@dataclass(frozen=True)
class BoundIsNull(BoundExpr):
    child: BoundExpr
    negated: bool = False

    def return_type(self) -> LogicalType:
        return LogicalType.BOOLEAN

    def name(self) -> str:
        return f"{self.child.name()} IS {'NOT ' if self.negated else ''}NULL"

    def children(self):
        return (self.child,)

    def with_children(self, children):
        return BoundIsNull(children[0], self.negated)


@dataclass(frozen=True)
class BoundCase(BoundExpr):
    conditions: tuple[BoundExpr, ...]
    results: tuple[BoundExpr, ...]  # len == len(conditions) + 1 (else last)
    type: LogicalType = LogicalType.SQLNULL

    def return_type(self) -> LogicalType:
        return self.type

    def name(self) -> str:
        return "CASE"

    def children(self):
        return self.conditions + self.results

    def with_children(self, children):
        k = len(self.conditions)
        return BoundCase(tuple(children[:k]), tuple(children[k:]), self.type)


@dataclass(frozen=True)
class BoundAggregate(BoundExpr):
    """sum/count/min/max/avg(arg), count(*) when arg is None; distinct flag
    per reference src/binder/expression/agg_func.rs:37."""

    function_name: str  # sum | count | min | max | avg
    arg: Optional[BoundExpr]
    distinct: bool
    type: LogicalType

    def return_type(self) -> LogicalType:
        return self.type

    def name(self) -> str:
        inner = "*" if self.arg is None else self.arg.name()
        d = "distinct " if self.distinct else ""
        return f"{self.function_name.capitalize()}({d}{inner})"

    def children(self):
        return () if self.arg is None else (self.arg,)

    def with_children(self, children):
        arg = children[0] if children else None
        return BoundAggregate(self.function_name, arg, self.distinct, self.type)


# ---- tree utilities ---------------------------------------------------------


def rewrite_expr(expr: BoundExpr, fn) -> BoundExpr:
    """Bottom-up rewrite: fn applied to every node after its children."""
    kids = expr.children()
    if kids:
        expr = expr.with_children(tuple(rewrite_expr(k, fn) for k in kids))
    out = fn(expr)
    return expr if out is None else out


def visit_expr(expr: BoundExpr, fn) -> None:
    fn(expr)
    for k in expr.children():
        visit_expr(k, fn)


def collect_aggregates(expr: BoundExpr) -> list[BoundAggregate]:
    out: list[BoundAggregate] = []

    def f(e):
        if isinstance(e, BoundAggregate):
            out.append(e)

    visit_expr(expr, f)
    return out


def contains_column_refs(expr: BoundExpr) -> bool:
    found = []

    def f(e):
        if isinstance(e, (BoundColumnRef, BoundReference)):
            found.append(e)

    visit_expr(expr, f)
    return bool(found)
