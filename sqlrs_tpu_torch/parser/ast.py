"""SQL AST.

Stands in for the external `sqlparser` crate the reference wraps
(reference src/parser/mod.rs:5-46, PostgreSqlDialect). Only the surface the
engine binds is modeled; every node is a plain dataclass.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from sqlrs_tpu_torch.types import LogicalType


# ---- expressions -----------------------------------------------------------


@dataclass
class Expr:
    pass


@dataclass
class Literal(Expr):
    # kind: "int" | "float" | "string" | "bool" | "null"
    kind: str
    value: Any


@dataclass
class TypedString(Expr):
    """DATE '1998-12-01' style typed literal."""

    type_name: str
    value: str


@dataclass
class IntervalLiteral(Expr):
    value: str  # the quoted magnitude, e.g. '1'
    unit: str  # YEAR | MONTH | DAY | HOUR | MINUTE | SECOND


@dataclass
class Ident(Expr):
    parts: list[str]  # a | t.a


@dataclass
class Star(Expr):
    qualifier: Optional[str] = None  # None => *, "t" => t.*


@dataclass
class UnaryOp(Expr):
    op: str  # - | + | NOT
    operand: Expr


@dataclass
class BinaryOp(Expr):
    op: str  # + - * / % = != < <= > >= AND OR
    left: Expr
    right: Expr


@dataclass
class FunctionCall(Expr):
    name: str
    args: list[Expr]
    distinct: bool = False
    named_args: dict[str, Expr] = field(default_factory=dict)  # delim => ','


@dataclass
class Cast(Expr):
    expr: Expr
    type: LogicalType


@dataclass
class Between(Expr):
    expr: Expr
    low: Expr
    high: Expr
    negated: bool = False


@dataclass
class InList(Expr):
    expr: Expr
    values: list[Expr] = field(default_factory=list)
    negated: bool = False


@dataclass
class Like(Expr):
    expr: Expr
    pattern: Expr
    negated: bool = False


@dataclass
class IsNull(Expr):
    expr: Expr
    negated: bool = False  # IS NOT NULL


@dataclass
class Case(Expr):
    # CASE [operand] WHEN c THEN r ... [ELSE e] END
    conditions: list[Expr] = field(default_factory=list)
    results: list[Expr] = field(default_factory=list)
    else_result: Optional[Expr] = None


@dataclass
class Extract(Expr):
    field_name: str  # YEAR | MONTH | DAY
    expr: Expr = None


@dataclass
class ScalarSubquery(Expr):
    query: "SelectStmt"


@dataclass
class Exists(Expr):
    """[NOT] EXISTS (SELECT ...) — bound as a semi/anti join when it appears
    as a top-level WHERE conjunct."""

    query: "SelectStmt" = None
    negated: bool = False


@dataclass
class InSubquery(Expr):
    """x [NOT] IN (SELECT ...) — bound as a semi/anti join (NOT IN is
    null-aware per SQL three-valued semantics)."""

    expr: Expr = None
    query: "SelectStmt" = None
    negated: bool = False


@dataclass
class Parenthesized(Expr):
    expr: Expr


# ---- table references ------------------------------------------------------


@dataclass
class TableRef:
    alias: Optional[str] = None


@dataclass
class BaseTableRef(TableRef):
    name: str = ""
    # table functions: read_csv('f.csv', header=>true)
    args: Optional[list[Expr]] = None
    named_args: dict[str, Expr] = field(default_factory=dict)


@dataclass
class SubqueryRef(TableRef):
    query: Optional["SelectStmt"] = None


@dataclass
class JoinRef(TableRef):
    left: Optional[TableRef] = None
    right: Optional[TableRef] = None
    join_type: str = "inner"  # inner | left | right | full | cross
    condition: Optional[Expr] = None


# ---- statements ------------------------------------------------------------


@dataclass
class Statement:
    pass


@dataclass
class OrderByItem:
    expr: Expr
    asc: bool = True


@dataclass
class CommonTableExpr:
    name: str
    columns: list[str]  # empty => subquery's own names
    query: "SelectStmt" = None


@dataclass
class SelectStmt(Statement):
    select_list: list[Expr] = field(default_factory=list)
    from_table: Optional[TableRef] = None
    where: Optional[Expr] = None
    group_by: list[Expr] = field(default_factory=list)
    having: Optional[Expr] = None
    order_by: list[OrderByItem] = field(default_factory=list)
    limit: Optional[Expr] = None
    offset: Optional[Expr] = None
    distinct: bool = False
    aliases: list[Optional[str]] = field(default_factory=list)  # per select item
    ctes: list[CommonTableExpr] = field(default_factory=list)  # WITH ... AS (...)


@dataclass
class ColumnDef:
    name: str
    type: LogicalType


@dataclass
class CreateTableStmt(Statement):
    name: str
    columns: list[ColumnDef] = field(default_factory=list)
    as_query: Optional[SelectStmt] = None


@dataclass
class InsertStmt(Statement):
    table: str
    columns: list[str] = field(default_factory=list)  # empty => all
    values: Optional[list[list[Expr]]] = None
    query: Optional[SelectStmt] = None


@dataclass
class CopyStmt(Statement):
    table: str
    path: str
    options: dict[str, Any] = field(default_factory=dict)  # DELIMITER, HEADER


@dataclass
class ExplainStmt(Statement):
    stmt: Statement


@dataclass
class ShowTablesStmt(Statement):
    pass


@dataclass
class DescribeStmt(Statement):
    table: str


@dataclass
class CreateViewStmt(Statement):
    """CREATE VIEW name [(cols)] AS SELECT ... (the TPC-H Q15 shape,
    reference tpch qgen: create view revenue0 as ...)."""

    name: str
    columns: list[str] = field(default_factory=list)
    query: SelectStmt = None


@dataclass
class DropStmt(Statement):
    kind: str  # "view" | "table"
    name: str = ""
    if_exists: bool = False
