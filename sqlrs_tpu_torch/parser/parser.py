"""Recursive-descent / Pratt SQL parser.

Covers the statement surface the reference binds (reference
src/parser/mod.rs:5-46 delegates to the external sqlparser crate; here the
parser is in-tree): SELECT with joins/subqueries/aggregates/order/limit,
CREATE TABLE (+AS), INSERT (+SELECT), COPY FROM, EXPLAIN, SHOW TABLES,
DESCRIBE, typed DATE/INTERVAL literals, table functions with `=>` named args,
and filename replacement scans ('x.csv' as a table ref, reference
src/planner_v2/binder/statement/bind_base_table_ref.rs:100-126).
"""

from __future__ import annotations

from typing import Optional

from sqlrs_tpu_torch.errors import ParserError
from sqlrs_tpu_torch.parser import ast
from sqlrs_tpu_torch.parser.tokenizer import Token, tokenize
from sqlrs_tpu_torch.types import parse_type_name

# Pratt binding powers
_PREC_OR = 10
_PREC_AND = 20
_PREC_NOT = 25
_PREC_CMP = 30
_PREC_ADD = 40
_PREC_MUL = 50
_PREC_UNARY = 60

_CMP_OPS = {"=", "!=", "<>", "<", "<=", ">", ">="}
_ADD_OPS = {"+", "-"}
_MUL_OPS = {"*", "/", "%"}


def parse(sql: str) -> list[ast.Statement]:
    """Parse a script into statements (split on top-level ';')."""
    tokens = tokenize(sql)
    p = _Parser(tokens)
    stmts: list[ast.Statement] = []
    while not p.peek().kind == "EOF":
        if p.peek_punct(";"):
            p.advance()
            continue
        stmts.append(p.parse_statement())
        if not (p.peek().kind == "EOF" or p.peek_punct(";")):
            raise ParserError(f"unexpected token {p.peek().value!r} after statement")
    return stmts


def parse_one(sql: str) -> ast.Statement:
    stmts = parse(sql)
    if len(stmts) != 1:
        raise ParserError(f"expected exactly one statement, got {len(stmts)}")
    return stmts[0]


class _Parser:
    def __init__(self, tokens: list[Token]) -> None:
        self.tokens = tokens
        self.i = 0

    # ---- token helpers ---------------------------------------------------

    def peek(self, ahead: int = 0) -> Token:
        j = min(self.i + ahead, len(self.tokens) - 1)
        return self.tokens[j]

    def advance(self) -> Token:
        t = self.tokens[self.i]
        if t.kind != "EOF":
            self.i += 1
        return t

    def peek_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "KEYWORD" and t.value in kws

    def peek_punct(self, p: str) -> bool:
        t = self.peek()
        return t.kind == "PUNCT" and t.value == p

    def peek_op(self, op: str) -> bool:
        t = self.peek()
        return t.kind == "OP" and t.value == op

    def eat_kw(self, *kws: str) -> bool:
        if self.peek_kw(*kws):
            self.advance()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.eat_kw(kw):
            raise ParserError(f"expected {kw}, found {self.peek().value!r}")

    def eat_punct(self, p: str) -> bool:
        if self.peek_punct(p):
            self.advance()
            return True
        return False

    def expect_punct(self, p: str) -> None:
        if not self.eat_punct(p):
            raise ParserError(f"expected {p!r}, found {self.peek().value!r}")

    def expect_ident(self) -> str:
        t = self.peek()
        if t.kind == "IDENT":
            return self.advance().value
        # allow non-reserved keywords as identifiers where unambiguous
        if t.kind == "KEYWORD" and t.value in ("TABLES", "YEAR", "MONTH", "DAY", "DATE"):
            return self.advance().value.lower()
        raise ParserError(f"expected identifier, found {t.value!r}")

    # ---- statements ------------------------------------------------------

    def parse_statement(self) -> ast.Statement:
        if self.peek_kw("SELECT"):
            return self.parse_select()
        if self.peek_kw("WITH"):
            return self.parse_with()
        if self.peek_kw("CREATE"):
            return self.parse_create()
        if self.peek_kw("DROP"):
            return self.parse_drop()
        if self.peek_kw("INSERT"):
            return self.parse_insert()
        if self.peek_kw("COPY"):
            return self.parse_copy()
        if self.peek_kw("EXPLAIN"):
            self.advance()
            return ast.ExplainStmt(self.parse_statement())
        if self.peek_kw("SHOW"):
            self.advance()
            self.expect_kw("TABLES")
            return ast.ShowTablesStmt()
        if self.peek_kw("DESCRIBE"):
            self.advance()
            return ast.DescribeStmt(self.expect_ident())
        raise ParserError(f"unsupported statement start: {self.peek().value!r}")

    def parse_select(self) -> ast.SelectStmt:
        self.expect_kw("SELECT")
        stmt = ast.SelectStmt()
        stmt.distinct = self.eat_kw("DISTINCT")
        while True:
            expr = self.parse_expr()
            alias: Optional[str] = None
            if self.eat_kw("AS"):
                alias = self.expect_ident()
            elif self.peek().kind == "IDENT":
                alias = self.advance().value
            stmt.select_list.append(expr)
            stmt.aliases.append(alias)
            if not self.eat_punct(","):
                break
        if self.eat_kw("FROM"):
            stmt.from_table = self.parse_table_refs()
        if self.eat_kw("WHERE"):
            stmt.where = self.parse_expr()
        if self.peek_kw("GROUP"):
            self.advance()
            self.expect_kw("BY")
            while True:
                stmt.group_by.append(self.parse_expr())
                if not self.eat_punct(","):
                    break
        if self.eat_kw("HAVING"):
            stmt.having = self.parse_expr()
        if self.peek_kw("ORDER"):
            self.advance()
            self.expect_kw("BY")
            while True:
                e = self.parse_expr()
                asc = True
                if self.eat_kw("DESC"):
                    asc = False
                else:
                    self.eat_kw("ASC")
                stmt.order_by.append(ast.OrderByItem(e, asc))
                if not self.eat_punct(","):
                    break
        # LIMIT and OFFSET in either order (reference order.slt uses
        # `offset 2 limit 1`)
        while self.peek_kw("LIMIT", "OFFSET"):
            kw = self.advance().value
            e = self.parse_expr()
            if kw == "LIMIT":
                stmt.limit = e
            else:
                stmt.offset = e
        return stmt

    def parse_with(self) -> ast.SelectStmt:
        """WITH name [(cols)] AS ( select ) [, ...] SELECT ..."""
        self.expect_kw("WITH")
        ctes: list[ast.CommonTableExpr] = []
        while True:
            name = self.expect_ident()
            cols: list[str] = []
            if self.eat_punct("("):
                while True:
                    cols.append(self.expect_ident())
                    if not self.eat_punct(","):
                        break
                self.expect_punct(")")
            self.expect_kw("AS")
            self.expect_punct("(")
            q = self.parse_select()
            self.expect_punct(")")
            ctes.append(ast.CommonTableExpr(name, cols, q))
            if not self.eat_punct(","):
                break
        stmt = self.parse_select()
        stmt.ctes = ctes
        return stmt

    def parse_drop(self) -> ast.DropStmt:
        self.expect_kw("DROP")
        if self.eat_kw("VIEW"):
            kind = "view"
        else:
            self.expect_kw("TABLE")
            kind = "table"
        if_exists = False
        if self.eat_kw("IF"):
            # IF EXISTS
            self.expect_kw("EXISTS")
            if_exists = True
        return ast.DropStmt(kind, self.expect_ident(), if_exists)

    def parse_create(self) -> ast.Statement:
        self.expect_kw("CREATE")
        if self.eat_kw("VIEW"):
            name = self.expect_ident()
            cols: list[str] = []
            if self.eat_punct("("):
                while True:
                    cols.append(self.expect_ident())
                    if not self.eat_punct(","):
                        break
                self.expect_punct(")")
            self.expect_kw("AS")
            return ast.CreateViewStmt(name, cols, self.parse_select())
        self.expect_kw("TABLE")
        name = self.expect_ident()
        if self.eat_kw("AS"):
            return ast.CreateTableStmt(name, as_query=self.parse_select())
        self.expect_punct("(")
        cols: list[ast.ColumnDef] = []
        while True:
            col = self.expect_ident()
            type_tok = self.advance()
            if type_tok.kind not in ("IDENT", "KEYWORD"):
                raise ParserError(f"expected type name, found {type_tok.value!r}")
            unsigned = self.eat_kw("UNSIGNED")
            cols.append(ast.ColumnDef(col, parse_type_name(type_tok.value, unsigned)))
            if not self.eat_punct(","):
                break
        self.expect_punct(")")
        return ast.CreateTableStmt(name, columns=cols)

    def parse_insert(self) -> ast.InsertStmt:
        self.expect_kw("INSERT")
        self.expect_kw("INTO")
        table = self.expect_ident()
        columns: list[str] = []
        if self.eat_punct("("):
            while True:
                columns.append(self.expect_ident())
                if not self.eat_punct(","):
                    break
            self.expect_punct(")")
        if self.eat_kw("VALUES"):
            rows: list[list[ast.Expr]] = []
            while True:
                self.expect_punct("(")
                row: list[ast.Expr] = []
                while True:
                    row.append(self.parse_expr())
                    if not self.eat_punct(","):
                        break
                self.expect_punct(")")
                rows.append(row)
                if not self.eat_punct(","):
                    break
            return ast.InsertStmt(table, columns=columns, values=rows)
        if self.peek_kw("SELECT"):
            return ast.InsertStmt(table, columns=columns, query=self.parse_select())
        raise ParserError("INSERT expects VALUES or SELECT")

    def parse_copy(self) -> ast.CopyStmt:
        self.expect_kw("COPY")
        table = self.expect_ident()
        self.expect_kw("FROM")
        t = self.advance()
        if t.kind != "STRING":
            raise ParserError("COPY FROM expects a file path string")
        options: dict[str, object] = {}
        if self.eat_punct("("):
            while True:
                key_tok = self.advance()
                key = key_tok.value.upper()
                if key == "DELIMITER":
                    v = self.advance()
                    options["delimiter"] = v.value
                elif key == "HEADER":
                    if self.peek_kw("TRUE", "FALSE"):
                        options["header"] = self.advance().value == "TRUE"
                    else:
                        options["header"] = True
                else:
                    raise ParserError(f"unsupported COPY option {key}")
                if not self.eat_punct(","):
                    break
            self.expect_punct(")")
        return ast.CopyStmt(table, t.value, options)

    # ---- table refs ------------------------------------------------------

    def parse_table_refs(self) -> ast.TableRef:
        left = self.parse_joined_table()
        while self.eat_punct(","):
            right = self.parse_joined_table()
            left = ast.JoinRef(left=left, right=right, join_type="cross")
        return left

    def parse_joined_table(self) -> ast.TableRef:
        left = self.parse_table_factor()
        while True:
            join_type: Optional[str] = None
            if self.peek_kw("JOIN", "INNER"):
                self.eat_kw("INNER")
                self.expect_kw("JOIN")
                join_type = "inner"
            elif self.peek_kw("LEFT"):
                self.advance()
                self.eat_kw("OUTER")
                self.expect_kw("JOIN")
                join_type = "left"
            elif self.peek_kw("RIGHT"):
                self.advance()
                self.eat_kw("OUTER")
                self.expect_kw("JOIN")
                join_type = "right"
            elif self.peek_kw("FULL"):
                self.advance()
                self.eat_kw("OUTER")
                self.expect_kw("JOIN")
                join_type = "full"
            elif self.peek_kw("CROSS"):
                self.advance()
                self.expect_kw("JOIN")
                join_type = "cross"
            else:
                return left
            right = self.parse_table_factor()
            cond: Optional[ast.Expr] = None
            if join_type != "cross":
                self.expect_kw("ON")
                cond = self.parse_expr()
            left = ast.JoinRef(
                left=left, right=right, join_type=join_type, condition=cond
            )

    def parse_table_factor(self) -> ast.TableRef:
        if self.eat_punct("("):
            if self.peek_kw("SELECT"):
                q = self.parse_select()
                self.expect_punct(")")
                alias = self._maybe_alias()
                return ast.SubqueryRef(alias=alias, query=q)
            ref = self.parse_table_refs()
            self.expect_punct(")")
            alias = self._maybe_alias()
            if alias is not None:
                ref.alias = alias
            return ref
        t = self.peek()
        if t.kind == "STRING":
            # replacement scan: 'file.csv' [alias]; the default alias is the
            # file stem (reference bind_base_table_ref.rs:100-126 — makes
            # `select t1.a from 'tests/csv/t1.csv'` resolve)
            self.advance()
            alias = self._maybe_alias()
            if alias is None:
                stem = t.value.replace("\\", "/").rsplit("/", 1)[-1]
                alias = stem.rsplit(".", 1)[0] if "." in stem else stem
            return ast.BaseTableRef(
                alias=alias,
                name="read_csv",
                args=[ast.Literal("string", t.value)],
            )
        name = self.expect_ident()
        args = None
        named_args: dict[str, ast.Expr] = {}
        if self.peek_punct("("):
            self.advance()
            args = []
            if not self.peek_punct(")"):
                while True:
                    # named arg: ident => expr
                    if (
                        self.peek().kind in ("IDENT", "KEYWORD")
                        and self.peek(1).kind == "OP"
                        and self.peek(1).value == "=>"
                    ):
                        key = self.advance().value.lower()
                        self.advance()  # =>
                        named_args[key] = self.parse_expr()
                    else:
                        args.append(self.parse_expr())
                    if not self.eat_punct(","):
                        break
            self.expect_punct(")")
        alias = self._maybe_alias()
        return ast.BaseTableRef(alias=alias, name=name, args=args, named_args=named_args)

    def _maybe_alias(self) -> Optional[str]:
        if self.eat_kw("AS"):
            return self.expect_ident()
        if self.peek().kind == "IDENT":
            return self.advance().value
        return None

    # ---- expressions (Pratt) ----------------------------------------------

    def parse_expr(self, min_prec: int = 0) -> ast.Expr:
        left = self.parse_prefix()
        while True:
            t = self.peek()
            # postfix/special predicates bind at comparison precedence
            if _PREC_CMP >= min_prec:
                negated = False
                ahead = 0
                if t.is_kw("NOT") and self.peek(1).kind == "KEYWORD" and self.peek(
                    1
                ).value in ("BETWEEN", "IN", "LIKE"):
                    negated = True
                    ahead = 1
                nxt = self.peek(ahead)
                if nxt.is_kw("BETWEEN"):
                    for _ in range(ahead + 1):
                        self.advance()
                    low = self.parse_expr(_PREC_ADD)
                    self.expect_kw("AND")
                    high = self.parse_expr(_PREC_ADD)
                    left = ast.Between(left, low, high, negated)
                    continue
                if nxt.is_kw("IN"):
                    for _ in range(ahead + 1):
                        self.advance()
                    self.expect_punct("(")
                    if self.peek_kw("SELECT", "WITH"):
                        q = (
                            self.parse_with()
                            if self.peek_kw("WITH")
                            else self.parse_select()
                        )
                        self.expect_punct(")")
                        left = ast.InSubquery(left, q, negated)
                        continue
                    vals = [self.parse_expr()]
                    while self.eat_punct(","):
                        vals.append(self.parse_expr())
                    self.expect_punct(")")
                    left = ast.InList(left, vals, negated)
                    continue
                if nxt.is_kw("LIKE"):
                    for _ in range(ahead + 1):
                        self.advance()
                    pattern = self.parse_expr(_PREC_ADD)
                    left = ast.Like(left, pattern, negated)
                    continue
                if t.is_kw("IS"):
                    self.advance()
                    negated = self.eat_kw("NOT")
                    self.expect_kw("NULL")
                    left = ast.IsNull(left, negated)
                    continue
            prec, op = self._infix_prec(t)
            if op is None or prec < min_prec:
                return left
            self.advance()
            right = self.parse_expr(prec + 1)
            if op == "<>":
                op = "!="
            left = ast.BinaryOp(op, left, right)

    def _infix_prec(self, t: Token):
        if t.kind == "KEYWORD":
            if t.value == "OR":
                return _PREC_OR, "OR"
            if t.value == "AND":
                return _PREC_AND, "AND"
            return 0, None
        if t.kind == "OP":
            if t.value in _CMP_OPS:
                return _PREC_CMP, t.value
            if t.value == "||":
                return _PREC_ADD, "||"
            if t.value in _ADD_OPS:
                return _PREC_ADD, t.value
            if t.value in _MUL_OPS:
                return _PREC_MUL, t.value
        return 0, None

    def parse_prefix(self) -> ast.Expr:
        t = self.peek()
        if t.kind == "NUMBER":
            self.advance()
            if "." in t.value:
                return ast.Literal("float", float(t.value))
            return ast.Literal("int", int(t.value))
        if t.kind == "STRING":
            self.advance()
            return ast.Literal("string", t.value)
        if t.is_kw("TRUE"):
            self.advance()
            return ast.Literal("bool", True)
        if t.is_kw("FALSE"):
            self.advance()
            return ast.Literal("bool", False)
        if t.is_kw("NULL"):
            self.advance()
            return ast.Literal("null", None)
        if t.is_kw("NOT"):
            self.advance()
            if self.peek_kw("EXISTS"):
                e = self.parse_prefix()  # Exists node
                e.negated = True
                return e
            return ast.UnaryOp("NOT", self.parse_expr(_PREC_NOT))
        if t.is_kw("EXISTS"):
            self.advance()
            self.expect_punct("(")
            q = self.parse_select()
            self.expect_punct(")")
            return ast.Exists(q, False)
        if t.is_kw("SUBSTRING"):
            # substring(x FROM a [FOR b]) and substring(x, a[, b])
            self.advance()
            self.expect_punct("(")
            x = self.parse_expr()
            args = [x]
            if self.eat_kw("FROM"):
                args.append(self.parse_expr())
                if self.eat_kw("FOR"):
                    args.append(self.parse_expr())
            else:
                while self.eat_punct(","):
                    args.append(self.parse_expr())
            self.expect_punct(")")
            return ast.FunctionCall("substring", args)
        if t.is_kw("DATE"):
            # DATE '1998-12-01'
            if self.peek(1).kind == "STRING":
                self.advance()
                s = self.advance()
                return ast.TypedString("DATE", s.value)
            # else: DATE used as an identifier
        if t.is_kw("INTERVAL"):
            self.advance()
            mag = self.advance()
            if mag.kind != "STRING":
                raise ParserError("INTERVAL expects a quoted magnitude")
            unit_tok = self.advance()
            unit = unit_tok.value.upper()
            if unit not in ("YEAR", "MONTH", "DAY", "HOUR", "MINUTE", "SECOND"):
                raise ParserError(f"unsupported interval unit {unit_tok.value!r}")
            return ast.IntervalLiteral(mag.value, unit)
        if t.is_kw("CASE"):
            self.advance()
            operand: Optional[ast.Expr] = None
            if not self.peek_kw("WHEN"):
                operand = self.parse_expr()
            conditions: list[ast.Expr] = []
            results: list[ast.Expr] = []
            while self.eat_kw("WHEN"):
                c = self.parse_expr()
                if operand is not None:
                    c = ast.BinaryOp("=", operand, c)
                self.expect_kw("THEN")
                conditions.append(c)
                results.append(self.parse_expr())
            else_result = self.parse_expr() if self.eat_kw("ELSE") else None
            self.expect_kw("END")
            if not conditions:
                raise ParserError("CASE requires at least one WHEN clause")
            return ast.Case(conditions, results, else_result)
        if t.is_kw("EXTRACT"):
            self.advance()
            self.expect_punct("(")
            field_tok = self.advance()
            field = field_tok.value.upper()
            if field not in ("YEAR", "MONTH", "DAY"):
                raise ParserError(f"unsupported EXTRACT field {field_tok.value!r}")
            from_tok = self.advance()
            if not from_tok.is_kw("FROM"):
                raise ParserError("EXTRACT expects FROM")
            e = self.parse_expr()
            self.expect_punct(")")
            return ast.Extract(field, e)
        if t.is_kw("CAST"):
            self.advance()
            self.expect_punct("(")
            e = self.parse_expr()
            self.expect_kw("AS")
            type_tok = self.advance()
            unsigned = self.eat_kw("UNSIGNED")
            self.expect_punct(")")
            return ast.Cast(e, parse_type_name(type_tok.value, unsigned))
        if t.kind == "OP" and t.value in ("-", "+"):
            self.advance()
            operand = self.parse_expr(_PREC_UNARY)
            if t.value == "-":
                # fold negative literals
                if isinstance(operand, ast.Literal) and operand.kind in ("int", "float"):
                    return ast.Literal(operand.kind, -operand.value)
                return ast.UnaryOp("-", operand)
            return operand
        if t.kind == "OP" and t.value == "*":
            self.advance()
            return ast.Star()
        if t.kind == "PUNCT" and t.value == "(":
            self.advance()
            if self.peek_kw("SELECT"):
                q = self.parse_select()
                self.expect_punct(")")
                return ast.ScalarSubquery(q)
            e = self.parse_expr()
            self.expect_punct(")")
            return ast.Parenthesized(e)
        if t.kind == "IDENT" or (
            t.kind == "KEYWORD" and t.value in ("YEAR", "MONTH", "DAY", "DATE", "LEFT", "RIGHT")
        ):
            return self.parse_ident_or_call()
        raise ParserError(f"unexpected token {t.value!r} in expression")

    def parse_ident_or_call(self) -> ast.Expr:
        name = self.advance().value
        # function call
        if self.peek_punct("("):
            self.advance()
            distinct = self.eat_kw("DISTINCT")
            args: list[ast.Expr] = []
            named_args: dict[str, ast.Expr] = {}
            if not self.peek_punct(")"):
                while True:
                    if self.peek_op("*"):
                        self.advance()
                        args.append(ast.Star())
                    elif (
                        self.peek().kind in ("IDENT", "KEYWORD")
                        and self.peek(1).kind == "OP"
                        and self.peek(1).value == "=>"
                    ):
                        key = self.advance().value.lower()
                        self.advance()
                        named_args[key] = self.parse_expr()
                    else:
                        args.append(self.parse_expr())
                    if not self.eat_punct(","):
                        break
            self.expect_punct(")")
            return ast.FunctionCall(name.lower(), args, distinct, named_args)
        parts = [name]
        while self.peek_punct("."):
            self.advance()
            if self.peek_op("*"):
                self.advance()
                return ast.Star(qualifier=".".join(parts))
            parts.append(self.expect_ident())
        return ast.Ident(parts)
