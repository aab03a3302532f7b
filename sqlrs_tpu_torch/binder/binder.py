"""Binder: AST → bound logical plan.

Merges the reference's two binder generations into one:
- v2-style table-index bindings, statement surface (create/insert/copy/
  explain/show/describe/select), star expansion, WHERE alias fallback,
  values-list widening (reference src/planner_v2/binder/*)
- v1-only semantics: join trees with equi-key extraction (reference
  src/binder/table/join.rs:161), aggregate planning with the fixed operator
  order Scan→Filter→Agg→Distinct→Order→Project→Limit (reference
  src/planner/select.rs:9-49), uncorrelated scalar subquery → cross join
  rewrite (reference src/binder/table/subquery.rs:84-140).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

from sqlrs_tpu_torch.binder.context import BindContext, Binding
from sqlrs_tpu_torch.binder.expression import (
    BoundAggregate,
    BoundCast,
    BoundColumnRef,
    BoundComparison,
    BoundConjunction,
    BoundConstant,
    BoundExpr,
    BoundFunction,
    BoundNot,
    ColumnBinding,
    collect_aggregates,
    visit_expr,
)
from sqlrs_tpu_torch.errors import BinderError, CatalogError, TypeError_
from sqlrs_tpu_torch.functions.aggregate import AGGREGATE_NAMES, aggregate_return_type
from sqlrs_tpu_torch.parser import ast
from sqlrs_tpu_torch.plan.logical import (
    LogicalAggregate,
    LogicalColumnDataScan,
    LogicalCreateTable,
    LogicalCreateView,
    LogicalCrossJoin,
    LogicalDrop,
    LogicalDummyScan,
    LogicalExplain,
    LogicalExpressionGet,
    LogicalFilter,
    LogicalGet,
    LogicalInsert,
    LogicalJoin,
    LogicalLimit,
    LogicalOperator,
    LogicalOrder,
    LogicalProjection,
)
from sqlrs_tpu_torch.types import Interval, LogicalType, ScalarValue, max_logical_type


@dataclass
class BoundStatement:
    plan: LogicalOperator
    names: list[str]
    types: list[LogicalType]


@dataclass
class _ExprState:
    """Carried through expression binding of one SELECT scope."""

    ctx: BindContext
    alias_map: dict[str, ast.Expr] = field(default_factory=dict)
    # uncorrelated scalar-subquery plans to cross-join into the FROM plan,
    # tagged with the clause they were bound in (select/where/group/having/
    # order) — post-aggregate clauses join ABOVE the aggregate
    subquery_plans: list[tuple[LogicalOperator, str]] = field(default_factory=list)
    # correlated scalar subqueries: (sub_plan, on_pairs(left=inner,
    # right=outer), phase) joined as RIGHT joins preserving outer row order
    scalar_joins: list = field(default_factory=list)
    # table indexes resolved through the parent (outer) context — marks
    # this scope as a correlated subquery
    outer_tables: set[int] = field(default_factory=set)
    phase: str = "select"
    allow_aliases: bool = False


@dataclass
class CorrelationCapture:
    """Out-params of binding a subquery that may reference the outer scope
    (the decorrelation contract; no reference analogue — sqlrs binds only
    FROM-alias and uncorrelated scalar subqueries, src/binder/table/
    subquery.rs:84).

    mode "scalar": equality correlations become injected GROUP BY keys,
    appended to the subquery's output columns; `pairs` then maps
    (outer expr, subquery output key ref) for a single-row-per-key join.
    mode "predicate" (EXISTS / IN): correlations become semi/anti join
    conditions; `pairs` holds equality conditions, `residuals` everything
    else (resolved against the merged left++right join layout)."""

    mode: str  # "scalar" | "predicate"
    pairs: list[tuple[BoundExpr, BoundExpr]] = field(default_factory=list)
    residuals: list[BoundExpr] = field(default_factory=list)
    n_appended: int = 0  # output columns appended beyond the user's select list

    def pairs_as_join_on(self):
        """pairs are (outer, inner); a join with the SUBQUERY as the left
        child wants (left=inner, right=outer)."""
        return [(inner, outer) for outer, inner in self.pairs]


@dataclass
class _SubJoinSpec:
    """A WHERE-level EXISTS / IN-subquery conjunct, lowered to a join."""

    join_type: str  # semi | anti
    plan: LogicalOperator
    on: list[tuple[BoundExpr, BoundExpr]]
    residual: Optional[BoundExpr]
    null_aware: bool = False


class Binder:
    def __init__(
        self,
        db,
        counter: Optional[itertools.count] = None,
        ctes: Optional[dict] = None,
    ) -> None:
        self.db = db
        self._counter = counter if counter is not None else itertools.count()
        # name -> ast.CommonTableExpr, visible to this statement's scopes
        self.ctes: dict = dict(ctes) if ctes else {}

    def next_index(self) -> int:
        return next(self._counter)

    # ---- statement dispatch ------------------------------------------------

    def bind(self, stmt: ast.Statement) -> BoundStatement:
        if isinstance(stmt, ast.SelectStmt):
            return self.bind_select(stmt)
        if isinstance(stmt, ast.CreateTableStmt):
            return self.bind_create_table(stmt)
        if isinstance(stmt, ast.InsertStmt):
            return self.bind_insert(stmt)
        if isinstance(stmt, ast.CopyStmt):
            return self.bind_copy(stmt)
        if isinstance(stmt, ast.ExplainStmt):
            return self.bind_explain(stmt)
        if isinstance(stmt, ast.ShowTablesStmt):
            return self.bind_show_tables()
        if isinstance(stmt, ast.DescribeStmt):
            return self.bind_describe(stmt)
        if isinstance(stmt, ast.CreateViewStmt):
            return self.bind_create_view(stmt)
        if isinstance(stmt, ast.DropStmt):
            return BoundStatement(
                LogicalDrop(kind=stmt.kind, name=stmt.name, if_exists=stmt.if_exists),
                [],
                [],
            )
        raise BinderError(f"unsupported statement {type(stmt).__name__}")

    def bind_create_view(self, stmt: ast.CreateViewStmt) -> BoundStatement:
        # validate now: the view body must bind, and a column list must match
        # its width (errors surface at CREATE VIEW time, not first use)
        sub = Binder(self.db, self._counter, ctes=self.ctes).bind_select(stmt.query)
        if stmt.columns and len(stmt.columns) != len(sub.names):
            raise BinderError(
                f"view {stmt.name!r} column list has {len(stmt.columns)} names "
                f"but the query returns {len(sub.names)} columns"
            )
        op = LogicalCreateView(
            view_name=stmt.name,
            column_names=list(stmt.columns),
            query_ast=stmt.query,
        )
        return BoundStatement(op, [], [])

    # ---- SELECT -------------------------------------------------------------

    def bind_select(
        self,
        stmt: ast.SelectStmt,
        outer_ctx: Optional[BindContext] = None,
        corr: Optional[CorrelationCapture] = None,
    ) -> BoundStatement:
        """With `outer_ctx`, unresolved columns fall back to the enclosing
        scope (correlated subquery); `corr` captures the decorrelation
        products (see CorrelationCapture)."""
        if stmt.ctes:
            self.ctes = dict(self.ctes)
            for cte in stmt.ctes:
                self.ctes[cte.name] = cte
        ctx = BindContext(parent=outer_ctx)
        if stmt.from_table is not None:
            plan = self.bind_table_ref(stmt.from_table, ctx)
        else:
            plan = LogicalDummyScan(table_index=self.next_index())

        state = _ExprState(ctx=ctx)

        # star expansion + select item binding (reference
        # src/planner_v2/binder/statement/bind_select_node.rs:149)
        select_items: list[ast.Expr] = []
        aliases: list[Optional[str]] = []
        for item, alias in zip(stmt.select_list, stmt.aliases):
            if isinstance(item, ast.Star):
                for b in self._star_bindings(ctx, item.qualifier):
                    for ci, name in enumerate(b.names):
                        select_items.append(ast.Ident([b.alias, name]))
                        aliases.append(name)
            else:
                select_items.append(item)
                aliases.append(alias)
        if not select_items:
            raise BinderError("SELECT list is empty")

        # alias map usable by WHERE / GROUP BY / ORDER BY (reference
        # ColumnAliasData, src/planner_v2/binder/statement/bind_select_node.rs:98-131)
        for item, alias in zip(select_items, aliases):
            if alias is not None and alias not in state.alias_map:
                state.alias_map[alias] = item

        state.phase = "select"
        select_exprs = [self.bind_expr(e, state) for e in select_items]
        out_names = [
            a if a is not None else e.name() for a, e in zip(aliases, select_exprs)
        ]

        state.allow_aliases = True
        # ---- WHERE: EXISTS / IN-subquery conjuncts lower to semi/anti joins
        state.phase = "where"
        where_expr: Optional[BoundExpr] = None
        sub_join_specs: list[_SubJoinSpec] = []
        if stmt.where is not None:
            conjs = _flatten_ast_and(stmt.where)
            plain: list[ast.Expr] = []
            for c_ast in conjs:
                tgt, neg = _unwrap_ast_not(c_ast)
                if isinstance(tgt, ast.Exists):
                    sub_join_specs.append(
                        self._bind_exists(tgt, neg ^ tgt.negated, state)
                    )
                elif isinstance(tgt, ast.InSubquery):
                    sub_join_specs.append(
                        self._bind_in_subquery(tgt, neg ^ tgt.negated, state)
                    )
                else:
                    plain.append(c_ast)
            if len(plain) == len(conjs):
                where_expr = self.bind_expr(stmt.where, state)
            elif plain:
                bound = [_to_boolean(self.bind_expr(c, state)) for c in plain]
                where_expr = bound[0] if len(bound) == 1 else BoundConjunction(
                    "AND", tuple(bound)
                )
        state.phase = "group"
        group_exprs = [self.bind_expr(g, state) for g in stmt.group_by]
        state.phase = "having"
        having_expr = self.bind_expr(stmt.having, state) if stmt.having else None
        state.phase = "order"
        order_items = [
            (self.bind_expr(o.expr, state), o.asc) for o in stmt.order_by
        ]

        # ---- correlation split: this SELECT is itself a correlated subquery
        corr_pairs: list[tuple[BoundExpr, BoundExpr]] = []
        corr_residuals: list[BoundExpr] = []
        if corr is not None and where_expr is not None and state.outer_tables:
            local: list[BoundExpr] = []
            for c in _flatten_and(where_expr):
                if _expr_tables(c) & state.outer_tables:
                    kind, a, b = _classify_correlated(c, state.outer_tables)
                    if kind == "pair":
                        corr_pairs.append((a, b))
                    else:
                        corr_residuals.append(c)
                else:
                    local.append(c)
            if local:
                where_expr = local[0] if len(local) == 1 else BoundConjunction(
                    "AND", tuple(local)
                )
            else:
                where_expr = None

        # ---- aggregate presence decides scalar-subquery join placement
        aggs: list[BoundAggregate] = []
        for e in select_exprs + [x for x, _ in order_items] + (
            [having_expr] if having_expr is not None else []
        ):
            for a in collect_aggregates(e):
                if a not in aggs:
                    aggs.append(a)
        agg_present = bool(aggs) or bool(group_exprs)

        # scalar subqueries: uncorrelated become cross joins (reference
        # src/binder/table/subquery.rs:120) — below the aggregate for
        # WHERE/GROUP BY uses, above it for SELECT/HAVING/ORDER BY uses;
        # correlated ones become order-preserving right joins on their
        # injected group keys
        post_agg_plans: list[LogicalOperator] = []
        for sub_plan, phase in state.subquery_plans:
            if agg_present and phase in ("select", "having", "order"):
                post_agg_plans.append(sub_plan)
            else:
                plan = LogicalCrossJoin(children=[plan, sub_plan])
        for sub_plan, on_pairs, phase in state.scalar_joins:
            if agg_present and phase in ("select", "having", "order"):
                raise BinderError(
                    "correlated scalar subquery is only supported in WHERE/GROUP BY"
                )
            plan = LogicalJoin(
                children=[sub_plan, plan],
                join_type="right",
                on=on_pairs,
            )

        if where_expr is not None:
            if collect_aggregates(where_expr):
                raise BinderError("aggregate functions are not allowed in WHERE")
            plan = LogicalFilter(children=[plan], predicate=_to_boolean(where_expr))

        # EXISTS / IN subquery joins apply after the row filter
        for spec in sub_join_specs:
            plan = LogicalJoin(
                children=[plan, spec.plan],
                join_type=spec.join_type,
                on=spec.on,
                filter=spec.residual,
                null_aware=spec.null_aware,
            )

        # ---- correlated scalar: inject equality keys as GROUP BY columns
        inject_positions: list[int] = []  # group position per corr pair
        if corr is not None and corr.mode == "scalar" and (
            corr_pairs or corr_residuals
        ):
            if corr_residuals:
                raise BinderError(
                    "correlated scalar subquery supports only equality correlation"
                )
            if not aggs:
                raise BinderError(
                    "correlated scalar subquery must compute an aggregate"
                )
            for _outer_e, inner_e in corr_pairs:
                for gi, g in enumerate(group_exprs):
                    if repr(g) == repr(inner_e):
                        inject_positions.append(gi)
                        break
                else:
                    inject_positions.append(len(group_exprs))
                    group_exprs.append(inner_e)

        # ---- aggregation ----------------------------------------------------
        if aggs or group_exprs:
            agg_index = self.next_index()
            agg_op = LogicalAggregate(
                children=[plan],
                table_index=agg_index,
                groups=list(group_exprs),
                aggregates=list(aggs),
            )
            plan = agg_op
            mapping: list[tuple[BoundExpr, BoundExpr]] = []
            for i, g in enumerate(group_exprs):
                mapping.append(
                    (g, BoundColumnRef(ColumnBinding(agg_index, i), g.return_type(), g.name()))
                )
            for j, a in enumerate(aggs):
                mapping.append(
                    (
                        a,
                        BoundColumnRef(
                            ColumnBinding(agg_index, len(group_exprs) + j),
                            a.return_type(),
                            a.name(),
                        ),
                    )
                )
            select_exprs = [_replace_subtrees(e, mapping) for e in select_exprs]
            order_items = [(_replace_subtrees(e, mapping), asc) for e, asc in order_items]
            if having_expr is not None:
                having_expr = _replace_subtrees(having_expr, mapping)
            for e in select_exprs + [x for x, _ in order_items]:
                _check_all_resolved_to(e, agg_index, group_exprs, aggs)
            # correlated scalar: expose the injected keys as output columns
            if inject_positions:
                for gi in inject_positions:
                    g = group_exprs[gi]
                    select_exprs.append(
                        BoundColumnRef(
                            ColumnBinding(agg_index, gi), g.return_type(), g.name()
                        )
                    )
                    out_names.append(g.name())
                    corr.n_appended += 1
            for sub_plan in post_agg_plans:
                plan = LogicalCrossJoin(children=[plan, sub_plan])
            if having_expr is not None:
                plan = LogicalFilter(children=[plan], predicate=_to_boolean(having_expr))

        # ---- DISTINCT as group-by-all (reference src/planner/select.rs:29-32)
        if stmt.distinct:
            d_index = self.next_index()
            plan = LogicalAggregate(
                children=[plan], table_index=d_index, groups=list(select_exprs)
            )
            mapping = [
                (
                    e,
                    BoundColumnRef(ColumnBinding(d_index, i), e.return_type(), e.name()),
                )
                for i, e in enumerate(select_exprs)
            ]
            select_exprs = [m for _, m in mapping]
            order_items = [(_replace_subtrees(e, mapping), asc) for e, asc in order_items]

        # ---- ORDER below projection (reference src/planner/select.rs:34)
        if order_items:
            plan = LogicalOrder(children=[plan], items=order_items)

        proj_index = self.next_index()

        # ---- predicate-mode correlation: export the inner columns that the
        # outer semi/anti join conditions reference through this projection
        if corr is not None and corr.mode == "predicate" and (
            corr_pairs or corr_residuals
        ):
            if aggs or group_exprs or stmt.distinct:
                raise BinderError(
                    "correlated EXISTS/IN subquery with aggregation or DISTINCT "
                    "is not supported"
                )
            export_pos: dict[str, int] = {}

            def _ensure_exported(ref: BoundColumnRef) -> BoundColumnRef:
                key = repr(ref)
                if key not in export_pos:
                    for i, se in enumerate(select_exprs):
                        if repr(se) == key:
                            export_pos[key] = i
                            break
                    else:
                        export_pos[key] = len(select_exprs)
                        select_exprs.append(ref)
                        out_names.append(ref.column_name)
                        corr.n_appended += 1
                return BoundColumnRef(
                    ColumnBinding(proj_index, export_pos[key]),
                    ref.type,
                    ref.column_name,
                )

            def _export_inner(e: BoundExpr) -> BoundExpr:
                def f(x):
                    if (
                        isinstance(x, BoundColumnRef)
                        and x.binding.table_index not in state.outer_tables
                    ):
                        return _ensure_exported(x)
                    return None

                from sqlrs_tpu_torch.binder.expression import rewrite_expr

                return rewrite_expr(e, f)

            corr.pairs = [(o, _export_inner(i)) for o, i in corr_pairs]
            corr.residuals = [_export_inner(r) for r in corr_residuals]
        elif corr is not None and corr.mode == "scalar" and inject_positions:
            # pair inner side = this projection's appended key columns
            base = len(select_exprs) - len(inject_positions)
            corr.pairs = [
                (
                    o,
                    BoundColumnRef(
                        ColumnBinding(proj_index, base + k),
                        select_exprs[base + k].return_type(),
                        out_names[base + k],
                    ),
                )
                for k, (o, _i) in enumerate(corr_pairs)
            ]

        plan = LogicalProjection(
            children=[plan], table_index=proj_index, exprs=select_exprs, names=out_names
        )

        # ---- LIMIT/OFFSET (bind-time scalar eval, reference
        # src/planner_v2/binder/statement/bind_result_modifier.rs:41-78)
        if stmt.limit is not None or stmt.offset is not None:
            limit = self._eval_const_int(stmt.limit, state) if stmt.limit else None
            offset = self._eval_const_int(stmt.offset, state) if stmt.offset else None
            plan = LogicalLimit(children=[plan], limit=limit, offset=offset)

        return BoundStatement(plan, out_names, [e.return_type() for e in select_exprs])

    def _star_bindings(self, ctx: BindContext, qualifier: Optional[str]):
        if qualifier is None:
            if not ctx.bindings:
                raise BinderError("SELECT * requires a FROM clause")
            return ctx.bindings
        return [ctx.get(qualifier)]

    def _eval_const_int(self, e: ast.Expr, state: _ExprState) -> int:
        bound = self.bind_expr(e, state)
        if isinstance(bound, BoundCast):
            bound = bound.child
        if not isinstance(bound, BoundConstant) or bound.value.is_null:
            raise BinderError("LIMIT/OFFSET must be a constant integer")
        return int(bound.value.value)

    # ---- FROM ---------------------------------------------------------------

    def bind_table_ref(self, ref: ast.TableRef, ctx: BindContext) -> LogicalOperator:
        if isinstance(ref, ast.BaseTableRef):
            return self.bind_base_table_ref(ref, ctx)
        if isinstance(ref, ast.SubqueryRef):
            return self.bind_subquery_ref(ref, ctx)
        if isinstance(ref, ast.JoinRef):
            return self.bind_join_ref(ref, ctx)
        raise BinderError(f"unsupported table ref {type(ref).__name__}")

    def bind_base_table_ref(
        self, ref: ast.BaseTableRef, ctx: BindContext
    ) -> LogicalOperator:
        if ref.args is None and not ref.named_args:
            # CTEs shadow views shadow tables
            cte = self.ctes.get(ref.name)
            if cte is not None:
                body_ctes = {k: v for k, v in self.ctes.items() if k != ref.name}
                return self._bind_view_body(
                    ref.alias or ref.name, cte.columns, cte.query, ctx, body_ctes
                )
            view = self.db.catalog.try_view(ref.name)
            if view is not None:
                # views bind against CATALOG scope, not the use site's WITH
                # scope — a caller's CTE must not capture table names inside
                # a stored view body
                return self._bind_view_body(
                    ref.alias or ref.name,
                    view.column_names,
                    view.query,
                    ctx,
                    {},
                )
        tidx = self.next_index()
        if ref.args is None and not ref.named_args:
            entry = self.db.catalog.try_table(ref.name)
            if entry is None:
                raise BinderError(f"table {ref.name!r} does not exist")
            fn = self.db.catalog.table_function("seq_scan")
            bind_data = fn.bind(self.db, [ScalarValue.varchar(ref.name)], {})
            alias = ref.alias or ref.name
        else:
            try:
                fn = self.db.catalog.table_function(ref.name)
            except CatalogError as e:
                raise BinderError(str(e))
            args = [self._const_scalar(a) for a in (ref.args or [])]
            named = {k: self._const_scalar(v) for k, v in ref.named_args.items()}
            bind_data = fn.bind(self.db, args, named)
            alias = ref.alias or ref.name
        get = LogicalGet(
            table_index=tidx,
            function_name=fn.name,
            bind_data=bind_data,
            returned_types=list(bind_data.types),
            returned_names=list(bind_data.names),
        )
        ctx.add(Binding(alias, tidx, list(bind_data.names), list(bind_data.types)))
        return get

    def _const_scalar(self, e: ast.Expr) -> ScalarValue:
        bound = self.bind_expr(e, _ExprState(ctx=BindContext()))
        if not isinstance(bound, BoundConstant):
            raise BinderError("table function arguments must be constants")
        return bound.value

    def _bind_view_body(
        self,
        alias: str,
        columns: list[str],
        query: ast.SelectStmt,
        ctx: BindContext,
        ctes: dict,
    ) -> LogicalOperator:
        """Expand a view / CTE reference: re-bind its stored SELECT and wrap
        it in a projection renamed to the declared column list."""
        sub = Binder(self.db, self._counter, ctes=ctes).bind_select(query)
        names = list(columns) if columns else list(sub.names)
        if columns and len(columns) != len(sub.names):
            raise BinderError(
                f"view/CTE {alias!r} declares {len(columns)} columns but its "
                f"query returns {len(sub.names)}"
            )
        tidx = self.next_index()
        proj = LogicalProjection(
            children=[sub.plan],
            table_index=tidx,
            exprs=[
                BoundColumnRef(b, t, n)
                for b, t, n in zip(sub.plan.output_bindings(), sub.types, names)
            ],
            names=names,
        )
        ctx.add(Binding(alias, tidx, names, list(sub.types)))
        return proj

    def bind_subquery_ref(
        self, ref: ast.SubqueryRef, ctx: BindContext
    ) -> LogicalOperator:
        if ref.alias is None:
            # same behavior as Postgres (reference subquery.slt)
            raise BinderError("subquery in FROM must have an alias")
        sub = Binder(self.db, self._counter, ctes=self.ctes).bind_select(ref.query)
        tidx = self.next_index()
        proj = LogicalProjection(
            children=[sub.plan],
            table_index=tidx,
            exprs=[
                BoundColumnRef(b, t, n)
                for b, t, n in zip(
                    sub.plan.output_bindings(), sub.types, sub.names
                )
            ],
            names=list(sub.names),
        )
        ctx.add(Binding(ref.alias, tidx, list(sub.names), list(sub.types)))
        return proj

    def bind_join_ref(self, ref: ast.JoinRef, ctx: BindContext) -> LogicalOperator:
        left = self.bind_table_ref(ref.left, ctx)
        right = self.bind_table_ref(ref.right, ctx)
        if ref.join_type == "cross":
            return LogicalCrossJoin(children=[left, right])
        cond = self.bind_expr(ref.condition, _ExprState(ctx=ctx))
        on, residual = self._extract_join_keys(cond, left, right)
        if not on:
            if ref.join_type == "inner":
                return LogicalFilter(
                    children=[LogicalCrossJoin(children=[left, right])],
                    predicate=_to_boolean(cond),
                )
            raise BinderError(
                f"{ref.join_type} join requires at least one equi-join condition"
            )
        return LogicalJoin(
            children=[left, right],
            join_type=ref.join_type,
            on=on,
            filter=residual,
        )

    def _extract_join_keys(
        self,
        cond: BoundExpr,
        left: LogicalOperator,
        right: LogicalOperator,
    ) -> tuple[list[tuple[BoundExpr, BoundExpr]], Optional[BoundExpr]]:
        """Split ON into equi-key pairs + residual filter, datafusion-style
        (reference src/binder/table/join.rs:161 extract_join_keys)."""
        left_tables = {b.table_index for b in left.output_bindings()}
        right_tables = {b.table_index for b in right.output_bindings()}
        conjuncts = _flatten_and(cond)
        on: list[tuple[BoundExpr, BoundExpr]] = []
        residual: list[BoundExpr] = []
        for c in conjuncts:
            if isinstance(c, BoundComparison) and c.op == "=":
                lt = _expr_tables(c.left)
                rt = _expr_tables(c.right)
                if lt and rt:
                    if lt <= left_tables and rt <= right_tables:
                        on.append((c.left, c.right))
                        continue
                    if lt <= right_tables and rt <= left_tables:
                        on.append((c.right, c.left))
                        continue
            residual.append(c)
        res: Optional[BoundExpr] = None
        if residual:
            res = residual[0] if len(residual) == 1 else BoundConjunction(
                "AND", tuple(residual)
            )
        return on, res

    # ---- expressions ----------------------------------------------------------

    def bind_expr(self, e: ast.Expr, state: _ExprState) -> BoundExpr:
        if isinstance(e, ast.Literal):
            return BoundConstant(_literal_value(e))
        if isinstance(e, ast.TypedString):
            if e.type_name == "DATE":
                return BoundConstant(ScalarValue.date_from_string(e.value))
            raise BinderError(f"unsupported typed literal {e.type_name}")
        if isinstance(e, ast.IntervalLiteral):
            return BoundConstant(_interval_value(e))
        if isinstance(e, ast.Parenthesized):
            return self.bind_expr(e.expr, state)
        if isinstance(e, ast.Ident):
            return self._bind_ident(e, state)
        if isinstance(e, ast.UnaryOp):
            return self._bind_unary(e, state)
        if isinstance(e, ast.BinaryOp):
            return self._bind_binary(e, state)
        if isinstance(e, ast.FunctionCall):
            return self._bind_function(e, state)
        if isinstance(e, ast.Cast):
            child = self.bind_expr(e.expr, state)
            return BoundCast(child, e.type)
        if isinstance(e, ast.ScalarSubquery):
            return self._bind_scalar_subquery(e, state)
        if isinstance(e, ast.Between):
            # x BETWEEN a AND b -> x >= a AND x <= b
            x = self.bind_expr(e.expr, state)
            lo = _bind_comparison(">=", x, self.bind_expr(e.low, state))
            hi = _bind_comparison("<=", x, self.bind_expr(e.high, state))
            out: BoundExpr = BoundConjunction("AND", (lo, hi))
            return BoundNot(out) if e.negated else out
        if isinstance(e, ast.InList):
            x = self.bind_expr(e.expr, state)
            eqs = tuple(
                _bind_comparison("=", x, self.bind_expr(v, state)) for v in e.values
            )
            out = eqs[0] if len(eqs) == 1 else BoundConjunction("OR", eqs)
            return BoundNot(out) if e.negated else out
        if isinstance(e, ast.Like):
            x = self.bind_expr(e.expr, state)
            pat = self.bind_expr(e.pattern, state)
            if x.return_type() not in (LogicalType.VARCHAR, LogicalType.SQLNULL):
                raise BinderError("LIKE requires a varchar operand")
            if not isinstance(pat, BoundConstant) or pat.value.type != LogicalType.VARCHAR:
                raise BinderError("LIKE pattern must be a string constant")
            out = BoundFunction("like", "like", (x, pat), LogicalType.BOOLEAN)
            return BoundNot(out) if e.negated else out
        if isinstance(e, ast.IsNull):
            from sqlrs_tpu_torch.binder.expression import BoundIsNull

            return BoundIsNull(self.bind_expr(e.expr, state), e.negated)
        if isinstance(e, ast.Case):
            return self._bind_case(e, state)
        if isinstance(e, ast.Extract):
            x = self.bind_expr(e.expr, state)
            if x.return_type() not in (LogicalType.DATE, LogicalType.SQLNULL):
                raise BinderError("EXTRACT requires a date operand")
            return BoundFunction(
                "extract", f"extract_{e.field_name.lower()}", (x,), LogicalType.INTEGER
            )
        if isinstance(e, ast.Star):
            raise BinderError("* is only allowed in the SELECT list or count(*)")
        raise BinderError(f"unsupported expression {type(e).__name__}")

    def _bind_case(self, e: ast.Case, state: _ExprState) -> BoundExpr:
        from sqlrs_tpu_torch.binder.expression import BoundCase

        conditions = tuple(_to_boolean(self.bind_expr(c, state)) for c in e.conditions)
        results = [self.bind_expr(r, state) for r in e.results]
        else_r = (
            self.bind_expr(e.else_result, state)
            if e.else_result is not None
            else BoundConstant(ScalarValue.null())
        )
        results.append(else_r)
        common = LogicalType.SQLNULL
        try:
            for r in results:
                common = max_logical_type(common, r.return_type())
        except TypeError_ as ex:
            raise BinderError(str(ex))
        if common == LogicalType.SQLNULL:
            common = LogicalType.INTEGER
        results = tuple(_cast_if_needed(r, common) for r in results)
        return BoundCase(conditions, results, common)

    def _bind_ident(self, e: ast.Ident, state: _ExprState) -> BoundExpr:
        """Resolution order: this scope → select-alias map → enclosing scopes
        (correlated reference; the resolved table index is recorded in
        state.outer_tables so the conjunct can be decorrelated)."""
        if len(e.parts) == 1:
            name = e.parts[0]
            hit = state.ctx.try_resolve_unqualified(name)  # raises on ambiguity
            if hit is None:
                # select-alias fallback for WHERE/GROUP BY/ORDER BY
                target = state.alias_map.get(name)
                if target is not None:
                    return self.bind_expr(target, state)
                c = state.ctx.parent
                while c is not None and hit is None:
                    hit = c.try_resolve_unqualified(name)
                    c = c.parent
                if hit is None:
                    raise BinderError(f"column {name!r} not found")
                state.outer_tables.add(hit[0].table_index)
            b, ci = hit
            return BoundColumnRef(ColumnBinding(b.table_index, ci), b.types[ci], name)
        if len(e.parts) == 2:
            alias, col = e.parts
            c = state.ctx
            depth = 0
            while c is not None:
                b = c.try_get(alias)
                if b is not None:
                    ci = b.try_column(col)
                    if ci is None:
                        raise BinderError(
                            f"column {col!r} not found in table {alias!r}"
                        )
                    if depth > 0:
                        state.outer_tables.add(b.table_index)
                    return BoundColumnRef(
                        ColumnBinding(b.table_index, ci), b.types[ci], col
                    )
                c = c.parent
                depth += 1
            raise BinderError(f"table {alias!r} not found in FROM clause")
        raise BinderError(f"unsupported qualified name {'.'.join(e.parts)}")

    def _bind_unary(self, e: ast.UnaryOp, state: _ExprState) -> BoundExpr:
        child = self.bind_expr(e.operand, state)
        if e.op == "NOT":
            return BoundNot(_to_boolean(child))
        if e.op == "-":
            t = child.return_type()
            if not (t.is_numeric() or t == LogicalType.SQLNULL):
                raise BinderError(f"cannot negate type {t}")
            return BoundFunction("negate", "neg", (child,), t)
        return child

    def _bind_binary(self, e: ast.BinaryOp, state: _ExprState) -> BoundExpr:
        if e.op in ("AND", "OR"):
            left = self.bind_expr(e.left, state)
            right = self.bind_expr(e.right, state)
            args: list[BoundExpr] = []
            for a in (left, right):
                a = _to_boolean(a)
                if isinstance(a, BoundConjunction) and a.op == e.op:
                    args.extend(a.args)
                else:
                    args.append(a)
            return BoundConjunction(e.op, tuple(args))
        left = self.bind_expr(e.left, state)
        right = self.bind_expr(e.right, state)
        if e.op in ("=", "!=", "<", "<=", ">", ">="):
            return _bind_comparison(e.op, left, right)
        if e.op in ("+", "-", "*", "/", "%"):
            return _bind_arithmetic(e.op, left, right)
        if e.op == "||":
            for a in (left, right):
                if a.return_type() not in (LogicalType.VARCHAR, LogicalType.SQLNULL):
                    raise BinderError("|| requires varchar operands")
            return BoundFunction(
                "concat", "concat", (left, right), LogicalType.VARCHAR
            )
        raise BinderError(f"unsupported binary operator {e.op}")

    def _bind_function(self, e: ast.FunctionCall, state: _ExprState) -> BoundExpr:
        name = e.name.lower()
        if name in AGGREGATE_NAMES:
            if name == "count" and (
                not e.args or isinstance(e.args[0], ast.Star)
            ):
                return BoundAggregate("count", None, e.distinct, LogicalType.BIGINT)
            if len(e.args) != 1:
                raise BinderError(f"aggregate {name} takes exactly one argument")
            arg = self.bind_expr(e.args[0], state)
            rt = aggregate_return_type(name, arg.return_type())
            return BoundAggregate(name, arg, e.distinct, rt)
        if name == "substring":
            if not 2 <= len(e.args) <= 3:
                raise BinderError("substring takes 2 or 3 arguments")
            args = tuple(self.bind_expr(a, state) for a in e.args)
            if args[0].return_type() not in (
                LogicalType.VARCHAR,
                LogicalType.SQLNULL,
            ):
                raise BinderError("substring requires a varchar operand")
            for a in args[1:]:
                if not isinstance(a, BoundConstant):
                    raise BinderError(
                        "substring start/length must be constants"
                    )
            return BoundFunction(
                "substring", "substring", args, LogicalType.VARCHAR
            )
        raise BinderError(f"scalar function {name!r} does not exist")

    def _bind_scalar_subquery(
        self, e: ast.ScalarSubquery, state: _ExprState
    ) -> BoundExpr:
        corr = CorrelationCapture("scalar")
        sub = Binder(self.db, self._counter, ctes=self.ctes).bind_select(
            e.query, outer_ctx=state.ctx, corr=corr
        )
        if len(sub.types) - corr.n_appended != 1:
            raise BinderError("scalar subquery must return exactly one column")
        if corr.pairs:
            # correlated: RIGHT join (sub ⟕ outer) on the injected keys keeps
            # the outer row order and yields NULL where the group is empty
            # (SQL: scalar subquery over zero rows is NULL)
            state.scalar_joins.append((sub.plan, list(corr.pairs_as_join_on()), state.phase))
            b0 = sub.plan.output_bindings()[0]
            return BoundColumnRef(b0, sub.types[0], sub.names[0])
        tidx = self.next_index()
        proj = LogicalProjection(
            children=[sub.plan],
            table_index=tidx,
            exprs=[BoundColumnRef(sub.plan.output_bindings()[0], sub.types[0], sub.names[0])],
            names=[sub.names[0]],
        )
        state.subquery_plans.append((proj, state.phase))
        return BoundColumnRef(ColumnBinding(tidx, 0), sub.types[0], sub.names[0])

    def _bind_exists(
        self, e: ast.Exists, negated: bool, state: _ExprState
    ) -> _SubJoinSpec:
        corr = CorrelationCapture("predicate")
        sub = Binder(self.db, self._counter, ctes=self.ctes).bind_select(
            e.query, outer_ctx=state.ctx, corr=corr
        )
        residual = None
        if corr.residuals:
            residual = (
                corr.residuals[0]
                if len(corr.residuals) == 1
                else BoundConjunction("AND", tuple(corr.residuals))
            )
        if not corr.pairs and residual is not None:
            raise BinderError(
                "correlated EXISTS requires at least one equality correlation"
            )
        return _SubJoinSpec(
            "anti" if negated else "semi", sub.plan, list(corr.pairs), residual
        )

    def _bind_in_subquery(
        self, e: ast.InSubquery, negated: bool, state: _ExprState
    ) -> _SubJoinSpec:
        corr = CorrelationCapture("predicate")
        sub = Binder(self.db, self._counter, ctes=self.ctes).bind_select(
            e.query, outer_ctx=state.ctx, corr=corr
        )
        if len(sub.types) - corr.n_appended != 1:
            raise BinderError("IN subquery must return exactly one column")
        outer_e = self.bind_expr(e.expr, state)
        inner0 = BoundColumnRef(
            sub.plan.output_bindings()[0], sub.types[0], sub.names[0]
        )
        cmp = _bind_comparison("=", outer_e, inner0)
        residual = None
        if corr.residuals:
            residual = (
                corr.residuals[0]
                if len(corr.residuals) == 1
                else BoundConjunction("AND", tuple(corr.residuals))
            )
        return _SubJoinSpec(
            "anti" if negated else "semi",
            sub.plan,
            [(cmp.left, cmp.right)] + list(corr.pairs),
            residual,
            null_aware=negated,
        )

    # ---- DDL / DML --------------------------------------------------------------

    def bind_create_table(self, stmt: ast.CreateTableStmt) -> BoundStatement:
        if self.db.catalog.try_table(stmt.name) is not None:
            raise BinderError(f"table {stmt.name!r} already exists")
        if stmt.as_query is not None:
            sub = self.bind_select(stmt.as_query)
            op = LogicalCreateTable(
                children=[sub.plan],
                table_name=stmt.name,
                column_names=list(sub.names),
                column_types=list(sub.types),
            )
            return BoundStatement(op, [], [])
        if not stmt.columns:
            raise BinderError("CREATE TABLE requires at least one column")
        seen = set()
        for c in stmt.columns:
            if c.name in seen:
                raise BinderError(f"duplicate column name {c.name!r}")
            seen.add(c.name)
        op = LogicalCreateTable(
            table_name=stmt.name,
            column_names=[c.name for c in stmt.columns],
            column_types=[c.type for c in stmt.columns],
        )
        return BoundStatement(op, [], [])

    def bind_insert(self, stmt: ast.InsertStmt) -> BoundStatement:
        entry = self.db.catalog.try_table(stmt.table)
        if entry is None:
            raise BinderError(f"table {stmt.table!r} does not exist")
        table_cols = entry.column_names
        if stmt.columns:
            for c in stmt.columns:
                if c not in table_cols:
                    raise BinderError(
                        f"column {c!r} does not exist in table {stmt.table!r}"
                    )
            provided = stmt.columns
        else:
            provided = table_cols
        expected_width = len(provided)

        if stmt.values is not None:
            state = _ExprState(ctx=BindContext())
            rows = []
            for row in stmt.values:
                if len(row) != expected_width:
                    raise BinderError(
                        f"INSERT has {len(row)} expressions but {expected_width} "
                        "target columns"
                    )
                rows.append([self.bind_expr(v, state) for v in row])
            # per-column type widening over the values list (reference
            # src/planner_v2/binder/statement/bind_expression_list_ref.rs:25-60)
            col_types: list[LogicalType] = []
            for ci in range(expected_width):
                t = LogicalType.SQLNULL
                for r in rows:
                    t = max_logical_type(t, r[ci].return_type())
                col_types.append(t)
            child: LogicalOperator = LogicalExpressionGet(
                table_index=self.next_index(),
                expr_types=col_types,
                expr_rows=rows,
            )
        else:
            sub = self.bind_select(stmt.query)
            if len(sub.types) != expected_width:
                raise BinderError(
                    f"INSERT has {len(sub.types)} expressions but {expected_width} "
                    "target columns"
                )
            child = sub.plan

        # map table column -> child output position (None = NULL fill),
        # replicating the reference's reorder exprs (reference
        # src/execution/volcano_executor/insert.rs:22-98)
        index_map: list[Optional[int]] = []
        for c in table_cols:
            index_map.append(provided.index(c) if c in provided else None)
        op = LogicalInsert(
            children=[child],
            table_name=stmt.table,
            expected_types=entry.column_types,
            column_index_map=index_map,
        )
        return BoundStatement(op, [], [])

    def bind_copy(self, stmt: ast.CopyStmt) -> BoundStatement:
        """COPY t FROM 'f.csv' rewrites to INSERT INTO t SELECT * FROM
        read_csv(...) (reference src/planner_v2/binder/statement/bind_copy.rs:10-94)."""
        named: dict[str, ast.Expr] = {}
        if "delimiter" in stmt.options:
            named["delim"] = ast.Literal("string", stmt.options["delimiter"])
        if "header" in stmt.options:
            named["header"] = ast.Literal("bool", stmt.options["header"])
        sel = ast.SelectStmt(
            select_list=[ast.Star()],
            aliases=[None],
            from_table=ast.BaseTableRef(
                name="read_csv",
                args=[ast.Literal("string", stmt.path)],
                named_args=named,
            ),
        )
        return self.bind_insert(ast.InsertStmt(stmt.table, columns=[], query=sel))

    # ---- meta statements ----------------------------------------------------------

    def bind_explain(self, stmt: ast.ExplainStmt) -> BoundStatement:
        sub = self.bind(stmt.stmt)
        op = LogicalExplain(
            children=[sub.plan],
            table_index=self.next_index(),
            stmt_type=type(stmt.stmt).__name__,
        )
        return BoundStatement(op, op.output_names(), op.output_types())

    def bind_show_tables(self) -> BoundStatement:
        """SHOW TABLES → select schema_name, table_name from sqlrs_tables()
        (reference src/planner_v2/binder/statement/bind_show_tables.rs:7-20)."""
        sel = ast.SelectStmt(
            select_list=[ast.Ident(["schema_name"]), ast.Ident(["table_name"])],
            aliases=[None, None],
            from_table=ast.BaseTableRef(name="sqlrs_tables", args=[]),
        )
        return self.bind_select(sel)

    def bind_describe(self, stmt: ast.DescribeStmt) -> BoundStatement:
        """DESCRIBE t → select * from sqlrs_columns() where table_name='t'
        (reference src/planner_v2/binder/statement/bind_explain_table.rs:9-33)."""
        sel = ast.SelectStmt(
            select_list=[ast.Star()],
            aliases=[None],
            from_table=ast.BaseTableRef(name="sqlrs_columns", args=[]),
            where=ast.BinaryOp(
                "=", ast.Ident(["table_name"]), ast.Literal("string", stmt.table)
            ),
        )
        return self.bind_select(sel)


# ---- helpers -------------------------------------------------------------------


def _literal_value(e: ast.Literal) -> ScalarValue:
    if e.kind == "int":
        return ScalarValue.integer_literal(e.value)
    if e.kind == "float":
        return ScalarValue.double(e.value)
    if e.kind == "string":
        return ScalarValue.varchar(e.value)
    if e.kind == "bool":
        return ScalarValue.boolean(e.value)
    if e.kind == "null":
        return ScalarValue.null()
    raise BinderError(f"unknown literal kind {e.kind}")


def _interval_value(e: ast.IntervalLiteral) -> ScalarValue:
    """Interval literal construction matching the reference's unit table
    (reference src/planner_v2/expression_binder.rs:139-170): YEAR/MONTH →
    IntervalYearMonth months; WEEK/DAY/HOUR/MINUTE/SECOND → IntervalDayTime
    as a flat millisecond count."""
    n = int(e.value)
    if e.unit == "YEAR":
        return ScalarValue.interval(months=12 * n)
    if e.unit == "MONTH":
        return ScalarValue.interval(months=n)
    ms = {
        "WEEK": 7 * 24 * 60 * 60 * 1000,
        "DAY": 24 * 60 * 60 * 1000,
        "HOUR": 60 * 60 * 1000,
        "MINUTE": 60 * 1000,
        "SECOND": 1000,
    }.get(e.unit)
    if ms is None:
        raise BinderError(f"unsupported interval unit {e.unit}")
    return ScalarValue.interval(raw_ms=n * ms)


def _cast_if_needed(e: BoundExpr, t: LogicalType) -> BoundExpr:
    if e.return_type() == t:
        return e
    return BoundCast(e, t)


def _to_boolean(e: BoundExpr) -> BoundExpr:
    t = e.return_type()
    if t == LogicalType.BOOLEAN:
        return e
    if t == LogicalType.SQLNULL:
        return BoundCast(e, LogicalType.BOOLEAN)
    raise BinderError(f"expected a boolean expression, got type {t}")


def _bind_comparison(op: str, left: BoundExpr, right: BoundExpr) -> BoundComparison:
    """Cast both sides to their max type (reference
    src/planner_v2/binder/expression/bind_comparison_expression.rs:18-56);
    incomparable types (varchar vs int) raise — `select 'abc' > 10` errors."""
    try:
        common = max_logical_type(left.return_type(), right.return_type())
    except TypeError_ as e:
        raise BinderError(str(e))
    return BoundComparison(op, _cast_if_needed(left, common), _cast_if_needed(right, common))


def _bind_arithmetic(op: str, left: BoundExpr, right: BoundExpr) -> BoundExpr:
    """Overload resolution through the scalar function registry (reference
    src/planner_v2/binder/function_binder.rs:11-125; the registry mirrors
    src/function/scalar/arithmetic_function.rs's overload sets)."""
    from sqlrs_tpu_torch.functions.registry import BUILTIN_SCALAR_FUNCTIONS, resolve_overload

    name = {"+": "add", "-": "subtract", "*": "multiply", "/": "divide", "%": "mod"}[op]
    lt, rt = left.return_type(), right.return_type()
    if lt == LogicalType.SQLNULL and rt == LogicalType.SQLNULL:
        lt = rt = LogicalType.INTEGER  # NULL+NULL types as integer
    ov = resolve_overload(BUILTIN_SCALAR_FUNCTIONS[name], [lt, rt])
    kernel = ov.kernel
    args = (left, right)
    arg_types = ov.arg_types
    if kernel == "date+swap":  # interval + date normalizes to date + interval
        kernel = "date+"
        args = (right, left)
        arg_types = (ov.arg_types[1], ov.arg_types[0])
    args = tuple(_cast_if_needed(a, t) for a, t in zip(args, arg_types))
    if kernel in ("+", "-", "*", "/", "%"):
        kernel = op  # numeric kernels dispatch on the operator symbol
    return BoundFunction(name, kernel, args, ov.return_type)


def _flatten_ast_and(e: ast.Expr) -> list[ast.Expr]:
    if isinstance(e, ast.BinaryOp) and e.op == "AND":
        return _flatten_ast_and(e.left) + _flatten_ast_and(e.right)
    if isinstance(e, ast.Parenthesized):
        inner = _flatten_ast_and(e.expr)
        if len(inner) > 1:
            return inner
    return [e]


def _unwrap_ast_not(e: ast.Expr) -> tuple[ast.Expr, bool]:
    """Strip Parenthesized / NOT layers; returns (core expr, negated)."""
    neg = False
    while True:
        if isinstance(e, ast.Parenthesized):
            e = e.expr
        elif isinstance(e, ast.UnaryOp) and e.op == "NOT":
            e = e.operand
            neg = not neg
        else:
            return e, neg


def _classify_correlated(
    c: BoundExpr, outer_tables: set[int]
) -> tuple[str, Optional[BoundExpr], Optional[BoundExpr]]:
    """Correlated conjunct → ("pair", outer_side, inner_side) when it is an
    equality with one pure-outer and one pure-inner side; else
    ("residual", None, None) — kept as a join residual filter."""
    if isinstance(c, BoundComparison) and c.op == "=":
        lt, rt = _expr_tables(c.left), _expr_tables(c.right)
        if lt and rt:
            if lt <= outer_tables and not (rt & outer_tables):
                return "pair", c.left, c.right
            if rt <= outer_tables and not (lt & outer_tables):
                return "pair", c.right, c.left
    return "residual", None, None


def _flatten_and(e: BoundExpr) -> list[BoundExpr]:
    if isinstance(e, BoundConjunction) and e.op == "AND":
        out: list[BoundExpr] = []
        for a in e.args:
            out.extend(_flatten_and(a))
        return out
    return [e]


def _expr_tables(e: BoundExpr) -> set[int]:
    tables: set[int] = set()

    def f(x):
        if isinstance(x, BoundColumnRef):
            tables.add(x.binding.table_index)

    visit_expr(e, f)
    return tables


def _replace_subtrees(
    e: BoundExpr, mapping: list[tuple[BoundExpr, BoundExpr]]
) -> BoundExpr:
    for src, dst in mapping:
        if e == src:
            return dst
    kids = e.children()
    if not kids:
        return e
    return e.with_children(tuple(_replace_subtrees(k, mapping) for k in kids))


def _check_all_resolved_to(e, agg_index, groups, aggs) -> None:
    """After agg rewrite, any remaining raw ColumnRef would read a
    non-grouped column — not validated by the reference's v1 either, so we
    leave it permissive (no-op hook kept for a stricter mode)."""
    return None
