"""The optimizer rule set.

Reimplements the reference's 13 RuleImpl variants (reference
src/optimizer/rules/mod.rs:23-43) over binding-based expressions:

- PushPredicateThroughNonJoin / PushPredicateThroughJoin
  (pushdown_predicates.rs:46,195; per-join-type side pushdown :139-190;
  alias rewrite through projections :222-254 — here generalized: every
  projection output is substituted, not just aliases)
- LimitProjectTranspose / PushLimitThroughJoin / PushLimitIntoTableScan /
  EliminateLimits (pushdown_limit.rs:51,146,227,80; limit+offset fold
  :170-179)
- PushProjectThroughChild / PushProjectIntoTableScan / RemoveNoopOperators
  (column_pruning.rs:112,47,212)
- CollapseProject / CombineFilter (combine_operators.rs:33,72)
- SimplifyCasts (simplification.rs:22 — constant-folds casts)
- PhysicalRewriteRule (physical_rewrite.rs:15) lives in
  sqlrs_tpu_torch/plan/physical.py as the PhysicalPlanGenerator kernel choice.
"""

from __future__ import annotations

from typing import Optional

from sqlrs_tpu_torch.binder.expression import (
    BoundCast,
    BoundColumnRef,
    BoundComparison,
    BoundConjunction,
    BoundConstant,
    BoundExpr,
    ColumnBinding,
    rewrite_expr,
    visit_expr,
)
from sqlrs_tpu_torch.errors import TypeError_
from sqlrs_tpu_torch.optimizer.hep import Pattern, Rule
from sqlrs_tpu_torch.plan.logical import (
    LogicalAggregate,
    LogicalCrossJoin,
    LogicalFilter,
    LogicalGet,
    LogicalJoin,
    LogicalLimit,
    LogicalOperator,
    LogicalOrder,
    LogicalProjection,
)

# ---- expression helpers -----------------------------------------------------


def referenced_bindings(exprs) -> set[ColumnBinding]:
    out: set[ColumnBinding] = set()

    def f(e):
        if isinstance(e, BoundColumnRef):
            out.add(e.binding)

    for e in exprs:
        visit_expr(e, f)
    return out


def substitute_bindings(
    expr: BoundExpr, mapping: dict[ColumnBinding, BoundExpr]
) -> BoundExpr:
    def f(e):
        if isinstance(e, BoundColumnRef):
            return mapping.get(e.binding)
        return None

    return rewrite_expr(expr, f)


def split_conjuncts(expr: BoundExpr) -> list[BoundExpr]:
    if isinstance(expr, BoundConjunction) and expr.op == "AND":
        out: list[BoundExpr] = []
        for a in expr.args:
            out.extend(split_conjuncts(a))
        return out
    return [expr]


def split_disjuncts(expr: BoundExpr) -> list[BoundExpr]:
    if isinstance(expr, BoundConjunction) and expr.op == "OR":
        out: list[BoundExpr] = []
        for a in expr.args:
            out.extend(split_disjuncts(a))
        return out
    return [expr]


def combine_conjuncts(exprs: list[BoundExpr]) -> Optional[BoundExpr]:
    if not exprs:
        return None
    if len(exprs) == 1:
        return exprs[0]
    return BoundConjunction("AND", tuple(exprs))


def _filter_over(exprs: list[BoundExpr], child: LogicalOperator) -> LogicalOperator:
    pred = combine_conjuncts(exprs)
    if pred is None:
        return child
    return LogicalFilter(children=[child], predicate=pred)


def _is(cls):
    return lambda p: isinstance(p, cls)


# ---- predicate pushdown --------------------------------------------------------


class PushPredicateThroughNonJoin(Rule):
    """Filter(Projection) → Projection(Filter) with projection outputs
    substituted into the predicate (handles column aliases; reference
    pushdown_predicates.rs:195-266)."""

    name = "PushPredicateThroughNonJoin"
    pattern = Pattern(_is(LogicalFilter), [Pattern(_is(LogicalProjection))])

    def apply(self, node):
        proj: LogicalProjection = node.children[0]
        mapping = {b: e for b, e in zip(proj.output_bindings(), proj.exprs)}
        new_pred = substitute_bindings(node.predicate, mapping)
        new_filter = LogicalFilter(children=proj.children, predicate=new_pred)
        return LogicalProjection(
            children=[new_filter],
            table_index=proj.table_index,
            exprs=proj.exprs,
            names=proj.names,
            passthrough=proj.passthrough,
        )


class PushPredicateThroughJoin(Rule):
    """Filter(Join) → per-join-type side pushdown (reference
    pushdown_predicates.rs:46-190). Inner: sides pushed, common conjuncts
    merged into the join's residual filter. Left/Right: only the preserved
    side's conjuncts are pushed; the rest stays above."""

    name = "PushPredicateThroughJoin"
    pattern = Pattern(_is(LogicalFilter), [Pattern(_is(LogicalJoin))])

    def apply(self, node):
        join: LogicalJoin = node.children[0]
        if join.join_type not in ("inner", "left", "right", "semi", "anti"):
            return None
        left, right = join.children
        left_b = set(left.output_bindings())
        right_b = set(right.output_bindings())
        conjuncts = split_conjuncts(node.predicate)
        left_f = [
            c for c in conjuncts if referenced_bindings([c]) <= left_b
        ]
        rest = [c for c in conjuncts if c not in left_f]
        right_f = [c for c in rest if referenced_bindings([c]) <= right_b]
        common = [c for c in rest if c not in right_f]
        if not left_f and not right_f and not common:
            return None

        if join.join_type == "inner":
            new_join = LogicalJoin(
                children=[_filter_over(left_f, left), _filter_over(right_f, right)],
                join_type=join.join_type,
                on=join.on,
                filter=combine_conjuncts(
                    ([join.filter] if join.filter is not None else []) + common
                ),
            )
            return new_join
        if join.join_type in ("left", "semi", "anti"):
            # semi/anti emit left rows only: conjuncts above can only
            # reference the left side, and pushing them below is safe
            if not left_f:
                return None
            new_join = LogicalJoin(
                children=[_filter_over(left_f, left), right],
                join_type=join.join_type,
                on=join.on,
                filter=join.filter,
                null_aware=join.null_aware,
            )
            return _filter_over(right_f + common, new_join)
        # right join
        if not right_f:
            return None
        new_join = LogicalJoin(
            children=[left, _filter_over(right_f, right)],
            join_type=join.join_type,
            on=join.on,
            filter=join.filter,
            null_aware=join.null_aware,
        )
        return _filter_over(left_f + common, new_join)


class PushJoinResidualIntoChildren(Rule):
    """Inner join whose residual (ON-clause non-equi) filter has single-side
    conjuncts: push them into the children as Filters. An inner join emits a
    pair iff the residual is TRUE, so pre-filtering a side by its own
    conjuncts is exactly equivalent (Kleene included — a NULL conjunct drops
    the pair either way), shrinks pair expansion, and leaves downstream
    consumers (the fused star-rollup route, the distributed join planner) a
    residual-free join. Inner only: outer joins must preserve unmatched
    rows, and null-aware anti joins define their correlated groups through
    the residual (executor._correlated_group_info). No reference analogue —
    the reference evaluates ON residuals row-at-a-time post-probe
    (hash_join.rs:47-127)."""

    name = "PushJoinResidualIntoChildren"
    pattern = Pattern(_is(LogicalJoin))

    def apply(self, node):
        join: LogicalJoin = node
        if join.join_type != "inner" or join.filter is None:
            return None
        left, right = join.children
        left_b = set(left.output_bindings())
        right_b = set(right.output_bindings())
        conjuncts = split_conjuncts(join.filter)
        left_f = [c for c in conjuncts if referenced_bindings([c]) <= left_b]
        rest = [c for c in conjuncts if c not in left_f]
        right_f = [c for c in rest if referenced_bindings([c]) <= right_b]
        keep = [c for c in rest if c not in right_f]
        if not left_f and not right_f:
            return None
        return LogicalJoin(
            children=[_filter_over(left_f, left), _filter_over(right_f, right)],
            join_type=join.join_type,
            on=join.on,
            filter=combine_conjuncts(keep),
            null_aware=join.null_aware,
        )


class PushSemiJoinThroughInner(Rule):
    """semi/anti(inner(A, B), S) → inner(A, semi/anti(B, S)) when every
    left-side reference of the semi join (its ON keys' left exprs plus any
    residual's inner-side refs) resolves within ONE child of the inner
    join. A semi/anti join is a pure order-preserving row filter on its
    left input, and the inner join's pair emission enumerates pairs
    right-row-major with build-insertion order within a probe row
    (ops/join.py equi_join_pairs), so filtering one side BEFORE the join
    keeps exactly the pairs — in the same relative order — that filtering
    the join output would keep. Pushing shrinks pair expansion (the semi
    filter runs on one table instead of the join output) and leaves
    HashAgg-over-inner-join plans in the shape the fused star-rollup route
    recognizes (Q18: the IN-subquery semi join commutes below the
    lineitem⋈orders join, then below orders⋈customer onto orders). No
    reference analogue — the reference has no semi joins (it binds only
    FROM-alias and scalar subqueries, src/binder/table/subquery.rs:84)."""

    name = "PushSemiJoinThroughInner"
    pattern = Pattern(_is(LogicalJoin))

    def apply(self, node):
        semi: LogicalJoin = node
        if semi.join_type not in ("semi", "anti"):
            return None
        inner = semi.children[0]
        if not isinstance(inner, LogicalJoin) or inner.join_type != "inner":
            return None
        a, b = inner.children
        a_b = set(a.output_bindings())
        b_b = set(b.output_bindings())
        left_refs = set()
        for lk, _ in semi.on:
            left_refs |= referenced_bindings([lk])
        if semi.filter is not None:
            left_refs |= referenced_bindings([semi.filter]) & (a_b | b_b)
        if not left_refs:
            return None
        if left_refs <= a_b:
            side = 0
        elif left_refs <= b_b:
            side = 1
        else:
            return None  # semi condition spans both inner-join sides
        pushed = LogicalJoin(
            children=[inner.children[side], semi.children[1]],
            join_type=semi.join_type,
            on=semi.on,
            filter=semi.filter,
            null_aware=semi.null_aware,
        )
        new_children = [a, b]
        new_children[side] = pushed
        return LogicalJoin(
            children=new_children,
            join_type="inner",
            on=inner.on,
            filter=inner.filter,
            null_aware=inner.null_aware,
        )


def factor_or_common(conjuncts: list[BoundExpr]) -> list[BoundExpr]:
    """OR_i(A ∧ C_i) → A ∧ OR_i(C_i) for conjuncts A common to every
    disjunct (∧ distributes over ∨ in Kleene logic, so NULL semantics are
    preserved). The TPC-H Q19 shape repeats the join equality inside each
    OR clause; without factoring it out, the comma-FROM stays a cross join
    — a trillion-pair disaster at SF1. A disjunct whose remainder is empty
    makes the whole OR implied by A, so the OR drops entirely."""
    out: list[BoundExpr] = []
    for c in conjuncts:
        disjuncts = split_disjuncts(c)
        if len(disjuncts) < 2:
            out.append(c)
            continue
        parts = [split_conjuncts(d) for d in disjuncts]
        rest_reprs = [{repr(y) for y in p} for p in parts[1:]]
        common = [
            x for x in parts[0] if all(repr(x) in rr for rr in rest_reprs)
        ]
        if not common:
            out.append(c)
            continue
        common_reprs = {repr(x) for x in common}
        remains: list[BoundExpr] = []
        or_implied = False
        for p in parts:
            rem = [y for y in p if repr(y) not in common_reprs]
            if not rem:
                or_implied = True
                break
            remains.append(combine_conjuncts(rem))
        out.extend(common)
        if not or_implied:
            out.append(
                remains[0]
                if len(remains) == 1
                else BoundConjunction("OR", tuple(remains))
            )
    return out


class PushPredicateThroughCrossJoin(Rule):
    """Filter(CrossJoin) → per-side pushdown + equality conjuncts linking
    both sides become an INNER equi-join (the comma-FROM TPC-H shape:
    `from a, b where a.x = b.x`). No reference analogue — the reference
    leaves comma joins as filtered cross products; at SF1 scale the
    cartesian intermediate is impossible, so the conversion is load-bearing.

    The converted join SWAPS the children: our hash join emits pairs in
    (probe=right row, build insertion) order, so with children (r, l) the
    emission is left-major — bit-identical to the cross product's
    row order (reference src/executor/join/cross_join.rs:25) under the
    surviving filter."""

    name = "PushPredicateThroughCrossJoin"
    pattern = Pattern(_is(LogicalFilter), [Pattern(_is(LogicalCrossJoin))])

    def apply(self, node):
        cj: LogicalCrossJoin = node.children[0]
        left, right = cj.children
        left_b = set(left.output_bindings())
        right_b = set(right.output_bindings())
        conjuncts = factor_or_common(split_conjuncts(node.predicate))
        left_f, right_f, on_pairs, rest = [], [], [], []
        for c in conjuncts:
            refs = referenced_bindings([c])
            if refs and refs <= left_b:
                left_f.append(c)
            elif refs and refs <= right_b:
                right_f.append(c)
            elif (
                isinstance(c, BoundComparison)
                and c.op == "="
                and referenced_bindings([c.left])
                and referenced_bindings([c.right])
            ):
                lt = referenced_bindings([c.left])
                rt = referenced_bindings([c.right])
                if lt <= left_b and rt <= right_b:
                    on_pairs.append((c.left, c.right))
                elif lt <= right_b and rt <= left_b:
                    on_pairs.append((c.right, c.left))
                else:
                    rest.append(c)
            else:
                rest.append(c)
        if not on_pairs and not left_f and not right_f:
            return None
        new_left = _filter_over(left_f, left)
        new_right = _filter_over(right_f, right)
        if on_pairs:
            # children swapped: probe order = original left-major order
            join = LogicalJoin(
                children=[new_right, new_left],
                join_type="inner",
                on=[(r, l) for l, r in on_pairs],
                filter=None,
            )
            return _filter_over(rest, join)
        if not left_f and not right_f:
            return None
        return _filter_over(
            rest, LogicalCrossJoin(children=[new_left, new_right])
        )


class DeriveImpliedSidePredicates(Rule):
    """Inner join with a disjunctive residual filter (the TPC-H Q19 shape —
    no reference analogue, the reference evaluates residuals row-at-a-time
    post-probe, hash_join.rs:47): every OR clause's single-side conjuncts
    imply a per-side prefilter OR(clause side parts), pushed onto that child
    WITHOUT removing the residual. F = OR_i AND_j(c_ij) implies
    OR_i AND(side conjuncts of clause i) whenever every clause has at least
    one conjunct on that side, so rows failing the derived predicate can
    never produce a surviving pair — the pair set shrinks before pair
    materialization, and the executor folds the derived Filter into the
    join as an alive-mask. Runs in a once-strategy batch (re-deriving on a
    fix-point would wrap the child in the same Filter forever)."""

    name = "DeriveImpliedSidePredicates"
    pattern = Pattern(_is(LogicalJoin))

    def apply(self, node):
        join: LogicalJoin = node
        if join.join_type != "inner" or join.filter is None:
            return None
        disjuncts = split_disjuncts(join.filter)
        if len(disjuncts) < 2:
            return None
        changed = False
        new_children = []
        for child in join.children:
            side_b = set(child.output_bindings())
            parts: Optional[list[BoundExpr]] = []
            for d in disjuncts:
                side_cs = [
                    c
                    for c in split_conjuncts(d)
                    if referenced_bindings([c]) <= side_b
                ]
                if not side_cs:
                    parts = None  # a clause with no conjunct on this side
                    break
                parts.append(combine_conjuncts(side_cs))
            if parts is None:
                new_children.append(child)
                continue
            derived = (
                parts[0]
                if len(parts) == 1
                else BoundConjunction("OR", tuple(parts))
            )
            # idempotence: _try_apply re-fires rules at the same position, so
            # skip a side that already carries exactly the derived prefilter
            if isinstance(child, LogicalFilter) and repr(child.predicate) == repr(
                derived
            ):
                new_children.append(child)
                continue
            new_children.append(
                LogicalFilter(children=[child], predicate=derived)
            )
            changed = True
        if not changed:
            return None
        return LogicalJoin(
            children=new_children,
            join_type=join.join_type,
            on=join.on,
            filter=join.filter,
            null_aware=join.null_aware,
        )


# ---- limit pushdown --------------------------------------------------------------


class LimitProjectTranspose(Rule):
    name = "LimitProjectTranspose"
    pattern = Pattern(_is(LogicalLimit), [Pattern(_is(LogicalProjection))])

    def apply(self, node):
        proj: LogicalProjection = node.children[0]
        new_limit = LogicalLimit(
            children=proj.children, limit=node.limit, offset=node.offset
        )
        return LogicalProjection(
            children=[new_limit],
            table_index=proj.table_index,
            exprs=proj.exprs,
            names=proj.names,
            passthrough=proj.passthrough,
        )


class PushLimitThroughJoin(Rule):
    """Copy limit+offset rows to the preserved side of an outer join
    (reference pushdown_limit.rs:146-225)."""

    name = "PushLimitThroughJoin"
    pattern = Pattern(_is(LogicalLimit), [Pattern(_is(LogicalJoin))])

    def apply(self, node):
        if node.limit is None:
            return None
        join: LogicalJoin = node.children[0]
        count = node.limit + (node.offset or 0)
        side = {"left": 0, "right": 1}.get(join.join_type)
        if side is None:
            return None
        child = join.children[side]
        if isinstance(child, LogicalLimit) and (
            child.limit is not None and child.limit <= count
        ):
            return None  # already pushed
        pushed = LogicalLimit(children=[child], limit=count, offset=None)
        new_children = list(join.children)
        new_children[side] = pushed
        new_join = LogicalJoin(
            children=new_children,
            join_type=join.join_type,
            on=join.on,
            filter=join.filter,
            null_aware=join.null_aware,
        )
        return LogicalLimit(children=[new_join], limit=node.limit, offset=node.offset)


class PushLimitIntoTableScan(Rule):
    name = "PushLimitIntoTableScan"
    pattern = Pattern(_is(LogicalLimit), [Pattern(_is(LogicalGet))])

    def apply(self, node):
        get: LogicalGet = node.children[0]
        if get.bounds is not None:
            return None
        limit = node.limit if node.limit is not None else (1 << 62)
        get2 = LogicalGet(
            table_index=get.table_index,
            function_name=get.function_name,
            bind_data=get.bind_data,
            returned_types=get.returned_types,
            returned_names=get.returned_names,
            projection=get.projection,
            bounds=(node.offset or 0, limit),
        )
        return get2


class EliminateLimits(Rule):
    """Limit(Limit) → one (limits min'ed, offsets summed; reference
    pushdown_limit.rs:80-144)."""

    name = "EliminateLimits"
    pattern = Pattern(_is(LogicalLimit), [Pattern(_is(LogicalLimit))])

    def apply(self, node):
        inner: LogicalLimit = node.children[0]
        if node.limit is not None and inner.limit is not None:
            limit = min(node.limit, inner.limit)
        else:
            limit = node.limit if node.limit is not None else inner.limit
        if node.offset is not None and inner.offset is not None:
            offset = node.offset + inner.offset
        else:
            offset = node.offset if node.offset is not None else inner.offset
        return LogicalLimit(children=inner.children, limit=limit, offset=offset)


# ---- column pruning ---------------------------------------------------------------


_PRUNABLE = (LogicalFilter, LogicalOrder, LogicalLimit, LogicalAggregate,
              LogicalJoin, LogicalCrossJoin)


class PushProjectThroughChild(Rule):
    """Insert pass-through pruning projections below a projection's child so
    scans only materialize referenced columns (reference
    column_pruning.rs:112-210). Critical for HBM footprint."""

    name = "PushProjectThroughChild"
    pattern = Pattern(
        _is(LogicalProjection), [Pattern(lambda p: isinstance(p, _PRUNABLE))]
    )

    def apply(self, node: LogicalProjection):
        child = node.children[0]
        required = referenced_bindings(node.exprs) | referenced_bindings(
            child.expressions()
        )
        changed = False
        new_grandchildren = []
        for g in child.children:
            g_bindings = g.output_bindings()
            needed = [b for b in g_bindings if b in required]
            if len(needed) == len(g_bindings) or not needed:
                new_grandchildren.append(g)
                continue
            if isinstance(g, LogicalProjection) and g.passthrough:
                new_grandchildren.append(g)
                continue
            g_types = g.output_types()
            g_names = g.output_names()
            pos = {b: i for i, b in enumerate(g_bindings)}
            prune = LogicalProjection(
                children=[g],
                table_index=-1,
                exprs=[
                    BoundColumnRef(b, g_types[pos[b]], g_names[pos[b]])
                    for b in needed
                ],
                names=[g_names[pos[b]] for b in needed],
                passthrough=True,
            )
            new_grandchildren.append(prune)
            changed = True
        if not changed:
            return None
        child.children = new_grandchildren
        return node


class PushProjectIntoTableScan(Rule):
    """Projection(Get) → Get with the scan pruned to referenced columns
    (reference column_pruning.rs:47-110). Pass-through pruning projections
    collapse into the scan entirely."""

    name = "PushProjectIntoTableScan"
    pattern = Pattern(_is(LogicalProjection), [Pattern(_is(LogicalGet))])

    def apply(self, node: LogicalProjection):
        get: LogicalGet = node.children[0]
        if get.projection is not None:
            return None
        required = referenced_bindings(node.exprs)
        cols = [
            c
            for c in range(len(get.returned_types))
            if ColumnBinding(get.table_index, c) in required
        ]
        if len(cols) == len(get.returned_types):
            return None
        get2 = LogicalGet(
            table_index=get.table_index,
            function_name=get.function_name,
            bind_data=get.bind_data,
            returned_types=get.returned_types,
            returned_names=get.returned_names,
            projection=cols,
            bounds=get.bounds,
        )
        if node.passthrough and [b.column_index for b in node.output_bindings()] == cols:
            return get2  # projection became the scan itself
        node.children = [get2]
        return node


class RemoveNoopOperators(Rule):
    """Remove identity projections (reference column_pruning.rs:212-260)."""

    name = "RemoveNoopOperators"
    pattern = Pattern(_is(LogicalProjection))

    def apply(self, node: LogicalProjection):
        if not node.passthrough:
            return None
        child = node.children[0]
        if node.output_bindings() == child.output_bindings():
            return child
        return None


# ---- combine operators ----------------------------------------------------------------


class CollapseProject(Rule):
    name = "CollapseProject"
    pattern = Pattern(_is(LogicalProjection), [Pattern(_is(LogicalProjection))])

    def apply(self, node: LogicalProjection):
        inner: LogicalProjection = node.children[0]
        if node.passthrough and not inner.passthrough:
            # a pass-through projection's OUTPUT bindings are its exprs'
            # bindings; substituting through a renaming projection would
            # change them and orphan every ancestor reference (visible with
            # semi/anti join keys pointing at subquery projections)
            return None
        mapping = {b: e for b, e in zip(inner.output_bindings(), inner.exprs)}
        new_exprs = [substitute_bindings(e, mapping) for e in node.exprs]
        return LogicalProjection(
            children=inner.children,
            table_index=node.table_index,
            exprs=new_exprs,
            names=node.names,
            passthrough=node.passthrough
            and all(isinstance(e, BoundColumnRef) for e in new_exprs),
        )


class CombineFilter(Rule):
    name = "CombineFilter"
    pattern = Pattern(_is(LogicalFilter), [Pattern(_is(LogicalFilter))])

    def apply(self, node: LogicalFilter):
        inner: LogicalFilter = node.children[0]
        pred = combine_conjuncts(
            split_conjuncts(node.predicate) + split_conjuncts(inner.predicate)
        )
        return LogicalFilter(children=inner.children, predicate=pred)


# ---- simplification ---------------------------------------------------------------------


class SimplifyCasts(Rule):
    """Constant-fold casts everywhere (reference simplification.rs:22-80)."""

    name = "SimplifyCasts"
    pattern = Pattern(lambda p: True)

    def apply(self, node: LogicalOperator):
        exprs = node.expressions()
        if not exprs:
            return None
        changed = False

        def fold(e):
            nonlocal changed
            if isinstance(e, BoundCast):
                if e.child.return_type() == e.target:
                    changed = True
                    return e.child
                if isinstance(e.child, BoundConstant):
                    try:
                        v = e.child.value.cast_to(e.target, safe=e.try_cast)
                    except TypeError_:
                        return None
                    changed = True
                    return BoundConstant(v)
            return None

        new = [rewrite_expr(e, fold) for e in exprs]
        if not changed:
            return None
        node.set_expressions(new)
        return node


def default_rule_batches():
    from sqlrs_tpu_torch.optimizer.hep import HepBatch, HepBatchStrategy

    return [
        HepBatch(
            "Predicate pushdown",
            HepBatchStrategy.fix_point_topdown(10),
            [
                PushPredicateThroughNonJoin(),
                PushPredicateThroughJoin(),
                PushPredicateThroughCrossJoin(),
                PushJoinResidualIntoChildren(),
                PushSemiJoinThroughInner(),
            ],
        ),
        HepBatch(
            "Implied predicate derivation",
            HepBatchStrategy.once_topdown(),
            [DeriveImpliedSidePredicates()],
        ),
        HepBatch(
            "Limit pushdown",
            HepBatchStrategy.fix_point_topdown(10),
            [
                LimitProjectTranspose(),
                PushLimitThroughJoin(),
                PushLimitIntoTableScan(),
                EliminateLimits(),
            ],
        ),
        HepBatch(
            "Column pruning",
            HepBatchStrategy.fix_point_topdown(10),
            [
                PushProjectThroughChild(),
                PushProjectIntoTableScan(),
                RemoveNoopOperators(),
            ],
        ),
        HepBatch(
            "Combine operators",
            HepBatchStrategy.fix_point_topdown(10),
            [CollapseProject(), CombineFilter()],
        ),
        HepBatch(
            "One-time simplification",
            HepBatchStrategy.once_topdown(),
            [SimplifyCasts()],
        ),
    ]
