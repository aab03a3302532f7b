"""Operator executors: physical plan → device batches.

The engine's data plane. Each operator consumes whole device-resident
columnar batches and produces one (pipeline breakers land exactly where the
reference materializes: agg, sort, join build — reference
src/executor/order.rs:14, hash_join.rs:187, hash_agg.rs:32). Operators are
eager torch code on the session's device; grouping and sort dispatch to
sqlrs_tpu_torch/ops/.

The port of sqlrs_tpu/exec/executor.py: scans, projection, filter,
limit, order, aggregation (ungrouped reductions, the histogram path of
ops/mxu_grouped.py, the sorted-run GROUP BY of ops/grouped_agg.py and the
legacy DISTINCT path of ops/grouping.py), the joins (inner, outer, semi,
anti, mark and cross, over ops/join.py), the fused star-rollup route
(exec/fused_route.py) in front of ORDER BY and GROUP BY, and
DDL/DML/explain. Each jitted program of the reference is a program here
(utils/programs.py: one captured CUDA graph a signature on the card): the
mark, semi-join, pair-compaction, outer- and cross-join, residual-join and
ungrouped-aggregate programs below, and those of ops/. An operator that is
not ported raises ExecutorError naming it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sqlrs_tpu_torch.binder.expression import (
    BoundAggregate,
    BoundComparison,
    BoundReference,
    rewrite_expr,
    visit_expr,
)
from sqlrs_tpu_torch.data import Column, DeviceBatch, Schema, SchemaField
from sqlrs_tpu_torch.data.batch import torch_dtype_for, ubigint_key
from sqlrs_tpu_torch.data.strings import NULL_CODE
from sqlrs_tpu_torch.errors import ExecutorError
from sqlrs_tpu_torch.exec.expression_executor import (
    execute_expr,
    execute_exprs_fused,
    execute_predicate,
    execute_scalar,
)
from sqlrs_tpu_torch.ops import elementwise as ew
from sqlrs_tpu_torch.ops.fused import compact_gather_arrays, compact_indices, mask_count
from sqlrs_tpu_torch.ops.grouping import (
    dedup_mask,
    group_ids,
    seg_argmin_by,
    seg_count_valid,
    seg_max,
    seg_min,
    seg_sum,
)
from sqlrs_tpu_torch.ops.join import _and_alive, equi_join_pairs
from sqlrs_tpu_torch.ops.sort import orderable_key, sort_rows
from sqlrs_tpu_torch.plan import physical as P
from sqlrs_tpu_torch.storage.memory import DataTable, null_column
from sqlrs_tpu_torch.types import LogicalType, numpy_dtype_for
from sqlrs_tpu_torch.utils import profiling, programs
from sqlrs_tpu_torch.utils.programs import program

_INT64_MAX = 2**63 - 1


def not_ported(what: str) -> ExecutorError:
    return ExecutorError(f"{what} not yet ported to sqlrs_tpu_torch")


class Executor:
    def __init__(self, db, profile=None) -> None:
        self.db = db
        self.device = db.device
        self.profile = profile  # utils/profiling.QueryProfile | None
        # child batches that a bailed fused-route attempt already executed
        # (exec/fused_route.py), keyed by id(operator)
        self._route_cache: dict[int, DeviceBatch] = {}

    def execute(self, op: P.PhysicalOperator) -> DeviceBatch:
        # one-shot reuse of a route's stashed batch, popped on hit, so that
        # no subtree runs twice and no batch outlives its single consumer
        if self._route_cache:
            hit = self._route_cache.pop(id(op), None)
            if hit is not None:
                return hit
        method = getattr(
            self, "_exec_" + type(op).__name__.removeprefix("Physical"), None
        )
        if method is None:
            raise not_ported(f"operator {type(op).__name__}")
        if self.profile is None and profiling.RECORDER is None:
            return method(op)
        label = op.explain_line()[:60]
        with profiling.operator(self.profile, label, "op:" + label, "operators") as stats:
            out = method(op)
            if stats is not None:
                stats.rows_out = out.num_rows
        return out

    # ---- scans -------------------------------------------------------------

    def _exec_TableScan(self, op: P.PhysicalTableScan) -> DeviceBatch:
        fn = self.db.catalog.table_function(op.function_name)
        return fn.execute(self.db, op.bind_data, op.projection, op.bounds)

    def _exec_DummyScan(self, op: P.PhysicalDummyScan) -> DeviceBatch:
        return DeviceBatch(Schema(()), [], 1, self.device)

    def _exec_ExpressionScan(self, op: P.PhysicalExpressionScan) -> DeviceBatch:
        cols = []
        for ci, t in enumerate(op.expr_types):
            scalars = [
                execute_scalar(row[ci], self.device).cast_to(t)
                for row in op.expr_rows
            ]
            cols.append(Column.from_scalars(t, scalars, device=self.device))
        return DeviceBatch(_schema(op), cols, len(op.expr_rows), self.device)

    def _exec_ColumnDataScan(self, op: P.PhysicalColumnDataScan) -> DeviceBatch:
        return op.batch

    # ---- row-wise operators ---------------------------------------------------

    def _exec_Projection(self, op: P.PhysicalProjection) -> DeviceBatch:
        child = self.execute(op.children[0])
        cols = execute_exprs_fused(op.exprs, child)
        return DeviceBatch(_schema(op), cols, child.num_rows, self.device)

    def _exec_Filter(self, op: P.PhysicalFilter) -> DeviceBatch:
        # one compaction for every size: the predicate and its count, then
        # every column compacted in one program. The reference's three
        # branches (host indices for small batches; a payload-carrying or a
        # permutation flag sort for large narrow or wide ones) all produce
        # these rows in this order; they differ only in what is fast on a
        # TPU.
        child = self.execute(op.children[0])
        return _filter_batch(child, op.predicate)

    def _exec_Limit(self, op: P.PhysicalLimit) -> DeviceBatch:
        out = self._streaming_limit(op)
        if out is not None:
            return out
        child = self.execute(op.children[0])
        offset = op.offset or 0
        start = min(offset, child.num_rows)
        count = child.num_rows - start
        if op.limit is not None:
            count = min(op.limit, count)
        return child.slice(start, count)

    def _streaming_limit(self, op: P.PhysicalLimit) -> DeviceBatch | None:
        """LIMIT k over a pure row-wise pipeline (Projection/Filter chain on
        an unbounded TableScan) executes the scan in geometrically growing
        chunks and stops as soon as offset+k rows survive — the per-batch
        LIMIT windowing + early stop of the reference's pull model
        (reference src/executor/limit.rs:31-70, storage/csv.rs:206-232)
        re-expressed for whole-batch execution: filters/projections compute
        over O(result) rows, never O(table). Returns None when the child
        pipeline isn't streamable (joins, aggregates, ORDER BY need their
        whole input; the reference breaks its pipeline there too)."""
        import dataclasses

        if op.limit is None:
            return None
        need = (op.offset or 0) + op.limit
        chain: list[P.PhysicalOperator] = []
        node = op.children[0]
        while isinstance(node, (P.PhysicalProjection, P.PhysicalFilter)):
            chain.append(node)
            node = node.children[0]
        if not isinstance(node, P.PhysicalTableScan) or node.bounds is not None:
            return None
        chunk = max(1024, 2 * need)
        start_row, parts, got = 0, [], 0
        while got < need or not parts:  # LIMIT 0 still needs the schema
            scan = dataclasses.replace(node, bounds=(start_row, chunk))
            piece = self.execute(scan)
            exhausted = piece.num_rows < chunk
            for c in reversed(chain):
                if isinstance(c, P.PhysicalFilter):
                    piece = _filter_batch(piece, c.predicate)
                else:
                    cols = execute_exprs_fused(c.exprs, piece)
                    piece = DeviceBatch(_schema(c), cols, piece.num_rows, self.device)
            parts.append(piece)
            got += piece.num_rows
            start_row += chunk
            chunk *= 2
            if exhausted:
                break
        batch = parts[0] if len(parts) == 1 else DeviceBatch.concat(parts)
        offset = op.offset or 0
        first = min(offset, batch.num_rows)
        return batch.slice(first, min(op.limit, batch.num_rows - first))

    def _exec_Order(self, op: P.PhysicalOrder) -> DeviceBatch:
        # star-rollup fusion: Order(HashAgg(HashJoin)) with the order key ==
        # the group key == the equi-join key runs as one packed sort
        from sqlrs_tpu_torch.exec.fused_route import try_order_agg_join_route

        routed = try_order_agg_join_route(self, op)
        if routed is not None:
            return routed
        child = self.execute(op.children[0])
        if child.num_rows == 0:
            return child
        key_cols = execute_exprs_fused([e for e, _ in op.items], child)
        keys = [(c, asc) for c, (_, asc) in zip(key_cols, op.items)]
        cols = sort_rows(keys, child.columns)
        return DeviceBatch(child.schema, cols, child.num_rows, self.device)

    # ---- aggregation ------------------------------------------------------------

    def _exec_SimpleAgg(self, op: P.PhysicalSimpleAgg) -> DeviceBatch:
        src, alive = self._fusable_filter_input(op)
        return self._aggregate(op, [], op.aggregates, src, alive)

    def _exec_HashAgg(self, op: P.PhysicalHashAgg) -> DeviceBatch:
        # star-rollup fusion without an ORDER BY: the rowid-packed kernel
        # recovers the first-appearance group order
        from sqlrs_tpu_torch.exec.fused_route import try_agg_join_route

        routed = try_agg_join_route(self, op)
        if routed is not None:
            return routed
        src, alive = self._fusable_filter_input(op)
        return self._aggregate(op, op.groups, op.aggregates, src, alive)

    @staticmethod
    def _distinct_on_sorted_path(op) -> bool:
        """DISTINCT aggregates ride the sorted-run path when grouped and all
        distinct aggs share ONE argument expression (the common SQL shape,
        e.g. Q16's count(distinct ps_suppkey))."""
        d_args = {repr(a.arg) for a in op.aggregates if a.distinct}
        if not d_args:
            return True
        return bool(getattr(op, "groups", None)) and len(d_args) == 1

    def _fusable_filter_input(self, op):
        """Filter directly under an aggregate fuses as an alive-mask: the
        aggregate excludes masked rows itself, skipping the compaction
        entirely. The mask is the raw (keep_data, keep_valid) pair."""
        child_op = op.children[0]
        if (
            isinstance(child_op, P.PhysicalFilter)
            and self._distinct_on_sorted_path(op)
        ):
            src = self.execute(child_op.children[0])
            if src.num_rows > 0:
                (keep,) = execute_exprs_fused([child_op.predicate], src)
                return src, (keep.data, keep.valid)
        return self.execute(child_op), None

    def _aggregate(self, op, groups, aggs, child, alive=None) -> DeviceBatch:
        n = child.num_rows
        if not groups and not any(a.distinct for a in aggs):
            # ungrouped aggregates are plain masked reductions (the
            # reference sends n == 0 to its legacy segment path; the
            # reductions below give the same one row for it)
            distinct_args, arg_keys = _distinct_args(aggs)
            arg_cols = execute_exprs_fused(distinct_args, child)
            slots = [
                arg_keys[repr(a.arg)] if a.arg is not None else None
                for a in aggs
            ]
            out_cols = _reduce_ungrouped_fused(
                aggs, slots, arg_cols, n, alive, self.device
            )
            return DeviceBatch(_schema(op), out_cols, 1, self.device)
        if groups and self._distinct_on_sorted_path(op):
            # sorted-run path: one lexicographic sort, no N-sized scatters
            # (ops/grouped_agg.py; DISTINCT aggs sharing one argument ride
            # the same sort with a value key — multi-argument DISTINCT
            # falls to the legacy dedup path below)
            from sqlrs_tpu_torch.ops.grouped_agg import sorted_grouped_aggregate

            distinct_args, arg_keys = _distinct_args(aggs)
            evaluated = execute_exprs_fused(list(groups) + distinct_args, child)
            key_cols = evaluated[: len(groups)]
            arg_cols = evaluated[len(groups):]
            specs = []
            for a in aggs:
                col = None
                if a.arg is not None:
                    col = arg_cols[arg_keys[repr(a.arg)]]
                specs.append((a.function_name, col, a.return_type(), a.distinct))
            # exact histogram path for small composite group domains
            # (Q1-class rollups): ops/mxu_grouped.py, whose kernel is
            # csrc/mxu_grouped.cu
            from sqlrs_tpu_torch.ops.mxu_grouped import mxu_grouped_aggregate

            mxu = mxu_grouped_aggregate(key_cols, specs, alive=alive)
            if mxu is not None:
                gcols, acols, n_groups = mxu
                log = getattr(self.db, "last_fused_routes", None)
                if log is None:
                    log = self.db.last_fused_routes = []
                log.append("hashagg_mxu")
                return DeviceBatch(_schema(op), gcols + acols, n_groups, self.device)
            gcols, acols, n_groups = sorted_grouped_aggregate(
                key_cols, specs, alive=alive
            )
            return DeviceBatch(_schema(op), gcols + acols, n_groups, self.device)
        # legacy path (ops/grouping.py): multi-argument or ungrouped DISTINCT
        if groups:
            key_cols = [execute_expr(g, child) for g in groups]
            gid, n_groups = group_ids(key_cols)
        else:
            key_cols = []
            gid = torch.zeros(n, dtype=torch.int64, device=self.device)
            n_groups = 1  # ungrouped agg always yields one row
        out_cols: list[Column] = []
        if key_cols:
            rep = torch.full((n_groups,), _INT64_MAX, dtype=torch.int64, device=self.device)
            rep.scatter_reduce_(
                0, gid, torch.arange(n, dtype=torch.int64, device=self.device), "amin"
            )
            out_cols.extend(c.take(rep) for c in key_cols)
        for a in aggs:
            out_cols.append(self._eval_aggregate(a, child, gid, n_groups))
        return DeviceBatch(_schema(op), out_cols, n_groups, self.device)

    def _eval_aggregate(
        self, a: BoundAggregate, batch: DeviceBatch, gid, n_groups: int
    ) -> Column:
        n = batch.num_rows
        dev = self.device
        ones = torch.ones(n_groups, dtype=torch.bool, device=dev)
        if a.arg is None:  # count(*)
            counts = seg_count_valid(
                torch.ones(n, dtype=torch.bool, device=dev), gid, n_groups
            )
            return Column(LogicalType.BIGINT, counts, ones)
        col = execute_expr(a.arg, batch)
        valid = dedup_mask([col], gid) if a.distinct else col.valid
        counts = seg_count_valid(valid, gid, n_groups)
        has_any = counts > 0
        name = a.function_name
        if name == "count":
            return Column(LogicalType.BIGINT, counts, ones)
        if name in ("sum", "avg"):
            acc_t = LogicalType.DOUBLE if name == "avg" else a.type
            data = ew.convert_numeric(col.data, col.type, acc_t)
            s = seg_sum(data, valid, gid, n_groups)
            if name == "avg":
                data = s / torch.clamp(counts, min=1).to(torch.float64)
                return Column(LogicalType.DOUBLE, data, has_any)
            return Column(a.type, s, has_any)
        if name in ("min", "max"):
            if col.type == LogicalType.VARCHAR:
                key, _ = orderable_key(col)
                key = key if name == "min" else -key
                win = seg_argmin_by(key, valid, gid, n_groups)
                win_safe = torch.clamp(win, 0, max(n - 1, 0))
                codes = (
                    col.data[win_safe]
                    if n > 0
                    else torch.full((n_groups,), NULL_CODE, dtype=torch.int32, device=dev)
                )
                return Column(LogicalType.VARCHAR, codes, has_any)
            if col.type == LogicalType.UBIGINT:  # min/max in unsigned order
                key = ubigint_key(col.data)
                if name == "min":
                    data = seg_min(key, valid, gid, n_groups, _INT64_MAX)
                else:
                    data = seg_max(key, valid, gid, n_groups, -_INT64_MAX - 1)
                return Column(col.type, ubigint_key(data), has_any)
            info = (
                np.iinfo(numpy_dtype_for(col.type))
                if col.type.is_integral() or col.type == LogicalType.DATE
                else np.finfo(numpy_dtype_for(col.type))
            )
            if name == "min":
                data = seg_min(col.data, valid, gid, n_groups, info.max)
            else:
                data = seg_max(col.data, valid, gid, n_groups, info.min)
            return Column(col.type, data, has_any)
        raise ExecutorError(f"unknown aggregate {name}")

    # ---- joins ----------------------------------------------------------------

    def _filter_fused_side(self, child_op):
        """(batch, alive) for a join side, folding one Filter level. alive
        is the raw (keep_data, keep_valid) pair — the AND happens inside
        the consumer."""
        if isinstance(child_op, P.PhysicalFilter):
            src = self.execute(child_op.children[0])
            if src.num_rows > 0:
                (keep,) = execute_exprs_fused([child_op.predicate], src)
                return src, (keep.data, keep.valid)
        return self.execute(child_op), None

    def _exec_semi_anti_join(self, op: P.PhysicalHashJoin) -> DeviceBatch:
        """Semi/anti join (decorrelated EXISTS / IN-subquery): emit LEFT rows
        that have (semi) / lack (anti) a surviving match, preserving left
        order. null_aware anti = NOT IN semantics: any NULL inner value ⇒
        empty result; NULL probe values never pass (SQL three-valued logic).

        A Filter on the LEFT child — even under the pure-reference
        Projection that column pruning interposes — folds as an alive
        mask: its rows drop in the SAME compaction as the semi/anti keep,
        instead of paying a full materializing compaction first. Folding
        is restricted to residual-free / single-<>-residual marks (the
        count-based paths), whose semantics ignore dead-row counts;
        null-aware NOT IN keeps the plain path."""
        def _fold_filter_child(child):
            """(batch, alive_pair, remap) with one Filter level folded,
            seeing through a pure-reference pruning Projection; (None,
            None, None) when the shape doesn't apply."""
            rm = None
            node = child
            if (
                isinstance(node, P.PhysicalProjection)
                and len(node.children) == 1
                and all(isinstance(e, BoundReference) for e in node.exprs)
                and isinstance(node.children[0], P.PhysicalFilter)
            ):
                rm = [e.index for e in node.exprs]
                node = node.children[0]
            if isinstance(node, P.PhysicalFilter):
                src = self.execute(node.children[0])
                if src.num_rows > 0:
                    (keep,) = execute_exprs_fused([node.predicate], src)
                    return src, (keep.data, keep.valid), rm
            return None, None, None

        left = right = None
        left_alive = right_alive = None
        remap = remap_r = None
        if not op.null_aware and (
            op.filter is None or self._ne_residual(op) is not None
        ):
            left, left_alive, remap = _fold_filter_child(op.children[0])
            right, right_alive, remap_r = _fold_filter_child(op.children[1])
        if left is None:
            remap = None
            left = self.execute(op.children[0])
        if right is None:
            remap_r = None
            right = self.execute(op.children[1])
        out_schema = _schema(op)
        nl = left.num_rows
        dev = self.device

        def _project(cols):
            return [cols[i] for i in remap] if remap is not None else cols

        def _emit_all():
            """Every LIVE left row survives (anti over empty right, etc.)."""
            if left_alive is None:
                return DeviceBatch(out_schema, _project(left.columns), nl, dev)
            keep = Column(LogicalType.BOOLEAN, left_alive[0], left_alive[1])
            out = left.compact(keep, mask_count(keep.data, keep.valid))
            return DeviceBatch(out_schema, _project(out.columns), out.num_rows, dev)

        def _emit_none():
            z = left.slice(0, 0)
            return DeviceBatch(out_schema, _project(z.columns), 0, dev)

        if nl == 0:
            return _emit_none()
        if right.num_rows == 0:
            # x NOT IN (empty) / NOT EXISTS(empty) keeps every left row —
            # even NULL probe values (SQL: NOT IN over an empty set is true)
            if op.join_type == "anti":
                return _emit_all()
            return _emit_none()
        if not op.on:
            # uncorrelated EXISTS / NOT EXISTS: no equi keys — the inner side
            # is non-empty (the empty case returned above), so EXISTS keeps
            # every left row and NOT EXISTS keeps none
            if op.filter is not None:
                raise ExecutorError(
                    "semi/anti join with a residual filter requires at least "
                    "one equi condition"
                )
            if op.join_type == "semi":
                return _emit_all()
            return _emit_none()

        def _remap_ref(e, rm):
            if rm is None:
                return e
            return rewrite_expr(
                e,
                lambda x: dataclasses.replace(x, index=rm[x.index])
                if isinstance(x, BoundReference)
                else None,
            )

        left_keys = execute_exprs_fused(
            [_remap_ref(l, remap) for l, _ in op.on], left
        )
        right_keys = execute_exprs_fused(
            [_remap_ref(r, remap_r) for _, r in op.on], right
        )
        correlated = len(op.on) > 1 or op.filter is not None
        if (
            op.null_aware
            and op.join_type == "anti"
            and not correlated
        ):
            # uncorrelated NOT IN: any NULL inner VALUE ⇒ no row can be
            # proven absent ⇒ empty result (the reference has no NOT IN;
            # semantics per SQL spec / DuckDB behavior)
            if bool(torch.logical_not(right_keys[0].valid).any()):
                return _emit_none()
        matched = self._mark_matches(
            op, left, right, left_keys, right_keys, remap=remap,
            remap_r=remap_r, right_alive=right_alive,
        )
        if op.null_aware and op.join_type == "anti" and correlated:
            # three-valued NOT IN per correlated group: x NOT IN S(l) is
            # UNKNOWN (row dropped) iff S(l) is non-empty AND (x IS NULL
            # or S(l) contains a NULL value); S(l) empty keeps the row,
            # even for NULL x. op.on[0] is the IN-value pair, op.on[1:]
            # the correlation keys (binder _bind_in_subquery layout).
            nonempty, has_null = self._correlated_group_info(
                op, left, right, left_keys, right_keys
            )
            keep_mask, n_keep = _semi_keep_corr(
                matched, left_keys[0].valid, nonempty, has_null
            )
        else:
            # NULL probe values never pass NOT IN when the inner side is
            # non-empty (null_guard)
            keep_mask, n_keep = _semi_keep(
                matched,
                left_keys[0].valid,
                anti=op.join_type == "anti",
                null_guard=bool(op.null_aware and op.join_type == "anti"),
                alive=left_alive,
            )
        # the mask as data and validity (a AND a = a): nothing to fill
        keep_col = Column(LogicalType.BOOLEAN, keep_mask, keep_mask)
        out = left.compact(keep_col, int(n_keep))
        return DeviceBatch(out_schema, _project(out.columns), out.num_rows, dev)

    @staticmethod
    def _ne_residual(op):
        """(left_col, right_col) when the residual is a single left-column
        <> right-column comparison (the TPC-H Q21 shape), else None —
        static plan inspection, shared by the count-based mark join and
        the left-Filter fold gate."""
        f = op.filter
        if not (
            isinstance(f, BoundComparison)
            and f.op in ("<>", "!=")
            and isinstance(f.left, BoundReference)
            and isinstance(f.right, BoundReference)
        ):
            return None
        w = op.left_width
        ia, ib = f.left.index, f.right.index
        if ia < w <= ib:
            return (ia, ib - w)
        if ib < w <= ia:
            return (ib, ia - w)
        return None

    def _mark_matches(self, op, left, right, left_keys, right_keys,
                      remap=None, remap_r=None, right_alive=None):
        """bool[left rows] (or raw match counts): does a surviving
        (keys + residual) match exist?

        Count-based mark join: per-left-row match counts come straight from
        the join's merged sort (ops/join.match_counts) with NO pair
        expansion. A residual that is a single column <> column comparison
        (the TPC-H Q21 shape, 'exists another lineitem with a DIFFERENT
        supplier') folds into counts too: matched = #key-matches-with-
        valid-b − #(key,b)=(key,a) matches > 0. Everything else falls back
        to pair expansion.

        remap (left-Filter folded through a pruning Projection): maps
        join-layout left column indexes onto the WIDER unprojected batch."""
        from sqlrs_tpu_torch.ops.join import match_counts

        nl = left.num_rows
        if op.filter is None:
            # raw counts: the >0 test folds into the keep mask (right_alive
            # — a folded build-side Filter — ANDs into every key's validity)
            return match_counts(right_keys, left_keys, build_alive=right_alive)
        ne = self._ne_residual(op)
        if ne is not None:
            a_l = left.columns[remap[ne[0]] if remap is not None else ne[0]]
            b_r = right.columns[
                remap_r[ne[1]] if remap_r is not None else ne[1]
            ]
            # a <> b is TRUE only where both sides are valid: restrict the
            # key-match count to valid-b rows (AND any folded build-side
            # Filter), subtract the equal-pair count
            ba = b_r.valid
            if right_alive is not None:
                ba = _and_alive(ba, right_alive)
            counts_all = match_counts(right_keys, left_keys, build_alive=ba)
            counts_eq = match_counts(right_keys + [b_r], left_keys + [a_l],
                                     build_alive=ba)
            return _ne_mark(counts_all, counts_eq, a_l.valid)
        # general residual: expand pairs, filter, scatter
        l_idx, r_idx = equi_join_pairs(left_keys, right_keys)
        if len(l_idx):
            keep = _eval_residual_on_pairs(op.filter, left, right, l_idx, r_idx)
            cnt = mask_count(keep.data, keep.valid)
            l_idx = l_idx[compact_indices(keep.data, keep.valid, cnt)]
        marked = torch.zeros(nl, dtype=torch.bool, device=self.device)
        if not len(l_idx):
            return marked
        return marked.index_fill_(0, l_idx, True)

    def _correlated_group_info(self, op, left, right, left_keys, right_keys):
        """Per-left-row info about the CORRELATED inner subset for null-aware
        NOT IN: (group_nonempty, group_has_null_value) masks (or raw
        counts). The group is defined by the correlation keys (op.on[1:])
        plus the residual filter — NOT the IN-value comparison itself."""
        corr_l, corr_r = left_keys[1:], right_keys[1:]
        nl, nr = left.num_rows, right.num_rows
        dev = self.device
        if corr_l and op.filter is None:
            from sqlrs_tpu_torch.ops.join import match_counts

            # raw counts: the >0 tests fold into _semi_keep_corr
            nonempty = match_counts(corr_r, corr_l)
            null_rows = torch.logical_not(right_keys[0].valid)
            has_null = match_counts(corr_r, corr_l, build_alive=null_rows)
            return nonempty, has_null
        if corr_l:
            gl, gr = equi_join_pairs(corr_l, corr_r)
        else:
            # correlation lives only in the residual filter: every (l, r)
            # candidate pair (rare shape; sizes here are subquery-bounded)
            gl = torch.arange(nl, dtype=torch.int64, device=dev).repeat_interleave(nr)
            gr = torch.arange(nr, dtype=torch.int64, device=dev).repeat(nl)
        if op.filter is not None and len(gl):
            keep = _eval_residual_on_pairs(op.filter, left, right, gl, gr)
            sel = compact_indices(keep.data, keep.valid, mask_count(keep.data, keep.valid))
            gl, gr = gl[sel], gr[sel]
        nonempty = torch.zeros(nl, dtype=torch.bool, device=dev)
        has_null = torch.zeros(nl, dtype=torch.int32, device=dev)
        if len(gl):
            nonempty.index_fill_(0, gl, True)
            r_val_null = torch.logical_not(right_keys[0].valid)
            has_null.scatter_reduce_(0, gl, r_val_null[gr].to(torch.int32), "amax")
        return nonempty, has_null > 0

    def _exec_HashJoin(self, op: P.PhysicalHashJoin) -> DeviceBatch:
        if op.join_type in ("semi", "anti"):
            return self._exec_semi_anti_join(op)
        # INNER joins fuse Filter children as alive-masks folded into the
        # join-key validity: masked rows simply never produce pairs, skipping
        # the compaction entirely (pair emission order is unchanged — probe
        # rows keep their relative order either way)
        if op.join_type == "inner":
            left, l_alive = self._filter_fused_side(op.children[0])
            right, r_alive = self._filter_fused_side(op.children[1])
        else:
            left, l_alive = self.execute(op.children[0]), None
            right, r_alive = self.execute(op.children[1]), None
        left_keys = execute_exprs_fused([l for l, _ in op.on], left)
        right_keys = execute_exprs_fused([r for _, r in op.on], right)
        from sqlrs_tpu_torch.ops.join import expand_gather, expand_pairs, pair_ranges

        pr = pair_ranges(left_keys, right_keys, l_alive, r_alive)
        total = pr[3] if pr is not None else 0
        budget = getattr(self.db, "join_pair_budget", 1 << 25)
        if op.filter is not None and total > budget:
            # bounded-memory path: the full pair set would exceed the cell
            # budget and a residual filter gates the output, so expand +
            # filter in fixed-size chunks (reference analogue: the pull
            # model's per-batch probe, hash_join.rs:207-250, never holds
            # the whole pair set either)
            l_idx, r_idx = self._residual_pairs_chunked(
                op, left, right, pr, budget
            )
        elif op.filter is not None and total > 0:
            # residual over ONLY the referenced columns: expand the pairs,
            # evaluate the filter and count survivors (the only host sync),
            # then compact
            l_idx_u, r_idx_u, kd, cnt = _residual_fused_phase1(
                op.filter, left, right, pr
            )
            cnt = int(cnt)
            if op.join_type == "inner":
                # compaction and the output gather in one program
                return _merge_rows(_schema(op), left, right, l_idx_u, r_idx_u,
                                   keep=(kd, cnt))
            l_idx, r_idx = compact_gather_arrays(kd, kd, (l_idx_u, r_idx_u), cnt)
        elif pr is not None and op.join_type == "inner":
            if total == 0:
                l_idx = r_idx = torch.zeros(0, dtype=torch.int64, device=self.device)
                return _merge_rows(_schema(op), left, right, l_idx, r_idx)
            # phase B and the output gather in one program
            lcols, rcols = expand_gather(pr, left.columns, right.columns)
            return DeviceBatch(_schema(op), lcols + rcols, total, self.device)
        elif pr is not None:
            l_idx, r_idx = expand_pairs(*pr)
        else:
            l_idx = r_idx = torch.zeros(0, dtype=torch.int64, device=self.device)
        if op.join_type in ("left", "right", "full"):
            return _outer_join(_schema(op), left, right, l_idx, r_idx, op.join_type)
        return _merge_rows(_schema(op), left, right, l_idx, r_idx)

    def _residual_pairs_chunked(self, op, left, right, pr, budget: int):
        """Expand + residual-filter join pairs in bounded-memory chunks.

        Peak live cells are O(budget + survivors) instead of O(total pairs):
        probe rows are partitioned so each chunk's pair span fits budget
        (+ one row's overhang), each chunk expands into a B2-sized block,
        the residual filter compacts it, and the chunks' survivors
        concatenate in unchanged probe-major order. The single-device
        counterpart of the reference's per-batch probe stream
        (hash_join.rs:207-250), which never holds the full pair set."""
        starts, counts, order, total = pr
        dev = self.device
        nr = counts.shape[0]
        maxc = int(counts.max())
        B2 = budget + maxc
        n_chunks = -(-total // budget)
        span_start = torch.cumsum(counts, 0) - counts
        bounds = torch.searchsorted(
            span_start,
            torch.arange(n_chunks + 1, dtype=torch.int64, device=dev) * budget,
        ).cpu().numpy()
        bounds[-1] = nr
        W = int(max(int(bounds[k + 1] - bounds[k]) for k in range(n_chunks)))
        W = max(W, 1)
        pad = torch.zeros(W, dtype=counts.dtype, device=dev)
        starts_p = torch.cat([starts, pad])
        counts_p = torch.cat([counts, pad])

        parts_l, parts_r = [], []
        for k in range(n_chunks):
            r0, r1 = int(bounds[k]), int(bounds[k + 1])
            if r1 <= r0:
                continue
            l_c, r_c, valid = _expand_pair_chunk(
                starts_p, counts_p, order, r0, r1 - r0, W, B2
            )
            keep = _eval_residual_on_pairs(op.filter, left, right, l_c, r_c)
            kd = keep.data & keep.valid & valid
            cnt = int(kd.sum())
            if cnt == 0:
                continue
            sel = compact_indices(kd, kd, cnt)
            parts_l.append(l_c[sel])
            parts_r.append(r_c[sel])
        if not parts_l:
            z = torch.zeros(0, dtype=torch.int64, device=dev)
            return z, z
        return torch.cat(parts_l), torch.cat(parts_r)

    def _exec_CrossJoin(self, op: P.PhysicalCrossJoin) -> DeviceBatch:
        left = self.execute(op.children[0])
        right = self.execute(op.children[1])
        nl, nr = left.num_rows, right.num_rows
        # left-major emission (reference src/executor/join/cross_join.rs:25),
        # the pair indices and the gather in one program (_cross_join_jit)
        return _merge_rows(_schema(op), left, right, None, None, cross=(nl, nr))

    # ---- DDL / DML ---------------------------------------------------------------

    def _exec_CreateTable(self, op: P.PhysicalCreateTable) -> DeviceBatch:
        from sqlrs_tpu_torch.catalog.catalog import ColumnDefinition

        storage = DataTable(op.column_names, op.column_types)
        self.db.catalog.create_table(
            op.table_name,
            [ColumnDefinition(n, t) for n, t in zip(op.column_names, op.column_types)],
            storage,
            schema=op.schema_name,
        )
        if op.children:  # CREATE TABLE AS
            batch = self.execute(op.children[0])
            storage.append_batch(batch)
        return self._empty_result()

    def _exec_Insert(self, op: P.PhysicalInsert) -> DeviceBatch:
        child = self.execute(op.children[0])
        entry = self.db.catalog.table(op.table_name)
        cols: list[Column] = []
        for ti, t in enumerate(op.expected_types):
            src = op.column_index_map[ti]
            if src is None:
                data, valid = null_column(t, child.num_rows)
                cols.append(Column.from_numpy(t, data, valid, device=self.device))
            else:
                cols.append(ew.cast_column(child.columns[src], t))
        entry.storage.append_batch(
            DeviceBatch(entry.storage.schema, cols, child.num_rows, self.device)
        )
        return self._empty_result()

    def _exec_CreateView(self, op: P.PhysicalCreateView) -> DeviceBatch:
        self.db.catalog.create_view(
            op.view_name, op.column_names, op.query_ast, schema=op.schema_name
        )
        return self._empty_result()

    def _exec_Drop(self, op: P.PhysicalDrop) -> DeviceBatch:
        from sqlrs_tpu_torch.errors import CatalogError

        try:
            if op.kind == "view":
                self.db.catalog.drop_view(op.name, schema=op.schema_name)
            else:
                self.db.catalog.drop_table(op.name, schema=op.schema_name)
        except CatalogError:
            if not op.if_exists:
                raise
        return self._empty_result()

    def _exec_Explain(self, op: P.PhysicalExplain) -> DeviceBatch:
        from sqlrs_tpu_torch.types import ScalarValue

        keys = list(op.plan_strings.keys())
        vals = [op.plan_strings[k] for k in keys]
        cols = [
            Column.from_scalars(
                LogicalType.VARCHAR,
                [ScalarValue.varchar(k) for k in keys],
                device=self.device,
            ),
            Column.from_scalars(
                LogicalType.VARCHAR,
                [ScalarValue.varchar(v) for v in vals],
                device=self.device,
            ),
        ]
        return DeviceBatch(_schema(op), cols, len(keys), self.device)

    def _empty_result(self) -> DeviceBatch:
        return DeviceBatch(Schema(()), [], 0, self.device)


def _schema(op: P.PhysicalOperator) -> Schema:
    return Schema(tuple(SchemaField(n, t) for n, t in zip(op.names, op.types)))


def _distinct_args(aggs) -> tuple[list, dict[str, int]]:
    """The aggregates' distinct argument expressions, and the slot of each
    by repr: identical arguments are evaluated once and share one Column."""
    args: list = []
    keys: dict[str, int] = {}
    for a in aggs:
        if a.arg is not None and repr(a.arg) not in keys:
            keys[repr(a.arg)] = len(args)
            args.append(a.arg)
    return args, keys


def _reduce_one_ungrouped(a, col, n: int, alive, device) -> Column:
    rt = a.return_type()
    ones = torch.ones(1, dtype=torch.bool, device=device)
    if col is None:  # count(*)
        if alive is None:
            data = torch.full((1,), n, dtype=torch.int64, device=device)
        else:
            data = alive.sum(dtype=torch.int64).reshape(1)
        return Column(LogicalType.BIGINT, data, ones)
    ok = col.valid if alive is None else (col.valid & alive)
    cnt = ok.sum(dtype=torch.int64)
    has = (cnt > 0).reshape(1)
    name = a.function_name
    if name == "count":
        return Column(LogicalType.BIGINT, cnt.reshape(1), ones)
    if name in ("sum", "avg"):
        acc_t = LogicalType.DOUBLE if name == "avg" else rt
        data = ew.convert_numeric(col.data, col.type, acc_t)
        s = torch.where(ok, data, torch.zeros_like(data)).sum(
            dtype=torch_dtype_for(acc_t)
        )
        if name == "avg":
            s = s / torch.clamp(cnt, min=1).to(torch.float64)
        return Column(rt, s.reshape(1).to(torch_dtype_for(rt)), has)
    if name in ("min", "max"):
        if col.type == LogicalType.VARCHAR:
            key, _ = orderable_key(col)
            big = torch.iinfo(key.dtype).max
            k = torch.where(ok, key, big if name == "min" else -big)
            if n == 0:
                codes = torch.full((1,), -1, dtype=col.data.dtype, device=device)
                return Column(LogicalType.VARCHAR, codes, has)
            i = torch.argmin(k) if name == "min" else torch.argmax(k)
            # a 1-element index tensor gathers on the device (a 0-dim one
            # would be read on the host as a Python index)
            return Column(LogicalType.VARCHAR, col.data[i.reshape(1)], has)
        if col.type == LogicalType.UBIGINT:  # min/max in unsigned order
            key = ubigint_key(col.data)
            sent = _INT64_MAX if name == "min" else -_INT64_MAX - 1
            v = torch.where(ok, key, torch.full_like(key, sent))
            r = (v.min() if name == "min" else v.max()) if n else torch.tensor(sent)
            return Column(rt, ubigint_key(r.reshape(1).to(device)), has)
        dt = col.data.dtype
        if col.type.is_float():
            sent = float("inf") if name == "min" else float("-inf")
        else:
            ii = torch.iinfo(dt) if dt != torch.bool else None
            if ii is None:
                sent = name == "min"
            else:
                sent = ii.max if name == "min" else ii.min
        v = torch.where(ok, col.data, torch.full_like(col.data, sent))
        if n == 0:
            r = torch.full((1,), sent, dtype=dt, device=device)
        else:
            r = (v.min() if name == "min" else v.max()).reshape(1)
        return Column(rt, r.to(torch_dtype_for(rt)), has)
    raise ExecutorError(f"unknown aggregate {name}")


def _filter_batch(batch: DeviceBatch, predicate) -> DeviceBatch:
    """The rows of `batch` where `predicate` holds, in order: the predicate
    program with its count (one host read), then one compaction program."""
    keep, cnt = execute_predicate(predicate, batch)
    if cnt == batch.num_rows:
        return batch
    return batch.compact(keep, cnt)


def _reduce_ungrouped_fused(aggs, slots, arg_cols, n: int, alive, device):
    """All ungrouped aggregates of a SimpleAgg as one program (the
    reference's `_UNGROUPED_FUSED_CACHE` program, exec/executor.py:1188),
    keyed by the aggregates' reprs. A VARCHAR min/max whose rank table is
    not on the device yet runs eagerly (the table builds on the host)."""
    from sqlrs_tpu_torch.data.strings import GLOBAL_STRINGS

    types = tuple(c.type for c in arg_cols)

    def body(datas, valids, alive):
        if isinstance(alive, tuple):  # raw (keep_data, keep_valid) pair
            alive = torch.logical_and(alive[0], alive[1])
        cols = [Column(t, d, v) for t, d, v in zip(types, datas, valids)]
        outs = [
            _reduce_one_ungrouped(a, cols[s] if s is not None else None, n, alive, device)
            for a, s in zip(aggs, slots)
        ]
        return tuple((c.type, c.data, c.valid) for c in outs)

    args = (tuple(c.data for c in arg_cols), tuple(c.valid for c in arg_cols), alive)
    if LogicalType.VARCHAR in types and not GLOBAL_STRINGS.has_device_ranks(device):
        programs.route_eagerly("rank table build")
        out = body(*args)
    else:
        out = programs.run(
            "exec.executor._reduce_ungrouped_fused", body, args,
            (tuple(repr(a) for a in aggs), tuple(slots), types, n),
        )
    return [Column(t, d, v) for t, d, v in out]


# ---- join helpers ---------------------------------------------------------
# The reference's join programs (exec/executor.py:958-1420), each a program
# here: _ne_mark, _semi_keep, _semi_keep_corr, the residual join's
# _expand_pair_chunk and _residual_fused_phase1, the pair gathers
# (_gather_pairs_jit, _compact_gather_pairs_jit), the outer join's
# _unmatched_masks and _outer_join_tail, and _cross_join.


@program
def _expand_pair_chunk(starts_p, counts_p, order, r0: int, nrows: int, W: int, B2: int):
    """One bounded chunk of pair expansion: W probe rows in, B2 padded pairs
    out, with a validity mask. `starts_p`/`counts_p` are W-padded so the
    W-row window never runs off the end. A dummy row W takes the B2 - tot
    padding pairs, so every repeat has its exact output size on the host."""
    dev = counts_p.device
    s = starts_p[r0 : r0 + W]
    c = counts_p[r0 : r0 + W]
    c = torch.where(torch.arange(W, device=dev) < nrows, c, 0)
    tot = c.sum()
    c_ext = torch.cat([c, (B2 - tot).reshape(1)])
    s_ext = torch.cat([s, torch.zeros(1, dtype=s.dtype, device=dev)])
    seq = torch.arange(B2, dtype=torch.int64, device=dev)
    loc = torch.repeat_interleave(
        torch.arange(W + 1, dtype=torch.int64, device=dev), c_ext, output_size=B2
    )
    base = torch.repeat_interleave(torch.cumsum(c_ext, 0) - c_ext, c_ext, output_size=B2)
    st = torch.repeat_interleave(s_ext, c_ext, output_size=B2)
    valid = seq < tot
    pos = seq - base + st
    l_idx = order[torch.clamp(pos, 0, order.shape[0] - 1)]
    r_idx = torch.clamp(r0 + loc, 0, counts_p.shape[0] - W - 1)  # < real nr
    return l_idx, r_idx, valid


def _residual_subplan(filter_expr, left, right):
    """(expr2, sub_fields, l_pick, r_pick): the filter rewritten against the
    compacted layout of ONLY the columns it references, plus per-side column
    index lists (the filter is positional against left++right)."""
    refs: set[int] = set()

    def _collect(e):
        if isinstance(e, BoundReference):
            refs.add(e.index)

    visit_expr(filter_expr, _collect)
    order = sorted(refs)
    remap = {old: new for new, old in enumerate(order)}

    def _remap(e):
        if isinstance(e, BoundReference):
            return BoundReference(remap[e.index], e.type, e.column_name)
        return None

    expr2 = rewrite_expr(filter_expr, _remap)
    nl = len(left.columns)
    all_fields = tuple(left.schema.fields) + tuple(right.schema.fields)
    sub_fields = tuple(all_fields[i] for i in order)
    l_pick = [i for i in order if i < nl]
    r_pick = [i - nl for i in order if i >= nl]
    return expr2, sub_fields, l_pick, r_pick


def _residual_fused_phase1(filter_expr, left, right, pr):
    """Pair expansion + residual evaluation + survivor count in one program
    (the reference's `_RESIDUAL_FUSED_CACHE` phase1): returns (l_idx,
    r_idx, keep, count) with the count a device scalar. Only the columns
    the filter references are gathered. A filter that would read the host
    (exec/expression_executor._host_work) runs eagerly."""
    from sqlrs_tpu_torch.exec.expression_executor import _host_work
    from sqlrs_tpu_torch.ops.join import _expand_body

    starts, counts, order_arr, total = pr
    expr2, sub_fields, l_pick, r_pick = _residual_subplan(filter_expr, left, right)
    n_l = len(l_pick)

    def body(starts, counts, order_arr, l_datas, l_valids, r_datas, r_valids):
        l_idx, r_idx = _expand_body(starts, counts, order_arr, total)
        cols = [
            Column(f.type, d[i], v[i])
            for f, d, v, i in zip(
                sub_fields,
                l_datas + r_datas,
                l_valids + r_valids,
                [l_idx] * n_l + [r_idx] * (len(sub_fields) - n_l),
            )
        ]
        keep = execute_expr(expr2, DeviceBatch(Schema(sub_fields), cols, total, l_idx.device))
        kd = torch.logical_and(keep.data, keep.valid)
        return l_idx, r_idx, kd, kd.sum()

    args = (
        starts, counts, order_arr,
        tuple(left.columns[i].data for i in l_pick), tuple(left.columns[i].valid for i in l_pick),
        tuple(right.columns[i].data for i in r_pick), tuple(right.columns[i].valid for i in r_pick),
    )
    why = _host_work([expr2], left.device)
    if why is not None:
        programs.route_eagerly(why)
        return body(*args)
    return programs.run(
        "exec.executor._residual_fused_phase1", body, args,
        (repr(expr2), tuple(f.type for f in sub_fields), n_l, total),
    )


@program
def _ne_mark(counts_all, counts_eq, a_valid):
    """Count-based `a <> b` mark: a key match with a DIFFERENT b exists."""
    return a_valid & (counts_all - counts_eq > 0)


def _as_bool_mark(matched):
    # _mark_matches hands back raw match COUNTS where it can
    return matched if matched.dtype == torch.bool else matched > 0


@program
def _semi_keep(matched, x_valid, anti: bool, null_guard: bool, alive=None):
    """Semi/anti keep mask + survivor count. `alive` is a fused-Filter
    (keep_data, keep_valid) pair from the LEFT child: dead rows drop here,
    in the same compaction as the semi/anti keep itself."""
    m = _as_bool_mark(matched)
    keep = torch.logical_not(m) if anti else m
    if null_guard:
        keep = keep & x_valid
    if alive is not None:
        keep = keep & torch.logical_and(alive[0], alive[1])
    return keep, keep.sum()


@program
def _semi_keep_corr(matched, x_valid, nonempty, has_null):
    """Correlated null-aware NOT IN keep mask + count (anti only)."""
    unknown = _as_bool_mark(nonempty) & (
        torch.logical_not(x_valid) | _as_bool_mark(has_null)
    )
    keep = torch.logical_not(_as_bool_mark(matched)) & torch.logical_not(unknown)
    return keep, keep.sum()


@program
def _unmatched_masks(l_idx, r_idx, nl: int, nr: int, jt: str):
    """Per side of an outer join, the rows no pair matched, and both counts
    in one vector (fetched together)."""
    dev = l_idx.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    um_l = um_r = None
    n_l = n_r = zero
    if jt in ("right", "full"):
        um_r = torch.ones(nr, dtype=torch.bool, device=dev).index_fill_(0, r_idx, False)
        n_r = um_r.sum()
    if jt in ("left", "full"):
        um_l = torch.ones(nl, dtype=torch.bool, device=dev).index_fill_(0, l_idx, False)
        n_l = um_l.sum()
    return um_l, um_r, torch.stack([n_l, n_r])


def _outer_pair_indices(l_idx, r_idx, um_l, um_r, n_um_l: int, n_um_r: int, jt: str):
    """The pair indices of a left/right/full join, -1 on a NULL side:
    unmatched right rows interleave at their probe positions (stable sort
    by probe row — reference hash_join.rs:73-121), unmatched left rows
    append at the end (hash_join.rs:294-322)."""
    all_l, all_r = l_idx, r_idx
    if jt in ("right", "full"):
        um_r = compact_indices(um_r, um_r, n_um_r)
        all_l = torch.cat([all_l, torch.full_like(um_r, -1)])
        all_r = torch.cat([all_r, um_r])
        o = torch.argsort(all_r, stable=True)
        all_r, all_l = all_r[o], all_l[o]
    if jt in ("left", "full"):
        um_l = compact_indices(um_l, um_l, n_um_l)
        all_l = torch.cat([all_l, um_l])
        all_r = torch.cat([all_r, torch.full_like(um_l, -1)])
    return all_l, all_r


def _gather_side(datas, valids, fills, idx, nullable: bool, empty: bool):
    """One side's output columns gathered by idx; with `nullable`, an index
    of -1 is a NULL row (valid False and null_column's fill value), and an
    empty side is all NULL rows (where the reference's gather from an empty
    array fails)."""
    if not nullable:
        return tuple(d[idx] for d in datas), tuple(v[idx] for v in valids)
    if empty:
        return (
            tuple(torch.full(idx.shape, f, dtype=d.dtype, device=idx.device)
                  for d, f in zip(datas, fills)),
            tuple(torch.zeros(idx.shape, dtype=torch.bool, device=idx.device) for _ in valids),
        )
    live = idx >= 0
    i = torch.clamp(idx, min=0)
    return (
        tuple(torch.where(live, d[i], f) for d, f in zip(datas, fills)),
        tuple(v[i] & live for v in valids),
    )


def _side_args(batch: DeviceBatch):
    return (
        tuple(c.data for c in batch.columns),
        tuple(c.valid for c in batch.columns),
    ), tuple(NULL_CODE if c.type == LogicalType.VARCHAR else 0 for c in batch.columns)


@program
def _gather_pairs(l_idx, r_idx, ld, lv, rd, rv, l_fills, r_fills, nullable: bool,
                  l_empty: bool, r_empty: bool, keep, count, cross, dev):
    """The join output gather (the reference's _gather_pairs_jit), with the
    residual's compaction first when `keep` is given
    (_compact_gather_pairs_jit), or the cross join's left-major pairs when
    `cross` = (nl, nr) is (_cross_join_jit)."""
    if cross is not None:
        nl, nr = cross
        l_idx = torch.arange(nl, dtype=torch.int64, device=dev).repeat_interleave(nr)
        r_idx = torch.arange(nr, dtype=torch.int64, device=dev).repeat(nl)
    if keep is not None:
        sel = compact_indices(keep, keep, count)
        l_idx, r_idx = l_idx[sel], r_idx[sel]
    return (
        _gather_side(ld, lv, l_fills, l_idx, nullable, l_empty),
        _gather_side(rd, rv, r_fills, r_idx, nullable, r_empty),
    )


@program
def _outer_join_tail(l_idx, r_idx, um_l, um_r, ld, lv, rd, rv, l_fills, r_fills,
                     n_um_l: int, n_um_r: int, jt: str, l_empty: bool, r_empty: bool):
    """The outer join's pair indices and output gather in one program (the
    reference's _outer_join_tail_jit)."""
    all_l, all_r = _outer_pair_indices(l_idx, r_idx, um_l, um_r, n_um_l, n_um_r, jt)
    return (
        _gather_side(ld, lv, l_fills, all_l, True, l_empty),
        _gather_side(rd, rv, r_fills, all_r, True, r_empty),
    )


def _outer_join(schema, left: DeviceBatch, right: DeviceBatch, l_idx, r_idx,
                jt: str) -> DeviceBatch:
    """A left/right/full join's rows: the unmatched masks and their counts
    (one program, one host read), then the tail program."""
    um_l, um_r, cnt = _unmatched_masks(l_idx, r_idx, left.num_rows, right.num_rows, jt)
    n_um_l, n_um_r = (int(x) for x in cnt.cpu().numpy())
    (la, l_fills), (ra, r_fills) = _side_args(left), _side_args(right)
    (ld, lv), (rd, rv) = _outer_join_tail(
        l_idx, r_idx, um_l, um_r, *la, *ra, l_fills, r_fills,
        n_um_l, n_um_r, jt, left.num_rows == 0, right.num_rows == 0,
    )
    cols = [Column(c.type, d, v) for c, d, v in zip(left.columns, ld, lv)]
    cols += [Column(c.type, d, v) for c, d, v in zip(right.columns, rd, rv)]
    return DeviceBatch(schema, cols, int(l_idx.shape[0]) + n_um_l + n_um_r, left.device)


def _eval_residual_on_pairs(filter_expr, left, right, l_idx, r_idx):
    """Evaluate a join residual over (l_idx, r_idx) pairs, gathering ONLY
    the columns the filter references (the filter is positional against the
    left++right layout)."""
    expr2, sub_fields, l_pick, r_pick = _residual_subplan(
        filter_expr, left, right
    )
    n_l = len(l_pick)
    left_sub = DeviceBatch(
        Schema(sub_fields[:n_l]), [left.columns[i] for i in l_pick],
        left.num_rows, left.device,
    )
    right_sub = DeviceBatch(
        Schema(sub_fields[n_l:]), [right.columns[i] for i in r_pick],
        right.num_rows, right.device,
    )
    pairs = _merge_rows(Schema(sub_fields), left_sub, right_sub, l_idx, r_idx)
    (keep,) = execute_exprs_fused([expr2], pairs)
    return keep


def _merge_rows(schema, left: DeviceBatch, right: DeviceBatch, l_idx, r_idx,
                nullable: bool = False, keep=None, cross=None) -> DeviceBatch:
    """Gather (left_rows ++ right_rows) into the join output layout, in one
    program (_gather_pairs). With `nullable`, an index of -1 is a NULL row
    on that side; `keep` = (mask, count) compacts the pairs first; `cross`
    = (nl, nr) makes the cross join's pairs."""
    (la, l_fills), (ra, r_fills) = _side_args(left), _side_args(right)
    kd, count = keep if keep is not None else (None, None)
    (ld, lv), (rd, rv) = _gather_pairs(
        l_idx, r_idx, *la, *ra, l_fills, r_fills, nullable,
        left.num_rows == 0, right.num_rows == 0, kd, count, cross, left.device,
    )
    if count is not None:
        n = count
    elif cross is not None:
        n = cross[0] * cross[1]
    else:
        n = int(l_idx.shape[0])
    cols = [Column(c.type, d, v) for c, d, v in zip(left.columns, ld, lv)]
    cols += [Column(c.type, d, v) for c, d, v in zip(right.columns, rd, rv)]
    return DeviceBatch(schema, cols, n, left.device)
