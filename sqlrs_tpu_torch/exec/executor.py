"""Operator executors: physical plan → device batches.

The engine's data plane. Each operator consumes whole device-resident
columnar batches and produces one (pipeline breakers land exactly where the
reference materializes: agg, sort, join build — reference
src/executor/order.rs:14, hash_join.rs:187, hash_agg.rs:32). Operators are
eager torch code on the session's device; grouping and sort dispatch to
sqlrs_tpu_torch/ops/.

The port of sqlrs_tpu/exec/executor.py so far: scans, projection, filter,
limit, order, ungrouped aggregates, the GROUP BY path of ops/mxu_grouped.py,
the fused star-rollup route (exec/fused_route.py) in front of ORDER BY and
GROUP BY, and DDL/DML/explain. An operator or path that is not ported yet
raises ExecutorError naming it; nothing falls back to another path.
"""

from __future__ import annotations

import torch

from sqlrs_tpu_torch.data import Column, DeviceBatch, Schema, SchemaField
from sqlrs_tpu_torch.data.batch import torch_dtype_for
from sqlrs_tpu_torch.errors import ExecutorError
from sqlrs_tpu_torch.exec.expression_executor import (
    execute_exprs_fused,
    execute_scalar,
)
from sqlrs_tpu_torch.ops import elementwise as ew
from sqlrs_tpu_torch.ops.fused import mask_count
from sqlrs_tpu_torch.ops.sort import orderable_key, sort_rows
from sqlrs_tpu_torch.plan import physical as P
from sqlrs_tpu_torch.storage.memory import DataTable, null_column


def not_ported(what: str) -> ExecutorError:
    return ExecutorError(f"{what} not yet ported to sqlrs_tpu_torch")


class Executor:
    def __init__(self, db) -> None:
        self.db = db
        self.device = db.device
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
        return method(op)

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
        # one compaction for every size: the kept row indices, then one
        # gather per column. The reference's three branches (host indices
        # for small batches; a payload-carrying or a permutation flag sort
        # for large narrow or wide ones) all produce these rows in this
        # order; they differ only in what is fast on a TPU.
        child = self.execute(op.children[0])
        (keep,) = execute_exprs_fused([op.predicate], child)
        idx = ew.selection_to_indices(keep)
        if idx.shape[0] == child.num_rows:
            return child
        return child.take(idx)

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
                    (keep,) = execute_exprs_fused([c.predicate], piece)
                    piece = piece.take(ew.selection_to_indices(keep))
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
        if not groups:
            raise not_ported("ungrouped DISTINCT aggregation")
        if not self._distinct_on_sorted_path(op):
            raise not_ported("legacy grouped aggregation (multi-argument DISTINCT)")
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
        # exact histogram path for small composite group domains (Q1-class
        # rollups): ops/mxu_grouped.py, whose kernel is csrc/mxu_grouped.cu
        from sqlrs_tpu_torch.ops.mxu_grouped import mxu_grouped_aggregate

        mxu = mxu_grouped_aggregate(key_cols, specs, alive=alive)
        if mxu is not None:
            gcols, acols, n_groups = mxu
            log = getattr(self.db, "last_fused_routes", None)
            if log is None:
                log = self.db.last_fused_routes = []
            log.append("hashagg_mxu")
            return DeviceBatch(_schema(op), gcols + acols, n_groups, self.device)
        live = n if alive is None else mask_count(alive[0], alive[1])
        if live == 0:
            # GROUP BY over no rows is no groups, whatever the path
            return DeviceBatch.empty(_schema(op), device=self.device)
        raise not_ported(
            "sorted-run grouped aggregation (ops/grouped_agg.py), which this "
            "GROUP BY needs"
        )

    # ---- joins ----------------------------------------------------------------

    def _exec_HashJoin(self, op: P.PhysicalHashJoin) -> DeviceBatch:
        if op.join_type in ("semi", "anti"):
            raise not_ported(f"{op.join_type} join")
        raise not_ported(f"{op.join_type} hash join")

    def _exec_CrossJoin(self, op: P.PhysicalCrossJoin) -> DeviceBatch:
        raise not_ported("cross join")

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
        from sqlrs_tpu_torch.types import LogicalType, ScalarValue

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
    from sqlrs_tpu_torch.types import LogicalType

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
        data = col.data.to(torch_dtype_for(acc_t))
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
            return Column(LogicalType.VARCHAR, col.data[i].reshape(1), has)
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


def _reduce_ungrouped_fused(aggs, slots, arg_cols, n: int, alive, device):
    """All ungrouped aggregates of a SimpleAgg. The JAX package compiles
    them into one program (with its own jit cache); here they are the plain
    eager reductions."""
    if isinstance(alive, tuple):  # raw (keep_data, keep_valid) pair
        alive = torch.logical_and(alive[0], alive[1])
    return [
        _reduce_one_ungrouped(
            a, arg_cols[s] if s is not None else None, n, alive, device
        )
        for a, s in zip(aggs, slots)
    ]
