"""SQL-level distributed execution: physical plans over row-sharded tables.

The port of sqlrs_tpu/parallel/dist_executor.py: a second executor
personality that runs the SAME physical plans as exec/executor.Executor
over tables row-sharded across a mesh of torch devices
(parallel/mesh.py), composed with the exchange / partial-agg / join
strategies of parallel/dist_ops.py and parallel/dist_join.py.

- `ShardedBatch`: every column is one row block per shard, on that
  shard's device, padded to a multiple of the shard count, plus each
  shard's `alive` row mask. Filters only clear `alive` bits (no
  compaction, no communication); compaction happens once, at the collect
  boundary, onto the controller's device (`db.device`, shard 0's).
- Row order: sharding is block-contiguous and dead rows are masked (never
  reordered), so collecting yields rows in EXACTLY the single-device order.
- Where the reference evaluates expressions on the global sharded view,
  the same code runs once per shard on its block (rows are independent).
  Where it reads a global scalar, the port reduces per shard on the device
  and reads the host once.
- Operators keep data sharded as long as the op is expressible with
  per-shard stages and collectives (scan/filter/project/simple & grouped
  agg/hash join/ORDER BY/LIMIT/DISTINCT); the rest (DISTINCT aggregates,
  cross join, DDL) materializes and delegates to the standard executor.
- Several processes (parallel/mesh.initialize_distributed): every process
  runs the same plan over its own shards, `ShardedBatch` holding only
  those; the collect boundary gathers the whole result into every process
  (the reference's `_host` over process_allgather), so every process's
  `db.run` returns every row, and delegated operators run alike in every
  process on the same collected rows. Every host read that steers control
  flow reads a value that came out of a collective or out of collected
  rows, so every process takes the same branches.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from sqlrs_tpu_torch.data import Column, DeviceBatch, Schema
from sqlrs_tpu_torch.data.batch import torch_dtype_for, ubigint_key, ubigint_to_float
from sqlrs_tpu_torch.errors import ExecutorError
from sqlrs_tpu_torch.exec.executor import Executor, _merge_rows, _schema
from sqlrs_tpu_torch.exec.expression_executor import execute_expr, execute_exprs_fused
from sqlrs_tpu_torch.ops import elementwise as ew
from sqlrs_tpu_torch.parallel import collectives
from sqlrs_tpu_torch.parallel.mesh import (
    live_blocks,
    replicate,
    row_blocks,
    shard_positions,
)
from sqlrs_tpu_torch.plan import physical as P
from sqlrs_tpu_torch.types import LogicalType, ScalarValue

_INT64_MAX = 2**63 - 1
_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)


@dataclass
class ShardedBatch:
    """Row-sharded columnar batch: `columns[c][s]` is column c's block on
    shard s (a Column on mesh.devices[s]), every block `local` rows, and
    `alive[s]` marks shard s's live rows. `parts` holds small row blocks on
    the controller's device that belong AFTER all sharded rows
    (unmatched-left join output, which the reference appends last).

    `rowid`, when set, is the LOGICAL row-order key (int64, sharded like
    the columns): the batch's single-device order is ascending rowid among
    alive rows, not physical position. Shuffle joins set it (the exchange
    scrambles placement); collect sorts by it, and order-sensitive
    operators consume it instead of position. rowid None == position
    order."""

    schema: Schema
    columns: list  # [column][shard] -> Column
    alive: list  # [shard] -> bool tensor
    mesh: object
    parts: list = field(default_factory=list)
    rowid: Optional[list] = None

    @property
    def local(self) -> int:
        return int(self.alive[0].shape[0])  # every process holds >= 1 shard

    @property
    def capacity(self) -> int:
        return self.local * self.mesh.size

    def view(self, s: int) -> DeviceBatch:
        """Shard s's block as a batch (dead rows hold garbage that
        downstream masks ignore)."""
        return DeviceBatch(
            self.schema, [c[s] for c in self.columns], self.local, self.mesh.devices[s]
        )

    def with_columns(self, schema: Schema, columns: list) -> "ShardedBatch":
        return ShardedBatch(schema, columns, self.alive, self.mesh, list(self.parts), self.rowid)

    def to_device_batch(self) -> DeviceBatch:
        """Collect: gather every shard's live rows onto the controller's
        device (in every process of a multi-process mesh). Preserves
        single-device row order (block-contiguous sharding + stable masking;
        rowid-sorted when an exchange scrambled the layout)."""
        mesh = self.mesh
        dev = mesh.devices[0]
        rows = collectives.LiveRows(mesh, self.alive, dev)
        order = None
        if self.rowid is not None and rows.n:
            order = torch.argsort(rows.take(self.rowid), stable=True)

        def take(xs):
            t = rows.take(xs)
            return t if order is None else t[order]

        cols = [
            Column(c[0].type, take([x.data for x in c]), take([x.valid for x in c]))
            for c in self.columns
        ]
        out = DeviceBatch(self.schema, cols, rows.n, dev)
        if self.parts:
            out = DeviceBatch.concat([out] + self.parts)
        return out


def shard_batch(batch: DeviceBatch, mesh) -> ShardedBatch:
    """Pad rows to a multiple of the shard count and lay every column out
    in row blocks, one per shard (the partitioned parallel scan)."""
    cols = [
        [
            Column(c.type, d, v)
            for d, v in zip(row_blocks(mesh, c.data), row_blocks(mesh, c.valid, False))
        ]
        for c in batch.columns
    ]
    return ShardedBatch(batch.schema, cols, live_blocks(mesh, batch.num_rows), mesh)


def _host_sum(mesh, xs) -> int:
    """Sum over shards of per-shard tensors, read once."""
    return int(collectives.reduce_sum(mesh, [x.sum(dtype=torch.int64) for x in xs]))


class DistributedExecutor:
    """Distributed personality of exec/executor.Executor: the same physical
    plan IR, a sharded data plane. Unsupported operators materialize their
    inputs and delegate to the single-device executor (correctness is
    never gated on distribution support)."""

    def __init__(self, db, mesh, profile=None) -> None:
        self.db = db
        self.mesh = mesh
        self.profile = profile  # utils/profiling.QueryProfile | None

    # ---- entry ---------------------------------------------------------------

    def run(self, op: P.PhysicalOperator) -> DeviceBatch:
        out = self.execute(op)
        return out.to_device_batch() if isinstance(out, ShardedBatch) else out

    def execute(self, op: P.PhysicalOperator):
        name = type(op).__name__.removeprefix("Physical")
        method = getattr(self, "_dexec_" + name, None)
        if method is None or (self.mesh.group is not None and _interns_by_row([op])):
            return self._fallback(op)
        if self.profile is None:
            return method(op)
        with self.profile.measure("dist:" + op.explain_line()[:54]) as stats:
            out = method(op)
            if isinstance(out, ShardedBatch):
                stats.rows_out = _host_sum(self.mesh, out.alive)
            else:
                stats.rows_out = out.num_rows
        return out

    def _fallback(self, op: P.PhysicalOperator) -> DeviceBatch:
        """Materialize children, then run the standard executor for this op."""
        cache = {id(c): self._materialize(self.execute(c)) for c in op.children}
        return _DelegatingExecutor(self.db, cache).execute(op)

    @staticmethod
    def _materialize(res) -> DeviceBatch:
        return res.to_device_batch() if isinstance(res, ShardedBatch) else res

    def _eval(self, exprs, sb: ShardedBatch) -> list:
        """Evaluate expressions on every shard's block: [expr][shard]."""
        per = [execute_exprs_fused(exprs, sb.view(s)) for s in range(self.mesh.n_local)]
        return [[p[j] for p in per] for j in range(len(exprs))]

    # ---- scans ---------------------------------------------------------------

    def _dexec_Explain(self, op):
        # plan strings are pre-materialized; never execute the child
        return _DelegatingExecutor(self.db, {}).execute(op)

    def _dexec_TableScan(self, op: P.PhysicalTableScan):
        fn = self.db.catalog.table_function(op.function_name)
        batch = fn.execute(self.db, op.bind_data, op.projection, op.bounds)
        return shard_batch(batch, self.mesh)

    # ---- row-wise (zero-communication SPMD) -------------------------------------

    def _dexec_Projection(self, op: P.PhysicalProjection):
        child = self.execute(op.children[0])
        if not isinstance(child, ShardedBatch):
            return self._delegate(op, child)
        out = child.with_columns(_schema(op), self._eval(op.exprs, child))
        out.parts = [
            DeviceBatch(
                _schema(op), [execute_expr(e, p) for e in op.exprs], p.num_rows, p.device
            )
            for p in child.parts
        ]
        return out

    def _dexec_Filter(self, op: P.PhysicalFilter):
        child = self.execute(op.children[0])
        if not isinstance(child, ShardedBatch):
            return self._delegate(op, child)
        (keep,) = self._eval([op.predicate], child)
        alive = [a & k.data & k.valid for a, k in zip(child.alive, keep)]
        out = ShardedBatch(child.schema, child.columns, alive, self.mesh, rowid=child.rowid)
        for p in child.parts:
            k = execute_expr(op.predicate, p)
            out.parts.append(p.take(ew.selection_to_indices(k)))
        return out

    def _dexec_Order(self, op: P.PhysicalOrder):
        """Distributed ORDER BY: sample-sort exchange on the first key (ties
        share a bucket), local stable sort with the global row index as the
        final tiebreak — collected output is bit-exact with the
        single-device stable sort. Doubles as compaction (dead rows are
        dropped by the exchange)."""
        child = self.execute(op.children[0])
        if not isinstance(child, ShardedBatch) or child.parts:
            return self._delegate(op, child)
        from sqlrs_tpu_torch.ops.sort import _directed_key
        from sqlrs_tpu_torch.parallel.dist_ops import dist_sort_rows

        key_cols = self._eval([e for e, _ in op.items], child)
        dkeys = [
            [_directed_key(c, asc) for c in kc] for kc, (_, asc) in zip(key_cols, op.items)
        ]
        payload, bool_cols = [], []
        for c in child.columns:
            is_bool = c[0].data.dtype == torch.bool
            bool_cols.append(is_bool)
            payload.append([x.data.to(torch.int32) if is_bool else x.data for x in c])
            payload.append([x.valid.to(torch.int32) for x in c])
        n_dev = self.mesh.size
        cap = child.capacity
        bucket_capacity = max(4 * cap // (n_dev * n_dev), 64)
        while True:
            _k, pays, alive, overflow = dist_sort_rows(
                self.mesh, dkeys, payload, child.alive, bucket_capacity,
                rowid=child.rowid,
            )
            if overflow == 0:
                break
            if bucket_capacity >= cap // n_dev + 64:
                return self._delegate(op, child)  # pathological skew
            bucket_capacity = min(bucket_capacity * 4, cap // n_dev + 64)
        cols = []
        for i, c in enumerate(child.columns):
            data, valid = pays[2 * i], pays[2 * i + 1]
            cols.append([
                Column(c[0].type, d.to(torch.bool) if bool_cols[i] else d, v > 0)
                for d, v in zip(data, valid)
            ])
        return ShardedBatch(child.schema, cols, alive, self.mesh)

    def _dexec_Limit(self, op: P.PhysicalLimit):
        """LIMIT/OFFSET without materializing: a global prefix count of live
        rows (each shard's count all_gathered, its predecessors' summed)
        masks rows outside the window."""
        child = self.execute(op.children[0])
        if not isinstance(child, ShardedBatch) or child.parts or child.rowid is not None:
            return self._delegate(op, child)
        offset = op.offset or 0
        counts = collectives.all_gather(
            self.mesh, [a.sum(dtype=torch.int64).reshape(1) for a in child.alive]
        )
        alive = []
        for s, a in enumerate(child.alive):
            base = counts[s].reshape(-1)[:self.mesh.offset + s].sum()
            pos = base + torch.cumsum(a.to(torch.int64), 0) - 1  # rank among live
            keep = a & (pos >= offset)
            if op.limit is not None:
                keep = keep & (pos < offset + op.limit)
            alive.append(keep)
        return ShardedBatch(child.schema, child.columns, alive, self.mesh)

    # ---- ungrouped aggregation: local partials + a psum ----------------------------

    def _dexec_SimpleAgg(self, op: P.PhysicalSimpleAgg):
        child = self.execute(op.children[0])
        if not isinstance(child, ShardedBatch) or child.parts:
            return self._delegate(op, child)
        if any(a.distinct for a in op.aggregates):
            return self._delegate(op, child.to_device_batch())
        dev = self.db.device
        cols = [
            Column.from_scalars(a.return_type(), [self._simple_agg_value(a, child)], device=dev)
            for a in op.aggregates
        ]
        return DeviceBatch(_schema(op), cols, 1, dev)

    def _simple_agg_value(self, a, child: ShardedBatch) -> ScalarValue:
        mesh = self.mesh
        rt = a.return_type()
        if a.arg is None:  # count(*)
            return ScalarValue(rt, _host_sum(mesh, child.alive))
        (col,) = self._eval([a.arg], child)
        ok = [al & c.valid for al, c in zip(child.alive, col)]
        cnt = _host_sum(mesh, ok)
        name = a.function_name
        if name == "count":
            return ScalarValue(rt, cnt)
        if cnt == 0:
            return ScalarValue(rt, None)
        if name in ("sum", "avg"):
            acc_t = LogicalType.DOUBLE if name == "avg" else rt
            s = collectives.reduce_sum(mesh, [
                torch.where(o, ew.convert_numeric(c.data, c.type, acc_t), 0).sum(
                    dtype=torch_dtype_for(acc_t)
                )
                for o, c in zip(ok, col)
            ])
            if name == "avg":
                return ScalarValue(rt, float(s) / cnt)
            if rt == LogicalType.UBIGINT:
                return ScalarValue(rt, int(s) % 2**64)  # the int64 bit pattern
            return ScalarValue(rt, float(s) if rt.is_float() else int(s))
        if name in ("min", "max"):
            want_min = name == "min"
            if col[0].type == LogicalType.VARCHAR:
                from sqlrs_tpu_torch.ops.sort import orderable_key

                # each shard's best (key, code); the codes of one string
                # dictionary, which every process builds alike
                best = []
                for o, c in zip(ok, col):
                    key, _ = orderable_key(c)
                    k = torch.where(o, key, _INT64_MAX if want_min else -_INT64_MAX)
                    i = torch.argmin(k) if want_min else torch.argmax(k)
                    best.append(torch.stack([k[i], c.data[i].to(torch.int64)]))
                best = collectives.gather(mesh, [b.reshape(1, 2) for b in best], self.db.device)
                vals = best[:, 0]
                s = int(torch.argmin(vals) if want_min else torch.argmax(vals))
                code = best[s, 1:].to(col[0].data.dtype)
                valid = torch.ones_like(code, dtype=torch.bool)
                return Column(col[0].type, code, valid).scalar_at(0)
            dt = col[0].data.dtype
            unsigned64 = col[0].type == LogicalType.UBIGINT
            if dt.is_floating_point:
                sent = float("inf") if want_min else float("-inf")
            else:
                ii = torch.iinfo(dt)
                sent = ii.max if want_min else ii.min
            # UBIGINT compares in unsigned order: through its signed key
            datas = [ubigint_key(c.data) if unsigned64 else c.data for c in col]
            parts = [
                torch.where(o, d, torch.full_like(d, sent)).amin()
                if want_min else
                torch.where(o, d, torch.full_like(d, sent)).amax()
                for o, d in zip(ok, datas)
            ]
            r = (collectives.reduce_min if want_min else collectives.reduce_max)(mesh, parts)
            if unsigned64:
                return ScalarValue(rt, (int(r) + 2**63) % 2**64)
            return ScalarValue(rt, float(r) if rt.is_float() else int(r)).cast_to(rt)
        raise ExecutorError(f"unknown aggregate {name}")

    # ---- grouped aggregation: shard-local sorted partials + O(G) gather -------------

    def _dexec_HashAgg(self, op: P.PhysicalHashAgg):
        fused = self._try_ring_agg_join(op)
        if fused is not None:
            return fused
        child = self.execute(op.children[0])
        if (
            not isinstance(child, ShardedBatch)
            or child.parts
            or any(a.distinct for a in op.aggregates)
        ):
            return self._delegate(op, child)
        return self._grouped_agg_dist(op, child)

    def _try_ring_agg_join(self, op: P.PhysicalHashAgg):
        """Fused ring aggregate-over-join: HashAgg directly over an inner
        single-key (or two-key) HashJoin, where every group key reads the
        build (dim) side and every aggregate argument reads the probe
        (fact) side, computes per-dim-row partials with
        dist_join.ring_agg_join / broadcast_agg_join — the join's pair set
        is NEVER materialized and no data is exchanged — and the result
        feeds the distributed grouped agg as a dim-sized batch whose
        rowid = (min matching fact row, dim position) reproduces the
        reference's first-appearance group order exactly.

        Returns None (caller falls back to join-then-agg) when the pattern
        or the policy doesn't fit. Policy: db.dist_join_policy == 'ring'
        forces the ring; 'auto' picks the ring when the build side has at
        least db.dist_ring_min_build (default 2^16) live rows and the
        broadcast-fused kernel ('broadcast_fused') below it; explicit
        'broadcast'/'shuffle' stay on the general machinery. A float join
        key also stays there: its [k, k + 1) range queries are for ints."""
        from sqlrs_tpu_torch.binder.expression import (
            BoundAggregate,
            BoundReference,
            rewrite_expr,
            visit_expr,
        )
        from sqlrs_tpu_torch.ops.sort import orderable_key
        from sqlrs_tpu_torch.parallel.dist_join import broadcast_agg_join, ring_agg_join

        policy = getattr(self.db, "dist_join_policy", "auto")
        if policy in ("broadcast", "shuffle"):
            return None
        # see through column-pruning Projection chains between agg and join by
        # composing expressions, level by level
        node = op.children[0]
        proj_stack, proj_nodes = [], []
        while isinstance(node, P.PhysicalProjection):
            proj_stack.append(node.exprs)
            proj_nodes.append(node)
            node = node.children[0]
        jop = node
        if not isinstance(jop, P.PhysicalHashJoin):
            return None
        if self.mesh.group is not None and _interns_by_row([op, jop, *proj_nodes]):
            return None
        if jop.join_type != "inner" or len(jop.on) not in (1, 2) or jop.filter is not None:
            return None
        if len(jop.on) == 1 and (jop.on[0][0].type.is_float() or jop.on[0][1].type.is_float()):
            return None
        # DISTINCT combines across shards exactly via locally-deduped (key,
        # value) pair exchange + a second fused pass, sound only when every
        # output group is refined by the join key; count/sum/avg over ONE
        # shared argument, otherwise fall back
        d_reprs = {repr(a.arg) for a in op.aggregates if a.distinct}
        has_distinct = bool(d_reprs)
        if has_distinct and (
            len(d_reprs) > 1
            or len(jop.on) != 1
            or any(
                a.distinct and a.function_name not in ("count", "sum", "avg")
                for a in op.aggregates
            )
        ):
            return None
        if len(jop.on) == 2:
            from sqlrs_tpu_torch.exec.fused_route import _routable_key_type

            for lk, rk in jop.on:
                for k in (lk, rk):
                    if not _routable_key_type(k.type):
                        return None

        def compose(e):
            for exprs in proj_stack:
                e = rewrite_expr(
                    e,
                    lambda x, exprs=exprs: exprs[x.index]
                    if isinstance(x, BoundReference) else None,
                )
            return e

        groups = [compose(g) for g in op.groups]
        aggregates = [
            a if a.arg is None else a.with_children((compose(a.arg),))
            for a in op.aggregates
        ]
        nb = len(jop.children[0].names)

        def side(exprs):
            lo, hi = [None], [None]

            def f(e):
                if isinstance(e, BoundReference):
                    lo[0] = e.index if lo[0] is None else min(lo[0], e.index)
                    hi[0] = e.index if hi[0] is None else max(hi[0], e.index)

            for e in exprs:
                visit_expr(e, f)
            return lo[0], hi[0]

        glo, ghi = side(groups)
        alo, _ahi = side([a.arg for a in aggregates if a.arg is not None])
        if glo is None or ghi >= nb:  # group keys must be build-side
            return None
        if alo is not None and alo < nb:  # agg args must be probe-side
            return None
        if has_distinct:
            lkey = jop.on[0][0]
            if not isinstance(lkey, BoundReference) or not any(
                isinstance(g, BoundReference) and g.index == lkey.index for g in groups
            ):
                return None  # groups not refined by the join key
            d_types = {
                a.arg.return_type()
                for a in aggregates
                if a.distinct and a.function_name in ("sum", "avg")
            }
            if LogicalType.UBIGINT in d_types or LogicalType.VARCHAR in d_types:
                return None  # no exact raw reconstruction for sums

        left = self.execute(jop.children[0])
        right = self.execute(jop.children[1])
        ok = (
            isinstance(left, ShardedBatch)
            and isinstance(right, ShardedBatch)
            and not left.parts
            and not right.parts
            and left.rowid is None
            and right.rowid is None
        )
        use_ring = True
        if ok and policy == "auto":
            # small builds take the broadcast-fused kernel (ONE all_gather +
            # one probe pass); large builds rotate chunks through the ring
            min_build = getattr(self.db, "dist_ring_min_build", 1 << 16)
            use_ring = _host_sum(self.mesh, left.alive) >= min_build
        if not ok:
            # fall back: re-dispatch through the normal agg-over-join path
            child = self.execute(op.children[0])
            if (
                not isinstance(child, ShardedBatch)
                or child.parts
                or any(a.distinct for a in op.aggregates)
            ):
                return self._delegate(op, child)
            return self._grouped_agg_dist(op, child)

        rng = range(self.mesh.n_local)
        if len(jop.on) == 2:
            # composite two-key equi join: fold into one combined int key
            # (fused_route._combine_keys over all shards)
            (l1, r1), (l2, r2) = jop.on
            d1, d2 = self._eval([l1, l2], left)
            f1, f2 = self._eval([r1, r2], right)
            combined = _combine_keys_sharded(self.mesh, f1, f2, d1, d2)
            if combined is None:
                return None  # combined packing would overflow int64
            f_enc, f_kv, d_enc, d_kv = combined
        else:
            (d_col,) = self._eval([jop.on[0][0]], left)
            (f_col,) = self._eval([jop.on[0][1]], right)
            d_enc, d_kv, f_enc, f_kv = [], [], [], []
            for s in rng:
                de, dv = orderable_key(d_col[s])
                fe, fv = orderable_key(f_col[s])
                d_enc.append(de.to(torch.int64))
                d_kv.append(dv)
                f_enc.append(fe.to(torch.int64))
                f_kv.append(fv)

        def shift(e):
            return rewrite_expr(
                e,
                lambda x: BoundReference(x.index - nb, x.type, x.column_name)
                if isinstance(x, BoundReference) else None,
            )

        group_cols = self._eval(groups, left)
        agg_args = [
            self._eval([shift(a.arg)], right)[0] if a.arg is not None else None
            for a in aggregates
        ]
        f_ok = [right.alive[s] & f_kv[s] for s in rng]
        d_ok = [left.alive[s] & d_kv[s] for s in rng]
        f_rowid = shard_positions(self.mesh, right.local)

        # per-aggregate partial layout: sum/count -> one sum column (+ a
        # validity-count column so all-NULL partials stay NULL); min/max ->
        # one (directed key, raw) sort + a validity-count column
        sum_cols: list = []
        mm_specs: list = []
        plan = []  # (kind, sum_ix, vcnt_ix, mm_ix)
        d_arg_col = None
        d_need_sum = False
        for a, c in zip(aggregates, agg_args):
            if a.arg is None:
                plan.append(("count_star", None, None, None))
                continue
            name = a.function_name
            if a.distinct:
                # served by the deduped-pair second pass below
                plan.append((name + "_d", None, None, None))
                d_arg_col = c
                d_need_sum = d_need_sum or name in ("sum", "avg")
                continue
            valid_cnt = [x.valid.to(torch.int64) for x in c]
            if name == "count":
                plan.append(("count", len(sum_cols), None, None))
                sum_cols.append(valid_cnt)
            elif name in ("sum", "avg"):
                # avg decomposes into sum + non-NULL-count partials; int args
                # accumulate int64 so the final division matches the
                # single-device float64(int_sum)/count exactly
                if name == "avg":
                    acc_t = (
                        LogicalType.DOUBLE
                        if c[0].type.is_float() or c[0].type == LogicalType.UBIGINT
                        else LogicalType.BIGINT
                    )
                else:
                    acc_t = a.return_type()
                plan.append((name, len(sum_cols), len(sum_cols) + 1, None))
                sum_cols.append([
                    torch.where(x.valid, ew.convert_numeric(x.data, x.type, acc_t), 0)
                    for x in c
                ])
                sum_cols.append(valid_cnt)
            else:  # min / max
                mks, vcs = [], []
                for s in rng:
                    enc, vv = orderable_key(c[s])
                    enc = _mm_key(enc)
                    if name == "max":
                        enc = ~enc
                    live = vv & right.alive[s]
                    mks.append(torch.where(live, enc, _INT64_MAX))
                    vcs.append(live.to(torch.int64))
                plan.append((name, None, len(sum_cols), len(mm_specs)))
                sum_cols.append(vcs)
                mm_specs.append((mks, [x.data for x in c]))

        fused_fn = ring_agg_join if use_ring else broadcast_agg_join
        counts, sums, min_rowid, mm_outs = fused_fn(
            self.mesh, f_enc, f_ok, f_rowid, sum_cols, mm_specs, d_enc, d_ok,
        )
        d_counts = d_sums = None
        if has_distinct:
            d_counts, d_sums = self._distinct_dim_partials(
                fused_fn, d_arg_col, f_enc, f_ok, right, d_enc, d_ok, d_need_sum,
            )

        # ---- dim-sized partial batch + the distributed grouped agg ----------
        ng = len(groups)
        part_cols = list(group_cols)
        aggs2 = []
        names2 = list(op.names[:ng])
        types2 = list(op.types[:ng])
        final_spec = []  # per original aggregate: ("one", ix) | ("avg", s, c)
        always = [torch.ones(left.local, dtype=torch.bool, device=d) for d in self.mesh.devices]

        def sharded_col(t, datas, valids):
            return [Column(t, d, v) for d, v in zip(datas, valids)]

        def _add(fn2, col, rt, nm):
            part_cols.append(col)
            aggs2.append(
                BoundAggregate(fn2, BoundReference(len(part_cols) - 1, col[0].type, nm), False, rt)
            )
            names2.append(nm)
            types2.append(rt)
            return ng + len(aggs2) - 1  # final output column index

        dcnt_ix = None  # shared distinct-count partial column

        def _dcnt_col():
            nonlocal dcnt_ix
            if dcnt_ix is None:
                # duplicate dim rows of one key carry EQUAL distinct
                # partials: combine with max, never sum
                dcnt_ix = _add(
                    "max", sharded_col(LogicalType.BIGINT, d_counts, always),
                    LogicalType.BIGINT, "#dcnt",
                )
            return dcnt_ix

        for i, ((kind, six, vix, mix), a) in enumerate(zip(plan, aggregates)):
            rt = a.return_type()
            nm = op.names[ng + i] if ng + i < len(op.names) else a.name()
            if kind == "count_d":
                final_spec.append(("one", _dcnt_col()))
                continue
            if kind in ("sum_d", "avg_d"):
                st = LogicalType.DOUBLE if d_sums[0].is_floating_point() else LogicalType.BIGINT
                s_ix = _add(
                    "max", sharded_col(st, d_sums, [x > 0 for x in d_counts]), st, nm + "#dsum"
                )
                if kind == "sum_d":
                    final_spec.append(("one", s_ix))
                else:
                    final_spec.append(("avg", s_ix, _dcnt_col()))
                continue
            if kind == "count_star":
                final_spec.append(("one", _add("sum", sharded_col(rt, counts, always), rt, nm)))
            elif kind == "count":
                final_spec.append(("one", _add("sum", sharded_col(rt, sums[six], always), rt, nm)))
            elif kind == "sum":
                final_spec.append(("one", _add(
                    "sum",
                    sharded_col(
                        rt, [x.to(torch_dtype_for(rt)) for x in sums[six]],
                        [x > 0 for x in sums[vix]],
                    ),
                    rt, nm,
                )))
            elif kind == "avg":
                st = (
                    LogicalType.DOUBLE if sums[six][0].is_floating_point()
                    else LogicalType.BIGINT
                )
                s_ix = _add(
                    "sum", sharded_col(st, sums[six], [x > 0 for x in sums[vix]]), st,
                    nm + "#sum",
                )
                c_ix = _add(
                    "sum", sharded_col(LogicalType.BIGINT, sums[vix], always),
                    LogicalType.BIGINT, nm + "#cnt",
                )
                final_spec.append(("avg", s_ix, c_ix))
            else:  # min / max
                raw, _mk = mm_outs[mix]
                final_spec.append(("one", _add(
                    kind, sharded_col(rt, raw, [x > 0 for x in sums[vix]]), rt, nm,
                )))
        # pair order: (first matching fact row, dim position); guard the
        # packing against int64 overflow at absurd capacities
        if right.capacity * left.capacity >= (1 << 62):
            return None  # pragma: no cover - capacities beyond packing range
        pos = shard_positions(self.mesh, left.local)
        pair_rowid = [
            torch.where(counts[s] > 0, min_rowid[s] * left.capacity + pos[s], _INT64_MAX)
            for s in rng
        ]
        schema2 = Schema.of([(f"g{i}", c[0].type) for i, c in enumerate(part_cols)])
        partial = ShardedBatch(
            schema2, part_cols, [d_ok[s] & (counts[s] > 0) for s in rng], self.mesh,
            rowid=pair_rowid,
        )
        op2 = P.PhysicalHashAgg(
            children=[],
            names=names2,
            types=types2,
            groups=[
                BoundReference(i, c[0].type, f"g{i}") for i, c in enumerate(part_cols[:ng])
            ],
            aggregates=aggs2,
        )
        self._record_strategy("ring" if use_ring else "broadcast_fused")
        batch = self._grouped_agg_dist(op2, partial)
        if all(spec[0] == "one" for spec in final_spec):
            return batch
        # avg post-pass: divide the combined sum/count partials and emit the
        # ORIGINAL output schema (G-sized)
        cols = list(batch.columns)
        out_cols = cols[:ng]
        for spec, a in zip(final_spec, aggregates):
            if spec[0] == "one":
                out_cols.append(cols[spec[1]])
            else:
                _, s_ix, c_ix = spec
                s, c = cols[s_ix], cols[c_ix]
                den = torch.clamp(c.data, min=1).to(torch.float64)
                out_cols.append(Column(
                    a.return_type(), s.data.to(torch.float64) / den, s.valid & (c.data > 0)
                ))
        return DeviceBatch(
            Schema.of(list(zip(op.names, op.types))), out_cols, batch.num_rows, batch.device
        )

    def _distinct_dim_partials(
        self, fused_fn, c, f_enc, f_ok, right: ShardedBatch, d_enc, d_ok, need_sum: bool,
    ):
        """count/sum(DISTINCT c) per dim row, exact across shards:

          1. shard-local sorted-unique over (join key, value-encoding) pairs
             (dist_join.pair_local_dedup);
          2. exchange the surviving pairs by key hash (partition_shuffle,
             fixed capacity + overflow-retry x4 — every copy of a pair lands
             on one shard);
          3. dedup again: pairs are now globally unique;
          4. the deduped pair table is just another fact table — one more
             fused pass returns per-dim-row counts (= COUNT(DISTINCT)) and
             value sums (= SUM(DISTINCT)).

        Returns (d_counts, d_sums) aligned with the dim side's layout
        (d_sums None when not need_sum)."""
        from sqlrs_tpu_torch.ops.grouped_agg import _orderable_inverse
        from sqlrs_tpu_torch.ops.hash_table import next_pow2
        from sqlrs_tpu_torch.ops.sort import orderable_key
        from sqlrs_tpu_torch.parallel.dist_join import pair_local_dedup
        from sqlrs_tpu_torch.parallel.dist_ops import _overflow_scalar, partition_shuffle

        mesh = self.mesh
        venc, pair_ok = [], []
        for s in range(mesh.n_local):
            e, vv = orderable_key(c[s])
            venc.append(e)
            pair_ok.append(f_ok[s] & vv)
        k1, v1, ok1 = pair_local_dedup(mesh, f_enc, venc, pair_ok)

        n_dev = mesh.size
        local_n = max(right.capacity // n_dev, 1)
        cap = next_pow2(max(-(-local_n // max(n_dev // 2, 1)), 64))
        while True:
            k2, v2, ok2, ovf = partition_shuffle(mesh, k1, v1, ok1, bucket_capacity=cap)
            if _overflow_scalar(mesh, ovf) == 0:
                break
            if cap >= 2 * next_pow2(local_n):  # pragma: no cover
                raise ExecutorError("distinct pair exchange overflow at maximum capacity")
            cap *= 4
        k3, v3, ok3 = pair_local_dedup(mesh, k2, v2, ok2)

        sum_cols: list = []
        if need_sum:
            col = []
            for v, o in zip(v3, ok3):
                raw = (
                    v.to(torch.float64) if v.is_floating_point()
                    else _orderable_inverse(v, c[0].type).to(torch.int64)
                )
                col.append(torch.where(o, raw, torch.zeros_like(raw)))
            sum_cols.append(col)
        rowid = shard_positions(mesh, k3[0].shape[0])
        d_counts, d_sums, _rid, _mm = fused_fn(mesh, k3, ok3, rowid, sum_cols, [], d_enc, d_ok)
        return d_counts, (d_sums[0] if need_sum else None)

    def _grouped_agg_dist(self, op, child: ShardedBatch) -> DeviceBatch:
        """Two-phase distributed GROUP BY: per-shard fixed-capacity sorted
        partial aggregation (ops/grouped_agg.partial_grouped_fixed), the O(G)
        partials gathered to the controller, then a final merge through the
        standard sorted-run kernel. The min global row index is carried as a
        partial state and the final rows are ordered by it, reproducing the
        reference's first-appearance group order exactly."""
        from sqlrs_tpu_torch.ops.grouped_agg import (
            _unsortable,
            partial_grouped_fixed,
            sorted_grouped_aggregate,
        )
        from sqlrs_tpu_torch.ops.hash_table import next_pow2
        from sqlrs_tpu_torch.ops.sort import orderable_key

        mesh = self.mesh
        rng = range(mesh.n_local)
        dev = self.db.device
        key_cols = self._eval(op.groups, child)
        arg_exprs = [a.arg for a in op.aggregates if a.arg is not None]
        arg_vals = iter(self._eval(arg_exprs, child))
        agg_cols = [next(arg_vals) if a.arg is not None else None for a in op.aggregates]

        keys = [
            [(orderable_key(c[s])[0], c[s].valid, c[s].data) for c in key_cols] for s in rng
        ]
        agg_desc = []  # kind per aggregate
        aggs = [[] for _ in rng]
        for a, c in zip(op.aggregates, agg_cols):
            name = a.function_name
            if c is None:
                agg_desc.append("count_star")
                for s in rng:
                    aggs[s].append(("count_star", None, None, None, None))
                continue
            if name in ("min", "max") and c[0].type == LogicalType.VARCHAR:
                kind = "vmin" if name == "min" else "vmax"
                agg_desc.append(kind)
                for s in rng:
                    rank, _ = orderable_key(c[s])
                    aggs[s].append((kind, c[s].data, c[s].valid, rank, torch.int32))
                continue
            if name == "avg":
                out_dt = torch.float64
            elif name == "sum":
                out_dt = torch_dtype_for(a.return_type())
            else:
                out_dt = torch_dtype_for(c[0].type)
            agg_desc.append(name)
            for s in rng:
                data = c[s].data
                if c[s].type == LogicalType.UBIGINT:
                    # avg sums the values as floats; min/max run on the
                    # signed key of the unsigned order (undone at the merge)
                    if name == "avg":
                        data = ubigint_to_float(data)
                    elif name in ("min", "max"):
                        data = ubigint_key(data)
                aggs[s].append((name, data, c[s].valid, None, out_dt))

        cap_local = child.local
        row_idx = child.rowid or shard_positions(mesh, cap_local)
        g_cap = min(next_pow2(max(64, cap_local // 8)), next_pow2(cap_local))
        while True:
            outs = [
                partial_grouped_fixed(child.alive[s], row_idx[s], keys[s], aggs[s], g_cap)
                for s in rng
            ]
            overflow = bool(collectives.reduce_max(mesh, [o[5] for o in outs]))
            if not overflow or g_cap >= next_pow2(cap_local):
                break
            g_cap = min(g_cap * 4, next_pow2(cap_local))  # retry with a larger capacity

        # ---- gather the live partials to the controller (G size) -------------
        rows = collectives.LiveRows(mesh, [o[2] for o in outs], dev)

        def gathered(get):
            return rows.take([get(o) for o in outs])

        partial_keys = []
        for k, c in enumerate(key_cols):
            kd = gathered(lambda o, k=k: o[0][k][0])
            kv = gathered(lambda o, k=k: o[0][k][1])
            partial_keys.append(Column(c[0].type, _unsortable(kd, c[0].type), kv))
        ones = torch.ones(rows.n, dtype=torch.bool, device=dev)
        merge_specs = [
            ("min", Column(LogicalType.BIGINT, gathered(lambda o: o[1]), ones),
             LogicalType.BIGINT)
        ]
        result_plan = []  # per original agg: how to read merged outputs
        for j, (kind, a) in enumerate(zip(agg_desc, op.aggregates)):
            rt = a.return_type()

            def state(key, j=j):
                return gathered(lambda o: o[3][j][key])

            if kind in ("count_star", "count"):
                result_plan.append(("count", len(merge_specs), rt))
                merge_specs.append(
                    ("sum", Column(LogicalType.BIGINT, state("cnt"), ones), LogicalType.BIGINT)
                )
            elif kind in ("sum", "avg"):
                cnt = state("cnt")
                has = cnt > 0
                st = LogicalType.DOUBLE if kind == "avg" else rt
                sum_col = Column(st, state("sum"), has)
                if kind == "avg":
                    result_plan.append(("avg", len(merge_specs), rt))
                    merge_specs.append(("sum", sum_col, LogicalType.DOUBLE))
                    merge_specs.append(
                        ("sum", Column(LogicalType.BIGINT, cnt, ones), LogicalType.BIGINT)
                    )
                else:
                    result_plan.append(("direct", len(merge_specs), rt))
                    merge_specs.append(("sum", sum_col, rt))
            else:  # min / max / vmin / vmax
                from sqlrs_tpu_torch.data.strings import NULL_CODE

                best = state("best")
                has = state("cnt") > 0
                if kind in ("vmin", "vmax"):
                    src_t = LogicalType.VARCHAR
                    best = torch.where(has, best, NULL_CODE)
                else:
                    src_t = agg_cols[j][0].type
                    if src_t == LogicalType.UBIGINT:
                        best = ubigint_key(best)
                result_plan.append(("direct", len(merge_specs), rt))
                merge_specs.append(
                    ("min" if kind in ("min", "vmin") else "max",
                     Column(src_t, _unsortable(best, src_t), has), rt)
                )

        gcols, acols, n_groups = sorted_grouped_aggregate(partial_keys, merge_specs)

        # ---- first-appearance order + output assembly --------------------------
        if n_groups > 0:
            order = torch.argsort(acols[0].data, stable=True)
            gcols = [c.take(order) for c in gcols]
            acols = [c.take(order) for c in acols]
        out_cols = list(gcols)
        for what, mi, rt in result_plan:
            if what == "count":
                out_cols.append(Column(
                    LogicalType.BIGINT, acols[mi].data,
                    torch.ones(n_groups, dtype=torch.bool, device=dev),
                ))
            elif what == "avg":
                s, c = acols[mi], acols[mi + 1]
                cnt = torch.clamp(c.data, min=1)
                out_cols.append(Column(rt, s.data / cnt.to(torch.float64), c.data > 0))
            else:
                a = acols[mi]
                out_cols.append(Column(rt, _unsortable(a.data, rt), a.valid))
        return DeviceBatch(_schema(op), out_cols, n_groups, dev)

    # ---- hash join: replicated build side, sharded slot-expansion probe ----------

    # guardrails for the fixed-width slot expansion; beyond these the
    # materialize-and-delegate path is the better plan anyway
    _JOIN_MAX_DUP = 256
    _JOIN_MAX_CELLS = 1 << 26

    def _dexec_HashJoin(self, op: P.PhysicalHashJoin):
        if op.join_type in ("semi", "anti"):
            return self._semi_anti_dist(op)
        right = self.execute(op.children[1])
        if not isinstance(right, ShardedBatch) or right.parts:
            cache = {id(op.children[1]): self._materialize(right)}
            cache[id(op.children[0])] = self._materialize(self.execute(op.children[0]))
            self._record_strategy("delegate")
            return _DelegatingExecutor(self.db, cache).execute(op)
        left_res = self.execute(op.children[0])
        if self._pick_shuffle(op, left_res, right):
            out = self._shuffle_join_dist(op, left_res, right)
            if out is not None:
                return out
        left = self._materialize(left_res)
        self._record_strategy("broadcast")
        return self._hash_join_dist(op, left, right)

    def _record_strategy(self, name: str) -> None:
        """Append the chosen join strategy to db.last_join_strategies (reset
        per statement by the session layer; tests read it)."""
        log = getattr(self.db, "last_join_strategies", None)
        if log is None:
            log = []
            self.db.last_join_strategies = log
        log.append(name)

    def _pick_shuffle(self, op, left_res, right: ShardedBatch) -> bool:
        """Strategy selection from live row counts: broadcast replicates the
        build side to every shard (cost ~ B x p); the shuffle repartitions
        both sides once (cost ~ B + N). Shuffle wins when B x (p-1) > N and
        B is big enough that replication actually hurts.
        `db.dist_shuffle_min_build` overrides the absolute floor."""
        if op.join_type != "inner" or not isinstance(left_res, ShardedBatch):
            return False
        if left_res.parts or right.parts:
            return False
        policy = getattr(self.db, "dist_join_policy", "auto")
        if policy == "broadcast":
            return False
        if policy == "shuffle":
            return True
        n_dev = self.mesh.size
        live = collectives.reduce_sum(self.mesh, [
            torch.stack([a.sum(dtype=torch.int64), b.sum(dtype=torch.int64)])
            for a, b in zip(left_res.alive, right.alive)
        ])
        build_rows, probe_rows = live.tolist()
        min_build = getattr(self.db, "dist_shuffle_min_build", 1 << 16)
        return build_rows >= min_build and build_rows * (n_dev - 1) > probe_rows

    def _semi_anti_dist(self, op: P.PhysicalHashJoin):
        """Distributed mark-join (decorrelated EXISTS / IN): the OUTER side
        stays row-sharded; the subquery side materializes and its sorted
        key array is replicated. Each shard tests membership with a
        searchsorted probe and flips its alive mask — no exchange and no
        pair expansion. Single-equality, residual-free joins only;
        everything else delegates."""
        left = self.execute(op.children[0])
        right = self._materialize(self.execute(op.children[1]))
        if (
            not isinstance(left, ShardedBatch)
            or left.parts
            or op.filter is not None
            or len(op.on) != 1
        ):
            cache = {id(op.children[0]): self._materialize(left), id(op.children[1]): right}
            return _DelegatingExecutor(self.db, cache).execute(op)
        from sqlrs_tpu_torch.ops.sort import _lex_argsort, orderable_key

        anti = op.join_type == "anti"
        out_schema = _schema(op)
        if right.num_rows == 0:
            # NOT IN / NOT EXISTS over an empty set keeps every row (even
            # NULL probes); semi keeps none
            alive = left.alive if anti else [torch.zeros_like(a) for a in left.alive]
            return ShardedBatch(out_schema, left.columns, alive, self.mesh, rowid=left.rowid)
        r_col = execute_expr(op.on[0][1], right)
        if op.null_aware and anti and bool(torch.logical_not(r_col.valid).any()):
            return ShardedBatch(
                out_schema, left.columns, [torch.zeros_like(a) for a in left.alive],
                self.mesh, rowid=left.rowid,
            )
        (l_col,) = self._eval([op.on[0][0]], left)
        rk, rv = orderable_key(r_col)
        big = float("inf") if rk.is_floating_point() else torch.iinfo(rk.dtype).max
        # validity rides the sort as a secondary key (invalid entries map to
        # the max sentinel AND sort after equal-valued valid entries), so a
        # legitimate key equal to dtype-max still matches
        rk = torch.where(rv, rk, big)
        flag = torch.logical_not(rv).to(torch.int32)
        perm = _lex_argsort([rk, flag])
        r_sorted = replicate(self.mesh, rk[perm])
        flag_sorted = replicate(self.mesh, flag[perm])
        m = int(rk.shape[0])
        alive = []
        for s, lc in enumerate(l_col):
            lk, lv = orderable_key(lc)
            lk = lk.to(r_sorted[s].dtype)
            pos = torch.clamp(torch.searchsorted(r_sorted[s], lk), 0, m - 1)
            matched = lv & (r_sorted[s][pos] == lk) & (flag_sorted[s][pos] == 0)
            keep = torch.logical_not(matched) if anti else matched
            if op.null_aware and anti:
                keep = keep & lv  # NULL probe never passes NOT IN (inner non-empty)
            alive.append(left.alive[s] & keep)
        return ShardedBatch(out_schema, left.columns, alive, self.mesh, rowid=left.rowid)

    _SHUFFLE_MAX_CELLS = 1 << 27

    def _shuffle_join_dist(
        self, op, left: ShardedBatch, right: ShardedBatch
    ) -> Optional[ShardedBatch]:
        """Partitioned (shuffle-repartition) inner hash join: both sides
        exchanged by key hash, full payloads carried, skew salted adaptively
        (parallel/dist_join.py). Returns None to fall back to broadcast when
        the match width would blow the cell budget.

        Bit-exactness: the output carries rowid = probe_rowid * m + slot,
        the single-device pair emission sequence; collect and downstream
        order-sensitive operators sort by it."""
        from sqlrs_tpu_torch.ops.hash_table import next_pow2
        from sqlrs_tpu_torch.ops.sort import orderable_key
        from sqlrs_tpu_torch.parallel.dist_join import shuffle_join_phase_a, shuffle_join_phase_b

        mesh = self.mesh
        n_dev = mesh.size
        rng = range(mesh.n_local)
        lkey_cols = self._eval([lk for lk, _ in op.on], left)
        rkey_cols = self._eval([rk for _, rk in op.on], right)
        b_keys, p_keys = [], []
        for lc, rc in zip(lkey_cols, rkey_cols):
            le, lv, re_, rv = [], [], [], []
            for s in rng:
                e1, v1 = orderable_key(lc[s])
                e2, v2 = orderable_key(rc[s])
                le.append(e1)
                lv.append(v1)
                re_.append(e2.to(e1.dtype))
                rv.append(v2)
            b_keys.append((le, lv))
            p_keys.append((re_, rv))

        def flatten(cols):
            pays, bools = [], []
            for c in cols:
                is_bool = c[0].data.dtype == torch.bool
                bools.append(is_bool)
                pays.append([x.data.to(torch.int32) if is_bool else x.data for x in c])
                pays.append([x.valid.to(torch.int32) for x in c])
            return pays, bools

        b_pay, b_bools = flatten(left.columns)
        p_pay, p_bools = flatten(right.columns)
        b_rowid = left.rowid or shard_positions(mesh, left.local)
        p_rowid = right.rowid or shard_positions(mesh, right.local)
        cap_b, cap_p = left.capacity, right.capacity
        # size buckets from LIVE row counts with 2x hash-skew slack, rounded
        # to a power of two; the x4 retry ladder covers residual skew
        live = collectives.reduce_sum(mesh, [
            torch.stack([a.sum(dtype=torch.int64), b.sum(dtype=torch.int64)])
            for a, b in zip(left.alive, right.alive)
        ])
        live_b, live_p = live.tolist()
        bucket_b = next_pow2(max(2 * live_b // (n_dev * n_dev), 64))
        bucket_p = next_pow2(max(2 * live_p // (n_dev * n_dev), 64))
        hot_capacity = 1024
        while True:
            a = shuffle_join_phase_a(
                mesh,
                b_keys, b_pay, b_rowid, left.alive,
                p_keys, p_pay, p_rowid, right.alive,
                bucket_b=bucket_b, bucket_p=bucket_p,
                hot_capacity=hot_capacity,
                hot_min=getattr(self.db, "dist_hot_min", None),
                # db.dist_exchange_ring=True stages the probe exchange in
                # ppermute ring hops (bit-identical outputs)
                ring=getattr(self.db, "dist_exchange_ring", False),
            )
            if a.overflow == 0:
                break
            if bucket_b >= cap_b // n_dev and bucket_p >= cap_p // n_dev:
                return None  # pragma: no cover - full capacity always fits
            bucket_b = min(bucket_b * 4, max(cap_b // n_dev, 64))
            bucket_p = min(bucket_p * 4, max(cap_p // n_dev, 64))
            hot_capacity = min(hot_capacity * 4, next_pow2(max(cap_b, 64)))
        m = max(a.m, 1)
        out_cap = n_dev * n_dev * bucket_p * m
        # memory guardrail: the strip expansion materializes out_cap cells
        if out_cap > self._SHUFFLE_MAX_CELLS:
            return None
        b_cells, p_cells, rowid_out, alive = shuffle_join_phase_b(
            mesh, a, len(b_keys), len(b_pay)
        )
        cols = []
        for i, c in enumerate(left.columns):
            cols.append([
                Column(c[0].type, d.to(torch.bool) if b_bools[i] else d, (v > 0) & al)
                for d, v, al in zip(b_cells[2 * i], b_cells[2 * i + 1], alive)
            ])
        for i, c in enumerate(right.columns):
            cols.append([
                Column(c[0].type, d.to(torch.bool) if p_bools[i] else d, v > 0)
                for d, v in zip(p_cells[2 * i], p_cells[2 * i + 1])
            ])
        out = ShardedBatch(_schema(op), cols, alive, mesh, rowid=rowid_out)
        if op.filter is not None:
            (keep,) = self._eval([op.filter], out)
            out.alive = [a_ & k.data & k.valid for a_, k in zip(out.alive, keep)]
        self._record_strategy("salted" if a.n_hot_buckets > 0 else "shuffle")
        return out

    def _hash_join_dist(self, op, left: DeviceBatch, right: ShardedBatch):
        """Broadcast-build distributed equi join:

        - the build (left) side is replicated; the probe (right) side stays
          row-sharded — no shuffle of the big side;
        - each probe row owns a fixed strip of m match slots (m = the most
          build rows sharing one key hash) plus, for right/full joins, one
          unmatched-right slot; probe-row-major strips reproduce the
          reference's probe-order emission (unmatched-right rows
          interleaved at their probe position) EXACTLY, because sharding is
          block-contiguous;
        - candidates are the build rows whose combined key hash equals the
          probe row's, in insertion order: the reference finds them through
          its open-addressing table (ops/hash_table.build_join_table), the
          port through the stably sorted build hashes — the same rows in the
          same order. Every candidate is re-checked for exact equality on
          all key columns;
        - unmatched-left rows (left/full) come from a psum'd visited bitmap
          and are appended as a part, last, as the reference does."""
        from sqlrs_tpu_torch.ops.hash_table import _mix64

        mesh = self.mesh
        nl = left.num_rows
        cdev = left.device
        left_keys = execute_exprs_fused([lk for lk, _ in op.on], left)
        right_keys = self._eval([rk for _, rk in op.on], right)

        def combined_hash(cols, n, dev):
            h = torch.full((n,), _GOLDEN, dtype=torch.int64, device=dev)
            valid = torch.ones(n, dtype=torch.bool, device=dev)
            for c in cols:
                h = _mix64(h ^ _mix64(_int64_bits(c)))
                valid = valid & c.valid
            return h, valid

        cap_r = right.capacity
        extra = 1 if op.join_type in ("right", "full") else 0
        if nl > 0:
            bh, bvalid = combined_hash(left_keys, nl, cdev)
            # NULL-key build rows never match: give each a spread decoy hash
            # (collisions are harmless — the exact re-check rejects them)
            decoy = _mix64(torch.arange(nl, dtype=torch.int64, device=cdev) + 7)
            bh = torch.where(bvalid, bh, decoy)
            sorted_bh, order = torch.sort(bh, stable=True)
            run = (
                torch.searchsorted(sorted_bh, sorted_bh, right=True)
                - torch.searchsorted(sorted_bh, sorted_bh)
            )
            m = int(run.max())
        else:
            m = 0
        w = max(m, 1) + extra
        if nl == 0 or m > self._JOIN_MAX_DUP or cap_r * w > self._JOIN_MAX_CELLS:
            cache = {id(op.children[0]): left, id(op.children[1]): right.to_device_batch()}
            return _DelegatingExecutor(self.db, cache).execute(op)

        sbh = replicate(mesh, sorted_bh)
        order_r = replicate(mesh, order)
        lcols = [(replicate(mesh, c.data), replicate(mesh, c.valid)) for c in left.columns]
        lkeys_r = [
            (replicate(mesh, _int64_bits(c)), replicate(mesh, c.valid)) for c in left_keys
        ]
        cols = [[] for _ in range(len(left.columns) + len(right.columns))]
        alive_out, visited, rowid_out = [], [], []
        for s, dev in enumerate(mesh.devices):
            rview = right.view(s)
            rk = [c[s] for c in right_keys]
            n_loc = right.local
            ph, pvalid = combined_hash(rk, n_loc, dev)
            lo = torch.searchsorted(sbh[s], ph)
            counts = torch.searchsorted(sbh[s], ph, right=True) - lo
            probe_ok = right.alive[s] & pvalid & (counts > 0)
            j = torch.arange(m, dtype=torch.int64, device=dev)  # slot strip of a probe row
            cand = order_r[s][torch.clamp(lo[:, None] + j[None, :], 0, nl - 1)]
            have = probe_ok[:, None] & (j[None, :] < counts[:, None])
            # exact key equality re-check on every candidate
            for (lbits, lvalid), c in zip(lkeys_r, rk):
                have = have & lvalid[s][cand] & c.valid[:, None]
                have = have & (lbits[s][cand] == _int64_bits(c)[:, None])
            if extra:
                cand = torch.cat([cand, torch.zeros((n_loc, extra), dtype=cand.dtype, device=dev)], 1)
                have = torch.cat([have, torch.zeros((n_loc, extra), dtype=torch.bool, device=dev)], 1)
            cand_flat = cand.reshape(-1)
            match_flat = have.reshape(-1)
            merged = [
                Column(lc.type, d[s][cand_flat], v[s][cand_flat] & match_flat)
                for (d, v), lc in zip(lcols, left.columns)
            ] + [
                Column(c.type, torch.repeat_interleave(c.data, w),
                       torch.repeat_interleave(c.valid, w))
                for c in rview.columns
            ]
            alive = match_flat
            if op.filter is not None:
                keep = execute_expr(op.filter, DeviceBatch(_schema(op), merged, n_loc * w, dev))
                alive = alive & keep.data & keep.valid
            if extra:
                has_match = alive.view(n_loc, w).any(1)
                ur = right.alive[s] & torch.logical_not(has_match)  # unmatched right rows
                ur_flat = torch.cat(
                    [torch.zeros((n_loc, m), dtype=torch.bool, device=dev), ur[:, None]], 1
                ).reshape(-1)
                alive = alive | ur_flat
            if op.join_type in ("left", "full"):
                visited.append(torch.zeros(nl + 1, dtype=torch.int32, device=dev).index_add_(
                    0, torch.where(alive & match_flat, cand_flat, nl),
                    torch.ones_like(cand_flat, dtype=torch.int32),
                )[:nl])
            # probe-major strips keep position order; a scrambled probe side
            # (rowid set) gives the output's logical order (probe rowid, slot)
            if right.rowid is not None:
                rowid_out.append((
                    right.rowid[s][:, None] * w
                    + torch.arange(w, dtype=torch.int64, device=dev)[None, :]
                ).reshape(-1))
            for i, c in enumerate(merged):
                cols[i].append(c)
            alive_out.append(alive)
        out = ShardedBatch(
            _schema(op), cols, alive_out, mesh, rowid=rowid_out if right.rowid is not None else None
        )
        if op.join_type in ("left", "full"):
            seen = collectives.reduce_sum(mesh, visited).to(cdev)
            unmatched = torch.nonzero(seen == 0).reshape(-1)
            if len(unmatched):
                empty_r = DeviceBatch.empty(right.schema, device=cdev)
                out.parts.append(_merge_rows(
                    _schema(op), left, empty_r, unmatched, torch.full_like(unmatched, -1),
                    nullable=True,
                ))
        return out

    # ---- delegation ------------------------------------------------------------

    def _delegate(self, op: P.PhysicalOperator, child_result) -> DeviceBatch:
        cache = {id(op.children[0]): self._materialize(child_result)}
        for c in op.children[1:]:
            cache[id(c)] = self._materialize(self.execute(c))
        return _DelegatingExecutor(self.db, cache).execute(op)


def _combine_keys_sharded(mesh, f1, f2, d1, d2):
    """fused_route._combine_keys over sharded key columns: the dim side's
    span statistics reduced over all shards, then each shard's combined
    keys. Returns (fact_ck, fact_ok, dim_ck, dim_ok) per shard, or None
    when the packing would overflow int64 (one host read of the meta)."""
    big = _INT64_MAX
    i64 = torch.int64
    dv = [a.valid & b.valid for a, b in zip(d1, d2)]
    stats = collectives.reduce_max(mesh, [
        torch.stack([
            -torch.where(v, b.data.to(i64), big).min(),  # -mn_min
            torch.where(v, b.data.to(i64), -big).max(),  # mn_max
            -torch.where(v, a.data.to(i64), big).min(),  # -mj_min
            torch.where(v, a.data.to(i64), -big).max(),  # d1_max
        ])
        for a, b, v in zip(d1, d2, dv)
    ])
    st = replicate(mesh, stats)
    f_ck, f_ok, d_ck = [], [], []
    for s in range(mesh.n_local):
        mn_min, mn_max, mj_min = -st[s][0], st[s][1], -st[s][2]
        span = torch.clamp(mn_max - mn_min + 1, min=1)
        d_ck.append((d1[s].data.to(i64) - mj_min) * span + (d2[s].data.to(i64) - mn_min))
        g2 = f2[s].data.to(i64)
        in_span = (g2 >= mn_min) & (g2 <= mn_max)
        f_ck.append((f1[s].data.to(i64) - mj_min) * span + (g2 - mn_min))
        f_ok.append(f1[s].valid & f2[s].valid & in_span)
    fstats = collectives.reduce_max(mesh, [
        torch.stack([
            -torch.where(ok, f.data.to(i64), big).min(),
            torch.where(ok, f.data.to(i64), -big).max(),
        ])
        for f, ok in zip(f1, f_ok)
    ])
    neg_mn_min, mn_max, neg_mj_min, d1_max, neg_f1_min, f1_max = torch.cat(
        [stats, fstats.to(stats.device)]
    ).tolist()
    s_minor = max(mn_max + neg_mn_min + 1, 1)
    mj_min, f1_min = -neg_mj_min, -neg_f1_min
    span = max(abs(f1_max - mj_min) + 1, abs(f1_min - mj_min) + 1, abs(d1_max - mj_min) + 1)
    if span >= (1 << 61) // max(s_minor, 1):
        return None
    return f_ck, f_ok, d_ck, dv


def _interns_by_row(ops) -> bool:
    """Whether an operator's own expressions intern new strings in the
    order of the rows they meet (`||`). Every process of a multi-process
    mesh builds the same string dictionary from the same tables and the
    same dictionary-wide code maps (substring, LIKE), but a string made
    from row data would take a code in the order each process met it on
    its own shards; under a process group such an operator runs on the
    collected rows, the same in every process. One process interns in the
    shards' row order and keeps the sharded path."""
    from sqlrs_tpu_torch.binder.expression import BoundExpr, BoundFunction, visit_expr

    found = []

    def look(e):
        if isinstance(e, BoundFunction) and e.op == "concat":
            found.append(e)

    def walk(v):
        if isinstance(v, BoundExpr):
            visit_expr(v, look)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)

    for op in ops:
        for name, v in vars(op).items():
            if name != "children":
                walk(v)
    return bool(found)


def _mm_key(enc):
    """int64 min/max sort key of an orderable key: floats through their
    sort order (ops/sort._float_order_key), ints as they are."""
    if enc.is_floating_point():
        from sqlrs_tpu_torch.ops.sort import _float_order_key

        return _float_order_key(enc.to(torch.float64))
    return enc.to(torch.int64)


def _int64_bits(c: Column):
    """Equality/hash bit view of a column's data as int64 (floats by their
    bits with -0.0 normalized so SQL 0 = -0 holds)."""
    data = c.data
    if data.dtype == torch.float64:
        data = torch.where(data == 0, torch.zeros_like(data), data)
        return data.view(torch.int64)
    if data.dtype == torch.float32:
        data = torch.where(data == 0, torch.zeros_like(data), data)
        return data.view(torch.int32).to(torch.int64)
    return data.to(torch.int64)


class _DelegatingExecutor(Executor):
    """Standard executor that serves precomputed results for given child
    plan nodes (the materialize-and-delegate fallback seam)."""

    def __init__(self, db, cache: dict) -> None:
        super().__init__(db)
        self._cache = cache

    def execute(self, op: P.PhysicalOperator) -> DeviceBatch:
        hit = self._cache.get(id(op))
        if hit is not None:
            return hit
        return super().execute(op)
