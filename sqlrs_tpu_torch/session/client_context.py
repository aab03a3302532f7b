"""Client-context session objects: prepared statements + query results.

Parity with the reference's v2 main_entry layer (reference
src/main_entry/client_context.rs:18-107, prepared_statement_data.rs:9,
pending_query_result.rs:14, query_result.rs:14): a ClientContext owns the
active query, statements can be prepared once (bind + optimize + physical
plan) and executed many times, execution goes through a PendingQueryResult
that is invalidated if another query starts, and results materialize into a
MaterializedQueryResult.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from sqlrs_tpu_torch.data import DeviceBatch
from sqlrs_tpu_torch.errors import ExecutorError
from sqlrs_tpu_torch.types import LogicalType
from sqlrs_tpu_torch.utils.render import batch_to_rows, batches_to_slt_lines


@dataclass
class MaterializedQueryResult:
    names: list[str]
    types: list[LogicalType]
    batches: list[DeviceBatch]

    def rows(self) -> list[list[str]]:
        out = []
        for b in self.batches:
            out.extend(batch_to_rows(b))
        return out

    def lines(self) -> list[str]:
        return batches_to_slt_lines(self.batches)

    def row_count(self) -> int:
        return sum(b.num_rows for b in self.batches)


@dataclass
class PreparedStatementData:
    """Bound + optimized + lowered once; re-executable (reference
    prepared_statement_data.rs:9 keeps {unbound stmt, physical plan, names,
    types})."""

    sql: str
    physical_plan: Any
    names: list[str]
    types: list[LogicalType]


class PendingQueryResult:
    """Handle for an in-flight query; invalidated when the context moves on
    (reference pending_query_result.rs:35-44)."""

    def __init__(self, context: "ClientContext", prepared: PreparedStatementData):
        self._context = context
        self._prepared = prepared

    def _check_valid(self) -> None:
        if self._context._active_pending is not self:
            raise ExecutorError("pending query result is no longer valid")

    def execute(self) -> MaterializedQueryResult:
        self._check_valid()
        if self._context.interrupted:
            raise ExecutorError("query interrupted")
        batches = self._context._execute_physical(self._prepared)
        return MaterializedQueryResult(
            self._prepared.names, self._prepared.types, batches
        )


class ClientContext:
    def __init__(self, db) -> None:
        self.db = db
        self.interrupted = False
        self._active_pending: Optional[PendingQueryResult] = None

    def interrupt(self) -> None:
        self.interrupted = True

    def prepare(self, sql: str) -> PreparedStatementData:
        from sqlrs_tpu_torch.parser import parse_one

        return self._prepare_stmt(sql, parse_one(sql))

    def _prepare_stmt(self, sql: str, stmt) -> PreparedStatementData:
        from sqlrs_tpu_torch.binder.binder import Binder
        from sqlrs_tpu_torch.optimizer import optimize
        from sqlrs_tpu_torch.plan.logical import (
            LogicalExplain,
            explain_tree as explain_logical,
        )
        from sqlrs_tpu_torch.plan.physical import (
            PhysicalPlanGenerator,
            explain_tree as explain_physical,
        )

        bound = Binder(self.db).bind(stmt)
        plan = bound.plan
        # explain materializes its three plan strings at prepare time, like
        # the reference's v2 (physical_explain.rs:12-40) and the v1 session
        # path (session/database.py _run_statement)
        if isinstance(plan, LogicalExplain):
            plan.plan_strings["logical_plan"] = explain_logical(plan.children[0])
        plan = optimize(plan)
        if isinstance(plan, LogicalExplain):
            plan.plan_strings["optimized_logical_plan"] = explain_logical(
                plan.children[0]
            )
        phys = PhysicalPlanGenerator().create_plan(plan)
        if isinstance(plan, LogicalExplain):
            phys.plan_strings = dict(plan.plan_strings)
            phys.plan_strings["physical_plan"] = explain_physical(
                phys.children[0]
            )
        return PreparedStatementData(sql, phys, bound.names, bound.types)

    def pending_query(self, sql: str) -> PendingQueryResult:
        self.interrupted = False
        pending = PendingQueryResult(self, self.prepare(sql))
        self._active_pending = pending  # invalidates any prior handle
        return pending

    def query(self, sql: str) -> MaterializedQueryResult:
        """One-shot: prepare + execute (reference client_context.rs:34)."""
        return self.pending_query(sql).execute()

    def query_all(self, sql: str) -> list[MaterializedQueryResult]:
        """Every statement in `sql`, in order. The v1 session path runs all
        statements of a multi-statement input; this keeps the two engine
        personalities aligned on valid v1 input instead of failing with
        parse_one's single-statement restriction."""
        from sqlrs_tpu_torch.parser import parse

        results = []
        for stmt in parse(sql):
            self.interrupted = False
            pending = PendingQueryResult(self, self._prepare_stmt(sql, stmt))
            self._active_pending = pending
            results.append(pending.execute())
        return results

    def execute_prepared(self, prepared: PreparedStatementData) -> MaterializedQueryResult:
        return MaterializedQueryResult(
            prepared.names, prepared.types, self._execute_physical(prepared)
        )

    def _execute_physical(self, prepared: PreparedStatementData):
        if self.db.mesh is not None:
            from sqlrs_tpu_torch.parallel.dist_executor import DistributedExecutor

            batch = DistributedExecutor(self.db, self.db.mesh).run(
                prepared.physical_plan
            )
        else:
            from sqlrs_tpu_torch.exec.executor import Executor

            batch = Executor(self.db).execute(prepared.physical_plan)
        return [batch] if len(batch.schema) > 0 else []
