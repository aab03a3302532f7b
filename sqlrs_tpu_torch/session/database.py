"""Session layer: Database / query pipeline orchestration.

Mirrors the reference's two entry points in one class: v1
`Database::run/explain` (reference src/db.rs:107,152) and the v2
DatabaseInstance + ClientContext::query session objects (reference
src/main_entry/db.rs:9, client_context.rs:34). A statement flows
parse → bind → (HEP optimize) → physical plan → execute; a failed statement
aborts only itself.

v1-style CSV sessions preload every CSV as a table via `create_csv_table`
(reference tests/sqllogictest/src/lib.rs:10-31 auto-loads tests/csv/*.csv).

The device is explicit: `Database(device=...)` places every tensor the
engine makes on that torch device, "cuda" by default, and a CUDA device
without CUDA is an error, never a quiet run on the CPU.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from sqlrs_tpu_torch.binder.binder import Binder
from sqlrs_tpu_torch.catalog.catalog import Catalog, ColumnDefinition
from sqlrs_tpu_torch.data import DeviceBatch
from sqlrs_tpu_torch.errors import ExecutorError, SqlrsError
from sqlrs_tpu_torch.exec.executor import Executor, not_ported
from sqlrs_tpu_torch.functions.table import BUILTIN_TABLE_FUNCTIONS
from sqlrs_tpu_torch.parser import ast, parse
from sqlrs_tpu_torch.plan.logical import LogicalExplain, explain_tree as explain_logical
from sqlrs_tpu_torch.plan.physical import PhysicalPlanGenerator, explain_tree as explain_physical
from sqlrs_tpu_torch.storage.csv import CsvConfig, load_csv
from sqlrs_tpu_torch.storage.memory import DataTable
from sqlrs_tpu_torch.utils.render import batches_to_slt_lines


class Database:
    def __init__(
        self,
        base_dir: str | None = None,
        profile: bool = False,
        mesh=None,
        n_devices: int | None = None,
        *,
        device="cuda",
    ) -> None:
        """`device` is the torch device (or its name) every tensor of this
        database lives on: the current CUDA device unless the caller asks
        for another (the tests ask for "cpu"). Without CUDA the default
        raises; nothing falls back to the CPU.

        `mesh` (a parallel/mesh.Mesh) or `n_devices` turns on distributed
        execution: tables are row-sharded over the mesh's devices and plans
        run through parallel/dist_executor.DistributedExecutor, with
        results equal to the single-device engine's, row order included.
        `n_devices=n` with device "cpu" puts n shards on the CPU; with a
        CUDA device it takes the first n CUDA devices and raises if there
        are fewer (several shards share one card only through a mesh that
        lists it several times). With a mesh, `device` is shard 0's: the
        controller's device, where delegated operators run and results are
        collected. `profile` is not ported yet."""
        if profile:
            raise not_ported("query profiling (profile=True)")
        if mesh is None and n_devices is not None:
            from sqlrs_tpu_torch.parallel.mesh import make_mesh

            dev = _resolve_device(device)
            mesh = (
                make_mesh(n_devices, devices=[dev] * n_devices) if dev.type == "cpu"
                else make_mesh(n_devices)
            )
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None else _resolve_device(device)
        self.catalog = Catalog()
        for fn in BUILTIN_TABLE_FUNCTIONS:
            self.catalog.register_table_function(fn.name, fn)
        self._csv_cache: dict[tuple, DataTable] = {}
        # relative csv paths in SQL resolve against base_dir (the reference
        # resolves against its repo root when running the slt suite)
        self.base_dir = base_dir or os.getcwd()

    # ---- storage helpers ------------------------------------------------------

    def _resolve_path(self, path: str) -> str:
        if os.path.isabs(path):
            return path
        return os.path.join(self.base_dir, path)

    def csv_cache_load(self, path: str, delim: str = ",", header: bool = True) -> DataTable:
        path = self._resolve_path(path)
        key = (os.path.abspath(path), delim, header)
        if key not in self._csv_cache:
            self._csv_cache[key] = load_csv(
                path, CsvConfig(has_header=header, delimiter=delim)
            )
        return self._csv_cache[key]

    def create_csv_table(self, name: str, path: str) -> None:
        """v1-style CSV-backed table (reference src/cli.rs `\\load csv` and the
        slt harness preload)."""
        table = load_csv(path)
        self.catalog.create_table(
            name,
            [ColumnDefinition(n, t) for n, t in zip(table.names, table.types)],
            table,
        )

    def create_memory_table_numpy(self, name: str, schema_pairs, arrays) -> None:
        """Columnar bulk ingest: numpy arrays go straight into the host-side
        table store (the device snapshot materializes on first scan). String
        arrays intern in one pass."""
        import numpy as np

        from sqlrs_tpu_torch.data.strings import GLOBAL_STRINGS
        from sqlrs_tpu_torch.types import LogicalType

        table = DataTable([n for n, _ in schema_pairs], [t for _, t in schema_pairs])
        cols, valids = [], []
        for (_n, t), a in zip(schema_pairs, arrays):
            a = np.asarray(a)
            if t == LogicalType.VARCHAR and a.dtype.kind in ("U", "O"):
                a = GLOBAL_STRINGS.intern_many(list(a))
            valids.append(np.ones(len(a), np.bool_))
            cols.append(a)
        table.append_numpy(cols, valids)
        self.catalog.create_table(
            name,
            [ColumnDefinition(n, t) for n, t in schema_pairs],
            table,
        )

    def create_memory_table(self, name: str, batch: DeviceBatch) -> None:
        table = DataTable.from_batch(batch)
        self.catalog.create_table(
            name,
            [
                ColumnDefinition(f.name, f.type)
                for f in batch.schema.fields
            ],
            table,
        )

    # ---- query pipeline ----------------------------------------------------------

    def connect(self):
        """New ClientContext session object (reference
        src/main_entry/client_context.rs:18) supporting prepared statements,
        pending results, and interruption."""
        from sqlrs_tpu_torch.session.client_context import ClientContext

        return ClientContext(self)

    def run(self, sql: str) -> list[DeviceBatch]:
        """Execute all statements; returns the last statement's batches."""
        stmts = parse(sql)
        if not stmts:
            return []
        out: list[DeviceBatch] = []
        for stmt in stmts:
            out = self._run_statement(stmt)
        return out

    def run_lines(self, sql: str) -> list[str]:
        """Execute and render rows with slt rules (one string per row)."""
        return batches_to_slt_lines(self.run(sql))

    def explain(self, sql: str) -> str:
        rows = self.run("explain " + sql)
        lines = []
        for b in rows:
            for key, val in b.to_pylist():
                lines.append(f"=== {key} ===\n{val}")
        return "\n".join(lines)

    def _run_statement(self, stmt: ast.Statement) -> list[DeviceBatch]:
        binder = Binder(self)
        bound = binder.bind(stmt)
        plan = bound.plan

        if isinstance(plan, LogicalExplain):
            plan.plan_strings["logical_plan"] = explain_logical(plan.children[0])

        plan = self._optimize(plan)

        phys = PhysicalPlanGenerator().create_plan(plan)
        if isinstance(plan, LogicalExplain):
            phys.plan_strings = dict(plan.plan_strings)
            phys.plan_strings["physical_plan"] = explain_physical(phys.children[0])

        if self.mesh is not None:
            from sqlrs_tpu_torch.parallel.dist_executor import DistributedExecutor

            self.last_join_strategies = []  # strategy picks, in exec order
            batch = DistributedExecutor(self, self.mesh).run(phys)
        else:
            batch = Executor(self).execute(phys)
        return [batch] if len(batch.schema) > 0 else []

    def _optimize(self, plan):
        """HEP optimizer hook; the rule engine is sqlrs_tpu_torch/optimizer/."""
        from sqlrs_tpu_torch.optimizer import optimize as hep_optimize

        optimized = hep_optimize(plan)
        if isinstance(optimized, LogicalExplain):
            optimized.plan_strings["optimized_logical_plan"] = explain_logical(
                optimized.children[0]
            )
        return optimized


def _resolve_device(device) -> torch.device:
    """The torch.device for `device`; a CUDA device needs CUDA, and one
    given without an index means the current CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ExecutorError(f"device {device!r} requested, but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ExecutorError(f"device {device!r} is not supported")
    return dev
