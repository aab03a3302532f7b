"""Device-resident in-memory table store.

Replaces the reference's LocalStorage append-only RecordBatch store with
1024-row batch coalescing (reference src/storage_v2/local_storage.rs:13,85-120)
and the v1 Storage/Table/Transaction traits (reference src/storage/mod.rs:20-54).

Design: a host-side numpy master copy per column (append-friendly, grown in
2^k tiles) plus a lazily refreshed device snapshot per device (torch
tensors). Scans hand out the snapshot of the device they are asked for —
zero-copy for repeated queries; appends only invalidate the snapshots. Row
storage is always dense fixed-width + validity mask (strings are dictionary
codes).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sqlrs_tpu_torch.data import Column, DeviceBatch, Schema, SchemaField
from sqlrs_tpu_torch.data.batch import host_to_device, scalars_to_numpy, storage_np
from sqlrs_tpu_torch.data.strings import GLOBAL_STRINGS, NULL_CODE
from sqlrs_tpu_torch.errors import StorageError
from sqlrs_tpu_torch.types import LogicalType, ScalarValue, numpy_dtype_for
from sqlrs_tpu_torch.utils import profiling

TILE = 1024  # row-tile granularity of the host master copy


class DataTable:
    def __init__(self, names: list[str], types: list[LogicalType]) -> None:
        self.names = list(names)
        self.types = list(types)
        self._capacity = 0
        self._num_rows = 0
        self._data: list[np.ndarray] = [
            np.zeros(0, dtype=numpy_dtype_for(t)) for t in types
        ]
        self._valid: list[np.ndarray] = [np.zeros(0, dtype=np.bool_) for _ in types]
        self._snapshots: dict[torch.device, list[Column]] = {}  # device caches
        self._version = 0

    # ---- metadata ---------------------------------------------------------

    @property
    def num_rows(self) -> int:
        return self._num_rows

    @property
    def schema(self) -> Schema:
        return Schema(
            tuple(SchemaField(n, t) for n, t in zip(self.names, self.types))
        )

    # ---- append path ------------------------------------------------------

    def _reserve(self, extra: int) -> None:
        need = self._num_rows + extra
        if need <= self._capacity:
            return
        new_cap = max(TILE, self._capacity)
        while new_cap < need:
            new_cap *= 2
        for i in range(len(self._data)):
            d = np.zeros(new_cap, dtype=self._data[i].dtype)
            v = np.zeros(new_cap, dtype=np.bool_)
            d[: self._num_rows] = self._data[i][: self._num_rows]
            v[: self._num_rows] = self._valid[i][: self._num_rows]
            self._data[i], self._valid[i] = d, v
        self._capacity = new_cap

    def append_numpy(self, columns: list[np.ndarray], valids: list[np.ndarray]) -> None:
        if not columns:
            return
        n = len(columns[0])
        self._reserve(n)
        lo, hi = self._num_rows, self._num_rows + n
        for i, (d, v) in enumerate(zip(columns, valids)):
            self._data[i][lo:hi] = d.astype(self._data[i].dtype, copy=False)
            self._valid[i][lo:hi] = v
        self._num_rows = hi
        self._snapshots = {}
        self._version += 1

    def append_batch(self, batch: DeviceBatch) -> None:
        self.append_numpy(
            [c.data_np() for c in batch.columns], [c.valid_np() for c in batch.columns]
        )

    def append_rows(self, rows: list[list[ScalarValue]]) -> None:
        cols = []
        valids = []
        for ci, t in enumerate(self.types):
            data, valid = scalars_to_numpy(t, [row[ci] for row in rows])
            cols.append(data)
            valids.append(valid)
        self.append_numpy(cols, valids)

    # ---- scan path --------------------------------------------------------

    def _device_columns(self, device: torch.device) -> list[Column]:
        snap = self._snapshots.get(device)
        if snap is None:
            rec = profiling.RECORDER
            if rec is None:
                snap = self._copy_columns(device)
            else:
                snap = rec.call("storage.first_scan", "storage", self._num_rows,
                                self._copy_columns, device)
            # the snapshot's address stays fixed until the table changes:
            # programs read it in place (utils/programs.py)
            from sqlrs_tpu_torch.utils.programs import mark_resident

            mark_resident(*(t for c in snap for t in (c.data, c.valid)))
            self._snapshots[device] = snap
        return snap

    def _copy_columns(self, device: torch.device) -> list[Column]:
        return [
            Column(
                t,
                host_to_device(storage_np(t, self._data[i][: self._num_rows]), device),
                host_to_device(self._valid[i][: self._num_rows], device),
            )
            for i, t in enumerate(self.types)
        ]

    def scan(
        self,
        device: torch.device,
        projection: Optional[list[int]] = None,
        bounds: Optional[tuple[int, int]] = None,  # (offset, limit)
    ) -> DeviceBatch:
        """Full-table device scan with projection + bounds pushdown
        (reference src/optimizer/plan_node/logical_table_scan.rs:8-16 puts both
        in the scan node)."""
        device = torch.device(device)
        cols = self._device_columns(device)
        idxs = projection if projection is not None else list(range(len(cols)))
        start, count = 0, self._num_rows
        if bounds is not None:
            offset, limit = bounds
            start = min(offset, self._num_rows)
            count = min(limit, self._num_rows - start)
        out = []
        for i in idxs:
            c = cols[i]
            out.append(Column(c.type, c.data[start : start + count], c.valid[start : start + count]))
        schema = Schema(
            tuple(SchemaField(self.names[i], self.types[i]) for i in idxs)
        )
        return DeviceBatch(schema, out, count, device)

    def host_column(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        return self._data[i][: self._num_rows], self._valid[i][: self._num_rows]

    @staticmethod
    def from_batch(batch: DeviceBatch) -> "DataTable":
        t = DataTable(batch.schema.names, batch.schema.types)
        t.append_batch(batch)
        return t


def empty_like(names: list[str], types: list[LogicalType]) -> DataTable:
    return DataTable(names, types)


def null_column(t: LogicalType, n: int) -> tuple[np.ndarray, np.ndarray]:
    fill = NULL_CODE if t == LogicalType.VARCHAR else 0
    return (
        np.full(n, fill, dtype=numpy_dtype_for(t)),
        np.zeros(n, dtype=np.bool_),
    )


def import_tables(db, tables: dict) -> None:
    """Load tables given as plain host data into `db`:
    {table: [(column, logical type name, numpy values, numpy validity)]}.

    VARCHAR values are decoded strings (interned here, into this package's
    dictionary); DATE values are days since the epoch; a validity of None
    means no NULLs. Types are named by string (`LogicalType[name]`), so a
    caller holding another engine's tables needs nothing of this package
    but the function."""
    rec = profiling.RECORDER
    if rec is None:
        _import_tables(db, tables)
    else:
        rec.call("storage.import", "storage", len(tables), _import_tables, db, tables)


def _import_tables(db, tables: dict) -> None:
    from sqlrs_tpu_torch.catalog.catalog import ColumnDefinition

    for name, cols in tables.items():
        types = [LogicalType[tname] for _c, tname, _v, _m in cols]
        table = DataTable([c for c, _t, _v, _m in cols], types)
        datas, valids = [], []
        for (_c, _tn, values, valid), t in zip(cols, types):
            values = np.asarray(values)
            n = len(values)
            valid = (
                np.ones(n, np.bool_) if valid is None else np.asarray(valid, np.bool_)
            )
            if t == LogicalType.VARCHAR:
                if not valid.all():
                    values = [
                        s if ok else None
                        for s, ok in zip(values.tolist(), valid.tolist())
                    ]
                values = GLOBAL_STRINGS.intern_many(values)
            datas.append(values)
            valids.append(valid)
        table.append_numpy(datas, valids)
        db.catalog.create_table(
            name,
            [ColumnDefinition(c, t) for (c, *_r), t in zip(cols, types)],
            table,
        )
