"""Table functions: data sources for LogicalGet.

Parity set (reference src/function/table/): seq_table_scan
(seq_table_scan.rs:15), read_csv with delim/header named args
(read_csv.rs:17-198), and the introspection functions sqlrs_tables
(sqlrs_tables.rs: schema_name/schema_oid/table_name) and sqlrs_columns
(sqlrs_columns.rs: table_name/column_names/column_types). Filename
replacement scans ('x.csv' in FROM) bind to read_csv (reference
src/planner_v2/binder/statement/bind_base_table_ref.rs:100-126).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from sqlrs_tpu_torch.data import DeviceBatch
from sqlrs_tpu_torch.errors import BinderError
from sqlrs_tpu_torch.storage.csv import CsvConfig, read_csv_file
from sqlrs_tpu_torch.storage.memory import DataTable
from sqlrs_tpu_torch.types import LogicalType, ScalarValue


@dataclass
class TableFunctionBindData:
    kind: str
    payload: Any = None
    types: list[LogicalType] = field(default_factory=list)
    names: list[str] = field(default_factory=list)


class TableFunction:
    name = "table_function"

    def bind(self, db, args, named_args) -> TableFunctionBindData:
        raise NotImplementedError

    def execute(
        self,
        db,
        bind_data: TableFunctionBindData,
        projection: Optional[list[int]] = None,
        bounds: Optional[tuple[int, int]] = None,
    ) -> DeviceBatch:
        raise NotImplementedError


class SeqTableScan(TableFunction):
    """Scan a catalog table's storage (reference seq_table_scan.rs:15)."""

    name = "seq_scan"

    def bind(self, db, args, named_args) -> TableFunctionBindData:
        (table_name,) = (a.value for a in args)
        entry = db.catalog.table(table_name)
        return TableFunctionBindData(
            kind="seq_scan",
            payload=table_name,
            types=entry.column_types,
            names=entry.column_names,
        )

    def execute(self, db, bind_data, projection=None, bounds=None) -> DeviceBatch:
        entry = db.catalog.table(bind_data.payload)
        return entry.storage.scan(db.device, projection=projection, bounds=bounds)


class ReadCsv(TableFunction):
    """read_csv('path', delim=>',', header=>true). The parsed table is cached
    on the Database keyed by (path, delim, header) so repeated queries reuse
    the device-resident columns."""

    name = "read_csv"

    def bind(self, db, args, named_args) -> TableFunctionBindData:
        if not args:
            raise BinderError("read_csv requires a file path argument")
        path = args[0].value
        delim = ","
        header = True
        if "delim" in named_args:
            delim = named_args["delim"].value
        if "delimiter" in named_args:
            delim = named_args["delimiter"].value
        if "header" in named_args:
            header = bool(named_args["header"].value)
        table = db.csv_cache_load(path, delim, header)
        return TableFunctionBindData(
            kind="read_csv",
            payload=(path, delim, header),
            types=list(table.types),
            names=list(table.names),
        )

    def execute(self, db, bind_data, projection=None, bounds=None) -> DeviceBatch:
        path, delim, header = bind_data.payload
        table = db.csv_cache_load(path, delim, header)
        return table.scan(db.device, projection=projection, bounds=bounds)


class SqlrsTables(TableFunction):
    name = "sqlrs_tables"

    _TYPES = [LogicalType.VARCHAR, LogicalType.BIGINT, LogicalType.VARCHAR]
    _NAMES = ["schema_name", "schema_oid", "table_name"]

    def bind(self, db, args, named_args) -> TableFunctionBindData:
        return TableFunctionBindData(
            kind="sqlrs_tables", types=list(self._TYPES), names=list(self._NAMES)
        )

    def execute(self, db, bind_data, projection=None, bounds=None) -> DeviceBatch:
        rows = []
        for schema in db.catalog.schemas.values():
            for t in schema.tables.values():
                rows.append([schema.name, schema.oid, t.name])
        table = _rows_to_table(self._NAMES, self._TYPES, rows)
        return table.scan(db.device, projection=projection, bounds=bounds)


class SqlrsColumns(TableFunction):
    name = "sqlrs_columns"

    _TYPES = [LogicalType.VARCHAR, LogicalType.VARCHAR, LogicalType.VARCHAR]
    _NAMES = ["table_name", "column_names", "column_types"]

    def bind(self, db, args, named_args) -> TableFunctionBindData:
        return TableFunctionBindData(
            kind="sqlrs_columns", types=list(self._TYPES), names=list(self._NAMES)
        )

    def execute(self, db, bind_data, projection=None, bounds=None) -> DeviceBatch:
        rows = []
        for schema in db.catalog.schemas.values():
            for t in schema.tables.values():
                names = "[" + ", ".join(c.name for c in t.columns) + "]"
                types = "[" + ", ".join(str(c.type) for c in t.columns) + "]"
                rows.append([t.name, names, types])
        table = _rows_to_table(self._NAMES, self._TYPES, rows)
        return table.scan(db.device, projection=projection, bounds=bounds)


def _rows_to_table(names, types, rows) -> DataTable:
    t = DataTable(list(names), list(types))
    if rows:
        t.append_rows(
            [[ScalarValue(ty, v) for ty, v in zip(types, row)] for row in rows]
        )
    return t


BUILTIN_TABLE_FUNCTIONS = [SeqTableScan(), ReadCsv(), SqlrsTables(), SqlrsColumns()]
