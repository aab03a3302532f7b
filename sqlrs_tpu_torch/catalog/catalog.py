"""Versioned catalog: schema → {tables, table functions, scalar function sets}.

Parity with the reference's v2 catalog (reference src/catalog_v2/catalog.rs:13,
catalog_set.rs:7, entry/schema_catalog_entry.rs:10, entry/table_catalog_entry.rs:10):
a Catalog holds CatalogSets of named entries with oids; the default schema is
"main" and builtins are registered at instance init (reference
src/main_entry/db.rs:15-41). The v1 string-keyed RootCatalog
(reference src/catalog/mod.rs:11-91) is subsumed: v1 CSV sessions just create
tables in "main" backed by CSV-loaded storage.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Optional

from sqlrs_tpu_torch.errors import CatalogError
from sqlrs_tpu_torch.types import LogicalType

if TYPE_CHECKING:
    from sqlrs_tpu_torch.storage.memory import DataTable

DEFAULT_SCHEMA = "main"


@dataclass
class ColumnDefinition:
    name: str
    type: LogicalType


@dataclass
class TableCatalogEntry:
    oid: int
    name: str
    schema: str
    columns: list[ColumnDefinition]
    storage: "DataTable"
    # hash-partitioning spec for distributed tables: column indices the table
    # is partitioned by across the mesh (None = replicated/single-device)
    partition_keys: Optional[list[int]] = None

    @property
    def column_names(self) -> list[str]:
        return [c.name for c in self.columns]

    @property
    def column_types(self) -> list[LogicalType]:
        return [c.type for c in self.columns]

    def column_index(self, name: str) -> int:
        for i, c in enumerate(self.columns):
            if c.name == name:
                return i
        raise CatalogError(f"column {name!r} not found in table {self.name}")


@dataclass
class SchemaCatalogEntry:
    oid: int
    name: str
    tables: dict[str, TableCatalogEntry] = field(default_factory=dict)
    table_functions: dict[str, Any] = field(default_factory=dict)
    scalar_functions: dict[str, Any] = field(default_factory=dict)
    aggregate_functions: dict[str, Any] = field(default_factory=dict)
    views: dict[str, "ViewCatalogEntry"] = field(default_factory=dict)


@dataclass
class ViewCatalogEntry:
    """A named stored SELECT (CREATE VIEW ... AS). Views are pure catalog
    metadata: the query AST is re-bound at every use site, so they always
    reflect current table contents (the TPC-H Q15 revenue view shape)."""

    oid: int
    name: str
    column_names: list[str]  # empty => the query's own output names
    query: Any  # ast.SelectStmt


class Catalog:
    """Per-DatabaseInstance catalog; bumping `version` on every DDL mirrors
    the reference's catalog_version (reference src/catalog_v2/catalog.rs:13)."""

    def __init__(self) -> None:
        self.schemas: dict[str, SchemaCatalogEntry] = {}
        self.version = 0
        self._next_oid = 1
        self.create_schema(DEFAULT_SCHEMA)

    def _oid(self) -> int:
        oid = self._next_oid
        self._next_oid += 1
        return oid

    def create_schema(self, name: str) -> SchemaCatalogEntry:
        if name in self.schemas:
            raise CatalogError(f"schema {name!r} already exists")
        entry = SchemaCatalogEntry(self._oid(), name)
        self.schemas[name] = entry
        self.version += 1
        return entry

    def schema(self, name: str = DEFAULT_SCHEMA) -> SchemaCatalogEntry:
        try:
            return self.schemas[name]
        except KeyError:
            raise CatalogError(f"schema {name!r} does not exist")

    # ---- tables -----------------------------------------------------------

    def create_table(
        self,
        name: str,
        columns: list[ColumnDefinition],
        storage: "DataTable",
        schema: str = DEFAULT_SCHEMA,
        partition_keys: Optional[list[int]] = None,
    ) -> TableCatalogEntry:
        s = self.schema(schema)
        if name in s.tables:
            raise CatalogError(f"table {name!r} already exists")
        entry = TableCatalogEntry(
            self._oid(), name, schema, columns, storage, partition_keys
        )
        s.tables[name] = entry
        self.version += 1
        return entry

    def drop_table(self, name: str, schema: str = DEFAULT_SCHEMA) -> None:
        s = self.schema(schema)
        if name not in s.tables:
            raise CatalogError(f"table {name!r} does not exist")
        del s.tables[name]
        self.version += 1

    def table(self, name: str, schema: str = DEFAULT_SCHEMA) -> TableCatalogEntry:
        s = self.schema(schema)
        try:
            return s.tables[name]
        except KeyError:
            raise CatalogError(f"table {name!r} does not exist")

    def try_table(self, name: str, schema: str = DEFAULT_SCHEMA):
        try:
            return self.table(name, schema)
        except CatalogError:
            return None

    # ---- views -------------------------------------------------------------

    def create_view(self, name, column_names, query, schema: str = DEFAULT_SCHEMA):
        s = self.schema(schema)
        if name in s.tables or name in s.views:
            raise CatalogError(f"table or view {name!r} already exists")
        entry = ViewCatalogEntry(self._oid(), name, list(column_names), query)
        s.views[name] = entry
        self.version += 1
        return entry

    def try_view(self, name: str, schema: str = DEFAULT_SCHEMA):
        try:
            return self.schema(schema).views.get(name)
        except CatalogError:
            return None

    def drop_view(self, name: str, schema: str = DEFAULT_SCHEMA) -> None:
        s = self.schema(schema)
        if name not in s.views:
            raise CatalogError(f"view {name!r} does not exist")
        del s.views[name]
        self.version += 1

    # ---- functions ---------------------------------------------------------

    def register_table_function(self, name: str, fn, schema: str = DEFAULT_SCHEMA):
        self.schema(schema).table_functions[name] = fn
        self.version += 1

    def table_function(self, name: str, schema: str = DEFAULT_SCHEMA):
        fn = self.schema(schema).table_functions.get(name)
        if fn is None:
            raise CatalogError(f"table function {name!r} does not exist")
        return fn

    def register_scalar_function_set(self, name: str, fset, schema: str = DEFAULT_SCHEMA):
        self.schema(schema).scalar_functions[name] = fset
        self.version += 1

    def scalar_function_set(self, name: str, schema: str = DEFAULT_SCHEMA):
        fset = self.schema(schema).scalar_functions.get(name)
        if fset is None:
            raise CatalogError(f"scalar function {name!r} does not exist")
        return fset

    def register_aggregate_function(self, name: str, fn, schema: str = DEFAULT_SCHEMA):
        self.schema(schema).aggregate_functions[name] = fn
        self.version += 1

    def aggregate_function(self, name: str, schema: str = DEFAULT_SCHEMA):
        return self.schema(schema).aggregate_functions.get(name)
