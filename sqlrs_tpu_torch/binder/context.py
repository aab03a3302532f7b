"""Bind context: table-alias → Binding registry.

Parity with the reference v2's table-index–based BindContext
(reference src/planner_v2/binder/bind_context.rs:12, binding.rs:12) plus the
v1 binder's ambiguity checks (reference src/binder/expression/mod.rs:177-214).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from sqlrs_tpu_torch.errors import BinderError
from sqlrs_tpu_torch.types import LogicalType


@dataclass
class Binding:
    alias: str
    table_index: int
    names: list[str]
    types: list[LogicalType]

    def try_column(self, name: str) -> int | None:
        try:
            return self.names.index(name)
        except ValueError:
            return None


@dataclass
class BindContext:
    """One SELECT scope's bindings. `parent` chains to the enclosing scope
    for correlated subqueries (the reference v2 models this as the
    ColumnRef depth field, src/planner_v2/binder/expression/
    bind_column_ref_expression.rs:13); table indexes are globally unique
    here, so resolution through the chain needs no depth bookkeeping — the
    binder records which table indexes came from an outer scope."""

    bindings: list[Binding] = field(default_factory=list)
    parent: "BindContext | None" = None

    def add(self, binding: Binding) -> None:
        if any(b.alias == binding.alias for b in self.bindings):
            raise BinderError(f"duplicate table alias {binding.alias!r}")
        self.bindings.append(binding)

    def get(self, alias: str) -> Binding:
        for b in self.bindings:
            if b.alias == alias:
                return b
        raise BinderError(f"table {alias!r} not found in FROM clause")

    def try_get(self, alias: str) -> Binding | None:
        for b in self.bindings:
            if b.alias == alias:
                return b
        return None

    def try_resolve_unqualified(self, column: str) -> tuple[Binding, int] | None:
        """None when not found in THIS scope; raises on ambiguity (ambiguity
        within a scope is an error even if an outer scope could resolve)."""
        hits: list[tuple[Binding, int]] = []
        for b in self.bindings:
            ci = b.try_column(column)
            if ci is not None:
                hits.append((b, ci))
        if not hits:
            return None
        if len(hits) > 1:
            raise BinderError(f"ambiguous column name {column!r}")
        return hits[0]

    def resolve_qualified(self, alias: str, column: str) -> tuple[Binding, int]:
        b = self.get(alias)
        ci = b.try_column(column)
        if ci is None:
            raise BinderError(f"column {column!r} not found in table {alias!r}")
        return b, ci

    def resolve_unqualified(self, column: str) -> tuple[Binding, int]:
        hits: list[tuple[Binding, int]] = []
        for b in self.bindings:
            ci = b.try_column(column)
            if ci is not None:
                hits.append((b, ci))
        if not hits:
            raise BinderError(f"column {column!r} not found")
        if len(hits) > 1:
            raise BinderError(f"ambiguous column name {column!r}")
        return hits[0]
