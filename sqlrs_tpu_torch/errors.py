"""Typed error hierarchy.

Mirrors the reference's thiserror enums threaded through every layer
(reference src/db.rs:188-230, src/main_entry/errors.rs:9-49,
src/executor/mod.rs:67-85): a failed statement aborts only that statement.
"""


class SqlrsError(Exception):
    """Base error for all engine layers."""


class ParserError(SqlrsError):
    pass


class TypeError_(SqlrsError):
    """Type-system error (named to avoid shadowing builtins.TypeError)."""


class CatalogError(SqlrsError):
    pass


class BinderError(SqlrsError):
    pass


class PlannerError(SqlrsError):
    pass


class OptimizerError(SqlrsError):
    pass


class ExecutorError(SqlrsError):
    pass


class StorageError(SqlrsError):
    pass
