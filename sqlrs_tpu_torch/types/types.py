"""Logical type system and implicit-cast lattice.

Behavioral parity with the reference's v2 type system
(reference src/types_v2/types.rs:9-200): 16 logical types, numeric
max-type combination, implicit-cast rules, and the cast-cost function used
for function-overload resolution (reference
src/function/cast/cast_rules.rs:6-14).

On device every type maps to a fixed-width jax/numpy dtype; VARCHAR columns
hold int32 codes into an interning dictionary (sqlrs_tpu_torch/data/strings.py) and
INTERVAL packs (months, days) into one int64 — both so that all column data is
dense fixed-width arrays XLA can tile.
"""

from __future__ import annotations

import enum

import numpy as np

from sqlrs_tpu_torch.errors import TypeError_

INTERVAL_UNIT_YEAR_MONTH = "YearMonth"
INTERVAL_UNIT_DAY_TIME = "DayTime"


class LogicalType(enum.Enum):
    INVALID = "Invalid"
    SQLNULL = "SqlNull"
    BOOLEAN = "Boolean"
    TINYINT = "Tinyint"
    UTINYINT = "UTinyint"
    SMALLINT = "Smallint"
    USMALLINT = "USmallint"
    INTEGER = "Integer"
    UINTEGER = "UInteger"
    BIGINT = "Bigint"
    UBIGINT = "UBigint"
    FLOAT = "Float"
    DOUBLE = "Double"
    VARCHAR = "Varchar"
    DATE = "Date"
    INTERVAL = "Interval"

    # ---- predicates ------------------------------------------------------

    def is_numeric(self) -> bool:
        return self in _NUMERIC

    def is_signed_numeric(self) -> bool:
        return self in (
            LogicalType.TINYINT,
            LogicalType.SMALLINT,
            LogicalType.INTEGER,
            LogicalType.BIGINT,
        )

    def is_unsigned_numeric(self) -> bool:
        return self in (
            LogicalType.UTINYINT,
            LogicalType.USMALLINT,
            LogicalType.UINTEGER,
            LogicalType.UBIGINT,
        )

    def is_integral(self) -> bool:
        return self.is_numeric() and self not in (LogicalType.FLOAT, LogicalType.DOUBLE)

    def is_float(self) -> bool:
        return self in (LogicalType.FLOAT, LogicalType.DOUBLE)

    def __repr__(self) -> str:  # "Integer" — used by plan/explain rendering
        return self.value

    def __str__(self) -> str:
        return self.value


_NUMERIC = (
    LogicalType.TINYINT,
    LogicalType.UTINYINT,
    LogicalType.SMALLINT,
    LogicalType.USMALLINT,
    LogicalType.INTEGER,
    LogicalType.UINTEGER,
    LogicalType.BIGINT,
    LogicalType.UBIGINT,
    LogicalType.FLOAT,
    LogicalType.DOUBLE,
)

# Valid implicit widening targets per type (reference
# src/types_v2/types.rs:138-200 `can_implicit_cast`).
_IMPLICIT_TARGETS: dict[LogicalType, tuple[LogicalType, ...]] = {
    LogicalType.INVALID: (),
    LogicalType.SQLNULL: tuple(t for t in LogicalType),  # NULL casts to anything
    LogicalType.BOOLEAN: (),
    LogicalType.TINYINT: (
        LogicalType.SMALLINT,
        LogicalType.INTEGER,
        LogicalType.BIGINT,
        LogicalType.FLOAT,
        LogicalType.DOUBLE,
    ),
    LogicalType.UTINYINT: (
        LogicalType.USMALLINT,
        LogicalType.UINTEGER,
        LogicalType.UBIGINT,
        LogicalType.SMALLINT,
        LogicalType.INTEGER,
        LogicalType.BIGINT,
        LogicalType.FLOAT,
        LogicalType.DOUBLE,
    ),
    LogicalType.SMALLINT: (
        LogicalType.INTEGER,
        LogicalType.BIGINT,
        LogicalType.FLOAT,
        LogicalType.DOUBLE,
    ),
    LogicalType.USMALLINT: (
        LogicalType.UINTEGER,
        LogicalType.UBIGINT,
        LogicalType.INTEGER,
        LogicalType.BIGINT,
        LogicalType.FLOAT,
        LogicalType.DOUBLE,
    ),
    LogicalType.INTEGER: (LogicalType.BIGINT, LogicalType.FLOAT, LogicalType.DOUBLE),
    LogicalType.UINTEGER: (
        LogicalType.UBIGINT,
        LogicalType.BIGINT,
        LogicalType.FLOAT,
        LogicalType.DOUBLE,
    ),
    LogicalType.BIGINT: (LogicalType.FLOAT, LogicalType.DOUBLE),
    LogicalType.UBIGINT: (LogicalType.FLOAT, LogicalType.DOUBLE),
    LogicalType.FLOAT: (LogicalType.DOUBLE,),
    LogicalType.DOUBLE: (),
    LogicalType.VARCHAR: (),
    LogicalType.DATE: (),
    LogicalType.INTERVAL: (),
}


def can_implicit_cast(src: LogicalType, dst: LogicalType) -> bool:
    if src == dst:
        return True
    return dst in _IMPLICIT_TARGETS[src]


def implicit_cast_cost(src: LogicalType, dst: LogicalType) -> int:
    """Overload-resolution cost: 0 exact, 1 implicit widening, -1 impossible
    (reference src/function/cast/cast_rules.rs:6-14)."""
    if src == dst:
        return 0
    if can_implicit_cast(src, dst):
        return 1
    return -1


def combine_numeric_types(left: LogicalType, right: LogicalType) -> LogicalType:
    """Numeric max-type (reference src/types_v2/types.rs:102-137)."""
    if left == right:
        return left
    if left.is_signed_numeric() and right.is_unsigned_numeric():
        # symmetric; arrange so the unsigned side is on the left
        return combine_numeric_types(right, left)
    if can_implicit_cast(left, right):
        return right
    if can_implicit_cast(right, left):
        return left
    # signed/unsigned of the same width: upcast so both fit
    if LogicalType.BIGINT in (left, right) or LogicalType.UBIGINT in (left, right):
        return LogicalType.DOUBLE
    if LogicalType.INTEGER in (left, right) or LogicalType.UINTEGER in (left, right):
        return LogicalType.BIGINT
    if LogicalType.SMALLINT in (left, right) or LogicalType.USMALLINT in (left, right):
        return LogicalType.INTEGER
    if LogicalType.TINYINT in (left, right) or LogicalType.UTINYINT in (left, right):
        return LogicalType.SMALLINT
    raise TypeError_(f"can not combine numeric types {left} and {right}")


def max_logical_type(left: LogicalType, right: LogicalType) -> LogicalType:
    """Common supertype of two types (reference src/types_v2/types.rs:80-100).

    Raises when the types are incomparable (e.g. Varchar vs Integer) — this is
    what makes `select 'abc' > 10` a bind error.
    """
    if left == right:
        return left
    if left == LogicalType.SQLNULL:
        return right
    if right == LogicalType.SQLNULL:
        return left
    if left.is_numeric() and right.is_numeric():
        return combine_numeric_types(left, right)
    raise TypeError_(f"can not compare two types: {left} and {right}")


# ---- physical (device) representation ------------------------------------

_NUMPY_DTYPES: dict[LogicalType, np.dtype] = {
    LogicalType.SQLNULL: np.dtype(np.int32),  # all-invalid placeholder column
    LogicalType.BOOLEAN: np.dtype(np.bool_),
    LogicalType.TINYINT: np.dtype(np.int8),
    LogicalType.UTINYINT: np.dtype(np.uint8),
    LogicalType.SMALLINT: np.dtype(np.int16),
    LogicalType.USMALLINT: np.dtype(np.uint16),
    LogicalType.INTEGER: np.dtype(np.int32),
    LogicalType.UINTEGER: np.dtype(np.uint32),
    LogicalType.BIGINT: np.dtype(np.int64),
    LogicalType.UBIGINT: np.dtype(np.uint64),
    LogicalType.FLOAT: np.dtype(np.float32),
    LogicalType.DOUBLE: np.dtype(np.float64),
    LogicalType.VARCHAR: np.dtype(np.int32),  # dictionary codes
    LogicalType.DATE: np.dtype(np.int32),  # days since unix epoch
    LogicalType.INTERVAL: np.dtype(np.int64),  # months << 32 | (days & 0xffffffff)
}


def numpy_dtype_for(t: LogicalType) -> np.dtype:
    try:
        return _NUMPY_DTYPES[t]
    except KeyError:
        raise TypeError_(f"type {t} has no device representation")


# ---- SQL type-name parsing (reference src/types_v2/types.rs:204-260) ------

_TYPE_NAMES = {
    "BOOLEAN": LogicalType.BOOLEAN,
    "BOOL": LogicalType.BOOLEAN,
    "TINYINT": LogicalType.TINYINT,
    "SMALLINT": LogicalType.SMALLINT,
    "INT": LogicalType.INTEGER,
    "INTEGER": LogicalType.INTEGER,
    "BIGINT": LogicalType.BIGINT,
    "FLOAT": LogicalType.FLOAT,
    "REAL": LogicalType.FLOAT,
    "DOUBLE": LogicalType.DOUBLE,
    "VARCHAR": LogicalType.VARCHAR,
    "CHAR": LogicalType.VARCHAR,
    "TEXT": LogicalType.VARCHAR,
    "STRING": LogicalType.VARCHAR,
    "DATE": LogicalType.DATE,
    "INTERVAL": LogicalType.INTERVAL,
}

_UNSIGNED_MAP = {
    LogicalType.TINYINT: LogicalType.UTINYINT,
    LogicalType.SMALLINT: LogicalType.USMALLINT,
    LogicalType.INTEGER: LogicalType.UINTEGER,
    LogicalType.BIGINT: LogicalType.UBIGINT,
}


def parse_type_name(name: str, unsigned: bool = False) -> LogicalType:
    t = _TYPE_NAMES.get(name.upper())
    if t is None:
        raise TypeError_(f"unsupported SQL type: {name}")
    if unsigned:
        if t not in _UNSIGNED_MAP:
            raise TypeError_(f"type {name} can not be unsigned")
        t = _UNSIGNED_MAP[t]
    return t


# Integer range checks for runtime casts (insert overflow errors, reference
# insert_table.slt `insert into t3(v1) values (1481)` on TINYINT UNSIGNED).
INT_RANGES: dict[LogicalType, tuple[int, int]] = {
    LogicalType.TINYINT: (-(2**7), 2**7 - 1),
    LogicalType.UTINYINT: (0, 2**8 - 1),
    LogicalType.SMALLINT: (-(2**15), 2**15 - 1),
    LogicalType.USMALLINT: (0, 2**16 - 1),
    LogicalType.INTEGER: (-(2**31), 2**31 - 1),
    LogicalType.UINTEGER: (0, 2**32 - 1),
    LogicalType.BIGINT: (-(2**63), 2**63 - 1),
    LogicalType.UBIGINT: (0, 2**64 - 1),
}
