from sqlrs_tpu_torch.types.types import (
    INTERVAL_UNIT_DAY_TIME,
    INTERVAL_UNIT_YEAR_MONTH,
    LogicalType,
    can_implicit_cast,
    combine_numeric_types,
    implicit_cast_cost,
    max_logical_type,
    numpy_dtype_for,
    parse_type_name,
)
from sqlrs_tpu_torch.types.values import Interval, ScalarValue

__all__ = [
    "LogicalType",
    "max_logical_type",
    "combine_numeric_types",
    "can_implicit_cast",
    "implicit_cast_cost",
    "numpy_dtype_for",
    "parse_type_name",
    "ScalarValue",
    "Interval",
    "INTERVAL_UNIT_YEAR_MONTH",
    "INTERVAL_UNIT_DAY_TIME",
]
