"""Aggregate function registry: return-type rules.

Parity with the reference's accumulator set (reference
src/executor/aggregate/mod.rs:27-45 `create_accumulator`): sum, count,
min, max (+ DISTINCT variants, reference sum.rs:99, count.rs:31), extended
with avg. Result types follow the reference's type-coercing `sum_result`
(reference src/executor/aggregate/sum.rs:64): integer sums widen to BIGINT.

Note the reference's CountAccumulator has a latent overwrite-instead-of-add
bug (reference src/executor/aggregate/count.rs:21-22) masked by its
single-stream call pattern; we implement correct accumulation and match the
*observed* slt outputs (SURVEY.md §7 "count bug fidelity").
"""

from __future__ import annotations

from sqlrs_tpu_torch.errors import BinderError
from sqlrs_tpu_torch.types import LogicalType

AGGREGATE_NAMES = ("sum", "count", "min", "max", "avg")


def aggregate_return_type(name: str, arg_type: LogicalType | None) -> LogicalType:
    if name == "count":
        return LogicalType.BIGINT
    if arg_type is None:
        raise BinderError(f"aggregate {name} requires an argument")
    if name == "avg":
        if not (arg_type.is_numeric() or arg_type == LogicalType.SQLNULL):
            raise BinderError(f"avg does not support type {arg_type}")
        return LogicalType.DOUBLE
    if name == "sum":
        if arg_type == LogicalType.SQLNULL:
            return LogicalType.SQLNULL
        if arg_type.is_signed_numeric():
            return LogicalType.BIGINT
        if arg_type.is_unsigned_numeric():
            return LogicalType.UBIGINT
        if arg_type == LogicalType.FLOAT:
            return LogicalType.FLOAT
        if arg_type == LogicalType.DOUBLE:
            return LogicalType.DOUBLE
        raise BinderError(f"sum does not support type {arg_type}")
    if name in ("min", "max"):
        return arg_type
    raise BinderError(f"unknown aggregate function {name}")
