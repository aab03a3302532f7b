"""Scalar values.

Parity targets: the reference's two ScalarValue generations
(reference src/types/mod.rs:23-236 and src/types_v2/values.rs:22-363).
A scalar is (logical type, host python value); NULL is value=None of any type.
Numeric literals type as INTEGER when they fit in i32, else BIGINT, matching
the reference's i32-first literal typing (reference src/types/mod.rs:148-162);
decimal literals type as DOUBLE.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from sqlrs_tpu_torch.errors import TypeError_
from sqlrs_tpu_torch.types.types import INT_RANGES, LogicalType


MS_PER_DAY = 86_400_000


@dataclass(frozen=True)
class Interval:
    """Calendar interval.

    `months` models arrow IntervalYearMonth; `raw_ms` models the arrow
    IntervalDayTime i64 *bit pattern* the reference builds from literals as a
    flat millisecond count (reference
    src/planner_v2/expression_binder.rs:149-164: DAY → num*86400000 etc.).
    Date arithmetic reproduces arrow 28's `Date32Type::add_day_time` exactly:
    the i64 splits into (days = high 32, ms = low 32 bitcast), both are added
    to midnight, and the result floors back to a date. Negating the flat
    count therefore shifts by -2 days for interval '1' day — the reference's
    observed `date '1998-12-01' - interval '1' day` = 1998-11-29 — and this
    implementation is bit-compatible with that behavior.
    """

    months: int = 0
    raw_ms: int = 0

    def negate(self) -> "Interval":
        return Interval(-self.months, -self.raw_ms)

    def day_shift(self) -> int:
        """Whole-day displacement of the day-time part (arrow to_parts +
        floor-to-date semantics)."""
        days_hi = self.raw_ms >> 32  # arithmetic shift
        ms_lo = self.raw_ms & 0xFFFFFFFF
        if ms_lo >= 2**31:
            ms_lo -= 2**32
        total_ms = days_hi * MS_PER_DAY + ms_lo
        return total_ms // MS_PER_DAY  # floor division

    # device packing (interval columns are rare; months and raw day-time ms
    # never coexist for literal-built intervals)
    def pack(self) -> int:
        if self.months:
            return (1 << 62) | (self.months & 0xFFFFFFFF)
        return self.raw_ms

    @staticmethod
    def unpack(packed: int) -> "Interval":
        if packed >> 62 == 1:
            months = packed & 0xFFFFFFFF
            if months >= 2**31:
                months -= 2**32
            return Interval(months=months)
        return Interval(raw_ms=packed)


@dataclass(frozen=True)
class ScalarValue:
    type: LogicalType
    value: Any  # None => NULL

    # ---- constructors ----------------------------------------------------

    @staticmethod
    def null() -> "ScalarValue":
        return ScalarValue(LogicalType.SQLNULL, None)

    @staticmethod
    def boolean(v: bool) -> "ScalarValue":
        return ScalarValue(LogicalType.BOOLEAN, bool(v))

    @staticmethod
    def integer_literal(v: int) -> "ScalarValue":
        if -(2**31) <= v <= 2**31 - 1:
            return ScalarValue(LogicalType.INTEGER, int(v))
        return ScalarValue(LogicalType.BIGINT, int(v))

    @staticmethod
    def double(v: float) -> "ScalarValue":
        return ScalarValue(LogicalType.DOUBLE, float(v))

    @staticmethod
    def varchar(v: str) -> "ScalarValue":
        return ScalarValue(LogicalType.VARCHAR, str(v))

    @staticmethod
    def date_from_string(s: str) -> "ScalarValue":
        return ScalarValue(LogicalType.DATE, date_str_to_days(s))

    @staticmethod
    def interval(months: int = 0, raw_ms: int = 0) -> "ScalarValue":
        return ScalarValue(LogicalType.INTERVAL, Interval(months, raw_ms))

    # ---- properties ------------------------------------------------------

    @property
    def is_null(self) -> bool:
        return self.value is None

    # ---- casting (constant folding / insert coercion) --------------------

    def cast_to(self, target: LogicalType, safe: bool = False) -> "ScalarValue":
        """Cast with overflow checking (reference `try_cast` semantics via
        cast_with_options, src/function/cast/default_cast.rs:11-36).
        safe=True yields NULL instead of raising on failure."""
        if self.is_null or target == self.type:
            return ScalarValue(target, self.value)
        try:
            return ScalarValue(target, _convert(self.value, self.type, target))
        except (TypeError_, ValueError, OverflowError):
            if safe:
                return ScalarValue(target, None)
            raise TypeError_(f"cannot cast {self.value!r} from {self.type} to {target}")

    def __str__(self) -> str:
        from sqlrs_tpu_torch.utils.render import render_scalar

        return render_scalar(self)


def _convert(v: Any, src: LogicalType, dst: LogicalType) -> Any:
    if dst == LogicalType.VARCHAR:
        from sqlrs_tpu_torch.utils.render import render_scalar

        return render_scalar(ScalarValue(src, v))
    if dst == LogicalType.BOOLEAN:
        if src == LogicalType.VARCHAR:
            lv = v.strip().lower()
            if lv in ("true", "t", "1"):
                return True
            if lv in ("false", "f", "0"):
                return False
            raise TypeError_(f"invalid boolean literal {v!r}")
        return bool(v)
    if dst.is_integral():
        if src == LogicalType.VARCHAR:
            iv = int(v.strip())
        elif src == LogicalType.BOOLEAN:
            iv = int(v)
        elif src.is_float():
            iv = int(v)  # truncate toward zero like arrow cast
        else:
            iv = int(v)
        lo, hi = INT_RANGES[dst]
        if not (lo <= iv <= hi):
            raise OverflowError(f"{iv} out of range for {dst}")
        return iv
    if dst.is_float():
        if src == LogicalType.VARCHAR:
            return float(v.strip())
        fv = float(v)
        if dst == LogicalType.FLOAT:
            fv = float(np.float32(fv))
        return fv
    if dst == LogicalType.DATE:
        if src == LogicalType.VARCHAR:
            return date_str_to_days(v)
        raise TypeError_(f"cannot cast {src} to Date")
    raise TypeError_(f"cannot cast {src} to {dst}")


# ---- civil date math (vectorizable; also used by ops/datetime.py) ---------


def date_str_to_days(s: str) -> int:
    parts = s.strip().split("-")
    if len(parts) != 3:
        raise TypeError_(f"invalid date literal {s!r}")
    y, m, d = (int(p) for p in parts)
    return days_from_civil(y, m, d)


def days_from_civil(y: int, m: int, d: int) -> int:
    """Days since 1970-01-01 (proleptic Gregorian), integer-only math."""
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def civil_from_days(z: int) -> tuple[int, int, int]:
    z += 719468
    era = (z if z >= 0 else z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + (3 if mp < 10 else -9)
    return (y + (m <= 2), m, d)
