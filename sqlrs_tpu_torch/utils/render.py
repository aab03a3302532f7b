"""Result rendering.

Reproduces the reference's sqllogictest rendering rules exactly
(reference src/util/mod.rs:53-80 `record_batch_to_string`):
- NULL            -> "NULL"
- empty string    -> "(empty)"
- booleans        -> "true" / "false"
- floats          -> Rust `Display` style: shortest round-trip repr, and
                     integral floats print without a fractional part ("2")
- dates           -> ISO "YYYY-MM-DD"
Values in a row are joined by a single space.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from sqlrs_tpu_torch.types import Interval, LogicalType, ScalarValue
from sqlrs_tpu_torch.types.values import civil_from_days


def _format_float(v: float, single: bool) -> str:
    if v != v:  # NaN
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "inf" if v > 0 else "-inf"
    if v == int(v) and abs(v) < 1e16:
        return str(int(v))
    if single:
        s = np.format_float_positional(np.float32(v), unique=True, trim="-")
    else:
        s = repr(float(v))
    return s


def render_value(t: LogicalType, v: Any) -> str:
    if v is None:
        return "NULL"
    if t == LogicalType.BOOLEAN:
        return "true" if v else "false"
    if t == LogicalType.VARCHAR:
        return "(empty)" if v == "" else str(v)
    if t == LogicalType.FLOAT:
        return _format_float(float(v), single=True)
    if t == LogicalType.DOUBLE:
        return _format_float(float(v), single=False)
    if t == LogicalType.DATE:
        y, m, d = civil_from_days(int(v))
        return f"{y:04d}-{m:02d}-{d:02d}"
    if t == LogicalType.INTERVAL:
        iv = v if isinstance(v, Interval) else Interval.unpack(int(v))
        parts = []
        if iv.months:
            parts.append(f"{iv.months} mons")
        if iv.raw_ms or not parts:
            parts.append(f"{iv.raw_ms} ms")
        return " ".join(parts)
    return str(v)


def render_scalar(sv: ScalarValue) -> str:
    return render_value(sv.type, sv.value)


def batch_to_rows(batch) -> list[list[str]]:
    types = batch.schema.types
    return [
        [render_value(t, v) for t, v in zip(types, row)] for row in batch.to_pylist()
    ]


def batches_to_slt_lines(batches) -> list[str]:
    lines: list[str] = []
    for b in batches:
        for row in batch_to_rows(b):
            lines.append(" ".join(row))
    return lines


def pretty_table(header: list[str], rows: list[list[str]]) -> str:
    """Boxed ASCII table for the CLI (reference src/util/mod.rs:14-29)."""
    widths = [len(h) for h in header]
    for row in rows:
        for i, cell in enumerate(row):
            widths[i] = max(widths[i], len(cell))
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [sep, "| " + " | ".join(h.ljust(w) for h, w in zip(header, widths)) + " |", sep]
    for row in rows:
        out.append("| " + " | ".join(c.ljust(w) for c, w in zip(row, widths)) + " |")
    out.append(sep)
    return "\n".join(out)
