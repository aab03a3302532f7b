"""CSV → device-resident columnar table.

Behavioral parity with the reference's two CSV paths:
- v1 CsvStorage with arrow `infer_reader_schema` over a 10-row sample, header
  on, ',' delimiter (reference src/storage/csv.rs:90-141);
- v2 `read_csv` table function with `delim`/`header` named args and the same
  inference (reference src/function/table/read_csv.rs:17-198).

Inference order per column (arrow-csv semantics): Boolean, Int64, Float64,
Date32, else Utf8. Empty fields are NULL for non-utf8 columns and the empty
string for utf8 columns (this is what makes `(empty)` vs NULL rendering in
the slt suite come out right).

A native C++ loader (native/csv_loader.cpp, bound in storage/native_loader.py)
takes the hot parse path when it builds; this module is the always-available
fallback and the single source of truth for inference semantics.
"""

from __future__ import annotations

import csv as _csv
import re
from dataclasses import dataclass

import numpy as np

from sqlrs_tpu_torch.data.strings import GLOBAL_STRINGS, NULL_CODE
from sqlrs_tpu_torch.errors import StorageError
from sqlrs_tpu_torch.storage.memory import DataTable
from sqlrs_tpu_torch.types import LogicalType
from sqlrs_tpu_torch.types.values import date_str_to_days

_DATE_RE = re.compile(r"^\d{4}-\d{2}-\d{2}$")
_INT_RE = re.compile(r"^-?\d+$")
_FLOAT_RE = re.compile(r"^-?(\d+(\.\d*)?|\.\d+)([eE][-+]?\d+)?$")
INFER_SAMPLE_ROWS = 10  # reference src/storage/csv.rs:133-141


@dataclass
class CsvConfig:
    has_header: bool = True
    delimiter: str = ","
    batch_size: int = 1024
    infer_rows: int = INFER_SAMPLE_ROWS


def _infer_column_type(values: list[str]) -> LogicalType:
    non_empty = [v for v in values if v != ""]
    if not non_empty:
        return LogicalType.VARCHAR
    if all(v.lower() in ("true", "false") for v in non_empty):
        return LogicalType.BOOLEAN
    if all(_INT_RE.match(v) for v in non_empty):
        return LogicalType.BIGINT
    if all(_FLOAT_RE.match(v) for v in non_empty):
        return LogicalType.DOUBLE
    if all(_DATE_RE.match(v) for v in non_empty):
        return LogicalType.DATE
    return LogicalType.VARCHAR


def load_csv(path: str, config: CsvConfig | None = None) -> DataTable:
    """Preferred entry: the native C++ parser (native/csv_loader.cpp) when it
    builds, else the in-Python reference implementation below. Both produce
    identical tables (tests/test_torch_native_loader.py cross-checks)."""
    from sqlrs_tpu_torch.storage import native_loader

    if native_loader.native_available():
        try:
            return native_loader.read_csv_native(path, config)
        except StorageError:
            raise
        except Exception:
            pass  # any binding-level surprise falls back to the Python path
    return read_csv_file(path, config)


def read_csv_file(path: str, config: CsvConfig | None = None) -> DataTable:
    config = config or CsvConfig()
    try:
        with open(path, newline="", encoding="utf-8") as f:
            reader = _csv.reader(f, delimiter=config.delimiter)
            rows = list(reader)
    except OSError as e:
        raise StorageError(f"cannot read csv {path!r}: {e}")
    if not rows:
        raise StorageError(f"empty csv file {path!r}")

    rows = [r for r in rows if r]  # blank lines are skipped (arrow-csv behavior)
    if not rows:
        raise StorageError(f"empty csv file {path!r}")
    if config.has_header:
        names = [c.strip() for c in rows[0]]
        data_rows = rows[1:]
    else:
        names = [f"column_{i + 1}" for i in range(len(rows[0]))]
        data_rows = rows

    ncols = len(names)
    for r in data_rows:
        if len(r) != ncols:
            # pad short rows with empties (arrow-csv tolerates trailing blanks)
            while len(r) < ncols:
                r.append("")

    sample = data_rows[: config.infer_rows]
    types = [_infer_column_type([r[i] for r in sample]) for i in range(ncols)]

    table = DataTable(names, types)
    n = len(data_rows)
    cols: list[np.ndarray] = []
    valids: list[np.ndarray] = []
    for i, t in enumerate(types):
        raw = [r[i] for r in data_rows]
        valid = np.ones(n, dtype=np.bool_)
        if t == LogicalType.VARCHAR:
            data = np.fromiter(
                (GLOBAL_STRINGS.intern(v) for v in raw), dtype=np.int32, count=n
            )
        elif t == LogicalType.BIGINT:
            data = np.zeros(n, dtype=np.int64)
            for j, v in enumerate(raw):
                if v == "":
                    valid[j] = False
                else:
                    try:
                        data[j] = int(v)
                    except ValueError:
                        raise StorageError(
                            f"csv {path!r} row {j}: {v!r} is not an integer"
                        )
        elif t == LogicalType.DOUBLE:
            data = np.zeros(n, dtype=np.float64)
            for j, v in enumerate(raw):
                if v == "":
                    valid[j] = False
                else:
                    data[j] = float(v)
        elif t == LogicalType.BOOLEAN:
            data = np.zeros(n, dtype=np.bool_)
            for j, v in enumerate(raw):
                if v == "":
                    valid[j] = False
                else:
                    data[j] = v.lower() == "true"
        elif t == LogicalType.DATE:
            data = np.zeros(n, dtype=np.int32)
            for j, v in enumerate(raw):
                if v == "":
                    valid[j] = False
                else:
                    data[j] = date_str_to_days(v)
        else:
            raise StorageError(f"unexpected inferred type {t}")
        cols.append(data)
        valids.append(valid)
    table.append_numpy(cols, valids)
    return table
