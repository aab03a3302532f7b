"""Fixed-width columnar device batches with validity masks.

This is the engine's RecordBatch replacement (reference uses Arrow
`RecordBatch` throughout, e.g. src/executor/mod.rs:34). A column is a dense
torch tensor plus a boolean validity tensor on the same device; a batch is
columns + row count + the device they live on. All dtypes are fixed width
(strings are dictionary codes, data/strings.py).

The device is always explicit: every constructor that makes tensors takes
it, and a batch knows its device even when it has no columns (the 1-row
dummy batch that constant expressions broadcast over).

Host materialization (`to_pylist`) happens only at the session boundary for
result rendering.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable, Sequence

import numpy as np
import torch

from sqlrs_tpu_torch.data.strings import GLOBAL_STRINGS, NULL_CODE
from sqlrs_tpu_torch.errors import TypeError_
from sqlrs_tpu_torch.types import Interval, LogicalType, ScalarValue, numpy_dtype_for

_INT64_MIN = -(2**63)
_INT64_MAX = 2**63 - 1

# The unsigned types' tensor form. torch has no arithmetic, comparison or
# where on uint16/uint32/uint64 tensors (uint8 has them all), so UTINYINT
# is uint8, USMALLINT and UINTEGER live in the next wider signed dtype
# (always holding a value in [0, 2^16) or [0, 2^32)), and UBIGINT is the
# int64 bit pattern of the uint64 value. The host form stays numpy's
# uint8..uint64 (types/types.numpy_dtype_for); storage_np and logical_np
# convert between the two exactly.
_CONTAINERS = {
    LogicalType.USMALLINT: np.dtype(np.int32),
    LogicalType.UINTEGER: np.dtype(np.int64),
    LogicalType.UBIGINT: np.dtype(np.int64),
}
_WRAP_MASKS = {LogicalType.USMALLINT: 0xFFFF, LogicalType.UINTEGER: 0xFFFFFFFF}


def torch_dtype_for(t: LogicalType) -> torch.dtype:
    """Tensor dtype of a logical type: the numpy representation of
    types/types.py mapped one to one, except for the unsigned containers
    above."""
    return _TORCH_DTYPES[_CONTAINERS.get(t) or numpy_dtype_for(t)]


_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def storage_np(t: LogicalType, a: np.ndarray) -> np.ndarray:
    """Host values of type t (numpy's dtype for t) in the tensor form's
    numpy dtype; exact both ways with logical_np."""
    a = np.asarray(a).astype(numpy_dtype_for(t), copy=False)
    if t == LogicalType.UBIGINT:
        return np.ascontiguousarray(a).view(np.int64)
    c = _CONTAINERS.get(t)
    return a if c is None else a.astype(c)


def logical_np(t: LogicalType, a: np.ndarray) -> np.ndarray:
    """Inverse of storage_np: tensor-form host values back to numpy's
    dtype for t."""
    if t == LogicalType.UBIGINT:
        return np.ascontiguousarray(a).view(np.uint64)
    if t in _CONTAINERS:
        return a.astype(numpy_dtype_for(t))
    return a


def wrap_unsigned(t: LogicalType, x):
    """Reduce a USMALLINT/UINTEGER container tensor modulo 2^16 / 2^32, as
    numpy's uint16/uint32 arithmetic wraps; the identity for other types
    (uint8 and the UBIGINT bit pattern wrap by themselves)."""
    m = _WRAP_MASKS.get(t)
    return x if m is None else x & m


def ubigint_key(x):
    """int64 whose signed order is the unsigned order of the UBIGINT bit
    patterns `x` (the value less 2^63, wrapped)."""
    return x ^ _INT64_MIN


def ubigint_to_float(x, dtype=torch.float64):
    """The UBIGINT bit patterns `x` as floats, each rounded once to nearest
    even as numpy's uint64 -> float conversion rounds: a value >= 2^63 is
    halved with its low bit kept sticky, converted, and doubled."""
    half = ((x >> 1) & _INT64_MAX) | (x & 1)
    return torch.where(x < 0, half.to(dtype) * 2, x.to(dtype))


def float_to_ubigint(f):
    """UBIGINT bit patterns of the floats `f` (in [0, 2^64) where the
    result is used), truncated as numpy's float -> uint64 conversion."""
    f = f.to(torch.float64)
    hi = f >= 2.0**63
    lo_part = torch.where(hi, f - 2.0**63, f).to(torch.int64)
    return torch.where(hi, lo_part ^ _INT64_MIN, lo_part)


@dataclass(frozen=True)
class SchemaField:
    name: str
    type: LogicalType
    nullable: bool = True


@dataclass(frozen=True)
class Schema:
    fields: tuple[SchemaField, ...]

    @staticmethod
    def of(pairs: Iterable[tuple[str, LogicalType]]) -> "Schema":
        return Schema(tuple(SchemaField(n, t) for n, t in pairs))

    @property
    def names(self) -> list[str]:
        return [f.name for f in self.fields]

    @property
    def types(self) -> list[LogicalType]:
        return [f.type for f in self.fields]

    def __len__(self) -> int:
        return len(self.fields)


@dataclass
class Column:
    type: LogicalType
    data: Any  # torch tensor, dtype = torch_dtype_for(type)
    valid: Any  # torch bool tensor, same length and device

    def __len__(self) -> int:
        return int(self.data.shape[0])

    # ---- constructors ----------------------------------------------------

    @staticmethod
    def from_numpy(
        t: LogicalType,
        data: np.ndarray,
        valid: np.ndarray | None = None,
        *,
        device,
    ) -> "Column":
        if valid is None:
            valid = np.ones(len(data), dtype=np.bool_)
        return Column(
            t,
            host_to_device(storage_np(t, data), device),
            host_to_device(np.asarray(valid, dtype=np.bool_), device),
        )

    @staticmethod
    def from_scalars(
        t: LogicalType, values: Sequence[ScalarValue], *, device
    ) -> "Column":
        """Build a column from host scalars (literal VALUES lists, agg results)."""
        data, valid = scalars_to_numpy(t, values)
        return Column.from_numpy(t, data, valid, device=device)

    @staticmethod
    def broadcast(v: ScalarValue, t: LogicalType, n: int, *, device) -> "Column":
        """Broadcast one scalar to n rows (reference src/types/mod.rs:214)."""
        dtype = torch_dtype_for(t)
        if v.is_null:
            fill = NULL_CODE if t == LogicalType.VARCHAR else 0
            data = torch.full((n,), fill, dtype=dtype, device=device)
            valid = torch.zeros(n, dtype=torch.bool, device=device)
        else:
            # the value goes through numpy's dtype first (np.full's unsafe
            # cast), so that it wraps or rounds exactly as the host
            # representation does
            x = np.full(1, _encode_value(t, v.cast_to(t).value), dtype=numpy_dtype_for(t))
            data = torch.full((n,), storage_np(t, x)[0].item(), dtype=dtype, device=device)
            valid = torch.ones(n, dtype=torch.bool, device=device)
        return Column(t, data, valid)

    # ---- host access -----------------------------------------------------

    def data_np(self) -> np.ndarray:
        """Host copy of the data in numpy's dtype for the type (uint8..
        uint64 for the unsigned types)."""
        return logical_np(self.type, self.data.cpu().numpy())

    def valid_np(self) -> np.ndarray:
        return self.valid.cpu().numpy()

    def scalar_at(self, i: int) -> ScalarValue:
        if not bool(self.valid[i]):
            return ScalarValue(self.type, None)
        x = logical_np(self.type, self.data[i : i + 1].cpu().numpy())[0].item()
        return ScalarValue(self.type, _decode_value(self.type, x))

    def to_pylist(self) -> list[Any]:
        return _to_pylist(self.type, self.data_np(), self.valid_np())

    def take(self, indices) -> "Column":
        """Gather rows by index (device op)."""
        idx = torch.as_tensor(indices, device=self.data.device)
        return Column(self.type, self.data[idx], self.valid[idx])

    def mask_invalid(self, keep) -> "Column":
        """AND the validity with `keep` (same length bool tensor)."""
        return Column(self.type, self.data, torch.logical_and(self.valid, keep))


def host_to_device(a: np.ndarray, device) -> torch.Tensor:
    """A copy of a host array on `device` (never a view of host memory, so
    a CPU tensor cannot alias a table's master copy)."""
    return torch.tensor(np.ascontiguousarray(a), device=device)


def scalars_to_numpy(
    t: LogicalType, values: Sequence[ScalarValue]
) -> tuple[np.ndarray, np.ndarray]:
    """(data, valid) host arrays of a list of scalars."""
    n = len(values)
    valid = np.array([not v.is_null for v in values], dtype=np.bool_)
    data = np.zeros(n, dtype=numpy_dtype_for(t))
    for i, v in enumerate(values):
        if v.is_null:
            data[i] = NULL_CODE if t == LogicalType.VARCHAR else 0
            continue
        data[i] = _encode_value(t, v.value)
    return data, valid


def _to_pylist(t: LogicalType, data: np.ndarray, valid: np.ndarray) -> list[Any]:
    if t == LogicalType.VARCHAR:
        return GLOBAL_STRINGS.decode(data, valid)
    return [
        _decode_value(t, x) if v else None
        for x, v in zip(data.tolist(), valid.tolist())
    ]


def _encode_value(t: LogicalType, v: Any) -> Any:
    if t == LogicalType.VARCHAR:
        return GLOBAL_STRINGS.intern(v)
    if t == LogicalType.INTERVAL:
        return v.pack() if isinstance(v, Interval) else int(v)
    if t == LogicalType.BOOLEAN:
        return bool(v)
    if t.is_float():
        return float(v)
    return int(v)


def _decode_value(t: LogicalType, x: Any) -> Any:
    if t == LogicalType.VARCHAR:
        return GLOBAL_STRINGS.lookup(int(x))
    if t == LogicalType.INTERVAL:
        return Interval.unpack(int(x))
    if t == LogicalType.BOOLEAN:
        return bool(x)
    if t.is_float():
        return float(x)
    return int(x)


@dataclass
class DeviceBatch:
    schema: Schema
    columns: list[Column]
    num_rows: int = field(default=-1)
    device: Any = None  # torch.device; taken from the columns when omitted

    def __post_init__(self) -> None:
        if self.num_rows < 0:
            self.num_rows = len(self.columns[0]) if self.columns else 0
        if self.device is None:
            if not self.columns:
                raise TypeError_("a DeviceBatch without columns needs a device")
            self.device = self.columns[0].data.device
        self.device = torch.device(self.device)
        for c in self.columns:
            if len(c) != self.num_rows:
                raise TypeError_("column length mismatch in DeviceBatch")
            if c.data.device != self.device or c.valid.device != self.device:
                raise TypeError_(
                    f"column on {c.data.device} in a DeviceBatch on {self.device}"
                )

    @staticmethod
    def empty(schema: Schema, *, device) -> "DeviceBatch":
        cols = [
            Column.from_numpy(
                f.type, np.zeros(0, dtype=numpy_dtype_for(f.type)), device=device
            )
            for f in schema.fields
        ]
        return DeviceBatch(schema, cols, 0, device)

    @staticmethod
    def from_pydict(
        schema: Schema, data: dict[str, list[Any]], *, device
    ) -> "DeviceBatch":
        cols = []
        for f in schema.fields:
            vals = [
                ScalarValue(f.type, v) if not isinstance(v, ScalarValue) else v
                for v in data[f.name]
            ]
            vals = [
                ScalarValue(f.type, None) if v.value is None else v.cast_to(f.type)
                for v in vals
            ]
            cols.append(Column.from_scalars(f.type, vals, device=device))
        return DeviceBatch(schema, cols, device=device)

    def _rebuild(self, flat, num_rows: int) -> "DeviceBatch":
        cols = [
            Column(c.type, flat[2 * ci], flat[2 * ci + 1])
            for ci, c in enumerate(self.columns)
        ]
        return DeviceBatch(self.schema, cols, num_rows, self.device)

    def _flat(self) -> tuple:
        return tuple(a for c in self.columns for a in (c.data, c.valid))

    @staticmethod
    def concat(batches: Sequence["DeviceBatch"]) -> "DeviceBatch":
        if not batches:
            raise TypeError_("concat of zero batches")
        if len(batches) == 1:
            return batches[0]
        from sqlrs_tpu_torch.ops.fused import concat_arrays

        first = batches[0]
        if not first.columns:
            return DeviceBatch(
                first.schema, [], sum(b.num_rows for b in batches), first.device
            )
        flat = concat_arrays([b._flat() for b in batches])
        return first._rebuild(flat, int(flat[0].shape[0]))

    def take(self, indices) -> "DeviceBatch":
        """Gather rows by index."""
        idx = torch.as_tensor(indices, device=self.device)
        if not self.columns:
            return DeviceBatch(self.schema, [], int(idx.shape[0]), self.device)
        from sqlrs_tpu_torch.ops.fused import gather_arrays

        return self._rebuild(gather_arrays(self._flat(), idx), int(idx.shape[0]))

    def compact(self, keep: "Column", count: int) -> "DeviceBatch":
        """Rows where `keep` holds, in their original order."""
        if not self.columns:
            return DeviceBatch(self.schema, [], count, self.device)
        from sqlrs_tpu_torch.ops.fused import compact_gather_arrays

        flat = compact_gather_arrays(keep.data, keep.valid, self._flat(), int(count))
        return self._rebuild(flat, count)

    def slice(self, start: int, length: int) -> "DeviceBatch":
        if not self.columns:
            return DeviceBatch(self.schema, [], length, self.device)
        from sqlrs_tpu_torch.ops.fused import slice_arrays

        return self._rebuild(
            slice_arrays(self._flat(), int(start), int(length)), length
        )

    def to_pylist(self) -> list[list[Any]]:
        """Row-major host values (None for NULL) — session-boundary only."""
        col_lists = [c.to_pylist() for c in self.columns]
        return [list(row) for row in zip(*col_lists)] if col_lists else []
