"""Vectorized elementwise kernels with validity-mask propagation.

The device half of the expression evaluator (reference evaluates expressions
with arrow compute kernels, src/executor/evaluator.rs:13 and
src/executor/array_compute.rs:70-90; v2 via function impls,
src/function/scalar/*). Everything here is (data, valid) -> (data, valid)
on torch tensors, evaluated eagerly on the tensors' own device.

NULL semantics:
- arithmetic/comparison: NULL if any input is NULL;
- AND/OR: Kleene three-valued logic (reference
  src/function/conjunction/default_conjunction.rs:59, and_kleene/or_kleene);
- VARCHAR ordering comparisons run on lexicographic-rank projections of the
  dictionary codes (sqlrs_tpu_torch/data/strings.py), equality directly on codes.
- every tensor made here goes to the device of the column it derives from.
"""

from __future__ import annotations

import numpy as np
import torch

from sqlrs_tpu_torch.data import Column
from sqlrs_tpu_torch.data.batch import host_to_device, torch_dtype_for
from sqlrs_tpu_torch.data.strings import GLOBAL_STRINGS, NULL_CODE
from sqlrs_tpu_torch.errors import ExecutorError, TypeError_
from sqlrs_tpu_torch.types import Interval, LogicalType

# ---- casts -----------------------------------------------------------------


def cast_column(col: Column, dst: LogicalType, safe: bool = False) -> Column:
    src = col.type
    if src == dst:
        return col
    dev = col.data.device
    if src == LogicalType.SQLNULL:
        dt = torch_dtype_for(dst)
        return Column(
            dst,
            torch.zeros(len(col), dtype=dt, device=dev),
            torch.zeros(len(col), dtype=torch.bool, device=dev),
        )
    if src.is_numeric() and dst.is_numeric():
        valid = col.valid
        if dst.is_integral():
            from sqlrs_tpu_torch.types.types import INT_RANGES, can_implicit_cast

            if not can_implicit_cast(src, dst):
                # narrowing: arrow checked-cast semantics — error on overflow
                # (what makes `insert into t3(v1) values (1481)` on TINYINT
                # UNSIGNED a statement error). Bounds are clamped to the
                # source dtype's own range so the comparison constants are
                # representable (e.g. UBIGINT's 2^64-1 vs an int64 source).
                lo, hi = INT_RANGES[dst]
                if src.is_integral():
                    slo, shi = INT_RANGES[src]
                else:
                    slo, shi = -(2**63), 2**63 - 1
                checks = []
                if lo > slo:
                    checks.append(col.data < lo)
                if hi < shi:
                    checks.append(col.data > hi)
                if not checks:
                    return Column(dst, col.data.to(torch_dtype_for(dst)), valid)
                bad = checks[0]
                for c in checks[1:]:
                    bad = torch.logical_or(bad, c)
                bad = torch.logical_and(valid, bad)
                if safe:
                    valid = torch.logical_and(valid, torch.logical_not(bad))
                elif bool(bad.any()):
                    raise TypeError_(f"cast overflow: {src} value out of {dst} range")
        return Column(dst, col.data.to(torch_dtype_for(dst)), valid)
    if src == LogicalType.BOOLEAN and dst.is_numeric():
        return Column(dst, col.data.to(torch_dtype_for(dst)), col.valid)
    # string-involved casts run on host through the dictionary (cold path)
    from sqlrs_tpu_torch.types import ScalarValue

    # one host copy of the column (per-row scalar_at would sync per row)
    scalars = [ScalarValue(src, v) for v in col.to_pylist()]
    out = []
    for sv in scalars:
        try:
            out.append(sv.cast_to(dst, safe=safe))
        except TypeError_:
            if safe:
                out.append(ScalarValue(dst, None))
            else:
                raise
    return Column.from_scalars(dst, out, device=dev)


# ---- arithmetic --------------------------------------------------------------

_ARITH = {"+", "-", "*", "/", "%"}


def arithmetic(op: str, t: LogicalType, left: Column, right: Column) -> Column:
    """Both inputs already cast to the common type t; output type t."""
    valid = torch.logical_and(left.valid, right.valid)
    l, r = left.data, right.data
    if op == "+":
        data = l + r
    elif op == "-":
        data = l - r
    elif op == "*":
        data = l * r
    elif op == "/":
        if t.is_integral():
            # SQL integer division truncates toward zero; x/0 -> NULL
            safe_r = torch.where(r == 0, torch.ones_like(r), r)
            q = torch.abs(l) // torch.abs(safe_r)
            sign = torch.sign(l) * torch.sign(safe_r)
            data = (q * sign).to(l.dtype)
            valid = torch.logical_and(valid, r != 0)
        else:
            data = l / r
    elif op == "%":
        safe_r = torch.where(r == 0, torch.ones_like(r), r)
        data = l - (torch.abs(l) // torch.abs(safe_r)) * torch.sign(l) * torch.abs(safe_r)
        data = data.to(l.dtype)
        valid = torch.logical_and(valid, r != 0)
    else:
        raise ExecutorError(f"unknown arithmetic op {op}")
    return Column(t, data.to(torch_dtype_for(t)), valid)


def negate(col: Column) -> Column:
    return Column(col.type, -col.data, col.valid)


# ---- comparisons -------------------------------------------------------------


def _orderable_view(col: Column):
    """Data array on which <,> are meaningful; VARCHAR goes through ranks."""
    if col.type == LogicalType.VARCHAR:
        ranks = GLOBAL_STRINGS.ranks_device(col.data.device)
        if len(ranks) == 0:
            return torch.zeros_like(col.data, dtype=torch.int64)
        codes = torch.clamp(col.data, 0, len(ranks) - 1).long()
        return ranks[codes]
    return col.data


def compare(op: str, left: Column, right: Column) -> Column:
    """Inputs already cast to a common type; returns BOOLEAN column."""
    valid = torch.logical_and(left.valid, right.valid)
    if op == "=":
        data = left.data == right.data
    elif op == "!=":
        data = left.data != right.data
    else:
        l, r = _orderable_view(left), _orderable_view(right)
        if op == "<":
            data = l < r
        elif op == "<=":
            data = l <= r
        elif op == ">":
            data = l > r
        elif op == ">=":
            data = l >= r
        else:
            raise ExecutorError(f"unknown comparison op {op}")
    return Column(LogicalType.BOOLEAN, data, valid)


# ---- Kleene logic ------------------------------------------------------------


def kleene_and(left: Column, right: Column) -> Column:
    l = torch.logical_and(left.data, left.valid)  # treat NULL as "unknown"
    r = torch.logical_and(right.data, right.valid)
    lf = torch.logical_and(torch.logical_not(left.data), left.valid)  # definitely false
    rf = torch.logical_and(torch.logical_not(right.data), right.valid)
    data = torch.logical_and(l, r)
    # result valid when: any side definitely false, or both sides valid
    valid = torch.logical_or(torch.logical_or(lf, rf), torch.logical_and(left.valid, right.valid))
    return Column(LogicalType.BOOLEAN, data, valid)


def kleene_or(left: Column, right: Column) -> Column:
    lt = torch.logical_and(left.data, left.valid)  # definitely true
    rt = torch.logical_and(right.data, right.valid)
    data = torch.logical_or(lt, rt)
    valid = torch.logical_or(torch.logical_or(lt, rt), torch.logical_and(left.valid, right.valid))
    return Column(LogicalType.BOOLEAN, data, valid)


def logical_not(col: Column) -> Column:
    return Column(LogicalType.BOOLEAN, torch.logical_not(col.data), col.valid)


# ---- date +/- interval -------------------------------------------------------


def _civil_from_days_vec(z):
    z = z + 719468
    era = torch.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + torch.where(mp < 10, 3, -9)
    return y + (m <= 2).to(y.dtype), m, d


def _days_from_civil_vec(y, m, d):
    y = y - (m <= 2).to(y.dtype)
    era = torch.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (m + torch.where(m > 2, -3, 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _last_day_of_month_vec(y, m):
    thirty_one = torch.isin(m, torch.tensor([1, 3, 5, 7, 8, 10, 12], device=m.device))
    thirty = torch.isin(m, torch.tensor([4, 6, 9, 11], device=m.device))
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    feb = torch.where(leap, 29, 28)
    return torch.where(thirty_one, 31, torch.where(thirty, 30, feb))


def date_add_interval(dates: Column, interval: Interval, sign: int) -> Column:
    """DATE ± INTERVAL, fully vectorized calendar math (reference
    src/function/scalar/arithmetic_function.rs:63-192 date±interval overloads;
    subtraction negates the interval first, :169-173). Month arithmetic
    clamps the day to the target month's length; day-time arithmetic is
    bit-compatible with arrow's IntervalDayTime (see types.values.Interval)."""
    if sign < 0:
        interval = interval.negate()
    z = dates.data.to(torch.int64)
    if interval.months:
        y, m, d = _civil_from_days_vec(z)
        total = y * 12 + (m - 1) + interval.months
        y2 = total // 12
        m2 = total % 12 + 1
        d2 = torch.minimum(d, _last_day_of_month_vec(y2, m2))
        z = _days_from_civil_vec(y2, m2, d2)
    z = z + interval.day_shift()
    return Column(LogicalType.DATE, z.to(torch.int32), dates.valid)


# ---- LIKE ---------------------------------------------------------------------


def like_match(col: Column, pattern: str, negated: bool = False) -> Column:
    """SQL LIKE on dictionary-encoded strings: the pattern is evaluated once
    per DISTINCT string (host regex over the dictionary), then mapped onto
    the column codes with a single device gather — O(D) pattern work for any
    column length."""
    import re as _re

    from sqlrs_tpu_torch.data.strings import GLOBAL_STRINGS

    rx = _re.compile(
        "^"
        + "".join(
            ".*" if ch == "%" else "." if ch == "_" else _re.escape(ch)
            for ch in pattern
        )
        + "$",
        _re.DOTALL,
    )
    d = GLOBAL_STRINGS
    # memoized per-pattern, extended incrementally on dictionary growth —
    # a repeated LIKE over a stable dictionary costs zero host regex work
    match_table = d.match_table(
        ("like", pattern), lambda s: bool(rx.match(s)), np.bool_
    )
    if negated:
        match_table = ~match_table
    dev = col.data.device
    if len(match_table) == 0:
        return Column(
            LogicalType.BOOLEAN,
            torch.zeros(len(col), dtype=torch.bool, device=dev),
            col.valid,
        )
    table = host_to_device(match_table, dev)
    codes = torch.clamp(col.data, 0, len(match_table) - 1).long()
    return Column(LogicalType.BOOLEAN, table[codes], col.valid)


def _code_map_column(col: Column, key, fn) -> Column:
    """Apply a string→string function as a code→code dictionary mapping:
    host work is O(new distinct strings) thanks to the memoized incremental
    match_table (interning any new results), then ONE device gather maps the
    column — row count never touches the host."""
    from sqlrs_tpu_torch.data.strings import GLOBAL_STRINGS, NULL_CODE

    d = GLOBAL_STRINGS
    n_before = len(d)
    dev = col.data.device
    if n_before == 0:
        return Column(
            LogicalType.VARCHAR,
            torch.full((len(col),), NULL_CODE, dtype=torch.int32, device=dev),
            col.valid,
        )
    table = d.match_table(key, lambda s: d.intern(fn(s)), np.int32)
    jt = host_to_device(table, dev)
    codes = torch.clamp(col.data, 0, n_before - 1).long()
    return Column(LogicalType.VARCHAR, jt[codes], col.valid)


def substring_column(col: Column, start: int, length=None) -> Column:
    """SQL substring (1-based start; negative/zero start clamps like
    Postgres' FROM clause on positive lengths is not fully modeled — TPC-H
    uses positive constants only)."""
    s0 = max(start - 1, 0)
    if length is None:
        return _code_map_column(col, ("substr", s0, None), lambda s: s[s0:])
    end = s0 + max(int(length), 0)
    return _code_map_column(col, ("substr", s0, end), lambda s: s[s0:end])


def concat_columns(left: Column, right: Column) -> Column:
    """VARCHAR || VARCHAR. Host work is O(distinct (l,r) pairs): one
    np.unique over a packed int64 pair key dedups, each distinct pair is
    interned once, and ONE device gather maps codes back (mirroring
    _code_map_column — the per-row Python loop this replaces stalled on
    fact-table inputs)."""
    from sqlrs_tpu_torch.data.strings import GLOBAL_STRINGS, NULL_CODE

    d = GLOBAL_STRINGS
    lc = left.data_np().astype(np.int64)
    rc = right.data_np().astype(np.int64)
    valid = left.valid_np() & right.valid_np()
    packed = np.where(valid, (lc << 32) | (rc & 0xFFFFFFFF), -1)
    uniq, inv = np.unique(packed, return_inverse=True)
    table = np.full(len(uniq), NULL_CODE, np.int32)
    for i, p in enumerate(uniq):
        if p < 0:
            continue
        table[i] = d.intern(d.lookup(int(p >> 32)) + d.lookup(int(p & 0xFFFFFFFF)))
    dev = left.data.device
    out = host_to_device(table[inv.reshape(-1)], dev)
    return Column(LogicalType.VARCHAR, out, host_to_device(valid, dev))


# ---- EXTRACT -------------------------------------------------------------------


def extract_date_field(col: Column, field: str) -> Column:
    y, m, d = _civil_from_days_vec(col.data.to(torch.int64))
    out = {"year": y, "month": m, "day": d}[field]
    return Column(LogicalType.INTEGER, out.to(torch.int32), col.valid)


# ---- IS NULL / CASE --------------------------------------------------------------


def is_null(col: Column, negated: bool = False) -> Column:
    data = col.valid if negated else torch.logical_not(col.valid)
    return Column(
        LogicalType.BOOLEAN,
        data,
        torch.ones(len(col), dtype=torch.bool, device=col.valid.device),
    )


def case_when(conditions: list[Column], results: list[Column], t: LogicalType) -> Column:
    """Nested where over (condition, result) pairs; last result is ELSE.
    A NULL condition counts as not-matched (SQL CASE semantics)."""
    out = results[-1]
    data, valid = out.data, out.valid
    for cond, res in zip(reversed(conditions), reversed(results[:-1])):
        fire = torch.logical_and(cond.data, cond.valid)
        data = torch.where(fire, res.data, data)
        valid = torch.where(fire, res.valid, valid)
    return Column(t, data, valid)


# ---- filter/selection helpers ------------------------------------------------


def selection_to_indices(keep: Column):
    """Boolean predicate column -> int64 row indices (on the column's
    device) where the predicate is TRUE (NULL counts as false). The size is
    data-dependent, so this synchronizes with the device."""
    return torch.nonzero(torch.logical_and(keep.data, keep.valid)).squeeze(1)
