"""The comparison that decides `correct`: an execution's rows against the
reference's rows for the same query and parameters.

Two numbers come of it. An execution *mismatches* when its rows differ in
anything but the rounding of a float: the row count, an integer, a string,
a date, a NULL. And every float cell gives a *relative gap*,
|got - expected| / max(|expected|, 1e-6) (the floor is below a cent and
below any share the queries compute): the run's widest gap is compared
with its limit, the count of mismatched executions with 0.

Rows whose ORDER BY keys tie in the reference may come in any order, so
each run of tied rows is sorted the same way on both sides first. A float
key ties within a relative 1e-9: sums equal in exact arithmetic (Q11's
values, products of cents and integers) come out an ulp apart in another
order of summation, and either side may then put either row first.
"""

from __future__ import annotations

import math

FLOOR = 1e-6
TIE = 1e-9  # relative: ORDER BY values closer than this are ties


def _is_float(v) -> bool:
    return isinstance(v, float)


def _canon(row: tuple) -> tuple:
    return tuple((0, "") if v is None else (1, v) if isinstance(v, str)
                 else (2, float(v)) for v in row)


def _same_key(a, b) -> bool:
    """ORDER BY keys tie: equal, or floats within the rounding the limit
    allows (values equal in exact arithmetic, summed in another order)."""
    if _is_float(a) and _is_float(b):
        return abs(a - b) <= TIE * max(abs(a), abs(b))
    return a == b


def _untie(got: list, exp: list, keys: tuple) -> tuple[list, list]:
    if not keys or len(exp) < 2:
        return got, exp
    got, exp = list(got), list(exp)
    i = 0
    while i < len(exp):
        j = i + 1
        while j < len(exp) and all(_same_key(exp[j][k], exp[j - 1][k]) for k in keys):
            j += 1
        if j - i > 1:
            exp[i:j] = sorted(exp[i:j], key=_canon)
            got[i:j] = sorted(got[i:j], key=_canon)
        i = j
    return got, exp


def compare(got: list[tuple], exp: list[tuple], keys: tuple = ()) -> tuple[bool, float, str]:
    """(mismatch, widest relative gap of a float cell, the first difference)."""
    if len(got) != len(exp):
        return True, 0.0, f"{len(got)} rows, expected {len(exp)}"
    got, exp = _untie(got, exp, keys)
    gap, first = 0.0, ""
    for i, (g, e) in enumerate(zip(got, exp)):
        if len(g) != len(e):
            return True, gap, f"row {i}: {len(g)} columns, expected {len(e)}"
        for j, (gv, ev) in enumerate(zip(g, e)):
            if _is_float(gv) or _is_float(ev):
                if gv is None or ev is None:
                    if gv is not ev:
                        return True, gap, f"row {i} col {j}: {gv!r}, expected {ev!r}"
                    continue
                gv, ev = float(gv), float(ev)
                if math.isnan(gv) or math.isnan(ev):
                    if not (math.isnan(gv) and math.isnan(ev)):
                        return True, gap, f"row {i} col {j}: {gv!r}, expected {ev!r}"
                    continue
                d = abs(gv - ev) / max(abs(ev), FLOOR)
                if d > gap:
                    gap, first = d, f"row {i} col {j}: {gv!r}, expected {ev!r}"
            elif gv != ev:
                return True, gap, f"row {i} col {j}: {gv!r}, expected {ev!r}"
    return False, gap, first
