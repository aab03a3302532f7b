"""Scalar function registry + overload resolution.

Parity with the reference's function subsystem (reference
src/function/scalar/scalar_function.rs:10, arithmetic_function.rs:63-192,
and the FunctionBinder's implicit-cast-cost overload resolution,
src/planner_v2/binder/function_binder.rs:11-125 + cast_rules.rs:6-14):
functions are sets of overloads keyed by argument types; binding picks the
minimum-total-cast-cost overload, preferring the exact max-logical-type match
on ties, and errors when no overload is reachable.

The builtin arithmetic set registers (T, T) -> T for every numeric T plus
the date ± interval overloads; each overload carries the kernel selector the
expression executor dispatches on (sqlrs_tpu_torch/exec/expression_executor.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from sqlrs_tpu_torch.errors import BinderError
from sqlrs_tpu_torch.types import (
    LogicalType,
    implicit_cast_cost,
    max_logical_type,
)
from sqlrs_tpu_torch.errors import TypeError_

NUMERIC_TYPES = [t for t in LogicalType if t.is_numeric()]


@dataclass(frozen=True)
class ScalarFunctionOverload:
    name: str
    arg_types: tuple[LogicalType, ...]
    return_type: LogicalType
    kernel: str  # selector for the expression executor


@dataclass
class ScalarFunctionSet:
    name: str
    overloads: list[ScalarFunctionOverload] = field(default_factory=list)

    def add(self, arg_types, return_type, kernel) -> None:
        self.overloads.append(
            ScalarFunctionOverload(self.name, tuple(arg_types), return_type, kernel)
        )


def resolve_overload(
    fset: ScalarFunctionSet, arg_types: list[LogicalType]
) -> ScalarFunctionOverload:
    """Minimum-total-implicit-cast-cost resolution (reference
    function_binder.rs:87); exact max-logical-type match breaks ties, and a
    remaining tie is an ambiguity error."""
    best: list[ScalarFunctionOverload] = []
    best_cost: Optional[int] = None
    for ov in fset.overloads:
        if len(ov.arg_types) != len(arg_types):
            continue
        total = 0
        ok = True
        for have, want in zip(arg_types, ov.arg_types):
            c = implicit_cast_cost(have, want)
            if c < 0:
                ok = False
                break
            total += c
        if not ok:
            continue
        if best_cost is None or total < best_cost:
            best, best_cost = [ov], total
        elif total == best_cost:
            best.append(ov)
    if not best:
        raise BinderError(
            f"no function overload {fset.name}({', '.join(map(str, arg_types))})"
        )
    if len(best) > 1:
        # prefer the overload matching the arguments' common supertype
        try:
            common = arg_types[0]
            for t in arg_types[1:]:
                common = max_logical_type(common, t)
            exact = [ov for ov in best if all(t == common for t in ov.arg_types)]
            if len(exact) == 1:
                return exact[0]
        except TypeError_:
            pass
        raise BinderError(
            f"ambiguous function call {fset.name}"
            f"({', '.join(map(str, arg_types))}): "
            f"{len(best)} equally good overloads"
        )
    return best[0]


def builtin_scalar_functions() -> dict[str, ScalarFunctionSet]:
    sets: dict[str, ScalarFunctionSet] = {}
    for name, op in [("add", "+"), ("subtract", "-"), ("multiply", "*"),
                     ("divide", "/"), ("mod", "%")]:
        s = ScalarFunctionSet(name)
        for t in NUMERIC_TYPES:
            s.add((t, t), t, op)
        sets[name] = s
    # date ± interval (reference arithmetic_function.rs:86-192)
    sets["add"].add((LogicalType.DATE, LogicalType.INTERVAL), LogicalType.DATE, "date+")
    sets["add"].add((LogicalType.INTERVAL, LogicalType.DATE), LogicalType.DATE, "date+swap")
    sets["subtract"].add(
        (LogicalType.DATE, LogicalType.INTERVAL), LogicalType.DATE, "date-"
    )
    like = ScalarFunctionSet("like")
    like.add((LogicalType.VARCHAR, LogicalType.VARCHAR), LogicalType.BOOLEAN, "like")
    sets["like"] = like
    ext = ScalarFunctionSet("extract")
    for f in ("year", "month", "day"):
        e = ScalarFunctionSet(f"extract_{f}")
        e.add((LogicalType.DATE,), LogicalType.INTEGER, f"extract_{f}")
        sets[f"extract_{f}"] = e
    return sets


BUILTIN_SCALAR_FUNCTIONS = builtin_scalar_functions()
