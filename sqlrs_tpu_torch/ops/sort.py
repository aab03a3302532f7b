"""Device sort: multi-key, per-key direction, arrow-compatible null placement.

Replaces the reference's materialize-all + `lexsort_to_indices` ORDER BY
(reference src/executor/order.rs:14-38). Keys are encoded to orderable
int64 tensors (strings via dictionary lex-ranks) and sorted by stable
`torch.argsort` passes, least significant key first — the same permutation
as the JAX package's one variadic stable `lax.sort` with `num_keys=k`.
NULLs sort first in both directions (arrow SortOptions default the
reference inherits). Filter compaction, which the JAX package also does by
a stable flag sort here, is `torch.nonzero` of the mask
(ops/elementwise.selection_to_indices), or, where the count is already on
the host, a scatter of each kept row to its rank (ops/fused.compact_indices):
the same rows in the same order.

Float keys follow `lax.sort`'s order, which is not IEEE total order:
-0.0 and +0.0 tie (the stable sort keeps their row order), and every NaN,
of either sign, sorts after +inf and ties with every other NaN. The float
key is therefore mapped to an int64 whose signed order is exactly that one
(`_float_order_key`), so the result does not depend on how a device's sort
treats signed zeros and NaN payloads.
"""

from __future__ import annotations

import torch

from sqlrs_tpu_torch.data import Column
from sqlrs_tpu_torch.data.strings import GLOBAL_STRINGS
from sqlrs_tpu_torch.errors import ExecutorError
from sqlrs_tpu_torch.types import LogicalType

_INT64_MIN = -(2**63)
_INT64_MAX = 2**63 - 1


def key_kind(t: LogicalType) -> str:
    """Host-static classification driving the key encoding."""
    if t == LogicalType.VARCHAR:
        return "varchar"
    if t in (LogicalType.FLOAT, LogicalType.DOUBLE):
        return "float"
    if t == LogicalType.UBIGINT:
        raise ExecutorError("type UBIGINT not yet ported to sqlrs_tpu_torch")
    if (
        t.is_numeric()
        or t in (LogicalType.DATE, LogicalType.INTERVAL, LogicalType.BOOLEAN)
    ):
        return "plain"
    raise ExecutorError(f"type {t} is not orderable")


def _rank_table_for(cols):
    if any(c.type == LogicalType.VARCHAR for c in cols):
        r = GLOBAL_STRINGS.ranks_device(cols[0].data.device)
        if r.shape[0] > 0:
            return r
    return None


def _encode(kind: str, data, rank):
    """Orderable int64/float64 key, monotone in column sort order."""
    if kind == "varchar":
        if rank is None:
            return torch.zeros(data.shape[0], dtype=torch.int64, device=data.device)
        codes = torch.clamp(data, 0, rank.shape[0] - 1).long()
        return rank[codes]
    if kind == "float":
        return data.to(torch.float64)
    return data.to(torch.int64)


def _float_order_key(f):
    """int64 whose signed order is lax.sort's order of the float64 `f`:
    +-0.0 map to one key, every NaN to INT64_MAX (above +inf), and the rest
    to the usual sign-magnitude flip of the IEEE bits."""
    f = torch.where(f == 0, torch.zeros_like(f), f)  # -0.0 -> +0.0
    bits = f.view(torch.int64)
    key = bits ^ ((bits >> 63) & _INT64_MAX)
    return torch.where(torch.isnan(f), torch.full_like(key, _INT64_MAX), key)


def _directed(kind: str, asc: bool, data, valid, rank):
    """int64 key whose ASCENDING order realizes the requested direction,
    NULLs first (the JAX package's _directed_traced, then made int64)."""
    key = _encode(kind, data, rank)
    if not asc:
        key = -key
    if kind == "float":
        key = torch.where(valid, key, torch.full_like(key, float("-inf")))
        return _float_order_key(key)
    return torch.where(valid, key, torch.full_like(key, _INT64_MIN))


def orderable_key(col: Column):
    """(key, valid): the undirected orderable key of a column."""
    rank = _rank_table_for([col]) if col.type == LogicalType.VARCHAR else None
    return _encode(key_kind(col.type), col.data, rank), col.valid


def _directed_key(col: Column, asc: bool):
    """Directed orderable int64 key (NULLs first)."""
    return _directed(
        key_kind(col.type), bool(asc), col.data, col.valid, _rank_table_for([col])
    )


def _sort_operand(key):
    """An integer tensor whose ascending order is lax.sort's order of `key`
    (float keys through _float_order_key, integer keys as they are)."""
    if key.is_floating_point():
        return _float_order_key(key.to(torch.float64))
    return key


def _lex_argsort(keys: list) -> torch.Tensor:
    """Stable lexicographic argsort of key tensors (first key most
    significant): one stable argsort pass per key, least significant
    first. The permutation of lax.sort over the keys with the row position
    as the last key."""
    n = keys[0].shape[0]
    perm = None
    for key in reversed(keys):
        k = _sort_operand(key)
        if perm is None:
            perm = torch.argsort(k, stable=True)
        else:
            perm = perm[torch.argsort(k[perm], stable=True)]
    if perm is None:
        perm = torch.arange(n, dtype=torch.int64, device=keys[0].device)
    return perm


# ---- public API --------------------------------------------------------------


def sort_indices(items: list[tuple[Column, bool]]):
    """Permutation sorting rows by the given (column, ascending) keys;
    stable, NULLs first."""
    cols = [c for c, _ in items]
    rank = _rank_table_for(cols)
    keys = [
        _directed(key_kind(c.type), bool(a), c.data, c.valid, rank)
        for c, a in items
    ]
    return _lex_argsort(keys)


def sort_rows(items: list[tuple[Column, bool]], columns: list[Column]):
    """Sort whole rows: the key permutation, then one gather per column.
    (The JAX package also has sort_gather_rows for wide tables, because a
    payload-carrying sort and a permutation + gather cost differently
    there; here they are the same.)"""
    perm = sort_indices(items)
    return [Column(c.type, c.data[perm], c.valid[perm]) for c in columns]
