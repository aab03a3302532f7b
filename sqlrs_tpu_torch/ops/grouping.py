"""Group-id assignment and segmented aggregation kernels.

The port of sqlrs_tpu/ops/grouping.py: the legacy GROUP BY path, which the
executor takes for multi-argument and ungrouped DISTINCT aggregates. Rows
are lexsorted by the encoded group keys (stable argsort passes, least
significant key first), group boundaries fall out of an adjacent
difference, and aggregates are segment reductions (`index_add_` and
`scatter_reduce_` into one slot per group). NULL keys form their own group
(SQL GROUP BY semantics), and group output order is first-appearance order,
which the reference preserves via its insertion-ordered map (reference
hash_agg.rs:85-111).
"""

from __future__ import annotations

import torch

from sqlrs_tpu_torch.data import Column
from sqlrs_tpu_torch.ops.fused import prefix_sum
from sqlrs_tpu_torch.ops.sort import _sort_operand, orderable_key

_INT64_MAX = 2**63 - 1


def group_ids(key_cols: list[Column]) -> tuple[torch.Tensor, int]:
    """Returns (gid, n_groups): gid[i] is the group of row i, numbered in
    first-appearance order. One host sync for n_groups (pipeline breaker)."""
    n = len(key_cols[0])
    dev = key_cols[0].data.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev), 0
    keys = [orderable_key(c) for c in key_cols]

    idx = torch.arange(n, dtype=torch.int64, device=dev)
    for key, valid in reversed(keys):
        # NULLs group together: order by (valid, key-with-null-slot)
        k = _sort_operand(torch.where(valid, key, torch.zeros_like(key)))[idx]
        v = valid[idx]
        order = torch.argsort(k, stable=True)
        idx = idx[order]
        v = v[order]
        order2 = torch.argsort(v.to(torch.int32), stable=True)
        idx = idx[order2]

    # boundary: any key column differs (validity-aware) vs previous sorted row
    boundary = torch.zeros(n, dtype=torch.bool, device=dev)
    boundary[0] = True
    for key, valid in keys:
        ks, vs = key[idx], valid[idx]
        diff = (vs[1:] != vs[:-1]) | (vs[1:] & (ks[1:] != ks[:-1]))
        boundary[1:] |= diff

    gid_sorted = torch.cumsum(boundary.to(torch.int64), 0) - 1
    gid = torch.zeros(n, dtype=torch.int64, device=dev).index_copy_(0, idx, gid_sorted)

    n_groups = int(gid_sorted[-1]) + 1  # host sync

    # renumber groups by first appearance
    first_row = torch.full((n_groups,), _INT64_MAX, dtype=torch.int64, device=dev)
    first_row.scatter_reduce_(
        0, gid, torch.arange(n, dtype=torch.int64, device=dev), reduce="amin"
    )
    rank = torch.argsort(torch.argsort(first_row, stable=True), stable=True)
    return rank[gid], n_groups


# ---- segmented aggregate kernels -------------------------------------------


def seg_count_valid(valid, gid, n_groups):
    out = torch.zeros(n_groups, dtype=torch.int64, device=gid.device)
    return out.index_add_(0, gid, valid.to(torch.int64))


def seg_sum(data, valid, gid, n_groups):
    """Per-group sums of the valid rows. Integer sums are exact in any
    order and take `index_add_`. On CUDA a float `index_add_` is atomics,
    which add in another order on every run, so float sums take a fixed
    order instead: a stable sort by group id, the fixed-order prefix sum
    of the sorted group-by (ops/fused.prefix_sum), and one difference of
    the prefix at each group's bounds."""
    x = torch.where(valid, data, torch.zeros_like(data))
    dev = gid.device
    if not x.is_floating_point():
        out = torch.zeros(n_groups, dtype=data.dtype, device=dev)
        return out.index_add_(0, gid, x)
    n = x.shape[0]
    if n == 0:
        return torch.zeros(n_groups, dtype=data.dtype, device=dev)
    order = torch.argsort(gid, stable=True)
    cs = prefix_sum(x[order])
    bounds = torch.searchsorted(
        gid[order], torch.arange(n_groups + 1, dtype=gid.dtype, device=dev)
    )
    at = torch.where(bounds > 0, cs[torch.clamp(bounds - 1, 0, n - 1)], 0)
    return at[1:] - at[:-1]


def _seg_reduce(x, gid, n_groups, identity, reduce: str):
    out = torch.full((n_groups,), identity, dtype=x.dtype, device=gid.device)
    return out.scatter_reduce_(0, gid, x, reduce=reduce)


def _identity(dtype, want_min: bool):
    """jax.ops.segment_min/max's value for an empty segment."""
    if dtype.is_floating_point:
        return float("inf") if want_min else float("-inf")
    ii = torch.iinfo(dtype)
    return ii.max if want_min else ii.min


def seg_min(data, valid, gid, n_groups, big):
    x = torch.where(valid, data, torch.full_like(data, big))
    return _seg_reduce(x, gid, n_groups, _identity(data.dtype, True), "amin")


def seg_max(data, valid, gid, n_groups, small):
    x = torch.where(valid, data, torch.full_like(data, small))
    return _seg_reduce(x, gid, n_groups, _identity(data.dtype, False), "amax")


def seg_argmin_by(order_key, data_valid, gid, n_groups):
    """Row index minimizing order_key per group, ignoring invalid rows.
    Used for MIN/MAX on dictionary-encoded strings (the winning row's code is
    gathered afterwards). Exact two-pass formulation: min key per group, then
    min row index among rows attaining it."""
    n = order_key.shape[0]
    big = _INT64_MAX
    k = torch.where(data_valid, order_key.to(torch.int64), big)
    m = _seg_reduce(k, gid, n_groups, big, "amin")
    attains = data_valid & (k == m[gid])
    rows = torch.where(
        attains, torch.arange(n, dtype=torch.int64, device=gid.device), big
    )
    return _seg_reduce(rows, gid, n_groups, big, "amin")


def dedup_mask(key_cols: list[Column], gid) -> torch.Tensor:
    """True for the first occurrence of each (group, value) pair — implements
    DISTINCT aggregates (sum/count DISTINCT, reference
    src/executor/aggregate/sum.rs:99, count.rs:31). NULL values are excluded
    entirely (SQL ignores NULLs in aggregates)."""
    n = len(key_cols[0])
    dev = gid.device
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=dev)
    # composite: (gid, valid_0, key_0, valid_1, key_1, ...) so NULLs cannot
    # shadow valid values that share the null-slot encoding
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    keys = [(gid, ones)]
    for c in key_cols:
        key, valid = orderable_key(c)
        keys.append((valid.to(torch.int64), ones))
        keys.append((key, valid))
    masked = [torch.where(v, k, torch.zeros_like(k)) for k, v in keys]
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    for k in reversed(masked):
        order = torch.argsort(_sort_operand(k)[idx], stable=True)
        idx = idx[order]
    diff_any = torch.zeros(n - 1, dtype=torch.bool, device=dev)
    for k in masked:
        ks = k[idx]
        diff_any |= ks[1:] != ks[:-1]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), diff_any])
    mask = torch.zeros(n, dtype=torch.bool, device=dev).index_copy_(0, idx, first)
    # drop NULL values entirely
    for c in key_cols:
        mask = mask & c.valid
    return mask
