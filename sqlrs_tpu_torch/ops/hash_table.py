"""Hash mixing and the open-addressing hash table: grouped aggregation and
equi-join index pairs.

The port of sqlrs_tpu/ops/hash_table.py. The general GROUP BY and the
chunked join residual call `next_pow2`, and the sharded engine (parallel/)
places rows on shards by `hash_keys(k, 1 << 32) % n_shards` and hashes join
keys with `_mix64`. The table functions (`build_table`,
`hash_group_aggregate`, `build_join_table`, `probe_counts`, `expand_pairs`,
`hash_join_pairs`) are the reference's measured comparison baseline: no
production path runs them (the sharded broadcast join finds its candidates
in the stably sorted build hashes instead, parallel/dist_executor.py), and
`make_join_groupby(strategy="hash")` (ops/pipelines.py) is their one
caller. Each `lax.while_loop` of scatter-claim or probe rounds is a Python
loop that reads its condition on the host once a round; every output
equals the reference's, pair order included.

The reference mixes on uint64. Torch has no uint64 arithmetic, so the same
bits ride int64: multiplication wraps identically, the two multipliers are
written as their two's-complement int64 values, and every right shift is
masked to the bits a logical shift keeps (torch's `>>` on int64 is
arithmetic). The results equal the reference's bit for bit, read as int64.
"""

from __future__ import annotations

import torch

# splitmix64's multipliers 0xBF58476D1CE4E5B9 and 0x94D049BB133111EB as int64
_M1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_M2 = 0x94D049BB133111EB - (1 << 64)


def _shr(x, s: int):
    """Logical right shift of int64 bits (the uint64 `>>`)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix64(x):
    """splitmix64 finalizer on the int64 view of the uint64 bits."""
    x = x.to(torch.int64)
    x = (x ^ _shr(x, 30)) * _M1
    x = (x ^ _shr(x, 27)) * _M2
    return x ^ _shr(x, 31)


def hash_keys(keys, capacity: int):
    """Slot index in [0, capacity); capacity must be a power of two (at
    most 2^63, so that the slot is non-negative as int64)."""
    return _mix64(keys) & (capacity - 1)


def umod(x, m: int):
    """The uint64 `x % m` of the int64 bits x, for 0 < m < 2^62."""
    r = torch.remainder(x, m)
    return torch.where(x < 0, torch.remainder(r + (1 << 64) % m, m), r)


def next_pow2(n: int) -> int:
    c = 1
    while c < n:
        c *= 2
    return c


# ---- the open-addressing table (the reference's comparison baseline) --------

EMPTY = -(2**63)  # reserved: no live key may equal EMPTY


def build_table(keys, capacity: int):
    """Insert distinct keys into an open-addressing table by rounds of
    scatter-claims: each homeless row claims its empty slot with a
    max-scatter, the losers and key mismatches probe the next slot.

    Returns (table_keys[capacity], slot_of_row[n]): table_keys holds the key
    occupying each slot (EMPTY otherwise); slot_of_row[i] is the slot that
    row i's key lives in. Duplicate keys share a slot."""
    keys = keys.to(torch.int64)
    dev = keys.device
    cap_mask = capacity - 1
    table = torch.full((capacity,), EMPTY, dtype=torch.int64, device=dev)
    slot = hash_keys(keys, capacity)
    done = torch.zeros(keys.shape, dtype=torch.bool, device=dev)
    while not bool(done.all()):
        occupant = table[slot]
        hit = occupant == keys
        want = (occupant == EMPTY) & ~done & ~hit
        table = table.scatter_reduce(0, slot, torch.where(want, keys, EMPTY), "amax")
        done = done | hit | (table[slot] == keys)
        slot = torch.where(done, slot, (slot + 1) & cap_mask)
    return table, slot


def hash_group_aggregate(keys, values, capacity: int):
    """GROUP BY keys: per-group sum / count / min / max.

    Returns (table_keys, sums, counts, mins, maxs), each `capacity` long;
    slots with table_keys == EMPTY are unused. Integer sums are exact; a
    float column's sums add in another order than the reference's."""
    table, slot = build_table(keys, capacity)
    dev, dt = values.device, values.dtype
    sums = torch.zeros(capacity, dtype=dt, device=dev).index_add_(0, slot, values)
    counts = torch.zeros(capacity, dtype=torch.int64, device=dev).index_add_(
        0, slot, torch.ones_like(slot)
    )
    big = float("inf") if dt.is_floating_point else torch.iinfo(dt).max
    mins = torch.full((capacity,), big, dtype=dt, device=dev).scatter_reduce_(
        0, slot, values, "amin"
    )
    maxs = torch.full((capacity,), -big, dtype=dt, device=dev).scatter_reduce_(
        0, slot, values, "amax"
    )
    return table, sums, counts, mins, maxs


def build_join_table(build_keys, capacity: int):
    """Build-side chain layout for a duplicate-preserving join probe:
    (table_keys, bucket_start, bucket_count, row_order), row_order holding
    the build rows grouped by slot (insertion order within a key) and
    bucket_start/count delimiting each slot's run."""
    table, slot = build_table(build_keys, capacity)
    counts = torch.zeros(capacity, dtype=torch.int64, device=slot.device).index_add_(
        0, slot, torch.ones_like(slot)
    )
    start = torch.cumsum(counts, 0) - counts
    order = torch.argsort(slot, stable=True)
    return table, start, counts, order


def probe_counts(table, probe_keys, bucket_counts, capacity: int):
    """For each probe row: its build-side slot (or -1) and match count, by
    a linear-probe chain walk with full-key equality."""
    probe_keys = probe_keys.to(torch.int64)
    cap_mask = capacity - 1
    slot = hash_keys(probe_keys, capacity)
    found = torch.full_like(slot, -1)
    active = torch.ones(slot.shape, dtype=torch.bool, device=slot.device)
    while bool(active.any()):
        occupant = table[slot]
        hit = active & (occupant == probe_keys)
        miss = active & (occupant == EMPTY)
        found = torch.where(hit, slot, found)
        active = active & ~hit & ~miss
        slot = torch.where(active, (slot + 1) & cap_mask, slot)
    counts = torch.where(found >= 0, bucket_counts[torch.clamp(found, min=0)], 0)
    return found, counts


def expand_pairs(found_slot, counts, bucket_start, row_order, out_capacity: int):
    """(build_row, probe_row) index pairs ordered by probe row (the
    reference's emission order), padded to `out_capacity`; `total` is the
    live prefix length. Returns (build_row, probe_row, live, total)."""
    dev = counts.device
    n_probe = counts.shape[0]
    pos = torch.arange(out_capacity, dtype=torch.int64, device=dev)
    if n_probe == 0 or row_order.shape[0] == 0:
        zeros = torch.zeros(out_capacity, dtype=torch.int64, device=dev)
        return zeros, zeros.to(torch.int32), torch.zeros_like(pos, dtype=torch.bool), (
            counts.sum()
        )
    offsets = torch.cumsum(counts, 0) - counts  # start of each probe row's run
    total = offsets[-1] + counts[-1]
    # which probe row does output position p belong to?
    probe_row = torch.searchsorted(offsets + counts, pos, right=True, out_int32=True)
    probe_row = torch.clamp(probe_row, max=n_probe - 1)
    within = pos - offsets[probe_row]
    slot = torch.clamp(found_slot[probe_row], min=0)
    build_pos = bucket_start[slot] + within
    build_row = row_order[torch.clamp(build_pos, 0, row_order.shape[0] - 1)]
    live = pos < total
    return (
        torch.where(live, build_row, 0),
        torch.where(live, probe_row, 0),
        live,
        total,
    )


def hash_join_pairs(build_keys, probe_keys, out_capacity: int | None = None):
    """Inner-join index pairs for int64 keys through the table: build,
    probe, expand. Without out_capacity the live pair count is read on the
    host and rounded up to a power of two."""
    capacity = next_pow2(max(2 * build_keys.shape[0], 16))
    table, start, bcounts, order = build_join_table(build_keys, capacity)
    found, counts = probe_counts(table, probe_keys, bcounts, capacity)
    if out_capacity is None:
        out_capacity = next_pow2(max(int(counts.sum()), 16))
    return expand_pairs(found, counts, start, order, out_capacity)
