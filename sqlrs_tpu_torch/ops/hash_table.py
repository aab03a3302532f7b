"""Hash mixing and the capacity helper of the open-addressing hash table
module.

The port of `next_pow2`, `_mix64` and `hash_keys` from
sqlrs_tpu/ops/hash_table.py: the general GROUP BY and the chunked join
residual call `next_pow2`, and the sharded engine (parallel/) places rows
on shards by `hash_keys(k, 1 << 32) % n_shards` and hashes join keys with
`_mix64`. The table itself (a measured comparison baseline there) is not
ported: the sharded broadcast join finds its candidates in the stably
sorted build hashes instead (parallel/dist_executor.py).

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
