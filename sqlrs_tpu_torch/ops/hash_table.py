"""Capacity helper of the open-addressing hash table module.

The port of `next_pow2` from sqlrs_tpu/ops/hash_table.py, the one function
of that file the general GROUP BY and the chunked join residual call. The
table itself (a measured comparison baseline there) and its sharded users
are not ported: no production path on one device runs them.
"""

from __future__ import annotations


def next_pow2(n: int) -> int:
    c = 1
    while c < n:
        c *= 2
    return c
