"""Equi-join index-pair generation.

The port of sqlrs_tpu/ops/join.py. It replaces the reference's build/probe
HashMap<u64, Vec<row>> hash join (reference
src/executor/join/hash_join.rs:146-292) with a merged sort: both sides' key
columns are sorted together with the row position as the final key (build
rows precede probe rows within each key, in insertion order), and prefix
sums and maxes hand every probe row its match range into the build side
sorted by key — no searches and no N-sized gathers. Matching is exact
equality of the encoded keys (the reference matches on a 64-bit hash only,
TODO at hash_join.rs:221-224). Match emission order equals the reference's:
probe (right) row outer, build (left) rows in insertion order. NULL join
keys never match (SQL equality semantics).

Two phases split at the single pair-count host sync:

  phase A (`_pairs_phase_a`): the merged sort — stable `torch.argsort`
  passes standing for the reference's `lax.sort(..., num_keys=k + 1)` —
  and the per-probe-row (start, count) ranges;
  phase B (`_expand_body`): ranges → (left_row, right_row) pairs with
  `torch.repeat_interleave(..., output_size=total)`, which needs no sync
  because the total is already on the host.

Each jitted program of the reference is a program here (utils/programs.py):
phase A with the key encodings (`_phase_a_prog`, which also applies the
two-key packing), phase B (`_expand_prog`, the reference's
`_pairs_phase_b`), phase B fused with the output gather (`expand_gather`,
the reference's `_expand_gather_jit`) and the packing's stats
(`_pack2_stats_prog`). The pair count and the stats are fetched between
programs, as there. `_pairs_phase_a` stays a plain function of encoded key
operands for the sharded engine.
"""

from __future__ import annotations

import torch

from sqlrs_tpu_torch.data import Column
from sqlrs_tpu_torch.ops.sort import _encode, _lex_argsort, _rank_table_for, key_kind
from sqlrs_tpu_torch.types import LogicalType
from sqlrs_tpu_torch.utils.programs import program

_INT64_MAX = 2**63 - 1


def _and_alive(v, alive):
    if alive is None:
        return v
    if isinstance(alive, tuple):  # raw (keep_data, keep_valid) pair
        return torch.logical_and(v, torch.logical_and(alive[0], alive[1]))
    return torch.logical_and(v, alive)


def _pairs_phase_a(l_ops, r_ops, num_keys: int, l_alive=None, r_alive=None):
    """l_ops/r_ops: per key column (valid, encoded key) per side. Returns
    per-probe-row (starts, counts) into the build side sorted by key id,
    the stably sorted build row order, and the total pair count (device
    scalar). Optional l_alive/r_alive row masks (fused Filter children) AND
    into every key's validity here.

    ONE merged sort with the row position as the final key (so within each
    key run, build rows precede probe rows, in insertion order), then
    prefix sums/maxes give every probe row its match range."""
    nl = l_ops[0].shape[0]
    nr = r_ops[0].shape[0]
    n = nl + nr
    dev = l_ops[0].device
    ops: list = []
    for i in range(0, num_keys, 2):
        lv = _and_alive(l_ops[i], l_alive)
        rv = _and_alive(r_ops[i], r_alive)
        valid = torch.cat([lv.to(torch.int32), rv.to(torch.int32)])
        key = torch.cat([l_ops[i + 1], r_ops[i + 1]])
        ops.append(valid)
        ops.append(torch.where(valid > 0, key, torch.zeros_like(key)))
    # the position is the final sort key: the passes are stable
    pos = _lex_argsort(ops)
    out = [o[pos] for o in ops]
    boundary = torch.zeros(n, dtype=torch.bool, device=dev)
    boundary[:1].fill_(True)
    for arr in out:
        boundary[1:] |= arr[1:] != arr[:-1]
    allvalid = torch.ones(n, dtype=torch.bool, device=dev)
    for arr in out[0::2]:
        allvalid &= arr > 0

    is_left = pos < nl
    is_lv = is_left & allvalid  # valid build rows
    lv64 = is_lv.to(torch.int64)
    cum_left = torch.cumsum(lv64, 0)  # inclusive prefix
    # valid-build count BEFORE each run start, broadcast through the run.
    # The reference takes a running max (run starts carry a non-decreasing
    # prefix); here each run start scatters its prefix to its run id and
    # every row gathers its run's: the same values, without torch.cummax,
    # whose 1-D CUDA scan is one serial pass (~19 ms at TPC-H SF1's 7.5M
    # rows on an H100, PERF.md)
    run_id = torch.cumsum(boundary.to(torch.int64), 0) - 1
    run_start = torch.zeros(n + 1, dtype=torch.int64, device=dev).scatter_(
        0, torch.where(boundary, run_id, n), cum_left - lv64
    )
    cl0 = run_start[run_id]
    # build rows precede probe rows within a run (position is a sort key),
    # so at any probe row the run's build rows are fully counted
    counts_sorted = cum_left - cl0
    is_rv = torch.logical_not(is_left) & allvalid
    packed = torch.where(is_rv, (cl0 << 31) | counts_sorted, 0)
    # every probe row appears exactly once: scatter its packed range to its
    # probe position (build rows write to one dump slot past the end;
    # invalid probe rows carry packed = 0)
    probe_pos = torch.where(is_left, nr, pos - nl)
    packed_by_probe = torch.zeros(nr + 1, dtype=torch.int64, device=dev).scatter_(
        0, probe_pos, packed
    )[:nr]
    starts = packed_by_probe >> 31
    counts = packed_by_probe & ((1 << 31) - 1)
    # build-side order: valid build rows first, already in (key, insertion)
    # order — each scatters its position to its rank among them (the tail
    # past the valid rows is never read)
    dest = torch.where(is_lv, cum_left - 1, nl)
    order = torch.zeros(nl + 1, dtype=torch.int64, device=dev).scatter_(0, dest, pos)[:nl]
    return starts, counts, order, counts.sum()


def _expand_body(starts, counts, order, total: int):
    """Pair expansion shared by the phase-B callers."""
    nr = counts.shape[0]
    dev = counts.device
    r_idx = torch.repeat_interleave(
        torch.arange(nr, dtype=torch.int64, device=dev), counts, output_size=total
    )
    base = torch.repeat_interleave(
        torch.cumsum(counts, 0) - counts, counts, output_size=total
    )
    pos = torch.arange(total, dtype=torch.int64, device=dev) - base + torch.repeat_interleave(
        starts, counts, output_size=total
    )
    l_idx = order[torch.clamp(pos, 0, order.shape[0] - 1)]
    return l_idx, r_idx


def _pack2_stats(lk1, lv1, lk2, lv2, rk1, rv1, rk2, rv2):
    """min/max of each key column over VALID rows of BOTH sides — drives
    the 2-key -> one-operand packing below (one fetch)."""
    big = _INT64_MAX

    def mm(lk, lv, rk, rv):
        k = torch.cat([lk.to(torch.int64), rk.to(torch.int64)])
        v = torch.cat([lv, rv])
        return torch.where(v, k, big).min(), torch.where(v, k, -big).max()

    a, b = mm(lk1, lv1, rk1, rv1)
    c, d = mm(lk2, lv2, rk2, rv2)
    return torch.stack([a, b, c, d])


def _pack2_apply(v1, k1, v2, k2, min1: int, min2: int, b2: int):
    """(valid, packed) for one side: both keys rebased and packed into one
    int64 — the 2-key sort becomes a 1-key one."""
    v = torch.logical_and(v1, v2)
    p = ((k1.to(torch.int64) - min1) << b2) | (k2.to(torch.int64) - min2)
    return v, torch.where(v, p, 0)


_PACK2_MIN_ROWS = 1 << 21


def _try_pack2(l_ops, r_ops):
    """2-key mark joins: fold both key columns into ONE int64 sort operand
    when the ranges fit (one stats pass + one small fetch + one pack per
    side): a sort pass per key is the cost, so two keys in one halves it.
    Q21's (orderkey, suppkey) equal-pair count is the shape this serves.
    Returns (l_ops2, r_ops2) or None."""
    for o in (l_ops[1], l_ops[3], r_ops[1], r_ops[3]):
        if o.is_floating_point():
            return None
    m = _pack2_stats(
        l_ops[1], l_ops[0], l_ops[3], l_ops[2],
        r_ops[1], r_ops[0], r_ops[3], r_ops[2],
    ).cpu().numpy()
    b2 = _pack2_width(m)
    if b2 is None:
        return None
    min1, min2 = int(m[0]), int(m[2])
    lv, lp = _pack2_apply(l_ops[0], l_ops[1], l_ops[2], l_ops[3], min1, min2, b2)
    rv, rp = _pack2_apply(r_ops[0], r_ops[1], r_ops[2], r_ops[3], min1, min2, b2)
    return [lv, lp], [rv, rp]


def _key_args(left_keys: list[Column], right_keys: list[Column]):
    """A program's key arguments: both sides' columns, the rank table when
    a key is VARCHAR (fetched outside the program), and the key kinds."""
    cols = list(left_keys) + list(right_keys)
    return (
        tuple(c.data for c in left_keys), tuple(c.valid for c in left_keys),
        tuple(c.data for c in right_keys), tuple(c.valid for c in right_keys),
        _rank_table_for(cols) if any(c.type == LogicalType.VARCHAR for c in cols) else None,
    ), tuple((key_kind(l.type), key_kind(r.type)) for l, r in zip(left_keys, right_keys))


def _encoded_ops(l_datas, l_valids, r_datas, r_valids, rank, kinds):
    """(valid, encoded key) per key and side, as orderable_key encodes them."""
    l_ops: list = []
    r_ops: list = []
    for ld, lv, rd, rv, (lkind, rkind) in zip(l_datas, l_valids, r_datas, r_valids, kinds):
        lk = _encode(lkind, ld, rank)
        rk = _encode(rkind, rd, rank)
        l_ops += [lv, lk]
        r_ops += [rv, rk.to(lk.dtype)]
    return l_ops, r_ops


@program
def _pack2_stats_prog(l_datas, l_valids, r_datas, r_valids, rank, kinds):
    l_ops, r_ops = _encoded_ops(l_datas, l_valids, r_datas, r_valids, rank, kinds)
    return _pack2_stats(
        l_ops[1], l_ops[0], l_ops[3], l_ops[2],
        r_ops[1], r_ops[0], r_ops[3], r_ops[2],
    )


@program
def _phase_a_prog(l_datas, l_valids, r_datas, r_valids, rank, l_alive, r_alive,
                  stats, kinds, b2, counts_only: bool):
    """Key encodings, the two-key packing when `b2` is set (its minima read
    on the device from `stats`), and phase A, in one program (the
    reference's `_pack2_apply` and `_pairs_phase_a`)."""
    l_ops, r_ops = _encoded_ops(l_datas, l_valids, r_datas, r_valids, rank, kinds)
    if b2 is not None:
        min1, min2 = stats[0], stats[2]
        l_ops = list(_pack2_apply(l_ops[0], l_ops[1], l_ops[2], l_ops[3], min1, min2, b2))
        r_ops = list(_pack2_apply(r_ops[0], r_ops[1], r_ops[2], r_ops[3], min1, min2, b2))
    starts, counts, order, total = _pairs_phase_a(
        tuple(l_ops), tuple(r_ops), len(l_ops), l_alive, r_alive
    )
    return counts if counts_only else (starts, counts, order, total)


def _pack2_width(m) -> int | None:
    """The packing's shift for stats m (host values), or None when the
    keys do not pack (_try_pack2's rule)."""
    if m[0] > m[1] or m[2] > m[3]:
        return None  # a side with no valid rows: leave unpacked
    span1 = int(m[1]) - int(m[0]) + 1
    span2 = int(m[3]) - int(m[2]) + 1
    b2 = max(span2.bit_length(), 1)
    if span1.bit_length() + b2 > 62:
        return None
    return b2


def match_counts(build_keys: list[Column], probe_keys: list[Column],
                 build_alive=None):
    """Per-probe-row count of matching build rows — the mark-join primitive
    (semi/anti/EXISTS) — with NO pair expansion and NO host sync: just
    _pairs_phase_a's merged sort. NULL keys on either side never match;
    build_alive optionally masks build rows.

    Two-key marks at scale pack both keys into one operand (_try_pack2's
    rule; one stats program and one small fetch first): packed equality ==
    pairwise equality for in-range keys, and NULLs (either column) stay
    non-matching via the ANDed validity."""
    nl = len(build_keys[0])
    nr = len(probe_keys[0])
    if nl == 0 or nr == 0:
        return torch.zeros(nr, dtype=torch.int64, device=probe_keys[0].data.device)
    args, kinds = _key_args(build_keys, probe_keys)
    stats, b2 = None, None
    if (len(build_keys) == 2 and nl + nr >= _PACK2_MIN_ROWS
            and all(lk != "float" for lk, _ in kinds)):
        stats = _pack2_stats_prog(*args, kinds=kinds)
        b2 = _pack2_width(stats.cpu().numpy())
    return _phase_a_prog(
        *args, build_alive, None, stats if b2 is not None else None,
        kinds=kinds, b2=b2, counts_only=True,
    )


def pair_ranges(left_keys: list[Column], right_keys: list[Column],
                l_alive=None, r_alive=None):
    """Phase A of pair emission: per-probe-row match ranges.
    Returns (starts, counts, order, total) — total is a host int (the single
    pipeline-breaker sync) — or None when either side is empty. Callers that
    schedule their own expansion (bounded-memory chunked residual filtering,
    exec/executor._residual_pairs_chunked) start here. l_alive/r_alive are
    optional fused-Filter row masks ANDed into key validity."""
    nl = len(left_keys[0])
    nr = len(right_keys[0])
    if nl == 0 or nr == 0:
        return None
    args, kinds = _key_args(left_keys, right_keys)
    starts, counts, order, total = _phase_a_prog(
        *args, l_alive, r_alive, None, kinds=kinds, b2=None, counts_only=False
    )
    return starts, counts, order, int(total)


@program
def _expand_prog(starts, counts, order, total: int):
    return _expand_body(starts, counts, order, total)


def expand_pairs(starts, counts, order, total: int):
    """Phase B: materialize the (left_row, right_row) pair tensors for a
    pair_ranges result, probe-major order."""
    if total == 0:
        z = torch.zeros(0, dtype=torch.int64, device=counts.device)
        return z, z
    return _expand_prog(starts, counts, order, total)


@program
def _expand_gather_prog(starts, counts, order, l_datas, l_valids, r_datas,
                        r_valids, total: int):
    l_idx, r_idx = _expand_body(starts, counts, order, total)
    return (
        tuple(d[l_idx] for d in l_datas), tuple(v[l_idx] for v in l_valids),
        tuple(d[r_idx] for d in r_datas), tuple(v[r_idx] for v in r_valids),
    )


def expand_gather(pr, left_cols: list[Column], right_cols: list[Column]):
    """Phase B fused with the gather of both sides' output columns (the
    reference's expand_gather_pairs): the inner join's rows, probe-major,
    as (left columns, right columns)."""
    starts, counts, order, total = pr
    ld, lv, rd, rv = _expand_gather_prog(
        starts, counts, order,
        tuple(c.data for c in left_cols), tuple(c.valid for c in left_cols),
        tuple(c.data for c in right_cols), tuple(c.valid for c in right_cols),
        total,
    )
    return (
        [Column(c.type, d, v) for c, d, v in zip(left_cols, ld, lv)],
        [Column(c.type, d, v) for c, d, v in zip(right_cols, rd, rv)],
    )


def equi_join_pairs(left_keys: list[Column], right_keys: list[Column]):
    """All matching (left_row, right_row) pairs, ordered by (right_row,
    left insertion order) to reproduce the reference's probe-order emission
    (hash_join.rs:207-250). ONE host sync (the pair count)."""
    pr = pair_ranges(left_keys, right_keys)
    if pr is None:
        z = torch.zeros(0, dtype=torch.int64, device=left_keys[0].data.device)
        return z, z
    return expand_pairs(*pr)
