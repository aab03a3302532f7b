"""Fused join + group-by pipelines: the star-rollup path.

The port of sqlrs_tpu/ops/pipelines.py. The fused route
(exec/fused_route.py) and `make_join_groupby('direct')` run
`join_groupby_direct`, `join_groupby_minmax_tv`, `join_groupby_firstapp`,
their rank stage (`_sorted_ranks_left`, `_ranks_and_value_prefix`) and the
order-preserving float transform. Each computes fact ⋈ dim + GROUP BY the
dim key for unique dim keys from ONE packed sort, prefix sums and range
queries in the packed domain, without materializing the join.
`make_join_groupby`'s other strategies are the reference's comparison
points, which no production path reaches: 'hash' (`join_groupby_local`,
over ops/hash_table.py's open-addressing table), 'sorted' and
'sorted_packed' (`join_groupby_sorted(_packed)`: run boundaries of the
sorted fact keys, one range query per run).

The reference's `lax.sort` calls become `torch.sort` (one key: the order
inside a run of equal packed keys does not matter, because every range
query falls between distinct packed values) and stable `torch.argsort`
passes, least significant key first, plus gathers (two keys). Everything is
eager torch on the tensors' device: on CUDA it is PyTorch's own sort, scan
and gather kernels, as the reference leaves these steps to XLA.
"""

from __future__ import annotations

import torch

from sqlrs_tpu_torch.ops.fused import prefix_sum
from sqlrs_tpu_torch.ops.hash_table import build_join_table, next_pow2, probe_counts

_BLK = 128                      # rows per block of the rank stage
_INT64_MIN = -(2**63)


def _pad(x, pad: int, fill):
    return torch.cat([x, torch.full((pad,), fill, dtype=x.dtype, device=x.device)])


def _scatter(perm, x, n: int):
    """zeros(n).at[perm].set(x): perm is a permutation of range(n)."""
    return torch.zeros(n, dtype=x.dtype, device=x.device).index_copy_(0, perm, x)


def _lex_sort(keys, payloads):
    """Sort rows by `keys` (most significant first) and carry `payloads`:
    one stable argsort pass per key, least significant first."""
    perm = torch.argsort(keys[-1], stable=True)
    for k in reversed(keys[:-1]):
        perm = perm[torch.argsort(k[perm], stable=True)]
    return [k[perm] for k in keys], [p[perm] for p in payloads]


def _block_counts(sp2d, q):
    """c[i] = the number of block minima strictly below q[i], from one merge
    sort of (queries ++ block minima) — the reference's
    lax.sort((vals, tags, ids), num_keys=2) with tag 0 for a query and 1 for
    a block minimum. The queries come first in the concatenation, so one
    stable pass on the values puts each query before the minima equal to it,
    which is the (value, tag) order. c is scattered to query order through
    an extra dump slot that every block minimum writes to."""
    nb = sp2d.shape[0]
    nq = q.shape[0]
    dev = q.device
    si = torch.argsort(torch.cat([q, sp2d[:, 0]]), stable=True)
    is_q = si < nq
    pos = torch.arange(nb + nq, dtype=torch.int64, device=dev)
    qrank = torch.cumsum(is_q.to(torch.int64), 0) - 1
    c_at = pos - qrank
    slot = torch.where(is_q, si, torch.full_like(si, nq))
    return torch.zeros(nq + 1, dtype=torch.int64, device=dev).scatter_(0, slot, c_at)[:nq]


def _ranks_and_value_prefix(sp2d, queries, vmask: int, bp):
    """Fused merge-rank + value prefix sum: rank_left(q) and the prefix sum
    of the packed VALUES below q's insertion point, from ONE gathered row
    per query. The insertion point of q lies in candidate block c-1, so

        prefix_values(q) = bp[c-1] + sum(row & vmask where row < q)

    bp: per-block exclusive value-prefix table (nb). Returns (rank_left,
    value_prefix), the prefix in bp's dtype. The in-block values are summed
    at bp's width; the reference casts them to int32 first, which no value
    it can pack (< 2^31, see fused_route) tells apart."""
    nb, blk = sp2d.shape
    n = nb * blk
    q = queries
    c = _block_counts(sp2d, q)
    rows = sp2d[torch.clamp(c - 1, 0, nb - 1)]
    below = rows < q[:, None]
    rank_ge = torch.logical_not(below).sum(1, dtype=torch.int64)
    count_ge = torch.where(c == 0, n, (nb - c) * blk + rank_ge)
    inblock = torch.where(below, rows & vmask, 0).sum(1, dtype=bp.dtype)
    prefix = torch.where(c == 0, 0, bp[torch.clamp(c - 1, 0, nb - 1)] + inblock)
    return n - count_ge, prefix


def _sorted_ranks_left(sp2d, queries):
    """searchsorted(sp.ravel(), queries, side='left') for a block-reshaped
    sorted array, via one small merge sort of (block minima ++ queries) and
    one gathered block row per query. For each query q, c = #block minima
    strictly < q: every block >= c holds only elements >= q, every block
    < c-1 only elements < q, and block c-1 is ranked by a 128-wide row scan
    (the step that the hand kernel `row_rank_ge` in ops/pallas_kernels.py
    computes on its own):
        count_ge(q) = (nb - c)·blk + rank_ge(row[c-1], q)
        rank_left(q) = n - count_ge(q)."""
    nb, blk = sp2d.shape
    n = nb * blk
    q = queries
    c = _block_counts(sp2d, q)
    rows = sp2d[torch.clamp(c - 1, 0, nb - 1)]
    rank_ge = (rows >= q[:, None]).sum(1, dtype=torch.int64)
    count_ge = torch.where(c == 0, n, (nb - c) * blk + rank_ge)
    return n - count_ge


def _payload_sums(payloads, ranks, nb: int, g: int, shared: bool):
    """Per-group sums of each payload (sorted like the packed operand) at
    the rank positions: one block-sum pass, a block prefix table and one
    gathered (Q,128) row per payload — the in-block masked sum is the step
    that the hand kernel `masked_row_sum` (ops/pallas_kernels.py) computes
    on its own. Integer payloads accumulate int64, FLOAT/DOUBLE float64.
    shared: Q = G+1 shared boundaries, else 2G lo/hi queries."""
    if not payloads:
        return []
    dev = ranks.device
    lane = torch.arange(_BLK, dtype=torch.int32, device=dev)
    b = ranks // _BLK
    rem = (ranks % _BLK).to(torch.int32)
    brow = torch.clamp(b, 0, nb - 1)
    bcol = torch.clamp(b, 0, nb)
    under = lane[None, :] < rem[:, None]
    out = []
    for e in payloads:
        acc_dt = torch.float64 if e.is_floating_point() else torch.int64
        e2d = e.view(nb, _BLK)
        ebs = e2d.sum(1, dtype=acc_dt)
        ebp = torch.cat([prefix_sum(ebs) - ebs, ebs.sum().reshape(1)])
        part = torch.where(under, e2d[brow], 0).sum(1, dtype=acc_dt)
        pr = ebp[bcol] + part
        out.append(pr[1:] - pr[:g] if shared else pr[g:] - pr[:g])
    return out


def _boundary_queries(dlo, dhi, shared: bool):
    """G+1 shared boundaries (dense or FK-complete dims) or 2G lo/hi."""
    return torch.cat([dlo, dhi[-1:]]) if shared else torch.cat([dlo, dhi])


def _lo_hi(ranks, g: int, shared: bool):
    return (ranks[:g], ranks[1:]) if shared else (ranks[:g], ranks[g:])


def join_groupby_direct(
    fact_keys, fact_vals, dim_keys_sorted, dim_perm, n_groups: int,
    val_bits: int, pack32: bool, dense: bool = False,
    with_minmax: bool = False, with_distinct: bool = False, extra_vals=(),
    null_ix: int = -1, shared: bool = False,
):
    """fact⋈dim + GROUP BY dim_row for unique dim keys: sort + prefix sum +
    range queries in the packed domain, no N-sized gathers:

        packed = key << vb | value        (int32 when the ranges allow)
        sp  = sort(packed)                — the only O(N log N) step
        lo/hi = rank_left(sp, dim<<vb / (dim+1)<<vb)
        sum = prefix(hi) - prefix(lo); cnt = hi - lo   — G-sized
        scatter by dim_perm                            — G-sized

    Requires 0 <= value < 2^val_bits and key < 2^(31-val_bits) (pack32) or
    2^(63-val_bits). Keys not in dim are never queried; misses still take
    sort slots.

    dense=True: the sorted dim keys are consecutive, so dhi[i] == dlo[i+1]
    and the 2G lo/hi queries collapse to G+1 shared boundaries — exact with
    misses on both sides of the span. shared=True asserts the same for
    non-dense dims whose fact keys all match (FK-complete star joins).

    extra_vals: value columns carried as sort PAYLOADS (any sign, any
    width), summed per group at the same rank positions; appended to the
    result as per-group sums (int64, or float64 for float payloads).

    with_distinct: the packed sort places each group's equal values
    adjacently, so first-occurrence flags of sp give per-group COUNT(DISTINCT
    v) and SUM(DISTINCT v); appended as (dcounts, dsums) after min/max.

    null_ix >= 0 is SENTINEL mode for a NULL-able packed column: the caller
    masks NULL values to vmask = 2^val_bits - 1 (every real value is below
    it), which sorts the NULL block to each range's tail, and passes the
    column's validity as extra_vals[null_ix]. Sums subtract nullcnt·vmask,
    max reads hi-1-nullcnt, and the distinct count/sum drop the sentinel.

    Returns (sums, counts, [mins, maxs,] [dcounts, dsums,] extra sums…) in
    dim_perm order."""
    if pack32:
        dk = dim_keys_sorted.to(torch.int32)
        packed = (fact_keys.to(torch.int32) << val_bits) | fact_vals.to(torch.int32)
        dlo = dk << val_bits
        dhi = (dk + 1) << val_bits
    else:
        packed = (fact_keys << val_bits) | fact_vals
        dlo = dim_keys_sorted << val_bits
        dhi = (dim_keys_sorted + 1) << val_bits
    n = packed.shape[0]
    # pad to a block multiple with dtype-max: it sorts last, outside every
    # dim range (caller contract: max key < 2^(31-vb)-1 / 2^(63-vb)-1)
    pad = (-n) % _BLK
    evs = tuple(extra_vals)
    if pad:
        packed = _pad(packed, pad, torch.iinfo(packed.dtype).max)
        evs = tuple(_pad(e, pad, 0) for e in evs)
    if evs:
        sp, order = torch.sort(packed)
        evs = tuple(e[order] for e in evs)
    else:
        sp = torch.sort(packed).values
    vmask = (1 << val_bits) - 1
    nb = sp.shape[0] // _BLK
    sp2d = sp.view(nb, _BLK)
    bs = (sp2d & vmask).sum(1, dtype=torch.int64)
    bp = torch.cumsum(bs, 0) - bs

    g = dlo.shape[0]
    share = dense or shared
    ranks, prefixes = _ranks_and_value_prefix(
        sp2d, _boundary_queries(dlo, dhi, share), vmask, bp
    )
    lo, hi = _lo_hi(ranks, g, share)
    sum_sorted = prefixes[1:] - prefixes[:g] if share else prefixes[g:] - prefixes[:g]
    cnt_sorted = hi - lo
    derived = []
    if with_distinct:
        # first-occurrence flags of each distinct (key, value): group
        # boundaries always flag 1 (keys in the high bits), duplicates 0
        flag = torch.cat([
            torch.ones(1, dtype=torch.int64, device=sp.device),
            (sp[1:] != sp[:-1]).to(torch.int64),
        ])
        derived = [flag, flag * (sp & vmask).to(torch.int64)]
    es_list = _payload_sums(tuple(derived) + evs, ranks, nb, g, share)
    nullcnt = None
    if null_ix >= 0:
        off = 2 if with_distinct else 0
        nullcnt = cnt_sorted - es_list[off + null_ix]
        sum_sorted = sum_sorted - nullcnt * vmask
        if with_distinct:
            has_null = (nullcnt > 0).to(torch.int64)
            es_list[0] = es_list[0] - has_null          # distinct count
            es_list[1] = es_list[1] - has_null * vmask  # distinct sum
    sums = _scatter(dim_perm, sum_sorted, n_groups)
    counts = _scatter(dim_perm, cnt_sorted, n_groups)
    extra_out = [_scatter(dim_perm, es, n_groups) for es in es_list]
    if with_minmax:
        # each key's range is ordered by VALUE: min/max are its first/last
        # elements (garbage for empty or all-NULL ranges — callers mask
        # those by count / validity count)
        last = sp.shape[0] - 1
        hi_eff = hi - 1 if nullcnt is None else hi - 1 - nullcnt
        min_sorted = (sp[torch.clamp(lo, 0, last)] & vmask).to(torch.int64)
        max_sorted = (sp[torch.clamp(hi_eff, 0, last)] & vmask).to(torch.int64)
        mins = _scatter(dim_perm, min_sorted, n_groups)
        maxs = _scatter(dim_perm, max_sorted, n_groups)
        return (sums, counts, mins, maxs, *extra_out)
    return (sums, counts, *extra_out)


def f64_orderable(v):
    """IEEE-754 order-preserving bit transform: doubles (NaN excluded) map
    to int64 such that signed integer order == float order. Positives keep
    their bits; negatives flip the magnitude bits (t = ~bits ^ minint64)."""
    tu = v.to(torch.float64).view(torch.int64)
    m = torch.full((), _INT64_MIN, dtype=torch.int64, device=tu.device)
    return torch.where(tu < 0, torch.bitwise_not(tu) ^ m, tu)


def f64_from_orderable(t):
    """Inverse of f64_orderable."""
    m = torch.full((), _INT64_MIN, dtype=torch.int64, device=t.device)
    bits = torch.where(t >= 0, t, torch.bitwise_not(t ^ m))
    return bits.view(torch.float64)


def join_groupby_minmax_tv(
    fact_keys, fact_vals_f64, tv, dim_keys_sorted, dim_perm, n_groups: int,
    pack32: bool, dense: bool = False, extra_vals=(), null_ix: int = -1,
):
    """fact⋈dim + GROUP BY key with MIN/MAX over a FLOAT/DOUBLE measure.

    A double cannot share the packed operand with the key, so the measure
    rides as a SECOND sort key, `tv` = f64_orderable(value): within each
    key's range rows are ordered by value, and min/max are the range's
    first/last elements. The measure's SUM rides as a payload (f64, or a
    scaled int64 for k-dp decimals).

    null_ix >= 0 is sentinel mode: NULL tv entries are int64 max (the range
    tail) and extra_vals[null_ix] is the column's validity.

    Returns (sums, counts, mins_f64, maxs_f64, extra sums…)."""
    if pack32:
        keys_op = fact_keys.to(torch.int32)
        dlo = dim_keys_sorted.to(torch.int32)
    else:
        keys_op = fact_keys
        dlo = dim_keys_sorted
    dhi = dlo + 1
    n = keys_op.shape[0]
    pad = (-n) % _BLK
    evs = (fact_vals_f64,) + tuple(extra_vals)
    if pad:
        keys_op = _pad(keys_op, pad, torch.iinfo(keys_op.dtype).max)
        tv = _pad(tv, pad, torch.iinfo(torch.int64).max)
        evs = tuple(_pad(e, pad, 0) for e in evs)
    (sp, tvs), evs = _lex_sort([keys_op, tv], evs)
    nb = sp.shape[0] // _BLK
    sp2d = sp.view(nb, _BLK)

    g = dlo.shape[0]
    ranks = _sorted_ranks_left(sp2d, _boundary_queries(dlo, dhi, dense))
    lo, hi = _lo_hi(ranks, g, dense)
    cnt_sorted = hi - lo
    es_list = _payload_sums(evs, ranks, nb, g, dense)
    sum_sorted, extra_sorted = es_list[0], es_list[1:]
    nullcnt = None
    if null_ix >= 0:
        nullcnt = cnt_sorted - extra_sorted[null_ix]
    last = tvs.shape[0] - 1
    hi_eff = hi - 1 if nullcnt is None else hi - 1 - nullcnt
    min_sorted = f64_from_orderable(tvs[torch.clamp(lo, 0, last)])
    max_sorted = f64_from_orderable(tvs[torch.clamp(hi_eff, 0, last)])
    return (
        _scatter(dim_perm, sum_sorted, n_groups),
        _scatter(dim_perm, cnt_sorted, n_groups),
        _scatter(dim_perm, min_sorted, n_groups),
        _scatter(dim_perm, max_sorted, n_groups),
        *[_scatter(dim_perm, es, n_groups) for es in extra_sorted],
    )


def join_groupby_firstapp(
    fact_keys, fact_vals, dim_keys_sorted, dim_perm, n_groups: int,
    rid_bits: int, dense: bool = False,
):
    """fact⋈dim + GROUP BY key with the engine's first-appearance group order
    recoverable — the ORDER-BY-free sibling of join_groupby_direct. The row
    index (not the value) is packed into the sort key:

        packed = key << rid_bits | rowid        (rowid < 2^rid_bits)
        sort (packed, values…)                  values ride as payloads

    Per-key ranges come from the same rank stage, per-key sums from the
    payload prefix machinery, and the first-appearance rank of each key is
    `sp[lo] & rid_mask`, the smallest probe row of its range (for unique dim
    keys the join emits at most one pair per probe row). Requires
    key_eff_max < 2^(63-rid_bits). fact_vals may be one tensor or a tuple.

    Returns (sums_0, counts, first_rowid, sums_1, …) in dim_perm order."""
    vals = fact_vals if isinstance(fact_vals, tuple) else (fact_vals,)
    n = fact_keys.shape[0]
    dev = fact_keys.device
    rid = torch.arange(n, dtype=torch.int64, device=dev)
    packed = (fact_keys.to(torch.int64) << rid_bits) | rid
    pad = (-n) % _BLK
    if pad:
        packed = _pad(packed, pad, torch.iinfo(torch.int64).max)
        vals = tuple(_pad(v, pad, 0) for v in vals)
    # packed values are unique (the rowid is in them): no order to keep
    sp, order = torch.sort(packed)
    vsorted = [v[order] for v in vals]
    nb = sp.shape[0] // _BLK
    sp2d = sp.view(nb, _BLK)

    dk = dim_keys_sorted.to(torch.int64)
    dlo = dk << rid_bits
    dhi = (dk + 1) << rid_bits
    g = dlo.shape[0]
    ranks = _sorted_ranks_left(sp2d, _boundary_queries(dlo, dhi, dense))
    lo, hi = _lo_hi(ranks, g, dense)
    sums_all = [
        _scatter(dim_perm, s, n_groups)
        for s in _payload_sums(vsorted, ranks, nb, g, dense)
    ]
    rmask = (1 << rid_bits) - 1
    first_sorted = sp[torch.clamp(lo, 0, sp.shape[0] - 1)] & rmask
    counts = _scatter(dim_perm, hi - lo, n_groups)
    firsts = _scatter(dim_perm, first_sorted, n_groups)
    return (sums_all[0], counts, firsts, *sums_all[1:])


def join_groupby_local(fact_keys, fact_vals, dim_keys, n_groups: int, capacity: int):
    """SELECT dim_row, sum(v), count(*) FROM fact JOIN dim USING (key)
    GROUP BY dim_row through the open-addressing table (unique dim keys):
    build on the dim keys, probe every fact key, scatter-add by dim row."""
    table, start, bcounts, order = build_join_table(dim_keys, capacity)
    found, _ = probe_counts(table, fact_keys, bcounts, capacity)
    matched = found >= 0
    slot = torch.clamp(found, min=0)
    dim_row = order[torch.clamp(start[slot], 0, order.shape[0] - 1)]
    gid = torch.where(matched, dim_row, n_groups)
    dev = fact_vals.device
    sums = torch.zeros(n_groups + 1, dtype=fact_vals.dtype, device=dev).index_add_(
        0, gid, torch.where(matched, fact_vals, 0)
    )
    counts = torch.zeros(n_groups + 1, dtype=torch.int64, device=dev).index_add_(
        0, gid, matched.to(torch.int64)
    )
    return sums[:n_groups], counts[:n_groups]


def _runs_to_groups(ks, vs, dim_keys_sorted, dim_perm, n_groups: int, run_capacity: int):
    """The shared tail of the sort-merge strategies: from fact keys `ks`
    sorted with their values `vs`, each run's sum (prefix-sum differences
    at the run ends) and count, keyed into the sorted dim keys, scattered
    by dim row. Returns (sums, counts, n_runs); n_runs > run_capacity
    means runs past the capacity went uncounted."""
    n = ks.shape[0]
    dev = ks.device
    prev = torch.cat([ks[:1] - 1, ks[:-1]])
    rid = torch.cumsum((ks != prev).to(torch.int32), 0, dtype=torch.int32) - 1
    n_runs = rid[-1] + 1
    csum = prefix_sum(vs)
    r = torch.arange(run_capacity, dtype=torch.int32, device=dev)
    ends = torch.searchsorted(rid, r, right=True, out_int32=True)
    prev_end = torch.cat([torch.zeros(1, dtype=ends.dtype, device=dev), ends[:-1]])
    valid_run = ends > prev_end
    last = torch.clamp(ends - 1, 0, n - 1)
    base = torch.where(prev_end > 0, csum[torch.clamp(prev_end - 1, 0, n - 1)], 0)
    run_sum = csum[last] - base
    run_cnt = (ends - prev_end).to(torch.int64)
    run_key = ks[last].contiguous()
    pos = torch.searchsorted(dim_keys_sorted.contiguous(), run_key, out_int32=True)
    pos_c = torch.clamp(pos, 0, n_groups - 1)
    hit = valid_run & (dim_keys_sorted[pos_c] == run_key)
    out_row = torch.where(hit, dim_perm[pos_c], n_groups)
    sums = torch.zeros(n_groups + 1, dtype=vs.dtype, device=dev).index_add_(
        0, out_row, torch.where(hit, run_sum, 0)
    )
    counts = torch.zeros(n_groups + 1, dtype=torch.int64, device=dev).index_add_(
        0, out_row, torch.where(hit, run_cnt, 0)
    )
    return sums[:n_groups], counts[:n_groups], n_runs


def join_groupby_sorted(
    fact_keys, fact_vals, dim_keys_sorted, dim_perm, n_groups: int, run_capacity: int
):
    """Sort-merge join + group-by: sort (key, value), then per-run sums and
    counts from prefix-sum differences at the run ends (run_capacity
    queries, not N), each run's key found in the sorted dim keys. Returns
    (sums, counts, n_runs); n_runs > run_capacity means undercounted
    output (callers size run_capacity >= distinct fact keys)."""
    ks, perm = torch.sort(fact_keys, stable=True)
    return _runs_to_groups(ks, fact_vals[perm], dim_keys_sorted, dim_perm, n_groups,
                           run_capacity)


def join_groupby_sorted_packed(
    fact_keys, fact_vals, dim_keys_sorted, dim_perm, n_groups: int,
    run_capacity: int, val_bits: int,
):
    """join_groupby_sorted with (key << val_bits | value) packed into ONE
    int64 sort operand (key < 2^(63 - val_bits), 0 <= value <
    2^val_bits). Runs stay contiguous per key because the value occupies
    the low bits."""
    sp = torch.sort((fact_keys << val_bits) | fact_vals).values
    return _runs_to_groups(sp >> val_bits, sp & ((1 << val_bits) - 1), dim_keys_sorted,
                           dim_perm, n_groups, run_capacity)


def make_join_groupby(n_groups: int, strategy: str = "direct", slack: int = 2):
    """The star rollup as a function of (fact_keys, fact_vals, dim_keys):
    strategy 'direct' (sort + prefix sum + range queries, the headline
    path), 'sorted'/'sorted_packed' (run-boundary sort-merge, with
    run_capacity slack x n_groups rounded to a power of two) or 'hash'
    (open addressing)."""
    if strategy == "hash":
        capacity = next_pow2(max(2 * n_groups, 16))

        def fn_hash(fact_keys, fact_vals, dim_keys):
            return join_groupby_local(fact_keys, fact_vals, dim_keys, n_groups, capacity)

        return fn_hash
    if strategy != "direct":
        return _make_sorted(n_groups, strategy, next_pow2(max(slack * n_groups, 16)))

    def fn_direct(
        fact_keys, fact_vals, dim_keys, val_bits: int = 7,
        pack32=None, key_max=None, val_max=None,
        dim_min=None, dim_max=None, fk_complete: bool = False,
    ):
        # pack32/val_bits contract: max(key) < 2^(31-val_bits) and
        # 0 <= value < 2^val_bits. Host-known table metadata (catalog
        # min/max) auto-chooses the packing, and dim_min/dim_max (for the
        # UNIQUE dim keys) the dense shared-boundary variant when the dim
        # domain is consecutive: max-min+1 == n_groups.
        if val_max is not None:
            val_bits = max(int(val_max).bit_length(), 1)
        if pack32 is None:
            pack32 = key_max is not None and int(key_max) < (1 << (31 - val_bits)) - 1
        dense = (
            dim_min is not None
            and dim_max is not None
            and int(dim_max) - int(dim_min) + 1 == n_groups
        )
        from sqlrs_tpu_torch.ops.mxu_agg import mxu_eligible, mxu_groupby_dense

        if mxu_eligible(n_groups, val_max, 0, dense, fact_keys.device):
            # dense dim + small non-negative int values: the dense-group
            # kernel (ops/mxu_agg.py) instead of the sort formulation
            return mxu_groupby_dense(
                fact_keys, fact_vals, n_groups, val_bits,
                key_min=int(dim_min), dim_keys=dim_keys, with_perm=True,
            )
        order = torch.argsort(dim_keys, stable=True)
        # fk_complete (every fact key matches some dim key) lets NON-dense
        # dims share range boundaries too
        return join_groupby_direct(
            fact_keys, fact_vals, dim_keys[order], order, n_groups,
            val_bits, bool(pack32), dense,
            shared=bool(fk_complete) and not dense,
        )

    return fn_direct


def _make_sorted(n_groups: int, strategy: str, run_capacity: int):
    """make_join_groupby's sort-merge strategies: 'sorted_packed', and
    'sorted' for any other name, as in the reference."""
    if strategy == "sorted_packed":

        def fn_packed(fact_keys, fact_vals, dim_keys, val_bits: int = 7):
            order = torch.argsort(dim_keys, stable=True)
            sums, counts, _ = join_groupby_sorted_packed(
                fact_keys, fact_vals, dim_keys[order], order, n_groups, run_capacity,
                val_bits,
            )
            return sums, counts

        return fn_packed

    def fn(fact_keys, fact_vals, dim_keys):
        order = torch.argsort(dim_keys, stable=True)
        sums, counts, _ = join_groupby_sorted(
            fact_keys, fact_vals, dim_keys[order], order, n_groups, run_capacity
        )
        return sums, counts

    return fn
