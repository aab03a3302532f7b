"""Distributed operators: shuffle, join + group-by, sort over a shard mesh.

The port of sqlrs_tpu/parallel/dist_ops.py. Each `shard_map(local, ...)`
program of the reference is a program here (`utils/programs.mesh_program`):
one function that runs its per-shard stages in a loop over this process's
shards and calls parallel/collectives.py between them, so a `local` body is
split at each collective in the code, but on a mesh whose shards share one
card, in one process, the bodies and the collectives are captured into one
CUDA graph and replayed after, one submission a call as the reference's
one dispatch. A process-group mesh, or shards on several cards, runs the
same function eagerly. A sharded array is a list of this process's
per-shard tensors, element j on `mesh.devices[j]` (global shard
`mesh.offset + j`); a replicated result is one tensor (the first shard's
copy), the same in every process. The join + group-by entry points take
the whole (unsharded) arrays, as every process of a multi-process mesh
holds them, and place only this process's shards inside the program.

- partition_shuffle: repartition rows by key hash through `all_to_all`
  with a fixed per-destination bucket capacity (padding carries a
  validity mask; overflow is counted, never silent).
- dist_join_groupby_broadcast / _shuffle(_checked) / _salted(_checked) /
  _ring: fact ⋈ dim + GROUP BY dim row, dim replicated, both sides
  hash-shuffled, hot keys salted, or dim chunks rotated around the ring.
  Every strategy answers each dim key's range of the shard's sorted fact
  rows with prefix-sum differences; one psum combines the partials.
- dist_sort / dist_sort_rows: sample sort — splitters from a gathered
  sample, bucket all_to_all, one local sort per shard.

No program body reads the host: the overflow counts leave a program as
tensors and the `_checked` retries (and dist_sort_rows' caller) read them
after it, once a try, as the reference reads its programs' outputs.
`lax.scan` over ring steps is a Python loop over steps, each over the
shards. The reference issues each step's ppermute before the probe that
does not depend on it, so that XLA overlaps the two; the steps keep that
order here (in a graph the two are still one stream's work, in order).
"""

from __future__ import annotations

import torch

from sqlrs_tpu_torch.ops.fused import prefix_sum
from sqlrs_tpu_torch.ops.hash_table import hash_keys
from sqlrs_tpu_torch.ops.sort import _lex_argsort
from sqlrs_tpu_torch.parallel import collectives
from sqlrs_tpu_torch.parallel.mesh import live_blocks, replicate, row_blocks
from sqlrs_tpu_torch.utils.programs import mesh_program

_BLK = 128
_MAXK = 2**63 - 1
# dim rows answered per pass of the range queries: each query gathers one
# 128-wide block row (1 KiB of int64 keys, again per summed column), so a
# pass holds a few GiB at most however many dim slots a shard holds
_QUERY_CHUNK = 1 << 19


def _chunk_key() -> tuple:
    """The module state the range-query programs read (tests change it)."""
    return (_QUERY_CHUNK,)


def _overflow_scalar(mesh, xs) -> int:
    """Max over the shards of a per-shard overflow counter: one host read."""
    return int(collectives.reduce_max(mesh, [x.reshape(-1).max() for x in xs]))


# ---- shard-local sorted join+group-by core -----------------------------------
#
# All four join+group-by strategies share one shard-local compute: fact rows
# joined to (a chunk of) the dim table, partial sums and counts by dim row.
# Sort the local fact rows once, then answer each dim key's [k, k+1) range
# with merge-ranked prefix-sum differences; the only scatter is G-sized.
# int64 max is a reserved key (masked rows).


def _sorted_fact_blocks(fk, fv, fm):
    """Sort local fact rows by key (masked rows -> reserved max key, sorted
    last) and precompute 128-wide block prefix sums of the values."""
    key = torch.where(fm, fk.to(torch.int64), _MAXK)
    ks, perm = torch.sort(key, stable=True)
    vs = fv[perm]
    pad = (-ks.shape[0]) % _BLK
    if pad:
        ks = torch.cat([ks, torch.full((pad,), _MAXK, dtype=ks.dtype, device=ks.device)])
        vs = torch.cat([vs, torch.zeros(pad, dtype=vs.dtype, device=vs.device)])
    k2d = ks.view(-1, _BLK)
    v2d = vs.view(-1, _BLK)
    bs = v2d.sum(1, dtype=vs.dtype)
    bp = torch.cat([prefix_sum(bs) - bs, bs.sum().reshape(1)])
    return k2d, v2d, bp


def _prefix_at(v2d, bp, pos):
    """Prefix sum of the block-laid values below each position."""
    nb = v2d.shape[0]
    lane = torch.arange(_BLK, dtype=torch.int32, device=pos.device)
    b = pos // _BLK
    rem = (pos % _BLK).to(torch.int32)
    rows = v2d[torch.clamp(b, 0, nb - 1)]
    part = torch.where(lane[None, :] < rem[:, None], rows, 0).sum(1, dtype=v2d.dtype)
    return bp[b] + part


def _range_partials(k2d, v2d, bp, dk, dm):
    """Per dim key k: (sum, count) of fact values with key in [k, k+1).
    Invalid dim rows query an empty range. Answered _QUERY_CHUNK dim rows
    at a time (each answer depends on its own row only)."""
    from sqlrs_tpu_torch.ops import pipelines

    if dk.shape[0] > _QUERY_CHUNK:
        parts = [
            _range_partials(k2d, v2d, bp, dk[i:i + _QUERY_CHUNK], dm[i:i + _QUERY_CHUNK])
            for i in range(0, dk.shape[0], _QUERY_CHUNK)
        ]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    dk = dk.to(torch.int64)
    dlo = torch.where(dm, dk, _MAXK)
    dhi = torch.where(dm, dk + 1, _MAXK)
    g = dlo.shape[0]
    ranks = pipelines._sorted_ranks_left(k2d, torch.cat([dlo, dhi]))
    lo, hi = ranks[:g], ranks[g:]
    return _prefix_at(v2d, bp, hi) - _prefix_at(v2d, bp, lo), hi - lo


def _scatter_add(n: int, tgt, vals):
    """zeros(n + 1).at[tgt].add(vals)[:n]; tgt == n is the dump slot. The
    callers' targets are distinct outside the dump slot, so float sums do
    not depend on the order of the adds."""
    out = torch.zeros(n + 1, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, tgt, vals)[:n]


def _local_join_groupby(fk, fv, fm, dk, drow, dm, n_groups: int):
    """(sums, counts) partials by dim row id over one shard's fact rows."""
    k2d, v2d, bp = _sorted_fact_blocks(fk, fv, fm)
    sum_d, cnt_d = _range_partials(k2d, v2d, bp, dk, dm)
    tgt = torch.where(dm, drow, n_groups)
    return _scatter_add(n_groups, tgt, sum_d), _scatter_add(n_groups, tgt, cnt_d)


# ---- exchange: repartition by key hash --------------------------------------


def _bucketize_rows(arrays, dest, n_dev: int, bucket_capacity: int):
    """The scatter half of the exchange: lay rows into per-destination
    buckets. Returns (tuple of (n_dev, cap) buffers, (n_dev, cap) live
    mask, local overflow count). dest == n_dev drops the row."""
    n = dest.shape[0]
    dev = dest.device
    cap = bucket_capacity
    order = torch.argsort(dest, stable=True)
    d_s = dest[order].to(torch.int64)
    ok = d_s < n_dev
    d_c = torch.clamp(d_s, 0, n_dev - 1)
    counts = torch.zeros(n_dev, dtype=torch.int64, device=dev).index_add_(
        0, torch.where(ok, d_s, 0), ok.to(torch.int64)
    )
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, dtype=torch.int64, device=dev) - starts[d_c]
    in_cap = ok & (pos < cap)
    overflow = (ok & torch.logical_not(in_cap)).sum()
    flat = torch.where(in_cap, d_c * cap + pos, n_dev * cap)
    bufs = []
    for a in arrays:
        buf = torch.zeros(n_dev * cap + 1, dtype=a.dtype, device=dev)
        buf[flat] = a[order]
        bufs.append(buf[:-1].view(n_dev, cap))
    mbuf = torch.zeros(n_dev * cap + 1, dtype=torch.bool, device=dev)
    mbuf[flat] = in_cap
    return tuple(bufs), mbuf[:-1].view(n_dev, cap), overflow


def _exchange_rows(mesh, arrays, dests, bucket_capacity: int):
    """all_to_all each shard's rows to their `dest` shards (dest == n_dev
    drops the row). arrays[s] is shard s's tuple of row arrays. Returns
    (per shard: tuple of received arrays, received masks, local overflow
    counts). overflow > 0 means live rows did NOT fit their (sender,
    receiver) bucket and were dropped: callers must surface it (retry
    bigger or raise), never ignore it."""
    n_dev = mesh.size
    parts = [
        _bucketize_rows(a, d, n_dev, bucket_capacity) for a, d in zip(arrays, dests)
    ]
    n_arr = len(arrays[0])
    received = [[] for _ in parts]
    for k in range(n_arr):
        recv = collectives.all_to_all(mesh, [p[0][k] for p in parts])
        for s, r in enumerate(recv):
            received[s].append(r.reshape(-1))
    masks = collectives.all_to_all(mesh, [p[1] for p in parts])
    return (
        [tuple(r) for r in received],
        [m.reshape(-1) for m in masks],
        [p[2] for p in parts],
    )


@mesh_program
def partition_shuffle(mesh, keys, values, valid, bucket_capacity: int):
    """Repartition per-shard (keys, values, valid) so rows land on shard
    hash(key) % n_dev. Per-destination buckets are padded to
    `bucket_capacity` rows; overflow rows are dropped with a returned
    per-shard overflow count so callers can size up and retry. Returns
    (keys, values, valid, overflow) per shard.

    One program: the reference's shard_map at
    sqlrs_tpu/parallel/dist_ops.py:165."""
    n_dev = mesh.size
    dests = [
        torch.where(v, hash_keys(k, 1 << 32) % n_dev, n_dev)
        for k, v in zip(keys, valid)
    ]
    recv, masks, ovf = _exchange_rows(
        mesh, [(k, v) for k, v in zip(keys, values)], dests, bucket_capacity
    )
    return (
        [r[0] for r in recv],
        [r[1] for r in recv],
        masks,
        [o.reshape(1) for o in ovf],
    )


# ---- fused distributed join + group-by ----------------------------------------


def _placed_fact_dim(mesh, fact_keys, fact_vals, dim_keys):
    """The padded block layout of both sides: fact keys/values/valid and
    dim keys/row ids/valid per shard."""
    n_dim = int(dim_keys.shape[0])
    dim_rows = torch.arange(n_dim, dtype=torch.int64, device=dim_keys.device)
    return (
        row_blocks(mesh, fact_keys), row_blocks(mesh, fact_vals),
        live_blocks(mesh, int(fact_keys.shape[0])),
        row_blocks(mesh, dim_keys), row_blocks(mesh, dim_rows),
        live_blocks(mesh, n_dim),
    )


@mesh_program(extra=_chunk_key)
def dist_join_groupby_broadcast(mesh, fact_keys, fact_vals, dim_keys, n_groups: int):
    """SELECT dim_row, sum(v), count(*) FROM fact JOIN dim USING (key)
    GROUP BY dim_row — dim replicated, fact sharded.

    Returns (sums[n_groups], counts[n_groups]) replicated. Group id == dim
    row index (dim keys unique — the fact→dimension join). One psum of
    O(n_groups) is the only cross-shard traffic.

    One program, placement included: the reference's shard_map at
    sqlrs_tpu/parallel/dist_ops.py:193."""
    fk = row_blocks(mesh, fact_keys)
    fv = row_blocks(mesh, fact_vals)
    fm = live_blocks(mesh, int(fact_keys.shape[0]))
    dks = replicate(mesh, dim_keys)
    sums, cnts = [], []
    for s in range(mesh.n_local):
        dk = dks[s]
        drow = torch.arange(dk.shape[0], dtype=torch.int64, device=dk.device)
        dm = torch.ones(dk.shape[0], dtype=torch.bool, device=dk.device)
        sm, ct = _local_join_groupby(fk[s], fv[s], fm[s], dk, drow, dm, n_groups)
        sums.append(sm)
        cnts.append(ct)
    return collectives.reduce_sum(mesh, sums), collectives.reduce_sum(mesh, cnts)


@mesh_program(extra=_chunk_key)
def dist_join_groupby_shuffle(
    mesh, fact_keys, fact_vals, dim_keys, n_groups: int, bucket_capacity: int
):
    """General large-large path: both sides repartitioned by key hash, then
    a per-shard join + partial aggregation; partials combined with psum.

    Returns (sums, counts, overflow): overflow > 0 means a (sender,
    receiver) bucket exceeded bucket_capacity and ROWS WERE DROPPED — the
    result is NOT trustworthy and the caller must retry with a larger
    capacity (dist_join_groupby_shuffle_checked does this) or raise.

    One program: the reference's shard_map at
    sqlrs_tpu/parallel/dist_ops.py:235."""
    fk, fv, fm, dk, drow, dm = _placed_fact_dim(mesh, fact_keys, fact_vals, dim_keys)
    fk, fv, fm, ovf_f = partition_shuffle(mesh, fk, fv, fm, bucket_capacity)
    dk, drow, dm, ovf_d = partition_shuffle(mesh, dk, drow, dm, bucket_capacity)
    sums, cnts = [], []
    for s in range(mesh.n_local):
        sm, ct = _local_join_groupby(fk[s], fv[s], fm[s], dk[s], drow[s], dm[s], n_groups)
        sums.append(sm)
        cnts.append(ct)
    overflow = collectives.reduce_sum(mesh, [a + b for a, b in zip(ovf_f, ovf_d)])
    return (
        collectives.reduce_sum(mesh, sums), collectives.reduce_sum(mesh, cnts),
        overflow.reshape(()),
    )


def dist_join_groupby_shuffle_checked(
    mesh, fact_keys, fact_vals, dim_keys, n_groups: int, bucket_capacity: int
):
    """Retries with 4x capacity until no exchange bucket overflows.
    Capacity == total padded rows always fits, so the loop terminates;
    silent row drops are impossible through this entry point."""
    n_dev = mesh.size
    n_pad = fact_keys.shape[0] + (-fact_keys.shape[0]) % n_dev
    d_pad = dim_keys.shape[0] + (-dim_keys.shape[0]) % n_dev
    cap_max = max(n_pad, d_pad)
    while True:
        sums, cnts, overflow = dist_join_groupby_shuffle(
            mesh, fact_keys, fact_vals, dim_keys, n_groups, bucket_capacity
        )
        if int(overflow) == 0:
            return sums, cnts
        if bucket_capacity >= cap_max:  # pragma: no cover - cap_max always fits
            raise RuntimeError("exchange overflow at full capacity")
        bucket_capacity = min(bucket_capacity * 4, cap_max)


@mesh_program(extra=_chunk_key)
def dist_join_groupby_salted(
    mesh, fact_keys, fact_vals, dim_keys, n_groups: int, bucket_capacity: int,
    hot_capacity: int = 1024, hot_factor: float = 4.0,
):
    """Skew-aware shuffle join + group-by (salted-key splitting):

    1. per-shard key histograms over hash buckets → psum → buckets with
       > hot_factor × mean are "hot";
    2. fact rows with hot keys are salted: their destination spreads
       round-robin over all shards instead of hash(key) % n_dev;
    3. dim rows in hot buckets are REPLICATED to every shard (all_gather
       of the small hot subset, capacity `hot_capacity`), cold dim rows
       shuffle normally;
    4. a local join + partial aggregate by dim row id; one psum combines.
       Every fact row is processed exactly once, so replication cannot
       double-count.

    Returns (sums, counts, overflow). One program: the reference's
    shard_map at sqlrs_tpu/parallel/dist_ops.py:366."""
    n_dev = mesh.size
    n_buckets = 4096
    fk, fv, fm, dk, drow, dm = _placed_fact_dim(mesh, fact_keys, fact_vals, dim_keys)
    rng = range(mesh.n_local)

    # ---- stage 1: per-shard key histograms, psum'd ----------------------------
    bucket_f = [hash_keys(fk[s], n_buckets) for s in rng]
    hists = [
        _scatter_add(n_buckets, bucket_f[s], fm[s].to(torch.int64)) for s in rng
    ]
    hists = collectives.psum(mesh, hists)

    # ---- stage 2: fact exchange (hot rows salted round-robin) ----------------
    hot, f_dest, d_hot, d_dest = [], [], [], []
    for s in rng:
        # float64 like the reference's x64 promotion (a python float times
        # an int64 tensor would be float32 in torch)
        total = hists[s].sum().to(torch.float64)
        h = hists[s] > (hot_factor * total / n_buckets)
        hot.append(h)
        n = fk[s].shape[0]
        base = hash_keys(fk[s], 1 << 32) % n_dev
        salt = torch.arange(n, dtype=torch.int64, device=fk[s].device) % n_dev
        dest = torch.where(h[bucket_f[s]], salt, base)
        f_dest.append(torch.where(fm[s], dest, n_dev))
        # dim: cold rows shuffle, hot rows all_gather
        dh = h[hash_keys(dk[s], n_buckets)] & dm[s]
        d_hot.append(dh)
        d_dest.append(torch.where(
            dm[s] & torch.logical_not(dh), hash_keys(dk[s], 1 << 32) % n_dev, n_dev
        ))
    f_recv, fm2, ovf_f = _exchange_rows(
        mesh, [(fk[s], fv[s]) for s in rng], f_dest, bucket_capacity
    )
    d_recv, dm_cold, ovf_d = _exchange_rows(
        mesh, [(dk[s], drow[s]) for s in rng], d_dest, bucket_capacity
    )
    # hot subset to a fixed-capacity buffer, then all_gather; hot rows
    # beyond hot_capacity are NOT carried — counted as overflow so the
    # caller retries (silent truncation = wrong answers under skew)
    ovf_hot, hk, hr, hm = [], [], [], []
    for s in rng:
        ovf_hot.append(torch.clamp(d_hot[s].to(torch.int64).sum() - hot_capacity, min=0))
        hot_order = torch.argsort(torch.logical_not(d_hot[s]).to(torch.int8), stable=True)
        hot_order = hot_order[:hot_capacity]
        hk.append(dk[s][hot_order])
        hr.append(drow[s][hot_order])
        hm.append(d_hot[s][hot_order])
    hk = collectives.all_gather(mesh, hk)
    hr = collectives.all_gather(mesh, hr)
    hm = collectives.all_gather(mesh, hm)

    # ---- stage 3: local join + partial agg --------------------------------------
    sums, cnts, ovfs = [], [], []
    for s in rng:
        dk_all = torch.cat([d_recv[s][0], hk[s].reshape(-1)])
        drow_all = torch.cat([d_recv[s][1], hr[s].reshape(-1)])
        dm_all = torch.cat([dm_cold[s], hm[s].reshape(-1)])
        sm, ct = _local_join_groupby(
            f_recv[s][0], f_recv[s][1], fm2[s], dk_all, drow_all, dm_all, n_groups
        )
        sums.append(sm)
        cnts.append(ct)
        ovfs.append(ovf_f[s] + ovf_d[s] + ovf_hot[s])
    return (
        collectives.reduce_sum(mesh, sums), collectives.reduce_sum(mesh, cnts),
        collectives.reduce_sum(mesh, ovfs),
    )


def dist_join_groupby_salted_checked(
    mesh, fact_keys, fact_vals, dim_keys, n_groups: int, bucket_capacity: int,
    hot_capacity: int = 1024, hot_factor: float = 4.0,
):
    """Retries the salted join with 4x bucket AND hot capacities until
    nothing overflowed. Both capacities are bounded by the padded input
    sizes, so the loop terminates with every row processed exactly once."""
    n_dev = mesh.size
    n_pad = fact_keys.shape[0] + (-fact_keys.shape[0]) % n_dev
    d_pad = dim_keys.shape[0] + (-dim_keys.shape[0]) % n_dev
    cap_max = max(n_pad, d_pad)
    while True:
        sums, cnts, overflow = dist_join_groupby_salted(
            mesh, fact_keys, fact_vals, dim_keys, n_groups,
            bucket_capacity, hot_capacity, hot_factor,
        )
        if int(overflow) == 0:
            return sums, cnts
        if bucket_capacity >= cap_max and hot_capacity >= d_pad:
            raise RuntimeError(  # pragma: no cover - full capacity always fits
                "exchange overflow at full capacity"
            )
        bucket_capacity = min(bucket_capacity * 4, cap_max)
        hot_capacity = min(hot_capacity * 4, d_pad)


@mesh_program(extra=_chunk_key)
def dist_join_groupby_ring(mesh, fact_keys, fact_vals, dim_keys, n_groups: int):
    """Ring join + group-by: both sides stay sharded and no key shuffle
    happens. Over n_dev ring steps each shard probes its resident fact rows
    against the dim chunk it holds, and the chunks move one shard along the
    ring by ppermute. Memory per shard is O(N/p + G/p + G); the collective
    payload is the dim table once around the ring plus one O(G) psum.

    Returns (sums[n_groups], counts[n_groups]) replicated. One program,
    every ring step in it: the reference's shard_map at
    sqlrs_tpu/parallel/dist_ops.py:482."""
    n_dev = mesh.size
    fk, fv, fm, dk, drow, dm = _placed_fact_dim(mesh, fact_keys, fact_vals, dim_keys)
    perm = collectives.ring_perm(n_dev)
    # the fact side is sorted ONCE; each ring step answers the resident dim
    # chunk's range queries against the same sorted blocks
    rng = range(mesh.n_local)
    tables = [_sorted_fact_blocks(fk[s], fv[s], fm[s]) for s in rng]
    sums = [torch.zeros(n_groups + 1, dtype=fv[s].dtype, device=fv[s].device) for s in rng]
    cnts = [torch.zeros(n_groups + 1, dtype=torch.int64, device=fv[s].device) for s in rng]
    chunk = (dk, drow, dm)
    for _step in range(n_dev):
        # the next chunk's transfer first: it does not depend on the range
        # queries below (the reference lets XLA overlap the two)
        nxt = tuple(collectives.ppermute(mesh, a, perm) for a in chunk)
        for s in rng:
            dk_c, drow_c, dm_c = chunk[0][s], chunk[1][s], chunk[2][s]
            sum_d, cnt_d = _range_partials(*tables[s], dk_c, dm_c)
            tgt = torch.where(dm_c, drow_c, n_groups)
            sums[s] = sums[s].index_add(0, tgt, sum_d)
            cnts[s] = cnts[s].index_add(0, tgt, cnt_d)
        chunk = nxt
    return (
        collectives.reduce_sum(mesh, [x[:n_groups] for x in sums]),
        collectives.reduce_sum(mesh, [x[:n_groups] for x in cnts]),
    )


def dist_sort_rows(
    mesh, dkeys, payload_arrays, alive, bucket_capacity: int, rowid=None,
):
    """Distributed ORDER BY over whole rows: sample-sort exchange on the
    FIRST directed key (ties share a value, hence a bucket, so shard i holds
    range bucket i), then one local stable sort per shard over ALL directed
    keys with the global row index as the final tiebreak — the collected
    result is bit-exact with the single-device stable sort, NULL placement
    and tie order included.

    dkeys: directed orderable int64 key arrays (ops/sort._directed_key);
    payload_arrays: every row array to carry (column data + validity);
    alive: live-row mask (dead rows are dropped by the exchange — the sort
    doubles as compaction); rowid: optional logical row-order array, the
    tie-break key when the input's placement is already scrambled
    (ShardedBatch.rowid); defaults to the global position index. Each is a
    sharded array (a list of per-shard tensors).

    Returns (sorted dkeys', payloads', alive', overflow) — overflow > 0
    means a (sender, receiver) bucket exceeded bucket_capacity and the
    caller must retry with a larger capacity or materialize. The overflow
    is read on the host after the program, as the reference reads it."""
    keys_out, pays_out, mask_out, overflow = _sort_rows_stage(
        mesh, dkeys, payload_arrays, alive, bucket_capacity, rowid
    )
    return keys_out, pays_out, mask_out, int(overflow)


@mesh_program
def _sort_rows_stage(mesh, dkeys, payload_arrays, alive, bucket_capacity: int, rowid):
    """dist_sort_rows as one program, its overflow (psum'd) a device
    scalar: the reference's shard_map at sqlrs_tpu/parallel/dist_ops.py:611."""
    n_dev = mesh.size
    sample_per_shard = 64
    nk = len(dkeys)
    big = _MAXK
    if dkeys[0][0].is_floating_point():
        big = float("inf")

    sends, dests, samples = [], [], []
    rng = range(mesh.n_local)
    for s in rng:
        alive_l = alive[s]
        n_local = alive_l.shape[0]
        dev = alive_l.device
        keys_l = [k[s] for k in dkeys]
        if rowid is None:
            rowid_l = (mesh.offset + s) * n_local + torch.arange(
                n_local, dtype=torch.int64, device=dev
            )
        else:
            rowid_l = rowid[s]
        first_l = torch.where(alive_l, keys_l[0], big)
        sorted_first = torch.sort(first_l).values
        stride = max(n_local // sample_per_shard, 1)
        samples.append(sorted_first[::stride][:sample_per_shard])
        sends.append(tuple(keys_l) + (rowid_l,) + tuple(p[s] for p in payload_arrays))
    gathered = collectives.all_gather(mesh, samples)
    for s in rng:
        sample = torch.sort(gathered[s].reshape(-1)).values
        m = sample.shape[0]
        idx = torch.arange(1, n_dev, dtype=torch.int64, device=sample.device) * m // n_dev
        splitters = sample[idx].contiguous()
        dest = torch.searchsorted(splitters, dkeys[0][s].contiguous(), right=True)
        dests.append(torch.where(alive[s], dest, n_dev))

    received, masks, ovfs = _exchange_rows(mesh, sends, dests, bucket_capacity)
    keys_out = [[] for _ in range(nk)]
    pays_out = [[] for _ in payload_arrays]
    mask_out = []
    for s in rng:
        recv, mask = received[s], masks[s]
        keys_r = recv[:nk]
        rowid_r = recv[nk]
        pays_r = recv[nk + 1:]
        # local stable sort: dead rows last, then directed keys, then the
        # global row index (exact single-device tie order)
        sort_ops = [torch.logical_not(mask).to(torch.int32)] + list(keys_r) + [rowid_r]
        perm = _lex_argsort(sort_ops)
        for j in range(nk):
            keys_out[j].append(keys_r[j][perm])
        for j, p in enumerate(pays_r):
            pays_out[j].append(p[perm])
        mask_out.append(mask[perm])
    overflow = collectives.reduce_sum(mesh, ovfs)
    return keys_out, pays_out, mask_out, overflow


# ---- distributed sort --------------------------------------------------------


@mesh_program
def dist_sort(mesh, keys, bucket_capacity: int):
    """Sample sort of per-shard int keys: splitters from an all-gathered
    per-shard sample; rows all_to_all'd to their range owner; a local sort
    per shard. Returns (sorted keys, valid mask) per shard, each
    n_dev * bucket_capacity long — shard i holds range bucket i, valid rows
    first, so the concatenation of valid rows is globally sorted.

    One program: the reference's shard_map at
    sqlrs_tpu/parallel/dist_ops.py:668."""
    n_dev = mesh.size
    sample_per_shard = 64
    samples = []
    for k in keys:
        stride = max(k.shape[0] // sample_per_shard, 1)
        samples.append(torch.sort(k[::stride][:sample_per_shard]).values)
    gathered = collectives.all_gather(mesh, samples)
    sends, dests = [], []
    for s, k in enumerate(keys):
        sample = torch.sort(gathered[s].reshape(-1)).values
        m = sample.shape[0]
        idx = torch.arange(1, n_dev, dtype=torch.int64, device=sample.device) * m // n_dev
        dests.append(torch.searchsorted(sample[idx].contiguous(), k.contiguous(), right=True))
        sends.append((k,))
    received, masks, _ovf = _exchange_rows(mesh, sends, dests, bucket_capacity)
    out_k, out_m = [], []
    for (recv_k,), recv_m in zip(received, masks):
        big = torch.iinfo(recv_k.dtype).max
        out_k.append(torch.sort(torch.where(recv_m, recv_k, big)).values)
        # valid rows first
        out_m.append(torch.sort(torch.logical_not(recv_m).to(torch.int8)).values == 0)
    return out_k, out_m
