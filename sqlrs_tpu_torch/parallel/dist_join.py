"""Shuffle-repartition distributed hash join carrying full row payloads, and
the fused ring / broadcast aggregate-over-join.

The port of sqlrs_tpu/parallel/dist_join.py. When NEITHER side fits
replicated, both sides are repartitioned by key hash so every shard joins
~N/p probe rows against ~B/p build rows. Two phases split at the one host
read (the max match count m, the same two-phase shape as
ops/join.equi_join_pairs):

  phase A ("exchange + rank"):
    1. a combined splitmix hash over all encoded key columns picks each
       row's destination shard; rows with NULL keys or dead rows are
       dropped (inner-join semantics: NULL never matches).
    2. SKEW IS HANDLED HERE, adaptively: a psum'd 4096-bucket key
       histogram marks hot buckets (> hot_factor x mean). Hot PROBE rows
       spread round-robin over all shards; hot BUILD rows are replicated to
       every shard by all_gather (bounded by hot_capacity) instead of being
       exchanged. When no bucket is hot this is the plain shuffle.
    3. every (sender, receiver) bucket overflow is COUNTED and returned
       (never silently dropped); the caller retries with 4x capacities.
    4. received build rows are sorted by global rowid (dead slots last), so
       local position order == single-device insertion order; one merged
       sort (ops/join._pairs_phase_a) then hands every probe row its match
       range [start, start+count) plus the key-rank -> position order.
  host: m = global max match count, the overflow and the hot-bucket count,
    in one read.
  phase B ("expand"): every probe row owns an m-wide strip of match slots;
    build columns gather through the order, probe columns repeat. Output
    logical order is rowid_out = probe_rowid * m + slot — exactly the
    single-device emission sequence (probe-order outer, build insertion
    order inner), so the collected result is bit-exact including row order
    (the ShardedBatch.rowid machinery).

The reference's scan bodies become Python loops over ring steps, each over
the shards; the `_varying` vma alignment of its ring probe (a shard_map
type check) has nothing to port. A sharded array is a list of per-shard
tensors (parallel/dist_ops.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from sqlrs_tpu_torch.ops.fused import prefix_sum
from sqlrs_tpu_torch.ops.hash_table import _mix64, umod
from sqlrs_tpu_torch.ops.join import _pairs_phase_a
from sqlrs_tpu_torch.ops.sort import _lex_argsort
from sqlrs_tpu_torch.parallel import collectives
from sqlrs_tpu_torch.parallel.dist_ops import _bucketize_rows, _exchange_rows

_N_BUCKETS = 4096
_BLK = 128
_MAXK = 2**63 - 1
_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)  # the hash seed as int64


def _ring_probe_ranks(mesh, p_sends, dest_ps, cap: int, l_ops, nk: int):
    """Ring-staged probe exchange: instead of one all_to_all followed by one
    rank pass, each shard's bucketized probe buffers rotate around the ring
    by ppermute, and each step ranks the chunk that just became resident
    (the row destined to this shard) against the local build side. Chunks
    land at the same sender-major offsets the all_to_all layout uses, and a
    probe row's ranks depend only on the build side, so every output is
    BIT-IDENTICAL to the monolithic path. Returns per shard (received probe
    arrays, mask, starts, counts, order) and the local overflow counts."""
    n_dev = mesh.size
    parts = [_bucketize_rows(a, d, n_dev, cap) for a, d in zip(p_sends, dest_ps)]
    bufs = [p[0] for p in parts]
    mbufs = [p[1] for p in parts]
    n_recv = n_dev * cap
    perm = collectives.ring_perm(n_dev)
    rng = range(mesh.n_local)
    outs, msk, sts, cts, orders = [], [], [], [], [None] * mesh.n_local
    for s in rng:
        dev = mbufs[s].device
        outs.append([torch.zeros(n_recv, dtype=b.dtype, device=dev) for b in bufs[s]])
        msk.append(torch.zeros(n_recv, dtype=torch.bool, device=dev))
        sts.append(torch.zeros(n_recv, dtype=torch.int64, device=dev))
        cts.append(torch.zeros(n_recv, dtype=torch.int64, device=dev))
    for step in range(n_dev):
        # the next hop first: it does not depend on the rank compute below
        bufs_n = [
            collectives.ppermute(mesh, [b[k] for b in bufs], perm)
            for k in range(len(bufs[0]))
        ]
        mbufs_n = collectives.ppermute(mesh, mbufs, perm)
        for i in rng:
            # the resident buffer belongs to shard (g - step); my chunk is row g
            g = mesh.offset + i
            chunk = [b[g] for b in bufs[i]]
            cm = mbufs[i][g]
            r_ops = []
            for j in range(nk):
                r_ops += [cm.to(torch.int32), chunk[j]]
            st_c, ct_c, order, _tot = _pairs_phase_a(l_ops[i], tuple(r_ops), 2 * nk)
            off = ((g - step) % n_dev) * cap
            for o, c in zip(outs[i], chunk):
                o[off:off + cap] = c
            msk[i][off:off + cap] = cm
            sts[i][off:off + cap] = st_c
            cts[i][off:off + cap] = ct_c
            orders[i] = order
        bufs = [[bufs_n[k][s] for k in range(len(bufs_n))] for s in rng]
        mbufs = mbufs_n
    return outs, msk, sts, cts, orders, [p[2] for p in parts]


@dataclass
class ShuffleJoinPhaseA:
    """Host-visible result of phase A (arrays stay on their shards)."""

    build_arrays: tuple  # key encs, payloads, rowid — rowid-sorted per shard
    build_mask: list
    probe_arrays: tuple  # key encs, payloads, rowid — exchange order
    probe_mask: list
    starts: list
    counts: list
    order: list
    overflow: int
    n_hot_buckets: int
    m: int  # global max matches per probe row


def _combined_hash(key_pairs):
    """One well-mixed 64-bit hash (int64 bits) per row over all encoded key
    columns. key_pairs entries are (encoded_key, valid): the hash consumes
    the encoded key. A float key enters by its value truncated to int64 —
    equal keys hash equally, which is all the placement needs."""
    enc0 = key_pairs[0][0]
    h = torch.full(enc0.shape, _GOLDEN, dtype=torch.int64, device=enc0.device)
    for enc, _valid in key_pairs:
        h = _mix64(h ^ _mix64(enc.to(torch.int64)))
    return h


def shuffle_join_phase_a(
    mesh,
    b_keys,  # [(enc sharded array, valid sharded array)] per join key, build side
    b_payload,  # sharded arrays to carry (col data + validity as int32)
    b_rowid,
    b_alive,
    p_keys,
    p_payload,
    p_rowid,
    p_alive,
    *,
    bucket_b: int,
    bucket_p: int,
    hot_capacity: int,
    hot_factor: float = 4.0,
    hot_min: int | None = None,
    ring: bool = False,
):
    # a bucket is hot only when it is BOTH far above the mean and big enough
    # to threaten a (sender, receiver) bucket: tiny inputs otherwise mark
    # noise buckets hot and pay replication for nothing
    if hot_min is None:
        hot_min = bucket_p
    n_dev = mesh.size
    nk = len(b_keys)
    rng = range(mesh.n_local)

    # ---- stage 1: hashes and the psum'd histogram of probe keys -------------
    loc = []
    hists = []
    for s in rng:
        bk = [(e[s], v[s]) for e, v in b_keys]
        pk = [(e[s], v[s]) for e, v in p_keys]
        bvalid = b_alive[s]
        for _e, v in bk:
            bvalid = bvalid & v
        pvalid = p_alive[s]
        for _e, v in pk:
            pvalid = pvalid & v
        hb = _combined_hash(bk)
        hp = _combined_hash(pk)
        bucket_p_id = hp & (_N_BUCKETS - 1)
        hist = torch.zeros(_N_BUCKETS, dtype=torch.int64, device=hp.device).index_add_(
            0, torch.where(pvalid, bucket_p_id, 0), pvalid.to(torch.int64)
        )
        hists.append(hist)
        loc.append((bk, pk, bvalid, pvalid, hb, hp, bucket_p_id))
    hists = collectives.psum(mesh, hists)

    # ---- stage 2: destinations, the hot build subset ---------------------------
    p_sends, dest_ps, b_sends, dest_bs, hot_rows, n_hots, ovf_hots = [], [], [], [], [], [], []
    for s in rng:
        bk, pk, bvalid, pvalid, hb, hp, bucket_p_id = loc[s]
        hist = hists[s]
        total = hist.sum()
        thresh = torch.clamp(hot_factor * total.to(torch.float64) / _N_BUCKETS, min=float(hot_min))
        hot = hist.to(torch.float64) > thresh
        n_hots.append(hot.to(torch.int64).sum())
        # probe rows: hot rows salted round-robin
        n_local = pvalid.shape[0]
        base_p = umod(hp, n_dev)
        salt = (
            torch.arange(n_local, dtype=torch.int64, device=hp.device) + mesh.offset + s
        ) % n_dev
        dest_p = torch.where(hot[bucket_p_id], salt, base_p)
        dest_ps.append(torch.where(pvalid, dest_p, n_dev))
        p_sends.append(
            tuple(e for e, _ in pk) + tuple(p[s] for p in p_payload) + (p_rowid[s],)
        )
        # build rows: cold rows shuffle, hot rows replicate
        b_hot = hot[hb & (_N_BUCKETS - 1)] & bvalid
        dest_bs.append(torch.where(bvalid & torch.logical_not(b_hot), umod(hb, n_dev), n_dev))
        b_send = tuple(e for e, _ in bk) + tuple(p[s] for p in b_payload) + (b_rowid[s],)
        b_sends.append(b_send)
        ovf_hots.append(torch.clamp(b_hot.to(torch.int64).sum() - hot_capacity, min=0))
        hot_order = torch.argsort(torch.logical_not(b_hot).to(torch.int8), stable=True)
        hot_order = hot_order[:hot_capacity]
        hot_rows.append(tuple(a[hot_order] for a in b_send) + (b_hot[hot_order],))
    if not ring:
        p_recv, pm, ovf_p = _exchange_rows(mesh, p_sends, dest_ps, bucket_p)
    b_cold, bm_cold, ovf_b = _exchange_rows(mesh, b_sends, dest_bs, bucket_b)
    hot_g = [
        collectives.all_gather(mesh, [h[k] for h in hot_rows])
        for k in range(len(hot_rows[0]))
    ]

    # ---- stage 3: sort build by rowid (dead slots last): local position order
    # becomes the single-device insertion order; then per-probe match ranges
    b_sorted_all, brow_all_s, bm_all_s, l_ops_all = [], [], [], []
    for s in rng:
        b_all = [
            torch.cat([c, g[s].reshape(-1)]) for c, g in zip(b_cold[s], hot_g[:-1])
        ]
        bm_all = torch.cat([bm_cold[s], hot_g[-1][s].reshape(-1)])
        perm = _lex_argsort([torch.logical_not(bm_all).to(torch.int32), b_all[-1]])
        b_sorted = [a[perm] for a in b_all[:-1]]
        bm_s = bm_all[perm]
        b_sorted_all.append(b_sorted)
        brow_all_s.append(b_all[-1][perm])
        bm_all_s.append(bm_s)
        l_ops = []
        for j in range(nk):
            l_ops += [bm_s.to(torch.int32), b_sorted[j]]
        l_ops_all.append(tuple(l_ops))
    if ring:
        # ring-staged probe exchange: outputs bit-identical to the
        # monolithic all_to_all + single rank pass
        p_recv, pm, starts, counts, orders, ovf_p = _ring_probe_ranks(
            mesh, p_sends, dest_ps, bucket_p, l_ops_all, nk
        )
    else:
        starts, counts, orders = [], [], []
        for s in rng:
            r_ops = []
            for j in range(nk):
                r_ops += [pm[s].to(torch.int32), p_recv[s][j]]
            st, ct, order, _tot = _pairs_phase_a(l_ops_all[s], tuple(r_ops), 2 * nk)
            starts.append(st)
            counts.append(ct)
            orders.append(order)

    # one host read: overflow (psum), hot buckets (replicated), m (pmax)
    overflow = collectives.reduce_sum(
        mesh, [ovf_p[s] + ovf_b[s] + ovf_hots[s] for s in rng]
    )
    m_glob = collectives.reduce_max(mesh, [c.max() for c in counts])
    overflow, n_hot, m = torch.stack(
        [overflow, n_hots[0].to(overflow.device), m_glob]
    ).tolist()
    n_b = len(b_sorted_all[0])
    n_p = len(p_recv[0])
    return ShuffleJoinPhaseA(
        build_arrays=tuple([b_sorted_all[s][k] for s in rng] for k in range(n_b))
        + ([brow_all_s[s] for s in rng],),
        build_mask=bm_all_s,
        probe_arrays=tuple([p_recv[s][k] for s in rng] for k in range(n_p)),
        probe_mask=list(pm),
        starts=starts,
        counts=counts,
        order=orders,
        overflow=int(overflow),
        n_hot_buckets=int(n_hot),
        m=int(m),
    )


def shuffle_join_phase_b(mesh, a: ShuffleJoinPhaseA, n_keys: int, n_b_payload: int):
    """Expand match ranges into m-wide probe strips. Returns (build payload
    cells, probe payload cells, probe rowid cells, alive cells) — sharded,
    local_probe_rows * m per shard.

    rowid_out = probe_rowid * m + slot reproduces the single-device pair
    emission sequence exactly (see module docstring)."""
    m = max(a.m, 1)
    b_pay = a.build_arrays[n_keys:n_keys + n_b_payload]
    p_pay = a.probe_arrays[n_keys:-1]
    p_rowid = a.probe_arrays[-1]
    b_cells = [[] for _ in b_pay]
    p_cells = [[] for _ in p_pay]
    rowid_out, alive = [], []
    for s in range(mesh.n_local):
        starts, counts, order = a.starts[s], a.counts[s], a.order[s]
        nb_local = order.shape[0]
        j = torch.arange(m, dtype=torch.int64, device=starts.device)
        cand_pos = starts[:, None] + j[None, :]
        cand = order[torch.clamp(cand_pos, 0, max(nb_local - 1, 0))]
        have = j[None, :] < counts[:, None]
        for k, arr in enumerate(b_pay):
            b_cells[k].append(arr[s][cand].reshape(-1))
        for k, arr in enumerate(p_pay):
            p_cells[k].append(torch.repeat_interleave(arr[s], m))
        rowid_out.append((p_rowid[s][:, None] * m + j[None, :]).reshape(-1))
        alive.append(have.reshape(-1))
    return b_cells, p_cells, rowid_out, alive


# ---- fused ring aggregate-over-join -----------------------------------------


def _blockify(arr, fill):
    """Pad to a multiple of 128 and reshape to (n_blocks, 128)."""
    pad = (-arr.shape[0]) % _BLK
    if pad:
        arr = torch.cat([arr, torch.full((pad,), fill, dtype=arr.dtype, device=arr.device)])
    return arr.view(-1, _BLK)


def _fact_tables(f_enc, f_ok, f_rowid, scols, mmflat):
    """One shard's probe tables: the fact rows sorted by (key, rowid) with
    every sum column's block prefix table, and one (key, mm_key) sort per
    min/max column."""
    key = torch.where(f_ok, f_enc, _MAXK)
    perm = _lex_argsort([key, f_rowid])
    ks, rid_s = key[perm], f_rowid[perm]
    k2d = _blockify(ks, _MAXK)
    sum_tables = []
    for sv in scols:
        v2d = _blockify(sv[perm], 0)
        bs = v2d.sum(1, dtype=sv.dtype)
        bp = torch.cat([prefix_sum(bs) - bs, bs.sum().reshape(1)])
        sum_tables.append((v2d, bp))
    mm_sorted = []
    for j in range(len(mmflat) // 2):
        mk, raw = mmflat[2 * j], mmflat[2 * j + 1]
        p2 = _lex_argsort([key, mk])
        mm_sorted.append((mk[p2], raw[p2]))
    return k2d, rid_s, sum_tables, mm_sorted


def _range_answers(k2d, n_local: int, rid_s, sum_tables, mm_sorted, d_enc, d_ok):
    """Per dim row: (count, min fact rowid, range sums, (mm_key, raw) at the
    range start) against one shard's probe tables, answered _QUERY_CHUNK dim
    rows at a time (each answer depends on its own row only)."""
    from sqlrs_tpu_torch.ops import pipelines
    from sqlrs_tpu_torch.parallel.dist_ops import _QUERY_CHUNK, _prefix_at

    if d_enc.shape[0] > _QUERY_CHUNK:
        parts = [
            _range_answers(k2d, n_local, rid_s, sum_tables, mm_sorted,
                           d_enc[i:i + _QUERY_CHUNK], d_ok[i:i + _QUERY_CHUNK])
            for i in range(0, d_enc.shape[0], _QUERY_CHUNK)
        ]
        return (
            torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]),
            [torch.cat([p[2][k] for p in parts]) for k in range(len(sum_tables))],
            [(torch.cat([p[3][k][0] for p in parts]), torch.cat([p[3][k][1] for p in parts]))
             for k in range(len(mm_sorted))],
        )

    dlo = torch.where(d_ok, d_enc, _MAXK)
    dhi = torch.where(d_ok, d_enc + 1, _MAXK)
    g = dlo.shape[0]
    ranks = pipelines._sorted_ranks_left(k2d, torch.cat([dlo, dhi]))
    lo, hi = ranks[:g], ranks[g:]
    cnt = hi - lo
    lo_c = torch.clamp(lo, 0, max(n_local - 1, 0))
    rid = torch.where(cnt > 0, rid_s[lo_c], _MAXK)
    sums = [_prefix_at(v2d, bp, hi) - _prefix_at(v2d, bp, lo) for v2d, bp in sum_tables]
    mms = [(mk_s[lo_c], raw_s[lo_c]) for mk_s, raw_s in mm_sorted]
    return cnt, rid, sums, mms


def _combine(mesh, cnt, rid, sums, mms):
    """Cross-shard combine of per-dim-row partials, each shard keeping its
    own chunk: psum of counts and sums, pmin of the first rowid, and per
    min/max the raw value of the first shard holding the global min key."""
    n_dev = mesh.size
    shards = mesh.local_shards  # (global index, device) of each local shard
    cnt_g = collectives.psum_scatter(mesh, cnt)
    rid_g = collectives.psum_scatter(mesh, rid, "min")
    sums_g = [collectives.psum_scatter(mesh, [x[k] for x in sums])
              for k in range(len(sums[0]))]
    mm_g = []
    for k in range(len(mms[0])):
        kk = [x[k][0] for x in mms]
        ra = [x[k][1] for x in mms]
        gmin = collectives.pmin(mesh, kk)
        mine = [k == m for k, m in zip(kk, gmin)]
        shard_sel = collectives.pmin(
            mesh, [torch.where(mine[s], g, n_dev) for s, (g, _d) in enumerate(shards)]
        )
        raw_g = collectives.psum_scatter(mesh, [
            torch.where(mine[s] & (shard_sel[s] == g), ra[s], torch.zeros_like(ra[s]))
            for s, (g, _d) in enumerate(shards)
        ])
        chunk = gmin[0].shape[0] // n_dev
        own_min = [gmin[s][g * chunk:(g + 1) * chunk] for s, (g, _d) in enumerate(shards)]
        mm_g.append((raw_g, own_min))
    return cnt_g, sums_g, rid_g, mm_g


def ring_agg_join(mesh, f_enc, f_ok, f_rowid, sum_cols, mm_specs, d_enc, d_ok):
    """Fused ring join + per-dim-row aggregation, the SQL-reachable form of
    dist_join_groupby_ring: no host syncs, no exchange and hence no
    overflow/retry. Fact rows never move; the dim chunks rotate around the
    ring by ppermute, and each shard answers the resident chunk's per-key
    range queries against its locally sorted fact rows.

    Arguments are sharded arrays: f_enc (int64 encoded fact join key),
    f_ok (fact row participates), f_rowid (global fact row position),
    sum_cols (arrays to range-sum, invalid rows pre-masked to 0), mm_specs
    ((mm_key int64 directed and invalid-masked to INT64_MAX, raw) pairs),
    d_enc and d_ok (dim side). Per dim row (aligned with the dim side's
    layout) returns:
      counts    int64: matching fact rows (count(*) partial)
      sums      one sharded array per sum_cols entry: range sums
      min_rowid int64: minimum fact rowid among matches (INT64_MAX when
                none) — the first-appearance order seed
      mm_outs   one (raw, mm_key) pair per mm_specs entry: the raw value
                whose directed key is minimal in the row's match range."""
    n_dev = mesh.size
    n_mm = len(mm_specs)
    chunk = d_enc[0].shape[0]
    d_cap = chunk * n_dev
    perm = collectives.ring_perm(n_dev)
    rng = range(mesh.n_local)
    tables, accs = [], []
    for s in rng:
        dev = f_enc[s].device
        scols = [c[s] for c in sum_cols]
        mmflat = [a[s] for pair in mm_specs for a in pair]
        tables.append(_fact_tables(f_enc[s], f_ok[s], f_rowid[s], scols, mmflat))
        accs.append((
            torch.zeros(d_cap + 1, dtype=torch.int64, device=dev),
            torch.full((d_cap + 1,), _MAXK, dtype=torch.int64, device=dev),
            [torch.zeros(d_cap + 1, dtype=c.dtype, device=dev) for c in scols],
            [(torch.full((d_cap + 1,), _MAXK, dtype=torch.int64, device=dev),
              torch.zeros(d_cap + 1, dtype=mmflat[2 * j + 1].dtype, device=dev))
             for j in range(n_mm)],
        ))
    d_pos = [
        g * chunk + torch.arange(chunk, dtype=torch.int64, device=dev)
        for g, dev in mesh.local_shards
    ]
    held = (list(d_enc), d_pos, list(d_ok))
    for _step in range(n_dev):
        # the next chunk's transfer first: it does not depend on the range
        # queries below (the reference lets XLA overlap the two)
        nxt = tuple(collectives.ppermute(mesh, a, perm) for a in held)
        for s in rng:
            d_enc_c, d_pos_c, d_ok_c = held[0][s], held[1][s], held[2][s]
            k2d, rid_s, sum_tables, mm_sorted = tables[s]
            cnt, rid, sums, mms = _range_answers(
                k2d, f_enc[s].shape[0], rid_s, sum_tables, mm_sorted, d_enc_c, d_ok_c
            )
            # each dim position is resident exactly once per shard, so the
            # writes below hit disjoint targets across the steps
            tgt = torch.where(d_ok_c, d_pos_c, d_cap)
            cnt_a, rid_a, sum_as, mm_as = accs[s]
            cnt_a.index_add_(0, tgt, cnt)
            rid_a.scatter_reduce_(0, tgt, rid, "amin")
            for a, x in zip(sum_as, sums):
                a.index_add_(0, tgt, x)
            tgt_hit = torch.where(d_ok_c & (cnt > 0), d_pos_c, d_cap)
            for (ka, ra), (mk, raw) in zip(mm_as, mms):
                ka[tgt_hit] = mk
                ra[tgt_hit] = raw
        held = nxt
    return _combine(
        mesh,
        [a[0][:d_cap] for a in accs],
        [a[1][:d_cap] for a in accs],
        [[x[:d_cap] for x in a[2]] for a in accs],
        [[(k[:d_cap], r[:d_cap]) for k, r in a[3]] for a in accs],
    )


def broadcast_agg_join(mesh, f_enc, f_ok, f_rowid, sum_cols, mm_specs, d_enc, d_ok):
    """Broadcast sibling of ring_agg_join for SMALL dim sides: each shard
    answers the FULL dim side's range queries, replicated by ONE tiled
    all_gather (O(G) bytes), against its locally sorted fact rows, and the
    per-dim-row partials combine with one psum/pmin. Two collectives
    instead of n_dev ppermute steps — the right trade when the dim side
    fits in every shard. Same argument and return contract as
    ring_agg_join."""
    d_enc_g = collectives.all_gather(mesh, list(d_enc), tiled=True)
    d_ok_g = collectives.all_gather(mesh, list(d_ok), tiled=True)
    cnts, rids, sums, mms = [], [], [], []
    for s in range(mesh.n_local):
        scols = [c[s] for c in sum_cols]
        mmflat = [a[s] for pair in mm_specs for a in pair]
        k2d, rid_s, sum_tables, mm_sorted = _fact_tables(
            f_enc[s], f_ok[s], f_rowid[s], scols, mmflat
        )
        cnt, rid, sm, mm = _range_answers(
            k2d, f_enc[s].shape[0], rid_s, sum_tables, mm_sorted, d_enc_g[s], d_ok_g[s]
        )
        cnts.append(cnt)
        rids.append(rid)
        sums.append(sm)
        mms.append([(torch.where(cnt > 0, k, _MAXK), r) for k, r in mm])
    return _combine(mesh, cnts, rids, sums, mms)


def pair_local_dedup(mesh, keys, vals, ok):
    """Shard-local sorted-unique over (key, value) pairs: sort the pairs
    and flag first occurrences. The building block of the cross-shard
    DISTINCT path: dedup locally, exchange by key hash
    (partition_shuffle), dedup again — every surviving (key, value) pair
    is then globally unique and lives on exactly one shard."""
    out_k, out_v, out_keep = [], [], []
    for k, v, o in zip(keys, vals, ok):
        kk = torch.where(o, k, _MAXK)
        perm = _lex_argsort([kk, v])
        sk, sv = kk[perm], v[perm]
        first = torch.ones(sk.shape[0], dtype=torch.bool, device=sk.device)
        first[1:] = (sk[1:] != sk[:-1]) | (sv[1:] != sv[:-1])
        out_k.append(sk)
        out_v.append(sv)
        out_keep.append(first & (sk != _MAXK))
    return out_k, out_v, out_keep
