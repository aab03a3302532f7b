"""Sorted-run grouped aggregation: the general GROUP BY.

The port of sqlrs_tpu/ops/grouped_agg.py (`sorted_grouped_aggregate` and
its two phases). It handles arbitrary key columns (any logical type, NULL
keys group together), multiple aggregates, and the reference's
first-appearance group output order (reference
src/executor/aggregate/hash_agg.rs:85-111):

  one lexicographic sort over (dead flag, key encodings, validity flags)
  with the row index as the last key → run boundaries by adjacent diff →
  per-run sum/count as prefix differences at run ends → per-run min/max →
  all remaining work at R = #groups size.

The reference's variadic `lax.sort(ops, num_keys=k + 1)` becomes stable
`torch.argsort` passes, least significant key first (ops/sort.py
`_lex_argsort`): stability stands for the row-index key, so the
permutation is the same, and each payload is gathered by it once. Small
keys (VARCHAR ranks, BOOLEANs) pack into shared int64 operands as
`_plan_key_layout` lays them out, which also cuts the number of passes.

Each jitted phase of the reference is a program here (utils/programs.py:
one captured CUDA graph a signature on the card), with the reference's
static arguments in the key; the one host sync between them is the run
count, as there. Prefix sums go through
ops/fused.prefix_sum, whose float association order is the same on every
run (a 1-D float cumsum on CUDA is not).
"""

from __future__ import annotations

import numpy as np
import torch

from sqlrs_tpu_torch.data import Column
from sqlrs_tpu_torch.data.batch import torch_dtype_for, ubigint_key
from sqlrs_tpu_torch.errors import ExecutorError
from sqlrs_tpu_torch.ops.elementwise import convert_numeric
from sqlrs_tpu_torch.ops.fused import prefix_sum
from sqlrs_tpu_torch.ops.hash_table import next_pow2
from sqlrs_tpu_torch.ops.sort import _encode, _lex_argsort, key_kind
from sqlrs_tpu_torch.types import LogicalType, numpy_dtype_for
from sqlrs_tpu_torch.utils.programs import program

_BLK = 128
_INT32_MAX = 2**31 - 1
_INT64_MAX = 2**63 - 1


def sorted_grouped_aggregate(
    key_cols: list[Column],
    agg_specs: list[tuple],
    alive=None,
):
    """agg_specs: (function_name, input column or None for count(*),
    result logical type[, distinct]). Returns (group_cols, agg_cols,
    n_groups) with groups in first-appearance order.

    DISTINCT aggregates ride the same two phases: the (single, shared)
    distinct argument column becomes an extra value sort key after the
    group keys, and phase 2 counts/sums contributions only at (group,
    value) pair boundaries. Multiple distinct aggs must share one argument
    column (raises ValueError otherwise — callers take the legacy dedup
    path).

    `alive` (optional bool tensor, or the raw (keep_data, keep_valid) pair)
    excludes rows without compacting first — the fused Filter→GROUP BY
    path: dead rows ride a leading dead-flag sort key to the end, never
    open runs, and are masked out of every aggregate."""
    n = len(key_cols[0])
    dev = key_cols[0].data.device
    if n == 0:
        return (
            [
                Column.from_numpy(c.type, np.zeros(0, numpy_dtype_for(c.type)), device=dev)
                for c in key_cols
            ],
            [
                Column.from_numpy(s[2], np.zeros(0, numpy_dtype_for(s[2])), device=dev)
                for s in agg_specs
            ],
            0,
        )

    # ---- layout planning (host-static) ------------------------------------
    # SMALL keys (VARCHAR lex ranks and BOOLEANs — their bit widths are
    # host-known) pack, WITH their validity bits, into shared int64
    # composite sort operands: one sort pass each instead of two per key.
    from sqlrs_tpu_torch.data.strings import GLOBAL_STRINGS

    rank_bits = max(len(GLOBAL_STRINGS).bit_length(), 1)
    has_alive = alive is not None
    key_layout, num_keys = _plan_key_layout(
        [c.type for c in key_cols], rank_bits, has_alive
    )

    # each DISTINCT aggregate input column rides the sort once, shared by
    # every aggregate over it; VARCHAR columns used by any min/max ride as
    # ONE packed (rank << 32 | code) operand
    specs4 = [
        (s[0], s[1], s[2], bool(s[3]) if len(s) > 3 else False)
        for s in agg_specs
    ]
    slot_of: dict[int, int] = {}
    slot_cols: list = []
    slot_packed: list = []
    agg_slots: list = []
    distinct_slot = -1
    for name, col, _, distinct in specs4:
        if col is None:
            agg_slots.append(None)
            continue
        ident = id(col)
        if ident not in slot_of:
            slot_of[ident] = len(slot_cols)
            slot_cols.append(col)
            slot_packed.append(False)
        agg_slots.append(slot_of[ident])
        if col.type == LogicalType.VARCHAR and name in ("min", "max"):
            slot_packed[slot_of[ident]] = True
        if distinct and name in ("sum", "avg", "count"):
            if distinct_slot not in (-1, slot_of[ident]):
                raise ValueError(
                    "sorted path supports one shared DISTINCT argument"
                )
            distinct_slot = slot_of[ident]

    spec = (
        tuple(
            (c.type,) + tuple(lay) for c, lay in zip(key_cols, key_layout)
        ),
        tuple(
            (name, col.type if col is not None else None, rt, slot,
             distinct and name in ("sum", "avg", "count"))
            for (name, col, rt, distinct), slot in zip(specs4, agg_slots)
        ),
        len(slot_cols),
        has_alive,
    )

    rank = None
    needs_rank = any(c.type == LogicalType.VARCHAR for c in key_cols) or any(
        c.type == LogicalType.VARCHAR and p
        for c, p in zip(slot_cols, slot_packed)
    ) or (distinct_slot >= 0 and slot_cols[distinct_slot].type == LogicalType.VARCHAR)
    if needs_rank:
        # the dictionary's rank table on this device (cached there)
        r = GLOBAL_STRINGS.ranks_device(dev)
        rank = r if r.shape[0] > 0 else None

    dkind = (
        key_kind(slot_cols[distinct_slot].type) if distinct_slot >= 0 else ""
    )
    out, new_run, new_pair, rid, n_runs = _agg_phase1(
        tuple(c.data for c in key_cols),
        tuple(c.valid for c in key_cols),
        rank,
        tuple(c.data for c in slot_cols),
        tuple(c.valid for c in slot_cols),
        alive,
        tuple(key_kind(c.type) for c in key_cols),
        tuple(key_layout),
        tuple(slot_packed),
        rank_bits,
        distinct_slot,
        dkind,
    )
    n_groups = int(n_runs)  # pipeline-breaker sync
    r_cap = next_pow2(max(n_groups, 8))

    if distinct_slot >= 0:
        num_keys += 2  # the (valid, value) distinct sort-operand pair
    gdata, gvalid, adata, avalid = _agg_phase2(
        out, new_run, new_pair, rid, n_runs, num_keys, spec, r_cap
    )

    group_cols = [
        Column(c.type, d[:n_groups], v[:n_groups])
        for c, d, v in zip(key_cols, gdata, gvalid)
    ]
    agg_cols = [
        Column(s[2], d[:n_groups], v[:n_groups])
        for s, d, v in zip(specs4, adata, avalid)
    ]
    return group_cols, agg_cols, n_groups


def _plan_key_layout(key_types, rank_bits: int, has_alive: bool):
    """Host-static sort-operand layout: per key ("small", op_i, shift, bits)
    for bit-packed composite members or ("plain", op_i, 0, 0) for dedicated
    (valid, key) operand pairs. op_i is the absolute sort-operand index
    (operand 0 is the dead flag when has_alive)."""
    layout: list = []
    n_ops = 1 if has_alive else 0
    acc_bits = None  # bits used in the currently-open composite
    for t in key_types:
        if t == LogicalType.VARCHAR:
            bits = rank_bits
        elif t == LogicalType.BOOLEAN:
            bits = 1
        else:
            bits = None
        if bits is None or bits + 1 > 62:
            if acc_bits is not None:
                n_ops += 1
                acc_bits = None
            layout.append(("plain", n_ops, 0, 0))
            n_ops += 2
            continue
        if acc_bits is not None and acc_bits + bits + 1 <= 62:
            for i, lay in enumerate(layout):
                if lay[0] == "small" and lay[1] == n_ops:
                    layout[i] = ("small", lay[1], lay[2] + bits + 1, lay[3])
            acc_bits += bits + 1
        else:
            if acc_bits is not None:
                n_ops += 1
            acc_bits = bits + 1
        layout.append(("small", n_ops, 0, bits))
    if acc_bits is not None:
        n_ops += 1
    return layout, n_ops


@program
def _agg_phase1(
    kdatas,
    kvalids,
    rank,
    sdatas,
    svalids,
    alive,
    kinds,
    layout,
    slot_packed,
    rank_bits: int,
    distinct_slot: int = -1,
    dkind: str = "",
):
    """Operand assembly (key encoding, composite bit-packing, payload
    building) + the lexicographic sort + run-boundary detection. Returns
    the sorted operands in the layout _agg_phase2 expects (sort keys, then
    payloads: row index, [alive], VARCHAR key codes, slot (data, valid)
    pairs), the run-start mask, run ids, and the run count (device
    scalar). With alive, a leading dead-flag key sends masked rows to the
    end and they never open runs."""
    n = kdatas[0].shape[0] if kdatas else sdatas[0].shape[0]
    dev = kdatas[0].device if kdatas else sdatas[0].device
    has_alive = alive is not None
    if isinstance(alive, tuple):  # raw (keep_data, keep_valid) pair
        alive = torch.logical_and(alive[0], alive[1])
    sort_keys: list = []
    if has_alive:
        sort_keys.append(torch.logical_not(alive).to(torch.int32))
    acc = None  # open composite value (bit budget tracked by `layout`)
    for data, valid, kind, lay in zip(kdatas, kvalids, kinds, layout):
        key = _encode(kind, data, rank)
        tag, op_i, shift, bits = lay
        if tag == "plain":
            if acc is not None:
                sort_keys.append(acc)
                acc = None
            sort_keys.append(valid.to(torch.int32))
            sort_keys.append(torch.where(valid, key, torch.zeros_like(key)))
            continue
        unit = (valid.to(torch.int64) << bits) | torch.where(
            valid, key.to(torch.int64), 0
        )
        if acc is not None and op_i == len(sort_keys):
            acc = (acc << (bits + 1)) | unit
        else:
            if acc is not None:
                sort_keys.append(acc)
            acc = unit
    if acc is not None:
        sort_keys.append(acc)
    num_keys = len(sort_keys)

    # the row index is the LEAST-SIGNIFICANT sort key (here: the sort's
    # stability), so each run's first sorted row is its first-appearance
    # representative; it rides as the first payload
    payloads: list = []
    if has_alive:
        payloads.append(alive.to(torch.int32))
    for data, kind in zip(kdatas, kinds):
        # non-VARCHAR key values are reconstructed from the sort key fields
        # themselves (the orderable encoding is invertible); only
        # dictionary codes need a dedicated payload
        if kind == "varchar":
            payloads.append(data)
    for data, valid, packed in zip(sdatas, svalids, slot_packed):
        if packed:
            rk = _encode("varchar", data, rank)
            code_u = data.to(torch.int64) & 0xFFFFFFFF
            payloads.append((rk.to(torch.int64) << 32) | code_u)
        else:
            payloads.append(_sortable(data))
        payloads.append(valid.to(torch.int32))

    n_group_ops = num_keys  # operands defining GROUP boundaries
    if distinct_slot >= 0:
        # the distinct argument rides as an extra (valid, value) sort-key
        # pair AFTER the group keys: equal values cluster within each run,
        # so phase 2 can count/sum at pair boundaries. Group boundaries
        # still come from the key fields alone.
        dd, dv = sdatas[distinct_slot], svalids[distinct_slot]
        denc = _encode(dkind, dd, rank)
        sort_keys.append(dv.to(torch.int32))
        sort_keys.append(torch.where(dv, denc, torch.zeros_like(denc)))
        num_keys = len(sort_keys)

    perm = _lex_argsort(sort_keys)
    out = [k[perm] for k in sort_keys] + [perm] + [p[perm] for p in payloads]
    new_run = torch.zeros(n, dtype=torch.bool, device=dev)
    new_run[:1].fill_(True)
    lo = 1 if has_alive else 0  # skip the dead flag for boundary detection
    for arr in out[lo:n_group_ops]:
        new_run[1:] |= arr[1:] != arr[:-1]
    new_pair = new_run
    if distinct_slot >= 0:
        new_pair = new_run.clone()
        for arr in out[n_group_ops:num_keys]:
            new_pair[1:] |= arr[1:] != arr[:-1]
    if has_alive:
        alive_s = out[num_keys + 1] > 0  # payloads: [rowidx, alive, ...]
        new_run = new_run & alive_s
        new_pair = new_pair & alive_s
    rid = torch.cumsum(new_run.to(torch.int32), 0, dtype=torch.int32) - 1
    if has_alive:
        # Dead rows sort to the tail but would otherwise inherit the LAST
        # live run's rid, making phase 2's ends/last for that run point at
        # a dead row: mask them out of every run
        rid = torch.where(alive_s, rid, _INT32_MAX)
    n_runs = new_run.sum(dtype=torch.int64)
    return out, new_run, new_pair, rid, n_runs


@program
def _agg_phase2(
    out, new_run, new_pair, rid, n_runs, num_keys: int, spec, r_cap: int
):
    """Per-run reduction + first-appearance placement at static capacity
    r_cap (outputs are r_cap-sized; the caller slices to n_groups).

    Run ends come from the merge-rank trick (ops/pipelines._sorted_ranks_left:
    a small merge sort of block minima and queries plus one 128-wide row
    scan per query), and per-run sums are prefix differences with prefixes
    computed only at the 2R query positions (one block-reduce pass). Every
    out-of-range position is clamped, and every scatter to a run id has a
    sentinel slot r_cap, exactly where the reference's clamping gather and
    dropped scatter decide the result."""
    from sqlrs_tpu_torch.ops.pipelines import _sorted_ranks_left

    key_types, agg_items, n_slots, has_alive = spec
    s_payloads = list(out[num_keys:])
    alive_s = (s_payloads[1] > 0) if has_alive else None
    n = out[0].shape[0]
    dev = out[0].device
    pad_n = (-n) % _BLK
    # DENSE mode: when the group count approaches the row count (Q18's 1.5M
    # orderkey groups over 6M rows), the per-run block machinery gathers
    # ~3×128 elements PER RUN; a full-N cumsum + one N-sized scatter is far
    # cheaper. Both n and r_cap are host-known: a host-side choice.
    dense = r_cap * 64 >= n

    def _pad_to_blocks(arr, fill):
        if pad_n == 0:
            return arr
        return torch.cat([arr, torch.full((pad_n,), fill, dtype=arr.dtype, device=dev)])

    r = torch.arange(r_cap, dtype=torch.int32, device=dev)
    rid_p = _pad_to_blocks(rid, _INT32_MAX)
    rid_tgt = torch.where((rid >= 0) & (rid < r_cap), rid.to(torch.int64), r_cap)
    if dense:
        # run end = max row position + 1 scattered by run id
        ends = torch.zeros(r_cap + 1, dtype=torch.int64, device=dev).scatter_reduce_(
            0, rid_tgt, torch.arange(1, n + 1, dtype=torch.int64, device=dev), "amax"
        )[:r_cap]
    else:
        ends = _sorted_ranks_left(rid_p.view(-1, _BLK), r + 1)  # side='right'
    prev_end = torch.cat([torch.zeros(1, dtype=ends.dtype, device=dev), ends[:-1]])
    live = r < n_runs
    last = torch.clamp(ends - 1, 0, n - 1)
    lane = torch.arange(_BLK, dtype=torch.int32, device=dev)

    if dense:

        def run_sum(arr):
            cs = prefix_sum(arr)

            def prefix_at(pos):
                return torch.where(pos > 0, cs[torch.clamp(pos - 1, 0, n - 1)], 0)

            return prefix_at(ends) - prefix_at(prev_end)

        def run_minmax(arr, want_min, sentinel):
            init = torch.full((r_cap + 1,), sentinel, dtype=arr.dtype, device=dev)
            return init.scatter_reduce_(
                0, rid_tgt, arr, "amin" if want_min else "amax"
            )[:r_cap]

    else:

        def run_sum(arr):
            a2 = _pad_to_blocks(arr, 0).view(-1, _BLK)
            nb = a2.shape[0]
            bs = a2.sum(1, dtype=arr.dtype)
            bp = torch.cat([prefix_sum(bs) - bs, bs.sum().reshape(1)])

            def prefix_at(pos):
                b = pos // _BLK
                rem = (pos % _BLK).to(torch.int32)
                rows = a2[torch.clamp(b, 0, nb - 1)]
                part = torch.where(lane[None, :] < rem[:, None], rows, 0).sum(
                    1, dtype=arr.dtype
                )
                return bp[b] + part

            return prefix_at(ends) - prefix_at(prev_end)

        nb_all = (n + pad_n) // _BLK
        rid_blocks_first = rid_p[::_BLK]
        rid_blocks_last = rid_p[_BLK - 1 :: _BLK]
        whole_blk = rid_blocks_first == rid_blocks_last
        e1 = torch.clamp(ends, min=1) - 1
        bs_ = prev_end // _BLK
        rs_ = (prev_end % _BLK).to(torch.int32)
        be_ = e1 // _BLK
        re_ = (e1 % _BLK).to(torch.int32) + 1
        same_blk = bs_ == be_

        def run_minmax(arr, want_min, sentinel):
            """Segmented min/max over the sorted runs: one block-reduce
            pass, an nb-sized scatter of whole-block bests to their run,
            and two gathered boundary rows per run for the partial
            blocks."""
            a2 = _pad_to_blocks(arr, sentinel).view(-1, _BLK)
            bbest = a2.amin(1) if want_min else a2.amax(1)
            tgt = torch.where(
                whole_blk & (rid_blocks_first >= 0) & (rid_blocks_first < r_cap),
                rid_blocks_first.to(torch.int64),
                r_cap,
            )
            init = torch.full((r_cap + 1,), sentinel, dtype=a2.dtype, device=dev)
            best = init.scatter_reduce_(
                0, tgt, bbest, "amin" if want_min else "amax"
            )[:r_cap]
            head_rows = a2[torch.clamp(bs_, 0, nb_all - 1)]
            not_same = torch.logical_not(same_blk)
            hm = (lane[None, :] >= rs_[:, None]) & (
                not_same[:, None] | (lane[None, :] < re_[:, None])
            )
            tail_rows = a2[torch.clamp(be_, 0, nb_all - 1)]
            tm = (lane[None, :] < re_[:, None]) & not_same[:, None]
            stacked = torch.stack([
                best,
                _reduce_rows(torch.where(hm, head_rows, sentinel), want_min),
                _reduce_rows(torch.where(tm, tail_rows, sentinel), want_min),
            ])
            return stacked.amin(0) if want_min else stacked.amax(0)

    # ---- first-appearance order -------------------------------------------
    # the row index was the least-significant sort key, so the row at each
    # run START is the run's first-appearance representative — UNLESS a
    # distinct value key sits between the group keys and the row index, in
    # which case the true first appearance is the run MIN of the row index
    row_idx = s_payloads[0]
    any_distinct = any(len(it) > 4 and it[4] for it in agg_items)
    if any_distinct:
        rep = torch.where(live, run_minmax(row_idx, True, _INT32_MAX), _INT32_MAX)
    else:
        rep = torch.where(
            live, row_idx[torch.clamp(prev_end, 0, n - 1)], _INT32_MAX
        )
    # rank in first-appearance order
    order_of_run = torch.argsort(torch.argsort(rep, stable=True), stable=True)

    def place(vals_runs):
        buf = torch.zeros(r_cap, dtype=vals_runs.dtype, device=dev)
        return buf.index_copy_(0, order_of_run, vals_runs)

    ones = torch.ones(r_cap, dtype=torch.bool, device=dev)

    # ---- group key output columns -------------------------------------------
    gdata, gvalid = [], []
    p = 2 if has_alive else 1
    for kt, kind, op_i, shift, bits in key_types:
        if kind == "small":
            composite = out[op_i]
            valid_bit = (composite >> (shift + bits)) & 1
            if kt == LogicalType.VARCHAR:
                raw = s_payloads[p]
                p += 1
            else:  # BOOLEAN
                raw = ((composite >> shift) & ((1 << bits) - 1)).to(torch.int32)
            gdata.append(_unsortable(place(raw[last]), kt))
            gvalid.append(place(valid_bit[last]) > 0)
            continue
        valid_f = out[op_i]  # the (valid, encoded key) sort fields
        key_f = out[op_i + 1]
        if kt == LogicalType.VARCHAR:
            raw = s_payloads[p]
            p += 1
        else:
            raw = _orderable_inverse(key_f, kt)
        gdata.append(_unsortable(place(raw[last]), kt))
        gvalid.append(place(valid_f[last]) > 0)

    # ---- aggregates -----------------------------------------------------------
    slot_base = p
    counts_cache: dict = {}
    adata, avalid = [], []
    for item in agg_items:
        name, ct, rt, slot = item[0], item[1], item[2], item[3]
        distinct = len(item) > 4 and item[4]
        if ct is None:  # count(*)
            if has_alive:
                cnt = run_sum(alive_s.to(torch.int64))
            else:
                cnt = ends - prev_end
            adata.append(place(torch.where(live, cnt, 0)))
            avalid.append(ones)
            continue
        data = s_payloads[slot_base + 2 * slot]  # VARCHAR min/max: packed
        valid = s_payloads[slot_base + 2 * slot + 1] > 0
        if has_alive:
            valid = valid & alive_s
        if distinct:
            # contributions only at (group, value) pair boundaries — the
            # distinct value rode as an extra sort key, so duplicates are
            # adjacent and only the first of each counts
            valid = valid & new_pair
        if (slot, distinct) not in counts_cache:
            counts_cache[(slot, distinct)] = run_sum(valid.to(torch.int64))
        counts = counts_cache[(slot, distinct)]
        has_any = counts > 0
        if name == "count":
            adata.append(place(torch.where(live, counts, 0)))
            avalid.append(ones)
            continue
        if name in ("sum", "avg"):
            acc_t = LogicalType.DOUBLE if name == "avg" else rt
            vals = convert_numeric(_unsortable(data, ct), ct, acc_t)
            sm = run_sum(torch.where(valid, vals, torch.zeros_like(vals)))
            if name == "avg":
                sm = sm / torch.clamp(counts, min=1).to(torch.float64)
            adata.append(place(sm).to(torch_dtype_for(rt)))
            avalid.append(place(has_any.to(torch.int32)) > 0)
            continue
        if name in ("min", "max"):
            if ct == LogicalType.VARCHAR:
                sentinel = _INT64_MAX if name == "min" else -_INT64_MAX
                v = torch.where(valid, data, sentinel)
                best = run_minmax(v, name == "min", sentinel)
                out_data = place((best & 0xFFFFFFFF).to(torch.int32))
            else:
                if ct.is_float():
                    sentinel = float("inf") if name == "min" else float("-inf")
                elif ct == LogicalType.UBIGINT:
                    sentinel = _INT64_MAX if name == "min" else -_INT64_MAX - 1
                else:
                    ii = np.iinfo(numpy_dtype_for(ct))
                    sentinel = int(ii.max) if name == "min" else int(ii.min)
                vals = _unsortable(data, ct)
                if ct == LogicalType.UBIGINT:
                    vals = ubigint_key(vals)  # unsigned order
                v = torch.where(valid, vals, torch.full_like(vals, sentinel))
                best = run_minmax(v, name == "min", sentinel)
                if ct == LogicalType.UBIGINT:
                    best = ubigint_key(best)
                out_data = place(best)
            adata.append(out_data.to(torch_dtype_for(rt)))
            avalid.append(place(has_any.to(torch.int32)) > 0)
            continue
        raise ExecutorError(f"unknown aggregate {name}")

    return tuple(gdata), tuple(gvalid), tuple(adata), tuple(avalid)


def _reduce_rows(x, want_min: bool):
    return x.amin(1) if want_min else x.amax(1)


def partial_grouped_fixed(alive, row_idx, keys, aggs, g_cap: int):
    """Shard-local FIXED-CAPACITY partial GROUP BY — the per-shard core of
    the distributed aggregation (parallel/dist_executor._grouped_agg_dist):
    g_cap-sized outputs, no host sync; the capacity-overflow flag drives
    the caller's retry with a larger g_cap.

    The same techniques as sorted_grouped_aggregate: the row index rides as
    the least-significant sort key (run start = first appearance), run ends
    come from merge-ranked queries at the capacity g_cap, run sums are
    block-prefix differences, and run min/max uses whole-block bests plus
    the boundary rows.

    alive:   bool[n] live-row mask (dead rows sort last, never form runs)
    row_idx: int64[n] global row ids
    keys:    list of (orderable key, valid bool, raw data)
    aggs:    list of ("count_star" | "count" | "sum" | "avg" | "min" | "max"
             | "vmin" | "vmax", data, valid, rank_or_None, out_dtype)
             (data/valid/rank are None for count_star; rank only for v*)

    Returns (key_outs, first_row, live, states, n_runs, overflow) where
    key_outs = [(data[g_cap], valid[g_cap])] (BOOLEAN keys as int32) and
    states = per agg a dict of g_cap-sized partial-state tensors."""
    from sqlrs_tpu_torch.ops.pipelines import _sorted_ranks_left

    n = alive.shape[0]
    dev = alive.device
    sort_keys: list = [torch.logical_not(alive).to(torch.int32)]
    for orderable, valid, _raw in keys:
        sort_keys.append(valid.to(torch.int32))
        sort_keys.append(torch.where(valid, orderable, torch.zeros_like(orderable)))
    sort_keys.append(row_idx)  # least-significant: run start = first appearance
    num_keys = len(sort_keys)

    payloads: list = [alive.to(torch.int32)]
    key_pay_ix = []
    for _orderable, valid, raw in keys:
        key_pay_ix.append(num_keys + len(payloads))
        payloads.append(_sortable(raw))
        payloads.append(valid.to(torch.int32))
    agg_pay_ix = []
    for kind, data, valid, rank, _dt in aggs:
        if data is None:
            agg_pay_ix.append(None)
            continue
        agg_pay_ix.append(num_keys + len(payloads))
        if kind in ("vmin", "vmax"):
            code_u = data.to(torch.int64) & 0xFFFFFFFF
            payloads.append((rank.to(torch.int64) << 32) | code_u)
        else:
            payloads.append(_sortable(data))
        payloads.append(valid.to(torch.int32))

    perm = _lex_argsort(sort_keys)
    out = [k[perm] for k in sort_keys] + [p[perm] for p in payloads]
    row_s = out[num_keys - 1]
    alive_b = out[num_keys] > 0

    new_run = torch.zeros(n, dtype=torch.bool, device=dev)
    new_run[:1].fill_(True)  # not `new_run[0] = True`: a host scalar's copy
    for arr in out[1:num_keys - 1]:  # key fields only (not dead flag/row)
        new_run[1:] |= arr[1:] != arr[:-1]
    new_run = new_run & alive_b
    rid = torch.cumsum(new_run.to(torch.int32), 0, dtype=torch.int32) - 1
    n_runs = new_run.sum(dtype=torch.int64)
    overflow = n_runs > g_cap
    rid_eff = torch.where(alive_b, rid, _INT32_MAX)  # dead rows leave every run

    pad_n = (-n) % _BLK
    nb = (n + pad_n) // _BLK

    def _pad(arr, fill):
        if pad_n == 0:
            return arr
        return torch.cat([arr, torch.full((pad_n,), fill, dtype=arr.dtype, device=dev)])

    rid_p = _pad(rid_eff, _INT32_MAX)
    r = torch.arange(g_cap, dtype=torch.int32, device=dev)
    ends = _sorted_ranks_left(rid_p.view(-1, _BLK), r + 1)  # side='right'
    prev_end = torch.cat([torch.zeros(1, dtype=ends.dtype, device=dev), ends[:-1]])
    live = r.to(torch.int64) < torch.clamp(n_runs, max=g_cap)
    start_pos = torch.clamp(prev_end, 0, n - 1)
    lane = torch.arange(_BLK, dtype=torch.int32, device=dev)

    def run_sum(arr):
        a2 = _pad(arr, 0).view(-1, _BLK)
        bs = a2.sum(1, dtype=arr.dtype)
        bp = torch.cat([prefix_sum(bs) - bs, bs.sum().reshape(1)])

        def prefix_at(pos):
            b = pos // _BLK
            rem = (pos % _BLK).to(torch.int32)
            rows = a2[torch.clamp(b, 0, nb - 1)]
            part = torch.where(lane[None, :] < rem[:, None], rows, 0).sum(1, dtype=arr.dtype)
            return bp[b] + part

        return prefix_at(ends) - prefix_at(prev_end)

    rid_first = rid_p[::_BLK]
    rid_last = rid_p[_BLK - 1::_BLK]
    whole_blk = rid_first == rid_last
    e1 = torch.clamp(ends, min=1) - 1
    bs_ = prev_end // _BLK
    rs_ = (prev_end % _BLK).to(torch.int32)
    be_ = e1 // _BLK
    re_ = (e1 % _BLK).to(torch.int32) + 1
    same_blk = bs_ == be_

    def run_minmax(arr, want_min, sentinel):
        a2 = _pad(arr, sentinel).view(-1, _BLK)
        bbest = _reduce_rows(a2, want_min)
        tgt = torch.where(
            whole_blk & (rid_first >= 0) & (rid_first < g_cap),
            rid_first.to(torch.int64),
            g_cap,
        )
        init = torch.full((g_cap + 1,), sentinel, dtype=a2.dtype, device=dev)
        scat = init.scatter_reduce_(0, tgt, bbest, "amin" if want_min else "amax")[:g_cap]
        head_rows = a2[torch.clamp(bs_, 0, nb - 1)]
        not_same = torch.logical_not(same_blk)
        hm = (lane[None, :] >= rs_[:, None]) & (
            not_same[:, None] | (lane[None, :] < re_[:, None])
        )
        head = _reduce_rows(torch.where(hm, head_rows, sentinel), want_min)
        tail_rows = a2[torch.clamp(be_, 0, nb - 1)]
        tm = (lane[None, :] < re_[:, None]) & not_same[:, None]
        tail = _reduce_rows(torch.where(tm, tail_rows, sentinel), want_min)
        stacked = torch.stack([scat, head, tail])
        return stacked.amin(0) if want_min else stacked.amax(0)

    first_row = torch.where(live, row_s[start_pos], _INT64_MAX)

    key_outs = []
    for ix in key_pay_ix:
        raw_s, valid_s = out[ix], out[ix + 1]
        kd = torch.where(live, raw_s[start_pos], torch.zeros_like(raw_s[:1]))
        kv = live & (valid_s[start_pos] > 0)
        key_outs.append((kd, kv))

    states = []
    for (kind, data, valid, rank, out_dt), ix in zip(aggs, agg_pay_ix):
        if kind == "count_star":
            cnt = torch.where(live, ends - prev_end, 0)
            states.append({"cnt": cnt})
            continue
        data_s = out[ix]
        valid_s = (out[ix + 1] > 0) & alive_b
        cnt = torch.where(live, run_sum(valid_s.to(torch.int64)), 0)
        if kind == "count":
            states.append({"cnt": cnt})
        elif kind in ("sum", "avg"):
            acc = data_s.to(out_dt)
            sm = run_sum(torch.where(valid_s, acc, torch.zeros_like(acc)))
            states.append({"cnt": cnt, "sum": torch.where(live, sm, torch.zeros_like(sm))})
        elif kind in ("min", "max"):
            if data_s.is_floating_point():
                sent = float("inf") if kind == "min" else float("-inf")
            else:
                ii = torch.iinfo(data_s.dtype)
                sent = ii.max if kind == "min" else ii.min
            v = torch.where(valid_s, data_s, torch.full_like(data_s, sent))
            states.append({"cnt": cnt, "best": run_minmax(v, kind == "min", sent)})
        elif kind in ("vmin", "vmax"):
            sent = _INT64_MAX if kind == "vmin" else -_INT64_MAX
            v = torch.where(valid_s, data_s, sent)
            best = run_minmax(v, kind == "vmin", sent)
            states.append({"cnt": cnt, "best": (best & 0xFFFFFFFF).to(torch.int32)})
        else:
            raise ExecutorError(f"unknown partial aggregate kind {kind}")

    return key_outs, first_row, live, states, n_runs, overflow


def _orderable_inverse(key_field, t: LogicalType):
    """Invert ops/sort.orderable_key for the non-VARCHAR types (identity up
    to dtype, except the UBIGINT signed-range shift)."""
    if t == LogicalType.UBIGINT:
        return ubigint_key(key_field)
    return key_field.to(torch_dtype_for(t))


def _sortable(data):
    """Payload-friendly view (bools -> int32)."""
    if data.dtype == torch.bool:
        return data.to(torch.int32)
    return data


def _unsortable(data, t: LogicalType):
    dt = torch_dtype_for(t)
    if data.dtype != dt:
        return data.to(dt)
    return data
