"""SQL → fused star-rollup pipelines: Order(HashAgg(HashJoin)) → one packed sort.

The port of sqlrs_tpu/exec/fused_route.py. The engine's star-rollup
pipelines (ops/pipelines.py: join_groupby_direct, join_groupby_minmax_tv,
join_groupby_firstapp, and ops/mxu_agg.py for dense dims) compute fact⋈dim
+ GROUP BY join-key + sum/count/min/max/avg/DISTINCT without materializing
the join. This module pattern-matches the plan shape

    Order(key asc|desc)                               -- optional
      HashAgg(groups ∋ key, aggs over one side's expressions)
        HashJoin(inner, fact.key = dim.key)           -- unique dim keys

and routes it through them. With the ORDER BY on the key, the output comes
in key order from the value-packed kernel; without it, the engine's
first-appearance group order is recovered from the rowid-packed kernel.
The join key may be an int, a DATE, a VARCHAR (first-appearance variant
only: dictionary codes are not collation order) or two int columns folded
into one combined key. Extra group columns must be dim attributes (with
unique dim keys they are functionally dependent on the key).

Eligibility is checked statically from the plan and dynamically from ONE
host fetch of a small stats vector (dim keys unique and valid, key spans,
value ranges, validity, k-dp decimal scales). k-dp DOUBLE measures ride as
scaled ints, so their per-group sums are exact integer arithmetic and the
finalize step divides by 10^k — by a device tensor, because PyTorch's CUDA
division by a Python scalar multiplies by the reciprocal, which is not the
same rounding. Ineligible plans return None and run the general executor
(the hash join and GROUP BY of exec/executor.py), as in the reference; the
children a bailed attempt already executed wait in the executor's one-shot
cache, so the general path scans each of them once.

Route names logged in `db.last_fused_routes` are the reference's, letter
for letter. The reference's host fetches are kept, and no others: the stats
vector, the composite-key meta, and the surviving group count. Each of its
jitted steps is a program here (utils/programs.py): the stats, the key
combination, each routed kernel (kernel 2, `dense_group_sums`, runs inside
the `_routed_kernel_mxu` graph), the compaction and the finalize.
"""

from __future__ import annotations

import dataclasses

import torch

from sqlrs_tpu_torch.binder.expression import (
    BoundAggregate,
    BoundReference,
    rewrite_expr,
    visit_expr,
)
from sqlrs_tpu_torch.data import Column, DeviceBatch
from sqlrs_tpu_torch.data.batch import torch_dtype_for
from sqlrs_tpu_torch.exec.expression_executor import execute_exprs_fused
from sqlrs_tpu_torch.ops import pipelines
from sqlrs_tpu_torch.ops.mxu_agg import mxu_eligible, mxu_groupby_dense
from sqlrs_tpu_torch.plan import physical as P
from sqlrs_tpu_torch.types import LogicalType
from sqlrs_tpu_torch.utils.programs import program

_INT64_MAX = 2**63 - 1


@program
def _route_stats(dim_keys, dim_valid, fact_keys, fact_valid, datas, valids):
    """Every dynamic eligibility check, fetched as ONE small vector:

      dim_sorted            (G,)  — stays on the device for the kernel
      meta  int64[6 + 4V]:  [d_all_valid, d_unique, d_min, d_max,
                             f_kmin, f_kmax,
                             per value column all_valid…, min…, max…,
                             k-dp scale (or -1)…]

    Value mins/maxs are over VALID rows; for a k-dp decimal float column
    they are the SCALED int range (it drives int32 payload packing)."""
    big = _INT64_MAX
    ks = torch.sort(dim_keys).values
    if dim_keys.shape[0] > 1:
        unique = (ks[1:] > ks[:-1]).all()
    else:
        unique = torch.ones((), dtype=torch.bool, device=ks.device)
    kmin = torch.where(fact_valid, fact_keys, big).min()
    kmax = torch.where(fact_valid, fact_keys, -big - 1).max()
    parts = [dim_valid.all(), unique, ks[0], ks[-1], kmin, kmax]
    parts += [v.all() for v in valids]
    # FLOAT/DOUBLE value columns: detect k-dp decimals (k in 0/2/4/6 —
    # TPC-H measures and their products) so that their sums can run in
    # EXACT integer arithmetic; kcode = the smallest integral k, or -1
    kcodes = []
    for d, v in zip(datas, valids):
        if not d.is_floating_point():
            kcodes.append(None)
            continue
        f = d.to(torch.float64)
        kc = torch.full((), -1.0, dtype=torch.float64, device=f.device)
        for k in (6, 4, 2, 0):  # descending: the smallest k wins last
            s = f * (10.0 ** k)
            fr = torch.abs(s - torch.round(s))
            row_ok = fr <= (1e-5 + torch.abs(s) * 1e-12)
            allok = torch.where(v, row_ok, True).all() & (
                torch.where(v, torch.abs(s), 0.0).max() < float(1 << 46)
            )
            kc = torch.where(allok, float(k), kc)
        kcodes.append(kc)

    def _scaled(d, kc):
        if kc is None:
            return d.to(torch.int64)
        scale = torch.where(
            kc == 0, 1.0, torch.where(kc == 2, 1e2, torch.where(kc == 4, 1e4, 1e6))
        )
        return torch.round(d.to(torch.float64) * scale).to(torch.int64)

    for d, v, kc in zip(datas, valids, kcodes):
        parts.append(torch.where(v, _scaled(d, kc), big).min())
    for d, v, kc in zip(datas, valids, kcodes):
        parts.append(torch.where(v, _scaled(d, kc), -big).max())
    for kc in kcodes:
        parts.append(
            torch.full((), -1, dtype=torch.int64, device=ks.device)
            if kc is None else kc
        )
    meta = torch.stack([p.to(torch.int64) for p in parts])
    return ks, meta


@program
def _combine_keys(f1, f1v, f2, f2v, d1, d1v, d2, d2v):
    """Fold a two-key equi join into one combined int key:

        ck = (k_major - dim_major_min) * span_minor + (k_minor - minor_min)

    over the DIM minor span, so ck is injective across majors for in-span
    minors; fact rows whose minor key falls outside that span would alias a
    neighbouring major's range and are masked invalid (they match no dim
    row anyway). Returns (fact_ck, fact_ok, dim_ck, dim_ok, meta[s, mj_min,
    mn_min, f1_min, f1_max, d1_max]); the host guards the packing against
    int64 overflow with the meta, and the finalize step decodes the
    combined key with it. Combined ascending order IS (major, minor) order."""
    big = _INT64_MAX
    d1, d2 = d1.to(torch.int64), d2.to(torch.int64)
    f1, f2 = f1.to(torch.int64), f2.to(torch.int64)
    d12v = d1v & d2v
    mn_min = torch.where(d12v, d2, big).min()
    mn_max = torch.where(d12v, d2, -big).max()
    mj_min = torch.where(d12v, d1, big).min()
    d1_max = torch.where(d12v, d1, -big).max()
    s = torch.clamp(mn_max - mn_min + 1, min=1)
    dim_ck = (d1 - mj_min) * s + (d2 - mn_min)
    in_span = (f2 >= mn_min) & (f2 <= mn_max)
    fact_ck = (f1 - mj_min) * s + (f2 - mn_min)
    fact_ok = f1v & f2v & in_span
    f1_min = torch.where(fact_ok, f1, big).min()
    f1_max = torch.where(fact_ok, f1, -big).max()
    meta = torch.stack([s, mj_min, mn_min, f1_min, f1_max, d1_max])
    return fact_ck, fact_ok, dim_ck, d12v, meta


def _mask_payloads(pairs, packs, scales=None):
    """(data, valid|None) pairs -> payload tensors with NULLs as 0 (their
    count rides a validity payload). packs[i] selects int32 (range-checked
    by the caller; the cast precedes the masking, so wrapped garbage in NULL
    slots is zeroed). FLOAT/DOUBLE payloads that are k-dp decimals
    (scales[i] >= 0) ride as SCALED ints with exact sums; other floats keep
    their width and accumulate float64."""
    out = []
    scales = scales or (-1,) * len(pairs)
    for (d, v), p32, sc in zip(pairs, packs, scales):
        dt = torch.int32 if p32 else torch.int64
        if d.is_floating_point():
            if sc is not None and sc >= 0:
                x = torch.round(d.to(torch.float64) * (10.0 ** sc)).to(dt)
            else:
                x = d
        else:
            x = d.to(dt)
        if v is not None:
            x = x.masked_fill(torch.logical_not(v), 0)
        out.append(x)
    return tuple(out)


@program
def _routed_kernel(fkeys, fvalid, fvals, fvals_valid, dim_sorted, miss_key: int,
                   n_groups: int, val_bits: int, pack32: bool, dense: bool,
                   with_minmax: bool, with_distinct: bool = False,
                   extra_pairs=(), extra_packs=(), extra_scales=(),
                   null_ix: int = -1):
    """Masked fact rows -> an out-of-span key, then the direct kernel.
    dim_sorted is sorted, so dim_perm is the identity and the output comes
    in key order. fvals_valid (when not None) masks NULL packed values to
    the sentinel 2^val_bits - 1 (sentinel mode, validity payload at extra
    index null_ix); extra_pairs are (data, valid|None) payload columns."""
    fk = torch.where(fvalid, fkeys, miss_key).to(torch.int64)
    fv = fvals.to(torch.int64)
    if fvals_valid is not None:
        fv = torch.where(fvals_valid, fv, (1 << val_bits) - 1)
    perm = torch.arange(n_groups, dtype=torch.int64, device=fk.device)
    return pipelines.join_groupby_direct(
        fk, fv, dim_sorted.to(torch.int64), perm, n_groups, val_bits, pack32,
        dense=dense, with_minmax=with_minmax, with_distinct=with_distinct,
        extra_vals=_mask_payloads(extra_pairs, extra_packs, extra_scales),
        null_ix=null_ix,
    )


@program
def _routed_kernel_tv(fkeys, fvalid, fvals, fvals_valid, dim_sorted,
                      miss_key: int, n_groups: int, pack32: bool, dense: bool,
                      extra_pairs=(), extra_packs=(), extra_scales=(),
                      sum_scale: int = -1, null_ix: int = -1):
    """min/max over a FLOAT/DOUBLE measure: the measure rides as a SECOND
    sort key under the order-preserving IEEE-754 transform
    (join_groupby_minmax_tv). NULL values mask to int64-max tv (the range
    tail) with the validity payload at null_ix; the sum payload (f64, or
    scaled int64 for a k-dp decimal) masks NULLs to 0."""
    fk = torch.where(fvalid, fkeys, miss_key).to(torch.int64)
    v64 = fvals.to(torch.float64)
    tv = pipelines.f64_orderable(v64)
    if sum_scale >= 0:
        vpay = torch.round(v64 * (10.0 ** sum_scale)).to(torch.int64)
    else:
        vpay = v64
    if fvals_valid is not None:
        tv = torch.where(fvals_valid, tv, _INT64_MAX)
        vpay = vpay.masked_fill(torch.logical_not(fvals_valid), 0)
    perm = torch.arange(n_groups, dtype=torch.int64, device=fk.device)
    return pipelines.join_groupby_minmax_tv(
        fk, vpay, tv, dim_sorted.to(torch.int64), perm, n_groups,
        pack32, dense=dense,
        extra_vals=_mask_payloads(extra_pairs, extra_packs, extra_scales),
        null_ix=null_ix,
    )


@program
def _routed_kernel_mxu(fkeys, fvalid, fvals, key_min: int, n_groups: int,
                       val_bits: int):
    """Pure sum+count rollup over a DENSE dim domain: the dense-group kernel
    (ops/mxu_agg.py). dim_sorted is consecutive, so gid order IS output
    order; invalid fact keys are misses (the kernel reads fvalid)."""
    return mxu_groupby_dense(fkeys, fvals, n_groups, val_bits, key_min=key_min,
                             valid=fvalid)


@program
def _routed_kernel_firstapp(fkeys, fvalid, pairs, dim_sorted, miss_key: int,
                            n_groups: int, rid_bits: int, dense: bool,
                            packs=(), scales=()):
    fk = torch.where(fvalid, fkeys, miss_key).to(torch.int64)
    perm = torch.arange(n_groups, dtype=torch.int64, device=fk.device)
    return pipelines.join_groupby_firstapp(
        fk, _mask_payloads(pairs, packs, scales),
        dim_sorted.to(torch.int64), perm, n_groups, rid_bits, dense=dense,
    )


@program
def _compact_nonempty(dim_sorted, arrays):
    """Drop zero-count groups keeping sorted order: one stable argsort by
    the drop flag; counts must be arrays[1]."""
    alive = arrays[1] > 0
    order = torch.argsort(torch.logical_not(alive).to(torch.int8), stable=True)
    return dim_sorted[order], tuple(a[order] for a in arrays), alive.sum()


@program
def _finalize(arrays, n_out: int, spec, reorder: bool = False,
              order_ix: int = -1, reverse: bool = False, fscales=None,
              fdivs=None):
    """Emit every output column. spec entries are (op, ai, bi, dtype, vop,
    vai): op 'slice' takes arrays[ai], 'div' computes float64
    arrays[ai]/max(arrays[bi], 1), 'majk'/'mink' decode a combined key with
    the meta arrays[bi]; dtype (torch dtype or None = keep) casts; vop
    selects the validity — 'ones', 'arr' (arrays[vai] is the mask) or 'gt0'
    (arrays[vai] > 0). reorder applies the first-appearance permutation
    argsort(arrays[order_ix][:n_out]). fscales[i] >= 0 marks a scaled-int
    decimal sum, divided back by fdivs[i] = 10^k, a device tensor: a true
    division, not a multiplication by the reciprocal."""
    if reorder:
        order = torch.argsort(arrays[order_ix][:n_out], stable=True)

        def take(a):
            return a[:n_out][order]
    elif reverse:  # ORDER BY key DESC: ascending kernel output, flipped
        def take(a):
            return torch.flip(a[:n_out], (0,))
    else:
        def take(a):
            return a[:n_out]

    dev = arrays[0].device
    ones = torch.ones(n_out, dtype=torch.bool, device=dev)
    outs = []
    if fscales is None:
        fscales = (-1,) * len(spec)
    if fdivs is None:
        # fills on the device: no host-to-device copy, so no sync
        fdivs = tuple(
            torch.full((), 10.0 ** f if f >= 0 else 1.0, dtype=torch.float64, device=dev)
            for f in fscales
        )
    for (op, ai, bi, dt, vop, vai), fsc, fdv in zip(spec, fscales, fdivs):
        if op == "slice":
            src = take(arrays[ai])
            if fsc >= 0:  # scaled-int decimal sum: divide back by 10^k
                src = src.to(torch.float64) / fdv
        elif op in ("majk", "mink"):
            # composite-key decode: arrays[bi] is the _combine_keys meta
            # [s_minor, mj_min, mn_min, …]; combined keys are >= 0
            ck = arrays[bi]
            if op == "majk":
                src = take(arrays[ai]) // ck[0] + ck[1]
            else:
                src = take(arrays[ai]) % ck[0] + ck[2]
        else:  # "div"
            num = take(arrays[ai]).to(torch.float64)
            if fsc >= 0:
                num = num / fdv
            den = torch.clamp(take(arrays[bi]), min=1).to(torch.float64)
            src = num / den
        if dt is not None:
            src = src.to(dt)
        if vop == "ones":
            valid = ones
        elif vop == "arr":
            valid = take(arrays[vai])
        else:  # "gt0"
            valid = take(arrays[vai]) > 0
        outs.append(src)
        outs.append(valid)
    return tuple(outs)


def _routable_key_type(t) -> bool:
    """Join-key types the packed kernels handle: ints and DATE (int32 days:
    equality and ORDER BY on day ints are exact)."""
    return (t.is_integral() and t != LogicalType.INTERVAL) or (
        t == LogicalType.DATE
    )


def _resolve_side(ref_index: int, left_width: int):
    """join-output column index -> (side, in-side index)."""
    if ref_index < left_width:
        return "left", ref_index
    return "right", ref_index - left_width


def try_order_agg_join_route(executor, op: P.PhysicalOrder):
    """Order(HashAgg(HashJoin)) with order key == group key: the output is
    produced directly in key order by the value-packed kernel (min/max
    supported). Returns None when ineligible."""
    db = getattr(executor, "db", None)
    if db is not None and getattr(db, "enable_fused_route", True) is False:
        return None
    if not op.items or len(op.items) > 2:
        return None
    dirs = {asc for _, asc in op.items}
    if len(dirs) != 1:
        return None  # mixed asc/desc cannot ride one packed order
    for j, (okey, _) in enumerate(op.items):
        if not isinstance(okey, BoundReference) or okey.index != j:
            return None
    if len(op.children) != 1 or not isinstance(op.children[0], P.PhysicalHashAgg):
        return None
    # DESC: the kernel emits ascending key order and finalize reverses it.
    # Two order keys must be the two columns of a composite join key.
    return _try_route(
        executor, op, op.children[0], ordered=True, reverse=not dirs.pop(),
        n_order_keys=len(op.items),
    )


def try_agg_join_route(executor, agg: P.PhysicalHashAgg):
    """Bare HashAgg(HashJoin), no ORDER BY above: the first-appearance group
    order is recovered from the rowid-packed kernel (join_groupby_firstapp),
    min probe row index per group and one G-sized argsort. Values ride as
    payloads (negatives fine); min/max are not available on this variant."""
    db = getattr(executor, "db", None)
    if db is not None and getattr(db, "enable_fused_route", True) is False:
        return None
    return _try_route(executor, agg, agg, ordered=False)


def _try_route(executor, op, agg, ordered: bool, reverse: bool = False,
               n_order_keys: int = 1):
    if not agg.groups or not all(isinstance(g, BoundReference) for g in agg.groups):
        return None
    if len(agg.children) != 1:
        return None
    child = agg.children[0]
    # column pruning interposes a pure-reference Projection between the
    # aggregate and the join — see through it by remapping indices
    remap = None
    if (
        isinstance(child, P.PhysicalProjection)
        and len(child.children) == 1
        and all(isinstance(e, BoundReference) for e in child.exprs)
    ):
        remap = [e.index for e in child.exprs]
        child = child.children[0]
    if not isinstance(child, P.PhysicalHashJoin):
        return None
    join = child

    def _map(i: int) -> int:
        return remap[i] if remap is not None else i

    if (
        join.join_type != "inner"
        or len(join.on) not in (1, 2)
        or join.filter is not None
        or getattr(join, "null_aware", False)
    ):
        return None
    composite = len(join.on) == 2
    for lk, rk in join.on:
        if not isinstance(lk, BoundReference) or not isinstance(rk, BoundReference):
            return None
    lw = join.left_width
    if composite:
        # two-key equi join: both keys int; the first TWO group columns must
        # be the two key columns of one side (groups[0] = the major key)
        if ordered and n_order_keys != 2:
            return None  # ORDER BY one of two keys under-specifies ties
        for lk, rk in join.on:
            for k in (lk, rk):
                if not _routable_key_type(k.type):
                    return None
        if len(agg.groups) < 2:
            return None
        g0s, g0i = _resolve_side(_map(agg.groups[0].index), lw)
        g1s, g1i = _resolve_side(_map(agg.groups[1].index), lw)
        if g0s != g1s or g0i == g1i:
            return None
        (l1, r1), (l2, r2) = join.on
        side_keys = (l1.index, l2.index) if g0s == "left" else (r1.index, r2.index)
        if {g0i, g1i} != set(side_keys):
            return None
        maj_pair = 0 if g0i == side_keys[0] else 1
        # (side, in-side index, position among agg.groups)
        extra_groups: list[tuple[str, int, int]] = [
            (*_resolve_side(_map(g.index), lw), gpos)
            for gpos, g in enumerate(agg.groups[2:], start=2)
        ]
    else:
        if ordered and n_order_keys != 1:
            return None
        lkey, rkey = join.on[0]
        # VARCHAR keys are dictionary codes: equality on codes IS string
        # equality, so the first-appearance variant routes them; the ORDER
        # BY variant would order by code, not collation, and bails
        varchar_key = lkey.type == LogicalType.VARCHAR and rkey.type == LogicalType.VARCHAR
        if varchar_key:
            if ordered:
                return None
        elif not (_routable_key_type(lkey.type) and _routable_key_type(rkey.type)):
            return None
        # SOME group column must BE the join key column of its side (any
        # position); every other group column must be a dim-side attribute
        key_positions = []
        extra_groups = []
        for gpos, g in enumerate(agg.groups):
            side, idx = _resolve_side(_map(g.index), lw)
            if idx == (lkey.index if side == "left" else rkey.index):
                key_positions.append(gpos)
            else:
                extra_groups.append((side, idx, gpos))
        if not key_positions:
            return None
        if ordered and key_positions[0] != 0:
            return None  # the ORDER BY references output column 0

    # aggregates: sum/count/min/max/avg over any number of distinct value
    # expressions whose column references all live on one side (the fact
    # side), plus count(*). One expression may be PACKED into the sort key
    # (min/max, DISTINCT, a free prefix sum); the others ride as payloads.
    val_side = None
    val_exprs: list = []       # distinct value expressions, by repr
    val_keys: list[str] = []
    specs: list[tuple[str, int | None]] = []  # (kind, val_exprs index)
    for a in agg.aggregates:
        if not isinstance(a, BoundAggregate):
            return None
        if a.distinct and (not ordered or a.function_name not in ("count", "sum", "avg")):
            # DISTINCT needs the value packed into the sort key (adjacent
            # duplicates); only the ordered variant packs values
            return None
        if a.arg is None:
            if a.function_name != "count":
                return None
            specs.append(("count_star", None))
            continue
        if a.function_name not in ("sum", "count", "min", "max", "avg"):
            return None
        rt_arg = a.arg.return_type()
        if not rt_arg.is_float() and (
            not rt_arg.is_integral()
            or rt_arg in (LogicalType.DATE, LogicalType.INTERVAL)
        ):
            return None
        if not ordered and a.function_name in ("min", "max"):
            return None  # rowid packing cannot order values within a range
        refs: list[int] = []
        bad = []
        visit_expr(
            a.arg,
            lambda e: (
                refs.append(e.index) if isinstance(e, BoundReference)
                else bad.append(e) if isinstance(e, BoundAggregate) else None
            ),
        )
        if bad or not refs:
            return None  # nested aggregate / constant-only argument
        ref_sides = {_resolve_side(_map(i), lw)[0] for i in refs}
        if len(ref_sides) != 1:
            return None
        side = ref_sides.pop()
        if val_side is None:
            val_side = side
        elif side != val_side:
            return None  # value expressions split across both join sides
        key = repr(a.arg)
        if key in val_keys:
            ix = val_keys.index(key)
        else:
            ix = len(val_keys)
            val_keys.append(key)
            val_exprs.append(a.arg)
        specs.append((a.function_name + ("_d" if a.distinct else ""), ix))
    # min/max and DISTINCT need their value packed; only one expression packs
    minmax_ixs = {ix for k, ix in specs if k in ("min", "max")}
    distinct_ixs = {ix for k, ix in specs if k.endswith("_d")}
    packed_need = minmax_ixs | distinct_ixs
    if len(packed_need) > 1:
        return None
    expr_float = [e.return_type().is_float() for e in val_exprs]
    # float min/max routes via the two-key tv kernel; float DISTINCT would
    # need value-equality packing and falls back
    float_tv = bool(packed_need) and expr_float[next(iter(packed_need))]
    if float_tv and distinct_ixs:
        return None

    # ---- execute children (scans/filters run as usual) ------------------
    # stash the batches in the executor's one-shot cache, so that a later
    # bail does NOT re-execute the subtree (the general path pops them)
    left = executor.execute(join.children[0])
    right = executor.execute(join.children[1])
    cache = executor._route_cache
    cache[id(join.children[0])] = left
    cache[id(join.children[1])] = right
    sides = {"left": left, "right": right}

    # ---- choose the dim (unique build) side -----------------------------
    # values live on the fact side; with only count(*) either side may be
    # the dim — the smaller one (the key values agree on an inner join)
    if val_side is not None:
        dim_side = "left" if val_side == "right" else "right"
    elif left.num_rows <= right.num_rows:
        dim_side = "left"
    else:
        dim_side = "right"
    fact_side = "left" if dim_side == "right" else "right"
    if any(side != dim_side for side, _, _ in extra_groups):
        return None  # non-key group columns must be dim attributes
    dim_b, fact_b = sides[dim_side], sides[fact_side]
    dev = fact_b.device
    n_groups = dim_b.num_rows
    n_fact = fact_b.num_rows
    if n_groups == 0 or n_fact == 0 or n_groups > n_fact:
        return None  # empty inputs / dim larger than fact: general path

    ck_meta_dev = None
    if composite:
        # fold the two keys into one combined int key (one small fetch);
        # everything downstream runs the single-key machinery
        def _side_col(b, side, pair_ix):
            lk, rk = join.on[pair_ix]
            return b.columns[(lk if side == "left" else rk).index]

        d1c = _side_col(dim_b, dim_side, maj_pair)
        d2c = _side_col(dim_b, dim_side, 1 - maj_pair)
        f1c = _side_col(fact_b, fact_side, maj_pair)
        f2c = _side_col(fact_b, fact_side, 1 - maj_pair)
        fact_ck, fact_ok, dim_ck, dim_ok, ck_meta_dev = _combine_keys(
            f1c.data, f1c.valid, f2c.data, f2c.valid,
            d1c.data, d1c.valid, d2c.data, d2c.valid,
        )
        ckm = ck_meta_dev.cpu().numpy()
        s_minor, mj_min = int(ckm[0]), int(ckm[1])
        f1_min, f1_max, d1_max = int(ckm[3]), int(ckm[4]), int(ckm[5])
        # int64 overflow guard on (k_major - mj_min) * s_minor
        span = max(abs(f1_max - mj_min) + 1, abs(f1_min - mj_min) + 1,
                   abs(d1_max - mj_min) + 1)
        if s_minor <= 0 or span >= (1 << 61) // max(s_minor, 1):
            return None
        dim_key_col = Column(LogicalType.BIGINT, dim_ck, dim_ok)
        fact_key_col = Column(LogicalType.BIGINT, fact_ck, fact_ok)
    else:
        dim_key_col = dim_b.columns[rkey.index if dim_side == "right" else lkey.index]
        fact_key_col = fact_b.columns[lkey.index if fact_side == "left" else rkey.index]
    # every distinct value expression over the fact batch: column refs are
    # free, the rest are evaluated with refs rewritten to fact-batch indices
    val_cols: list = [None] * len(val_exprs)
    to_eval, eval_ixs = [], []
    for k, e in enumerate(val_exprs):
        if isinstance(e, BoundReference):
            val_cols[k] = fact_b.columns[_resolve_side(_map(e.index), lw)[1]]
        else:
            to_eval.append(e)
            eval_ixs.append(k)
    if to_eval:
        def _rw(e):
            if isinstance(e, BoundReference):
                return dataclasses.replace(e, index=_resolve_side(_map(e.index), lw)[1])
            return None

        outs = execute_exprs_fused([rewrite_expr(e, _rw) for e in to_eval], fact_b)
        for k, c in zip(eval_ixs, outs):
            val_cols[k] = c

    # ---- dynamic checks (ONE host fetch) --------------------------------
    nv = len(val_cols)
    dim_sorted, meta_dev = _route_stats(
        dim_key_col.data.to(torch.int64), dim_key_col.valid,
        fact_key_col.data.to(torch.int64), fact_key_col.valid,
        tuple(c.data for c in val_cols),
        tuple(c.valid for c in val_cols),
    )
    meta = meta_dev.cpu().numpy()
    if not bool(meta[0]) or not bool(meta[1]):
        return None  # NULL or duplicate dim keys
    d_min, d_max = int(meta[2]), int(meta[3])
    f_kmin, f_kmax = int(meta[4]), int(meta[5])
    with_minmax = bool(minmax_ixs)
    with_distinct = bool(distinct_ixs)
    nullable: list[bool] = []
    fits32: list[bool] = []
    vmins = vmaxs = ()
    kscales: list[int] = []
    if val_cols:
        # NULL-able value columns: masked payloads (NULL sums as 0) plus
        # one validity payload each for the per-group non-NULL count
        flags = meta[6:6 + nv]
        vmins = meta[6 + nv:6 + 2 * nv]
        vmaxs = meta[6 + 2 * nv:6 + 3 * nv]
        nullable = [not bool(f) for f in flags]
        # k-dp decimal scale per float column (-1: not a decimal / an int
        # column); scaled payloads whose worst-case total could overflow
        # int64 fall back to f64 payloads
        kscales = [int(x) for x in meta[6 + 3 * nv:6 + 4 * nv]]
        for k in range(nv):
            if expr_float[k] and kscales[k] >= 0:
                mag = max(abs(int(vmins[k])), abs(int(vmaxs[k])), 1)
                if mag * n_fact >= (1 << 62):
                    kscales[k] = -1
        lo32, hi32 = -(1 << 31), (1 << 31) - 1
        fits32 = [
            (not expr_float[k] or kscales[k] >= 0) and (
                int(mn) > int(mx)  # no valid rows: masked zeros
                or (lo32 < int(mn) and int(mx) < hi32)
            )
            for k, (mn, mx) in enumerate(zip(vmins, vmaxs))
        ]
    f_kmax = max(f_kmax, d_max)
    f_kmin = min(f_kmin, d_min)
    miss_key = f_kmax + 1  # out of every dim range, incl. the last boundary
    dense = (d_max - d_min + 1) == n_groups

    # validity payloads: one per NULL-able expression (count(v), avg
    # denominators, all-NULL groups)
    valid_ixs = [k for k in range(len(val_cols)) if nullable[k]]
    used_mxu = False
    if ordered:
        # the packed expression: the min/max/DISTINCT one if any, else the
        # first whose valid range packs; its prefix sum comes with the rank
        # rows. Everything else rides as payloads.
        def _bits_ok(k):
            if expr_float[k]:
                return None  # floats never pack
            vmx = max(int(vmaxs[k]), 0)
            if int(vmins[k]) < 0 and int(vmins[k]) <= int(vmaxs[k]):
                return None
            if nullable[k]:
                vmx += 1  # sentinel mode: every real value < 2^vb - 1
            vb = max(vmx.bit_length(), 1)
            if vb >= 62 or miss_key >= (1 << (62 - vb)) or f_kmin <= -(1 << (62 - vb)):
                return None
            return vb

        packed_ix = None
        val_bits = 1
        if packed_need:
            packed_ix = next(iter(packed_need))
            if not float_tv:  # a float rides the second sort key instead
                vb = _bits_ok(packed_ix)
                if vb is None:
                    return None  # min/max/DISTINCT cannot ride a payload
                val_bits = vb
        else:
            for k in range(len(val_cols)):
                vb = _bits_ok(k)
                if vb is not None:
                    packed_ix, val_bits = k, vb
                    break
        if miss_key >= (1 << (62 - val_bits)) or f_kmin <= -(1 << (62 - val_bits)):
            return None  # packing headroom exhausted
        # int32 packing needs val_bits < 31; the reference shifts by
        # 31 - val_bits unguarded and raises for wider values
        pack32 = (
            val_bits < 31
            and miss_key < (1 << (31 - val_bits)) - 1
            and f_kmin > -(1 << (31 - val_bits))
        )
        extra_ixs = [k for k in range(len(val_cols)) if k != packed_ix]
        vals = (val_cols[packed_ix].data if packed_ix is not None
                else torch.zeros(n_fact, dtype=torch.int64, device=dev))
        pvalid = (
            val_cols[packed_ix].valid
            if packed_ix is not None and nullable[packed_ix] else None
        )
        pairs = tuple(
            (val_cols[k].data, val_cols[k].valid if nullable[k] else None)
            for k in extra_ixs
        ) + tuple((val_cols[k].valid.to(torch.int32), None) for k in valid_ixs)
        packs = tuple(fits32[k] for k in extra_ixs) + tuple(True for _ in valid_ixs)
        scales_t = tuple(
            kscales[k] if expr_float[k] else -1 for k in extra_ixs
        ) + tuple(-1 for _ in valid_ixs)
        # sentinel mode: the packed column's validity payload position
        null_ix = len(extra_ixs) + valid_ixs.index(packed_ix) if pvalid is not None else -1
        used_mxu = (
            not with_minmax and not with_distinct and not pairs
            and packed_ix is not None and pvalid is None
            and mxu_eligible(
                n_groups, int(vmaxs[packed_ix]), int(vmins[packed_ix]), dense, dev
            )
        )
        if used_mxu:
            out = _routed_kernel_mxu(
                fact_key_col.data, fact_key_col.valid,
                vals, d_min, n_groups=n_groups, val_bits=val_bits,
            )
        elif float_tv:
            out = _routed_kernel_tv(
                fact_key_col.data.to(torch.int64), fact_key_col.valid,
                vals, pvalid, dim_sorted, miss_key,
                n_groups=n_groups, pack32=bool(pack32), dense=dense,
                extra_pairs=pairs, extra_packs=packs, extra_scales=scales_t,
                sum_scale=kscales[packed_ix], null_ix=null_ix,
            )
        else:
            out = _routed_kernel(
                fact_key_col.data.to(torch.int64), fact_key_col.valid,
                vals, pvalid, dim_sorted, miss_key,
                n_groups=n_groups, val_bits=val_bits, pack32=bool(pack32),
                dense=dense, with_minmax=with_minmax, with_distinct=with_distinct,
                extra_pairs=pairs, extra_packs=packs, extra_scales=scales_t,
                null_ix=null_ix,
            )
        # kernel layout: sums_packed, counts, [mins, maxs,] [dcnt, dsum,]
        # extra sums…, validity counts…
        dbase = 4 if with_minmax else 2
        kb = dbase + (2 if with_distinct else 0)
        dcnt_ai, dsum_ai = dbase, dbase + 1
        expr_src = {k: kb + j for j, k in enumerate(extra_ixs)}
        if packed_ix is not None:
            expr_src[packed_ix] = 0
        vbase = kb + len(extra_ixs)
        expr_vcnt = {k: vbase + j for j, k in enumerate(valid_ixs)}
    else:
        rid_bits = max(n_fact.bit_length(), 1)
        if miss_key >= (1 << (62 - rid_bits)) or f_kmin <= -(1 << (62 - rid_bits)):
            return None
        pairs = tuple(
            (c.data, c.valid if nullable[k] else None)
            for k, c in enumerate(val_cols)
        ) + tuple((val_cols[k].valid.to(torch.int32), None) for k in valid_ixs)
        packs = tuple(fits32) + tuple(True for _ in valid_ixs)
        scales_t = tuple(
            kscales[k] if expr_float[k] else -1 for k in range(len(val_cols))
        ) + tuple(-1 for _ in valid_ixs)
        if not pairs:
            pairs = ((torch.zeros(n_fact, dtype=torch.int32, device=dev), None),)
            packs = (True,)
            scales_t = (-1,)
        out = _routed_kernel_firstapp(
            fact_key_col.data.to(torch.int64), fact_key_col.valid,
            pairs, dim_sorted, miss_key,
            n_groups=n_groups, rid_bits=rid_bits, dense=dense, packs=packs,
            scales=scales_t,
        )
        # kernel layout: sums_0, counts, firsts, sums_1…, validity counts…
        expr_src = {k: (0 if k == 0 else k + 2) for k in range(len(val_cols))}
        vbase = len(val_cols) + 2
        expr_vcnt = {k: vbase + j for j, k in enumerate(valid_ixs)}

    # extra dim group columns and (for first-appearance order with the dim
    # on the right) original dim positions ride the compaction as G-sized
    # arrays, aligned to key-sorted order via sperm
    base_len = len(out)
    extras_flat: list = []
    need_sperm = bool(extra_groups) or (not ordered and fact_side == "left")
    sperm = (
        torch.argsort(dim_key_col.data.to(torch.int64), stable=True)
        if need_sperm else None
    )
    for _, idx, _ in extra_groups:
        c = dim_b.columns[idx]
        extras_flat.append(c.data[sperm])
        extras_flat.append(c.valid[sperm])
    pos_idx = None
    if not ordered and fact_side == "left":
        # pairs are emitted right-row-major (the reference's probe order),
        # so with the DIM side on the right the first-appearance group order
        # is the dim table's original row order
        pos_idx = base_len + len(extras_flat)
        extras_flat.append(sperm)
    keys_c, arrays_c, n_alive = _compact_nonempty(
        dim_sorted, tuple(out) + tuple(extras_flat)
    )
    n_out = int(n_alive)  # the ONLY host sync after the kernel

    # ---- build the output batch in one finalize step ---------------------
    # finalize arrays: (keys_c,) + arrays_c — arrays_c[i] is at index i+1
    A = 1
    extra_entry = {}
    for i, (_, idx, gpos) in enumerate(extra_groups):
        extra_entry[gpos] = (
            ("slice", A + base_len + 2 * i, -1, None,
             "arr", A + base_len + 2 * i + 1),
            dim_b.columns[idx].type,
        )
    spec: list = []
    col_types: list = []
    if composite:
        # decode the combined key back into its two columns (the ck meta
        # rides as the LAST finalize array)
        ck_ix = A + len(arrays_c)
        t0 = agg.types[0] if agg.types else LogicalType.BIGINT
        t1 = agg.types[1] if len(agg.types) > 1 else LogicalType.BIGINT
        spec.append(("majk", 0, ck_ix, torch_dtype_for(t0), "ones", -1))
        spec.append(("mink", 0, ck_ix, torch_dtype_for(t1), "ones", -1))
        col_types.extend([t0, t1])
        for gpos in range(2, len(agg.groups)):
            e, t = extra_entry[gpos]
            spec.append(e)
            col_types.append(t)
    else:
        for gpos in range(len(agg.groups)):
            if gpos in extra_entry:
                e, t = extra_entry[gpos]
                spec.append(e)
                col_types.append(t)
            else:  # a key position (the key may repeat among the groups)
                gtype = agg.types[gpos] if gpos < len(agg.types) else dim_key_col.type
                spec.append(("slice", 0, -1, torch_dtype_for(gtype), "ones", -1))
                col_types.append(gtype)
    cnt_ai = A + 1
    fscales_l: list[int] = [-1] * len(spec)  # group columns: no scaling
    for (kind, ix), a in zip(specs, agg.aggregates):
        rt = a.return_type()
        dt = torch_dtype_for(rt)
        fscales_l.append(
            kscales[ix]
            if kind in ("sum", "avg") and ix is not None
            and expr_float[ix] and kscales[ix] >= 0
            else -1
        )
        # an all-NULL group renders NULL sums/min/max/avg
        vop, vai = ("gt0", A + expr_vcnt[ix]) if ix in expr_vcnt else ("ones", -1)
        if kind == "sum":
            entry = ("slice", A + expr_src[ix], -1, dt, vop, vai)
        elif kind == "min":
            entry = ("slice", A + 2, -1, dt, vop, vai)
        elif kind == "max":
            entry = ("slice", A + 3, -1, dt, vop, vai)
        elif kind == "avg":
            den = A + expr_vcnt[ix] if ix in expr_vcnt else cnt_ai
            entry = ("div", A + expr_src[ix], den, dt, vop, vai)
        elif kind == "count_d":
            entry = ("slice", A + dcnt_ai, -1, dt, "ones", -1)
        elif kind == "sum_d":
            entry = ("slice", A + dsum_ai, -1, dt, vop, vai)
        elif kind == "avg_d":
            entry = ("div", A + dsum_ai, A + dcnt_ai, dt, vop, vai)
        elif kind == "count" and ix in expr_vcnt:
            # non-NULL count of a NULL-able expression
            entry = ("slice", A + expr_vcnt[ix], -1, dt, "ones", -1)
        else:  # count(all-valid v) / count_star
            entry = ("slice", cnt_ai, -1, dt, "ones", -1)
        spec.append(entry)
        col_types.append(rt)
    if ordered:
        reorder, order_ix = False, -1
    else:
        # first-appearance order: fact on the right → min probe (fact)
        # rowid; dim on the right → original dim row position
        reorder = True
        order_ix = A + 2 if fact_side == "right" else A + pos_idx
    fin_arrays = (keys_c,) + tuple(arrays_c)
    if composite:
        fin_arrays = fin_arrays + (ck_meta_dev,)
    flat = _finalize(
        fin_arrays, n_out, tuple(spec),
        reorder=reorder, order_ix=order_ix, reverse=reverse,
        fscales=tuple(fscales_l),
    )
    cols = [Column(t, flat[2 * i], flat[2 * i + 1]) for i, t in enumerate(col_types)]
    db = getattr(executor, "db", None)
    if db is not None:
        log = getattr(db, "last_fused_routes", None)
        if log is None:
            log = db.last_fused_routes = []
        log.append(
            ("order_agg_join_direct" if ordered else "agg_join_firstapp")
            + ("_dense" if dense else "")
            + ("_ck2" if composite else "")
            + ("_mxu" if used_mxu else "")
            + ("_tv" if ordered and float_tv else "")
        )
    cache.pop(id(join.children[0]), None)  # consumed — don't leak into a
    cache.pop(id(join.children[1]), None)  # later executor walk
    return DeviceBatch(_out_schema(op, agg), cols, n_out, dev)


def _out_schema(op, agg):
    from sqlrs_tpu_torch.exec.executor import _schema

    return _schema(op if op.names else agg)
