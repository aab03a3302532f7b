"""Exact grouped aggregation for small composite group domains.

The port of sqlrs_tpu/ops/mxu_grouped.py, the path that the general GROUP BY
takes when its composite key domain has at most MXU_AGG_MAX_GROUPS groups
(TPC-H Q1 is G=4). What real queries need is kept as the reference has it:

  - MULTIPLE aggregates over multiple value columns: every aggregate rides
    ONE histogram pass — a count channel, one channel per 8-bit value limb,
    one validity channel per NULL-able column.
  - DOUBLE measures via fixed-point detection: a stats pass proves every
    value is a k-dp decimal (k in {0,2,4,6}) and the scaled range fits; sums
    are then computed in EXACT integer arithmetic and divided back by 10^k.
  - SIGNED values via bias: w = scaled - bias (bias = min(scaled, 0)), so
    limbs stay non-negative; sums add back count*bias.
  - MULTI-COLUMN group keys (ints, DATE day-ints, BOOLEAN, VARCHAR dict
    codes): gid = sum((code_j - min_j) * stride_j), with a reserved NULL slot
    per NULL-able key.
  - FIRST-APPEARANCE group order (reference hash_agg.rs:85-111): the
    histogram also returns each group's first row.

The reference's kernel is a Pallas one-hot matmul for the TPU's matrix unit.
Here the histogram is `grouped_histogram`: on a CUDA tensor it launches the
hand-written kernel in csrc/mxu_grouped.cu (exact int64 totals from
warp-aggregated integer atomics into per-warp shared histograms, and the
exact first row by atomicMin, which replaces the
reference's first-block table and its (G, 2048) gather); on a CPU tensor it
runs `grouped_histogram_plain`, the same function in plain PyTorch. Nothing
falls back from one to the other.

The division that turns a scaled int64 sum back into a DOUBLE stays the
reference's (`ssum / 10.0**k`, then `/ den` for avg), so a DOUBLE result is
one IEEE division of the same exact total. The divisor is a tensor on the
data's device: PyTorch's CUDA division by a Python scalar multiplies by the
reciprocal, which is not the same rounding.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from sqlrs_tpu_torch.data import Column
from sqlrs_tpu_torch.data.batch import torch_dtype_for
from sqlrs_tpu_torch.ops.mxu_agg import mxu_backend_ok
from sqlrs_tpu_torch.types import LogicalType

MXU_AGG_MAX_GROUPS = 1024       # composite-domain cap (the reference's)
MXU_AGG_MAX_VAL_BITS = 48       # 6 limbs / 2 input words per column
MXU_AGG_MAX_CHANNELS = 32       # count + limb + validity channels
MXU_AGG_MAX_ROWS = 1 << 28      # the reference's eligibility bound, kept
                                # so that the same queries take this path
_SCALES = (0, 2, 4, 6)          # decimal scales probed by the stats pass

_INT64_MAX = 2**63 - 1
_BLOCK = 256                    # CUDA threads per block
_MAX_ROWS_PER_BLOCK = 1 << 24   # 255 * 2^24 < 2^32: no uint32 cell overflows


def _min_rows() -> int:
    """Below this many rows the general GROUP BY keeps its sorted path
    (the stats pass and its fetch do not pay off)."""
    return int(os.environ.get("SQLRS_TPU_MXU_AGG_MIN_ROWS", str(1 << 17)))


# --------------------------------------------------------------------------
# the kernel: wrapper, plain version, launch
# --------------------------------------------------------------------------


def _check_histogram_inputs(gid, words, limb_plan, n_groups: int) -> None:
    if gid.dtype != torch.int32 or gid.dim() != 1 or not gid.is_contiguous():
        raise ValueError("gid must be a contiguous 1-D int32 tensor")
    if (
        words.dtype != torch.int32
        or words.dim() != 2
        or words.shape[1] != gid.shape[0]
        or not words.is_contiguous()
    ):
        raise ValueError("words must be a contiguous int32 tensor (n_words, n)")
    if words.device != gid.device:
        raise ValueError("gid and words must be on one device")
    if not 1 <= n_groups <= MXU_AGG_MAX_GROUPS:
        raise ValueError(f"n_groups {n_groups} outside [1, {MXU_AGG_MAX_GROUPS}]")
    if 1 + len(limb_plan) > MXU_AGG_MAX_CHANNELS:
        raise ValueError(f"{1 + len(limb_plan)} channels > {MXU_AGG_MAX_CHANNELS}")
    for w, s in limb_plan:
        if not (0 <= w < words.shape[0] and 0 <= s <= 24):
            raise ValueError(f"limb ({w}, {s}) outside the words")


def grouped_histogram(gid, words, limb_plan, n_groups: int):
    """Per-group totals and first rows of one pass over the rows.

    gid int32 (n), a value outside [0, n_groups) being a miss; words int32
    (n_words, n); limb_plan a sequence of (word, shift). Returns
    totals int64 (1 + len(limb_plan), n_groups) — channel 0 counts the
    in-range rows, channel 1+i sums (words[w_i] >> s_i) & 255 over them —
    and first_row int64 (n_groups), INT64_MAX for a group with no row.

    A CUDA tensor goes to the kernel (csrc/mxu_grouped.cu), a CPU tensor to
    grouped_histogram_plain; any other device raises."""
    limb_plan = tuple((int(w), int(s)) for w, s in limb_plan)
    _check_histogram_inputs(gid, words, limb_plan, n_groups)
    if gid.device.type == "cuda":
        return _grouped_histogram_cuda(gid, words, limb_plan, n_groups)
    if gid.device.type == "cpu":
        return grouped_histogram_plain(gid, words, limb_plan, n_groups)
    raise ValueError(f"grouped_histogram has no version for {gid.device}")


grouped_histogram.launches = 0  # kernel launches, counted where they happen


def grouped_histogram_plain(gid, words, limb_plan, n_groups: int):
    """grouped_histogram in plain PyTorch: int64 index_add_ for the totals,
    scatter_reduce_ "amin" for the first rows."""
    dev = gid.device
    n = gid.shape[0]
    inr = (gid >= 0) & (gid < n_groups)
    g = torch.where(inr, gid, 0).long()
    live = inr.long()
    totals = torch.zeros(1 + len(limb_plan), n_groups, dtype=torch.int64, device=dev)
    totals[0].index_add_(0, g, live)
    for i, (w, s) in enumerate(limb_plan):
        limb = ((words[w] >> s) & 255).long() * live
        totals[1 + i].index_add_(0, g, limb)
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    first_row = torch.full((n_groups,), _INT64_MAX, dtype=torch.int64, device=dev)
    first_row.scatter_reduce_(
        0, g, torch.where(inr, rows, _INT64_MAX), reduce="amin"
    )
    return totals, first_row


def _histogram_lib():
    from sqlrs_tpu_torch.utils.cuda_build import load_kernel_library

    lib = load_kernel_library("mxu_grouped")
    fn = lib.sqlrs_grouped_histogram
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
    return fn


def _launch_grid(n: int, device) -> int:
    """Blocks for n rows: a few per SM, and enough that no block covers more
    than 2^24 rows (a thread takes 4 rows a step)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    step = 4 * _BLOCK
    grid = max(1, min(-(-n // step), 4 * sms))
    grid = max(grid, -(-n // _MAX_ROWS_PER_BLOCK))
    rows_per_block = -(-n // (grid * step)) * step
    if rows_per_block > _MAX_ROWS_PER_BLOCK:
        raise ValueError(f"{rows_per_block} rows per block > 2^24")
    return grid


def _grouped_histogram_cuda(gid, words, limb_plan, n_groups: int):
    fn = _histogram_lib()
    dev = gid.device
    n = int(gid.shape[0])
    nl = len(limb_plan)
    totals = torch.zeros(1 + nl, n_groups, dtype=torch.int64, device=dev)
    first_row = torch.full((n_groups,), _INT64_MAX, dtype=torch.int64, device=dev)
    plan_w = (ctypes.c_int * max(nl, 1))(*[w for w, _ in limb_plan])
    plan_s = (ctypes.c_int * max(nl, 1))(*[s for _, s in limb_plan])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            gid.data_ptr(), words.data_ptr(), n, int(words.shape[0]),
            plan_w, plan_s, nl, n_groups, totals.data_ptr(), first_row.data_ptr(),
            _launch_grid(n, dev), _BLOCK, stream,
        )
    if err != 0:
        raise RuntimeError(f"grouped_histogram kernel launch failed: cudaError {err}")
    grouped_histogram.launches += 1
    return totals, first_row


# --------------------------------------------------------------------------
# stats pass: one host fetch
# --------------------------------------------------------------------------


def _live_mask(alive, n: int, device):
    if alive is None:
        return torch.ones(n, dtype=torch.bool, device=device)
    if isinstance(alive, tuple):
        return torch.logical_and(alive[0], alive[1])
    return alive


def _agg_stats(kdatas, kvalids, alive, vdatas, vvalids):
    """Per key column [min, max, any_null] over (valid & alive) rows, int64;
    per value column [any_null, vmin, vmax, integral@10^0, @10^2, @10^4,
    @10^6] over (valid & alive) rows, float64. Two small vectors, fetched
    together. Key stats stay int64 (codes can exceed 2^53); value stats are
    f64 (the path guards |scaled| < 2^48 anyway)."""
    first = kdatas[0] if kdatas else vdatas[0]
    n, dev = first.shape[0], first.device
    live = _live_mask(alive, n, dev)
    big = _INT64_MAX
    kparts = [live.sum(dtype=torch.int64)]  # live-row count
    for d, v in zip(kdatas, kvalids):
        ok = v & live
        d64 = d.to(torch.int64)
        kparts.append(torch.where(ok, d64, big).min())
        kparts.append(torch.where(ok, d64, -big).max())
        kparts.append((live & ~v).any().to(torch.int64))
    vparts = []
    for d, v in zip(vdatas, vvalids):
        ok = v & live
        f = d.to(torch.float64)
        vparts.append((live & ~v).any().to(torch.float64))
        vparts.append(torch.where(ok, f, float("inf")).min())
        vparts.append(torch.where(ok, f, float("-inf")).max())
        for k in _SCALES:
            s = f * (10.0 ** k)
            fr = torch.abs(s - torch.round(s))
            # a k-dp decimal COMPUTED in doubles (e.g. the product of three
            # 2dp columns) carries representation error ~|s|*c*2^-52, so the
            # integrality test is relative (the reference's reasoning holds
            # unchanged: the 2^46 cap keeps round() exact and the test
            # selective)
            row_ok = fr <= (1e-5 + torch.abs(s) * 1e-12)
            allok = torch.where(ok, row_ok, True).all()
            mag = torch.where(ok, torch.abs(s), 0.0).max()
            vparts.append((allok & (mag < float(1 << 46))).to(torch.float64))
    kvec = torch.stack(kparts).cpu().numpy()
    vvec = (
        torch.stack(vparts).cpu().numpy() if vparts else np.zeros(0, np.float64)
    )
    return kvec, vvec


# --------------------------------------------------------------------------
# phase A: gid + words + histogram + ordered decode
# --------------------------------------------------------------------------


def _mxu_agg_phase_a(
    kdatas, kvalids, alive, vdatas, vvalids, kmins, biases,
    key_plan, val_plan, spec, n_groups: int,
):
    """key_plan: per key (span_eff, has_null, torch dtype); val_plan: per
    value column (n_limbs, has_null, scale_k); spec: per aggregate (op,
    col_ix, out dtype, is_float_sum) with op in {count_star, count, sum,
    avg}. Returns first-appearance-ordered G-sized outputs + n_nonempty."""
    first = kdatas[0] if kdatas else vdatas[0]
    n, dev = first.shape[0], first.device
    live = _live_mask(alive, n, dev)

    # ---- composite gid (row-major over key columns) ----------------------
    gid = torch.zeros(n, dtype=torch.int64, device=dev)
    for j, (span_eff, _has_null, _kind) in enumerate(key_plan):
        d64 = kdatas[j].to(torch.int64) - kmins[j]
        slot = torch.where(kvalids[j], d64, span_eff - 1)
        gid = gid * span_eff + slot
    gid = torch.where(live, gid, -1)
    k32 = gid.to(torch.int32)

    # ---- value words: scaled, biased, NULL-masked ------------------------
    words: list = []
    word_of_col: list[tuple[int, int]] = []  # (first word ix, n_words)
    for i, (n_limbs, _has_null, k) in enumerate(val_plan):
        d = vdatas[i]
        if d.is_floating_point():
            s = torch.round(d.to(torch.float64) * (10.0 ** k)).to(torch.int64)
        else:
            s = d.to(torch.int64)
        w = s - biases[i]
        w = torch.where(vvalids[i] & live, w, 0)
        nw = -(-n_limbs * 8 // 24)
        word_of_col.append((len(words), nw))
        for wi in range(nw):
            words.append(((w >> (24 * wi)) & 0xFFFFFF).to(torch.int32))
    # validity channels (0/1 words) for NULL-able value columns
    vword_of_col: dict[int, int] = {}
    for i, (_nl, has_null, _k) in enumerate(val_plan):
        if has_null:
            vword_of_col[i] = len(words)
            words.append((vvalids[i] & live).to(torch.int32))

    # ---- channel layout --------------------------------------------------
    limb_plan: list[tuple[int, int]] = []
    chan_of_col: list[int] = []
    for i, (n_limbs, _hn, _k) in enumerate(val_plan):
        chan_of_col.append(1 + len(limb_plan))
        w0, _nw = word_of_col[i]
        for j in range(n_limbs):
            limb_plan.append((w0 + j // 3, (j % 3) * 8))
    vchan_of_col: dict[int, int] = {}
    for i, wix in vword_of_col.items():
        vchan_of_col[i] = 1 + len(limb_plan)
        limb_plan.append((wix, 0))

    word_mat = (
        torch.stack(words)
        if words
        else torch.zeros((0, n), dtype=torch.int32, device=dev)
    )
    chans, first_row = grouped_histogram(k32, word_mat, limb_plan, n_groups)
    counts = chans[0]
    nonempty = counts > 0
    n_out = int(nonempty.sum())

    # ---- first-appearance order + decode, all at G size ------------------
    order = torch.argsort(first_row, stable=True)        # nonempty first
    ogid = order

    gdata, gvalid = [], []
    strides: list[int] = []
    s = 1
    for span_eff, _hn, _kind in reversed(key_plan):
        strides.append(s)
        s *= span_eff
    strides.reverse()
    for j, (span_eff, has_null, kind) in enumerate(key_plan):
        slot = (ogid // strides[j]) % span_eff
        code = slot + kmins[j]
        if has_null:
            gvalid.append(slot != (span_eff - 1))
        else:
            gvalid.append(torch.ones(n_groups, dtype=torch.bool, device=dev))
        gdata.append(code.to(kind))

    ocounts = counts[order]
    adata, avalid = [], []
    ones = torch.ones(n_groups, dtype=torch.bool, device=dev)
    for op, ci, out_dt, is_float_sum in spec:
        if op == "count_star":
            adata.append(ocounts)
            avalid.append(ones)
            continue
        nl, has_null, k = val_plan[ci]
        vcnt = chans[vchan_of_col[ci]][order] if has_null else ocounts
        if op == "count":
            adata.append(vcnt)
            avalid.append(ones)
            continue
        base = chan_of_col[ci]
        ssum = torch.zeros(n_groups, dtype=torch.int64, device=dev)
        for j in range(nl):
            ssum = ssum + (chans[base + j] << (8 * j))
        ssum = ssum[order] + vcnt * biases[ci]           # un-bias
        # a fill on the device: no host-to-device copy, so no sync
        scale = torch.full((), 10.0 ** k, dtype=torch.float64, device=dev)
        if op == "sum":
            if is_float_sum:
                out = ssum.to(torch.float64) / scale
            else:
                out = ssum.to(out_dt)
            adata.append(out)
            avalid.append(vcnt > 0)
            continue
        # avg
        den = torch.clamp(vcnt, min=1).to(torch.float64)
        out = ssum.to(torch.float64) / scale / den
        adata.append(out)
        avalid.append(vcnt > 0)
    return gdata, gvalid, adata, avalid, n_out


# --------------------------------------------------------------------------
# the executor-facing entry
# --------------------------------------------------------------------------

_KEY_KINDS = {
    LogicalType.TINYINT, LogicalType.SMALLINT, LogicalType.INTEGER,
    LogicalType.BIGINT, LogicalType.DATE, LogicalType.BOOLEAN,
    LogicalType.VARCHAR,
}


def mxu_grouped_aggregate(key_cols, agg_specs, alive=None):
    """Try the exact histogram path for a general GROUP BY; returns
    (group_cols, agg_cols, n_groups) or None when ineligible. agg_specs
    entries: (name, Column|None, result_type [, distinct]) — the reference's
    contract. As there, it returns None below SQLRS_TPU_MXU_AGG_MIN_ROWS
    rows (default 2^17) and off the backend that ops/mxu_agg.mxu_backend_ok
    admits, and the caller takes the sorted path (ops/grouped_agg.py)."""
    if not key_cols or not mxu_backend_ok(key_cols[0].data.device):
        return None
    n = len(key_cols[0])
    if n < max(_min_rows(), 1) or n >= MXU_AGG_MAX_ROWS:
        return None
    if any(c.type not in _KEY_KINDS for c in key_cols):
        return None
    # aggregates: sum/count/avg only (min/max need an order a histogram
    # cannot give; DISTINCT needs dedup) over int/double arguments
    specs4 = [
        (s[0], s[1], s[2], bool(s[3]) if len(s) > 3 else False)
        for s in agg_specs
    ]
    val_cols: list = []
    col_ix: dict[int, int] = {}
    entries: list[tuple[str, int | None]] = []
    for name, col, rt, distinct in specs4:
        if distinct:
            return None
        if col is None:
            if name != "count":
                return None
            entries.append(("count_star", None))
            continue
        if name not in ("sum", "avg", "count"):
            return None
        t = col.type
        if name in ("sum", "avg"):
            if not (
                t.is_float()
                or (t.is_integral() and t not in (
                    LogicalType.DATE, LogicalType.INTERVAL,
                    LogicalType.BOOLEAN,
                ))
            ):
                return None
        if id(col) not in col_ix:
            col_ix[id(col)] = len(val_cols)
            val_cols.append(col)
        entries.append((name, col_ix[id(col)]))

    # columns only referenced by count() need no limbs — mark them
    needs_limbs = [False] * len(val_cols)
    for name, ci in entries:
        if name in ("sum", "avg"):
            needs_limbs[ci] = True

    # ---- stats pass + ONE fetch ------------------------------------------
    kvec, vvec = _agg_stats(
        [c.data for c in key_cols],
        [c.valid for c in key_cols],
        alive,
        [c.data for c in val_cols],
        [c.valid for c in val_cols],
    )
    n_live = int(kvec[0])
    if n_live == 0:
        return None  # empty after the mask

    key_plan: list = []
    kmins: list[int] = []
    g_total = 1
    for j, c in enumerate(key_cols):
        kmin, kmax, anyn = (
            int(kvec[1 + 3 * j]), int(kvec[2 + 3 * j]), int(kvec[3 + 3 * j])
        )
        if kmin > kmax:  # all-NULL key column
            span = 0
            kmin = 0
        else:
            span = kmax - kmin + 1
        span_eff = span + (1 if anyn else 0)
        if span_eff <= 0 or span_eff > MXU_AGG_MAX_GROUPS:
            return None
        key_plan.append((span_eff, bool(anyn), torch_dtype_for(c.type)))
        kmins.append(kmin)
        g_total *= span_eff
        if g_total > MXU_AGG_MAX_GROUPS:
            return None

    val_plan: list = []
    biases: list[int] = []
    for i, c in enumerate(val_cols):
        base = 7 * i
        anyn = bool(vvec[base])
        vmin, vmax = float(vvec[base + 1]), float(vvec[base + 2])
        if not needs_limbs[i]:
            val_plan.append((0, anyn, 0))
            biases.append(0)
            continue
        if not np.isfinite(vmin) or not np.isfinite(vmax):
            if vmin > vmax:  # all-NULL value column: zero limbs suffice
                val_plan.append((0, True, 0))
                biases.append(0)
                continue
            return None
        k_ok = None
        for kk, k in enumerate(_SCALES):
            if vvec[base + 3 + kk] > 0:
                k_ok = k
                break
        if k_ok is None:
            return None  # not a k-dp decimal
        smin = int(round(vmin * (10.0 ** k_ok)))
        smax = int(round(vmax * (10.0 ** k_ok)))
        bias = min(smin, 0)
        vb = max((smax - bias).bit_length(), 1)
        if vb > MXU_AGG_MAX_VAL_BITS:
            return None
        if (smax - bias) * n >= (1 << 62):
            return None  # int64 assembly guard
        val_plan.append((-(-vb // 8), anyn, k_ok))
        biases.append(bias)

    nch = 1 + sum(p[0] for p in val_plan) + sum(
        1 for p in val_plan if p[1]
    )
    if nch > MXU_AGG_MAX_CHANNELS:
        return None

    spec = []
    for (name, ci), (_sname, _c, rt, _d) in zip(entries, specs4):
        if name == "count_star":
            spec.append(("count_star", -1, torch.int64, False))
            continue
        is_float = val_cols[ci].type.is_float() or val_plan[ci][2] > 0
        spec.append((name, ci, torch_dtype_for(rt), is_float))

    gdata, gvalid, adata, avalid, n_groups = _mxu_agg_phase_a(
        [c.data for c in key_cols],
        [c.valid for c in key_cols],
        alive,
        [c.data for c in val_cols],
        [c.valid for c in val_cols],
        kmins,
        biases,
        key_plan,
        val_plan,
        spec,
        g_total,
    )
    group_cols = [
        Column(c.type, d[:n_groups], v[:n_groups])
        for c, d, v in zip(key_cols, gdata, gvalid)
    ]
    agg_cols = []
    for (_sname, _c, rt, _d), d, v in zip(specs4, adata, avalid):
        dt = torch_dtype_for(rt)
        agg_cols.append(Column(rt, d[:n_groups].to(dt), v[:n_groups]))
    return group_cols, agg_cols, n_groups
