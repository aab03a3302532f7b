"""sqlrs_tpu_torch/ops/pipelines.py against sqlrs_tpu/ops/pipelines.py: the
star rollup's packed-sort pipelines and their rank stage, on the same numpy
inputs made from a seed, and against numpy oracles.

Integer outputs must be identical; float64 payload sums agree to rel 1e-12
(prefix sums are taken in another order). The cases mirror
tests/test_kernels.py's pipeline tests: int32 and int64 packing, dense,
shared and general boundaries, misses on both sides of the dim span, prime
n (block padding), negative keys, and the with_minmax, with_distinct,
null_ix, tv and firstapp layouts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sqlrs_tpu  # noqa: F401  (x64 on before the reference's arrays)
import sqlrs_tpu_torch
from sqlrs_tpu.ops import pipelines as ref
from sqlrs_tpu_torch.ops import pipelines as port


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _j(a):
    return jnp.asarray(a)


def _same_outputs(ref_out, port_out, rel=1e-12):
    assert len(ref_out) == len(port_out)
    for i, (r, p) in enumerate(zip(ref_out, port_out)):
        r, p = np.asarray(r), p.numpy()
        if r.dtype.kind == "f":
            assert p.dtype == np.float64
            np.testing.assert_allclose(p, r, rtol=rel, atol=0, err_msg=f"output {i}")
        else:
            assert p.dtype == r.dtype, (i, p.dtype, r.dtype)
            assert np.array_equal(p, r), f"output {i}"


def _star(seed, n, g, kind, vb=7, shared_ok=False):
    """fact keys drawn from the dim keys with misses below and above the
    span (and inside it, unless the case shares boundaries), values in
    [0, 2^vb - 1) (the sentinel stays free)."""
    rng = np.random.default_rng(seed)
    if kind == "dense":
        dim = np.arange(g, dtype=np.int64) + 50
    elif kind == "negative":
        dim = np.arange(g, dtype=np.int64) * 977 - 3000
    else:
        dim = np.arange(g, dtype=np.int64) * 13 + 5
    gid = rng.integers(0, g, n)
    fk = dim[gid].copy()
    fk[::11] = dim.min() - 4
    fk[5::13] = dim.max() + 9
    if kind == "sparse" and not shared_ok:
        fk[7::17] = dim[0] + 1          # a miss between two dim keys
    fv = rng.integers(0, (1 << vb) - 1, n).astype(np.int64)
    perm = rng.permutation(g)
    dim_rows = dim[perm]                 # dim table in its own row order
    return rng, fk, fv, dim_rows


def _sorted_dim(dim_rows):
    order = np.argsort(dim_rows, kind="stable")
    return dim_rows[order], order.astype(np.int64)


def _numpy_direct(fk, fv, dim_rows, valid=None):
    sums = np.zeros(len(dim_rows), np.int64)
    counts = np.zeros(len(dim_rows), np.int64)
    pos = {int(k): i for i, k in enumerate(dim_rows)}
    for i, (k, v) in enumerate(zip(fk.tolist(), fv.tolist())):
        j = pos.get(k)
        if j is not None:
            counts[j] += 1
            if valid is None or valid[i]:
                sums[j] += v
    return sums, counts


def test_f64_orderable_round_trip():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(0, 1e6, 500), rng.uniform(-1, 1, 500) * 1e-300,
        [0.0, -0.0, np.inf, -np.inf, 5e-324, -5e-324, 1.5, -1.5],
    ])
    t_ref = np.asarray(ref.f64_orderable(_j(x)))
    t_port = port.f64_orderable(_t(x))
    assert np.array_equal(t_port.numpy(), t_ref)
    order = np.argsort(t_ref, kind="stable")
    assert np.all(np.diff(x[order]) >= 0)
    back = port.f64_from_orderable(t_port).numpy()
    assert np.array_equal(back.view(np.int64), x.view(np.int64))
    assert np.array_equal(back, np.asarray(ref.f64_from_orderable(_j(t_ref))))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("nq", [1, 129, 1000])
def test_sorted_ranks_left(dtype, nq):
    rng = np.random.default_rng(nq)
    nb = 37
    sp = np.sort(rng.integers(-5000, 5000, nb * 128)).astype(dtype)
    sp[:200] = sp[200]                   # a long run across block boundaries
    # queries below and above every element, on block minima and in runs
    q = np.concatenate([
        [sp.min() - 1, sp.max() + 1, sp[0], sp[128], sp[-1]],
        rng.integers(-6000, 6000, max(nq - 5, 0)),
    ])[:nq].astype(dtype)
    sp2d = sp.reshape(nb, 128)
    got = port._sorted_ranks_left(_t(sp2d), _t(q)).numpy()
    assert np.array_equal(got, np.searchsorted(sp, q, side="left"))
    assert np.array_equal(got, np.asarray(ref._sorted_ranks_left(_j(sp2d), _j(q))))


@pytest.mark.parametrize("vb", [3, 7])
def test_ranks_and_value_prefix(vb):
    rng = np.random.default_rng(vb)
    nb = 20
    keys = np.sort(rng.integers(0, 300, nb * 128))
    vals = rng.integers(0, 1 << vb, nb * 128)
    sp = np.sort((keys << vb) | vals).astype(np.int64)
    sp2d = sp.reshape(nb, 128)
    vmask = (1 << vb) - 1
    bs = (sp2d & vmask).sum(1)
    bp = np.cumsum(bs) - bs
    q = (np.arange(-2, 303, dtype=np.int64)) << vb
    r_rank, r_pref = ref._ranks_and_value_prefix(_j(sp2d), _j(q), vmask, _j(bp))
    p_rank, p_pref = port._ranks_and_value_prefix(_t(sp2d), _t(q), vmask, _t(bp))
    assert np.array_equal(p_rank.numpy(), np.asarray(r_rank))
    assert np.array_equal(p_pref.numpy(), np.asarray(r_pref))
    rank = np.searchsorted(sp, q, side="left")
    assert np.array_equal(p_rank.numpy(), rank)
    csum = np.concatenate([[0], np.cumsum(sp & vmask)])
    assert np.array_equal(p_pref.numpy(), csum[rank])


# (kind, pack32, mode): mode "dense" / "shared" / "general" boundaries
DIRECT_CASES = [
    ("dense", True, "dense"),
    ("dense", False, "dense"),
    ("sparse", True, "general"),
    ("sparse", False, "general"),
    ("sparse", False, "shared"),
    ("negative", False, "general"),
    ("negative", True, "shared"),
]


@pytest.mark.parametrize("kind,pack32,mode", DIRECT_CASES)
def test_join_groupby_direct_sum_count(kind, pack32, mode):
    n, g = 9_973, 64  # prime n: block padding
    _, fk, fv, dim_rows = _star(3, n, g, kind, shared_ok=mode == "shared")
    ds, perm = _sorted_dim(dim_rows)
    kw = dict(dense=mode == "dense", shared=mode == "shared")
    r = ref.join_groupby_direct(_j(fk), _j(fv), _j(ds), _j(perm), g, 7, pack32, **kw)
    p = port.join_groupby_direct(_t(fk), _t(fv), _t(ds), _t(perm), g, 7, pack32, **kw)
    _same_outputs(r, p)
    exp_s, exp_c = _numpy_direct(fk, fv, dim_rows)
    assert np.array_equal(p[0].numpy(), exp_s)
    assert np.array_equal(p[1].numpy(), exp_c)


@pytest.mark.parametrize("kind,pack32,mode", [
    ("dense", True, "dense"), ("sparse", False, "general"), ("negative", True, "shared"),
])
def test_join_groupby_direct_layouts(kind, pack32, mode):
    """with_minmax + with_distinct + int32/int64/float64 payloads, then the
    same in sentinel (null_ix) mode with a NULL-able packed column."""
    n, g = 5_003, 40
    rng, fk, fv, dim_rows = _star(5, n, g, kind, vb=5, shared_ok=mode == "shared")
    ds, perm = _sorted_dim(dim_rows)
    kw = dict(dense=mode == "dense", shared=mode == "shared",
              with_minmax=True, with_distinct=True)
    p32 = rng.integers(-70, 70, n).astype(np.int32)
    p64 = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
    pf = rng.uniform(1.0, 1000.0, n)
    extra = (p32, p64, pf)
    r = ref.join_groupby_direct(_j(fk), _j(fv), _j(ds), _j(perm), g, 5, pack32,
                                extra_vals=tuple(map(_j, extra)), **kw)
    p = port.join_groupby_direct(_t(fk), _t(fv), _t(ds), _t(perm), g, 5, pack32,
                                 extra_vals=tuple(map(_t, extra)), **kw)
    _same_outputs(r, p)
    # sentinel mode: NULL packed values masked to vmask, validity payload
    valid = rng.random(n) > 0.2
    fvm = np.where(valid, fv, (1 << 5) - 1)
    extra = (p32, valid.astype(np.int32))
    r = ref.join_groupby_direct(_j(fk), _j(fvm), _j(ds), _j(perm), g, 5, pack32,
                                extra_vals=tuple(map(_j, extra)), null_ix=1, **kw)
    p = port.join_groupby_direct(_t(fk), _t(fvm), _t(ds), _t(perm), g, 5, pack32,
                                 extra_vals=tuple(map(_t, extra)), null_ix=1, **kw)
    _same_outputs(r, p)
    exp_s, exp_c = _numpy_direct(fk, fv, dim_rows, valid)
    assert np.array_equal(p[0].numpy(), exp_s)
    assert np.array_equal(p[1].numpy(), exp_c)


@pytest.mark.parametrize("pack32,dense,nullable", [
    (True, True, False), (False, False, True), (True, False, True),
])
def test_join_groupby_minmax_tv(pack32, dense, nullable):
    n, g = 4_001, 30
    rng, fk, _, dim_rows = _star(7, n, g, "dense" if dense else "sparse")
    ds, perm = _sorted_dim(dim_rows)
    x = rng.normal(0, 1e3, n)
    x[::5] = -0.0
    tv = np.asarray(ref.f64_orderable(_j(x)))
    extra = (rng.integers(-9, 9, n).astype(np.int32),)
    null_ix = -1
    if nullable:
        valid = rng.random(n) > 0.25
        tv = np.where(valid, tv, np.iinfo(np.int64).max)
        x = np.where(valid, x, 0.0)
        extra = extra + (valid.astype(np.int32),)
        null_ix = 1
    r = ref.join_groupby_minmax_tv(_j(fk), _j(x), _j(tv), _j(ds), _j(perm), g,
                                   pack32, dense=dense, extra_vals=tuple(map(_j, extra)),
                                   null_ix=null_ix)
    p = port.join_groupby_minmax_tv(_t(fk), _t(x), _t(tv), _t(ds), _t(perm), g,
                                    pack32, dense=dense, extra_vals=tuple(map(_t, extra)),
                                    null_ix=null_ix)
    _same_outputs(r, p)


@pytest.mark.parametrize("kind,dense", [("dense", True), ("sparse", False), ("negative", False)])
def test_join_groupby_firstapp(kind, dense):
    n, g = 6_007, 48
    rng, fk, fv, dim_rows = _star(9, n, g, kind)
    ds, perm = _sorted_dim(dim_rows)
    vals = (fv.astype(np.int32), rng.integers(-(1 << 35), 1 << 35, n),
            rng.uniform(1.0, 50.0, n))
    rid_bits = max(n.bit_length(), 1)
    r = ref.join_groupby_firstapp(_j(fk), tuple(map(_j, vals)), _j(ds), _j(perm), g,
                                  rid_bits, dense=dense)
    p = port.join_groupby_firstapp(_t(fk), tuple(map(_t, vals)), _t(ds), _t(perm), g,
                                   rid_bits, dense=dense)
    _same_outputs(r, p)
    pos = {int(k): i for i, k in enumerate(dim_rows)}
    first = np.full(g, -1)
    for i, k in enumerate(fk.tolist()):
        j = pos.get(k)
        if j is not None and first[j] < 0:
            first[j] = i
    hit = first >= 0
    assert np.array_equal(p[2].numpy()[hit], first[hit])


def test_make_join_groupby_direct_with_catalog_metadata(monkeypatch):
    """make_join_groupby('direct'): the packing and the dense variant chosen
    from host metadata, and the dense-group kernel when eligible
    (SQLRS_TPU_MXU=interpret, as the reference's CPU tests select it)."""
    n, g, base = 10_007, 96, 50
    rng = np.random.default_rng(13)
    gid = rng.integers(0, g, n)
    dim = np.arange(g, dtype=np.int64) + base
    fk = dim[gid].copy()
    fk[::7] = 3                          # misses below the dim span
    fk[5::13] = base + g + 9             # misses above it
    fv = rng.integers(0, 100, n).astype(np.int64)
    m = (fk >= base) & (fk < base + g)
    exp_s, exp_c = np.zeros(g, np.int64), np.zeros(g, np.int64)
    np.add.at(exp_s, gid[m], fv[m])
    np.add.at(exp_c, gid[m], 1)
    shuffled = rng.permutation(g)
    dk = dim[shuffled]
    fn_r, fn_p = ref.make_join_groupby(g), port.make_join_groupby(g)
    for mode in ("0", "interpret"):
        monkeypatch.setenv("SQLRS_TPU_MXU", mode)
        for kw in (
            dict(val_bits=7, pack32=False),
            dict(val_bits=7, pack32=True),
            dict(val_bits=7, pack32=True, dim_min=base, dim_max=base + g - 1),
            dict(key_max=int(fk.max()), val_max=99, dim_min=base, dim_max=base + g - 1),
        ):
            r = fn_r(_j(fk), _j(fv), _j(dk), **kw)
            p = fn_p(_t(fk), _t(fv), _t(dk), **kw)
            _same_outputs(r, p)
            assert np.array_equal(p[0].numpy(), exp_s[shuffled]), (mode, kw)
            assert np.array_equal(p[1].numpy(), exp_c[shuffled]), (mode, kw)
    # FK-complete sparse dims share boundaries: every fact key matches
    sparse = np.arange(g, dtype=np.int64) * 1013904223 + 12345
    fk2 = sparse[gid]
    r = fn_r(_j(fk2), _j(fv), _j(sparse), fk_complete=True)
    p = fn_p(_t(fk2), _t(fv), _t(sparse), fk_complete=True)
    _same_outputs(r, p)
    # the comparison strategies on the same inputs: each equals the
    # reference's strategy and numpy (tests/test_kernels.py's packed case)
    for strategy, kw in (("hash", {}), ("sorted", {}), ("sorted_packed", {"val_bits": 8})):
        r = ref.make_join_groupby(g, strategy=strategy)(_j(fk), _j(fv), _j(dk), **kw)
        p = port.make_join_groupby(g, strategy=strategy)(_t(fk), _t(fv), _t(dk), **kw)
        _same_outputs(r, p)
        assert np.array_equal(p[0].numpy(), exp_s[shuffled]), strategy
        assert np.array_equal(p[1].numpy(), exp_c[shuffled]), strategy


@pytest.mark.parametrize("strategy", ["hash", "sorted", "sorted_packed"])
@pytest.mark.parametrize("kind", ["sparse", "negative"])
def test_make_join_groupby_comparison_strategies(strategy, kind):
    """'hash', 'sorted' and 'sorted_packed' against the reference's, exactly
    (tests/test_kernels.py:124-130): misses inside and outside the dim span,
    a shuffled dim table, a prime row count."""
    n, g = 6_007, 300
    _rng, fk, fv, dk = _star(41, n, g, kind)
    if kind == "negative" and strategy == "sorted_packed":
        shift = -int(fk.min())               # the packed sort needs keys >= 0
        fk, dk = fk + shift, dk + shift
    kw = {"val_bits": 8} if strategy == "sorted_packed" else {}
    r = ref.make_join_groupby(g, strategy=strategy)(_j(fk), _j(fv), _j(dk), **kw)
    p = port.make_join_groupby(g, strategy=strategy)(_t(fk), _t(fv), _t(dk), **kw)
    _same_outputs(r, p)
    pos = {int(k): i for i, k in enumerate(dk)}
    exp_s, exp_c = np.zeros(g, np.int64), np.zeros(g, np.int64)
    for k, v in zip(fk.tolist(), fv.tolist()):
        if k in pos:
            exp_s[pos[k]] += v
            exp_c[pos[k]] += 1
    assert np.array_equal(p[0].numpy(), exp_s) and np.array_equal(p[1].numpy(), exp_c)


@pytest.mark.parametrize("run_capacity", [16, 64, 1024])
def test_join_groupby_sorted_run_overflow(run_capacity):
    """n_runs past run_capacity: the same undercounted sums and counts and
    the same int32 n_runs as the reference, plain and packed."""
    n, g = 4_001, 200
    _rng, fk, fv, dim_rows = _star(43, n, g, "dense")
    dim_sorted, order = _sorted_dim(dim_rows)
    args_r = (_j(fk), _j(fv), _j(dim_sorted), _j(order), g, run_capacity)
    args_p = (_t(fk), _t(fv), _t(dim_sorted), _t(order), g, run_capacity)
    _same_outputs(ref.join_groupby_sorted(*args_r), port.join_groupby_sorted(*args_p))
    _same_outputs(ref.join_groupby_sorted_packed(*args_r, 8),
                  port.join_groupby_sorted_packed(*args_p, 8))


# tests/test_kernels.py's pipeline tests on their own inputs (seeds, sizes,
# dim keys), each against the reference's strategy and its numpy oracle


def _gid_oracle(gid, fv, groups, m=None):
    m = np.ones(len(gid), bool) if m is None else m
    s, c = np.zeros(groups, np.int64), np.zeros(groups, np.int64)
    np.add.at(s, gid[m], fv[m])
    np.add.at(c, gid[m], 1)
    return s, c


def test_fused_join_groupby_pipeline():
    rng = np.random.default_rng(3)
    n, groups = 50_000, 128
    gid = rng.integers(0, groups, n)
    dim_keys = np.arange(groups, dtype=np.int64) * 13 + 5
    fk = dim_keys[gid]
    fv = rng.integers(0, 50, n).astype(np.int64)
    r = ref.make_join_groupby(groups)(_j(fk), _j(fv), _j(dim_keys))
    p = port.make_join_groupby(groups)(_t(fk), _t(fv), _t(dim_keys))
    _same_outputs(r, p)
    es, ec = _gid_oracle(gid, fv, groups)
    assert np.array_equal(p[0].numpy(), es) and np.array_equal(p[1].numpy(), ec)


def test_packed_pipeline_matches_plain():
    rng = np.random.default_rng(9)
    n, groups = 60_000, 300
    gid = rng.integers(0, groups, n)
    dim_keys = np.arange(groups, dtype=np.int64) * 977 + 11
    fk, fv = dim_keys[gid], rng.integers(0, 128, n).astype(np.int64)
    base = port.make_join_groupby(groups, strategy="sorted")(_t(fk), _t(fv), _t(dim_keys))
    for strategy, args in (("sorted_packed", {"val_bits": 8}),
                           ("direct", {"val_bits": 8, "pack32": False}),
                           ("direct", {"val_bits": 8, "pack32": True})):
        r = ref.make_join_groupby(groups, strategy=strategy)(_j(fk), _j(fv), _j(dim_keys), **args)
        p = port.make_join_groupby(groups, strategy=strategy)(_t(fk), _t(fv), _t(dim_keys), **args)
        _same_outputs(r, p)
        assert np.array_equal(p[0].numpy(), base[0].numpy()), (strategy, args)
        assert np.array_equal(p[1].numpy(), base[1].numpy()), (strategy, args)
    es, ec = _gid_oracle(gid, fv, groups)
    assert np.array_equal(base[0].numpy(), es) and np.array_equal(base[1].numpy(), ec)


def test_direct_pipeline_misses_and_odd_sizes():
    rng = np.random.default_rng(11)
    n, groups = 9_973, 64  # prime n: block padding
    gid = rng.integers(0, groups, n)
    dim_keys = np.arange(groups, dtype=np.int64) * 1013904223 + 12345
    fk = dim_keys[gid].copy()
    fk[::11] = 7  # misses
    fv = rng.integers(0, 100, n).astype(np.int64)
    r = ref.make_join_groupby(groups, strategy="direct")(_j(fk), _j(fv), _j(dim_keys))
    p = port.make_join_groupby(groups, strategy="direct")(_t(fk), _t(fv), _t(dim_keys))
    _same_outputs(r, p)
    es, ec = _gid_oracle(gid, fv, groups, fk != 7)
    assert np.array_equal(p[0].numpy(), es) and np.array_equal(p[1].numpy(), ec)


def test_direct_pipeline_dense_boundary_sharing():
    rng = np.random.default_rng(13)
    n, groups, base = 10_007, 96, 50
    gid = rng.integers(0, groups, n)
    dim_keys = np.arange(groups, dtype=np.int64) + base
    fk = dim_keys[gid].copy()
    fk[::7] = 3
    fk[5::13] = base + groups + 9
    fv = rng.integers(0, 100, n).astype(np.int64)
    es, ec = _gid_oracle(gid, fv, groups, (fk >= base) & (fk < base + groups))
    fn_r = ref.make_join_groupby(groups, strategy="direct")
    fn_p = port.make_join_groupby(groups, strategy="direct")
    for pack32 in (False, True):
        for span in ({"dim_min": base, "dim_max": base + groups - 1}, {}):
            kw = dict(val_bits=7, pack32=pack32, **span)
            r = fn_r(_j(fk), _j(fv), _j(dim_keys), **kw)
            p = fn_p(_t(fk), _t(fv), _t(dim_keys), **kw)
            _same_outputs(r, p)
            assert np.array_equal(p[0].numpy(), es) and np.array_equal(p[1].numpy(), ec), kw
