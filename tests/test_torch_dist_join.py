"""The sharded engine's join operators (sqlrs_tpu_torch/parallel/
dist_join.py) over 8 shards on the CPU, the JAX conftest's 8 virtual
devices, on inputs made from numpy seeds.

`shuffle_join_phase_a` is held once to the reference's shard_map program
on the 8-device CPU mesh (about 20 s to compile): the same rows on the
same shards, read through `addressable_shards`, the same match ranges and
the same overflow, hot-bucket count and m. Everything else is held to
numpy: the ring-staged probe exchange against the monolithic one bit for
bit, phase B's pairs and their order, `ring_agg_join` and
`broadcast_agg_join` per dim row, and `pair_local_dedup`.
"""

import numpy as np
import pytest
import torch

import sqlrs_tpu  # noqa: F401  (x64)
import jax
import jax.numpy as jnp

from sqlrs_tpu.parallel import dist_join as ref_join
from sqlrs_tpu.parallel.mesh import make_mesh as ref_make_mesh
from sqlrs_tpu.parallel.mesh import row_sharding
from sqlrs_tpu_torch.parallel import dist_join
from sqlrs_tpu_torch.parallel.mesh import live_blocks, make_mesh, row_blocks, shard_positions

N_DEV = 8
I64_MAX = np.iinfo(np.int64).max


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(N_DEV, devices=["cpu"] * N_DEV)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _blocks(mesh, x):
    return row_blocks(mesh, _t(x))


def _shards(x) -> list:
    blocks = sorted(x.addressable_shards, key=lambda s: s.index[0].start or 0)
    return [np.asarray(s.data) for s in blocks]


def _join_inputs(seed=11, n=4096):
    """tests/test_distributed.py's ring case: duplicate build keys, probe
    misses, a hot probe key, NULL build keys."""
    rng = np.random.default_rng(seed)
    bkeys = rng.integers(0, 500, n).astype(np.int64)
    pkeys = rng.integers(0, 700, n).astype(np.int64)
    pkeys[::5] = 3
    bpay = rng.integers(-50, 50, n).astype(np.int64)
    bval = np.ones(n, np.bool_)
    bval[::17] = False
    return bkeys, pkeys, bpay, bval


def _phase_a(mesh, bkeys, pkeys, bpay, bval, ring=False, **kw):
    n_b, n_p = len(bkeys), len(pkeys)
    return dist_join.shuffle_join_phase_a(
        mesh,
        [(_blocks(mesh, bkeys), _blocks(mesh, bval))], [_blocks(mesh, bpay)],
        shard_positions(mesh, -(-n_b // N_DEV)), live_blocks(mesh, n_b),
        [(_blocks(mesh, pkeys), live_blocks(mesh, n_p))], [],
        shard_positions(mesh, -(-n_p // N_DEV)), live_blocks(mesh, n_p),
        ring=ring, **kw,
    )


def _matches(a, s: int) -> list:
    """Shard s's matched build rowids per received probe slot, in order."""
    brow = a.build_arrays[-1][s].numpy()
    order, st, ct = a.order[s].numpy(), a.starts[s].numpy(), a.counts[s].numpy()
    mask = a.probe_mask[s].numpy()
    return [list(brow[order[st[i]:st[i] + ct[i]]]) if mask[i] else None
            for i in range(len(mask))]


def test_phase_a_same_blocks_as_reference(mesh):
    """Hot probe keys (hot_min 16 at this size) spread round-robin and hot
    build rows replicated, in both: every shard holds the same build rows in
    the same order, the same probe slots, and the same match lists."""
    bkeys, pkeys, bpay, bval = _join_inputs()
    n = len(bkeys)
    kw = dict(bucket_b=2 * n // 8, bucket_p=2 * n // 8, hot_capacity=256, hot_min=16)
    jm = ref_make_mesh(N_DEV)

    def put(x):
        return jax.device_put(jnp.asarray(x), row_sharding(jm))

    r = ref_join.shuffle_join_phase_a(
        jm, [(put(bkeys), put(bval))], [put(bpay)], put(np.arange(n, dtype=np.int64)),
        put(np.ones(n, np.bool_)), [(put(pkeys), put(np.ones(n, np.bool_)))], [],
        put(np.arange(n, dtype=np.int64)), put(np.ones(n, np.bool_)), **kw,
    )
    a = _phase_a(mesh, bkeys, pkeys, bpay, bval, **kw)
    assert (a.overflow, a.n_hot_buckets, a.m) == (r.overflow, r.n_hot_buckets, r.m)
    assert a.n_hot_buckets > 0 and a.overflow == 0
    ref_bm = _shards(r.build_mask)
    for s in range(N_DEV):
        bm = a.build_mask[s].numpy()
        assert np.array_equal(bm, ref_bm[s])
        for got, exp in zip(a.build_arrays, r.build_arrays):  # keys, payload, rowid
            assert np.array_equal(got[s].numpy()[bm], _shards(exp)[s][bm])
        for got, exp in zip(a.probe_arrays, r.probe_arrays):  # keys, rowid
            assert np.array_equal(got[s].numpy(), _shards(exp)[s])
        pm = a.probe_mask[s].numpy()
        assert np.array_equal(pm, _shards(r.probe_mask)[s])
        for got, exp in ((a.starts, r.starts), (a.counts, r.counts)):
            assert np.array_equal(got[s].numpy()[pm], _shards(exp)[s][pm])
        rbrow, rorder = _shards(r.build_arrays[-1])[s], _shards(r.order)[s]
        rst, rct = _shards(r.starts)[s], _shards(r.counts)[s]
        exp = [list(rbrow[rorder[rst[i]:rst[i] + rct[i]]]) if pm[i] else None
               for i in range(len(pm))]
        assert _matches(a, s) == exp


def test_ring_probe_exchange_bit_identical(mesh):
    """ring=True (the probe exchange in ppermute hops, a rank pass per
    chunk) gives every phase-A output bit for bit as the all_to_all path."""
    bkeys, pkeys, bpay, bval = _join_inputs()
    n = len(bkeys)
    kw = dict(bucket_b=2 * n // 8, bucket_p=2 * n // 8, hot_capacity=256)
    a0 = _phase_a(mesh, bkeys, pkeys, bpay, bval, ring=False, **kw)
    a1 = _phase_a(mesh, bkeys, pkeys, bpay, bval, ring=True, **kw)
    assert (a0.overflow, a0.m, a0.n_hot_buckets) == (a1.overflow, a1.m, a1.n_hot_buckets)
    for f in ("build_mask", "probe_mask", "starts", "counts", "order"):
        for x, y in zip(getattr(a0, f), getattr(a1, f)):
            assert torch.equal(x, y), f
    for f in ("build_arrays", "probe_arrays"):
        for xs, ys in zip(getattr(a0, f), getattr(a1, f)):
            for x, y in zip(xs, ys):
                assert torch.equal(x, y), f


def test_shuffle_partitions_by_key(mesh):
    """Unique keys: no hot bucket, no overflow at 2x the even share, m == 1,
    and every shard holds the keys that hash to it."""
    n = 4096
    rng = np.random.default_rng(5)
    keys = np.arange(n, dtype=np.int64)
    a = _phase_a(mesh, keys, keys[rng.permutation(n)], keys, np.ones(n, np.bool_),
                 bucket_b=2 * n // 8, bucket_p=2 * n // 8, hot_capacity=64)
    assert (a.overflow, a.n_hot_buckets, a.m) == (0, 0, 1)
    from sqlrs_tpu_torch.ops.hash_table import umod

    for s in range(N_DEV):
        bm = a.build_mask[s]
        bk = a.build_arrays[0][s][bm]
        h = dist_join._combined_hash([(bk, torch.ones_like(bm[bm]))])
        assert bool((umod(h, N_DEV) == s).all())


def test_phase_a_overflow_counts_dropped_rows(mesh):
    bkeys, pkeys, bpay, bval = _join_inputs(seed=2)
    a = _phase_a(mesh, bkeys, pkeys, bpay, bval, bucket_b=8, bucket_p=8, hot_capacity=4)
    assert a.overflow > 0


@pytest.mark.parametrize("ring", [False, True])
def test_phase_b_pairs_in_single_device_order(mesh, ring):
    """Phase B's live cells, sorted by rowid_out, are the inner join's pairs
    in the single-device emission order: probe order outer, build insertion
    order inner; NULL build keys never match."""
    bkeys, pkeys, bpay, bval = _join_inputs(seed=3, n=1500)
    n = len(bkeys)
    a = _phase_a(mesh, bkeys, pkeys, bpay, bval, ring=ring, bucket_b=n, bucket_p=n,
                 hot_capacity=n, hot_min=8)
    b_cells, _p_cells, rowid_out, alive = dist_join.shuffle_join_phase_b(mesh, a, 1, 1)
    rid = torch.cat([r[m] for r, m in zip(rowid_out, alive)]).numpy()
    pay = torch.cat([c[m] for c, m in zip(b_cells[0], alive)]).numpy()
    got = pay[np.argsort(rid, kind="stable")]
    exp = [bpay[j] for i in range(n) for j in range(n) if bval[j] and bkeys[j] == pkeys[i]]
    assert np.array_equal(got, np.array(exp, np.int64))


def _agg_join_case(seed):
    """A fact side with NULL keys and dead rows, a dim side with duplicate
    keys, misses and NULL keys."""
    rng = np.random.default_rng(seed)
    nf, nd = 2003, 61
    f_key = rng.integers(0, 50, nf).astype(np.int64)
    f_ok = rng.random(nf) < 0.9
    v = rng.integers(-100, 100, nf).astype(np.int64)
    x = rng.integers(-64, 64, nf).astype(np.float64) / 8.0
    d_key = rng.integers(0, 60, nd).astype(np.int64)
    d_ok = rng.random(nd) < 0.9
    return f_key, f_ok, v, x, d_key, d_ok


def _numpy_agg_join(f_key, f_ok, v, x, d_key, d_ok):
    out = []
    for k, ok in zip(d_key, d_ok):
        hit = np.flatnonzero(f_ok & (f_key == k)) if ok else np.array([], np.int64)
        out.append((len(hit), int(v[hit].sum()), float(x[hit].sum()),
                    int(hit[0]) if len(hit) else I64_MAX,
                    int(v[hit].min()) if len(hit) else None,
                    int(v[hit].max()) if len(hit) else None))
    return out


@pytest.mark.parametrize("chunk", [None, 5], ids=["one_pass", "chunked"])
@pytest.mark.parametrize("fn", ["ring_agg_join", "broadcast_agg_join"])
@pytest.mark.parametrize("seed", [0, 1])
def test_agg_join_per_dim_row(mesh, fn, seed, chunk, monkeypatch):
    """Per dim row: the count, the sums, the first matching fact row and the
    min/max through the directed keys (max by the bitwise NOT), as numpy,
    with the range queries answered in one pass or 5 dim rows at a time."""
    if chunk is not None:
        from sqlrs_tpu_torch.parallel import dist_ops

        monkeypatch.setattr(dist_ops, "_QUERY_CHUNK", chunk)
    f_key, f_ok, v, x, d_key, d_ok = _agg_join_case(seed)
    nf = len(f_key)
    f_rowid = shard_positions(mesh, -(-nf // N_DEV))
    f_live = live_blocks(mesh, nf)
    ok = [a & b for a, b in zip(_blocks(mesh, f_ok), f_live)]
    mm_min = [torch.where(o, b, I64_MAX) for o, b in zip(ok, _blocks(mesh, v))]
    mm_max = [torch.where(o, ~b, I64_MAX) for o, b in zip(ok, _blocks(mesh, v))]
    counts, sums, min_rowid, mm = getattr(dist_join, fn)(
        mesh, _blocks(mesh, f_key), ok, f_rowid,
        [_blocks(mesh, v), _blocks(mesh, x)],
        [(mm_min, _blocks(mesh, v)), (mm_max, _blocks(mesh, v))],
        _blocks(mesh, d_key),
        [a & b for a, b in zip(_blocks(mesh, d_ok), live_blocks(mesh, len(d_key)))],
    )
    nd = len(d_key)

    def cat(xs):
        return torch.cat(xs).numpy()[:nd]

    got_c, got_s, got_x, got_r = cat(counts), cat(sums[0]), cat(sums[1]), cat(min_rowid)
    got_min, got_max = cat(mm[0][0]), cat(mm[1][0])
    for g, exp in enumerate(_numpy_agg_join(f_key, f_ok, v, x, d_key, d_ok)):
        c, s, xs, r, lo, hi = exp
        assert (got_c[g], got_s[g], got_x[g], got_r[g]) == (c, s, xs, r), g
        if c:
            assert (got_min[g], got_max[g]) == (lo, hi), g


def test_pair_local_dedup(mesh):
    rng = np.random.default_rng(6)
    n = 999
    k = rng.integers(0, 20, n).astype(np.int64)
    val = rng.integers(0, 5, n).astype(np.int64)
    ok = rng.random(n) < 0.85
    sk, sv, keep = dist_join.pair_local_dedup(
        mesh, _blocks(mesh, k), _blocks(mesh, val),
        [a & b for a, b in zip(_blocks(mesh, ok), live_blocks(mesh, n))])
    local = -(-n // N_DEV)
    for s in range(N_DEV):
        lo, hi = s * local, min((s + 1) * local, n)
        m = ok[lo:hi]
        exp = sorted(set(zip(k[lo:hi][m].tolist(), val[lo:hi][m].tolist())))
        got = list(zip(sk[s][keep[s]].tolist(), sv[s][keep[s]].tolist()))
        assert got == exp
