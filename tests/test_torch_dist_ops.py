"""The sharded engine's mesh, collectives and operators
(sqlrs_tpu_torch/parallel/mesh.py, collectives.py, dist_ops.py) over 8
shards on the CPU, the JAX conftest's 8 virtual devices.

Inputs are made from numpy seeds. `partition_shuffle` and `dist_sort` are
held to the reference's shard_map programs on the 8-device CPU mesh: every
shard's block equal, read through `addressable_shards`. Each of those
compiles for about 20 s on the CPU, so they are the only JAX programs here
outside the slow-marked tests. Every join + GROUP BY strategy and
`dist_sort_rows` are held to numpy; the overflow counts and the retry
ladders of the checked strategies to a numpy model of the bucketing (and,
in slow-marked tests, to the reference's). The layout is held to the
reference's `shard_batch`, the collectives to their definitions, and no
collective's result aliases its input when several shards share a device.
"""

import collections

import numpy as np
import pytest
import torch

import sqlrs_tpu  # noqa: F401  (x64)
import jax
import jax.numpy as jnp

from sqlrs_tpu.parallel import dist_ops as ref_ops
from sqlrs_tpu.parallel.mesh import make_mesh as ref_make_mesh
from sqlrs_tpu.parallel.mesh import replicated, row_sharding
from sqlrs_tpu_torch.errors import ExecutorError
from sqlrs_tpu_torch.ops.hash_table import hash_keys
from sqlrs_tpu_torch.parallel import collectives, dist_ops
from sqlrs_tpu_torch.parallel.mesh import (
    Mesh,
    live_blocks,
    make_mesh,
    padded_capacity,
    replicate,
    row_blocks,
)

N_DEV = 8


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(N_DEV, devices=["cpu"] * N_DEV)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= N_DEV, "conftest should provide 8 CPU devices"
    return ref_make_mesh(N_DEV)


@pytest.fixture(scope="module")
def data():
    """tests/test_distributed.py's star: 16,000 zipf(1.3) fact keys into 64
    dim keys."""
    rng = np.random.default_rng(0)
    n, groups = 16_000, 64
    gid = np.minimum(rng.zipf(1.3, n), groups).astype(np.int64) - 1
    dim_keys = np.arange(groups, dtype=np.int64) * 7 + 3
    fact_vals = rng.integers(0, 10, n).astype(np.int64)
    exp_s, exp_c = _numpy_groupby(gid, fact_vals, groups)
    return dict(n=n, groups=groups, gid=gid, dim_keys=dim_keys,
                fact_keys=dim_keys[gid], fact_vals=fact_vals, exp_s=exp_s, exp_c=exp_c)


def _numpy_groupby(gid, vals, groups):
    s, c = np.zeros(groups, np.int64), np.zeros(groups, np.int64)
    np.add.at(s, gid, vals)
    np.add.at(c, gid, 1)
    return s, c


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _shards(x) -> list:
    """A JAX array's per-shard blocks in shard order, through its
    addressable shards."""
    blocks = sorted(x.addressable_shards, key=lambda s: s.index[0].start or 0)
    return [np.asarray(s.data) for s in blocks]


def _hash_dest(keys, n_dev=N_DEV):
    return hash_keys(_t(keys), 1 << 32).numpy() % n_dev


def _bucket_overflow(dest_per_shard, cap, n_dev=N_DEV) -> int:
    """Numpy model of the exchange: rows beyond `cap` in a (sender,
    receiver) bucket are dropped and counted."""
    return int(sum(
        np.maximum(np.bincount(d[d < n_dev], minlength=n_dev) - cap, 0).sum()
        for d in dest_per_shard
    ))


# ---- mesh and placement ------------------------------------------------------


def test_make_mesh_needs_cuda_devices_unless_listed():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")  # the rule without CUDA is what is held
    for n in (None, 1, 4):
        with pytest.raises(ExecutorError):
            make_mesh(n)
    with pytest.raises(ExecutorError):
        make_mesh(2, devices=["cuda:0", "cuda:0"])
    with pytest.raises(ExecutorError):
        make_mesh(3, devices=["cpu", "cpu"])
    m = make_mesh(4, devices=["cpu"] * 4)
    assert m.size == 4 and m.shape["x"] == 4
    assert m.devices == [torch.device("cpu")] * 4
    with pytest.raises(ExecutorError):
        Mesh([])


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 1003])
def test_row_blocks_match_reference_shard_batch(mesh, n):
    """Block-contiguous rows padded to a multiple of the shard count: the
    reference's shard_batch layout, shard by shard."""
    from sqlrs_tpu.data import DeviceBatch as RefBatch
    from sqlrs_tpu.data import Schema as RefSchema
    from sqlrs_tpu.parallel.dist_executor import shard_batch as ref_shard_batch
    from sqlrs_tpu.types import LogicalType as RLT

    vals = np.arange(n, dtype=np.int64) * 3 - 5
    ref = ref_shard_batch(RefBatch.from_pydict(
        RefSchema.of([("v", RLT.BIGINT)]), {"v": vals.tolist()}), ref_make_mesh(N_DEV))
    blocks = row_blocks(mesh, _t(vals))
    alive = live_blocks(mesh, n)
    assert padded_capacity(n, N_DEV) == ref.capacity
    for got, exp in zip(blocks, _shards(ref.columns[0].data)):
        assert np.array_equal(got.numpy(), exp)
    for got, exp in zip(alive, _shards(ref.alive)):
        assert np.array_equal(got.numpy(), exp)


# ---- collectives --------------------------------------------------------------


def test_collectives_follow_their_definitions(mesh):
    rng = np.random.default_rng(4)
    xs = [_t(rng.integers(-9, 9, (N_DEV, 5))) for _ in range(N_DEV)]
    recv = collectives.all_to_all(mesh, xs)
    for i in range(N_DEV):
        for j in range(N_DEV):
            assert torch.equal(recv[i][j], xs[j][i])
    flat = [x.reshape(-1) for x in xs]
    total = sum(flat[1:], flat[0].clone())
    for p in collectives.psum(mesh, flat):
        assert torch.equal(p, total)
    mins = collectives.pmin(mesh, flat)
    assert torch.equal(mins[3], torch.stack(flat).amin(0))
    assert torch.equal(collectives.reduce_max(mesh, flat), torch.stack(flat).amax(0))
    chunk = total.shape[0] // N_DEV
    for i, p in enumerate(collectives.psum_scatter(mesh, flat)):
        assert torch.equal(p, total[i * chunk:(i + 1) * chunk])
    for g in collectives.all_gather(mesh, flat):
        assert torch.equal(g, torch.stack(flat))
    assert torch.equal(collectives.all_gather(mesh, flat, tiled=True)[2], torch.cat(flat))
    ring = collectives.ppermute(mesh, flat, collectives.ring_perm(N_DEV))
    for i in range(N_DEV):
        assert torch.equal(ring[(i + 1) % N_DEV], flat[i])
    partial = collectives.ppermute(mesh, flat, [(0, 1)])
    assert torch.equal(partial[1], flat[0]) and not partial[0].any()
    assert torch.equal(collectives.gather(mesh, flat, "cpu"), torch.cat(flat))


def test_float_psum_adds_in_shard_order(mesh):
    """The same bits on every run, equal to the sum taken in shard order."""
    rng = np.random.default_rng(8)
    xs = [_t(rng.standard_normal(257) * 10.0 ** rng.integers(-8, 8, 257)) for _ in range(N_DEV)]
    exp = xs[0].clone()
    for x in xs[1:]:
        exp = exp + x
    first = collectives.reduce_sum(mesh, xs)
    assert torch.equal(first, exp)
    assert torch.equal(collectives.reduce_sum(mesh, xs), first)


def test_collective_results_never_alias_their_inputs(mesh):
    """8 shards share the CPU, so `t.to(dev)` is `t` itself: a result
    written in place must change no input and no other shard's result."""
    rng = np.random.default_rng(9)
    flat = [_t(rng.integers(0, 100, 16)) for _ in range(N_DEV)]
    bufs = [_t(rng.integers(0, 100, (N_DEV, 4))) for _ in range(N_DEV)]
    keep = [x.clone() for x in flat]
    keep_b = [b.clone() for b in bufs]
    outs = [
        collectives.all_to_all(mesh, bufs),
        collectives.psum(mesh, flat),
        collectives.pmin(mesh, flat),
        collectives.psum_scatter(mesh, flat),
        collectives.all_gather(mesh, flat),
        collectives.all_gather(mesh, flat, tiled=True),
        collectives.ppermute(mesh, flat, collectives.ring_perm(N_DEV)),
        replicate(mesh, flat[0]),
        [collectives.reduce_sum(mesh, flat), collectives.gather(mesh, flat, "cpu")],
    ]
    before = [[o.clone() for o in out] for out in outs]
    for out in outs:
        for o in out:
            o.fill_(-7)  # every consumer writing its result in place
    for x, k in zip(flat, keep):
        assert torch.equal(x, k)
    for b, k in zip(bufs, keep_b):
        assert torch.equal(b, k)
    ptrs = [o.data_ptr() for out in outs for o in out]
    assert len(set(ptrs)) == len(ptrs)  # no result shares storage with another
    # and the operators built on them are pure: a second call agrees
    outs2 = collectives.all_to_all(mesh, bufs)
    assert all(torch.equal(a, b) for a, b in zip(outs2, before[0]))
    keys = [_t(x) for x in np.split(np.arange(64, dtype=np.int64) % 11, N_DEV)]
    ok = [torch.ones(8, dtype=torch.bool) for _ in range(N_DEV)]
    r1 = dist_ops.partition_shuffle(mesh, keys, keys, ok, 16)
    for k in r1[0]:
        k.fill_(0)
    r2 = dist_ops.partition_shuffle(mesh, keys, keys, ok, 16)
    assert all(torch.equal(a, b) for a, b in zip(r2[0], r2[1]))
    assert sum(int(m.sum()) for m in r2[2]) == 64


# ---- the exchange and the sample sort against the reference's programs ------


def test_partition_shuffle_same_blocks_as_reference(mesh, jmesh, data):
    """The JAX shard_map program on the 8-device CPU mesh and the port give
    every shard the same keys, values, mask and overflow, slot for slot;
    the bucket is small enough that rows are dropped and counted."""
    n, cap = data["n"], 320
    fk, fv = data["fact_keys"], data["fact_vals"]
    valid = np.ones(n, np.bool_)
    valid[::13] = False
    sh = row_sharding(jmesh)
    rk, rv, rm, rovf = ref_ops.partition_shuffle(
        jmesh, *(jax.device_put(jnp.asarray(a), sh) for a in (fk, fv, valid)),
        bucket_capacity=cap,
    )
    pk, pv, pm, povf = dist_ops.partition_shuffle(
        mesh, row_blocks(mesh, _t(fk)), row_blocks(mesh, _t(fv)),
        row_blocks(mesh, _t(valid)), cap,
    )
    for got, ref in ((pk, rk), (pv, rv), (pm, rm), (povf, rovf)):
        exp = _shards(ref)
        assert len(got) == len(exp) == N_DEV
        for g, e in zip(got, exp):
            assert np.array_equal(g.numpy(), e)
    # and the overflow is the numpy model's
    dest = np.where(valid, _hash_dest(fk), N_DEV)
    model = _bucket_overflow(np.split(dest, N_DEV), cap)
    assert model > 0 and sum(int(o) for o in povf) == model


def test_dist_sort_same_blocks_as_reference(mesh, jmesh, data):
    n = data["n"]
    fk = data["fact_keys"] * 1013904223 % 100_003 - 50_000  # spread, with negatives
    ks, valid = ref_ops.dist_sort(
        jmesh, jax.device_put(jnp.asarray(fk), row_sharding(jmesh)), bucket_capacity=n // 4
    )
    pk, pm = dist_ops.dist_sort(mesh, row_blocks(mesh, _t(fk)), n // 4)
    for g, e in zip(pk, _shards(ks)):
        assert np.array_equal(g.numpy(), e.reshape(-1))
    for g, e in zip(pm, _shards(valid)):
        assert np.array_equal(g.numpy(), e.reshape(-1))
    got = torch.cat([k[m] for k, m in zip(pk, pm)]).numpy()
    assert np.array_equal(got, np.sort(fk))


def test_partition_shuffle_places_rows_by_hash(mesh, data):
    n = data["n"]
    fk = data["fact_keys"]
    k, v, m, ovf = dist_ops.partition_shuffle(
        mesh, row_blocks(mesh, _t(fk)), row_blocks(mesh, _t(data["fact_vals"])),
        live_blocks(mesh, n), n // 2,
    )
    assert sum(int(o) for o in ovf) == 0
    expected = collections.Counter(_hash_dest(fk).tolist())
    for d in range(N_DEV):
        live = k[d][m[d]].numpy()
        assert len(live) == expected[d]
        assert np.all(_hash_dest(live) == d)


@pytest.mark.parametrize("seed", [1, 2])
def test_dist_sort_rows_matches_numpy(mesh, seed):
    """Whole-row ORDER BY over two directed keys with heavy ties and dead
    rows: the collected rows equal numpy's stable lexsort of the live rows,
    dead rows dropped."""
    rng = np.random.default_rng(seed)
    n = 3001
    k1 = rng.integers(0, 40, n)
    k2 = rng.integers(-1000, 1000, n)
    pay = rng.integers(-(2**40), 2**40, n)
    alive = rng.random(n) < 0.8
    cap = padded_capacity(n, N_DEV)
    bucket = max(4 * cap // (N_DEV * N_DEV), 64)
    while True:
        keys, pays, mask, overflow = dist_ops.dist_sort_rows(
            mesh, [row_blocks(mesh, _t(k1)), row_blocks(mesh, _t(k2))],
            [row_blocks(mesh, _t(pay))], row_blocks(mesh, _t(alive)), bucket,
        )
        if overflow == 0:
            break
        bucket *= 4
    got_k1 = torch.cat([k[m] for k, m in zip(keys[0], mask)]).numpy()
    got_pay = torch.cat([p[m] for p, m in zip(pays[0], mask)]).numpy()
    live = np.flatnonzero(alive)
    order = live[np.lexsort((live, k2[live], k1[live]))]
    assert np.array_equal(got_k1, k1[order])
    assert np.array_equal(got_pay, pay[order])


# ---- join + GROUP BY strategies against numpy ----------------------------------


def test_broadcast_join_groupby(mesh, data):
    sums, counts = dist_ops.dist_join_groupby_broadcast(
        mesh, _t(data["fact_keys"]), _t(data["fact_vals"]), _t(data["dim_keys"]),
        data["groups"],
    )
    assert np.array_equal(sums.numpy(), data["exp_s"])
    assert np.array_equal(counts.numpy(), data["exp_c"])


def test_shuffle_join_groupby(mesh, data):
    sums, counts, overflow = dist_ops.dist_join_groupby_shuffle(
        mesh, _t(data["fact_keys"]), _t(data["fact_vals"]), _t(data["dim_keys"]),
        data["groups"], bucket_capacity=data["n"] // 2,
    )
    assert int(overflow) == 0
    assert np.array_equal(sums.numpy(), data["exp_s"])
    assert np.array_equal(counts.numpy(), data["exp_c"])


def test_ring_join_groupby(mesh, data):
    sums, counts = dist_ops.dist_join_groupby_ring(
        mesh, _t(data["fact_keys"]), _t(data["fact_vals"]), _t(data["dim_keys"]),
        data["groups"],
    )
    assert np.array_equal(sums.numpy(), data["exp_s"])
    assert np.array_equal(counts.numpy(), data["exp_c"])


@pytest.mark.parametrize("chunk", [None, 3], ids=["one_pass", "chunked"])
@pytest.mark.parametrize("strategy", ["broadcast", "shuffle", "salted", "ring"])
def test_strategies_on_unpadded_sizes(mesh, strategy, chunk, monkeypatch):
    """Fact and dim sizes that are not multiples of the shard count, keys
    that miss, float values: each strategy's partials equal numpy's, with
    the dim rows' range queries answered in one pass or 3 rows at a time."""
    if chunk is not None:
        monkeypatch.setattr(dist_ops, "_QUERY_CHUNK", chunk)
    rng = np.random.default_rng(7)
    n, groups = 1003, 37
    dim_keys = np.arange(groups, dtype=np.int64) * 11 + 5
    gid = rng.integers(0, groups + 3, n)
    fk = np.where(gid < groups, dim_keys[np.minimum(gid, groups - 1)], 4)
    fv = rng.integers(0, 10, n).astype(np.float64) / 4.0  # dyadic: exact in any order
    hit = gid < groups
    exp_s = np.zeros(groups)
    exp_c = np.zeros(groups, np.int64)
    np.add.at(exp_s, gid[hit], fv[hit])
    np.add.at(exp_c, gid[hit], 1)
    args = (mesh, _t(fk), _t(fv), _t(dim_keys), groups)
    if strategy == "broadcast":
        sums, cnts = dist_ops.dist_join_groupby_broadcast(*args)
    elif strategy == "shuffle":
        sums, cnts = dist_ops.dist_join_groupby_shuffle_checked(*args, bucket_capacity=16)
    elif strategy == "salted":
        sums, cnts = dist_ops.dist_join_groupby_salted_checked(
            *args, bucket_capacity=16, hot_capacity=2)
    else:
        sums, cnts = dist_ops.dist_join_groupby_ring(*args)
    assert sums.dtype == torch.float64
    assert np.array_equal(sums.numpy(), exp_s)
    assert np.array_equal(cnts.numpy(), exp_c)


def test_salted_join_groupby_extreme_skew(mesh):
    rng = np.random.default_rng(1)
    n, groups = 32_000, 64
    gid = np.where(rng.random(n) < 0.8, 0, rng.integers(1, groups, n)).astype(np.int64)
    dim_keys = np.arange(groups, dtype=np.int64) * 7 + 3
    fv = rng.integers(0, 10, n).astype(np.int64)
    exp_s, exp_c = _numpy_groupby(gid, fv, groups)
    sums, cnts, overflow = dist_ops.dist_join_groupby_salted(
        mesh, _t(dim_keys[gid]), _t(fv), _t(dim_keys), groups,
        bucket_capacity=n // 4, hot_capacity=64,
    )
    assert int(overflow) == 0
    assert np.array_equal(sums.numpy(), exp_s)
    assert np.array_equal(cnts.numpy(), exp_c)


def test_scaling_shapes(data):
    """The same function on 2 shards (and on 3, not a power of two)."""
    for n_dev in (2, 3):
        m = make_mesh(n_dev, devices=["cpu"] * n_dev)
        sums, counts = dist_ops.dist_join_groupby_broadcast(
            m, _t(data["fact_keys"]), _t(np.ones(data["n"], np.int64)),
            _t(data["dim_keys"]), data["groups"],
        )
        assert int(counts.sum()) == data["n"]
        assert np.array_equal(counts.numpy(), data["exp_c"])


# ---- overflow: reported, then retried ------------------------------------------


def _record_calls(monkeypatch, name):
    calls = []
    fn = getattr(dist_ops, name)

    def wrapped(*a, **k):
        out = fn(*a, **k)
        calls.append((a[5] if len(a) > 5 else k["bucket_capacity"], int(out[2])))
        return out

    monkeypatch.setattr(dist_ops, name, wrapped)
    return calls


def test_shuffle_overflow_is_reported_then_retried(mesh, data, monkeypatch):
    """Overflow at a tiny capacity is visible and is the numpy model's
    count; the checked wrapper grows the capacity 4x at a time until nothing
    overflows (the same ladder as the model's) and is then exact."""
    tiny = 16
    args = (mesh, _t(data["fact_keys"]), _t(data["fact_vals"]), _t(data["dim_keys"]),
            data["groups"])
    f_dest = np.split(_hash_dest(data["fact_keys"]), N_DEV)
    d_blocks = row_blocks(mesh, _t(data["dim_keys"]))
    d_live = live_blocks(mesh, data["groups"])
    d_dest = [np.where(m.numpy(), _hash_dest(b.numpy()), N_DEV) for b, m in zip(d_blocks, d_live)]

    def model(cap):
        return _bucket_overflow(f_dest, cap) + _bucket_overflow(d_dest, cap)

    _, _, overflow = dist_ops.dist_join_groupby_shuffle(*args, bucket_capacity=tiny)
    assert int(overflow) == model(tiny) > 0
    calls = _record_calls(monkeypatch, "dist_join_groupby_shuffle")
    sums, counts = dist_ops.dist_join_groupby_shuffle_checked(*args, bucket_capacity=tiny)
    assert np.array_equal(sums.numpy(), data["exp_s"])
    assert np.array_equal(counts.numpy(), data["exp_c"])
    ladder, cap = [], tiny
    while True:
        ladder.append((cap, model(cap)))
        if model(cap) == 0:
            break
        cap = min(cap * 4, data["n"])
    assert calls == ladder


def test_salted_hot_truncation_is_reported_then_retried(mesh, monkeypatch):
    rng = np.random.default_rng(3)
    n, groups = 8_000, 512
    gid = np.where(rng.random(n) < 0.9, 0, rng.integers(1, groups, n)).astype(np.int64)
    dim_keys = np.arange(groups, dtype=np.int64) * 7 + 3
    fv = rng.integers(0, 10, n).astype(np.int64)
    exp_s, exp_c = _numpy_groupby(gid, fv, groups)
    args = (mesh, _t(dim_keys[gid]), _t(fv), _t(dim_keys), groups)
    _, _, overflow = dist_ops.dist_join_groupby_salted(
        *args, bucket_capacity=32, hot_capacity=1, hot_factor=0.5)
    assert int(overflow) > 0
    calls = _record_calls(monkeypatch, "dist_join_groupby_salted")
    sums, cnts = dist_ops.dist_join_groupby_salted_checked(
        *args, bucket_capacity=32, hot_capacity=1, hot_factor=0.5)
    assert np.array_equal(sums.numpy(), exp_s)
    assert np.array_equal(cnts.numpy(), exp_c)
    assert [c for c, _ in calls] == [32 * 4**i for i in range(len(calls))]
    assert calls[-1][1] == 0 and all(o > 0 for _, o in calls[:-1])


# ---- the same overflow counts and ladders as the reference (slow) ----------------


def _ref_ladder(monkeypatch, name, *args, **kw):
    calls = []
    fn = getattr(ref_ops, name)

    def wrapped(*a, **k):
        out = fn(*a, **k)
        calls.append((a[5] if len(a) > 5 else k["bucket_capacity"], int(np.asarray(out[2]))))
        return out

    monkeypatch.setattr(ref_ops, name, wrapped)
    checked = getattr(ref_ops, name + "_checked")
    sums, cnts = checked(*args, **kw)
    return calls, np.asarray(sums), np.asarray(cnts)


@pytest.mark.slow
def test_shuffle_retry_ladder_equals_reference(mesh, jmesh, data, monkeypatch):
    sh, rep = row_sharding(jmesh), replicated(jmesh)
    ref_calls, rs, rc = _ref_ladder(
        monkeypatch, "dist_join_groupby_shuffle", jmesh,
        jax.device_put(jnp.asarray(data["fact_keys"]), sh),
        jax.device_put(jnp.asarray(data["fact_vals"]), sh),
        jax.device_put(jnp.asarray(data["dim_keys"]), rep), data["groups"],
        bucket_capacity=16,
    )
    calls = _record_calls(monkeypatch, "dist_join_groupby_shuffle")
    sums, cnts = dist_ops.dist_join_groupby_shuffle_checked(
        mesh, _t(data["fact_keys"]), _t(data["fact_vals"]), _t(data["dim_keys"]),
        data["groups"], bucket_capacity=16)
    assert calls == ref_calls
    assert np.array_equal(sums.numpy(), rs) and np.array_equal(cnts.numpy(), rc)


@pytest.mark.slow
def test_salted_retry_ladder_equals_reference(mesh, jmesh, monkeypatch):
    rng = np.random.default_rng(3)
    n, groups = 8_000, 512
    gid = np.where(rng.random(n) < 0.9, 0, rng.integers(1, groups, n)).astype(np.int64)
    dim_keys = np.arange(groups, dtype=np.int64) * 7 + 3
    fv = rng.integers(0, 10, n).astype(np.int64)
    sh, rep = row_sharding(jmesh), replicated(jmesh)
    ref_calls, rs, rc = _ref_ladder(
        monkeypatch, "dist_join_groupby_salted", jmesh,
        jax.device_put(jnp.asarray(dim_keys[gid]), sh), jax.device_put(jnp.asarray(fv), sh),
        jax.device_put(jnp.asarray(dim_keys), rep), groups,
        bucket_capacity=32, hot_capacity=1, hot_factor=0.5,
    )
    calls = _record_calls(monkeypatch, "dist_join_groupby_salted")
    sums, cnts = dist_ops.dist_join_groupby_salted_checked(
        mesh, _t(dim_keys[gid]), _t(fv), _t(dim_keys), groups,
        bucket_capacity=32, hot_capacity=1, hot_factor=0.5)
    assert calls == ref_calls
    assert np.array_equal(sums.numpy(), rs) and np.array_equal(cnts.numpy(), rc)


@pytest.mark.slow
def test_dist_sort_rows_same_blocks_as_reference(mesh, jmesh):
    rng = np.random.default_rng(5)
    n = 2000
    k1, k2 = rng.integers(0, 30, n), rng.integers(-50, 50, n)
    pay = rng.integers(0, 1000, n)
    alive = rng.random(n) < 0.9
    sh = row_sharding(jmesh)

    def put(a):
        return jax.device_put(jnp.asarray(a), sh)

    rk, rp, rm, rovf = ref_ops.dist_sort_rows(
        jmesh, [put(k1), put(k2)], [put(pay)], put(alive), 256)
    pk, pp, pm, povf = dist_ops.dist_sort_rows(
        mesh, [row_blocks(mesh, _t(k1)), row_blocks(mesh, _t(k2))],
        [row_blocks(mesh, _t(pay))], row_blocks(mesh, _t(alive)), 256)
    assert povf == rovf
    for got, ref in ((pk[0], rk[0]), (pk[1], rk[1]), (pp[0], rp[0]), (pm, rm)):
        for g, e, m in zip(got, _shards(ref), _shards(rm)):
            assert np.array_equal(g.numpy()[m], e[m])
