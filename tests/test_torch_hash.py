"""The port's splitmix64 hashing (sqlrs_tpu_torch/ops/hash_table.py) against
the reference's (sqlrs_tpu/ops/hash_table.py), bit for bit.

The reference mixes on uint64; the port carries the same bits in int64.
Random int64 keys from a numpy seed, with negatives, 0, INT64_MIN and
INT64_MAX among them, go through both: `_mix64`, `hash_keys` at several
power-of-two capacities, the shard placement `hash_keys(k, 1 << 32) %
n_shards` of parallel/dist_ops.partition_shuffle, the uint64 remainder
`umod` and the join exchange's `_combined_hash` (parallel/dist_join.py).

The open-addressing table functions (the reference's comparison baseline)
go through both too and must agree exactly, slots and pair order included
(tests/test_kernels.py:19-100).
"""

import numpy as np
import pytest
import torch

import sqlrs_tpu  # noqa: F401  (x64)
import jax.numpy as jnp

from sqlrs_tpu.ops import hash_table as ref
from sqlrs_tpu.parallel import dist_join as ref_join
from sqlrs_tpu_torch.ops import hash_table as port
from sqlrs_tpu_torch.parallel import dist_join as port_join

I64 = np.iinfo(np.int64)


def _keys(seed: int, n: int = 4099) -> np.ndarray:
    rng = np.random.default_rng(seed)
    k = rng.integers(I64.min, I64.max, n, dtype=np.int64, endpoint=True)
    k[:8] = [0, -1, 1, I64.min, I64.max, I64.min + 1, I64.max - 1, 2**32]
    k[8::5] = rng.integers(-1000, 1000, len(k[8::5]))  # small keys, both signs
    return k


def _ref_bits(x) -> np.ndarray:
    """The reference's uint64 result as int64 bits."""
    return np.asarray(x).astype(np.uint64).view(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mix64_bit_for_bit(seed):
    k = _keys(seed)
    got = port._mix64(torch.from_numpy(k)).numpy()
    assert np.array_equal(got, _ref_bits(ref._mix64(jnp.asarray(k))))


@pytest.mark.parametrize("capacity", [1, 2, 4096, 1 << 32, 1 << 62, 1 << 63])
def test_hash_keys_bit_for_bit(capacity):
    k = _keys(capacity % 97)
    got = port.hash_keys(torch.from_numpy(k), capacity).numpy()
    exp = np.asarray(ref.hash_keys(jnp.asarray(k), capacity))
    assert got.dtype == np.int64 and np.array_equal(got, exp)
    assert (got >= 0).all() and (got.astype(np.uint64) < np.uint64(capacity)).all()


@pytest.mark.parametrize("n_shards", [1, 3, 4, 8])
def test_shard_placement_matches_reference(n_shards):
    k = _keys(10 + n_shards)
    got = port.hash_keys(torch.from_numpy(k), 1 << 32) % n_shards
    exp = np.asarray(ref.hash_keys(jnp.asarray(k), 1 << 32)) % n_shards
    assert np.array_equal(got.numpy(), exp)


@pytest.mark.parametrize("m", [1, 3, 7, 8, 4096, (1 << 61) + 5])
def test_umod_is_the_uint64_remainder(m):
    k = _keys(20 + m % 13)
    got = port.umod(torch.from_numpy(k), m).numpy()
    exp = (k.view(np.uint64) % np.uint64(m)).astype(np.int64)
    assert np.array_equal(got, exp)


@pytest.mark.parametrize("n_keys", [1, 2, 3])
def test_combined_hash_matches_reference(n_keys):
    cols = [_keys(30 + j) for j in range(n_keys)]
    valid = np.ones(len(cols[0]), np.bool_)
    got = port_join._combined_hash(
        [(torch.from_numpy(c), torch.from_numpy(valid)) for c in cols]
    ).numpy()
    exp = ref_join._combined_hash([(jnp.asarray(c), jnp.asarray(valid)) for c in cols])
    assert np.array_equal(got, _ref_bits(exp))
    # the join exchange's destination and histogram bucket of every row
    assert np.array_equal(
        port.umod(torch.from_numpy(got), 8).numpy(),
        np.asarray(exp % jnp.uint64(8)).astype(np.int64),
    )
    assert np.array_equal(got & 4095, np.asarray(exp % jnp.uint64(4096)).astype(np.int64))


# ---- the open-addressing table ----------------------------------------------


def _same(ref_out, port_out):
    for i, (r, p) in enumerate(zip(ref_out, port_out)):
        r, p = np.asarray(r), p.numpy()
        assert p.dtype == r.dtype, (i, p.dtype, r.dtype)
        assert np.array_equal(p, r), f"output {i}"


def test_build_table_equals_reference():
    keys = np.array([5, 5, 9, 9, 9, 1, 2, 3], dtype=np.int64)
    _same(ref.build_table(jnp.asarray(keys), 16), port.build_table(torch.from_numpy(keys), 16))
    assert port.EMPTY == int(ref.EMPTY)
    # colliding chains at a tight capacity: every row placed as the reference places it
    k = _keys(40, 300)
    _same(ref.build_table(jnp.asarray(k), 512), port.build_table(torch.from_numpy(k), 512))


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_hash_group_aggregate_equals_reference(dtype):
    rng = np.random.default_rng(42)
    keys = rng.integers(0, 517, size=20_000).astype(np.int64)
    vals = rng.integers(-100, 100, size=20_000).astype(dtype)
    cap = port.next_pow2(2 * 517)
    r = ref.hash_group_aggregate(jnp.asarray(keys), jnp.asarray(vals), cap)
    p = port.hash_group_aggregate(torch.from_numpy(keys), torch.from_numpy(vals), cap)
    _same(r, p)
    live = p[0].numpy() != port.EMPTY
    exp = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        s, c, mn, mx = exp.get(k, (0, 0, 10**9, -(10**9)))
        exp[k] = (s + v, c + 1, min(mn, v), max(mx, v))
    got = {
        int(k): (int(s), int(c), int(mn), int(mx))
        for k, s, c, mn, mx in zip(*(x.numpy()[live] for x in p))
    }
    assert got == exp


def test_build_join_table_and_probe_counts_equal_reference():
    rng = np.random.default_rng(3)
    bk = rng.integers(0, 300, size=2_000).astype(np.int64)
    pk = rng.integers(0, 400, size=3_000).astype(np.int64)
    cap = port.next_pow2(2 * len(bk))
    r = ref.build_join_table(jnp.asarray(bk), cap)
    p = port.build_join_table(torch.from_numpy(bk), cap)
    _same(r, p)
    _same(ref.probe_counts(r[0], jnp.asarray(pk), r[2], cap),
          port.probe_counts(p[0], torch.from_numpy(pk), p[2], cap))


@pytest.mark.parametrize("out_capacity", [None, 16, 1 << 14])
def test_hash_join_pairs_equal_reference_in_order(out_capacity):
    """expand_pairs through hash_join_pairs: the same (build, probe) pairs
    in the same probe-major order, padded alike, and numpy's pair set."""
    rng = np.random.default_rng(7)
    bk = rng.integers(0, 300, size=2_000).astype(np.int64)
    pk = rng.integers(0, 400, size=3_000).astype(np.int64)
    r = ref.hash_join_pairs(jnp.asarray(bk), jnp.asarray(pk), out_capacity)
    p = port.hash_join_pairs(torch.from_numpy(bk), torch.from_numpy(pk), out_capacity)
    _same(r, p)
    if out_capacity is None:
        total = int(p[3])
        got = list(zip(p[0].numpy()[:total].tolist(), p[1].numpy()[:total].tolist()))
        by_key = {}
        for i, k in enumerate(bk.tolist()):
            by_key.setdefault(k, []).append(i)
        exp = [(i, j) for j, k in enumerate(pk.tolist()) for i in by_key.get(k, [])]
        assert got == exp  # probe order outer, build insertion order inner


def test_hash_join_pairs_reject_hash_collisions():
    bk = np.array([0, 16, 32, 48], dtype=np.int64)
    pk = np.array([64, 80, 0], dtype=np.int64)
    r = ref.hash_join_pairs(jnp.asarray(bk), jnp.asarray(pk))
    p = port.hash_join_pairs(torch.from_numpy(bk), torch.from_numpy(pk))
    _same(r, p)
    assert int(p[3]) == 1 and int(p[0][0]) == 0 and int(p[1][0]) == 2
