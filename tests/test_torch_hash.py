"""The port's splitmix64 hashing (sqlrs_tpu_torch/ops/hash_table.py) against
the reference's (sqlrs_tpu/ops/hash_table.py), bit for bit.

The reference mixes on uint64; the port carries the same bits in int64.
Random int64 keys from a numpy seed, with negatives, 0, INT64_MIN and
INT64_MAX among them, go through both: `_mix64`, `hash_keys` at several
power-of-two capacities, the shard placement `hash_keys(k, 1 << 32) %
n_shards` of parallel/dist_ops.partition_shuffle, the uint64 remainder
`umod` and the join exchange's `_combined_hash` (parallel/dist_join.py).
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
