"""sqlrs_tpu_torch/ops/mxu_agg.py against sqlrs_tpu/ops/mxu_agg.py.

`mxu_groupby_dense` on CPU tensors runs the plain version of the
dense-group kernel; it must equal the reference's Pallas kernel in
interpret mode and a numpy oracle exactly (int64 sums and counts). The
selection guard `mxu_eligible` must make the reference's choices under
every SQLRS_TPU_MXU mode, with the device taking the place of the TPU test.
Inputs stay at or below 10K rows where the reference interprets its kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sqlrs_tpu  # noqa: F401  (x64 on before the reference's arrays)
from sqlrs_tpu.ops import mxu_agg as ref
from sqlrs_tpu_torch.ops import mxu_agg as port


def _numpy_dense(keys, vals, g, key_min=0):
    k = keys - key_min
    m = (k >= 0) & (k < g)
    sums, counts = np.zeros(g, np.int64), np.zeros(g, np.int64)
    np.add.at(sums, k[m], vals[m])
    np.add.at(counts, k[m], 1)
    return sums, counts


def _both(keys, vals, g, bits, **kw):
    kr = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    kp = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    if "key_min" in kr:
        kr["key_min"] = jnp.int64(kr["key_min"])
    rs, rc = ref.mxu_groupby_dense(jnp.asarray(keys), jnp.asarray(vals), g, bits,
                                   interpret=True, **kr)
    ps, pc = port.mxu_groupby_dense(torch.from_numpy(keys), torch.from_numpy(vals),
                                    g, bits, **kp)
    assert ps.dtype == pc.dtype == torch.int64
    assert np.array_equal(ps.numpy(), np.asarray(rs))
    assert np.array_equal(pc.numpy(), np.asarray(rc))
    return ps.numpy(), pc.numpy()


@pytest.mark.parametrize("bits,hi", [(7, 100), (23, 1 << 23), (24, 1 << 24)])
def test_matches_reference_and_numpy(bits, hi):
    """Misses on both sides, 1-limb to 3-limb values, a row count that is
    no multiple of any block size; values 0 and 2^24 - 1 included."""
    rng = np.random.default_rng(bits)
    n, g = 9_001, 700
    keys = rng.integers(0, g, n).astype(np.int64)
    keys[::11] = -3
    keys[::17] = g + 9
    vals = rng.integers(0, hi, n).astype(np.int64)
    vals[::5] = 0
    vals[3::7] = hi - 1
    s, c = _both(keys, vals, g, bits)
    es, ec = _numpy_dense(keys, vals, g)
    assert np.array_equal(s, es) and np.array_equal(c, ec)


def test_rebase_keeps_far_keys_out():
    """Keys are rebased by key_min in int64 BEFORE the int32 cast: keys
    2^32 away from the domain would wrap into it as false hits."""
    rng = np.random.default_rng(1)
    n, g, key_min = 6_000, 300, 5_000_000_000
    keys = key_min + rng.integers(0, g, n)
    keys[::3] = keys[::3] + (1 << 32)          # wraps to an in-range int32
    keys[1::9] = key_min - (1 << 32) + 7
    keys[2::9] = key_min - 1
    vals = rng.integers(0, 1 << 10, n)
    s, c = _both(keys, vals, g, 10, key_min=key_min)
    es, ec = _numpy_dense(keys, vals, g, key_min)
    assert np.array_equal(s, es) and np.array_equal(c, ec)
    assert c.sum() == ((keys >= key_min) & (keys < key_min + g)).sum()


def test_with_perm_scatters_to_dim_row_order():
    rng = np.random.default_rng(2)
    n, g, key_min = 5_000, 64, 100
    dim_keys = key_min + rng.permutation(g)
    keys = key_min + rng.integers(-5, g + 5, n)
    vals = rng.integers(0, 128, n)
    s, c = _both(keys, vals, g, 7, key_min=key_min, dim_keys=dim_keys, with_perm=True)
    es, ec = _numpy_dense(keys, vals, g, key_min)
    assert np.array_equal(s, es[dim_keys - key_min])
    assert np.array_equal(c, ec[dim_keys - key_min])


@pytest.mark.parametrize("g", [1, 1 << 16], ids=["one_group", "two_pow_16"])
def test_group_count_extremes(g):
    rng = np.random.default_rng(g)
    n = 4_099
    keys = rng.integers(-2, g + 2, n)
    vals = np.full(n, (1 << 24) - 1, np.int64)
    vals[::4] = 0
    s, c = _both(keys, vals, g, 24)
    es, ec = _numpy_dense(keys, vals, g)
    assert np.array_equal(s, es) and np.array_equal(c, ec)


def test_plan_is_the_reference_plan():
    for g in (1, 255, 256, 4097, 1 << 16):
        for bits in (1, 8, 9, 24):
            assert port._plan(g, bits) == ref._plan(g, bits)
    assert (port.K_LO, port.MXU_MAX_GROUPS, port.MXU_MAX_VAL_BITS) == (
        ref.K_LO, ref.MXU_MAX_GROUPS, ref.MXU_MAX_VAL_BITS)


ELIGIBLE_ARGS = [
    (64, 99, 0, True),             # the headline shape
    (64, 99, None, True),
    (64, 99, 0, False),            # not dense
    (64, None, 0, True),           # value range unknown
    (64, 1 << 24, 0, True),        # 25 bits
    (64, (1 << 24) - 1, 0, True),  # 24 bits
    (64, 99, -1, True),            # a negative value
    (0, 99, 0, True),
    (1 << 16, 99, 0, True),
    ((1 << 16) + 1, 99, 0, True),
]


@pytest.mark.parametrize("mode", ["0", "interpret", "auto"])
def test_mxu_eligible_modes(monkeypatch, mode):
    """"0" never; "interpret" on any device with the reference's bounds;
    "auto" only for CUDA data (the reference: only on a TPU), so on the
    CPU both say no."""
    monkeypatch.setenv("SQLRS_TPU_MXU", mode)
    assert port.mxu_interpret_flag() == ref.mxu_interpret_flag() == (mode == "interpret")
    for args in ELIGIBLE_ARGS:
        got = port.mxu_eligible(*args, torch.device("cpu"))
        assert got == ref.mxu_eligible(*args), (mode, args)
        if mode == "auto":
            assert not got
    if mode == "auto":
        assert port.mxu_eligible(64, 99, 0, True, "cuda")
    if mode == "0":
        assert not port.mxu_eligible(64, 99, 0, True, "cuda")


@pytest.mark.parametrize("keys_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("vals_dtype", [np.int32, np.int64])
def test_stored_column_types(keys_dtype, vals_dtype):
    """The columns go to the kernel as stored, int32 or int64 keys and
    values: the same sums as the reference (which casts to int32 after its
    int64 rebase) and numpy."""
    rng = np.random.default_rng(7)
    n, g, key_min = 7_001, 900, -400
    keys = (key_min + rng.integers(-20, g + 20, n)).astype(keys_dtype)
    vals = rng.integers(0, 1 << 24, n).astype(vals_dtype)
    s, c = _both(keys, vals, g, 24, key_min=key_min)
    es, ec = _numpy_dense(keys.astype(np.int64), vals.astype(np.int64), g, key_min)
    assert np.array_equal(s, es) and np.array_equal(c, ec)


@pytest.mark.parametrize("keys_dtype", [np.int32, np.int64])
def test_validity_mask_is_a_miss(keys_dtype):
    """valid=False rows are misses: the port with the mask equals the
    reference on keys masked below the domain (the route's formulation
    before the mask moved into the kernel), and numpy."""
    rng = np.random.default_rng(8)
    n, g, key_min = 6_007, 512, 1_000
    keys = (key_min + rng.integers(0, g, n)).astype(keys_dtype)
    keys[::13] = key_min + g + 3
    valid = rng.random(n) < 0.8
    valid[::7] = False
    vals = rng.integers(0, 1 << 20, n).astype(np.int64)
    masked = np.where(valid, keys, key_min - 1).astype(keys_dtype)
    rs, rc = ref.mxu_groupby_dense(jnp.asarray(masked), jnp.asarray(vals), g, 20,
                                   interpret=True, key_min=jnp.int64(key_min))
    ps, pc = port.mxu_groupby_dense(torch.from_numpy(keys), torch.from_numpy(vals), g, 20,
                                    key_min=key_min, valid=torch.from_numpy(valid))
    assert np.array_equal(ps.numpy(), np.asarray(rs))
    assert np.array_equal(pc.numpy(), np.asarray(rc))
    es, ec = _numpy_dense(masked.astype(np.int64), vals, g, key_min)
    assert np.array_equal(ps.numpy(), es) and np.array_equal(pc.numpy(), ec)
    assert pc.numpy().sum() == (valid & (keys - key_min < g)).sum()


@pytest.mark.parametrize(
    "change",
    ["keys_int16", "vals_length", "no_groups", "too_many_groups", "valid_not_bool",
     "key_min_beyond_int64"],
)
def test_dense_group_sums_rejects_bad_inputs(change):
    keys = torch.zeros(10, dtype=torch.int32)
    vals = torch.zeros(10, dtype=torch.int32)
    valid, key_min = None, 0
    g = 4
    if change == "keys_int16":
        keys = keys.to(torch.int16)
    if change == "vals_length":
        vals = vals[:9]
    if change == "no_groups":
        g = 0
    if change == "too_many_groups":
        g = port.MXU_MAX_GROUPS + 1
    if change == "valid_not_bool":
        valid = torch.ones(10, dtype=torch.int32)
    if change == "key_min_beyond_int64":
        key_min = 1 << 63
    with pytest.raises(ValueError):
        port.dense_group_sums(keys, vals, g, key_min=key_min, valid=valid)


@pytest.mark.parametrize("bits,hi", [(7, 100), (23, 1 << 23)])
def test_dense_xla_formulation_matches_reference(bits, hi):
    """mxu_groupby_dense_xla (the one-hot products outside the kernel)
    against the reference's and numpy, exactly (tests/test_kernels.py:
    237-255): misses on both sides, 1- and 3-limb values, a row count that
    is no multiple of the block."""
    rng = np.random.default_rng(7)
    n, g = 70_000, 700
    keys = rng.integers(0, g, n).astype(np.int64)
    keys[::11] = -3
    keys[::17] = g + 9
    vals = rng.integers(0, hi, n).astype(np.int64)
    rs, rc = ref.mxu_groupby_dense_xla(jnp.asarray(keys), jnp.asarray(vals), g, bits)
    ps, pc = port.mxu_groupby_dense_xla(torch.from_numpy(keys), torch.from_numpy(vals), g, bits)
    assert ps.dtype == pc.dtype == torch.int64
    assert np.array_equal(ps.numpy(), np.asarray(rs))
    assert np.array_equal(pc.numpy(), np.asarray(rc))
    exp_s, exp_c = _numpy_dense(keys, vals, g)
    assert np.array_equal(ps.numpy(), exp_s) and np.array_equal(pc.numpy(), exp_c)
