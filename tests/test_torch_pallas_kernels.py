"""sqlrs_tpu_torch/ops/pallas_kernels.py against sqlrs_tpu/ops/pallas_kernels.py.

`row_rank_ge` and `masked_row_sum` on CPU tensors run their plain versions
(the rank stage's gather formulation); they must equal the reference's
Pallas kernels in interpret mode and numpy, int32 for int32: ragged query
counts, rem of 0 and 128, and queries below and above every lane.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sqlrs_tpu  # noqa: F401
from sqlrs_tpu.ops import pallas_kernels as ref
from sqlrs_tpu_torch.ops import pallas_kernels as port


def _sorted_blocks(rng, nb):
    return np.sort(rng.integers(0, 10_000, nb * 128).astype(np.int32)).reshape(nb, 128)


@pytest.mark.parametrize("nq", [1, 8, 203, 1024])
def test_row_rank_ge(nq):
    rng = np.random.default_rng(nq)
    nb = 64
    sp2d = _sorted_blocks(rng, nb)
    b = rng.integers(0, nb, nq).astype(np.int32)
    q = rng.integers(0, 10_000, nq).astype(np.int32)
    q[::3] = -1                 # below every lane
    q[1::3] = 10_001            # above every lane
    q[2::5] = sp2d[b[2::5], 17]  # equal to a lane
    got = port.row_rank_ge(torch.from_numpy(sp2d), torch.from_numpy(b), torch.from_numpy(q))
    assert got.dtype == torch.int32
    exp = (sp2d[b] >= q[:, None]).sum(1)
    assert np.array_equal(got.numpy(), exp)
    r = ref.row_rank_ge(jnp.asarray(sp2d), jnp.asarray(b), jnp.asarray(q), interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(r))


@pytest.mark.parametrize("nq", [1, 13, 500])
def test_masked_row_sum(nq):
    rng = np.random.default_rng(100 + nq)
    nb = 32
    v2d = rng.integers(-100, 100, (nb, 128)).astype(np.int32)
    b = rng.integers(0, nb, nq).astype(np.int32)
    rem = rng.integers(0, 129, nq).astype(np.int32)
    rem[::4] = 0
    rem[1::4] = 128
    got = port.masked_row_sum(torch.from_numpy(v2d), torch.from_numpy(b), torch.from_numpy(rem))
    assert got.dtype == torch.int32
    exp = np.array([v2d[b[i], : rem[i]].sum() for i in range(nq)])
    assert np.array_equal(got.numpy(), exp)
    r = ref.masked_row_sum(jnp.asarray(v2d), jnp.asarray(b), jnp.asarray(rem), interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(r))


def test_masked_row_sum_wraps_in_int32():
    """The sum accumulates in int32, as the reference's does."""
    v2d = np.full((8, 128), 1 << 30, np.int32)
    b = np.array([0, 3, 7], np.int32)
    rem = np.array([4, 5, 128], np.int32)
    got = port.masked_row_sum(torch.from_numpy(v2d), torch.from_numpy(b), torch.from_numpy(rem))
    exp = (rem.astype(np.int64) << 30).astype(np.uint32).view(np.int32)  # mod 2^32
    assert np.array_equal(got.numpy(), exp)
    r = ref.masked_row_sum(jnp.asarray(v2d), jnp.asarray(b), jnp.asarray(rem), interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(r))


@pytest.mark.parametrize("change", ["width", "int64_rows", "lengths", "int64_queries"])
def test_wrappers_reject_bad_inputs(change):
    x2d = torch.zeros(4, 128, dtype=torch.int32)
    b = torch.zeros(3, dtype=torch.int32)
    q = torch.zeros(3, dtype=torch.int32)
    if change == "width":
        x2d = torch.zeros(4, 64, dtype=torch.int32)
    if change == "int64_rows":
        x2d = x2d.long()
    if change == "lengths":
        q = q[:2]
    if change == "int64_queries":
        q = q.long()
    for fn in (port.row_rank_ge, port.masked_row_sum):
        with pytest.raises(ValueError):
            fn(x2d, b, q)
