"""sqlrs_tpu_torch/ops/pallas_kernels.py against sqlrs_tpu/ops/pallas_kernels.py.

`row_rank_ge` and `masked_row_sum` on CPU tensors run their plain versions
(the rank stage's gather formulation); they must equal the reference's
Pallas kernels in interpret mode and numpy, int32 for int32: ragged query
counts, unsorted rows, a single row, rem of every edge (-5, 0, 1, 127, 128,
200), and queries below and above every lane. Block indices below 0 and at
or above nb are held against numpy only: the reference takes them clipped.
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


def _clip_out(rng, b, nb):
    """Some block indices below 0 and some at or above nb, and numpy's
    clipped copy."""
    b = b.copy()
    b[3::11] = -3
    b[5::13] = nb + rng.integers(0, 5)
    b[7::17] = np.iinfo(np.int32).min
    return b, np.clip(b, 0, nb - 1)


def _case(nq, **kw):
    return pytest.param(nq, kw, id="-".join([*kw, str(nq)]))


# (nq, what): the first cases keep their ids; with unsorted the rows are not
# sorted, one_row is nb = 1, clip puts block indices outside [0, nb)
RANK_CASES = [_case(nq) for nq in (1, 8, 203, 1024, 3, 4, 5, 32, 33, 129)] + [
    _case(203, unsorted=True), _case(33, one_row=True), _case(203, clip=True)]


@pytest.mark.parametrize("nq,what", RANK_CASES)
def test_row_rank_ge(nq, what):
    rng = np.random.default_rng(nq)
    nb = 1 if what.get("one_row") else 64
    if what.get("unsorted"):
        sp2d = rng.integers(0, 10_000, (nb, 128)).astype(np.int32)
    else:
        sp2d = _sorted_blocks(rng, nb)
    b = rng.integers(0, nb, nq).astype(np.int32)
    q = rng.integers(0, 10_000, nq).astype(np.int32)
    q[::3] = -1                 # below every lane
    q[1::3] = 10_001            # above every lane
    q[2::5] = sp2d[b[2::5], 17]  # equal to a lane
    bc = b
    if what.get("clip"):
        b, bc = _clip_out(rng, b, nb)
    got = port.row_rank_ge(torch.from_numpy(sp2d), torch.from_numpy(b), torch.from_numpy(q))
    assert got.dtype == torch.int32
    exp = (sp2d[bc] >= q[:, None]).sum(1)
    assert np.array_equal(got.numpy(), exp)
    if not what.get("clip"):
        r = ref.row_rank_ge(jnp.asarray(sp2d), jnp.asarray(b), jnp.asarray(q), interpret=True)
        assert np.array_equal(got.numpy(), np.asarray(r))


# with edges, rem takes -5, 1, 127 and 200 beside 0 and 128
SUM_CASES = [_case(nq) for nq in (1, 13, 500, 3, 4, 5, 32, 33, 129)] + [
    _case(129, edges=True), _case(500, edges=True), _case(33, one_row=True, edges=True),
    _case(500, clip=True, edges=True)]


@pytest.mark.parametrize("nq,what", SUM_CASES)
def test_masked_row_sum(nq, what):
    rng = np.random.default_rng(100 + nq)
    nb = 1 if what.get("one_row") else 32
    v2d = rng.integers(-100, 100, (nb, 128)).astype(np.int32)
    b = rng.integers(0, nb, nq).astype(np.int32)
    rem = rng.integers(0, 129, nq).astype(np.int32)
    rem[::4] = 0
    rem[1::4] = 128
    if what.get("edges"):
        rem[2::8] = -5
        rem[3::8] = 1
        rem[6::8] = 127
        rem[7::8] = 200
    bc = b
    if what.get("clip"):
        b, bc = _clip_out(rng, b, nb)
    got = port.masked_row_sum(torch.from_numpy(v2d), torch.from_numpy(b), torch.from_numpy(rem))
    assert got.dtype == torch.int32
    exp = np.array([v2d[bc[i], : max(rem[i], 0)].sum() for i in range(nq)])
    assert np.array_equal(got.numpy(), exp)
    if not what.get("clip"):
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


# tests/test_pallas.py's own inputs (its seeds and shapes), held the same way


@pytest.mark.parametrize("nq", [8, 200, 1024])
def test_row_rank_ge_reference_inputs(nq):
    rng = np.random.default_rng(0)
    nb = 64
    sp2d = np.sort(rng.integers(0, 10_000, (nb, 128)).astype(np.int32).ravel()).reshape(nb, 128)
    b = rng.integers(0, nb, nq).astype(np.int32)
    q = rng.integers(0, 10_000, nq).astype(np.int32)
    got = port.row_rank_ge(torch.from_numpy(sp2d), torch.from_numpy(b), torch.from_numpy(q))
    assert np.array_equal(got.numpy(), (sp2d[b] >= q[:, None]).sum(1))
    r = ref.row_rank_ge(jnp.asarray(sp2d), jnp.asarray(b), jnp.asarray(q), interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(r))


def test_masked_row_sum_reference_inputs():
    rng = np.random.default_rng(1)
    nb, nq = 32, 500
    v2d = rng.integers(0, 100, (nb, 128)).astype(np.int32)
    b = rng.integers(0, nb, nq).astype(np.int32)
    rem = rng.integers(0, 129, nq).astype(np.int32)
    got = port.masked_row_sum(torch.from_numpy(v2d), torch.from_numpy(b), torch.from_numpy(rem))
    assert np.array_equal(got.numpy(), np.array([v2d[b[i], : rem[i]].sum() for i in range(nq)]))
    r = ref.masked_row_sum(jnp.asarray(v2d), jnp.asarray(b), jnp.asarray(rem), interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(r))
