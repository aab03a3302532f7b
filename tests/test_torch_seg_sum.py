"""The legacy DISTINCT path's per-group sums (sqlrs_tpu_torch/ops/grouping.
seg_sum), and that the path gives the same bits on every run.

Float sums take a fixed order: a stable sort by group id, the fixed-order
prefix sum of ops/fused.prefix_sum, and a difference at each group's
bounds. (A float `index_add_` is atomics on CUDA, which add in another
order on every run.) Integer sums take `index_add_`, exact in any order.
On the CPU the sums are held to numpy: integers exactly, floats to rel
1e-9 of the group's sum of magnitudes plus the rounding of the prefix sums
(as in the sorted GROUP BY, a float sum is a difference of two prefix
sums, so its error also scales with the prefix's magnitude: 8 ulps of the
sum of all magnitudes). Tests marked `cuda` run the same sums, and a
multi-argument DISTINCT query that takes the path, twice on the card: the
two runs must be equal bit for bit, and equal the CPU run to the same
bound; they skip without CUDA.

This file imports no JAX, so it also runs on a machine with a card and no
JAX, with the repository's conftest (which pins JAX to the CPU) left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_seg_sum.py
"""

import numpy as np
import pytest
import torch

import sqlrs_tpu_torch
from sqlrs_tpu_torch.ops.grouping import seg_sum
from sqlrs_tpu_torch.types import LogicalType as LT

CASES = [(0, 3), (1, 1), (4099, 37), (20000, 4096), (20000, 19990)]


def _case(n, n_groups, dtype, seed=0):
    rng = np.random.default_rng(seed + n + n_groups)
    gid = rng.integers(0, max(n_groups - 2, 1), n)
    if np.dtype(dtype).kind == "f":
        # money-like values: 2 decimals, three orders of magnitude
        data = (np.round(rng.uniform(-500, 500, n), 2) * 10.0 ** rng.integers(0, 3, n))
        data = data.astype(dtype)
    else:
        data = rng.integers(-(2**40), 2**40, n).astype(dtype)
    valid = rng.random(n) < 0.9
    return gid, data, valid


def _numpy(gid, data, valid, n_groups):
    """(sums, error bound per group)."""
    exact = np.zeros(n_groups, np.float64 if data.dtype.kind == "f" else data.dtype)
    mag = np.zeros(n_groups)
    np.add.at(exact, gid[valid], data[valid])
    np.add.at(mag, gid[valid], np.abs(data[valid]).astype(np.float64))
    return exact, 1e-9 * mag + 8 * np.finfo(np.float64).eps * mag.sum()


def _run(gid, data, valid, n_groups, dev):
    return seg_sum(torch.from_numpy(data).to(dev), torch.from_numpy(valid).to(dev),
                   torch.from_numpy(gid).to(dev), n_groups)


@pytest.mark.parametrize("dtype", ["float64", "int64"])
@pytest.mark.parametrize("n,n_groups", CASES)
def test_seg_sum_matches_numpy(n, n_groups, dtype):
    gid, data, valid = _case(n, n_groups, dtype)
    got = _run(gid, data, valid, n_groups, "cpu").numpy()
    exact, bound = _numpy(gid, data, valid, n_groups)
    assert got.dtype == data.dtype and got.shape == (n_groups,)
    if dtype == "float64":
        assert np.all(np.abs(got - exact) <= bound)
    else:
        assert np.array_equal(got, exact)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_groups", CASES)
def test_cuda_seg_sum_same_bits_every_run(n, n_groups):
    _need_cuda()
    gid, data, valid = _case(n, n_groups, "float64", seed=1)
    first = _run(gid, data, valid, n_groups, "cuda").cpu()
    for _ in range(3):
        assert torch.equal(_run(gid, data, valid, n_groups, "cuda").cpu(), first)
    exact, bound = _numpy(gid, data, valid, n_groups)
    assert np.all(np.abs(first.numpy() - exact) <= bound)
    cpu = _run(gid, data, valid, n_groups, "cpu").numpy()
    assert np.all(np.abs(first.numpy() - cpu) <= 2 * bound)


@pytest.mark.cuda
def test_cuda_legacy_distinct_query_same_bits_every_run():
    """Two DISTINCT arguments send the query down the legacy path; its float
    sums must come out the same on every run, and as on the CPU."""
    _need_cuda()
    rng = np.random.default_rng(5)
    n = 200_000
    k = rng.integers(0, 3000, n)
    v = rng.integers(0, 50, n)
    x = np.round(rng.uniform(-500, 500, n), 2)
    sql = ("select k, count(distinct v), count(distinct x), sum(x), avg(x) from t"
           " group by k")
    runs = {}
    for dev in ("cuda", "cpu"):
        db = sqlrs_tpu_torch.Database(device=dev)
        db.create_memory_table_numpy(
            "t", [("k", LT.BIGINT), ("v", LT.BIGINT), ("x", LT.DOUBLE)], [k, v, x])
        runs[dev] = [[r for b in db.run(sql) for r in b.to_pylist()] for _ in range(2)]
    first, second = runs["cuda"]
    assert first == second  # bit for bit: Python floats compare exactly
    assert len(first) == len(runs["cpu"][0]) == 3000
    mag = np.bincount(k, weights=np.abs(x), minlength=3000)
    bound = 1e-9 * mag + 16 * np.finfo(np.float64).eps * mag.sum()
    cnt = np.bincount(k, minlength=3000)
    for a, b in zip(first, runs["cpu"][0]):
        assert a[:3] == b[:3]
        assert abs(a[3] - b[3]) <= bound[a[0]]
        assert abs(a[4] - b[4]) <= bound[a[0]] / cnt[a[0]]
