"""The star rollup's kernels: `dense_group_sums` (ops/mxu_agg.py, the port of
sqlrs_tpu/ops/mxu_agg.py::_mxu_kernel) and `row_rank_ge` / `masked_row_sum`
(ops/pallas_kernels.py, the ports of sqlrs_tpu/ops/pallas_kernels.py's two
kernels).

On the CPU each wrapper runs its plain PyTorch version, held here bit for
bit against numpy. Tests marked `cuda` hold each CUDA kernel
(csrc/mxu_agg.cu, csrc/pallas_kernels.cu) against its plain version on the
card, and the port's star rollup on the card against the port on the CPU;
they skip without CUDA.

This file imports no JAX, so it also runs on a machine with a card and no
JAX, with the repository's conftest (which pins JAX to the CPU) left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dense_kernels.py
"""

import numpy as np
import pytest
import torch

import sqlrs_tpu_torch
from sqlrs_tpu_torch.ops import mxu_agg, pallas_kernels
from sqlrs_tpu_torch.types import LogicalType as LT

# (n, G, values below, every row a miss)
DENSE_CASES = [
    (1, 1, 1 << 7, False),
    (2047, 256, 1 << 24, False),
    (2049, 4097, 1 << 7, False),
    (5000, 65536, 1 << 24, False),
    (3000, 7, 1 << 24, True),
    (4096, 1, 1 << 24, False),
]


def _dense_case(n, G, hi, all_miss, seed=0):
    rng = np.random.default_rng(seed + n + G)
    gid = rng.integers(0, G, n, dtype=np.int32)
    gid[::9] = -1
    gid[4::11] = G
    gid[7::13] = np.iinfo(np.int32).min
    if all_miss:
        gid[:] = -1
    vals = rng.integers(0, hi, n, dtype=np.int32)
    vals[::5] = hi - 1
    vals[1::7] = 0
    return gid, vals


def _numpy_dense(gid, vals, G):
    m = (gid >= 0) & (gid < G)
    sums, counts = np.zeros(G, np.int64), np.zeros(G, np.int64)
    np.add.at(sums, gid[m], vals[m].astype(np.int64))
    np.add.at(counts, gid[m], 1)
    return sums, counts


@pytest.mark.parametrize("n,G,hi,all_miss", DENSE_CASES)
def test_plain_dense_group_sums_matches_numpy(n, G, hi, all_miss):
    gid, vals = _dense_case(n, G, hi, all_miss)
    before = mxu_agg.dense_group_sums.launches
    sums, counts = mxu_agg.dense_group_sums(torch.from_numpy(gid), torch.from_numpy(vals), G)
    es, ec = _numpy_dense(gid, vals, G)
    assert sums.dtype == counts.dtype == torch.int64
    assert np.array_equal(sums.numpy(), es) and np.array_equal(counts.numpy(), ec)
    # a CPU tensor runs the plain version: no kernel launch is counted
    assert mxu_agg.dense_group_sums.launches == before


def _rank_case(nq, seed=0):
    """A sorted (64, 128) int32 array, clipped block indices and queries
    below, above and on its lanes, and lane counts 0..128."""
    rng = np.random.default_rng(seed + nq)
    nb = 64
    sp2d = np.sort(rng.integers(-50_000, 50_000, nb * 128).astype(np.int32)).reshape(nb, 128)
    b = rng.integers(0, nb, nq).astype(np.int32)
    q = rng.integers(-60_000, 60_000, nq).astype(np.int32)
    q[::4] = sp2d[b[::4], 64]
    q[1::9] = np.iinfo(np.int32).min
    q[2::9] = np.iinfo(np.int32).max
    rem = rng.integers(0, 129, nq).astype(np.int32)
    rem[::3] = 0
    rem[1::3] = 128
    v2d = rng.integers(-(1 << 31), (1 << 31) - 1, (nb, 128)).astype(np.int32)
    return sp2d, v2d, b, q, rem


def _numpy_rank(sp2d, v2d, b, q, rem):
    rank = (sp2d[b] >= q[:, None]).sum(1).astype(np.int32)
    lane = np.arange(128)
    s = np.where(lane[None, :] < rem[:, None], v2d[b].astype(np.int64), 0).sum(1)
    return rank, (s & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("nq", [1, 31, 33, 1000])
def test_plain_rank_kernels_match_numpy(nq):
    sp2d, v2d, b, q, rem = _rank_case(nq)
    t = torch.from_numpy
    before = (pallas_kernels.row_rank_ge.launches, pallas_kernels.masked_row_sum.launches)
    rank = pallas_kernels.row_rank_ge(t(sp2d), t(b), t(q))
    msum = pallas_kernels.masked_row_sum(t(v2d), t(b), t(rem))
    er, es = _numpy_rank(sp2d, v2d, b, q, rem)
    assert rank.dtype == msum.dtype == torch.int32
    assert np.array_equal(rank.numpy(), er) and np.array_equal(msum.numpy(), es)
    assert before == (pallas_kernels.row_rank_ge.launches,
                      pallas_kernels.masked_row_sum.launches)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")


@pytest.mark.cuda
@pytest.mark.parametrize("n,G,hi,all_miss", DENSE_CASES)
def test_cuda_dense_group_sums_matches_plain(n, G, hi, all_miss):
    _need_cuda()
    gid, vals = _dense_case(n, G, hi, all_miss)
    g_t, v_t = torch.from_numpy(gid).cuda(), torch.from_numpy(vals).cuda()
    before = mxu_agg.dense_group_sums.launches
    sk, ck = mxu_agg.dense_group_sums(g_t, v_t, G)
    sp, cp = mxu_agg.dense_group_sums_plain(g_t, v_t, G)
    torch.cuda.synchronize()
    assert mxu_agg.dense_group_sums.launches == before + 1
    assert torch.equal(sk, sp) and torch.equal(ck, cp)
    es, ec = _numpy_dense(gid, vals, G)
    assert np.array_equal(sk.cpu().numpy(), es) and np.array_equal(ck.cpu().numpy(), ec)


@pytest.mark.cuda
@pytest.mark.parametrize("nq", [1, 31, 33, 1000])
def test_cuda_rank_kernels_match_plain(nq):
    _need_cuda()
    sp2d, v2d, b, q, rem = (torch.from_numpy(a).cuda() for a in _rank_case(nq))
    before = (pallas_kernels.row_rank_ge.launches, pallas_kernels.masked_row_sum.launches)
    rank = pallas_kernels.row_rank_ge(sp2d, b, q)
    msum = pallas_kernels.masked_row_sum(v2d, b, rem)
    torch.cuda.synchronize()
    assert (pallas_kernels.row_rank_ge.launches, pallas_kernels.masked_row_sum.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(rank, pallas_kernels.row_rank_ge_plain(sp2d, b, q))
    assert torch.equal(msum, pallas_kernels.masked_row_sum_plain(v2d, b, rem))


STAR_SQL = [
    "select d.k, sum(f.v), count(*) from f join d on f.k = d.k group by d.k order by d.k",
    "select d.k, sum(f.v), count(*) from f join d on f.k = d.k group by d.k",
    "select d.k, min(f.v), max(f.v), avg(f.v), count(distinct f.v) from f join d "
    "on f.k = d.k group by d.k order by d.k desc",
    "select d.k, sum(f.x), avg(f.x), min(f.x) from f join d on f.k = d.k "
    "group by d.k order by d.k",
]


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "spread"])
@pytest.mark.parametrize("sql", STAR_SQL)
def test_cuda_star_rollup_matches_cpu(sql, dense):
    """The star rollup through the port on the card and on the CPU: the
    same route names and rows, integers exactly, DOUBLE to rel 1e-12."""
    _need_cuda()
    rng = np.random.default_rng(3)
    g, n = 4096, 200_000
    dim = np.arange(g, dtype=np.int64)
    if not dense:
        dim = dim * 1013904223 + 12345
    fk = dim[np.minimum(rng.zipf(1.2, n), g) - 1]
    fk[::17] = -5
    fv = rng.integers(0, 100, n).astype(np.int64)
    fx = np.round(rng.uniform(0, 1000, n), 2)
    results = []
    for device in ("cpu", "cuda"):
        db = sqlrs_tpu_torch.Database(device=device)
        db.create_memory_table_numpy(
            "f", [("k", LT.BIGINT), ("v", LT.BIGINT), ("x", LT.DOUBLE)], [fk, fv, fx])
        db.create_memory_table_numpy("d", [("k", LT.BIGINT)], [dim])
        db.last_fused_routes = []
        rows = [tuple(r) for b in db.run(sql) for r in b.to_pylist()]
        results.append((rows, list(db.last_fused_routes)))
    (cpu, cpu_routes), (cuda, cuda_routes) = results
    assert cpu_routes and cuda_routes[0].startswith(cpu_routes[0])
    assert len(cpu) == len(cuda) > 0
    for rc, rg in zip(cpu, cuda):
        for x, y in zip(rc, rg):
            if isinstance(x, float):
                assert y == pytest.approx(x, rel=1e-12, abs=0)
            else:
                assert x == y
