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


def _numpy_dense_keyed(keys, vals, G, key_min, valid):
    """The contract in numpy: gid = key - key_min in int64 (wrapping), a
    miss when invalid or outside [0, G)."""
    with np.errstate(over="ignore"):
        k = keys.astype(np.int64) - np.int64(key_min)
    m = (k >= 0) & (k < G)
    if valid is not None:
        m &= valid
    sums, counts = np.zeros(G, np.int64), np.zeros(G, np.int64)
    np.add.at(sums, k[m], vals[m].astype(np.int64))
    np.add.at(counts, k[m], 1)
    return sums, counts


# (G, keys dtype, values dtype, key_min, with a mask, skew)
# G 8192 / 8193 / 40000 / 65536 make 1 / 2 / 5 / 8 interleaved owners; 8193
# and 40000 leave a ragged last slot
KEYED_CASES = [
    (8192, np.int64, np.int64, 0, False, "zipf"),
    (8193, np.int32, np.int32, -17, True, "ends"),
    (40000, np.int64, np.int32, 5_000_000_000, True, "zipf"),
    (65536, np.int32, np.int64, 0, False, "one_id"),
    (65536, np.int64, np.int64, -(1 << 40), True, "zipf"),
    (3, np.int64, np.int32, 1 << 62, False, "uniform"),
]


def _keyed_case(G, kdt, vdt, key_min, masked, skew, n=20_011, seed=0):
    """Keys with the given skew over [key_min, key_min + G), misses 2^32
    below and above the domain and just outside it; values of both signs
    (int64 ones near +-2^40, int32 ones over the whole range)."""
    rng = np.random.default_rng(seed + G + n)
    if skew == "zipf":
        gid = np.minimum(rng.zipf(1.2, n), G) - 1
    elif skew == "ends":
        gid = np.where(rng.random(n) < 0.5, 0, G - 1)
        gid[::3] = rng.integers(0, G, len(gid[::3]))
    elif skew == "one_id":
        gid = np.full(n, G // 3)
    else:
        gid = rng.integers(0, G, n)
    keys = gid.astype(np.int64) + key_min if kdt == np.int64 else gid + key_min
    keys = np.asarray(keys).astype(np.int64)
    if kdt == np.int64:
        keys[5::17] = keys[5::17] + (1 << 32)
        keys[6::17] = keys[6::17] - (1 << 32)
    keys[7::19] = key_min - 1
    keys[8::19] = key_min + G
    keys = keys.astype(kdt)
    if vdt == np.int64:
        vals = rng.integers(-(1 << 40), 1 << 40, n)
    else:
        vals = rng.integers(-(1 << 31), (1 << 31) - 1, n, dtype=np.int64)
        vals[::5] = np.iinfo(np.int32).min
    vals = vals.astype(vdt)
    valid = rng.random(n) < 0.75 if masked else None
    return keys, vals, valid


# (G, skew, val_bits): values in [0, 2^val_bits), which lets the kernel pack
# a count and a sum into one cell; 300,007 rows are 19 bits, so val_bits 26
# fills the cell (19 + 19 + 26 = 64) and 27 does not pack
PACKED_CASES = [(65536, "zipf", 7), (8193, "one_id", 26), (40000, "ends", 27)]


def _packed_case(G, skew, val_bits, n=300_007):
    keys, _, valid = _keyed_case(G, np.int64, np.int64, 3, True, skew, n=n)
    rng = np.random.default_rng(G + val_bits)
    vals = rng.integers(0, 1 << val_bits, n)
    vals[::7] = (1 << val_bits) - 1
    return keys, vals, valid


@pytest.mark.parametrize("G,skew,val_bits", PACKED_CASES)
def test_plain_dense_group_sums_with_value_bound(G, skew, val_bits):
    """val_bits is a promise about the values, not a change of result."""
    keys, vals, valid = _packed_case(G, skew, val_bits, n=20_011)
    t = torch.from_numpy
    sums, counts = mxu_agg.dense_group_sums(t(keys), t(vals), G, key_min=3,
                                            valid=t(valid), val_bits=val_bits)
    es, ec = _numpy_dense_keyed(keys, vals, G, 3, valid)
    assert np.array_equal(sums.numpy(), es) and np.array_equal(counts.numpy(), ec)


@pytest.mark.parametrize("G,kdt,vdt,key_min,masked,skew", KEYED_CASES)
def test_plain_dense_group_sums_keyed_contract(G, kdt, vdt, key_min, masked, skew):
    keys, vals, valid = _keyed_case(G, kdt, vdt, key_min, masked, skew)
    t = torch.from_numpy
    sums, counts = mxu_agg.dense_group_sums(
        t(keys), t(vals), G, key_min=key_min, valid=None if valid is None else t(valid))
    es, ec = _numpy_dense_keyed(keys, vals, G, key_min, valid)
    assert np.array_equal(sums.numpy(), es) and np.array_equal(counts.numpy(), ec)
    assert counts.numpy().sum() > 0


def _rank_case(nq, seed=0, what=()):
    """A sorted (64, 128) int32 array, block indices in [0, 64) and queries
    below, above and on its lanes, and lane counts 0..128. `what` may add:
    unsorted (rows not sorted), one_row (nb = 1), clip (block indices below
    0 and at or above nb), edges (rem of -5, 1, 127 and 200 too), and s2 (the
    uniform shape: 2^16 sorted rows, block indices uniform over them, each
    query a lane of its row +- 2, rem uniform in [0, 128])."""
    rng = np.random.default_rng(seed + nq)
    nb = 1 if "one_row" in what else (1 << 16 if "s2" in what else 64)
    x = rng.integers(-50_000, 50_000, nb * 128).astype(np.int32)
    sp2d = (x if "unsorted" in what else np.sort(x)).reshape(nb, 128)
    b = rng.integers(0, nb, nq).astype(np.int32)
    v2d = rng.integers(-(1 << 31), (1 << 31) - 1, (nb, 128)).astype(np.int32)
    if "s2" in what:
        q = sp2d[b, rng.integers(0, 128, nq)] + rng.integers(-2, 3, nq).astype(np.int32)
        return sp2d, v2d, b, q, rng.integers(0, 129, nq).astype(np.int32)
    q = rng.integers(-60_000, 60_000, nq).astype(np.int32)
    q[::4] = sp2d[b[::4], 64]
    q[1::9] = np.iinfo(np.int32).min
    q[2::9] = np.iinfo(np.int32).max
    rem = rng.integers(0, 129, nq).astype(np.int32)
    rem[::3] = 0
    rem[1::3] = 128
    if "edges" in what:
        rem[2::12] = -5
        rem[5::12] = 1
        rem[8::12] = 127
        rem[11::12] = 200
    if "clip" in what:
        b[3::11] = -3
        b[5::13] = nb + 2
        b[7::17] = np.iinfo(np.int32).max
    return sp2d, v2d, b, q, rem


def _numpy_rank(sp2d, v2d, b, q, rem):
    b = np.clip(b, 0, sp2d.shape[0] - 1)
    rank = (sp2d[b] >= q[:, None]).sum(1).astype(np.int32)
    lane = np.arange(128)
    s = np.where(lane[None, :] < rem[:, None], v2d[b].astype(np.int64), 0).sum(1)
    return rank, (s & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def _rank_param(nq, *what):
    return pytest.param(nq, what, id="-".join([*what, str(nq)]))


# (nq, what): the first four keep their ids
RANK_CASES = [_rank_param(nq) for nq in (1, 31, 33, 1000, 3, 4, 5, 32, 129)] + [
    _rank_param(1000, "unsorted"), _rank_param(129, "one_row", "edges"),
    _rank_param(1000, "clip", "edges"), _rank_param((1 << 17) + 5, "s2")]


@pytest.mark.parametrize("nq,what", RANK_CASES)
def test_plain_rank_kernels_match_numpy(nq, what):
    sp2d, v2d, b, q, rem = _rank_case(nq, what=what)
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
@pytest.mark.parametrize("G,kdt,vdt,key_min,masked,skew", KEYED_CASES)
def test_cuda_dense_group_sums_keyed_matches_plain(G, kdt, vdt, key_min, masked, skew):
    """The kernel on the columns as stored, at zipf and other skews, with
    1 to 8 interleaved owners: bit for bit against the plain version."""
    _need_cuda()
    keys, vals, valid = _keyed_case(G, kdt, vdt, key_min, masked, skew, n=300_007)
    k_t, v_t = torch.from_numpy(keys).cuda(), torch.from_numpy(vals).cuda()
    m_t = None if valid is None else torch.from_numpy(valid).cuda()
    before = mxu_agg.dense_group_sums.launches
    sk, ck = mxu_agg.dense_group_sums(k_t, v_t, G, key_min=key_min, valid=m_t)
    sp, cp = mxu_agg.dense_group_sums_plain(k_t, v_t, G, key_min=key_min, valid=m_t)
    torch.cuda.synchronize()
    assert mxu_agg.dense_group_sums.launches == before + 1
    assert torch.equal(sk, sp) and torch.equal(ck, cp)
    es, ec = _numpy_dense_keyed(keys, vals, G, key_min, valid)
    assert np.array_equal(sk.cpu().numpy(), es) and np.array_equal(ck.cpu().numpy(), ec)


@pytest.mark.cuda
@pytest.mark.parametrize("G,skew,val_bits", PACKED_CASES)
def test_cuda_dense_group_sums_packed_matches_plain(G, skew, val_bits):
    """With a value bound the kernel packs count and sum where they fit:
    bit for bit against the plain version, at the cell's edge too."""
    _need_cuda()
    keys, vals, valid = (torch.from_numpy(a).cuda() for a in _packed_case(G, skew, val_bits))
    sk, ck = mxu_agg.dense_group_sums(keys, vals, G, key_min=3, valid=valid,
                                      val_bits=val_bits)
    sp, cp = mxu_agg.dense_group_sums_plain(keys, vals, G, key_min=3, valid=valid)
    torch.cuda.synchronize()
    assert torch.equal(sk, sp) and torch.equal(ck, cp)


def _on_card_at(a, offset):
    """a on the card, at `offset` elements into a larger buffer (0: its own
    allocation): 128 keeps a 16-B aligned base, 3 does not."""
    t = torch.from_numpy(a).cuda()
    if not offset:
        return t
    buf = torch.zeros(offset + t.numel(), dtype=t.dtype, device=t.device)
    buf[offset:] = t.reshape(-1)
    return buf[offset:].view(t.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,what", RANK_CASES + [
    _rank_param(1000, "clip", "edges", "aligned_view"),
    _rank_param(1000, "clip", "edges", "misaligned_view"),
    _rank_param(33, "unsorted", "misaligned_view")])
def test_cuda_rank_kernels_match_plain(nq, what):
    """Bit for bit against the plain version, one launch each; the views
    put the rows at an aligned and a misaligned offset (the scalar-load
    form of the kernel)."""
    _need_cuda()
    offset = 128 if "aligned_view" in what else (3 if "misaligned_view" in what else 0)
    case = _rank_case(nq, what=what)
    sp2d, v2d = (_on_card_at(a, offset) for a in case[:2])
    b, q, rem = (torch.from_numpy(a).cuda() for a in case[2:])
    assert (sp2d.data_ptr() % 16 == 0) == (offset != 3)
    before = (pallas_kernels.row_rank_ge.launches, pallas_kernels.masked_row_sum.launches)
    rank = pallas_kernels.row_rank_ge(sp2d, b, q)
    msum = pallas_kernels.masked_row_sum(v2d, b, rem)
    torch.cuda.synchronize()
    assert (pallas_kernels.row_rank_ge.launches, pallas_kernels.masked_row_sum.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(rank, pallas_kernels.row_rank_ge_plain(sp2d, b, q))
    assert torch.equal(msum, pallas_kernels.masked_row_sum_plain(v2d, b, rem))
    er, es = _numpy_rank(*case)
    assert np.array_equal(rank.cpu().numpy(), er) and np.array_equal(msum.cpu().numpy(), es)


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
