"""`grouped_histogram` (sqlrs_tpu_torch/ops/mxu_grouped.py), the function
behind the port of sqlrs_tpu/ops/mxu_grouped.py::_kernel.

On the CPU its wrapper runs the plain PyTorch version, held here bit for
bit against a numpy brute force. Tests marked `cuda` hold the CUDA kernel
(csrc/mxu_grouped.cu) against the plain version on the card, and the whole
port on the card against the port on the CPU; they skip without CUDA.

This file imports no JAX, so it also runs on a machine with a card and no
JAX, with the repository's conftest (which pins JAX to the CPU) left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_histogram.py
"""

import numpy as np
import pytest
import torch

import sqlrs_tpu_torch
from sqlrs_tpu_torch.ops import mxu_grouped as port_mxu
from sqlrs_tpu_torch.types import LogicalType as LT

INT64_MAX = 2**63 - 1


def _histogram_case(seed, n, G, n_limbs, saturate=False, all_miss=False):
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, G, n, dtype=np.int32)
    miss = rng.random(n) < 0.125
    gid[miss] = np.where(rng.random(int(miss.sum())) < 0.5, -1, G).astype(np.int32)
    if all_miss:
        gid[:] = -1
    n_words = max(1, -(-n_limbs // 3))
    if saturate:
        words = np.full((n_words, n), 0xFFFFFF, np.int32)
    else:
        words = rng.integers(0, 1 << 24, (n_words, n), dtype=np.int32)
    plan = [(j // 3, (j % 3) * 8) for j in range(n_limbs)]
    return gid, words, plan


def _numpy_histogram(gid, words, plan, G):
    inr = (gid >= 0) & (gid < G)
    totals = np.zeros((1 + len(plan), G), np.int64)
    np.add.at(totals[0], gid[inr], 1)
    for i, (w, s) in enumerate(plan):
        np.add.at(totals[1 + i], gid[inr], (words[w][inr].astype(np.int64) >> s) & 255)
    first = np.full(G, INT64_MAX, np.int64)
    rows = np.flatnonzero(inr)
    np.minimum.at(first, gid[rows], rows)
    return totals, first


# (n, G, limb channels, every limb 255, every row a miss)
HIST_CASES = [
    (1, 1, 0, False, False),
    (2047, 4, 14, False, False),
    (2049, 1000, 31, True, False),
    (5000, 1024, 31, False, False),
    (3000, 7, 4, False, True),
    (4096, 33, 1, True, False),
]


@pytest.mark.parametrize("n,G,n_limbs,saturate,all_miss", HIST_CASES)
def test_plain_histogram_matches_numpy(n, G, n_limbs, saturate, all_miss):
    gid, words, plan = _histogram_case(n + G, n, G, n_limbs, saturate, all_miss)
    before = port_mxu.grouped_histogram.launches
    totals, first = port_mxu.grouped_histogram(
        torch.from_numpy(gid), torch.from_numpy(words), plan, G
    )
    et, ef = _numpy_histogram(gid, words, plan, G)
    assert totals.dtype == torch.int64 and first.dtype == torch.int64
    assert np.array_equal(totals.numpy(), et)
    assert np.array_equal(first.numpy(), ef)
    # a CPU tensor runs the plain version: no kernel launch is counted
    assert port_mxu.grouped_histogram.launches == before


@pytest.mark.parametrize(
    "change",
    ["gid_int64", "too_many_groups", "too_many_channels", "limb_outside_words"],
)
def test_histogram_wrapper_rejects_bad_inputs(change):
    gid, words, plan = _histogram_case(0, 100, 4, 3)
    gid_t, words_t, G = torch.from_numpy(gid), torch.from_numpy(words), 4
    if change == "gid_int64":
        gid_t = gid_t.long()
    if change == "too_many_groups":
        G = port_mxu.MXU_AGG_MAX_GROUPS + 1
    if change == "too_many_channels":
        plan = [(0, 0)] * port_mxu.MXU_AGG_MAX_CHANNELS
    if change == "limb_outside_words":
        plan = [(1, 0)]
    with pytest.raises(ValueError):
        port_mxu.grouped_histogram(gid_t, words_t, plan, G)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")


@pytest.mark.cuda
@pytest.mark.parametrize("n,G,n_limbs,saturate,all_miss", HIST_CASES)
def test_cuda_kernel_matches_plain(n, G, n_limbs, saturate, all_miss):
    _need_cuda()
    gid, words, plan = _histogram_case(n + G, n, G, n_limbs, saturate, all_miss)
    gid_t = torch.from_numpy(gid).cuda()
    words_t = torch.from_numpy(words).cuda()
    before = port_mxu.grouped_histogram.launches
    tk, fk = port_mxu.grouped_histogram(gid_t, words_t, plan, G)
    tp, fp = port_mxu.grouped_histogram_plain(gid_t, words_t, plan, G)
    torch.cuda.synchronize()
    assert port_mxu.grouped_histogram.launches == before + 1
    assert torch.equal(tk, tp) and torch.equal(fk, fp)
    et, ef = _numpy_histogram(gid, words, plan, G)
    assert np.array_equal(tk.cpu().numpy(), et) and np.array_equal(fk.cpu().numpy(), ef)


SQL = [
    "select s, count(*), sum(b), avg(c), sum(c * (1 - c)) from t where b > 3 group by s",
    "select s, b % 7, count(*) from t group by s, b % 7",
    "select count(*), sum(b), min(c), max(s) from t where c < 0.5",
    "select s, b, c from t where b between 10 and 20 order by c desc, s limit 9",
]


@pytest.mark.cuda
@pytest.mark.parametrize("sql", SQL)
def test_cuda_database_matches_cpu_database(sql):
    """The same SQL and data through the port on the card and on the CPU:
    equal row order and integer/string values, DOUBLE to rel 1e-12."""
    _need_cuda()
    rng = np.random.default_rng(5)
    n = 50_000
    s = np.array(["ab", "cd", "ef", "gh", "ij"])[rng.integers(0, 5, n)]
    b = rng.integers(0, 50, n).astype(np.int64)
    c = np.round(rng.uniform(0, 1, n), 2)
    results = []
    for device in ("cpu", "cuda"):
        db = sqlrs_tpu_torch.Database(device=device)
        db.create_memory_table_numpy(
            "t",
            [("s", LT.VARCHAR), ("b", LT.BIGINT), ("c", LT.DOUBLE)],
            [s, b, c],
        )
        results.append([tuple(r) for bt in db.run(sql) for r in bt.to_pylist()])
    cpu, cuda = results
    assert len(cpu) == len(cuda) > 0
    for rc, rg in zip(cpu, cuda):
        for x, y in zip(rc, rg):
            if isinstance(x, float):
                assert y == pytest.approx(x, rel=1e-12, abs=0)
            else:
                assert x == y
