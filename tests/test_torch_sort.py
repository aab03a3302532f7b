"""sqlrs_tpu_torch/ops/sort.py against sqlrs_tpu/ops/sort.py: the same key
columns, made from a seed with numpy, must give the same permutation,
including float keys holding -0.0, +0.0, NaN of either sign and +-inf,
NULLs, duplicate keys (stability), both directions and several keys."""

import numpy as np
import pytest
import torch

import sqlrs_tpu  # noqa: F401  (x64)
import jax.numpy as jnp
from sqlrs_tpu.data import Column as RefColumn
from sqlrs_tpu.data.strings import GLOBAL_STRINGS as REF_STRINGS
from sqlrs_tpu.ops import sort as ref_sort
from sqlrs_tpu.types import LogicalType as RLT

from sqlrs_tpu_torch.data import Column as PortColumn
from sqlrs_tpu_torch.data.strings import GLOBAL_STRINGS as PORT_STRINGS
from sqlrs_tpu_torch.ops import fused as port_fused
from sqlrs_tpu_torch.ops import sort as port_sort
from sqlrs_tpu_torch.types import LogicalType as PLT

N = 400


def _float_keys(rng):
    special = np.array(
        [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1.5, -1.5], np.float64
    )
    return special[rng.integers(0, len(special), N)]


def _make(rng, kind):
    valid = rng.random(N) > 0.15
    if kind == "double":
        return "DOUBLE", _float_keys(rng), valid
    if kind == "bigint":
        return "BIGINT", rng.integers(-3, 4, N).astype(np.int64), valid
    if kind == "date":
        return "DATE", rng.integers(9000, 9004, N).astype(np.int32), valid
    words = np.array(["pear", "apple", "fig", "", "apple pie"])
    return "VARCHAR", words[rng.integers(0, len(words), N)], valid


def _cols(tname, data, valid):
    if tname == "VARCHAR":
        strs = [s if v else None for s, v in zip(data.tolist(), valid.tolist())]
        rdata = REF_STRINGS.intern_many(strs)
        pdata = PORT_STRINGS.intern_many(strs)
    else:
        rdata = pdata = data
    ref = RefColumn(RLT[tname], jnp.asarray(rdata), jnp.asarray(valid))
    port = PortColumn(PLT[tname], torch.from_numpy(pdata.copy()), torch.from_numpy(valid.copy()))
    return ref, port


CASES = [
    (("double",), (True,)),
    (("double",), (False,)),
    (("bigint", "double"), (True, False)),
    (("varchar", "double"), (False, True)),
    (("date", "varchar", "bigint"), (True, True, False)),
]


@pytest.mark.parametrize("kinds,ascs", CASES)
def test_sort_indices_match_reference(kinds, ascs):
    rng = np.random.default_rng(len(kinds) * 10 + sum(ascs))
    pairs = [_cols(*_make(rng, k)) for k in kinds]
    ref = ref_sort.sort_indices([(r, a) for (r, _), a in zip(pairs, ascs)])
    port = port_sort.sort_indices([(p, a) for (_, p), a in zip(pairs, ascs)])
    assert np.array_equal(np.asarray(ref), port.numpy())


def test_sort_rows_and_compaction_match_reference():
    rng = np.random.default_rng(3)
    kr, kp = _cols(*_make(rng, "double"))
    vr, vp = _cols(*_make(rng, "bigint"))
    ref = ref_sort.sort_rows([(kr, False)], [kr, vr])
    port = port_sort.sort_rows([(kp, False)], [kp, vp])
    for r, p in zip(ref, port):
        assert np.array_equal(np.asarray(r.valid), p.valid.numpy())
        np.testing.assert_array_equal(np.asarray(r.data), p.data.numpy())
    keep = rng.random(N) > 0.5
    keep_valid = rng.random(N) > 0.1
    count = int((keep & keep_valid).sum())
    r_keep = RefColumn(RLT.BOOLEAN, jnp.asarray(keep), jnp.asarray(keep_valid))
    p_keep = PortColumn(PLT.BOOLEAN, torch.from_numpy(keep), torch.from_numpy(keep_valid))
    assert np.array_equal(
        np.asarray(ref_sort.compact_indices(r_keep, count)),
        port_fused.compact_indices(p_keep.data, p_keep.valid, count).numpy(),
    )
