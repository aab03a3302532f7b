"""sqlrs_tpu_torch/ops/mxu_grouped.py against sqlrs_tpu/ops/mxu_grouped.py.

The same inputs, made from a seed with numpy, go through the reference's
`mxu_grouped_aggregate` (its Pallas kernel in interpret mode, as
tests/test_mxu_grouped.py runs it) and the port's (here on the CPU, so its
histogram is the plain PyTorch version). Cases mirror
tests/test_mxu_grouped.py. Group order and integer outputs must be equal;
DOUBLE outputs agree to rel 1e-12 (the reference's division by a constant
10^k may sit one ulp from the port's correctly rounded one), and each test
records whether they were bit-equal.

The histogram under the aggregation has its own tests, which need no JAX:
tests/test_torch_histogram.py.
"""

import numpy as np
import pytest
import torch

import sqlrs_tpu  # noqa: F401  (x64)
import jax.numpy as jnp
from sqlrs_tpu.data import Column as RefColumn
from sqlrs_tpu.ops import mxu_grouped as ref_mxu
from sqlrs_tpu.types import LogicalType as RLT

from sqlrs_tpu_torch.data import Column as PortColumn
from sqlrs_tpu_torch.ops import mxu_grouped as port_mxu
from sqlrs_tpu_torch.types import LogicalType as PLT

@pytest.fixture(autouse=True)
def _mxu_interpret(monkeypatch):
    monkeypatch.setenv("SQLRS_TPU_MXU", "interpret")
    monkeypatch.setenv("SQLRS_TPU_MXU_AGG_MIN_ROWS", "0")


def _cols(tname, data, valid=None):
    """(reference Column, port Column) over the same numpy values."""
    data = np.asarray(data)
    valid = np.ones(len(data), bool) if valid is None else np.asarray(valid, bool)
    ref = RefColumn(RLT[tname], jnp.asarray(data), jnp.asarray(valid))
    port = PortColumn(PLT[tname], torch.from_numpy(data.copy()), torch.from_numpy(valid.copy()))
    return ref, port


def _run_both(keys, aggs, alive=None):
    """keys: [(type name, data, valid)]; aggs: [(name, col index | None,
    result type name)] over `vals` columns given as (type name, data,
    valid). Returns (reference result, port result)."""
    kp = [_cols(*k) for k in keys["keys"]]
    vp = [_cols(*v) for v in keys.get("vals", [])]
    ref_specs = [
        (name, vp[ci][0] if ci is not None else None, RLT[rt], False)
        for name, ci, rt in aggs
    ]
    port_specs = [
        (name, vp[ci][1] if ci is not None else None, PLT[rt], False)
        for name, ci, rt in aggs
    ]
    ref_alive = None if alive is None else jnp.asarray(alive)
    port_alive = None if alive is None else torch.from_numpy(np.asarray(alive).copy())
    ref = ref_mxu.mxu_grouped_aggregate([k[0] for k in kp], ref_specs, alive=ref_alive)
    port = port_mxu.mxu_grouped_aggregate([k[1] for k in kp], port_specs, alive=port_alive)
    return ref, port


def _assert_same(ref, port, record_property):
    assert (ref is None) == (port is None)
    if ref is None:
        return
    rg, ra, rn = ref
    pg, pa, pn = port
    assert rn == pn
    bit_equal = True
    for r, p in zip(rg + ra, pg + pa):
        assert r.type.name == p.type.name
        rd, rv = np.asarray(r.data)[:rn], np.asarray(r.valid)[:rn]
        pd, pv = p.data.numpy(), p.valid.numpy()
        assert np.array_equal(rv, pv)
        if rd.dtype.kind == "f":
            np.testing.assert_allclose(pd[pv], rd[rv], rtol=1e-12, atol=0)
            bit_equal &= bool(np.array_equal(pd[pv], rd[rv]))
        else:
            assert pd.dtype == rd.dtype
            assert np.array_equal(pd[pv], rd[rv])
    record_property("double_outputs_bit_equal", bit_equal)


def test_differential_int_sum_first_appearance(record_property):
    rng = np.random.default_rng(7)
    n = 3000
    case = {
        "keys": [("BIGINT", rng.integers(10, 26, n))],
        "vals": [("BIGINT", rng.integers(-1000, 1000, n), rng.random(n) > 0.15)],
    }
    aggs = [("count", None, "BIGINT"), ("sum", 0, "BIGINT"), ("count", 0, "BIGINT")]
    ref, port = _run_both(case, aggs)
    assert port is not None
    _assert_same(ref, port, record_property)


@pytest.mark.parametrize("vmin", [0, -1])
def test_signed_bias_boundaries(vmin, record_property):
    n = 1024
    v = np.full(n, vmin, dtype=np.int64)
    v[::2] = 100
    case = {"keys": [("BIGINT", np.zeros(n, np.int64))], "vals": [("BIGINT", v)]}
    ref, port = _run_both(case, [("sum", 0, "BIGINT")])
    assert port is not None and int(port[1][0].data[0]) == int(v.sum())
    _assert_same(ref, port, record_property)


@pytest.mark.parametrize("vmax", [(1 << 24) - 1, 1 << 24])
def test_value_at_limb_boundary(vmax, record_property):
    n = 2048
    v = np.zeros(n, dtype=np.int64)
    v[:100] = vmax
    case = {
        "keys": [("BIGINT", np.arange(n, dtype=np.int64) % 4)],
        "vals": [("BIGINT", v)],
    }
    ref, port = _run_both(case, [("sum", 0, "BIGINT"), ("count", None, "BIGINT")])
    assert port is not None
    _assert_same(ref, port, record_property)


@pytest.mark.parametrize("extra,fires", [(0, True), (1, False)])
def test_group_cap_boundary(extra, fires, record_property):
    g = port_mxu.MXU_AGG_MAX_GROUPS + extra
    n = 4096
    case = {
        "keys": [("BIGINT", np.arange(n, dtype=np.int64) % g)],
        "vals": [("BIGINT", np.ones(n, np.int64))],
    }
    ref, port = _run_both(case, [("sum", 0, "BIGINT")])
    assert (port is not None) == fires
    _assert_same(ref, port, record_property)


def test_double_fixed_point_and_products(record_property):
    """2dp decimals and their computed 4dp/6dp products, sums and avgs."""
    rng = np.random.default_rng(3)
    n = 2000
    p = np.round(rng.uniform(900, 105000, n), 2)
    d = np.round(rng.uniform(0, 0.1, n), 2)
    t = np.round(rng.uniform(0, 0.08, n), 2)
    case = {
        "keys": [("BIGINT", rng.integers(0, 3, n))],
        "vals": [("DOUBLE", p), ("DOUBLE", p * (1 - d)), ("DOUBLE", p * (1 - d) * (1 + t))],
    }
    aggs = [
        ("sum", 0, "DOUBLE"), ("avg", 0, "DOUBLE"),
        ("sum", 1, "DOUBLE"), ("sum", 2, "DOUBLE"), ("avg", 2, "DOUBLE"),
    ]
    ref, port = _run_both(case, aggs)
    assert port is not None
    _assert_same(ref, port, record_property)


def test_null_keys_and_alive_mask(record_property):
    rng = np.random.default_rng(5)
    n = 1500
    case = {
        "keys": [
            ("BIGINT", rng.integers(0, 5, n), rng.random(n) > 0.1),
            ("VARCHAR", rng.integers(0, 3, n).astype(np.int32), rng.random(n) > 0.2),
        ],
        "vals": [("BIGINT", rng.integers(0, 100, n), rng.random(n) > 0.3)],
    }
    aggs = [("count", None, "BIGINT"), ("sum", 0, "BIGINT"), ("avg", 0, "DOUBLE")]
    ref, port = _run_both(case, aggs, alive=rng.random(n) > 0.3)
    assert port is not None
    _assert_same(ref, port, record_property)


@pytest.mark.parametrize(
    "kind",
    ["non_decimal_double", "min_aggregate", "distinct", "no_live_rows", "wide_span"],
)
def test_ineligible_inputs_both_none(kind):
    rng = np.random.default_rng(11)
    n = 500
    keys = [("BIGINT", rng.integers(0, 4, n))]
    vals = [("DOUBLE", rng.uniform(0, 1, n) if kind == "non_decimal_double"
             else np.round(rng.uniform(0, 10, n), 2))]
    aggs = [("sum", 0, "DOUBLE")]
    alive = None
    if kind == "min_aggregate":
        aggs = [("min", 0, "DOUBLE")]
    if kind == "no_live_rows":
        alive = np.zeros(n, bool)
    if kind == "wide_span":
        keys = [("BIGINT", rng.integers(0, 1 << 20, n))]
    if kind == "distinct":
        kp = [_cols(*k) for k in keys]
        vp = [_cols(*v) for v in vals]
        ref = ref_mxu.mxu_grouped_aggregate(
            [kp[0][0]], [("sum", vp[0][0], RLT.DOUBLE, True)]
        )
        port = port_mxu.mxu_grouped_aggregate(
            [kp[0][1]], [("sum", vp[0][1], PLT.DOUBLE, True)]
        )
    else:
        ref, port = _run_both({"keys": keys, "vals": vals}, aggs, alive=alive)
    assert ref is None and port is None
