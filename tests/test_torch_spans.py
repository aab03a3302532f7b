"""Spans (sqlrs_tpu_torch/utils/profiling.py) on the CPU, and the reading
that puts the device's idle time down to them (perfbench/spans.py).

- Off (the default), a span site tests one module global and runs no code
  of the recorder.
- On, the 22 TPC-H queries at SF 0.01, on one device and over 4 CPU
  shards: one `statement` root a statement, its four frontend phases
  under it, and the operator spans' names and nesting equal to the
  operator profile's list; every span of a statement carries its id.
- Under `programs.emulating()` a program call's input copy and replay
  nest as on the card; the string dictionary's tables and a full garbage
  collection are spans.
- `perfbench.spans.attribute` on planted records: idle time against nested
  spans, a host read, correlation ids, a gap across two statements, the
  clock check.
"""

import gc

import pytest
import torch

import sqlrs_tpu_torch
from perfbench import spans as reading
from sqlrs_tpu_torch.benchmarks import tpch_dbgen, tpch_queries
from sqlrs_tpu_torch.data.strings import StringDictionary
from sqlrs_tpu_torch.utils import profiling, programs

SF = 0.01
FRONTEND = ["frontend.parse", "frontend.bind", "frontend.optimize", "frontend.plan"]


@pytest.fixture(autouse=True)
def recording_off():
    profiling.stop()
    yield
    profiling.stop()


def test_off_records_and_allocates_nothing(monkeypatch):
    """Off, every span site tests RECORDER and runs its work directly: no
    code of the recorder runs, nothing is allocated for a span."""

    def refuse(*_a, **_k):
        raise AssertionError("span code ran with recording off")

    monkeypatch.setattr(profiling.Span, "__init__", refuse)
    for name in ("open", "close", "call", "statement", "statement_open"):
        monkeypatch.setattr(profiling.Recorder, name, refuse)
    monkeypatch.setattr(profiling, "operator", refuse)
    assert profiling.RECORDER is None
    db = sqlrs_tpu_torch.Database(device="cpu", n_devices=2)
    db.run("create table z(a int, s varchar); insert into z values (1, 'x'), (2, 'yy')")
    db.run("select s, sum(a) from z where s like 'y%' group by s order by s")
    one = sqlrs_tpu_torch.Database(device="cpu")
    tpch_dbgen.load_into(one, {"nation": tpch_dbgen.gen_tables(SF, seed=5)["nation"]})
    ctx = one.connect()
    with programs.emulating():
        assert len(one.run("select n_name from nation where n_name like 'A%' order by n_name"
                           "; select count(*) from nation")[0].columns) == 1
        assert ctx.query("select sum(n_nationkey) from nation").row_count() == 1
        prep = ctx.prepare("select n_name from nation where n_regionkey = 1")
        assert ctx.execute_prepared(prep).row_count() == 5
        assert len(ctx.query_all("select 1; select 2")) == 2
    gc.collect()
    assert profiling.RECORDER is None


@pytest.fixture(scope="module")
def tables():
    return tpch_dbgen.gen_tables(SF, seed=5)


@pytest.fixture(scope="module", params=["one device", "4 shards"])
def layout(request, tables):
    kw = {} if request.param == "one device" else {"n_devices": 4}
    db = sqlrs_tpu_torch.Database(device="cpu", profile=True, **kw)
    tpch_dbgen.load_into(db, tables)
    return request.param, db


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def _operator_list(spans, prefix):
    """(name, depth) of the operator spans whose names begin with prefix,
    in the order they closed; depth counts such spans above."""
    by_id = {s.id: s for s in spans}
    out = []
    for s in spans:
        if not s.name.startswith(prefix):
            continue
        depth, p = 0, by_id.get(s.parent)
        while p is not None:
            depth += p.name.startswith(prefix)
            p = by_id.get(p.parent)
        out.append((s.name, depth))
    return out


@pytest.mark.parametrize("qn", range(1, 23))
def test_tpch_span_trees(layout, qn):
    name, db = layout
    sql = tpch_queries.ALL[qn]
    for stmt in sql if isinstance(sql, list) else [sql]:
        with profiling.recording() as rec:
            db.run(stmt)
        spans = rec.spans()
        roots = [s for s in spans if s.parent is None]
        assert [s.name for s in roots] == ["statement"], roots
        root = roots[0]
        assert [s.name for s in _children(spans, root)][:4] == FRONTEND
        assert all(s.stmt == root.id for s in spans)
        # the operator spans are the profile's operators, nested alike
        if name == "one device":
            want = [("op:" + op.op, op.depth) for op in db.last_profile.ops]
            got = _operator_list(spans, "op:")
        else:
            want = [(op.op, op.depth) for op in db.last_profile.ops]
            got = _operator_list(spans, "dist:")
        assert got == want
        assert got or stmt.lstrip().lower().startswith(("create view", "drop view"))


def test_emulated_programs_nest_as_on_the_card(tables):
    db = sqlrs_tpu_torch.Database(device="cpu")
    tpch_dbgen.load_into(db, tables)
    with programs.emulating(), profiling.recording() as rec:
        for qn in (1, 3, 6):
            db.run(tpch_queries.ALL[qn])
    spans = rec.spans()
    by_id = {s.id: s for s in spans}
    replays = [s for s in spans if s.name == "programs.replay"]
    packs = [s for s in spans if s.name == "programs.pack"]
    assert replays and packs
    assert all(by_id[p.parent].name == "programs.replay" for p in packs)
    for r in replays:
        assert isinstance(r.detail, str) and r.detail  # the program's name
        p = by_id.get(r.parent)
        while p is not None and not p.name.startswith("op:"):
            p = by_id.get(p.parent)
        assert p is not None, "a replay outside every operator"
        assert r.start_ns >= p.start_ns and r.end_ns <= p.end_ns


def test_program_call_spans():
    add = programs.program(lambda x, y: x + y)
    x, y = torch.arange(5), torch.ones(5, dtype=torch.int64)
    with programs.emulating(), profiling.recording() as rec:
        out = add(x, y)
    assert out.tolist() == [1, 2, 3, 4, 5]
    replay, = [s for s in rec.spans() if s.name == "programs.replay"]
    pack, = [s for s in rec.spans() if s.name == "programs.pack"]
    assert pack.parent == replay.id and replay.detail == add.name
    assert replay.start_ns <= pack.start_ns <= pack.end_ns <= replay.end_ns


def test_string_tables_and_collections_are_spans():
    d = StringDictionary()
    d.intern_each(["b", "a", "c"])
    with profiling.recording() as rec:
        assert d.match_table("planted", lambda s: s < "b").tolist() == [False, True, False]
        d.match_table("planted", lambda s: s < "b")  # nothing new: no span
        assert d.ranks().tolist() == [1, 0, 2]
        d.intern("aa")
        d.ranks()
        gc.collect()
    names = [(s.name, s.detail) for s in rec.spans()]
    assert names[:3] == [("strings.match_table", 3), ("strings.ranks", 3), ("strings.ranks", 4)]
    assert ("gc", None) in names
    assert reading.dictionary_s(reading.host_spans(rec.spans())) > 0


def test_import_and_first_scan_are_spans(tables):
    db = sqlrs_tpu_torch.Database(device="cpu")
    with profiling.recording() as rec:
        tpch_dbgen.load_into(db, {"nation": tables["nation"]})
        db.catalog.table("nation").storage.scan(db.device)
        db.catalog.table("nation").storage.scan(db.device)  # cached: no span
    names = [(s.name, s.detail) for s in rec.spans()]
    assert names == [("storage.import", 1), ("storage.first_scan", 25)]


def test_trace_nested_in_recording_keeps_it_on(tmp_path):
    db = sqlrs_tpu_torch.Database(device="cpu")
    with profiling.recording() as rec:
        with profiling.trace(str(tmp_path)):
            db.run("select 1")
        assert profiling.RECORDER is rec
    assert profiling.RECORDER is None
    roots = [s.name for s in rec.spans() if s.parent is None]
    assert [n for n in roots if n != "gc"] == ["statement"]


# ---- the reading on planted records ----------------------------------------------------

H = reading.HostSpan
R = reading.Record


def planted():
    """Two statements in a window [0, 1000] ns: A parses, then an operator
    replays a program (whose input copy launches a kernel) and reads the
    host; the harness syncs across A's end; B binds, then an operator
    launches a kernel. The device idles over [0, 258], [262, 276],
    [330, 620] (from A's host read into B) and [700, 1000]."""
    spans = [
        H(0, None, "statement", "session", 100, 400),
        H(1, 0, "frontend.parse", "frontend", 110, 150),
        H(2, 0, "op:Scan", "operators", 200, 390),
        H(3, 2, "programs.replay", "programs", 250, 300, "m.prog"),
        H(4, 3, "programs.pack", "programs", 255, 260),
        H(5, None, "statement", "session", 500, 900),
        H(6, 5, "frontend.bind", "frontend", 510, 560),
        H(7, 5, "dist:Agg", "sharded engine", 600, 880),
    ]
    runtime = [
        R("cudaLaunchKernel", 256, 258, None, 2),
        R("cudaGraphLaunch", 270, 275, None, 1),
        R("cudaGraphLaunch", 302, 304, None, 9),  # 4 ns past its replay
        R("cudaStreamSynchronize", 320, 360, None, 3),
        R("cudaDeviceSynchronize", 395, 420, None, 4),
        R("cudaLaunchKernel", 605, 606, None, 5),
    ]
    device = [
        R("CatArrayBatchedCopy", 258, 262, 0, 2),
        R("graph kernel", 276, 330, 0, 1),
        R("reduce", 620, 700, 0, 5),
    ]
    return spans, device, runtime


def test_attribution_of_idle_time_reads_and_records():
    spans, device, runtime = planted()
    a = reading.attribute(spans, device, runtime, 0, 1000)
    assert a.idle_ns == 258 + 14 + 290 + 300
    by = {}
    for s, e, o in a.idle:
        key = reading.label(o)
        by[key] = by.get(key, 0) + e - s
    assert by == {
        "between statements": 100 + 80 + 100,
        "statement": 10 + 50 + 5 + 10 + 40 + 20,
        "frontend.parse": 40, "frontend.bind": 50,
        "op:Scan": 50 + 30, "dist:Agg": 20 + 180,
        "programs.replay(prog)": 5 + 14, "programs.pack": 3,
        "cudaStreamSynchronize": 30, "cudaDeviceSynchronize": 25,
    }
    # the gap across both statements is split between them and the harness
    owners = [o.id if o else None for s, e, o in a.idle if 330 <= s < 620]
    assert owners == [-1, 2, 0, -2, None, 5, 6, 5, 7]
    m = reading.metrics(a, passes=1, executions=2)
    assert m == pytest.approx({
        "frontend.run_ms": 90 / 2 / 1e6, "frontend.idle_ms": 90 / 1e6,
        "ops.host_reads": 1, "ops.host_read_ms": 40 / 1e6, "ops.idle_ms": 280 / 1e6,
        "programs.replay_host_ms": 50 / 1e6, "programs.input_copy_device_ms": 4 / 1e6,
    })
    assert reading.clock(a) == {"graph_launches": 2, "inside_replay_share": 0.5,
                                "largest_offset_us": 0.004, "device_records_correlated": 1.0,
                                "records_before_their_call": 0, "largest_move_us": 0.0,
                                "moved_records_before_their_call": 0}
    idle = reading.idle_breakdown(a, passes=1)
    assert idle["named_share"] == pytest.approx(1 - 135 / 862)
    assert idle["by_category_ms"]["host read in an operator"] == pytest.approx(30 / 1e6)
    assert idle["by_category_ms"]["host read"] == pytest.approx(25 / 1e6)


def test_named_gaps_carry_the_host_spans():
    spans, device, runtime = planted()
    a = reading.attribute(spans, device, runtime, 0, 1000)
    host = sorted((r.start, r.name) for r in runtime)
    gaps = reading.named_gaps(a, [(90, "Q1"), (490, "Q2")], host, top=2)
    assert gaps == [
        ["Q2: no CUDA call; host: dist:Agg → between statements", 300 / 1e9],
        ["Q1: 2 CUDA calls, most cudaDeviceSynchronize; host: "
         "cudaStreamSynchronize → dist:Agg (1 statement start inside)", 290 / 1e9],
    ]


def test_a_read_into_pageable_memory_waits_in_its_copy():
    """PyTorch reads a value by a copy to the host and a stream sync; into
    pageable memory the copy itself waits for the device. Both calls are
    the read's time; the sync alone counts it."""
    spans = [H(0, None, "op:Filter", "operators", 0, 100)]
    runtime = [R("cudaMemcpyAsync", 10, 60, None, 1), R("cudaStreamSynchronize", 60, 62, None, 2)]
    device = [R("Memcpy DtoH (Device -> Pageable)", 40, 41, 0, 1)]
    a = reading.attribute(spans, device, runtime, 0, 100)
    m = reading.metrics(a, passes=1, executions=1)
    assert m["ops.host_reads"] == 1
    assert m["ops.host_read_ms"] == pytest.approx(52 / 1e6)
    assert m["ops.idle_ms"] == pytest.approx(48 / 1e6)


def test_device_records_are_moved_onto_the_host_clock():
    """A device clock that falls behind the host's and is then set again:
    records that end an idle stretch read the offset, the others follow
    it, and none starts before its call once moved."""
    ms, lat = 1_000_000, 5_000
    calls = [R("cudaLaunchKernel", k * 100 * ms, k * 100 * ms + 1_000, None, k) for k in (1, 2, 3, 4)]
    drift = {1: 0, 2: -10 * ms, 3: -20 * ms, 4: 0}
    device = [R("kernel", c.start + lat + drift[c.correlation],
                c.start + lat + drift[c.correlation] + 20 * ms, 0, c.correlation) for c in calls]
    moved, largest = reading.align(device, calls, reading.clock_offset(device, calls))
    assert largest == 20 * ms - lat
    assert [r.start - c.start for r, c in zip(moved, calls)] == [lat, 0, 0, lat]
    a = reading.attribute([], device, calls, 0, 500 * ms)
    assert reading.clock(a)["records_before_their_call"] == 2
    assert reading.clock(a)["moved_records_before_their_call"] == 0
    assert a.idle_ns == 500 * ms - 4 * 20 * ms


def test_the_witness_reads_the_offset_without_correlation_ids():
    """Markers launched after each sync read the device clock's offset from
    the host's clock marks alone: as given, it follows the drift; less the
    offset the other records give, a launch's latency everywhere."""
    ms, lat = 1_000_000, 5_000
    calls = [R("cudaLaunchKernel", k * 100 * ms, k * 100 * ms + 1_000, None, k)
             for k in (0, 1, 2, 3, 4)]
    drift = {0: 0, 1: 0, 2: -10 * ms, 3: -20 * ms, 4: 0}
    device = [R("kernel", c.start + lat + drift[c.correlation],
                c.start + lat + drift[c.correlation] + 20 * ms, 0, c.correlation) for c in calls]
    offset = reading.clock_offset(device, calls)
    # a marker 50 ms after each kernel's call, its correlation id unknown;
    # the clock falls behind linearly, and is set again after the third
    marks = [c.start + 50 * ms for c in calls[1:]]
    behind = [-5 * ms, -15 * ms, -20 * ms, 0]
    markers = [R(reading.WITNESS + "(long)", t + lat + b, t + lat + b + 2_000, 0, -1)
               for t, b in zip(marks, behind)]
    w = reading.witness(markers, marks, offset)
    assert w == {"markers": 4, "lag_us": [-19_995, -4_995, 5], "moved_lag_us": [0, 0, 5]}
    assert reading.witness(markers[:3], marks, offset) is None
