"""The spans reading: the engine's own spans (sqlrs_tpu_torch/utils/profiling.py)
beside torch.profiler's CUDA records, on one clock, and what they say of
the device's idle time, the host's reads and set-up.

    python3 -m perfbench.spans --workload NAME --seed N --seconds S [--out DIR]

runs the cell as `perfbench.run --trace 1` does (set-up, the window, the
three traced readings, the comparison), with spans recorded during set-up
and a fourth reading after the three: TRACE_PASSES passes under
torch.profiler (CUDA activity) with spans recorded. Its last line of
output, also written to DIR/spans_<cell>.json (DIR: `spans_out/` in the
checkout unless --out names another), holds the run's result object and
the reading (`reading`): the eight per-layer values below, the clock
check, the device's idle time by the host's innermost span, the longest
idle gaps named by the query and the host's spans at their ends, and the
cost of recording.

The reading, from the records (`attribute`, a pure function):

- the device records are first moved onto the host's clock (`align`),
  by an offset read from the records that end an idle stretch
  (`clock_offset`);
- each device-idle interval (no kernel, copy or set record on any card)
  is put down to the host's innermost span at each instant of it: a
  runtime call that waits for the device counts as the innermost span
  while it lasts (SYNC_CALLS, and a copy to pageable host memory, which
  returns only once the copy is done); no span open is the harness's time
  between executions;
- each kernel and copy record goes to the span that launched it, through
  the runtime call with its correlation id;
- the clock check: the share of `cudaGraphLaunch` records that lie inside
  a `programs.replay` span, and the largest distance of one outside; the
  device records that start before their call, before and after `align`;
  and a witness of the offset that needs no correlation id (`witness`):
  after each execution's sync, with the card idle, the host reads its
  clock and launches a marker kernel, which starts a launch's latency
  later on one clock.

Values (`metrics`): frontend.run_ms (ms a query: the frontend spans of an
execution), frontend.idle_ms (ms a pass: idle under a frontend span),
ops.host_reads (a pass: SYNC_CALLS inside an operator span, `op:` or
`dist:`; PyTorch reads a value by a copy to the host, then a stream sync),
ops.host_read_ms (ms a pass: the host's time in them and in copies to
pageable memory there), ops.idle_ms (ms a pass: idle under an operator
span, outside those calls),
programs.replay_host_ms (ms a pass: the host's time in replay spans),
programs.input_copy_device_ms (ms a pass: device time of the records
launched inside `programs.pack` spans) and storage.dictionary_s (s:
`strings.match_table` and `strings.ranks` spans during set-up).
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import sys
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import NamedTuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# runtime calls that make the host wait for the device (`cudaMemcpy` is the
# synchronous copy; PyTorch's reads are cudaMemcpyAsync + a stream sync)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
OPERATORS = ("op:", "dist:")  # operator spans' names begin so
BETWEEN = "between statements"  # no span open: the harness's time


class HostSpan(NamedTuple):
    """A span of the host's timeline: an engine span, or a runtime call that
    waits for the device (layer "sync", id negative; detail True where it
    counts as a host read: one of SYNC_CALLS)."""

    id: int
    parent: int | None
    name: str
    layer: str
    start: int
    end: int
    detail: object = None


class Record(NamedTuple):
    """A torch.profiler record: a runtime call on the host (card None) or a
    kernel, copy or set on card `card`."""

    name: str
    start: int
    end: int
    card: int | None
    correlation: int


def host_spans(spans) -> list[HostSpan]:
    """The recorder's closed spans (utils/profiling.Span) as HostSpans."""
    return [HostSpan(s.id, s.parent, s.name, s.layer, s.start_ns, s.end_ns, s.detail)
            for s in spans if s.end_ns is not None]


def innermost(spans: list[HostSpan], t0: int, t1: int) -> list[tuple[int, int, HostSpan | None]]:
    """[t0, t1] cut into segments (start, end, the innermost open span, or
    None where none is open), in order. Spans nest."""
    segs: list = []
    stack: list[HostSpan] = []
    cursor = t0

    def emit(upto: int) -> None:
        nonlocal cursor
        upto = min(max(upto, t0), t1)
        if upto > cursor:
            segs.append((cursor, upto, stack[-1] if stack else None))
            cursor = upto

    for s in sorted(spans, key=lambda s: (s.start, -s.end)):
        while stack and stack[-1].end <= s.start:
            emit(stack[-1].end)
            stack.pop()
        emit(s.start)
        stack.append(s)
    while stack:
        emit(stack[-1].end)
        stack.pop()
    emit(t1)
    return segs


def idle_intervals(device: list[Record], t0: int, t1: int) -> list[tuple[int, int]]:
    """The intervals of [t0, t1] in which no card ran a record."""
    from perfbench.trace import _union

    return [(s, e) for _d, s, e in _union(sorted((r.start, r.end, r.name) for r in device),
                                          t0, t1)[1]]


def _owner_at(segs, starts: list[int], t: int):
    """The innermost span at instant t of `innermost`'s segments, whose
    starts are `starts`."""
    i = bisect.bisect_right(starts, t) - 1
    return segs[i][2] if i >= 0 and t < segs[i][1] else None


@dataclass
class Attribution:
    """What `attribute` puts down to the host's spans."""

    window: tuple[int, int]
    spans: list  # the HostSpans, the sync calls among them
    parents: dict  # id -> HostSpan
    segs: list  # `innermost` of the spans, the sync calls among them
    idle: list = field(default_factory=list)  # (start, end, owner HostSpan | None)
    idle_ns: int = 0
    syncs: list = field(default_factory=list)  # the sync calls' HostSpans
    launched: list = field(default_factory=list)  # (device Record, owner | None)
    graph_launches: int = 0
    graph_inside: int = 0
    graph_offset_ns: int = 0
    correlated: int = 0
    before_call: int = 0  # device records that start before their call, as given
    aligned_before_call: int = 0  # and once moved
    shift_ns: int = 0  # the largest move of a record onto the host's clock
    offset: object = None  # `clock_offset`'s function

    def ancestors(self, s: HostSpan | None):
        while s is not None:
            yield s
            s = self.parents.get(s.parent)

    def within(self, s: HostSpan | None, pred) -> bool:
        return any(pred(a) for a in self.ancestors(s))


IDLE_NS = 10_000  # an idle stretch, for `align`: longer than the gaps between a graph's kernels


def clock_offset(device: list[Record], runtime: list[Record]):
    """The device clock's offset from the host's (ns, at most 0) as a
    function of the host's time. A record that ends an idle stretch started
    as soon as its call reached the card: its lag (its start less its
    call's) reads the offset at that call. Between two such readings the
    offset is taken as falling linearly (the device clock falling behind),
    or, where the later reading is higher (the clock was set again), as the
    earlier one. No record starts before its call, so the offset is at most
    the least lag of the calls in the same ms, and at most 0, since a late
    device clock cannot be told from a queue."""
    calls = {r.correlation: r.start for r in runtime}
    least: dict = {}  # ms of the call -> the least lag of its records
    for r in device:
        c = calls.get(r.correlation)
        if c is not None:
            least[c // 1_000_000] = min(least.get(c // 1_000_000, 0), r.start - c)
    samples, reach = [], None
    for r in sorted(device, key=lambda r: r.start):
        if reach is not None and r.start - reach >= IDLE_NS and r.correlation in calls:
            samples.append((calls[r.correlation], r.start - calls[r.correlation]))
        reach = r.end if reach is None else max(reach, r.end)
    samples.sort()
    times = [t for t, _g in samples]

    def offset(t: int) -> int:
        bound = least.get(t // 1_000_000, 0)
        i = bisect.bisect_right(times, t) - 1
        if i < 0:
            return bound
        t_a, g_a = samples[i]
        if i + 1 < len(samples) and samples[i + 1][1] < g_a:
            t_b, g_b = samples[i + 1]
            g_a += (g_b - g_a) * (t - t_a) // (t_b - t_a)
        return min(bound, g_a)

    return offset


def align(device: list[Record], runtime: list[Record], offset) -> tuple[list[Record], int]:
    """The device records moved by `offset` (`clock_offset`'s) at their
    calls onto the host's clock, and the largest move (ns)."""
    calls = {r.correlation: r.start for r in runtime}
    out, moved = [], 0
    for r in device:
        d = offset(calls.get(r.correlation, r.start))
        moved = max(moved, -d)
        out.append(r._replace(start=r.start - d, end=r.end - d))
    return out, moved


def attribute(spans: list[HostSpan], device: list[Record], runtime: list[Record],
              t0: int, t1: int) -> Attribution:
    """Put the window [t0, t1]'s device-idle time, its synchronising calls
    and its device records down to the host's spans (see the module
    docstring), the records first moved onto the host's clock (`align`)."""
    calls = {r.correlation: r for r in runtime}
    before = sum(r.start < calls[r.correlation].start for r in device if r.correlation in calls)
    offset = clock_offset(device, runtime)
    device, shift = align(device, runtime, offset)
    base = innermost(spans, t0, t1)
    base_starts = [s for s, _e, _o in base]
    pageable = {r.correlation for r in device
                if r.name.startswith("Memcpy DtoH") and "Pageable" in r.name}
    waits = sorted((r for r in runtime if r.name in SYNC_CALLS
                    or (r.name.startswith("cudaMemcpy") and r.correlation in pageable)),
                   key=lambda r: r.start)
    syncs = []
    for k, r in enumerate(waits):
        if r.end < t0 or r.start > t1:
            continue
        owner = _owner_at(base, base_starts, r.start)
        syncs.append(HostSpan(-1 - k, owner.id if owner else None, r.name, "sync",
                              r.start, r.end, r.name in SYNC_CALLS))
    every = list(spans) + syncs
    segs = innermost(every, t0, t1)
    a = Attribution(window=(t0, t1), spans=every, parents={s.id: s for s in every},
                    segs=segs, syncs=syncs, before_call=before, shift_ns=shift, offset=offset)
    # idle intervals against the segments, both in order
    j = 0
    for s, e in idle_intervals(device, t0, t1):
        a.idle_ns += e - s
        while j < len(segs) and segs[j][1] <= s:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < e:
            lo, hi = max(s, segs[k][0]), min(e, segs[k][1])
            if hi > lo:
                a.idle.append((lo, hi, segs[k][2]))
            k += 1
    # device records to the spans that launched them
    for r in device:
        call = calls.get(r.correlation)
        if call is not None:
            a.correlated += 1
            a.aligned_before_call += r.start < call.start
        a.launched.append((r, None if call is None else _owner_at(base, base_starts, call.start)))
    # the clock: graph launches inside replay spans
    replays = sorted((s for s in spans if s.name == "programs.replay"), key=lambda s: s.start)
    starts = [s.start for s in replays]
    for r in runtime:
        if r.name != "cudaGraphLaunch" or r.end < t0 or r.start > t1:
            continue
        a.graph_launches += 1
        i = bisect.bisect_right(starts, r.start) - 1
        if i >= 0 and r.end <= replays[i].end:
            a.graph_inside += 1
            continue
        off = [r.end - replays[i].end] if i >= 0 else []
        if i + 1 < len(replays):
            off.append(replays[i + 1].start - r.start)
        a.graph_offset_ns = max(a.graph_offset_ns, min(off) if off else t1 - t0)
    return a


def category(a: Attribution, owner: HostSpan | None) -> str:
    """The kind of host work an idle instant is put down to."""
    if owner is None:
        return BETWEEN
    if owner.layer == "sync":
        return "host read in an operator" if a.within(owner, _is_operator) else "host read"
    if owner.name.startswith("frontend."):
        return "frontend"
    if owner.name == "statement":
        return "statement, outside its phases"
    return owner.layer


def _is_operator(s: HostSpan) -> bool:
    return s.name.startswith(OPERATORS)


def label(owner: HostSpan | None) -> str:
    """A span as the breakdown names it."""
    if owner is None:
        return BETWEEN
    if owner.name.startswith("programs.") and owner.detail:
        return f"{owner.name}({str(owner.detail).rsplit('.', 1)[-1]})"
    return owner.name[:48]


def metrics(a: Attribution, passes: int, executions: int) -> dict:
    """The reading's values over the spans reading's passes (storage's
    from set-up: `dictionary_s`)."""
    ops_syncs = [s for s in a.syncs if a.within(s, _is_operator)]
    ops_reads = [s for s in ops_syncs if s.detail]
    front = sum(s.end - s.start for s in a.spans if s.name.startswith("frontend."))
    idle_front = sum(e - s for s, e, o in a.idle
                     if o is not None and o.name.startswith("frontend."))
    idle_ops = sum(e - s for s, e, o in a.idle if o is not None and _is_operator(o))
    replay = sum(s.end - s.start for s in a.spans if s.name == "programs.replay")
    pack = sum(r.end - r.start for r, o in a.launched
               if a.within(o, lambda s: s.name == "programs.pack"))
    return {
        "frontend.run_ms": front / 1e6 / max(executions, 1),
        "frontend.idle_ms": idle_front / 1e6 / passes,
        "ops.host_reads": len(ops_reads) / passes,
        "ops.host_read_ms": sum(s.end - s.start for s in ops_syncs) / 1e6 / passes,
        "ops.idle_ms": idle_ops / 1e6 / passes,
        "programs.replay_host_ms": replay / 1e6 / passes,
        "programs.input_copy_device_ms": pack / 1e6 / passes,
    }


def dictionary_s(spans) -> float:
    """Seconds in the string dictionary's match and rank tables."""
    return sum(s.end - s.start for s in spans
               if s.name in ("strings.match_table", "strings.ranks")) / 1e9


def _seconds_by_name(spans) -> dict:
    """Seconds by span name, operators and statements left out."""
    by: Counter = Counter()
    for s in spans:
        if not s.name.startswith(OPERATORS) and s.name != "statement":
            by[s.name] += s.end - s.start
    return {k: v / 1e9 for k, v in by.most_common()}


def idle_breakdown(a: Attribution, passes: int, top: int = 12) -> dict:
    """Idle ms a pass by category and by the innermost span's label, and
    the share put down to a named span or to the time between statements
    (not to a statement outside its phases)."""
    by_cat: Counter = Counter()
    by_label: Counter = Counter()
    for s, e, o in a.idle:
        by_cat[category(a, o)] += e - s
        by_label[label(o)] += e - s
    unnamed = by_cat.get("statement, outside its phases", 0)
    return {
        "idle_ms": a.idle_ns / 1e6 / passes,
        "named_share": 1.0 - unnamed / a.idle_ns if a.idle_ns else None,
        "by_category_ms": {k: v / 1e6 / passes for k, v in by_cat.most_common()},
        "by_span_ms": [[k, v / 1e6 / passes] for k, v in by_label.most_common(top)],
    }


def named_gaps(a: Attribution, marks, host, top: int = 10) -> list:
    """The longest idle gaps, named as the traced run's breakdown names
    them, then the host's innermost span at the gap's start and end."""
    from perfbench.trace import _gap_name

    gaps = sorted(idle_intervals([r for r, _o in a.launched], *a.window),
                  key=lambda g: g[0] - g[1])[:top]
    starts = [g for g, _e, _o in a.segs]
    roots = [sp.start for sp in a.spans if sp.name == "statement"]
    out = []
    for s, e in gaps:
        names = (f"{label(_owner_at(a.segs, starts, s))} → "
                 f"{label(_owner_at(a.segs, starts, e - 1))}")
        crossed = sum(s < r < e for r in roots)
        if crossed:
            names += f" ({crossed} statement start{'s' if crossed > 1 else ''} inside)"
        out.append([f"{_gap_name((e - s, s, e), marks, host)}; host: {names}", (e - s) / 1e9])
    return out


def recording_cost(db, stream, devices, rounds: int) -> dict:
    """Whole passes with recording off and on, in the order off, on, on,
    off, `rounds` times, on the host's clock (no profiler): the medians, ms
    a pass, and their ratio."""
    import statistics

    from perfbench.harness import _sync, execute
    from sqlrs_tpu_torch.utils import profiling

    times: dict = {False: [], True: []}
    for on in (False, True, True, False) * rounds:
        _sync(devices)
        t0 = time.perf_counter()
        with profiling.recording() if on else contextlib.nullcontext():
            for ex in stream.next_pass():
                execute(db, ex)
                _sync(devices)
        times[on].append((time.perf_counter() - t0) * 1e3)
    off, on = statistics.median(times[False]), statistics.median(times[True])
    # one span's own cost, alone: a loop of spans under a fresh recorder
    with profiling.recording() as rec:
        t0 = time.perf_counter()
        for _ in range(20000):
            rec.call("cost", "cost", None, int)
        span_us = (time.perf_counter() - t0) / 20000 * 1e6
    return {"off_pass_ms": times[False], "on_pass_ms": times[True], "on_over_off": on / off,
            "span_us": span_us}


def clock(a: Attribution) -> dict:
    """The two clocks against each other: host spans against the runtime's
    graph launches, and each device record's start against the call that
    launched it (never before it, on one clock)."""
    return {"graph_launches": a.graph_launches,
            "inside_replay_share": a.graph_inside / a.graph_launches if a.graph_launches else None,
            "largest_offset_us": a.graph_offset_ns / 1e3,
            "device_records_correlated": a.correlated / len(a.launched) if a.launched else None,
            "records_before_their_call": a.before_call,
            "largest_move_us": a.shift_ns / 1e3,
            "moved_records_before_their_call": a.aligned_before_call}


WITNESS = "spin_kernel"  # the marker: torch.cuda._sleep's kernel, which the engine never runs


def witness(markers: list[Record], marks: list[int], offset) -> dict | None:
    """The clock witness: each marker's start less the host's clock read
    just before its launch (`marks`, in order), with the card idle, as
    given and less `offset` (`clock_offset`'s from the other records) at the
    mark: µs, least, median, largest. On one clock each lag is a launch's
    latency, a few µs. None unless each mark has its marker."""
    if not markers or len(markers) != len(marks):
        return None

    def spread(xs: list[int]) -> list[float]:
        xs = sorted(xs)
        return [xs[0] / 1e3, xs[len(xs) // 2] / 1e3, xs[-1] / 1e3]

    lags = [r.start - t for r, t in zip(sorted(markers, key=lambda r: r.start), marks)]
    return {"markers": len(markers), "lag_us": spread(lags),
            "moved_lag_us": spread([g - offset(t) for g, t in zip(lags, marks)])}


# ---- the reading on the card ------------------------------------------------------


def _records(prof) -> tuple[list[Record], list[Record]]:
    """torch.profiler's records: (device, runtime calls), without the
    profiler's own device records."""
    from perfbench.trace import OVERHEAD

    device, runtime = [], []
    for e in prof.profiler.kineto_results.events():
        s = int(e.start_ns())
        r = Record(e.name(), s, s + int(e.duration_ns()),
                   int(e.device_index()) if "CUDA" in str(e.device_type()) else None,
                   int(e.correlation_id()))
        if r.card is None:
            runtime.append(r)
        elif r.end > r.start and r.name not in OVERHEAD:
            device.append(r)
    return device, runtime


def spans_passes(run, db, stream, passes: int) -> dict:
    """The fourth traced reading: `passes` passes under torch.profiler (CUDA
    activity; the CPU's in the CPU tests) with spans recorded, a clock
    witness after each execution on the card; the reading's dict."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench.harness import _sync, execute
    from sqlrs_tpu_torch.utils import profiling

    marks, witness_marks = [], []
    card = torch.device(run.devices[0])
    _sync(run.devices)
    activity = ProfilerActivity.CUDA if card.type == "cuda" else ProfilerActivity.CPU
    with profiling.recording() as rec, profile(activities=[activity]) as prof:
        t0 = time.time_ns()
        for _ in range(passes):
            for ex in stream.next_pass():
                marks.append((time.time_ns(), f"Q{ex.qn}"))
                execute(db, ex)
                _sync(run.devices)
                if card.type == "cuda":
                    witness_marks.append(time.time_ns())
                    with torch.cuda.device(card):
                        torch.cuda._sleep(1000)
        _sync(run.devices)
        t1 = time.time_ns()
    spans = [s for s in host_spans(rec.spans()) if s.start >= t0 and s.end <= t1]
    device, runtime = _records(prof)
    markers = [r for r in device if WITNESS in r.name and r.card == card.index]
    device = [r for r in device if WITNESS not in r.name]
    a = attribute(spans, device, runtime, t0, t1)
    first = run.trace_summary
    return {
        "passes": passes,
        "executions": len(marks),
        "metrics": metrics(a, passes, len(marks)),
        "clock": dict(clock(a), witness=witness(markers, witness_marks, a.offset)),
        "idle": idle_breakdown(a, passes),
        "idle_gaps": named_gaps(a, marks, sorted((r.start, r.name) for r in runtime)),
        "host_reads_by_span": Counter(
            label(a.parents.get(s.parent)) for s in a.syncs if s.detail).most_common(15),
        "spans_a_pass": len(spans) / passes,
        "pass_ms": (t1 - t0) / 1e6 / passes,
        "first_reading_pass_ms": first.window_s / first.passes * 1e3 if first else None,
    }


def trace_file(db, stream, devices, path: str) -> dict:
    """One execution under profiling.trace into `path`; the share of the
    trace file's cudaGraphLaunch events inside a programs.replay span of
    its span track (the file's own clock)."""
    from perfbench.harness import _sync, execute
    from sqlrs_tpu_torch.utils import profiling

    ex = stream.next_pass()[0]
    with profiling.trace(path):
        execute(db, ex)
        _sync(devices)
    with open(os.path.join(path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    replays = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("name") == "programs.replay" and e.get("ph") == "X")
    starts = [s for s, _e in replays]
    n = inside = 0
    for e in events:
        if e.get("name") != "cudaGraphLaunch" or "dur" not in e:
            continue
        n += 1
        i = bisect.bisect_right(starts, e["ts"]) - 1
        inside += i >= 0 and e["ts"] + e["dur"] <= replays[i][1]
    return {"query": f"Q{ex.qn}", "graph_launches": n, "replays": len(replays),
            "inside_replay_share": inside / n if n else None}


def main(argv=None, device: str = "cuda", scale_factor: float | None = None) -> int:
    """`device` "cpu" and `scale_factor` are for the CPU tests."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=os.path.join(ROOT, "spans_out"),
                    help="where the reading and a Chrome trace go")
    args = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    sys.path.insert(0, ROOT)
    from perfbench import harness
    from sqlrs_tpu_torch.utils import profiling

    reading: dict = {}
    setup = profiling.start()

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)
        if msg.startswith("set-up ") and profiling.RECORDER is setup:
            profiling.stop()  # set-up ends here: the window is not recorded

    outdir = args.out
    os.makedirs(outdir, exist_ok=True)
    traced = harness.trace_run

    def trace_run(run, db, stream, hist) -> None:
        traced(run, db, stream, hist)
        reading.update(spans_passes(run, db, stream, harness.TRACE_PASSES))
        reading["cost"] = recording_cost(db, stream, run.devices, rounds=2)
        reading["trace_file"] = trace_file(
            db, stream, run.devices, os.path.join(outdir, f"spans_trace_{args.workload}"))

    harness.trace_run = trace_run
    try:
        out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, True,
                               device=device, log=log, scale_factor=scale_factor)
    finally:
        harness.trace_run = traced
        profiling.stop()
    reading["metrics"]["storage.dictionary_s"] = dictionary_s(host_spans(setup.spans()))
    reading["setup_s_by_span"] = _seconds_by_name(host_spans(setup.spans()))
    out["reading"] = reading
    with open(os.path.join(outdir, f"spans_{args.workload}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
