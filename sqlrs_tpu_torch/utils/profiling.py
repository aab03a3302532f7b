"""Query profiling and spans.

The port of sqlrs_tpu/utils/profiling.py, and the engine's span recorder.
It provides:

- QueryProfile: per-operator row counts and host-clock times, the
  reference's operator list (`Database(profile=True)` or
  SQLRS_TPU_PROFILE=1, then `db.last_profile`);
- spans: named intervals at the engine's layer boundaries (a statement,
  its frontend phases, each operator, each program's first run, capture,
  replay and input copy, table import and first scan, the string
  dictionary's match and rank tables, full garbage collections), each with
  its parent and the id of the statement it belongs to. `recording()`
  turns them on; they are kept in memory, in a bounded buffer, until the
  caller reads them (`Recorder.spans()`);
- trace(): a torch.profiler scope (CPU and CUDA activities) that records
  spans and writes both into one Chrome trace, for kernel-level analysis.

Spans take their times from `time.time_ns()`, the clock torch.profiler's
records carry (`start_ns()` of its kineto events, in ns since the epoch),
so a span and the device records it launched lie on one timeline.

Span sites. A site reads the module global RECORDER and, while it is
None (recording off, the default), runs its work directly: one test and
no allocation. While it is on, the site runs the work through the
recorder (`Recorder.call`, `Recorder.statement`); the operator boundary
tests it beside the executor's `profile is None`. A span costs two clock
readings and one small object.

QueryProfile's counters are taken at operator boundaries, on the host. A
sharded operator's live-row count needs the device, so it is read after
the statement (`QueryProfile.settle`): the profile adds no
synchronisation inside a statement.

What the times mean on a GPU: the device runs asynchronously, so an
operator's `wall_s` and `self_s` are host-clock times. `self_s` is the
host's time in the operator itself: launching its work, plus any
synchronisation the operator makes (a data-dependent size read back, for
example). It is not the operator's device time; trace() records that. The
reference has the same semantics under JAX's asynchronous dispatch.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import time
from collections import deque
from dataclasses import dataclass, field

# ---- spans -----------------------------------------------------------------------

SPAN_CAPACITY = 1 << 20  # spans kept; the oldest go first past it


class Span:
    """One interval of the engine's work. `parent` and `stmt` are span ids:
    the enclosing span's, and the statement's whose work this is (None
    outside a statement). `detail` names the work where the name alone
    does not: a program's name, a table's new entries."""

    __slots__ = ("id", "parent", "stmt", "name", "layer", "start_ns", "end_ns", "detail")

    def __init__(self, sid, parent, stmt, name, layer, start_ns, detail) -> None:
        self.id = sid
        self.parent = parent
        self.stmt = stmt
        self.name = name
        self.layer = layer
        self.start_ns = start_ns
        self.end_ns = None
        self.detail = detail

    def __repr__(self) -> str:
        return f"Span({self.id}, {self.name!r}, parent={self.parent}, stmt={self.stmt})"


class Recorder:
    """The spans of this process while recording is on: a stack of the open
    ones and a bounded buffer of the closed ones."""

    def __init__(self) -> None:
        self._closed: deque = deque(maxlen=SPAN_CAPACITY)
        self._open: list[Span] = []
        self._next = 0
        self._gc_span = None

    def open(self, name: str, layer: str, detail=None) -> Span:
        parent, stmt = (self._open[-1].id, self._open[-1].stmt) if self._open else (None, None)
        sid = self._next
        self._next += 1
        span = Span(sid, parent, stmt, name, layer, time.time_ns(), detail)
        self._open.append(span)
        return span

    def close(self, span: Span, end_ns: int | None = None) -> None:
        span.end_ns = time.time_ns() if end_ns is None else end_ns
        # the stack unwinds to the span (an error may have skipped a close)
        while self._open:
            if self._open.pop() is span:
                break
        self._closed.append(span)

    def call(self, name: str, layer: str, detail, fn, /, *args, **kwargs):
        """fn(*args, **kwargs) inside a span."""
        s = self.open(name, layer, detail)
        try:
            return fn(*args, **kwargs)
        finally:
            self.close(s)

    def annotate(self, prefix: str, detail) -> None:
        """Set the detail of the innermost open span whose name begins with
        `prefix` (an operator's numbers that the operator's own span
        carries)."""
        for s in reversed(self._open):
            if s.name.startswith(prefix):
                s.detail = detail
                return

    def statement(self, fn, /, *args):
        """fn(*args) inside a statement's root span, whose id is the
        statement id of every span inside it; inside an open statement,
        fn(*args) alone."""
        if self.statement_open():
            return fn(*args)
        s = self.open("statement", "session")
        s.stmt = s.id
        try:
            return fn(*args)
        finally:
            self.close(s)

    def statement_open(self) -> bool:
        return any(s.name == "statement" for s in self._open)

    def spans(self) -> list[Span]:
        """The closed spans, oldest first."""
        return list(self._closed)

    def _on_gc(self, phase: str, info: dict) -> None:
        # full collections only: the ones that take a visible time
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._gc_span = self.open("gc", "runtime")
        elif self._gc_span is not None:
            self.close(self._gc_span)
            self._gc_span = None


RECORDER: Recorder | None = None  # the recorder while recording is on


def start() -> Recorder:
    """Turn recording on (a no-op if it is on) and return the recorder."""
    global RECORDER
    if RECORDER is None:
        RECORDER = Recorder()
        gc.callbacks.append(RECORDER._on_gc)
    return RECORDER


def stop() -> Recorder | None:
    """Turn recording off; returns the recorder that was on, whose spans
    stay readable."""
    global RECORDER
    rec, RECORDER = RECORDER, None
    if rec is not None:
        gc.callbacks.remove(rec._on_gc)
    return rec


@contextlib.contextmanager
def recording():
    """Record spans inside the block and yield the recorder. Nested inside
    another recording, it yields that recorder and leaves it on."""
    if RECORDER is not None:
        yield RECORDER
        return
    rec = start()
    try:
        yield rec
    finally:
        stop()


# ---- the operator profile -------------------------------------------------------------


@dataclass
class OpStats:
    op: str
    rows_out: int = 0
    wall_s: float = 0.0  # subtree wall
    self_s: float = 0.0  # wall minus direct children (operator's own work)
    depth: int = 0

    def rows_per_sec(self) -> float:
        return self.rows_out / self.self_s if self.self_s > 0 else 0.0


@dataclass
class QueryProfile:
    ops: list[OpStats] = field(default_factory=list)
    _stack: list[float] = field(default_factory=list)  # child-time accumulators
    # (stats, read): rows_out values that read the device, settled after the
    # statement
    _deferred: list = field(default_factory=list)

    def defer_rows(self, stats: OpStats, read) -> None:
        """Set stats.rows_out to read() once the statement has ended."""
        self._deferred.append((stats, read))

    def settle(self) -> None:
        """Read the deferred row counts (one host read each)."""
        for stats, read in self._deferred:
            stats.rows_out = read()
        self._deferred.clear()

    def report(self) -> str:
        lines = [
            f"{'operator':44s} {'rows_out':>10s} {'self_ms':>9s} {'rows/s':>12s}"
        ]
        for s in reversed(self.ops):  # root first
            label = ("  " * s.depth + s.op)[:44]
            lines.append(
                f"{label:44s} {s.rows_out:10d} "
                f"{s.self_s * 1e3:9.2f} {s.rows_per_sec():12.0f}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def operator(profile: QueryProfile | None, label: str, name: str | None, layer: str):
    """The operator boundary: one pair of clock readings times the
    operator's span `name` (while recording, and if a name is given) and
    its profile entry `label` (if there is a profile, which gets the
    OpStats the block yields)."""
    rec = RECORDER if name is not None else None
    stats = None
    if profile is not None:
        stats = OpStats(op=label, depth=len(profile._stack))
        profile._stack.append(0.0)
    s = rec.open(name, layer) if rec is not None else None
    t0 = s.start_ns if s is not None else time.time_ns()
    try:
        yield stats
    finally:
        t1 = time.time_ns()
        if s is not None:
            rec.close(s, t1)
        if stats is not None:
            stats.wall_s = (t1 - t0) / 1e9
            child_s = profile._stack.pop()
            stats.self_s = max(stats.wall_s - child_s, 0.0)
            if profile._stack:
                profile._stack[-1] += stats.wall_s
            profile.ops.append(stats)


def profiling_enabled() -> bool:
    return os.environ.get("SQLRS_TPU_PROFILE", "0") == "1"


# ---- the Chrome trace -------------------------------------------------------------------


def chrome_events(spans, base_ns: int) -> list[dict]:
    """Spans as Chrome trace complete events ("X", times in µs after
    `base_ns`), one track, nested by time."""
    return [
        {"ph": "X", "pid": "sqlrs_tpu_torch spans", "tid": 0, "name": s.name, "cat": s.layer,
         "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"id": s.id, "parent": s.parent, "stmt": s.stmt,
                  **({} if s.detail is None else {"detail": s.detail})}}
        for s in spans
    ]


@contextlib.contextmanager
def trace(path: str):
    """torch.profiler scope over the CPU and, where there is one, the CUDA
    device (the counterpart of the reference's jax.profiler scope), with
    spans recorded: on exit it writes a Chrome trace, `trace.json`, into
    the directory `path`, which it makes if needed. The spans are a track
    of their own there, on the records' clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with recording() as rec:
        t0 = time.time_ns()
        with profile(activities=activities) as prof:
            yield prof
        spans = [s for s in rec.spans() if s.start_ns >= t0]
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, "trace.json")
    prof.export_chrome_trace(out)
    with open(out) as f:
        doc = json.load(f)
    # the exporter writes times in µs after its baseTimeNanoseconds (since
    # the epoch, or 0 where it writes none)
    doc["traceEvents"].extend(chrome_events(spans, int(doc.get("baseTimeNanoseconds", 0))))
    with open(out, "w") as f:
        json.dump(doc, f)
