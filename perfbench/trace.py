"""The device trace of a traced run, reduced to what the metrics read.

torch.profiler records the CUDA activity alone (kernels, copies and sets
on the device; the CUDA runtime's calls on the host): the operators' host
events would add host time to a host-bound engine and move what is read.
From its records:

- busy seconds: the union of a card's records' intervals inside the
  traced window, averaged over the cards the layout uses; the window: from
  the first pass's start to the last pass's synchronised end;
- device ms: the kernels' durations (not copies or sets);
- launches: `cudaLaunchKernel*` and `cudaGraphLaunch` calls;
- kernel 1 (`grouped_histogram`): its records' durations, and the bytes
  its calls must move (`KernelBytes`), for its share of the memory bound;
- the breakdown: the device operations that took most time, and the
  longest idle gaps, named by the query that was running and the host's
  last CUDA call before the gap.
"""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import Counter
from dataclasses import dataclass, field

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")
K1 = "grouped_histogram"
# the profiler's own records on the device's timeline, which are no work
OVERHEAD = ("Buffer Flush", "CUPTI Overhead", "Instrumentation", "Resource")


def hbm_rate(root: str, card: str) -> float | None:
    """The card's published memory rate, bytes/s, from perfbench/peaks.json;
    None for a card it does not list."""
    with open(os.path.join(root, "perfbench", "peaks.json")) as f:
        peaks = json.load(f)
    for name, p in peaks.items():
        if name == card:
            return float(p["hbm_bytes_per_s"])
    return None


def histogram_bytes(gid, words, limb_plan, n_groups: int) -> int:
    """Bytes one grouped_histogram call must move: each input byte read once
    (the group ids and each word the plan reads), each output byte written
    once (1 + len(plan) int64 totals and an int64 first row, per group)."""
    n = int(gid.shape[0])
    used = len({int(w) for w, _ in limb_plan})
    return n * gid.element_size() * (1 + used) + (2 + len(limb_plan)) * n_groups * 8


class KernelBytes:
    """Kernel 1's bytes, execution by execution. The wrapper's CUDA path is
    wrapped (the module looks it up at each call), so its eager and capture
    calls record their arguments' bytes; a graph replay makes no Python
    call, and is credited with the bytes recorded for the same text (the
    same shapes: a program's key holds every tensor's shape). The launch
    counter the program keeps (`grouped_histogram.launches`, replays
    included) says how many launches each execution made."""

    def __init__(self) -> None:
        self.calls = 0
        self.bytes = 0
        self.by_text: dict[str, tuple[int, int]] = {}
        self.last: tuple[int, int | None] = (0, 0)  # launches, bytes (None: unknown)

    def install(self) -> None:
        from sqlrs_tpu_torch.ops import mxu_grouped

        inner = mxu_grouped._grouped_histogram_cuda

        def counted(gid, words, limb_plan, n_groups, _inner=inner):
            self.calls += 1
            self.bytes += histogram_bytes(gid, words, limb_plan, n_groups)
            return _inner(gid, words, limb_plan, n_groups)

        mxu_grouped._grouped_histogram_cuda = counted

    def execute(self, db, ex):
        from sqlrs_tpu_torch.ops.mxu_grouped import grouped_histogram

        from perfbench.harness import execute

        c0, b0, l0 = self.calls, self.bytes, grouped_histogram.launches
        outs = execute(db, ex)
        calls, nbytes = self.calls - c0, self.bytes - b0
        launches = grouped_histogram.launches - l0
        if calls == launches:
            self.by_text[ex.key] = (launches, nbytes)
            self.last = (launches, nbytes)
        else:
            known = self.by_text.get(ex.key)
            self.last = (launches, known[1] if known and known[0] == launches else None)
        return outs


@dataclass
class TraceSummary:
    passes: int
    window_s: float
    busy_s: float
    kernel_s: float
    launches: int
    k1_s: float
    k1_records: int
    k1_launches: int
    k1_bytes: int | None
    top_ops: list = field(default_factory=list)
    gaps: list = field(default_factory=list)

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops[:10], "idle_gaps": self.gaps[:10]}


def _events(prof):
    """(name, start ns, end ns, the card's index or None on the host) of
    every record."""
    out = []
    for e in prof.profiler.kineto_results.events():
        card = int(e.device_index()) if "CUDA" in str(e.device_type()) else None
        out.append((e.name(), int(e.start_ns()), int(e.start_ns()) + int(e.duration_ns()), card))
    return out


def _union(records, t0: int, t1: int) -> tuple[int, list]:
    """Busy ns of (start, end, name) records inside [t0, t1], and the gaps
    between them, each (ns, start, end)."""
    busy, cursor, gaps = 0, t0, []
    for s, e, _n in records:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if s > cursor:
            gaps.append((s - cursor, cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if t1 > cursor:
        gaps.append((t1 - cursor, cursor, t1))
    return busy, gaps


def profile_passes(db, stream, passes: int, devices: list[str], hist) -> TraceSummary:
    from torch.profiler import ProfilerActivity, profile

    from perfbench.harness import _sync, execute

    marks = []  # (ns, label): each execution's start on the host's clock
    k1_launches, k1_bytes = 0, 0
    _sync(devices)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        for _ in range(passes):
            for ex in stream.next_pass():
                marks.append((time.time_ns(), f"Q{ex.qn}"))
                if hist is None:
                    execute(db, ex)
                else:
                    hist.execute(db, ex)
                    k1_launches += hist.last[0]
                    if hist.last[1] is None or k1_bytes is None:
                        k1_bytes = None
                    else:
                        k1_bytes += hist.last[1]
                _sync(devices)
        t1 = time.time_ns()
    events = _events(prof)
    dev = sorted((s, e, n) for n, s, e, c in events
                 if c is not None and e > s and n not in OVERHEAD)
    host = sorted((s, n) for n, s, e, c in events if c is None)
    # each card's busy time inside the window, averaged over the layout's
    # cards; the gaps in which no card ran anything
    cards = sorted({int(d.split(":")[1]) for d in devices})
    busy = sum(_union(sorted((s, e, n) for n, s, e, c in events
                             if c == card and e > s and n not in OVERHEAD), t0, t1)[0]
               for card in cards) / len(cards)
    _all, gaps = _union(dev, t0, t1)
    kernels = [(n, e - s) for s, e, n in dev
               if not n.startswith(("Memcpy", "Memset")) and e > s]
    by_name: dict[str, int] = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0) + e - s
    k1 = [d for n, d in kernels if K1 in n]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    gaps.sort(key=lambda g: -g[0])
    return TraceSummary(
        passes=passes, window_s=(t1 - t0) / 1e9, busy_s=busy / 1e9,
        kernel_s=sum(d for _, d in kernels) / 1e9,
        launches=sum(1 for _s, n in host if n in LAUNCH_CALLS),
        k1_s=sum(k1) / 1e9, k1_records=len(k1), k1_launches=k1_launches,
        k1_bytes=k1_bytes if hist is not None else None,
        top_ops=[[n[:120], d / 1e9] for n, d in top[:10]],
        gaps=[[_gap_name(g, marks, host), g[0] / 1e9] for g in gaps[:10]])


def _gap_name(gap, marks, host) -> str:
    """The query that was running when the gap began, and the CUDA calls
    the host made during it (none: the host ran Python or waited)."""
    _d, start, end = gap
    i = bisect.bisect_right([ns for ns, _ in marks], start) - 1
    query = marks[i][1] if i >= 0 else "before the first query"
    lo = bisect.bisect_left(host, (start, ""))
    hi = bisect.bisect_right(host, (end, "\uffff"))
    calls = Counter(n for _s, n in host[lo:hi])
    if not calls:
        return f"{query}: no CUDA call"
    name, _k = calls.most_common(1)[0]
    return f"{query}: {sum(calls.values())} CUDA calls, most {name}"
