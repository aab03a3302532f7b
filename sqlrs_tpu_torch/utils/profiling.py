"""Query profiling: per-operator rows/bytes counters and roofline accounting.

The port of sqlrs_tpu/utils/profiling.py. It provides:

- QueryProfile: per-operator row counts, wall time, estimated bytes touched;
- roofline_fraction(): fraction of the device's memory-bandwidth bound a
  measured operator achieved;
- trace(): a torch.profiler scope (CPU and CUDA activities) that writes a
  Chrome trace, for kernel-level analysis.

Enabled per session by Database(profile=True) or SQLRS_TPU_PROFILE=1.
Counters are taken on the host at operator boundaries, which are already
pipeline breakers, so profiling adds no synchronisation of its own.

What the times mean on a GPU: the device runs asynchronously, so an
operator's `wall_s` and `self_s` are host-clock times. `self_s` is the
host's time in the operator itself: launching its work, plus any
synchronisation the operator makes (a data-dependent size read back, for
example). It is not the operator's device time; trace() records that. The
reference has the same semantics under JAX's asynchronous dispatch.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

# peak memory bandwidth (bytes/s) by CUDA device name
HBM_BANDWIDTH = {
    "H100 80GB HBM3": 3.35e12,  # H100 SXM
    "H100 PCIe": 2.0e12,
}


def chip_bandwidth(device) -> float:
    """Peak memory bandwidth of `device` (a torch device or its name), in
    bytes/s; 50e9 for the CPU or an unlisted card."""
    device = torch.device(device)
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        for k, v in HBM_BANDWIDTH.items():
            if k.lower() in name.lower():
                return v
    return 50e9  # cpu-ish default


@dataclass
class OpStats:
    op: str
    rows_in: int = 0
    rows_out: int = 0
    bytes_touched: int = 0
    wall_s: float = 0.0  # subtree wall
    self_s: float = 0.0  # wall minus direct children (operator's own work)
    depth: int = 0

    def rows_per_sec(self) -> float:
        n = self.rows_in or self.rows_out
        return n / self.self_s if self.self_s > 0 else 0.0

    def roofline_fraction(self, device, bytes_per_row: int = 16) -> float:
        """Fraction of `device`'s bandwidth-bound rows/s this operator
        achieved."""
        bound = chip_bandwidth(device) / bytes_per_row
        return self.rows_per_sec() / bound if bound else 0.0


@dataclass
class QueryProfile:
    ops: list[OpStats] = field(default_factory=list)
    _stack: list[float] = field(default_factory=list)  # child-time accumulators

    @contextlib.contextmanager
    def measure(self, op: str, rows_in: int = 0, bytes_touched: int = 0):
        stats = OpStats(
            op=op, rows_in=rows_in, bytes_touched=bytes_touched,
            depth=len(self._stack),
        )
        self._stack.append(0.0)
        t0 = time.perf_counter()
        try:
            yield stats
        finally:
            stats.wall_s = time.perf_counter() - t0
            child_s = self._stack.pop()
            stats.self_s = max(stats.wall_s - child_s, 0.0)
            if self._stack:
                self._stack[-1] += stats.wall_s
            self.ops.append(stats)

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


def profiling_enabled() -> bool:
    return os.environ.get("SQLRS_TPU_PROFILE", "0") == "1"


@contextlib.contextmanager
def trace(path: str):
    """torch.profiler scope over the CPU and, where there is one, the CUDA
    device (the counterpart of the reference's jax.profiler scope): on exit
    it writes a Chrome trace, `trace.json`, into the directory `path`,
    which it makes if needed."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(path, exist_ok=True)
    prof.export_chrome_trace(os.path.join(path, "trace.json"))
