"""One run of one cell: set-up, the measured window, the traced readings,
and the comparison with the reference that decides `correct`.

Everything of a cell is found by name: the cell's entry in BENCHMARK.json
names its configuration and traffic mix; the configuration's `file` holds
the deployment; `perfbench/traffic/<mix>.json` the traffic;
`perfbench/metrics/<metric>.py` the reader of each metric the cell
reports. Adding a configuration, a mix, a cell or a metric adds files and
entries, and edits none.

A configuration's file names, besides its scale factor and the
comparison's limits (`check_limits`):

- `dataset`: three modules under perfbench/, by path: the `generator`
  (`gen_tables(scale_factor, seed)` -> {table: {column: numpy array}}),
  the `queries` (`derive(q, raw, scale_factor)` -> the fields of query q's
  text, `statements(q, fields)` -> its SQL, `ORDER_KEYS[q]` -> the output
  columns its ORDER BY sorts on) and the `reference`
  (`oracle(q, tables, fields)` -> the expected rows, `with_float(tables,
  dtype)` -> the tables with their float64 columns in `dtype`, for the
  control);
- `column_types`: {engine type: [column, ...]} for the columns whose type
  their dtype does not give (dates held as epoch days); the others are
  DOUBLE (floats), VARCHAR (text) or BIGINT (integers);
- `engine`: `{"kind": "single", "cards": [i]}`, a Database on card i, or
  `{"kind": "mesh", "cards": [i, j, ...]}`, the sharded engine with shard
  k on card k's entry (repeats put several shards on one card). The run
  reports as many devices as the layout uses distinct cards.

The run (see `run_cell`): generate the tables from the seed, load
them into `sqlrs_tpu_torch.Database` and copy them to the device, warm up
with the mix's warm-up passes, then run whole passes of the mix, one
execution at a time (a closed loop with one caller), until the window's
seconds have passed. Each execution is timed from the call to a
synchronised device. With tracing on, more passes follow the window:
under torch.profiler, with the engine's operator profile, and through the
frontend alone. Then the device's peak is read, the engine is freed, and a
sample of the window's executions, drawn from the seed, is compared with
the NumPy reference.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import resource
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from perfbench.reference import compare as cmp
from perfbench.traffic import qgen

FORBIDDEN = ("jax", "jaxlib", "flax", "sqlrs_tpu")
# warm-up passes run until one sees no program's first sighting or capture
# (the first pass of a text runs its programs eagerly, the next captures
# them; a string a query interns changes every key after it), at most:
MAX_WARMUP_PASSES = 6
TRACE_PASSES = 2  # passes of each traced reading after the window


class NoDevice(RuntimeError):
    """The cell's cards are not there."""


class ForbiddenModules(RuntimeError):
    """The process holds the JAX package or JAX."""


@dataclass
class Run:
    """What a run measured, as the metric readers see it."""

    cell: dict
    config: dict
    device: str  # the first card of the layout ("cpu" in the CPU tests)
    devices: list = field(default_factory=list)  # each shard's device
    setup_s: float = 0.0
    load_s: float = 0.0
    latencies_s: list = field(default_factory=list)
    queries: list = field(default_factory=list)  # each execution's query number
    passes: int = 0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    program_stats: dict = field(default_factory=dict)
    # tracing: torch.profiler's reduction, the operator profile and the
    # frontend's timings
    trace_summary: object = None
    op_self_s: dict = field(default_factory=dict)
    op_passes: int = 0
    prepare_s: float = 0.0
    prepare_queries: int = 0
    hbm_bytes_per_s: float | None = None

    @property
    def scale_factor(self) -> float:
        return float(self.config["scale_factor"])


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> tuple[dict, dict]:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return cell, configs[cell["config"]]


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: the end-to-end ones untraced,
    the per-layer ones traced, each where its `workloads` (if any) list it."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def read_metric(root: str, name: str, run: Run):
    """The value of metric `name` for `run`: `read(run)` of
    perfbench/metrics/<name>.py, None where it finds nothing to read."""
    return load_module(root, f"perfbench/metrics/{name}.py").read(run)


def load_module(root: str, path: str):
    """A module of the benchmark's, by its path under perfbench/ (a
    metric's reader, a dataset's generator, queries or reference)."""
    parts = path.split("/")
    if parts[0] != "perfbench" or ".." in parts or not path.endswith(".py"):
        raise ValueError(f"not a module under perfbench/: {path!r}")
    name = "perfbench_file_" + path[len("perfbench/"):-3].replace("/", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, os.path.join(root, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Dataset:
    """A configuration's generator, query texts and reference."""

    generator: object
    queries: object
    reference: object

    @classmethod
    def load(cls, root: str, config: dict) -> "Dataset":
        names = config["dataset"]
        return cls(*(load_module(root, names[role])
                     for role in ("generator", "queries", "reference")))


def engine_devices(config: dict, device: str) -> list[str]:
    """Each shard's device: card i of the layout is cuda:i (all of them the
    one CPU device in the CPU tests)."""
    cards = [int(c) for c in config["engine"]["cards"]]
    if not device.startswith("cuda"):
        return [device] * len(cards)
    return [f"cuda:{c}" for c in cards]


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that are JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


# ---- the program side ------------------------------------------------------------

def _sync(devices) -> None:
    """Wait for every card in `devices` (a device name or a list of them)."""
    import torch

    for d in sorted({devices} if isinstance(devices, str) else set(devices)):
        if d.startswith("cuda"):
            torch.cuda.synchronize(d)


def make_database(config: dict, devices: list[str]):
    import sqlrs_tpu_torch

    kind = config["engine"]["kind"]
    if kind == "single" and len(devices) == 1:
        return sqlrs_tpu_torch.Database(device=devices[0])
    if kind == "mesh":
        from sqlrs_tpu_torch.parallel.mesh import make_mesh

        return sqlrs_tpu_torch.Database(mesh=make_mesh(len(devices), devices=devices))
    raise ValueError(f"unknown engine {config['engine']!r}")


def column_type(config: dict, column: str, arr: np.ndarray) -> str:
    for tn, cols in config.get("column_types", {}).items():
        if column in cols:
            return tn
    kind = arr.dtype.kind
    return "DOUBLE" if kind == "f" else "VARCHAR" if kind in "UO" else "BIGINT"


def load_tables(db, tables: dict, config: dict, devices: list[str]) -> float:
    """Import the tables into `db` and copy every table to the device (its
    first scan): seconds."""
    from sqlrs_tpu_torch.storage.memory import import_tables

    t0 = time.perf_counter()
    spec = {}
    for name, cols in tables.items():
        spec[name] = []
        for cn, arr in cols.items():
            tn = column_type(config, cn, arr)
            spec[name].append((cn, tn, arr.astype(np.int32) if tn == "DATE" else arr, None))
    import_tables(db, spec)
    for name in tables:
        db.catalog.table(name).storage.scan(db.device)
    _sync(devices)
    return time.perf_counter() - t0


def execute(db, ex: qgen.Execution):
    """The batches of each statement of one execution."""
    return [db.run(stmt) for stmt in ex.statements]


def result_rows(outs) -> list[tuple]:
    """The rows of the last statement that returns a schema."""
    rows: list[tuple] = []
    for batches in outs:
        got = [tuple(r) for b in batches for r in b.to_pylist()]
        if got or (batches and batches[0].columns):
            rows = got
    return rows


def program_stats() -> dict:
    from sqlrs_tpu_torch.utils import programs

    st = programs.stats
    return {"replays": st.replays, "warmups": st.warmups, "captures": st.captures,
            "eager_routed": sum(st.eager_routed.values())}


# ---- the run ---------------------------------------------------------------------

def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", started: float | None = None,
             scale_factor: float | None = None, log=None) -> dict:
    """One run of `workload`; returns the result object (the last line a
    run prints). `device` "cpu" and `scale_factor` are for the CPU tests."""
    started = time.perf_counter() if started is None else started
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench = load_benchmark(root)
    cell, cfg_entry = find_cell(bench, workload)
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    if scale_factor is not None:
        config = dict(config, scale_factor=scale_factor)
    data = Dataset.load(root, config)
    mix = qgen.load_mix(root, cell["traffic"])
    warm_mix = qgen.load_mix(root, mix.get("warmup", cell["traffic"]))
    import torch

    devices = engine_devices(config, device)
    if device.startswith("cuda"):
        cards = len(set(devices))
        if cards > int(cell["chips"]):
            raise ValueError(f"{workload}: its layout uses {cards} cards, the cell asks for "
                             f"{cell['chips']}")
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        need = max(int(cell["chips"]), 1 + max(int(d.split(":")[1]) for d in devices))
        if have < need:
            raise NoDevice(f"{workload} needs {need} CUDA card(s); found {have}")
    run = Run(cell=cell, config=config, device=devices[0], devices=devices)
    sf = run.scale_factor

    from perfbench import trace as tr

    hist = tr.KernelBytes() if trace and device.startswith("cuda") else None
    t0 = time.perf_counter()
    tables = data.generator.gen_tables(sf, seed=seed)
    gen_s = time.perf_counter() - t0
    db = make_database(config, devices)
    run.load_s = load_tables(db, tables, config, devices)
    if hist is not None:
        hist.install()
    warm = qgen.Stream(warm_mix, seed, sf, data.queries)
    t0 = time.perf_counter()
    for n_warm in range(1, MAX_WARMUP_PASSES + 1):
        before = program_stats()
        for ex in warm.next_pass():
            execute(db, ex) if hist is None else hist.execute(db, ex)
        after = program_stats()
        if n_warm >= 2 and after["warmups"] == before["warmups"] \
                and after["captures"] == before["captures"]:
            break
    _sync(devices)
    warm_s = time.perf_counter() - t0
    run.setup_s = time.perf_counter() - started
    log(f"set-up {run.setup_s:.3f} s: tables made in {gen_s:.3f} s, loaded and copied in "
        f"{run.load_s:.3f} s, warm-up {warm_s:.3f} s ({n_warm} passes)")

    # the window: whole passes until `seconds` have passed
    stream = qgen.Stream(mix, seed, sf, data.queries)
    pick = np.random.default_rng([seed, 0xC0DE])
    share = float(mix.get("check_share", 0.0))
    kept, last = [], []
    pass_s = []
    stats0 = program_stats()
    collections = _GcTimer()
    gc.callbacks.append(collections)
    use0 = resource.getrusage(resource.RUSAGE_SELF)
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        current = []
        t_pass = time.perf_counter()
        for ex in stream.next_pass():
            ts = time.perf_counter()
            try:
                outs = execute(db, ex) if hist is None else hist.execute(db, ex)
                _sync(devices)
            except Exception as e:  # an answer that never comes: counted, and shown
                run.failed += 1
                outs = e
                log(f"Q{ex.qn} failed: {type(e).__name__}: {e}")
            run.latencies_s.append(time.perf_counter() - ts)
            run.queries.append(ex.qn)
            run.attempted += 1
            draw = pick.random()
            if run.passes == 0 or draw < share:
                kept.append((ex, outs))
            else:
                current.append((ex, outs))
        last = current
        run.passes += 1
        pass_s.append(time.perf_counter() - t_pass)
    run.window_s = time.perf_counter() - t_start
    use1 = resource.getrusage(resource.RUSAGE_SELF)
    gc.callbacks.remove(collections)
    stats1 = program_stats()
    run.program_stats = {k: stats1[k] - stats0[k] for k in stats0}
    log(f"window {run.window_s:.3f} s: {run.passes} passes, {run.attempted} executions; "
        f"programs {run.program_stats}; full garbage collections {collections.count}, "
        f"{collections.seconds:.3f} s")
    cpu = (use1.ru_utime - use0.ru_utime) + (use1.ru_stime - use0.ru_stime)
    log(f"host in the window: {cpu:.3f} s of CPU time (user "
        f"{use1.ru_utime - use0.ru_utime:.3f}), {use1.ru_nivcsw - use0.ru_nivcsw} involuntary "
        f"and {use1.ru_nvcsw - use0.ru_nvcsw} voluntary context switches")
    lat = np.asarray(run.latencies_s) * 1e3
    qs = np.asarray(run.queries)
    log("latency ms of every execution: " + ", ".join(
        f"p{p} {np.percentile(lat, p):.3f}" for p in (50, 90, 95, 99)) +
        f"; pass s: min {min(pass_s):.4f}, median {float(np.median(pass_s)):.4f}, "
        f"max {max(pass_s):.4f}")
    medians = sorted(((float(np.median(lat[qs == q])), q) for q in set(run.queries)), reverse=True)
    log("median ms by query: " + ", ".join(f"Q{q} {m:.1f}" for m, q in medians))
    if run.passes > 1:
        kept.extend(last)  # the last pass is checked whole
    del last, current

    if trace:
        trace_run(run, db, stream, hist)
    cuda = sorted({d for d in devices if d.startswith("cuda")})
    if cuda:
        run.memory_peak_bytes = max(int(torch.cuda.max_memory_reserved(d)) for d in cuda)
        run.hbm_bytes_per_s = tr.hbm_rate(root, torch.cuda.get_device_name(cuda[0]))

    # the program's outputs to the host, then its state freed
    checked = [(ex, outs if isinstance(outs, Exception) else result_rows(outs))
               for ex, outs in kept]
    del kept, db
    _free(devices)
    verdict = judge(checked, tables, config, data, log)

    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        value = read_metric(root, m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": verdict["correct"], "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device_info(run)}
    if trace and run.trace_summary is not None:
        out["breakdown"] = run.trace_summary.breakdown()
    out["checks"] = verdict["checks"]
    # last, once everything of the run has been loaded: the reference, the
    # comparison and every metric's reader
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(f"the process holds {', '.join(found)}")
    return out


class _GcTimer:
    """Python's full (generation 2) garbage collections: count and seconds."""

    def __init__(self) -> None:
        self.count, self.seconds, self._t0 = 0, 0.0, 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.count += 1
            self.seconds += time.perf_counter() - self._t0


def _free(devices: list[str]) -> None:
    gc.collect()
    if any(d.startswith("cuda") for d in devices):
        import torch

        from sqlrs_tpu_torch.utils import programs

        programs.clear()
        gc.collect()
        torch.cuda.empty_cache()


def device_info(run: Run) -> dict:
    """The devices the layout used: as many as its distinct cards, the peak
    of the fullest."""
    if not run.device.startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
            "count": len(set(run.devices)), "memory_peak_bytes": run.memory_peak_bytes}
    if run.trace_summary is not None:
        info["busy_s"] = run.trace_summary.busy_s
        info["window_s"] = run.trace_summary.window_s
    return info


def judge(checked: list, tables: dict, config: dict, data: Dataset, log) -> dict:
    """Compare each checked execution with the reference; `correct` and the
    numbers compared, each beside its limit."""
    limits = config["check_limits"]
    t0 = time.perf_counter()
    cache: dict = {}
    mismatched, gap, failed = 0, 0.0, 0
    worst = ""
    for ex, rows in checked:
        if isinstance(rows, Exception):
            failed += 1
            continue
        exp = cache.get(ex.key)
        if exp is None:
            exp = cache[ex.key] = data.reference.oracle(ex.qn, tables, ex.fields)
        bad, g, note = cmp.compare(rows, exp, data.queries.ORDER_KEYS[ex.qn])
        if bad:
            mismatched += 1
            log(f"Q{ex.qn} {ex.raw}: {note}")
        if g > gap:
            gap, worst = g, f"Q{ex.qn} {ex.raw}: {note}"
    log(f"reference and comparison: {len(checked)} executions, {len(cache)} texts, "
        f"{time.perf_counter() - t0:.3f} s")
    if worst:
        log(f"widest relative gap: {worst}")
    checks = {
        "checked": {"value": len(checked), "limit": 1},
        "failed": {"value": failed, "limit": limits["failed"]},
        "mismatched": {"value": mismatched, "limit": limits["mismatched"]},
        "rel_gap": {"value": gap, "limit": limits["rel_gap"]},
    }
    correct = (len(checked) >= 1 and failed <= limits["failed"]
               and mismatched <= limits["mismatched"] and gap <= limits["rel_gap"])
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    return {"correct": bool(correct), "checks": checks}


# ---- the traced readings ------------------------------------------------------------

def trace_run(run: Run, db, stream, hist) -> None:
    """After the window: torch.profiler over a few passes, then passes with
    the engine's operator profile on, then the frontend alone."""
    from perfbench import trace as tr

    mix_passes = TRACE_PASSES
    if run.device.startswith("cuda"):
        run.trace_summary = tr.profile_passes(db, stream, mix_passes, run.devices, hist)
    # the operator profile: host self time by operator
    db.profile_enabled = True
    try:
        for _ in range(mix_passes):
            for ex in stream.next_pass():
                for stmt in ex.statements:
                    db.run(stmt)
                    prof = db.last_profile
                    if prof is None:
                        continue
                    for op in prof.ops:
                        kind = "dist" if op.op.startswith("dist:") else "ops"
                        run.op_self_s[kind] = run.op_self_s.get(kind, 0.0) + op.self_s
                _sync(run.devices)
            run.op_passes += 1
    finally:
        db.profile_enabled = False
    # the frontend: parse, bind, optimize and plan each statement in the
    # pass's order; a view's statements also run, so that the next finds it
    for _ in range(mix_passes):
        for ex in stream.next_pass():
            for stmt in ex.statements:
                t0 = time.perf_counter()
                db.connect().prepare(stmt)
                run.prepare_s += time.perf_counter() - t0
                if stmt.lstrip().lower().startswith(("create view", "drop view")):
                    db.run(stmt)
            run.prepare_queries += 1
