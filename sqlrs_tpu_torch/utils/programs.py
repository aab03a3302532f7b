"""Programs: the port's counterpart of the JAX package's `jax.jit` programs.

The JAX package runs every operator phase as one jitted XLA program, cached
by signature, one dispatch a call (its "dispatch diet": STATUS.md's
whole-batch take/slice/concat, one-program sorts, `_FUSED_CACHE` and the
executor's residual and ungrouped-aggregate caches). On the card the
counterpart is a captured CUDA graph: a function of tensors with no host
read inside, captured once per signature, then replayed with one
submission. A graph replays the same kernels with the same launch
configurations as the eager run, so its results are bit-equal to it.

    @program
    def f(arrays, idx, count: int): ...

    f(arrays, idx, count=n)   # tensors anywhere in nested tuples/lists

Every leaf of the arguments that is not a tensor is static: it is part of
the key, as `static_argnames` are for `jax.jit`. The key is the program,
the arguments' structure and static values, each tensor's shape, dtype and
device, and the string dictionary's length (the reference's `_FUSED_CACHE`
key carries `len(GLOBAL_STRINGS)`: rank and LIKE tables depend on it).

How a call runs on a CUDA tensor, with programs on (`SQLRS_TPU_FUSE`
unset or not "0"):

- The first call of a signature runs the function eagerly on the caller's
  stream and returns its results: it is the warm-up PyTorch asks for
  before a capture, and it builds what the function builds at first use
  (rank tables, LIKE and substring code maps). A signature seen once costs
  what it costs eagerly. (Not on a side stream: its results go back to the
  caller, and memory allocated on a side stream but used on the caller's
  would need `record_stream` to be safe.)
- The second call captures the function into a `torch.cuda.CUDAGraph` on
  a side stream, then replays it. Later calls replay it.
- Inputs. A tensor registered with `mark_resident` (a table's device
  columns, the rank table, code maps: tensors whose address does not move
  while they live) is read by the graph where it lies, and its address is
  part of the key. Every other input is copied before a replay into the
  graph's input region: one `torch.cat` into a flat byte buffer for all of
  them, so inputs at new addresses are always right.
- Outputs. The graph packs its outputs into one flat byte buffer; after a
  replay that buffer is cloned out (one copy) and the outputs are views of
  the clone. Nothing a caller holds lies in graph memory, so the next
  replay of the same program, or of any other, cannot overwrite it. An
  output that is one of the inputs is handed back as the caller's tensor.
- Memory. All graphs of a device capture into one shared pool, and a graph
  keeps no tensor of its own alive: its input region, intermediates and
  packed outputs are freed back to the pool when the capture ends, and it
  reaches its regions through views that own nothing. Later captures reuse
  that memory where a freed block fits. That is safe because replays are
  serial on one stream and each replay's inputs are copied in right before
  it and its outputs out right after it. So the pool grows to much less
  than the sum of the graphs' memory, and it is bounded: past
  `max_pool_bytes` (a quarter of the card) every graph of the device is
  dropped and the pool starts anew. The cache also keeps at most 512
  signatures, least recently used first out (`_FUSED_CACHE_MAX` in the
  reference).
- Kernel counts. A hand-written kernel's wrapper counts its launches in
  Python when it launches (`register_kernel`). A capture records how many
  launches of each kernel the graph holds, takes them back off the counts
  (a capture launches nothing) and adds them at every replay.
- A capture or replay error raises: nothing falls back to the eager run.
  Code that must read the host is routed eagerly before a program is
  called, by a predicate on what it will run (see
  exec/expression_executor.py), never by catching an error.

A sharded stage (`mesh_program`, the counterpart of the reference's
`shard_map` programs) is one program over every shard of a mesh whose
shards all lie on one device in one process: the per-shard bodies and the
one-process collectives between them (device copies) are captured into
one graph, keyed by the mesh too. A mesh with a process group, or with
shards on several devices, runs the stage eagerly, with its reason
counted in `stats.eager_routed`.

On the CPU, with `SQLRS_TPU_FUSE=0`, inside another program's body, or
when every input is empty, a program is its function, called directly.
`SQLRS_TPU_COMPILE_CACHE` has no counterpart: a CUDA graph cannot outlive
its process, and what does persist, the nvcc build of each kernel, is
cached in build/kernels/.

While spans are recorded (utils/profiling.py), a first sighting is a
`programs.first_run` span, a capture `programs.capture`, a replay
`programs.replay` (the program's name its detail) holding its input copy,
`programs.pack`.

`checking()` holds the programs to that contract on the CPU: inside it,
every program body runs under a dispatch mode that raises on an operation
that would read the host or whose output shape depends on the data, and
the mode counts what the calls would submit on the card (see `Checker`).
`emulating()` runs every call on the CPU through the card's input region
and packed outputs, without the graph, so tests hold those layouts to the
eager results. Both are for tests, and run in one thread.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
import weakref
from collections import Counter, OrderedDict

import torch
import torch.utils._python_dispatch

from sqlrs_tpu_torch.utils import profiling

MAX_ENTRIES = 512  # signatures kept a device (the reference's _FUSED_CACHE_MAX)
_ALIGN = 256  # byte alignment of each tensor in a flat input or output region


def enabled() -> bool:
    """Programs are on unless SQLRS_TPU_FUSE=0 (the reference's switch)."""
    return os.environ.get("SQLRS_TPU_FUSE", "1") != "0"


# ---- resident tensors --------------------------------------------------------

# storage address -> weak reference to the tensor registered there
_RESIDENT: dict[int, weakref.ref] = {}


def mark_resident(*tensors) -> None:
    """Register tensors whose address stays fixed while they live (a
    table's device snapshot, the rank table, code maps): a program reads
    them where they lie, with the address in its key, instead of copying
    them in. A view of a registered tensor's storage counts as resident."""
    for t in tensors:
        if t.numel():
            _RESIDENT[t.untyped_storage().data_ptr()] = weakref.ref(t)


def is_resident(t: torch.Tensor) -> bool:
    if not t.numel():
        return False
    ref = _RESIDENT.get(t.untyped_storage().data_ptr())
    if ref is None:
        return False
    base = ref()
    if base is None or not base.numel():
        _RESIDENT.pop(t.untyped_storage().data_ptr(), None)
        return False
    return True


# ---- hand-written kernels' launch counts --------------------------------------

_KERNELS: list = []


def register_kernel(wrapper) -> None:
    """A kernel wrapper whose `.launches` counts its launches: a graph that
    holds some adds them back at every replay."""
    if wrapper not in _KERNELS:
        _KERNELS.append(wrapper)


def _kernel_counts() -> tuple:
    return tuple(k.launches for k in _KERNELS)


# ---- argument trees ------------------------------------------------------------

_T = "T"  # a tensor's place in a tree


def _flatten(x, leaves: list):
    """A hashable tree of x with each tensor replaced by _T (appended to
    leaves) and every other leaf kept as a static value."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return _T
    if isinstance(x, (tuple, list)):
        return (type(x).__name__, tuple(_flatten(i, leaves) for i in x))
    if isinstance(x, dict):
        return ("dict", tuple((k, _flatten(v, leaves)) for k, v in x.items()))
    return ("s", x)


def _unflatten(tree, it):
    if tree == _T:
        return next(it)
    tag, body = tree
    if tag == "s":
        return body
    if tag == "dict":
        return {k: _unflatten(v, it) for k, v in body}
    items = [_unflatten(i, it) for i in body]
    return tuple(items) if tag == "tuple" else items


def _dictionary_length() -> int:
    from sqlrs_tpu_torch.data.strings import GLOBAL_STRINGS

    return len(GLOBAL_STRINGS)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _slots(tensors) -> tuple[list[int], int]:
    """Aligned byte offsets of tensors laid out one after another, and the
    total."""
    offs, pos = [], 0
    for t in tensors:
        offs.append(pos)
        pos += -(-_nbytes(t) // _ALIGN) * _ALIGN
    return offs, pos


def _as_bytes(t):
    flat = t.reshape(-1)
    if not flat.numel():
        return torch.empty(0, dtype=torch.uint8, device=t.device)
    if flat.stride(0) != 1:  # a broadcast (stride 0) or strided tensor
        flat = torch.empty(flat.shape, dtype=flat.dtype, device=flat.device).copy_(flat)
    return flat.view(torch.uint8)


def _byte_view(flat, off: int, t_like):
    """A view of flat[off:] with t_like's dtype and shape."""
    nb = _nbytes(t_like)
    return flat[off : off + nb].view(t_like.dtype).view(t_like.shape)


_PADS: dict = {}


def _pad(dev):
    """Filler bytes for the gaps between aligned slots (never read)."""
    pad = _PADS.get(dev)
    if pad is None:
        pad = _PADS[dev] = torch.zeros(_ALIGN, dtype=torch.uint8, device=dev)
    return pad


def _pack(tensors, offs, total, out) -> None:
    """Write tensors into the flat uint8 `out` at their aligned offsets, in
    one torch.cat (one launch)."""
    pad = _pad(out.device)
    parts, pos = [], 0
    for t, off in zip(tensors, offs):
        if off > pos:
            parts.append(pad[: off - pos])
        b = _as_bytes(t)
        parts.append(b)
        pos = off + b.shape[0]
    if total > pos:
        parts.append(pad[: total - pos])
    if len(parts) == 1:
        out.copy_(parts[0])
    else:
        torch.cat(parts, out=out)


def _copied(leaves) -> list[int]:
    """The tensor inputs copied into the input region: all but the resident
    ones, which are read where they lie."""
    return [i for i, t in enumerate(leaves) if not is_resident(t)]


def _tensor_sig(t, resident: bool):
    sig = (tuple(t.shape), t.dtype, t.device)
    if resident:
        return sig + (t.data_ptr(), t.stride())
    return sig


class ProgramError(RuntimeError):
    """A program's capture or replay failed. It is never caught to fall back
    to the eager run, and code that takes errors as results (the fuzz
    corpus' outcomes, the expected errors of sql_cases) lets it through."""


# ---- statistics ----------------------------------------------------------------


class Stats:
    """What the programs of this process did (reset by `reset_stats`)."""

    def __init__(self) -> None:
        self.calls = 0          # program calls that reached the cache
        self.replays = 0        # graph replays (one submission each)
        self.captures = 0       # graphs captured
        self.capture_s = 0.0    # host seconds spent capturing
        self.warmups = 0        # first sightings, run eagerly
        self.inline = 0         # calls run directly (CPU, off, nested)
        self.input_copies = 0   # copies into input regions (one a replay at most)
        self.output_copies = 0  # clones out of the pool (one a replay at most)
        self.flushes = 0        # pool-bytes flushes
        self.evictions = 0      # LRU evictions
        self.eager_routed: Counter = Counter()  # reason -> calls routed eagerly
        # kernel name -> launches made by graph replays (in its count too)
        self.replayed_launches: Counter = Counter()
        self.replays_by: Counter = Counter()  # program name -> replays

    def as_dict(self) -> dict:
        d = dict(vars(self))
        for k in ("eager_routed", "replayed_launches", "replays_by"):
            d[k] = dict(d[k])
        return d


stats = Stats()


def reset_stats() -> None:
    global stats
    stats = Stats()


def route_eagerly(reason: str) -> None:
    """Count a call that the caller routes eagerly, by a predicate decided
    before any capture (printed by chip_smoke.py's phase 13)."""
    if _DEPTH:
        return  # inside another program's body: not a routing decision
    stats.eager_routed[reason] += 1
    if _CHECKER is not None:
        _CHECKER.eager_routed[reason] += 1


# ---- the per-device cache --------------------------------------------------------


class _Entry:
    __slots__ = (
        "graph", "copied", "in_offs", "in_flat", "outs", "out_flat",
        "out_offs", "out_like", "out_tree", "kernel_delta", "pool_bytes",
    )


_SEEN = object()  # a signature run once, eagerly


class LRU:
    """Signatures -> entries (a graph's, or _SEEN), least recently used out
    past max_entries. When the last graph leaves, `new_pool()` runs: PyTorch
    refuses a capture into a pool whose graphs are all gone."""

    def __init__(self, max_entries: int = MAX_ENTRIES) -> None:
        self.entries: OrderedDict = OrderedDict()
        self.max_entries = max_entries
        self.n_graphs = 0

    def __len__(self) -> int:
        return len(self.entries)

    def get(self, key):
        e = self.entries.get(key)
        if e is not None:
            self.entries.move_to_end(key)
        return e

    def put(self, key, entry) -> None:
        old = self.entries.get(key)
        self.n_graphs += (entry is not _SEEN) - (old is not None and old is not _SEEN)
        self.entries[key] = entry
        self.entries.move_to_end(key)
        while len(self.entries) > self.max_entries:
            _, gone = self.entries.popitem(last=False)
            stats.evictions += 1
            if gone is not _SEEN:
                self.n_graphs -= 1
                if self.n_graphs == 0:
                    self.new_pool()

    def new_pool(self) -> None:
        pass


class DeviceCache(LRU):
    """The programs of one device: an LRU of signatures, one shared graph
    pool, one capture stream."""

    def __init__(self, device) -> None:
        super().__init__()
        self.device = torch.device(device)
        total = torch.cuda.get_device_properties(self.device).total_memory
        self.max_pool_bytes = total // 4
        self.new_pool()
        self.stream = torch.cuda.Stream(self.device)

    def graphs(self) -> int:
        return self.n_graphs

    def new_pool(self) -> None:
        self.pool = torch.cuda.graph_pool_handle()
        self.pool_bytes = 0

    def flush(self) -> None:
        """Drop every graph and start a new pool."""
        self.entries.clear()
        self.n_graphs = 0
        self.new_pool()


_CACHES: dict = {}


def device_cache(device) -> DeviceCache:
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    c = _CACHES.get(dev)
    if c is None:
        c = _CACHES[dev] = DeviceCache(dev)
    return c


def caches() -> dict:
    return dict(_CACHES)


def clear() -> None:
    """Drop every device's graphs (tests; memory measurements)."""
    for c in _CACHES.values():
        c.flush()
    _CACHES.clear()


# ---- capture and replay ------------------------------------------------------------

_DEPTH = 0  # > 0 inside a program's warm-up, capture or checked body


def nested() -> bool:
    """Inside a program's body: a program called here is its function."""
    return _DEPTH > 0


@contextlib.contextmanager
def _inside():
    global _DEPTH
    _DEPTH += 1
    try:
        yield
    finally:
        _DEPTH -= 1


def _non_owning(t):
    """A tensor over t's memory that keeps nothing alive: the graph reaches
    its regions through these, while the pool may hand the memory to later
    captures (see the module docstring)."""
    st = t.untyped_storage()
    view = torch._C._construct_storage_from_data_pointer(
        st.data_ptr(), t.device, st.nbytes()
    )
    out = torch.empty(0, dtype=t.dtype, device=t.device)
    out.set_(view, t.storage_offset(), t.shape, t.stride())
    return out


def _body(fn, tree, leaves, copied, in_offs, in_flat):
    """Run fn over the input region's views (and the resident inputs), and
    lay its outputs out: ("input", j) for an output that is input j, else
    ("packed", i) at offset out_offs[i] of a flat buffer filled by one
    torch.cat. Returns (outs, packed, out_offs, out_total, out_flat,
    out_tree)."""
    args = list(leaves)
    for i, off in zip(copied, in_offs):
        args[i] = _byte_view(in_flat, off, leaves[i])
    out = fn(*_unflatten(tree, iter(args)))
    out_leaves: list = []
    out_tree = _flatten(out, out_leaves)
    outs, packed = [], []
    for t in out_leaves:
        src = next(
            (j for j, a in enumerate(args)
             if a.numel() and a.data_ptr() == t.data_ptr() and a.shape == t.shape
             and a.stride() == t.stride() and a.dtype == t.dtype),
            None,
        )
        if src is not None:
            outs.append(("input", src))
        else:
            outs.append(("packed", len(packed)))
            packed.append(t)
    out_offs, out_total = _slots(packed)
    out_flat = torch.empty(max(out_total, 1), dtype=torch.uint8, device=in_flat.device)
    if out_total:
        _pack(packed, out_offs, out_total, out_flat[:out_total])
    return outs, packed, out_offs, out_total, out_flat, out_tree


def _entry(copied, in_offs, in_flat, in_total, body_out, view) -> _Entry:
    outs, packed, out_offs, out_total, out_flat, out_tree = body_out
    e = _Entry()
    e.copied = copied
    e.in_offs = in_offs
    e.in_flat = view(in_flat)[:in_total] if in_total else None
    e.outs = outs
    e.out_offs = out_offs
    e.out_like = [(p.dtype, tuple(p.shape), _nbytes(p)) for p in packed]
    e.out_flat = view(out_flat)[:out_total] if out_total else None
    e.out_tree = out_tree
    e.graph = None
    e.kernel_delta = ()
    e.pool_bytes = 0
    return e


def _capture(cache: DeviceCache, name: str, fn, tree, leaves) -> _Entry:
    dev = cache.device
    copied = _copied(leaves)
    in_offs, in_total = _slots([leaves[i] for i in copied])
    before = _kernel_counts()
    reserved0 = torch.cuda.memory_reserved(dev)
    t0 = time.perf_counter()
    g = torch.cuda.CUDAGraph()
    cur = torch.cuda.current_stream(dev)
    _pad(dev)  # made outside the capture: a tensor the graph does not own
    cache.stream.wait_stream(cur)
    with torch.cuda.device(dev), torch.cuda.stream(cache.stream), _inside():
        g.capture_begin(pool=cache.pool)
        try:
            in_flat = torch.empty(max(in_total, 1), dtype=torch.uint8, device=dev)
            body_out = _body(fn, tree, leaves, copied, in_offs, in_flat)
        except BaseException as err:
            # end the capture so that the stream is usable again, and raise
            # the body's error (a capture error is never hidden)
            try:
                g.capture_end()
            except RuntimeError:
                pass
            raise ProgramError(f"capturing program {name}: {type(err).__name__}: {err}") from err
        try:
            g.capture_end()
        except RuntimeError as err:
            raise ProgramError(f"capturing program {name}: {err}") from err
    cur.wait_stream(cache.stream)
    after = _kernel_counts()
    for k, b in zip(_KERNELS, before):
        k.launches = b  # a capture launches nothing
    e = _entry(copied, in_offs, in_flat, in_total, body_out, _non_owning)
    e.graph = g
    e.kernel_delta = tuple(a - b for a, b in zip(after, before))
    e.pool_bytes = max(torch.cuda.memory_reserved(dev) - reserved0, 0)
    stats.captures += 1
    stats.capture_s += time.perf_counter() - t0
    return e


def _replay(name: str, e: _Entry, leaves):
    rec = profiling.RECORDER
    if rec is not None:
        return rec.call("programs.replay", "programs", name, _replay_in, name, e, leaves, rec)
    return _replay_in(name, e, leaves, None)


def _replay_in(name: str, e: _Entry, leaves, rec):
    """A replay's work; `rec` the recorder while spans are recorded."""
    if e.in_flat is not None:
        region = ([leaves[i] for i in e.copied], e.in_offs, e.in_flat.shape[0], e.in_flat)
        if rec is None:
            _pack(*region)
        else:
            rec.call("programs.pack", "programs", None, _pack, *region)
        stats.input_copies += 1
    try:
        e.graph.replay()
    except RuntimeError as err:
        raise ProgramError(f"replaying program {name}: {err}") from err
    stats.replays += 1
    stats.replays_by[name] += 1
    stats.output_copies += e.out_flat is not None
    for k, d in zip(_KERNELS, e.kernel_delta):
        if d:
            k.launches += d
            stats.replayed_launches[k.__name__] += d
    return _outputs(e, leaves)


def _outputs(e: _Entry, leaves):
    """The outputs of a replay: the packed ones cloned out of the region in
    one copy, as views of the clone; the inputs handed back."""
    res = None if e.out_flat is None else e.out_flat.clone()
    out = []
    for kind, j in e.outs:
        if kind == "input":
            out.append(leaves[j])
            continue
        dtype, shape, nb = e.out_like[j]
        if nb == 0:
            out.append(torch.empty(shape, dtype=dtype, device=leaves[0].device))
        else:
            off = e.out_offs[j]
            out.append(res[off : off + nb].view(dtype).view(shape))
    return _unflatten(e.out_tree, iter(out))


def _emulate(name: str, fn, tree, leaves):
    """A call as a capture and a replay would lay it out, without a graph
    (`emulating()`, for the CPU tests): the inputs copied into a region,
    the body run on its views, the outputs packed and cloned out; its spans
    are a replay's."""
    rec = profiling.RECORDER
    with _inside():
        if rec is None:
            return _emulate_in(fn, tree, leaves, None)
        return rec.call("programs.replay", "programs", name, _emulate_in, fn, tree, leaves, rec)


def _emulate_in(fn, tree, leaves, rec):
    copied = _copied(leaves)
    in_offs, in_total = _slots([leaves[i] for i in copied])
    in_flat = torch.empty(max(in_total, 1), dtype=torch.uint8, device=leaves[0].device)
    if in_total:
        region = ([leaves[i] for i in copied], in_offs, in_total, in_flat[:in_total])
        if rec is None:
            _pack(*region)
        else:
            rec.call("programs.pack", "programs", None, _pack, *region)
    body_out = _body(fn, tree, leaves, copied, in_offs, in_flat)
    return _outputs(_entry(copied, in_offs, in_flat, in_total, body_out, lambda t: t), leaves)


_EMULATE = False


@contextlib.contextmanager
def emulating():
    """On the CPU, run every program call as `_emulate` lays it out (the
    input region, the body on its views, the packed outputs' clone), so
    that tests hold those layouts to the eager results. Inside
    `checking()` too, the body then sees the input region's views, so an
    in-place write is caught only on a resident input."""
    global _EMULATE
    _EMULATE = True
    try:
        yield
    finally:
        _EMULATE = False


def signature(name: str, extra, tree, leaves) -> tuple:
    """A program call's key: the program, its extra key, the arguments'
    structure with their static values, each tensor's shape, dtype and
    device (and address, for a resident one), and the dictionary's
    length."""
    return (
        name, extra, tree,
        tuple(_tensor_sig(t, is_resident(t)) for t in leaves),
        _dictionary_length(),
    )


def _call(name: str, fn, args, kwargs, extra=()):
    if _CHECKER is not None:
        return _CHECKER.run(name, fn, args, kwargs, extra)
    if _DEPTH or not enabled():
        stats.inline += 1
        return fn(*args, **kwargs)
    leaves: list = []
    tree = _flatten((args, kwargs), leaves)
    if not leaves or all(t.numel() == 0 for t in leaves):
        stats.inline += 1
        return fn(*args, **kwargs)
    if any(t.device != leaves[0].device for t in leaves):
        route_eagerly("inputs on more than one device")
        return fn(*args, **kwargs)
    if leaves[0].device.type != "cuda":
        if _EMULATE:
            return _emulate(name, lambda a, k: fn(*a, **k), tree, leaves)
        stats.inline += 1
        return fn(*args, **kwargs)
    cache = device_cache(leaves[0].device)
    key = signature(name, extra, tree, leaves)
    stats.calls += 1
    e = cache.get(key)
    if e is None:
        cache.put(key, _SEEN)
        stats.warmups += 1
        rec = profiling.RECORDER
        with _inside():
            if rec is None:
                return fn(*args, **kwargs)
            return rec.call("programs.first_run", "programs", name, fn, *args, **kwargs)
    if e is _SEEN:
        rec = profiling.RECORDER
        if rec is None:
            e = _capture(cache, name, lambda a, k: fn(*a, **k), tree, leaves)
        else:
            e = rec.call("programs.capture", "programs", name, _capture, cache, name,
                         lambda a, k: fn(*a, **k), tree, leaves)
        cache.pool_bytes += e.pool_bytes
        if cache.pool_bytes > cache.max_pool_bytes:
            # past the bound: this graph runs once, then every graph of the
            # pool goes (every graph in the cache lies in cache.pool)
            out = _replay(name, e, leaves)
            cache.flush()
            stats.flushes += 1
            return out
        cache.put(key, e)
    return _replay(name, e, leaves)


class Program:
    """A function of tensors run as a program (see the module docstring)."""

    def __init__(self, fn, name: str) -> None:
        self.fn = fn
        self.name = name
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        return _call(self.name, self.fn, args, kwargs)


def program(fn) -> Program:
    """Decorator: `fn` becomes a program, keyed by its qualified name."""
    return Program(fn, f"{fn.__module__}.{fn.__qualname__}")


def run(name: str, fn, args: tuple, extra) -> object:
    """Run `fn(*args)` as the program `name`; `extra` is hashable and,
    with `name` and the arguments' signature, must determine everything
    that fn does (the expression executor's program closes over its
    expression list and keys on its reprs)."""
    return _call(name, fn, args, {}, extra)


# ---- sharded stages (the reference's shard_map programs) ----------------------------


def mesh_key(mesh) -> tuple:
    """The mesh as a static part of a stage's key: its global size, its
    local shard count, the first local shard's global index and the
    devices. Two meshes never share a graph."""
    return ("mesh", mesh.size, mesh.n_local, mesh.offset, tuple(str(d) for d in mesh.devices))


def mesh_eager_reason(mesh):
    """Why a stage over `mesh` cannot be one program, or None. Decided
    before the call: a process group's collectives are torch.distributed
    calls, which a capture under gloo cannot hold (NCCL capture is not
    done); shards on several devices would need one graph a device."""
    if mesh.group is not None:
        return "process-group mesh"
    if len(set(mesh.devices)) > 1:
        return "shards on more than one device"
    return None


class MeshProgram(Program):
    """A sharded stage `fn(mesh, *args)` run as ONE program: every shard's
    body and the collectives between the bodies in one graph, as the
    reference's `shard_map` runs them in one SPMD program. Where
    `mesh_eager_reason` names a reason, the stage runs eagerly and the
    reason is counted. `extra()` returns module state the body reads,
    which joins the key."""

    def __init__(self, fn, name: str, extra=None) -> None:
        super().__init__(fn, name)
        self.extra = extra

    def __call__(self, mesh, *args, **kwargs):
        why = mesh_eager_reason(mesh)
        if why is not None:
            route_eagerly(why)
            return self.fn(mesh, *args, **kwargs)
        return self.staged(mesh, self.fn, (), args, kwargs)

    def staged(self, mesh, fn, key: tuple, args, kwargs):
        """`fn(mesh, *args, **kwargs)` as this stage's program over a mesh
        that `mesh_eager_reason` lets through. `key` (hashable) joins the
        stage's key: with the arguments it must determine what fn does
        (a closure's expression keys on its repr)."""
        extra = mesh_key(mesh) + (self.extra() if self.extra is not None else ()) + key
        return _call(self.name, functools.partial(fn, mesh), args, kwargs, extra)


def mesh_program(fn=None, *, extra=None):
    """Decorator: `fn(mesh, ...)` becomes a sharded stage's program, keyed by
    its qualified name, the mesh (`mesh_key`), `extra()` and the arguments."""

    def wrap(f):
        return MeshProgram(f, f"{f.__module__}.{f.__qualname__}", extra)

    return wrap if fn is None else wrap(fn)


# ---- checking mode (CPU tests) ----------------------------------------------------

_CHECKER = None

_aten = torch.ops.aten
# operations that read the host or give an output whose shape depends on
# the data: a capture refuses them (or bakes in one run's sizes)
_HOST_READS = {
    _aten._local_scalar_dense.default, _aten.nonzero.default,
    _aten.masked_select.default, _aten.is_nonzero.default, _aten.equal.default,
    _aten._unique.default, _aten._unique2.default, _aten.unique_dim.default,
    _aten.unique_consecutive.default, _aten.bincount.default,
}
_EMPTY = {
    _aten.empty.memory_format, _aten.empty_strided.default,
    _aten.empty_like.default,
}


class HostReadInProgram(ProgramError):
    """A program body did something a CUDA graph capture refuses."""


def _refuse(c, msg: str):
    err = HostReadInProgram(msg)
    c.refused.append(msg)
    return err


def _why_refused(func, args, kwargs):
    if func in _HOST_READS:
        return f"{func} reads the host"
    if func is _aten.lift_fresh.default:
        return "torch.tensor(...) from host data (a host-to-device upload)"
    if func in (_aten.index.Tensor, _aten.index_put.default, _aten.index_put_.default):
        for ix in args[1]:
            if ix is not None and ix.dtype in (torch.bool, torch.uint8):
                return f"{func} with a boolean mask (nonzero: a host read)"
    if func is _aten.repeat_interleave.Tensor and (kwargs or {}).get("output_size") is None:
        if len(args) < 3 or args[2] is None:
            return "repeat_interleave without output_size (a host read)"
    return None


def _host_method(orig, what):
    def f(self, *a, **k):
        c = _CHECKER
        if c is not None:
            if _DEPTH:
                raise _refuse(c, f"Tensor.{what}() inside program {c.current}")
            c.host_reads += 1
        return orig(self, *a, **k)

    return f


class Checker:
    """Counts, as the card would see them: `programs` program calls (one
    submission each), `input_copies` and `output_copies` (at most one each a
    call: the flat input region's fill and the packed outputs' clone),
    `eager_ops` (every operation outside programs that is not a view or an
    empty allocation) and `host_reads` (`.item()`, `int(t)`, `.numpy()`,
    `.tolist()`, nonzero and the other reads). `submissions()` is their sum.
    Inside a program body, any such read, a boolean-mask index,
    `torch.tensor` of host data or an in-place write to an input raises
    HostReadInProgram."""

    def __init__(self) -> None:
        self.programs = 0
        self.input_copies = 0
        self.output_copies = 0
        self.eager_ops = 0
        self.host_reads = 0
        self.by_program: Counter = Counter()
        self.eager_routed: Counter = Counter()
        self.keys: set = set()      # the signatures the calls would use
        self.refused: list = []     # every HostReadInProgram raised
        self.current = None
        self._inputs: set = set()

    def submissions(self) -> int:
        return (self.programs + self.input_copies + self.output_copies
                + self.eager_ops + self.host_reads)

    def run(self, name, fn, args, kwargs, extra=()):
        if _DEPTH or not enabled():
            return fn(*args, **kwargs)
        leaves: list = []
        tree = _flatten((args, kwargs), leaves)
        if not leaves or all(t.numel() == 0 for t in leaves):
            return fn(*args, **kwargs)
        self.keys.add(signature(name, extra, tree, leaves))
        self.programs += 1
        self.by_program[name] += 1
        if any(leaves[i].numel() for i in _copied(leaves)):
            self.input_copies += 1
        self.current = name
        self._inputs = {t.untyped_storage().data_ptr() for t in leaves if t.numel()}
        try:
            if _EMULATE:
                out = _emulate(name, lambda a, k: fn(*a, **k), tree, leaves)
            else:
                with _inside():
                    out = fn(*args, **kwargs)
        finally:
            self._inputs = set()
            self.current = None
        outs: list = []
        _flatten(out, outs)
        ins = {(t.data_ptr(), tuple(t.shape), t.stride(), t.dtype) for t in leaves}
        if any(o.numel() and (o.data_ptr(), tuple(o.shape), o.stride(), o.dtype) not in ins
               for o in outs):
            self.output_copies += 1
        return out


class _Mode(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self, checker: Checker) -> None:
        super().__init__()
        self.c = checker

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        c = self.c
        if _DEPTH:
            why = _why_refused(func, args, kwargs)
            if why is not None:
                raise _refuse(c, f"{why} inside program {c.current}")
            s = func._schema
            if (s.arguments and s.arguments[0].alias_info is not None
                    and s.arguments[0].alias_info.is_write
                    and isinstance(args[0], torch.Tensor) and args[0].numel()
                    and args[0].untyped_storage().data_ptr() in c._inputs):
                raise _refuse(c, f"{func} writes into an input of program {c.current}")
        elif func in _HOST_READS:
            c.host_reads += 1
        elif func not in _EMPTY:
            ret = func._schema.returns
            view = bool(ret) and ret[0].alias_info is not None and not ret[0].alias_info.is_write
            if not view or func is _aten.lift_fresh.default:
                c.eager_ops += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def checking():
    """Run every program body under a mode that raises on host reads, and
    count what the statements would submit on the card (a `Checker`).
    For the CPU tests; programs run their bodies directly here."""
    global _CHECKER
    if _CHECKER is not None:
        raise RuntimeError("programs.checking() does not nest")
    c = Checker()
    patched = {}
    for name in ("numpy", "tolist", "__array__"):
        patched[name] = getattr(torch.Tensor, name)
        setattr(torch.Tensor, name, _host_method(patched[name], name))
    _CHECKER = c
    try:
        with _Mode(c):
            yield c
    finally:
        _CHECKER = None
        for name, orig in patched.items():
            setattr(torch.Tensor, name, orig)
