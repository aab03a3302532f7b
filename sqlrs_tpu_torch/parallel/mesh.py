"""The shard mesh: an ordered list of torch devices, one per shard.

The port of sqlrs_tpu/parallel/mesh.py. The JAX engine places row blocks
with `NamedSharding` and runs `shard_map` programs over a mesh whose
devices may span processes. Here each process holds a `Mesh` that lists
its own shards' torch devices, keeps each shard's rows on its device, runs
each per-shard stage in a loop over its shards, and moves a tensor from one
shard to another only in parallel/collectives.py.

One process (the single-controller case): `mesh.devices[i]` holds shard i
of `mesh.size`. A device may repeat in the list only when the caller lists
it so: N shards on one card (`make_mesh(4, devices=["cuda:0"] * 4)`) run
every exchange path there; on a host with 4 GPUs `make_mesh(4)` puts shard
i on cuda:i. Nothing puts a shard on the CPU or doubles shards up unless
asked.

Several processes (SPMD, as the reference runs across hosts): every
process joins a torch.distributed process group through
`initialize_distributed`, loads the same tables and runs the same
statements; `make_mesh` then builds the flat global mesh, in which process
`rank` holds k shards, global shards rank * k .. rank * k + k - 1, on the
devices it lists (`mesh.devices`, this process's shards only;
`mesh.local_shards` pairs each with its global index). `mesh.size` is the
global shard count: it partitions rows and picks destination shards.
Placement (row_blocks, live_blocks, replicate, shard_positions) places only
this process's shards at their global row offsets and needs no
communication; the collectives cross processes.

The backend is NCCL for CUDA shards and gloo for CPU shards. Ranks that
share one card cannot form an NCCL communicator (NCCL refuses two ranks on
one GPU), so they pass backend="gloo" and their CUDA tensors are staged
through host memory. Nothing switches backend on a failure.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch

from sqlrs_tpu_torch.errors import ExecutorError

DATA_AXIS = "x"
# a rank that takes another branch than its peers fails the run after this
# long instead of hanging it (SQLRS_TPU_DIST_TIMEOUT seconds)
_DEFAULT_TIMEOUT_S = 600


class Mesh:
    """Flat one-axis mesh. `devices` are this process's shards, in global
    order; `rank`, `n_proc` and `group` say where they sit in a
    multi-process mesh (group None: one process holds every shard)."""

    def __init__(self, devices: Sequence, *, rank: int = 0, n_proc: int = 1,
                 group=None, wire=None, shape: Optional[dict] = None) -> None:
        if not devices:
            raise ExecutorError("a mesh needs at least one device")
        self.devices = [torch.device(d) for d in devices]
        self.rank = rank
        self.n_proc = n_proc
        self.group = group
        self.wire = wire  # where cross-process buffers live (collectives.wire_device)
        self._shape = shape
        # bytes this process sent to other processes, and the host seconds
        # spent copying CUDA tensors to and from host memory for gloo
        self.stats = {"bytes": 0, "staging_s": 0.0}

    def reset_stats(self) -> None:
        self.stats = {"bytes": 0, "staging_s": 0.0}

    @property
    def size(self) -> int:
        """The global shard count."""
        return len(self.devices) * self.n_proc

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def offset(self) -> int:
        """The global index of this process's first shard."""
        return self.rank * len(self.devices)

    @property
    def local_shards(self) -> list:
        """(global shard index, device) of each of this process's shards."""
        return [(self.offset + j, d) for j, d in enumerate(self.devices)]

    @property
    def shape(self) -> dict:
        return dict(self._shape) if self._shape else {DATA_AXIS: self.size}

    def __repr__(self) -> str:
        devs = [str(d) for d in self.devices]
        if self.group is None:
            return f"Mesh({devs})"
        return f"Mesh({devs}, rank {self.rank} of {self.n_proc}, {self.size} shards)"


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
) -> None:
    """Join the torch.distributed process group (multi-process execution):
    after this, `make_mesh` builds a mesh whose shards span the processes.
    A second call is a no-op.

    Parameters fall back to SQLRS_TPU_COORDINATOR (host:port, or an init
    URL such as tcp://host:port or file:///path), SQLRS_TPU_NUM_PROCESSES
    and SQLRS_TPU_PROCESS_ID, then to torchrun's MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE and RANK. `backend` defaults to "nccl" where CUDA is
    available and "gloo" elsewhere; ranks whose shards share one card pass
    "gloo". The group's timeout is SQLRS_TPU_DIST_TIMEOUT seconds (600 by
    default), so that a rank that diverges fails the run."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    addr = coordinator_address or os.environ.get("SQLRS_TPU_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("SQLRS_TPU_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("SQLRS_TPU_PROCESS_ID")
    if addr is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if addr is None or num_processes is None or process_id is None:
        raise ExecutorError(
            "initialize_distributed needs a coordinator address, a process count "
            "and a process id (arguments, SQLRS_TPU_* or torchrun's variables)"
        )
    if "://" not in addr:
        addr = f"tcp://{addr}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(_local_rank(process_id))
    timeout = datetime.timedelta(
        seconds=float(os.environ.get("SQLRS_TPU_DIST_TIMEOUT", _DEFAULT_TIMEOUT_S))
    )
    dist.init_process_group(
        backend, init_method=addr, world_size=int(num_processes), rank=int(process_id),
        timeout=timeout,
    )


def _local_rank(rank: int) -> int:
    """This process's card: LOCAL_RANK, else the rank modulo the cards."""
    lr = _env_int("LOCAL_RANK")
    if lr is not None:
        return lr
    n = torch.cuda.device_count()
    return rank % n if n else 0


def _process_mesh(n_devices: Optional[int], devices: Optional[Sequence],
                  shape_of=None) -> Mesh:
    """The flat global mesh over the initialised process group: this
    process's devices as listed (default: n_devices / n_proc shards, one
    when n_devices is None, on cuda:{LOCAL_RANK}). Every process must hold
    the same number of shards: one all_gather of the counts checks it, and
    every process raises alike when it fails."""
    import torch.distributed as dist

    from sqlrs_tpu_torch.parallel import collectives

    n_proc, rank = dist.get_world_size(), dist.get_rank()
    backend = dist.get_backend()
    if devices is None:
        k = 1 if n_devices is None else max(n_devices // n_proc, 1)
        devs = [torch.device("cuda", _local_rank(rank))] * k
    else:
        devs = [torch.device(d) for d in devices]
    bad = int(
        (backend == "nccl" and any(d.type != "cuda" for d in devs))
        or any(d.type == "cuda" and not torch.cuda.is_available() for d in devs)
    )
    counts = collectives.gather_ints(backend, [len(devs), bad])
    ks = [int(c[0]) for c in counts]
    if any(int(c[1]) for c in counts):
        raise ExecutorError(
            f"make_mesh: a process listed devices its backend ({backend}) cannot "
            "serve (NCCL needs CUDA shards; CUDA shards need CUDA)"
        )
    if len(set(ks)) != 1:
        raise ExecutorError(f"make_mesh: every process must hold as many shards; got {ks}")
    if n_devices is not None and n_devices != n_proc * ks[0]:
        raise ExecutorError(
            f"make_mesh: {n_devices} shards asked, {n_proc} processes x {ks[0]} listed"
        )
    shape = shape_of(n_proc, ks[0]) if shape_of else None
    return Mesh(devs, rank=rank, n_proc=n_proc, group=dist.group.WORLD,
                wire=collectives.wire_device(backend), shape=shape)


def _distributed() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def make_multihost_mesh(axis_names: tuple = ("host", "device"),
                        devices: Optional[Sequence] = None) -> Mesh:
    """The hierarchical processes x devices view of the flat mesh: the same
    shards, shape {axis_names[0]: n_proc, axis_names[1]: k}, or (1, n) when
    the shard count does not divide by the process count. Collectives over
    it are the flat mesh's (they always run over every shard)."""
    h, d = axis_names

    def shape_of(n_proc: int, k: int) -> dict:
        n = n_proc * k
        return {h: 1, d: n} if n % n_proc else {h: n_proc, d: n // n_proc}

    if _distributed():
        return _process_mesh(None, devices, shape_of)
    mesh = make_mesh(devices=devices) if devices is not None else make_mesh()
    mesh._shape = shape_of(1, mesh.size)
    return mesh


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """With `devices`, a mesh over them in order (repeats allowed: the
    caller listed them). Otherwise the first n CUDA devices, all of them
    when n is None; fewer than n raises.

    After initialize_distributed: the global mesh, `devices` listing this
    process's shards and `n_devices` (if given) the global count."""
    if _distributed():
        return _process_mesh(n_devices, devices)
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if n_devices is not None and len(devs) != n_devices:
            raise ExecutorError(
                f"make_mesh: {n_devices} shards asked, {len(devs)} devices listed"
            )
        for d in devs:
            if d.type == "cuda" and not torch.cuda.is_available():
                raise ExecutorError(f"device {d} listed, but CUDA is not available")
        return Mesh(devs)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else n_devices
    if n < 1 or n > have:
        raise ExecutorError(
            f"make_mesh: {n_devices} shards asked, {have} CUDA devices present "
            "(list the devices to place several shards on one)"
        )
    return Mesh([torch.device("cuda", i) for i in range(n)])


# ---- placement: the stand-ins for row_sharding / replicated ------------------


def padded_capacity(n: int, n_shards: int) -> int:
    """Rows padded to a multiple of the shard count, at least one a shard
    (dist_executor.shard_batch's layout)."""
    return max(-(-n // n_shards) * n_shards, n_shards)


def row_blocks(mesh: Mesh, x, fill=0) -> list:
    """`x` (1-D, any device, the whole array) laid out block-contiguously:
    padded with `fill` to padded_capacity rows, shard g holding rows
    [g * cap / n, (g + 1) * cap / n) on its device, each a fresh copy (so
    no block aliases the source or another block). Only this process's
    shards are placed."""
    n_dev = mesh.size
    n = int(x.shape[0])
    local = padded_capacity(n, n_dev) // n_dev
    out = []
    for g, dev in mesh.local_shards:
        blk = torch.full((local,), fill, dtype=x.dtype, device=dev)
        lo, hi = min(g * local, n), min((g + 1) * local, n)
        if hi > lo:
            blk[: hi - lo] = x[lo:hi].to(dev)
        out.append(blk)
    return out


def live_blocks(mesh: Mesh, n: int) -> list:
    """The bool row blocks marking the first n rows of a row_blocks layout
    as real (the rest are padding)."""
    local = padded_capacity(n, mesh.size) // mesh.size
    return [
        torch.arange(local, device=dev) < (n - g * local)
        for g, dev in mesh.local_shards
    ]


def replicate(mesh: Mesh, x) -> list:
    """A copy of `x` on every shard's device (replicated placement)."""
    return [x.to(dev, copy=True) for dev in mesh.devices]


def shard_positions(mesh: Mesh, local: int) -> list:
    """Each shard's global row positions of a block layout with `local`
    rows a shard (the sharded `arange(capacity)`)."""
    return [
        g * local + torch.arange(local, dtype=torch.int64, device=dev)
        for g, dev in mesh.local_shards
    ]
