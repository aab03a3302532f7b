"""The shard mesh: an ordered list of torch devices, one per shard.

The port of sqlrs_tpu/parallel/mesh.py. The JAX engine is single-
controller: one process holds a `jax.sharding.Mesh`, places row blocks
with `NamedSharding` and runs `shard_map` programs. Here one process holds
a `Mesh` of torch devices, keeps shard i's rows on `mesh.devices[i]`, runs
each per-shard stage in a loop over the shards, and moves a tensor from one
shard to another only in parallel/collectives.py.

A device may repeat in the list only when the caller lists it so: N shards
on one card (`make_mesh(4, devices=["cuda:0"] * 4)`) run every exchange
path there; on a host with 4 GPUs `make_mesh(4)` puts shard i on cuda:i.
Nothing puts a shard on the CPU or doubles shards up unless asked.

Not in this slice: `initialize_distributed` and `make_multihost_mesh`
(multi-process execution over torch.distributed).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from sqlrs_tpu_torch.errors import ExecutorError

DATA_AXIS = "x"


class Mesh:
    """Flat one-axis mesh: `devices[i]` holds shard i."""

    def __init__(self, devices: Sequence) -> None:
        if not devices:
            raise ExecutorError("a mesh needs at least one device")
        self.devices = [torch.device(d) for d in devices]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: len(self.devices)}

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def initialize_distributed(*_args, **_kwargs) -> None:
    raise ExecutorError(
        "initialize_distributed (multi-process execution) not yet ported to "
        "sqlrs_tpu_torch"
    )


def make_multihost_mesh(*_args, **_kwargs) -> Mesh:
    raise ExecutorError(
        "make_multihost_mesh (multi-process execution) not yet ported to "
        "sqlrs_tpu_torch"
    )


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """With `devices`, a mesh over them in order (repeats allowed: the
    caller listed them). Otherwise the first n CUDA devices, all of them
    when n is None; fewer than n raises."""
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
    """`x` (1-D, any device) laid out block-contiguously: padded with
    `fill` to padded_capacity rows, shard i holding rows
    [i * cap / n, (i + 1) * cap / n) on its device, each a fresh copy (so
    no block aliases the source or another block)."""
    n_dev = mesh.size
    n = int(x.shape[0])
    local = padded_capacity(n, n_dev) // n_dev
    out = []
    for i, dev in enumerate(mesh.devices):
        blk = torch.full((local,), fill, dtype=x.dtype, device=dev)
        lo, hi = min(i * local, n), min((i + 1) * local, n)
        if hi > lo:
            blk[: hi - lo] = x[lo:hi].to(dev)
        out.append(blk)
    return out


def live_blocks(mesh: Mesh, n: int) -> list:
    """The bool row blocks marking the first n rows of a row_blocks layout
    as real (the rest are padding)."""
    local = padded_capacity(n, mesh.size) // mesh.size
    return [
        torch.arange(local, device=dev) < (n - i * local)
        for i, dev in enumerate(mesh.devices)
    ]


def replicate(mesh: Mesh, x) -> list:
    """A copy of `x` on every shard's device (replicated placement)."""
    return [x.to(dev, copy=True) for dev in mesh.devices]


def shard_positions(mesh: Mesh, local: int) -> list:
    """Each shard's global row positions of a block layout with `local`
    rows a shard (the sharded `arange(capacity)`)."""
    return [
        i * local + torch.arange(local, dtype=torch.int64, device=dev)
        for i, dev in enumerate(mesh.devices)
    ]
