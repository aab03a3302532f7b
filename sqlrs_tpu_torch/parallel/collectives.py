"""Cross-shard collectives of the shard mesh.

The counterpart of the `jax.lax` collectives that the JAX engine calls
inside `shard_map` (`all_to_all`, `psum`, `pmin`, `pmax`, `all_gather`,
`ppermute`; a pmax is `reduce_max`, read on the host), as plain functions
over per-shard lists: element j of an argument is the tensor of this
process's j-th shard, on `mesh.devices[j]`, and element j of a result is
placed on that device too. This module is the one place where a tensor
crosses from one shard to another (placement from the controller's device
is parallel/mesh.py's, and collecting a result to it is `gather` here).

One process holds every shard: the bodies move tensors between devices.
Several processes (`mesh.group` set): the part that crosses processes is a
torch.distributed call on a fixed-shape buffer (`all_to_all_single`,
`all_gather`, `isend`/`irecv` for ppermute), on the wire device: the card
for NCCL, host memory for gloo, through which CUDA tensors are staged
explicitly. Bools travel as uint8. `mesh.stats` counts the bytes this
process sends to others and the seconds spent staging.

The one-process bodies read nothing on the host and size every result by
its inputs' shapes, so a sharded stage that calls them is one program
(utils/programs.mesh_program): on shards that share one card they are
device-to-device copies and reductions inside the stage's CUDA graph.
`reduce_max` is the reference's pmax; where the reference reads it on the
host (an overflow, phase A's m), the caller reads it after the stage.
`LiveRows` and `gather` (nonzero, data-sized results) are collect
boundaries and run outside every stage. The process-group bodies are
torch.distributed calls and run eagerly.

Every result is a new tensor. With several shards on one device
`t.to(dev)` returns `t` itself, so a received buffer would otherwise alias
the sender's, and a consumer writing it in place would corrupt the other
shard; the copies here rule that out, whatever the consumers do.

Reductions run in shard order 0..n-1 on this process's first shard's
device and the result is copied out, so a float psum adds in the same
order on every run; across processes the shards' tensors are all-gathered
first and reduced the same way in every process (never by the backend's
all_reduce, whose order varies), so every process holds the same bits as
the single-process run.
"""

from __future__ import annotations

import time

import torch

from sqlrs_tpu_torch.parallel.mesh import replicate

def wire_device(backend: str) -> torch.device:
    """Where a backend's buffers live: the current card for NCCL, host
    memory for gloo."""
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _staged(mesh, fn, *devices):
    """fn() timed into mesh.stats when it copies between a card and the
    host."""
    types = {d.type for d in devices}
    if types != {"cpu", "cuda"}:
        return fn()
    cuda_dev = next(d for d in devices if d.type == "cuda")
    torch.cuda.synchronize(cuda_dev)  # the copy's own time, not the queue's
    t0 = time.perf_counter()
    out = fn()
    mesh.stats["staging_s"] += time.perf_counter() - t0
    return out


def _send(mesh, t):
    """t as it goes on the wire: bools as uint8, on the wire device."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if t.device != mesh.wire:
        t = _staged(mesh, lambda: t.to(mesh.wire), t.device, mesh.wire)
    return t.contiguous()


def _arrive(mesh, t, dtype, dev):
    """A received wire tensor as a new tensor of `dtype` on `dev`."""
    return _staged(mesh, lambda: t.to(dev, dtype=dtype, copy=True), t.device,
                   torch.device(dev))


def _stacked(xs):
    return torch.stack([x.to(xs[0].device) for x in xs])


def _gather_mp(mesh, xs):
    """Every shard's tensor, stacked in global shard order on the wire
    device: (n_shards, *shape). All shards' tensors share one shape."""
    import torch.distributed as dist

    x = _send(mesh, _stacked(xs))
    parts = [torch.empty_like(x) for _ in range(mesh.n_proc)]
    dist.all_gather(parts, x, group=mesh.group)
    mesh.stats["bytes"] += x.numel() * x.element_size() * (mesh.n_proc - 1)
    return torch.cat(parts)


def gather_ints(backend: str, values: list) -> list:
    """Each process's list of ints, in rank order, in every process (the
    mesh's construction check)."""
    import torch.distributed as dist

    x = torch.tensor(values, dtype=torch.int64).to(wire_device(backend))
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return [p.tolist() for p in parts]


def all_to_all(mesh, send: list) -> list:
    """`lax.all_to_all(x, axis, 0, 0, tiled=False)`: send[j] is shard j's
    (n_shards, ...) buffer whose row i goes to shard i; returns recv with
    recv[i][j] = send[j][i]."""
    if mesh.group is not None:
        return _all_to_all_mp(mesh, send)
    n = mesh.size
    return [
        torch.stack([send[j][i].to(dev) for j in range(n)])
        for i, dev in enumerate(mesh.devices)
    ]


def _all_to_all_mp(mesh, send: list) -> list:
    """One all_to_all_single: process p's (k, n, ...) stack, rearranged to
    (n_proc, k_src, k_dst, ...) by destination process; local shard j then
    receives column j of what every process sent, in global source order."""
    import torch.distributed as dist

    p, k = mesh.n_proc, mesh.n_local
    dtype = send[0].dtype
    x = _send(mesh, _stacked(send))
    rest = tuple(x.shape[2:])
    y = x.view(k, p, k, *rest).transpose(0, 1).contiguous()
    out = torch.empty_like(y)
    dist.all_to_all_single(out, y, group=mesh.group)
    mesh.stats["bytes"] += y.numel() * y.element_size() * (p - 1) // p
    return [
        _arrive(mesh, out[:, :, j].reshape(p * k, *rest), dtype, dev)
        for j, dev in enumerate(mesh.devices)
    ]


def _reduce(mesh, xs: list, op):
    d0 = mesh.devices[0]
    if mesh.group is not None:
        xs = list(_arrive(mesh, _gather_mp(mesh, xs), xs[0].dtype, d0).unbind(0))
    acc = xs[0].to(d0, copy=True)
    for x in xs[1:]:
        acc = op(acc, x.to(d0))
    return acc


def reduce_sum(mesh, xs: list):
    """The sum over all shards in shard order, on this process's first
    shard's device (the same value in every process)."""
    return _reduce(mesh, xs, torch.add)


def reduce_min(mesh, xs: list):
    return _reduce(mesh, xs, torch.minimum)


def reduce_max(mesh, xs: list):
    return _reduce(mesh, xs, torch.maximum)


def psum(mesh, xs: list) -> list:
    return replicate(mesh, reduce_sum(mesh, xs))


def pmin(mesh, xs: list) -> list:
    return replicate(mesh, reduce_min(mesh, xs))


def psum_scatter(mesh, xs: list, op: str = "sum") -> list:
    """psum (or pmin) of equal-length tensors, each shard keeping only its
    own contiguous 1/n of the result (psum then the own-chunk slice)."""
    if mesh.group is not None:
        return _reduce_scatter_mp(mesh, xs, op)
    red = {"sum": reduce_sum, "min": reduce_min}[op](mesh, xs)
    chunk = red.shape[0] // mesh.size
    return [
        red[g * chunk:(g + 1) * chunk].to(dev, copy=True)
        for g, dev in mesh.local_shards
    ]


def _reduce_scatter_mp(mesh, xs: list, op: str) -> list:
    """psum_scatter across processes: chunk g of every shard's tensor goes
    to shard g (one all_to_all), which adds the n chunks in shard order,
    the order of the single-process sum, element for element."""
    fn = {"sum": torch.add, "min": torch.minimum}[op]
    n = mesh.size
    chunk = xs[0].shape[0] // n
    recv = _all_to_all_mp(
        mesh, [x[:n * chunk].reshape(n, chunk, *x.shape[1:]) for x in xs]
    )
    out = []
    for r in recv:
        acc = r[0].clone()
        for i in range(1, n):
            acc = fn(acc, r[i])
        out.append(acc)
    return out


def all_gather(mesh, xs: list, tiled: bool = False) -> list:
    """Every shard's tensor, stacked in shard order on every device
    (concatenated along the first axis when tiled)."""
    if mesh.group is not None:
        whole = _gather_mp(mesh, xs)
        if tiled:
            whole = whole.reshape(-1, *whole.shape[2:])
        return [_arrive(mesh, whole, xs[0].dtype, dev) for dev in mesh.devices]
    join = torch.cat if tiled else torch.stack
    return [join([x.to(dev) for x in xs]) for dev in mesh.devices]


def ppermute(mesh, xs: list, perm) -> list:
    """`lax.ppermute(x, axis, perm)`: for each (src, dst) pair of global
    shards, shard dst receives shard src's tensor; a shard no pair sends
    to gets zeros."""
    if mesh.group is not None:
        return _ppermute_mp(mesh, xs, perm)
    out = [None] * len(xs)
    for src, dst in perm:
        out[dst] = xs[src].to(mesh.devices[dst], copy=True)
    return [torch.zeros_like(x) if o is None else o for o, x in zip(out, xs)]


def _ppermute_mp(mesh, xs: list, perm) -> list:
    """Pairs within this process copy; pairs across processes go as one
    batch of isend/irecv (tag: the destination shard). Every shard's
    tensor has the same shape, so a receiver sizes its buffer by its own."""
    import torch.distributed as dist

    k, off = mesh.n_local, mesh.offset
    out = [None] * k
    ops, pending = [], []
    for src, dst in perm:
        src_here, dst_here = off <= src < off + k, off <= dst < off + k
        if src_here and dst_here:
            out[dst - off] = xs[src - off].to(mesh.devices[dst - off], copy=True)
        elif src_here:
            t = _send(mesh, xs[src - off])
            ops.append(dist.P2POp(dist.isend, t, dst // k, mesh.group, dst))
            mesh.stats["bytes"] += t.numel() * t.element_size()
        elif dst_here:
            like = xs[dst - off]
            wire_dt = torch.uint8 if like.dtype == torch.bool else like.dtype
            buf = torch.empty(like.shape, dtype=wire_dt, device=mesh.wire)
            ops.append(dist.P2POp(dist.irecv, buf, src // k, mesh.group, dst))
            pending.append((dst - off, buf, like.dtype))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for j, buf, dtype in pending:
        out[j] = _arrive(mesh, buf, dtype, mesh.devices[j])
    return [torch.zeros_like(x) if o is None else o for o, x in zip(out, xs)]


def ring_perm(n: int) -> list:
    """The ring permutation (i -> i + 1 mod n)."""
    return [(i, (i + 1) % n) for i in range(n)]


class LiveRows:
    """The live rows of every shard, collected in shard order onto `device`
    (in every process): `take(xs)` is gather(mesh, xs, device) at the
    positions where gather(mesh, masks, device) is true. Across processes
    only live rows travel, each shard's padded to the largest live count
    (one all_gather of the counts tells every process)."""

    def __init__(self, mesh, masks: list, device) -> None:
        self.mesh, self.device = mesh, device
        if mesh.group is None:
            self.idx = torch.nonzero(gather(mesh, masks, device)).reshape(-1)
            self.n = int(self.idx.shape[0])
            return
        self.local = [torch.nonzero(m).reshape(-1) for m in masks]
        counts = _gather_mp(mesh, [i.new_full((1,), i.shape[0]) for i in self.local])
        self.counts = counts.reshape(-1).tolist()
        self.width = max(self.counts)
        self.n = sum(self.counts)

    def take(self, xs: list):
        if self.mesh.group is None:
            return gather(self.mesh, xs, self.device)[self.idx]
        if self.width == 0:  # no live row anywhere: nothing to send
            return torch.empty((0, *xs[0].shape[1:]), dtype=xs[0].dtype, device=self.device)
        packed = []
        for x, i in zip(xs, self.local):
            rows = x[i]
            pad = self.width - rows.shape[0]
            if pad:
                rows = torch.cat([rows, rows.new_zeros((pad, *rows.shape[1:]))])
            packed.append(rows)
        whole = _arrive(self.mesh, _gather_mp(self.mesh, packed), xs[0].dtype, self.device)
        return torch.cat([whole[g, :c] for g, c in enumerate(self.counts)])


def gather(mesh, xs: list, device):
    """Collect: every shard's tensor concatenated in shard order on
    `device` (the collect boundary of a sharded result; in every process,
    as the reference's process_allgather(tiled=True))."""
    if mesh.group is not None:
        whole = _gather_mp(mesh, xs)
        return _arrive(mesh, whole.reshape(-1, *whole.shape[2:]), xs[0].dtype, device)
    return torch.cat([x.to(device) for x in xs])
