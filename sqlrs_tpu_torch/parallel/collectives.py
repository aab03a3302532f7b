"""Cross-shard collectives of the single-controller mesh.

The counterpart of the `jax.lax` collectives that the JAX engine calls
inside `shard_map` (`all_to_all`, `psum`, `pmin`, `pmax`, `all_gather`,
`ppermute`; a pmax is `reduce_max`, read on the host), as plain functions over per-shard lists: element i of an
argument is shard i's tensor, on `mesh.devices[i]`, and element i of a
result is placed on that device too. This module is the one place where a
tensor crosses from one shard to another (placement from the controller's
device is parallel/mesh.py's, and collecting a result to it is `gather`
here); a multi-process slice replaces these bodies with torch.distributed
calls.

Every result is a new tensor. With several shards on one device
`t.to(dev)` returns `t` itself, so a received buffer would otherwise alias
the sender's, and a consumer writing it in place would corrupt the other
shard; the copies here rule that out, whatever the consumers do.

Reductions run in shard order 0..n-1 on shard 0's device and the result is
copied out, so a float psum adds in the same order on every run.
"""

from __future__ import annotations

import torch

from sqlrs_tpu_torch.parallel.mesh import replicate


def all_to_all(mesh, send: list) -> list:
    """`lax.all_to_all(x, axis, 0, 0, tiled=False)`: send[j] is shard j's
    (n_shards, ...) buffer whose row i goes to shard i; returns recv with
    recv[i][j] = send[j][i]."""
    n = mesh.size
    return [
        torch.stack([send[j][i].to(dev) for j in range(n)])
        for i, dev in enumerate(mesh.devices)
    ]


def _reduce(mesh, xs: list, op):
    d0 = mesh.devices[0]
    acc = xs[0].to(d0, copy=True)
    for x in xs[1:]:
        acc = op(acc, x.to(d0))
    return acc


def reduce_sum(mesh, xs: list):
    """The sum over shards in shard order, on shard 0's device."""
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
    red = {"sum": reduce_sum, "min": reduce_min}[op](mesh, xs)
    chunk = red.shape[0] // mesh.size
    return [
        red[i * chunk:(i + 1) * chunk].to(dev, copy=True)
        for i, dev in enumerate(mesh.devices)
    ]


def all_gather(mesh, xs: list, tiled: bool = False) -> list:
    """Every shard's tensor, stacked in shard order on every device
    (concatenated along the first axis when tiled)."""
    join = torch.cat if tiled else torch.stack
    return [join([x.to(dev) for x in xs]) for dev in mesh.devices]


def ppermute(mesh, xs: list, perm) -> list:
    """`lax.ppermute(x, axis, perm)`: for each (src, dst) pair shard dst
    receives shard src's tensor; a shard no pair sends to gets zeros."""
    out = [None] * len(xs)
    for src, dst in perm:
        out[dst] = xs[src].to(mesh.devices[dst], copy=True)
    return [torch.zeros_like(x) if o is None else o for o, x in zip(out, xs)]


def ring_perm(n: int) -> list:
    """The ring permutation (i -> i + 1 mod n)."""
    return [(i, (i + 1) % n) for i in range(n)]


def gather(mesh, xs: list, device):
    """Collect: the shards' tensors concatenated in shard order on
    `device` (the collect boundary of a sharded result)."""
    return torch.cat([x.to(device) for x in xs])
