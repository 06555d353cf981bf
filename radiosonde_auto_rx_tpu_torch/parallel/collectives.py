"""Collectives over one mesh axis, on dicts of local shards.

The reference runs its sharded bodies under ``shard_map`` with ``lax``
collectives inside; the port runs each body as a host loop over this
process's shards (``mesh.local``), split at its collectives into
per-shard maps with one of these between them.  Every function takes a
sharded tensor — {coordinate: tensor on that shard's device}, one shape
and dtype on every shard, as in SPMD — and returns one with the same
keys.

Each collective is a set of messages (source shard -> destination
shard).  A message between two shards of this process is a device copy
(``.to(device, copy=True)``, a same-device copy on a virtual mesh).
Messages to and from other processes go through ``torch.distributed``:
per peer rank one packed message each way, all posted in one
``batch_isend_irecv``, packed in the order of the (source, destination)
coordinates on both ends.  Every process builds the same message list
from the mesh alone, so every process issues the same collectives in the
same order; none is issued inside a data-dependent branch.

Reductions add (or take the max) in shard-index order on every shard,
so a single-process run and a multi-process run of one mesh give the
same bits.
"""

import torch


def axis_index(mesh, coord, axis: str) -> int:
    """The index of shard ``coord`` along ``axis``."""
    return coord[mesh.axis(axis)]


def _peer(coord, ax: int, i: int):
    return coord[:ax] + (i,) + coord[ax + 1:]


def transfer(mesh, msgs, like):
    """Deliver ``msgs``: a list of (key, src coord, dst coord, payload)
    in one order on every process; ``payload()`` (called only where the
    source is local) returns a tensor of ``like``'s shape and dtype.
    Returns {key: tensor on the destination's device} for the messages
    whose destination is local."""
    me = mesh.process
    out, send, recv = {}, {}, {}
    for key, src, dst, payload in msgs:
        s_rank, d_rank = mesh.rank(src), mesh.rank(dst)
        if s_rank == me and d_rank == me:
            out[key] = payload().to(mesh.device(dst), copy=True)
        elif s_rank == me:
            send.setdefault(d_rank, []).append(payload())
        elif d_rank == me:
            recv.setdefault(s_rank, []).append((key, dst))
    if send or recv:
        import torch.distributed as dist
        comm = mesh.device(mesh.local[0])
        # masks travel as bytes (not every backend takes bool)
        wire = torch.uint8 if like.dtype == torch.bool else like.dtype
        ops, bufs = [], {}
        for peer in sorted(send):
            packed = torch.cat([t.reshape(-1).to(comm).view(wire)
                                for t in send[peer]])
            ops.append(dist.P2POp(dist.isend, packed, peer))
        for peer in sorted(recv):
            bufs[peer] = torch.empty(len(recv[peer]) * like.numel(),
                                     dtype=wire, device=comm)
            ops.append(dist.P2POp(dist.irecv, bufs[peer], peer))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for peer, items in recv.items():
            parts = bufs[peer].view(like.dtype).view(len(items), *like.shape)
            for (key, dst), part in zip(items, parts):
                out[key] = part.to(mesh.device(dst), copy=True)
    return out


def _like(shards):
    return next(iter(shards.values()))


def ppermute(shards: dict, mesh, axis: str, perm) -> dict:
    """``lax.ppermute``: shard ``j`` along ``axis`` sends to ``i`` for
    each (j, i) in ``perm``; a shard no pair names receives zeros."""
    ax = mesh.axis(axis)
    msgs = []
    for c in mesh.coords:
        for j, i in perm:
            if c[ax] == i:
                src = _peer(c, ax, j)
                msgs.append((c, src, c,
                             lambda src=src: shards[src].contiguous()))
    got = transfer(mesh, msgs, _like(shards))
    return {c: got[c] if c in got else torch.zeros_like(x)
            for c, x in shards.items()}


def _gather_group(shards: dict, mesh, axis: str) -> dict:
    """{local coord: [shard k of its ``axis`` group for k = 0..n-1], on
    the coord's device}."""
    ax = mesh.axis(axis)
    n = mesh.shape[axis]
    msgs = []
    for c in mesh.coords:
        for k in range(n):
            if k != c[ax]:
                src = _peer(c, ax, k)
                msgs.append(((c, k), src, c,
                             lambda src=src: shards[src].contiguous()))
    got = transfer(mesh, msgs, _like(shards))
    return {c: [x if k == c[ax] else got[(c, k)] for k in range(n)]
            for c, x in shards.items()}


def psum(shards: dict, mesh, axis: str) -> dict:
    """``lax.psum`` over ``axis``: every shard gets the sum of its
    group, added in shard-index order."""
    out = {}
    for c, parts in _gather_group(shards, mesh, axis).items():
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        out[c] = acc
    return out


def pmax(shards: dict, mesh, axis: str) -> dict:
    """``lax.pmax`` over ``axis``."""
    out = {}
    for c, parts in _gather_group(shards, mesh, axis).items():
        acc = parts[0]
        for p in parts[1:]:
            acc = torch.maximum(acc, p)
        out[c] = acc
    return out


def all_gather(shards: dict, mesh, axis: str, dim: int) -> dict:
    """``lax.all_gather(..., tiled=True)``: the group's shards
    concatenated along ``dim`` in shard-index order."""
    return {c: torch.cat(parts, dim=dim)
            for c, parts in _gather_group(shards, mesh, axis).items()}


def all_to_all(shards: dict, mesh, axis: str) -> dict:
    """``lax.all_to_all(x, axis, 0, 0, tiled=False)``: each shard's
    leading dimension (the axis size) is split, chunk ``i`` sent to
    shard ``i``; shard ``i`` stacks the chunks it receives by source
    index."""
    ax = mesh.axis(axis)
    n = mesh.shape[axis]
    like = _like(shards)
    if like.shape[0] != n:
        raise ValueError(f"all_to_all: leading dim {like.shape[0]} is not "
                         f"the {axis!r} size {n}")
    msgs = []
    for c in mesh.coords:
        for j in range(n):
            src = _peer(c, ax, j)
            msgs.append(((c, j), src, c,
                         lambda src=src, i=c[ax]: shards[src][i].contiguous()))
    got = transfer(mesh, msgs, like[0])
    return {c: torch.stack([got[(c, j)] for j in range(n)])
            for c in shards}
