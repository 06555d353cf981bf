"""Halo exchange for overlap-save sequence parallelism.

Port of ``radiosonde_auto_rx_tpu/parallel/halo.py``.  Each time shard
holds a contiguous ``[..., T_local]`` slice of the stream; convolution
and window continuity need ``halo`` trailing samples of the previous
shard prepended.  One ``ppermute`` moves every halo one hop along the
axis — a single neighbor transfer, no all-gather.  The reference sends
around the whole ring and zeroes the wrapped halo; here the end shard
sends none, and ``ppermute`` gives the shard no pair names zeros.
"""

import torch

from radiosonde_auto_rx_tpu_torch.parallel.collectives import ppermute


def halo_exchange_left(shards: dict, mesh, halo: int, axis: str) -> dict:
    """Prepend each shard with the last ``halo`` samples of its left
    neighbor along ``axis`` (zeros for shard 0, matching zero-initial
    filter state).

    shards: {coord: [..., T_local]} -> {coord: [..., halo + T_local]}
    """
    if halo == 0:
        return shards       # x[..., -0:] would be the WHOLE shard
    n = mesh.shape[axis]
    tails = {c: x[..., -halo:] for c, x in shards.items()}
    recv = ppermute(tails, mesh, axis, [(i, i + 1) for i in range(n - 1)])
    return {c: torch.cat([recv[c], x], dim=-1) for c, x in shards.items()}


def halo_exchange_right(shards: dict, mesh, halo: int, axis: str) -> dict:
    """Append the first ``halo`` samples of the right neighbor (zeros
    for the last shard).

    shards: {coord: [..., T_local]} -> {coord: [..., T_local + halo]}
    """
    if halo == 0:
        return shards
    n = mesh.shape[axis]
    heads = {c: x[..., :halo] for c, x in shards.items()}
    recv = ppermute(heads, mesh, axis, [(i + 1, i) for i in range(n - 1)])
    return {c: torch.cat([x, recv[c]], dim=-1) for c, x in shards.items()}
