"""Expert-parallel decoder routing: channels -> per-type decoder shards.

Port of ``radiosonde_auto_rx_tpu/parallel/routing.py``.  Each sonde
type's demod chain is an "expert" owned by a ``ch`` shard, and detected
channels move to their expert with one capacity-padded ``all_to_all``
— the MoE dispatch pattern applied to radio channels.

Shapes are static: every (source shard -> expert) pair carries a fixed
``capacity`` of channel slots; unused slots are masked.  Overflow
channels are dropped and counted (the reference's analogue: more
detections than available SDRs are simply not decoded).

``compact_by_type`` is the compaction primitive (stable argsort, on the
device, no host sync); the station's host grouping
(``Station.group_tasks_by_type``) gives the same slot order.
"""

import torch

from radiosonde_auto_rx_tpu_torch.parallel.collectives import all_to_all
from radiosonde_auto_rx_tpu_torch.parallel.mesh import (
    CH_AXIS, shard, unshard)


def compact_by_type(type_ids, n_types: int, capacity: int):
    """Group channel indices by type id (-1 = no detection).

    type_ids: [C] int tensor.  Returns (slots [n_types, capacity] int32
    channel indices (-1 pad), counts [n_types], dropped [n_types])."""
    dev = type_ids.device
    type_ids = type_ids.to(torch.int64)
    order = torch.argsort(type_ids, stable=True)            # -1s first
    sorted_ids = type_ids[order]
    # rank of each channel within its type group
    same = sorted_ids[:, None] == torch.arange(n_types, device=dev)[None]
    rank = torch.cumsum(same.to(torch.int64), dim=0) - 1    # [C, K]
    rank = torch.where(same, rank, 0).sum(dim=1)            # [C]
    counts = same.sum(dim=0)                                # [K]
    # scatter into an extra dump row so invalid entries never collide
    # with a real slot
    slots = torch.full((n_types + 1, capacity), -1, dtype=torch.int32,
                       device=dev)
    valid = (sorted_ids >= 0) & (rank < capacity)
    slots.index_put_(
        (torch.where(valid, sorted_ids, n_types),
         torch.where(valid, rank % capacity, 0)),
        torch.where(valid, order, -1).to(torch.int32))
    dropped = torch.clamp(counts - capacity, min=0)
    return slots[:n_types], torch.clamp(counts, max=capacity), dropped


def gather_type_batch(x, slots_k):
    """Gather one expert's channels: x [C, ...], slots_k [capacity] ->
    (batch [capacity, ...], mask [capacity])."""
    mask = slots_k >= 0
    idx = torch.clamp(slots_k, 0, x.shape[0] - 1).to(torch.int64)
    batch = x.index_select(0, idx)
    m = mask.reshape((-1,) + (1,) * (batch.dim() - 1))
    return torch.where(m, batch, torch.zeros_like(batch)), mask


def dispatch_to_experts(xl: dict, tl: dict, mesh, n_experts: int,
                        capacity: int, channel_ids: dict | None = None):
    """Expert dispatch over the ``ch`` axis, on local shards.

    xl: {coord: local payload [C_l, ...]}; tl: {coord: local type ids
    [C_l]} (-1 = none).  Packs up to ``capacity`` channels per (source
    shard, expert), ships them with one ``all_to_all`` over ``ch``, and
    returns per shard
      (recv [e_local, n_src*capacity, ...], mask [e_local, n_src*cap],
       ids [e_local, n_src*cap] or None, dropped [1])
    where expert ``e`` lands on shard ``e // e_local`` at local slot
    ``e % e_local``.  ``channel_ids`` ({coord: [C_l]}) rides along so the
    host can map routed slots back to global channels."""
    n_sh = mesh.shape[CH_AXIS]
    if n_experts % n_sh:
        raise ValueError(f"n_experts {n_experts} must be a multiple of ch "
                         f"shards {n_sh}")
    e_local = n_experts // n_sh
    S_tot = n_sh * capacity
    send, send_m, send_i, dropped = {}, {}, {}, {}
    for c, x in xl.items():
        C_l = x.shape[0]
        slots, _, drop = compact_by_type(tl[c], n_experts, capacity)
        # every expert's batch in one gather: [n_experts * capacity, ...]
        b, m = gather_type_batch(x, slots.reshape(-1))
        feat = tuple(x.shape[1:])
        send[c] = b.reshape((n_sh, e_local, capacity) + feat)
        send_m[c] = m.reshape(n_sh, e_local, capacity)
        if channel_ids is not None:
            idx = torch.clamp(slots, 0, C_l - 1).to(torch.int64)
            send_i[c] = torch.where(slots >= 0, channel_ids[c][idx],
                                    -1).reshape(n_sh, e_local, capacity)
        dropped[c] = drop.sum()[None]
    # all-to-all: swap the leading dst axis with the shard axis, then
    # expert-major with the slots flat
    recv = all_to_all(send, mesh, CH_AXIS)
    recv_m = all_to_all(send_m, mesh, CH_AXIS)
    recv_i = all_to_all(send_i, mesh, CH_AXIS) if channel_ids is not None \
        else None
    out = {}
    for c, r in recv.items():
        feat = tuple(r.shape[3:])
        out[c] = (r.transpose(0, 1).reshape((e_local, S_tot) + feat),
                  recv_m[c].transpose(0, 1).reshape(e_local, S_tot),
                  None if recv_i is None else
                  recv_i[c].transpose(0, 1).reshape(e_local, S_tot),
                  dropped[c])
    return out


def route_to_experts(mesh, x, type_ids, n_experts: int, capacity: int):
    """All-to-all channel dispatch over the ``ch`` mesh axis, on global
    tensors (every shard in this process).

    x: [C, F, T...]; type_ids: [C].  Expert e = type id e, owned by
    ch-shard ``e // e_local``.  Returns (recv [n_experts, n_src *
    capacity, F, T...], recv_mask, dropped [n_ch]) assembled from the
    shards, as the reference's global arrays sharded P(ch)."""
    spec = (CH_AXIS,)
    xl = shard(x, mesh, spec)
    tl = shard(torch.as_tensor(type_ids), mesh, spec)
    res = dispatch_to_experts(xl, tl, mesh, n_experts, capacity)
    return tuple(unshard({c: r[k] for c, r in res.items()}, mesh, spec)
                 for k in (0, 1, 3))

