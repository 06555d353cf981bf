"""Device mesh and shard layout.

Port of ``radiosonde_auto_rx_tpu/parallel/mesh.py``.  Axis names:
  ``ch`` — channel data parallelism (leading axis of [C, T] IQ tensors)
  ``t``  — time/sequence parallelism (trailing axis, overlap-save halos)

A ``Mesh`` is an array of shards, each a ``torch.device`` owned by one
process (its ``torch.distributed`` rank; 0 without a process group).
The same device may back several shards: a virtual mesh, the port's
counterpart of the forced host device count the reference's tests use,
and the way a one-GPU host runs the sharded code.

A sharded tensor is a dict of this process's shards, coordinate ->
tensor on that shard's device, laid out by a spec: per leading tensor
dimension a mesh axis name (split over that axis) or None (whole), as a
``PartitionSpec``; a mesh axis the spec does not name replicates the
tensor over it.  ``shard`` splits a tensor into local shards,
``unshard`` assembles one when every shard is local.
"""

import itertools

import numpy as np
import torch

CH_AXIS = "ch"
T_AXIS = "t"


def process_rank() -> int:
    """This process's rank in the ``torch.distributed`` group (0
    without one)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


class Mesh:
    """``devices`` and ``ranks``: arrays of one shape, a ``torch.device``
    and its owning process rank per coordinate; ``axis_names`` name the
    array's axes."""

    def __init__(self, devices, axis_names, ranks=None):
        given = np.asarray(devices, object)
        self.devices = np.empty(given.shape, object)
        for c in itertools.product(*map(range, given.shape)):
            self.devices[c] = torch.device(given[c])
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes "
                             f"{self.axis_names}")
        self.ranks = np.zeros(self.devices.shape, np.int64) if ranks is None \
            else np.asarray(ranks, np.int64).reshape(self.devices.shape)
        self.process = process_rank()
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.size = int(self.devices.size)
        self.coords = list(itertools.product(*map(range,
                                                  self.devices.shape)))
        self.local = [c for c in self.coords if self.rank(c) == self.process]

    def device(self, coord) -> torch.device:
        return self.devices[tuple(coord)]

    def rank(self, coord) -> int:
        return int(self.ranks[tuple(coord)])

    def axis(self, name: str) -> int:
        return self.axis_names.index(name)

    @property
    def all_local(self) -> bool:
        return len(self.local) == self.size

    def __repr__(self):
        devices = sorted(set(map(str, self.devices.flat)))
        return f"Mesh({self.shape}, {devices})"


def make_mesh(n_ch: int | None = None, n_t: int = 1, devices=None,
              ranks=None) -> Mesh:
    """Build a ``(ch, t)`` mesh over ``devices`` (default: every visible
    CUDA device; a list may repeat a device, a virtual mesh).  ``ranks``:
    each device's owning process (default: this process).

    If ``n_ch`` is None it absorbs all devices not used by ``n_t``."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if n_ch is None:
        if n_t < 1 or n % n_t:
            raise ValueError(f"{n} devices not divisible by n_t={n_t}")
        n_ch = n // n_t
    if n_ch < 1 or n_ch * n_t > n:
        raise ValueError(f"mesh {n_ch}x{n_t} needs more than {n} devices")
    k = n_ch * n_t
    if ranks is None:
        ranks = [process_rank()] * n
    dev = np.empty(k, object)
    dev[:] = devices[:k]
    return Mesh(dev.reshape(n_ch, n_t), (CH_AXIS, T_AXIS),
                np.asarray(list(ranks)[:k]).reshape(n_ch, n_t))


def channel_sharding(mesh: Mesh):
    """[C, ...] tensors: shard channels, replicate the rest; (mesh,
    spec) for ``shard``."""
    return mesh, (CH_AXIS,)


def stream_sharding(mesh: Mesh):
    """[C, T] IQ streams: channels over ``ch``, time over ``t``."""
    return mesh, (CH_AXIS, T_AXIS)


def _index(shape, mesh: Mesh, spec, coord):
    """The slices of a global ``shape`` that shard ``coord`` holds."""
    out = []
    for d, n in enumerate(shape):
        ax = spec[d] if d < len(spec) else None
        if ax is None:
            out.append(slice(None))
            continue
        k = mesh.shape[ax]
        if n % k:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"split over {k} {ax!r} shards")
        i = coord[mesh.axis(ax)]
        out.append(slice(i * (n // k), (i + 1) * (n // k)))
    return tuple(out)


def to_device(x, device) -> torch.Tensor:
    """A host array (or CPU tensor) on ``device``; onto a CUDA device
    through pinned memory, so that the host does not wait for the
    device's queue (a plain copy from pageable memory synchronizes)."""
    t = torch.as_tensor(x)
    device = torch.device(device)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.contiguous().pin_memory().to(device, non_blocking=True)


def shard(x, mesh: Mesh, spec) -> dict:
    """Split a host array or tensor into this process's shards: {coord:
    contiguous tensor on the shard's device}."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return {c: to_device(x[_index(x.shape, mesh, spec, c)].contiguous(),
                         mesh.device(c)) for c in mesh.local}


def _global_shape(shards: dict, mesh: Mesh, spec) -> tuple:
    shape = list(next(iter(shards.values())).shape)
    for d, ax in enumerate(spec):
        if ax is not None:
            shape[d] *= mesh.shape[ax]
    return tuple(shape)


def unshard(shards: dict, mesh: Mesh, spec, device=None) -> torch.Tensor:
    """Assemble a sharded tensor (every shard local) on ``device``
    (default: the first shard's); a replicated axis reads index 0."""
    if not mesh.all_local:
        raise ValueError("unshard needs every shard in this process")
    named = {mesh.axis(a) for a in spec if a is not None}
    first = shards[mesh.coords[0]]
    out = torch.empty(_global_shape(shards, mesh, spec), dtype=first.dtype,
                      device=first.device if device is None else device)
    for c in mesh.coords:
        if any(c[a] for a in range(len(c)) if a not in named):
            continue
        out[_index(out.shape, mesh, spec, c)] = shards[c].to(out.device)
    return out


def gather_rows(shards: dict, mesh: Mesh, rows, device) -> torch.Tensor:
    """Rows ``rows`` (global indices along dim 0) of a tensor sharded
    ``(ch, None, ..., t)`` — rows over ``ch``, the last dim over ``t`` —
    as one [len(rows), ..., T] tensor on ``device``: only those rows
    move."""
    if not mesh.all_local:
        raise ValueError("gather_rows needs every shard in this process")
    c_l = next(iter(shards.values())).shape[0]
    out = []
    for r in rows:
        i, j = divmod(int(r), c_l)
        out.append(torch.cat([shards[(i, k)][j].to(device)
                              for k in range(mesh.shape[T_AXIS])], dim=-1))
    return torch.stack(out)


def scatter_rows(shards: dict, rows, values) -> dict:
    """A copy of a ``(ch, None, ..., t)``-sharded tensor with global rows
    ``rows`` replaced by ``values`` [len(rows), ..., T] (any device); the
    shards holding none of the rows are the same tensors."""
    c_l = next(iter(shards.values())).shape[0]
    out = dict(shards)
    for c in shards:
        mine = [(k, int(r) % c_l) for k, r in enumerate(rows)
                if int(r) // c_l == c[0]]
        if not mine:
            continue
        x = shards[c]
        t_l = x.shape[-1]
        k_idx = to_device([k for k, _ in mine], values.device)
        v = values.index_select(0, k_idx)[..., c[1] * t_l:(c[1] + 1) * t_l]
        out[c] = x.index_copy(0, to_device([j for _, j in mine], x.device),
                              v.to(x.device, x.dtype))
    return out
