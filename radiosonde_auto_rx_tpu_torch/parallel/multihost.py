"""Multi-process initialization and the global mesh.

Port of ``radiosonde_auto_rx_tpu/parallel/multihost.py``.  Scale-out
is one process per host (or per GPU), ``torch.distributed`` between
them, and one global mesh whose ``ch`` axis spans processes — channel
batches are data-parallel, so cross-process traffic is only the
collectives the sharded program asks for (``parallel/collectives.py``).

Typical use in each process::

    from radiosonde_auto_rx_tpu_torch.parallel import multihost
    multihost.initialize("tcp://host:port", num_processes=2, process_id=r)
    mesh = multihost.global_mesh(n_t=2)     # (ch, t) over ALL devices
    step = make_station_step(cfg, mesh, ...)

The backend is NCCL between CUDA devices and gloo between CPU ones.
Telemetry fan-in stays per process: each runs its own exporters for the
channels it feeds.
"""

import logging
import os

import torch

from radiosonde_auto_rx_tpu_torch.parallel.mesh import make_mesh

log = logging.getLogger("multihost")

_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def process_count() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device: str = "cuda"):
    """``torch.distributed.init_process_group`` for a mesh of ``device``
    shards: backend ``nccl`` for CUDA, ``gloo`` for the CPU.

    ``coordinator_address``: an init method (``tcp://host:port``,
    ``file:///path``; a bare ``host:port`` means tcp) with
    ``num_processes`` and ``process_id``; a failure raises.  Without
    one, torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK) is used where it is set; where it is not, the process logs and
    stays single-process.  A no-op when already initialized."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if coordinator_address is not None:
        init = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=init,
                                world_size=int(num_processes),
                                rank=int(process_id))
    elif all(k in os.environ for k in _TORCHRUN_ENV):
        dist.init_process_group(backend, init_method="env://")
    else:
        log.warning("multihost: running single-process (no coordinator "
                    "and no torchrun environment)")
        return
    if backend == "nccl":
        # NCCL's transfers run on the current device: torchrun's local
        # rank, else one GPU a process in rank order
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
    log.info("distributed: process %d/%d (%s)", dist.get_rank(),
             dist.get_world_size(), backend)


def global_mesh(n_t: int = 1, local_devices=None):
    """(ch, t) mesh over every device of every process: each process
    contributes the same number of local devices (default: its visible
    CUDA devices), in rank order; the ``ch`` axis spans processes.  Keep
    ``n_t`` within one process's devices so halo transfers stay local."""
    if local_devices is None:
        local_devices = [torch.device("cuda", i)
                         for i in range(torch.cuda.device_count())]
    local_devices = list(local_devices)
    n = process_count()
    if n > 1:
        import torch.distributed as dist
        counts = [None] * n
        dist.all_gather_object(counts, len(local_devices))
        if len(set(counts)) != 1:
            raise ValueError(f"processes contribute {counts} devices; the "
                             f"global mesh needs the same count from each")
    k = len(local_devices)
    # another process's devices are named as this one's: only the owner
    # ever touches a device, by its rank
    devices = [local_devices[i % k] for i in range(n * k)]
    ranks = [i // k for i in range(n * k)]
    return make_mesh(n_t=n_t, devices=devices, ranks=ranks)


def local_channel_slice(n_channels: int):
    """Which global channels this process feeds: the contiguous block
    matching its position on the mesh's ch axis."""
    n, me = process_count(), process_index()
    per = n_channels // n
    lo = me * per
    hi = lo + per if me < n - 1 else n_channels
    return lo, hi
