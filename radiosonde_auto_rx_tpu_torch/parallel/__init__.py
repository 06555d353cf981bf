"""Mesh construction, shardings, collectives and halo exchange.

Port of ``radiosonde_auto_rx_tpu/parallel``.  The scaling axes are a
``Mesh`` (``parallel/mesh.py``):

* axis ``ch`` — channel data parallelism: the leading ``[C]`` axis of
  every IQ/soft-bit tensor is sharded over devices.  Channels are
  independent, so this axis needs no collectives but the expert
  all-to-all (``parallel/routing.py``).
* axis ``t`` — sequence (time) parallelism: long IQ streams are split
  into contiguous time shards.  Convolution/window continuity across the
  cut is restored by exchanging a left *halo* with the neighbor shard
  (``parallel/halo.py``).

Nothing assumes a device count: the same code runs on one GPU, a
virtual mesh (one device backing several shards), several GPUs, or
several processes over ``torch.distributed`` (``parallel/multihost.py``).
"""

from radiosonde_auto_rx_tpu_torch.parallel.mesh import (
    make_mesh,
    channel_sharding,
    stream_sharding,
    shard,
    unshard,
)
from radiosonde_auto_rx_tpu_torch.parallel.halo import (
    halo_exchange_left,
    halo_exchange_right,
)
from radiosonde_auto_rx_tpu_torch.parallel.pipeline import (
    sharded_fir_filter,
    sharded_fsk_demod,
    make_station_step,
)
