"""Host-side control plane: config, telemetry filtering, the station loop.

The reference's task manager (reference auto_rx/auto_rx.py main loop
:760-1159) owns SDRs and spawns one OS task per frequency.  Here the unit
of work is a *channel batch*: one wideband capture is channelized on
device, scanned and demodulated as a batch, and the control plane only
routes the resulting frames — no subprocess management, no SDR pooling.

``Station`` is loaded on first use: the frame decoders import
``station.gps_ephem`` in the frame-plane workers, which must not load
torch through this package.
"""

from radiosonde_auto_rx_tpu_torch.station.config import (
    default_config, read_auto_rx_config)
from radiosonde_auto_rx_tpu_torch.station.telemetry import (
    telemetry_filter, enrich_telemetry)


def __getattr__(name):
    if name == "Station":
        from radiosonde_auto_rx_tpu_torch.station.station import Station
        return Station
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
