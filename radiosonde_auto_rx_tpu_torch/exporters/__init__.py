"""Telemetry exporters — the reference's uniform sink protocol.

Every exporter implements ``.add(telemetry_dict)`` and ``.close()``,
optionally ``.update_station_position(lat, lon, alt)`` — the contract the
reference wires at auto_rx/auto_rx.py:948-1104.  Network exporters queue
internally and never block the signal path.
"""

from radiosonde_auto_rx_tpu_torch.exporters.logfile import TelemetryLogger
from radiosonde_auto_rx_tpu_torch.exporters.ozimux import OziUploader
from radiosonde_auto_rx_tpu_torch.exporters.aprs import APRSUploader, \
    telemetry_to_aprs_position
from radiosonde_auto_rx_tpu_torch.exporters.sondehub import SondehubUploader
from radiosonde_auto_rx_tpu_torch.exporters.rotator import Rotator
from radiosonde_auto_rx_tpu_torch.exporters.email_notification import \
    EmailNotification
