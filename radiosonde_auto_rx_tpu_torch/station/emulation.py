"""Telemetry replay for integration testing.

Mirrors reference auto_rx/autorx/emulation.py (:32,105): replay a recorded
per-sonde CSV log through the exporter chain at real-time or accelerated
speed, without any signal processing.
"""

import logging
import time

from dateutil.parser import parse

from radiosonde_auto_rx_tpu_torch.web.log_files import read_log_file

log = logging.getLogger(__name__)


def replay_log_file(filename, exporters, speed: float = 0.0,
                    limit: int | None = None):
    """Replay a CSV log through ``exporters``.

    speed=0 replays as fast as possible; speed=1 in real time."""
    data = read_log_file(filename)
    n = len(data["lat"]) if limit is None else min(limit, len(data["lat"]))
    prev_dt = None
    for i in range(n):
        dt = parse(data["time"][i])
        telemetry = {
            "type": data["type"], "id": data["serial"],
            "frame": i, "datetime": data["time"][i], "datetime_dt": dt,
            "lat": data["lat"][i], "lon": data["lon"][i],
            "alt": data["alt"][i], "vel_v": data["vel_v"][i],
            "vel_h": data["vel_h"][i], "heading": data["heading"][i],
            "temp": data["temp"][i], "humidity": data["humidity"][i],
            "pressure": data["pressure"][i],
        }
        if prev_dt is not None and speed > 0:
            time.sleep(max(0.0, (dt - prev_dt).total_seconds() / speed))
        prev_dt = dt
        for e in exporters:
            e.add(telemetry)
        log.info("replay %s frame %d: %.5f, %.5f, %.1f m",
                 telemetry["id"], i, telemetry["lat"], telemetry["lon"],
                 telemetry["alt"])
    return n
