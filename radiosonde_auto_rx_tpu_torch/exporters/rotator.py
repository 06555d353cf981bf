"""Antenna rotator exporter: rotctld (hamlib) TCP protocol.

Protocol (`p` query / `P az el` set) and the movement-threshold + homing
update loop mirror the reference (reference auto_rx/autorx/rotator.py:
rotctld commands :18-115, update thread :278-347).
"""

import socket
import threading
import time

from radiosonde_auto_rx_tpu_torch.utils.geometry import position_info


class ROTCTLD:
    """Minimal rotctld client."""

    def __init__(self, hostname, port=4533, timeout=5):
        self.hostname = hostname
        self.port = port
        self.timeout = timeout
        self.sock = None

    def connect(self):
        self.sock = socket.create_connection(
            (self.hostname, self.port), timeout=self.timeout)
        model = self.get_model()
        return model is not None

    def send_command(self, command: str):
        if self.sock is None:
            return None
        try:
            self.sock.sendall((command + "\n").encode())
            return self.sock.recv(1024).decode().strip()
        except OSError:
            # drop the session so the update loop reconnects
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None
            return None

    def get_model(self):
        return self.send_command("_")

    def set_azel(self, azimuth: float, elevation: float):
        resp = self.send_command("P %3.1f %2.1f" % (azimuth, elevation))
        return resp is not None and resp.startswith("RPRT 0")

    def get_azel(self):
        resp = self.send_command("p")
        if resp is None:
            return None
        try:
            az, el = resp.split("\n")[:2]
            return float(az), float(el)
        except (ValueError, IndexError):
            return None

    def close(self):
        if self.sock:
            self.sock.close()
            self.sock = None


class Rotator:
    """Track the latest telemetry with an az/el rotator."""

    def __init__(self, station_position=(0.0, 0.0, 0.0),
                 rotctld_host="localhost", rotctld_port=4533,
                 rotator_update_rate=30, rotator_update_threshold=5.0,
                 rotator_homing_enabled=False, rotator_homing_delay=10,
                 rotator_home_position=(0.0, 0.0), start_thread=False):
        self.station_position = station_position
        self.update_rate = rotator_update_rate
        self.update_threshold = rotator_update_threshold
        self.homing_enabled = rotator_homing_enabled
        self.homing_delay = rotator_homing_delay * 60
        self.home_position = rotator_home_position
        self.rot = ROTCTLD(rotctld_host, rotctld_port)
        self.latest = None
        self.latest_time = 0.0
        self.running = False
        self._thread = None
        if start_thread:
            self.running = True
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def add(self, telemetry: dict):
        self.latest = telemetry.copy()
        self.latest_time = time.time()

    def target_azel(self, telemetry):
        info = position_info(
            self.station_position,
            (telemetry["lat"], telemetry["lon"], telemetry["alt"]))
        return info["bearing"], max(0.0, info["elevation"])

    def _loop(self):
        while self.running:
            time.sleep(self.update_rate)
            try:
                if self.rot.sock is None:
                    # (re)connect lazily each cycle: rotctld may start
                    # after the station, and a dropped TCP session must
                    # not silently no-op every subsequent command
                    # (reference connects in its update thread,
                    # rotator.py:278-289)
                    try:
                        if not self.rot.connect():
                            self.rot.close()
                            continue
                    except OSError:
                        continue
                if self.latest and \
                        time.time() - self.latest_time < self.homing_delay:
                    az, el = self.target_azel(self.latest)
                    cur = self.rot.get_azel()
                    if cur is None or \
                            abs(cur[0] - az) > self.update_threshold or \
                            abs(cur[1] - el) > self.update_threshold:
                        self.rot.set_azel(az, el)
                elif self.homing_enabled:
                    self.rot.set_azel(*self.home_position)
            except OSError:
                pass

    def update_station_position(self, lat, lon, alt):
        self.station_position = (lat, lon, alt)

    def close(self):
        self.running = False
        if self._thread:
            self._thread.join(timeout=2)
        self.rot.close()
