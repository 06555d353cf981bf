"""GPSD client for mobile station position.

Mirrors reference auto_rx/autorx/gpsd.py GPSDAdaptor (:294-430): connects
to gpsd's JSON protocol, watches TPV reports, and calls back with
{latitude, longitude, altitude, speed, valid} dicts.
"""

import json
import socket
import threading
import time


class GPSDAdaptor:
    def __init__(self, hostname="localhost", port=2947, callback=None,
                 start_thread=True):
        self.hostname = hostname
        self.port = port
        self.callback = callback
        self.running = False
        self._thread = None
        if start_thread:
            self.start()

    def start(self):
        self.running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while self.running:
            try:
                with socket.create_connection(
                        (self.hostname, self.port), timeout=10) as s:
                    s.sendall(b'?WATCH={"enable":true,"json":true};\n')
                    buf = b""
                    s.settimeout(5)
                    while self.running:
                        try:
                            data = s.recv(4096)
                        except socket.timeout:
                            continue
                        if not data:
                            break
                        buf += data
                        while b"\n" in buf:
                            line, buf = buf.split(b"\n", 1)
                            self.handle_report(line)
            except OSError:
                time.sleep(5)

    def handle_report(self, line: bytes):
        try:
            rep = json.loads(line)
        except json.JSONDecodeError:
            return
        if rep.get("class") != "TPV":
            return
        pos = {
            "valid": rep.get("mode", 0) >= 3 and "lat" in rep,
            "latitude": rep.get("lat", 0.0),
            "longitude": rep.get("lon", 0.0),
            "altitude": rep.get("alt", 0.0),
            "speed": rep.get("speed", 0.0),
        }
        if self.callback and pos["valid"]:
            self.callback(pos)

    def close(self):
        self.running = False
        if self._thread:
            self._thread.join(timeout=2)
