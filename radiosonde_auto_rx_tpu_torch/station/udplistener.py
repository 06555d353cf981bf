"""UDP pseudo-decoder: accept telemetry JSON over UDP.

Mirrors reference auto_rx/autorx/udplistener.py (:14): external decoders
can inject telemetry dicts (one JSON object per datagram) which flow
through the same enrich/filter/export pipeline as native frames.  Used for
integration testing and for decoders not yet ported.
"""

import json
import socket
import threading


class UDPListener:
    def __init__(self, port=55673, callback=None, start_thread=True):
        self.port = port
        self.callback = callback
        self.running = False
        self._thread = None
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.settimeout(0.5)
        self.sock.bind(("0.0.0.0", port))
        if start_thread:
            self.running = True
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def _loop(self):
        while self.running:
            try:
                data, _ = self.sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                telemetry = json.loads(data)
            except json.JSONDecodeError:
                continue
            if self.callback:
                self.callback(telemetry)

    def close(self):
        self.running = False
        if self._thread:
            self._thread.join(timeout=2)
        self.sock.close()
