"""OziMux / Payload-Summary UDP exporter.

Sentence and JSON formats match the reference (reference
auto_rx/autorx/ozimux.py:85-210): "TELEMETRY,HH:MM:SS,lat,lon,alt\\n" UDP
sentences plus a PAYLOAD_SUMMARY JSON broadcast.
"""

import json
import socket


class OziUploader:
    EXTRA_FIELDS = ["bt", "humidity", "pressure", "sats", "batt", "snr",
                    "fest", "f_centre", "ppm", "subtype"]

    def __init__(self, ozimux_port=None, payload_summary_port=None,
                 update_rate=5, station="radiosonde_auto_rx_tpu_torch",
                 ozimux_host="<broadcast>", payload_summary_host=None):
        self.ozimux_port = ozimux_port
        self.payload_summary_port = payload_summary_port
        self.ozimux_host = ozimux_host
        # chasemapper may live on a different machine than OziMux
        # (reference config keys ozi_hostname vs payload_summary_hostname)
        self.payload_summary_host = payload_summary_host or ozimux_host
        self.station = station

    @staticmethod
    def make_sentence(telemetry):
        short_time = telemetry["datetime_dt"].strftime("%H:%M:%S")
        return "TELEMETRY,%s,%.5f,%.5f,%d\n" % (
            short_time, telemetry["lat"], telemetry["lon"],
            telemetry["alt"])

    def make_payload_summary(self, telemetry):
        packet = {
            "type": "PAYLOAD_SUMMARY",
            "station": self.station,
            "callsign": telemetry["id"],
            "latitude": telemetry["lat"],
            "longitude": telemetry["lon"],
            "altitude": telemetry["alt"],
            "speed": telemetry.get("vel_h", -1 / 3.6) * 3.6,
            "heading": telemetry.get("heading", -1),
            "time": telemetry["datetime_dt"].strftime("%H:%M:%S"),
            "comment": "Radiosonde",
            "model": telemetry["type"],
            "freq": telemetry.get("freq", ""),
            "temp": telemetry.get("temp", -273.0),
            "frame": telemetry["frame"],
        }
        for f in self.EXTRA_FIELDS:
            if f in telemetry:
                packet[f] = telemetry[f]
        return packet

    def _send_udp(self, data: bytes, port: int, host=None):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.sendto(data, (host or self.ozimux_host, port))
        except OSError:
            try:
                s.sendto(data, ("127.0.0.1", port))
            except OSError:
                pass
        s.close()

    def add(self, telemetry: dict):
        if self.ozimux_port:
            self._send_udp(self.make_sentence(telemetry).encode("ascii"),
                           self.ozimux_port)
        if self.payload_summary_port:
            self._send_udp(
                json.dumps(self.make_payload_summary(telemetry)
                           ).encode("ascii"),
                self.payload_summary_port,
                host=self.payload_summary_host)

    def close(self):
        pass
