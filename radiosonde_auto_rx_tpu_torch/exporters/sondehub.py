"""SondeHub exporter: universal-schema reformat + batched gzip upload.

The reformat rules (per-type manufacturer/serial mapping) mirror the
reference (reference auto_rx/autorx/sondehub.py reformat_data :113-360);
uploads are batched, gzip-compressed PUTs every ``upload_rate`` seconds
(:362-504), with the DFM slower-upload z-check workaround (:182-196) and
periodic station position upload (:504).
"""

import datetime
import gzip
import json
import queue
import threading
import time

SONDEHUB_URL = "https://api.v2.sondehub.org/sondes/telemetry"
SONDEHUB_STATION_URL = "https://api.v2.sondehub.org/listeners"
SOFTWARE_NAME = "radiosonde_auto_rx_tpu_torch"


def reformat_data(telemetry, user_callsign="N0CALL", user_position=None,
                  user_antenna="", version="0.1.0"):
    """Telemetry dict -> SondeHub universal format (or None to drop)."""
    out = {
        "software_name": SOFTWARE_NAME,
        "software_version": version,
        "uploader_callsign": user_callsign,
        "uploader_position": user_position,
        "uploader_antenna": user_antenna,
        "time_received": datetime.datetime.now(datetime.timezone.utc
                                               ).strftime("%Y-%m-%dT%H:%M:%S.%fZ"),
    }
    if telemetry.get("encrypted"):
        return None
    try:
        out["datetime"] = telemetry["datetime_dt"].strftime(
            "%Y-%m-%dT%H:%M:%S.%fZ")
    except (KeyError, AttributeError):
        return None

    t = telemetry["type"]
    slower = False
    if t.startswith("RS41"):
        out.update(manufacturer="Vaisala", type="RS41",
                   serial=telemetry["id"])
    elif t.startswith("RS92"):
        out.update(manufacturer="Vaisala", type="RS92",
                   serial=telemetry["id"])
    elif t in ("RD94", "RD41"):
        out.update(manufacturer="Vaisala", type=t, serial=telemetry["id"])
    elif t.startswith("DFM"):
        out.update(manufacturer="Graw", type="DFM", subtype=t,
                   serial=telemetry["id"].split("-")[1])
        slower = True
    elif t == "PS15":
        out.update(manufacturer="Graw", type="PS-15", subtype="PS-15",
                   serial=telemetry["id"].split("-")[1])
        slower = True
    elif t.startswith("M10") or t.startswith("M20"):
        out.update(manufacturer="Meteomodem", type=t,
                   serial=telemetry["id"][4:])
    elif t == "LMS6" or t == "LMS":
        out.update(manufacturer="Lockheed Martin", type="LMS6-403",
                   serial=telemetry["id"].split("-")[1])
    elif t == "MK2LMS":
        out.update(manufacturer="Lockheed Martin", type="LMS6-1680",
                   serial=telemetry["id"].split("-")[1])
    elif t == "IMET":
        out.update(manufacturer="Intermet Systems",
                   type=telemetry.get("subtype", "iMet-4"),
                   serial=telemetry["id"].split("-")[1])
    elif t == "IMET5":
        out.update(manufacturer="Intermet Systems",
                   type=telemetry.get("subtype", "iMet-54"),
                   serial=telemetry["id"].split("-")[1])
    elif t == "MEISEI":
        out.update(manufacturer="Meisei",
                   type=telemetry.get("subtype", "IMS100"),
                   serial=telemetry["id"].split("-")[1])
    elif t == "MRZ":
        out.update(manufacturer="Meteo-Radiy", type="MRZ",
                   serial=telemetry["id"][4:])
    elif t == "MTS01":
        out.update(manufacturer="Meteosis", type="MTS01",
                   serial=telemetry["id"].split("-")[1])
    elif t.startswith("WXR"):
        out.update(manufacturer="Weathex", type="WxR-301D",
                   serial=telemetry["id"].split("-")[1])
    else:
        return None

    if "subtype" in telemetry and "subtype" not in out:
        out["subtype"] = telemetry["subtype"]

    out["frame"] = telemetry["frame"]
    out["lat"] = telemetry["lat"]
    out["lon"] = telemetry["lon"]
    out["alt"] = telemetry["alt"]

    for src, dst in (("temp", "temp"), ("humidity", "humidity"),
                     ("pressure", "pressure"), ("vel_v", "vel_v"),
                     ("vel_h", "vel_h"), ("heading", "heading"),
                     ("sats", "sats"), ("batt", "batt"),
                     ("freq_float", "frequency"), ("snr", "snr"),
                     ("f_error", "frequency_error"), ("bt", "burst_timer"),
                     ("aux", "xdata"), ("tx_frequency", "tx_frequency")):
        if src in telemetry:
            val = telemetry[src]
            if isinstance(val, float) and val in (-273.0, -1.0, -9999.0):
                continue
            out[dst] = val
    out["_slower_uploads"] = slower
    return out


class SondehubUploader:
    """Queue + batched gzip PUT every ``upload_rate`` s (network
    best-effort, disabled automatically without connectivity)."""

    def __init__(self, upload_rate=30, user_callsign="N0CALL",
                 user_position=None, user_antenna="",
                 contact_email="none@none.com", start_thread=True,
                 url=SONDEHUB_URL):
        self.upload_rate = upload_rate
        self.user_callsign = user_callsign
        self.user_position = user_position
        self.user_antenna = user_antenna
        self.contact_email = contact_email
        self.url = url
        self.input_queue = queue.Queue()
        self.slower_uploads = False
        self.running = False
        self.last_upload_count = 0
        self._thread = None
        if start_thread:
            self.running = True
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def add(self, telemetry: dict):
        ref = reformat_data(telemetry, self.user_callsign,
                            self.user_position, self.user_antenna)
        if ref is not None:
            self.slower_uploads |= ref.pop("_slower_uploads", False)
            self.input_queue.put(ref)

    def _loop(self):
        while self.running:
            # DFM slower-uploads: cap at 30 s like the reference
            # (reference sondehub.py:388-391)
            rate = min(30, int(self.upload_rate * 1.5)) \
                if self.slower_uploads else self.upload_rate
            time.sleep(max(1, rate))
            # listener position: on start and every 6 h (reference
            # uploads the station position periodically so the receiver
            # appears on the SondeHub map); best-effort + retried next
            # cycle on failure
            if self.user_position and (
                    time.time() - getattr(self, "_last_pos_upload", 0)
                    > 6 * 3600):
                if self.station_position_upload(
                        *self.user_position, antenna=self.user_antenna):
                    self._last_pos_upload = time.time()
            self.process_queue()

    def process_queue(self):
        batch = []
        while not self.input_queue.empty():
            batch.append(self.input_queue.get())
        if batch:
            self.upload_telemetry(batch)

    def upload_telemetry(self, batch):
        """Gzip JSON PUT (reference sondehub.py:401-504)."""
        try:
            import requests
            blob = gzip.compress(json.dumps(batch).encode("utf-8"))
            headers = {
                "User-Agent": f"{SOFTWARE_NAME}-0.1.0",
                "Content-Encoding": "gzip",
                "Content-Type": "application/json",
            }
            r = requests.put(self.url, data=blob, headers=headers,
                             timeout=20)
            self.last_upload_count = len(batch)
            return r.status_code == 200
        except Exception:
            return False

    def station_position_upload(self, lat, lon, alt, radio="", antenna=""):
        try:
            import requests
            pos = {
                "software_name": SOFTWARE_NAME,
                "software_version": "0.1.0",
                "uploader_callsign": self.user_callsign,
                "uploader_position": [lat, lon, alt],
                "uploader_radio": radio,
                "uploader_antenna": antenna,
                "uploader_contact_email": self.contact_email,
                "mobile": False,
            }
            r = requests.put(SONDEHUB_STATION_URL, json=pos, timeout=20)
            return r.status_code == 200
        except Exception:
            return False

    def update_station_position(self, lat, lon, alt):
        self.user_position = [lat, lon, alt]

    def close(self):
        self.running = False
        if self._thread:
            self._thread.join(timeout=2)
