"""Telemetry validation and enrichment.

``telemetry_filter`` mirrors the reference's checks (reference
auto_rx/auto_rx.py:566-725): zero position, altitude cap, satellite count,
station radius (with temporary block), clock sanity, and per-type serial
validity.  ``enrich_telemetry`` mirrors the decoder-side fixups
(reference auto_rx/autorx/decode.py handle_decoder_line :1602-2002):
datetime completion, freq fields, aprsid, iMet synthetic serial.
"""

import datetime
import re

from dateutil.parser import parse

from radiosonde_auto_rx_tpu_torch.utils.geometry import position_info
from radiosonde_auto_rx_tpu_torch.utils.serial import generate_aprs_id
from radiosonde_auto_rx_tpu_torch.utils.sonde_specific import (
    fix_datetime, imet_unique_id)

VAISALA_SERIAL_RE = re.compile(r"[C-Z][\d][\d][\d]\d{4}$")


def enrich_telemetry(telemetry: dict, freq_hz: float | None = None,
                     snr: float | None = None,
                     f_error: float | None = None,
                     station_code: str = "SONDE") -> dict:
    """Fill derived fields: datetime_dt, freq/freq_float, aprsid, iMet ID."""
    t = dict(telemetry)
    if freq_hz is not None:
        t["freq_float"] = freq_hz / 1e6
        t["freq"] = "%.3f MHz" % (freq_hz / 1e6)
    if snr is not None:
        t["snr"] = snr
    if f_error is not None:
        t["f_error"] = f_error

    # datetime: time-only strings (iMet/LMS/Weathex/RD41) get today's date
    dt_str = t["datetime"]
    if "T" in dt_str:
        t["datetime_dt"] = parse(dt_str)
    else:
        t["datetime_dt"] = fix_datetime(dt_str)

    # synthetic iMet serial from power-on time + frequency (the decoder
    # cannot know a serial; reference decode.py:1782 always generates one)
    if t["type"] == "IMET" and "freq_float" in t and \
            not re.match(r"IMET-[0-9A-F]{8}$", t["id"]):
        t["id"] = imet_unique_id(t, custom=station_code)

    if "aprsid" not in t:
        aid = generate_aprs_id(t)
        if aid:
            t["aprsid"] = aid
    return t


def telemetry_filter(telemetry: dict, config: dict):
    """Validate telemetry; returns "OK", "TempBlock", or False."""
    if telemetry["lat"] == 0.0 and telemetry["lon"] == 0.0:
        return False
    if telemetry["alt"] > config["max_altitude"]:
        return False
    if "sats" in telemetry and telemetry["sats"] < 4:
        return False

    if config["station_lat"] != 0.0 and config["station_lon"] != 0.0:
        info = position_info(
            (config["station_lat"], config["station_lon"],
             config["station_alt"]),
            (telemetry["lat"], telemetry["lon"], telemetry["alt"]))
        if info["straight_distance"] > config["max_radius_km"] * 1000:
            return "TempBlock" if config["radius_temporary_block"] else False
        if info["straight_distance"] < config["min_radius_km"] * 1000 and \
                config["radius_temporary_block"]:
            return "TempBlock"

    delta = (datetime.datetime.now(datetime.timezone.utc)
             - telemetry["datetime_dt"]).total_seconds()
    if abs(delta) > 3600 * config["sonde_time_threshold"]:
        return False

    if _serial_valid(telemetry["id"], telemetry["type"]):
        return "OK"
    return False


# Per-type serial formats, derived from what each frame decoder can
# legitimately emit (reference auto_rx.py:566-725 validates Vaisala /
# DFM / Meisei / MRZ / dropsonde serials and passes the remaining types
# through on type alone; the formats below additionally pin those
# pass-through types to their decoders' actual serial grammar — M10/M20
# "XXX-X-XXXXX", numeric LMS/WXR, synthetic iMet IDs — so a corrupted
# frame that survives its checksum cannot reach the exporters with a
# malformed ID).
_SERIAL_RES = {
    # Meteomodem: <hex><2 digits>-<hex>-<5 digits> (m10mod.c serial
    # composition; models/m10.py:244,461)
    "M10": re.compile(r"M10-[0-9A-F]\d{2}-[0-9A-F]-\d{5}$"),
    "M20": re.compile(r"M20-\d{3,4}-\d-\d{5}$"),
    "LMS": re.compile(r"LMS6-\d+$"),
    # iMet: the station's synthetic SHA id (sonde_specific.imet_unique
    # _id) or the iMet-54's numeric serial
    "IMET5": re.compile(r"IMET5-\d+$"),
    "IMET": re.compile(r"IMET-[0-9A-F]{8}$"),
    # MTS-01 serials are a free-form ASCII field from the frame (only
    # NULs stripped, models/mts01.py:84) and may contain separators
    # like '-' or '_': accept any printable non-space run, matching the
    # reference's pass-on-type-alone behavior for this type
    "MTS01": re.compile(r"MTS01-[!-~]+$"),
    "WXR": re.compile(r"WXR-\d+$"),
    # DFM-06 serials are HEXADECIMAL (dfm09mod prints %6X; models/dfm.py
    # :303), DFM-09/17/PS15 decimal — accept both
    "DFM": re.compile(r"(DFM|PS15)\w*-[0-9A-F]+$"),
    "MRZ": re.compile(r"MRZ-\d+-\d+$"),
    "MEISEI": re.compile(r"(IMS100|RS11G|MEISEI)-\d+$"),
}
# subtype names carried in the type field map to the Meisei grammar
_SERIAL_RES["IMS100"] = _SERIAL_RES["RS11G"] = _SERIAL_RES["MEISEI"]


def _serial_valid(serial: str, typ: str) -> bool:
    """Reference serial checks (auto_rx.py:566-725) tightened to each
    decoder's real serial grammar."""
    if ("RS41" in typ or "RS92" in typ) and \
            VAISALA_SERIAL_RE.match(serial):
        # the reference applies the Vaisala regex regardless of type;
        # gating it on the Vaisala types (and end-anchoring) keeps a
        # corrupted other-type serial that happens to look Vaisala-ish
        # from bypassing its own grammar
        return True
    if "RD41" in typ or "RD94" in typ:
        # uninitialised dropsondes transmit an all-zero serial
        return bool(re.match(r"\d{9}$", serial)) and \
            serial != "000000000"
    # most-specific type key first (IMET5 before IMET).  The reference's
    # DFM/Meisei/MRZ 'x'-placeholder checks are subsumed by the \d+
    # serial grammars (a placeholder like DFM-xxxxxxxx fails the regex);
    # MTS01's free-form ASCII serial may legitimately contain an 'x',
    # so no extra placeholder check applies.
    for key in sorted(_SERIAL_RES, key=len, reverse=True):
        if key in typ:
            return _SERIAL_RES[key].match(serial) is not None
    return False


class RealtimeVelocityFilter:
    """Reject positions implying implausible velocity between frames
    (the reference's DFM realtime filter, decode.py:1929-1980)."""

    def __init__(self, max_velocity_ms: float = 300.0):
        self.max_velocity = max_velocity_ms
        self.last = {}

    def check(self, telemetry: dict) -> bool:
        sid = telemetry["id"]
        now = telemetry["datetime_dt"]
        pos = (telemetry["lat"], telemetry["lon"], telemetry["alt"])
        ok = True
        if sid in self.last:
            t0, p0 = self.last[sid]
            dt = (now - t0).total_seconds()
            if dt > 0:
                info = position_info(p0, pos)
                if info["straight_distance"] / dt > self.max_velocity:
                    ok = False
        if ok:
            self.last[sid] = (now, pos)
        return ok
