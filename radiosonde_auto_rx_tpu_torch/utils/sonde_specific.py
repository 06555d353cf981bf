"""Sonde-type specific helpers: time fixing, synthetic IDs, subtypes.

Mirrors reference auto_rx/autorx/sonde_specific.py: fix_datetime (:13-47),
imet_unique_id (:54-90), decode_dfm_subtype (:92-118).
"""

import datetime
import hashlib

from dateutil.parser import parse


def fix_datetime(datetime_str, local_dt_str=None):
    """Complete a time-only telemetry timestamp with today's date, handling
    the day-rollover window around midnight UTC."""
    if local_dt_str is None:
        now = datetime.datetime.now(datetime.timezone.utc)
    else:
        now = parse(local_dt_str)
    outside_window = now.hour not in (23, 0)
    dt = parse(datetime_str, default=now)
    if outside_window:
        return dt
    if dt.hour == 23 and now.hour == 0:
        dt -= datetime.timedelta(days=1)
    elif dt.hour == 0 and now.hour == 23:
        dt += datetime.timedelta(days=1)
    return dt


def imet_unique_id(telemetry, custom="SONDE", imet1=False):
    """Synthetic iMet serial from power-on time + frequency + location code.

    Needs telemetry keys datetime_dt, frame, freq_float."""
    frame = telemetry["frame"] // 2 if imet1 else telemetry["frame"]
    power_on = telemetry["datetime_dt"] - datetime.timedelta(seconds=frame)
    freq = round(telemetry["freq_float"] * 10.0) / 10.0
    s = power_on.strftime("%Y-%m-%dT%H:%M:%SZ") + \
        ("%.3f MHz" % freq) + custom
    h = hashlib.sha256(s.encode("ascii")).hexdigest().upper()
    return "IMET-" + h[-8:]


def decode_dfm_subtype(subtype):
    """DFM subtype nibble -> best-guess model name."""
    table = {"0x6": "DFM06", "0x7": "PS-15", "0xA": "DFM09",
             "0xB": "DFM17", "0xC": "DFM09P", "0xD": "DFM17"}
    if "0x" not in subtype:
        return "DFM-Unknown"
    return table.get(subtype, "DFMx" + subtype[-1])
