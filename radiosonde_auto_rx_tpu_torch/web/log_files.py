"""Telemetry log-file analytics: listing, reading, Skew-T data, KML export.

Mirrors reference auto_rx/autorx/log_files.py: filename parsing + flight
stats (:31-217), log reading (:243-390), Skew-T dataset generation
(:395-504), KML path export (:556-707).  Operates on the CSV format
written by exporters/logfile.py (identical to the reference's).
"""

import glob
import io
import math
import os
import zipfile

from dateutil.parser import parse



def log_filename_to_stats(filename: str) -> dict | None:
    """Parse YYYYMMDD-HHMMSS_<serial>_<type>_<freq>_sonde.log."""
    base = os.path.basename(filename)
    parts = base.split("_")
    if len(parts) < 5 or not base.endswith("_sonde.log"):
        return None
    return {
        "filename": filename,
        "start_time": parts[0],
        "serial": parts[1],
        "type": parts[2],
        "freq": parts[3],
    }


def list_log_files(log_directory="./log/", quicklook=False) -> list:
    out = []
    seen = set()
    for f in sorted(glob.glob(os.path.join(log_directory, "*_sonde.log")),
                    reverse=True):
        entry = log_filename_to_stats(f)
        if entry is None:
            continue
        seen.add(f)
        if quicklook:
            entry.update(log_quick_look(f) or {})
        out.append(entry)
    # evict cache entries for rotated/archived logs: a long-running
    # station otherwise retains (mtime, stats) for every path it ever
    # listed
    for path in list(_QUICKLOOK_CACHE):
        if path not in seen and not os.path.exists(path):
            del _QUICKLOOK_CACHE[path]
    return out


def read_log_file(filename: str, decimation: int = 1) -> dict:
    """CSV log -> dict of column arrays (reference log_files.py:243-390)."""
    out = {"time": [], "lat": [], "lon": [], "alt": [], "vel_v": [],
           "vel_h": [], "heading": [], "temp": [], "humidity": [],
           "pressure": [], "sats": [], "batt": [], "snr": [],
           "serial": None, "type": None}
    with open(filename) as f:
        header = f.readline()
        for i, line in enumerate(f):
            if decimation > 1 and i % decimation:
                continue
            fields = line.strip().split(",")
            if len(fields) < 14:
                continue
            # parse the WHOLE line before appending anything: a
            # mid-line ValueError must skip the line, not leave the
            # column arrays at different lengths (misaligned columns
            # crash skew-T and mis-place snr-map samples)
            try:
                vals = [float(fields[j]) for j in range(3, 12)]
                sats = float(fields[16]) if len(fields) > 16 else None
                snr = float(fields[14]) if len(fields) > 14 else None
            except ValueError:
                continue
            out["time"].append(fields[0])
            out["serial"] = fields[1]
            for key, v in zip(("lat", "lon", "alt", "vel_v", "vel_h",
                               "heading", "temp", "humidity",
                               "pressure"), vals):
                out[key].append(v)
            out["type"] = fields[12]
            if sats is not None:
                out["sats"].append(sats)
            if snr is not None:
                out["snr"].append(snr)
    return out


_QUICKLOOK_CACHE: dict = {}    # path -> (mtime, stats)


def log_quick_look(filename: str) -> dict | None:
    """Flight summary stats, cached by (path, mtime): /get_log_list
    calls this for EVERY log on every History-tab poll, and a
    long-running station accumulates hundreds of flights — re-parsing
    unchanged files each request is O(total log bytes) per poll."""
    try:
        mtime = os.stat(filename).st_mtime
    except OSError:
        return None
    hit = _QUICKLOOK_CACHE.get(filename)
    if hit is not None and hit[0] == mtime:
        return hit[1]
    data = read_log_file(filename, decimation=10)
    if not data["alt"]:
        _QUICKLOOK_CACHE[filename] = (mtime, None)
        return None
    with open(filename) as f:
        n_lines = sum(1 for _ in f) - 1
    stats = {
        "first_time": data["time"][0],
        "last_time": data["time"][-1],
        "max_alt": max(data["alt"]),
        "last_alt": data["alt"][-1],
        "last_lat": data["lat"][-1],
        "last_lon": data["lon"][-1],
        "points": n_lines,
    }
    _QUICKLOOK_CACHE[filename] = (mtime, stats)
    return stats


def pressure_from_altitude(alt_m: float) -> float:
    """ISA barometric estimate (used when the sonde has no P sensor)."""
    return 1013.25 * (1.0 - alt_m / 44330.77) ** 5.2558 \
        if alt_m < 44330 else 0.01


def calculate_skewt_data(log_data: dict, decimation: int = 1,
                         max_alt: float = 35000.0) -> list:
    """Log data -> Skew-T dataset [{press, hght, temp, dwpt, wdir, wspd}]
    (reference log_files.py:395-504; dewpoint via Magnus formula)."""
    out = []
    n = len(log_data["alt"])
    last_alt = -9999.0
    for i in range(0, n, decimation):
        alt = log_data["alt"][i]
        if alt <= last_alt or alt > max_alt:
            continue
        last_alt = alt
        temp = log_data["temp"][i]
        rh = log_data["humidity"][i]
        press = log_data["pressure"][i]
        if press <= 0:
            press = pressure_from_altitude(alt)
        if temp <= -270.0:
            continue
        if 0.0 < rh <= 100.0:
            gamma = math.log(max(rh, 0.1) / 100.0) + \
                (17.625 * temp) / (243.04 + temp)
            dwpt = 243.04 * gamma / (17.625 - gamma)
        else:
            dwpt = None
        out.append({
            "press": round(press, 1),
            "hght": round(alt, 1),
            "temp": round(temp, 1),
            "dwpt": round(dwpt, 1) if dwpt is not None else None,
            "wdir": round(log_data["heading"][i], 1),
            "wspd": round(log_data["vel_h"][i] * 1.94384, 1),   # knots
        })
    return out


def log_file_to_kml(filename: str) -> str:
    """One flight path as a KML document (reference log_files.py:556-707)."""
    data = read_log_file(filename)
    coords = "\n".join("%.5f,%.5f,%.1f" % (lon, lat, alt)
                       for lat, lon, alt in zip(data["lat"], data["lon"],
                                                data["alt"]))
    from xml.sax.saxutils import escape
    # the serial is over-the-air data: escape it like telemetry_to_kml
    name = escape(data["serial"] or os.path.basename(filename))
    return ('<?xml version="1.0" encoding="UTF-8"?>\n'
            '<kml xmlns="http://www.opengis.net/kml/2.2"><Document>'
            f'<Placemark><name>{name}</name><LineString>'
            '<altitudeMode>absolute</altitudeMode><extrude>1</extrude>'
            f'<coordinates>{coords}</coordinates>'
            '</LineString></Placemark></Document></kml>\n')


def zip_log_files(log_directory="./log/", serial_list=None) -> bytes:
    """Zip selected (or all) log files (reference log_files.py:523-553)."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for entry in list_log_files(log_directory):
            if serial_list and entry["serial"] not in serial_list:
                continue
            zf.write(entry["filename"],
                     os.path.basename(entry["filename"]))
    return buf.getvalue()
