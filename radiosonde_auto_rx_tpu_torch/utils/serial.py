"""Serial-number handling and APRS object-ID generation.

Mirrors reference auto_rx/autorx/utils.py: strip_sonde_serial (:160-173),
short_type_lookup (:175-226), generate_aprs_id (:280-360).
"""

import re

_PREFIX_RE = re.compile(
    "^(DFM|M10|M20|IMET|IMET5|IMET54|MRZ|LMS6|IMS100|RS11G|MTS01|WXR)-")

SHORT_TYPE_NAMES = {
    "DFM": "Graw DFM", "PS15": "Graw PS15",
    "M10": "Meteomodem M10", "M20": "Meteomodem M20",
    "LMS6": "Lockheed Martin LMS6-403",
    "MK2LMS": "Lockheed Martin LMS6-1680",
    "IMET": "Intermet Systems iMet-1/4",
    "IMET-XDATA": "Intermet Systems iMet-1/4 + XDATA",
    "IMET5": "Intermet Systems iMet-5x",
    "MEISEI": "Meisei iMS-100/RS-11",
    "IMS100": "Meisei iMS-100", "RS11G": "Meisei RS-11G",
    "MRZ": "Meteo-Radiy MRZ", "MTS01": "Meteosis MTS01",
    "WXR301": "Weathex WxR-301D",
    "WXRPN9": "Weathex WxR-301D (PN9 Variant)",
    "RD41": "Vaisala RD41 Dropsonde", "RD94": "Vaisala RD94 Dropsonde",
}


def strip_sonde_serial(serial: str) -> str:
    if _PREFIX_RE.match(serial):
        return "-".join(serial.split("-")[1:])
    return serial


def short_type_lookup(type_name: str) -> str:
    if type_name.startswith("RS41") or type_name.startswith("RS92"):
        return "Vaisala " + type_name
    return SHORT_TYPE_NAMES.get(type_name, "Unknown")


def generate_aprs_id(sonde_data: dict) -> str | None:
    t = sonde_data["type"]
    sid = sonde_data["id"]
    try:
        if "RS92" in t or "RS41" in t:
            return sid.strip()
        if "DFM" in t or "PS15" in t:
            return "D%d" % int(sid.split("-")[-1])
        if "M10" in t:
            return sonde_data.get("aprsid")
        if "M20" in t:
            if "rawid" in sonde_data:
                return ("ME" + sonde_data["rawid"].split("_")[1][:2] +
                        sid.split("-")[-1])
            return None
        if "IMET" in t:
            return "IMET" + sid[-5:]
        if "LMS" in t:
            return "LMS6" + hex(int(sid.split("-")[1])).upper()[-5:]
        if "WXR" in t:
            return "WXR" + hex(int(sid.split("-")[1])).upper()[-6:]
        if "MEISEI" in t or "IMS100" in t or "RS11G" in t:
            return "IMS" + sid.split("-")[-1][-6:]
        if "MRZ" in t:
            return "MRZ" + sid.split("-")[1][-6:]
        if "MTS01" in t:
            return "MTS" + sid.split("-")[-1][-6:]
        if "RD41" in t or "RD94" in t:
            return t + sid[-5:]
    except (ValueError, IndexError):
        return None
    return None
