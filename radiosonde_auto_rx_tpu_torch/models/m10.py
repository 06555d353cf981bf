"""Meteomodem M10 / M20 frame codec (9615/9600 Bd, differential biphase).

Frame structure and telemetry semantics follow the on-air protocol as
documented by the reference decoders (reference demod/mod/m10mod.c,
m20mod.c): 32-symbol raw header (m10mod.c:72); per-pair bit decision
``s2-s1`` then differential decode ``data = !(b_prev ^ b)``
(m10mod.c:1455-1487); MSB-first byte packing (m10mod.c:141-168); linear
16-bit checksum ``update_checkM10`` (m10mod.c:595-630); M10 Trimble
Copernicus GPS payload (m10mod.c:173-226), Gtop variant (:243-250,483-570);
M20 field layout (m20mod.c:208-226); Shibaura NTC temperature
(m10mod.c:635-698), U.P.S.I. humidity (m10mod.c:775-825), battery
(m10mod.c:830-846); M20 RH/pressure from DF9DQ (m20mod.c:678-738);
JSON fields (m10mod.c:968-1046, m20mod.c:826-864).  The implementation
(vectorized numpy + encoder fixtures) is new.
"""

import numpy as np

from radiosonde_auto_rx_tpu_torch.models import register
from radiosonde_auto_rx_tpu_torch.demod.framing import find_frame_starts

RAW_HEADER = "10011001100110010100110010011001"
BAUD_M10 = 9615
BAUD_M20 = 9600

STD_FLEN_M10 = 0x64
STD_FLEN_M20 = 0x45
FRAME_LEN = 101
AUX_LEN_M10 = 20
AUX_LEN_M20 = 64

TYPE_M2K2, TYPE_M10, TYPE_M10PLUS, TYPE_M20 = 0x8F, 0x9F, 0xAF, 0x20


# --------------------------------------------------------------------------- #
# bit plumbing
# --------------------------------------------------------------------------- #

def pairs_to_bits(raw, soft=None):
    """Raw symbol pairs -> b-bits: b = (s2 - s1 >= 0) (m10mod.c:1459-1467)."""
    raw = np.asarray(raw, dtype=np.uint8)
    n = (len(raw) // 2) * 2
    if soft is not None:
        s = soft[1:n:2] - soft[0:n:2]
        return (s >= 0).astype(np.uint8)
    # hard: ±1 equivalent of the same decision
    s = raw[1:n:2].astype(np.int8) - raw[0:n:2].astype(np.int8)
    return (s >= 0).astype(np.uint8)


def diff_decode(b, b0=0):
    """data[k] = 1 ^ (b[k-1] ^ b[k]) (m10mod.c:1484)."""
    prev = np.concatenate([[b0], b[:-1]]).astype(np.uint8)
    return (1 ^ (prev ^ b)).astype(np.uint8)


def diff_encode(data, b0=0):
    """Inverse: b[k] = b[k-1] ^ (1 ^ data[k])."""
    flips = (1 ^ np.asarray(data, dtype=np.uint8))
    b = np.bitwise_xor.accumulate(np.concatenate([[b0], flips]))[1:]
    return b.astype(np.uint8)


def bits_to_raw(b):
    """b-bits -> raw symbol pairs (s1, s2) = (1-b, b)."""
    out = np.empty(2 * len(b), dtype=np.uint8)
    out[0::2] = 1 - b
    out[1::2] = b
    return out


from radiosonde_auto_rx_tpu_torch.demod.framing import (  # noqa: E402
    bits_to_bytes_be, bytes_to_bits_be)


# --------------------------------------------------------------------------- #
# checksum (m10mod.c:595-630)
# --------------------------------------------------------------------------- #

def update_check_m10(c, b):
    c1 = c & 0xFF
    b = ((b >> 1) | ((b & 1) << 7)) & 0xFF
    b ^= (b >> 2) & 0xFF
    t6 = (c & 1) ^ ((c >> 2) & 1) ^ ((c >> 4) & 1)
    t7 = ((c >> 1) & 1) ^ ((c >> 3) & 1) ^ ((c >> 5) & 1)
    t = (c & 0x3F) | (t6 << 6) | (t7 << 7)
    s = (c >> 7) & 0xFF
    s ^= (s >> 2) & 0xFF
    c0 = b ^ t ^ s
    return ((c1 << 8) | c0) & 0xFFFF


def check_m10(msg, length):
    cs = 0
    for i in range(length):
        cs = update_check_m10(cs, int(msg[i]))
    return cs & 0xFFFF


# --------------------------------------------------------------------------- #
# shared helpers
# --------------------------------------------------------------------------- #

def gps2date(week, seconds):
    """GPS week/sec -> (year, month, day) via MJD (m10mod.c:120-138)."""
    gps_days = week * 7 + seconds // 86400
    mjd = 44244 + gps_days
    J = mjd + 2468570
    C = 4 * J // 146097
    J = J - (146097 * C + 3) // 4
    Y = 4000 * (J + 1) // 1461001
    J = J - 1461 * Y // 4 + 31
    M = 80 * J // 2447
    day = J - 2447 * M // 80
    J = M // 11
    month = M + 2 - 12 * J
    year = 100 * (C - 49) + Y + J
    return year, month, day


def _be(frame, pos, n):
    v = 0
    for i in range(n):
        v = (v << 8) | int(frame[pos + i])
    return v


def _s16(v):
    return v - 0x10000 if v & 0x8000 else v


def _s24(v):
    return v - 0x1000000 if v & 0x800000 else v


def _s32(v):
    return v - 0x100000000 if v & 0x80000000 else v


# Shibaura PB5-41E Steinhart-Hart (m10mod.c:656-660)
_SH_P = (1.07303516e-03, 2.41296733e-04, 2.26744154e-06, 6.52855181e-08)
_RS_SCALE = (12.1e3, 36.5e3, 475.0e3)
_RP_SCALE = (1e20, 330.0e3, 2000.0e3)


def _steinhart(R, p):
    lr = np.log(R)
    return 1.0 / (p[0] + p[1] * lr + p[2] * lr**2 + p[3] * lr**3) - 273.15


# --------------------------------------------------------------------------- #
# M10
# --------------------------------------------------------------------------- #

@register("M10")
class M10Decoder:
    """M10 (Trimble / Gtop) frame decoder: raw bit stream -> telemetry."""

    HEADER = RAW_HEADER

    def __init__(self, jsn_freq_khz: int = 0):
        self.jsn_freq_khz = jsn_freq_khz

    def decode_bits(self, raw_bits, soft=None):
        raw_bits = np.asarray(raw_bits, dtype=np.uint8)
        out = []
        nraw = 2 * 8 * (FRAME_LEN + AUX_LEN_M10)
        # differential decode is polarity-invariant (m10mod.c:1443-1445),
        # but the header search needs the right polarity: try both.
        for inv in (False, True):
            hdr = RAW_HEADER if not inv else "".join(
                "1" if c == "0" else "0" for c in RAW_HEADER)
            for s in find_frame_starts(raw_bits, hdr, max_errors=2):
                raw = raw_bits[s:s + nraw]
                if len(raw) < 2 * 8 * STD_FLEN_M10:
                    continue
                sft = None if soft is None else soft[s:s + nraw]
                b = pairs_to_bits(raw, sft)
                data = diff_decode(b, b0=0)
                frame = np.zeros(FRAME_LEN + AUX_LEN_M10, dtype=np.uint8)
                fb = bits_to_bytes_be(data)
                frame[:len(fb)] = fb[:len(frame)]
                t = self.decode_frame(frame)
                if t:
                    out.append(t)
        return out

    def decode_frame(self, frame):
        flen = int(frame[0])
        auxlen = flen - STD_FLEN_M10
        if auxlen < 0 or auxlen > AUX_LEN_M10:
            auxlen = 0
        pos_check = STD_FLEN_M10 - 1 + auxlen
        cs1 = _be(frame, pos_check, 2)
        cs2 = check_m10(frame, pos_check)
        if cs1 != cs2:
            return None
        ftype = int(frame[1])
        if ftype == TYPE_M10:
            return self._telem_trimble(frame, auxlen)
        if ftype == TYPE_M10PLUS:
            return self._telem_gtop(frame, auxlen)
        return None

    # ---- Trimble payload (m10mod.c:224-240,286-457) ----

    def _telem_trimble(self, frame, auxlen):
        week = _be(frame, 0x20, 2)
        if week > 4000:
            return None
        if week < 1304:
            week += 1024          # Copernicus II WNRO
        tow_ms = _be(frame, 0x0A, 4)
        gpssec = tow_ms // 1000
        if not (0 <= gpssec // 86400 <= 6):
            return None
        B60B60 = (1 << 30) / 90.0
        lat = _s32(_be(frame, 0x0E, 4)) / B60B60
        lon = _s32(_be(frame, 0x12, 4)) / B60B60
        alt = _s32(_be(frame, 0x16, 4)) / 1000.0
        vx = _s16(_be(frame, 0x04, 2)) / 2e2   # east, 0.005 m/s units
        vy = _s16(_be(frame, 0x06, 2)) / 2e2   # north
        vv = _s16(_be(frame, 0x08, 2)) / 2e2
        vh = float(np.hypot(vx, vy))
        vd = float(np.degrees(np.arctan2(vx, vy)) % 360.0)
        numsv = int(frame[0x1E])
        utc_ofs = int(frame[0x1F])

        # UTC datetime (m10mod.c:976-999)
        utc_s = gpssec - utc_ofs
        utc_week = week
        if utc_s < 0:
            utc_week -= 1
            utc_s += 604800
        yy, mm, dd = gps2date(utc_week, utc_s)
        day_s = utc_s % 86400
        sek = day_s % 60 + (tow_ms % 1000) / 1000.0
        dt = (f"{yy:04d}-{mm:02d}-{dd:02d}T{day_s // 3600:02d}:"
              f"{(day_s % 3600) // 60:02d}:{sek:06.3f}Z")

        sn = frame[0x5D:0x5D + 5]
        b2 = int(sn[2])
        b34 = int(sn[3]) | (int(sn[4]) << 8)
        sid = (f"{(b2 >> 4) & 0xF:1X}{b2 & 0xF:02d}-{int(sn[0]) & 0xF:1X}-"
               f"{(b34 >> 13) & 0x7:1d}{b34 & 0x1FFF:04d}")

        telem = {
            "type": "M10",
            "frame": int(week * 604800 + tow_ms / 1e3 + 0.5),
            "id": f"M10-{sid}",
            "datetime": dt,
            "lat": round(lat, 5),
            "lon": round(lon, 5),
            "alt": round(alt, 5),
            "vel_h": round(vh, 5),
            "heading": round(vd, 5),
            "vel_v": round(vv, 5),
            "sats": numsv,
            "aprsid": (f"ME{int(sn[2]):02X}{int(sn[0]) & 0xF:1X}"
                       f"{int(sn[4]):02X}{int(sn[3]):02X}"),
            "batt": round(self._batv(frame), 2),
            "rawid": "M10_" + "".join(f"{int(x):02X}" for x in sn),
            "subtype": f"0x{TYPE_M10:02X}",
            "ref_datetime": "UTC",
            "ref_position": "GPS",
            "gpsutc_leapsec": utc_ofs,
        }
        T = self._temp(frame)
        if T > -270.0:
            telem["temp"] = round(T, 1)
        rh = self._rh(frame, T)
        if rh > -0.5:
            telem["humidity"] = round(rh, 1)
        if self.jsn_freq_khz:
            telem["freq"] = self.jsn_freq_khz
        return telem

    # ---- Gtop payload (m10mod.c:483-570) ----

    def _telem_gtop(self, frame, auxlen):
        lat = _s32(_be(frame, 0x04, 4)) / 1e6
        lon = _s32(_be(frame, 0x08, 4)) / 1e6
        alt = _s24(_be(frame, 0x0C, 3)) / 1e2
        vx = _s16(_be(frame, 0x0F, 2)) / 1e2
        vy = _s16(_be(frame, 0x11, 2)) / 1e2
        vv = _s16(_be(frame, 0x13, 2)) / 1e2
        vh = float(np.hypot(vx, vy))
        vd = float(np.degrees(np.arctan2(vx, vy)) % 360.0)
        tval = _be(frame, 0x15, 3)
        dval = _be(frame, 0x18, 3)
        yy = 2000 + dval % 100
        mm = (dval % 10000) // 100
        dd = dval // 10000
        hh, mi = tval // 10000, (tval % 10000) // 100
        sek = float(tval % 100)
        dt = f"{yy:04d}-{mm:02d}-{dd:02d}T{hh:02d}:{mi:02d}:{sek:06.3f}Z"
        sn = frame[0x5D:0x5D + 5]
        b2 = int(sn[2])
        b34 = int(sn[3]) | (int(sn[4]) << 8)
        sid = (f"{(b2 >> 4) & 0xF:1X}{b2 & 0xF:02d}-{int(sn[0]) & 0xF:1X}-"
               f"{(b34 >> 13) & 0x7:1d}{b34 & 0x1FFF:04d}")
        telem = {
            "type": "M10",
            "frame": int(hh * 3600 + mi * 60 + sek),
            "id": f"M10-{sid}",
            "datetime": dt,
            "lat": round(lat, 5),
            "lon": round(lon, 5),
            "alt": round(alt, 5),
            "vel_h": round(vh, 5),
            "heading": round(vd, 5),
            "vel_v": round(vv, 5),
            "batt": round(self._batv(frame), 2),
            "rawid": "M10_" + "".join(f"{int(x):02X}" for x in sn),
            "subtype": f"0x{TYPE_M10PLUS:02X}",
            "ref_datetime": "UTC",
            "ref_position": "GPS",
        }
        T = self._temp(frame)
        if T > -270.0:
            telem["temp"] = round(T, 1)
        if self.jsn_freq_khz:
            telem["freq"] = self.jsn_freq_khz
        return telem

    # ---- sensors (m10mod.c:635-846) ----

    @staticmethod
    def _temp(frame):
        scT = int(frame[0x3E])
        adc = ((int(frame[0x40]) << 8) | int(frame[0x3F])) - 0xA000
        if adc <= 0 or scT >= 3:
            return -273.15
        x = (4095.0 - adc) / adc
        denom = x - _RS_SCALE[scT] / _RP_SCALE[scT]
        if denom <= 0:
            return -273.15
        R = _RS_SCALE[scT] / denom
        if R <= 0:
            return -273.15
        return float(_steinhart(R, _SH_P))

    @staticmethod
    def _tntc2(frame):
        adc = (int(frame[0x5A]) << 8) | int(frame[0x59])
        if adc == 0:
            return -273.15
        x = (4095.0 - adc) / adc
        if x <= 0:
            return -273.15
        R = 22.1e3 / x
        p = (4.42606809e-03, -6.58184309e-04, 8.95735557e-05,
             -2.84347503e-06)
        return float(_steinhart(R, p))

    def _rh(self, frame, Tc):
        cnt55 = _be(frame, 0x34, 1) << 16 | _be(frame, 0x33, 1) << 8 | \
            _be(frame, 0x32, 1)
        cnt_rh = _be(frame, 0x37, 1) << 16 | _be(frame, 0x36, 1) << 8 | \
            _be(frame, 0x35, 1)
        if cnt55 == 0:
            return -1.0
        c = cnt_rh / cnt55
        rh = (c - 0.8955) / 0.002
        T = Tc
        if T < 0.0:
            rh += 0.0 - T / 5.5
        if T < -30.0:
            rh *= 1.0 + (-30.0 - T) / 75.0
        return float(np.clip(rh, 0.0, 100.0))

    @staticmethod
    def _batv(frame):
        adc = (int(frame[0x46]) << 8) | int(frame[0x45])
        return 2.709 * adc * 2.5 / 1023.0


# --------------------------------------------------------------------------- #
# M20
# --------------------------------------------------------------------------- #

@register("M20")
class M20Decoder:
    """M20 frame decoder (m20mod.c field layout)."""

    HEADER = RAW_HEADER

    def __init__(self, jsn_freq_khz: int = 0):
        self.jsn_freq_khz = jsn_freq_khz

    def decode_bits(self, raw_bits, soft=None):
        raw_bits = np.asarray(raw_bits, dtype=np.uint8)
        out = []
        nraw = 2 * 8 * (FRAME_LEN + AUX_LEN_M20)
        for inv in (False, True):
            hdr = RAW_HEADER if not inv else "".join(
                "1" if c == "0" else "0" for c in RAW_HEADER)
            for s in find_frame_starts(raw_bits, hdr, max_errors=2):
                raw = raw_bits[s:s + nraw]
                if len(raw) < 2 * 8 * (STD_FLEN_M20 + 1):
                    continue
                sft = None if soft is None else soft[s:s + nraw]
                b = pairs_to_bits(raw, sft)
                data = diff_decode(b, b0=0)
                frame = np.zeros(FRAME_LEN + AUX_LEN_M20, dtype=np.uint8)
                fb = bits_to_bytes_be(data)
                frame[:min(len(fb), len(frame))] = fb[:len(frame)]
                t = self.decode_frame(frame)
                if t:
                    out.append(t)
        return out

    def decode_frame(self, frame):
        flen = int(frame[0])
        auxlen = flen - STD_FLEN_M20
        pos_fw = 0x43
        if auxlen < 0:
            auxlen = 0
            pos_fw = flen - 2
        elif auxlen > AUX_LEN_M20:
            auxlen = AUX_LEN_M20
            flen = STD_FLEN_M20 + AUX_LEN_M20
        pos_check = flen - 1
        fw = int(frame[pos_fw])
        if fw > 0x20:
            fw = 0
        cs1 = _be(frame, pos_check, 2)
        cs2 = check_m10(frame, pos_check)
        if cs1 != cs2 or int(frame[1]) != TYPE_M20:
            return None
        return self._telem(frame, fw)

    def _telem(self, frame, fw):
        week = _be(frame, 0x1A, 2)
        if week > 4000:
            return None
        if week < 1304:
            week += 1024
        gpssec = _be(frame, 0x0F, 3)
        day = gpssec // 86400
        if not (0 <= day <= 6):
            return None
        tow_ms = gpssec * 1000
        yy, mm, dd = gps2date(week, gpssec)
        day_s = gpssec % 86400
        dt = (f"{yy:04d}-{mm:02d}-{dd:02d}T{day_s // 3600:02d}:"
              f"{(day_s % 3600) // 60:02d}:{day_s % 60:06.3f}Z")

        lat = _s32(_be(frame, 0x1C, 4)) / 1e6
        lon = _s32(_be(frame, 0x20, 4)) / 1e6
        alt = _s24(_be(frame, 0x08, 3)) / 1e2
        vx = _s16(_be(frame, 0x0B, 2)) / 1e2
        vy = _s16(_be(frame, 0x0D, 2)) / 1e2
        vv = _s16(_be(frame, 0x18, 2)) / 1e2
        vh = float(np.hypot(vx, vy))
        vd = float(np.degrees(np.arctan2(vx, vy)) % 360.0)

        sn24 = _be(frame, 0x14, 1) << 16 | _be(frame, 0x13, 1) << 8 | \
            _be(frame, 0x12, 1)
        ym = sn24 & 0x7F
        sid = (f"{ym // 12}{(ym % 12) + 1:02d}-{((sn24 >> 7) & 0x7) + 1}-"
               f"{(sn24 >> 23) & 0x1}{(sn24 >> 10) & 0x1FFF:04d}")

        telem = {
            "type": "M20",
            "frame": int(week * 604800 + tow_ms / 1e3 + 0.5),
            "id": f"M20-{sid}",
            "datetime": dt,
            "lat": round(lat, 5),
            "lon": round(lon, 5),
            "alt": round(alt, 5),
            "vel_h": round(vh, 5),
            "heading": round(vd, 5),
            "vel_v": round(vv, 5),
            "batt": round(int(frame[0x26]) * 3.3 / 255, 2),
            "rawid": (f"M20_{int(frame[0x12]):02X}{int(frame[0x13]):02X}"
                      f"{int(frame[0x14]):02X}"),
            "subtype": f"0x{TYPE_M20:02X}",
            "ref_datetime": "GPS",
            "ref_position": "GPS",
        }
        T = self._temp(frame)
        if T > -273.0:
            telem["temp"] = round(T, 1)
        rh = self._rh(frame, self._tntc2(frame))
        if rh > -0.5:
            telem["humidity"] = round(rh, 1)
        P = self._pressure(frame, fw)
        if P > 0.0:
            telem["pressure"] = round(P, 2)
        if self.jsn_freq_khz:
            telem["freq"] = self.jsn_freq_khz
        return telem

    # ---- sensors (m20mod.c:564-738) ----

    @staticmethod
    def _temp(frame):
        adc = (int(frame[0x05]) << 8) | int(frame[0x04])
        if adc > 8191:
            scT, adc = 2, adc - 8192
        elif adc > 4095:
            scT, adc = 1, adc - 4096
        else:
            scT = 0
        if adc <= 0:
            return -273.15
        x = (4095.0 - adc) / adc
        denom = x - _RS_SCALE[scT] / _RP_SCALE[scT]
        if denom <= 0:
            return -273.15
        R = _RS_SCALE[scT] / denom
        if R <= 0:
            return -273.15
        T = _steinhart(R, _SH_P)
        if T < -120.0 or T > 60.0:
            return -273.15
        return float(T)

    @staticmethod
    def _tntc2(frame):
        adc = (int(frame[0x07]) << 8) | int(frame[0x06])
        if adc == 0:
            return -273.15
        x = (4095.0 - adc) / adc
        if x <= 0:
            return -273.15
        R = 22.1e3 / x
        T25, b, R25 = 298.15, 3650.0, 2.2e3
        return float(1.0 / (1.0 / T25 + np.log(R / R25) / b) - 273.15)

    @staticmethod
    def _rh(frame, TU):
        humval = (int(frame[0x03]) << 8) | int(frame[0x02])
        rh_cal = (int(frame[0x30]) << 8) | int(frame[0x2F])
        cal = 6.4e8 / (rh_cal + 80000.0)
        x = (humval + 80000.0) * cal * (1.0 - 5.8e-4 * (TU - 25.0))
        x = 4.16e9 / x
        x = 10.087 * x**3 - 211.62 * x**2 + 1388.2 * x - 2797.0
        if humval >= 48000:
            return -1.0
        return float(np.clip(x, 0.0, 100.0))

    @staticmethod
    def _pressure(frame, fw):
        val = (int(frame[0x25]) << 8) | int(frame[0x24])
        p0 = int(frame[0x16]) if fw >= 0x07 else 0
        val = (val << 8) | p0
        if val <= 0:
            return 0.0
        hpa = val / 4096.0
        return -1.0 if hpa > 2560.0 else float(hpa)


# --------------------------------------------------------------------------- #
# encoder fixtures
# --------------------------------------------------------------------------- #

def _put_be(frame, pos, val, n):
    for i in range(n):
        frame[pos + i] = (val >> (8 * (n - 1 - i))) & 0xFF


def encode_frame_m10(week=2050, tow_ms=388815000, lat=48.2, lon=16.4,
                     alt=12345.6, vE=3.1, vN=-4.2, vU=2.5, numsv=9,
                     utc_ofs=18, sn=(0x23, 0x00, 0xA5, 0x34, 0x52),
                     adc_temp=(1, 0xA000 + 2048), batt_adc=560,
                     cnt55=900000, cnt_rh=810000, ntc2_adc=2000):
    """Build one valid M10 (Trimble) frame, checksummed."""
    frame = np.zeros(FRAME_LEN, dtype=np.uint8)
    frame[0] = STD_FLEN_M10
    frame[1] = TYPE_M10
    frame[2] = 0x20
    B60B60 = (1 << 30) / 90.0
    _put_be(frame, 0x04, int(round(vE * 2e2)) & 0xFFFF, 2)
    _put_be(frame, 0x06, int(round(vN * 2e2)) & 0xFFFF, 2)
    _put_be(frame, 0x08, int(round(vU * 2e2)) & 0xFFFF, 2)
    _put_be(frame, 0x0A, tow_ms, 4)
    _put_be(frame, 0x0E, int(round(lat * B60B60)) & 0xFFFFFFFF, 4)
    _put_be(frame, 0x12, int(round(lon * B60B60)) & 0xFFFFFFFF, 4)
    _put_be(frame, 0x16, int(round(alt * 1000)) & 0xFFFFFFFF, 4)
    frame[0x1E] = numsv
    frame[0x1F] = utc_ofs
    _put_be(frame, 0x20, week if week >= 1304 else week, 2)
    # sensors
    frame[0x32], frame[0x33], frame[0x34] = (cnt55 & 0xFF,
                                             (cnt55 >> 8) & 0xFF,
                                             (cnt55 >> 16) & 0xFF)
    frame[0x35], frame[0x36], frame[0x37] = (cnt_rh & 0xFF,
                                             (cnt_rh >> 8) & 0xFF,
                                             (cnt_rh >> 16) & 0xFF)
    frame[0x3E] = adc_temp[0]
    frame[0x3F] = adc_temp[1] & 0xFF
    frame[0x40] = (adc_temp[1] >> 8) & 0xFF
    frame[0x45] = batt_adc & 0xFF
    frame[0x46] = (batt_adc >> 8) & 0xFF
    frame[0x59] = ntc2_adc & 0xFF
    frame[0x5A] = (ntc2_adc >> 8) & 0xFF
    for i, b in enumerate(sn):
        frame[0x5D + i] = b
    frame[0x62] = 1
    cs = check_m10(frame, STD_FLEN_M10 - 1)
    frame[0x63] = (cs >> 8) & 0xFF
    frame[0x64] = cs & 0xFF
    return frame


def encode_frame_m20(week=2150, gpssec=388815, lat=52.1, lon=13.3,
                     alt=8000.25, vE=2.5, vN=1.5, vU=-3.0,
                     sn24=(3 * 12 + 4) | (2 << 7) | (1234 << 10) | (1 << 23),
                     fw=0x07, adc_temp=2048, ntc2_adc=2000, humval=30000,
                     rh_cal=20000, p_raw=0x400000, batt=200):
    frame = np.zeros(FRAME_LEN, dtype=np.uint8)
    frame[0] = STD_FLEN_M20
    frame[1] = TYPE_M20
    frame[0x02], frame[0x03] = humval & 0xFF, (humval >> 8) & 0xFF
    frame[0x04], frame[0x05] = adc_temp & 0xFF, (adc_temp >> 8) & 0xFF
    frame[0x06], frame[0x07] = ntc2_adc & 0xFF, (ntc2_adc >> 8) & 0xFF
    _put_be(frame, 0x08, int(round(alt * 100)) & 0xFFFFFF, 3)
    _put_be(frame, 0x0B, int(round(vE * 100)) & 0xFFFF, 2)
    _put_be(frame, 0x0D, int(round(vN * 100)) & 0xFFFF, 2)
    _put_be(frame, 0x0F, gpssec, 3)
    frame[0x12] = sn24 & 0xFF
    frame[0x13] = (sn24 >> 8) & 0xFF
    frame[0x14] = (sn24 >> 16) & 0xFF
    frame[0x15] = 1                       # counter
    frame[0x16] = (p_raw & 0xFF) if fw >= 0x07 else 0
    _put_be(frame, 0x18, int(round(vU * 100)) & 0xFFFF, 2)
    _put_be(frame, 0x1A, week, 2)
    _put_be(frame, 0x1C, int(round(lat * 1e6)) & 0xFFFFFFFF, 4)
    _put_be(frame, 0x20, int(round(lon * 1e6)) & 0xFFFFFFFF, 4)
    frame[0x24] = (p_raw >> 8) & 0xFF
    frame[0x25] = (p_raw >> 16) & 0xFF
    frame[0x26] = batt
    frame[0x2F] = rh_cal & 0xFF
    frame[0x30] = (rh_cal >> 8) & 0xFF
    frame[0x43] = fw
    cs = check_m10(frame, STD_FLEN_M20 - 1)
    frame[STD_FLEN_M20 - 1] = (cs >> 8) & 0xFF
    frame[STD_FLEN_M20] = cs & 0xFF
    return frame


def frame_to_raw_bits(frame, pad_bytes=8):
    """Frame bytes -> header + differential pair raw bit stream."""
    hdr = np.array([int(c) for c in RAW_HEADER], dtype=np.uint8)
    data = bytes_to_bits_be(frame)
    if pad_bytes:
        data = np.concatenate(
            [data, np.zeros(8 * pad_bytes, dtype=np.uint8)])
    b = diff_encode(data, b0=0)
    return np.concatenate([hdr, bits_to_raw(b)])
