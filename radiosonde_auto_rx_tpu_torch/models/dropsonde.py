"""Vaisala RD94 / RD41 dropsonde frame codec (4.8 kBd Manchester2 + 8N1).

Frame structure per the reference decoder (reference
dropsonde/rd94rd41drop.c): 80-raw-bit header = bytes 1A CF FC 1D in
Manchester2 8N1 (:49-56); 120-byte frames, the first two bytes FC 1D from
the header, 8N1 bits little-endian (:332-371); block layout + checksums:
RD94 Fletcher-16 (``sum2 | sum1<<8``, :452-463), RD41 CRC16-0x1021 init 0
(:467-485); RD94 field layout: frame counter, float32 P/T/U1/U2 (nonstd
bit packing :766-792), ublox NAV-SOL ECEF pos/vel + week/TOW
(:407-430,512-686); RD41 variant: big-endian floats, vel/alt/time blocks
CCC/DDD/EEE/FFF (:434-449,688-760); next-frame header bytes checked at
118/119 (:836-844); JSON output (:1215-1250).  Implementation is new.
"""

import numpy as np

from radiosonde_auto_rx_tpu_torch.models import register
from radiosonde_auto_rx_tpu_torch.demod.framing import find_frame_starts
from radiosonde_auto_rx_tpu_torch.models.rs41 import ecef_to_geodetic, \
    geodetic_to_ecef, hdv_to_ecef_vel, ecef_vel_to_hdv
from radiosonde_auto_rx_tpu_torch.models.m10 import gps2date

FRAME_LEN = 120
OFS = 2
BAUD = 4800

# header bytes 1A CF FC 1D as Manchester2 8N1 (reference :52-56)
_HDR_BYTES = (0x1A, 0xCF, 0xFC, 0x1D)


def _byte_8n1_bits(b):
    """8N1: start 0, 8 data bits LSB-first, stop 1."""
    return [0] + [(b >> i) & 1 for i in range(8)] + [1]


def _manchester2_encode(bits):
    out = []
    for b in bits:
        out += [0, 1] if b else [1, 0]
    return out


RAW_HEADER = "".join(str(b) for b in _manchester2_encode(
    [bit for byte in _HDR_BYTES for bit in _byte_8n1_bits(byte)]))

POS_FRNR = OFS + 0x01
POS_P, POS_T, POS_U1, POS_U2 = OFS + 0x05, OFS + 0x09, OFS + 0x0D, OFS + 0x11
POS_TOW, POS_WEEK = OFS + 0x18, OFS + 0x20
POS_ECEF_X, POS_PACC = OFS + 0x24, OFS + 0x30
POS_ECEF_V1, POS_SACC1, POS_SATS1 = OFS + 0x34, OFS + 0x40, OFS + 0x46
POS_ECEF_V2, POS_SACC2, POS_SATS2 = OFS + 0x4A, OFS + 0x56, OFS + 0x5A
POS94_ID, POS94_BAT, POS94_TI = OFS + 0x5D, OFS + 0x66, OFS + 0x68
POS_PCKFRM, POS_PCKPTU = OFS + 0x00, OFS + 0x05
POS_CCC, POS_DDD, POS_EEE, POS_FFF = OFS + 0x17, OFS + 0x2A, OFS + 0x38, \
    OFS + 0x47
POS_PCKIDINT = OFS + 0x64
POS41_ID, POS41_BAT, POS41_TI = POS_PCKIDINT, POS_PCKIDINT + 6, \
    POS_PCKIDINT + 8


def chksum16(data):
    """Fletcher-like (rd94rd41drop.c:452-463): returns sum2 | sum1<<8."""
    s1 = s2 = 0
    for b in data:
        s1 = (s1 + int(b)) % 0x100
        s2 = (s2 + s1) % 0x100
    return s2 | (s1 << 8)


def crc16(data):
    rem = 0
    for b in data:
        rem ^= int(b) << 8
        for _ in range(8):
            rem = ((rem << 1) ^ 0x1021 if rem & 0x8000 else rem << 1) \
                & 0xFFFF
    return rem


def f32_rd94(frame, pos):
    """RD94 nonstandard float packing (rd94rd41drop.c:766-792)."""
    num = 0
    for i in range(4):
        num |= int(frame[pos + i]) << (24 - 8 * i)
    val = ((num & 0x800000) << 8) | ((num >> 1) & 0x7F800000) | \
        (num & 0x7FFFFF)
    return float(np.frombuffer(np.uint32(val).tobytes(), "<f4")[0])


def f32_rd94_encode(f):
    val = int(np.frombuffer(np.float32(f).tobytes(), "<u4")[0])
    num = ((val >> 8) & 0x800000) | ((val & 0x7F800000) << 1) | \
        (val & 0x7FFFFF)
    return [(num >> (24 - 8 * i)) & 0xFF for i in range(4)]


def f32_le(frame, pos):
    return float(np.frombuffer(bytes(frame[pos:pos + 4]), "<f4")[0])


def _u(frame, pos, n, le=True):
    v = 0
    rng = range(n) if not le else range(n - 1, -1, -1)
    for i in rng:
        v = (v << 8) | int(frame[pos + i])
    return v


def _i32le(frame, pos):
    v = _u(frame, pos, 4)
    return v - 0x100000000 if v & 0x80000000 else v


@register("DROPSONDE")
class DropsondeDecoder:
    """RD94/RD41 decoder with auto type detection."""

    HEADER = RAW_HEADER

    def __init__(self, jsn_freq_khz: int = 0):
        self.jsn_freq_khz = jsn_freq_khz

    def decode_bits(self, raw_bits, soft=None):
        raw_bits = np.asarray(raw_bits, dtype=np.uint8)
        if soft is not None:
            soft = np.asarray(soft)
        out = []
        nraw = FRAME_LEN * 10 * 2 - 40
        for inv in (False, True):
            hdr = RAW_HEADER if not inv else "".join(
                "1" if c == "0" else "0" for c in RAW_HEADER)
            for s in find_frame_starts(raw_bits, hdr, max_errors=4):
                raw = raw_bits[s:s + nraw]
                if inv:
                    raw = raw ^ 1
                if len(raw) < nraw // 2:
                    continue
                # prepend the FC 1D tail of the header (frame bytes 0..1)
                pre = [bit for byte in (0xFC, 0x1D)
                       for bit in _byte_8n1_bits(byte)]
                n = len(raw) // 2 * 2
                if soft is not None and len(soft) >= s + n:
                    # Manchester2 ([1,0]=0 / [0,1]=1): integrate BOTH
                    # half-symbols, bit = sign(s2 - s1) — same
                    # dual-symbol soft combining as DFM/RS92/MRZ
                    sr = soft[s:s + n] * (-1.0 if inv else 1.0)
                    data = (sr[1::2] - sr[0::2] > 0.0).astype(np.uint8)
                else:
                    data = raw[1:n:2]
                bits = np.concatenate(
                    [np.array(pre, dtype=np.uint8), data])
                nby = min(len(bits) // 10, FRAME_LEN)
                frame = np.zeros(FRAME_LEN, dtype=np.uint8)
                tenb = bits[:nby * 10].reshape(-1, 10)[:, 1:9]
                frame[:nby] = (tenb << np.arange(8)[None, :]).sum(axis=1)
                t = self.decode_frame(frame)
                if t:
                    out.append(t)
        return out

    # ------------------------------------------------------------------ #

    def decode_frame(self, frame):
        err94 = self._errs_rd94(frame)
        err41 = self._errs_rd41(frame)
        # auto detect (rd94rd41drop.c:1035-1047)
        typ = 41 if bin(err41 & 0x7F).count("1") <= 2 else \
            (94 if bin(err94 & 0x1F).count("1") < 3 else 0)
        if typ == 41 and (err41 & 0x7F) == 0:
            return self._telem_rd41(frame)
        if typ == 94 and (err94 & 0x1F) == 0:
            return self._telem_rd94(frame)
        if typ == 94:
            return None
        if (err94 & 0x1F) == 0:
            return self._telem_rd94(frame)
        return None

    def _errs_rd94(self, frame):
        err = 0
        checks = [(POS_PCKFRM, 3, 0), (POS_PCKPTU, 17, 1),
                  (POS_TOW, 47, 2), (POS_ECEF_V2 - 1, 18, 3),
                  (POS94_ID, 21, 4)]
        for pos, ln, bit in checks:
            want = (int(frame[pos + ln]) << 8) | int(frame[pos + ln + 1])
            if want != chksum16(frame[pos:pos + ln]):
                err |= 1 << bit
        return err

    def _errs_rd41(self, frame):
        err = 0
        checks = [(POS_PCKFRM, 3, 0), (POS_PCKPTU, 16, 1),
                  (POS_CCC, 17, 2), (POS_DDD, 12, 3), (POS_EEE, 13, 4),
                  (POS_FFF, 27, 5), (POS_PCKIDINT, 14, 6)]
        for pos, ln, bit in checks:
            want = (int(frame[pos + ln]) << 8) | int(frame[pos + ln + 1])
            if want != crc16(frame[pos:pos + ln]):
                err |= 1 << bit
        return err

    # ------------------------------------------------------------------ #

    def _telem_rd94(self, frame):
        frnr = _u(frame, POS_FRNR, 2)                 # LE for RD94
        week = _u(frame, POS_WEEK, 2)
        tow_ms = _i32le(frame, POS_TOW)
        gpssec = tow_ms // 1000
        day = gpssec // 86400
        if not (0 <= day <= 6):
            return None
        X = [_i32le(frame, POS_ECEF_X + 4 * k) / 100.0 for k in range(3)]
        lat, lon, alt = ecef_to_geodetic(*X)
        if not (-1000 <= alt <= 80000):
            return None
        V = [_i32le(frame, POS_ECEF_V1 + 4 * k) / 100.0 for k in range(3)]
        vH, vD, vU = ecef_vel_to_hdv(V[0], V[1], V[2], lat, lon)
        sats = int(frame[POS_SATS1])
        yy, mm, dd = gps2date(week, gpssec)
        std = (gpssec % 86400) // 3600
        minute = (gpssec % 3600) // 60
        sek = gpssec % 60
        ms = tow_ms % 1000
        sid = _u(frame, POS94_ID, 4, le=False)
        T = f32_rd94(frame, POS_T)
        P = f32_rd94(frame, POS_P)
        U1 = f32_rd94(frame, POS_U1)
        telem = {
            "type": "RD94",
            "frame": frnr,
            "id": f"{sid:09d}",
            "datetime": (f"{yy:04d}-{mm:02d}-{dd:02d}T{std:02d}:"
                         f"{minute:02d}:{sek:02d}.{ms:03d}Z"),
            "lat": round(lat, 5),
            "lon": round(lon, 5),
            "alt": round(alt, 5),
            "vel_h": round(vH, 5),
            "heading": round(vD, 5),
            "vel_v": round(vU, 5),
            "sats": sats,
            "ref_datetime": "GPS",
            "ref_position": "GPS",
        }
        self._add_ptu(telem, T, U1, P)
        if self.jsn_freq_khz:
            telem["freq"] = self.jsn_freq_khz
        return telem

    def _telem_rd41(self, frame):
        frnr = _u(frame, POS_FRNR, 2, le=False)       # BE for RD41
        std = int(frame[POS_CCC + 9]) & 0x1F
        minute = int(frame[POS_CCC + 10])
        sek = int(frame[POS_CCC + 11])
        cs = int(frame[POS_CCC + 12])
        lat = np.int32(_u(frame, POS_DDD, 4, le=False) & 0xFFFFFFFF) / 1e7
        lon = np.int32(_u(frame, POS_DDD + 4, 4, le=False)
                       & 0xFFFFFFFF) / 1e7
        alt3 = _u(frame, POS_CCC + 6, 3, le=False)
        if alt3 & 0x800000:
            alt3 -= 0x1000000
        alt = alt3 / 100.0
        vH = np.int16(_u(frame, POS_CCC, 2, le=False) & 0xFFFF) / 100.0
        vD = np.int16(_u(frame, POS_CCC + 2, 2, le=False) & 0xFFFF) / 100.0
        vV = -np.int16(_u(frame, POS_CCC + 4, 2, le=False) & 0xFFFF) / 100.0
        sats = int(frame[POS_CCC + 13])
        sid = _u(frame, POS41_ID, 4, le=False)
        T = f32_le(frame, POS_T)
        P = f32_le(frame, POS_P)
        U1 = f32_le(frame, POS_U1)
        telem = {
            "type": "RD41",
            "frame": frnr,
            "id": f"{sid:09d}",
            "datetime": f"{std:02d}:{minute:02d}:{sek:02d}.{cs:02d}Z",
            "lat": round(float(lat), 5),
            "lon": round(float(lon), 5),
            "alt": round(alt, 5),
            "vel_h": round(float(vH), 5),
            "heading": round(float(vD), 5),
            "vel_v": round(float(vV), 5),
            "sats": sats,
            "ref_datetime": "UTC",
            "ref_position": "MSL",
        }
        self._add_ptu(telem, T, U1, P)
        if self.jsn_freq_khz:
            telem["freq"] = self.jsn_freq_khz
        return telem

    @staticmethod
    def _add_ptu(telem, T, U1, P):
        if T > -273.0:
            telem["temp"] = round(T, 1)
        if U1 > -0.5:
            telem["humidity"] = round(U1, 1)
        if P > 0.0:
            telem["pressure"] = round(P, 2)


# --------------------------------------------------------------------------- #
# encoder fixture (RD94)
# --------------------------------------------------------------------------- #

def encode_frame_rd94(sid=941234567 % 10**9, frnr=321, week=2150,
                      tow_ms=((86400 * 3) + 12 * 3600 + 600) * 1000 + 250,
                      lat=13.5, lon=121.0, alt=9000.0, vH=12.0, vD=45.0,
                      vU=-22.0, sats=9, P=320.5, T=-48.2, U1=22.0, U2=21.0,
                      bat=8.9, Ti=15.0):
    frame = np.zeros(FRAME_LEN, dtype=np.uint8)
    frame[0], frame[1] = 0xFC, 0x1D

    def put_le(pos, v, n):
        v &= (1 << (8 * n)) - 1
        for i in range(n):
            frame[pos + i] = (v >> (8 * i)) & 0xFF

    put_le(POS_FRNR, frnr, 2)
    for pos, val in ((POS_P, P), (POS_T, T), (POS_U1, U1), (POS_U2, U2)):
        frame[pos:pos + 4] = f32_rd94_encode(val)
    put_le(POS_TOW, tow_ms, 4)
    put_le(POS_WEEK, week, 2)
    X = geodetic_to_ecef(lat, lon, alt)
    for k in range(3):
        put_le(POS_ECEF_X + 4 * k, int(round(X[k] * 100)), 4)
    V = hdv_to_ecef_vel(vH, vD, vU, lat, lon)
    for k in range(3):
        put_le(POS_ECEF_V1 + 4 * k, int(round(V[k] * 100)), 4)
    frame[POS_SATS1] = sats
    for i, b in enumerate(f32_rd94_encode(Ti)):
        frame[POS94_TI + i] = b
    put_le(POS94_BAT, int(round(bat * 1000)), 2)
    for i in range(4):
        frame[POS94_ID + i] = (sid >> (24 - 8 * i)) & 0xFF
    # checksums
    for pos, ln in ((POS_PCKFRM, 3), (POS_PCKPTU, 17), (POS_TOW, 47),
                    (POS_ECEF_V2 - 1, 18), (POS94_ID, 21)):
        chk = chksum16(frame[pos:pos + ln])
        frame[pos + ln] = (chk >> 8) & 0xFF
        frame[pos + ln + 1] = chk & 0xFF
    frame[118], frame[119] = 0x1A, 0xCF
    return frame


def frames_to_raw_bits(frames):
    """Frames -> raw Manchester2 8N1 stream.

    The stream per frame is [FC 1D][data][1A CF]: frame bytes 0..1 are the
    header tail and 118..119 the next frame's header start, so a leading
    [1A CF] completes the first sync and consecutive frames chain."""
    bits = [bit for byte in (0x1A, 0xCF) for bit in _byte_8n1_bits(byte)]
    for frame in frames:
        for b in frame:
            bits += _byte_8n1_bits(int(b))
    return np.array(_manchester2_encode(bits), dtype=np.uint8)
