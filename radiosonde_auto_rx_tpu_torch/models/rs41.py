"""Vaisala RS41 frame codec (4.8 kBd GFSK, 320/518-byte frames).

Frame structure, scrambler, ECC layout and telemetry semantics follow the
on-air protocol as documented by the reference decoder
(reference demod/mod/rs41mod.c): 64-bit header + LFSR XOR mask (:169-190),
[type|len|data|crc16] blocks at fixed positions (:322-401), two interleaved
RS(255,231) codewords over the descrambled frame (:1699-1735), PTU
calibration polynomial chain (:553-794), ECEF→geodetic conversion
(:1002-1096).  The implementation here is new: batch-friendly numpy frame
plane + a frame *encoder* used as the test fixture/ground truth.
"""

from dataclasses import dataclass, field
import datetime

import numpy as np

from radiosonde_auto_rx_tpu_torch.demod.framing import (
    bits_to_bytes_le, bytes_to_bits_le, find_frame_starts)
from radiosonde_auto_rx_tpu_torch.ecc.crc import crc16_ccitt
from radiosonde_auto_rx_tpu_torch.ecc.rs import RS255_231
from radiosonde_auto_rx_tpu_torch.models import register

# ---------------------------------------------------------------------------
# constants (rs41mod.c:165-195, 336-401)
# ---------------------------------------------------------------------------

HEADER_BITS = ("0000100001101101010100111000100001000100011010010100100000011111")
HEADER_BYTES = np.array([0x86, 0x35, 0xF4, 0x40, 0x93, 0xDF, 0x1A, 0x60],
                        dtype=np.uint8)  # descrambled
BAUD = 4800
NDATA_LEN = 320
XDATA_LEN = 198
FRAME_LEN = NDATA_LEN + XDATA_LEN   # 518
HEADLEN_BYTES = 8

# 64-byte LFSR scramble mask (rs41mod.c:175-182)
MASK = np.array([
    0x96, 0x83, 0x3E, 0x51, 0xB1, 0x49, 0x08, 0x98,
    0x32, 0x05, 0x59, 0x0E, 0xF9, 0x44, 0xC6, 0x26,
    0x21, 0x60, 0xC2, 0xEA, 0x79, 0x5D, 0x6D, 0xA1,
    0x54, 0x69, 0x47, 0x0C, 0xDC, 0xE8, 0x5C, 0xF1,
    0xF7, 0x76, 0x82, 0x7F, 0x07, 0x99, 0xA2, 0x2C,
    0x93, 0x7C, 0x30, 0x63, 0xF5, 0x10, 0x2E, 0x61,
    0xD0, 0xBC, 0xB4, 0xB6, 0x06, 0xAA, 0xF4, 0x23,
    0x78, 0x6E, 0x3B, 0xAE, 0xBF, 0x7B, 0x4C, 0xC1], dtype=np.uint8)

# block positions
POS_FRAME = 0x039
POS_FRAMENB = 0x03B
POS_SONDEID = 0x03D
POS_BATT = 0x045
POS_CALDATA = 0x052
POS_CALFREQ = 0x055
POS_CALBURST = 0x05E
POS_CALRSTYP = 0x05B
POS_CALRSTYP2 = 0x053
POS_CALRSM = 0x055
POS_PTU = 0x065
POS_GPS1 = 0x093
POS_GPSWEEK = 0x095
POS_GPSITOW = 0x097
POS_GPS2 = 0x0B5
POS_GPS3 = 0x112
POS_ECEFX = 0x114
POS_ECEFV = 0x120
POS_NUMSATS = 0x126
POS_AUX = 0x12B
POS_ZEROSTD = 0x12B

PCK_FRAME = 0x7928
PCK_PTU = 0x7A2A
PCK_GPS1 = 0x7C1E
PCK_GPS2 = 0x7D59
PCK_GPS3 = 0x7B15
PCK_SGM_XTU = 0x7F1B
PCK_SGM_CRYPT = 0x80A7
PCK_ZEROSTD = 0x7611

RS_R = 24   # RS(255,231)
RS_PARPOS = 8
RS_MSGPOS = 56


def descramble(frame: np.ndarray) -> np.ndarray:
    """XOR the 64-byte LFSR mask (involution; rs41mod.c:188-190)."""
    n = len(frame)
    reps = -(-n // 64)
    return (frame ^ np.tile(MASK, reps)[:n]).astype(np.uint8)


# ---------------------------------------------------------------------------
# ECC: two interleaved RS(255,231) codewords (rs41mod.c:1699-1762)
# ---------------------------------------------------------------------------

ERA_MAX = 12        # ECC3 erasure-search depth (rs41mod.c:1712)


def _frame_pos_to_cw(pos: int):
    """Frame byte position -> (codeword index, cw array position) or None
    (rs41mod.c:1867-1870 position mapping)."""
    if RS_PARPOS <= pos < RS_PARPOS + RS_R:
        return 0, pos - RS_PARPOS
    if RS_PARPOS + RS_R <= pos < RS_PARPOS + 2 * RS_R:
        return 1, pos - (RS_PARPOS + RS_R)
    if pos >= RS_MSGPOS:
        k = pos - RS_MSGPOS
        cwpos = RS_R + k // 2
        if cwpos < 255:
            return k % 2, cwpos
    return None


def _ecc3_search(cw_row, cand_cw_pos, cand_masks):
    """Soft-score erasure/bit-toggle list decode of one failing codeword
    (rs41mod.c 3rd pass :1848-1943): try pairs of erasures at the
    lowest-|score| byte positions, optionally toggling the weakest bit of
    a third low-score byte.  All (i, j, k) combinations are tried as ONE
    batched errors-and-erasures decode; the first success in the
    reference's search order wins.

    Returns (corrected_row, n_corrected) or None.
    """
    M = min(len(cand_cw_pos), ERA_MAX)
    combos = []
    for i in range(1, M):
        for j in range(i):
            combos.append((i, j, -1))
            for k in range(j):
                combos.append((i, j, k))
    if not combos:
        return None
    B = len(combos)
    cws = np.repeat(cw_row[None, :], B, axis=0)
    era = np.zeros((B, 2), dtype=np.int64)
    for b, (i, j, k) in enumerate(combos):
        era[b, 0] = cand_cw_pos[i]
        era[b, 1] = cand_cw_pos[j]
        if k >= 0:
            cws[b, cand_cw_pos[k]] ^= cand_masks[k]
    errs = RS255_231.decode(cws, era, np.full(B, 2, dtype=np.int64))
    ok = np.nonzero(errs >= 0)[0]
    if len(ok) == 0:
        return None
    b = int(ok[0])
    return cws[b], int(errs[b])


def rs41_ecc(frame: np.ndarray, frmlen: int, second_pass: bool = True,
             byte_scores=None, bit_toggle=None, fixed=None):
    """Correct the frame in place; returns (ec, frame).

    ec >= 0: total corrected symbols; ec < 0: -(cw1_bad | cw2_bad<<1).
    Codeword layout: reversed-index RS (cw[0] holds the highest-degree
    coefficient in the reference's convention — the reference treats
    cw[i] as coefficient of X^i with parity at low indices, which matches
    our RSCode convention directly).

    ``byte_scores`` ([FRAME_LEN] min-|soft| per byte) enables the ECC3
    erasure/bit-toggle search past the RS limit; ``bit_toggle``
    ([FRAME_LEN] uint8, mask of the weakest bit per byte) adds the
    bit-toggle dimension; ``fixed`` (bool mask) excludes positions
    already stuffed from history (ECC4, rs41mod.c inFixed :1680-1690).
    """
    full = np.zeros(FRAME_LEN, dtype=np.uint8)
    full[:min(frmlen, FRAME_LEN)] = frame[:min(frmlen, FRAME_LEN)]

    def build_cws(f):
        cw = np.zeros((2, 255), dtype=np.int64)
        cw[0, :RS_R] = f[RS_PARPOS:RS_PARPOS + RS_R]
        cw[1, :RS_R] = f[RS_PARPOS + RS_R:RS_PARPOS + 2 * RS_R]
        cw[0, RS_R:] = f[RS_MSGPOS + 0::2][:231]
        cw[1, RS_R:] = f[RS_MSGPOS + 1::2][:231]
        return cw

    cw = build_cws(full)
    errs = RS255_231.decode(cw)

    if second_pass and (errs[0] < 0 or errs[1] < 0):
        # stuff known packet IDs + zero padding and retry (rs41mod.c:1738-1762)
        f2 = full.copy()
        for pos, pck in ((POS_FRAME, PCK_FRAME), (POS_PTU, PCK_PTU),
                         (POS_GPS1, PCK_GPS1), (POS_GPS2, PCK_GPS2),
                         (POS_GPS3, PCK_GPS3)):
            f2[pos] = (pck >> 8) & 0xFF
            f2[pos + 1] = pck & 0xFF
        if frametype(full) >= -2:   # std frame: rebuild the ZERO pck
            f2[NDATA_LEN:] = 0
            f2[POS_ZEROSTD] = 0x76
            f2[POS_ZEROSTD + 1] = 0x11
            f2[POS_ZEROSTD + 2:NDATA_LEN - 2] = 0
            f2[NDATA_LEN - 2] = 0xEC
            f2[NDATA_LEN - 1] = 0xC7
        else:
            f2[NDATA_LEN + 7:FRAME_LEN - 2] = 0
        cw2 = build_cws(f2)
        cw2[:, :RS_R] = cw[:, :RS_R]  # parity unchanged
        errs2 = RS255_231.decode(cw2)
        for i in range(2):
            if errs[i] < 0 and errs2[i] >= 0:
                cw[i] = cw2[i]
                errs[i] = errs2[i]
            elif errs[i] < 0:
                # keep the stuffed codeword as the ECC3 starting point
                # (the reference's 3rd pass operates on the post-pass2
                # cw arrays, rs41mod.c:1848+)
                cw[i] = cw2[i]

    if byte_scores is not None and (errs[0] < 0 or errs[1] < 0):
        # ECC3: per-byte soft scores -> erasure candidates
        # (score preparation rs41mod.c print_frame :2490-2500)
        flen = NDATA_LEN if frametype(full) >= 0 else FRAME_LEN
        scores = np.asarray(byte_scores, dtype=np.float64).copy()
        scores.resize(FRAME_LEN)
        mx = np.floor(np.abs(scores[HEADLEN_BYTES:flen]).max() + 1.5)
        scores[:HEADLEN_BYTES] = mx * 2.0
        scores[flen:] = mx
        masks = (np.asarray(bit_toggle, dtype=np.uint8).copy()
                 if bit_toggle is not None
                 else np.zeros(FRAME_LEN, np.uint8))
        masks.resize(FRAME_LEN)
        order = np.argsort(np.abs(scores), kind="stable")
        for i in range(2):
            if errs[i] >= 0:
                continue
            cand_pos, cand_masks = [], []
            for p in order:
                if fixed is not None and fixed[int(p)]:
                    continue
                m = _frame_pos_to_cw(int(p))
                if m is None or m[0] != i:
                    continue
                cand_pos.append(m[1])
                cand_masks.append(int(masks[int(p)]))
                if len(cand_pos) >= ERA_MAX:
                    break
            res = _ecc3_search(cw[i], cand_pos, cand_masks)
            if res is not None:
                cw[i], errs[i] = res[0], res[1]

    # write back
    full[RS_PARPOS:RS_PARPOS + RS_R] = cw[0, :RS_R]
    full[RS_PARPOS + RS_R:RS_PARPOS + 2 * RS_R] = cw[1, :RS_R]
    full[RS_MSGPOS + 0::2] = cw[0, RS_R:RS_R + 231]
    full[RS_MSGPOS + 1::2] = cw[1, RS_R:RS_R + 231]

    if errs[0] >= 0 and errs[1] >= 0:
        ec = int(errs[0] + errs[1])
    else:
        ec = -(int(errs[0] < 0) | (int(errs[1] < 0) << 1))
    return ec, full


def frametype(frame: np.ndarray) -> int:
    """+4 => std 320-byte frame, -4 => aux 518 (rs41mod.c:403-415)."""
    b = int(frame[POS_FRAME - 1])
    return sum(((b >> i) & 1) - ((b >> (i + 4)) & 1) for i in range(4))


def check_crc(frame: np.ndarray, pos: int, pck: int) -> bool:
    if ((pck >> 8) & 0xFF) != frame[pos]:
        return False
    crclen = int(frame[pos + 1])
    if pos + crclen + 4 > FRAME_LEN:
        return False
    dat = int(frame[pos + 2 + crclen]) | (int(frame[pos + 3 + crclen]) << 8)
    return dat == int(crc16_ccitt(frame[pos + 2:pos + 2 + crclen]))


# ---------------------------------------------------------------------------
# geodesy (rs41mod.c:1002-1096)
# ---------------------------------------------------------------------------

EARTH_A = 6378137.0
EARTH_B = 6356752.31424518
_E2 = (EARTH_A**2 - EARTH_B**2) / EARTH_A**2
_EE2 = (EARTH_A**2 - EARTH_B**2) / EARTH_B**2


def ecef_to_geodetic(x, y, z):
    lam = np.arctan2(y, x)
    p = np.sqrt(x * x + y * y)
    t = np.arctan2(z * EARTH_A, p * EARTH_B)
    phi = np.arctan2(z + _EE2 * EARTH_B * np.sin(t) ** 3,
                     p - _E2 * EARTH_A * np.cos(t) ** 3)
    R = EARTH_A / np.sqrt(1 - _E2 * np.sin(phi) ** 2)
    alt = p / np.cos(phi) - R
    return np.degrees(phi), np.degrees(lam), alt


def geodetic_to_ecef(lat_deg, lon_deg, alt):
    """Inverse (encoder fixture)."""
    phi, lam = np.radians(lat_deg), np.radians(lon_deg)
    N = EARTH_A / np.sqrt(1 - _E2 * np.sin(phi) ** 2)
    x = (N + alt) * np.cos(phi) * np.cos(lam)
    y = (N + alt) * np.cos(phi) * np.sin(lam)
    z = (N * (1 - _E2) + alt) * np.sin(phi)
    return x, y, z


def ecef_vel_to_hdv(vx, vy, vz, lat_deg, lon_deg):
    phi, lam = np.radians(lat_deg), np.radians(lon_deg)
    vN = -vx * np.sin(phi) * np.cos(lam) - vy * np.sin(phi) * np.sin(lam) \
        + vz * np.cos(phi)
    vE = -vx * np.sin(lam) + vy * np.cos(lam)
    vU = vx * np.cos(phi) * np.cos(lam) + vy * np.cos(phi) * np.sin(lam) \
        + vz * np.sin(phi)
    vH = np.hypot(vN, vE)
    vD = np.degrees(np.arctan2(vE, vN)) % 360.0
    return vH, vD, vU


def hdv_to_ecef_vel(vH, vD, vU, lat_deg, lon_deg):
    phi, lam = np.radians(lat_deg), np.radians(lon_deg)
    vN = vH * np.cos(np.radians(vD))
    vE = vH * np.sin(np.radians(vD))
    vx = -vN * np.sin(phi) * np.cos(lam) - vE * np.sin(lam) \
        + vU * np.cos(phi) * np.cos(lam)
    vy = -vN * np.sin(phi) * np.sin(lam) + vE * np.cos(lam) \
        + vU * np.cos(phi) * np.sin(lam)
    vz = vN * np.cos(phi) + vU * np.sin(phi)
    return vx, vy, vz


def gps_week_tow_to_datetime(week: int, tow_ms: int) -> datetime.datetime:
    """GPS epoch 1980-01-06; no leap seconds (rs41mod.c:204-221 Gps2Date)."""
    epoch = datetime.datetime(1980, 1, 6, tzinfo=datetime.timezone.utc)
    return epoch + datetime.timedelta(weeks=week, milliseconds=tow_ms)


# ---------------------------------------------------------------------------
# PTU calibration chain (rs41mod.c:553-794)
# ---------------------------------------------------------------------------

def _f32(cal: np.ndarray, off: int) -> float:
    return float(np.frombuffer(cal[off:off + 4].tobytes(), "<f4")[0])


@dataclass
class RS41Cal:
    """Calibration constants unpacked from the 51x16-byte subframe store."""
    rf1: float = 0.0
    rf2: float = 0.0
    co1: tuple = (0.0,) * 3
    calT1: tuple = (0.0,) * 3
    calH: tuple = (0.0,) * 2
    co2: tuple = (0.0,) * 3
    calT2: tuple = (0.0,) * 3
    cf1: float = 0.0
    cf2: float = 0.0
    mtxH: tuple = (0.0,) * 42
    corHp: tuple = (0.0,) * 3
    corHt: tuple = (0.0,) * 12
    calP: tuple = (0.0,) * 25

    @classmethod
    def from_calibytes(cls, cal: np.ndarray) -> "RS41Cal":
        g = lambda off, n: tuple(_f32(cal, off + 4 * j) for j in range(n))
        calP = [0.0] * 25
        order = [0, 4, 8, 12, 16, 20, 24, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11]
        for j, k in enumerate(order):
            calP[k] = _f32(cal, 606 + 4 * j)
        return cls(
            rf1=_f32(cal, 61), rf2=_f32(cal, 65),
            co1=g(77, 3), calT1=g(89, 3), calH=g(117, 2),
            co2=g(293, 3), calT2=g(305, 3),
            cf1=_f32(cal, 69), cf2=_f32(cal, 73),
            mtxH=g(125, 42), corHp=g(678, 3), corHt=g(698, 12),
            calP=tuple(calP),
        )


def ptu_temperature(cal: RS41Cal, f, f1, f2, co, calT) -> float:
    """Platinum-resistor temperature (rs41mod.c get_T :620-629)."""
    if f2 == f1:
        return -273.15
    g = float(f2 - f1) / (cal.rf2 - cal.rf1)
    rb = (f1 * cal.rf2 - f2 * cal.rf1) / float(f2 - f1)
    rc = f / g - rb
    r = rc * calT[0]
    return (co[0] + co[1] * r + co[2] * r * r + calT[1]) * (1.0 + calT[2])


def ptu_rh_empirical(cal: RS41Cal, f, f1, f2, T) -> float:
    """Empirical capacitive RH (rs41mod.c get_RHemp :635-648)."""
    a0 = 7.5
    a1 = 350.0 / cal.calH[0]
    fh = (f - f1) / float(f2 - f1)
    rh = 100.0 * (a1 * fh - a0)
    rh += 0.0 - T / 5.5
    if T < -20.0:
        rh *= 1.0 + (-20.0 - T) / 100.0
    if T < -40.0:
        rh *= 1.0 + (-40.0 - T) / 120.0
    rh = min(max(rh, 0.0), 100.0)
    if T < -273.0:
        rh = -1.0
    return rh


def vapor_sat_p(tc: float) -> float:
    """Hyland-Wexler saturation pressure (rs41mod.c:654-670)."""
    T = tc + 273.15
    return float(np.exp(-5800.2206 / T + 1.3914993 + 6.5459673 * np.log(T)
                        - 4.8640239e-2 * T + 4.1764768e-5 * T * T
                        - 1.4452093e-8 * T ** 3))


def ptu_rh2_advanced(cal: RS41Cal, f, f1, f2, T, TH, P) -> float:
    """Matrix-calibrated RH (rs41mod.c get_RH2adv :672-730)."""
    cfh = (f - f1) / float(f2 - f1)
    cap = cal.cf1 + (cal.cf2 - cal.cf1) * cfh
    Cp = (cap / cal.calH[0] - 1.0) * cal.calH[1]
    Trh = (TH - 20.0) / 180.0
    b = [Trh ** k for k in range(6)]
    if P > 0.0:
        _p = P / 1000.0
        bp = [cal.corHp[j] * (_p / (1.0 + cal.corHp[j] * _p)
                              - Cp ** j / (1.0 + cal.corHp[j]))
              for j in range(3)]
        corr = sum(bp[j] * sum(cal.corHt[4 * j + k] * b[k] for k in range(4))
                   for j in range(3))
        Cp -= corr
    rh = 0.0
    aj = 1.0
    for j in range(7):
        for k in range(6):
            rh += aj * b[k] * cal.mtxH[6 * j + k]
        aj *= Cp
    if P <= 0.0 and T < -40.0:
        rh += (T + 40.0) / 12.0
    rh = rh * vapor_sat_p(TH) / vapor_sat_p(T)
    return min(max(rh, 0.0), 100.0)


def ptu_pressure(cal: RS41Cal, f, f1, f2, fx) -> float:
    """Pressure polynomial (rs41mod.c get_P :733-753)."""
    if f1 == f2 or f1 == f:
        return 0.0
    a0 = cal.calP[24] / ((f - f1) / float(f2 - f1))
    a1 = fx * 0.01
    p = 0.0
    a0j = 1.0
    for j in range(6):
        a1k = 1.0
        for k in range(4):
            p += a0j * a1k * cal.calP[j * 4 + k]
            a1k *= a1
        a0j *= a0
    return p


def pressure_from_altitude(h: float) -> float:
    """Barometric fallback (rs41mod.c Ph :757-794)."""
    gMR = 9.80665 * 0.0289644 / 8.31446
    if h > 32000.0:
        Pb, Tb, Lb, hb = 8.6802, 228.65, 0.0028, 32000.0
    elif h > 20000.0:
        Pb, Tb, Lb, hb = 54.7489, 216.65, 0.001, 20000.0
    elif h > 11000.0:
        Pb, Tb, Lb, hb = 226.321, 216.65, 0.0, 11000.0
    else:
        Pb, Tb, Lb, hb = 1013.25, 288.15, -0.0065, 0.0
    if Lb == 0.0:
        return Pb * np.exp(-gMR * (h - hb) / Tb)
    return Pb * (1.0 + Lb * (h - hb) / Tb) ** (-gMR / Lb)


# ---------------------------------------------------------------------------
# stateful decoder
# ---------------------------------------------------------------------------

@register("RS41")
class RS41Decoder:
    """Per-sonde RS41 decoder state (the reference's gpx_t)."""

    TYPE = "RS41"
    HEADER = HEADER_BITS
    FRAME_BITS = FRAME_LEN * 8

    def __init__(self, ptu_mode: int = 2, jsn_freq_khz: int = 0,
                 emit_subframe: bool = True):
        self.id = None
        self.calibytes = np.zeros(51 * 16, dtype=np.uint8)
        self.calfrchk = np.zeros(51, dtype=bool)
        self.rstyp = ""
        self.rstmp = [""] * 9
        self.rsm = ""
        self.conf_fw = 0
        self.conf_bk = 0
        self.conf_kt = -1
        self.conf_bt = 0
        self.conf_cd = -1
        self.freq_khz = 0
        self.ptu_mode = ptu_mode
        self.jsn_freq_khz = jsn_freq_khz
        self.emit_subframe = emit_subframe
        self.calconf_complete = False
        self.calconf_sent = False
        # ECC4 frame-number history
        self.last_frnr = 0
        self._since_good = 0

    # -- state reset on new sonde (rs41mod.c get_SondeID :457-507) --
    def _new_sonde(self, sid: str):
        self.id = sid
        self.calibytes[:] = 0
        self.calfrchk[:] = False
        self.rstyp = ""
        self.rsm = ""
        self.conf_fw = 0
        self.conf_bt = 0
        self.conf_bk = 0
        self.conf_cd = -1
        self.conf_kt = -1
        self.freq_khz = 0
        self.calconf_complete = False
        self.calconf_sent = False
        self.last_frnr = 0          # history invalid for a new sonde
        self._since_good = 0

    def decode_bits(self, bits: np.ndarray, soft=None):
        """Find frames in a hard-bit stream and decode each.

        bits: stream of 0/1 following the RS41 convention (high tone = 1).
        ``soft``: optional per-bit soft values aligned with ``bits``;
        enables the ECC3 byte-score erasure search (the min-|soft| per
        byte is the byte score, rs41mod.c:2939-2958).
        Returns a list of telemetry dicts.
        """
        out = []
        starts = find_frame_starts(bits, HEADER_BITS, max_errors=3)
        for s in starts:
            self._since_good += 1
            nbits = (FRAME_LEN - HEADLEN_BYTES) * 8
            chunk = bits[s:s + nbits]
            payload = bits_to_bytes_le(chunk)
            frame = np.zeros(FRAME_LEN, dtype=np.uint8)
            frame[:HEADLEN_BYTES] = HEADER_BYTES
            n = min(len(payload), FRAME_LEN - HEADLEN_BYTES)
            xframe = descramble(
                np.concatenate([np.zeros(HEADLEN_BYTES, np.uint8), payload]))
            frame[HEADLEN_BYTES:HEADLEN_BYTES + n] = \
                xframe[HEADLEN_BYTES:HEADLEN_BYTES + n]
            scores = toggles = None
            if soft is not None:
                sc = np.abs(np.asarray(soft[s:s + nbits], dtype=np.float64))
                n8 = (len(sc) // 8) * 8
                scb = sc[:n8].reshape(-1, 8)
                scores = np.zeros(HEADLEN_BYTES + len(scb))
                scores[HEADLEN_BYTES:] = scb.min(axis=1)
                toggles = np.zeros(HEADLEN_BYTES + len(scb), np.uint8)
                toggles[HEADLEN_BYTES:] = (1 << scb.argmin(axis=1)
                                           ).astype(np.uint8)
            telem = self.decode_frame(frame, HEADLEN_BYTES + n,
                                      byte_scores=scores,
                                      bit_toggle=toggles)
            if telem is not None:
                out.append(telem)
        return out

    def _stuff_known_bytes(self, frame):
        """ECC4 speculative known-byte stuffing (rs41mod.c:1764-1845):
        when the FRAME-block CRC fails, overwrite SondeID / cal bytes /
        frame number from decoder history before retrying the RS decode.
        Returns (stuffed_frame, fixed_mask)."""
        f = frame.copy()
        fixed = np.zeros(FRAME_LEN, dtype=bool)
        if check_crc(f, POS_FRAME, PCK_FRAME):
            return f, fixed
        if self.id and bytes(f[POS_SONDEID:POS_SONDEID + 8]) != \
                self.id.encode()[:8]:
            f[POS_SONDEID:POS_SONDEID + 8] = np.frombuffer(
                self.id.encode()[:8].ljust(8), dtype=np.uint8)
            fixed[POS_SONDEID:POS_SONDEID + 8] = True
        if not check_crc(f, POS_FRAME, PCK_FRAME):
            calfr = int(f[POS_CALDATA])
            if calfr < 51 and self.calfrchk[calfr]:
                f[POS_CALDATA + 1:POS_CALDATA + 17] = \
                    self.calibytes[calfr * 16:calfr * 16 + 16]
                fixed[POS_CALDATA + 1:POS_CALDATA + 17] = True
        if not check_crc(f, POS_FRAME, PCK_FRAME) and self.last_frnr:
            pred = self.last_frnr + self._since_good
            if ((pred >> 8) & 0xFF) != int(f[POS_FRAMENB + 1]):
                f[POS_FRAMENB + 1] = (pred >> 8) & 0xFF
                fixed[POS_FRAMENB + 1] = True
            if (pred & 0xFF) != int(f[POS_FRAMENB]):
                f[POS_FRAMENB] = pred & 0xFF
                fixed[POS_FRAMENB] = True
        return f, fixed

    def decode_frame(self, frame: np.ndarray, frmlen: int = FRAME_LEN,
                     byte_scores=None, bit_toggle=None):
        """Decode one descrambled frame -> telemetry dict or None."""
        ft = frametype(frame)
        flen = NDATA_LEN if ft >= 0 else FRAME_LEN
        orig = frame.copy()
        ec, frame = rs41_ecc(frame, min(frmlen, flen))
        if ec < 0 and byte_scores is not None:
            # ECC4 known-byte stuffing from history, then the ECC3
            # erasure/bit-toggle search (rs41mod.c:1764-1943)
            stuffed, fixed = self._stuff_known_bytes(orig)
            ec, frame = rs41_ecc(stuffed, min(frmlen, flen),
                                 byte_scores=byte_scores,
                                 bit_toggle=bit_toggle, fixed=fixed)
        if ec < 0:
            return None

        telem = {"type": "RS41", "subtype": "RS41"}
        crc_ok = {}

        # walk [type|len|data|crc] blocks (rs41mod.c print_position :2167-2291)
        pos = POS_FRAME
        encrypted = False
        ofs_cal = 0
        xdata = []
        err_frame = err_gps1 = err_gps3 = True
        while pos < flen - 1:
            blk = int(frame[pos])
            ln = int(frame[pos + 1])
            pck = (blk << 8) | ln
            if not check_crc(frame, pos, blk << 8):
                return None
            if pck == PCK_FRAME:
                err_frame = not self._get_frameconf(frame, pos - POS_FRAME,
                                                    telem)
                ofs_cal = pos - POS_FRAME
            elif pck == PCK_PTU or pck == PCK_SGM_XTU:
                crc_ok["ptu"] = (pos, pck)
            elif pck == PCK_GPS1:
                err_gps1 = not self._get_gps1(frame, pos - POS_GPS1, telem)
            elif pck == PCK_GPS2:
                pass  # raw sat data (pseudoranges); not used for position
            elif pck == PCK_GPS3:
                err_gps3 = not self._get_gps3(frame, pos - POS_GPS3, telem)
            elif pck == PCK_SGM_CRYPT:
                encrypted = True
            elif blk == 0x7E:
                s = bytes(frame[pos + 2 + 1:pos + 2 + ln]).decode(
                    "ascii", "ignore")
                xdata.append("".join(c for c in s if 0x1E < ord(c) < 0x7F))
            pos += 2 + ln + 2

        if "ptu" in crc_ok and not encrypted:
            ppos, ppck = crc_ok["ptu"]
            self._get_ptu(frame, ppos - POS_PTU, telem,
                          valid_alt=not err_gps3)
        self._get_calconf(frame, ofs_cal)

        if encrypted:
            telem["subtype"] = "RS41-SGM"
            telem["encrypted"] = True
        elif self.rstyp:
            telem["subtype"] = self.rstyp
            if self.rstyp.startswith("RS41-SGM"):
                telem["encrypted"] = False

        ok = (not err_frame) and ((not err_gps1 and not err_gps3) or encrypted)
        if not ok:
            return None

        telem["bt"] = self.conf_cd & 0xFFFF  # ui16 like the reference
        if self.freq_khz > 0:
            telem["tx_frequency"] = self.freq_khz
        if self.rsm:
            telem["rs41_mainboard"] = self.rsm
        if self.conf_fw:
            telem["rs41_mainboard_fw"] = self.conf_fw
        if xdata:
            telem["aux"] = "#".join(xdata)
        if self.emit_subframe:
            if self.calconf_complete and not self.calconf_sent:
                telem["rs41_calconf51x16"] = bytes(
                    self.calibytes).hex().upper()
                self.calconf_sent = True
            sub = frame[POS_CALDATA + ofs_cal:POS_CALDATA + ofs_cal + 17]
            if sub[0] == 0x32:
                telem["rs41_conf0x32"] = bytes(sub[1:17]).hex().upper()
        telem["ref_datetime"] = "GPS"
        telem["ref_position"] = "GPS"
        telem["ecc"] = ec
        return telem

    # -- block parsers --

    def _get_frameconf(self, frame, ofs, telem) -> bool:
        if not check_crc(frame, POS_FRAME + ofs, PCK_FRAME):
            return False
        sid = bytes(frame[POS_SONDEID + ofs:POS_SONDEID + ofs + 8]).decode(
            "ascii", "replace")
        if sid != self.id:
            self._new_sonde(sid)
        telem["id"] = sid
        telem["frame"] = int(frame[POS_FRAMENB + ofs]) | (
            int(frame[POS_FRAMENB + ofs + 1]) << 8)
        # ECC4 history: last good frame number (rs41mod.c:433-434)
        self.last_frnr = telem["frame"]
        self._since_good = 0
        telem["batt"] = round(int(frame[POS_BATT + ofs]) / 10.0, 2)
        calfr = int(frame[POS_CALDATA + ofs])
        if calfr < 51 and not self.calfrchk[calfr]:
            self.calibytes[calfr * 16:calfr * 16 + 16] = \
                frame[POS_CALDATA + ofs + 1:POS_CALDATA + ofs + 17]
            self.calfrchk[calfr] = True
        if not self.calconf_complete and self.calfrchk.all():
            dat = int(self.calibytes[0]) | (int(self.calibytes[1]) << 8)
            if dat == int(crc16_ccitt(self.calibytes[2:50 * 16])):
                self.calconf_complete = True
        return True

    def _get_gps1(self, frame, ofs, telem) -> bool:
        if not check_crc(frame, POS_GPS1 + ofs, PCK_GPS1):
            return False
        week = int(frame[POS_GPSWEEK + ofs]) | (
            int(frame[POS_GPSWEEK + ofs + 1]) << 8)
        tow = int.from_bytes(
            bytes(frame[POS_GPSITOW + ofs:POS_GPSITOW + ofs + 4]), "little")
        dt = gps_week_tow_to_datetime(week, tow)
        telem["datetime"] = dt.strftime("%Y-%m-%dT%H:%M:%S.") + \
            f"{dt.microsecond // 1000:03d}Z"
        telem["datetime_dt"] = dt
        return True

    def _get_gps3(self, frame, ofs, telem) -> bool:
        if not check_crc(frame, POS_GPS3 + ofs, PCK_GPS3):
            return False
        p = POS_ECEFX + ofs
        xyz = [int.from_bytes(bytes(frame[p + 4 * k:p + 4 * k + 4]),
                              "little", signed=True) / 100.0
               for k in range(3)]
        vel = [int.from_bytes(
            bytes(frame[POS_ECEFV + ofs + 2 * k:POS_ECEFV + ofs + 2 * k + 2]),
            "little", signed=True) / 100.0 for k in range(3)]
        lat, lon, alt = ecef_to_geodetic(*xyz)
        if alt < -1000 or alt > 80000:
            return False
        vH, vD, vV = ecef_vel_to_hdv(*vel, lat, lon)
        telem.update(lat=round(float(lat), 5), lon=round(float(lon), 5),
                     alt=round(float(alt), 5), vel_h=round(float(vH), 5),
                     heading=round(float(vD), 5), vel_v=round(float(vV), 5),
                     sats=int(frame[POS_NUMSATS + ofs]))
        return True

    def _get_ptu(self, frame, ofs, telem, valid_alt: bool):
        if not check_crc(frame, POS_PTU + ofs, PCK_PTU):
            return
        cal = RS41Cal.from_calibytes(self.calibytes)
        meas = [int.from_bytes(
            bytes(frame[POS_PTU + ofs + 2 + 3 * i:POS_PTU + ofs + 5 + 3 * i]),
            "little") for i in range(12)]
        chk = self.calfrchk
        bR = chk[0x03] and chk[0x04]
        bc1 = chk[0x04] and chk[0x05]
        bT1 = chk[0x05] and chk[0x06]
        bc2 = chk[0x12] and chk[0x13]
        bT2 = chk[0x13]
        bH = chk[0x07]
        bH2 = all(chk[i] for i in list(range(0x07, 0x13)) +
                  [0x2A, 0x2B, 0x2C, 0x2D, 0x2E])
        bP = (chk[0x21] and self.calibytes[0x21F] == ord("P") and
              all(chk[i] for i in (0x25, 0x26, 0x27, 0x28, 0x29, 0x2A)))

        Tc = TH = -273.15
        RH = RH2 = P = -1.0
        if bR and bc1 and bT1:
            Tc = ptu_temperature(cal, meas[0], meas[1], meas[2],
                                 cal.co1, cal.calT1)
        if bR and bc2 and bT2:
            TH = ptu_temperature(cal, meas[6], meas[7], meas[8],
                                 cal.co2, cal.calT2)
        if bH and Tc > -273.0:
            RH = ptu_rh_empirical(cal, meas[3], meas[4], meas[5], Tc)
        if bP:
            fx = int.from_bytes(
                bytes(frame[POS_PTU + ofs + 2 + 38:POS_PTU + ofs + 2 + 40]),
                "little", signed=True)
            P = ptu_pressure(cal, meas[9], meas[10], meas[11], fx)
        if self.ptu_mode == 2:
            _P = P if bP else (
                pressure_from_altitude(telem.get("alt", 0.0))
                if valid_alt else -1.0)
            if bH and bH2 and Tc > -273.0 and TH > -273.0:
                RH2 = ptu_rh2_advanced(cal, meas[3], meas[4], meas[5],
                                       Tc, TH, _P)
            RH_out = RH2
        else:
            RH_out = RH
        if Tc > -273.0:
            telem["temp"] = round(Tc, 1)
        if RH_out > -0.5:
            telem["humidity"] = round(RH_out, 1)
        if P > 0.0:
            telem["pressure"] = round(P, 2)

    def _get_calconf(self, frame, ofs):
        """Config values from cal subframes (rs41mod.c get_Calconf :1551)."""
        if not check_crc(frame, POS_FRAME + ofs, PCK_FRAME):
            return
        calfr = int(frame[POS_CALDATA + ofs])
        d = frame[POS_CALDATA + ofs:POS_CALDATA + ofs + 17]
        if calfr == 0x00:
            f0 = ((int(frame[POS_CALFREQ + ofs]) & 0xC0) * 10) // 64
            f1 = 40 * int(frame[POS_CALFREQ + ofs + 1])
            self.freq_khz = 400000 + f1 + f0
        elif calfr == 0x01:
            self.conf_fw = int(d[6]) | (int(d[7]) << 8)
        elif calfr == 0x02:
            self.conf_bk = int(frame[POS_CALBURST + ofs])
            self.conf_kt = int(d[8]) | (int(d[9]) << 8)
        elif calfr == 0x31:
            self.conf_bt = int(d[7]) | (int(d[8]) << 8)
        elif calfr == 0x32:
            self.conf_cd = int(d[1]) | (int(d[2]) << 8)
        elif calfr == 0x21:
            chars = frame[POS_CALRSTYP + ofs:POS_CALRSTYP + ofs + 8]
            self.rstmp = [chr(c) if 0x20 <= c < 0x7F else "" for c in chars]
        elif calfr == 0x22:
            c9 = int(frame[POS_CALRSTYP2 + ofs])
            s = "".join(self.rstmp)
            if 0x20 <= c9 < 0x7F:
                s += chr(c9)
            self.rstyp = s
            rsm = frame[POS_CALRSM + ofs:POS_CALRSM + ofs + 8]
            self.rsm = "".join(
                chr(c) for c in rsm if 0x20 <= c < 0x7F)


# ---------------------------------------------------------------------------
# encoder (test fixture / ground-truth generator)
# ---------------------------------------------------------------------------

def _put_block(frame, pos, pck, data):
    ln = len(data)
    assert ln == (pck & 0xFF), (hex(pck), ln)
    frame[pos] = (pck >> 8) & 0xFF
    frame[pos + 1] = pck & 0xFF
    frame[pos + 2:pos + 2 + ln] = data
    c = int(crc16_ccitt(np.asarray(data, dtype=np.uint8)))
    frame[pos + 2 + ln] = c & 0xFF
    frame[pos + 3 + ln] = (c >> 8) & 0xFF


def make_calibytes(tx_freq_khz: int = 402500, rstyp: str = "RS41-SGP",
                   fw: int = 0x5212) -> np.ndarray:
    """51x16-byte cal store with plausible PTU coefficients."""
    cal = np.zeros(51 * 16, dtype=np.uint8)

    def put32(off, v):
        cal[off:off + 4] = np.frombuffer(
            np.float32(v).tobytes(), dtype=np.uint8)

    put32(61, 750.0)     # Rf1
    put32(65, 1100.0)    # Rf2
    for j, v in enumerate((-243.911, 0.187654, 8.2e-06)):   # co1
        put32(77 + 4 * j, v)
    for j, v in enumerate((1.0302, 0.0, 0.0)):              # calT1
        put32(89 + 4 * j, v)
    for j, v in enumerate((45.0, 5.0)):                     # calH
        put32(117 + 4 * j, v)
    for j, v in enumerate((-243.911, 0.187654, 8.2e-06)):   # co2
        put32(293 + 4 * j, v)
    for j, v in enumerate((1.0301, 0.0, 0.0)):              # calT2
        put32(305 + 4 * j, v)
    # subframe 0x00: tx frequency (get_Calconf calfr 0x00);
    # subframe data bytes live at frame[pos_CalData+1 ...] = frame[0x053...],
    # so in-subframe offset of frame position p is (p - 0x053).
    df = tx_freq_khz - 400000
    b1 = df // 40
    b0 = ((df - 40 * b1) * 64) // 10
    cal[0x00 * 16 + (0x055 - 0x053)] = b0 & 0xC0
    cal[0x00 * 16 + (0x056 - 0x053)] = b1 & 0xFF
    # subframe 0x01: fw
    cal[0x01 * 16 + 6] = fw & 0xFF
    cal[0x01 * 16 + 7] = (fw >> 8) & 0xFF
    # subframes 0x21/0x22: RS type + mainboard
    rt = rstyp.encode().ljust(8, b"\x00")[:8]
    cal[0x21 * 16 + (0x05B - 0x053):0x21 * 16 + (0x05B - 0x053) + 8] = \
        np.frombuffer(rt, dtype=np.uint8)
    if len(rstyp) > 8:
        cal[0x22 * 16 + (0x053 - 0x053)] = ord(rstyp[8])
    rsm = b"RSM412".ljust(8, b"\x00")
    cal[0x22 * 16 + (0x055 - 0x053):0x22 * 16 + (0x055 - 0x053) + 8] = \
        np.frombuffer(rsm, dtype=np.uint8)
    # store crc so calconf_complete can pass (rs41mod.c:536-546)
    c = int(crc16_ccitt(cal[2:50 * 16]))
    cal[0] = c & 0xFF
    cal[1] = (c >> 8) & 0xFF
    return cal


def encode_frame(frame_nb: int, sonde_id: str, week: int, tow_ms: int,
                 lat: float, lon: float, alt: float,
                 vH: float = 5.0, vD: float = 90.0, vV: float = 3.0,
                 batt: float = 2.9, numSV: int = 9,
                 calibytes: np.ndarray | None = None, calfr: int = 0,
                 ptu_meas: list | None = None) -> np.ndarray:
    """Build a valid descrambled 320-byte std frame."""
    frame = np.zeros(FRAME_LEN, dtype=np.uint8)
    frame[:8] = HEADER_BYTES
    frame[POS_FRAME - 1] = 0x0F   # std frame marker

    if calibytes is None:
        calibytes = make_calibytes()

    # FRAME block (0x7928, len 0x28)
    d = np.zeros(0x28, dtype=np.uint8)
    d[0] = frame_nb & 0xFF
    d[1] = (frame_nb >> 8) & 0xFF
    d[2:10] = np.frombuffer(sonde_id.encode().ljust(8)[:8], dtype=np.uint8)
    d[POS_BATT - POS_FRAMENB] = int(round(batt * 10))
    d[POS_CALDATA - POS_FRAMENB] = calfr
    d[POS_CALDATA - POS_FRAMENB + 1:POS_CALDATA - POS_FRAMENB + 17] = \
        calibytes[calfr * 16:calfr * 16 + 16]
    _put_block(frame, POS_FRAME, PCK_FRAME, d)

    # PTU block (0x7A2A, len 0x2A): 12 x u24 meas + trailing bytes
    d = np.zeros(0x2A, dtype=np.uint8)
    meas = ptu_meas or [0] * 12
    for i, v in enumerate(meas):
        d[3 * i:3 * i + 3] = np.frombuffer(
            int(v).to_bytes(3, "little"), dtype=np.uint8)
    _put_block(frame, POS_PTU, PCK_PTU, d)

    # GPS1 (0x7C1E, len 0x1E): week, iTOW, 12x2 sat quality
    d = np.zeros(0x1E, dtype=np.uint8)
    d[0:2] = np.frombuffer(int(week).to_bytes(2, "little"), dtype=np.uint8)
    d[2:6] = np.frombuffer(int(tow_ms).to_bytes(4, "little"), dtype=np.uint8)
    d[6::2] = 0xFF   # no sat info
    _put_block(frame, POS_GPS1, PCK_GPS1, d)

    # GPS2 (0x7D59, len 0x59): pseudoranges; zero-fill
    d = np.zeros(0x59, dtype=np.uint8)
    _put_block(frame, POS_GPS2, PCK_GPS2, d)

    # GPS3 (0x7B15, len 0x15): ECEF pos cm, vel cm/s, numSV, sAcc, pDOP
    x, y, z = geodetic_to_ecef(lat, lon, alt)
    vx, vy, vz = hdv_to_ecef_vel(vH, vD, vV, lat, lon)
    d = np.zeros(0x15, dtype=np.uint8)
    for k, v in enumerate((x, y, z)):
        d[4 * k:4 * k + 4] = np.frombuffer(
            int(round(v * 100)).to_bytes(4, "little", signed=True),
            dtype=np.uint8)
    for k, v in enumerate((vx, vy, vz)):
        d[12 + 2 * k:14 + 2 * k] = np.frombuffer(
            int(round(v * 100)).to_bytes(2, "little", signed=True),
            dtype=np.uint8)
    d[18] = numSV
    d[19] = 30   # sAcc
    d[20] = 15   # pDOP
    _put_block(frame, POS_GPS3, PCK_GPS3, d)

    # ZERO pck (0x7611, len 0x11)
    _put_block(frame, POS_ZEROSTD, PCK_ZEROSTD, np.zeros(0x11, np.uint8))

    # RS parity over both interleaved codewords
    cw = np.zeros((2, 255), dtype=np.int64)
    cw[0, RS_R:] = frame[RS_MSGPOS + 0::2][:231]
    cw[1, RS_R:] = frame[RS_MSGPOS + 1::2][:231]
    enc0 = RS255_231.encode(cw[0, RS_R:])
    enc1 = RS255_231.encode(cw[1, RS_R:])
    frame[RS_PARPOS:RS_PARPOS + RS_R] = enc0[:RS_R]
    frame[RS_PARPOS + RS_R:RS_PARPOS + 2 * RS_R] = enc1[:RS_R]
    return frame[:NDATA_LEN]


def frame_to_bits(frame: np.ndarray) -> np.ndarray:
    """Descrambled frame -> on-air bit stream (scramble + LSB-first)."""
    xframe = descramble(np.asarray(frame, dtype=np.uint8))
    return bytes_to_bits_le(xframe)
