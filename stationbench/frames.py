"""Frozen frame encoders of the sonde types the traffic puts on air.

The benchmark's yardstick: copies of the on-air frame layouts that the
program's decoders read (RS41, DFM-09, M10, M20, MTS01 at 400 MHz; RS92-NGP and LMS6-1680 at
1680 MHz), kept here so
that a change to the program's codecs cannot move what the traffic
sends.  Each ``<type>_frame_bits(serial, i, t_gps, lat, lon, alt)``
returns the raw channel bits of frame ``i`` (the symbols the modulator
keys), and ``expected_id`` the telemetry id the station must report.
Plain NumPy; imports nothing of the program.
"""

import datetime
import math

import numpy as np

GPS_EPOCH = datetime.datetime(1980, 1, 6, tzinfo=datetime.timezone.utc)


def gps_week_tow(t_gps: float):
    """(GPS week, seconds of week) of a GPS time in seconds since the
    GPS epoch."""
    week = int(t_gps // 604800)
    return week, t_gps - week * 604800


def gps_datetime(t_gps: float) -> datetime.datetime:
    return GPS_EPOCH + datetime.timedelta(seconds=t_gps)


# --------------------------------------------------------------------- #
# shared codes

def _crc_table():
    tab = np.zeros(256, np.uint16)
    for byte in range(256):
        rem = byte << 8
        for _ in range(8):
            rem = ((rem << 1) ^ 0x1021) if rem & 0x8000 else rem << 1
            rem &= 0xFFFF
        tab[byte] = rem
    return tab


_CRC = _crc_table()


def crc16_ccitt(data) -> int:
    """CRC16-CCITT, polynomial 0x1021, initial 0xFFFF."""
    rem = 0xFFFF
    for b in np.asarray(data, np.uint8):
        rem = ((rem << 8) & 0xFFFF) ^ int(_CRC[((rem >> 8) ^ int(b)) & 0xFF])
    return rem


def _gf256(poly: int):
    exp = np.zeros(512, np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        x <<= 1
        if x & 0x100:
            x ^= poly
    exp[255:510] = exp[:255]
    log = np.zeros(256, np.int64)
    log[exp[:255]] = np.arange(255)
    return exp, log


_EXP, _LOG = _gf256(0x11D)


def _gmul(a: int, b: int) -> int:
    return 0 if a == 0 or b == 0 else int(_EXP[_LOG[a] + _LOG[b]])


def _rs_generator(r: int):
    """g(X) = prod_{i<r} (X - alpha^i), coefficients low degree first."""
    g = [1]
    for i in range(r):
        root = int(_EXP[i])
        nxt = [0] * (len(g) + 1)
        for k, c in enumerate(g):
            nxt[k] ^= _gmul(c, root)
            nxt[k + 1] ^= c
        g = nxt
    return g


_RS_G = _rs_generator(24)


def _rs_basis():
    """Row i: X^(24 + i) mod g(X), low degree first: the parity of a
    codeword is the XOR of its message symbols times these rows."""
    basis = np.zeros((231, 24), np.int64)
    rem = [0] * 24
    rem[0] = 1                                   # X^0, shifted 24 times
    for i in range(24 + 231):
        if i >= 24:
            basis[i - 24] = rem
        fb = rem[23]
        rem = [0] + rem[:23]
        if fb:
            for j in range(24):
                rem[j] ^= _gmul(_RS_G[j], fb)
    return basis


_RS_BASIS = _rs_basis()


def rs255_231_parity(msg) -> np.ndarray:
    """The 24 parity symbols of the systematic RS(255, 231) codeword over
    GF(2^8)/0x11D with roots alpha^0..alpha^23 whose message symbol i is
    the coefficient of X^(24 + i): msg(X) X^24 mod g(X), low degree
    first."""
    msg = np.asarray(msg, np.int64)
    b = _RS_BASIS[:len(msg)]
    nz = (msg[:, None] != 0) & (b != 0)
    terms = np.where(nz, _EXP[_LOG[msg][:, None] + _LOG[b]], 0)
    return np.bitwise_xor.reduce(terms, axis=0).astype(np.uint8)


def bytes_to_bits_le(data) -> np.ndarray:
    data = np.asarray(data, np.uint8)
    return ((data[:, None] >> np.arange(8)[None, :]) & 1).reshape(-1) \
        .astype(np.uint8)


def bytes_to_bits_be(data) -> np.ndarray:
    data = np.asarray(data, np.uint8)
    return ((data[:, None] >> np.arange(7, -1, -1)[None, :]) & 1) \
        .reshape(-1).astype(np.uint8)


def _put_be(frame, pos, val, n):
    for i in range(n):
        frame[pos + i] = (val >> (8 * (n - 1 - i))) & 0xFF


# --------------------------------------------------------------------- #
# RS41: 320-byte standard frame, scrambled, two interleaved RS(255,231)

RS41_HEADER = np.array([0x86, 0x35, 0xF4, 0x40, 0x93, 0xDF, 0x1A, 0x60],
                       np.uint8)
RS41_MASK = np.array([
    0x96, 0x83, 0x3E, 0x51, 0xB1, 0x49, 0x08, 0x98,
    0x32, 0x05, 0x59, 0x0E, 0xF9, 0x44, 0xC6, 0x26,
    0x21, 0x60, 0xC2, 0xEA, 0x79, 0x5D, 0x6D, 0xA1,
    0x54, 0x69, 0x47, 0x0C, 0xDC, 0xE8, 0x5C, 0xF1,
    0xF7, 0x76, 0x82, 0x7F, 0x07, 0x99, 0xA2, 0x2C,
    0x93, 0x7C, 0x30, 0x63, 0xF5, 0x10, 0x2E, 0x61,
    0xD0, 0xBC, 0xB4, 0xB6, 0x06, 0xAA, 0xF4, 0x23,
    0x78, 0x6E, 0x3B, 0xAE, 0xBF, 0x7B, 0x4C, 0xC1], np.uint8)
EARTH_A = 6378137.0
EARTH_B = 6356752.31424518
_E2 = (EARTH_A ** 2 - EARTH_B ** 2) / EARTH_A ** 2


def geodetic_to_ecef(lat_deg, lon_deg, alt):
    phi, lam = np.radians(lat_deg), np.radians(lon_deg)
    n = EARTH_A / np.sqrt(1 - _E2 * np.sin(phi) ** 2)
    return ((n + alt) * np.cos(phi) * np.cos(lam),
            (n + alt) * np.cos(phi) * np.sin(lam),
            (n * (1 - _E2) + alt) * np.sin(phi))


def _hdv_to_ecef_vel(vh, vd, vu, lat_deg, lon_deg):
    phi, lam = np.radians(lat_deg), np.radians(lon_deg)
    vn, ve = vh * np.cos(np.radians(vd)), vh * np.sin(np.radians(vd))
    return (-vn * np.sin(phi) * np.cos(lam) - ve * np.sin(lam)
            + vu * np.cos(phi) * np.cos(lam),
            -vn * np.sin(phi) * np.sin(lam) + ve * np.cos(lam)
            + vu * np.cos(phi) * np.sin(lam),
            vn * np.cos(phi) + vu * np.sin(phi))


def _rs41_block(frame, pos, pck, data):
    n = len(data)
    frame[pos] = (pck >> 8) & 0xFF
    frame[pos + 1] = pck & 0xFF
    frame[pos + 2:pos + 2 + n] = data
    c = crc16_ccitt(data)
    frame[pos + 2 + n] = c & 0xFF
    frame[pos + 3 + n] = (c >> 8) & 0xFF


def rs41_calibytes(tx_freq_khz: int = 402500) -> np.ndarray:
    """The 51 x 16-byte calibration store: PTU coefficients, transmit
    frequency, firmware, type RS41-SGP, CRC."""
    cal = np.zeros(51 * 16, np.uint8)

    def put32(off, v):
        cal[off:off + 4] = np.frombuffer(np.float32(v).tobytes(), np.uint8)

    put32(61, 750.0)
    put32(65, 1100.0)
    for j, v in enumerate((-243.911, 0.187654, 8.2e-06)):
        put32(77 + 4 * j, v)
        put32(293 + 4 * j, v)
    for j, v in enumerate((1.0302, 0.0, 0.0)):
        put32(89 + 4 * j, v)
    for j, v in enumerate((45.0, 5.0)):
        put32(117 + 4 * j, v)
    for j, v in enumerate((1.0301, 0.0, 0.0)):
        put32(305 + 4 * j, v)
    df = tx_freq_khz - 400000
    b1 = df // 40
    cal[2] = (((df - 40 * b1) * 64) // 10) & 0xC0
    cal[3] = b1 & 0xFF
    cal[16 + 6], cal[16 + 7] = 0x12, 0x52
    cal[0x21 * 16 + 8:0x21 * 16 + 16] = np.frombuffer(b"RS41-SGP", np.uint8)
    cal[0x22 * 16 + 2:0x22 * 16 + 10] = np.frombuffer(b"RSM412\0\0",
                                                       np.uint8)
    c = crc16_ccitt(cal[2:50 * 16])
    cal[0], cal[1] = c & 0xFF, (c >> 8) & 0xFF
    return cal


_RS41_CAL = rs41_calibytes()


def rs41_frame_bits(serial: str, i: int, t_gps: float, lat: float,
                    lon: float, alt: float) -> np.ndarray:
    """On-air bits of RS41 frame ``i`` (frame number 900 + i)."""
    frame = np.zeros(320, np.uint8)
    frame[:8] = RS41_HEADER
    frame[0x38] = 0x0F
    calfr = i % 50
    d = np.zeros(0x28, np.uint8)
    nb = 900 + i
    d[0], d[1] = nb & 0xFF, (nb >> 8) & 0xFF
    d[2:10] = np.frombuffer(serial.encode().ljust(8)[:8], np.uint8)
    d[0x0A] = 29
    d[0x17] = calfr
    d[0x18:0x28] = _RS41_CAL[calfr * 16:calfr * 16 + 16]
    _rs41_block(frame, 0x039, 0x7928, d)
    _rs41_block(frame, 0x065, 0x7A2A, np.zeros(0x2A, np.uint8))
    week, sow = gps_week_tow(t_gps)
    d = np.zeros(0x1E, np.uint8)
    d[0:2] = np.frombuffer(int(week).to_bytes(2, "little"), np.uint8)
    d[2:6] = np.frombuffer(int(round(sow * 1000)).to_bytes(4, "little"),
                           np.uint8)
    d[6::2] = 0xFF
    _rs41_block(frame, 0x093, 0x7C1E, d)
    _rs41_block(frame, 0x0B5, 0x7D59, np.zeros(0x59, np.uint8))
    d = np.zeros(0x15, np.uint8)
    for k, v in enumerate(geodetic_to_ecef(lat, lon, alt)):
        d[4 * k:4 * k + 4] = np.frombuffer(
            int(round(v * 100)).to_bytes(4, "little", signed=True), np.uint8)
    for k, v in enumerate(_hdv_to_ecef_vel(5.0, 90.0, 5.0, lat, lon)):
        d[12 + 2 * k:14 + 2 * k] = np.frombuffer(
            int(round(v * 100)).to_bytes(2, "little", signed=True), np.uint8)
    d[18], d[19], d[20] = 9, 30, 15
    _rs41_block(frame, 0x112, 0x7B15, d)
    _rs41_block(frame, 0x12B, 0x7611, np.zeros(0x11, np.uint8))
    for k in range(2):
        frame[8 + 24 * k:8 + 24 * (k + 1)] = rs255_231_parity(
            frame[56 + k::2][:231])
    x = frame ^ np.tile(RS41_MASK, 5)
    return bytes_to_bits_le(x)


# --------------------------------------------------------------------- #
# DFM-09: Manchester, Hamming(8,4), one cycle of five frames a second

_DFM_HEADER = np.array([int(c) for c in "0100010111001111"], np.uint8)
_DFM_G = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1],
                   [0, 1, 1, 1], [1, 0, 1, 1], [1, 1, 0, 1], [1, 1, 1, 0]],
                  np.uint8)


def _val2bits(v, n):
    return np.array([(v >> (n - 1 - i)) & 1 for i in range(n)], np.uint8)


def _hamming(bits):
    """Bits (a multiple of 4) -> interleaved Hamming(8,4) codewords."""
    msg = np.asarray(bits, np.uint8).reshape(-1, 4)
    cw = (msg @ _DFM_G.T) % 2
    return cw.reshape(len(msg), 8).T.reshape(-1).astype(np.uint8)


def _dfm_dat(fr_id, payload48):
    return _hamming(np.concatenate([_val2bits(payload48, 48),
                                    _val2bits(fr_id, 4)]))


def _dfm_conf(conf_id, val24):
    return _hamming(np.concatenate([_val2bits(conf_id, 4),
                                    _val2bits(val24, 24)]))


def _fl24(f, p=4):
    return ((p & 0xF) << 20) | (int(round(f * (1 << p))) & 0xFFFFF)


_DFM_MEAS = (1317.45, 900.0, 2000.0, 1000.0, 5000.0, 3.0, 2500.0, 7.0, 9.0)


def manchester(bits) -> np.ndarray:
    """Manchester-2 (DFM-09): bit b -> raw (1 - b, b)."""
    b = np.asarray(bits, np.uint8)
    out = np.empty(2 * len(b), np.uint8)
    out[0::2] = b ^ 1
    out[1::2] = b
    return out


def dfm_frame_bits(serial: str, i: int, t_gps: float, lat: float,
                   lon: float, alt: float) -> np.ndarray:
    """Raw (Manchester) bits of one DFM-09 cycle: five frames carrying
    the nine data packets, and two of the eleven configuration channels
    in turn (measurements 0-8, the serial's two halves)."""
    sn = int(serial)
    t = gps_datetime(t_gps)
    frnr = int(t_gps) & 0xFF
    msek = int((t.second + t.microsecond / 1e6) * 1000)
    dats = {0: (2 << 24) | (frnr << 16), 1: (0xFF << 16) | msek,
            2: ((int(lat * 1e7) & 0xFFFFFFFF) << 16) | 520,
            3: ((int(lon * 1e7) & 0xFFFFFFFF) << 16) | 18000,
            4: ((int(alt * 100) & 0xFFFFFFFF) << 16) | 500,
            5: 0, 6: 0, 7: 0,
            8: (t.year << 36) | (t.month << 32) | (t.day << 27) |
               (t.hour << 22) | (t.minute << 16) | (8 << 8)}
    confs = [(ch, _fl24(_DFM_MEAS[ch])) for ch in range(9)]
    confs += [(0xA, (0xC << 20) | (((sn >> 16) & 0xFFFF) << 4)),
              (0xA, (0xC << 20) | ((sn & 0xFFFF) << 4) | 1)]
    frames = []
    for k, (d1, d2) in enumerate(((0, 1), (2, 3), (4, 5), (6, 7), (8, 7))):
        cid, cval = confs[(5 * i + k) % len(confs)]
        frames.append(np.concatenate([
            _DFM_HEADER, _dfm_conf(cid, cval), _dfm_dat(d1, dats[d1]),
            _dfm_dat(d2, dats[d2])]))
    return manchester(np.concatenate(frames))


# --------------------------------------------------------------------- #
# M10 / M20 (Meteomodem): differential Manchester pairs, 9600-9616 Bd

_M10_HEADER = np.array([int(c) for c in "10011001100110010100110010011001"],
                       np.uint8)


def _check_m10(msg, length):
    cs = 0
    for i in range(length):
        b = int(msg[i])
        c1 = cs & 0xFF
        b = ((b >> 1) | ((b & 1) << 7)) & 0xFF
        b ^= (b >> 2) & 0xFF
        t6 = (cs & 1) ^ ((cs >> 2) & 1) ^ ((cs >> 4) & 1)
        t7 = ((cs >> 1) & 1) ^ ((cs >> 3) & 1) ^ ((cs >> 5) & 1)
        t = (cs & 0x3F) | (t6 << 6) | (t7 << 7)
        s = (cs >> 7) & 0xFF
        s ^= (s >> 2) & 0xFF
        cs = ((c1 << 8) | (b ^ t ^ s)) & 0xFFFF
    return cs


def _m10_raw(frame) -> np.ndarray:
    data = np.concatenate([bytes_to_bits_be(frame), np.zeros(64, np.uint8)])
    b = np.bitwise_xor.accumulate(np.concatenate([[0], 1 ^ data]))[1:]
    raw = np.empty(2 * len(b), np.uint8)
    raw[0::2] = 1 - b
    raw[1::2] = b
    return np.concatenate([_M10_HEADER, raw])


def _m10_sn(serial: str):
    """Serial "XYY-Z-NNNNN" -> the five serial bytes of the frame."""
    a, b, c = serial.split("-")
    b2 = (int(a[0], 16) << 4) | int(a[1:])
    b34 = (int(c[0]) << 13) | int(c[1:])
    return (int(b, 16), 0, b2, b34 & 0xFF, b34 >> 8)


def m10_frame_bits(serial: str, i: int, t_gps: float, lat: float,
                   lon: float, alt: float) -> np.ndarray:
    frame = np.zeros(101, np.uint8)
    frame[0], frame[1], frame[2] = 0x64, 0x9F, 0x20
    k = (1 << 30) / 90.0
    week, sow = gps_week_tow(t_gps)
    _put_be(frame, 0x04, 620, 2)
    _put_be(frame, 0x06, (-840) & 0xFFFF, 2)
    _put_be(frame, 0x08, 1000, 2)
    _put_be(frame, 0x0A, int(round(sow * 1000)), 4)
    _put_be(frame, 0x0E, int(round(lat * k)) & 0xFFFFFFFF, 4)
    _put_be(frame, 0x12, int(round(lon * k)) & 0xFFFFFFFF, 4)
    _put_be(frame, 0x16, int(round(alt * 1000)) & 0xFFFFFFFF, 4)
    frame[0x1E], frame[0x1F] = 9, 18
    _put_be(frame, 0x20, week, 2)
    frame[0x32:0x35] = (0xA0, 0xBB, 0x0D)
    frame[0x35:0x38] = (0x50, 0x5C, 0x0C)
    frame[0x3E], frame[0x3F], frame[0x40] = 1, 0x00, 0xA8
    frame[0x45], frame[0x46] = 0x30, 0x02
    frame[0x59], frame[0x5A] = 0xD0, 0x07
    frame[0x5D:0x62] = _m10_sn(serial)
    frame[0x62] = 1
    cs = _check_m10(frame, 0x63)
    frame[0x63], frame[0x64] = (cs >> 8) & 0xFF, cs & 0xFF
    return _m10_raw(frame)


def _m20_sn24(serial: str) -> int:
    """Serial "YMM-B-NNNNN" -> the 24-bit serial field."""
    a, b, c = serial.split("-")
    ym = int(a[:-2]) * 12 + int(a[-2:]) - 1
    return ym | ((int(b) - 1) << 7) | (int(c[1:]) << 10) | \
        (int(c[0]) << 23)


def m20_frame_bits(serial: str, i: int, t_gps: float, lat: float,
                   lon: float, alt: float) -> np.ndarray:
    frame = np.zeros(101, np.uint8)
    frame[0], frame[1] = 0x45, 0x20
    frame[2], frame[3] = 0x30, 0x75
    frame[4], frame[5] = 0x00, 0x08
    frame[6], frame[7] = 0xD0, 0x07
    week, sow = gps_week_tow(t_gps)
    _put_be(frame, 0x08, int(round(alt * 100)) & 0xFFFFFF, 3)
    _put_be(frame, 0x0B, 250, 2)
    _put_be(frame, 0x0D, 150, 2)
    _put_be(frame, 0x0F, int(sow), 3)
    sn24 = _m20_sn24(serial)
    frame[0x12:0x15] = (sn24 & 0xFF, (sn24 >> 8) & 0xFF, sn24 >> 16)
    frame[0x15] = 1
    frame[0x16] = 0x00
    _put_be(frame, 0x18, 500, 2)
    _put_be(frame, 0x1A, week, 2)
    _put_be(frame, 0x1C, int(round(lat * 1e6)) & 0xFFFFFFFF, 4)
    _put_be(frame, 0x20, int(round(lon * 1e6)) & 0xFFFFFFFF, 4)
    frame[0x24], frame[0x25], frame[0x26] = 0x00, 0x40, 200
    frame[0x2F], frame[0x30] = 0x20, 0x4E
    frame[0x43] = 0x07
    cs = _check_m10(frame, 0x44)
    frame[0x44], frame[0x45] = (cs >> 8) & 0xFF, cs & 0xFF
    return _m10_raw(frame)


# --------------------------------------------------------------------- #
# MTS01 (Meteosis): 1200 Bd, CSV payload, CRC16/0x8005 bit-reversed

_MTS01_HEADER = np.array(
    [int(c) for c in "10101010" "10101010" "10110100" "00101011"], np.uint8)


def _crc16_re(data) -> int:
    rem = 0xFFFF
    for byte in data:
        rem ^= int(byte) << 8
        for _ in range(8):
            rem = ((rem << 1) ^ 0x8005 if rem & 0x8000 else rem << 1) \
                & 0xFFFF
    return int(f"{rem:016b}"[::-1], 2)


def mts01_frame_bits(serial: str, i: int, t_gps: float, lat: float,
                     lon: float, alt: float) -> np.ndarray:
    t = gps_datetime(t_gps)
    csv = (f"{serial},X,{i + 321},{t.year % 100:02d}{t.month:02d}"
           f"{t.day:02d}{t.hour:02d}{t.minute:02d}{t.second:02d},2900,"
           f"{lat:.6f},{lon:.6f},{alt:.1f},270.5,12.3,0,12.50,12.50,40.0"
           ).encode("ascii")
    frame = np.zeros(131, np.uint8)
    frame[0] = 0x80
    frame[1:129] = np.frombuffer(csv + b"U" * (128 - len(csv)), np.uint8)
    crc = _crc16_re(frame[1:129])
    frame[129], frame[130] = crc & 0xFF, (crc >> 8) & 0xFF
    return np.concatenate([_MTS01_HEADER, bytes_to_bits_be(frame)])


# --------------------------------------------------------------------- #

# --------------------------------------------------------------------- #
# RS92-NGP (1680 MHz): 240-byte frames, Manchester 8N1, RS(255,231), raw
# GPS pseudoranges that the decoder solves against the ephemeris

GRAVITY = 3.986005e14
EARTH_ROT = 7.2921151467e-05
RANGE_EST = 0.072
WEEKSEC = 604800.0
RS92_DF = 299792.458 / 1023.0 / 1024.0        # meters a chip unit
RS92_DL = 1575.42 / 1.023 / 4.0
_CALX170 = np.array([0x36, 0x98, 0x92, 0x25, 0x6B, 0xB3, 0x99, 0xE1,
                     0x57, 0x05, 0x30, 0x9A, 0xFE, 0x51, 0xF4, 0xAB],
                    np.uint8)
_NGP_KEY = np.array([0x5A, 0xC3, 0x17, 0x88, 0x2E, 0xD1, 0x4B, 0x96,
                     0x63, 0x0F, 0xB2, 0x79, 0xE4, 0x3D, 0xA8, 0x51],
                    np.uint8)


def rs92_test_ephemeris(gpsweek: int, toe: float, n_sats: int = 8):
    """A spread constellation of circular orbits, healthy, PRN 1..n:
    dicts of the broadcast elements (the rest zero; sqrt(a) 5153.6,
    inclination 0.9599 rad)."""
    return [dict(prn=k + 1, week=1, gpsweek=gpsweek, toe=toe, toc=toe,
                 sqrta=5153.6, i0=0.9599,
                 Omega0=2 * math.pi * (k % 4) / 4.0 + 0.3,
                 M0=2 * math.pi * ((k * 5) % 8) / 8.0 + 0.7 * (k // 4),
                 w=0.4 * k) for k in range(n_sats)]


def sat_position(t: float, e: dict):
    """ECEF position of a circular, uncorrected orbit at time of week
    ``t`` (internal week 1, as the decoder's)."""
    tk = t - e["toe"]
    a = e["sqrta"] ** 2
    u = e["M0"] + math.sqrt(GRAVITY / a ** 3) * tk + e["w"]
    om = e["Omega0"] - EARTH_ROT * (tk + e["toe"])
    x, y = a * math.cos(u), a * math.sin(u)
    ci, si = math.cos(e["i0"]), math.sin(e["i0"])
    return np.array((x * math.cos(om) - y * math.sin(om) * ci,
                     x * math.sin(om) + y * math.cos(om) * ci, y * si))


def _xor_ptu_key(cal):
    m32 = 0xFFFFFFFF
    p = [int(v) for v in cal[0x24:0x24 + 11]]
    key = np.zeros(16, np.uint8)
    for j in range(8):
        a = 0x1D89
        for k in range(4):
            a = (p[j + k] + a) & m32
            a = ((a << 10) + a) & m32
            a = ((a >> 6) ^ a) & m32
        a = ((a << 3) + a) & m32
        a = ((a >> 11) ^ a) & m32
        a = ((a << 15) + a) & m32
        key[2 * j], key[2 * j + 1] = a & 0xFF, (a >> 8) & 0xFF
    return key


def rs92ngp_calibytes(freq_khz: int = 1680000) -> np.ndarray:
    """The NGP calibration store: identity PTU records in NGP float byte
    order, the 0x170 constant block permuted, the transmit frequency, the
    records region XORed with a 16-byte keystream."""
    cal = np.zeros(512, np.uint8)
    recs = {11: 1.0, 17: 2.0, 31: 1.0, 37: 2.0, 41: 1.0, 47: 2.0, 51: 1.0,
            57: 2.0}
    for j, (idx, val) in enumerate(sorted(recs.items())):
        cal[0x40 + 5 * j] = idx
        cal[0x41 + 5 * j:0x45 + 5 * j] = np.frombuffer(
            np.float32(val).tobytes(), np.uint8)[[2, 0, 1, 3]]
    for j in range(len(recs), 56):
        cal[0x40 + 5 * j] = 200
    q = _CALX170
    for k in range(3):
        cal[0x170 + 5 * k:0x170 + 5 * k + 5] = q[[5 * k, 5 * k + 1,
                                                   5 * k + 4, 5 * k + 2,
                                                   5 * k + 3]]
    cal[0x17F] = q[15]
    w = (freq_khz - 1600000) // 10
    cal[2], cal[3] = w & 0xFF, w >> 8
    cal[0x40:0x40 + 330] ^= np.tile(_NGP_KEY, 21)[:330]
    return cal


_RS92_CAL = rs92ngp_calibytes()
_RS92_TAGS = {0x06: 0x6510, 0x2A: 0x690C, 0x46: 0x673D, 0xC4: 0x6805}


def _ptu_counts():
    ref1, ref3, ref4 = 4_000_000.0, 3_500_000.0, 3_000_000.0
    temp = ref1 - (ref1 - ref4) * (2.0 + 1.0 / 25.0)
    hum = ref1 - (ref1 - ref3) * (2.0 - 1.0 / 45.0)
    pres = ref1 - (ref1 - ref4) * (2.0 - 1.0 / 320.0)
    return [int(round(v)) for v in (temp, hum, hum, ref1, 3_200_000.0, pres,
                                    ref3, ref4)]


def rs92ngp_frame_bits(serial: str, i: int, t_gps: float, lat: float,
                       lon: float, alt: float, ephs=None) -> np.ndarray:
    """Raw (Manchester) bits of RS92-NGP frame ``i`` (frame number
    100 + i): pseudoranges and Doppler counts that put the decoder's
    navigation solution at (lat, lon, alt), rising 5 m/s."""
    week, tow = gps_week_tow(t_gps)
    if ephs is None:
        raise ValueError("an RS92 frame needs the ephemeris")
    frame = np.zeros(240, np.uint8)
    frame[:6] = (0x2A, 0x2A, 0x2A, 0x2A, 0x2A, 0x10)
    for pos, tag in _RS92_TAGS.items():
        frame[pos], frame[pos + 1] = tag & 0xFF, tag >> 8
    nb = 100 + i
    frame[0x08], frame[0x09] = nb & 0xFF, (nb >> 8) & 0xFF
    frame[0x0C:0x14] = np.frombuffer(serial.encode().ljust(8)[:8], np.uint8)
    calfr = i % 32
    frame[0x17] = calfr
    frame[0x18:0x28] = _RS92_CAL[calfr * 16:calfr * 16 + 16]
    for k, v in enumerate(_ptu_counts()):
        frame[0x2C + 3 * k:0x2F + 3 * k] = (v & 0xFF, (v >> 8) & 0xFF,
                                            (v >> 16) & 0xFF)
    xptu = _xor_ptu_key(_RS92_CAL)
    j = np.arange(24)
    frame[0x2C:0x44] ^= frame[0x08 + (j & 1)] ^ xptu[j % 16]
    tow_ms = int(round(tow * 1000))
    frame[0x48:0x4C] = np.frombuffer(np.uint32(tow_ms).tobytes(), np.uint8)
    t = tow_ms / 1000.0
    rx = np.array(geodetic_to_ecef(lat, lon, alt))
    v_rx = np.array(_hdv_to_ecef_vel(0.0, 0.0, 5.0, lat, lon))
    prns = np.zeros(12, np.int64)
    status = np.zeros(12, np.uint8)
    for k, e in enumerate(ephs[:12]):
        prns[k], status[k] = e["prn"], 0xFF
        sat = sat_position(t, e)
        c, s_ = math.cos(EARTH_ROT * RANGE_EST), math.sin(EARTH_ROT *
                                                        RANGE_EST)
        rot = np.array((c * sat[0] + s_ * sat[1], -s_ * sat[0] + c * sat[1],
                        sat[2]))
        prange = np.linalg.norm(rot - rx) + 1.0e5
        chips = int(round(-prange / RS92_DF)) & 0xFFFFFFFF
        frame[0x62 + 8 * k:0x66 + 8 * k] = np.frombuffer(
            np.uint32(chips).tobytes(), np.uint8)
        v_sat = (sat_position(t + 0.5, e) - sat_position(t - 0.5, e))
        los = (sat - rx) / np.linalg.norm(sat - rx)
        prate = float(los @ (v_sat - v_rx)) - 3000.0
        d = int(round(-prate * RS92_DL / RS92_DF)) & 0xFFFFFF
        frame[0x66 + 8 * k:0x69 + 8 * k] = (d & 0xFF, (d >> 8) & 0xFF,
                                            (d >> 16) & 0xFF)
    for k in range(len(ephs[:12]), 12):
        frame[0x62 + 8 * k:0x66 + 8 * k] = np.frombuffer(
            np.uint32(0x7FFFFFFF).tobytes(), np.uint8)
    bits = np.zeros(64, np.uint8)
    for k in range(12):
        for b in range(5):
            bits[5 * k + b] = (int(prns[k]) >> b) & 1
    for blk in range(4):
        w = sum(int(bits[15 * blk + b]) << b for b in range(15)) | \
            (int(bits[60 + blk]) << 15)
        frame[0x4E + 2 * blk], frame[0x4F + 2 * blk] = w & 0xFF, w >> 8
    frame[0x56:0x62] = status
    for pos, n in ((0x08, 0x20), (0x2C, 0x18), (0x48, 0x7A), (0xC6, 0x0A)):
        c = crc16_ccitt(frame[pos:pos + n])
        frame[pos + n], frame[pos + n + 1] = c & 0xFF, c >> 8
    frame[216:240] = rs255_231_parity(frame[6:216])
    b10 = np.zeros((240, 10), np.uint8)
    b10[:, 9] = 1
    for k in range(8):
        b10[:, 1 + k] = (frame >> k) & 1
    return manchester(b10.reshape(-1))


# --------------------------------------------------------------------- #
# LMS6-1680 (MK2A): 9616 Bd 8N1 bytes, CRC16 (init 0), a full-ID frame
# every tenth slot before the GPS frame

_MK2_PAD = 0xCA


def _mk2_put(frame, p, v, n):
    for k in range(n):
        frame[p + n - 1 - k] = v & 0xFF
        v >>= 8


def _crc16_0(data) -> int:
    rem = 0
    for b in np.asarray(data, np.uint8):
        rem = ((rem << 8) & 0xFFFF) ^ int(_CRC[((rem >> 8) ^ int(b)) & 0xFF])
    return rem


def _mk2_chars(data) -> np.ndarray:
    data = np.concatenate([np.full(12, _MK2_PAD, np.uint8),
                           np.asarray(data, np.uint8)])
    chars = np.zeros((len(data), 10), np.uint8)
    chars[:, 9] = 1
    for k in range(8):
        chars[:, 1 + k] = (data >> k) & 1
    return chars.reshape(-1)


def mk2lms_frame_bits(serial: str, i: int, t_gps: float, lat: float,
                      lon: float, alt: float) -> np.ndarray:
    sid = int(serial)
    b60 = float(0xB60B60)
    out = []
    if i % 10 == 0:
        f = np.zeros(0x4D, np.uint8)
        f[0], f[1], f[2] = 0x24, 0x52, 0x4D
        _mk2_put(f, 4, sid & 0xFFFF, 2)
        _mk2_put(f, 6, (99 + i) & 0xFFFF, 2)
        f[0x32:0x36] = ((sid >> 8) & 0xFF, sid & 0xFF, (sid >> 24) & 0xFF,
                        (sid >> 16) & 0xFF)
        _mk2_put(f, 0x38, _crc16_0(f[:0x38]), 2)
        f[0x3A:] = _MK2_PAD
        out.append(_mk2_chars(f))
    _, tow = gps_week_tow(t_gps)
    f = np.zeros(0x54, np.uint8)
    f[0], f[1], f[2] = 0x24, 0x52, 0x54
    _mk2_put(f, 4, sid & 0xFFFF, 2)
    _mk2_put(f, 6, (100 + i) & 0xFFFF, 2)
    _mk2_put(f, 10, int(round(tow * 1000)), 4)
    _mk2_put(f, 18, int(round(lat * b60)) & 0xFFFFFFFF, 4)
    _mk2_put(f, 22, int(round(lon * b60)) & 0xFFFFFFFF, 4)
    _mk2_put(f, 26, int(round(alt * 1000)), 4)
    _mk2_put(f, 36, 5000, 3)
    _mk2_put(f, 0x2A, _crc16_0(f[:0x2A]), 2)
    f[0x2C:] = _MK2_PAD
    out.append(_mk2_chars(f))
    return np.concatenate(out)


def mk2lms_pad(n: int) -> np.ndarray:
    """``n`` bits of the MK2A stream's own filler: 8N1 pad characters
    (0xCA, the run the decoder's frame sync reads between frames), then
    marks."""
    chars = _mk2_chars(np.full(max(n // 10 - 12, 0), _MK2_PAD, np.uint8))
    return np.concatenate([chars, np.ones(n - len(chars), np.uint8)])[:n]


# type -> (frame bits, channel symbol rate (Bd), tone spacing (Hz),
# Gaussian BT).  The traffic keys each sonde's frames back to back, as
# chip_smoke.py's synthesizers and the program's own test fixtures
# (tests/station_fixture.py, tests/test_station_chains.py) send them;
# its GPS time advances one second a frame.  A type in SLOT_FILL sends
# one frame a second instead, the rest of the second filled as its
# protocol fills it: back to back, an LMS6-1680's 0.1 s frames would run
# its GPS time ten times the capture's, past the station's 3-hour time
# filter within a run.
TYPES = {
    "RS41": (rs41_frame_bits, 4800, 4800, 0.5),
    "DFM": (dfm_frame_bits, 2500, 5000, 0.5),
    "M10": (m10_frame_bits, 9616, 10000, 1.0),
    "M20": (m20_frame_bits, 9600, 10000, 1.0),
    "MTS01": (mts01_frame_bits, 1200, 2400, 1.0),
    "RS92NGP": (rs92ngp_frame_bits, 4800, 20000, 0.5),
    "MK2LMS": (mk2lms_frame_bits, 9616, 100000, 1.0),
}


SLOT_FILL = {"MK2LMS": mk2lms_pad}


def frame_bits(typ: str, serial: str, i: int, t_gps: float, lat: float,
               lon: float, alt: float, **kw) -> np.ndarray:
    """The channel symbols of frame ``i`` of a sonde of ``typ``."""
    return TYPES[typ][0](serial, i, t_gps, lat, lon, alt, **kw)


def expected_id(typ: str, serial: str) -> str:
    """The telemetry id a sonde of ``typ`` with ``serial`` reports."""
    return {"RS41": serial, "DFM": f"DFM-{serial}", "M10": f"M10-{serial}",
            "M20": f"M20-{serial}", "MTS01": f"MTS01-{serial}",
            "RS92NGP": serial, "MK2LMS": f"LMS6-{serial}"}[typ]
