"""iMet-54 frame codec (4.8 kBd GFSK, 8N1 framing, Hamming(8,4), CRC32).

Frame structure and telemetry semantics follow the on-air protocol as
documented by the reference decoder (reference demod/mod/imet54mod.c):
8N1 byte framing stripped by ``de8n1`` (:107-118); 64-bit (8×8 transpose)
interleaving (:120-133); Hamming(8,4) with LSB-first codewords and LUT
(:135-226); paired 16-bit LFSR frame check ``crc32ok`` (:228-280) and the
CRC32-802.3 continuous-frame variant (:282-360); field layout SN/GPS/PTU/
status (:332-345); NMEA-style ddmm.mmmm lat/lon (:375-395); Hyland-Wexler
RH compensation (:409-470); JSON output incl. time-only datetime and
iMet-50 subtype detection (:494-616).  Implementation (numpy + encoder
fixture) is new.
"""

import numpy as np

from radiosonde_auto_rx_tpu_torch.models import register
from radiosonde_auto_rx_tpu_torch.demod.framing import find_frame_starts

# preamble+sync correlation header: 0x00 0xAA 0x24 0x24 in 8N1
HEADER = "0000000001" "0101010101" "0001001001" "0001001001"
BAUD = 4798
FRAME_LEN_BYTES = 108          # FRMBYTE_STD
BITFRAME_LEN = 2200
OFS_BITS = 24                  # 0x24 0x24 0x42 sync after header (de-8N1)

POS_SN, POS_TIME, POS_LAT, POS_LON, POS_ALT = 0x00, 0x04, 0x08, 0x0C, 0x10
POS_T, POS_RH, POS_TRH = 0x1C, 0x20, 0x24
POS_STATUS, POS_CRC32CONT, POS_F8, POS_CNT11 = 0x2A, 0x34, 0x52, 0x5E

# Hamming(8,4) codeword LUT (imet54mod.c:197-198), codeword bits LSB-first
HAM_LUT = np.array([0x00, 0x87, 0x99, 0x1E, 0xAA, 0x2D, 0x33, 0xB4,
                    0x4B, 0xCC, 0xD2, 0x55, 0xE1, 0x66, 0x78, 0xFF],
                   dtype=np.uint8)
H = np.array([[1, 0, 1, 0, 1, 0, 1, 0],
              [0, 1, 1, 0, 0, 1, 1, 0],
              [0, 0, 0, 1, 1, 1, 1, 0],
              [1, 1, 1, 1, 1, 1, 1, 1]], dtype=np.uint8)
HE = np.array([0x9, 0xA, 0xB, 0xC, 0xD, 0xE, 0xF, 0x8], dtype=np.uint8)
# m0=c2, m1=c4, m2=c5, m3=c6 (systematic positions, imet54mod.c:199-200)
_CW_TO_NIB = np.full(256, 0xFF, dtype=np.uint8)
for _n in range(16):
    _CW_TO_NIB[HAM_LUT[_n]] = _n


def de8n1(bits):
    """Drop start/stop bits: keep positions n%10 in 1..8 (imet54mod.c:107)."""
    bits = np.asarray(bits, dtype=np.uint8)
    n = len(bits) // 10 * 10
    return bits[:n].reshape(-1, 10)[:, 1:9].reshape(-1)


def en8n1(bits):
    bits = np.asarray(bits, dtype=np.uint8)
    assert len(bits) % 8 == 0
    out = np.ones((len(bits) // 8, 10), dtype=np.uint8)
    out[:, 0] = 0
    out[:, 1:9] = bits.reshape(-1, 8)
    return out.reshape(-1)


def deinter64(bits):
    """8×8 bit transpose per 64-bit block (self-inverse) (imet54mod.c:120)."""
    bits = np.asarray(bits, dtype=np.uint8)
    n = len(bits) // 64 * 64
    blocks = bits[:n].reshape(-1, 8, 8).transpose(0, 2, 1).reshape(-1)
    return np.concatenate([blocks, bits[n:]])


def hamming_decode_byte(cwb):
    """One 8-bit codeword (LSB-first bits) -> (nibble, err_flag)."""
    syn = (H @ cwb) % 2
    synval = int((syn * (1 << np.arange(4))).sum())
    cwb = cwb.copy()
    err = 0
    if synval:
        hit = np.flatnonzero(HE == synval)
        if len(hit):
            cwb[hit[0]] ^= 1
            err = 1
        else:
            err = 0xF0
    byt = int((cwb * (1 << np.arange(8))).sum())
    nib = _CW_TO_NIB[byt]
    if nib == 0xFF:
        return 0, 0xF0
    return int(nib), err


_CRC_WALK = None    # (n_seq, b_seq, c0_seq, c1_seq, include) — the LFSR
                    # state walk is data-independent, so precompute it once
                    # and reduce with one masked XOR per check


def _crc_walk():
    global _CRC_WALK
    if _CRC_WALK is None:
        poly0, poly1 = 0x0EDB, 0x8260
        n, b = 104, 0
        c0, c1 = 0x48EB, 0x1ACA
        ns, bs, c0s, c1s = [], [], [], []
        while n >= 0:
            ns.append(n)
            bs.append(b)
            c0s.append(c0)
            c1s.append(c1)
            nx_c0, nx_c1 = c0, c1
            if c1 & 0x8000:
                nx_c0 ^= poly0
                nx_c1 ^= poly1
            nx_c0 = (nx_c0 << 1) & 0xFFFF
            nx_c1 = (nx_c1 << 1) & 0xFFFF
            if c1 & 0x8000:
                nx_c0 |= 1
            if (c1 ^ c0) & 0x8000:
                nx_c1 |= 1
            c0, c1 = nx_c0, nx_c1
            if b < 7:
                b += 1
            else:
                b = 0
                n = n - 7 if n % 4 == 3 else n + 1
        ns = np.array(ns)
        inc = (ns < 100) | ((ns > 101) & (ns < 106))
        _CRC_WALK = (ns, np.array(bs), np.array(c0s), np.array(c1s), inc)
    return _CRC_WALK


_HAM_TABS = None    # 256-entry (nibble, err) decode tables


def hamming_decode_bytes(cw_vals):
    """Vectorized hamming_decode_byte over an array of 8-bit codeword
    values (LSB-first bit packing): returns (nibs, errs)."""
    global _HAM_TABS
    if _HAM_TABS is None:
        nib_t = np.zeros(256, dtype=np.uint8)
        err_t = np.zeros(256, dtype=np.int32)
        w = (1 << np.arange(8)).astype(np.uint8)
        for v in range(256):
            cwb = ((v >> np.arange(8)) & 1).astype(np.uint8)
            nib_t[v], err_t[v] = hamming_decode_byte(cwb)
        _HAM_TABS = (nib_t, err_t)
    nib_t, err_t = _HAM_TABS
    cw_vals = np.asarray(cw_vals, dtype=np.int64)
    return nib_t[cw_vals], err_t[cw_vals]


def crc32ok(frame):
    """Paired 16-bit LFSR check over the std frame (imet54mod.c:228-280)."""
    if len(frame) < FRAME_LEN_BYTES:
        return False
    ns, bs, c0s, c1s, inc = _crc_walk()
    data_c0 = (int(frame[100]) << 8) | int(frame[101])
    data_c1 = (int(frame[106]) << 8) | int(frame[107])
    f = np.asarray(frame, dtype=np.int64)
    sel = inc & (((f[ns] >> bs) & 1) != 0)
    crc0 = int(np.bitwise_xor.reduce(np.where(sel, c0s, 0)))
    crc1 = int(np.bitwise_xor.reduce(np.where(sel, c1s, 0)))
    crc0 ^= data_c0 ^ 0x5000
    crc1 ^= data_c1 ^ 0x1DAD
    return crc1 == 0 and (crc0 & 0xF000) == 0


def crc32_fix(frame):
    """Set frame[100..101], [106..107] so crc32ok passes (encoder)."""
    f = frame.copy()
    f[100] = f[101] = f[106] = f[107] = 0
    # replicate the partial accumulation (skipped positions contribute 0)
    poly0, poly1 = 0x0EDB, 0x8260
    n, b = 104, 0
    c0, c1 = 0x48EB, 0x1ACA
    crc0 = crc1 = 0
    while n >= 0:
        if n < 100 or (101 < n < 106):
            if (int(f[n]) >> b) & 1:
                crc0 ^= c0
                crc1 ^= c1
        nx_c0, nx_c1 = c0, c1
        if c1 & 0x8000:
            nx_c0 ^= poly0
            nx_c1 ^= poly1
        nx_c0 = (nx_c0 << 1) & 0xFFFF
        nx_c1 = (nx_c1 << 1) & 0xFFFF
        if c1 & 0x8000:
            nx_c0 |= 1
        if (c1 ^ c0) & 0x8000:
            nx_c1 |= 1
        c0, c1 = nx_c0, nx_c1
        if b < 7:
            b += 1
        else:
            b = 0
            n = n - 7 if n % 4 == 3 else n + 1
    data_c0 = crc0 ^ 0x5000
    data_c1 = crc1 ^ 0x1DAD
    frame = frame.copy()
    frame[100], frame[101] = (data_c0 >> 8) & 0xFF, data_c0 & 0xFF
    frame[106], frame[107] = (data_c1 >> 8) & 0xFF, data_c1 & 0xFF
    return frame


def _i4be(frame, pos):
    v = 0
    for i in range(4):
        v = (v << 8) | int(frame[pos + i])
    return v - 0x100000000 if v & 0x80000000 else v


def _f32be(frame, pos):
    return np.frombuffer(bytes(frame[pos:pos + 4]), ">f4")[0]


def vapor_sat_p(tc):
    """Hyland and Wexler saturation pressure (imet54mod.c:409-422)."""
    T = tc + 273.15
    return np.exp(-5800.2206 / T + 1.3914993 + 6.5459673 * np.log(T)
                  - 4.8640239e-2 * T + 4.1764768e-5 * T * T
                  - 1.4452093e-8 * T**3)


@register("IMET5")
class IMet54Decoder:
    """iMet-54/50 frame decoder: raw 8N1 bit stream -> telemetry."""

    HEADER = HEADER

    def __init__(self, jsn_freq_khz: int = 0):
        self.jsn_freq_khz = jsn_freq_khz

    def decode_bits(self, raw_bits, soft=None):
        raw_bits = np.asarray(raw_bits, dtype=np.uint8)
        out = []
        for inv in (False, True):
            hdr = HEADER if not inv else "".join(
                "1" if c == "0" else "0" for c in HEADER)
            for s in find_frame_starts(raw_bits, hdr, max_errors=2):
                seg = raw_bits[s:s + BITFRAME_LEN]
                if inv:
                    seg = seg ^ 1
                if len(seg) < 600:
                    continue
                t = self.decode_raw_frame(seg)
                if t:
                    out.append(t)
        return out

    def decode_raw_frame(self, frame_bits):
        """Post-header raw bits -> telemetry (imet54mod.c print_frame)."""
        bits8n1 = de8n1(frame_bits)
        if len(bits8n1) <= OFS_BITS:
            return None
        bits = deinter64(bits8n1[OFS_BITS:])
        ncw = len(bits) // 8
        vals = bits[:8 * ncw].reshape(ncw, 8).astype(np.int64) @ (
            1 << np.arange(8))
        nibs, ec = hamming_decode_bytes(vals)
        nbytes = ncw // 2
        frame = ((nibs[0:2 * nbytes:2] << 4) |
                 (nibs[1:2 * nbytes:2] & 0xF)).astype(np.uint8)

        ecseg = ec[:min(2 * POS_CRC32CONT, ncw)]
        ecc_frm = -1 if (ecseg > 0x10).any() else int(ecseg.sum())
        return self.decode_frame(frame, ecc_frm)

    def decode_frame(self, frame, ecc_frm=0):
        if len(frame) <= POS_F8:
            return None
        crc_ok = crc32ok(frame)
        frm_ok = ecc_frm >= 0
        if not (frm_ok and crc_ok):
            return None

        sn = _i4be(frame, POS_SN) & 0xFFFFFFFF
        timems = _i4be(frame, POS_TIME)
        if not (0 <= timems <= 235959999):
            return None
        sek = (timems % 100000) / 1e3
        v = timems // 100000
        minute = v % 100
        std = (v // 100) % 100

        def nmea(pos):
            val = _i4be(frame, pos)
            valdeg = int(val / 1e6)
            valmin = (val / 1e6 - valdeg) * 100.0 / 60.0
            return float(np.float32(valdeg + valmin))

        lat, lon = nmea(POS_LAT), nmea(POS_LON)
        alt = _i4be(frame, POS_ALT) / 1e1
        if not (-90 <= lat <= 90 and -180 <= lon <= 180
                and -400 <= alt <= 60000):
            return None

        status = (int(frame[POS_STATUS]) << 8) | int(frame[POS_STATUS + 1])
        if (status & 0x30) != 0x30:
            return None

        # PTU floats; 0x4E6E6B28 (1e9) marks a missing sensor
        count_1e9 = 0
        T = _f32be(frame, POS_T)
        if _i4be(frame, POS_T) == 0x4E6E6B28:
            T, count_1e9 = -273.15, count_1e9 + 1
        elif not (-120.0 < T < 80.0):
            T = -273.15
        _rh = float(np.clip(_f32be(frame, POS_RH), 0.0, 100.0))
        if _i4be(frame, POS_RH) == 0x4E6E6B28:
            _rh, count_1e9 = -1.0, count_1e9 + 1
        Trh = _f32be(frame, POS_TRH)
        if _i4be(frame, POS_TRH) == 0x4E6E6B28:
            Trh, count_1e9 = -273.15, count_1e9 + 1
        elif not (-120.0 < Trh < 80.0):
            Trh = -273.15
        rh = -1.0
        if T > -273.0 and Trh > -273.0:
            rh = float(np.clip(
                _rh * vapor_sat_p(Trh) / vapor_sat_p(T), 0.0, 100.0))

        # iMet-50: empty PTU block + zero status bits (imet54mod.c:527-535)
        rs_type = 54
        if (frame[POS_STATUS + 2:POS_F8].sum() == 0
                and (status & 0xF0F) == 0 and count_1e9 == 3):
            rs_type = 50

        telem = {
            "type": "IMET5",
            "frame": int(std * 3600 + minute * 60 + sek + 0.5),
            "id": f"IMET5-{sn}",
            "datetime": f"{std:02d}:{minute:02d}:{sek:06.3f}Z",
            "lat": round(lat, 5),
            "lon": round(lon, 5),
            "alt": round(alt, 5),
            "subtype": "iMet-54" if rs_type == 54 else "iMet-50",
            "ref_datetime": "UTC",
            "ref_position": "MSL",
        }
        if T > -273.0:
            telem["temp"] = round(float(T), 1)
        if rh > -0.5:
            telem["humidity"] = round(rh, 1)
        if self.jsn_freq_khz:
            telem["freq"] = self.jsn_freq_khz
        return telem


# --------------------------------------------------------------------------- #
# encoder fixture
# --------------------------------------------------------------------------- #

def _put_i4be(frame, pos, val):
    val &= 0xFFFFFFFF
    for i in range(4):
        frame[pos + i] = (val >> (8 * (3 - i))) & 0xFF


def encode_frame(sn=54001234, hh=12, mm=30, ss=15.0, lat=51.5, lon=7.25,
                 alt=12000.5, T=-35.2, RH=45.0, Trh=-30.0, status=0x003E):
    """Build one valid 108-byte iMet-54 frame, CRC-fixed."""
    frame = np.zeros(FRAME_LEN_BYTES, dtype=np.uint8)
    _put_i4be(frame, POS_SN, sn)
    timems = int(round(((hh * 100 + mm) * 100 + ss) * 1000))
    _put_i4be(frame, POS_TIME, timems)

    def nmea_enc(deg):
        d = int(deg)
        minutes = (deg - d) * 60.0
        return int(round((d + minutes / 100.0) * 1e6))

    _put_i4be(frame, POS_LAT, nmea_enc(lat))
    _put_i4be(frame, POS_LON, nmea_enc(lon))
    _put_i4be(frame, POS_ALT, int(round(alt * 10)))
    import struct
    for pos, val in ((POS_T, T), (POS_RH, RH), (POS_TRH, Trh)):
        frame[pos:pos + 4] = np.frombuffer(struct.pack(">f", val), np.uint8)
    frame[POS_STATUS] = (status >> 8) & 0xFF
    frame[POS_STATUS + 1] = status & 0xFF
    return crc32_fix(frame)


def encode_raw_bits(frame):
    """Frame bytes -> full raw 8N1 bit stream incl. header."""
    nibs = np.empty(2 * len(frame), dtype=np.uint8)
    nibs[0::2] = (frame >> 4) & 0xF
    nibs[1::2] = frame & 0xF
    cw = HAM_LUT[nibs]
    bits = ((cw[:, None] >> np.arange(8)[None, :]) & 1).reshape(-1)
    inter = deinter64(bits)          # transpose is self-inverse
    sync = np.concatenate([
        ((np.uint8(b) >> np.arange(7, -1, -1)) & 1).astype(np.uint8)
        for b in (0x24, 0x24, 0x42)])
    payload = en8n1(np.concatenate([sync, inter]).astype(np.uint8))
    hdr = np.array([int(c) for c in HEADER], dtype=np.uint8)
    return np.concatenate([hdr, payload])
