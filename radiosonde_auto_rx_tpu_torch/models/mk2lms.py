"""Lockheed Martin LMS6-1680 / MK2A frame codec (9616 Bd, 8N1, wide FM).

Frame structure and telemetry semantics follow the on-air protocol as
documented by the reference decoder (reference mk2a/mk2a1680mod.c):
9616 Bd 8N1 bytes LSB-first (:1686-1706,1742-1765); raw header = 3 sync
bytes 0xCA + frame prefix 0x24 0x52 (:1691-1702); subframe type byte at
offset 2: 0x54 = GPS/telemetry, 0x4D = full-ID (:1796-1817); big-endian
fields: SondeID u16, FrameNb u16, TOW ms u32, lat/lon u32 scaled by
2^32/360 (0xB60B60.xx), alt mm u32, vE/vN/vU s24 mm/s (:1839-1947);
full 32-bit serial from the 0x4D subframe at offset 0x32 (:1981-1992);
trailing 0xCA padding trimmed, CRC16 poly 0x1021 init 0 stored
big-endian over all preceding bytes incl. the 0x24 0x52 prefix
(:1773-1826,1956-1971); JSON emitted for CRC-clean 0x54 frames once the
full ID is known, type "LMS" subtype "MK2A", time-only datetime
(:2035-2055).  Implementation (numpy + encoder fixture) is new.
"""

import numpy as np

from radiosonde_auto_rx_tpu_torch.models import register
from radiosonde_auto_rx_tpu_torch.demod.framing import find_frame_starts
from radiosonde_auto_rx_tpu_torch.ecc.crc import crc16_ccitt

# 5 x 10-bit 8N1 characters: 0xCA 0xCA 0xCA 0x24 0x52
HEADER = ("0010100111" "0010100111" "0010100111"
          "0001001001" "0010010101")
BAUD = 9616
BITS = 10               # 1 start + 8 data + 1 stop
OFS = 2                 # frame starts at the 0x24 0x52 prefix
FRAME_LEN = 176
POS_TYPE = OFS
POS_SONDEID = OFS + 0x02
POS_FRAMENB = OFS + 0x04
POS_GPSTOW = OFS + 0x08
POS_GPSLAT = OFS + 0x10
POS_GPSLON = OFS + 0x14
POS_GPSALT = OFS + 0x18
POS_GPSVE = OFS + 0x1C
POS_GPSVN = OFS + 0x1F
POS_GPSVU = OFS + 0x22
POS_FULLID = OFS + 0x30
LEN_54 = 0x28 + OFS     # GPS subframe payload bytes before CRC
LEN_4D = 0x36 + OFS
B60B60 = float(0xB60B60)  # 2^32 / 360
PAD = 0xCA
SYNCLEN = 40            # frames end at a 4-char 0xCA sync run (findsync)


def _be(f, p, n):
    v = 0
    for i in range(n):
        v = (v << 8) | int(f[p + i])
    return v


def _s24(f, p):
    v = _be(f, p, 3)
    return v - 0x1000000 if v > 0x7FFFFF else v


@register("MK2LMS")
class MK2LMSDecoder:
    """Stateful MK2A decoder: raw 8N1 bit stream -> telemetry."""

    HEADER = HEADER

    def __init__(self, jsn_freq_khz: int = 0):
        self.jsn_freq_khz = jsn_freq_khz
        self.id = 0          # 32-bit serial once a 0x4D frame was seen
        self.prev_frnr = -1

    def decode_bits(self, raw_bits, soft=None):
        raw_bits = np.asarray(raw_bits, dtype=np.uint8)
        out = []
        for inv in (False, True):
            hdr = HEADER if not inv else "".join(
                "1" if c == "0" else "0" for c in HEADER)
            starts = find_frame_starts(raw_bits, hdr, max_errors=2)
            for k, s in enumerate(starts):
                # frame bytes include the 0x24 0x52 prefix: back up 2 chars
                start = s - 2 * BITS
                # a frame ends where the next header's sync run begins
                # (reference main loop reads until the next header)
                end = start + FRAME_LEN * BITS
                if k + 1 < len(starts):
                    end = min(end, starts[k + 1] - len(HEADER) - 2 * BITS)
                n = max(0, (end - start) // BITS) * BITS
                bits = raw_bits[start:start + n]
                if inv:
                    bits = bits ^ 1
                if len(bits) < (LEN_54 + 2) * BITS:
                    continue
                t = self.decode_frame_bits(bits)
                if t:
                    out.append(t)
        return out

    def decode_frame_bits(self, frame_bits):
        n = len(frame_bits) // BITS
        chars = frame_bits[: n * BITS].reshape(n, BITS)
        frame = (chars[:, 1:9] << np.arange(8)[None, :]) \
            .sum(axis=1).astype(np.uint8)
        # a 4-byte 0xCA run terminates the frame (mk2a1680mod.c findsync
        # :1727-1741: the bit reader stops at SYNCLEN=40 sync bits)
        run = 0
        for i in range(len(frame)):
            run = run + 1 if frame[i] == PAD else 0
            if run == SYNCLEN // BITS and i >= run:
                frame = frame[: i + 1]
                break
        return self.decode_frame(frame)

    def decode_frame(self, frame):
        frame = np.asarray(frame, dtype=np.uint8)
        flen = len(frame)
        while flen > 2 and frame[flen - 1] == PAD:
            flen -= 1
        # CRC search around the trimmed length (mk2a1680mod.c:1960-1970:
        # the padding trim can eat CRC bytes that happen to equal 0xCA)
        crc_ok = False
        for ln in (flen - 2, flen - 1, flen):
            if ln + 2 <= len(frame) and ln > OFS and \
                    crc16_ccitt(frame[:ln], init=0) == _be(frame, ln, 2):
                crc_ok = True
                break
        if not crc_ok:
            return None

        ftype = int(frame[POS_TYPE])
        if ftype == 0x4D and len(frame) > POS_FULLID + 4:
            if frame[POS_SONDEID] == frame[POS_FULLID] and \
                    frame[POS_SONDEID + 1] == frame[POS_FULLID + 1]:
                self.id = ((int(frame[POS_FULLID + 2]) << 24)
                           | (int(frame[POS_FULLID + 3]) << 16)
                           | (int(frame[POS_FULLID]) << 8)
                           | int(frame[POS_FULLID + 1]))
            return None
        if ftype != 0x54 or len(frame) <= POS_GPSALT + 4:
            return None

        sid16 = _be(frame, POS_SONDEID, 2)
        if (self.id & 0xFFFF) != sid16:
            self.id = sid16
        frnr = _be(frame, POS_FRAMENB, 2)
        tow_ms = _be(frame, POS_GPSTOW, 4)
        sod, ms = divmod(tow_ms, 1000)
        sod %= 86400
        def _s32(v):
            return v - 0x100000000 if v > 0x7FFFFFFF else v

        lat = _s32(_be(frame, POS_GPSLAT, 4)) / B60B60
        lon = _s32(_be(frame, POS_GPSLON, 4)) / B60B60
        alt = _be(frame, POS_GPSALT, 4) / 1000.0
        if not (-100.0 <= alt <= 60000.0):
            return None
        vE = _s24(frame, POS_GPSVE) / 1e3
        vN = _s24(frame, POS_GPSVN) / 1e3
        vU = _s24(frame, POS_GPSVU) / 1e3
        vH = float(np.hypot(vE, vN))
        vD = float(np.degrees(np.arctan2(vE, vN))) % 360.0

        # JSON gating: CRC ok, full 32-bit ID known, new frame number
        if not (self.id & 0xFFFF0000) or frnr == self.prev_frnr:
            return None
        self.prev_frnr = frnr
        sek = sod % 60 + ms / 1000.0
        telem = {
            "type": "LMS",
            "frame": frnr,
            "id": f"LMS6-{self.id}",
            "datetime": (f"{sod // 3600:02d}:{(sod % 3600) // 60:02d}"
                         f":{sek:06.3f}Z"),
            "lat": round(float(lat), 5),
            "lon": round(float(lon), 5),
            "alt": round(alt, 5),
            "vel_h": round(vH, 5),
            "heading": round(vD, 5),
            "vel_v": round(vU, 5),
            "subtype": "MK2A",
        }
        if self.jsn_freq_khz:
            telem["freq"] = self.jsn_freq_khz
        return telem


# --------------------------------------------------------------------------- #
# encoder fixture
# --------------------------------------------------------------------------- #

def _put_be(frame, p, v, n):
    for i in range(n):
        frame[p + n - 1 - i] = v & 0xFF
        v >>= 8


def encode_frame_54(sid32=1234567, frnr=100, tow_ms=43_205_000,
                    lat=44.5, lon=-72.6, alt=15000.0,
                    vel_neu=(5.0, 3.0, -4.0), flen=0x54):
    """One GPS/telemetry (0x54) MK2A frame, 0xCA-padded, CRC appended.

    Intra-frame filler bytes are 0x00 — a run of four 0xCA bytes inside
    the payload would read as the inter-frame sync and truncate the frame
    (mk2a1680mod.c findsync); only the post-CRC padding is 0xCA.
    """
    frame = np.zeros(flen, dtype=np.uint8)
    frame[0], frame[1] = 0x24, 0x52
    frame[POS_TYPE] = 0x54
    _put_be(frame, POS_SONDEID, sid32 & 0xFFFF, 2)
    _put_be(frame, POS_FRAMENB, frnr, 2)
    _put_be(frame, POS_GPSTOW, tow_ms, 4)
    _put_be(frame, POS_GPSLAT, int(round(lat * B60B60)) & 0xFFFFFFFF, 4)
    _put_be(frame, POS_GPSLON, int(round(lon * B60B60)) & 0xFFFFFFFF, 4)
    _put_be(frame, POS_GPSALT, int(round(alt * 1000)), 4)
    vN, vE, vU = vel_neu
    _put_be(frame, POS_GPSVE, int(round(vE * 1000)) & 0xFFFFFF, 3)
    _put_be(frame, POS_GPSVN, int(round(vN * 1000)) & 0xFFFFFF, 3)
    _put_be(frame, POS_GPSVU, int(round(vU * 1000)) & 0xFFFFFF, 3)
    crc = crc16_ccitt(frame[:LEN_54], init=0)
    _put_be(frame, LEN_54, crc, 2)
    frame[LEN_54 + 2:] = PAD
    return frame


def encode_frame_4d(sid32=1234567, frnr=99, flen=0x4D):
    """One full-ID (0x4D) MK2A frame (0x00 filler, 0xCA post-CRC pad)."""
    frame = np.zeros(flen, dtype=np.uint8)
    frame[0], frame[1] = 0x24, 0x52
    frame[POS_TYPE] = 0x4D
    _put_be(frame, POS_SONDEID, sid32 & 0xFFFF, 2)
    _put_be(frame, POS_FRAMENB, frnr, 2)
    frame[POS_FULLID] = (sid32 >> 8) & 0xFF
    frame[POS_FULLID + 1] = sid32 & 0xFF
    frame[POS_FULLID + 2] = (sid32 >> 24) & 0xFF
    frame[POS_FULLID + 3] = (sid32 >> 16) & 0xFF
    crc = crc16_ccitt(frame[:LEN_4D], init=0)
    _put_be(frame, LEN_4D, crc, 2)
    frame[LEN_4D + 2:] = PAD
    return frame


def frame_to_raw_bits(frame, n_sync=12):
    """Frame bytes -> 8N1 raw bit stream with leading 0xCA sync run."""
    data = np.concatenate([np.full(n_sync, PAD, dtype=np.uint8),
                           np.asarray(frame, dtype=np.uint8)])
    chars = np.zeros((len(data), BITS), dtype=np.uint8)
    chars[:, 9] = 1
    for i in range(8):
        chars[:, 1 + i] = (data >> i) & 1
    return chars.reshape(-1)


def encode_flight_bits(sid32=1234567, n_frames=3, **kw):
    """Raw bit stream: one 0x4D ID frame then n 0x54 telemetry frames."""
    chunks = [frame_to_raw_bits(encode_frame_4d(sid32=sid32))]
    tow0 = kw.pop("tow_ms", 43_205_000)
    frnr0 = kw.pop("frnr", 100)
    for k in range(n_frames):
        f = encode_frame_54(sid32=sid32, frnr=frnr0 + k,
                            tow_ms=tow0 + 1000 * k, **kw)
        chunks.append(frame_to_raw_bits(f))
    return np.concatenate(chunks)
