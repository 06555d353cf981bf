"""Weathex WxR-301D frame codec (4.8 kBd; PN9-whitened 5 kBd variant).

Frame structure per the reference decoder (reference
weathex/weathex301d.c): 40-bit header AA AA AA 2D D4 (PN9: AA AA AA C1 94)
(:47-55); 69-byte frames incl. header, MSB-first bits (:269-296); PN9
whitening XOR from byte 6 (:299-316); xor8|sum8 checksum over 53 bytes at
``ofs`` (:319-331); subframes frid=1 (status) and frid=2 (GPS): packed
bitfields — alt 19 bits at byte 13<<4, lat 25 bits at byte 15<<7, lon
26 bits at byte 19 (:395-480); JSON gated on both subframes' checksums and
matching SN/counter (:487-520).
"""

import numpy as np

from radiosonde_auto_rx_tpu_torch.models import register
from radiosonde_auto_rx_tpu_torch.demod.framing import find_frame_starts

HEADER = "10101010" "10101010" "10101010" "00101101" "11010100"
HEADER_PN9 = "10101010" "10101010" "10101010" "11000001" "10010100"
BAUD = 4800
BAUD_PN9 = 5000
FRAMELEN = 69
OFS, OFS_PN9 = 6, 8

PN9B = np.array([
    0xFF, 0x87, 0xB8, 0x59, 0xB7, 0xA1, 0xCC, 0x24,
    0x57, 0x5E, 0x4B, 0x9C, 0x0E, 0xE9, 0xEA, 0x50,
    0x2A, 0xBE, 0xB4, 0x1B, 0xB6, 0xB0, 0x5D, 0xF1,
    0xE6, 0x9A, 0xE3, 0x45, 0xFD, 0x2C, 0x53, 0x18,
    0x0C, 0xCA, 0xC9, 0xFB, 0x49, 0x37, 0xE5, 0xA8,
    0x51, 0x3B, 0x2F, 0x61, 0xAA, 0x72, 0x18, 0x84,
    0x02, 0x23, 0x23, 0xAB, 0x63, 0x89, 0x51, 0xB3,
    0xE7, 0x8B, 0x72, 0x90, 0x4C, 0xE8, 0xFB, 0xC1], dtype=np.uint8)


def xor8sum(data):
    x = 0
    s = 0
    for b in data:
        x ^= int(b)
        s = (s + int(b)) & 0xFF
    return (x << 8) | s


@register("WXR301")
class WeathexDecoder:
    """Stateful Weathex decoder: NRZ bit stream -> telemetry."""

    HEADER = HEADER

    def __init__(self, pn9: bool = False, jsn_freq_khz: int = 0):
        self.pn9 = pn9
        self.ofs = OFS_PN9 if pn9 else OFS
        self.jsn_freq_khz = jsn_freq_khz
        self.sub1 = None         # (sn, cnt, chk_ok)

    def decode_bits(self, bits, soft=None):
        bits = np.asarray(bits, dtype=np.uint8)
        hdr0 = HEADER_PN9 if self.pn9 else HEADER
        out = []
        for inv in (False, True):
            hdr = hdr0 if not inv else "".join(
                "1" if c == "0" else "0" for c in hdr0)
            for s in find_frame_starts(bits, hdr, max_errors=2):
                seg = bits[s:s + 8 * FRAMELEN - 40]
                if inv:
                    seg = seg ^ 1
                if len(seg) < 8 * (FRAMELEN - 5) - 40 - 64:
                    continue
                hdr_bits = np.array([int(c) for c in hdr0], dtype=np.uint8)
                fb = np.concatenate([hdr_bits, seg])
                fb = np.concatenate(
                    [fb, np.zeros(8 * FRAMELEN - len(fb), np.uint8)])
                frame = (fb.reshape(-1, 8) <<
                         np.arange(7, -1, -1)[None, :]).sum(axis=1
                                                            ).astype(np.uint8)
                t = self.decode_frame(frame)
                if t:
                    out.append(t)
        return out

    def decode_frame(self, frame):
        xframe = frame.copy()
        if self.pn9:
            j = np.arange(6, FRAMELEN)
            xframe[6:] ^= PN9B[(j - 6) % 64]
        ofs = self.ofs
        chkdat = (int(xframe[ofs + 53]) << 8) | int(xframe[ofs + 54])
        chk_ok = chkdat == xor8sum(xframe[ofs:ofs + 53])

        sn = int(xframe[ofs]) | (int(xframe[ofs + 1]) << 8) | \
            (int(xframe[ofs + 2]) << 16) | (int(xframe[ofs + 3]) << 24)
        cnt = int(xframe[ofs + 4]) | (int(xframe[ofs + 5]) << 8)
        frid = int(xframe[ofs + 6])

        if frid == 1:
            self.sub1 = (sn, cnt, chk_ok)
            return None
        if frid != 2 or not chk_ok:
            return None

        hms = (int(xframe[ofs + 7]) | (int(xframe[ofs + 8]) << 8) |
               (int(xframe[ofs + 9]) << 16)) & 0x3FFFF
        h, m, s = hms // 10000, (hms % 10000) // 100, hms % 100
        val_alt = ((int(xframe[ofs + 13]) | (int(xframe[ofs + 14]) << 8) |
                    (int(xframe[ofs + 15]) << 16)) >> 4) & 0x7FFFF
        val_lat = ((int(xframe[ofs + 15]) | (int(xframe[ofs + 16]) << 8) |
                    (int(xframe[ofs + 17]) << 16) |
                    (int(xframe[ofs + 18]) << 24)) >> 7) & 0x1FFFFFF
        val_lon = (int(xframe[ofs + 19]) | (int(xframe[ofs + 20]) << 8) |
                   (int(xframe[ofs + 21]) << 16) |
                   (int(xframe[ofs + 22]) << 24)) & 0x3FFFFFF
        if val_alt == 0 and val_lat == 0 and val_lon == 0:
            return None
        if self.sub1 is None:
            return None
        sn1, cnt1, chk1ok = self.sub1
        if not (chk1ok and sn1 == sn and cnt1 == cnt):
            return None

        telem = {
            "type": "WXR301",
            "frame": cnt,
            "id": f"WXR-{sn}",
            "datetime": f"{h:02d}:{m:02d}:{s:02d}Z",
            "lat": round(np.float32(val_lat / 1e5).item(), 5),
            "lon": round(np.float32(val_lon / 1e5).item(), 5),
            "alt": round(np.float32(val_alt / 10.0).item(), 2),
            "ref_datetime": "UTC",
            "ref_position": "MSL",
        }
        if self.pn9:
            telem["subtype"] = "WXR_PN9"
        if self.jsn_freq_khz:
            telem["freq"] = self.jsn_freq_khz
        return telem


@register("WXRPN9")
class WeathexPN9Decoder(WeathexDecoder):
    """PN9-whitened 5 kBd variant (reference decode.py:1385-1471)."""

    HEADER = HEADER_PN9

    def __init__(self, jsn_freq_khz: int = 0):
        super().__init__(pn9=True, jsn_freq_khz=jsn_freq_khz)


# --------------------------------------------------------------------------- #
# encoder fixture
# --------------------------------------------------------------------------- #

def encode_frame(frid, sn=30112233, cnt=777, time=(10, 20, 30),
                 lat=3.15, lon=101.7, alt=12345.6, pn9=False,
                 fill=True):
    ofs = OFS_PN9 if pn9 else OFS
    hdr = HEADER_PN9 if pn9 else HEADER
    frame = np.zeros(FRAMELEN, dtype=np.uint8)
    if fill:
        # unread payload bytes carry pseudo-random data (real sondes
        # transmit PTU/status there) — an all-zero run is 30+ bytes of
        # constant tone, which starves any demod's clock tracking
        fr = np.random.default_rng(int(sn) * 131 + int(cnt) * 7 + frid)
        frame[:] = fr.integers(0, 256, FRAMELEN)
    hb = np.array([int(c) for c in hdr], dtype=np.uint8)
    frame[:5] = (hb.reshape(5, 8) << np.arange(7, -1, -1)[None, :]).sum(1)
    x = frame.copy()
    x[ofs] = sn & 0xFF
    x[ofs + 1] = (sn >> 8) & 0xFF
    x[ofs + 2] = (sn >> 16) & 0xFF
    x[ofs + 3] = (sn >> 24) & 0xFF
    x[ofs + 4] = cnt & 0xFF
    x[ofs + 5] = (cnt >> 8) & 0xFF
    x[ofs + 6] = frid
    if frid == 2:
        h, m, s = time
        hms = h * 10000 + m * 100 + s
        x[ofs + 7] = hms & 0xFF
        x[ofs + 8] = (hms >> 8) & 0xFF
        x[ofs + 9] = (hms >> 16) & 0x03
        val_alt = int(round(alt * 10)) & 0x7FFFF
        val_lat = int(round(lat * 1e5)) & 0x1FFFFFF
        val_lon = int(round(lon * 1e5)) & 0x3FFFFFF
        packed = val_alt << 4 | 0x0        # bits 4..22 of bytes 13..15
        x[ofs + 13] = packed & 0xFF
        x[ofs + 14] = (packed >> 8) & 0xFF
        x[ofs + 15] = ((packed >> 16) & 0x7F) | ((val_lat & 1) << 7)
        rest = val_lat >> 1
        x[ofs + 16] = rest & 0xFF
        x[ofs + 17] = (rest >> 8) & 0xFF
        x[ofs + 18] = (rest >> 16) & 0xFF
        x[ofs + 19] = val_lon & 0xFF
        x[ofs + 20] = (val_lon >> 8) & 0xFF
        x[ofs + 21] = (val_lon >> 16) & 0xFF
        x[ofs + 22] = (val_lon >> 24) & 0x03
    chk = xor8sum(x[ofs:ofs + 53])
    x[ofs + 53] = (chk >> 8) & 0xFF
    x[ofs + 54] = chk & 0xFF
    if pn9:
        j = np.arange(6, FRAMELEN)
        x[6:] ^= PN9B[(j - 6) % 64]
        x[:5] = frame[:5]
    return x


def frame_to_bits(frame):
    return ((frame[:, None] >> np.arange(7, -1, -1)[None, :]) & 1
            ).reshape(-1).astype(np.uint8)
