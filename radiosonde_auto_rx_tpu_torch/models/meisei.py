"""Meisei iMS-100 / RS-11G frame codec (2400 Bd biphase-S, BCH(63,51)).

Frame structure per the reference decoder (reference
demod/mod/meisei100mod.c): 1200 bit/s = 600-bit frames of two 300-bit
subframes headed 0x049DCE / 0xFB6230 (:20-90); biphase-S raw symbols, bit=1
iff the two raw symbols are equal (:213-229); each subframe = 24-bit header
+ 6 × 46-bit blocks, each a BCH(63,51) t=2 codeword shortened to (46,34)
with bit-reversed mapping cw[45-j]=bits[j] and two 16+1-bit parity-guarded
words per block (:740-780, doc :84-92); iMS-100 field layout: counter/cfg/
time in the 049DCE subframe, NMEA position + date + GPS word checksum in
the FB6230 subframe (:1026-1240); RS-11G variant layout (:787-1015);
config channels cfg[0,16,32,48]=SN float32, cfg[15]=frequency, thermistor
R-T interpolation table (:1094-1135); JSON output (:1236-1279).
"""

import numpy as np

from radiosonde_auto_rx_tpu_torch.models import register
from radiosonde_auto_rx_tpu_torch.demod.framing import find_frame_starts
from radiosonde_auto_rx_tpu_torch.ecc.bch import bch_decode, bch_encode

HEADER_049DCE = "000001001001110111001110"
HEADER_FB6230 = "111110110110001000110000"
# raw (biphase-S) header: computed below from HEADER_049DCE — bit b maps to
# raw pair with b = (r0 == r1), transitions at every bit boundary
BAUD_RAW = 2400
SUBFRAME_BITS = 300
FRAME_BITS = 600
HEADLEN = 24


def biphase_s_decode(raw):
    """bit = 1 iff raw[2j] == raw[2j+1] (meisei100mod.c:213-229)."""
    raw = np.asarray(raw, dtype=np.uint8)
    n = len(raw) // 2 * 2
    return (raw[0:n:2] == raw[1:n:2]).astype(np.uint8)


def biphase_s_encode(bits, level0=0):
    """Phase-continuous biphase-S: always transition at bit boundary;
    bit 1 = no mid-bit transition, bit 0 = mid-bit transition."""
    out = np.empty(2 * len(bits), dtype=np.uint8)
    lvl = level0
    for j, b in enumerate(bits):
        lvl ^= 1                      # transition at bit start
        out[2 * j] = lvl
        if b == 0:
            lvl ^= 1                  # mid-bit transition for 0
        out[2 * j + 1] = lvl
    return out


def _raw_header():
    bits = np.array([int(c) for c in HEADER_049DCE], dtype=np.uint8)
    return "".join(str(b) for b in biphase_s_encode(bits, level0=0))


RAW_HEADER = _raw_header()


def bits2val(bits, n=None):
    v = 0
    for b in (bits if n is None else bits[:n]):
        v = (v << 1) | int(b)
    return v


def val2bits(v, n):
    return np.array([(v >> (n - 1 - i)) & 1 for i in range(n)],
                    dtype=np.uint8)


def block_decode(block46):
    """One 46-bit block -> (corrected 46 bits, errors) via shortened BCH
    + the two 16-bit word parity checks (meisei100mod.c:740-771)."""
    cw = np.zeros(63, dtype=np.uint8)
    for j in range(46):
        cw[45 - j] = block46[j]
    cw, errors = bch_decode(cw)
    if errors >= 0:
        if np.any(cw[46:63]):
            errors = -3
        par = 1 ^ int(cw[13:29].sum() & 1)
        if cw[12] != par:
            errors = -3
        par = 1 ^ int(cw[30:46].sum() & 1)
        if cw[29] != par:
            errors = -3
    out = block46.copy()
    if errors >= 0:
        for j in range(46):
            out[j] = cw[45 - j]
    return out, errors


def block_encode(w0, w1):
    """Two 16-bit words -> 46-bit block with parity bits + BCH parity."""
    cw = np.zeros(63, dtype=np.uint8)
    # w16[0] occupies block bits 0..15 = cw[45..30]; w16[1] bits 17..32
    # = cw[28..13] (get_w16 / bit-reversed mapping)
    cw[30:46] = val2bits(w0, 16)[::-1]
    cw[29] = 1 ^ int(cw[30:46].sum() & 1)
    cw[13:29] = val2bits(w1, 16)[::-1]
    cw[12] = 1 ^ int(cw[13:29].sum() & 1)
    full = bch_encode(cw[12:63])
    cw[0:12] = full[0:12]
    block = np.zeros(46, dtype=np.uint8)
    for j in range(46):
        block[j] = cw[45 - j]
    return block


def get_w16(subframe_bits, j):
    """j-th 16-bit word (meisei100mod.c:252-255)."""
    p = HEADLEN + 46 * (j // 2) + 17 * (j % 2)
    return bits2val(subframe_bits[p:p + 16], 16)


def _f32le(w32):
    return float(np.frombuffer(np.uint32(w32).tobytes(), "<f4")[0])


def _f32_to_u32(f):
    return int(np.frombuffer(np.float32(f).tobytes(), "<u4")[0])


def est_year_ims100(_y, _yr=0):
    """Year from last digit + rollover heuristic (meisei100mod.c:380-392)."""
    yr_rollover, yr_offset = 20, 20
    if 2003 < _yr < 2100:
        yr_rollover = _yr - 2004
        yr_offset = (yr_rollover // 10) * 10
    _y = _y % 10 + yr_offset
    if _y < yr_rollover:
        _y += 10
    return 2000 + _y


@register("MEISEI")
class MeiseiDecoder:
    """Stateful Meisei decoder: raw biphase-S stream -> telemetry.

    Auto-detects iMS-100 vs RS-11G from the 0x30xx/0x31xx type word
    (meisei100mod.c:806-813,1033-1040).
    """

    HEADER = RAW_HEADER

    def __init__(self, jsn_freq_khz: int = 0, ref_year: int = 0):
        self.jsn_freq_khz = jsn_freq_khz
        self.ref_year = ref_year
        self.ims100 = True
        self.reset_gpx()

    def reset_gpx(self):
        self.cfg = np.zeros(64, dtype=np.float64)
        self.cfg_valid = 0
        self.sn = -1.0
        self.fq = 0.0
        self.f_ref = 0
        self.g = dict(frnr=0, frnr1=0, jahr=0, monat=0, tag=0,
                      std=0, minute=0, sek=0.0, lat=0.0, lon=0.0, alt=0.0,
                      vH=0.0, vD=0.0, vV=0.0, vV_valid=False,
                      T=float("nan"), RH=float("nan"),
                      frm0_count=0, frm0_valid=False,
                      frm1_count=0, frm1_valid=False)

    # ------------------------------------------------------------------ #

    def decode_bits(self, raw_bits, soft=None):
        raw_bits = np.asarray(raw_bits, dtype=np.uint8)
        out = []
        nraw = 2 * (FRAME_BITS - HEADLEN)
        # biphase-S is level-polarity invariant: search both polarities.
        # The starting level alternates frame-to-frame with the stream's
        # running level, so merge both polarities' hits and decode in
        # STREAM order — the iMS-100 emitter pairs an even frame with
        # the following odd frame and is stateful across frames.
        starts = []
        for hdr in (RAW_HEADER,
                    "".join("1" if c == "0" else "0" for c in RAW_HEADER)):
            starts.extend(find_frame_starts(raw_bits, hdr, max_errors=3))
        for s in sorted(set(starts)):
            raw = raw_bits[s:s + nraw]
            if len(raw) < nraw:
                continue
            bits = np.concatenate([
                np.array([int(c) for c in HEADER_049DCE],
                         dtype=np.uint8),
                biphase_s_decode(raw)])
            t = self.decode_frame(bits[:FRAME_BITS])
            out.extend(t)
        return out

    # ------------------------------------------------------------------ #

    def decode_frame(self, frame_bits):
        """One 600-bit frame (two subframes) -> telemetry list."""
        results = []
        gps_chk_sum = 0
        err_frm = 0
        err_blks = 0
        block_err = np.zeros((2, 6), dtype=np.int32)
        subs = []
        for sf in range(2):
            sub = frame_bits[sf * SUBFRAME_BITS:(sf + 1) * SUBFRAME_BITS
                             ].copy()
            for blk in range(6):
                b0 = HEADLEN + blk * 46
                corrected, errors = block_decode(sub[b0:b0 + 46])
                sub[b0:b0 + 46] = corrected
                block_err[sf, blk] = errors if errors >= 0 else 15
                if errors < 0:
                    err_frm += 1
                if errors != 0:
                    err_blks += 1
            subs.append(sub)

        # type word 0x30xx/0x31xx: xx >= 0xC0 -> iMS-100
        typeval = get_w16(subs[0], 7)
        if err_frm == 0:
            self.ims100 = (typeval & 0xFF) >= 0xC0

        if self.ims100:
            t = self._ims100(subs, err_frm, err_blks, block_err)
        else:
            t = self._rs11g(subs, err_frm, err_blks)
        if t:
            results.append(t)
        return results

    # ---- iMS-100 (meisei100mod.c:1019-1280) ----

    def _ims100(self, subs, err_frm, err_blks, block_err):
        g = self.g
        sub0, sub1 = subs
        counter = get_w16(sub0, 0)

        # cfg channel from subframe 0
        if err_frm == 0 and block_err[0, 0] < 2 and block_err[0, 1] < 2:
            w0 = get_w16(sub0, 2)
            w1 = get_w16(sub0, 3)
            w32 = (w1 << 16) | w0
            fv = _f32le(w32)
            self.cfg[counter % 64] = fv
            self.cfg_valid |= 1 << (counter % 64)
            if counter % 0x10 == 0:
                self.sn = fv
            if counter % 64 == 15:
                self.fq = 400e3 + fv * 100.0
            if counter % 4 == 0:
                self.f_ref = get_w16(sub0, 1)
            if counter % 4 == 3:
                self.f_ref = get_w16(sub0, 6)

        if counter % 2 == 0:
            g["frnr"] = counter
            ms = bits2val(sub0[HEADLEN + 5 * 46:HEADLEN + 5 * 46 + 16], 16)
            g["std"] = bits2val(
                sub0[HEADLEN + 5 * 46 + 17:HEADLEN + 5 * 46 + 25], 8)
            g["minute"] = bits2val(
                sub0[HEADLEN + 5 * 46 + 25:HEADLEN + 5 * 46 + 33], 8)
            g["sek"] = ms / 1000.0
            self._ims100_ptu(sub0)

        # subframe 1: GPS words + checksum
        gps_chk = 0
        for j in (10, 11):
            gps_chk += get_w16(sub0, j)
        for j in range(11):
            gps_chk += get_w16(sub1, j)
        gps_err = (gps_chk & 0xFFFF) != get_w16(sub1, 11)

        if counter % 2 == 0:
            dat2 = bits2val(sub1[HEADLEN:HEADLEN + 16], 16)
            g["tag"] = dat2 // 1000
            g["monat"] = (dat2 // 10) % 100
            g["jahr"] = est_year_ims100(dat2 % 10, self.ref_year)
            lat = (get_w16(sub1, 1) << 16) | get_w16(sub1, 2)
            lon = (get_w16(sub1, 3) << 16) | get_w16(sub1, 4)
            alt = (get_w16(sub1, 5) << 8) | \
                bits2val(sub1[HEADLEN + 46 * 3:HEADLEN + 46 * 3 + 8], 8)
            latdeg = int(lat / 1e6)
            g["lat"] = latdeg + (lat / 1e6 - latdeg) * 100.0 / 60.0
            londeg = int(lon / 1e6)
            g["lon"] = londeg + (lon / 1e6 - londeg) * 100.0 / 60.0
            g["alt"] = alt / 1e2
            g["vD"] = get_w16(sub1, 9) / 1e2
            g["vH"] = get_w16(sub1, 10) / 1.94384e2
            g["frm0_count"] = counter
            g["frm0_valid"] = (err_frm == 0 and not gps_err)
            return None
        else:
            vu = get_w16(sub1, 1)
            if vu & 0x8000:
                vu -= 0x10000
            g["vV"] = vu / 1.94384e1
            g["vV_valid"] = vu != 0
            g["frm1_count"] = counter
            g["frm1_valid"] = (err_frm == 0 and not gps_err)
            if g["frm0_valid"]:
                g["frm0_valid"] = False
                return self._emit("IMS100")
        return None

    def _ims100_ptu(self, sub0):
        """Thermistor interpolation + RH polynomial
        (meisei100mod.c:1090-1140)."""
        g = self.g
        g["T"] = float("nan")
        g["RH"] = float("nan")
        if self.f_ref == 0:
            return
        T_cfg = (self.cfg_valid & 0x01E01FFE1FFE0000) == 0x01E01FFE1FFE0000
        U_cfg = (self.cfg_valid & 0x001E000000000000) == 0x001E000000000000
        cfg = self.cfg
        if T_cfg and self._sane_T_table(33, 12):
            t_raw = get_w16(sub0, 5)
            f = (t_raw / self.f_ref) * 4.0
            if f > 1.0:
                f = 1.0 / (f - 1.0)
                R = cfg[53] + cfg[54] * f + cfg[55] * f * f - cfg[56]
                if R <= cfg[33]:
                    g["T"] = cfg[17]
                elif R >= cfg[44]:
                    g["T"] = cfg[28]
                else:
                    for j in range(11):
                        if R < cfg[34 + j]:
                            fr = (np.log(R) - np.log(cfg[33 + j])) / \
                                (np.log(cfg[34 + j]) - np.log(cfg[33 + j]))
                            g["T"] = cfg[17 + j] - \
                                fr * (cfg[17 + j] - cfg[18 + j])
                            break
        if U_cfg:
            u_raw = get_w16(sub0, 6)
            f = (u_raw / self.f_ref) * 4.0
            rh = cfg[49] + cfg[50] * f + cfg[51] * f**2 + cfg[52] * f**3
            g["RH"] = float(np.clip(rh, 0.0, 100.0))

    def _sane_T_table(self, r_base, n):
        cfg = self.cfg
        R_old, T_old = 0.0, np.inf
        for i in range(n):
            if cfg[r_base + i] <= R_old:
                return False
            R_old = cfg[r_base + i]
        for i in range(n):
            if cfg[17 + i] >= T_old:
                return False
            T_old = cfg[17 + i]
        return True

    # ---- RS-11G (meisei100mod.c:780-1016) ----

    def _rs11g(self, subs, err_frm, err_blks):
        g = self.g
        sub0, sub1 = subs
        counter = get_w16(sub0, 0)
        if err_blks == 0:
            w0 = get_w16(sub0, 2)
            w1 = get_w16(sub0, 3)
            w32 = (((w1 & 0xFF00) >> 8 | (w1 & 0xFF) << 8) << 16) | \
                ((w0 & 0xFF00) >> 8 | (w0 & 0xFF) << 8)
            fv = _f32le(w32)
            self.cfg[counter % 64] = fv
            self.cfg_valid |= 1 << (counter % 64)
            if counter % 16 == 0:
                self.sn = fv
            if counter % 64 == 15:
                self.fq = 403700 + fv * 100.0
            if counter % 4 == 0:
                self.f_ref = get_w16(sub0, 1)

        if counter % 2 == 0:
            if err_blks == 0:
                g["frnr"] = counter
                lat = (get_w16(sub1, 1) << 16) | get_w16(sub1, 2)
                lon = (get_w16(sub1, 3) << 16) | get_w16(sub1, 4)
                alt = (get_w16(sub1, 5) << 16) | get_w16(sub1, 6)
                if lat & 0x80000000:
                    lat -= 0x100000000
                if lon & 0x80000000:
                    lon -= 0x100000000
                if alt & 0x80000000:
                    alt -= 0x100000000
                g["lat"] = lat / 1e7
                g["lon"] = lon / 1e7
                g["alt"] = alt / 1e2
                g["vH"] = get_w16(sub1, 7) / 1e2
                g["vD"] = get_w16(sub1, 8) / 1e2
                vu = get_w16(sub1, 9)
                if vu & 0x8000:
                    vu -= 0x10000
                g["vV"] = vu / 1e2
                jj = bits2val(sub1[HEADLEN + 5 * 46 + 8:
                                   HEADLEN + 5 * 46 + 16], 8) + 0x700
                mm = bits2val(sub1[HEADLEN + 5 * 46 + 17:
                                   HEADLEN + 5 * 46 + 25], 8)
                tt = bits2val(sub1[HEADLEN + 5 * 46 + 25:
                                   HEADLEN + 5 * 46 + 33], 8)
                if jj > 1980 and 0 < mm < 13 and 0 < tt < 32:
                    g["jahr"], g["monat"], g["tag"] = jj, mm, tt
            return None
        else:
            if err_blks == 0:
                ms = (bits2val(sub0[HEADLEN + 5 * 46 + 8:
                                    HEADLEN + 5 * 46 + 16], 8) << 8) | \
                    bits2val(sub0[HEADLEN + 5 * 46:
                                  HEADLEN + 5 * 46 + 8], 8)
                std = bits2val(sub0[HEADLEN + 5 * 46 + 17:
                                    HEADLEN + 5 * 46 + 25], 8)
                minute = bits2val(sub0[HEADLEN + 5 * 46 + 25:
                                       HEADLEN + 5 * 46 + 33], 8)
                if std < 24 and minute < 60 and ms < 60000:
                    g["std"], g["minute"], g["sek"] = std, minute, ms / 1e3
                g["frnr1"] = counter
                if g["frnr1"] - g["frnr"] == 1:
                    return self._emit("RS11G")
        return None

    # ------------------------------------------------------------------ #

    def _emit(self, subtype):
        g = self.g
        sid = f"{self.sn:.0f}" if 0 < self.sn < 1e9 else "xxxxxx"
        telem = {
            "type": "MEISEI",
            "frame": g["frnr"],
            "id": f"{subtype}-{sid}",
            "datetime": (f"{g['jahr']:04d}-{g['monat']:02d}-{g['tag']:02d}"
                         f"T{g['std']:02d}:{g['minute']:02d}:"
                         f"{g['sek']:06.3f}Z"),
            "lat": round(g["lat"], 5),
            "lon": round(g["lon"], 5),
            "alt": round(g["alt"], 5),
            "vel_h": round(g["vH"], 5),
            "heading": round(g["vD"], 5),
            "subtype": subtype,
            "ref_datetime": "UTC",
            "ref_position": "MSL",
        }
        if subtype == "RS11G":
            telem["vel_v"] = round(g["vV"], 5)
        elif g["frm1_valid"] and g["frm1_count"] == g["frm0_count"] + 1 \
                and g["vV_valid"]:
            telem["vel_v"] = round(g["vV"], 5)
        if not np.isnan(g["T"]):
            telem["temp"] = round(g["T"], 1)
        if not np.isnan(g["RH"]):
            telem["humidity"] = round(g["RH"], 1)
        if self.jsn_freq_khz:
            telem["freq"] = self.jsn_freq_khz
        if self.fq > 0:
            telem["tx_frequency"] = round(self.fq)
        return telem


# --------------------------------------------------------------------------- #
# encoder fixture (iMS-100)
# --------------------------------------------------------------------------- #

def _nmea_enc(deg):
    d = int(deg)
    return int(round((d + (deg - d) * 60.0 / 100.0) * 1e6))


def encode_subframes_ims100(counter, sn=2304123.0, lat=36.1, lon=140.08,
                            alt=12000.0, vH=8.5, vD=120.0, vV=-4.2,
                            date=(2023, 5, 17), time=(11, 22, 33.5),
                            cfg_val=None):
    """One 600-bit iMS-100 frame (both subframes) for a given counter."""
    yy, mm, dd = date
    hh, mi, ss = time
    w0 = [0] * 12
    w1 = [0] * 12
    w0[0] = counter & 0xFFFF
    if cfg_val is None:
        cfg_val = _f32_to_u32(sn) if counter % 16 == 0 else 0
    w0[2] = cfg_val & 0xFFFF
    w0[3] = (cfg_val >> 16) & 0xFFFF
    w0[1] = 800            # f_ref (counter%4==0 slot)
    w0[6] = 800            # f_ref (counter%4==3 slot)
    w0[7] = 0x30C1         # iMS-100 type marker
    ms = int(round(ss * 1000))
    w0[10] = ms & 0xFFFF
    w0[11] = (hh << 8) | mi          # std = top byte, min = low byte

    lat_i = _nmea_enc(lat)
    lon_i = _nmea_enc(lon)
    alt_i = int(round(alt * 100))
    dat2 = dd * 1000 + mm * 10 + (yy % 10)
    w1[0] = dat2 & 0xFFFF
    w1[1] = (lat_i >> 16) & 0xFFFF
    w1[2] = lat_i & 0xFFFF
    w1[3] = (lon_i >> 16) & 0xFFFF
    w1[4] = lon_i & 0xFFFF
    w1[5] = (alt_i >> 8) & 0xFFFF
    w1[6] = ((alt_i & 0xFF) << 8)    # alt low byte + padding
    if counter % 2 == 0:
        w1[9] = int(round(vD * 100)) & 0xFFFF
        w1[10] = int(round(vH * 1.94384 * 100)) & 0xFFFF
    else:
        w1[1] = int(round(vV * 1.94384 * 10)) & 0xFFFF
    # GPS checksum: sum of sub0 w16[10..11] + sub1 w16[0..10] == w16[11]
    chk = (w0[10] + w0[11] + sum(w1[:11])) & 0xFFFF
    w1[11] = chk

    def build(hdr_bits, w):
        bits = np.array([int(c) for c in hdr_bits], dtype=np.uint8)
        blocks = [block_encode(w[2 * j], w[2 * j + 1]) for j in range(6)]
        return np.concatenate([bits] + blocks)

    return np.concatenate([build(HEADER_049DCE, w0),
                           build(HEADER_FB6230, w1)])


def frames_to_raw_bits(frame_bits_list):
    """Decoded 600-bit frames -> continuous raw biphase-S stream."""
    out = []
    lvl = 0
    for fb in frame_bits_list:
        raw = biphase_s_encode(fb, level0=lvl)
        lvl = int(raw[-1])
        out.append(raw)
    return np.concatenate(out)
