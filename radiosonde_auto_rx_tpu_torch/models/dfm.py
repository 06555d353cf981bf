"""Graw DFM-06/09/17 frame codec (2.5 kBd, Manchester, Hamming(8,4)).

Frame structure and telemetry semantics follow the on-air protocol as
documented by the reference decoder (reference demod/mod/dfm09mod.c):
280-bit frame = 16-bit header + CONF(56) + DAT1(104) + DAT2(104) (:174-180);
column interleaving over 8-bit Hamming codewords (:232-239); Hamming(8,4)
generator/parity (:183-198) with 1-bit syndrome correction and soft-decision
2-bit correction (:241-312); CONF channel float24 measurements (:807-820);
DAT packet ids 0..8 carrying a SiRF-style geodetic nav solution (:345-525);
serial-number confirmation logic for DFM-06 (SN6) and DFM-09/17 (two 16-bit
halves) (:690-801); NTC thermistor temperature (:531-560); JSON output
fields (:1100-1147).  The implementation (batch numpy + encoder fixture) is
new.
"""

import datetime

import numpy as np

from radiosonde_auto_rx_tpu_torch.models import register

RAW_HEADER = "10011010100110010101101001010101"   # Manchester2 of 0x45CF
HEADER = "0100010111001111"
BAUD = 2500          # decoded bit rate; raw Manchester runs at 5000 bd
FRAME_BITS = 280     # decoded bits incl. 16-bit header
CONF, DAT1, DAT2 = 16, 16 + 56, 16 + 160
XDATA_LEN = 26

DFM_TYPES = {0x6: "DFM06", 0x7: "DFM06P", 0x8: "DFM06P", 0xA: "DFM09",
             0xB: "DFM17", 0xC: "DFM09P", 0xD: "DFM17P"}

# Hamming(8,4) systematic generator / parity check (dfm09mod.c:183-198)
G = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1],
              [0, 1, 1, 1], [1, 0, 1, 1], [1, 1, 0, 1], [1, 1, 1, 0]],
             dtype=np.uint8)
H = np.array([[0, 1, 1, 1, 1, 0, 0, 0], [1, 0, 1, 1, 0, 1, 0, 0],
              [1, 1, 0, 1, 0, 0, 1, 0], [1, 1, 1, 0, 0, 0, 0, 1]],
             dtype=np.uint8)
HE = np.array([0x7, 0xB, 0xD, 0xE, 0x8, 0x4, 0x2, 0x1], dtype=np.uint8)
CODEWORDS = (G[None, :, :] * ((np.arange(16)[:, None] >>
                               np.arange(3, -1, -1)[None, :]) & 1
                              )[:, None, :].astype(np.uint8)
             ).sum(axis=2) % 2   # [16, 8]


def bits2val(bits, n=None):
    bits = np.asarray(bits, dtype=np.uint64)
    if n is not None:
        bits = bits[:n]
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def val2bits(v, n):
    return np.array([(v >> (n - 1 - i)) & 1 for i in range(n)],
                    dtype=np.uint8)


def deinterleave(bits, L):
    """[L*8] column-interleaved stream -> L codewords of 8 bits
    (dfm09mod.c:232-239: block[8*i+j] = str[L*j+i])."""
    return np.asarray(bits).reshape(8, L).T.copy()   # [L, 8]


def interleave(cw, L):
    return np.asarray(cw).reshape(L, 8).T.reshape(-1).copy()


def hamming_decode(cw, soft=None):
    """Decode L×8 codewords -> (L×4 nibble bits, err_count, hard_fail).

    1-bit syndrome correction; unresolved syndromes fall back to the
    soft-decision distance-2 search over the 16 codewords when soft values
    are given (dfm09mod.c:241-312).
    """
    cw = np.asarray(cw, dtype=np.uint8).copy()
    L = cw.shape[0]
    syn = (cw @ H.T) % 2                                  # [L, 4]
    synval = (syn * (1 << np.arange(3, -1, -1))).sum(axis=1)
    nerr = 0
    fail = False
    for i in range(L):
        if synval[i] == 0:
            continue
        hit = np.flatnonzero(HE == synval[i])
        if len(hit):
            cw[i, hit[0]] ^= 1
            nerr += 1
        elif soft is not None:
            d = (cw[i][None, :] != CODEWORDS).sum(axis=1)
            cand = np.flatnonzero(d == 2)
            if len(cand):
                corr = ((2.0 * CODEWORDS[cand] - 1.0) * soft[i]).sum(axis=1)
                cw[i] = CODEWORDS[cand[np.argmax(corr)]]
                nerr += 2
            else:
                fail = True
        else:
            fail = True
    return cw[:, :4], nerr, fail


def hamming_encode(nibbles):
    """[L] nibble values -> [L*8] interleaved codeword bits."""
    L = len(nibbles)
    msg = ((np.asarray(nibbles, dtype=np.uint8)[:, None] >>
            np.arange(3, -1, -1)[None, :]) & 1).astype(np.uint8)
    cw = (msg @ G.T) % 2
    return interleave(cw.astype(np.uint8), L)


def fl24(v):
    """DFM-09 float24: 4-bit exponent + 20-bit mantissa (dfm09mod.c:547-554)."""
    p = (v >> 20) & 0xF
    return (v & 0xFFFFF) / float(1 << p)


def datetime2gpsweek(yy, mm, dd, hr, mi, sec):
    if mm < 3:
        yy -= 1
        mm += 12
    gps_days = int(365.25 * yy) + int(30.6001 * (mm + 1.0)) + dd - 723263
    week = gps_days // 7
    tow = (gps_days % 7) * 86400 + hr * 3600 + mi * 60 + sec
    return week, tow


def manchester_decode(raw_bits, variant=2):
    """Pairs -> bits.  Manchester2 (DFM-09): 01->1, 10->0; Manchester1
    (DFM-06) is the complement (dfm09mod.c:1667-1668)."""
    raw = np.asarray(raw_bits, dtype=np.uint8)
    n = (len(raw) // 2) * 2
    second = raw[1:n:2]
    return second if variant == 2 else (second ^ 1)


def manchester_encode(bits, variant=2):
    b = np.asarray(bits, dtype=np.uint8)
    if variant != 2:
        b = b ^ 1
    out = np.empty(2 * len(b), dtype=np.uint8)
    out[0::2] = b ^ 1
    out[1::2] = b
    return out


@register("DFM")
class DFMDecoder:
    """Stateful DFM frame decoder: raw Manchester bit stream -> telemetry."""

    HEADER = RAW_HEADER

    def __init__(self, jsn_freq_khz: int = 0, dist_check: bool = True,
                 max_pck_err: int = 4):
        self.jsn_freq_khz = jsn_freq_khz
        self.dist_check = dist_check
        self.max_pck_err = max_pck_err
        self._frmcnt = 0.0
        self.reset_sonde()

    def reset_sonde(self):
        self.sonde_typ = 0
        self.sn6 = 0
        self.sn = 0
        self.sn_out = ""
        self.snc = dict(max_ch=0, nul_ch=0, sn_ch=0, chXbit=0, SN_X=0,
                        chX=[0, 0])
        self.meas24 = np.zeros(9)
        self.cfgchk24 = np.zeros(9, dtype=bool)
        self.cfgchk = False
        self.ptu_out = 0
        self.status = [0.0, 0.0, 0.0]
        self.pck_ec = {i: -1 for i in range(9)}
        self.pck_ts = {i: -1e9 for i in range(9)}
        self.nav = dict(lat=0.0, lon=0.0, alt=0.0, horiV=0.0, dir=0.0,
                        vertV=0.0, sek=0.0, frnr=0, posmode=2,
                        jahr=0, monat=0, tag=0, std=0, minute=0,
                        nSV=0, nPRN=0, prn=0, dMSL=0.0)
        self.xdata = np.zeros(XDATA_LEN, dtype=np.uint8)
        self.inverted = False

    # ------------------------------------------------------------------ #

    #: consecutive frames decoded per header detection; DFM transmits
    #: back-to-back, so trailing frames whose own header was corrupted
    #: are still recovered (dfm09mod.c:1309 nfrms=8, :1656-1714)
    NFRMS = 8

    def decode_bits(self, raw_bits: np.ndarray, soft=None):
        """Raw 5000 bd Manchester bit stream -> list of telemetry dicts.

        Auto-polarity: searches both the header and its complement
        (reference --auto, dfm09mod.c:1652-1671).  Each header hit seeds
        up to NFRMS consecutive frame reads at the 560-raw-bit frame
        stride.  When soft values are given, both Manchester halves are
        integrated (s = s2 - s1) for the hard and soft bit decisions
        (dfm09mod.c:1685)."""
        from radiosonde_auto_rx_tpu_torch.demod.framing import find_frame_starts
        raw_bits = np.asarray(raw_bits, dtype=np.uint8)
        stride = 2 * FRAME_BITS          # raw bits per frame incl. header
        results = []
        for inv, hdr in ((False, RAW_HEADER),
                         (True, "".join("1" if c == "0" else "0"
                                        for c in RAW_HEADER))):
            starts = [int(s) for s in
                      find_frame_starts(raw_bits, hdr, max_errors=2)]
            cands = set()
            for s in starts:
                for k in range(self.NFRMS):
                    p = s + k * stride
                    if p + 2 * (FRAME_BITS - 16) > len(raw_bits):
                        break
                    cands.add(p)

            def support(p):
                # header hits on p's frame lattice: back-to-back frames
                # give one a frame, data that looks like the header one
                return sum(min((p - h) % stride, (h - p) % stride) <= 2
                           for h in starts)
            # a continuation frame may land a bit or two off another
            # header's hit; never decode the same frame twice, and where
            # two candidates overlap keep the better supported one, so
            # that a header-like pattern inside a frame cannot shadow the
            # true frames after it (the earlier one on a tie)
            done = []
            for p in sorted(cands, key=lambda p: (-support(p), p)):
                if all(abs(p - q) >= stride // 2 for q in done):
                    done.append(p)
            for p in sorted(done):
                raw = raw_bits[p - len(RAW_HEADER):
                               p + 2 * (FRAME_BITS - 16)]
                if inv:
                    raw = raw ^ 1
                if len(raw) < 2 * FRAME_BITS:
                    continue
                bits = manchester_decode(raw, variant=2)
                fsoft = None
                if soft is not None:
                    sraw = soft[p - len(RAW_HEADER):p + 2 * (FRAME_BITS - 16)]
                    sraw = sraw * (-1.0 if inv else 1.0)
                    # integrate both Manchester symbols: first half is
                    # the complement, so the combined statistic is
                    # second minus first (dfm09mod.c:1685)
                    fsoft = sraw[1::2] - sraw[0::2]
                    bits = (fsoft >= 0.0).astype(np.uint8)
                self.inverted = inv
                self._frmcnt += 1.0
                t = self.decode_frame(bits[:FRAME_BITS],
                                      None if fsoft is None
                                      else fsoft[:FRAME_BITS])
                if t:
                    results.append(t)
        return results

    # ------------------------------------------------------------------ #

    def decode_frame(self, frame_bits: np.ndarray, soft=None):
        """One 280-bit decoded frame -> telemetry dict or None
        (dfm09mod.c print_frame :1152-1187 + dat_out/conf_out)."""
        def blk(pos, L):
            cw = deinterleave(frame_bits[pos:pos + L * 8], L)
            sft = None
            if soft is not None:
                sft = np.asarray(
                    [soft[pos:pos + L * 8].reshape(8, L).T[i]
                     for i in range(L)])
            return hamming_decode(cw, sft)

        conf, ec0, f0 = blk(CONF, 7)
        dat1, ec1, f1 = blk(DAT1, 13)
        dat2, ec2, f2 = blk(DAT2, 13)

        self.conf_out(conf.reshape(-1), ec0 if not f0 else -1)
        out = None
        for dat, ec, fail in ((dat1, ec1, f1), (dat2, ec2, f2)):
            fr_id = self.dat_out(dat.reshape(-1), -1 if fail else ec)
            if fr_id == 8 and out is None:
                out = self.emit_json()
        return out

    # ------------------------------------------------------------------ #
    # CONF channel (dfm09mod.c conf_out :690-900)

    def conf_out(self, conf_bits, ec):
        conf_id = bits2val(conf_bits[:4], 4)
        if conf_id > 4 and bits2val(conf_bits[8:28], 20) == 0:
            self.snc["nul_ch"] = bits2val(conf_bits[:8], 8)

        dfm6typ = ((self.snc["nul_ch"] & 0xF0) == 0x50) and \
                  (self.snc["nul_ch"] & 0x0F)
        if dfm6typ:
            self.ptu_out = 6
            if (self.sonde_typ & 0xF) > 6:
                self.sonde_typ = 0
                self.snc["max_ch"] = conf_id

        if conf_id > 5 and conf_id > self.snc["max_ch"] and ec == 0:
            if bits2val(conf_bits[4:8], 4) == 0xC:
                self.snc["max_ch"] = conf_id

        if conf_id > 5 and (conf_id == (self.snc["nul_ch"] >> 4) + 1
                            or conf_id == self.snc["max_ch"]):
            sn2_ch = bits2val(conf_bits[:8], 8)
            sn_ch = (sn2_ch >> 4) & 0xF
            if (self.snc["nul_ch"] & 0x58) == 0x58:          # DFM-06
                sn6 = bits2val(conf_bits[4:28], 24)
                if sn6 == self.sn6 and sn6 != 0:
                    self.sonde_typ = 0x100 | sn_ch
                    self.ptu_out = 6
                    self.sn_out = f"{sn6:6X}".strip()
                else:
                    self.sonde_typ = 0
                self.sn6 = sn6
            elif (sn2_ch & 0xF) in (0xC, 0x0):               # DFM-09/17/PS15
                val = bits2val(conf_bits[8:28], 20)
                hl = val & 0xF
                if hl < 2:
                    if self.snc["sn_ch"] != sn_ch:
                        self.snc["chXbit"] = 0
                        self.snc["chX"] = [0, 0]
                    self.snc["sn_ch"] = sn_ch
                    self.snc["chX"][hl] = (val >> 4) & 0xFFFF
                    self.snc["chXbit"] |= 1 << hl
                    if self.snc["chXbit"] == 3:
                        sn = (self.snc["chX"][0] << 16) | self.snc["chX"][1]
                        if sn == self.snc["SN_X"] or self.snc["SN_X"] == 0:
                            self.sonde_typ = 0x100 | sn_ch
                            self.sn = sn
                            self.ptu_out = sn_ch if sn_ch in \
                                (0xA, 0xB, 0xC, 0xD) else 0
                            if self.sn6 == 0 or (self.sonde_typ & 0xF) >= 0xA:
                                self.sn_out = f"{sn:6d}".strip()
                        else:
                            self.sonde_typ = 0
                        self.snc["SN_X"] = sn
                        self.snc["chXbit"] = 0

        if 0 <= conf_id <= 8 and ec == 0:
            self.cfgchk24[conf_id] = True
            self.meas24[conf_id] = fl24(bits2val(conf_bits[4:28], 24))
            chk = bool(np.all(self.cfgchk24[:6])) if self.ptu_out >= 0x5 \
                else False
            if self.ptu_out >= 0x7:
                chk = chk and self.cfgchk24[6] and self.cfgchk24[7]
            if self.ptu_out >= 0x8:
                chk = chk and self.cfgchk24[8]
            self.cfgchk = chk

        # sensor type / Rf / status channels (dfm09mod.c:826-867)
        self.sensortyp = "T"
        self.rf = 220e3
        if self.cfgchk:
            if self.ptu_out >= 0xD or (self.ptu_out >= 0xC
                                       and self.meas24[6] < 220e3):
                self.sensortyp = "P"
            if ((self.ptu_out in (0xB, 0xC) and self.sensortyp == "T")
                    or self.ptu_out >= 0xD):
                self.rf = 332e3
            if self.ptu_out >= 0xA:
                ofs = 2 if self.sensortyp == "P" else 0
                if conf_id == 0x5 + ofs:
                    self.status[0] = bits2val(conf_bits[8:24], 16) / 1000.0
                if conf_id == 0x6 + ofs:
                    self.status[1] = bits2val(conf_bits[8:24], 16) / 100.0

    # ------------------------------------------------------------------ #
    # DAT packets (dfm09mod.c dat_out :345-525, posmode<=2)

    def dat_out(self, dat_bits, ec):
        nav = self.nav
        fr_id = bits2val(dat_bits[48:52], 4)
        if 0 <= fr_id <= 8:
            ecv = ec
            if ec > 0 and ec > self.max_pck_err:
                ecv = -2
            self.pck_ec[fr_id] = ecv
            self.pck_ts[fr_id] = self._frmcnt
        if ec < 0:
            return -1

        if fr_id == 0:
            mode = bits2val(dat_bits[16:24], 8)
            nav["posmode"] = mode if 1 < mode < 5 else -1
            nav["frnr"] = bits2val(dat_bits[24:32], 8)
        if nav["posmode"] <= 2:
            if fr_id == 1:
                nav["prn"] = bits2val(dat_bits[0:32], 32)
                nav["nPRN"] = bin(nav["prn"]).count("1")
                nav["sek"] = bits2val(dat_bits[32:48], 16) / 1000.0
            elif fr_id == 2:
                nav["lat"] = np.array(bits2val(dat_bits[0:32], 32)).astype(np.uint32).astype(np.int32) / 1e7
                nav["horiV"] = np.array(bits2val(dat_bits[32:48], 16)).astype(np.uint16).astype(np.int16) / 1e2
            elif fr_id == 3:
                nav["lon"] = np.array(bits2val(dat_bits[0:32], 32)).astype(np.uint32).astype(np.int32) / 1e7
                nav["dir"] = bits2val(dat_bits[32:48], 16) / 1e2
            elif fr_id == 4:
                nav["alt"] = np.array(bits2val(dat_bits[0:32], 32)).astype(np.uint32).astype(np.int32) / 1e2
                nav["vertV"] = np.array(bits2val(dat_bits[32:48], 16)).astype(np.uint16).astype(np.int16) / 1e2
            elif fr_id == 5:
                nav["dMSL"] = np.array(bits2val(dat_bits[0:16], 16)).astype(np.uint16).astype(np.int16) / 1e2
        if fr_id == 8:
            nav["jahr"] = bits2val(dat_bits[0:12], 12)
            nav["monat"] = bits2val(dat_bits[12:16], 4)
            nav["tag"] = bits2val(dat_bits[16:21], 5)
            nav["std"] = bits2val(dat_bits[21:26], 5)
            nav["minute"] = bits2val(dat_bits[26:32], 6)
            nav["nSV"] = bits2val(dat_bits[32:40], 8)
        return fr_id

    # ------------------------------------------------------------------ #

    def get_temp(self):
        """NTC thermistor temperature (dfm09mod.c get_Temp :531-560)."""
        if not (self.cfgchk and self.ptu_out):
            return -273.15
        m = self.meas24
        if getattr(self, "sensortyp", "T") == "P":
            f, f1, f2 = m[1], m[5], m[6]
        else:
            f, f1, f2 = m[0], m[3], m[4]
        B0, T0, R0 = 3260.0, 25 + 273.15, 5.0e3
        g = f2 / self.rf
        R = (f - f1) / g if g != 0 else 0.0
        if f * f1 * f2 == 0:
            R = 0.0
        if R > 0:
            return 1.0 / (1.0 / T0 + np.log(R / R0) / B0) - 273.15
        return -273.15

    def emit_json(self):
        """Assemble the telemetry dict after pck8 (dfm09mod.c:905-1147)."""
        nav = self.nav
        ok = all(self.pck_ec.get(i, -1) >= 0 and
                 self._frmcnt - self.pck_ts[i] < 6.0
                 for i in (0, 1, 2, 3, 4, 8))
        for i in range(9):
            self.pck_ec[i] = -1
        if not ok or not (nav["sek"] < 60.0):
            return None
        week, tow = datetime2gpsweek(nav["jahr"], nav["monat"], nav["tag"],
                                     nav["std"], nav["minute"],
                                     int(nav["sek"] + 0.5))
        sec_gps = week * 604800 + tow
        sid = f"DFM-{self.sn_out}" if self.sn_out else "DFM-xxxxxxxx"
        sek = nav["sek"]
        dt = (f"{nav['jahr']:04d}-{nav['monat']:02d}-{nav['tag']:02d}"
              f"T{nav['std']:02d}:{nav['minute']:02d}:{sek:06.3f}Z")
        telem = {
            "type": "DFM",
            "frame": sec_gps,
            "id": sid,
            "datetime": dt,
            "lat": round(nav["lat"], 5),
            "lon": round(nav["lon"], 5),
            "alt": round(nav["alt"], 5),
            "vel_h": round(nav["horiV"], 5),
            "heading": round(nav["dir"], 5),
            "vel_v": round(nav["vertV"], 5),
            "sats": nav["nSV"] if nav["nSV"] else nav["nPRN"],
            "ref_datetime": "UTC",
            "ref_position": "GPS" if nav["posmode"] <= 2 else "MSL",
        }
        if self.ptu_out >= 0xA and self.status[0] > 0:
            telem["batt"] = round(self.status[0], 2)
        T = self.get_temp()
        if T > -270.0:
            telem["temp"] = round(T, 1)
        typ = self.sonde_typ & 0xF
        if typ > 0:
            sub = f"0x{typ:1X}"
            if typ in DFM_TYPES:
                sub += f":{DFM_TYPES[typ]}"
            telem["subtype"] = sub
        if self.jsn_freq_khz:
            telem["freq"] = self.jsn_freq_khz
        return telem


# --------------------------------------------------------------------------- #
# encoder fixture
# --------------------------------------------------------------------------- #

def _make_dat(fr_id, payload48):
    bits = np.zeros(52, dtype=np.uint8)
    bits[:48] = val2bits(payload48, 48)
    bits[48:52] = val2bits(fr_id, 4)
    nibs = [bits2val(bits[4 * i:4 * i + 4], 4) for i in range(13)]
    return hamming_encode(nibs)


def _make_conf(conf_id, val24):
    bits = np.concatenate([val2bits(conf_id, 4), val2bits(val24, 24)])
    nibs = [bits2val(bits[4 * i:4 * i + 4], 4) for i in range(7)]
    return hamming_encode(nibs)


def encode_frame(conf_id, val24, dat1_id, dat1_pay, dat2_id, dat2_pay):
    """Build one 280-bit decoded DFM frame (header + conf + dat1 + dat2)."""
    hdr = np.array([int(c) for c in HEADER], dtype=np.uint8)
    return np.concatenate([hdr, _make_conf(conf_id, val24),
                           _make_dat(dat1_id, dat1_pay),
                           _make_dat(dat2_id, dat2_pay)])


def fl24_encode(f, p=4):
    """Inverse of fl24 for fixture values."""
    return ((p & 0xF) << 20) | (int(round(f * (1 << p))) & 0xFFFFF)


def encode_flight_bits(sn=21012345, lat=51.3, lon=6.88, alt=10000.0,
                       vel_h=5.2, heading=180.0, vel_v=-3.5,
                       date=(2018, 6, 1, 12, 30, 15.0), n_cycles=3,
                       meas=None, time_step=0.0):
    """Raw Manchester bit stream for a DFM-09 flight segment: cycles of
    frames covering conf channels 0..6 and dat packets 0..8.

    ``time_step`` (seconds) advances the GPS date by that much per cycle
    so each cycle carries a distinct timestamp — a real sonde ticks 1 s
    per cycle; the PER harness needs distinct frame identities."""
    if meas is None:
        # f=meas[0], f1=meas[3], f2=meas[4]: R=(f-f1)*Rf/f2 ≈ 13968 Ω
        # = R25·2.7936 → T ≈ 0 C with Rf=220k (dfm09mod.c get_Temp)
        meas = [1317.45, 900.0, 2000.0, 1000.0, 5000.0,
                3.0, 2500.0, 7.0, 9.0]
    import datetime as _dt
    yy, mm, dd, hh, mi, sek = date

    def _dats(cyc):
        t = (_dt.datetime(yy, mm, dd, hh, mi) +
             _dt.timedelta(seconds=sek + cyc * time_step))
        msek = int((t.second + t.microsecond / 1e6) * 1000)
        # frnr is the sonde's 1 Hz frame counter; dfm09mod only emits
        # JSON while (sec_gps % 256 - frnr) stays constant frame-to-
        # frame (dfm09mod.c:941-950), so tick it with GPS time.
        wk, tow = datetime2gpsweek(t.year, t.month, t.day, t.hour,
                                   t.minute, int(t.second))
        frnr = (wk * 604800 + tow) & 0xFF
        return {
            0: (2 << 24) | (frnr << 16),              # mode=2
            1: (0xFF << 16) | msek,                   # prn bitmap | msek
            2: ((int(lat * 1e7) & 0xFFFFFFFF) << 16) |
               (int(vel_h * 100) & 0xFFFF),
            3: ((int(lon * 1e7) & 0xFFFFFFFF) << 16) |
               (int(heading * 100) & 0xFFFF),
            4: ((int(alt * 100) & 0xFFFFFFFF) << 16) |
               (int(vel_v * 100) & 0xFFFF),
            5: 0,
            6: 0,
            7: 0,
            8: (t.year << 36) | (t.month << 32) | (t.day << 27) |
               (t.hour << 22) | (t.minute << 16) | (8 << 8),  # nSV=8
        }
    sn_hi, sn_lo = (sn >> 16) & 0xFFFF, sn & 0xFFFF
    # DFM-09 (STM32): meas channels 0..8, SN in channel 0xA as two 16-bit
    # halves marked 0xAC....[hl] (dfm09mod.c:747-801)
    confs = [(ch, fl24_encode(meas[ch])) for ch in range(9)]
    confs += [(0xA, (0xC << 20) | (sn_hi << 4) | 0),
              (0xA, (0xC << 20) | (sn_lo << 4) | 1)]

    frames = []
    ci = 0
    for cyc in range(n_cycles):
        dats = _dats(cyc)
        dat_ids = list(range(0, 9))
        while dat_ids:
            d1 = dat_ids.pop(0)
            d2 = dat_ids.pop(0) if dat_ids else 7
            cid, cval = confs[ci % len(confs)]
            ci += 1
            frames.append(encode_frame(cid, cval, d1, dats[d1], d2, dats[d2]))
    decoded = np.concatenate(frames)
    return manchester_encode(decoded, variant=2)
