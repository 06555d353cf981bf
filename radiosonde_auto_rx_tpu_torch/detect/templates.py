"""Header template bank for sonde-type detection.

Headers, baud rates, Gaussian BT factors, correlation thresholds and
max-header-bit-errors follow the reference detector's table
(reference scan/dft_detect.c:40-195).  Template synthesis uses the same
Gaussian FM pulse p(t) = Q((t-1/2)/sigma) - Q((t+1/2)/sigma) with
sigma = sqrt(ln 2)/(2*pi*BT) (dft_detect.c:975-982) and includes the
neighbor-symbol pulse tails (dft_detect.c:1240-1258).
"""

from dataclasses import dataclass
import math

import numpy as np

_erf = np.vectorize(math.erf)   # avoid a scipy dependency


@dataclass(frozen=True)
class TemplateSpec:
    name: str           # auto_rx type name
    header: str         # header bit string
    sps: int            # header symbol rate (baud)
    bt: float           # Gaussian BT
    thres: float        # correlation detection threshold
    herrs: int          # max header bit errors on re-read
    tn: int             # dft_detect type number (exit code)
    lp_iq: int          # IF lowpass class: 0=6k,1=12k,2=22k,3=200k


# reference scan/dft_detect.c:176-195 (type numbers :156-174)
_H = {
    "DFM": "10011010100110010101101001010101",
    "RS41": "0000100001101101010100111000100001000100011010010100100000011111",
    "RS92": ("10100110011001101001" "10100110011001101001"
             "1010011001100110100110101010100110101001"),
    "LMS6": ("0101011000001000" "0001110010010111"
             "0001101010100111" "0011110100111110"),
    "IMET5": "0000000001" "0101010101" "0001001001" "0001001001",
    "MK2LMS": "0010100111" "0010100111" "0001001001" "0010010101",
    # full 32-bit raw header (demod/mod/m10mod.c:76).  The reference's
    # detect template instead drops 4 leading bits and appends 4 raw bits
    # of the length byte under its pair convention (dft_detect.c:66-67) —
    # with pair/diff encoding both raw polarities occur in the wild, and
    # the full header matches either via inverted detection while the
    # data-tail variant anticorrelates for one of them.
    "M10": "10011001100110010100110010011001",
    "MEISEI": "110011001101001101001101010100101010110010101010",
    "RD94RD41": ("10100110010110101001" "10010101011010010101"
                 "10101001010101010101" "10011001010110101001"),
    "MRZ": "1001100110011001" "1001101010101010",
    "MTS01": "10101010" "10101010" "10110100" "00101011",
    "C34C50": "01010101010101010101010101010101",
    "WXR301": ("10101010" "10101010" "10101010" "00101101" "11010100"),
    "WXRPN9": ("10101010" "10101010" "10101010" "11000001" "10010100"),
    "IMET1AB": ("0000" "11110000111100001111000011110000" "1111"
                "0000" "10101100110010101100101010101100" "1111"),
    # 1200 Hz 0xAA 0xAA AFSK preamble shared by all iMet variants
    # (dft_detect.c imet_preamble :94-98); which variant it is gets
    # resolved by the 2200-vs-2400 Hz tone-power check
    # (dft_detect.c:1542-1607)
    "IMETafsk": ("11110000111100001111000011110000"
                 "11110000111100001111000011110000"),
    "IMET4": ("0000" "1111" "0000" "1111" "0000" "1111" "0000" "1111"),
}

TEMPLATES = [
    TemplateSpec("DFM",      _H["DFM"],      2500, 1.0, 0.65, 2, 2,  1),
    TemplateSpec("RS41",     _H["RS41"],     4800, 0.5, 0.70, 2, 3,  1),
    TemplateSpec("RS92",     _H["RS92"],     4800, 0.5, 0.70, 3, 4,  1),
    TemplateSpec("LMS6",     _H["LMS6"],     4800, 1.0, 0.60, 8, 8,  1),
    TemplateSpec("IMET5",    _H["IMET5"],    4800, 0.5, 0.80, 2, 24, 1),
    TemplateSpec("MK2LMS",   _H["MK2LMS"],   9616, 1.0, 0.70, 2, 18, 2),
    TemplateSpec("M10",      _H["M10"],      9608, 1.0, 0.76, 2, 5,  2),
    TemplateSpec("MEISEI",   _H["MEISEI"],   2400, 1.0, 0.70, 2, 9,  2),
    TemplateSpec("RD94RD41", _H["RD94RD41"], 4800, 1.0, 0.70, 2, 10, 1),
    TemplateSpec("MRZ",      _H["MRZ"],      2400, 1.5, 0.80, 2, 12, 1),
    TemplateSpec("MTS01",    _H["MTS01"],    1200, 1.0, 0.65, 2, 13, 0),
    TemplateSpec("C34C50",   _H["C34C50"],   5800, 1.5, 0.80, 2, 15, 2),
    TemplateSpec("WXR301",   _H["WXR301"],   4800, 1.0, 0.65, 2, 16, 3),
    TemplateSpec("WXRPN9",   _H["WXRPN9"],   5000, 1.0, 0.65, 2, 17, 3),
    TemplateSpec("IMET1AB",  _H["IMET1AB"],  9600, 1.0, 0.80, 2, 29, 3),
    # The iMet family is detected ONLY via the 64-bit AFSK idle preamble
    # + tone-power disambiguation; the short IMET4/IMET1RS headers are
    # never correlated directly (they false-match payload data — the
    # reference's correlate loop stops at idxIMETafsk,
    # dft_detect.c:1517-1518) and exist only as redirect targets.
    TemplateSpec("IMETafsk", _H["IMETafsk"], 9600, 0.5, 0.80, 4, 25, 1),
]

# redirect targets for the IMETafsk tone check (dft_detect.c:1586-1597)
IMET4_SPEC = TemplateSpec("IMET4", _H["IMET4"], 9600, 0.5, 0.80, 2, 26, 1)
IMET1RS_SPEC = TemplateSpec("IMET1RS", _H["IMET4"], 9600, 0.5, 0.80, 2,
                            28, 3)

# 1680 MHz scan set (reference scan.py:488-547: LMS6-1680 via MK2A
# telemetry + RS92-NGP with the narrower --bw 32 filter; iMet-1 RS
# historically also flew at 1680 — reached via the IMETafsk redirect).
# Used with the L-band IF bandwidth table (dft_detect.c -L flag
# :1405-1410).
WIDEBAND_TEMPLATES = [s for s in TEMPLATES
                      if s.name in ("RS92", "MK2LMS", "IMETafsk")]


def q_func(x):
    return 0.5 - 0.5 * _erf(x / math.sqrt(2.0))


def gauss_pulse(t, sigma):
    """Gaussian FM pulse (dft_detect.c:977-982)."""
    return q_func((t - 0.5) / sigma) - q_func((t + 0.5) / sigma)


def make_template(spec: TemplateSpec, fs: int) -> np.ndarray:
    """Matched-filter template at sample rate fs, unit L2 norm.

    Mirrors dft_detect.c init_buffers :1229-1266: per-sample sum of the
    current symbol's pulse plus both neighbors' tails.
    """
    spb = fs / spec.sps
    sigma = math.sqrt(math.log(2.0)) / (2.0 * math.pi * spec.bt)
    bits = np.array([1.0 if c == "1" else -1.0 for c in spec.header])
    L = int(len(bits) * spb)
    i = np.arange(L)
    pos = (i / spb).astype(np.int64)
    t = (i - pos * spb) / spb - 0.5
    b = bits[pos] * gauss_pulse(t, sigma)
    prev = pos > 0
    b[prev] += bits[pos[prev] - 1] * gauss_pulse(t[prev] + 1.0, sigma)
    nxt = pos < len(bits) - 1
    b[nxt] += bits[pos[nxt] + 1] * gauss_pulse(t[nxt] - 1.0, sigma)
    b = b / math.sqrt(float(np.sum(b * b)))
    return b.astype(np.float32)


def build_template_bank(fs: int, specs=None):
    """Zero-padded [Ntypes, Lmax] template bank + per-type lengths."""
    specs = TEMPLATES if specs is None else specs
    tmpls = [make_template(s, fs) for s in specs]
    lmax = max(len(t) for t in tmpls)
    bank = np.zeros((len(tmpls), lmax), dtype=np.float32)
    for i, t in enumerate(tmpls):
        bank[i, :len(t)] = t
    lens = np.array([len(t) for t in tmpls], dtype=np.int64)
    return bank, lens, specs
