"""M-FSK / GFSK modulators and calibrated-noise helpers (test fixtures).

These replace the reference's recorded-IQ test corpus (which is not shipped
in-repo; see reference auto_rx/test/README.md) with synthetic signals:
a phase-continuous modulator equivalent to the reference's fsk_mod_c
(reference utils/fsk.c:321-363) plus the AWGN Eb/N0 calibration used by the
regression harness (reference auto_rx/test/generate_lowsnr.py:82-98).
NumPy on host — only used to build fixtures, never in the signal path.
"""

import math

import numpy as np


def bits_to_symbols(bits: np.ndarray, m: int) -> np.ndarray:
    """Pack bits into M-FSK symbol indices, MSB first (fsk.c:338-347)."""
    bits = np.asarray(bits).astype(np.int64) & 1
    if m == 2:
        return bits
    assert m == 4 and bits.size % 2 == 0
    return (bits[0::2] << 1) | bits[1::2]


def fsk_mod(bits: np.ndarray, fs: int, rs: int, m: int, f1: float,
            tone_spacing: float, phase0: float = 0.0) -> np.ndarray:
    """Phase-continuous complex M-FSK at tone freqs f1 + sym*tone_spacing."""
    ts = fs // rs
    syms = bits_to_symbols(bits, m)
    freqs = f1 + syms.astype(np.float64) * tone_spacing
    finst = np.repeat(freqs, ts)                       # per-sample frequency
    phase = phase0 + 2 * np.pi * np.cumsum(finst) / fs
    return np.exp(1j * phase).astype(np.complex64)


def gfsk_mod(bits: np.ndarray, fs: int, rs: int, m: int, f_centre: float,
             tone_spacing: float, bt: float = 0.5,
             ppm: float = 0.0) -> np.ndarray:
    """Gaussian-shaped M-FSK (what real sondes transmit, e.g. RS41 BT=0.5).

    Frequency pulse = rect(Ts) convolved with a Gaussian of
    sigma = sqrt(ln 2)/(2*pi*BT) symbol periods (reference
    scan/dft_detect.c:977-982 pulse()).
    """
    ts = fs // rs
    syms = bits_to_symbols(bits, m).astype(np.float64)
    dev = (syms - (m - 1) / 2.0) * tone_spacing        # centered deviations
    if ppm or fs % rs:
        # fractional samples-per-symbol: used for a deliberate TX clock
        # offset (real transmitters are never exactly on the receiver's
        # sample grid) and for non-divisible rates (e.g. 9616 Bd on a
        # 240 kHz channel)
        rs_eff = rs * (1.0 + ppm * 1e-6)
        n = int(len(syms) * fs / rs_eff)
        idx = np.minimum((np.arange(n) * (rs_eff / fs)).astype(np.int64),
                         len(syms) - 1)
        finst = dev[idx]
    else:
        finst = np.repeat(dev, ts)
    # Gaussian smoothing of the frequency trajectory
    sigma = math.sqrt(math.log(2.0)) / (2.0 * math.pi * bt) * (fs / rs)
    klen = int(8 * sigma) | 1
    kx = np.arange(klen) - klen // 2
    g = np.exp(-0.5 * (kx / sigma) ** 2)
    g /= g.sum()
    finst = np.convolve(finst, g, mode="same") + f_centre
    phase = 2 * np.pi * np.cumsum(finst) / fs
    return np.exp(1j * phase).astype(np.complex64)


def add_awgn(iq: np.ndarray, ebno_db: float, fs: int, rs: int,
             bits_per_symbol: int = 1, rng: np.random.Generator | None = None,
             normalise: bool = True,
             ref_power: float | None = None) -> np.ndarray:
    """Add complex AWGN for an exact Eb/N0 given the baud rate
    (reference auto_rx/test/generate_lowsnr.py:82-98).

    ``ref_power`` overrides the signal-power estimate (default
    ``np.var(iq)``).  np.var subtracts the complex mean — for a
    baseband burst with a strong DC line (alternating idle) that is
    NOT the carrier power, so measurements that must share one Eb/N0
    convention across carrier offsets pass the baseband variance here
    (a signal at f_off has zero mean, so its var is the full power)."""
    rng = rng or np.random.default_rng(0)
    var = np.var(iq) if ref_power is None else ref_power
    ebno = 10.0 ** (ebno_db / 10.0)
    nvar = var * fs / (rs * ebno * bits_per_symbol)
    noise = np.sqrt(nvar / 2.0) * (
        rng.standard_normal(len(iq)) + 1j * rng.standard_normal(len(iq)))
    out = (iq + noise).astype(np.complex64)
    if normalise:
        out = out / np.max(np.abs(out))
    return out.astype(np.complex64)
