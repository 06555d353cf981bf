"""The plain reference that judges a run: float64 NumPy, no program code.

- ``channelize``: the polyphase filter bank of the station's channelizer
  (a Blackman-windowed sinc prototype of 12 taps a branch, cut at half the
  channel spacing, the branch taps reversed, zero history; the cross-branch
  DFT), from the cs16 block itself.
- ``welch``: the station's sparse Welch PSD (a power-normalised Hann window
  of ``nfft`` points every ``hop`` samples, |DFT|^2 averaged, fftshifted).
- ``chan_err`` / ``psd_err``: how far the program's rows lie from these.
- ``judge_telemetry``: each telemetry frame against the traffic's truth
  (serial, GPS time, position).
- ``decodable``: whether a frame lies where the station's design decodes
  it, inside the demodulated span of one block.
"""

import datetime
import math

import numpy as np

from stationbench import frames

# how far a decoded position may lie from the frame's truth: the frames
# carry it to 1e-7 degree (DFM) .. 1e-6 (M20) and 1 cm .. 0.1 m in height
POS_TOL_DEG = 1e-4
ALT_TOL_M = 5.0
# a task is a sonde's when its type is the sonde's and it lies within the
# larger of this and the type's tone spacing of the sonde's carrier (a
# wide FSK's task follows the demod's estimate, tens of kHz off centre)
TASK_TOL_HZ = 5e3
# the decoders report time as their frames state it: an M10 gives UTC,
# its GPS time less the leap seconds its frame carries (18)
TIME_SHIFT_S = {"M10": -18.0}
# types whose frames state only the time of day (the station adds a date)
TIME_OF_DAY = ("MK2LMS",)
# the station's type names of a sonde type
# The station demodulates every block on its own (no state carried from
# the block before), so a frame that straddles a block edge is not
# decoded by design ("frames straddling block boundaries are lost", the
# channelizer's note in radiosonde_auto_rx_tpu/ops/channelizer.py).
# Within a block the demod reads windows of nsym + 2 symbols, stepping
# nsym, from the block's start, and stops before a window would pass its
# end: up to 2 nsym + 2 symbols at the end go unread.  nsym is
# max(50, min(300, 1440000 / rs)) (station/chains.py's _demod_cfg).  A
# frame counts when it starts LEAD_SYMBOLS into the block or later, which
# leaves the channelizer's and resampler's filters their start.
LEAD_SYMBOLS = 8
TASK_TYPES = {"RS41": ("RS41",), "DFM": ("DFM",), "M10": ("M10",),
              "M20": ("M20",), "MTS01": ("MTS01",)}


def design_lowpass(cutoff: float, taps: int) -> np.ndarray:
    """Blackman-windowed sinc, unit DC gain; ``taps`` rounded up to odd."""
    taps += 1 - taps % 2
    n = np.arange(taps, dtype=np.float64)
    w = (7938 / 18608.0 - 9240 / 18608.0 * np.cos(2 * np.pi * n / (taps - 1))
         + 1430 / 18608.0 * np.cos(4 * np.pi * n / (taps - 1)))
    h = w * 2.0 * cutoff * np.sinc(2.0 * cutoff * (n - (taps - 1) / 2))
    return h / h.sum()


def prototype(n_chan: int, per_branch: int = 12) -> np.ndarray:
    return design_lowpass(0.5 / n_chan, n_chan * per_branch)[
        :n_chan * per_branch] * n_chan


def planes(cs16: np.ndarray) -> np.ndarray:
    """cs16 [2, T] -> complex128 [T] at the wire scale 1/32768."""
    x = np.asarray(cs16, np.float64) / 32768.0
    return x[0] + 1j * x[1]


def channelize(x: np.ndarray, n_chan: int) -> np.ndarray:
    """complex [T] -> [n_chan, T // n_chan]; row k centered at k fs / N
    (k > N/2: k fs / N - fs)."""
    h = prototype(n_chan)
    p = len(h) // n_chan
    m = len(x) // n_chan
    xb = x[:m * n_chan].reshape(m, n_chan)
    hb = h.reshape(p, n_chan)[:, ::-1]
    y = np.zeros_like(xb)
    for k in range(p):
        y[k:] += xb[:m - k] * hb[k]
    return np.fft.fft(y, axis=1).T


def welch(x: np.ndarray, nfft: int, hop: int) -> np.ndarray:
    """complex [T] -> mean |DFT|^2 of one Hann window a hop, fftshifted,
    over nseg * nfft."""
    nseg = len(x) // hop
    n = np.arange(nfft)
    win = 0.5 - 0.5 * np.cos(2 * np.pi * n / (nfft - 1))
    win = win / np.sqrt(np.sum(win ** 2) / nfft)
    segs = x[:nseg * hop].reshape(nseg, hop)[:, :nfft] * win
    p = (np.abs(np.fft.fft(segs, axis=1)) ** 2).sum(axis=0)
    return np.fft.fftshift(p) / (nseg * nfft)


def chan_err(got: np.ndarray, want: np.ndarray, rows) -> float:
    """Largest |program - reference| of the listed rows, each over its
    row's largest |reference|.  ``got`` [N, 2, M] planes, ``want``
    complex [N, M]."""
    worst = 0.0
    for r in rows:
        g = got[r, 0].astype(np.float64) + 1j * got[r, 1].astype(np.float64)
        w = want[r]
        worst = max(worst, float(np.max(np.abs(g - w)) /
                                 max(np.max(np.abs(w)), 1e-30)))
    return worst


def psd_err(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |program - reference| of a PSD row over (reference + the
    row's median): relative on every bin, the noise floor's included."""
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(got - want) / (want + np.median(want))))


def demod_nsym(rs: int) -> int:
    return max(50, min(300, 4800 * 300 // rs))


def decodable(a: int, e: int, b0: int, block: int, fs: int, rs: int) -> bool:
    """Whether wideband samples [a, e) of a frame keyed at ``rs`` lie in
    the demodulated span of the block [b0, b0 + block)."""
    sym = fs / rs
    return a >= b0 + LEAD_SYMBOLS * sym and \
        e <= b0 + block - (2 * demod_nsym(rs) + 2) * sym


def sonde_index(traffic):
    return {s.id: s for s in traffic.sondes}


def frame_of(sonde, telem):
    """The truth frame index a telemetry frame states (None: no frame of
    the sonde's run has that time)."""
    dt = telem.get("datetime_dt")
    if dt is None:
        try:
            dt = datetime.datetime.fromisoformat(
                str(telem["datetime"]).replace("Z", "+00:00"))
        except (KeyError, ValueError):
            return None
    t = (dt - frames.GPS_EPOCH).total_seconds() - \
        TIME_SHIFT_S.get(sonde.type, 0.0)
    if sonde.type in TIME_OF_DAY:
        t0 = sonde.truth[0][0]
        t = t0 + (t - t0 + 43200.0) % 86400.0 - 43200.0
    i = int(round(t - sonde.truth[0][0]))
    if abs(t - sonde.truth[0][0] - i) > 0.01 or not 0 <= i < len(sonde.truth):
        return None
    return i


def judge_telemetry(traffic, telem):
    """(sonde, frame index) the telemetry frame truly is, or None when it
    states a serial, time or position that no frame on air carries."""
    s = sonde_index(traffic).get(telem.get("id"))
    if s is None:
        return None
    i = frame_of(s, telem)
    if i is None:
        return None
    _, lat, lon, alt, _, _ = s.truth[i]
    if abs(telem["lat"] - lat) > POS_TOL_DEG or \
            abs(telem["lon"] - lon) > POS_TOL_DEG or \
            abs(telem["alt"] - alt) > ALT_TOL_M or \
            not math.isfinite(telem["lat"]):
        return None
    return s, i


def wrong_tasks(traffic, tasks) -> list:
    """The tasks (type, Hz from the capture center) that are no sonde's:
    a type that no sonde near enough has."""
    out = []
    for typ, f in tasks:
        if not any(typ in TASK_TYPES.get(s.type, (s.type,)) and
                   abs(f - s.f_off) < max(TASK_TOL_HZ, s.spacing)
                   for s in traffic.sondes):
            out.append((typ, f))
    return out
