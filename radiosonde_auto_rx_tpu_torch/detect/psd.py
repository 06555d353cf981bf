"""Welch PSD over IQ planes + host-side scan-peak picking.

Port of ``radiosonde_auto_rx_tpu/detect/psd.py``.  Every segment's
windowed |DFT|^2 goes through ``ops.fft.fft_abs2`` (K2: the CUDA kernel
on a CUDA tensor, its matmul twin on a CPU tensor); the segments are
strided VIEWS of the capture in both hop modes, read in place.
``detect_peaks`` and ``scan_peaks`` are host NumPy, copied because the
reference module imports JAX.
"""

from functools import lru_cache

import numpy as np
import torch

from radiosonde_auto_rx_tpu_torch.ops.fft import fft_abs2


def _window(nfft: int) -> np.ndarray:
    """Hann window, power-normalised to mean(w^2) = 1."""
    n = np.arange(nfft)
    win = 0.5 - 0.5 * np.cos(2 * np.pi * n / (nfft - 1))
    return (win / np.sqrt(np.sum(win**2) / nfft)).astype(np.float32)


def _dft_mats(nfft):
    """The reference's windowed DFT operands (window folded into the
    fftshifted cos/sin columns) — kept for parity checks."""
    n = np.arange(nfft)
    win = 0.5 - 0.5 * np.cos(2 * np.pi * n / (nfft - 1))   # hann
    win = win / np.sqrt(np.sum(win**2) / nfft)
    kcol = np.arange(nfft) - nfft // 2                     # fftshifted
    ang = 2 * np.pi * np.outer(n, kcol) / nfft
    wc = (win[:, None] * np.cos(ang)).astype(np.float32)
    ws = (win[:, None] * np.sin(ang)).astype(np.float32)
    return wc, ws


@lru_cache(maxsize=8)
def _window_on(nfft: int, device: torch.device):
    return torch.from_numpy(_window(nfft)).to(device)


def _welch(x, nfft: int, hop: int | None = None):
    """x: [C, 2, T] planes -> mean |DFT|^2 over hops, fftshifted [C, nfft].

    ``hop`` defaults to nfft//2 (50%-overlap Welch).  hop <= nfft (a
    divisor) reads the segments as nfft/hop interleaved non-overlapping
    tilings; hop = k*nfft reads one nfft window per hop stride (sparse
    sampling, integration duty 1/k — the station scan uses k = 4)."""
    C, _, T = x.shape
    x = x.float()            # a bf16 block: K2 reads a float32 copy
    hop = nfft // 2 if hop is None else hop
    if hop <= nfft:
        if nfft % hop:
            raise ValueError("hop must divide nfft")
        nseg = (T - nfft) // hop + 1
        groups = []
        for k in range(nfft // hop):
            nk = (nseg - k + (nfft // hop) - 1) // (nfft // hop)
            if nk > 0:
                off = k * hop
                groups.append(x[:, :, off:off + nk * nfft]
                              .reshape(C, 2, nk, nfft))
    else:
        if hop % nfft:
            raise ValueError("sparse hop must be a multiple of nfft")
        nseg = T // hop
        if nseg <= 0:
            raise ValueError("capture shorter than one hop")
        groups = [x[:, :, :nseg * hop].reshape(C, 2, nseg, hop)[..., :nfft]]
    win = _window_on(nfft, x.device)
    acc = 0
    for segs in groups:
        acc = acc + fft_abs2(segs, win, shift=True).sum(dim=1)
    return acc / (nseg * nfft)                             # [C, nfft]


def power_spectrum(x, device, nfft=1024, fs=48000, hop=None):
    """IQ (complex [C,T]/[T] or planes [C,2,T]) -> (freqs, psd_db), the
    PSD computed on ``device``.

    freqs in Hz relative to center; psd_db [C, nfft] (NumPy).  ``hop``
    as in ``_welch``."""
    from radiosonde_auto_rx_tpu_torch.demod.fsk import iq_planes
    single = len(np.shape(x) if not isinstance(x, torch.Tensor)
                 else x.shape) == 1
    x = iq_planes(x, device)
    p = _welch(x, nfft, hop).cpu().numpy()
    psd_db = 10.0 * np.log10(np.maximum(p, 1e-20))
    freqs = (np.arange(nfft) - nfft // 2) * (fs / nfft)
    return freqs, (psd_db[0] if single else psd_db)


def detect_peaks(x, mph=None, mpd=1, threshold=0.0):
    """Peak indices: amplitude >= mph, separated by >= mpd samples.

    Same semantics as the reference's vendored Marcos-Duarte detector
    (auto_rx/autorx/utils.py:437): local maxima on rising edges, highest
    peaks win within the minimum-distance window.
    """
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    if x.size < 3:
        return np.array([], dtype=int)
    dx = np.diff(x)
    rise = np.flatnonzero((np.hstack((dx, 0)) <= 0) & (np.hstack((0, dx)) > 0))
    if rise.size and mph is not None:
        rise = rise[x[rise] >= mph]
    if rise.size and threshold > 0:
        # a "peak" flagged at the very first/last sample has only one
        # neighbor — compare against that neighbor ALONE
        def _prom(i):
            nbrs = [x[i - 1]] if i > 0 else []
            if i + 1 < x.size:
                nbrs.append(x[i + 1])
            return x[i] - max(nbrs)
        keep = np.array([_prom(i) > threshold for i in rise])
        rise = rise[keep]
    if rise.size and mpd > 1:
        order = rise[np.argsort(x[rise])][::-1]
        suppressed = np.zeros(x.size, dtype=bool)
        keep = []
        for i in order:
            if not suppressed[i]:
                keep.append(i)
                lo = max(0, i - int(mpd))
                suppressed[lo:i + int(mpd) + 1] = True
        rise = np.sort(np.array(keep, dtype=int))
    return rise


def scan_peaks(psd_db, freqs, snr_threshold=10.0, min_distance_hz=10e3,
               quantization_hz=10e3, never_scan=()):
    """PSD -> candidate frequencies (Hz, relative to capture center).

    Mirrors the reference scan pass (auto_rx/autorx/scan.py:1009-1097):
    noise floor = median(power); peaks above floor+threshold; quantize;
    dedupe; drop blocked frequencies.
    """
    psd_db = np.asarray(psd_db)
    noise_floor = float(np.median(psd_db))
    df = abs(freqs[1] - freqs[0])
    mpd = max(1, int(min_distance_hz / df))
    idx = detect_peaks(psd_db, mph=noise_floor + snr_threshold, mpd=mpd)
    if len(idx) == 0:
        return np.array([]), noise_floor
    pf = freqs[idx]
    if quantization_hz:
        pf = np.round(pf / quantization_hz) * quantization_hz
    pf = np.unique(pf)
    if never_scan:
        pf = np.array([f for f in pf
                       if not any(abs(f - b) < quantization_hz / 2
                                  for b in never_scan)])
    return pf, noise_floor
