"""Polyphase rational resampler — the ``tsrc`` equivalent.

Port of ``radiosonde_auto_rx_tpu/ops/resample.py``: for a rational
ratio L/M every block of L outputs is one product of an input frame of
hop M with a host-built banded weight matrix ``W [win, L]``; frames are
shifted views of the edge-padded input, so the resampler is one matrix
product per call.
"""

from fractions import Fraction
from functools import lru_cache

import numpy as np
import torch


def rational_ratio(fs_in: float, fs_out: float, max_den: int = 5000):
    """(L, M) with fs_out/fs_in ~= L/M, denominator bounded."""
    fr = Fraction(fs_out / fs_in).limit_denominator(max_den)
    return fr.numerator, fr.denominator


@lru_cache(maxsize=None)
def _poly_bank(l_up: int, m_down: int, taps_per_phase: int):
    """Polyphase bank [L, taps] of the windowed-sinc prototype (gain L)."""
    n = taps_per_phase * l_up
    cutoff = 0.47 / max(l_up, m_down)        # of the upsampled rate
    t = np.arange(n) - (n - 1) / 2.0
    h = 2 * cutoff * np.sinc(2 * cutoff * t)
    h *= np.blackman(n)
    # decompose: bank[p, j] = h[j*L + p]
    bank = np.zeros((l_up, taps_per_phase), np.float32)
    for p in range(l_up):
        row = h[p::l_up]
        bank[p, :len(row)] = row
    # unity DC gain per phase row -> flat gain across fractional delays
    bank /= bank.sum(axis=1, keepdims=True).clip(1e-9)
    return bank


@lru_cache(maxsize=None)
def _block_weights(l_up: int, m_down: int, taps_per_phase: int):
    """Banded weight matrix W [win, L] with
    y[b*L + p] = sum_i x[b*M + i_min + i] * W[i, p], plus (i_min, win).
    """
    half = taps_per_phase // 2
    bank = _poly_bank(l_up, m_down, taps_per_phase)       # [L, taps]
    p = np.arange(l_up, dtype=np.int64)
    base0 = (p * m_down) // l_up + half                   # [L]
    phase0 = (p * m_down) % l_up
    i_min = int(base0.min()) - taps_per_phase + 1
    i_max = int(base0.max())
    win = i_max - i_min + 1
    w = np.zeros((win, l_up), np.float32)
    for pp in range(l_up):
        j = np.arange(taps_per_phase)
        w[base0[pp] - j - i_min, pp] = bank[phase0[pp], j]
    return w, i_min, win


@lru_cache(maxsize=16)
def _weights_on(l_up: int, m_down: int, taps_per_phase: int,
                device: torch.device):
    w, _, _ = _block_weights(l_up, m_down, taps_per_phase)
    return torch.from_numpy(w).to(device)


def _resample(x, l_up: int, m_down: int, taps_per_phase: int):
    """x: [..., T] float32 -> [..., (T - taps)*L//M]."""
    t_in = x.shape[-1]
    n_out = (t_in - taps_per_phase) * l_up // m_down
    _, i_min, win = _block_weights(l_up, m_down, taps_per_phase)
    n_blk = -(-n_out // l_up)
    # frame b covers x[b*M + i_min : b*M + i_min + win]; edge-replicate
    # padding reproduces the index clip of the per-output formulation
    pad_l = max(0, -i_min)                                # i_min <= 0
    nq = -(-win // m_down)
    need = (n_blk - 1 + nq) * m_down                      # xs length used
    pad_r = max(0, need + i_min - t_in)
    lead = x.shape[:-1]
    xp = torch.cat([x[..., :1].expand(*lead, pad_l), x,
                    x[..., -1:].expand(*lead, pad_r)], dim=-1)
    xs = xp[..., i_min + pad_l:]                          # start at i_min
    tile = xs[..., :(n_blk - 1 + nq) * m_down]
    tile = tile.reshape(*lead, n_blk - 1 + nq, m_down)
    frames = torch.cat([tile[..., q:q + n_blk, :] for q in range(nq)],
                       dim=-1)[..., :win]                 # [.., n_blk, win]
    y = frames @ _weights_on(l_up, m_down, taps_per_phase, x.device)
    y = y.reshape(*lead, n_blk * l_up)
    return y[..., :n_out]


def resample(x, fs_in: float, fs_out: float, taps_per_phase: int = 16,
             max_den: int = 5000):
    """Resample a [..., T] float or complex tensor along its last axis,
    on its device -> [..., floor((T-taps)*L/M)] samples at ``fs_out``
    (complex input: each of its real and imaginary parts through the
    same real weights, as the reference's complex matmul).  Identity
    ratios pass through untouched."""
    l_up, m_down = rational_ratio(fs_in, fs_out, max_den)
    if l_up == m_down:
        return x
    if x.is_complex():
        return torch.complex(
            _resample(x.real.float(), l_up, m_down, taps_per_phase),
            _resample(x.imag.float(), l_up, m_down, taps_per_phase))
    return _resample(x.float(), l_up, m_down, taps_per_phase)


def resample_planes(x, fs_in: float, fs_out: float,
                    taps_per_phase: int = 16, max_den: int = 5000):
    """[C, 2, T] or [2, T] float32 planes (a tensor) -> planes at
    ``fs_out``, [..., floor((T-taps)*L/M)] samples.  Identity ratios pass
    through untouched."""
    return resample(x, fs_in, fs_out, taps_per_phase, max_den)
