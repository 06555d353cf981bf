"""FIR lowpass design and channel-batched filtering.

Port of ``radiosonde_auto_rx_tpu/ops/fir.py``: ``design_lowpass`` (host
NumPy, copied) and the 'same'-length, group-delay-aligned filters
``fir_filter`` and ``fir_filter_block`` (the detector's conditioning and
the iMet AFSK front end).

Both filters are ``torch.nn.functional.conv1d`` (a cross-correlation,
so the taps are reversed, as ``lax.conv_general_dilated`` is fed in the
reference).  On a CUDA tensor conv1d goes through cuDNN, which computes
float32 convolutions in TF32 (about three decimal digits) unless
``torch.backends.cudnn.allow_tf32`` is False; ``_fp32_conv`` clears the
flag for the call and restores it, so the filters are full float32
whatever the caller set.  The reference's blocked-Toeplitz form of
``fir_filter_block`` exists to fill a TPU's matrix unit; here the bank
is one multi-output convolution with the same result.
"""

from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F


def design_lowpass(cutoff_norm: float, taps: int) -> np.ndarray:
    """Blackman-windowed sinc lowpass.

    Args:
        cutoff_norm: cutoff as a fraction of the sample rate (0 < f < 0.5).
        taps: number of taps; rounded up to odd.

    Matches reference demod/mod/demod_mod.c:555-587 (coefficients 1-norm
    normalised, Blackman window 7938/18608 - 9240/18608 cos + 1430/18608 cos).
    """
    if taps % 2 == 0:
        taps += 1
    taps = max(taps, 1)
    n = np.arange(taps, dtype=np.float64)
    if taps > 1:
        w = (
            7938 / 18608.0
            - 9240 / 18608.0 * np.cos(2 * np.pi * n / (taps - 1))
            + 1430 / 18608.0 * np.cos(4 * np.pi * n / (taps - 1))
        )
    else:
        w = np.ones(1)
    x = 2.0 * cutoff_norm * (n - (taps - 1) / 2)
    h = 2.0 * cutoff_norm * np.sinc(x)
    ws = w * h
    ws /= ws.sum()
    return ws.astype(np.float32)


@contextmanager
def _fp32_conv():
    """cuDNN convolutions in full float32 (no TF32) inside the block."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def fir_filter_block(x, hs):
    """Filter [C, T] (or [T]) by a bank ``hs`` [F, K] (or [K]) ->
    [C, F, T] float32, 'same' length and group-delay aligned:
    y[c, f, t] = sum_k h[f, k] x[c, t + (K-1)//2 - k] (zeros outside)."""
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None, :]
    hs = torch.as_tensor(hs, dtype=torch.float32, device=x.device)
    if hs.dim() == 1:
        hs = hs[None, :]
    K = hs.shape[-1]
    d = (K - 1) // 2
    xp = F.pad(x.float()[:, None, :], (d, K - 1 - d))
    with _fp32_conv():
        y = F.conv1d(xp, hs.flip(-1)[:, None, :])
    return y[0] if squeeze else y


def fir_filter(x, h):
    """Filter [C, T] (or [T]) by taps h [K], 'same' length, group-delay
    aligned."""
    return fir_filter_block(x, h)[..., 0, :]
