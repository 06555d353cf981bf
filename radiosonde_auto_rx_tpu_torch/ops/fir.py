"""FIR lowpass design and channel-batched filtering.

Port of ``radiosonde_auto_rx_tpu/ops/fir.py``: ``design_lowpass`` and
``design_lowpass_for_transition`` (host NumPy, copied), the
'same'-length, group-delay-aligned filters ``fir_filter`` and
``fir_filter_block`` (the detector's conditioning, the prescreen's
stride-2 IF bank and the iMet AFSK front end), the causal ``fir_filter_streaming`` (a carried tail of
K - 1 samples) and the filter + M:1 ``decimate``.  The last two take
complex input too (two real planes).

Every filter is ``torch.nn.functional.conv1d`` (a cross-correlation,
so the taps are reversed, as ``lax.conv_general_dilated`` is fed in the
reference).  On a CUDA tensor conv1d goes through cuDNN, which computes
float32 convolutions in TF32 (about three decimal digits) unless
``torch.backends.cudnn.allow_tf32`` is False; ``_full_fp32`` clears that
flag, cuBLAS's (``torch.backends.cuda.matmul.allow_tf32``, for the
correlations' matmuls) and cuBLAS's bfloat16 reduced-precision
reduction (``allow_bf16_reduced_precision_reduction``, so a bfloat16
product accumulates in float32, as the reference's
``preferred_element_type=float32`` asks) for the call and restores
them, whatever the caller set.  ``fir_filter_block`` computes in its
input's dtype, as the reference's does: bfloat16 rows (the detector's
``RSX_DETECT_DTYPE`` streams) take bfloat16 taps and give bfloat16
output, accumulated in float32; every other input is float32.  The
reference's blocked-Toeplitz form of it (``_toeplitz_rows`` and the
stride-``block`` convolution, and ``_conv_same`` beside it) is a
formulation that fills a TPU's matrix unit with the same result; here
the bank is one multi-output convolution.
"""

from contextlib import contextmanager
from functools import lru_cache

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


def design_lowpass_for_transition(cutoff_norm: float,
                                  transition_norm: float) -> np.ndarray:
    """Lowpass with taps sized from the transition bandwidth (taps ~=
    4/tbw), the reference's sizing rule (scan/dft_detect.c:1056-1060)."""
    taps = int(4.0 / max(transition_norm, 1e-6))
    if taps % 2 == 0:
        taps += 1
    return design_lowpass(cutoff_norm, taps)


@contextmanager
def _full_fp32():
    """cuDNN convolutions and cuBLAS matmuls in full float32 (no TF32),
    and bfloat16 matmuls accumulated in float32, inside the block,
    whatever the caller set."""
    mm = torch.backends.cuda.matmul
    prev = (torch.backends.cudnn.allow_tf32, mm.allow_tf32,
            mm.allow_bf16_reduced_precision_reduction)
    torch.backends.cudnn.allow_tf32 = False
    mm.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, mm.allow_tf32,
         mm.allow_bf16_reduced_precision_reduction) = prev


def fir_filter_block(x, hs, stride: int = 1):
    """Filter [C, T] (or [T]) by a bank ``hs`` [F, K] (or [K]) ->
    [C, F, T'], group-delay aligned:
    y[c, f, i] = sum_k h[f, k] x[c, i*stride + (K-1)//2 - k] (zeros
    outside), the 'same'-length filter's every ``stride``-th sample
    (T' = ceil(T/stride)); the decimation is the convolution's stride.
    bfloat16 input is filtered by bfloat16 taps into bfloat16 output
    (float32 accumulation); any other input in float32."""
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None, :]
    if x.dtype != torch.bfloat16:
        x = x.float()
    hs = _taps_tensor(hs, x.device).to(x.dtype)
    if hs.dim() == 1:
        hs = hs[None, :]
    K = hs.shape[-1]
    d = (K - 1) // 2
    xp = F.pad(x[:, None, :], (d, K - 1 - d))
    with _full_fp32():
        y = F.conv1d(xp, hs.flip(-1)[:, None, :], stride=int(stride))
    return y[0] if squeeze else y


def fir_filter(x, h):
    """Filter [C, T] (or [T]) by taps h [K], 'same' length, group-delay
    aligned."""
    return fir_filter_block(x, h)[..., 0, :]


@lru_cache(maxsize=64)
def _taps_cached(raw: bytes, shape: tuple, device: torch.device):
    return torch.from_numpy(
        np.frombuffer(raw, np.float32).reshape(shape).copy()).to(device)


def _taps_tensor(h, device) -> torch.Tensor:
    """Taps as a float32 tensor on ``device``.  Host taps are copied to
    a device once and reused: each copy from pageable host memory makes
    the host wait for the device's queue."""
    if isinstance(h, torch.Tensor):
        return h.to(device=device, dtype=torch.float32)
    a = np.ascontiguousarray(h, np.float32)
    return _taps_cached(a.tobytes(), a.shape, torch.device(device))


def _taps_on(h, x):
    """Taps as a reversed conv1d weight [1, 1, K] on ``x``'s device."""
    return _taps_tensor(h, x.device).flip(-1)[None, None, :]


def _conv_valid(x, h):
    """'valid' convolution of real [C, T] with taps [K] -> [C, T-K+1]:
    y[t] = sum_k h[k] x[t + K-1 - k]."""
    with _full_fp32():
        return F.conv1d(x.float()[:, None, :], _taps_on(h, x))[:, 0, :]


def _complex_planes(fn, x):
    """``fn`` on a real tensor, or on each plane of a complex one."""
    if x.is_complex():
        return torch.complex(fn(x.real), fn(x.imag))
    return fn(x)


def fir_filter_streaming(x_block, h, tail):
    """Causal streaming FIR: returns (y_block, new_tail).

    ``tail`` is the last K-1 input samples of the previous block
    ([C, K-1]); the returned block is time-aligned with the input block
    delayed by the filter group delay (K-1)/2 relative to a 'same'
    filter."""
    K = int(torch.as_tensor(h).shape[0])
    xx = torch.cat([tail, x_block], dim=-1)              # [C, K-1+T]
    y = _complex_planes(lambda v: _conv_valid(v, h), xx)
    return y, xx[:, xx.shape[-1] - (K - 1):]


def decimate(x, factor: int, h: np.ndarray | None = None):
    """Lowpass + M:1 decimation of [C, T] (or [T]) -> [C, ceil(T/M)]:
    a 'same'-aligned filter sampled every ``factor``-th output (one
    strided conv1d).  Default taps: cutoff 0.45 of the output Nyquist,
    transition 0.1 of the output rate."""
    if factor == 1:
        return x
    if h is None:
        h = design_lowpass_for_transition(0.45 / factor, 0.1 / factor)
    K = len(h)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None, :]

    def strided(v):
        d = (K - 1) // 2
        vp = F.pad(v.float()[:, None, :], (d, K - 1 - d))
        with _full_fp32():
            return F.conv1d(vp, _taps_on(h, v), stride=factor)[:, 0, :]

    y = _complex_planes(strided, x)
    return y[0] if squeeze else y
