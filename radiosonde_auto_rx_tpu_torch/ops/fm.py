"""FM quadrature discriminator on re/im planes.

Port of ``radiosonde_auto_rx_tpu/ops/fm.py`` (``FM_GAIN``,
``fm_discriminate_planes``, ``fm_discriminate_planes_mixed``):
    s_fm[t] = gain * arg( z[t] * conj(z[t-1]) ) / pi,   gain = 0.8
i.e. instantaneous frequency normalised to +/-1 at Nyquist, times 0.8.
The port computes in float32 throughout, so the reference's output-dtype
argument (bf16 streams on a TPU) has no counterpart here.
"""

import math

import torch

FM_GAIN = 0.8  # reference demod/mod/demod_mod.c:22


def fm_discriminate_planes_mixed(re, im):
    """The discriminator on separate re/im rows [..., T] -> [..., T]
    float32 FM audio (first sample 0): the detector's conditioning path
    (``detect/scanner.py``)."""
    rp = torch.cat([re[..., :1], re[..., :-1]], dim=-1)
    ip = torch.cat([im[..., :1], im[..., :-1]], dim=-1)
    wr = re * rp + im * ip
    wi = im * rp - re * ip
    return (FM_GAIN / math.pi) * torch.atan2(wi.float(), wr.float())


def fm_discriminate_planes(x):
    """[..., 2, T] re/im planes -> [..., T] float32 FM audio."""
    return fm_discriminate_planes_mixed(x[..., 0, :], x[..., 1, :])
