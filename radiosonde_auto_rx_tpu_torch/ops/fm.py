"""FM quadrature discriminator and IQ conditioning.

Port of ``radiosonde_auto_rx_tpu/ops/fm.py`` (``FM_GAIN``,
``fm_discriminate`` on complex IQ, ``fm_discriminate_planes`` and
``fm_discriminate_planes_mixed`` on re/im planes, ``iq_dc_removal``,
``dc_offset``):
    s_fm[t] = gain * arg( z[t] * conj(z[t-1]) ) / pi,   gain = 0.8
i.e. instantaneous frequency normalised to +/-1 at Nyquist, times 0.8.
``fm_discriminate_planes_mixed`` takes the reference's ``out_dtype``:
the detector's bfloat16 streams (``RSX_DETECT_DTYPE``) are its output
in that dtype, with the products in the planes' dtype and ``atan2`` in
float32.
"""

import math

import torch

FM_GAIN = 0.8  # reference demod/mod/demod_mod.c:22


def fm_discriminate(z, gain: float = FM_GAIN):
    """[..., T] complex IQ tensor -> [..., T] float32 FM audio (first
    sample 0)."""
    zprev = torch.cat([z[..., :1], z[..., :-1]], dim=-1)
    w = z * torch.conj(zprev)
    return ((gain / math.pi) * torch.atan2(w.imag, w.real)).float()


def fm_discriminate_planes_mixed(re, im, out_dtype=torch.float32):
    """The discriminator on separate re/im rows [..., T] -> [..., T] FM
    audio in ``out_dtype`` (first sample 0): the products in the rows'
    dtype, ``atan2`` on float32 inputs, the scaled result cast to
    ``out_dtype`` — the detector's conditioning path
    (``detect/scanner.py``, ``detect/prescreen.py``)."""
    rp = torch.cat([re[..., :1], re[..., :-1]], dim=-1)
    ip = torch.cat([im[..., :1], im[..., :-1]], dim=-1)
    wr = re * rp + im * ip
    wi = im * rp - re * ip
    return ((FM_GAIN / math.pi) * torch.atan2(
        wi.float(), wr.float())).to(out_dtype)


def fm_discriminate_planes(x):
    """[..., 2, T] re/im planes -> [..., T] float32 FM audio."""
    return fm_discriminate_planes_mixed(x[..., 0, :], x[..., 1, :])


def iq_dc_removal(z, alpha: float | None = None):
    """Remove the complex DC term over the block: ``z - 0.98 * mean(z)``
    (the reference detector's leaky DC estimate in its static-shape,
    block-mean form; ``alpha`` is unused there too)."""
    return z - 0.98 * torch.mean(z, dim=-1, keepdim=True)


def dc_offset(z):
    """Block-mean DC term: after FM discrimination, a residual-carrier
    frequency estimate (df = sr * dc / (2 * FM_GAIN))."""
    return torch.mean(z, dim=-1)
