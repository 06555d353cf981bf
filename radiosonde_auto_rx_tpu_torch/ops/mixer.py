"""Complex NCO mixing (frequency translation) without lookup tables.

Port of ``radiosonde_auto_rx_tpu/ops/mixer.py``: the rotation is
generated directly, with the phase reduced modulo one cycle before the
2*pi multiply so that float32 stays accurate for block-local time
indices (see ``nco_phase``).
"""

import math

import torch


def nco_phase(freq_norm, n: int, device, t0=0.0) -> torch.Tensor:
    """Phase (in cycles, wrapped to [0, 1)) of an NCO at normalized
    frequency ``freq_norm`` (f/Fs: a number or a [...] tensor) ->
    float32 [..., n] on ``device``.  frac(k*t) in float32 is good to
    ~1e-4 cycles for |k*t| up to ~2^13 (block-local t)."""
    t = torch.arange(n, dtype=torch.float32, device=device) + float(t0)
    k = torch.as_tensor(freq_norm, dtype=torch.float32, device=device)
    ph = k[..., None] * t
    return ph - torch.floor(ph)


def freq_shift(x: torch.Tensor, freq_norm, t0=0.0) -> torch.Tensor:
    """Multiply complex [..., T] IQ by exp(+j*2*pi*freq_norm*t), on x's
    device.  To shift a signal *down* by f (move +f to DC) pass -f/Fs."""
    ph = nco_phase(freq_norm, x.shape[-1], x.device, t0)
    rot = torch.polar(torch.ones_like(ph), (2.0 * math.pi) * ph)
    return x * rot.to(torch.complex64)
