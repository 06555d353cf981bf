"""Polyphase filter-bank channelizer: one wideband capture -> N channels.

Port of ``radiosonde_auto_rx_tpu/ops/channelizer.py``: the polyphase
branch filter is P shifted multiply-accumulates along the decimated
time axis (branch axis REVERSED — see ``_channelize``), the cross-branch
DFT a pair of real [N, N] matrix products.  Recentered single-channel
extraction (``_extract``) runs one branch set of the same prototype on a
wideband stream rotated by host-computed float64 phase tables.

The branch dtype (``_branch_dtype``, ``RSX_CHANNELIZER_DTYPE``, read at
each call) is float32 unless the switch asks for bfloat16, the form the
reference takes on its TPU: then the branch taps, the P shifted
multiply-accumulates (each result rounded to bfloat16) and the DFT's
operands are bfloat16, the DFT's products accumulate in float32, and
the channel planes come out in bfloat16, as the reference's do.
"""

import os
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from radiosonde_auto_rx_tpu_torch.ops.fir import _full_fp32, design_lowpass


def _branch_dtype() -> torch.dtype:
    """dtype of the polyphase branches and of the channel planes:
    ``RSX_CHANNELIZER_DTYPE=float32|bfloat16`` forces; otherwise (the
    reference's ``auto``, which takes bfloat16 only on a TPU) float32."""
    forced = os.environ.get("RSX_CHANNELIZER_DTYPE")
    return _dtype_named(forced) if forced else torch.float32


def _dtype_named(name: str) -> torch.dtype:
    """A floating torch dtype by its NumPy/JAX name (``bfloat16``,
    ``float32``)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"not a floating dtype: {name!r}")
    return dt


def pfb_prototype(n_chan: int, taps_per_branch: int = 12,
                  cutoff_scale: float = 0.5) -> np.ndarray:
    """Prototype lowpass for the bank: cutoff at half the channel spacing
    (critically sampled), length n_chan*taps_per_branch."""
    ntaps = n_chan * taps_per_branch
    h = design_lowpass(cutoff_scale / n_chan, ntaps)
    if len(h) > ntaps:
        h = h[:ntaps]
    elif len(h) < ntaps:
        h = np.concatenate([h, np.zeros(ntaps - len(h), np.float32)])
    return (h * n_chan).astype(np.float32)


def _dft_mats(n):
    k = np.arange(n)
    ang = 2 * np.pi * np.outer(k, k) / n
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


@lru_cache(maxsize=16)
def _dft_mats_on(n: int, device: torch.device):
    cosm, sinm = _dft_mats(n)
    return (torch.from_numpy(cosm).to(device),
            torch.from_numpy(sinm).to(device))


@lru_cache(maxsize=16)
def _dft_pair_on(n: int, device: torch.device, dtype: torch.dtype):
    """The cross-branch DFT as two [2N, N] operands in ``dtype``:
    [yr | yi] @ [cos; sin] = zr and [yi | yr] @ [cos; -sin] = zi, so each
    output is one product accumulated in float32 and rounded once."""
    cosm, sinm = _dft_mats(n)
    return (torch.from_numpy(np.concatenate([cosm, sinm])).to(device, dtype),
            torch.from_numpy(np.concatenate([cosm, -sinm])).to(device, dtype))


def _branch_mac(planes, hb):
    """Decimating FIR over the branch axis: planes [..., M, N], hb [P, N]
    (already reversed) -> y[..., m, r] = sum_p planes[m - p, r] hb[p, r]
    with zero history."""
    P = hb.shape[0]
    M = planes.shape[-2]
    xp = F.pad(planes, (0, 0, P - 1, 0))
    y = xp[..., P - 1:P - 1 + M, :] * hb[0]
    for p in range(1, P):
        y = y + xp[..., P - 1 - p:P - 1 - p + M, :] * hb[p]
    return y


def _channelize(x, h, n_chan: int):
    """x: [..., 2, T] wideband planes; h: [P*N] prototype tensor.

    Returns [..., N, 2, T//N] channel planes; channel k is centered at
    +k*fs/N (k > N/2 ⇒ negative frequencies).
    """
    P = h.shape[0] // n_chan
    T = x.shape[-1] // n_chan * n_chan
    M = T // n_chan
    lead = x.shape[:-2]
    ydt = _branch_dtype()
    # polyphase branches: branch r takes samples x[m*N + r]
    xb = x[..., :T].to(ydt).reshape(*lead, 2, M, n_chan)
    # prototype branch taps, branch axis REVERSED: with y[m] =
    # Σ_j h[j]·x[mN + (N−1) − j] (a true decimating FIR), the j = pN+s
    # component multiplies x[(m−p)N + r] for r = N−1−s, so branch r's
    # taps are h[pN + (N−1−r)].  The un-reversed form is exact at every
    # channel center but droops ~4 dB at ±25 kHz off center.
    hb = h.reshape(P, n_chan).flip(1).to(ydt)
    y = _branch_mac(xb, hb)                                  # [..., 2, M, N]
    yr, yi = y[..., 0, :, :], y[..., 1, :, :]                # [..., M, N]
    # cross-branch DFT: z_k = sum_r y_r e^{-2πi rk/N}
    if ydt != torch.float32:
        opr, opi = _dft_pair_on(n_chan, x.device, ydt)
        with _full_fp32():
            zr = torch.cat([yr, yi], dim=-1) @ opr
            zi = torch.cat([yi, yr], dim=-1) @ opi
        return torch.stack([zr.transpose(-1, -2), zi.transpose(-1, -2)],
                           dim=-2)                           # [..., N, 2, M]
    cosm, sinm = _dft_mats_on(n_chan, x.device)
    zr = yr @ cosm + yi @ sinm                               # [..., M, N]
    zi = yi @ cosm - yr @ sinm
    return torch.stack([zr.transpose(-1, -2), zi.transpose(-1, -2)],
                       dim=-2)                               # [..., N, 2, M]


def _planes(x, device) -> torch.Tensor:
    """Host complex [T] / planes [2, T] (or a tensor) -> f32 planes on
    ``device``; complex is split on the host."""
    if isinstance(x, torch.Tensor):
        if x.is_complex():
            x = torch.stack([x.real, x.imag], dim=-2)
        return x.to(device=device, dtype=torch.float32)
    x = np.asarray(x)
    if np.iscomplexobj(x):
        x = np.stack([x.real, x.imag], axis=-2)
    return torch.from_numpy(np.require(x, np.float32, ("C", "W"))).to(device)


def channelize(x, n_chan: int, device, h: np.ndarray | None = None):
    """Wideband IQ (complex [T] or planes [2, T]) -> [N, 2, T//N] channels
    on ``device``.

    Channel k is centered at f_k = k*fs/N for k <= N/2, f_k - fs for
    k > N/2; each channel's output rate is fs/N.
    """
    if h is None:
        h = pfb_prototype(n_chan)
    x = _planes(x, device)
    return _channelize(x, torch.as_tensor(h, device=x.device), n_chan)


def channel_freqs(n_chan: int, fs: float) -> np.ndarray:
    """Center frequency (Hz, relative to capture center) per channel."""
    k = np.arange(n_chan)
    f = k * fs / n_chan
    f[k > n_chan // 2] -= fs
    return f


def extract_phases(f_hz: float, fs: float, t_samples: int, n_dec: int):
    """Host-side exact phase tables for ``_extract`` (float64 modular
    math — a float32 in-graph NCO drifts ~0.1 cycle over a 1 s wideband
    block, which would smear the FSK tones).

    Returns (ph_m [T//n_dec], ph_r [n_dec]) phase tables in cycles:
    the rotation phase of wideband sample ``m*n_dec + r`` is
    ``ph_m[m] + ph_r[r]`` (mod 1).  The NCO starts at phase 0 every call
    (every consumer demodulates each capture block independently).
    """
    m = np.arange(t_samples // n_dec, dtype=np.float64)
    r = np.arange(n_dec, dtype=np.float64)
    f = float(f_hz) / float(fs)
    ph_m = np.mod(f * n_dec * m, 1.0).astype(np.float32)
    ph_r = np.mod(f * r, 1.0).astype(np.float32)
    return ph_m, ph_r


def _extract(x, h, ph_m, ph_r, n_dec: int):
    """x: [S, 2, T] wideband planes (one per slot); h: [P*n_dec]
    prototype; ph_m: [S, T//n_dec], ph_r: [S, n_dec] rotation phases
    (cycles).

    Returns [S, 2, T//n_dec] recentered decimated channel planes in the
    branch dtype: each slot rotates its stream DOWN by its frequency
    (e^{-j2πf n}; float32, then rounded to the branch dtype) and
    decimates through the prototype's polyphase branches, then sums the
    branches (the channel-0 row of the cross-branch DFT, accumulated in
    float32).  At a channel center this reproduces that ``_channelize``
    row.
    """
    P = h.shape[0] // n_dec
    T = x.shape[-1] // n_dec * n_dec
    M = T // n_dec
    S = x.shape[0]
    ydt = _branch_dtype()
    hb = h.reshape(P, n_dec).flip(1).to(ydt)                 # [P, N]
    tau = float(np.float32(2.0 * np.pi))
    cm, sm = torch.cos(ph_m * tau), torch.sin(ph_m * tau)    # [S, M]
    cr, sr = torch.cos(ph_r * tau), torch.sin(ph_r * tau)    # [S, N]
    xb = x[..., :T].float().reshape(S, 2, M, n_dec)
    # cos/sin of the summed phase via angle addition
    c = cm[:, :, None] * cr[:, None, :] - sm[:, :, None] * sr[:, None, :]
    s = sm[:, :, None] * cr[:, None, :] + cm[:, :, None] * sr[:, None, :]
    # rotate DOWN by f: (re + j·im)·(c - j·s)
    re = xb[:, 0] * c + xb[:, 1] * s                         # [S, M, N]
    im = xb[:, 1] * c - xb[:, 0] * s
    y = _branch_mac(torch.stack([re, im], dim=1).to(ydt), hb)  # [S,2,M,N]
    return y.sum(dim=-1)                                     # [S, 2, M]


def extract_channels(x, fs: float, f_hz_list, n_dec: int, device,
                     h: np.ndarray | None = None):
    """Wideband IQ planes -> [S, 2, T//n_dec] channels on ``device``,
    recentered on the (possibly off-grid) frequencies ``f_hz_list`` (Hz
    relative to the capture center).  ``x`` is [2, T] (shared across
    slots) or [S, 2, T] (one capture per slot).  ``h`` defaults to the
    prototype an ``n_dec``-channel PFB uses, so an extraction at a
    channel center matches that PFB channel."""
    if h is None:
        h = pfb_prototype(n_dec)
    x = _planes(x, device)
    T = int(x.shape[-1])
    tabs = [extract_phases(f, fs, T, n_dec) for f in f_hz_list]
    ph_m = torch.from_numpy(np.stack([t[0] for t in tabs])).to(x.device)
    ph_r = torch.from_numpy(np.stack([t[1] for t in tabs])).to(x.device)
    if x.dim() == 2:
        x = x[None].expand(len(f_hz_list), *x.shape)
    return _extract(x, torch.as_tensor(h, device=x.device), ph_m, ph_r,
                    n_dec)
