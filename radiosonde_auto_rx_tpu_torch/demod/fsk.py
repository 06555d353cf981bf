"""Channel-batched non-coherent M-FSK demodulator.

Port of ``radiosonde_auto_rx_tpu/demod/fsk.py`` (codec2 fsk.c re-derived
as block-parallel tensor math — see that module's notes).  IQ is
float32 ``[C, 2, T]`` planes; all state carries a leading ``[C]`` axis.
A CPU tensor runs the plain twin ``fsk_scan_ref``: the reference's
``lax.scan`` over blocks as a Python loop of torch ops, with the spectral
pass as K1's twin ``ops.fsk_sf.freq_est_sf_ref``.  A CUDA tensor runs
``fsk_scan``: the whole scan, every demod block of every channel, as one
launch of the hand-written kernel ``csrc/fsk_scan.cu`` (K1 as its
spectral stage; ``csrc/fsk_block.cuh``); there is no path from a CUDA
tensor to the twin.

Both scans of the reference are ported: the buffered (gather-free) one,
the default, and the unbuffered one (``buffered=False``, the reference's
``_fsk_demod_scan``: each window read at ``[ptr - nmem, ptr)``), which
the standalone demod CLI runs.  Soft-decision conventions match the
reference exactly: 2FSK ``sd = |tone0| - |tone1|`` (positive ⇒ bit 0);
4FSK sum form (positive ⇒ bit 1).
"""

from dataclasses import dataclass
from functools import lru_cache
import math

import numpy as np
import torch

from radiosonde_auto_rx_tpu_torch import kernels
from radiosonde_auto_rx_tpu_torch.ops.fft import _twiddles
from radiosonde_auto_rx_tpu_torch.ops.fsk_sf import KERNEL_NDFT, _tables, \
    freq_est_sf, freq_est_sf_ref

TWO_PI = float(np.float32(2.0 * np.pi))


@dataclass(frozen=True)
class FSKConfig:
    """Static demod parameters (hashable: keys the constant caches)."""

    fs: int                 # sample rate, Hz
    rs: int                 # symbol rate, baud
    m: int = 2              # tones (2 or 4)
    p: int = 8              # integrate-and-dump offsets per symbol
    nsym: int = 50          # symbols per processing block
    est_min: int = 0        # tone-search window, Hz (may be negative for IQ)
    est_max: int = 0        # 0,0 -> defaults to ±fs/2
    tone_spacing: int = 0   # known tone spacing (Hz) for the mask estimator
    freq_est_type: int = 0  # 0: M-peak picking; 1: mask correlation

    def __post_init__(self):
        if self.fs % self.rs:
            raise ValueError("Ts = fs/rs must be integer")
        if (self.fs // self.rs) % self.p:
            raise ValueError("Ts/P must be integer")
        if self.m not in (2, 4):
            raise ValueError("m must be 2 or 4")
        if self.freq_est_type == 1 and self.tone_spacing <= 0:
            raise ValueError("mask estimator needs tone_spacing")

    @property
    def ts(self) -> int:            # samples per symbol
        return self.fs // self.rs

    @property
    def tsp(self) -> int:           # samples per timing offset
        return self.ts // self.p

    @property
    def n(self) -> int:             # nominal samples per block
        return self.ts * self.nsym

    @property
    def nmem(self) -> int:          # window memory: N + 2 symbols (fsk.c:149)
        return self.n + 2 * self.ts

    @property
    def ndft(self) -> int:          # est FFT size: bins within 10% of Rs
        return int(2 ** math.ceil(math.log2(self.fs / (0.1 * self.rs))))

    @property
    def tc(self) -> float:          # spectral EMA coefficient (fsk.c:148)
        return 0.95 * self.ndft / self.fs

    @property
    def est_space_bins(self) -> int:  # peak blanking half-width
        return int((0.75 * self.rs) * self.ndft / self.fs)

    @property
    def numffts(self) -> int:       # FFT hops per block (fsk.c:465)
        return self.n // (self.ndft // 2) - 1

    @property
    def bits_per_symbol(self) -> int:
        return 1 if self.m == 2 else 2

    @property
    def est_range(self):            # (st, en) search bins after fftshift
        emin = self.est_min
        emax = self.est_max
        if emin == 0 and emax == 0:
            emin, emax = -self.fs // 2, self.fs // 2
        st = max(0, (emin * self.ndft) // self.fs + self.ndft // 2)
        en = min(self.ndft, (emax * self.ndft) // self.fs + self.ndft // 2)
        return st, en

    @property
    def block_advance_max(self) -> int:
        return self.n + self.ts // 2


def iq_planes(x, device) -> torch.Tensor:
    """Normalize IQ input to float32 [C, 2, T] planes on ``device``.

    Accepts complex [C, T] / [T] (NumPy or torch; NumPy complex is split
    on the host) or already-split real [C, 2, T]."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if np.iscomplexobj(x):
            x = np.atleast_2d(x)
            x = np.stack([x.real, x.imag], axis=1)
        # a read-only buffer (one from a JAX array) is copied: torch
        # warns on sharing it
        x = torch.from_numpy(np.require(x, np.float32, ("C", "W")))
    elif x.is_complex():
        if x.dim() == 1:
            x = x[None, :]
        x = torch.stack([x.real, x.imag], dim=1)
    if x.dim() != 3 or x.shape[1] != 2:
        raise ValueError("real input must be [C, 2, T]")
    return x.to(device=device, dtype=torch.float32)


# Per-channel demod carry: a plain dict with keys
#   sf [C, ndft] f32, timing [C] f32, ppm [C] f32, ptr [C] i32, nin [C] i32.
FSKState = dict


def fsk_init_state(cfg: FSKConfig, channels: int, device) -> FSKState:
    return dict(
        sf=torch.zeros((channels, cfg.ndft), dtype=torch.float32,
                       device=device),
        timing=torch.zeros((channels,), dtype=torch.float32, device=device),
        ppm=torch.zeros((channels,), dtype=torch.float32, device=device),
        ptr=torch.full((channels,), cfg.nmem, dtype=torch.int32,
                       device=device),
        nin=torch.full((channels,), cfg.n, dtype=torch.int32, device=device),
    )


def state_from_numpy(d: dict, device) -> FSKState:
    """An FSKState from host arrays (e.g. the reference's state)."""
    dt = dict(sf=torch.float32, timing=torch.float32, ppm=torch.float32,
              ptr=torch.int32, nin=torch.int32)
    return {k: torch.as_tensor(np.array(v), dtype=dt[k], device=device)
            for k, v in d.items()}


def state_to_numpy(s: FSKState) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in s.items()}


# ----------------------------------------------------------------------------
# windowed-DFT matrices (host precompute; fftshifted columns)
# ----------------------------------------------------------------------------

def _dft_mats(cfg: FSKConfig):
    """Windowed DFT as two real matmul operands [ndft, ndft]:
    X_re = xr @ Wc + xi @ Ws ;  X_im = xi @ Wc - xr @ Ws
    for X_k = sum_n w_n x_n e^{-2πi n k / N}, columns fftshifted."""
    n = cfg.ndft
    # hann window, symmetric (fsk.c:451: 0.5 - 0.5 cos(2πn/(N-1)))
    idx = np.arange(n)
    win = 0.5 - 0.5 * np.cos(2 * np.pi * idx / (n - 1))
    # column order after fftshift: bin b corresponds to freq (b - n/2)
    kcol = np.arange(n) - n // 2
    ang = 2 * np.pi * np.outer(idx, kcol) / n
    wc = (win[:, None] * np.cos(ang)).astype(np.float32)
    ws = (win[:, None] * np.sin(ang)).astype(np.float32)
    return wc, ws


class _Consts:
    """Per-(cfg, device) constants of the block, built once: fresh
    host->device copies inside the block loop would stall it."""

    def __init__(self, cfg: FSKConfig, device):
        f32 = dict(dtype=torch.float32, device=device)
        nf = cfg.numffts
        half = cfg.ndft // 2
        wc, ws = _dft_mats(cfg)
        self.wc = torch.from_numpy(wc).to(device)
        self.ws = torch.from_numpy(ws).to(device)
        # DFT hops over the newest N samples (fsk.c:465-468)
        self.starts = tuple(int(s) for s in
                            (cfg.nmem - cfg.n) + np.arange(nf) * half)
        # exact closed form of the per-hop EMA Sf = Sf*(1-tc) + tc*mag
        tc = cfg.tc
        self.decay = float(np.float32((1.0 - tc) ** nf))
        self.weights = tuple(float(v) for v in (
            tc * (1.0 - tc) ** (nf - 1 - np.arange(nf))).astype(np.float32))
        st, en = cfg.est_range
        bins = np.arange(cfg.ndft)
        self.bins = torch.arange(cfg.ndft, device=device)
        self.valid = torch.from_numpy((bins >= st) & (bins < en)).to(device)
        nps = cfg.nmem // cfg.tsp
        self.b = torch.arange(cfg.tsp, **f32)
        Q = max(1, int(np.sqrt(nps)))
        nA = -(-nps // Q)
        self.Q, self.nA = Q, nA
        self.aA = torch.arange(nA, **f32) * float(np.float32(Q * cfg.tsp))
        self.aR = torch.arange(Q, **f32) * float(np.float32(cfg.tsp))
        ni = (cfg.nsym + 1) * cfg.p
        rot = np.exp(2j * np.pi / cfg.p * np.arange(ni))
        self.rot_re = torch.from_numpy(rot.real.astype(np.float32)).to(device)
        self.rot_im = torch.from_numpy(rot.imag.astype(np.float32)).to(device)
        # flat index of symbol k's integrator at shift 0: (k+1)*P
        self.sym_base = (torch.arange(cfg.nsym, device=device) + 1) * cfg.p
        self.win_idx = torch.arange(cfg.nmem, device=device)
        # the scan kernel's tables: the Hann window (wc's DC column, the
        # twin's own float32 values), FFT twiddles, hop starts and weights,
        # the timing rotation [2, ni]
        self.win = self.wc[:, cfg.ndft // 2].contiguous()
        self.tw = _twiddles(cfg.ndft, device)
        self.starts_t, self.weights_t = _tables(self.starts, self.weights,
                                                device)
        self.rot = torch.stack([self.rot_re, self.rot_im]).contiguous()


@lru_cache(maxsize=64)
def _consts(cfg: FSKConfig, device: torch.device) -> _Consts:
    return _Consts(cfg, device)


# ----------------------------------------------------------------------------
# frequency estimation
# ----------------------------------------------------------------------------

def _freq_est(cfg: FSKConfig, xw, sf, spectral=freq_est_sf):
    """Update the spectral EMA and estimate the M tone frequencies.

    xw: [C, 2, nmem] float32 window;  sf: [C, ndft] EMA carry;
    spectral: K1's entry ``freq_est_sf`` or its twin.
    Returns (f_est [C, M] in Hz, new sf)."""
    k = _consts(cfg, xw.device)
    sf_new = spectral(xw, sf, k.wc, k.ws, k.starts, k.weights, k.decay)
    st, en = cfg.est_range
    if cfg.freq_est_type == 1:
        f_est = _mask_estimate(cfg, sf_new, st, en)
    else:
        f_est = _peak_estimate(cfg, sf_new, k.valid)
    return f_est, sf_new


def _peak_estimate(cfg: FSKConfig, sf, valid):
    """M peaks with ±est_space blanking, sorted ascending (fsk.c:508-546)."""
    ndft = cfg.ndft
    f_zero = cfg.est_space_bins
    bins = _consts(cfg, sf.device).bins
    s = torch.where(valid[None, :], sf, -1.0)
    peaks = []
    for _ in range(cfg.m):
        imax = torch.argmax(s, dim=-1)                            # [C]
        peaks.append(imax)
        blank = (bins[None, :] >= imax[:, None] - f_zero) & (
            bins[None, :] < imax[:, None] + f_zero)
        s = torch.where(blank, 0.0, s)
    freqi = torch.stack(peaks, dim=-1) - ndft // 2                # [C, M]
    freqi = torch.sort(freqi, dim=-1).values
    return freqi.float() * (cfg.fs / ndft)


def _mask_offsets(cfg: FSKConfig):
    """The mask comb's bin offsets in the reference's summation order
    (``set`` iteration: 0..2 plus round(m*spacing*ndft/fs)-1 .. +1+2)
    and the comb's length."""
    offs = [0, 1, 2]
    bin_last = 0
    for mm in range(1, cfg.m):
        b = int(round(mm * cfg.tone_spacing * cfg.ndft / cfg.fs)) - 1
        offs += [b, b + 1, b + 2]
        bin_last = b
    return tuple(set(offs)), bin_last + 3


def _mask_estimate(cfg: FSKConfig, sf, st: int, en: int):
    """Correlate Sf with a comb at known tone spacing (fsk.c:549-581)."""
    ndft = cfg.ndft
    offs, len_mask = _mask_offsets(cfg)
    nb = en - len_mask - st
    if nb <= 0:
        raise ValueError("est range too narrow for mask correlator")
    corr = torch.zeros((sf.shape[0], nb), dtype=torch.float32,
                       device=sf.device)
    for o in offs:               # the reference's summation order
        corr = corr + sf[:, st + o:st + o + nb]
    b_max = torch.argmax(corr, dim=-1) + st                       # [C]
    foff = (b_max - ndft // 2).float() * (cfg.fs / ndft)
    m_idx = torch.arange(cfg.m, dtype=torch.float32, device=sf.device)
    return foff[:, None] + m_idx[None, :] * cfg.tone_spacing


# ----------------------------------------------------------------------------
# block demod core
# ----------------------------------------------------------------------------

def fsk_demod_block(cfg: FSKConfig, xw, state: FSKState, probe: bool = False,
                    spectral=freq_est_sf):
    """Demodulate one window (plain torch ops around K1: ``spectral`` is
    ``freq_est_sf``, the kernel on a CUDA tensor, or its twin).

    xw: [C, 2, nmem] float32 IQ planes.
    Returns (out dict, new partial state).  out contains:
      soft  [C, nsym*bps] float32 soft decisions (reference sign conventions)
      bits  [C, nsym*bps] uint8 hard bits
      f_est [C, M], ebno_db [C], ppm [C], nin_next [C]
    """
    C = xw.shape[0]
    M, P, nsym = cfg.m, cfg.p, cfg.nsym
    kc = _consts(cfg, xw.device)
    xw = xw.float().contiguous()

    f_est, sf_new = _freq_est(cfg, xw, state["sf"], spectral)
    xr, xi = xw[:, 0], xw[:, 1]                                   # [C, nmem]

    # --- tone downconvert + integrate-and-dump (fsk.c:644-668) ---
    # NCO phase factored as t = a*tsp + b (see the reference): a
    # tsp-long micro-mix, then a coarse rotation built from two short
    # trig tables — the same phases as per-sample evaluation.
    nps = cfg.nmem // cfg.tsp                                     # (nsym+2)*P
    k = f_est / float(cfg.fs)                                     # [C, M]
    xr2 = xr.reshape(C, 1, nps, cfg.tsp)
    xi2 = xi.reshape(C, 1, nps, cfg.tsp)
    phb = k[:, :, None] * kc.b[None, None, :]
    phb = phb - torch.floor(phb)                                  # [0, 1)
    angb = TWO_PI * phb                                           # [C, M, tsp]
    cb, sb = torch.cos(angb)[:, :, None, :], torch.sin(angb)[:, :, None, :]
    ur = (xr2 * cb + xi2 * sb).sum(-1)                            # [C, M, nps]
    ui = (xi2 * cb - xr2 * sb).sum(-1)
    Q, nA = kc.Q, kc.nA
    phA = k[:, :, None] * kc.aA[None, None, :]
    phA = phA - torch.floor(phA)
    angA = TWO_PI * phA
    cA, sA = torch.cos(angA), torch.sin(angA)                     # [C, M, nA]
    phR = k[:, :, None] * kc.aR[None, None, :]
    phR = phR - torch.floor(phR)
    angR = TWO_PI * phR
    cR, sR = torch.cos(angR), torch.sin(angR)                     # [C, M, Q]
    ca = (cA[:, :, :, None] * cR[:, :, None, :] -
          sA[:, :, :, None] * sR[:, :, None, :]).reshape(C, M, nA * Q)
    sa = (sA[:, :, :, None] * cR[:, :, None, :] +
          cA[:, :, :, None] * sR[:, :, None, :]).reshape(C, M, nA * Q)
    ca, sa = ca[:, :, :nps], sa[:, :, :nps]
    ps_re = ca * ur + sa * ui                                     # [C, M, nps]
    ps_im = ca * ui - sa * ur
    ni = (nsym + 1) * P
    fi_re = ps_re[:, :, 0:ni]
    fi_im = ps_im[:, :, 0:ni]
    for pp in range(1, P):
        fi_re = fi_re + ps_re[:, :, pp:pp + ni]                   # [C, M, ni]
        fi_im = fi_im + ps_im[:, :, pp:pp + ni]

    # --- fine timing from the |.|^2 spectral line at Rs (fsk.c:677-708) ---
    ft1 = torch.sum(fi_re * fi_re + fi_im * fi_im, dim=1)         # [C, ni]
    tc_re = torch.sum(ft1 * kc.rot_re[None, :], dim=-1)
    tc_im = torch.sum(ft1 * kc.rot_im[None, :], dim=-1)
    norm_timing = torch.atan2(tc_im, tc_re) / TWO_PI              # [-0.5, 0.5]
    rx_timing = norm_timing * P

    # --- sample clock tracking (fsk.c:713-731) ---
    d_norm = norm_timing - state["timing"]
    appm = 1e6 * d_norm / nsym
    ppm = torch.where(torch.abs(d_norm) < 0.2,
                      0.9 * state["ppm"] + 0.1 * appm, state["ppm"])
    half_ts = cfg.ts // 2
    nin_next = (cfg.n
                + (norm_timing > 0.25).to(torch.int32) * half_ts
                - (norm_timing < -0.25).to(torch.int32) * half_ts)

    # --- resample integrators at the timing estimate (fsk.c:737-757) ---
    # symbol k's sample sits at flat integrator index (k+1)*P + low
    # (low in [-(P//2+1), P//2]); a gather picks exactly the values the
    # reference selects from its static shifted slices.
    low = torch.floor(rx_timing).to(torch.int32)                  # [C]
    fract = rx_timing - low.float()
    low = torch.clamp(low, -(P // 2 + 1), P // 2)
    idx = (kc.sym_base[None, :] + low[:, None]).long()            # [C, nsym]
    idx = idx[:, None, :].expand(C, M, nsym)
    v_re = torch.gather(fi_re, 2, idx)
    v_im = torch.gather(fi_im, 2, idx)
    vh_re = torch.gather(fi_re, 2, idx + 1)
    vh_im = torch.gather(fi_im, 2, idx + 1)
    fr = fract[:, None, None]
    v_re = v_re * (1.0 - fr) + vh_re * fr
    v_im = v_im * (1.0 - fr) + vh_im * fr
    tmag = torch.sqrt(v_re * v_re + v_im * v_im)                  # [C, M, nsym]

    # --- hard bits + soft decisions (fsk.c:760-805) ---
    sym = torch.argmax(tmag, dim=1)                               # [C, nsym]
    if M == 2:
        bits = sym.to(torch.uint8)
        soft = tmag[:, 0, :] - tmag[:, 1, :]                      # + ⇒ bit 0
    else:
        b_hi = ((sym >> 1) & 1).to(torch.uint8)
        b_lo = (sym & 1).to(torch.uint8)
        bits = torch.stack([b_hi, b_lo], dim=-1).reshape(C, nsym * 2)
        t0, t1, t2, t3 = tmag[:, 0], tmag[:, 1], tmag[:, 2], tmag[:, 3]
        sd_hi = -t0 - t1 + t2 + t3                                # + ⇒ bit 1
        sd_lo = -t0 + t1 - t2 + t3
        soft = torch.stack([sd_hi, sd_lo], dim=-1).reshape(C, nsym * 2)

    # --- Eb/N0 estimate (fsk.c:806-833) ---
    mx = torch.amax(tmag, dim=1)                                  # [C, nsym]
    mean_e = torch.mean(mx, dim=-1)
    var_e = torch.mean(mx ** 2, dim=-1) - mean_e ** 2
    std_e = torch.sqrt(torch.clamp(var_e, min=0.0))
    ebno_db = -6.0 + 20.0 * torch.log10((1e-6 + mean_e) / (1e-6 + std_e))

    out = dict(soft=soft, bits=bits, f_est=f_est, ebno_db=ebno_db,
               ppm=ppm, nin_next=nin_next)
    if probe:
        out["sf"] = sf_new
        out["timing"] = norm_timing
        out["tmag"] = tmag
    new_state = dict(sf=sf_new, timing=norm_timing, ppm=ppm)
    return out, new_state


# ----------------------------------------------------------------------------
# stream demod: loop over blocks
# ----------------------------------------------------------------------------

SLACK_TS = 8          # the rolling buffer's slack, in symbols


def _offsets(cfg: FSKConfig):
    """The window offset's start, largest value and slack-wrap jump:
    every offset sits on the +-ts//2 adjustment grid."""
    half_ts = cfg.ts // 2
    n_steps = SLACK_TS * cfg.ts // half_ts
    off_max = n_steps * half_ts
    return (n_steps // 2) * half_ts, off_max, \
        _slack_wrap(cfg.ts, half_ts, off_max)


def _stream_layout(C: int, outs: dict) -> dict:
    """[n_blocks, C, ...] per-block outputs -> the stream layout: soft
    and bits [C, nb*nsym*bps], f_est [C, nb, M], the rest [C, nb, ...]."""
    out = {k: v.transpose(0, 1) for k, v in outs.items() if k != "nin_next"}
    out["soft"] = out["soft"].reshape(C, -1)
    out["bits"] = out["bits"].reshape(C, -1)
    return out


def fsk_scan_ref(cfg: FSKConfig, x, state: FSKState, n_blocks: int,
                 probe: bool = False, buffered: bool = True):
    """Plain twin of ``fsk_scan``: the scan as a Python loop of torch ops
    (``fsk_demod_block`` with K1's twin), on any device.

    The reference's rolling [C, 2, nmem + slack] buffer is advanced by a
    SHARED ``n`` samples per block, with each channel's ±ts/2 clock
    adjustments moving only its ``off`` pointer (wrapping back toward the
    slack center by a grid-aligned jump, ``_slack_wrap``).  At block b
    that buffer holds ``x[..., b*n : b*n + nmem + slack]``, so the window
    is gathered from ``x`` at ``b*n + off`` directly — the same samples,
    no buffer copy.  ``buffered=False`` is the reference's plain scan
    (``_fsk_demod_scan``): block b's window is ``x[..., ptr - nmem :
    ptr]`` at the channel's running pointer, its start clamped into
    ``[0, T - nmem]`` as ``jax.lax.dynamic_slice`` clamps it.

    x: [C, 2, T] float32.  Returns (state, outs) in the stream layout:
    soft/bits [C, n_blocks*nsym*bps], f_est [C, n_blocks, M], ebno_db and
    ppm [C, n_blocks]; with ``probe`` also sf [C, n_blocks, ndft], timing
    [C, n_blocks] and tmag [C, n_blocks, M, nsym]."""
    C, _, T = x.shape
    kc = _consts(cfg, x.device)
    off0, off_max, wrap = _offsets(cfg)
    off = torch.full((C,), off0, dtype=torch.int64, device=x.device)
    st = state
    outs = []
    for b in range(n_blocks):
        if buffered:
            start = b * cfg.n + off
        else:
            start = torch.clamp(st["ptr"].long() - cfg.nmem, 0,
                                T - cfg.nmem)
        idx = start[:, None] + kc.win_idx[None, :]               # [C, nmem]
        win = torch.gather(x, 2, idx[:, None, :].expand(C, 2, cfg.nmem))
        out, newp = fsk_demod_block(cfg, win, st, probe=probe,
                                    spectral=freq_est_sf_ref)
        off = off + (out["nin_next"] - cfg.n)
        off = torch.where(off > off_max, off - wrap, off)
        off = torch.where(off < 0, off + wrap, off)
        off = torch.clamp(off, 0, off_max)
        st = FSKState(sf=newp["sf"], timing=newp["timing"], ppm=newp["ppm"],
                      ptr=st["ptr"] + out["nin_next"], nin=out["nin_next"])
        outs.append(out)
    stacked = {key: torch.stack([o[key] for o in outs]) for key in outs[0]}
    return st, _stream_layout(C, stacked)


def _slack_wrap(ts: int, half_ts: int, off_max: int) -> int:
    """Grid-aligned slack-wrap jump (~off_max/2): a multiple of
    ``half_ts`` (so the offset stays on the window grid) and, for even
    ``ts``, a whole number of symbols."""
    if ts % 2 == 0:
        return max(ts, (off_max // (2 * ts)) * ts)
    return max(half_ts, (off_max // (2 * half_ts)) * half_ts)


def fsk_num_blocks(cfg: FSKConfig, t_samples: int) -> int:
    """Demod blocks the unbuffered scan takes from ``t_samples``."""
    return max(0, (t_samples - cfg.nmem) // cfg.block_advance_max)


def fsk_num_blocks_buffered(cfg: FSKConfig, t_samples: int,
                            slack_ts: int = SLACK_TS) -> int:
    w = cfg.nmem + slack_ts * cfg.ts
    return max(0, (t_samples - w) // cfg.n)


# ----------------------------------------------------------------------------
# the scan kernel (csrc/fsk_scan.cu)
# ----------------------------------------------------------------------------

# The C entry's three flat operand arrays, in the order of
# csrc/fsk_block.cuh's ScanPtr, ScanInt and ScanFloat.
SCAN_POINTERS = ("x", "sf_in", "timing_in", "ppm_in", "ptr_in",
                 "sf", "timing", "ppm", "ptr", "nin",
                 "soft", "bits", "f_est", "ebno_db", "ppm_blocks",
                 "probe_sf", "probe_timing", "probe_tmag",
                 "win", "tw", "starts", "weights", "rot")
MAX_MASK_OFFS = 12
SCAN_INTS = ("C", "T", "n_blocks", "m", "p", "nsym", "ts", "ndft", "nf",
             "est_type", "est_st", "est_en", "est_space", "mask_nb", "q",
             "na", "off0", "off_max", "wrap", "slack", "n_offs",
             *(f"offs{i}" for i in range(MAX_MASK_OFFS)), "unbuffered")
SCAN_FLOATS = ("fs", "bin_hz", "tone_spacing", "decay")


def _check_state(cfg: FSKConfig, state: FSKState, C: int, device):
    want = dict(sf=((C, cfg.ndft), torch.float32),
                timing=((C,), torch.float32), ppm=((C,), torch.float32),
                ptr=((C,), torch.int32))
    for k, (shape, dt) in want.items():
        t = state[k]
        if t.shape != shape or t.dtype != dt or t.device != device or \
                not t.is_contiguous():
            raise ValueError(f"fsk_scan: state[{k!r}] must be a contiguous "
                             f"{dt} tensor of shape {shape} on {device}")


def _scan_operands(cfg: FSKConfig, x, state: FSKState, n_blocks: int,
                   probe: bool = False, buffered: bool = True):
    """The scan kernel's operands for x [C, 2, T] (on any device: the
    CPU tests hand them to the kernel source compiled for the CPU).

    Returns (tensors by SCAN_POINTERS, None where absent; ints by
    SCAN_INTS; floats by SCAN_FLOATS; (new state, outs)) where the new
    state and outs are the output tensors the kernel fills, in the
    layout of ``fsk_scan_ref``."""
    if cfg.m not in (2, 4) or cfg.ndft not in KERNEL_NDFT:
        raise ValueError(f"fsk_scan kernel: M={cfg.m}, ndft={cfg.ndft} "
                         f"(takes M 2 or 4, ndft {KERNEL_NDFT})")
    C, two, T = x.shape
    dev = x.device
    if two != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("fsk_scan kernel: x must be contiguous float32 "
                         "[C, 2, T] planes")
    # the unbuffered scan clamps each window into [0, T - nmem]
    w = cfg.nmem + SLACK_TS * cfg.ts if buffered else cfg.nmem
    span = (n_blocks - 1) * cfg.n + w if buffered else w
    if n_blocks < 1 or C < 1 or span > T:
        raise ValueError(f"fsk_scan kernel: {n_blocks} blocks do not fit "
                         f"[{C}, 2, {T}]")
    _check_state(cfg, state, C, dev)
    k = _consts(cfg, dev)
    M, nsym, nb = cfg.m, cfg.nsym, n_blocks
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    new = dict(sf=torch.empty((C, cfg.ndft), **f32),
               timing=torch.empty((C,), **f32),
               ppm=torch.empty((C,), **f32),
               ptr=torch.empty((C,), **i32), nin=torch.empty((C,), **i32))
    nbits = nb * nsym * cfg.bits_per_symbol
    outs = dict(soft=torch.empty((C, nbits), **f32),
                bits=torch.empty((C, nbits), dtype=torch.uint8, device=dev),
                f_est=torch.empty((C, nb, M), **f32),
                ebno_db=torch.empty((C, nb), **f32),
                ppm=torch.empty((C, nb), **f32))
    if probe:
        outs.update(sf=torch.empty((C, nb, cfg.ndft), **f32),
                    timing=torch.empty((C, nb), **f32),
                    tmag=torch.empty((C, nb, M, nsym), **f32))
    tensors = dict(
        x=x, sf_in=state["sf"], timing_in=state["timing"],
        ppm_in=state["ppm"], ptr_in=state["ptr"],
        sf=new["sf"], timing=new["timing"], ppm=new["ppm"], ptr=new["ptr"],
        nin=new["nin"], soft=outs["soft"], bits=outs["bits"],
        f_est=outs["f_est"], ebno_db=outs["ebno_db"],
        ppm_blocks=outs["ppm"], probe_sf=outs.get("sf"),
        probe_timing=outs.get("timing"), probe_tmag=outs.get("tmag"),
        win=k.win, tw=k.tw, starts=k.starts_t, weights=k.weights_t,
        rot=k.rot)
    st, en = cfg.est_range
    mask_nb, offs = 0, ()
    if cfg.freq_est_type == 1:
        offs, len_mask = _mask_offsets(cfg)
        mask_nb = en - len_mask - st
        if mask_nb <= 0:
            raise ValueError("est range too narrow for mask correlator")
    off0, off_max, wrap = _offsets(cfg) if buffered else (0, 0, 0)
    ints = dict(C=C, T=T, n_blocks=nb, m=M, p=cfg.p, nsym=nsym, ts=cfg.ts,
                ndft=cfg.ndft, nf=cfg.numffts, est_type=cfg.freq_est_type,
                est_st=st, est_en=en, est_space=cfg.est_space_bins,
                mask_nb=mask_nb, q=k.Q, na=k.nA, off0=off0, off_max=off_max,
                wrap=wrap, slack=w - cfg.nmem, n_offs=len(offs),
                **{f"offs{i}": (offs[i] if i < len(offs) else 0)
                   for i in range(MAX_MASK_OFFS)},
                unbuffered=int(not buffered))
    floats = dict(fs=float(cfg.fs), bin_hz=float(cfg.fs / cfg.ndft),
                  tone_spacing=float(cfg.tone_spacing), decay=k.decay)
    return ([tensors[n] for n in SCAN_POINTERS],
            [int(ints[n]) for n in SCAN_INTS],
            [float(floats[n]) for n in SCAN_FLOATS], (new, outs))


def fsk_scan(cfg: FSKConfig, x, state: FSKState, n_blocks: int,
             probe: bool = False, buffered: bool = True):
    """The whole scan as one launch of ``csrc/fsk_scan.cu``: one
    256-thread block per channel walks the demod blocks with its carry in
    shared memory.  Same arguments and result as ``fsk_scan_ref``; x and
    the state must be contiguous and on one CUDA device (M 2 or 4, ndft
    64-512), else it raises.  ``launches["fsk_scan"]`` counts both modes,
    ``launches["fsk_scan_unbuffered"]`` the unbuffered one alone."""
    import ctypes
    if x.device.type != "cuda":
        raise ValueError(f"fsk_scan: no kernel for device {x.device}")
    ptrs, ints, floats, (new, outs) = _scan_operands(cfg, x, state,
                                                     n_blocks, probe,
                                                     buffered)
    p_arr = (ctypes.c_void_p * len(ptrs))(
        *[None if t is None else t.data_ptr() for t in ptrs])
    i_arr = (ctypes.c_int * len(ints))(*ints)
    f_arr = (ctypes.c_float * len(floats))(*floats)
    lib = kernels.library()
    err = lib.rsx_fsk_scan(
        ctypes.cast(p_arr, ctypes.c_void_p),
        ctypes.cast(i_arr, ctypes.c_void_p),
        ctypes.cast(f_arr, ctypes.c_void_p), x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "fsk_scan")
    kernels.launches["fsk_scan"] += 1
    if not buffered:
        kernels.launches["fsk_scan_unbuffered"] += 1
    return new, outs


def fsk_demod_stream(cfg: FSKConfig, x, device, state: FSKState | None = None,
                     probe: bool = False, buffered: bool = True):
    """Demodulate IQ on ``device``: complex [C, T] / [T], or float32
    planes [C, 2, T].

    Returns (soft [C, total_bits], bits [C, total_bits], stats dict,
    state).  Stats are [C, n_blocks] (f_est [C, n_blocks, M]); with
    ``probe=True`` also ``sf`` [C, nb, ndft], ``timing`` [C, nb] and
    ``tmag`` [C, nb, M, nsym].  A CPU tensor runs the plain scan
    ``fsk_scan_ref``, a CUDA tensor one launch of the scan kernel
    ``fsk_scan``.  ``buffered`` (the default) selects the gather-free
    rolling-buffer scan; ``buffered=False`` the plain per-channel window
    at the running pointer (``fsk_num_blocks`` blocks; the state's
    ``ptr`` carries where the next call's first window ends)."""
    is_cplx = x.is_complex() if isinstance(x, torch.Tensor) \
        else np.iscomplexobj(x)
    squeeze = is_cplx and len(x.shape) == 1
    x = iq_planes(x, device)
    C, _, T = x.shape
    if state is None:
        state = fsk_init_state(cfg, C, x.device)
    nb = fsk_num_blocks_buffered(cfg, T) if buffered \
        else fsk_num_blocks(cfg, T)
    if nb == 0:
        empty = torch.zeros((C, 0), dtype=torch.float32, device=x.device)
        return empty, empty.to(torch.uint8), {}, state
    if x.device.type == "cpu":
        state, outs = fsk_scan_ref(cfg, x, state, nb, probe, buffered)
    else:
        state, outs = fsk_scan(cfg, x.contiguous(), state, nb, probe,
                               buffered)
    soft, bits = outs.pop("soft"), outs.pop("bits")
    if squeeze:
        soft, bits = soft[0], bits[0]
    return soft, bits, outs, state
