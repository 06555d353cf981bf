"""Matched-filter correlation of FM streams against the template bank.

Port of ``radiosonde_auto_rx_tpu/detect/correlator.py``, every form of
it: the correlation ``_correlate`` by the overlap-save FFT
(``_corr_fft``), the direct correlation (``_corr_direct``) or the
blocked-Toeplitz product (``_corr_toeplitz``), chosen by
``RSX_DETECT_CORR=fft|conv|toeplitz`` (read at import; ``auto``, the
default, is the reference's choice off a TPU: ``fft``; below 2·Lmax
samples the direct correlation); and the peak search by the exact
per-position normalization (``_correlate_peaks_exact``) or the
block-normalized one (``_correlate_peaks_blocknorm_scan``, one chunk
of the banded product at a time, the prescreen's on every device;
``_correlate_peaks_blocknorm``, the reference's monolithic form, has
the same outputs and calls it), chosen by
``RSX_DETECT_PEAKS=exact|blocknorm`` (read at import; ``auto``: exact)
in the dispatcher ``_correlate_peaks``.  A bfloat16 stream (the
detector's ``RSX_DETECT_DTYPE``) keeps the Toeplitz and banded
products' operands and score cubes in bfloat16, accumulated in float32,
as the reference does; the normalization terms are always float32.
The host decision loop (header re-read, M10/M20 and iMet subtype
disambiguation) is the reference's NumPy code, copied.

Numerics: the normalization takes ``s2 - L·dc²`` from differences of
float32 cumulative sums over the whole stream (48,000 samples), a
cancellation whose rounding depends on the order of the sums; a CUDA
scan sums in another order than the CPU, so scores differ between the
two by more than the correlation's own rounding (``chip_smoke.py`` and
``tests/test_torch_cuda.py`` state the tolerance).
"""

import os
import weakref
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from radiosonde_auto_rx_tpu_torch.ops.fir import _full_fp32


@dataclass
class Detection:
    name: str
    tn: int
    score: float
    position: int       # sample index of header end
    inverted: bool
    freq_offset: float  # Hz (from FM DC term, if computed)


def _windowed_sums(x, lens):
    """Running sums over trailing windows of per-type lengths.

    x: [C, T]; lens: [K] ints.  Returns sums [C, K, T'] aligned with the
    'valid' correlation positions for a bank padded to Lmax."""
    C, T = x.shape
    lmax = int(max(lens))
    nvalid = T - lmax + 1
    x = x.float()                 # running sums accumulate in f32
    cs = torch.cat([x.new_zeros(C, 1), torch.cumsum(x, dim=-1)], dim=-1)
    # correlation at valid position t covers x[t : t+L]
    return torch.stack([cs[:, int(L):nvalid + int(L)] - cs[:, :nvalid]
                        for L in lens], dim=1)          # [C, K, nvalid]


def _corr_direct(x, bank):
    """Direct correlation: [C, T] * [K, Lmax] -> [C, K, T']."""
    with _full_fp32():
        return F.conv1d(x[:, None, :], bank[:, None, :])


def _corr_fft(x, bank, nfft: int = 4096):
    """Overlap-save FFT cross-correlation, same result as _corr_direct.

    Circular correlation irfft(X · conj(H)) equals the linear one at lags
    [0, nfft-Lmax] when the template is zero-padded to Lmax ≤ nfft, so
    each nfft-frame (hop B = nfft-Lmax+1) yields B valid positions."""
    C, T = x.shape
    K, lmax = bank.shape
    if nfft < 2 * lmax:
        nfft = 1 << int(np.ceil(np.log2(2 * lmax)))
    B = nfft - lmax + 1
    nvalid = T - lmax + 1
    nblk = max(1, -(-nvalid // B))
    pad = (nblk - 1) * B + nfft - T
    xp = F.pad(x, (0, max(pad, 0)))
    frames = xp.unfold(-1, nfft, B)[:, :nblk]              # [C, nblk, nfft]
    xs = torch.fft.rfft(frames)                            # [C, nblk, nF]
    hs = torch.conj(torch.fft.rfft(bank, n=nfft))          # [K, nF]
    y = torch.fft.irfft(xs[:, :, None, :] * hs[None, None], n=nfft)
    corr = y[..., :B].permute(0, 2, 1, 3).reshape(C, K, nblk * B)
    return corr[:, :, :nvalid]


def _corr_toeplitz(x, bank, block: int = 128):
    """Blocked-Toeplitz correlation, the same result as _corr_direct:
    each B-sample frame x[m*B : m*B + B+Lmax-1] times the banded
    operand rhs[i, k*B + j] = bank[k, i - j] gives K·B output columns,
    so the whole bank correlates as one dense product.  The operands
    are in x's dtype (the bank's cast there), the products accumulate
    in float32, and the [C, K, T'] cube keeps x's dtype (bfloat16 for a
    bfloat16 stream), as the reference's does."""
    C, T = x.shape
    K, lmax = bank.shape
    B = int(block)
    nvalid = T - lmax + 1
    M = -(-nvalid // B)
    span = B + lmax - 1
    xp = F.pad(x, (0, M * B + lmax - 1 - T))
    rhs = _operand(bank, B, span, x.dtype)                # [span, K*B]
    with _full_fp32():
        out = xp.unfold(-1, span, B) @ rhs                # [C, M, K*B]
    corr = out.reshape(C, M, K, B).permute(0, 2, 1, 3).reshape(C, K, M * B)
    return corr[:, :, :nvalid]


# Correlation strategy: the overlap-save FFT off a TPU (the reference
# takes the blocked-Toeplitz product only there);
# RSX_DETECT_CORR=fft|conv|toeplitz forces.
_CORR_METHOD = os.environ.get("RSX_DETECT_CORR", "auto")


def _corr_method() -> str:
    return "fft" if _CORR_METHOD == "auto" else _CORR_METHOD


def _correlate(x, bank, lens):
    """x: [C, T] FM stream (float32 or bfloat16); bank: [K, Lmax], taken
    in x's dtype (its sum too), as the reference's callers cast it.

    Returns (corr [C,K,T'], xnorm [C,K,T'], dc [C,K,T']) at valid
    positions (T' = T-Lmax+1); correlation index t covers x[t:t+L_k].
    The normalization terms are float32."""
    T = x.shape[-1]
    lmax = bank.shape[-1]
    method = _corr_method()
    src, bank = bank, bank.to(x.dtype)
    if method == "toeplitz" and T >= 2 * lmax:
        corr = _corr_toeplitz(x, src)
    elif method == "fft" and T >= 2 * lmax:
        corr = _corr_fft(x.float(), bank.float())
    else:
        corr = _corr_direct(x.float(), bank.float())
    x = x.float()                 # bf16 streams: square/sum in f32
    s1 = _windowed_sums(x, lens)                        # [C,K,T']
    s2 = _windowed_sums(x * x, lens)
    lensf = torch.tensor([float(v) for v in lens], device=x.device)[
        None, :, None]
    dc = s1 / lensf
    # norm of (x - dc) over the window; template sums ~0 so corr is
    # DC-corrected via corr - dc*sum(tmpl)
    tsum = bank.sum(dim=-1).float()[None, :, None]
    corr = corr - dc * tsum
    xnorm = torch.sqrt(torch.clamp(s2 - lensf * dc * dc, min=1e-12))
    # dead-air guard: windows much quieter than the channel (e.g. zero
    # padding) would divide ~0/~0 into garbage scores — zero them out
    rms = torch.sqrt(torch.mean(x * x, dim=-1))[:, None, None]
    floor = 0.05 * torch.sqrt(lensf) * rms
    corr = torch.where(xnorm < floor, torch.zeros_like(corr), corr)
    return corr, xnorm, dc


def correlate_bank(x, bank, lens):
    """Normalized correlation scores of FM stream(s) x ([T] or [C, T]
    tensor) against ``bank`` [K, Lmax] (moved to x's device), on x's
    device: (scores [C, K, T'] in [-1, 1], dc [C, K, T'])."""
    x = x.float()
    if x.dim() == 1:
        x = x[None, :]
    corr, xnorm, dc = _correlate(x, torch.as_tensor(bank).to(x.device),
                                 [int(v) for v in lens])
    return corr / xnorm, dc


def _correlate_peaks_exact(x, bank, lens):
    """Correlate + per-(channel, type) peak reduction: only [C, K] peak
    values, positions and DC (plus the [C] stream mean for the
    frequency-offset estimate) leave the device.

    Returns (val [C, K], ipk [C, K] int32, dc [C, K], xm [C])."""
    corr, xnorm, dc = _correlate(x, bank, lens)
    score = corr / xnorm
    ipk = torch.argmax(torch.abs(score), dim=-1, keepdim=True)   # [C, K, 1]
    val = torch.gather(score, -1, ipk)[..., 0]
    dcpk = torch.gather(dc, -1, ipk)[..., 0]
    return val, ipk[..., 0].int(), dcpk, torch.mean(x.float(), dim=-1)


def banded_operand(bank, block: int = 128, rows: int | None = None
                   ) -> torch.Tensor:
    """The einsum-Toeplitz operand of a template bank [K, Lmax]:
    w[i, k*B + j] = bank[k, i - j] for 0 <= i - j < Lmax, [W, K*B] with
    W = ``rows`` (default ceil((B + Lmax - 1)/B)*B), in the bank's dtype
    on its device.  A frame x[m*B : m*B + W] times w is the raw
    correlation at t = m*B + j.  Built on the device (a gather, no host
    copy); the prescreen builds its banks' once."""
    bank = torch.as_tensor(bank)
    K, lmax = bank.shape
    B = int(block)
    W = -(-(B + lmax - 1) // B) * B if rows is None else int(rows)
    d = (torch.arange(W, device=bank.device)[:, None] -
         torch.arange(B, device=bank.device)[None, :])       # [W, B]
    inside = (d >= 0) & (d < lmax)
    g = bank[:, d.clamp(0, lmax - 1)]                       # [K, W, B]
    w = torch.where(inside, g, g.new_zeros(()))
    return w.permute(1, 0, 2).reshape(W, K * B).contiguous()


# banded operands, one per (bank, block, rows, dtype) while the bank
# lives: {key: (weak reference to the bank, operand)}
_OPERANDS = {}


def _operand(bank, block: int, rows, dtype) -> torch.Tensor:
    """``banded_operand(bank, block, rows)`` in ``dtype`` (equal to the
    operand of the bank cast to ``dtype``: the operand only places the
    bank's values), built once and kept while ``bank`` lives unchanged,
    so a detector's or a prescreen's banks are laid out once."""
    key = (id(bank), bank._version, int(block), rows, dtype)
    hit = _OPERANDS.get(key)
    if hit is not None and hit[0]() is bank:
        return hit[1]
    w = banded_operand(bank, block, rows).to(dtype)
    _OPERANDS[key] = (weakref.ref(
        bank, lambda _, key=key: _OPERANDS.pop(key, None)), w)
    return w


def _block_norms(xb, Mb, lens, B, M, pad):
    """Block-granular norm terms of the blocknorm peak search: per type
    and output block m, the DC and norm over the blocks covering
    t..t+L+B (clamped at the stream's end), from float32 block cumsums of
    xb [C, Mb', B]; [C, M + pad, K] each (pad rows: dc 0, norm 1)."""
    xbn = xb[:, :Mb].float()
    zero = xbn.new_zeros(xbn.shape[0], 1)
    cs1b = torch.cat([zero, torch.cumsum(xbn.sum(-1), dim=-1)], dim=-1)
    cs2b = torch.cat([zero, torch.cumsum((xbn * xbn).sum(-1), dim=-1)],
                     dim=-1)
    C = xbn.shape[0]
    m_idx = torch.arange(M, device=xb.device)
    dcs, xns = [], []
    for L in lens:
        lb = min(-(-L // B) + 1, Mb)
        lo = torch.clamp(m_idx, max=Mb - lb)[None].expand(C, M)
        s1 = cs1b.gather(1, lo + lb) - cs1b.gather(1, lo)
        s2 = cs2b.gather(1, lo + lb) - cs2b.gather(1, lo)
        n = float(lb * B)
        dc_a = s1 / n
        dcs.append(dc_a)
        xns.append(torch.sqrt(torch.clamp(s2 - n * dc_a * dc_a, min=1e-12)))
    dc_all = F.pad(torch.stack(dcs, dim=2), (0, 0, 0, pad))   # [C, M', K]
    xn_all = F.pad(torch.stack(xns, dim=2), (0, 0, 0, pad), value=1.0)
    return dc_all, xn_all


def _exact_rescore(xf, t_pk, corr_pk, tsum, lens, rms):
    """The exact per-position score at each peak t_pk [C, K] (int64):
    the per-sample window DC and norm from float32 cumsums of the
    float32 stream xf, as in ``_correlate``.  Returns (val, dc_pk)."""
    zero = xf.new_zeros(xf.shape[0], 1)
    cs1 = torch.cat([zero, torch.cumsum(xf, dim=-1)], dim=-1)
    cs2 = torch.cat([zero, torch.cumsum(xf * xf, dim=-1)], dim=-1)
    lensj = torch.tensor(lens, dtype=torch.int64, device=xf.device)[None, :]
    lensf = lensj.float()
    s1p = cs1.gather(1, t_pk + lensj) - cs1.gather(1, t_pk)
    s2p = cs2.gather(1, t_pk + lensj) - cs2.gather(1, t_pk)
    dc_pk = s1p / lensf
    xn_pk = torch.sqrt(torch.clamp(s2p - lensf * dc_pk * dc_pk, min=1e-12))
    floor = 0.05 * torch.sqrt(lensf) * rms[:, None]
    val = (corr_pk - dc_pk * tsum[None, :]) / xn_pk
    return torch.where(xn_pk < floor, torch.zeros_like(val), val), dc_pk


# rows of the banded product a chunk
M_CHUNK = 128


def _correlate_peaks_blocknorm_scan(x, bank, lens, block: int = 128,
                                    m_chunk: int = M_CHUNK,
                                    rescore: bool = True,
                                    positions: bool = True):
    """Peak search with block-granular normalization, one M-chunk of the
    banded correlation matmul at a time (JAX
    ``correlator._correlate_peaks_blocknorm_scan``, its ``lax.scan`` a
    Python loop here): per (channel, type) the best |corr - dc·tsum| /
    xnorm over the stream, with xnorm and dc taken once per ``block``
    output positions from block cumsums over a window that covers
    t..t+L+B; padded positions never win (-1 in the in-block max, -inf
    across blocks); windows quieter than 0.05·sqrt(L)·rms score 0; ties
    go to the first occurrence.  ``positions=True`` also returns each
    peak's position and, with ``rescore=True``, rescores it exactly
    (per-sample norms at the peak) or, with ``rescore=False``, returns
    the block-normalized signed score and the block DC at the peak;
    ``positions=False`` (the prescreen) returns only the
    block-normalized |score|.  The products' operands and the chunk's
    correlation are in x's dtype (bfloat16 for a bfloat16 stream),
    accumulated in float32 (full float32 for a float32 stream); the
    norms are float32.

    x: [C, T]; bank: [K, Lmax], taken in x's dtype (its sum too), as
    the reference's callers cast it; its banded operand is built once
    (``_operand``).  Returns (val [C, K], t_pk [C, K] int32, dc_pk
    [C, K], xm [C])."""
    C, T = x.shape
    K, lmax = bank.shape
    dev, xdt = x.device, x.dtype
    lens = [int(v) for v in lens]
    B = int(block)
    nvalid = T - lmax + 1
    M = -(-nvalid // B)
    nbw = -(-(B + lmax - 1) // B)
    W = nbw * B
    Mc = min(int(m_chunk), M)
    nch = -(-M // Mc)
    w = _operand(bank, B, None, xdt)
    bank = bank.to(xdt)
    Mb = -(-T // B)
    pad_to = max((nch * Mc + nbw) * B, Mb * B)
    xp = F.pad(x, (0, pad_to - T))
    xb = xp.reshape(C, -1, B)
    xf = x.float()
    dc_all, xn_all = _block_norms(xb, Mb, lens, B, M, nch * Mc - M)
    tsum = bank.sum(dim=-1).float()                         # [K]
    rms = torch.sqrt(torch.mean(xf * xf, dim=-1))           # [C]
    lensf = torch.tensor(lens, dtype=torch.float32, device=dev)
    floor_ck = 0.05 * torch.sqrt(lensf)[None, :] * rms[:, None]   # [C, K]
    frames = xp.unfold(-1, W, B)                            # [C, *, W]
    jB = torch.arange(B, device=dev)
    kB = torch.arange(K, device=dev)[None, :] * B
    neg1 = x.new_tensor(-1.0)
    best = xf.new_full((C, K), float("-inf"))
    t_pk = torch.zeros(C, K, dtype=torch.int64, device=dev)
    corr_pk = xf.new_zeros(C, K)
    for i in range(nch):
        m0 = i * Mc
        with _full_fp32():
            corr = torch.matmul(frames[:, m0:m0 + Mc], w)   # [C, Mc, K*B]
        corr = corr.reshape(C, Mc, K, B)
        dc_c = dc_all[:, m0:m0 + Mc]
        xn_c = xn_all[:, m0:m0 + Mc]
        t_pos = (m0 + torch.arange(Mc, device=dev))[:, None] * B + jB
        valid = t_pos < nvalid                              # [Mc, B]
        y = torch.abs(corr - (dc_c[..., None] *
                              tsum[None, None, :, None]).to(xdt))
        y = torch.where(valid[None, :, None, :], y, neg1)
        y_best, j_best = torch.max(y, dim=-1)               # [C, Mc, K]
        score = y_best.float() / xn_c
        score = torch.where(xn_c < floor_ck[:, None, :],
                            torch.zeros_like(score), score)
        score = torch.where((t_pos[:, 0] < nvalid)[None, :, None], score,
                            torch.full_like(score, float("-inf")))
        if not positions:
            best = torch.maximum(best, score.amax(dim=1))
            continue
        s_loc, m_loc = torch.max(score, dim=1)              # [C, K]
        j_loc = j_best.gather(1, m_loc[:, None, :])[:, 0]
        corr_loc = corr.reshape(C, Mc * K * B).gather(
            1, m_loc * (K * B) + kB + j_loc).float()
        upd = s_loc > best
        best = torch.where(upd, s_loc, best)
        t_pk = torch.where(upd, (m0 + m_loc) * B + j_loc, t_pk)
        corr_pk = torch.where(upd, corr_loc, corr_pk)
    xm = torch.mean(xf, dim=-1)
    if not positions:
        zero = xf.new_zeros(C, K)
        return best, zero.int(), zero, xm
    if not rescore:
        m_pk = (t_pk // B)[:, None, :]
        dc_pk = dc_all.gather(1, m_pk)[:, 0]
        xn_pk = xn_all.gather(1, m_pk)[:, 0]
        val = (corr_pk - dc_pk * tsum[None, :]) / xn_pk
        val = torch.where(xn_pk < floor_ck, torch.zeros_like(val), val)
        return val, t_pk.int(), dc_pk, xm
    # exact per-position rescore at the peak
    val, dc_pk = _exact_rescore(xf, t_pk, corr_pk, tsum, lens, rms)
    return val, t_pk.int(), dc_pk, xm


def _correlate_peaks_blocknorm(x, bank, lens, block: int = 128,
                               rescore: bool = True, positions: bool = True):
    """Peak reduction with block-granular normalization (JAX
    ``correlator._correlate_peaks_blocknorm``, which materializes the
    whole banded product): the scan form's outputs, which equal the
    monolithic form's (JAX ``tests/test_detect.py``), so it is computed
    by ``_correlate_peaks_blocknorm_scan``.  ``rescore=True`` rescores
    the peak exactly; ``rescore=False`` returns the block-normalized
    signed score at the peak, its position and its block DC;
    ``positions=False`` only the block-normalized |score|.

    x: [C, T]; bank: [K, Lmax].  Returns (val [C, K], t_pk [C, K] int32,
    dc_pk [C, K], xm [C])."""
    return _correlate_peaks_blocknorm_scan(x, bank, lens, block,
                                           rescore=rescore,
                                           positions=positions)


# Peak-search strategy: the exact per-position search off a TPU (the
# reference takes the block-normalized one only there);
# RSX_DETECT_PEAKS=exact|blocknorm forces.
_PEAKS_METHOD = os.environ.get("RSX_DETECT_PEAKS", "auto")


def _peaks_method() -> str:
    return "exact" if _PEAKS_METHOD == "auto" else _PEAKS_METHOD


def _correlate_peaks(x, bank, lens, rescore: bool = True):
    """The peak search the switches select (JAX
    ``correlator._correlate_peaks``): exact, or below 2·Lmax samples;
    else the block-normalized one, rescored unless ``rescore=False``."""
    if _peaks_method() == "exact" or x.shape[-1] < 2 * bank.shape[-1]:
        return _correlate_peaks_exact(x, bank, lens)
    return _correlate_peaks_blocknorm_scan(x, bank, lens, rescore=rescore)


def _headcmp(x_c, spec, start, fs, inverted, dc):
    """Re-read header bits at symbol centers and count errors
    (reference headcmp, dft_detect.c:866-901)."""
    spb = fs / spec.sps
    idx = (start + (np.arange(len(spec.header)) + 0.5) * spb).astype(int)
    idx = idx[idx < len(x_c)]
    if len(idx) < len(spec.header):
        return len(spec.header)
    bits = (x_c[idx] - dc) > 0
    want = np.array([c == "1" for c in spec.header])
    if inverted:
        want = ~want
    return int(np.sum(bits != want))


def _frm_m10_m20(x_c, spec, start, fs, inverted, dc):
    """Disambiguate M10 vs M20 by decoding the frame length/type bytes
    right after the header (reference frm_M10, dft_detect.c:932-965).

    Returns "M10", "M20", or None (bytes implausible)."""
    from radiosonde_auto_rx_tpu_torch.models.m10 import (
        STD_FLEN_M10, STD_FLEN_M20, TYPE_M10, TYPE_M10PLUS, TYPE_M20,
        TYPE_M2K2, pairs_to_bits, diff_decode)
    from radiosonde_auto_rx_tpu_torch.demod.framing import bits_to_bytes_be
    spb = fs / spec.sps
    n_raw = 2 * 8 * 2                       # two bytes of raw pair bits
    idx = (start + (np.arange(n_raw) + 0.5) * spb).astype(int)
    idx = idx[idx < len(x_c)]
    if len(idx) < n_raw:
        return None
    raw = ((x_c[idx] - dc) > 0).astype(np.uint8)
    if inverted:
        raw = 1 - raw
    by = bits_to_bytes_be(diff_decode(pairs_to_bits(raw), b0=0))
    flen, ftype = int(by[0]), int(by[1])
    if ftype == TYPE_M20 or flen == STD_FLEN_M20:
        return "M20"
    if ftype in (TYPE_M10, TYPE_M10PLUS, TYPE_M2K2) or flen == STD_FLEN_M10:
        return "M10"
    return "M10"      # header matched; default like the reference


def _imet_subtype(x_c, pos, fs, wideband=False):
    """Resolve the shared iMet AFSK preamble to a concrete variant by
    tone power (reference dft_detect.c:1542-1607): accumulate ~1 s of
    FM-audio spectrum after the preamble and compare the 2200 Hz and
    2400 Hz data-tone powers.  2200 Hz dominant (and above the 800 Hz
    reference band) -> iMet-4 family (IMET1RS on wideband captures);
    2400 Hz dominant -> iMet-1 AB, which the reference drops to avoid
    blocking MRZ detection.

    Returns "IMET4" | "IMET1RS" | None (drop).
    """
    seg = x_c[pos:pos + int(fs)]
    if len(seg) < fs // 4:           # too little audio to vote on
        return None
    n_dft = 1024
    nseg = len(seg) // n_dft
    sp = np.abs(np.fft.rfft(
        seg[:nseg * n_dft].reshape(nseg, n_dft), axis=-1)).sum(axis=0)
    df = fs / n_dft
    if int(2500 / df) >= len(sp):
        return None
    m = max(1, int(50.0 / df))

    def band_power(f_hz):
        b = int(f_hz / df + 0.5)
        lo = max(0, b - m // 4)
        return float(sp[lo:lo + m].sum())

    pow2200, pow2400, pow800 = (band_power(f) for f in (2200, 2400, 800))
    if pow2200 > pow2400 and pow2200 > pow800:
        return "IMET1RS" if wideband else "IMET4"
    return None


def decide_from_peaks(val_a, ipk_a, dc_a, xm, specs, lens, chan,
                      fm_gain_hz=None, max_det=1, fs=48000,
                      wideband=False):
    """Host decision loop over per-(channel, type) correlation peaks:
    threshold -> header re-read confirmation (headcmp) -> M10/M20 and
    iMet subtype disambiguation -> Detection list per channel
    (reference scan/dft_detect.c:866-965,1509-1607).

    ``chan(c)`` lazily returns channel ``c``'s conditioned FM stream as
    float32 NumPy — shared by ``detect_types`` and the station step's
    confirmation pass (``parallel/station_step.StationStep.confirm``)."""
    C = val_a.shape[0]
    out = []
    for c in range(C):
        dets = []
        for k, spec in enumerate(specs):
            ipk = int(ipk_a[c, k])
            val = float(val_a[c, k])
            if abs(val) >= spec.thres:
                herrs = _headcmp(np.asarray(chan(c)), spec, ipk, fs,
                                 val < 0, float(dc_a[c, k]))
                if herrs > spec.herrs:
                    continue
                off = 0.0
                if fm_gain_hz is not None:
                    # frequency offset from the stream mean: headers are
                    # not DC-balanced, so the whole dwell (payload
                    # averages out) beats the header window
                    off = float(xm[c]) * fm_gain_hz
                name = spec.name
                if name == "M10":
                    sub = _frm_m10_m20(chan(c), spec, ipk + int(lens[k]),
                                       fs, val < 0, float(dc_a[c, k]))
                    if sub is not None:
                        name = sub
                elif name == "IMETafsk":
                    sub = _imet_subtype(chan(c), ipk + int(lens[k]), fs,
                                        wideband)
                    if sub is None:
                        continue        # 2400 Hz dominant: not iMet-4/1RS
                    name = sub
                tn = {"IMET4": 26, "IMET1RS": 28,
                      "M20": 6}.get(name, spec.tn)
                dets.append(Detection(
                    name=name, tn=tn, score=abs(val),
                    position=ipk + int(lens[k]),
                    inverted=val < 0, freq_offset=off))
        dets.sort(key=lambda d: d.score, reverse=True)
        out.append(dets[:max_det] if max_det else dets)
    return out


def detect_types(x, bank, lens, specs, fm_gain_hz=None, max_det=1,
                 fs=48000, wideband=False):
    """Detect sonde types in FM stream(s).

    x: [T] or [C, T] tensor of FM discriminator output (float32, or the
    detector's bfloat16 streams); bank: [K, Lmax] templates on x's
    device, taken in x's dtype, as the reference does.  The peak search
    is the one ``RSX_DETECT_PEAKS`` selects (``_correlate_peaks``).
    Returns per channel a list of Detection sorted by score (the
    reference emits the best type, dft_detect.c:1612-1666).  Candidates are confirmed by re-reading the
    header bits at the detected position and bounding the bit errors
    (reference headcmp + herrs, dft_detect.c:866-901,1509-1524).
    ``fm_gain_hz``: scale from FM units to Hz for the frequency-offset
    estimate (reference df = dc/(2*FM_GAIN*decM), :438-442)."""
    single = x.dim() == 1
    xt = x if x.is_floating_point() else x.float()
    if single:
        xt = xt[None, :]
    # only [C, K] peak stats cross to the host; the FM streams stay on
    # the device and are fetched per channel, only when a candidate
    # clears its threshold
    val_a, ipk_a, dc_a, xm = (t.cpu().numpy() for t in _correlate_peaks(
        xt, bank, lens))
    _cache = {}

    def chan(c):
        if c not in _cache:
            # the host re-read takes float32 (streams may be bf16)
            _cache[c] = xt[c].float().cpu().numpy()
        return _cache[c]

    out = decide_from_peaks(val_a, ipk_a, dc_a, xm, specs, lens, chan,
                            fm_gain_hz=fm_gain_hz, max_det=max_det,
                            fs=fs, wideband=wideband)
    return out[0] if single else out
