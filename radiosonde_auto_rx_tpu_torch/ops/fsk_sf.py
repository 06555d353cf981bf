"""K1: the FSK frequency estimator's fused spectral pass.

Port of ``radiosonde_auto_rx_tpu/ops/pallas_fsk.py::freq_est_sf``: for
every channel, the windowed DFT of ``numffts`` half-overlapped hops of
the demod window, their magnitudes, and the closed-form EMA
``sf_new = sf·decay + Σ_h w_h·|X_h|``.

``freq_est_sf`` dispatches on where ``xw`` lies: a CPU tensor goes to
the plain twin ``freq_est_sf_ref`` (the einsum form of
``demod/fsk.py::_freq_est``); a CUDA tensor is one launch of the
hand-written kernel ``csrc/fsk_sf.cu``, a thin kernel around the spectral
stage that the demod scan (``csrc/fsk_scan.cu``) runs inside its own
launch (``csrc/fsk_block.cuh``: one FFT per hop, the hops summed in order
in shared memory).  There is no path from a CUDA tensor to the twin.
"""

import math
import weakref
from functools import lru_cache

import torch

from radiosonde_auto_rx_tpu_torch import kernels
from radiosonde_auto_rx_tpu_torch.ops.fft import _twiddles


def freq_est_sf_ref(xw, sf, wc, ws, starts, weights, decay):
    """Plain twin (einsum form).  Shapes as ``freq_est_sf``."""
    ndft = sf.shape[-1]
    segs = torch.stack([xw[:, :, s:s + ndft] for s in starts], dim=2)
    xr, xi = segs[:, 0], segs[:, 1]                          # [C, nf, ndft]
    x_re = torch.einsum("cnd,de->cne", xr, wc) + \
        torch.einsum("cnd,de->cne", xi, ws)
    x_im = torch.einsum("cnd,de->cne", xi, wc) - \
        torch.einsum("cnd,de->cne", xr, ws)
    mag = torch.sqrt(x_re * x_re + x_im * x_im)              # [C, nf, ndft]
    _, w = _tables(tuple(int(s) for s in starts),
                   tuple(float(v) for v in weights), xw.device)
    return sf * decay + torch.einsum("cnd,n->cd", mag, w)


@lru_cache(maxsize=64)
def _tables(starts: tuple, weights: tuple, device: torch.device):
    """Hop starts (int32) and EMA weights (f32) as device arrays, cached:
    a fresh host->device copy per call would stall the block loop."""
    return (torch.tensor(starts, dtype=torch.int32, device=device),
            torch.tensor(weights, dtype=torch.float32, device=device))


KERNEL_NDFT = (64, 128, 256, 512)    # the FFT sizes the kernels take
DFT_TOL = 1e-6      # wc/ws against the DFT of wc's DC column, of its peak

# (id(wc), id(ws)) -> (weak references, tensor versions) of the operand
# pairs found to be a windowed DFT: each pair is checked once, not per call
_dft_checked = {}


def is_dft_pair(wc, ws) -> bool:
    """Whether wc/ws are the fftshifted windowed-DFT operands that
    ``demod.fsk._dft_mats`` builds, wc[n, k] = win[n] cos(2 pi n (k - N/2)
    / N) and ws the same with sin, for the window ``win`` = wc's DC column
    wc[:, N/2], to DFT_TOL of the window's peak.  That is the only function
    the kernel computes: it reads the window and does an FFT."""
    n = wc.shape[0]
    win = wc[:, n // 2].double().cpu()
    idx = torch.arange(n, dtype=torch.float64)
    ang = 2 * math.pi * torch.outer(idx, idx - n // 2) / n
    tol = DFT_TOL * float(win.abs().max())
    return all(float((m.double().cpu() - win[:, None] * f(ang)).abs().max())
               <= tol for m, f in ((wc, torch.cos), (ws, torch.sin)))


def _dft_pair_ok(wc, ws) -> bool:
    """``is_dft_pair``, cached per operand pair while neither is written."""
    key, ver = (id(wc), id(ws)), (wc._version, ws._version)
    hit = _dft_checked.get(key)
    if hit and hit[0]() is wc and hit[1]() is ws and hit[2] == ver:
        return True
    if not is_dft_pair(wc, ws):
        return False
    if len(_dft_checked) >= 64:
        _dft_checked.clear()
    _dft_checked[key] = (weakref.ref(wc), weakref.ref(ws), ver)
    return True


def _launch(xw, sf, wc, ws, starts, weights, decay):
    C, two, nmem = xw.shape
    ndft = sf.shape[-1]
    for name, t in (("xw", xw), ("sf", sf), ("wc", wc), ("ws", ws)):
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                t.device != xw.device:
            raise ValueError(f"freq_est_sf kernel: {name} must be a "
                             f"contiguous float32 tensor on {xw.device}")
    if two != 2 or sf.shape != (C, ndft) or wc.shape != (ndft, ndft) or \
            ws.shape != (ndft, ndft):
        raise ValueError("freq_est_sf kernel: expect xw [C, 2, nmem], "
                         "sf [C, ndft], wc/ws [ndft, ndft]")
    if ndft not in KERNEL_NDFT:
        raise ValueError(f"freq_est_sf kernel: ndft={ndft} not in "
                         f"{KERNEL_NDFT}")
    if not _dft_pair_ok(wc, ws):
        raise ValueError("freq_est_sf kernel: wc/ws must be the fftshifted "
                         "windowed DFT of wc's DC column (demod.fsk."
                         "_dft_mats), the only function the kernel computes")
    starts = tuple(int(s) for s in starts)
    weights = tuple(float(w) for w in weights)
    nf = len(starts)
    if len(weights) != nf or not starts:
        raise ValueError("freq_est_sf kernel: one weight per hop start")
    if min(starts) < 0 or max(starts) + ndft > nmem:
        raise ValueError("freq_est_sf kernel: hop outside the window")
    st, wt = _tables(starts, weights, xw.device)
    out = torch.empty_like(sf)
    if C:
        lib = kernels.library()
        err = lib.rsx_freq_est_sf(
            xw.data_ptr(), sf.data_ptr(), wc.data_ptr(), st.data_ptr(),
            wt.data_ptr(), float(decay),
            _twiddles(ndft, xw.device).data_ptr(), out.data_ptr(), C, nmem,
            ndft, nf, xw.device.index or 0,
            torch.cuda.current_stream(xw.device).cuda_stream)
        kernels.check(err, "freq_est_sf")
        kernels.launches["freq_est_sf"] += 1
    return out


def freq_est_sf(xw, sf, wc, ws, starts, weights, decay):
    """One fused EMA-spectrum update.

    xw: [C, 2, nmem] float32 window planes; sf: [C, ndft] EMA carry;
    wc/ws: [ndft, ndft] windowed-DFT operands (fftshifted columns, from
    ``demod.fsk._dft_mats``); starts: hop offsets into the window;
    weights/decay: closed-form per-hop EMA coefficients.
    Returns sf_new [C, ndft].

    The twin takes any wc/ws.  The kernel, an FFT, reads only the window
    in wc's DC column, wc[:, ndft/2], so on a CUDA tensor wc/ws must be
    that window's DFT operands (``is_dft_pair``, checked once per pair);
    any other pair raises."""
    if xw.device.type == "cpu":
        return freq_est_sf_ref(xw, sf, wc, ws, starts, weights, decay)
    if xw.device.type != "cuda":
        raise ValueError(f"freq_est_sf: no kernel for device {xw.device}")
    return _launch(xw, sf, wc, ws, starts, weights, decay)
