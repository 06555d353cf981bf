"""Sonde detector: IQ conditioning + template-bank correlation.

Port of ``radiosonde_auto_rx_tpu/detect/scanner.py`` (``LPIQ_BW``,
``LPIQ_BW_LBAND``, ``LPFM_BW``, ``SondeDetector``).  Per IF bandwidth
class (6/12/22/200 kHz, or the 1680 MHz table with ``lband``;
reference scan/dft_detect.c:148-149, :1405-1410): an IF lowpass over
the re/im planes, one FM discriminator, an FM-audio lowpass, then the
class's templates correlated against the stream — batched over
channels, in ``stream_dtype()`` (``RSX_DETECT_DTYPE``, read at each
call: float32 unless it asks for bfloat16, the reference's TPU form;
the FIR banks, the discriminator's products and the streams are then
bfloat16, its ``atan2`` float32).  As in the reference, the half-rate
``Prescreen`` (``detect/prescreen.py``) is built by default (not for
L-band) and rejects empty channels of a batch of 8 or more before the
full pass.
"""

import os

import numpy as np
import torch

from radiosonde_auto_rx_tpu_torch.demod.fsk import iq_planes
from radiosonde_auto_rx_tpu_torch.detect.correlator import detect_types
from radiosonde_auto_rx_tpu_torch.detect.prescreen import MARGIN, Prescreen
from radiosonde_auto_rx_tpu_torch.detect.templates import (
    TEMPLATES, build_template_bank)
from radiosonde_auto_rx_tpu_torch.ops.channelizer import _dtype_named
from radiosonde_auto_rx_tpu_torch.ops.fir import (
    design_lowpass, fir_filter_block)
from radiosonde_auto_rx_tpu_torch.ops.fm import (
    FM_GAIN, fm_discriminate_planes_mixed)

# IF lowpass bandwidth per class (dft_detect.c:148-149)
LPIQ_BW = (6e3, 12e3, 22e3, 200e3)
# L-band rescaled class table (dft_detect.c -L flag :1405-1410): wider
# deviations at 1680 MHz, incl. the RS92-NGP 32 kHz tweak (scan.py:461)
LPIQ_BW_LBAND = (20e3, 32e3, 200e3, 400e3)
# FM-audio lowpass (dft_detect.c:148: 4k narrow, 10k wide)
LPFM_BW = (4e3, 10e3)


def stream_dtype() -> torch.dtype:
    """dtype of the conditioned FM streams: ``RSX_DETECT_DTYPE=float32|
    bfloat16`` forces; otherwise (the reference's ``auto``, which takes
    bfloat16 only on a TPU) float32."""
    forced = os.environ.get("RSX_DETECT_DTYPE")
    return _dtype_named(forced) if forced else torch.float32


class SondeDetector:
    """Detect sonde type(s) in IQ channels at rate ``fs`` on ``device``.

    Usage: ``SondeDetector(fs, device=dev).detect(iq)`` -> list of
    Detection (per channel when input is batched).  ``lband=True``
    selects the 1680 MHz IF bandwidth table; ``bw_table`` overrides the
    table (the station's 96 kHz wide scan passes its own).  The
    prescreen is built unless ``prescreen=False`` or ``lband``; a class
    too wide for its half rate leaves ``self.prescreen`` None."""

    def __init__(self, fs: int = 48000, specs=None, taps: int = 97,
                 lband: bool = False, prescreen: bool = True,
                 prescreen_margin: float | None = None, bw_table=None, *,
                 device):
        self.fs = fs
        self.lband = lband
        self.device = torch.device(device)
        if bw_table is None:
            bw_table = LPIQ_BW_LBAND if lband else LPIQ_BW
        specs = TEMPLATES if specs is None else specs
        self.prescreen = None
        if prescreen and not lband:
            try:
                self.prescreen = Prescreen(fs, specs, bw_table, LPFM_BW,
                                           taps, device=self.device)
            except ValueError:      # a class too wide for fs/2
                self.prescreen = None
            if prescreen_margin is None:
                prescreen_margin = MARGIN
        self.prescreen_margin = float(prescreen_margin
                                      if prescreen_margin is not None
                                      else 0.55)

        def on(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(
                self.device)

        # group templates by IF bandwidth class present at this rate:
        # (h_if, h_fm, specs, bank, lens); a class wider than fs takes
        # no filters
        self.classes = []
        for cls in sorted({s.lp_iq for s in specs}):
            bw = bw_table[cls]
            cls_specs = [s for s in specs if s.lp_iq == cls]
            bank, lens, _ = build_template_bank(fs, cls_specs)
            lens = tuple(int(v) for v in lens)
            if bw >= fs:
                self.classes.append((None, None, cls_specs, on(bank), lens))
                continue
            h_if = design_lowpass(bw / 2 / fs, taps)
            lpfm = LPFM_BW[1] if any(s.sps > 6000 for s in cls_specs) \
                else LPFM_BW[0]
            h_fm = design_lowpass(lpfm / fs, taps)
            self.classes.append((on(h_if), on(h_fm), cls_specs, on(bank),
                                 lens))
        filt = [cl[0] for cl in self.classes if cl[0] is not None]
        self._h_if = torch.stack(filt) if filt else None        # [F, K]
        # FM audio lowpasses grouped by distinct taps: (h_fm, classes)
        groups = {}
        for i, cl in enumerate(self.classes):
            if cl[1] is not None:
                key = cl[1].cpu().numpy().tobytes()
                groups.setdefault(key, (cl[1], []))[1].append(i)
        self._fm_groups = list(groups.values())

    def _condition(self, x):
        """x: [C, 2, T] planes -> list of FM streams [C, T] per class, in
        ``stream_dtype()``: all IF lowpasses as one filter-bank pass over
        the stacked re/im rows, one discriminator over the class-stacked
        planes, then the FM lowpasses grouped by distinct taps."""
        C, _, T = x.shape
        sdt = stream_dtype()
        x = x.to(sdt)
        out = [None] * len(self.classes)
        filt_idx = [i for i, cl in enumerate(self.classes)
                    if cl[0] is not None]
        if filt_idx:
            y = fir_filter_block(x.reshape(C * 2, T), self._h_if) \
                .reshape(C, 2, len(filt_idx), T)
            fmf = fm_discriminate_planes_mixed(y[:, 0], y[:, 1], sdt)
            for fi, i in enumerate(filt_idx):
                out[i] = fmf[:, fi]                       # [C, T]
        for i, cl in enumerate(self.classes):
            if cl[0] is None:
                out[i] = fm_discriminate_planes_mixed(x[:, 0], x[:, 1], sdt)
        for h_fm, idxs in self._fm_groups:
            sub = torch.stack([out[i] for i in idxs],
                              dim=1).reshape(C * len(idxs), T)
            flt = fir_filter_block(sub, h_fm[None, :])[:, 0]
            flt = flt.reshape(C, len(idxs), T)
            for k, i in enumerate(idxs):
                out[i] = flt[:, k]
        return out

    def detect(self, iq, max_det: int = 1, dc_block: bool = True,
               prescreen: bool | None = None):
        """iq: complex [T]/[C,T] or planes [C,2,T] (host data or a
        tensor) -> detections.

        Returns a list of Detection for 1-D input, else a list per
        channel.  Frequency offsets are in Hz (df = fs*dc/(2*FM_GAIN),
        the discriminator's normalization, demod/mod/demod_mod.c:298).

        ``prescreen``: None = auto (the half-rate reject when built and
        the batch holds 8 or more channels); True/False forces.  Only
        the channels the prescreen keeps get the full-rate pass, and
        their detections are the full pass's; a rejected channel gets
        [].  The survivors go through as they are (the reference pads
        their batch to a power of two for its compile cache; each
        channel's full pass does not depend on the batch)."""
        single = (iq.dim() if isinstance(iq, torch.Tensor)
                  else np.ndim(iq)) == 1
        x = iq_planes(iq, self.device)
        if dc_block:
            x = x - torch.mean(x, dim=-1, keepdim=True) * 0.98
        C = x.shape[0]
        use_pre = self.prescreen is not None and \
            (prescreen if prescreen is not None else C >= 8)
        if use_pre:
            ratio = self.prescreen.scores(x).cpu().numpy()
            surv = np.flatnonzero(ratio >= self.prescreen_margin)
            merged = [[] for _ in range(C)]
            if surv.size:
                sub = self._detect_full(
                    x.index_select(0, torch.from_numpy(surv).to(x.device)),
                    max_det)
                for i, c in enumerate(surv):
                    merged[int(c)] = sub[i]
            return merged[0] if single else merged
        merged = self._detect_full(x, max_det)
        return merged[0] if single else merged

    def _detect_full(self, x, max_det: int):
        """Full-rate 4-stream multi-template pass on [C, 2, T] planes."""
        streams = self._condition(x)
        C = x.shape[0]
        merged = [[] for _ in range(C)]
        for fm, (_, _, cls_specs, bank, lens) in zip(streams,
                                                     self.classes):
            dets = detect_types(fm, bank, lens, cls_specs,
                                fm_gain_hz=self.fs / (2.0 * FM_GAIN),
                                max_det=0, fs=self.fs,
                                wideband=self.lband or self.fs > 50000)
            for c in range(C):
                merged[c].extend(dets[c])
        for c in range(C):
            merged[c].sort(key=lambda d: d.score, reverse=True)
            if max_det:
                merged[c] = merged[c][:max_det]
        return merged
