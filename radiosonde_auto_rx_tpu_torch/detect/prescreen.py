"""Phase-1 detector prescreen: a cheap reduced-rate reject before the
full pass.

Port of ``radiosonde_auto_rx_tpu/detect/prescreen.py`` (``MARGIN``,
``_eff_sps``, ``Prescreen``) on an explicit ``device``.  The full
detector conditions four IF/FM streams and correlates every template per
candidate channel (``detect/scanner.py``); the prescreen runs the same
class structure at half rate wherever that is safe, so that channels
holding no sonde are rejected cheaply:

* a class decimates 2:1 only when its IF cutoff sits below the
  decimated Nyquist (alias-free) and its fastest effective header baud
  keeps >= 4 samples per symbol at the low rate (effective baud counts
  the shortest same-bit run);
* decimating classes run the IF lowpass with an output stride of 2
  (``ops/fir.fir_filter_block(stride=2)``), the FM discriminator on the
  decimated IQ, and template banks synthesized at the class rate;
* the unfiltered (raw) class discriminates at full rate and decimates
  after its FM audio lowpass, which doubles as the anti-alias filter;
* peaks come from the block-normalized chunked correlation without
  positions (``correlator._correlate_peaks_blocknorm_scan(positions=
  False)``) on every device, as in the reference, with each class's
  banded matmul operand built once (in each stream dtype) by the
  correlator; a stream shorter than two templates takes the exact
  path.

A channel survives when any type's |score| clears ``MARGIN * thres``.
Survivors get the unchanged full-rate pass, so accepted detections keep
the full pass's scores and positions.  The streams are in the
detector's ``stream_dtype()`` (``RSX_DETECT_DTYPE``: float32 unless it
asks for bfloat16, the reference's TPU form), and so are the banks and
banded operands they are correlated with.
"""

import numpy as np
import torch

from radiosonde_auto_rx_tpu_torch.detect.correlator import (
    _correlate_peaks_blocknorm_scan, _correlate_peaks_exact)
from radiosonde_auto_rx_tpu_torch.detect.templates import build_template_bank
from radiosonde_auto_rx_tpu_torch.ops.fir import (
    design_lowpass, fir_filter_block)
from radiosonde_auto_rx_tpu_torch.ops.fm import fm_discriminate_planes_mixed

# default survivor margin (validated by tests/test_prescreen.py across
# types, Eb/N0 and frequency offsets)
MARGIN = 0.55


def _eff_sps(spec) -> float:
    """Effective baud of a header: sps / shortest same-bit run."""
    run = 1
    mn = len(spec.header)
    for a, b in zip(spec.header, spec.header[1:]):
        if a == b:
            run += 1
        else:
            mn = min(mn, run)
            run = 1
    mn = min(mn, run)
    return spec.sps / max(1, mn)


class Prescreen:
    """Reduced-rate screening scores for a template-spec set on
    ``device``.

    ``scores(x)`` -> per-channel max over types of |corr score| / thres:
    >= MARGIN means "could clear the full detector's threshold".
    """

    DECIM = 2

    def __init__(self, fs: int, specs, bw_table, lpfm_table,
                 taps: int = 97, *, device):
        self.fs = fs
        self.device = torch.device(device)

        def on(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(
                self.device)

        # (h_if or None, h_fm, bank, lens, thres, d, banded operand)
        self.classes = []
        # template order of the [C, K_total] ratio matrix: classes in
        # ascending lp_iq order, specs in their in-class order
        self.spec_order = []
        for cls in sorted({s.lp_iq for s in specs}):
            cls_specs = [s for s in specs if s.lp_iq == cls]
            self.spec_order.extend(cls_specs)
            bw = bw_table[cls]
            # class decimation: alias-free AND >= 4 samples per
            # effective symbol at the low rate
            d = self.DECIM
            if max(_eff_sps(s) for s in cls_specs) * 4 > fs / self.DECIM:
                d = 1
            fs_cls = fs // d
            if bw < fs and bw / 2 >= fs_cls / 2:
                raise ValueError(f"class bw {bw} too wide for fs {fs}/{d}")
            bank, lens, _ = build_template_bank(fs_cls, cls_specs)
            thres = np.array([s.thres for s in cls_specs], np.float32)
            h_if = None if bw >= fs else design_lowpass(bw / 2 / fs, taps)
            lpfm = lpfm_table[1] if any(s.sps > 6000 for s in cls_specs) \
                else lpfm_table[0]
            # FM audio lowpass at the class rate (the raw class takes it
            # at full rate, as its anti-alias filter)
            fm_rate = fs if h_if is None else fs_cls
            h_fm = design_lowpass(lpfm / fm_rate,
                                  max(25, taps * fs_cls // fs) | 1)
            bank_t = on(bank)
            self.classes.append((
                None if h_if is None else on(h_if), on(h_fm), bank_t,
                tuple(int(v) for v in lens), on(thres), d))

    def scores(self, x):
        """x: [C, 2, T] IQ planes -> ratio [C] (max_k |score_k|/thres_k)."""
        return self.template_ratios(x).amax(dim=1)

    def template_ratios(self, x):
        """x: [C, 2, T] IQ planes on the device -> [C, K_total]
        per-template |score|/thres ratios (float32), templates ordered as
        ``spec_order``; computed in ``stream_dtype()``."""
        from radiosonde_auto_rx_tpu_torch.detect.scanner import stream_dtype
        sdt = stream_dtype()
        x = x.to(sdt)
        C, _, T = x.shape
        # one strided filter-bank pass per distinct stride over the
        # stacked re/im rows
        streams = [None] * len(self.classes)
        by_d = {}
        for i, cl in enumerate(self.classes):
            if cl[0] is not None:
                by_d.setdefault(cl[5], []).append(i)
        for d, idxs in by_d.items():
            hs = torch.stack([self.classes[i][0] for i in idxs])
            y = fir_filter_block(x.reshape(C * 2, T), hs, stride=d) \
                .reshape(C, 2, len(idxs), -1)
            fmf = fm_discriminate_planes_mixed(y[:, 0], y[:, 1], sdt)
            for fi, i in enumerate(idxs):
                streams[i] = fmf[:, fi]
        if any(cl[0] is None for cl in self.classes):
            fm_raw = fm_discriminate_planes_mixed(x[:, 0], x[:, 1], sdt)
            for i, cl in enumerate(self.classes):
                if cl[0] is None:
                    streams[i] = fm_raw
        ratios = []
        for s, (h_if, h_fm, bank, lens, thres, d) in zip(streams,
                                                        self.classes):
            # FM lowpass at the class rate; the raw class decimates here
            stride = d if h_if is None else 1
            fm = fir_filter_block(s, h_fm[None, :], stride=stride)[:, 0]
            if fm.shape[-1] >= 2 * bank.shape[-1]:
                val = _correlate_peaks_blocknorm_scan(
                    fm, bank, lens, positions=False)[0]
            else:
                val = _correlate_peaks_exact(fm, bank, lens)[0]
            ratios.append(val.abs() / thres[None, :])
        return torch.cat(ratios, dim=1)                    # [C, K_total]
