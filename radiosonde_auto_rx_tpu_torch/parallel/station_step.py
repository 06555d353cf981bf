"""The station's per-block device dataflow on one device.

Port of the single-device parts of
``radiosonde_auto_rx_tpu/parallel/station_step.py::ShardedStationStep``:
``analyze`` (channelize + sparse Welch PSD, the ``n_t == 1`` branch,
and with ``screen=True`` the half-rate prescreen's template ratios of
every channel), ``expert_assignment`` (the host's threshold-only
routing from those ratios), the fused ``steady_step`` (analyze +
recentered extraction of off-grid task rows + per-type demod of the
active channels, the iMet AFSK chains on their FM audio), and the
full-rate confirmation of scan candidates (``confirm`` on the device,
then the host decision loop ``decide_confirmed``).  There is no mesh:
multi-device sharding and ``route_demod`` are not ported yet.
"""

import numpy as np
import torch

from radiosonde_auto_rx_tpu_torch.demod.fsk import fsk_demod_stream
from radiosonde_auto_rx_tpu_torch.detect.correlator import (
    _correlate_peaks_exact, decide_from_peaks)
from radiosonde_auto_rx_tpu_torch.detect.psd import _welch
from radiosonde_auto_rx_tpu_torch.detect.prescreen import Prescreen
from radiosonde_auto_rx_tpu_torch.detect.scanner import (
    LPFM_BW, LPIQ_BW, SondeDetector)
from radiosonde_auto_rx_tpu_torch.detect.templates import TEMPLATES
from radiosonde_auto_rx_tpu_torch.models.imet4 import afsk_fm_audio
from radiosonde_auto_rx_tpu_torch.ops.channelizer import (
    _channelize, _extract, pfb_prototype)
from radiosonde_auto_rx_tpu_torch.ops.fm import FM_GAIN
from radiosonde_auto_rx_tpu_torch.ops.resample import resample_planes
from radiosonde_auto_rx_tpu_torch.station.chains import (
    CHAIN_TABLE, demod_chain)


# expert (demod chain) types of the routed step: the 48 kHz chains
EXPERT_TYPES = ("RS41", "RS92", "DFM", "M10", "M20", "LMS6",
                "IMET5", "MEISEI", "MRZ", "MTS01", "IMET4", "RD94RD41")

# detector template name -> expert type.  The M10 template nominates the
# M10 expert by default (the reference's frm_M10 falls back to M10); the
# confirmation pass resolves M10-vs-M20 and the iMet subtypes, so these
# defaults only matter for threshold-only routing.  Templates absent
# here (wideband chains) fall back to the host path.
TEMPLATE_TO_EXPERT = {t: t for t in EXPERT_TYPES
                      if t not in ("M20", "IMET4")}
TEMPLATE_TO_EXPERT["IMETafsk"] = "IMET4"


class StationStep:
    """Channelize + PSD + steady demod + candidate confirmation for one
    channel geometry on ``device``."""

    def __init__(self, device, n_chan: int = 50, fs_ch: int = 48000,
                 nfft: int = 2048, conf_capacity: int = 2):
        self.device = torch.device(device)
        self.n_chan = int(n_chan)
        self.fs_ch = int(fs_ch)
        self.nfft = int(nfft)
        self.conf_cap = int(conf_capacity)
        self.prescreen = Prescreen(self.fs_ch, TEMPLATES, LPIQ_BW, LPFM_BW,
                                   device=self.device)
        # full-rate confirmation machinery; its own prescreen is off
        # (analyze screens, and the station confirms scan candidates
        # exactly)
        self.detector = SondeDetector(self.fs_ch, prescreen=False,
                                      device=self.device)
        # template index (prescreen.spec_order) -> expert index or -1
        self.template_expert = np.array(
            [EXPERT_TYPES.index(TEMPLATE_TO_EXPERT[s.name])
             if s.name in TEMPLATE_TO_EXPERT else -1
             for s in self.prescreen.spec_order], np.int32)
        self.taps = torch.from_numpy(pfb_prototype(self.n_chan)).to(
            self.device)
        self.pfb_p = int(self.taps.shape[0]) // self.n_chan
        self._chain_cache = {}

    def _channels(self, wide):
        B, _, T = wide.shape
        if T % self.n_chan:
            raise ValueError("capture length must be a multiple of n_chan")
        ch = _channelize(wide, self.taps, self.n_chan)        # [B, N, 2, M]
        return ch.reshape(B * self.n_chan, 2, T // self.n_chan)

    def analyze(self, wide, screen: bool = True):
        """wide [B, 2, T] f32 planes -> (channels [B*N, 2, T//N],
        psd [B, nfft] (sparse Welch, one nfft window per 4*nfft),
        ratios).  ``screen=True`` also runs the half-rate prescreen over
        every DC-blocked channel: ratios [B*N, K_total] in
        ``prescreen.spec_order``; else None.  The station's steady path
        passes ``screen=False``: its candidates come from the PSD scan
        and go straight to the exact ``confirm``."""
        chf = self._channels(wide)
        psd = _welch(wide, self.nfft, hop=4 * self.nfft)
        if not screen:
            return chf, psd, None
        dc = torch.mean(chf, dim=-1, keepdim=True) * 0.98
        return chf, psd, self.prescreen.template_ratios(chf - dc)

    def expert_assignment(self, ratios, margin: float = 1.0):
        """Host policy: per-channel expert id from template ratios.

        ratios: [C, K] (host numpy).  Returns (expert_ids [C] int32 with
        -1 = no expert, best_template [C] int32).  An approximate
        routing only: the ratios are half-rate prescreen scores, and
        lookalikes (M20-vs-M10, iMet subtypes) are undisambiguated; the
        station routes ``confirm`` + ``decide_confirmed``'s decisions."""
        r = np.asarray(ratios)
        best = r.argmax(axis=1)
        ok = r.max(axis=1) >= margin
        exp = np.where(ok, self.template_expert[best], -1).astype(np.int32)
        return exp, best.astype(np.int32)

    def _chain_for(self, name: str):
        """(cfg, resample_to, afsk) demod chain for a type — identical
        construction to Station.decode_channels.  A wideband chain is
        extracted per task by the station, never fused."""
        if name not in self._chain_cache:
            if CHAIN_TABLE[name].get("wide_fs", 0) > self.fs_ch:
                raise ValueError(f"{name} is a wideband chain: the station "
                                 f"extracts it per task, not in the fused "
                                 f"step")
            self._chain_cache[name] = demod_chain(name, self.fs_ch)
        return self._chain_cache[name]

    def steady_step(self, wide, idx, blk, rows, ph_m, ph_r, plan,
                    scan: bool = True):
        """One fused block: analyze + forced-row recentering + per-type
        demod of the predicted active channels.

        wide: [B, 2, T] tensor; idx: [K] global channel ids concatenated
        per plan entry; blk/rows/ph_m/ph_r: recentering slots (host
        arrays; a row id >= B*N marks a pad slot, skipped); plan: tuple
        of (type_name, count).  ``scan=False`` skips the Welch PSD and
        returns ``psd=None``.  Returns (chf, psd, {type: (soft, bits,
        stats)})."""
        if scan:
            chf, psd, _ = self.analyze(wide, screen=False)
        else:
            chf, psd = self._channels(wide), None
        rows = np.asarray(rows)
        keep = np.flatnonzero(rows < chf.shape[0])
        if keep.size:
            dev = self.device
            blk = np.asarray(blk)[keep]
            ext = _extract(
                wide[torch.from_numpy(blk.astype(np.int64)).to(dev)],
                self.taps,
                torch.from_numpy(np.asarray(ph_m)[keep]).to(dev),
                torch.from_numpy(np.asarray(ph_r)[keep]).to(dev),
                self.n_chan)
            chf.index_copy_(0, torch.from_numpy(
                rows[keep].astype(np.int64)).to(dev), ext)
        idx = torch.from_numpy(np.asarray(idx, np.int64)).to(self.device)
        outs = {}
        off = 0
        for name, n in plan:
            rows_t = idx[off:off + n]
            off += n
            cfg, rs_to, afsk = self._chain_for(name)
            x = chf.index_select(0, rows_t)
            if rs_to:
                x = resample_planes(x, self.fs_ch, rs_to)
            if afsk:
                # Bell-202 audio as a real signal: [audio, 0] planes
                audio = afsk_fm_audio(x, self.fs_ch)
                x = torch.stack([audio, torch.zeros_like(audio)], dim=1)
            soft, bits, stats, _ = fsk_demod_stream(cfg, x, self.device)
            outs[name] = (soft, bits, stats)
        return chf, psd, outs

    # ------------------------------------------------------------------ #

    @property
    def n_conf_slots(self) -> int:
        return self.conf_cap

    def confirm(self, channels, slot_cids):
        """Full-rate confirmation pass on candidate channels.

        channels: [C, 2, Tc] tensor; slot_cids: [S] global channel ids of
        the candidates.  The single-device body of the reference's
        sharded ``confirm``, without its pad slots (the station passes
        only real candidates): DC block, the detector's conditioning
        and, per bandwidth class, the exact peak search.  Returns
        dict(streams [n_classes, S, Tc], peaks [(val, ipk, dc, xm) per
        class, each [S, K_cls] ([S] for xm)]) for the host decision loop
        (``decide_confirmed``)."""
        det = self.detector
        mine = channels.index_select(0, torch.from_numpy(
            np.asarray(slot_cids, np.int64)).to(channels.device))
        # same DC block as SondeDetector.detect's entry
        mine = mine - torch.mean(mine, dim=-1, keepdim=True) * 0.98
        streams = det._condition(mine)                # per class [S, T]
        peaks = [_correlate_peaks_exact(fm, bank, lens)
                 for fm, (_, _, _, bank, lens) in zip(streams, det.classes)]
        return dict(streams=torch.stack(streams), peaks=peaks)

    def decide_confirmed(self, conf, slot_cids, max_det: int = 1):
        """Host decision loop over ``confirm`` outputs: the logic of
        ``SondeDetector._detect_full`` (threshold, headcmp, M10/M20 +
        iMet disambiguation, score sort).

        Returns {global channel id: [Detection, ...]}."""
        det = self.detector
        slot_cids = np.asarray(slot_cids)
        S = len(slot_cids)
        merged = [[] for _ in range(S)]
        streams = conf["streams"]
        # headcmp + subtype disambiguation read the same conditioned
        # stream up to 3x per candidate: fetch each row once
        _cache = {}

        def _chan(ci, c):
            key = (ci, int(c))
            if key not in _cache:
                _cache[key] = streams[ci, c].cpu().numpy()
            return _cache[key]

        for ci, ((_, _, cls_specs, _, lens), pk) in enumerate(
                zip(det.classes, conf["peaks"])):
            val, ipk, dc, xm = (v.cpu().numpy() for v in pk)
            dets = decide_from_peaks(
                val, ipk, dc, xm, cls_specs, np.asarray(lens),
                chan=lambda c, ci=ci: _chan(ci, c),
                fm_gain_hz=self.fs_ch / (2.0 * FM_GAIN), max_det=0,
                fs=self.fs_ch, wideband=self.fs_ch > 50000)
            for s in range(S):
                merged[s].extend(dets[s])
        out = {}
        for s in range(S):
            merged[s].sort(key=lambda d: d.score, reverse=True)
            out[int(slot_cids[s])] = merged[s][:max_det] if max_det \
                else merged[s]
        return out
