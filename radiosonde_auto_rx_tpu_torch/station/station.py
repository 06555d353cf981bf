"""The station: wideband IQ blocks in, telemetry out.

Port of ``radiosonde_auto_rx_tpu/station/station.py::Station``.
``start_manual_decoder`` registers a task; ``process_captures`` runs
``captures_dispatch`` and ``captures_collect`` over a batch of blocks by
one of three routes, as in the reference:

- the fused steady block (a narrow capture with ``use_mesh`` on and a
  one-shard mesh, the default on one GPU): one
  ``StationStep.steady_step`` per batch (channelize + PSD + recentering
  + per-type demod, speculated from the current task state), then the
  host scan and task policy, the full-rate confirmation of new scan
  candidates, which starts a task for each detected sonde, the
  speculation check, and frame decoding into telemetry;
- the sharded split dispatch (a mesh of several shards, or
  ``fused_steady_step: false``): ``StationStep.analyze`` over the mesh
  (the batch padded with zero blocks to a multiple of the ``ch`` size),
  the host scan and task policy, the sharded ``confirm`` of the scan
  candidates, then, with several ``ch`` shards, every task of an expert
  type through ``route_demod`` (the all-to-all to its expert's shard and
  the per-expert demod there) and ``_decode_routed``; every other task,
  and every task on one ``ch`` shard, through ``decode_channels`` on
  its rows gathered from the shards;
- the sequential route (``use_mesh: false``, or any capture centered at
  or above 1 GHz, the L-band profile of 240 kHz channels):
  ``process_capture`` block by block — PSD scan, row allocation,
  channelizer and recentered rows, the profile's detector on the
  candidate rows (its half-rate prescreen at 8 or more candidates),
  then per-type demod and decode (``decode_channels``).

The captures of one cycle (a block from each of several SDRs over a
band) may overlap.  Each task is demodulated and its bits decoded in one
capture of the cycle, its owner (``Station._owner``): the capture that
started it (or last decoded it) while the cycle holds it there, else
the nearest that holds it; a scan peak another capture owns is no
candidate.  So a sonde in an overlap leaves ``captures_collect``, and
reaches the exporters, once a cycle, as a sonde does at upstream's
station, which runs one decoder a sonde whatever the number of SDRs
(the JAX package demodulates it in every capture that holds it).  A
cycle of one capture, or of one source's micro-batch, is unchanged.

The collect also runs the single-channel paths: a second sonde inside
a channel whose row is taken (``_process_collision``: its own row
extracted from the wideband block, then detect + decode) and the 96 kHz
wide scan of the candidates the PSD width gate flags
(``_process_wide_candidate``).  The iMet AFSK chains ride the fused
step like any other type; the Weathex chains are extracted per task at
their own rate from the retained wideband block (``decode_channels``).

Frame decoding runs in the frame-plane worker pool
(``frame_plane_workers``, -1 = sized from the CPU count, as in the
reference; 0 = inline): the workers own each task's decoder state, the
main process keeps the telemetry tail, in ticket order.

The mesh: ``Station(..., mesh=...)``, else with ``use_mesh`` on
``make_mesh(n_t=mesh_time_shards)`` over every visible CUDA device when
``device`` is ``cuda`` with no index, over ``[device]`` otherwise (one
device: a 1x1 mesh; ``mesh_time_shards`` above 1 then raises, as the
reference's ``make_mesh`` does).  The station's host code needs every
shard in its process.

The scan/task policy is a copy of the reference's, with the same
semantics; the frame decoders, telemetry filter and config are the
port's copies of the reference's host modules.
"""

import dataclasses
import logging
import os
import time

import numpy as np
import torch

from radiosonde_auto_rx_tpu_torch.demod.fsk import fsk_demod_stream
from radiosonde_auto_rx_tpu_torch.detect.psd import power_spectrum, scan_peaks
from radiosonde_auto_rx_tpu_torch.detect.scanner import SondeDetector
from radiosonde_auto_rx_tpu_torch.detect.templates import (
    TEMPLATES, WIDEBAND_TEMPLATES)
from radiosonde_auto_rx_tpu_torch.models import get_model
from radiosonde_auto_rx_tpu_torch.models.imet4 import afsk_fm_audio
from radiosonde_auto_rx_tpu_torch.ops.channelizer import (
    channel_freqs, channelize, extract_channels, extract_phases,
    pfb_prototype)
from radiosonde_auto_rx_tpu_torch.ops.resample import resample_planes
from radiosonde_auto_rx_tpu_torch.parallel.mesh import (
    gather_rows, make_mesh, scatter_rows, unshard)
from radiosonde_auto_rx_tpu_torch.parallel.station_step import (
    EXPERT_TYPES, ROWS, StationStep)
from radiosonde_auto_rx_tpu_torch.station import gps_ephem
from radiosonde_auto_rx_tpu_torch.station.chains import (
    CHAIN_TABLE, DRIFT_MIN_HZ, MODEL_NAME, RECENTER_MIN_HZ, WIDE_SCAN_FS,
    WIDE_SCAN_WIN_HZ, WIDE_WIDTH_HZ, demod_chain)
from radiosonde_auto_rx_tpu_torch.station.config import default_config
from radiosonde_auto_rx_tpu_torch.station.frame_plane import FramePlane
from radiosonde_auto_rx_tpu_torch.station.telemetry import (
    RealtimeVelocityFilter, enrich_telemetry, telemetry_filter)
from radiosonde_auto_rx_tpu_torch.utils import probe

log = logging.getLogger("station")


def _np(t):
    """A tensor's host copy: on a card, the host waits here for the work
    that makes it."""
    with probe.span("station.d2h"):
        return t.detach().cpu().numpy()


class _BandProfile:
    """Channelizer + detector geometry for one capture configuration.

    The narrow profile carves the capture into 48 kHz sonde channels;
    the wide profile (above 1 GHz, reference scan.py:488-547 1680 MHz
    mode) uses few wide channels for MK2LMS/RS92-NGP, with the L-band
    detector (``WIDEBAND_TEMPLATES``, ``LPIQ_BW_LBAND``, no prescreen).
    The detector is built on first use."""

    def __init__(self, n_chan: int, fs_wide: int, device,
                 wide: bool = False):
        self.n_chan = n_chan
        self.fs_ch = fs_wide // n_chan
        self.freqs = channel_freqs(n_chan, fs_wide)
        self.pfb_taps = pfb_prototype(n_chan)
        self.wide = wide
        self._device = device
        self._detector = None

    @property
    def detector(self) -> SondeDetector:
        if self._detector is None:
            self._detector = SondeDetector(
                self.fs_ch, specs=WIDEBAND_TEMPLATES if self.wide else None,
                lband=self.wide, device=self._device)
        return self._detector


class Station:
    """Batch station on ``device`` (and ``mesh``): wideband IQ blocks in,
    telemetry out.

    Task state is keyed by absolute frequency (Hz), as in the
    reference."""

    def __init__(self, config: dict | None = None, exporters=None,
                 center_freq_hz: float = 402.5e6, *, device, mesh=None):
        self.device = torch.device(device)
        self.config = {**default_config(), **(config or {})}
        if mesh is None and bool(self.config.get("use_mesh", True)):
            devices = None if self.device.type == "cuda" and \
                self.device.index is None else [self.device]
            mesh = make_mesh(n_t=int(self.config.get("mesh_time_shards", 1)),
                             devices=devices)
        if mesh is not None and not mesh.all_local:
            raise ValueError("the station needs every mesh shard in its "
                             "process")
        self.mesh = mesh
        self.exporters = exporters or []
        self.center_freq = center_freq_hz
        self.fs_wide = int(self.config["capture_rate"])
        self.n_chan = int(self.config["num_channels"])
        self._narrow = _BandProfile(self.n_chan, self.fs_wide, self.device)
        self._wide = None            # built on the first >1 GHz capture
        self._steps = {}             # (n_chan, fs_ch) -> StationStep
        self.rt_filter = RealtimeVelocityFilter(self.config["max_velocity"])
        # parallel host frame plane: decoder worker pool (0 = inline,
        # -1 = auto-size; workers spawn lazily on first decode)
        n_workers = int(self.config.get("frame_plane_workers", -1))
        if n_workers < 0:
            n_workers = min(4, max(1, (os.cpu_count() or 2) - 1))
        self.frame_plane = FramePlane(n_workers)
        # task state (reference auto_rx.py task_list / temporary_block_list)
        # freq_hz (int) -> dict(type, decoder, last_ok, center: the
        # center of the capture that last decoded it, ``_owner``)
        self.active = {}
        self.temporary_blocks = {}   # freq_hz -> unblock time
        self.scan_results = []
        self.stats = dict(frames_ok=0, frames_filtered=0, detections=0)
        self.scan_enabled = True
        self.manual_tasks = {}       # freq_hz (int) -> forced type name
        # per-block recentering state: channel -> offset (Hz) of the
        # task frequency from the channel center; row -> offset its row
        # was EXTRACTED at (the drift-retune anchor)
        self._offsets = {}
        self._ext_off = {}
        self._ex_taps = {}           # n_dec -> wide-extraction prototype
        self._cur_wide = None        # the current block's [2, T] planes
        self._wide_det = None        # the 96 kHz wide-scan detector
        self._wide_freqs = set()     # last scan's wideband candidates
        self._defer_retunes = None   # fz -> target while a multi-block
                                     # collect is in flight
        self._defer_scan = set()     # deferred keys whose target came
                                     # from a scan peak (absorb)
        self._steady_tick = -1
        self._block_seq = 0          # the spans' block id, a dispatch

    # ------------------------------------------------------------------ #

    def profile(self, center_freq_hz: float | None = None) -> _BandProfile:
        """Channel geometry for a capture centered here: wide channels
        above 1 GHz (1680 MHz band; ``num_channels_wide`` of them, else
        one per 240 kHz), narrow below."""
        c = self.center_freq if center_freq_hz is None else center_freq_hz
        if c < 1e9:
            return self._narrow
        if self._wide is None:
            n_wide = int(self.config.get("num_channels_wide", 0)) or \
                max(1, self.fs_wide // 240000)
            self._wide = _BandProfile(n_wide, self.fs_wide, self.device,
                                      wide=True)
        return self._wide

    # geometry of the current center's profile
    @property
    def fs_ch(self):
        return self.profile().fs_ch

    @property
    def freqs(self):
        return self.profile().freqs

    @property
    def pfb_taps(self):
        return self.profile().pfb_taps

    @property
    def detector(self) -> SondeDetector:
        return self.profile().detector

    def channel_of_freq(self, freq_hz: float) -> int:
        prof = self.profile()
        rel = freq_hz - self.center_freq
        return int(np.argmin(np.abs(prof.freqs - rel)))

    def _chan_center(self, ci: int) -> float:
        """Absolute center frequency of channel ``ci`` (no offset)."""
        return self.center_freq + float(self.profile().freqs[ci])

    def freq_of_channel(self, ci: int) -> int:
        """Absolute (task-key) frequency of row ``ci``, including any
        recentering offset registered for it this block.  Rows beyond
        the PFB grid (a second sonde in one channel, a wide-scan row)
        store their absolute frequency directly."""
        if ci >= self.profile().n_chan:
            return int(round(self._offsets.get(ci, 0.0)))
        return int(round(self._chan_center(ci) +
                         self._offsets.get(ci, 0.0)))

    def in_capture(self, freq_hz: float,
                   center_hz: float | None = None) -> bool:
        """Whether the capture centered at ``center_hz`` (the current
        center by default) holds ``freq_hz``."""
        c = self.center_freq if center_hz is None else center_hz
        return abs(freq_hz - c) <= self.fs_wide / 2

    def _owner(self, fz: float, centers, prefer: float | None = None):
        """The center of the capture of a cycle (``centers``, one a
        block; blocks of one center are one capture) that demodulates
        the task or scan peak at ``fz``, so that a sonde in the overlap
        of two captures is decoded once a cycle: the center its task
        (the active task within ``quantization``) was last decoded in,
        while the cycle holds it there; else the nearest center that
        holds it, the first in source order on a tie.  ``prefer`` (a
        scan peak's own capture) is kept while it lies within
        ``quantization`` as near as that, so that a peak two captures
        see near their midpoint stays a candidate in at least one.  None
        where no capture of the cycle holds ``fz``."""
        holders = [c for c in dict.fromkeys(centers)
                   if self.in_capture(fz, c)]
        if len(holders) < 2:
            return holders[0] if holders else None
        q = float(self.config["quantization"])
        task = min((g for g in self.active if abs(g - fz) <= q),
                   key=lambda g: abs(g - fz), default=None)
        if task is not None and self.active[task].get("center") in holders:
            return self.active[task]["center"]
        near = min(holders, key=lambda c: abs(fz - c))
        if prefer in holders and abs(fz - prefer) <= abs(fz - near) + q:
            return prefer
        return near

    def _owns(self, fz: float, centers) -> bool:
        """Whether the current capture demodulates the task at ``fz``
        in the cycle of ``centers``."""
        return self._owner(fz, centers) == self.center_freq

    def _count_overlaps(self, centers):
        """Counts in ``overlap_rows`` the tasks that the current capture
        holds and leaves to another capture of the cycle."""
        n = sum(1 for fz in {**self.manual_tasks, **self.active}
                if self.in_capture(fz) and not self._owns(fz, centers))
        if n:
            probe.count("overlap_rows", n, self.stats)

    def _blocked(self, freq_hz: float) -> bool:
        now = time.time()
        for f, until in list(self.temporary_blocks.items()):
            if until < now:
                del self.temporary_blocks[f]
        return any(abs(freq_hz - f) < self.config["quantization"]
                   for f in self.temporary_blocks)

    # ------------------------------------------------------------------ #

    def _wide_planes(self, x) -> torch.Tensor:
        """Wideband input -> float32 [2, T] planes on the device.  Host
        complex is split on the host; int16 (cs16) and uint8 (cu8) wire
        planes are scaled on the device after a native-width copy."""
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
            if np.iscomplexobj(x):
                x = np.stack([x.real, x.imag]).astype(np.float32)
            x = torch.from_numpy(np.require(x, None, ("C", "W")))
        if x.device.type == self.device.type:
            t = x.to(self.device)
        else:
            with probe.span("station.h2d"):
                t = x.to(self.device)
        if t.is_complex():
            return torch.stack([t.real, t.imag]).float()
        if t.dim() != 2 or t.shape[0] != 2:
            raise ValueError("expect [2, T] planes")
        if t.dtype == torch.int16:
            # cs16 wire scale (an exact power of two)
            return t.float() * (1.0 / 32768.0)
        if t.dtype == torch.uint8:
            # rtl_sdr cu8: (x - 127.5)/128, as the reference decoders
            return (t.float() - 127.5) * (1 / 128)
        return t.float()

    def _cand_of_freq(self, f_abs: float,
                      snap_hz: float = RECENTER_MIN_HZ):
        """Absolute frequency -> (channel, offset-from-channel-center);
        offsets below ``snap_hz`` demodulate at the channel center."""
        ci = self.channel_of_freq(f_abs)
        off = f_abs - self._chan_center(ci)
        return (ci, 0.0 if abs(off) < snap_hz else float(off))

    def scan(self, wideband_iq) -> list:
        """PSD scan -> candidate (channel, offset_hz) pairs in the
        current capture: the sparse Welch PSD (one 2048-point segment
        per 8192 samples, K2 on a card), then ``scan_from_psd``.  With
        ``only_scan`` set, no PSD is taken."""
        if self.config["only_scan"]:
            return self.scan_from_psd(None)
        planes = self._wide_planes(wideband_iq)
        # the PSD's launch and its copy back, which waits for it
        with probe.span("station.d2h", of="psd"):
            _, psd = power_spectrum(planes[None], self.device, nfft=2048,
                                    fs=self.fs_wide, hop=8192)
        with probe.span("station.policy"):
            return self.scan_from_psd(psd[0], db=True)

    def scan_from_psd(self, psd, db: bool = False) -> list:
        """Candidates (channel, offset) from a wideband PSD row (raw
        ``_welch`` power, or dB with ``db=True``): peaks above the
        median floor, quantized to the absolute 10 kHz raster, refined
        to the local spectral centroid, collapsed within decoder
        spacing.  Wideband candidates are flagged in
        ``self._wide_freqs``."""
        self._wide_freqs = set()
        if self.config["only_scan"]:
            cands = [self._cand_of_freq(f * 1e6)
                     for f in self.config["only_scan"]
                     if self.in_capture(f * 1e6)]
            return self._scan_tail(cands)
        q = float(self.config["quantization"]) or 10e3
        psd = np.asarray(psd)
        psd_db = psd if db else 10.0 * np.log10(np.maximum(psd, 1e-20))
        nfft = psd_db.shape[-1]
        pfreqs = (np.arange(nfft) - nfft // 2) * (self.fs_wide / nfft)
        peaks, nf = scan_peaks(
            psd_db, pfreqs,
            snr_threshold=self.config["snr_threshold"],
            min_distance_hz=self.config["min_distance"],
            quantization_hz=0)
        fq_abs = np.unique(np.round((np.asarray(peaks) +
                                     self.center_freq) / q) * q)
        fq_abs = [float(f) for f in fq_abs
                  if not any(abs(f - b * 1e6) < q / 2
                             for b in self.config["never_scan"])]
        bin_hz = self.fs_wide / nfft
        p_lin = np.maximum(10 ** (psd_db / 10.0) - 10 ** (nf / 10.0), 0.0)

        def _centroid(f_abs, win_hz):
            """(centroid f_abs, RMS width Hz) of the floor-subtracted
            power within ±win_hz."""
            k = (f_abs - self.center_freq) / bin_hz + nfft // 2
            lo = max(0, int(round(k - win_hz / bin_hz)))
            hi = min(nfft, int(round(k + win_hz / bin_hz)) + 1)
            w = p_lin[lo:hi]
            if w.sum() <= 0:
                return f_abs, 0.0
            ks = np.arange(lo, hi)
            kc = float((w * ks).sum() / w.sum())
            var = float((w * (ks - kc) ** 2).sum() / w.sum())
            return ((kc - nfft // 2) * bin_hz + self.center_freq,
                    np.sqrt(max(var, 0.0)) * bin_hz)

        can_wide = (bool(self.config.get("wideband_sondes", False)) and
                    not self.profile().wide and
                    self.fs_wide % WIDE_SCAN_FS == 0)
        refined = []                 # (strength_db, f_abs, is_wide)
        for f in fq_abs:
            k = (f - self.center_freq) / bin_hz + nfft // 2
            fc, _ = _centroid(f, q)
            wide_c = False
            if can_wide:
                fw, width = _centroid(fc, WIDE_SCAN_WIN_HZ)
                if width > WIDE_WIDTH_HZ:
                    fc, wide_c = fw, True
            ki = min(nfft - 1, max(0, int(round(k))))
            refined.append((float(psd_db[ki]), round(float(fc), -2),
                            wide_c))
        spacing = max(float(self.config["min_distance"]),
                      float(self.config.get("decoder_spacing_limit",
                                            15e3)))
        fq_abs, kept = [], []
        self._wide_freqs = set()
        for s, f, wide_c in sorted(refined, reverse=True):
            if any(abs(f - b * 1e6) < q / 2
                   for b in self.config["never_scan"]):
                continue
            if all(abs(f - g) >= spacing for g in kept):
                kept.append(f)
                fq_abs.append(f)
                if wide_c:
                    ci_w, off_w = self._cand_of_freq(f)
                    self._wide_freqs.add(
                        int(round(self._chan_center(ci_w) + off_w)))
        fq_abs.sort()
        self.scan_results = {
            "timestamp": time.time(),
            "freq": ((pfreqs + self.center_freq) / 1e6).round(4).tolist(),
            "power": np.round(psd_db, 1).tolist(),
            "peak_freq": [f / 1e6 for f in fq_abs],
            "noise_floor": round(nf, 1),
        }
        cands = [self._cand_of_freq(f) for f in fq_abs]
        for f_mhz in self.config["always_scan"]:
            if self.in_capture(f_mhz * 1e6):
                cands.append(self._cand_of_freq(f_mhz * 1e6))
        return self._scan_tail(cands)

    def _scan_tail(self, cands: list) -> list:
        spacing = float(self.config.get("decoder_spacing_limit", 15e3))
        for f_mhz in self.config["always_decode"]:
            if self.in_capture(f_mhz * 1e6):
                cands.append(self._cand_of_freq(f_mhz * 1e6))
        out, seen = [], set()
        for ci, off in sorted(cands):
            fq = self._chan_center(ci) + off
            if self._blocked(fq):
                continue
            if self._absorb_candidate(fq, spacing):
                continue
            key = (ci, int(round(off)))
            if key in seen:
                continue
            seen.add(key)
            out.append((ci, off))
        return out[: self.config["max_peaks"]]

    def _absorb_candidate(self, fq: float, spacing: float) -> bool:
        """A candidate within ``decoder_spacing_limit`` of an active or
        manual task is the same (possibly drifting) sonde; an active
        task lagging the peak by a scan quantum moves to it (deferred
        while a multi-block collect is in flight)."""
        for fz in self.manual_tasks:
            if abs(fq - fz) <= spacing:
                return True
        for fz in list(self.active):
            if abs(fq - fz) <= spacing:
                if abs(fq - fz) >= float(self.config["quantization"]):
                    if self._defer_retunes is not None:
                        self._defer_retunes[fz] = fq
                        self._defer_scan.add(fz)
                    else:
                        self._retune(fz, fq)
                return True
        return False

    def _retune(self, old_fz: int, new_fz: float):
        """Move an active task to a new frequency, preserving decoder
        state (drift follow)."""
        new_fz = int(round(new_fz))
        if new_fz == old_fz or old_fz not in self.active \
                or new_fz in self.active:
            return
        self.active[new_fz] = self.active.pop(old_fz)
        self.frame_plane.rekey(old_fz, new_fz)
        log.info("drift: task %.4f MHz -> %.4f MHz",
                 old_fz / 1e6, new_fz / 1e6)

    # ------------------------------------------------------------------ #
    # the block cycle

    def _step(self, prof) -> StationStep:
        key = (prof.n_chan, prof.fs_ch)
        if key not in self._steps:
            # confirmation slots cover a scan's worth of candidates
            # whatever the mesh size (2 a shard on an 8-way mesh; a
            # one-shard mesh gets the same total on one shard)
            n_sh = self.mesh.shape["ch"] if self.mesh is not None else 1
            conf_default = max(2, -(-2 * int(self.config.get(
                "max_peaks", 10)) // n_sh))
            self._steps[key] = StationStep(
                self.device, n_chan=prof.n_chan, fs_ch=prof.fs_ch,
                conf_capacity=int(self.config.get("confirm_capacity",
                                                  conf_default)),
                mesh=self.mesh,
                capacity=int(self.config.get("expert_capacity", 4)))
        return self._steps[key]

    def process_capture(self, wideband_iq, center_freq_hz=None,
                        cycle=None) -> list:
        """One full sequential cycle: scan -> detect -> demod -> decode
        -> export.

        ``center_freq_hz`` retunes the station for this block (band-plan
        hopping; task state is frequency-keyed so decoders persist across
        hops).  ``cycle``: the centers of every capture of this block's
        cycle (this block's alone by default); a task or scan peak that
        another of them owns (``_owner``) is left to it.  Returns the
        accepted telemetry dicts."""
        if center_freq_hz is not None:
            self.center_freq = float(center_freq_hz)
        cycle = [self.center_freq] if cycle is None else cycle
        prof = self.profile()
        n_chan = prof.n_chan
        planes = self._wide_planes(wideband_iq)
        self._cur_wide = planes
        self._offsets = {}
        self._ext_off = {}
        cands = self.scan(planes) if self.scan_enabled else []
        with probe.span("station.policy"):
            # row allocation: each task/candidate frequency gets one row of
            # the channel bank.  On-grid rows are PFB channels; off-grid
            # rows are recentered extractions scattered over (or, when two
            # sondes share a channel, appended after) the PFB rows.
            rec = {}                     # row < n_chan -> extraction f_rel
            extra = []                   # appended rows' extraction f_rel
            row_alloc = {}               # row -> f_abs

            def _alloc(f_abs: float) -> int:
                ci = self.channel_of_freq(f_abs)
                off = f_abs - self._chan_center(ci)
                if ci not in row_alloc:
                    row = ci
                    if abs(off) >= RECENTER_MIN_HZ:
                        rec[row] = float(prof.freqs[ci]) + off
                        self._ext_off[row] = float(off)
                elif abs(row_alloc[ci] - f_abs) < 1.0:
                    return ci
                else:
                    # a second task inside one channel: its own recentered
                    # row, appended after the PFB rows, EXTRACTED at f_abs
                    # (the drift-retune anchor)
                    row = n_chan + len(extra)
                    extra.append(float(prof.freqs[ci]) + off)
                    self._ext_off[row] = float(f_abs)
                row_alloc[row] = float(f_abs)
                self._offsets[row] = f_abs - (
                    self._chan_center(row) if row < n_chan else 0.0)
                return row

            # manual tasks + known-active sondes within this capture
            # re-decode every visit without needing a fresh detection
            forced = {}                  # row -> type name
            for fz, name in self.manual_tasks.items():
                if self._owns(fz, cycle):
                    forced[_alloc(fz)] = name
            for fz, st in self.active.items():
                if self._owns(fz, cycle):
                    forced.setdefault(_alloc(fz), st["type"])
            self._count_overlaps(cycle)
            cand_rows = []
            wide_cands = []
            for ci, off in cands:
                fq = self._chan_center(ci) + off
                if self._owner(fq, cycle, prefer=self.center_freq) != \
                        self.center_freq:
                    continue             # another capture's sonde
                if int(round(fq)) in self._wide_freqs:
                    wide_cands.append(fq)
                    continue
                row = _alloc(fq)
                if row not in forced:
                    cand_rows.append(row)
        ch = channelize(planes, n_chan, self.device, prof.pfb_taps)
        ch = self._apply_recenter(ch, planes, prof, rec, extra)
        n_rows = n_chan + len(extra)
        tasks = [(row, name, None) for row, name in forced.items()]
        if cand_rows:
            # the profile's detector: its prescreen rejects empty rows
            # first when there are 8 or more candidates
            with probe.span("station.detect", rows=len(cand_rows)):
                detections = prof.detector.detect(ch.index_select(
                    0, torch.tensor(cand_rows, device=ch.device)))
            for row, dets in zip(cand_rows, detections):
                if not dets:
                    continue
                det = dets[0]
                self.stats["detections"] += 1
                name = det.name
                if prof.wide and name == "RS92":
                    # an RS92 header at 1680 MHz is an RS92-NGP
                    # (reference decode.py:948 starts rs92mod --ngp)
                    name = "RS92NGP"
                if name in CHAIN_TABLE or name in MODEL_NAME:
                    # the detector's FM-DC offset estimate refines the
                    # task frequency when the scan center was materially
                    # off; the demod's f_est feedback trims the rest
                    if det.freq_offset and \
                            RECENTER_MIN_HZ <= abs(det.freq_offset) <= 5e3:
                        self._offsets[row] = self._offsets.get(row, 0.0) \
                            + float(det.freq_offset)
                    tasks.append((row, name, det))
        with probe.span("station.policy"):
            tasks = self._dedupe_tasks(tasks)
        # one batched demod call per type
        telemetry_out = []
        for name, items in self.group_tasks_by_type(tasks, n_rows).items():
            telemetry_out.extend(self.decode_channels(ch, items, name))
        # wideband candidates (Weathex): 96 kHz wide-scan detect + decode
        # from the retained wideband block
        for fq in wide_cands:
            telemetry_out.extend(
                self._process_wide_candidate(prof, planes, fq))
        return telemetry_out

    def _dedupe_tasks(self, tasks: list) -> list:
        """Spacing rule over a block's freshly detected tasks: a
        detection within ``decoder_spacing_limit`` of an existing
        (forced) task or of a stronger detection is the same sonde (the
        reference's sequential handle_scan_results check,
        auto_rx.py:304-419)."""
        spacing = float(self.config.get("decoder_spacing_limit", 15e3))
        order = sorted(tasks, key=lambda t: (
            t[2] is not None, -(t[2].score if t[2] is not None else 0.0)))
        kept, out = [], []
        for row, name, det in order:
            fz = self.freq_of_channel(row)
            if det is not None and any(abs(fz - g) < spacing
                                       for g in kept):
                continue
            kept.append(fz)
            out.append((row, name, det))
        return out

    def _apply_recenter(self, ch, planes, prof, rec: dict, extra: list):
        """Recenter off-grid rows from the wideband block: one
        ``extract_channels`` call covers the scattered replacements
        (``rec``: row -> f_rel) and the appended rows (``extra``: f_rel
        each).  Unlike the reference (which pads the slots to a power of
        two for its compile cache), only real rows are extracted."""
        if not rec and not extra:
            return ch
        f_list = [f for _, f in sorted(rec.items())] + list(extra)
        ext = extract_channels(planes, self.fs_wide, f_list, prof.n_chan,
                               self.device, prof.pfb_taps)
        if rec:
            rows = torch.tensor(sorted(rec), device=ch.device)
            ch = ch.index_copy(0, rows, ext[:len(rec)])
        if extra:
            ch = torch.cat([ch, ext[len(rec):]])
        return ch

    def process_captures(self, blocks, centers=None) -> list:
        """B wideband blocks through one fused steady step (or, on the
        sequential route, ``process_capture`` block by block), then the
        host policy and frame decode.  Returns the accepted telemetry."""
        return self.captures_collect(self.captures_dispatch(blocks,
                                                            centers))

    def captures_dispatch(self, blocks, centers=None):
        """Queue the device work of a block batch (pair with
        ``captures_collect``).  With ``use_mesh`` off, or any capture
        centered at or above 1 GHz, the batch takes the sequential route
        (``process_capture`` per block, run by the collect)."""
        if centers is None:
            centers = [self.center_freq] * len(blocks)
        centers = [float(c) for c in centers]
        self._block_seq += 1
        seq = self._block_seq
        if self.mesh is None or any(self.profile(c).wide for c in centers):
            return ("seq", list(blocks), centers, seq)
        with probe.block(seq):
            return self._dispatch_batch(blocks, centers) + (seq,)

    def _dispatch_batch(self, blocks, centers):
        """``captures_dispatch`` on a mesh: the pending tuple without its
        block id."""
        prof = self.profile(centers[0])
        step = self._step(prof)
        planes = [self._wide_planes(b) for b in blocks]
        T = int(planes[0].shape[-1])
        if any(int(p.shape[-1]) != T for p in planes):
            raise ValueError("batch blocks must share a length")
        # pad the batch with zero blocks to a multiple of the ch size
        B_pad = -(-len(blocks) // step.n_sh) * step.n_sh
        wide = torch.stack(planes + [torch.zeros_like(planes[0])] *
                           (B_pad - len(blocks)))
        if self.mesh.size == 1 and \
                bool(self.config.get("fused_steady_step", True)):
            return self._dispatch_steady(step, prof, wide, len(blocks),
                                         centers)
        # the split dispatch: channelize + PSD only (sharded over the
        # mesh); candidates come from the PSD scan peaks and go straight
        # to the full-rate confirm, and every task is demodulated by the
        # collect; no fused step's outputs to collect
        chf, psd, _ = step.analyze(wide, screen=False)
        return ("sharded", step, prof, wide, chf, psd, len(blocks), centers,
                None)

    def _dispatch_steady(self, step, prof, wide, B, centers):
        """Speculative fused dispatch: predict the block's tasks from the
        current task state and run channelize + PSD + forced-row
        recentering + per-type demod as one step.  ``captures_collect``
        validates the prediction against the real scan policy.  Unlike
        the reference (which pads to powers of two for its compile
        cache), plans and recentering slots are unpadded."""
        n_chan = prof.n_chan
        pred = {}                    # cid -> (name, f_abs)
        rec = {}                     # cid -> extraction f_rel
        for b in range(B):
            self.center_freq = centers[b]
            for fz, name in self.manual_tasks.items():
                if self._owns(fz, centers):
                    ci = self.channel_of_freq(fz)
                    pred.setdefault(b * n_chan + ci, (name, float(fz)))
            for fz, st_a in self.active.items():
                if self._owns(fz, centers):
                    ci = self.channel_of_freq(fz)
                    pred.setdefault(b * n_chan + ci,
                                    (st_a["type"], float(fz)))
        type_cids = {}
        for cid, (name, f_abs) in pred.items():
            b, ci = divmod(cid, n_chan)
            if CHAIN_TABLE[name].get("wide_fs", 0) > prof.fs_ch:
                continue             # wide chains extract per task
            type_cids.setdefault(name, []).append(cid)
            off = f_abs - (centers[b] + float(prof.freqs[ci]))
            if abs(off) >= RECENTER_MIN_HZ:
                rec[cid] = float(prof.freqs[ci]) + off
        plan, idx, fused_pos = [], [], {}
        for name in sorted(type_cids):
            cids = sorted(type_cids[name])
            fused_pos.update({cid: (name, k)
                              for k, cid in enumerate(cids)})
            plan.append((name, len(cids)))
            idx.extend(cids)
        items = sorted(rec.items())
        T = int(wide.shape[-1])
        M = T // n_chan
        ph_m = np.zeros((len(items), M), np.float32)
        ph_r = np.zeros((len(items), n_chan), np.float32)
        blk = np.zeros(len(items), np.int32)
        rows = np.zeros(len(items), np.int32)
        for s, (cid, f_rel) in enumerate(items):
            ph_m[s], ph_r[s] = extract_phases(f_rel, self.fs_wide, T,
                                              n_chan)
            blk[s] = cid // n_chan
            rows[s] = cid
        # scan duty: while decoding, scan the PSD only every
        # ``scan_every`` blocks; with no active tasks every block scans
        scan = bool(self.scan_enabled)
        if scan and pred:
            n = max(1, int(self.config.get("scan_every", 4)))
            self._steady_tick += 1
            scan = (self._steady_tick % n) == 0
        chf, psd, fused = step.steady_step(
            wide, np.asarray(idx, np.int32), blk, rows, ph_m, ph_r,
            tuple(plan), scan=scan)
        return ("steady", step, prof, wide, chf, psd, B, centers,
                dict(pred=pred, rec=rec, fused=fused, fused_pos=fused_pos))

    def captures_collect(self, pending) -> list:
        """Finish a ``captures_dispatch`` batch: host scan/task policy,
        speculation check, host frame decode (or, on the sequential
        route, ``process_capture`` per block).  The pending tuple's last
        item is its block id, which every span of the collect carries."""
        with probe.block(pending[-1]):
            if pending[0] == "seq":
                _, blocks, centers, _ = pending
                out = []
                for b, c in zip(blocks, centers):
                    out.extend(self.process_capture(b, center_freq_hz=c,
                                                    cycle=centers))
                return out
            _, step, prof, wide, chf, psd, B, centers, steady, _ = pending
            return self._collect_sharded(step, prof, wide, chf, psd, B,
                                         centers, steady)

    def _collect_sharded(self, step, prof, wide, chf, psd, B,
                         centers, steady) -> list:
        # drift retunes are deferred for the whole batch; the freshest
        # measurement wins (scan peaks over resids)
        self._defer_retunes = {}
        self._defer_scan = set()
        try:
            return self._collect_sharded_inner(step, prof, wide, chf,
                                               psd, B, centers, steady)
        finally:
            pending, self._defer_retunes = self._defer_retunes, None
            self._defer_scan = set()
            for fz, target in pending.items():
                self._retune(fz, target)

    def _collect_sharded_inner(self, step, prof, wide, chf, psd, B,
                               centers, steady) -> list:
        n_chan = prof.n_chan
        with probe.span("station.policy"):
            sharded = isinstance(chf, dict)
            if sharded:
                psd = unshard(psd, self.mesh, ROWS)
            psd_np = None if psd is None else _np(psd)

            # host policy per block: scan peaks + task state -> candidates
            # and forced tasks (manual/active)
            tasks = {}                   # global cid -> (name, det)
            cand = []
            cand_strength = {}           # cid -> PSD dB at the channel
            cid_off = {}                 # cid -> recentering offset (Hz)
            rec = {}                     # cid -> extraction f_rel
            collide = []                 # (b, f_abs): 2nd sonde in a channel
            wide_host = []               # (b, f_abs): wideband candidates
            for b in range(B):
                self.center_freq = centers[b]
                self._offsets = {}
                cands_b = (self.scan_from_psd(psd_np[b])
                           if self.scan_enabled and psd_np is not None
                           else [])
                forced = {}              # ci -> (name, f_abs)
                for fz, name in self.manual_tasks.items():
                    if self._owns(fz, centers):
                        ci = self.channel_of_freq(fz)
                        if ci in forced and abs(forced[ci][1] - fz) >= 1.0:
                            collide.append((b, float(fz), name))
                            continue
                        forced[ci] = (name, float(fz))
                for fz, st_a in self.active.items():
                    if self._owns(fz, centers):
                        ci = self.channel_of_freq(fz)
                        if ci in forced and \
                                abs(forced[ci][1] - fz) >= 1.0:
                            if not any(abs(fz - c_f) < 1.0
                                       for _, c_f, _ in collide):
                                collide.append((b, float(fz), None))
                            continue
                        forced.setdefault(ci, (st_a["type"], float(fz)))
                self._count_overlaps(centers)
                for ci, (name, f_abs) in forced.items():
                    cid = b * n_chan + ci
                    tasks[cid] = (name, None)
                    off = f_abs - self._chan_center(ci)
                    cid_off[cid] = off
                    if abs(off) >= RECENTER_MIN_HZ:
                        rec[cid] = float(prof.freqs[ci]) + off
                if not cands_b:
                    continue
                db = 10.0 * np.log10(np.maximum(psd_np[b], 1e-20))
                nfft = db.shape[-1]
                for ci, off in cands_b:
                    cid = b * n_chan + ci
                    fq = self._chan_center(ci) + off
                    if self._owner(fq, centers, prefer=centers[b]) != \
                            centers[b]:
                        continue         # another capture's sonde
                    if int(round(fq)) in self._wide_freqs:
                        wide_host.append((b, fq))
                        continue
                    if cid in tasks or cid in cid_off:
                        # a second sonde in a channel whose row is taken
                        collide.append((b, fq, None))
                        continue
                    cand.append(cid)
                    cid_off[cid] = off
                    if abs(off) >= RECENTER_MIN_HZ:
                        rec[cid] = float(prof.freqs[ci]) + off
                    # the candidate's PSD neighborhood (for overflow rank)
                    k = int(round((prof.freqs[ci] + off) / self.fs_wide *
                                  nfft)) + nfft // 2
                    lo = max(0, k - nfft // (2 * n_chan))
                    cand_strength[cid] = float(
                        db[lo:k + nfft // (2 * n_chan) + 1].max())
            # recenter off-grid rows before demod.  The fused dispatch
            # already recentered the predicted rows; only new/changed rows
            # re-extract here, and rows the dispatch recentered but the
            # (post-retune) policy no longer wants are restored to the
            # channel center.  The split dispatch recentered none.
            s_rec = steady["rec"] if steady else {}
            restore = {cid: float(prof.freqs[cid % n_chan])
                       for cid in s_rec if cid not in rec}
            rec = {cid: f for cid, f in rec.items() if s_rec.get(cid) != f}
            rec.update(restore)
            # cid -> offset its row holds NOW
            ext_cid = {cid: f_rel - float(prof.freqs[cid % n_chan])
                       for cid, f_rel in {**s_rec, **rec}.items()}
            chf = self._recenter_cids(chf, wide, prof, rec)

            # full-rate confirmation: exact type decisions (headcmp, M10/M20
            # + iMet disambiguation).  Unlike the reference (which pads the
            # slots for its compile cache), only real candidates go in.
            S = step.n_conf_slots
            if len(cand) > S:
                order = np.argsort([cand_strength[c] for c in cand])[::-1]
                # a persistent signal is re-nominated by the next PSD scan
                log.warning("confirmation slots full: dropping the %d "
                            "weakest of %d candidates (re-nominated by the "
                            "next scan if still present)",
                            len(cand) - S, len(cand))
                cand = [cand[i] for i in order[:S]]
        if cand:
            # a mesh of several shards takes every slot (-1 pads); one
            # shard only the real candidates
            slots = np.asarray(cand, np.int64)
            if sharded:
                slots = np.concatenate([slots, np.full(S - len(cand), -1)])
            with probe.span("station.detect", rows=len(cand)):
                decided = step.decide_confirmed(step.confirm(chf, slots),
                                                slots)
            for cid, dets in decided.items():
                if not dets:
                    continue
                det = dets[0]
                self.stats["detections"] += 1
                if det.name in CHAIN_TABLE or det.name in MODEL_NAME:
                    tasks[cid] = (det.name, det)
                    # detector FM-DC refinement of the task frequency
                    foff = det.freq_offset or 0.0
                    if RECENTER_MIN_HZ <= abs(foff) <= 5e3:
                        cid_off[cid] = cid_off.get(cid, 0.0) + foff

        with probe.span("station.policy"):
            # spacing rule over the fresh detections (the reference's
            # sequential handle_scan_results semantics): forced tasks hold
            # their ground, then stronger detections absorb weaker ones
            # within decoder_spacing_limit
            spacing = float(self.config.get("decoder_spacing_limit", 15e3))

            def _task_fz(cid):
                b, ci = divmod(cid, n_chan)
                self.center_freq = centers[b]
                return self._chan_center(ci) + cid_off.get(cid, 0.0)

            def _elsewhere(cid):
                # a detection in a capture other than the nearest that
                # holds it ranks after those in theirs: when two captures
                # confirm one new sonde, the nearer takes it
                own = self._owner(_task_fz(cid), centers)
                return own is not None and own != centers[cid // n_chan]

            kept = [_task_fz(cid) for cid, (_, det) in tasks.items()
                    if det is None]
            for cid, (_, det) in sorted(
                    ((c, v) for c, v in tasks.items() if v[1] is not None),
                    key=lambda kv: (_elsewhere(kv[0]), -kv[1][1].score)):
                fz = _task_fz(cid)
                if any(abs(fz - g) < spacing for g in kept):
                    del tasks[cid]
                else:
                    kept.append(fz)

            # expert routing over the mesh; other types host-batched.  On a
            # single ch shard there is nothing to route: every task is a host
            # task (the per-type batch of only the types present)
            exp_ids = np.full(-(-B // step.n_sh) * step.n_sh * n_chan, -1,
                              np.int64)
            host_tasks = {}              # block -> [(ci, name, det)]
            for cid, (name, det) in tasks.items():
                if step.n_sh > 1 and name in EXPERT_TYPES:
                    exp_ids[cid] = EXPERT_TYPES.index(name)
                else:
                    b, ci = divmod(cid, n_chan)
                    host_tasks.setdefault(b, []).append((ci, name, det))
        telems = []
        if (exp_ids >= 0).any():
            res = step.gather_routed(step.route_demod(chf, exp_ids))
            telems.extend(self._decode_routed(
                step, res, tasks, centers, n_chan,
                int(wide.shape[-1]) // n_chan, cid_off, ext_cid))
        fused_items = []             # (name, j, cid) served by steady
        for b, items in host_tasks.items():
            with probe.span("station.policy"):
                self.center_freq = centers[b]
                self._offsets = {ci: cid_off.get(b * n_chan + ci, 0.0)
                                 for ci, _, _ in items}
                self._ext_off = {ci: ext_cid.get(b * n_chan + ci, 0.0)
                                 for ci, _, _ in items}
                self._cur_wide = wide[b]
                legacy = []
                for ci, name, det in items:
                    cid = b * n_chan + ci
                    fp = steady["fused_pos"].get(cid) if steady else None
                    # speculation check: same type, same task frequency, and
                    # no re-extraction pending for the row — else the split
                    # path re-demodulates this channel
                    if det is None and fp is not None and fp[0] == name and \
                            cid not in rec and \
                            abs(steady["pred"][cid][1] -
                                (self._chan_center(ci) +
                                 cid_off.get(cid, 0.0))) < 1.0:
                        fused_items.append((name, fp[1], cid))
                    else:
                        legacy.append((ci, name, det))
            for name, grp in self.group_tasks_by_type(
                    legacy, n_chan).items():
                if not sharded:
                    telems.extend(self.decode_channels(
                        chf[b * n_chan:(b + 1) * n_chan], grp, name))
                    continue
                # only the group's rows leave the shards (none for a
                # wideband chain, which extracts from the wideband block)
                wide_chain = CHAIN_TABLE[name].get("wide_fs", 0) > \
                    prof.fs_ch
                rows = None if wide_chain else gather_rows(
                    chf, self.mesh, [b * n_chan + ci for ci, _ in grp],
                    self.device)
                telems.extend(self.decode_channels(
                    rows, [(k, det) for k, (_, det) in enumerate(grp)],
                    name, chan_map={k: ci for k, (ci, _) in enumerate(grp)}))
        if steady and steady["fused_pos"]:
            # the rows the dispatch demodulated speculatively, against
            # those the speculation check served (``fused_channels``)
            probe.count("spec_predicted", len(steady["fused_pos"]),
                        self.stats)
        if fused_items:
            probe.count("fused_channels", len(fused_items), self.stats)
            telems.extend(self._decode_fused(
                steady["fused"], fused_items, centers, n_chan, cid_off,
                ext_cid))
        # second-sonde-in-a-channel fallback: own extracted row through
        # the single-channel detect + decode path
        for b, f_abs, forced_name in collide:
            self.center_freq = centers[b]
            self._cur_wide = wide[b]
            telems.extend(self._process_collision(prof, wide[b], f_abs,
                                                  forced_name))
        # wideband candidates (Weathex): the 96 kHz wide scan
        for b, f_abs in wide_host:
            self.center_freq = centers[b]
            self._cur_wide = wide[b]
            telems.extend(self._process_wide_candidate(prof, wide[b],
                                                       f_abs))
        self.center_freq = centers[-1]
        return telems

    def _decode_fused(self, fused, fused_items, centers, n_chan,
                      cid_off, ext_cid) -> list:
        """Host frame plane over the fused steady-step demod outputs
        (the ``decode_channels`` tail without re-dispatching device
        work)."""
        out = []
        cache = {}
        meta = {}                    # pool ticket -> telemetry-tail args
        probe.count("decode_rows", len(fused_items), self.stats)
        for name, j, cid in fused_items:
            if name not in cache:
                soft, bits, stats = fused[name]
                stats_np = {k: _np(v) for k, v in stats.items()}
                chain = CHAIN_TABLE[name]
                bits_np = _np(bits)
                cache[name] = (
                    _np(soft), bits_np,
                    np.atleast_2d(stats_np["ebno_db"])
                    if "ebno_db" in stats_np else None,
                    self._freq_residuals(stats_np, chain,
                                         bits_np.shape[0]),
                    bool(chain.get("afsk")))
            soft_b, bits_b, eb, resid, afsk = cache[name]
            b, ci = divmod(cid, n_chan)
            self.center_freq = centers[b]
            self._offsets = {ci: cid_off.get(cid, 0.0)}
            fz = self.freq_of_channel(ci)
            bits = bits_b[j]
            soft = None if afsk else soft_b[j]
            if afsk:
                bits = 1 - bits      # sym 0 = 1200 Hz = bit 1
            snr = None if eb is None else float(eb[j].max())
            fr = None if resid is None else resid[j]
            fd = self._f_demod_of(ci, fz, ext=ext_cid.get(cid, 0.0))
            if self.frame_plane.workers > 0:
                # the worker owns this task's decoder state: an inline
                # decode here would build a second decoder whose state
                # diverges from the worker's
                model_name = MODEL_NAME.get(name, name)
                ticket = self.frame_plane.decode(
                    fz, model_name,
                    self._decoder_kwargs(name, model_name), bits,
                    None if soft is None else -soft)
                meta[ticket] = (name, fz, snr, None, fr, fd,
                                self.center_freq)
                continue
            try:
                out.extend(self._decode_frames(
                    fz, name, bits, soft, snr, None,
                    f_resid=fr, f_demod=fd))
            except Exception:
                log.exception("decode failed on %.3f MHz (%s)",
                              fz / 1e6, name)
        if meta:
            out.extend(self._pooled_tail(meta))
        return out

    def _process_collision(self, prof, planes, f_abs: float,
                           forced_name: str | None = None) -> list:
        """Detect + decode one candidate whose channel row is already
        owned by another task (two sondes >= decoder_spacing_limit apart
        inside one 48 kHz channel): extract its recentered row from the
        wideband block and run the single-channel path on it.
        ``forced_name`` (a second manual task) skips detection."""
        f_rel = f_abs - self.center_freq
        row = extract_channels(planes, self.fs_wide, [f_rel], prof.n_chan,
                               self.device, prof.pfb_taps)
        det = None
        name = forced_name
        if name is None:
            dets = prof.detector.detect(row, prescreen=False)[0]
            if not dets:
                return []
            det = dets[0]
            self.stats["detections"] += 1
            name = det.name
            if prof.wide and name == "RS92":
                name = "RS92NGP"
        if name not in CHAIN_TABLE and name not in MODEL_NAME:
            return []
        n_chan = prof.n_chan
        self._offsets = {n_chan: float(f_abs)}   # virtual row
        self._ext_off[n_chan] = float(f_abs)     # demod anchor = here
        return self.decode_channels(row, [(0, det)], name,
                                    chan_map={0: n_chan})

    def _wide_scan_detector(self) -> SondeDetector:
        """The 96 kHz detector for wideband types: the real ±25 kHz tone
        pairs are outside any 48 kHz channel, so wide candidates
        re-detect on a 96 kHz extraction with a 64 kHz IF class (the
        audio lowpass then recovers the baud pattern)."""
        if self._wide_det is None:
            specs = [dataclasses.replace(s, lp_iq=0)
                     for s in TEMPLATES if s.name.startswith("WXR")]
            self._wide_det = SondeDetector(
                WIDE_SCAN_FS, specs=specs, prescreen=False,
                bw_table=(64e3, 64e3, 64e3, 200e3), device=self.device)
        return self._wide_det

    def _wide_taps(self, n_dec: int) -> np.ndarray:
        """The ``n_dec``-branch extraction prototype, built once."""
        if n_dec not in self._ex_taps:
            self._ex_taps[n_dec] = pfb_prototype(n_dec)
        return self._ex_taps[n_dec]

    def _process_wide_candidate(self, prof, planes, f_abs: float) -> list:
        """Wide-scan one flagged candidate: extract a 96 kHz channel at
        its carrier from the wideband block, detect with the wide bank,
        decode through the wideband chain.  Falls back to the narrow
        single-channel path when no wide type confirms (the width gate
        can fire on overlapping narrow signals)."""
        n_dec = self.fs_wide // WIDE_SCAN_FS
        f_rel = float(f_abs) - self.center_freq
        row96 = extract_channels(planes, self.fs_wide, [f_rel], n_dec,
                                 self.device, self._wide_taps(n_dec))
        dets = self._wide_scan_detector().detect(row96, prescreen=False)[0]
        if not dets:
            return self._process_collision(prof, planes, f_abs)
        det = dets[0]
        self.stats["detections"] += 1
        name = det.name
        if name not in CHAIN_TABLE:
            return []
        n_chan = prof.n_chan
        self._offsets[n_chan] = float(f_abs)     # virtual row
        self._ext_off[n_chan] = float(f_abs)     # demod anchor = here
        # the detection row is already at WIDE_SCAN_FS — reuse it when
        # that IS the chain's rate (WXR*); other rates re-extract
        ready = int(CHAIN_TABLE[name].get("wide_fs", 0)) == WIDE_SCAN_FS
        return self.decode_channels(row96, [(0, det)], name,
                                    chan_map={0: n_chan}, wide_ready=ready)

    def _recenter_cids(self, chf, wide, prof, rec: dict):
        """Scatter recentered extractions over the channel rows
        (``rec``: global cid -> extraction f_rel)."""
        if not rec:
            return chf
        items = sorted(rec.items())
        n_chan = prof.n_chan
        blk = torch.tensor([cid // n_chan for cid, _ in items],
                           device=self.device)
        ext = extract_channels(wide[blk], self.fs_wide,
                               [f for _, f in items], n_chan, self.device,
                               prof.pfb_taps)
        if isinstance(chf, dict):
            return scatter_rows(chf, [cid for cid, _ in items], ext)
        rows = torch.tensor([cid for cid, _ in items], device=self.device)
        return chf.index_copy(0, rows, ext)

    def _decode_routed(self, step, res, tasks, centers, n_chan, t_total,
                       cid_off, ext_cid) -> list:
        """Host frame plane over ``route_demod`` outputs (``res``, from
        ``gather_routed``): slice each routed slot's valid bits/soft,
        apply the per-chain host tail (AFSK bit inversion), decode
        task-keyed by frequency."""
        ids = _np(res["ids"])
        mask = _np(res["mask"])
        ebno = _np(res["ebno"])
        fres = _np(res["fres"])
        fcnt = _np(res["fcnt"])
        dropped = int(_np(res["dropped"]).sum())
        if dropped:
            # capacity overflow: the reference's loss mode when
            # detections exceed the available SDRs
            log.warning("expert routing dropped %d channel(s) — raise "
                        "expert_capacity", dropped)
        out = []
        probe.count("decode_rows", int(mask.sum()), self.stats)
        for e, name in enumerate(EXPERT_TYPES):
            afsk = bool(CHAIN_TABLE[name].get("afsk"))
            for s in np.flatnonzero(mask[e]):
                cid = int(ids[e, s])
                b, ci = divmod(cid, n_chan)
                self.center_freq = centers[b]
                self._offsets = {ci: cid_off.get(cid, 0.0)}
                fz = self.freq_of_channel(ci)
                det = tasks.get(cid, (None, None))[1]
                bits, soft = step.slot_bits(res, e, int(s), t_total)
                if afsk:
                    bits, soft = 1 - bits, None  # sym 0 = 1200 Hz = bit 1
                f_resid = None
                if not afsk and fcnt[e, s] >= 1.0:
                    f_resid = float(np.clip(fres[e, s], -2500.0, 2500.0))
                try:
                    out.extend(self._decode_frames(
                        fz, name, bits, soft, float(ebno[e, s]), det,
                        f_resid=f_resid,
                        f_demod=self._f_demod_of(
                            ci, fz, ext=ext_cid.get(cid, 0.0))))
                except Exception:
                    log.exception("decode failed on %.3f MHz (%s)",
                                  fz / 1e6, name)
        return out

    @staticmethod
    def group_tasks_by_type(tasks, n_rows: int) -> dict:
        """Group (row, type, det) tasks into per-type row lists, types
        sorted by name and rows ascending (the slot order of the
        reference's ``parallel/routing.compact_by_type``).  ``n_rows``:
        the channel rows plus any appended past them."""
        groups = {}
        for ci, name, det in sorted(tasks, key=lambda t: t[0]):
            if not 0 <= ci < n_rows:
                raise ValueError(f"task row {ci} outside {n_rows} rows")
            groups.setdefault(name, []).append((int(ci), det))
        return {name: groups[name] for name in sorted(groups)}

    # ------------------------------------------------------------------ #
    # web-control hooks (reference web.py control endpoints :445-661)

    def start_manual_decoder(self, freq_hz: float, sonde_type: str):
        if sonde_type not in CHAIN_TABLE:
            raise ValueError(f"unknown sonde type {sonde_type!r}")
        fz = int(round(freq_hz))
        self.manual_tasks[fz] = sonde_type
        return fz

    def stop_decoder(self, freq_hz: float, lockout_minutes: float = 0):
        """Stop any decoder on this frequency; optional temporary block."""
        q = self.config["quantization"]
        for fz in list(self.manual_tasks):
            if abs(fz - freq_hz) <= q:
                del self.manual_tasks[fz]
        for fz in list(self.active):
            if abs(fz - freq_hz) <= q:
                del self.active[fz]
                self.frame_plane.drop(fz)
        fz = int(round(freq_hz))
        if lockout_minutes > 0:
            self.temporary_blocks[fz] = time.time() + lockout_minutes * 60
        return fz

    def decode_channel(self, iq_ch, ci: int, name: str, det=None) -> list:
        """Demod + decode one channel (planes [2, T] or complex [T] at
        the profile's channel rate) known to carry type ``name``, keyed
        at channel ``ci``'s center."""
        self._offsets = {}           # manual API: channel-center task
        self._ext_off = {}
        self._cur_wide = None        # no wideband block to extract from
        return self.decode_channels(self._wide_planes(iq_ch)[None],
                                    [(0, det)], name, chan_map={0: ci})

    def decode_channels(self, ch, items, name: str, chan_map=None,
                        wide_ready: bool = False) -> list:
        """Batched demod + per-channel decode for one sonde type (the
        split path a speculation miss takes, and the single-channel
        paths).  ch: [N, 2, T] channel planes on the device; items:
        [(channel_index, det)]; ``chan_map``: item index -> the row the
        task lives on (``ch`` then holds exactly the items' rows);
        ``wide_ready``: ``ch`` is already extracted at the chain's
        ``wide_fs``."""
        chain = CHAIN_TABLE[name]
        fs = self.fs_ch
        wide_mode = chain.get("wide_fs", 0) > fs
        if wide_mode and wide_ready:
            iq = ch
            fs = int(chain["wide_fs"])
        elif wide_mode:
            # a wideband chain on a narrow station: extract the wide
            # channel around each task frequency from the retained
            # wideband block
            wfs = int(chain["wide_fs"])
            if self._cur_wide is None or self.fs_wide % wfs != 0:
                log.warning(
                    "%s needs a %d Hz channel (station capture %d Hz "
                    "%s) — use a capture rate divisible by %d",
                    name, wfs, self.fs_wide,
                    "not retained" if self._cur_wide is None
                    else "not divisible", wfs)
                return []
            n_dec = self.fs_wide // wfs
            f_rel = [self.freq_of_channel(chan_map[ci] if chan_map
                                          else ci) - self.center_freq
                     for ci, _ in items]
            iq = extract_channels(self._cur_wide, self.fs_wide, f_rel,
                                  n_dec, self.device, self._wide_taps(n_dec))
            fs = wfs
        elif chan_map is None:
            iq = ch.index_select(0, torch.tensor([ci for ci, _ in items],
                                                 device=ch.device))
        else:
            iq = ch
        cfg, rs_to, afsk = demod_chain(name, fs)
        if rs_to:
            iq = resample_planes(iq, fs, rs_to)
        if afsk:
            # IF lowpass -> FM discriminate -> audio lowpass (imet4iq's
            # front end), then FSK-demod the Bell-202 audio tones
            audio = afsk_fm_audio(iq, fs)
            planes = torch.stack([audio, torch.zeros_like(audio)], dim=1)
            _, bits_b, stats, _ = fsk_demod_stream(cfg, planes, self.device)
            bits_b = 1 - _np(bits_b)     # sym 0 = 1200 Hz = bit 1
            soft_b = None
        else:
            soft_b, bits_b, stats, _ = fsk_demod_stream(cfg, iq,
                                                        self.device)
            bits_b, soft_b = _np(bits_b), _np(soft_b)
        stats = {k: _np(v) for k, v in stats.items()}
        probe.count("decode_rows", len(items), self.stats)
        out = []
        ebno = np.atleast_2d(stats["ebno_db"]) if "ebno_db" in stats \
            else None
        resid = self._freq_residuals(stats, chain, len(items))
        if self.frame_plane.workers > 0:
            return self._decode_frames_pooled(items, name, bits_b, soft_b,
                                              ebno, chan_map, resid,
                                              wide_mode)
        for j, (ci, det) in enumerate(items):
            real_ci = chan_map[ci] if chan_map else ci
            fz = self.freq_of_channel(real_ci)
            try:
                out.extend(self._decode_frames(
                    fz, name, bits_b[j],
                    None if soft_b is None else soft_b[j],
                    None if ebno is None else float(ebno[j].max()), det,
                    f_resid=resid[j] if resid is not None else None,
                    f_demod=self._f_demod_of(real_ci, fz, wide_mode)))
            except Exception:
                # one bad channel/decoder must not kill the capture loop
                log.exception("decode failed on %.3f MHz (%s)",
                              fz / 1e6, name)
        return out

    def _f_demod_of(self, real_ci: int, fz: int, wide_mode: bool = False,
                    ext=None) -> float:
        """Absolute frequency row ``real_ci`` was DEMODULATED at (the
        drift-retune anchor, so every decode path goes through here): the
        task frequency for a wide extraction, the recorded extraction
        frequency for a row beyond the PFB grid, else the channel center
        plus the row's actual extraction offset (0 for plain PFB rows).
        ``ext`` overrides the offset lookup for callers that track
        offsets in cid-space."""
        if wide_mode:
            return float(fz)
        if real_ci >= self.profile().n_chan:
            # a virtual row records its absolute extraction frequency; fz
            # may since have moved by a detector refinement it never saw
            base = self._ext_off.get(real_ci)
            return float(fz) if base is None else float(base)
        if ext is None:
            ext = self._ext_off.get(real_ci, 0.0)
        return self._chan_center(real_ci) + float(ext)

    @staticmethod
    def _freq_residuals(stats, chain, n_items):
        """Per-channel carrier-offset residual (Hz) from the demod's
        tone-frequency estimates (NaN = no locked block): the drift
        signal ``_post_frames`` applies after a successful decode."""
        if chain.get("afsk") or "f_est" not in stats:
            return None
        fe = np.asarray(stats["f_est"], np.float32)  # [C, nb, M]
        eb = np.atleast_2d(np.asarray(stats["ebno_db"], np.float32))
        if fe.ndim == 2:
            fe = fe[None]
        cen = fe.mean(axis=2, dtype=np.float32)      # [C, nb]
        resid = np.full(n_items, np.nan)
        for j in range(min(n_items, cen.shape[0])):
            # locked blocks: within 10 dB of the best block, > 3 dB
            good = eb[j] > max(3.0, float(eb[j].max()) - 10.0)
            if good.any():
                resid[j] = float(np.clip(
                    np.float32(cen[j] * good).sum() /
                    max(float(good.sum()), 1.0), -2500.0, 2500.0))
        return resid

    def _decode_frames_pooled(self, items, name, bits_b, soft_b, ebno,
                              chan_map, resid=None,
                              wide_mode=False) -> list:
        """Fan this type's channels out to the frame-plane workers, then
        run the tail (``_pooled_tail``)."""
        model_name = MODEL_NAME.get(name, name)
        meta = {}
        for j, (ci, det) in enumerate(items):
            real_ci = chan_map[ci] if chan_map else ci
            fz = self.freq_of_channel(real_ci)
            soft = None if soft_b is None else -soft_b[j]
            ticket = self.frame_plane.decode(
                fz, model_name, self._decoder_kwargs(name, model_name),
                bits_b[j], soft)
            meta[ticket] = (name, fz,
                            None if ebno is None else float(ebno[j].max()),
                            det, resid[j] if resid is not None else None,
                            self._f_demod_of(real_ci, fz, wide_mode),
                            self.center_freq)
        return self._pooled_tail(meta)

    def _pooled_tail(self, meta) -> list:
        """Gather the frame-plane workers' results and run the light
        main-process tail (enrich/filter/export) in ticket order, so the
        output order matches the inline path.  ``meta`` maps a ticket to
        ``(name, fz, snr_db, det, f_resid, f_demod, center)``, ``center``
        that of the capture the row was demodulated in."""
        results = self.frame_plane.gather()
        if self.frame_plane.workers > 0:
            # decodes and tasks a worker and the tasks moved between
            # workers: the pool's balance, for the operator
            self.stats["pool_decodes"] = list(self.frame_plane.decodes)
            self.stats["pool_tasks"] = self.frame_plane.tasks()
            self.stats["pool_moves"] = self.frame_plane.moves
        out = []
        for ticket in sorted(meta):
            name, fz, snr_db, det, f_resid, f_demod, center = meta[ticket]
            state = self.active.get(fz)
            if state is None or state["type"] != name:
                # a fresh task starts its rx_timeout clock now: a type
                # that needs several blocks to confirm a serial (DFM)
                # must not be reaped before its first accepted frame
                state = dict(type=name, decoder=None,
                             last_ok=time.time())
                self.active[fz] = state
            state["center"] = center     # the task's owner (``_owner``)
            try:
                out.extend(self._post_frames(fz, state,
                                             results.get(ticket, []),
                                             snr_db, det, f_resid,
                                             f_demod))
            except Exception:
                # one bad telemetry dict must not kill the capture loop
                log.exception("telemetry tail failed on %.3f MHz (%s)",
                              fz / 1e6, name)
        return out

    def _decoder_kwargs(self, name, model_name) -> dict:
        """Constructor args for a type's frame decoder."""
        kwargs = {}
        if name == "RS92NGP":
            # 1680 MHz RS92-NGP: scrambled cal/PTU + frequency table
            # offset (reference rs92mod.c --ngp :1803)
            kwargs["ngp"] = True
        if model_name == "RS92":
            # RS92 needs GPS ephemeris for its raw-pseudorange nav
            eph = self.config.get("rs92_ephemeris")
            if eph is None:
                eph = gps_ephem.get_ephemeris()
                self.config["rs92_ephemeris"] = eph
            if eph:
                kwargs["ephemeris"] = eph
        return kwargs

    def _decode_frames(self, fz, name, bits, soft, snr_db, det,
                       f_resid=None, f_demod=None) -> list:
        """Host frame plane for one channel (task-keyed by absolute
        frequency ``fz``): decoder state, frame decode,
        enrich/filter/export."""
        model_name = MODEL_NAME.get(name, name)
        state = self.active.get(fz)
        if state is None or state["type"] != name or \
                state.get("decoder") is None:
            decoder_cls = get_model(model_name)
            prev_ok = state["last_ok"] if state is not None and \
                state.get("type") == name else time.time()
            state = dict(
                type=name,
                decoder=decoder_cls(**self._decoder_kwargs(name,
                                                           model_name)),
                last_ok=prev_ok)
            self.active[fz] = state
        state["center"] = self.center_freq   # the task's owner (``_owner``)
        with probe.span("frame_plane.decode", worker=None,
                        model=model_name) as sp:
            raw_telems = state["decoder"].decode_bits(
                bits, None if soft is None else -soft)
            sp.set(frames=len(raw_telems))
        return self._post_frames(fz, state, raw_telems, snr_db, det,
                                 f_resid, f_demod)

    def _post_frames(self, fz, state, raw_telems, snr_db, det,
                     f_resid=None, f_demod=None) -> list:
        """Telemetry tail: enrich, filter, export, task bookkeeping, and
        the drift follow (anchored to the demod center ``f_demod``)."""
        freq_hz = float(fz)
        out = []
        for t in raw_telems:
            t = enrich_telemetry(
                t, freq_hz=freq_hz, snr=snr_db,
                f_error=det.freq_offset if det else None,
                station_code=self.config["station_code"])
            if t.get("encrypted") and self.config["close_on_encrypted"]:
                self._drop_channel(fz, encrypted=True)
                break
            verdict = telemetry_filter(t, self.config)
            if verdict == "TempBlock":
                self._drop_channel(fz)
                break
            if verdict is not True and verdict != "OK":
                self.stats["frames_filtered"] += 1
                continue
            if self.config["enable_realtime_filter"] and \
                    not self.rt_filter.check(t):
                self.stats["frames_filtered"] += 1
                continue
            state["last_ok"] = time.time()
            self.stats["frames_ok"] += 1
            out.append(t)
            for exporter in self.exporters:
                try:
                    exporter.add(t)
                except Exception:
                    log.exception("exporter error")
        if out and f_resid is not None and np.isfinite(f_resid):
            anchor = fz if f_demod is None else f_demod
            target = round(anchor + f_resid, -2)
            if abs(target - fz) >= DRIFT_MIN_HZ:
                if self._defer_retunes is not None:
                    # a scan-peak (absorb) target wins over a resid one
                    if fz not in self._defer_scan:
                        self._defer_retunes[fz] = target
                else:
                    self._retune(fz, target)
        return out

    def _drop_channel(self, fz, encrypted=False):
        self.active.pop(fz, None)
        self.frame_plane.drop(fz)
        self.temporary_blocks[fz] = time.time() + \
            self.config["temporary_block_time"] * 60
        if encrypted:
            log.warning("Encrypted sonde on %.3f MHz — blocked", fz / 1e6)

    def clean_task_list(self):
        """Reap idle decoders (reference auto_rx.py clean_task_list)."""
        now = time.time()
        for fz in list(self.active):
            if now - self.active[fz]["last_ok"] > self.config["rx_timeout"]:
                self.active.pop(fz)
                self.frame_plane.drop(fz)

    def close(self):
        self.frame_plane.close()
        for e in self.exporters:
            try:
                e.close()
            except Exception:
                log.exception("exporter close failed")
