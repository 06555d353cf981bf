"""The station's per-block device dataflow, sharded over a (ch, t) mesh.

Port of ``radiosonde_auto_rx_tpu/parallel/station_step.py::
ShardedStationStep``:

    wideband captures [B, 2, T]
      -> PFB channelize        (halo'd overlap-save over ``t``)
      -> Welch PSD             (per-shard partial sums, psum over ``t``)
      -> detect scores         (half-rate prescreen bank, pmax over ``t``)
      -> expert routing        (capacity-padded ``all_to_all`` over ``ch``)
      -> per-type FSK demod    (each shard demods its experts' channels)

``analyze`` is data-independent; between it and ``route_demod`` the
host applies its task state (scan peaks, the full-rate ``confirm`` and
``decide_confirmed``, manual tasks, active decoders) to turn scores into
the expert assignment, where the reference's scan-results loop sits.

Each sharded body is a host loop over this process's shards, split at
its collectives (``parallel/collectives.py``); the host knows each
shard's index, so the expert a shard runs is plain Python where the
reference switches on ``axis_index``.  Sharded inputs and outputs are
dicts of local shards (``parallel/mesh.py``); a global tensor given is
split first.  On a 1x1 mesh (the default, on ``device``) ``analyze``
and ``confirm`` are the single-device bodies and return plain tensors,
and the fused ``steady_step`` (analyze + recentered extraction of
off-grid task rows + per-type demod of the active channels) is the
station's block.

Expert set: every chain that demodulates on a 48 kHz channel — 12
experts, the fractional-resample chains (DFM 50 kHz, M10 48.08 kHz)
and the iMet AFSK chain included — padded to a multiple of the ``ch``
size (pad experts are never routed).  The host knows from the
assignment which slots are live, so an expert demodulates only its live
slots, and an expert with none (a pad expert included) skips its demod:
every other slot emits zeros, masked, and the host reads only masked
slots.  ``confirm`` likewise conditions only the real candidates.  The
wideband chains keep the station's host-batched ``decode_channels``
path.
"""

import numpy as np
import torch
import torch.nn.functional as F

from radiosonde_auto_rx_tpu_torch.demod.fsk import (
    fsk_demod_stream, fsk_init_state, fsk_num_blocks_buffered)
from radiosonde_auto_rx_tpu_torch.detect.correlator import (
    _correlate_peaks, decide_from_peaks)
from radiosonde_auto_rx_tpu_torch.detect.psd import _welch
from radiosonde_auto_rx_tpu_torch.detect.prescreen import Prescreen
from radiosonde_auto_rx_tpu_torch.detect.scanner import (
    LPFM_BW, LPIQ_BW, SondeDetector)
from radiosonde_auto_rx_tpu_torch.detect.templates import TEMPLATES
from radiosonde_auto_rx_tpu_torch.models.imet4 import afsk_fm_audio
from radiosonde_auto_rx_tpu_torch.ops.channelizer import (
    _branch_dtype, _channelize, _extract, pfb_prototype)
from radiosonde_auto_rx_tpu_torch.ops.fm import FM_GAIN
from radiosonde_auto_rx_tpu_torch.ops.resample import (
    rational_ratio, resample_planes)
from radiosonde_auto_rx_tpu_torch.parallel.collectives import (
    pmax, psum, transfer)
from radiosonde_auto_rx_tpu_torch.parallel.halo import halo_exchange_left
from radiosonde_auto_rx_tpu_torch.parallel.mesh import (
    CH_AXIS, T_AXIS, make_mesh, shard, to_device, unshard)
from radiosonde_auto_rx_tpu_torch.parallel.pipeline import scan
from radiosonde_auto_rx_tpu_torch.parallel.routing import (
    dispatch_to_experts)
from radiosonde_auto_rx_tpu_torch.station.chains import (
    CHAIN_TABLE, demod_chain)

STREAM = (CH_AXIS, None, T_AXIS)        # channels [C, 2, Tc]
ROWS = (CH_AXIS, None)                  # psd, ratios, per-slot stats
ROUTED = (CH_AXIS, None, T_AXIS)        # route_demod soft/bits

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
    """Channelize + PSD + steady demod + candidate confirmation + expert
    routing for one channel geometry on ``mesh`` (default: a 1x1 mesh on
    ``device``)."""

    def __init__(self, device=None, n_chan: int = 50, fs_ch: int = 48000,
                 nfft: int = 2048, conf_capacity: int = 2, *, mesh=None,
                 capacity: int = 4, frame_halo: int = 26400):
        if mesh is None:
            if device is None:
                raise ValueError("StationStep needs a device or a mesh")
            mesh = make_mesh(1, 1, devices=[device])
        self.mesh = mesh
        self.device = torch.device(device) if mesh.size == 1 and \
            device is not None else mesh.device(mesh.local[0])
        self.n_chan = int(n_chan)
        self.fs_ch = int(fs_ch)
        self.nfft = int(nfft)
        self.conf_cap = int(conf_capacity)
        self.capacity = int(capacity)
        self.n_sh = mesh.shape[CH_AXIS]
        self.n_t = mesh.shape[T_AXIS]
        # pad the expert axis up to a multiple of the ch mesh size; pad
        # experts are never routed and emit zeros
        self.n_exp = len(EXPERT_TYPES)
        self.n_exp_pad = -(-self.n_exp // self.n_sh) * self.n_sh
        self.e_local = self.n_exp_pad // self.n_sh
        self._kits = {}
        self.taps, self.prescreen, self.detector = self._kit(self.device)
        self.pfb_p = int(self.taps.shape[0]) // self.n_chan
        # template index (prescreen.spec_order) -> expert index or -1
        self.template_expert = np.array(
            [EXPERT_TYPES.index(TEMPLATE_TO_EXPERT[s.name])
             if s.name in TEMPLATE_TO_EXPERT else -1
             for s in self.prescreen.spec_order], np.int32)
        self._chain_cache = {}
        self.expert_cfgs = []
        self.expert_chain = []        # per expert (resample_to, afsk)
        halos = []
        for name in EXPERT_TYPES:
            cfg, rs_to, afsk = demod_chain(name, self.fs_ch)
            self.expert_cfgs.append(cfg)
            self.expert_chain.append((rs_to, afsk))
            # per-expert demod warmup in CHANNEL samples: nmem + scan
            # slack at the effective rate, mapped back through the
            # resampler (plus its taps-long transient) / AFSK FIRs
            h = cfg.nmem + 8 * cfg.ts
            if rs_to:
                l_up, m_down = rational_ratio(self.fs_ch, rs_to)
                h = -(-h * m_down // l_up) + 16
            if afsk:
                h += 2 * 97           # IF + audio lowpass transients
            halos.append(h)
        # demod halo = scan warmup plus a frame-length margin: a frame
        # straddling a t-seam is fully demodulated by the shard owning
        # its tail (frames longer than ``frame_halo`` samples lose seam
        # crossings, the loss the reference takes at any decoder
        # restart).  Each t-shard must hold >= halo_max samples.  With a
        # single t-shard there are no seams and no halo.
        self.halo_max = (max(halos) + int(frame_halo)) if self.n_t > 1 \
            else 0
        # detection halo: longest full-rate template + both FIR stages
        lmax = max(int(self.fs_ch / s.sps * len(s.header))
                   for s in self.prescreen.spec_order)
        self.det_halo = lmax + 4 * 97

    def _kit(self, dev):
        """(PFB taps, prescreen, detector) on device ``dev``, built once:
        each device of the mesh holds its own."""
        dev = torch.device(dev)
        if dev not in self._kits:
            self._kits[dev] = (
                torch.from_numpy(pfb_prototype(self.n_chan)).to(dev),
                Prescreen(self.fs_ch, TEMPLATES, LPIQ_BW, LPFM_BW,
                          device=dev),
                # full-rate confirmation machinery; its own prescreen is
                # off (analyze screens, and the station confirms scan
                # candidates exactly)
                SondeDetector(self.fs_ch, prescreen=False, device=dev))
        return self._kits[dev]

    def _on(self, c):
        return self._kit(self.mesh.device(c))

    def _channels(self, wide):
        """Channel rows [B*N, 2, T//N] of ``wide`` in the branch dtype
        (``wide`` already cast to it)."""
        B, _, T = wide.shape
        if T % self.n_chan:
            raise ValueError("capture length must be a multiple of n_chan")
        ch = _channelize(wide, self.taps, self.n_chan)        # [B, N, 2, M]
        return ch.reshape(B * self.n_chan, 2, T // self.n_chan)

    def _bits_len(self, t_local: int):
        """Per-expert (soft/bits length, n_blocks) for a t-shard of
        ``t_local`` channel samples.  Resampled experts count blocks at
        their effective rate."""
        out = []
        for cfg, (rs_to, _) in zip(self.expert_cfgs, self.expert_chain):
            t_eff = t_local + self.halo_max
            if rs_to:
                l_up, m_down = rational_ratio(self.fs_ch, rs_to)
                t_eff = (t_eff - 16) * l_up // m_down
            nb = fsk_num_blocks_buffered(cfg, t_eff)
            out.append((nb * cfg.nsym * cfg.bits_per_symbol, nb))
        return out

    # ------------------------------------------------------------------ #

    def analyze(self, wide, screen: bool = True):
        """wide [B, 2, T] f32 planes -> (channels [B*N, 2, T//N] in the
        branch dtype (``RSX_CHANNELIZER_DTYPE``: the block is cast to it
        once, for the channelizer and the PSD, whose K2 launch reads a
        float32 copy of a bfloat16 block),
        psd [B, nfft] (sparse Welch, one nfft window per 4*nfft),
        ratios).  ``screen=True`` also runs the half-rate prescreen over
        every DC-blocked channel: ratios [B*N, K_total] in
        ``prescreen.spec_order``; else None.  The station's steady path
        passes ``screen=False``: its candidates come from the PSD scan
        and go straight to the exact ``confirm``.

        On a mesh of several shards ``wide`` is a tensor or a dict of
        local shards (STREAM), and the results are dicts of local shards:
        channels (STREAM), psd and ratios (ROWS)."""
        if self.mesh.size > 1:
            return self._analyze_sharded(wide, screen)
        wide = wide.to(_branch_dtype())
        chf = self._channels(wide)
        psd = _welch(wide, self.nfft, hop=4 * self.nfft)
        if not screen:
            return chf, psd, None
        dc = torch.mean(chf, dim=-1, keepdim=True) * 0.98
        return chf, psd, self.prescreen.template_ratios(chf - dc)

    def _analyze_sharded(self, wide, screen: bool):
        mesh, N, Pp, n_t = self.mesh, self.n_chan, self.pfb_p, self.n_t
        wl = wide if isinstance(wide, dict) else shard(wide, mesh, STREAM)
        bdt = _branch_dtype()
        wl = {c: w.to(bdt) for c, w in wl.items()}
        if any(w.shape[-1] % N for w in wl.values()):
            raise ValueError("t-shard must be a multiple of n_chan")
        if n_t == 1:
            # no t-seams: _channelize's own zero history is the halo
            ch = {c: _channelize(w, self._on(c)[0], N)
                  for c, w in wl.items()}
        else:
            # channelize with a (P-1)*N left halo: output columns equal
            # the unsharded _channelize of the full stream's (shard 0's
            # zero halo is the unsharded zero history)
            wx = halo_exchange_left(
                {c: w.reshape(-1, w.shape[-1]) for c, w in wl.items()},
                mesh, (Pp - 1) * N, T_AXIS)
            ch = {c: _channelize(v.reshape(wl[c].shape[0], 2, -1),
                                 self._on(c)[0], N)[..., Pp - 1:]
                  for c, v in wx.items()}
        chf = {c: v.reshape(-1, 2, v.shape[-1]) for c, v in ch.items()}
        # Welch PSD: local segment sums, summed over t
        psd = {c: _welch(w, self.nfft, hop=4 * self.nfft)
               for c, w in wl.items()}
        if n_t > 1:
            psd = {c: v / n_t for c, v in psum(psd, mesh, T_AXIS).items()}
        if not screen:
            return chf, psd, None
        # detection scores on every channel; a template-length halo so
        # headers straddling a t-seam are still seen; max over t shards
        x = {c: v - torch.mean(v, dim=-1, keepdim=True) * 0.98
             for c, v in chf.items()}
        if n_t > 1:
            x = halo_exchange_left(
                {c: v.reshape(-1, v.shape[-1]) for c, v in x.items()},
                mesh, self.det_halo, T_AXIS)
            x = {c: v.reshape(-1, 2, v.shape[-1]) for c, v in x.items()}
        ratios = {c: self._on(c)[1].template_ratios(v) for c, v in x.items()}
        if n_t > 1:
            ratios = pmax(ratios, mesh, T_AXIS)
        return chf, psd, ratios

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
            chf, psd = self._channels(wide.to(_branch_dtype())), None
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
                rows[keep].astype(np.int64)).to(dev), ext.to(chf.dtype))
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
        return self.n_sh * self.conf_cap

    def confirm(self, channels, slot_cids):
        """Full-rate confirmation pass on candidate channels.

        channels: [C, 2, Tc]; slot_cids: global channel ids of the
        candidates.  On a 1x1 mesh only real candidates go in (the
        reference pads the slots for its compile cache).  The DC block,
        the detector's conditioning and, per bandwidth class, the exact
        peak search.  Returns dict(streams [n_classes, S, Tc], peaks
        [(val, ipk, dc, xm) per class, each [S, K_cls] ([S] for xm)]) for
        the host decision loop (``decide_confirmed``).

        On a mesh of several shards, slot_cids holds ``n_conf_slots``
        ids (-1 pad) and channels is sharded (STREAM): ch-shard ``i``
        confirms slots ``[i*conf_cap, (i+1)*conf_cap)``, each stream
        assembled from its owner's t pieces (the reference's psum over
        ``ch`` adds one non-zero term per slot and all-gathers over
        ``t``; a copy from the owner gives the same bits).  The results
        are dicts of local shards: streams (None, ch, None), val/ipk/dc
        ROWS, xm (ch,)."""
        if self.mesh.size > 1:
            return self._confirm_sharded(channels, slot_cids)
        return self._confirm_rows(self.detector, channels.index_select(
            0, torch.from_numpy(np.asarray(slot_cids, np.int64)).to(
                channels.device)))

    @staticmethod
    def _confirm_rows(det, mine):
        # same DC block as SondeDetector.detect's entry
        mine = mine - torch.mean(mine, dim=-1, keepdim=True) * 0.98
        streams = det._condition(mine)                # per class [S, T]
        peaks = [_correlate_peaks(fm, bank, lens)
                 for fm, (_, _, _, bank, lens) in zip(streams, det.classes)]
        return dict(streams=torch.stack([s.float() for s in streams]),
                    peaks=peaks)

    def _confirm_sharded(self, channels, slot_cids):
        mesh, cap, n_t = self.mesh, self.conf_cap, self.n_t
        if not isinstance(channels, dict):
            channels = shard(channels, mesh, STREAM)
        sc = np.asarray(slot_cids, np.int64)
        if sc.shape != (self.n_conf_slots,):
            raise ValueError(f"confirm takes {self.n_conf_slots} slots")
        like = next(iter(channels.values()))
        C_l = like.shape[0]
        msgs = []
        for c in mesh.coords:
            for k in range(cap):
                cid = int(sc[c[0] * cap + k])
                if cid < 0:
                    continue
                own, row = divmod(cid, C_l)
                for t in range(n_t):
                    msgs.append(((c, k, t), (own, t), c,
                                 lambda own=own, t=t, row=row:
                                 channels[(own, t)][row]))
        got = transfer(mesh, msgs, like[0])
        classes = self.detector.classes
        streams, peaks = {}, [tuple({} for _ in range(4)) for _ in classes]
        for c, x in channels.items():
            # only the real slots are conditioned; a pad slot's outputs
            # are zeros (the host reads real slots only)
            real = [k for k in range(cap) if (c, k, 0) in got]
            f32 = dict(dtype=torch.float32, device=x.device)
            streams[c] = torch.zeros((len(classes), cap, x.shape[-1] * n_t),
                                     **f32)
            res = self._confirm_rows(self._on(c)[2], torch.stack(
                [torch.cat([got[(c, k, t)] for t in range(n_t)], dim=-1)
                 for k in real])) if real else None
            idx = to_device(np.asarray(real, np.int64), x.device)
            if res is not None:
                streams[c][:, idx] = res["streams"].to(torch.float32)
            for i, (_, _, _, _, lens) in enumerate(classes):
                K = len(lens)
                for j, shape in enumerate(((cap, K),) * 3 + ((cap,),)):
                    v = torch.zeros(shape, dtype=torch.int32 if j == 1
                                    else torch.float32, device=x.device)
                    if res is not None:
                        v[idx] = res["peaks"][i][j].to(v.dtype)
                    peaks[i][j][c] = v
        return dict(streams=streams, peaks=peaks)

    def _gather_confirmed(self, conf):
        """A sharded ``confirm`` result assembled as the 1x1 mesh's."""
        if not isinstance(conf["streams"], dict):
            return conf
        m = self.mesh
        return dict(streams=unshard(conf["streams"], m, (None, CH_AXIS)),
                    peaks=[tuple(unshard(p, m, ROWS if j < 3 else (CH_AXIS,))
                                 for j, p in enumerate(pk))
                           for pk in conf["peaks"]])

    def decide_confirmed(self, conf, slot_cids, max_det: int = 1):
        """Host decision loop over ``confirm`` outputs: the logic of
        ``SondeDetector._detect_full`` (threshold, headcmp, M10/M20 +
        iMet disambiguation, score sort).

        Returns {global channel id: [Detection, ...]} for real slots."""
        det = self.detector
        conf = self._gather_confirmed(conf)
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
            cid = int(slot_cids[s])
            if cid < 0:
                continue
            merged[s].sort(key=lambda d: d.score, reverse=True)
            out[cid] = merged[s][:max_det] if max_det else merged[s]
        return out

    # ------------------------------------------------------------------ #

    def route_demod(self, channels, expert_ids):
        """All-to-all expert routing + per-type demod over the mesh.

        channels: [C, 2, Tc] tensor or dict of local shards (STREAM);
        expert_ids: [C] host ints (-1 = not routed), the host policy's
        assignment, known to every process.  Returns a dict of local
        shards per field: soft/bits [E_l, S, n_t-shard out_max] (ROUTED;
        bits uint8), ebno/fres/fcnt/ids/mask [E_l, S] (ROWS), dropped [1]
        (ch,), with E_l = ``e_local`` experts a shard, S = n_sh *
        capacity slots; ``gather_routed`` assembles it."""
        mesh, cap = self.mesh, self.capacity
        if not isinstance(channels, dict):
            channels = shard(channels, mesh, STREAM)
        exp = np.asarray(expert_ids, np.int64)
        like = next(iter(channels.values()))
        C_l, T_l = like.shape[0], like.shape[-1]
        if T_l < self.halo_max:
            raise ValueError(
                f"t-shard holds {T_l} channel samples < demod halo "
                f"{self.halo_max}; use fewer/longer time shards or a "
                f"smaller frame_halo")
        lens = self._bits_len(T_l)
        out_max = max(v for v, _ in lens)
        S_tot = self.n_sh * cap
        el = shard(torch.from_numpy(exp), mesh, (CH_AXIS,))
        cid = {c: torch.arange(c[0] * C_l, (c[0] + 1) * C_l,
                               device=mesh.device(c)) for c in mesh.local}
        disp = dispatch_to_experts(channels, el, mesh, self.n_exp_pad, cap,
                                   channel_ids=cid)
        recv = {c: d[0] for c, d in disp.items()}
        # the demod halo: one exchange outside the expert loop; none on a
        # single t-shard (halo_max == 0)
        if self.halo_max:
            flat = halo_exchange_left(
                {c: r.reshape(-1, T_l) for c, r in recv.items()}, mesh,
                self.halo_max, T_AXIS)
            recv = {c: f.reshape(self.e_local, S_tot, 2, -1)
                    for c, f in flat.items()}
        # each expert's live slots, known to the host from the
        # assignment: source shard s's channels of the expert land at
        # slots s*capacity + [0, its count)
        live = {}
        for e in {int(e) for e in exp[exp >= 0]}:
            live[e] = [s * cap + r for s in range(self.n_sh) for r in range(
                min(cap, int((exp[s * C_l:(s + 1) * C_l] == e).sum())))]
        soft, bits, ebno, fsum, fcnt = {}, {}, {}, {}, {}
        for c, xh in recv.items():
            parts = [self._expert_demod(c[0] * self.e_local + slot,
                                        xh[slot], lens, out_max,
                                        live.get(c[0] * self.e_local + slot))
                     for slot in range(self.e_local)]
            soft[c], bits[c], ebno[c], fsum[c], fcnt[c] = (
                torch.stack(p) for p in zip(*parts))
        # best block Eb/N0 across the time shards; residuals: a
        # locked-count-weighted mean across them (a shard with no locked
        # block contributes nothing)
        if self.n_t > 1:
            ebno = pmax(ebno, mesh, T_AXIS)
            fsum = psum(fsum, mesh, T_AXIS)
            fcnt = psum(fcnt, mesh, T_AXIS)
        fres = {c: fsum[c] / torch.clamp(fcnt[c], min=1.0) for c in fsum}
        return dict(soft=soft, bits=bits, ebno=ebno, fres=fres, fcnt=fcnt,
                    ids={c: d[2] for c, d in disp.items()},
                    mask={c: d[1] for c, d in disp.items()},
                    dropped={c: d[3] for c, d in disp.items()})

    def _expert_demod(self, e: int, xe, lens, out_max: int, live):
        """Expert ``e``'s demod of its live slots (``live``, indices into
        xe [S, 2, T]): (soft [S, out_max], bits uint8, ebno [S], fsum
        [S], fcnt [S]), zeros in every other slot; all zeros for a pad
        expert, one with no routed channel, or too short a shard."""
        S, dev = xe.shape[0], xe.device
        z = torch.zeros((S, out_max), dtype=torch.float32, device=dev)
        zs = torch.zeros((S,), dtype=torch.float32, device=dev)
        if e >= self.n_exp or not live or lens[e][1] == 0:
            return z, z.to(torch.uint8), zs, zs, zs
        idx = to_device(np.asarray(live, np.int64), dev)
        xe = xe.index_select(0, idx)
        cfg, nb = self.expert_cfgs[e], lens[e][1]
        rs_to, afsk = self.expert_chain[e]
        if rs_to:
            xe = resample_planes(xe, self.fs_ch, rs_to)
        if afsk:
            # Bell-202: IF lowpass -> FM discriminator -> audio lowpass,
            # then FSK on the tones
            audio = afsk_fm_audio(xe, self.fs_ch)
            xe = torch.stack([audio, torch.zeros_like(audio)], dim=1)
        _, outs = scan(cfg, xe.float().contiguous(),
                       fsk_init_state(cfg, len(live), dev), nb)
        eb = outs["ebno_db"]                                  # [S, nb]
        ebno = eb.max(dim=1).values
        if afsk:
            fsum = fcnt = torch.zeros_like(ebno)
        else:
            # carrier-offset residual: tone-mean of the demod's f_est
            # over locked blocks (within 10 dB of the slot's best block
            # and above 3 dB)
            fe = outs["f_est"].mean(dim=-1)                   # [S, nb]
            thr = torch.clamp(ebno - 10.0, min=3.0)
            good = (eb > thr[:, None]).to(torch.float32)
            fsum, fcnt = (fe * good).sum(dim=1), good.sum(dim=1)
        n = outs["soft"].shape[1]
        return (z.index_copy(0, idx, F.pad(outs["soft"], (0, out_max - n))),
                z.to(torch.uint8).index_copy(
                    0, idx, F.pad(outs["bits"], (0, out_max - n))),
                zs.index_copy(0, idx, ebno), zs.index_copy(0, idx, fsum),
                zs.index_copy(0, idx, fcnt))

    def gather_routed(self, res):
        """A ``route_demod`` result assembled (every shard in this
        process) with the pad experts dropped: soft/bits [E, S, n_t *
        out_max], ebno/fres/fcnt/ids/mask [E, S], dropped [n_sh]."""
        m = self.mesh
        out = {k: unshard(v, m, ROUTED if k in ("soft", "bits") else ROWS)
               [:self.n_exp] for k, v in res.items() if k != "dropped"}
        out["dropped"] = unshard(res["dropped"], m, (CH_AXIS,))
        return out

    def bits_lens(self, t_total: int):
        """Per-expert valid soft/bits length for a GLOBAL channel-sample
        count ``t_total`` (the outputs concatenate ``n_t`` t-shards of
        padded slices; each shard's valid prefix is
        ``_bits_len(t_total // n_t)``)."""
        return self._bits_len(t_total // self.n_t)

    def slot_bits(self, res, expert: int, slot: int, t_total: int):
        """One routed slot's (bits, soft) from a ``gather_routed`` result,
        each t-shard's valid prefix concatenated: bits uint8, soft
        float32 (host arrays)."""
        blen, _ = self.bits_lens(t_total)[expert]
        bits = res["bits"][expert, slot].cpu().numpy()
        soft = res["soft"][expert, slot].cpu().numpy()
        seg = bits.shape[0] // self.n_t
        take = np.concatenate([np.arange(k * seg, k * seg + blen)
                               for k in range(self.n_t)])
        return bits[take].astype(np.uint8), soft[take].astype(np.float32)
