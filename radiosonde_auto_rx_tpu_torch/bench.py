"""Headline benchmark: IQ Msamples/s through the FSK demodulator, plus the
station's per-block device programs.

Port of the repository's root ``bench.py`` (the JAX driver), with its
metric names and definitions.

Usage::

    python -m radiosonde_auto_rx_tpu_torch.bench [--device cpu]
        [--ablate | --scaling]

Primary metric: complex IQ samples/s through the full RS41-config 2FSK
demod (frequency estimation, tone integration, timing, soft bits), one
launch of the scan kernel ``fsk_scan`` over 512 channels x 4 s.
Baseline: the reference decodes ~5 concurrent 48 kHz channels in real
time on a Pi4 = 0.24 Msamples/s/device.

The station metrics time the station's device programs at production
geometry (10 wideband 2.4 MHz captures of 1 s, 50 channels): the
production block (``StationStep.analyze`` without the prescreen,
``confirm`` on 20 candidates, the per-type demod of 10 actives), the
fused steady block with and without its PSD scan
(``StationStep.steady_step``), and the r3 all-channel model (channelize,
sparse Welch PSD, prescreen on the 20% duty rows, the full detection
pass on the top 16, the demod of every channel).  Host-side peak picking
and frame decode are left out, as in the reference: they are the
station's own host work, which its block walls measure.

Timing follows the reference: two warm-up calls, then ``reps`` calls
enqueued on alternating input buffers and one host fetch of a scalar,
best of three trials; the wall ms a step is that over ``reps``.  On a
CUDA device each program also reads ``<program>_device_ms``: CUDA events
around calls queued behind a device spin (``tools.profile_station.
device_ms``), or, for a program that blocks the host inside (a copy from
pageable host memory: the steady block's plan, ``confirm``'s slot ids;
the detector's host decisions), the profiler's sum of its device
activities (``device_busy_ms``), named in ``<program>_clock``;
``<program>_launches`` counts the port's kernels one step launches.
XLA's cost-analysis keys of the reference (``_mfu_pct_bf16peak``,
``_hbm_util_pct_v5espec``) have no counterpart; in their place the r3
step's least bytes (the captures read once, its two scalars written
once) and that count over the step's time as a share of the H100's
3.35 TB/s.  On the CPU (``--device cpu``, the reference's CPU
geometry) no device metric is written: those keys are null.

``--ablate`` times the r3 model's five stages alone and prints a table;
``--scaling`` times ``parallel.pipeline.sharded_fsk_demod`` on one shard
and on every visible GPU (8 CPU shards with ``--device cpu``).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"extra"}.  Without a CUDA device and without ``--device cpu`` it prints
the reference's error line and exits 1; any failure raises.
"""

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from radiosonde_auto_rx_tpu_torch import kernels
from radiosonde_auto_rx_tpu_torch.demod.fsk import (
    FSKConfig, fsk_demod_stream, fsk_init_state, fsk_num_blocks_buffered)
from radiosonde_auto_rx_tpu_torch.detect.correlator import _correlate_peaks
from radiosonde_auto_rx_tpu_torch.detect.psd import _welch
from radiosonde_auto_rx_tpu_torch.detect.scanner import SondeDetector
from radiosonde_auto_rx_tpu_torch.ops.channelizer import (
    _channelize, extract_phases, pfb_prototype)
from radiosonde_auto_rx_tpu_torch.ops.resample import resample_planes
from radiosonde_auto_rx_tpu_torch.parallel.mesh import (
    CH_AXIS, T_AXIS, make_mesh, shard)
from radiosonde_auto_rx_tpu_torch.parallel.pipeline import (
    scan, sharded_fsk_demod)
from radiosonde_auto_rx_tpu_torch.parallel.station_step import StationStep
from radiosonde_auto_rx_tpu_torch.station.chains import demod_chain
from radiosonde_auto_rx_tpu_torch.tools.profile_station import (
    device_busy_ms, device_ms)

BASELINE_MSPS = 0.24  # reference: ~5 real-time 48 kHz channels per device
H100_HBM_BPS = 3.35e12          # H100 SXM HBM3, NVIDIA's data sheet
N_CHAN = 50                     # production: 2.4 MHz / 48 kHz
DUTY = 0.2                      # detector duty cycle (r3 model)
CAP = 16                        # full-pass survivors (r3 model)
N_CAND = 20                     # production confirmation slots
# a realistic active-sonde load: ~1 sonde per capture across the common
# types (reference stations run ~5 concurrent tasks; this models 2x that)
ACTIVES = ("RS41", "RS41", "RS41", "RS41", "DFM", "DFM", "M10", "M10",
           "M20", "MTS01")
N_OFFGRID = 2                   # steady block: off-grid (recentered) actives
HEADLINE_SCALING_CALLS = 20     # --scaling's calls at the headline geometry


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The sizes a run takes: the headline demod's channels and samples,
    the station programs' captures (``B`` of ``t_wide`` samples; the r3
    model and ``--ablate`` take ``t_wide_r3``), the production block's
    confirmation slots, the timed calls a trial and the trials, and
    ``--scaling``'s (channels, samples, calls)."""
    demod_channels: int
    demod_samples: int
    B: int
    t_wide: int
    t_wide_r3: int
    n_cand: int
    reps: int
    trials: int = 3
    scaling: tuple = (16, 96_000, 3)


# the reference's accelerator sizes, and its CPU sizes (production and
# steady keep full 1 s captures on the CPU, as the reference does)
CARD = Geometry(512, 4 * 48000, 10, 2_400_000, 2_400_000, N_CAND, 50)
CPU = Geometry(16, 48000, 1, 2_400_000, 480_000, 6, 2)


def _cfg():
    return FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=300,
                     est_min=-5000, est_max=5000,
                     tone_spacing=5000, freq_est_type=1)


def make_input(cfg, channels, t_samples, device):
    """Synthetic 2FSK made on ``device`` from seed 0: random symbols
    + AWGN, as [C, 2, T] float32 planes."""
    g = torch.Generator(device=device).manual_seed(0)
    nsym = t_samples // cfg.ts + 1
    bits = torch.rand((channels, nsym), generator=g, device=device) < 0.5
    tone = cfg.tone_spacing / 2.0
    f = torch.where(bits.repeat_interleave(cfg.ts, dim=1)[:, :t_samples],
                    tone, -tone)
    ph = 2 * math.pi * torch.cumsum(f, dim=1) / cfg.fs
    iq = torch.stack([torch.cos(ph), torch.sin(ph)], dim=1)
    noise = torch.randn(iq.shape, generator=g, device=device) * 0.07
    return (iq + noise).float()


def _wide(B, t_wide, device):
    """B Gaussian-noise wideband captures [B, 2, t_wide] made on
    ``device`` from seed 1."""
    g = torch.Generator(device=device).manual_seed(1)
    return torch.randn((B, 2, t_wide), generator=g, device=device)


def _stacked(out, C: int, nb: int):
    """A stream-layout scan output [C, nb*nsym] as the reference's
    stacked [nb, C, nsym] (a view)."""
    return out.view(C, nb, -1).transpose(0, 1)


# ---------------------------------------------------------------------- #
# the programs: each maps its input to a dict of scalar probes (tensors)

def demod_program(cfg, channels, device):
    """The headline program: the buffered demod of x [C, 2, T], one
    ``fsk_scan`` launch; probes: the soft and bit sums (reduced on the
    device, so no full output crosses to the host)."""
    state0 = fsk_init_state(cfg, channels, device)

    def run(x):
        _, outs = scan(cfg, x, state0,
                       fsk_num_blocks_buffered(cfg, x.shape[-1]))
        return dict(soft=outs["soft"].sum(),
                    bits=outs["bits"].to(torch.int32).sum())

    return run


class AllChannelModel:
    """The r3 all-channel model's stages (reference ``bench.py:104-222``
    and ``:456-490``) on ``B`` captures of ``t_wide`` samples: every
    channel demodulated, the two-phase detect at ``DUTY``."""

    def __init__(self, device, B, t_wide):
        self.device = torch.device(device)
        self.B, self.t_wide = B, t_wide
        self.cfg = _cfg()
        self.taps = torch.from_numpy(pfb_prototype(N_CHAN)).to(device)
        self.det = SondeDetector(48000, device=device)
        self.C = B * N_CHAN
        self.n_det = max(1, int(self.C * DUTY))
        self.cap = min(CAP, self.n_det)
        self.nb = fsk_num_blocks_buffered(self.cfg, t_wide // N_CHAN)

    def channelize(self, wide):
        """PFB channelizer per capture -> [B*N, 2, T//N]."""
        return _channelize(wide, self.taps, N_CHAN).reshape(
            self.C, 2, -1)

    def psd(self, wide):
        """The station's sparse Welch scan: one 2048 window per 8192
        samples (K2)."""
        return _welch(wide, 2048, hop=8192)

    def ratios(self, chf):
        """Half-rate prescreen scores of the duty rows [n_det]."""
        return self.det.prescreen.scores(chf[:self.n_det])

    def full_pass(self, chf, survivors):
        """The 4-stream multi-template pass on the ``survivors`` rows:
        per class the peak value's max plus the window sums' sum."""
        acc = torch.zeros((), device=self.device)
        streams = self.det._condition(chf[survivors])
        for fm, (_, _, _, bank, lens) in zip(streams, self.det.classes):
            val, _, _, xm = _correlate_peaks(fm, bank.to(fm.dtype), lens)
            acc = acc + val.max() + xm.sum()
        return acc

    def top(self, ratio):
        """The full pass's survivors: the top-``cap`` prescreen rows
        (device-side; the station gathers its survivors on the host,
        the same work at a fixed capacity)."""
        return torch.topk(ratio, self.cap).indices

    def demod(self, chf):
        """The buffered demod of every channel (one ``fsk_scan``) and
        the reference's consumption probes on its stacked [nb, C, nsym]
        outputs: the duty rows' bit sum and a soft sum strided over the
        symbols (every block contributes)."""
        _, outs = scan(self.cfg, chf,
                       fsk_init_state(self.cfg, self.C, self.device),
                       self.nb)
        soft = _stacked(outs["soft"], self.C, self.nb)
        bits = _stacked(outs["bits"], self.C, self.nb)
        return (bits[:, :self.n_det].to(torch.int32).sum(),
                soft[:, :, ::257].sum())

    def step(self, wide):
        chf = self.channelize(wide)
        psd = self.psd(wide)
        ratio = self.ratios(chf)
        survivors = self.top(ratio)
        duty_bits, soft = self.demod(chf)
        return dict(psd=psd.sum(), corr=self.full_pass(chf, survivors),
                    ratio=ratio.sum(), soft=soft, duty_bits=duty_bits,
                    ratios=ratio, survivors=survivors)

    def least_bytes(self) -> int:
        """The step's least bytes: the captures read once and its two
        scalars (the reference's sum and duty bit count) written once."""
        return self.B * 2 * self.t_wide * 4 + 2 * 4


def production_program(device, B, t_wide, n_cand):
    """The production station's per-block device programs as the
    station dispatches them on one device: ``analyze(screen=False)``
    (PFB channelize, sparse Welch PSD), ``confirm`` on ``n_cand`` scan
    candidates (every block filling its confirmation slots, the worst
    case), and the per-type demod of the active channels.  The numpy
    plan is the reference's (``default_rng(3)``), built once.  Returns
    (program, model string)."""
    step = StationStep(device, n_chan=N_CHAN, capacity=4,
                       conf_capacity=n_cand)
    rng = np.random.default_rng(3)
    by_type = {}
    for name in ACTIVES:
        by_type.setdefault(name, []).append(int(rng.integers(0, B * N_CHAN)))
    slots = np.full(step.n_conf_slots, -1, np.int32)
    slots[:n_cand] = rng.choice(B * N_CHAN, n_cand, replace=False)
    # each type's chain as the station's decode_channels dispatches it
    plan = [(name, *demod_chain(name, 48000)[:2],
             torch.tensor(cids, dtype=torch.int64, device=device))
            for name, cids in by_type.items()]

    def run(wide):
        chf, psd, _ = step.analyze(wide, screen=False)
        conf = step.confirm(chf, slots)
        out = dict(psd=psd.sum(),
                   peaks=sum(p[0].sum() for p in conf["peaks"]))
        for name, cfg_t, rs_to, idx in plan:
            x = chf[idx].float()
            if rs_to:
                x = resample_planes(x, 48000, rs_to)
            soft, bits, _, _ = fsk_demod_stream(cfg_t, x, device)
            out[f"soft_{name}"] = soft[:, ::257].sum()
            out[f"bits_{name}"] = bits.to(torch.int32)[:, ::7].sum()
        return out

    model = ("production device programs (analyze[no-screen] + "
             "confirm@%d cands + %d-type demod@%d active)"
             % (n_cand, len(plan), len(ACTIVES)))
    return run, model


def steady_plan(B, t_wide):
    """The steady block's host plan (reference ``bench.py:355-381``):
    (idx, blk, rows, ph_m, ph_r, plan) with each type's channels padded
    to a power of two by repeating its first, and ``N_OFFGRID``
    recentering slots 10 kHz off their channel centers."""
    rng = np.random.default_rng(3)
    cids = rng.choice(B * N_CHAN, len(ACTIVES), replace=False)
    by_type = {}
    for name, cid in zip(ACTIVES, cids):
        by_type.setdefault(name, []).append(int(cid))
    plan, idx = [], []
    for name in sorted(by_type):
        ids = sorted(by_type[name])
        n = 1 << max(0, int(np.ceil(np.log2(len(ids)))))
        plan.append((name, n))
        idx.extend(ids + [ids[0]] * (n - len(ids)))
    M = t_wide // N_CHAN
    ph_m = np.zeros((N_OFFGRID, M), np.float32)
    ph_r = np.zeros((N_OFFGRID, N_CHAN), np.float32)
    blk = np.zeros(N_OFFGRID, np.int32)
    rows = np.zeros(N_OFFGRID, np.int32)
    for s in range(N_OFFGRID):
        cid = int(cids[s])
        f_rel = (cid % N_CHAN) * 48000.0 + 10e3
        ph_m[s], ph_r[s] = extract_phases(f_rel, N_CHAN * 48000, t_wide,
                                          N_CHAN)
        blk[s] = cid // N_CHAN
        rows[s] = cid
    return np.asarray(idx, np.int32), blk, rows, ph_m, ph_r, tuple(plan)


def steady_program(device, B, t_wide, scan_psd=True):
    """The fused steady block (``StationStep.steady_step``): channelize,
    the PSD when ``scan_psd``, the recentered extraction of the
    off-grid actives and the per-type demod.  The station copies the
    plan from host memory on every call; the bench times it so."""
    step = StationStep(device, n_chan=N_CHAN, capacity=4)
    idx, blk, rows, ph_m, ph_r, plan = steady_plan(B, t_wide)

    def run(wide):
        chf, psd, outs = step.steady_step(wide, idx, blk, rows, ph_m, ph_r,
                                          plan, scan=scan_psd)
        out = dict(psd=psd.sum() if scan_psd
                   else chf[:, 0, ::4097].sum())
        for name, (soft, bits, _) in outs.items():
            out[f"soft_{name}"] = soft[:, ::257].sum()
            out[f"bits_{name}"] = bits.to(torch.int32)[:, ::7].sum()
        return out

    return run


# ---------------------------------------------------------------------- #
# timing

def _fetch(out):
    """Wait for ``out`` by fetching one element of its first tensor to
    the host (one stream: every call queued before it has run)."""
    float(next(iter(out.values())).reshape(-1)[0])


def _wall_ms(fn, inputs, reps: int, trials: int) -> float:
    """The reference's timing: two warm-ups, then ``reps`` calls
    enqueued on alternating inputs and one fetch; best of ``trials``;
    ms a call."""
    for a in inputs:
        _fetch(fn(a))
    best = math.inf
    for _ in range(trials):
        t0 = time.perf_counter()
        outs = [fn(inputs[i % 2]) for i in range(reps)]
        _fetch(outs[-1])
        best = min(best, time.perf_counter() - t0)
    return best / reps * 1e3


def _device_time(fn, trials: int):
    """(ms, clock) of ``fn()`` on the card: CUDA events behind a device
    spin, or, where the host cannot queue the calls ahead (it blocks
    inside), the profiler's sum of the device activities."""
    try:
        return min(device_ms(fn) for _ in range(trials)), "device"
    except RuntimeError as e:
        if "never queued" not in str(e):
            raise
    return device_busy_ms(fn), "device busy"


def _timed(extra, name, fn, inputs, geo, device) -> float:
    """Time program ``name`` on ``inputs`` (two buffers) into ``extra``:
    its wall ms a step, the port kernels one step launches and, on a
    CUDA device, its device ms and their clock.  Returns the wall ms."""
    wall = _wall_ms(fn, inputs, geo.reps, geo.trials)
    kernels.reset_launches()
    _fetch(fn(inputs[0]))
    extra[f"{name}_launches"] = dict(kernels.launches)
    extra[f"{name}_wall_ms"] = wall
    if device.type == "cuda":
        ms, clock = _device_time(lambda: fn(inputs[0]), geo.trials)
    else:
        ms, clock = None, "host (cpu): no device time"
    extra[f"{name}_device_ms"] = ms
    extra[f"{name}_clock"] = clock
    return wall


def _pair(x):
    """The input and its alternate buffer (+1e-4), as the reference."""
    return x, x + 1e-4


def hbm_sustained_gbps(device) -> float:
    """The memory rate a one-kernel multiply-add sustains on the card:
    16 Mi float32 read and written once a call, the reference's timing
    (alternating inputs, 40 calls a fetch, best of 3)."""
    n = 16 * 1024 * 1024
    a = torch.ones((n,), device=device)
    a2 = a * 1.0001
    one = torch.tensor(1.0, device=device)
    k = torch.tensor(1.5, device=device)

    def saxpy(v):
        return dict(y=torch.addcmul(one, v, k)[0])

    ms = _wall_ms(saxpy, (a, a2), 40, 3)
    return 2 * n * 4 / (ms / 1e3) / 1e9


# ---------------------------------------------------------------------- #
# the drivers

def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def run(device, geo: Geometry) -> dict:
    """Every program at ``geo`` on ``device``: the JSON result."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    cfg = _cfg()
    extra = {"device": card_line() if cuda else "cpu",
             "geometry": dataclasses.asdict(geo)}

    C, T = geo.demod_channels, geo.demod_samples
    x = make_input(cfg, C, T, device)
    ms = _timed(extra, "demod", demod_program(cfg, C, device), _pair(x),
                geo, device)
    msps = C * T / ms / 1e3
    del x

    wide = _pair(_wide(geo.B, geo.t_wide, device))
    samples = geo.B * geo.t_wide
    # headline station metric: the production device programs as the
    # station dispatches them (worst case: full confirmation slots)
    prod, model = production_program(device, geo.B, geo.t_wide, geo.n_cand)
    pr_ms = _timed(extra, "production", prod, wide, geo, device)
    extra["station_step_msps_production"] = samples / pr_ms / 1e3
    extra["station_step_msps_wideband"] = samples / pr_ms / 1e3
    extra["bench_schema"] = 2
    extra["station_step_vs_baseline"] = samples / pr_ms / 1e3 / BASELINE_MSPS
    extra["station_step_ms"] = pr_ms
    extra["station_step_model"] = model
    # the fused steady block; while decoding the station scans 1 block
    # in scan_every (4), so the no-scan variant is the majority block
    sd_ms = _timed(extra, "steady",
                   steady_program(device, geo.B, geo.t_wide), wide, geo,
                   device)
    ns_ms = _timed(extra, "steady_noscan",
                   steady_program(device, geo.B, geo.t_wide, False), wide,
                   geo, device)
    extra["station_step_msps_steady"] = samples / sd_ms / 1e3
    extra["station_step_ms_steady"] = sd_ms
    extra["station_step_msps_steady_noscan"] = samples / ns_ms / 1e3
    extra["station_step_ms_steady_noscan"] = ns_ms
    extra["station_step_ms_steady_duty4"] = (sd_ms + 3 * ns_ms) / 4
    del wide

    # the r3 continuity model: every channel demodulated + two-phase
    # detect at 20% duty
    r3 = AllChannelModel(device, geo.B, geo.t_wide_r3)
    st_ms = _timed(extra, "r3_allch", r3.step,
                   _pair(_wide(geo.B, geo.t_wide_r3, device)), geo, device)
    extra["station_step_msps_wideband_r3_allch_model"] = \
        geo.B * geo.t_wide_r3 / st_ms / 1e3
    extra["station_step_least_bytes_r3"] = r3.least_bytes()
    extra["station_step_hbm_pct_h100_least_bytes"] = \
        100.0 * r3.least_bytes() / (st_ms / 1e3) / H100_HBM_BPS \
        if cuda else None
    extra["hbm_sustained_gbps_measured"] = \
        hbm_sustained_gbps(device) if cuda else None
    extra["detect_duty"] = DUTY
    extra["detect_full_pass_cap"] = CAP
    return {"metric": "fsk_demod_iq_throughput", "value": msps,
            "unit": "Msamples/s/chip", "vs_baseline": msps / BASELINE_MSPS,
            "extra": extra}


def ablate(device, geo: Geometry) -> list:
    """The r3 model's stages alone (reference ``bench.py:423-531``):
    channelize, PSD scan, prescreen, the full detect (prescreen, top-k
    and the full pass on the survivors) and the demod of every channel,
    each timed as the programs are.  Prints a table (ms a step, device
    ms and clock, least MB: each stage's inputs read once and outputs
    written once, the Welch PSD counting the windows it reads) and
    returns its rows as dicts.  A stage's products are the channels, the
    PSD rows, the ratios, the soft and bit streams; the full pass's
    peaks are counted as its one scalar."""
    device = torch.device(device)
    B, t_wide = geo.B, geo.t_wide_r3
    m = AllChannelModel(device, B, t_wide)
    wide = _wide(B, t_wide, device)
    chf = m.channelize(wide)
    f4 = 4
    plane = B * 2 * t_wide * f4                 # the captures, once
    nseg = t_wide // 8192                       # _welch's sparse windows
    rows_b = m.n_det * 2 * (t_wide // N_CHAN) * f4
    nbits = m.nb * m.cfg.nsym
    stages = [
        ("channelize", lambda w: dict(y=m.channelize(w)), wide,
         2 * plane),
        ("psd_scan", lambda w: dict(y=m.psd(w).sum()), wide,
         B * nseg * 2048 * 2 * f4 + B * 2048 * f4),
        ("prescreen", lambda c: dict(y=m.ratios(c).sum()), chf,
         rows_b + m.n_det * f4),
        ("full_detect_top%d" % m.cap,
         lambda c: dict(y=m.full_pass(c, m.top(m.ratios(c)))), chf,
         rows_b + f4),
        ("fsk_demod", lambda c: dict(zip(("bits", "soft"), m.demod(c))),
         chf, plane + m.C * nbits * (f4 + 1))]
    rows = []
    for name, fn, arg, nbytes in stages:
        extra = {}
        ms = _timed(extra, name, fn, _pair(arg), geo, device)
        rows.append(dict(stage=name, ms=ms, device_ms=extra[
            f"{name}_device_ms"], clock=extra[f"{name}_clock"],
            least_mb=nbytes / 1e6, gbps=nbytes / ms / 1e6,
            launches={k: v for k, v in extra[f"{name}_launches"].items()
                      if v}))
    total = sum(r["ms"] for r in rows)
    print("| stage | ms/step | device ms | clock | least MB | GB/s at least "
          "MB | launches |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        dms = "not measured" if r["device_ms"] is None \
            else f"{r['device_ms']:.3f}"
        print(f"| {r['stage']} | {r['ms']:.3f} | {dms} | {r['clock']} | "
              f"{r['least_mb']:.0f} | {r['gbps']:.0f} | {r['launches']} |")
    print(f"| SUM (isolated) | {total:.3f} | | | | | |")
    print(f"\ngeometry: B={B} x {t_wide / 1e6:.1f} Ms wide, {N_CHAN} ch, "
          f"duty={DUTY}, full-pass cap={m.cap}, reps={geo.reps} on "
          f"{card_line() if device.type == 'cuda' else 'cpu'}")
    print(f"wide Msps if fused step == sum: {B * t_wide / total / 1e3:.0f}")
    return rows


def _sharded_msps(cfg, scaling, counts, devices) -> dict:
    """Samples/s (Msamples/s) of ``sharded_fsk_demod`` on ``scaling``'s
    (channels, samples, calls) at each shard count of ``counts``: the
    input sharded once, one warm call, then the calls timed, each ending
    in a host fetch of every shard's bit sum."""
    C, T, reps = scaling
    x = torch.randn((C, 2, T), generator=torch.Generator().manual_seed(0))
    msps = {}
    for n in counts:
        mesh = make_mesh(n_ch=n, n_t=1, devices=devices(n))
        xs = shard(x, mesh, (CH_AXIS, None, T_AXIS))

        def run():
            _, bits = sharded_fsk_demod(cfg, mesh, xs)
            return sum(int(b.to(torch.int32).sum()) for b in bits.values())

        run()                                   # warm (kernels built)
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        msps[n] = C * T * reps / (time.perf_counter() - t0) / 1e6
    return msps


def scaling(device, geo: Geometry) -> dict:
    """Sharded-demod samples/s (``parallel.pipeline.sharded_fsk_demod``
    on a channel mesh) at 1 shard and at n: on the CPU 8 CPU shards
    (``sharded_demod_scaling_cpu``, the reference's virtual devices: they
    share one host's cores, so this checks the sharded program, not
    silicon scaling), on the card every visible GPU
    (``sharded_demod_scaling_gpu``).  A virtual mesh of one card
    serializes its shards, so with one visible GPU only the 1-GPU number
    is reported (``ndev`` 1, ``vs_baseline`` null).  The metric keeps the
    reference's geometry (``geo.scaling``), where each call is ~1 ms of
    device work and the host's dispatch sets the pace; on the card
    ``extra["headline"]`` also times the headline demod's geometry
    (``geo.demod_channels`` x ``geo.demod_samples``,
    ``HEADLINE_SCALING_CALLS`` calls), where the device work dominates.
    Prints and returns the JSON result."""
    device = torch.device(device)
    cfg = _cfg()
    if device.type == "cpu":
        counts = (1, 8)

        def devices(n):
            return [device] * n
    else:
        n_vis = torch.cuda.device_count()
        counts = (1, n_vis) if n_vis > 1 else (1,)

        def devices(n):
            return [torch.device("cuda", i) for i in range(n)]
    msps = _sharded_msps(cfg, geo.scaling, counts, devices)
    n = counts[-1]
    speedup = msps[n] / msps[1] if n > 1 else None
    cpu = device.type == "cpu"
    C, T, reps = geo.scaling
    res = {
        "metric": "sharded_demod_scaling_" + ("cpu" if cpu else "gpu"),
        "value": msps[n], "unit": f"Msamples/s@{n}dev",
        "vs_baseline": speedup,
        "extra": {"ndev": n, "msps_1dev": msps[1], f"msps_{n}dev": msps[n],
                  f"speedup_{n}v1": speedup,
                  "device": "cpu" if cpu else card_line(),
                  "geometry": {"channels": C, "samples": T, "reps": reps},
                  "note": (
                      "8 CPU shards of one process share the host's cores "
                      "(one shard already multithreads), so this checks "
                      "the sharded program, not silicon scaling" if cpu
                      else "one process drives one GPU a shard from a host "
                      "loop" if n > 1
                      else "one visible GPU: a virtual mesh of one card "
                      "serializes its shards, so only the 1-GPU rate is "
                      "reported")},
    }
    if not cpu:
        big = (geo.demod_channels, geo.demod_samples, HEADLINE_SCALING_CALLS)
        hm = _sharded_msps(cfg, big, counts, devices)
        res["extra"]["headline"] = {
            "geometry": dict(zip(("channels", "samples", "reps"), big)),
            "msps_1dev": hm[1], f"msps_{n}dev": hm[n],
            f"speedup_{n}v1": hm[n] / hm[1] if n > 1 else None}
    print(json.dumps(res))
    return res


def error_line(reason: str) -> str:
    """The reference's error line (``bench.py:609-629``)."""
    return json.dumps({"metric": "fsk_demod_iq_throughput", "value": 0.0,
                       "unit": "Msamples/s/chip", "vs_baseline": 0.0,
                       "extra": {"error": reason}})


def main(argv=None, geometry: Geometry | None = None) -> int:
    """The command line; ``geometry`` overrides the device's sizes (the
    tests pass a small one)."""
    ap = argparse.ArgumentParser(
        prog="python -m radiosonde_auto_rx_tpu_torch.bench")
    ap.add_argument("--device", default="cuda",
                    help="torch device the programs run on (default cuda)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--ablate", action="store_true",
                      help="time the r3 model's stages alone")
    mode.add_argument("--scaling", action="store_true",
                      help="the sharded demod at 1 and n shards")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(error_line("no CUDA device (pass --device cpu to run on the "
                         "CPU)"))
        sys.stdout.flush()
        return 1
    geo = geometry or (CARD if device.type == "cuda" else CPU)
    if args.scaling:
        scaling(device, geo)
    elif args.ablate:
        ablate(device, geo)
    else:
        print(json.dumps(run(device, geo)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
