"""The traffic generator: the station's wideband captures, cycle by cycle.

A configuration has one source (an SDR: one capture centred at
``center_mhz``) or several (``"sources": [{"center_mhz": ...}, ...]``,
each a capture of ``capture_rate`` at its own centre, in the order the
station reads them).  All sources share one sample clock, so block ``k``
of every source spans the same samples; cycle ``k`` is block ``k`` of
each source.  A traffic file (``traffic/<name>.json``) lists the sondes
on air, of the types in ``frames.TYPES``, each with its serial,
frequency (``channel`` and ``offset_hz`` from the first source's centre,
or an absolute ``freq_mhz``), level and launch site.  ``Traffic`` keeps
every sonde's symbol stream (a seeded lead-in of random bits, then its
frames back to back) and the truth of each frame: its id, GPS time,
position and the symbols it spans (an LMS6-1680 sends one frame a
second, padded as its protocol pads, ``frames.SLOT_FILL``).  The frames
of the blocks a run is expected to need are encoded at set-up; past them
a stream grows as the modulator asks for more, so that a station faster
than the traffic's ``max_realtime_x`` still gets fresh frames.

``Generator`` modulates cycle ``k`` on the device, from the seed: every
source's capture carries every sonde within half the capture rate of its
centre (the station's own span, ``Station.in_capture``) at that
capture's offset, with the same symbols and level, through a
phase-continuous Gaussian FSK of its own carried across blocks (the FSK
of ``modulate``); each source adds its own complex noise of 0.002 RMS a
component.  The station gets each source's cs16 planes ``[2, T]``
(int16) on the host, as an SDR source hands them over.  A prefetch
thread on a CUDA stream of its own makes a cycle's blocks together and
stays two cycles ahead.

Every sonde keeps its serial; its frame counter and GPS time advance
frame by frame through the run, and its position follows an ascent from
its launch site.  GPS time starts at the run's clock floored to the
hour, so that a seed gives the same inputs to every run in that hour and
the station's time filter (3 hours) accepts every frame.
"""

import math
import queue
import threading
import time

import numpy as np

from stationbench import frames

NOISE_RMS = 0.002
# GPS time starts at the run's clock floored to the hour: a frame's time
# of day then shares its hour with the clock's or the hour before, which
# the station's completion of a time-only timestamp (an LMS6-1680's)
# around midnight needs
TIME_QUANTUM_S = 3600


def gps_start(now: float | None = None) -> float:
    """GPS seconds of the run's clock floored to ``TIME_QUANTUM_S``."""
    now = time.time() if now is None else now
    epoch = frames.GPS_EPOCH.timestamp()
    return math.floor((now - epoch) / TIME_QUANTUM_S) * TIME_QUANTUM_S


def channel_offset(ch: int, n_chan: int, fs: int) -> float:
    """Center (Hz from the capture center) of channel ``ch`` of an
    ``n_chan``-channel bank; negative indices count down from the top."""
    return float((ch % n_chan) * fs / n_chan - (fs if ch % n_chan >
                                                 n_chan // 2 else 0))


def ascent(site, t: float):
    """(lat, lon, alt) ``t`` seconds after launch from ``site`` (lat, lon,
    alt, east m/s, north m/s, up m/s)."""
    lat0, lon0, alt0, ve, vn, vu = site
    lat = lat0 + vn * t / 111_320.0
    lon = lon0 + ve * t / (111_320.0 * math.cos(math.radians(lat0)))
    return lat, lon, alt0 + vu * t


class Sonde:
    """One sonde's symbol stream and the truth of its frames."""

    def __init__(self, spec: dict, f_off: float, t0_gps: float, rng,
                 **kw):
        self.type = spec["type"]
        self.serial = spec["serial"]
        self.id = frames.expected_id(self.type, self.serial)
        self.f_off = f_off
        self.level = float(spec["level"])
        _, self.rs, self.spacing, self.bt = frames.TYPES[self.type]
        self.site = tuple(spec["site"])
        self.t0_gps, self.kw = t0_gps, kw
        # the first frame starts ``phase_s`` into the run, whatever the
        # seed: every seed puts the same frames at the same block edges;
        # before it, random bits (chip_smoke.py's lead-in)
        lead = int(round(float(spec.get("phase_s", 0.0)) * self.rs))
        self.buf = rng.integers(0, 2, max(lead, 1024)).astype(np.uint8)
        self.n = lead
        self.truth = []          # (t_gps, lat, lon, alt, first, end symbol)

    @property
    def syms(self) -> np.ndarray:
        return self.buf[:self.n]

    def ensure(self, n_sym: int):
        """Encodes frames until the stream holds ``n_sym`` symbols."""
        while self.n < n_sym:
            i = len(self.truth)
            t = self.t0_gps + i
            lat, lon, alt = ascent(self.site, float(i))
            bits = frames.frame_bits(self.type, self.serial, i, t, lat, lon,
                                     alt, **self.kw)
            n_frame = len(bits)
            if self.type in frames.SLOT_FILL and n_frame < self.rs:
                bits = np.concatenate(
                    [bits, frames.SLOT_FILL[self.type](self.rs - n_frame)])
            end = self.n + len(bits)
            if end > len(self.buf):
                buf = np.empty(max(end, 2 * len(self.buf)), np.uint8)
                buf[:self.n] = self.buf[:self.n]
                self.buf = buf
            self.buf[self.n:end] = bits
            self.truth.append((t, lat, lon, alt, self.n, self.n + n_frame))
            self.n = end


def source_centers(cfg: dict) -> list:
    """The centre (Hz) of each source of a configuration, in order: its
    ``sources``, or one source at ``center_mhz``."""
    srcs = cfg.get("sources") or [{"center_mhz": cfg["center_mhz"]}]
    return [float(src["center_mhz"]) * 1e6 for src in srcs]


class Traffic:
    """The sondes of a traffic file on a configuration's captures, their
    frames encoded for the first ``n_blocks`` blocks.  ``centers`` holds
    each source's centre (Hz); a sonde's ``f_off`` is its offset from the
    first source's centre, ``f_hz`` its absolute frequency and
    ``sources`` the captures that carry it."""

    def __init__(self, spec: dict, cfg: dict, seed: int, n_blocks: int,
                 t0_gps: float | None = None):
        self.spec = spec
        self.fs = int(cfg["capture_rate"])
        self.block = int(round(float(cfg["block_seconds"]) * self.fs))
        self.t0_gps = gps_start() if t0_gps is None else t0_gps
        self.centers = source_centers(cfg)
        n_chan = int(cfg.get("num_channels_wide") or cfg["num_channels"]) \
            if self.centers[0] > 1e9 else int(cfg["num_channels"])
        rng = np.random.default_rng([int(seed), 1])
        # the GPS constellation an RS92's frames are solved against: its
        # week and epoch are the run's, as a station's downloaded one
        week, sow = frames.gps_week_tow(self.t0_gps)
        self.ephemeris = frames.rs92_test_ephemeris(week, float(sow))
        self.sondes = []
        c0 = self.centers[0]
        for em in spec["emitters"]:
            if "freq_mhz" in em:
                f_off = float(em["freq_mhz"]) * 1e6 - c0
            else:
                f_off = channel_offset(int(em["channel"]), n_chan,
                                       self.fs) + \
                    float(em.get("offset_hz", 0.0))
            kw = {"ephs": self.ephemeris} if em["type"] == "RS92NGP" else {}
            s = Sonde(em, f_off, self.t0_gps, rng, **kw)
            s.f_hz = c0 + f_off
            s.sources = [i for i, c in enumerate(self.centers)
                         if abs(s.f_hz - c) <= self.fs / 2]
            if not s.sources:
                raise ValueError(
                    f"{s.type} {s.serial} at {s.f_hz / 1e6:.6f} MHz lies in"
                    f" no source's capture ({self.fs / 1e6:g} MS/s at "
                    f"{', '.join(f'{c / 1e6:.6f}' for c in self.centers)}"
                    f" MHz)")
            s.ensure(-(-(n_blocks * self.block + self.fs) * s.rs // self.fs))
            self.sondes.append(s)
        self.seed = int(seed)

    def frames_ending_in(self, k0: int, k1: int):
        """Truth of every sonde frame whose last symbol falls in blocks
        [k0, k1): (sonde, frame index, t_gps, lat, lon, alt, block,
        first sample, end sample)."""
        out = []
        for s in self.sondes:
            for i, (t, lat, lon, alt, first, end) in enumerate(s.truth):
                a = first * self.fs // s.rs
                e = -(-end * self.fs // s.rs)
                blk = (e - 1) // self.block
                if k0 <= blk < k1:
                    out.append((s, i, t, lat, lon, alt, blk, a, e))
        return out


class Modulator:
    """Phase-continuous Gaussian FSK of one sonde, one block at a time
    (the arithmetic of the port's ``demod.modulate.gfsk_mod``, kept here
    so that the yardstick cannot move): the frequency of wideband sample
    ``n`` is the deviation of symbol ``floor(n rs / fs)``, smoothed by a
    Gaussian of sigma sqrt(ln 2) / (2 pi BT) symbols, plus the offset.
    The symbols of each block go to the device as bytes."""

    def __init__(self, em, fs: int, device, f_off: float | None = None):
        import torch
        self.em, self.fs, self.device = em, fs, device
        # the offset from this capture's centre (None: the sonde's own
        # ``f_off``, from the first source's)
        self.f_off = em.f_off if f_off is None else f_off
        self.phase = 0.0
        sigma = math.sqrt(math.log(2.0)) / (2 * math.pi * em.bt) * \
            (fs / em.rs)
        klen = int(8 * sigma) | 1
        kx = np.arange(klen) - klen // 2
        g = np.exp(-0.5 * (kx / sigma) ** 2)
        self.half = klen // 2
        self.g = torch.from_numpy(g / g.sum()).to(device)

    def freq(self, n0: int, n: int):
        """Smoothed instantaneous frequency (Hz) of samples [n0, n0+n)."""
        import torch
        em = self.em
        lo = max(n0 - self.half, 0) * em.rs // self.fs
        hi = (n0 + n + self.half - 1) * em.rs // self.fs + 1
        em.ensure(hi)
        syms = torch.from_numpy(em.syms[lo:hi]).to(self.device)
        idx = torch.arange(n0 - self.half, n0 + n + self.half,
                           device=self.device, dtype=torch.int64)
        sym = torch.clamp((idx * em.rs) // self.fs - lo, 0, hi - lo - 1)
        dev = (syms[sym].to(torch.float64) - 0.5) * em.spacing
        dev = torch.where(idx < 0, torch.zeros_like(dev), dev)
        # a power-of-two transform at least as long as the linear
        # convolution (radix-2 FFTs, no Bluestein)
        m = 1 << (dev.numel() + self.g.numel() - 2).bit_length()
        f = torch.fft.irfft(torch.fft.rfft(dev, m) *
                            torch.fft.rfft(self.g, m), m)
        return f[2 * self.half:2 * self.half + n]

    def block(self, n0: int, n: int):
        """The complex baseband of samples [n0, n0+n) (complex128)."""
        import torch
        f = self.freq(n0, n)
        step = 2 * math.pi * self.f_off / self.fs
        ph = self.phase + torch.cumsum(
            (2 * math.pi / self.fs) * f, 0) + step * torch.arange(
                1, n + 1, device=self.device, dtype=torch.float64)
        self.phase = float(ph[-1].remainder(2 * math.pi))
        return torch.polar(torch.full_like(ph, self.em.level), ph)


def block_seed(seed: int, k: int, source: int = 0) -> int:
    """The noise generator's seed of block ``k`` of ``source``."""
    key = [int(seed), 2, k] + ([source] if source else [])
    return int(np.random.SeedSequence(key).generate_state(
        1, np.uint64)[0] & 0x7FFFFFFFFFFFFFFF)


class Generator:
    """Cycles of the traffic as cs16 planes, in order."""

    def __init__(self, traffic: Traffic, device):
        self.traffic = traffic
        self.device = device
        c0 = traffic.centers[0]
        # a modulator for each sonde in each capture that carries it
        self.mods = [[Modulator(e, traffic.fs, device, e.f_off + (c0 - c))
                      for e in traffic.sondes if i in e.sources]
                     for i, c in enumerate(traffic.centers)]
        self.k = 0

    def make(self, k: int):
        """Cycle ``k`` as int16 [sources, 2, T] on the device (cycles in
        order)."""
        import torch
        if k != self.k:
            raise ValueError("cycles are made in order")
        self.k += 1
        T = self.traffic.block
        g = torch.Generator(device=self.device)
        out = []
        for i, mods in enumerate(self.mods):
            g.manual_seed(block_seed(self.traffic.seed, k, i))
            x = torch.randn((2, T), generator=g, device=self.device,
                            dtype=torch.float64) * NOISE_RMS
            for m in mods:
                z = m.block(k * T, T)
                x[0] += z.real
                x[1] += z.imag
            out.append(torch.clamp(torch.round(x * 32768.0), -32768, 32767)
                       .to(torch.int16))
        return torch.stack(out)


class Prefetch:
    """Runs a ``Generator`` in a thread on its own CUDA stream (none on
    the CPU), ``depth`` cycles ahead; ``get()`` returns the next cycle as
    a host NumPy array [sources, 2, T].  Its device work lies on its own
    stream, which the trace's reading leaves out."""

    def __init__(self, gen: Generator, depth: int = 2):
        import torch
        self.gen = gen
        self.q = queue.Queue(maxsize=depth)
        self.stop = threading.Event()
        self.error = None
        cuda = torch.device(gen.device).type == "cuda"
        self.stream = torch.cuda.Stream(gen.device) if cuda else None
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="stationbench-generate")
        self.thread.start()

    def _run(self):
        import torch
        try:
            k = 0
            while not self.stop.is_set():
                with torch.profiler.record_function("generate"):
                    if self.stream is not None:
                        # a pageable host block, as a source reading a
                        # file or a socket hands over (copied on this
                        # thread's stream, which the copy waits for)
                        with torch.cuda.stream(self.stream):
                            host = self.gen.make(k).cpu()
                    else:
                        host = self.gen.make(k)
                while not self.stop.is_set():
                    try:
                        self.q.put(host.numpy(), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                k += 1
        except BaseException as e:       # handed to the consumer
            self.error = e
            self.q.put(None)

    def get(self):
        blk = self.q.get()
        if blk is None:
            raise RuntimeError("the generator failed") from self.error
        return blk

    def close(self):
        self.stop.set()
        while True:
            try:
                self.q.get_nowait()
            except queue.Empty:
                break
        self.thread.join(timeout=30)
