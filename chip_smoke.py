"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises (non-zero exit, traceback):

1. Check for a CUDA device, print the card's name and power limit
   (nvidia-smi), build the port's kernels from ``csrc/`` (nvcc, sm_90a,
   one process per source, all at once, into ``build/kernels/``) and
   print the build time.
2. Hold each hand-written kernel against its plain PyTorch twin on the
   card: K1 (FSK frequency-estimator pass) at the shapes the main path
   below gives it (RS41 with 2 channels, DFM at 50 kHz with 1), then
   RS41 and DFM with 16 channels and the MTS01 and M20 geometries; K2
   (|FFT|^2 of the Welch PSD) at N = 2048 on the sparse-Welch view of
   1 capture (the main path's 292 segments) and of 10 (2920), both
   timed, and on the half-overlapped Welch tilings of a capture that
   starts at an odd float (rows at no particular alignment); K3
   (windowed complex FFT) through its entry point ``ops.fft.fft`` at
   N = 64, 256, 1024 (512 rows, Hann window) and N = 2048, 4096 (64
   rows) as one launch each, and N = 8192, above the kernel's largest
   row, by the factored path (two launches); the launches of each route
   are counted.  Print each error against its tolerance, each kernel's
   time (device time, with the launches queued ahead of the card, and
   the time of a call when the wrapper's Python sets the pace) beside
   its twin's, the one PyTorch call that computes the same function from the same
   planes and window (cuFFT; none for K1), and the bound: the larger of
   the function's least float32 operations (each DFT as an FFT,
   5 N log2 N) over 67 TFLOP/s and its bytes (inputs read once, outputs
   written once) over 3.35 TB/s.
3. Synthesize 4 s of one 2.4 MHz capture at 402.5 MHz (cs16 wire format,
   ~0.002 RMS noise) carrying an RS41 on a channel center, an RS41
   +10 kHz off grid and a DFM on a channel center.  The signals come
   from the port's copies of the NumPy modulator and frame encoders.
4. Register the three sondes with ``start_manual_decoder`` on a port
   ``Station(device="cuda")`` at the production geometry (50 x 48 kHz
   channels, scan 1 block in 4) and run ``process_captures`` block by
   block: first as four 1 s blocks (the production block), then as two
   2 s blocks.  The kernel launch counters are zeroed just before.  The
   station demodulates each block afresh, and one DFM data cycle
   (1.12 s) is longer than the 0.84 s a 1 s block demodulates, so the
   DFM decodes only from the 2 s blocks — in the reference package too.
5. Check: both RS41s decoded from the 1 s blocks and all three sondes
   from the 2 s blocks, each with its encoded serial and a position
   within 1e-4 deg; both kernels launched on that run; the fused steady
   path served the channels; the same blocks through a CPU ``Station``
   (the plain twins) give the same telemetry.
6. Time one steady block (scan and no-scan) on the card.
7. Detection: hold the CUDA detector (``StationStep.confirm`` +
   ``decide_confirmed`` on the three sondes' rows of the first block)
   against its CPU path; then drive a ``Station(device="cuda")`` with no
   task over the same captures (1 s blocks, then 2 s blocks; counters
   zeroed just before, read just after).  Check that the three sondes
   are detected with their types and channels, that both RS41s decode
   from the 1 s blocks and all three from the 2 s blocks, and that a CPU
   ``Station`` detects the same tasks block by block and decodes the
   same telemetry.  Print the ``detections`` stat, K2's launches and the
   wall time of the block that runs ``confirm``.

The second-to-last line is a JSON object of per-kernel results (times
at the main path's shapes, bound, library-call time, the largest error
of all the checks, the
detection path's launch counts for K1 and K2 and K3's phase's; K2 and
K3 also list every shape timed), the last line ``{"ok": true, "device": {...}}``.
Without a CUDA device the script exits non-zero before printing any
result.
"""

import datetime
import json
import statistics
import subprocess
import sys
import time

import numpy as np

FS_WIDE = 2_400_000
N_CHAN = 50
SECONDS = 4
CENTER = 402.5e6
RS41_TS = 1_755_600_000          # fixed epoch -> identical frames per run
K1_TOL = 1e-5                    # max |kernel - twin| / max |twin|
K2_TOL = 1e-4                    # per bin, |kernel - twin| / (|twin| + row mean)
K3_TOL = 1e-4                    # per bin, |kernel - twin| / (|twin| + row RMS)
# K3's phase: (N, rows, method, kernel launches expected): one launch up
# to the kernel's largest row (4096), two above (the factored path's two
# DFT stages)
K3_SHAPES = ((64, 512, "auto", 1), (256, 512, "auto", 1),
             (1024, 512, "auto", 1), (2048, 64, "auto", 1),
             (4096, 64, "auto", 1), (8192, 64, "auto", 2))
# CUDA detector vs its CPU path: FM streams to STREAM_TOL of their peak;
# peak scores and DC terms to DET_TOL (the float32 running sums of the
# normalization cancel, and the CUDA scan sums in another order than the
# CPU; measured 1e-5 of a score on an H100; decisions are thresholded at
# 0.6-0.8); peak positions equal wherever the row's best two |scores|
# are more than DET_TOL apart, so that the measured score error cannot
# swap them
STREAM_TOL = 1e-4
DET_TOL = 1e-4
PEAK_F32 = 67e12                 # H100 SXM float32 FLOP/s, no tensor cores
PEAK_BYTES = 3.35e12             # H100 SXM HBM3 bytes/s
STATION_CFG = {"station_lat": 0.0, "station_lon": 0.0,
               "sonde_time_threshold": 1e9, "frame_plane_workers": 0,
               "enable_realtime_filter": False}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------- #
# synthetic capture

def sondes_for(n_chan: int, fs_wide: int):
    """(type, serial, offset Hz from capture center, lat, lon) of the
    three test sondes for a capture geometry."""
    from radiosonde_auto_rx_tpu_torch.ops.channelizer import channel_freqs
    f = channel_freqs(n_chan, fs_wide)
    return [("RS41", "T1357911", float(f[n_chan // 5]), -34.5, 138.6),
            ("RS41", "P2468024", float(f[2 * n_chan // 5]) + 10e3,
             -31.9, 115.9),
            ("DFM", "21054321", float(f[4 * n_chan // 5]), 47.9, 16.8)]


def _rs41_bits(serial, lat, lon, n_frames, rng):
    from radiosonde_auto_rx_tpu_torch.models.rs41 import (
        encode_frame, frame_to_bits, make_calibytes)
    now = datetime.datetime.fromtimestamp(RS41_TS, datetime.timezone.utc)
    week = (now - datetime.datetime(1980, 1, 6, tzinfo=datetime.timezone.utc)
            ).days // 7
    dow = (now.weekday() + 1) % 7
    tow_ms = ((dow * 24 + now.hour) * 3600 + now.minute * 60 +
              now.second) * 1000
    cal = make_calibytes()
    return np.concatenate(
        [rng.integers(0, 2, 400)] +
        [frame_to_bits(encode_frame(
            frame_nb=900 + i, sonde_id=serial, week=week,
            tow_ms=tow_ms + i * 1000, lat=lat, lon=lon, alt=12000.0,
            calibytes=cal, calfr=i % 50)) for i in range(n_frames)])


def _dfm_bits(serial, lat, lon, n_cycles, rng):
    from radiosonde_auto_rx_tpu_torch.models.dfm import encode_flight_bits
    return np.concatenate([
        rng.integers(0, 2, 500).astype(np.uint8),
        encode_flight_bits(sn=int(serial), lat=lat, lon=lon,
                           n_cycles=n_cycles, time_step=1.0)
        .astype(np.uint8)])


def synth_stream(n_chan: int, fs_wide: int, seconds: int, seed: int = 21):
    """``seconds`` of one continuous capture with the three sondes keyed
    up, as cs16 ``[2, seconds*fs_wide]`` int16 planes."""
    from radiosonde_auto_rx_tpu_torch.demod.modulate import gfsk_mod
    rng = np.random.default_rng(seed)
    t = seconds * fs_wide
    x = (rng.standard_normal(t) + 1j * rng.standard_normal(t)) * 0.002
    secs = seconds + 1
    for typ, serial, f_off, lat, lon in sondes_for(n_chan, fs_wide):
        if typ == "RS41":
            bits = _rs41_bits(serial, lat, lon, int(secs * 4800 / 2560) + 1,
                              rng)
            sig = gfsk_mod(bits, fs_wide, 4800, 2, f_off, 4800, bt=0.5)
        else:
            bits = _dfm_bits(serial, lat, lon, secs, rng)
            sig = gfsk_mod(bits, fs_wide, 2500, 2, f_off, 5000, bt=0.5)
        if len(sig) < t:
            raise RuntimeError(f"{typ} burst shorter than the capture")
        x += 0.2 * sig[:t]
    planes = np.stack([x.real, x.imag]) * 32768.0
    return np.clip(np.round(planes), -32768, 32767).astype(np.int16)


def split_blocks(stream, fs_wide: int, block_s: int):
    n = block_s * fs_wide
    return [stream[:, i:i + n] for i in range(0, stream.shape[1], n)]


# ---------------------------------------------------------------------- #
# the station

def make_station(device, n_chan: int, fs_wide: int, manual: bool = True):
    """A port ``Station`` at this geometry; ``manual``: the three sondes
    start as manual tasks, else the station has to find them."""
    from radiosonde_auto_rx_tpu_torch.station.station import Station
    st = Station({**STATION_CFG, "capture_rate": fs_wide,
                  "num_channels": n_chan}, center_freq_hz=CENTER,
                 device=device)
    if manual:
        for typ, serial, f_off, _, _ in sondes_for(n_chan, fs_wide):
            st.start_manual_decoder(CENTER + f_off, typ)
    return st


def tasks_of(st):
    """The station's tasks: sorted (type, frequency Hz)."""
    return sorted((v["type"], fz) for fz, v in st.active.items())


def _key(t):
    return (t["type"], t.get("id"), t.get("frame"),
            round(t["lat"], 4), round(t["lon"], 4), round(t["alt"], 1))


def check_telemetry(telems, n_chan: int, fs_wide: int, types):
    """Every sonde of ``types`` decoded with its serial and a position
    within 1e-4 degree, and nothing else decoded wrong; returns
    {serial: frames decoded}."""
    seen = {}
    for typ, serial, f_off, lat, lon in sondes_for(n_chan, fs_wide):
        want_id = serial if typ == "RS41" else f"DFM-{serial}"
        mine = [t for t in telems
                if abs(t["freq_float"] * 1e6 - (CENTER + f_off)) < 2e3]
        if not mine and typ in types:
            raise AssertionError(f"{typ} {serial}: no telemetry")
        for t in mine:
            if t["type"] != typ or t["id"] != want_id:
                raise AssertionError(f"{typ} {serial}: got {t['type']} "
                                     f"{t['id']}")
            if abs(t["lat"] - lat) > 1e-4 or abs(t["lon"] - lon) > 1e-4:
                raise AssertionError(f"{typ} {serial}: position "
                                     f"{t['lat']}, {t['lon']}")
        seen[serial] = len(mine)
    if sum(seen.values()) != len(telems):
        raise AssertionError("telemetry from an unexpected frequency")
    return seen


def drive_station(device, runs, n_chan: int, fs_wide: int,
                  manual: bool = True):
    """A station path: for each run (a list of blocks), a new station
    (``make_station``), then ``process_captures`` per block.  The launch
    counters are zeroed just before and read just after.  Returns
    ([(station, telemetry, [(tasks after the block, block wall ms)])]
    per run, kernel launches over all runs)."""
    import torch
    from radiosonde_auto_rx_tpu_torch import kernels
    cuda = torch.device(device).type == "cuda"
    kernels.reset_launches()
    out = []
    for blocks in runs:
        st = make_station(device, n_chan, fs_wide, manual)
        telems, per_block = [], []
        for blk in blocks:
            t0 = time.perf_counter()
            telems.extend(st.process_captures([blk]))
            if cuda:
                torch.cuda.synchronize()
            per_block.append((tasks_of(st),
                              (time.perf_counter() - t0) * 1e3))
        out.append((st, telems, per_block))
    return out, dict(kernels.launches)


# ---------------------------------------------------------------------- #
# kernels against their twins

def _time_ms(fn, reps: int = 20, ahead: bool = True) -> float:
    """Mean ms of ``fn`` between two CUDA events around ``reps`` calls,
    after 3 warm-ups.  ``ahead``: the device first spins
    (``torch.cuda._sleep``, ~6 ms at first), so the host has queued every
    call before the first one starts and the events bracket device time
    alone.  That is checked: if the spin had ended by the time the last
    call was queued, the timing is taken again behind a spin four times
    as long, and a host that never gets ahead is an error.  Without
    ``ahead`` a call shorter than its wrapper's Python is timed at the
    host's pace (the launch gap)."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    for spin in (10_000_000, 40_000_000, 160_000_000, 640_000_000):
        torch.cuda.synchronize()
        if ahead:
            torch.cuda._sleep(spin)
        start.record()
        for _ in range(reps):
            fn()
        queued_ahead = not start.query()    # the card was still spinning
        stop.record()
        torch.cuda.synchronize()
        if queued_ahead or not ahead:
            return start.elapsed_time(stop) / reps
    raise RuntimeError("the host never queued the timed calls ahead of "
                       "the card")


def fft_flops(n: int) -> float:
    """Operations of one complex length-``n`` DFT done as an FFT, the
    least work of the function (5 N log2 N; K1's own O(N^2) DFT does
    8 N^2 and is not the bound)."""
    return 5.0 * n * np.log2(n)


def bound(flops: float, nbytes: float):
    """(least ms on the card, "operations" or "bytes"): the function's
    least float32 work outside the tensor cores over 67 TFLOP/s, and each
    input read once plus each output written once over 3.35 TB/s (H100
    SXM data sheet)."""
    t_ops, t_bytes = flops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else \
        (t_bytes, "bytes")


def check_k1(dev, name, cfg, c, seed=0):
    import torch
    from radiosonde_auto_rx_tpu_torch.demod.fsk import _consts
    from radiosonde_auto_rx_tpu_torch.ops import fsk_sf
    g = torch.Generator(device=dev).manual_seed(seed)
    xw = torch.randn(c, 2, cfg.nmem, generator=g, device=dev)
    sf = torch.rand(c, cfg.ndft, generator=g, device=dev)
    k = _consts(cfg, dev)
    args = (xw, sf, k.wc, k.ws, k.starts, k.weights, k.decay)
    got = fsk_sf.freq_est_sf(*args)
    want = fsk_sf.freq_est_sf_ref(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    ms = _time_ms(lambda: fsk_sf.freq_est_sf(*args))
    call = _time_ms(lambda: fsk_sf.freq_est_sf(*args), ahead=False)
    plain = _time_ms(lambda: fsk_sf.freq_est_sf_ref(*args))
    nf, nd = len(k.starts), cfg.ndft
    # per hop the windowed ndft-point DFT as an FFT (window, FFT), per
    # bin |X| and the weighted hop sum; the EMA
    flops = c * nf * (fft_flops(nd) + 2.0 * nd + 5.0 * nd) + 2.0 * c * nd
    nbytes = 4.0 * (c * 2 * cfg.nmem + 2 * c * nd + 2 * nd * nd + 2 * nf)
    b_ms, b_by = bound(flops, nbytes)
    ok = bool(torch.isfinite(got).all()) and rel <= K1_TOL
    print(f"K1 freq_est_sf {name} C={c} nmem={cfg.nmem} ndft={cfg.ndft} "
          f"hops={cfg.numffts}: max_abs_err={err:.3e} rel={rel:.3e} "
          f"(tol {K1_TOL}) kernel {ms:.4f} ms ({call:.4f} a call at the "
          f"host's pace), twin {plain:.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by})")
    if not ok:
        raise AssertionError(f"K1 {name}: disagrees with its twin")
    return dict(max_abs_err=err, ms=ms, call_ms=call, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_k2(dev, captures, seed=0):
    import torch
    from radiosonde_auto_rx_tpu_torch.detect.psd import _window_on
    from radiosonde_auto_rx_tpu_torch.ops import fft
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(captures, 2, FS_WIDE, generator=g, device=dev)
    nfft, hop = 2048, 8192
    nseg = FS_WIDE // hop
    view = x[:, :, :nseg * hop].reshape(captures, 2, nseg, hop)[..., :nfft]
    win = _window_on(nfft, dev)
    got = fft.fft_abs2(view, win, True)
    want = fft.fft_abs2_ref(view, win, True)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = float(diff.max())
    rel = float((diff / (want.abs() + want.mean(-1, keepdim=True))).max())
    ms = _time_ms(lambda: fft.fft_abs2(view, win, True))
    call = _time_ms(lambda: fft.fft_abs2(view, win, True), ahead=False)
    plain = _time_ms(lambda: fft.fft_abs2_ref(view, win, True))
    # the library call from the same planes and window: complex rows,
    # window, cuFFT, |.|^2, roll
    lib = _time_ms(lambda: torch.roll(torch.fft.fft(
        torch.complex(view[:, 0], view[:, 1]) * win).abs() ** 2,
        nfft // 2, dims=-1))
    rows = captures * nseg
    # per row: window, FFT, |.|^2
    b_ms, b_by = bound(rows * (fft_flops(nfft) + 2.0 * nfft + 3.0 * nfft),
                       4.0 * (rows * 2 * nfft + nfft + rows * nfft))
    ok = bool(torch.isfinite(got).all()) and rel <= K2_TOL
    print(f"K2 fft_abs2 N={nfft} B={rows} (sparse Welch view of "
          f"{captures} capture(s)): max_abs_err={err:.3e} per-bin "
          f"rel={rel:.3e} (tol {K2_TOL}) kernel {ms:.4f} ms ({call:.4f} a "
          f"call at the host's pace), "
          f"twin {plain:.4f} ms, torch.fft {lib:.4f} ms, bound "
          f"{b_ms:.5f} ms ({b_by})")
    if not ok:
        raise AssertionError("K2: disagrees with its twin")
    return dict(max_abs_err=err, ms=ms, call_ms=call, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib)


def check_k2_overlapped(dev, seed=2):
    """K2 on the two interleaved tilings of a half-overlapped Welch PSD
    (``detect/psd.py::_welch`` with hop = nfft/2) of a capture that starts
    3 floats into its buffer, so that no row is 16-byte aligned.  Returns
    the largest absolute error."""
    import torch
    from radiosonde_auto_rx_tpu_torch.detect.psd import _window_on
    from radiosonde_auto_rx_tpu_torch.ops import fft
    g = torch.Generator(device=dev).manual_seed(seed)
    nfft, nk = 2048, 146
    x = torch.randn(2, 2, 3 + (nk + 1) * nfft, generator=g, device=dev)[..., 3:]
    win = _window_on(nfft, dev)
    worst = 0.0
    for off in (0, nfft // 2):
        view = x[:, :, off:off + nk * nfft].reshape(2, 2, nk, nfft)
        if view.data_ptr() % 16 == 0:
            raise AssertionError("the overlapped tiling came out aligned")
        got = fft.fft_abs2(view, win, True)
        want = fft.fft_abs2_ref(view, win, True)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        rel = float((diff / (want.abs() + want.mean(-1, keepdim=True))).max())
        worst = max(worst, float(diff.max()))
        print(f"K2 fft_abs2 N={nfft} B={2 * nk} (overlapped Welch tiling at "
              f"offset {off}, rows from an odd float): "
              f"max_abs_err={float(diff.max()):.3e} per-bin rel={rel:.3e} "
              f"(tol {K2_TOL})")
        if not bool(torch.isfinite(got).all()) or rel > K2_TOL:
            raise AssertionError("K2 (overlapped tiling): disagrees with "
                                 "its twin")
    return worst


def k3_phase(dev):
    """K3 through its entry point ``ops.fft.fft`` at every listed shape
    (counters zeroed just before, read just after), then each output held
    against the twin ``fft_ref`` per bin, and each shape timed beside the
    twin and ``torch.fft.fft``.  Returns (the N = 1024 entry, launches)."""
    import torch
    from radiosonde_auto_rx_tpu_torch import kernels
    from radiosonde_auto_rx_tpu_torch.ops import fft
    g = torch.Generator(device=dev).manual_seed(3)
    cases = []
    for n, b, method, _ in K3_SHAPES:
        x = torch.randn(b, 2, n, generator=g, device=dev)
        win = torch.hann_window(n, periodic=False, device=dev)
        cases.append((n, b, method, x, win))
    kernels.reset_launches()
    outs, per_case = [], []
    for n, b, method, x, win in cases:
        seen = kernels.launches["fft"]
        outs.append(fft.fft(x, win, method))
        per_case.append(kernels.launches["fft"] - seen)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    print(f"phase 2 K3 path (ops.fft.fft at {len(cases)} shapes): "
          f"launches {launches}, by shape {per_case}")
    if per_case != [k for _, _, _, k in K3_SHAPES]:
        raise AssertionError(f"fft launched {per_case} kernels by shape, "
                             f"expected {[k for *_, k in K3_SHAPES]}")
    entry, worst, shapes = None, 0.0, []
    for (n, b, method, x, win), got in zip(cases, outs):
        want = fft.fft_ref(x * win)
        mag = torch.hypot(want[:, 0], want[:, 1])
        rms = mag.pow(2).mean(-1, keepdim=True).sqrt()
        diff = torch.hypot(got[:, 0] - want[:, 0], got[:, 1] - want[:, 1])
        err = float(diff.max())
        rel = float((diff / (mag + rms)).max())
        worst = max(worst, err)
        ms = _time_ms(lambda: fft.fft(x, win, method))
        call = _time_ms(lambda: fft.fft(x, win, method), ahead=False)
        plain = _time_ms(lambda: fft.fft_ref(x, win))
        # the library call from the same planes and window
        lib = _time_ms(lambda: torch.fft.fft(
            torch.complex(x[:, 0], x[:, 1]) * win))
        # per row: window, FFT (the same function for either method)
        b_ms, b_by = bound(b * (fft_flops(n) + 2.0 * n),
                           4.0 * (2 * b * n + n + 2 * b * n))
        print(f"K3 fft N={n} B={b} {method}: max_abs_err={err:.3e} "
              f"per-bin rel={rel:.3e} (tol {K3_TOL}) kernel {ms:.4f} ms "
              f"({call:.4f} a call at the host's pace), twin {plain:.4f} "
              f"ms, torch.fft {lib:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        if not bool(torch.isfinite(got).all()) or rel > K3_TOL:
            raise AssertionError(f"K3 N={n} {method}: disagrees with its "
                                 f"twin")
        times = dict(ms=ms, call_ms=call, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lib)
        shapes.append(dict(n=n, rows=b, method=method, **times))
        if n == 1024:
            entry = times
    return dict(entry, max_abs_err=worst, shapes=shapes), launches["fft"]


def check_detector(dev, stream):
    """The CUDA detector against its CPU path at the detection path's
    shapes: the three sondes' 48 kHz rows of the first 1 s block,
    extracted at their frequencies as the station recenters a candidate,
    through ``StationStep.confirm`` + ``decide_confirmed`` on both
    devices.
    Streams to STREAM_TOL of their peak; peak scores within DET_TOL (the
    normalization's float32 running sums over 48,000 samples cancel, and
    the CUDA scan sums in another order: see detect/correlator.py);
    positions equal except where the CPU row's best two |scores| are
    within DET_TOL; the same decisions."""
    import torch
    from radiosonde_auto_rx_tpu_torch.detect.correlator import _correlate
    from radiosonde_auto_rx_tpu_torch.ops.channelizer import \
        extract_channels
    from radiosonde_auto_rx_tpu_torch.parallel.station_step import \
        StationStep
    wide = split_blocks(stream, FS_WIDE, 1)[0].astype(np.float32) / 32768.0
    freqs = [f for _, _, f, _, _ in sondes_for(N_CHAN, FS_WIDE)]
    cids = np.arange(len(freqs))
    out = []
    for d in (dev, torch.device("cpu")):
        step = StationStep(d, n_chan=N_CHAN, fs_ch=FS_WIDE // N_CHAN)
        rows = extract_channels(wide, FS_WIDE, freqs, N_CHAN, d)
        conf = step.confirm(rows, cids)
        out.append((conf, step.decide_confirmed(conf, cids, 0)))
    (g_conf, g_dec), (c_conf, c_dec) = out
    c_step = step
    s_err = float((g_conf["streams"].cpu() - c_conf["streams"]).abs().max())
    s_ref = float(c_conf["streams"].abs().max())
    v_err = dc_err = 0.0
    n_pos = n_rows = 0
    for ci, (gp, cp) in enumerate(zip(g_conf["peaks"], c_conf["peaks"])):
        gv, gi, gd, gm = (t.cpu() for t in gp)
        cv, cidx, cd, cm = cp
        v_err = max(v_err, float((gv - cv).abs().max()))
        dc_err = max(dc_err, float((gd - cd).abs().max()),
                     float((gm - cm).abs().max()))
        fm = c_conf["streams"][ci]
        _, _, _, bank, lens = c_step.detector.classes[ci]
        corr, xnorm, _ = _correlate(fm, bank, lens)
        top2 = (corr / xnorm).abs().topk(2, dim=-1).values
        tie = (top2[..., 0] - top2[..., 1]) < DET_TOL
        n_pos += int((~tie).sum())
        n_rows += tie.numel()
        if not torch.equal(gi[~tie], cidx[~tie]):
            raise AssertionError(f"detector class {ci}: peak positions "
                                 f"differ between CUDA and CPU")

    def key(dec):
        return {c: [(d.name, d.tn, d.inverted) for d in v]
                for c, v in dec.items()}

    print(f"phase 7 detector CUDA vs CPU (confirm of {len(freqs)} rows of "
          f"48,000 samples): streams max err {s_err:.3e} (tol "
          f"{STREAM_TOL} x {s_ref:.3f}), peak scores max err {v_err:.3e}, "
          f"DC terms max err {dc_err:.3e} (tol {DET_TOL}), peak positions "
          f"equal in {n_pos} of {n_rows} (row, template) pairs (the rest "
          f"tie within {DET_TOL}), decisions {key(g_dec)}")
    if n_pos == 0:
        raise AssertionError("the position check compared no peak")
    if s_err > STREAM_TOL * s_ref or v_err > DET_TOL or \
            dc_err > DET_TOL or key(g_dec) != key(c_dec):
        raise AssertionError("the CUDA detector disagrees with its CPU path")


def check_detections(per_block, types_freqs):
    """After the run, one task per sonde, with its type and within 2 kHz
    of its frequency (its channel)."""
    tasks = per_block[-1][0]
    for typ, f in types_freqs:
        if not any(t == typ and abs(fz - f) < 2e3 for t, fz in tasks):
            raise AssertionError(f"{typ} at {f / 1e6:.4f} MHz not "
                                 f"detected: tasks {tasks}")
    if len(tasks) != len(types_freqs):
        raise AssertionError(f"unexpected tasks {tasks}")


def same_tasks(a, b) -> bool:
    return len(a) == len(b) and all(
        ta == tb and abs(fa - fb) <= 1 for (ta, fa), (tb, fb) in zip(a, b))


# ---------------------------------------------------------------------- #

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from radiosonde_auto_rx_tpu_torch import kernels
    from radiosonde_auto_rx_tpu_torch.station.chains import CHAIN_TABLE, \
        _demod_cfg
    dev = torch.device("cuda", 0)
    if torch.get_float32_matmul_precision() != "highest" or \
            torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 matmuls must run in full float32")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # 1. build
    t0 = time.perf_counter()
    lib = kernels.library_path()
    kernels.library()
    print(f"phase 1 build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    if kernels.build_log.get("ptxas"):
        print(kernels.build_log["ptxas"].strip())

    # 2. kernels against their twins at the main path's shapes
    def cfg_of(name):
        ch = CHAIN_TABLE[name]
        return _demod_cfg(ch.get("resample_to", 48000), ch["rs"],
                          ch.get("est", 10000), ch.get("mask", 0))
    # first the shapes the main path below gives K1 (the two RS41s in
    # one call, the DFM alone), then wider batches and other chains
    k1 = check_k1(dev, "RS41", cfg_of("RS41"), 2)
    for seed, (name, c) in enumerate((("DFM", 1), ("RS41", 16), ("DFM", 16),
                                      ("MTS01", 4), ("M20", 4)), 1):
        k1["max_abs_err"] = max(k1["max_abs_err"], check_k1(
            dev, name, cfg_of(name), c, seed)["max_abs_err"])
    k2, k2_wide = check_k2(dev, 1), check_k2(dev, 10, seed=1)
    k2["shapes"] = [dict(n=2048, rows=rows, **{
        k: v for k, v in res.items() if k != "max_abs_err"})
        for rows, res in ((292, k2), (2920, k2_wide))]
    k2["max_abs_err"] = max(k2["max_abs_err"], k2_wide["max_abs_err"],
                            check_k2_overlapped(dev))
    k3, k3_launches = k3_phase(dev)

    # 3-5. the steady path with manual tasks
    stream = synth_stream(N_CHAN, FS_WIDE, SECONDS)
    runs = [split_blocks(stream, FS_WIDE, 1), split_blocks(stream, FS_WIDE, 2)]
    print(f"phase 3 synth: {SECONDS} s of {FS_WIDE} Hz cs16, cut into "
          f"{[len(r) for r in runs]} blocks")
    results, launches = drive_station(dev, runs, N_CHAN, FS_WIDE)
    for (st, telems, _), types, blocks in zip(
            results, (("RS41",), ("RS41", "DFM")), runs):
        seen = check_telemetry(telems, N_CHAN, FS_WIDE, types)
        print(f"phase 4 station, manual tasks, {len(blocks)} blocks of "
              f"{blocks[0].shape[1] // FS_WIDE} s: frames {seen}, "
              f"stats {st.stats}")
        if st.stats.get("fused_channels", 0) <= 0:
            raise AssertionError("the fused steady path served no channel")
    print(f"phase 4 kernel launches on the manual-task path: {launches}")
    for name in ("freq_est_sf", "fft_abs2"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the main path")
    cpu_results, _ = drive_station(torch.device("cpu"), runs, N_CHAN,
                                   FS_WIDE)
    for (_, telems, _), (_, telems_cpu, _) in zip(results, cpu_results):
        if sorted(map(_key, telems)) != sorted(map(_key, telems_cpu)):
            raise AssertionError("CUDA and CPU stations decoded different "
                                 "telemetry")
    print(f"phase 5 reference: CPU station (plain twins) decoded the same "
          f"{[len(t) for _, t, _ in cpu_results]} frames")
    st, blocks = results[0][0], runs[0]

    # 6. steady block wall time (host clock, each block ends in host
    # decode, which synchronizes with the device)
    times = {True: [], False: []}
    kernels.reset_launches()
    for i in range(12):
        scan_next = (st._steady_tick + 1) % int(st.config["scan_every"]) \
            == 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st.process_captures([blocks[i % len(blocks)]])
        torch.cuda.synchronize()
        times[scan_next].append((time.perf_counter() - t0) * 1e3)
    for scan in (True, False):
        print(f"phase 6 steady block scan={scan}: median "
              f"{statistics.median(times[scan]):.2f} ms over "
              f"{len(times[scan])} blocks ({card})")
    print(f"phase 6 kernel launches over these 12 steady 1 s blocks: "
          f"{dict(kernels.launches)}")

    # 7. detection: the same captures through a station with no task
    check_detector(dev, stream)
    want = [(typ, CENTER + f) for typ, _, f, _, _ in
            sondes_for(N_CHAN, FS_WIDE)]
    d_results, d_launches = drive_station(dev, runs, N_CHAN, FS_WIDE,
                                          manual=False)
    for (st, telems, per_block), types, blocks in zip(
            d_results, (("RS41",), ("RS41", "DFM")), runs):
        check_detections(per_block, want)
        seen = check_telemetry(telems, N_CHAN, FS_WIDE, types)
        print(f"phase 7 station, no task, {len(blocks)} blocks of "
              f"{blocks[0].shape[1] // FS_WIDE} s: detections "
              f"{st.stats['detections']}, tasks {per_block[-1][0]}, "
              f"frames {seen}, stats {st.stats}; block wall ms "
              f"{[round(ms, 2) for _, ms in per_block]} ({card})")
    print(f"phase 7 kernel launches on the detection path: {d_launches}")
    for name in ("freq_est_sf", "fft_abs2"):
        if d_launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the "
                                 f"detection path")
    d_cpu, _ = drive_station(torch.device("cpu"), runs, N_CHAN, FS_WIDE,
                             manual=False)
    for (_, telems, pb), (_, telems_cpu, pb_cpu) in zip(d_results, d_cpu):
        if sorted(map(_key, telems)) != sorted(map(_key, telems_cpu)):
            raise AssertionError("CUDA and CPU detecting stations decoded "
                                 "different telemetry")
        for (tasks, _), (tasks_cpu, _) in zip(pb, pb_cpu):
            if not same_tasks(tasks, tasks_cpu):
                raise AssertionError(f"CUDA and CPU stations detected "
                                     f"differently: {tasks} vs {tasks_cpu}")
    print(f"phase 7 reference: CPU station detected the same tasks block by "
          f"block and decoded the same {[len(t) for _, t, _ in d_cpu]} "
          f"frames")
    # the block that runs confirm, on a new station each time (the first
    # 1 s block: scan, confirm of the three candidates, decode)
    conf_ms = []
    for _ in range(3):
        st = make_station(dev, N_CHAN, FS_WIDE, manual=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st.process_captures([runs[0][0]])
        torch.cuda.synchronize()
        conf_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"phase 7 detection block (scan + confirm + decode, 1 s): "
          f"{[round(v, 2) for v in conf_ms]} ms, median "
          f"{statistics.median(conf_ms):.2f} ms ({card})")

    entries = []
    for name, src, rep, res, n in (
            ("freq_est_sf", "radiosonde_auto_rx_tpu_torch/csrc/fsk_sf.cu",
             "radiosonde_auto_rx_tpu/ops/pallas_fsk.py:84", k1,
             d_launches["freq_est_sf"]),
            ("fft_abs2", "radiosonde_auto_rx_tpu_torch/csrc/fft_abs2.cu",
             "radiosonde_auto_rx_tpu/ops/pallas_fft.py:162", k2,
             d_launches["fft_abs2"]),
            ("fft", "radiosonde_auto_rx_tpu_torch/csrc/fft_planes.cu",
             "radiosonde_auto_rx_tpu/ops/pallas_fft.py:172", k3,
             k3_launches)):
        entries.append(dict(name=name, route="cuda", source=src,
                            replaces=rep, launches=n, **res))
    entries[2]["path"] = "ops.fft.fft"
    print(f"card: {card}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
