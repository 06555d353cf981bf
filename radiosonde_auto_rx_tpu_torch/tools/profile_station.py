"""Per-stage timing of the station step at bench geometry.

Port of ``radiosonde_auto_rx_tpu/tools/profile_station.py``.

Usage: ``python -m radiosonde_auto_rx_tpu_torch.tools.profile_station
[--device cpu]``

Times each device stage of the production dataflow in isolation, at the
reference tool's geometry (``B`` captures of ``T_WIDE`` samples, 50
channels): channelize, the sparse Welch PSD (one window per 4·nfft; K2),
the detector's half-rate prescreen scores on the duty cycle's channels,
the full detection pass on ``CAP`` channels (conditioning, then the exact
correlation peak search per template class) and the buffered FSK demod
of every channel (one launch of the scan kernel ``fsk_scan``).

``--device`` (default ``cuda``): on a CUDA device each stage is timed
with CUDA events around ``REPS`` calls queued behind a device spin, so
that the events bracket device time and not the host's pace (best of
``TRIALS``); a stage that waits on the host inside (a blocking copy)
cannot be queued ahead and reads the profiler's sum of its device
activities instead ("device busy").  Without a CUDA device the tool
exits 1 unless ``--device cpu`` was asked for, and on the CPU it reads
the host clock.
"""

import argparse
import sys
import time

import torch

from radiosonde_auto_rx_tpu_torch import kernels
from radiosonde_auto_rx_tpu_torch.demod.fsk import FSKConfig, fsk_demod_stream
from radiosonde_auto_rx_tpu_torch.detect.correlator import \
    _correlate_peaks_exact
from radiosonde_auto_rx_tpu_torch.detect.psd import _welch
from radiosonde_auto_rx_tpu_torch.detect.scanner import SondeDetector
from radiosonde_auto_rx_tpu_torch.ops.channelizer import (_channelize,
                                                          pfb_prototype)

N_CHAN = 50
B = 10                      # captures per step
T_WIDE = 2_400_000          # 1 s per capture
DUTY = 0.2                  # detector duty cycle
CAP = 16                    # full-pass survivors (two-phase detect)
REPS = 20
TRIALS = 3


def device_ms(fn, reps: int = REPS, ahead: bool = True) -> float:
    """Mean ms of ``fn`` between two CUDA events around ``reps`` calls,
    after 3 warm-ups.  ``ahead``: the device first spins
    (``torch.cuda._sleep``, ~6 ms at first), so the host has queued every
    call before the first one starts and the events bracket device time
    alone.  That is checked: if the spin had ended by the time the last
    call was queued, the timing is taken again behind a spin four times
    as long, and a host that never gets ahead is an error.  Without
    ``ahead`` a call shorter than its wrapper's Python is timed at the
    host's pace (the launch gap)."""
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


def device_events(prof):
    """The device activities (kernels, copies, fills) of a profile."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_busy_ms(fn, reps: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after a warm-up: the
    sum of its device activities' spans under torch.profiler (one stream,
    so they do not overlap)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.time_range.elapsed_us() for e in device_events(prof))
    if not busy:
        raise RuntimeError("the profiler saw no device time")
    return busy / 1e3 / reps


def _host_ms(fn) -> float:
    fn()
    best = float("inf")
    for _ in range(TRIALS):
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        best = min(best, (time.perf_counter() - t0) / REPS * 1e3)
    return best


def _stage(name, fn, samples, device, out):
    """Time one stage; record its ms (and the clock that read them),
    Msps-wide, the device its result lies on and the port kernels one
    call launches."""
    cuda = device.type == "cuda"
    kernels.reset_launches()
    res = fn()
    if cuda:
        torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.launches.items() if v}
    if not cuda:
        ms, clock = _host_ms(fn), "host (cpu)"
    else:
        try:
            ms, clock = min(device_ms(fn) for _ in range(TRIALS)), "device"
        except RuntimeError:
            # the stage waits on the host inside (a blocking copy), so
            # it cannot be queued ahead: the profiler's sum of its device
            # activities instead
            ms, clock = device_busy_ms(fn, REPS), "device busy"
    out[name] = dict(ms=ms, msps=samples / ms / 1e3, clock=clock,
                     device=str(res.device), launches=launches)
    print(f"{name:28s} {ms:9.3f} ms {clock:11s} "
          f"{samples / ms / 1e3:9.1f} Msps-wide   launches {launches}",
          flush=True)


def stages(device, wide) -> list:
    """The stages as [(name, fn)] over ``wide`` [B, 2, T] float32 planes
    on ``device``: each ``fn()`` runs its stage once and returns its
    result (a tensor on ``device``)."""
    cfg = FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=300,
                    est_min=-5000, est_max=5000,
                    tone_spacing=5000, freq_est_type=1)
    taps = torch.from_numpy(pfb_prototype(N_CHAN)).to(device)
    det = SondeDetector(48000, device=device)
    n_det = max(1, int(wide.shape[0] * N_CHAN * DUTY))
    chf = _channelize(wide, taps, N_CHAN)
    chf = chf.reshape(-1, 2, chf.shape[-1]).contiguous()

    def full_pass():
        acc = torch.zeros((), device=device)
        for fm, (_, _, _, bank, lens) in zip(det._condition(chf[:CAP]),
                                             det.classes):
            val, ipk, dcpk, xm = _correlate_peaks_exact(fm, bank, lens)
            acc = acc + val.max() + xm.sum()
        return acc

    return [
        ("channelize", lambda: _channelize(wide, taps, N_CHAN)),
        ("welch_psd hop=4*nfft", lambda: _welch(wide, 2048, 8192)),
        ("det_prescreen (duty chans)",
         lambda: det.prescreen.scores(chf[:n_det])),
        (f"det_full_pass ({CAP} ch)", full_pass),
        ("fsk_demod(all channels)",
         lambda: fsk_demod_stream(cfg, chf, device)[0]),
    ]


def profile(device, wide=None) -> dict:
    """Every stage on ``device`` over ``wide`` (default: ``B`` captures
    of ``T_WIDE`` seeded Gaussian samples).  Returns {stage: dict(ms,
    msps, device, launches)}."""
    device = torch.device(device)
    if wide is None:
        gen = torch.Generator(device=device).manual_seed(1)
        wide = torch.randn((B, 2, T_WIDE), generator=gen, device=device)
    samples = wide.shape[0] * wide.shape[-1]
    out = {}
    for name, fn in stages(device, wide):
        _stage(name, fn, samples, device, out)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device the stages run on (default cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("profile_station: no CUDA device (pass --device cpu to run "
              "on the CPU)", file=sys.stderr)
        return 1
    profile(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
