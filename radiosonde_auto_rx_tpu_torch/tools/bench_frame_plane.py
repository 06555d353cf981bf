"""Host frame-plane throughput bench: frames/s and real-time-channel
equivalents through the FramePlane decoder pool.

The demod's channel count is only usable if the host can turn the
demodulated bit streams into
telemetry at least as fast as they arrive.  This bench measures that
side: it synthesizes clean on-air bit streams with the PER harness's
frame generators (tools/per_harness.py CASES), then pushes C channels
of them through ``FramePlane`` at several worker counts and reports

* decoded bits/s of wall-clock throughput, and
* the equivalent number of *real-time* channels
  (= throughput / baud-rate — one channel produces ``rs`` bits/s),

per sonde type.  The reference's equivalent "frame plane" is one whole
decoder subprocess per active sonde (reference auto_rx/autorx/decode.py
:1489-1600), i.e. its capacity is ~ncpu sondes; the pool should beat
that by a wide margin and, per VERDICT round 1 #6, must keep the host
side ahead of the demod's real-time channel count.

CLI::

    python -m radiosonde_auto_rx_tpu_torch.tools.bench_frame_plane \
        --types RS41,DFM,M10 --channels 32 --rounds 3 --workers 0,3

Prints one JSON line per (type, workers) combination.
"""

import argparse
import json
import sys
import time

import numpy as np

from radiosonde_auto_rx_tpu_torch.station.frame_plane import FramePlane
from radiosonde_auto_rx_tpu_torch.tools import per_harness

# frame-plane model name + constructor kwargs per harness type
_MODEL = {"RS41": ("RS41", {}), "DFM": ("DFM", {}), "M10": ("M10", {}),
          "LMS6": ("LMS6", {}), "MEISEI": ("MEISEI", {}),
          "MRZ": ("MRZ", {}), "IMET54": ("IMET5", {})}


def bench_type(sonde_type, channels, rounds, workers, n_frames=20,
               seed=0):
    if sonde_type not in _MODEL:
        raise SystemExit(
            f"unsupported type {sonde_type!r}: this bench covers "
            f"{sorted(_MODEL)} (types whose decoder consumes the raw "
            f"PER-harness bit stream directly)")
    rng = np.random.default_rng(seed)
    case = per_harness.CASES[sonde_type](n_frames, rng, None)
    bits = np.asarray(case.tx_bits, np.uint8)
    model_name, kwargs = _MODEL[sonde_type]
    plane = FramePlane(workers)
    try:
        # warmup: builds per-frequency decoder state in every worker
        for c in range(channels):
            plane.decode(1000 + c, sonde_type, model_name, kwargs, bits,
                         None)
        warm = plane.gather()
        decoded = sum(len(v) for v in warm.values())
        t0 = time.perf_counter()
        for _ in range(rounds):
            for c in range(channels):
                plane.decode(1000 + c, sonde_type, model_name, kwargs, bits,
                             None)
            plane.gather()
        dt = time.perf_counter() - t0
    finally:
        plane.close()
    n_bits = rounds * channels * len(bits)
    bps = n_bits / dt
    return {
        "type": sonde_type, "workers": workers,
        "frames_per_stream": decoded // max(channels, 1),
        "bits_per_s": round(bps),
        "rt_channels": round(bps / case.rs, 1),
        "wall_s": round(dt, 3),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--types", default="RS41,DFM,M10")
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--workers", default="0,3",
                    help="comma list of pool sizes (0 = inline)")
    args = ap.parse_args(argv)
    for t in args.types.split(","):
        for w in (int(v) for v in args.workers.split(",")):
            res = bench_type(t, args.channels, args.rounds, w,
                             n_frames=args.frames)
            print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
