"""Generate docs/per_torch.csv: the round-3 PER sweep plus the port's
±20 kHz off-grid points per narrow type (round-4 verdict #7), rows
labelled ``torch``.  The JAX package's docs/per_r5.csv is not written.

For each type, the off-grid points are measured at the SAME Eb/N0 grid
point the PER gate checks (first grid point >= the recorded 50% cliff
+ 0.5 dB): a measured off-grid PER within binomial noise of the
centered recorded PER there demonstrates the recentered extraction
(ops/channelizer.extract_channels) costs < 0.5 dB.  The reference
regression-tests frequency offsets the same way
(reference auto_rx/test/test_demod.py:776 --shift).

Usage:  python -m radiosonde_auto_rx_tpu_torch.tools.per_offgrid \
            [out.csv] [--device cpu]

``--device`` (default ``cuda``): where the port's chain runs; without a
CUDA device the CLI exits 1 unless ``--device cpu`` was asked for.
"""

import argparse
import csv
import os
import sys

# Types measured off-grid: every narrow (48/96 kHz-channel) chain with
# the generic GFSK modulator.  IMET4 (AFSK carrier synth) and the
# L-band wideband chains (MK2LMS, RS92NGP) are excluded: the former
# needs its own modulator at the wide rate, the latter two are tuned
# per-task in both this framework and the reference.
OFFGRID_TYPES = ("RS41", "RS92", "DFM", "M10", "M20", "LMS6", "MEISEI",
                 "MRZ", "IMET54", "MTS01", "RD94RD41", "WXR301",
                 "WXRPN9")
OFFSETS = (20e3, -20e3)
SEEDS = (11, 12, 13)
N_FRAMES = 100

DOCS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "docs")


def _cliff(curve):
    for (e0, p0), (e1, p1) in zip(curve, curve[1:]):
        if p0 >= 0.5 >= p1:
            return e0 if p0 == p1 else e0 + (p0 - 0.5) / (p0 - p1) * \
                (e1 - e0)
    return None


def gate_point(rows, sonde_type):
    """The Eb/N0 grid point the PER gate checks for this type, on the
    recorded ``tpu`` rows given (the JAX gate reads the centered ones:
    pass only those)."""
    curve = sorted((float(r["ebno_db"]), float(r["per"]))
                   for r in rows
                   if r["type"] == sonde_type and r["chain"] == "tpu")
    grid = [e for e, _ in curve]
    c = _cliff(curve)
    if c is None:
        return grid[0]
    return min((e for e in grid if e >= c + 0.5), default=grid[-1])


def main(out_path=None, device="cuda"):
    from radiosonde_auto_rx_tpu_torch.tools.per_harness import run_point
    src = os.path.join(DOCS, "per_r3.csv")
    out_path = out_path or os.path.join(DOCS, "per_torch.csv")
    with open(src) as f:
        base = list(csv.DictReader(f))
    for r in base:
        r.setdefault("f_off", "0")
    new_rows = []
    for t in OFFGRID_TYPES:
        e_gate = gate_point(base, t)
        for f_off in OFFSETS:
            per_sum, n = 0.0, 0
            for seed in SEEDS:
                row = run_point(t, e_gate, n_frames=N_FRAMES, seed=seed,
                                f_off=f_off, device=device)[0]
                per_sum += row["per"] * row["frames_tx"]
                n += row["frames_tx"]
            agg = dict(type=t, chain="torch", ebno_db=e_gate,
                       frames_tx=n, frames_rx=round(n - per_sum),
                       per=round(per_sum / n, 4), runtime_s="",
                       f_off=int(f_off))
            new_rows.append(agg)
            print(f"{t} @ {e_gate:.1f} dB, {f_off/1e3:+.0f} kHz: "
                  f"PER {agg['per']:.3f} ({n} frames)", flush=True)
    cols = ["type", "chain", "ebno_db", "frames_tx", "frames_rx",
            "per", "runtime_s", "f_off"]
    with open(out_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        for r in base + new_rows:
            w.writerow({k: r.get(k, "") for k in cols})
    print("wrote", out_path)


def _cli(argv=None):
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("output", nargs="?", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device the demod runs on (default cuda)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("per_offgrid: no CUDA device (pass --device cpu to run on "
              "the CPU)", file=sys.stderr)
        return 1
    main(args.output, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(_cli())
