"""Refine PER cliff points with more frames (round-3 verdict item #4).

The round-2 sweep (docs/per_r2.csv) measured every (type, chain, Eb/N0)
point with 100 frames — enough for the flat regions but statistically
thin on the cliff, where the reference's own ground truth uses 100-240
packets per file with multiple files per point
(reference auto_rx/test/README.md:75-83).

This tool reads a base sweep CSV, finds each (type, chain)'s cliff
window (points with 0.1 < PER < 0.9, widened by one grid step on each
side), re-measures those points with ``--seeds`` independent seeds x
``--frames`` frames each (default 3 x 100 = 300 frames/point; each seed
draws fresh payloads AND fresh noise), and writes a merged CSV where the
refined rows replace the originals.  Flat rows are carried over
unchanged.  The per-type 50% cliff derived from the merged CSV is the
reference for the regression gate (tests/test_per_gate.py).

The port re-measures its own chains (``torch`` and ``ref``) and carries
the JAX package's recorded ``tpu`` rows over unchanged.  Sweep with
``per_harness -o docs/per_torch_sweep.csv``, then:

    python -m radiosonde_auto_rx_tpu_torch.tools.per_refine [--device cpu]

``--device`` (default ``cuda``) is where each worker's demod runs; without
a CUDA device the CLI exits 1 unless ``--device cpu`` was asked for.
The JAX package's docs/per_r*.csv files are never written.
"""

import argparse
import collections
import csv
import os
import sys


def read_sweep(path):
    rows = []
    with open(path) as f:
        for r in csv.DictReader(f):
            rows.append(dict(type=r["type"], chain=r["chain"],
                             ebno_db=float(r["ebno_db"]),
                             frames_tx=int(r["frames_tx"]),
                             frames_rx=int(r["frames_rx"]),
                             per=float(r["per"]),
                             runtime_s=float(r["runtime_s"])))
    return rows


def cliff_windows(rows, lo=0.1, hi=0.9):
    """(type, chain) -> sorted ebno list to refine: cliff points widened
    one grid step each side."""
    groups = collections.defaultdict(list)
    for r in rows:
        groups[(r["type"], r["chain"])].append(r)
    out = {}
    for key, g in groups.items():
        g.sort(key=lambda r: r["ebno_db"])
        ebnos = [r["ebno_db"] for r in g]
        idx = {i for i, r in enumerate(g) if lo < r["per"] < hi}
        for i in sorted(idx):
            idx |= {max(0, i - 1), min(len(g) - 1, i + 1)}
        if not idx:
            # cliff fell between grid points (PER jumps 1 -> 0): refine
            # around the jump itself
            for i in range(1, len(g)):
                if g[i - 1]["per"] >= hi and g[i]["per"] <= lo:
                    idx |= {i - 1, i}
        out[key] = sorted(ebnos[i] for i in idx)
    return out


def cliff_50(rows, sonde_type, chain="torch"):
    """Interpolated Eb/N0 of the 50% PER crossing for one type/chain."""
    g = sorted((r for r in rows
                if r["type"] == sonde_type and r["chain"] == chain),
               key=lambda r: r["ebno_db"])
    for a, b in zip(g, g[1:]):
        if a["per"] >= 0.5 >= b["per"]:
            if a["per"] == b["per"]:
                return a["ebno_db"]
            f = (a["per"] - 0.5) / (a["per"] - b["per"])
            return a["ebno_db"] + f * (b["ebno_db"] - a["ebno_db"])
    return None


def _measure(args):
    """Worker: one (type, chain, ebno) refined over several seeds."""
    sonde_type, chain, ebno, frames, seeds, device = args
    from radiosonde_auto_rx_tpu_torch.tools.per_harness import run_point
    tx = rx = 0
    rt = 0.0
    for seed in range(seeds):
        rows = run_point(sonde_type, ebno, frames, seed, (chain,),
                         device=device)
        for r in rows:
            tx += r["frames_tx"]
            rx += r["frames_rx"]
            rt += r["runtime_s"]
    return dict(type=sonde_type, chain=chain, ebno_db=ebno,
                frames_tx=tx, frames_rx=rx,
                per=round(1.0 - rx / max(tx, 1), 4),
                runtime_s=round(rt, 3))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", default="docs/per_torch_sweep.csv")
    ap.add_argument("-o", "--output",
                    default="docs/per_torch_refined.csv")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--types", default=None,
                    help="comma list; default = every type in the base")
    ap.add_argument("--device", default="cuda",
                    help="torch device the demod runs on (default cuda)")
    args = ap.parse_args(argv)
    import torch
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("per_refine: no CUDA device (pass --device cpu to run on "
              "the CPU)", file=sys.stderr)
        return 1

    rows = read_sweep(args.base)
    windows = cliff_windows(rows)
    only = set(args.types.split(",")) if args.types else None
    tasks = [(t, c, e, args.frames, args.seeds, args.device)
             for (t, c), ebnos in sorted(windows.items())
             if c in ("torch", "ref") and (only is None or t in only)
             for e in ebnos]
    print(f"refining {len(tasks)} cliff points "
          f"({args.seeds}x{args.frames} frames each)", flush=True)

    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    refined = {}
    with ctx.Pool(args.jobs) as pool:
        for r in pool.imap_unordered(_measure, tasks):
            refined[(r["type"], r["chain"], r["ebno_db"])] = r
            print("%(type)s,%(chain)s,%(ebno_db).1f,%(frames_tx)d,"
                  "%(frames_rx)d,%(per).4f,%(runtime_s).3f" % r,
                  flush=True)

    merged = [refined.get((r["type"], r["chain"], r["ebno_db"]), r)
              for r in rows]
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "w") as f:
        w = csv.DictWriter(f, fieldnames=["type", "chain", "ebno_db",
                                          "frames_tx", "frames_rx",
                                          "per", "runtime_s"])
        w.writeheader()
        for r in sorted(merged, key=lambda r: (r["type"], r["chain"],
                                               r["ebno_db"])):
            w.writerow(r)
    # cliff summary: torch-vs-ref per type from the merged data
    types = sorted({r["type"] for r in merged})
    print("type,cliff_torch_db,cliff_ref_db,delta_db", flush=True)
    for t in types:
        ct = cliff_50(merged, t, "torch")
        cr = cliff_50(merged, t, "ref")
        d = (ct - cr) if (ct is not None and cr is not None) else None
        print(f"{t},{ct},{cr},{d}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
