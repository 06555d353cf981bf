"""Plot port-vs-reference PER overlay curves from a per_harness CSV.

The reference tracks decode sensitivity as PER-vs-Eb/N0 plots
(reference auto_rx/test/plot_per.py, test/calc_per.py); this is the
equivalent over a sweep of the port (``torch`` rows, default
``docs/per_torch_sweep.csv``): one small-multiple panel per sonde
type, both chains overlaid on identical noisy streams.

CLI::

    python -m radiosonde_auto_rx_tpu_torch.tools.plot_per \
        docs/per_torch_sweep.csv -o docs/per_torch.png
"""

import argparse
import collections
import csv
import sys

# categorical slots 1 (blue) and 2 (orange): the dataviz default
# palette's leading adjacent pair (documented CVD-safe: adjacent
# dE 9.1, normal-vision 19.6 on the light surface)
C_TPU = "#2a78d6"
C_REF = "#eb6834"
INK = "#333333"
GRID = "#e3e3e0"


def load(path):
    data = collections.defaultdict(dict)
    for r in csv.DictReader(open(path)):
        if r["type"].startswith("#"):
            continue
        data[(r["type"], r["chain"])][float(r["ebno_db"])] = \
            float(r["per"])
    return data


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("csv", nargs="?", default="docs/per_torch_sweep.csv")
    ap.add_argument("-o", "--output", default="docs/per_torch.png")
    args = ap.parse_args(argv)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable", file=sys.stderr)
        return 1

    data = load(args.csv)
    types = sorted({t for t, _ in data})
    ncol = 4
    nrow = -(-len(types) // ncol)
    fig, axes = plt.subplots(nrow, ncol, figsize=(3.4 * ncol, 2.6 * nrow),
                             sharey=True)
    axes = axes.ravel()
    for ax in axes[len(types):]:
        ax.set_visible(False)
    for ax, typ in zip(axes, types):
        for chain, color in (("torch", C_TPU), ("ref", C_REF)):
            d = data.get((typ, chain))
            if not d:
                continue
            xs = sorted(d)
            ax.plot(xs, [d[x] for x in xs], color=color, linewidth=1.8,
                    label={"torch": "this port",
                           "ref": "reference chain"}[chain])
        ax.set_title(typ, fontsize=10, color=INK)
        ax.set_ylim(-0.04, 1.04)
        ax.grid(True, color=GRID, linewidth=0.7)
        ax.tick_params(labelsize=8, colors=INK)
        for side in ("top", "right"):
            ax.spines[side].set_visible(False)
        for side in ("left", "bottom"):
            ax.spines[side].set_color(GRID)
    fig.supxlabel("Eb/N0 (dB)", fontsize=10, color=INK)
    fig.supylabel("packet error rate", fontsize=10, color=INK)
    handles, labels = axes[0].get_legend_handles_labels()
    fig.legend(handles, labels, loc="upper center", ncol=2, frameon=False,
               fontsize=10, bbox_to_anchor=(0.5, 1.0))
    fig.suptitle("PER vs Eb/N0 — identical noisy streams through both "
                 "chains", fontsize=11, color=INK, y=1.03)
    fig.tight_layout(rect=(0, 0, 1, 0.98))
    fig.savefig(args.output, dpi=130, bbox_inches="tight",
                facecolor="white")
    print(args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
