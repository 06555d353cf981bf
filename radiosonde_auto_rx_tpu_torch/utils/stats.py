"""Station statistics from per-sonde logs: radio horizon + normalized SNR.

Re-implementation of the reference's log analytics
(reference auto_rx/autorx/stats.py:38-160, auto_rx/utils/receiver_stats.py):
the data computation is separated from plotting so it is testable headless;
``plot_*`` helpers require matplotlib and are gated on its availability.

CLI (mirrors ``python3 -m autorx.stats``):
    python -m radiosonde_auto_rx_tpu_torch.utils.stats --horizon [--snrmap]
"""

import glob
import logging
import math
import os

import numpy as np

from radiosonde_auto_rx_tpu_torch.utils.geometry import position_info
from radiosonde_auto_rx_tpu_torch.web.log_files import read_log_file

log = logging.getLogger("stats")


def collect_last_positions(log_directory, station, min_range_km=10,
                           max_range_km=1000):
    """Last observed position of every sonde in the log directory ->
    list of dicts(bearing, elevation, range_km, serial)
    (reference stats.py radio_horizon_plot :38-75)."""
    out = []
    for fname in sorted(glob.glob(os.path.join(log_directory,
                                               "*_sonde.log"))):
        try:
            data = read_log_file(fname)
        except (OSError, ValueError):
            continue
        if not data["lat"]:
            continue
        balloon = (data["lat"][-1], data["lon"][-1], data["alt"][-1])
        info = position_info(station, balloon)
        rng_km = info["straight_distance"] / 1000.0
        if not (min_range_km < rng_km < max_range_km):
            continue
        out.append(dict(bearing=info["bearing"],
                        elevation=info["elevation"],
                        range_km=rng_km,
                        serial=data.get("serial")))
    return out


def snr_map(log_directory, station, min_range_km=10, max_range_km=1000,
            normalise=True, norm_range_km=50, mode="mean",
            min_snr=5.0, max_snr=40.0):
    """[360 bearing, 90 elevation] SNR map, range-normalized to
    ``norm_range_km`` via +20*log10(r/r0) (reference stats.py
    normalised_snr :77-160).  Cells with no data hold -100."""
    grid = np.full((360, 90), -100.0)
    counts = np.zeros((360, 90), np.int64)
    for fname in sorted(glob.glob(os.path.join(log_directory,
                                               "*_sonde.log"))):
        try:
            data = read_log_file(fname)
        except (OSError, ValueError):
            continue
        snrs = data.get("snr") or []
        for i, snr in enumerate(snrs):
            if snr is None or not (min_snr < snr < max_snr):
                continue
            balloon = (data["lat"][i], data["lon"][i], data["alt"][i])
            info = position_info(station, balloon)
            rng_km = info["straight_distance"] / 1000.0
            if not (min_range_km < rng_km < max_range_km):
                continue
            b = int(math.floor(info["bearing"])) % 360
            e = min(89, max(0, int(math.floor(info["elevation"]))))
            if normalise:
                snr = snr + 20.0 * np.log10(rng_km / norm_range_km)
            if counts[b, e] == 0:
                grid[b, e] = snr
            elif mode == "mean":
                grid[b, e] = (grid[b, e] * counts[b, e] + snr) / \
                    (counts[b, e] + 1)
            elif mode == "max":
                grid[b, e] = max(grid[b, e], snr)
            counts[b, e] += 1
    return grid, counts


def horizon_profile(positions, bin_deg=5):
    """Per-bearing-bin minimum observed elevation — the effective radio
    horizon silhouette used by the receiver_stats utility."""
    nbins = 360 // bin_deg
    prof = np.full(nbins, np.nan)
    for p in positions:
        b = int(p["bearing"] // bin_deg) % nbins
        e = p["elevation"]
        if np.isnan(prof[b]) or e < prof[b]:
            prof[b] = e
    return prof


def _plt():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError:
        log.error("matplotlib not available — cannot plot")
        return None


def plot_radio_horizon(positions, title="Radio Horizon", save_figure=None):
    plt = _plt()
    if plt is None:
        return None
    plt.figure(figsize=(12, 4))
    plt.scatter([p["bearing"] for p in positions],
                [p["elevation"] for p in positions],
                c=[p["range_km"] for p in positions])
    plt.colorbar(label="Range (km)")
    plt.title(title)
    plt.xlabel("Bearing (degrees True)")
    plt.ylabel("Elevation (degrees)")
    plt.ylim(-1.5, 10)
    plt.xlim(0, 360)
    plt.grid()
    if save_figure:
        plt.savefig(save_figure)
    return plt


def plot_snr_map(grid, title="SNR Map", normalise=True, save_figure=None):
    plt = _plt()
    if plt is None:
        return None
    plt.figure(figsize=(12, 6))
    plt.imshow(np.flipud(grid.T), vmin=0, vmax=40, extent=[0, 360, 0, 90])
    plt.xlabel("Bearing (degrees true)")
    plt.ylabel("Elevation (degrees)")
    plt.title(title)
    plt.colorbar(label="Normalised SNR (dB)" if normalise else "SNR (dB)",
                 shrink=0.5)
    if save_figure:
        plt.savefig(save_figure)
    return plt


def main(argv=None):
    import argparse
    from radiosonde_auto_rx_tpu_torch.station.config import read_auto_rx_config
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", default=None)
    ap.add_argument("-l", "--log", default="./log/")
    ap.add_argument("--horizon", action="store_true")
    ap.add_argument("--snrmap", action="store_true")
    ap.add_argument("-o", "--output", default=None,
                    help="save figure to this path instead of showing")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = read_auto_rx_config(args.config)
    station = (cfg["station_lat"], cfg["station_lon"], cfg["station_alt"])
    code = cfg.get("station_code", "SONDE")
    if args.horizon:
        pos = collect_last_positions(args.log, station)
        log.info("found %d datapoints for radio horizon", len(pos))
        plt = plot_radio_horizon(pos, title=f"{code} Radio Horizon",
                                 save_figure=args.output)
        if plt and not args.output:
            plt.show()
    if args.snrmap:
        grid, counts = snr_map(args.log, station)
        log.info("SNR map holds %d observations", int(counts.sum()))
        plt = plot_snr_map(grid, title=f"{code} SNR Map",
                           save_figure=args.output)
        if plt and not args.output:
            plt.show()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
