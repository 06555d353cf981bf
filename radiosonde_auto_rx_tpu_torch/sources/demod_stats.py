"""Demod statistics tracking: windowed SNR / ppm / frequency estimates.

Equivalent of the reference's fsk_demod stderr-stats consumer (reference
auto_rx/autorx/fsk_demod.py:14-158 `FSKDemodStats`): it keeps a sliding
window over per-block stats and exposes smoothed SNR (peak-hold option),
mean ppm, and the latest tone frequency estimate — the numbers merged
into outgoing telemetry (reference decode.py:1901-1915).

Instead of parsing JSON lines off a pipe, ``update_block`` ingests the
stats dict `fsk_demod_stream` returns (arrays [C, n_blocks]), per
channel.
"""

import numpy as np


class DemodStatsTracker:
    """Sliding-window stats for one demodulated channel."""

    def __init__(self, averaging_time: float = 5.0, peak_hold: bool = False):
        self.averaging_time = float(averaging_time)
        self.peak_hold = peak_hold
        self._times = []
        self._snrs = []
        self._ppms = []
        self.snr = -999.0
        self.fest = [0.0, 0.0]
        self.fest_mean = 0.0
        self.ppm = 0.0

    def update(self, snr_db: float, ppm: float, f_est, t: float):
        """Ingest one block's stats at host time ``t`` seconds."""
        if not np.isfinite(snr_db):
            return
        self._times.append(t)
        self._snrs.append(float(snr_db))
        self._ppms.append(float(ppm))
        f_est = np.atleast_1d(np.asarray(f_est, np.float64))
        self.fest = [float(f) for f in f_est[:2]] if f_est.size >= 2 \
            else [float(f_est[0]), 0.0]
        self.fest_mean = float(np.mean(f_est))

        # trim the window (reference fsk_demod.py:75-87)
        t_min = t - self.averaging_time
        while self._times and self._times[0] < t_min:
            self._times.pop(0)
            self._snrs.pop(0)
            self._ppms.pop(0)

        self.snr = (float(np.max(self._snrs)) if self.peak_hold
                    else float(np.mean(self._snrs)))
        self.ppm = float(np.mean(self._ppms))

    def update_block(self, stats: dict, channel: int, t0: float,
                     block_period: float):
        """Ingest every block of one channel from a `fsk_demod_stream`
        stats dict (arrays [C, n_blocks])."""
        ebno = np.atleast_2d(np.asarray(stats["ebno_db"]))[channel]
        ppm = np.atleast_2d(np.asarray(stats["ppm"]))[channel]
        f_est = np.asarray(stats["f_est"])
        if f_est.ndim == 2:
            f_est = f_est[None]
        for b in range(len(ebno)):
            self.update(float(ebno[b]), float(ppm[b]), f_est[channel, b],
                        t0 + b * block_period)
