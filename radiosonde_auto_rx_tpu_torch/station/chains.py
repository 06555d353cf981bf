"""Per-type demod chains and station policy constants.

Copied from ``radiosonde_auto_rx_tpu/station/station.py`` (lines 31-120),
whose module imports JAX; ``_demod_cfg`` builds the port's own
``FSKConfig``.  The port keeps its own copy of such policy.
"""

import numpy as np

from radiosonde_auto_rx_tpu_torch.demod.fsk import FSKConfig
from radiosonde_auto_rx_tpu_torch.models.imet4 import afsk_demod_config

# Offsets below this demodulate fine at the channel center (every narrow
# chain's estimator window is >= +-5 kHz); above it the candidate is
# re-extracted from the wideband block recentered on its scan peak.
RECENTER_MIN_HZ = 1000.0
# Spectral-width gate for wideband candidates (Weathex tones at ±25 kHz):
# a floor-subtracted RMS width above this over ±WIDE_SCAN_WIN_HZ sends
# the candidate to the 96 kHz wide-scan detector.
WIDE_WIDTH_HZ = 12e3
WIDE_SCAN_WIN_HZ = 35e3
WIDE_SCAN_FS = 96000
# Demod-tracked drift below this is noise (the tone estimator's DFT bin
# is 375-750 Hz for the narrow chains); above it the task frequency
# follows the sonde.
DRIFT_MIN_HZ = 500.0


def _demod_cfg(fs: int, rs: int, est: int = 10000, mask: int = 0):
    p = 5
    ts = fs // rs
    while ts % p and p > 1:
        p -= 1
    nsym = max(50, min(300, 4800 * 300 // rs))
    while (fs // rs) * nsym < 2 ** int(np.ceil(np.log2(fs / (0.1 * rs)))):
        nsym *= 2
    return FSKConfig(fs=fs, rs=rs, m=2, p=p, nsym=nsym,
                     est_min=-est, est_max=est,
                     tone_spacing=mask, freq_est_type=1 if mask else 0)


# Per-type demod chain parameters: raw symbol rate on the 48 kHz channel
# and soft-bit polarity for the decoder, following the reference's
# experimental fsk_demod chains (reference auto_rx/autorx/decode.py
# :846-1476).  Types whose raw rate does not divide the channel rate use
# the nearest divisor (the demod's nin clock tracking absorbs the ppm).
CHAIN_TABLE = {
    "RS41": dict(rs=4800, mask=5000, est=5000),
    # RS92's Manchester stream has a strong 2.4 kHz line comb; the mask
    # (tone-pair) estimator is required to lock the true FSK tones
    "RS92": dict(rs=4800, est=5000, mask=4800),
    # DFM: 2500 Bd raw Manchester — resample the 48 kHz channel to
    # 50 kHz so Ts = 20 exactly
    "DFM": dict(rs=2500, est=5000, resample_to=50000),
    # M10 runs at 9615.4 Bd: resample the 48 kHz channel to 48.08 kHz so
    # Ts = 5 exactly.  M20 is 9600 Bd, which divides 48 kHz exactly.
    "M10": dict(rs=9616, est=10000, resample_to=48080),
    "M20": dict(rs=9600, est=10000),
    "LMS6": dict(rs=4800, est=10000),
    "IMET5": dict(rs=4800, est=5000, mask=5000),
    "MEISEI": dict(rs=2400, est=10000),
    "MRZ": dict(rs=4800, est=10000),
    "MTS01": dict(rs=1200, est=5000),
    # iMet-1/4: Bell-202 AFSK rides on the FM audio — discriminate first,
    # then FSK-demod the audio tones (``demod_chain``)
    "IMET4": dict(afsk=True),
    "IMET1RS": dict(afsk=True),
    "IMET1AB": dict(afsk=True),
    # Weathex: 50 kHz tone spacing on a 96 kHz channel, extracted per
    # task from the wideband block (``Station.decode_channels``)
    "WXR301": dict(rs=4800, est=55000, mask=50000, wide_fs=96000),
    "WXRPN9": dict(rs=5000, est=55000, mask=50000, wide_fs=96000,
                   resample_to=100000),
    "RD94RD41": dict(rs=4800, est=20000),   # ref decode.py:995
    # L-band chains on 240 kHz channels (the station's wide profile above
    # 1 GHz): MK2LMS resampled 601/600 so Ts = 25; RS92-NGP's wider
    # deviation (~20 kHz tone spacing)
    "MK2LMS": dict(rs=9616, est=110000, mask=100000, resample_to=240400),
    "RS92NGP": dict(rs=4800, est=32000, mask=20000, wide_fs=240000),
}

# detector type name -> models registry name
MODEL_NAME = {"RD94RD41": "DROPSONDE", "IMET4": "IMET", "IMET1RS": "IMET",
              "IMET1AB": "IMET", "RS92NGP": "RS92"}


def demod_chain(name: str, fs_ch: int):
    """(cfg, resample_to, afsk) demod chain of a type on an ``fs_ch``
    channel, built as the reference's ``StationStep._chain_for``
    (``radiosonde_auto_rx_tpu/parallel/station_step.py:614-636``): the
    AFSK chains demodulate the FM audio at the channel rate."""
    chain = CHAIN_TABLE[name]
    if chain.get("afsk"):
        return afsk_demod_config(fs_ch), None, True
    rs_to = chain.get("resample_to")
    cfg = _demod_cfg(rs_to or fs_ch, chain["rs"], chain.get("est", 10000),
                     chain.get("mask", 0))
    return cfg, rs_to, False


# ROADMAP.md items that port what the slices so far leave out
TODO_SPLIT = "a mesh over several devices: expert routing (route_demod, " \
    "_decode_routed; ROADMAP.md queue 1 item 6: multi-device)"
