"""Comparative PER-vs-Eb/N0 harness: the port's chain vs the reference C
chain.

The reference's ground truth is *decoded packet counts versus calibrated
Eb/N0* (reference auto_rx/test/generate_lowsnr.py: AWGN calibrated per
baud rate, 5-20 dB in 0.5 dB steps; test_demod.py:751-828: chain ->
packet count CSV).  This module is that harness with two upgrades the
round-1 version lacked:

* **Exact TX/RX accounting.**  Every transmitted frame carries a unique
  identity (its ``frame`` field — all five decoders, ours and the
  reference's, emit it), and PER counts ``|tx_ids - rx_ids|`` instead of
  unique-telemetry-count heuristics.  A fixed number of *warmup* frames
  precedes the counted window (demod convergence, DFM serial-number
  confirmation, RS92 cal assembly) and is excluded from both sides.

* **A reference overlay on the identical stream.**  When the reference
  tree and a C compiler are available (tests/oracle.py builds the
  binaries out-of-tree in /tmp), the *same* noisy IQ is written as CS16
  and piped through ``fsk_demod | <decoder>`` with the production flags
  from reference auto_rx/autorx/decode.py, giving a port-vs-reference PER
  overlay per Eb/N0 point.

CLI::

    python -m radiosonde_auto_rx_tpu_torch.tools.per_harness \
        --type RS41 --ebno 5:20:0.5 --frames 100 -o results.csv

Output CSV: ``type,chain,ebno_db,frames_tx,frames_rx,per,runtime_s``
with ``chain`` in {torch, ref}: the port's rows are labelled ``torch``, so
that they and the JAX package's recorded ``tpu`` rows can share one CSV.
``--device`` (default ``cuda``) is where the port's chain runs: on a CUDA
device the demod of a point is one launch of the scan kernel
``fsk_scan``; without a CUDA device the CLI exits 1 unless ``--device
cpu`` was asked for.
"""

import argparse
import dataclasses
import datetime
import os
import sys
import tempfile
import time

import numpy as np
import torch

from radiosonde_auto_rx_tpu_torch.demod import FSKConfig, fsk_demod_stream
from radiosonde_auto_rx_tpu_torch.demod.modulate import add_awgn, gfsk_mod


def _oracle():
    """The reference-binary builder (tests/oracle.py) if importable and
    the reference tree is present; else None (TPU-only sweeps)."""
    try:
        from radiosonde_auto_rx_tpu_torch.tools import repo_root
        sys.path.insert(0, repo_root())
        from tests import oracle
        return oracle if oracle.available() else None
    except ImportError:
        return None


def _gps_now_plus(i_sec: float = 0.0):
    return _gps_at(datetime.datetime.now(datetime.timezone.utc) +
                   datetime.timedelta(seconds=i_sec))


# The RS41, M10 and M20 cases write ``_gps_now_plus`` into their frames,
# so two runs a second apart make different frames.  A run held to
# another chain's frames on the same IQ patches ``_gps_now_plus`` with
# ``pinned_gps_now_plus`` (in every harness it runs).
PINNED_GPS_TIME = datetime.datetime(2026, 10, 17, 12, 0, 0,
                                    tzinfo=datetime.timezone.utc)


def pinned_gps_now_plus(i_sec: float = 0.0):
    return _gps_at(PINNED_GPS_TIME + datetime.timedelta(seconds=i_sec))


def _gps_at(now):
    """(GPS week, time of week ms) of the UTC datetime ``now``."""
    week = (now - datetime.datetime(1980, 1, 6,
                                    tzinfo=datetime.timezone.utc)).days // 7
    dow = (now.weekday() + 1) % 7
    tow_ms = (((dow * 24 + now.hour) * 3600 + now.minute * 60 +
               now.second) * 1000)
    return week, tow_ms


@dataclasses.dataclass
class Case:
    """One sonde-type PER scenario: TX bits + both decode chains."""
    tx_bits: np.ndarray          # on-air bits incl. warmup frames
    fs: int
    rs: int
    spacing: float
    bt: float
    cfg: FSKConfig
    decode: callable             # (bits, soft) -> telemetry dicts (ours)
    tx_ids: set                  # counted frame identities (no warmup)
    ref_cmd: callable = None     # (oracle, iq_path) -> shell pipeline
    idle_run: int = 1            # idle = runs of this many 1s then 0s
    ppm: float = 0.0             # TX clock offset (real sondes are never
                                 # exactly on the receiver sample grid)
    prep: callable = None        # optional IQ conditioner before the
                                 # demod (e.g. the station's 601/600
                                 # fractional resample for MK2LMS);
                                 # (complex [T], device) -> planes
                                 # on the device for
                                 # fsk_demod_stream
    mod: callable = None         # optional modulator (bits -> complex
                                 # IQ) replacing gfsk_mod, e.g. the
                                 # iMet AFSK-over-FM carrier


# Warmup frames per type: demod freq/timing convergence plus decoder
# state acquisition (DFM: the serial number arrives on conf channel 0xA
# as two halves once per 11-frame conf cycle and must be confirmed
# before telemetry is emitted, dfm09mod.c:747-801 — ~5 cycles covers
# two sightings of both halves under noise).
WARMUP = {"RS41": 1, "DFM": 5, "M10": 1, "LMS6": 1, "RS92": 2,
          "MEISEI": 1, "MRZ": 8, "IMET54": 1, "MTS01": 1, "WXR301": 1,
          "RD94RD41": 1, "M20": 1, "MK2LMS": 1, "RS92NGP": 20,
          "IMET4": 1, "WXRPN9": 1}


def _idle(n, run=1):
    """Clock-rich idle: alternating runs of `run` ones then `run`
    zeros.  run=1 (bit-rate alternation) suits tone-masked estimators
    (RS41-style); unmasked peak-picking estimators (M10's chain, ours
    and the reference's alike) need run>=4 so the idle keeps spectral
    energy AT the tones rather than in alternation sidebands."""
    unit = np.concatenate([np.ones(run, np.uint8), np.zeros(run, np.uint8)])
    return np.tile(unit, n // (2 * run) + 1)[:n]


def _slot(frame_bits, rs, run=1):
    """Pad one frame's bits to a 1-second on-air slot with clock-rich
    idle, the real sondes' 1 Hz cadence.  Back-to-back frames are not
    just unrealistic — the reference decoders read a fixed frame window
    after each header and would swallow the next header."""
    gap = rs - len(frame_bits)
    if gap <= 0:
        return frame_bits
    return np.concatenate([frame_bits, _idle(gap, run)])


def _rs41_case(n_frames, rng, workdir):
    from radiosonde_auto_rx_tpu_torch.models.rs41 import (RS41Decoder,
                                                    encode_frame,
                                                    frame_to_bits,
                                                    make_calibytes)
    week, tow = _gps_now_plus()
    cal = make_calibytes()
    w = WARMUP["RS41"]
    bits = np.concatenate([_slot(frame_to_bits(encode_frame(
        frame_nb=100 + i, sonde_id="P1234567", week=week,
        tow_ms=tow + i * 1000, lat=47.5, lon=15.2, alt=12000.0,
        calibytes=cal, calfr=i % 51)), 4800) for i in range(n_frames + w)])
    cfg = FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=300,
                    est_min=-5000, est_max=5000, tone_spacing=5000,
                    freq_est_type=1)
    dec = RS41Decoder()
    # production chain: reference decode.py:901 + :920
    ref = lambda o, iq: (
        f"{o.binary('fsk_demod')} --cs16 -b -5000 -u 5000 -s --mask 5000 "
        f"--nsym=300 -p 5 2 48000 4800 {iq} - 2>/dev/null | "
        f"{o.binary('rs41mod')} --ptu2 --json --softin -i --ecc2 "
        f"2>/dev/null")
    # soft values feed the ECC3/ECC4 byte-score erasure search
    # (rs41mod.c:2939-2958) — measured +0.5 dB at the cliff vs
    # hard-bits-only
    return Case(bits, 48000, 4800, 4800, 0.5, cfg,
                lambda b, s: dec.decode_bits(b, s),
                set(range(100 + w, 100 + w + n_frames)), ref)


def _dfm_case(n_frames, rng, workdir):
    from radiosonde_auto_rx_tpu_torch.models.dfm import (DFMDecoder,
                                                   datetime2gpsweek,
                                                   encode_flight_bits)
    w = WARMUP["DFM"]
    date = (2024, 6, 1, 12, 30, 15.0)
    bits = encode_flight_bits(sn=21098765, lat=48.1, lon=11.5,
                              n_cycles=n_frames + w, date=date,
                              time_step=1.0)
    ids = set()
    for c in range(w, n_frames + w):
        t = (datetime.datetime(*date[:5]) +
             datetime.timedelta(seconds=date[5] + c))
        wk, tow = datetime2gpsweek(t.year, t.month, t.day, t.hour,
                                   t.minute, int(t.second + 0.5))
        ids.add(wk * 604800 + tow)
    cfg = FSKConfig(fs=50000, rs=2500, m=2, p=10, nsym=125,
                    est_min=-5000, est_max=5000)
    dec = DFMDecoder()
    # production chain: reference decode.py:1067 + :1081
    ref = lambda o, iq: (
        f"{o.binary('fsk_demod')} --cs16 -b -5000 -u 5000 -s "
        f"2 50000 2500 {iq} - 2>/dev/null | "
        f"{o.binary('dfm09mod')} -vv --ecc --json --dist --auto --softin "
        f"2>/dev/null")
    return Case(bits, 50000, 2500, 5000, 0.5, cfg,
                lambda b, s: dec.decode_bits(b, None if s is None else -s),
                ids, ref)


def _m10_case(n_frames, rng, workdir):
    from radiosonde_auto_rx_tpu_torch.models.m10 import (M10Decoder,
                                                   encode_frame_m10,
                                                   frame_to_raw_bits)
    week, tow = _gps_now_plus()
    w = WARMUP["M10"]
    bits = np.concatenate([_slot(frame_to_raw_bits(encode_frame_m10(
        week=week, tow_ms=tow + i * 1000, lat=48.2, lon=16.4,
        alt=11000.0)), 9616, run=8) for i in range(n_frames + w)])
    ids = {int(week * 604800 + (tow + i * 1000) / 1e3 + 0.5)
           for i in range(w, n_frames + w)}
    cfg = FSKConfig(fs=48080, rs=9616, m=2, p=5, nsym=240,
                    est_min=-10000, est_max=10000)
    dec = M10Decoder()
    # production chain: reference decode.py:1120 + :1125
    ref = lambda o, iq: (
        f"{o.binary('fsk_demod')} --cs16 -b -10000 -u 10000 -s -p 5 "
        f"2 48080 9616 {iq} - 2>/dev/null | "
        f"{o.binary('m10mod')} --json --ptu -vvv --softin -i 2>/dev/null")
    return Case(bits, 48080, 9616, 10000, 1.0, cfg,
                lambda b, s: dec.decode_bits(b, None if s is None else -s),
                ids, ref, idle_run=8)


def _lms6_case(n_frames, rng, workdir):
    from radiosonde_auto_rx_tpu_torch.models.lms6 import (LMS6Decoder,
                                                    blocks_to_raw_bits,
                                                    encode_block,
                                                    encode_frame)
    w = WARMUP["LMS6"]
    frames = [encode_frame(frnr=100 + i, tow_ms=210600500 + i * 1000,
                           fill_seed=i) for i in range(n_frames + w)]
    bits = blocks_to_raw_bits([encode_block(f) for f in frames])
    cfg = FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=300,
                    est_min=-10000, est_max=10000)
    dec = LMS6Decoder()
    # production chain: reference decode.py:1201 + :1209
    ref = lambda o, iq: (
        f"{o.binary('fsk_demod')} --cs16 -b -10000 -u 10000 -s "
        f"2 48000 4800 {iq} - 2>/dev/null | "
        f"{o.binary('lms6Xmod')} --json --softin --vit2 -i 2>/dev/null")
    return Case(bits, 48000, 4800, 4800, 1.0, cfg,
                lambda b, s: dec.decode_bits(b, None if s is None else -s),
                set(range(100 + w, 100 + w + n_frames)), ref)


def _rs92_case(n_frames, rng, workdir):
    from radiosonde_auto_rx_tpu_torch.models.rs92 import (RS92Decoder,
                                                    encode_flight_bits,
                                                    make_test_ephemeris)
    from radiosonde_auto_rx_tpu_torch.station import gps_ephem
    ephs = make_test_ephemeris()
    w = WARMUP["RS92"]
    bits = encode_flight_bits(n_frames=n_frames + w, ephs=ephs,
                              frnr=100, lat=47.0, lon=15.5, alt=9000.0)
    rinex = None
    if workdir is not None:
        rinex = os.path.join(workdir, "eph.txt")
        gps_ephem.write_rinex_nav(ephs, rinex)
    cfg = FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=300,
                    est_min=-5000, est_max=5000, tone_spacing=4800,
                    freq_est_type=1)
    dec = RS92Decoder(ephemeris=ephs)
    # production chain: reference decode.py:976 + :985 (-e ephemeris).
    # --mask matches our cfg's masked estimator (freq_est_type=1): the
    # Manchester stream is alternation-heavy and the unmasked C
    # peak-picker locks to alternation sidebands on synthetic signals.
    ref = lambda o, iq: (
        f"{o.binary('fsk_demod')} --cs16 -b -10000 -u 10000 -s "
        f"--mask 4800 --nsym=300 -p 5 "
        f"2 48000 4800 {iq} - 2>/dev/null | "
        f"{o.binary('rs92mod')} --crc --ecc --vel --json --softin -i "
        f"-e {rinex} 2>/dev/null")
    return Case(bits, 48000, 4800, 4800, 0.5, cfg,
                lambda b, s: dec.decode_bits(b, None if s is None else -s),
                set(range(100 + w, 100 + w + n_frames)),
                ref if rinex else None)


def _meisei_case(n_frames, rng, workdir):
    from radiosonde_auto_rx_tpu_torch.models.meisei import (
        MeiseiDecoder, encode_subframes_ims100, frames_to_raw_bits)
    w = WARMUP["MEISEI"]
    # one telemetry packet = an (even, odd) counter pair: the iMS-100
    # emitter holds the even frame's position until the odd frame's vV
    # arrives (meisei100mod.c:1019-1280); identity is the even counter
    frames = [encode_subframes_ims100(16 + i, sn=2304123.0, lat=36.1,
                                      lon=140.08, alt=9000.0)
              for i in range(2 * (n_frames + w))]
    bits = frames_to_raw_bits(frames)
    cfg = FSKConfig(fs=48000, rs=2400, m=2, p=5, nsym=300,
                    est_min=-10000, est_max=10000)
    dec = MeiseiDecoder(ref_year=2023)
    # production chain: reference decode.py:1343-1379
    ref = lambda o, iq: (
        f"{o.binary('fsk_demod')} --cs16 -b -15000 -u 15000 -s "
        f"2 48000 2400 {iq} - 2>/dev/null | "
        f"{o.binary('meisei100mod')} --softin --json --ptu --ecc "
        f"2>/dev/null")
    return Case(bits, 48000, 2400, 3600, 1.0, cfg,
                lambda b, s: dec.decode_bits(b),
                {16 + 2 * (w + k) for k in range(n_frames)}, ref)


def _mrz_case(n_frames, rng, workdir):
    from radiosonde_auto_rx_tpu_torch.models.mrz import (MRZDecoder, encode_frame,
                                                   frame_to_raw_bits)
    w = WARMUP["MRZ"]
    cfgs = [(0xC, 30112), (0xD, 21055), (0xF, 150621), (0x0, 0x3F800000)]
    slots = []
    for i in range(n_frames + w):
        cid, cval = cfgs[i % len(cfgs)]
        f = encode_frame(cid, 12, 30 + i // 60, i % 60, 55.75, 37.62,
                         15000.0, cfg32=cval)
        slots.append(_slot(frame_to_raw_bits(f), 2400, run=4))
    bits = np.concatenate(slots)
    # frame identity = gps_cnt; derive the counted ids from a clean
    # decode (both chains emit the same "frame" convention,
    # mp3h1mod.c:748 — oracle-parity-tested in tests/test_mrz.py)
    clean = MRZDecoder().decode_bits(bits)
    ids = {t["frame"] for t in clean[-n_frames:]}
    cfg = FSKConfig(fs=48000, rs=2400, m=2, p=5, nsym=300,
                    est_min=-10000, est_max=10000)
    dec = MRZDecoder()
    # reference decode.py:1256-1293 (fsk_demod split chain).  MRZ's
    # production *default* is the standard IQ chain (config.py:447
    # experimental=False), but that chain's cliff measures >14 dB worse
    # here — the split chain is the stronger reference, so overlay
    # against it (conservative comparison).
    ref = lambda o, iq: (
        f"{o.binary('fsk_demod')} --cs16 -b -10000 -u 10000 -s "
        f"2 48000 2400 {iq} - 2>/dev/null | "
        f"{o.binary('mp3h1mod')} --auto --json --softin --ptu 2>/dev/null")
    return Case(bits, 48000, 2400, 2400, 0.5, cfg,
                lambda b, s: dec.decode_bits(b, None if s is None else -s),
                ids, ref, idle_run=4)


def _imet54_case(n_frames, rng, workdir):
    from radiosonde_auto_rx_tpu_torch.models.imet54 import (IMet54Decoder,
                                                      encode_frame,
                                                      encode_raw_bits)
    w = WARMUP["IMET54"]
    bits = np.concatenate([
        _slot(encode_raw_bits(encode_frame(sn=54001234, hh=12,
                                           mm=30 + i // 60,
                                           ss=float(i % 60))), 4800,
              run=4)
        for i in range(n_frames + w)])
    ids = {(12 * 3600 + (30 + i // 60) * 60 + i % 60)
           for i in range(w, n_frames + w)}
    cfg = FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=300,
                    est_min=-10000, est_max=10000)
    dec = IMet54Decoder()
    # production chain: reference decode.py:1215-1250 — IMET5 defaults
    # to the experimental fsk_demod split chain
    # (config.py:442 experimental_decoders["IMET5"]=True)
    ref = lambda o, iq: (
        f"{o.binary('fsk_demod')} --cs16 -b -10000 -u 10000 -s "
        f"2 48000 4800 {iq} - 2>/dev/null | "
        f"{o.binary('imet54mod')} --ecc --json --softin -i --ptu "
        f"2>/dev/null")
    return Case(bits, 48000, 4800, 4800, 0.5, cfg,
                lambda b, s: dec.decode_bits(b, None if s is None else -s),
                ids, ref, idle_run=4)


def _mts01_case(n_frames, rng, workdir):
    from radiosonde_auto_rx_tpu_torch.models.mts01 import (MTS01Decoder,
                                                     encode_frame,
                                                     frame_to_bits)
    w = WARMUP["MTS01"]
    bits = np.concatenate([
        _slot(frame_to_bits(encode_frame(frnr=100 + i,
                                         time=(10, 45, i % 60))), 1200,
              run=4)
        for i in range(n_frames + w)])
    cfg = FSKConfig(fs=48000, rs=1200, m=2, p=5, nsym=300,
                    est_min=-5000, est_max=5000)
    dec = MTS01Decoder()
    # production chain: reference decode.py:758-781 — mts01mod's own IQ
    # front-end reads CS16 directly (no fsk_demod stage)
    ref = lambda o, iq: (
        f"cat {iq} | {o.binary('mts01mod')} --json --IQ 0.0 --lpIQ --dc "
        f"- 48000 16 2>/dev/null")
    return Case(bits, 48000, 1200, 2400, 1.0, cfg,
                lambda b, s: dec.decode_bits(b, None if s is None else -s),
                set(range(100 + w, 100 + w + n_frames)), ref, idle_run=4)


def _wxr301_case(n_frames, rng, workdir):
    from radiosonde_auto_rx_tpu_torch.models.weathex import (WeathexDecoder,
                                                       encode_frame,
                                                       frame_to_bits)
    w = WARMUP["WXR301"]
    slots = []
    for i in range(n_frames + w):
        # one telemetry packet = subframe pair (frid 1 then 2) sharing
        # sn/cnt (weathex301d.c sub1 latch; models/weathex.py:96-120)
        pair = np.concatenate([
            frame_to_bits(encode_frame(1, cnt=700 + i,
                                       time=(10, 20, i % 60))),
            _idle(120, 4),
            frame_to_bits(encode_frame(2, cnt=700 + i,
                                       time=(10, 20, i % 60)))])
        slots.append(_slot(pair, 4800, run=4))
    bits = np.concatenate(slots)
    cfg = FSKConfig(fs=96000, rs=4800, m=2, p=5, nsym=300,
                    est_min=-55000, est_max=55000, tone_spacing=50000,
                    freq_est_type=1)
    dec = WeathexDecoder()
    # production chain: reference decode.py:1385-1423 (96 kHz IQ,
    # masked estimator, soft-decision inverted)
    ref = lambda o, iq: (
        f"{o.binary('fsk_demod')} --cs16 -b -40000 -u 40000 -s "
        f"--mask 50000 2 96000 4800 {iq} - 2>/dev/null | "
        f"{o.binary('weathex301d')} --softin -i --json 2>/dev/null")
    return Case(bits, 96000, 4800, 50000, 1.0, cfg,
                lambda b, s: dec.decode_bits(b),
                set(range(700 + w, 700 + w + n_frames)), ref, idle_run=4)


def _wxrpn9_case(n_frames, rng, workdir):
    from radiosonde_auto_rx_tpu_torch.models.weathex import (WeathexPN9Decoder,
                                                       encode_frame,
                                                       frame_to_bits)
    w = WARMUP["WXRPN9"]
    slots = []
    for i in range(n_frames + w):
        pair = np.concatenate([
            frame_to_bits(encode_frame(1, cnt=700 + i,
                                       time=(10, 20, i % 60), pn9=True)),
            _idle(120, 4),
            frame_to_bits(encode_frame(2, cnt=700 + i,
                                       time=(10, 20, i % 60), pn9=True))])
        slots.append(_slot(pair, 5000, run=4))
    bits = np.concatenate(slots)
    cfg = FSKConfig(fs=100000, rs=5000, m=2, p=5, nsym=300,
                    est_min=-55000, est_max=55000, tone_spacing=50000,
                    freq_est_type=1)
    dec = WeathexPN9Decoder()
    # production chain: reference decode.py:1428-1467 (5 kBd PN9 variant
    # on a 100 kHz channel)
    ref = lambda o, iq: (
        f"{o.binary('fsk_demod')} --cs16 -b -40000 -u 40000 -s "
        f"--mask 50000 2 100000 5000 {iq} - 2>/dev/null | "
        f"{o.binary('weathex301d')} --softin -i --json --pn9 2>/dev/null")
    return Case(bits, 100000, 5000, 50000, 1.0, cfg,
                lambda b, s: dec.decode_bits(b),
                set(range(700 + w, 700 + w + n_frames)), ref, idle_run=4)


def _imet4_case(n_frames, rng, workdir):
    from radiosonde_auto_rx_tpu_torch.models.imet4 import (
        IMet4Decoder, afsk_demod_config, afsk_modulate, encode_frame_bits,
        encode_gps_packet, encode_eptu_packet)
    from radiosonde_auto_rx_tpu_torch.ops.fm import fm_discriminate_planes
    w = WARMUP["IMET4"]
    slots = []
    for i in range(n_frames + w):
        fb = encode_frame_bits(
            [encode_gps_packet(lat=45.46, lon=9.19, alt=2500 + 2 * i,
                               time=(12, 30 + i // 60, i % 60)),
             encode_eptu_packet(frame=100 + i)], sync_bits=160)
        gap = 1200 - len(fb)
        if gap > 0:     # Bell-202 idle = resting mark tone (all ones)
            fb = np.concatenate([fb, np.ones(gap, np.uint8)])
        slots.append(fb)
    bits = np.concatenate(slots)
    cfg = afsk_demod_config(48000)
    dec = IMet4Decoder()

    def prep(iq, device):
        # the AFSK rides on FM audio: IF lowpass -> discriminate ->
        # audio lowpass, then feed the audio as a real signal (imag
        # plane zero) — same chain as the station (chain["afsk"])
        from radiosonde_auto_rx_tpu_torch.models.imet4 import afsk_fm_audio
        pl = torch.from_numpy(np.stack([iq.real, iq.imag])
                              .astype(np.float32)).to(device)
        audio = afsk_fm_audio(pl, 48000)
        return torch.stack([audio, torch.zeros_like(audio)])[None]

    def decode(b, s):
        # FSK symbol 0 = 1200 Hz tone = AFSK bit 1 (station.py:384)
        return dec.decode_bits(1 - np.asarray(b))

    def mod(tx_bits):
        audio = afsk_modulate(tx_bits, fs=48000).astype(np.float64)
        ph = 2 * np.pi * np.cumsum(3000.0 * audio) / 48000.0
        return np.exp(1j * ph).astype(np.complex64)

    # production chain: reference decode.py:546-579 — imet4iq's own IQ
    # front-end (FM demod + tone discrimination) at 48 kHz
    ref = lambda o, iq: (
        f"cat {iq} | {o.binary('imet4iq')} --iq 0.0 --lpIQ --dc - "
        f"48000 16 --json 2>/dev/null")
    return Case(bits, 48000, 1200, 0.0, 1.0, cfg, decode,
                set(range(100 + w, 100 + w + n_frames)), ref, prep=prep,
                mod=mod)


def _rs92ngp_case(n_frames, rng, workdir):
    from radiosonde_auto_rx_tpu_torch.models.rs92 import (RS92Decoder,
                                                    encode_flight_bits,
                                                    make_calibytes,
                                                    make_test_ephemeris)
    from radiosonde_auto_rx_tpu_torch.station import gps_ephem
    ephs = make_test_ephemeris()
    w = WARMUP["RS92NGP"]
    cal = make_calibytes(ngp=True, freq_khz=1680000)
    bits = encode_flight_bits(n_frames=n_frames + w, ephs=ephs,
                              calibytes=cal, ngp=True, frnr=100,
                              lat=47.0, lon=15.5, alt=9000.0)
    rinex = None
    if workdir is not None:
        rinex = os.path.join(workdir, "eph_ngp.txt")
        gps_ephem.write_rinex_nav(ephs, rinex)
    # 1680 MHz branch: 96 kHz channel, ~20 kHz tone spacing (reference
    # decode.py:946-950; station CHAIN_TABLE RS92NGP mask=20000)
    cfg = FSKConfig(fs=96000, rs=4800, m=2, p=5, nsym=300,
                    est_min=-32000, est_max=32000, tone_spacing=20000,
                    freq_est_type=1)
    dec = RS92Decoder(ephemeris=ephs)
    # production chain: reference decode.py:944-990 (--ngp branch)
    ref = lambda o, iq: (
        f"{o.binary('fsk_demod')} --cs16 -b -10000 -u 10000 -s "
        f"--mask 20000 --nsym=300 -p 5 "
        f"2 96000 4800 {iq} - 2>/dev/null | "
        f"{o.binary('rs92mod')} --crc --ecc --vel --json --softin -i "
        f"-e {rinex} --ngp --ptu 2>/dev/null")
    return Case(bits, 96000, 4800, 20000, 0.5, cfg,
                lambda b, s: dec.decode_bits(b, None if s is None else -s),
                set(range(100 + w, 100 + w + n_frames)),
                ref if rinex else None)


def _mk2lms_case(n_frames, rng, workdir):
    from radiosonde_auto_rx_tpu_torch.models.mk2lms import (
        MK2LMSDecoder, encode_frame_4d, encode_frame_54, frame_to_raw_bits)
    from radiosonde_auto_rx_tpu_torch.ops.resample import resample_planes
    w = WARMUP["MK2LMS"]
    sid = 7654321
    slots = []
    # MK2A is a continuous 9616 Bd byte stream: inter-frame fill is the
    # 0xCA sync char itself; a 0x4D full-ID frame every 8 telemetry
    # frames (the decoder gates JSON on the 32-bit ID, like the
    # reference mk2a1680mod)
    fill_char = frame_to_raw_bits(np.zeros(0, np.uint8), n_sync=1)
    for i in range(n_frames + w):
        fb = frame_to_raw_bits(encode_frame_54(
            sid32=sid, frnr=100 + i, tow_ms=43_205_000 + 1000 * i,
            lat=44.52, lon=-72.61, alt=15000.0 + 5.0 * i))
        if i % 8 == 0:
            fb = np.concatenate(
                [frame_to_raw_bits(encode_frame_4d(sid32=sid)), fb])
        gap = 9616 - len(fb)
        if gap > 0:
            nfill = gap // 10
            fb = np.concatenate([fb, np.tile(fill_char, nfill)])
        slots.append(fb)
    bits = np.concatenate(slots)
    # TPU chain mirrors the station: 240 kHz channel resampled 601/600
    # to 240.4 kHz so Ts = 25 exactly (station.py CHAIN_TABLE MK2LMS)
    cfg = FSKConfig(fs=240400, rs=9616, m=2, p=5, nsym=300,
                    est_min=-110000, est_max=110000, tone_spacing=100000,
                    freq_est_type=1)
    dec = MK2LMSDecoder()

    def prep(iq, device):
        pl = torch.from_numpy(np.stack([iq.real, iq.imag])
                              .astype(np.float32)).to(device)
        return resample_planes(pl, 240000, 240400)[None]

    # production chain: reference decode.py:661-699 — mk2a1680mod's
    # integrated IQ front-end at 240 kHz
    ref = lambda o, iq: (
        f"cat {iq} | {o.binary('mk2a1680mod')} --iq 0.0 --lpIQ "
        f"--lpbw 160 --decFM --dc --crc --json - 240000 16 2>/dev/null")
    return Case(bits, 240000, 9616, 100000, 1.0, cfg,
                lambda b, s: dec.decode_bits(b, None if s is None else -s),
                set(range(100 + w, 100 + w + n_frames)), ref, prep=prep)


def _m20_case(n_frames, rng, workdir):
    from radiosonde_auto_rx_tpu_torch.models.m10 import (M20Decoder,
                                                   encode_frame_m20,
                                                   frame_to_raw_bits)
    week, tow = _gps_now_plus()
    gps0 = tow // 1000
    w = WARMUP["M20"]
    bits = np.concatenate([_slot(frame_to_raw_bits(encode_frame_m20(
        week=week, gpssec=gps0 + i, lat=52.15, lon=13.35,
        alt=7000.0 + 5.0 * i)), 9600, run=8) for i in range(n_frames + w)])
    ids = {int(week * 604800 + gps0 + i) for i in range(w, n_frames + w)}
    cfg = FSKConfig(fs=48000, rs=9600, m=2, p=5, nsym=240,
                    est_min=-10000, est_max=10000)
    dec = M20Decoder()
    # production chain: reference decode.py:1131-1167
    ref = lambda o, iq: (
        f"{o.binary('fsk_demod')} --cs16 -b -10000 -u 10000 -s -p 5 "
        f"2 48000 9600 {iq} - 2>/dev/null | "
        f"{o.binary('m20mod')} --json --ptu -vvv --softin -i 2>/dev/null")
    return Case(bits, 48000, 9600, 10000, 1.0, cfg,
                lambda b, s: dec.decode_bits(b, None if s is None else -s),
                ids, ref, idle_run=8)


def _rd94_case(n_frames, rng, workdir):
    from radiosonde_auto_rx_tpu_torch.models.dropsonde import (DropsondeDecoder,
                                                         encode_frame_rd94,
                                                         frames_to_raw_bits)
    w = WARMUP["RD94RD41"]
    # dropsondes transmit continuously: consecutive frames chain without
    # idle (frames_to_raw_bits inserts the shared [1A CF] sync)
    frames = [encode_frame_rd94(frnr=100 + i, lat=25.1, lon=-80.3,
                                alt=4000.0 - 3.0 * i)
              for i in range(n_frames + w)]
    bits = frames_to_raw_bits(frames)
    cfg = FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=300,
                    est_min=-20000, est_max=20000)
    dec = DropsondeDecoder()
    # production chain: reference decode.py:993-1029
    ref = lambda o, iq: (
        f"{o.binary('fsk_demod')} --cs16 -b -20000 -u 20000 -s "
        f"2 48000 4800 {iq} - 2>/dev/null | "
        f"{o.binary('rd94rd41drop')} --json --softinv 2>/dev/null")
    return Case(bits, 48000, 4800, 10000, 1.0, cfg,
                lambda b, s: dec.decode_bits(b, None if s is None else -s),
                set(range(100 + w, 100 + w + n_frames)), ref)


CASES = {"RS41": _rs41_case, "DFM": _dfm_case, "M10": _m10_case,
         "LMS6": _lms6_case, "RS92": _rs92_case, "MEISEI": _meisei_case,
         "MRZ": _mrz_case, "IMET54": _imet54_case, "MTS01": _mts01_case,
         "WXR301": _wxr301_case, "RD94RD41": _rd94_case, "M20": _m20_case,
         "MK2LMS": _mk2lms_case, "RS92NGP": _rs92ngp_case,
         "IMET4": _imet4_case, "WXRPN9": _wxrpn9_case}


def _make_iq(case: Case, ebno_db: float, rng, f_off: float = 0.0,
             n_up: int = 4, device="cuda"):
    idle = _idle(600, case.idle_run)
    # generous tail so the demod's clipped nmem + one-block tail never
    # cuts the last frame
    tail = _idle(1400, case.idle_run)
    tx = np.concatenate([idle, case.tx_bits, tail])
    if f_off:
        # off-grid point: synthesize at n_up x the channel rate with
        # the carrier f_off Hz off the channel center, then pull the
        # channel back through the SAME recentered polyphase extraction
        # the station uses for off-grid candidates
        # (ops/channelizer.extract_channels; round-4 verdict #7) — the
        # PER then includes any recentering loss.
        from radiosonde_auto_rx_tpu_torch.ops.channelizer import \
            extract_channels
        assert case.mod is None, "off-grid PER needs the gfsk modulator"
        fs_wide = case.fs * n_up
        clean = gfsk_mod(tx, fs_wide, case.rs, 2, f_off, case.spacing,
                         bt=case.bt, ppm=case.ppm)
        # calibrate noise against the BASEBAND variance so off-grid
        # points share the centered sweep's Eb/N0 convention: np.var
        # subtracts the mean, and a centered burst with alternating
        # idle carries a large DC line (|mean| ~ 0.4 for RS41), so
        # var(centered) < E|x|^2 = var(offset) — without this the
        # centered curves sit ~0.7 dB flattered vs any offset point
        cal = float(np.var(gfsk_mod(tx, case.fs, case.rs, 2, 0.0,
                                    case.spacing, bt=case.bt,
                                    ppm=case.ppm)))
        wide = add_awgn(clean, ebno_db, fs_wide, case.rs, rng=rng,
                        ref_power=cal)
        planes = np.stack([wide.real, wide.imag]).astype(np.float32)
        ext = extract_channels(planes, fs_wide, [f_off], n_up, device)
        ext = ext.cpu().numpy().astype(np.float32)[0]
        # undo the extraction's passband gain (= n_up): the TPU chain
        # is scale-invariant, but a 'ref' chain run on this IQ would
        # otherwise clip hard in the cs16 conversion
        return ((ext[0] + 1j * ext[1]) / n_up).astype(np.complex64)
    clean = (case.mod(tx) if case.mod is not None else
             gfsk_mod(tx, case.fs, case.rs, 2, 0.0, case.spacing,
                      bt=case.bt, ppm=case.ppm))
    return add_awgn(clean, ebno_db, case.fs, case.rs, rng=rng)


def run_point(sonde_type: str, ebno_db: float, n_frames: int = 100,
              seed: int = 0, chains=("torch",), workdir=None,
              f_off: float = 0.0, device="cuda"):
    """One PER measurement per requested chain.  Returns a list of
    dict(type, chain, ebno_db, frames_tx, frames_rx, per, runtime_s).
    ``f_off`` (Hz) synthesizes the carrier off the channel center and
    demodulates through the station's recentered extraction (torch chain
    only — the reference chain always tunes to the carrier).
    ``device``: where the torch chain runs — the off-grid extraction,
    the case's ``prep`` and the demod (one ``fsk_scan`` launch on a CUDA
    device)."""
    rng = np.random.default_rng(seed)
    own_dir = None
    if workdir is None and "ref" in chains:
        own_dir = tempfile.TemporaryDirectory()
        workdir = own_dir.name
    case = CASES[sonde_type](n_frames, rng, workdir)
    iq = _make_iq(case, ebno_db, rng, f_off=f_off, device=device)
    rows = []
    try:
        for chain in chains:
            t0 = time.perf_counter()
            if chain == "torch":
                # np complex in: iq_planes splits on the host
                iq_t = case.prep(iq, device) if case.prep is not None \
                    else iq
                soft, bits, stats, _ = fsk_demod_stream(case.cfg, iq_t,
                                                        device)
                soft, bits = soft.cpu().numpy(), bits.cpu().numpy()
                if bits.ndim == 2:      # planes input keeps the C axis
                    soft, bits = soft[0], bits[0]
                telems = case.decode(np.asarray(bits), np.asarray(soft))
            else:
                o = _oracle()
                if o is None or case.ref_cmd is None:
                    continue
                iq_path = os.path.join(workdir,
                                       f"{sonde_type}_{ebno_db}.cs16")
                with open(iq_path, "wb") as f:
                    f.write(o.iq_to_cs16(iq))
                telems = o.run_json(case.ref_cmd(o, iq_path))
                os.unlink(iq_path)
            dt = time.perf_counter() - t0
            rx_ids = {t.get("frame") for t in telems} & case.tx_ids
            rows.append(dict(type=sonde_type, chain=chain,
                             ebno_db=ebno_db, frames_tx=n_frames,
                             frames_rx=len(rx_ids),
                             per=1.0 - len(rx_ids) / n_frames,
                             runtime_s=round(dt, 3), f_off=f_off))
    finally:
        if own_dir is not None:
            own_dir.cleanup()
    return rows


def sweep(sonde_type: str, ebnos, n_frames: int = 100, seed: int = 0,
          chains=("torch",), out=None, device="cuda"):
    rows = []
    with tempfile.TemporaryDirectory() as workdir:
        for e in ebnos:
            for r in run_point(sonde_type, float(e), n_frames, seed,
                               chains, workdir, device=device):
                rows.append(r)
                print("%(type)s,%(chain)s,%(ebno_db).1f,%(frames_tx)d,"
                      "%(frames_rx)d,%(per).3f,%(runtime_s).3f" % r,
                      file=out or sys.stdout, flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--type", default="RS41", choices=sorted(CASES))
    ap.add_argument("--ebno", default="5:20:0.5",
                    help="start:stop:step dB (reference range 5-20/0.5)")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chains", default="torch",
                    help="comma list: torch,ref (ref needs the reference "
                         "tree, tests/oracle.py)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the demod runs on (default cuda)")
    ap.add_argument("-o", "--output", default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("per_harness: no CUDA device (pass --device cpu to run on "
              "the CPU)", file=sys.stderr)
        return 1
    a, b, s = (float(v) for v in args.ebno.split(":"))
    ebnos = np.arange(a, b + s / 2, s)
    chains = tuple(args.chains.split(","))
    out = open(args.output, "w") if args.output else None
    print("type,chain,ebno_db,frames_tx,frames_rx,per,runtime_s",
          file=out or sys.stdout)
    sweep(args.type, ebnos, args.frames, args.seed, chains, out,
          device=device)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
