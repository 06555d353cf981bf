"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises (non-zero exit, traceback):

1. Check for a CUDA device, print the card's name and power limit
   (nvidia-smi), build the port's kernels from ``csrc/`` (nvcc, sm_90a,
   one process per source, all at once, into ``build/kernels/``) and
   print the build time.
2. Hold each hand-written kernel against its plain PyTorch twin on the
   card.  The scan kernel ``fsk_scan`` (the whole buffered FSK demod,
   one launch a call, K1 as its spectral stage) against ``fsk_scan_ref``
   (run on a CPU copy of the inputs, and on the card too but for
   ``TWIN_CPU_ONLY``) on 1 s of modulated signal with noise at the main
   path's shapes (RS41
   with 2 channels, DFM at 50 kHz with 1), then RS41 with 16, M20 and
   MTS01 with 4, M10 (odd n) and an FSK4 config with 2, and the geometries
   of phase 8's chains: the iMet AFSK audio (P = 8, ndft 512, a real
   input) with 1 and 4, WXR301 (96 kHz, ndft 256, the mask comb over the
   whole spectrum) and WXRPN9 (100 kHz) with 1, and the L-band chains of
   phase 9 with 1: RS92NGP (240 kHz, ndft 512, a window span that fits
   shared memory once) and MK2LMS (240.4 kHz, ndft 256), once from the
   initial state with probe outputs and once from a carried state; the
   scan's unbuffered mode (the demod CLI's: each window at
   ``[ptr - nmem, ptr)``, one window buffer) against
   ``fsk_scan_ref(buffered=False)`` at RS41, DFM and M10 with 1 channel
   over the CLI's chunk of 8 demod blocks, from the initial state and
   from the carried one (its pointer runs past the input: clamped window
   starts); K1
   alone through its entry point ``ops.fsk_sf.freq_est_sf`` (a thin
   kernel around the same stage; counters zeroed just before, read just
   after) at the shapes the main path gives the stage, then wider
   batches and other chains; K2
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
   its twin's (the scan's twin: the profiler's device time, since its
   thousands of launches cannot be queued ahead), the one PyTorch call
   that computes the same function from the same planes and window
   (cuFFT; none for K1 or the scan), the bound (the larger of the
   function's least float32 operations, each DFT as an FFT, 5 N log2 N,
   over 67 TFLOP/s and its bytes, inputs read once and outputs written
   once, over 3.35 TB/s) and, for the scan, the microseconds a demod
   block (each channel is a serial chain of demod blocks).
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
   within 1e-4 deg; the scan kernel launched exactly once for each demod
   call (counted by a wrapper around the callers' ``fsk_demod_stream``),
   K1 never on its own, K2 at least once; the fused steady path served
   the channels; the same blocks through a CPU ``Station`` (the plain
   twins) give the same telemetry.
6. Time 12 steady blocks (scan and no-scan) on the card, check one scan
   launch a type group a block, then profile 4 more with torch.profiler:
   kernel launches, device busy time, launch API and demod host time
   per block.  (b) The split dispatch (``fused_steady_step: false``,
   inline): phase 4's blocks give the same telemetry as the fused
   station, and steady blocks launch the scan once a type group a block
   and K2 once a block (the PSD every block).  Then steady blocks with
   manual tasks through new stations in turns (inline fused, (a) the
   default configuration with the frame-plane pool, ``frame_plane_
   workers`` -1, and the split dispatch; 12 blocks each): print each
   row's median block wall.
7. Detection: hold the CUDA detector (``StationStep.confirm`` +
   ``decide_confirmed`` on the three sondes' rows of the first block)
   against its CPU path; then drive a ``Station(device="cuda")`` with no
   task over the same captures (1 s blocks, then 2 s blocks; counters
   zeroed just before, read just after).  Check that the three sondes
   are detected with their types and channels, that both RS41s decode
   from the 1 s blocks and all three from the 2 s blocks, and that a CPU
   ``Station`` detects the same tasks block by block and decodes the
   same telemetry, with the launches checked as in phase 5.  Print the
   ``detections`` stat, the launches and the wall time of the block that
   runs ``confirm``.
8. The narrow station's remaining paths: 4 s of a second capture (same
   geometry, noise and wire format; ``wideband_sondes`` on) carrying an
   iMet-4 on a channel center (Bell-202 AFSK on FM), a WXR301 10 kHz off
   grid (50 kHz shift) and two RS41s 12 kHz either side of one channel
   center, on channels clear of phase 3's, driven as 1 s and then 2 s
   blocks twice (counters zeroed just before each drive, read just
   after): (a) all four as manual tasks (the iMet in the fused step, the
   WXR301 extracted at 96 kHz per task, the second RS41 through the
   forced collision path), (b) with no task (the iMet detected and
   decoded as AFSK, the WXR301 through the PSD width gate and the 96 kHz
   wide scan, the second RS41 through collision + detection).  Check the
   types, serials and positions of all four from the 2 s blocks, one
   scan launch per demod call (the AFSK group and every wide and
   collision decode included), K1 never alone, and the same telemetry
   and tasks block by block from a CPU ``Station``.  Print the wall time
   of a steady 1 s block with the four sondes active, of the detection
   block, and the launches.
9. The sequential route and L-band.  (a) Phase 3's capture plus six
   unmodulated carriers on clear channels through ``Station(...,
   use_mesh=False)`` (``process_capture`` block by block) with no task,
   as 1 s and then 2 s blocks (counters zeroed just before, read just
   after): nine PSD candidates, so the detector's half-rate prescreen
   runs under its own rule (C >= 8) on the card.  Check the three
   sondes' detections and telemetry as in phase 7, that the prescreen
   ran on the card once a run on the nine candidates and kept only the
   sondes, that its ratios are within RATIO_TOL of a CPU station's with
   the same survivors, that the CPU station has the same tasks block by
   block and the same telemetry, and one scan launch per demod call.
   Print the wall time of a sequential 1 s block with the sondes as
   tasks, of the detection block, and the prescreen's device time on the
   candidate batch.  (b) 4 s of a 2.4 MHz capture at 1680 MHz (ten
   240 kHz channels) carrying an RS92-NGP on a channel center, as two
   2 s blocks through a station with no task: found by the scan with the
   L-band detector, renamed from RS92 and decoded (serial, subtype,
   position); then ``decode_channel`` on a 240 kHz MK2LMS channel; both
   equal to a CPU station's.
10. The command lines.  (a) Phase 3's capture written as a cs16 file
   (under ``build/chip_smoke/``) and replayed by ``station.main.
   run_station`` in this process, as ``python -m
   radiosonde_auto_rx_tpu_torch --replay`` runs it: 2 s blocks (the
   default), no task, the frame-plane pool at the reference's default
   (``frame_plane_workers`` -1), a checkpoint, the per-sonde log
   exporter and the web server on an ephemeral port (counters zeroed
   just before, read just after).  Check exit 0, the log rows against
   the telemetry of the same blocks through ``drive_station`` on the
   card, one scan launch per demod call, K2 at least once, tickets
   resolved by worker processes, and the checkpoint's tasks.  Then time
   the steady 1 s block with manual tasks without the pool and with it,
   in turns, and check that no pool worker holds a CUDA context: none
   maps the CUDA driver library (``/proc/<pid>/maps``; this process
   does), and ``nvidia-smi --query-compute-apps=pid`` lists no more
   apps with the pool than before it (its PIDs are another namespace's,
   so only their count is read).  (b) ``python -m
   radiosonde_auto_rx_tpu_torch --replay ... -f ... -m RS41`` as a child
   process: exit 0 and the RS41's rows.  (c) ``demod.cli.run`` on 4 s
   of RS41 test frames (``--testframes --hardout``) on the card and on
   the CPU: the same bits, one unbuffered scan launch a chunk; its real
   time factor.
11. The quality tools.  (a) The PER gate on the card: each of the 16
   types through ``tools.per_harness.run_point`` at the point
   ``tests/test_per_gate.py`` gates (``docs/per_r5.csv``'s centered
   ``tpu`` rows; 100 frames, seed 123, limit max(recorded + 0.20,
   0.35)), then the +-20 kHz points of RS41, DFM and M10 (50 frames,
   seed 321, limit max(recorded + 0.25, 0.45)), the frames' GPS time
   pinned (``per_harness.pinned_gps_now_plus``); one scan launch a
   point; each point also through the plain twin on the CPU, the card's
   received frames within ``PER_TWIN_TOL`` of the point's frames of the
   CPU's; print type, offset, Eb/N0, PER, recorded PER, limit, launches
   and seconds.  (b) ``tools.profile_station`` at its bench geometry (10
   captures of 2.4 M samples, 50 channels): the per-stage device ms,
   every stage on the card, the PSD one K2 launch, the demod one scan
   launch.  (c) ``utils.probe.trace`` around one steady block: the
   Chrome trace names ``fsk_scan``.  (d) ``run_point("RS41", 18.0, 5)``
   with the demod's probe outputs in the probe registry: the spectrum
   [1, blocks, ndft] with the tones at +-2400 Hz.
12. The mesh, on virtual meshes of the card (every shard on the one
   device; counters zeroed just before each drive, read just after).
   (a) (ch, t) = (8, 1): phase 3's 4 s as one batch of four 1 s blocks
   (padded to 8 with zero blocks), no task: the sharded analyze, the
   scan, the sharded ``confirm``, then ``route_demod``: the 12 experts
   pad to 16, two a shard, RS41 (expert 0) on shard 0 and DFM (expert 2)
   on shard 1, and the all-to-all moves a channel between shards.  The
   same telemetry and tasks from a CPU station on an (8, 1) mesh, the
   same tasks as the card's ``use_mesh: false`` station; then the blocks
   one at a time: the telemetry and tasks of the ``use_mesh: false``
   station, block by block.  (b) (2, 2) with ``mesh_time_shards`` 2 on
   two 4 s captures (phase 3's and ``synth_stream`` seed
   ``MESH_SEED``), one a batch: the channelizer, prescreen and demod
   halos and the t reductions; the telemetry and tasks of a CPU (2, 2)
   mesh and of the ``use_mesh: false`` station.  Both: one scan launch
   a demod call (the experts' scans counted), K1 never alone, K2 at
   least once.  (c) ``make_station_step`` (IF FIR + demod) on a (4, 2)
   mesh over 50 RS41 channels of 2 s (``fsk_signal``; two zero rows pad them
   to 52): every row's bits equal the unsharded card demod of the
   unsharded FIR output, t-shard by t-shard, one scan launch a shard;
   ``make_pp_demod_pipeline`` on a 3-stage mesh: the RS41 frames decode,
   the bits equal the CPU port's, one unbuffered scan launch a
   microbatch.  Then (a)'s batch in turns with the default 1x1 station
   on the same blocks, the three sondes as tasks: the block walls and
   device busy; torch.profiler around one ``route_demod`` (and one with
   an iMet row added, and one ``make_station_step``): the host's waits
   on the device inside it, device-to-host copies.
13. The reference's accelerator forms, forced by their switches
   (``TPU_FORMS``: bf16 polyphase branches and FM streams, the
   blocked-Toeplitz correlation, the block-normalized peak search).
   (a) Each form on the card against the CPU's run of the same form at
   the detector's geometry (phase 7's three rows of 48,000 samples, the
   class holding RS41 and DFM): ``_corr_toeplitz`` in float32 and bf16,
   ``_correlate_peaks_blocknorm`` in both ``rescore`` modes and
   ``_correlate_peaks`` under each ``RSX_DETECT_PEAKS``, each on float32
   and bf16 streams; ``_channelize`` (1 s of the capture) and
   ``_extract`` (the three rows) in bf16; each tolerance in
   ``forms_check``.  (b) A subprocess started with the four switches in
   its environment (two are read at import) drives phase 7's task-less
   blocks (counters zeroed just before, read just after): the same
   tasks block by block and the same telemetry as phase 7's float32
   station, bf16 channel planes, one scan launch a demod call and K2 at
   least once; then the detection block in turns with the float32
   forms, ``tools.profile_station``'s channelize, prescreen and
   full-pass stages (beside phase 11's float32 ones), and the prescreen
   and the full pass on 4, 16 and 64 rows in both forms.  (c) ``python
   -m radiosonde_auto_rx_tpu_torch.tools.dcn_probe --device cpu`` (two
   gloo processes on the host's CPU) exits 0; its fit is printed; on a
   host with one GPU the probe's default (``--device cuda``: NCCL, one
   GPU a process) exits 1 and says why.
14. The repository's two drivers.  (a) ``python -m
   radiosonde_auto_rx_tpu_torch.bench`` as a child, as a user runs it:
   its one JSON line has every key (``BENCH_KEYS``), every number
   finite and positive, each program's wall ms at or above its device
   ms (``WALL_SLACK``), and the launches a step of ``bench_plan`` (one
   scan a type group, K2 once on a step that scans); the line is
   printed.  (b) its ``--ablate`` table; (c) ``--scaling`` over the
   visible GPUs (one GPU: the 1-GPU rate alone).  (d)
   ``graft_entry.entry()`` on the card against the same step on the
   CPU: bits equal, soft within ``ENTRY_TOL`` of its peak, one
   unbuffered scan launch.  (e) ``graft_entry.dryrun_multichip(8)`` over
   a virtual mesh of the card (8 shards on the one GPU): its own value
   checks, the stage pipeline's 4 unbuffered scan launches, K2 and the
   buffered scan inside the shards; its OK line is printed.  (f) The
   scan kernel against its twin on the card at every shape the bench's
   programs give it at the card's geometry (recorded from one call of
   each program): the headline's 512 channels x 4 s on the bench's own
   input, the r3 model's 500 channels, and each type group of the
   production and steady programs on modulated signals of their shapes;
   ``scan_diff``'s checks from the initial and from a carried state.
15. The sharded station step across processes over NCCL, one GPU a
   process (``--mesh-worker`` children joining one group on a
   ``file://`` store through ``parallel.multihost``; counters zeroed
   just before each mode's drive in each process, read just after).
   With fewer than two GPUs it prints that it needs two and how many it
   found, and checks that a worker started as one of two processes
   exits 1 naming the GPU count.  With two or more: (a)
   ``tests/station_fixture.py``'s captures (rebuilt from the port's
   copies) through ``StationStep.analyze`` -> ``confirm`` ->
   ``route_demod`` on a (4, 2) mesh and ``make_station_step`` on an
   (8, 1) mesh over 2 processes, 4 virtual shards each on its own GPU;
   (b) the same over 4 processes where there are 4 GPUs; every shard
   held to one process's run of the same meshes on ``cuda:0`` (integers
   and masks equal, floats within ``MESH_FLOAT_TOL`` of their peak), the
   routed RS41 slot assembled from the ranks decoding ``T1357911``, the
   scan and K2 launched in every rank, and each GPU holding exactly one
   worker's context; (c) the bench's production geometry (8 captures of
   1 s, 50 channels; ``analyze(screen=False)``, ``confirm`` on 20
   slots, ``route_demod`` of ``bench.ACTIVES``) on an (N, 1) mesh over N
   processes (4 where there are 4 GPUs, else 2), held as (a) to one
   process's (N, 1) virtual mesh, each rank's step wall and device busy
   (NCCL kernels apart) beside that process's; (d) ``make_station_step``
   at the headline's 512 x 192,000 over the N processes in Msamples/s,
   in turns with one process over N GPUs and with one GPU; (e) where
   there are 3 GPUs or more, the stage pipeline (phase 12 (c)) over
   three processes against one process's.

The second-to-last line is a JSON object of per-kernel results (times
at the main path's shapes, bound, library-call time, the largest error
of all the checks; launches: the scan's and K2's on the detection path
(and by phase-8, phase-9 and phase-10 drive, phase 6's split dispatch,
phase 11's tools, phase 12's meshes, phase 13's TPU forms, phase
14's bench programs a step and dryrun, and phase 15's processes by
rank and mode, ``{}`` on a host with one GPU), the unbuffered scan's in
phase 10's demod CLI run (and phase 12's pipeline, phase 14's entry and
dryrun), K1's and K3's in
their own phases, through
their entry points; every kernel also lists each shape timed),
the last line ``{"ok": true, "device": {...}}``.
Without a CUDA device the script exits non-zero before printing any
result.
"""

import datetime
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

FS_WIDE = 2_400_000
N_CHAN = 50
SECONDS = 4
CENTER = 402.5e6
RS41_TS = 1_755_600_000          # fixed epoch -> identical frames per run
K1_TOL = 1e-5                    # max |kernel - twin| / max |twin|
K2_TOL = 1e-4                    # per bin, |kernel - twin| / (|twin| + row mean)
K3_TOL = 1e-4                    # per bin, |kernel - twin| / (|twin| + row RMS)
# fsk_scan and the per-window demod against their twins: soft decisions,
# spectra and tone magnitudes to 1e-4 of their peak (float32 sums in
# another order: the FFT against the DFT matrix product, the tree
# reductions against torch's); bits, tone estimates and nin equal
SCAN_TOL = 1e-4
# shapes whose twin, run on the card, is not held to: at MK2LMS (240.4 kHz,
# ts 25) the fine-timing line is weak enough that the order of the twin's
# CUDA reductions moves its timing by ~4e-6 and its soft decisions by
# ~1.2e-4 of their peak away from the same twin on the CPU, which the
# kernel follows (to ~3e-7 of the peak); every shape is held to the twin
# on the CPU
TWIN_CPU_ONLY = ("MK2LMS",)
# K1 alone through its entry point: the shapes the main path gives the
# scan's spectral stage (the two RS41s in one call, the DFM alone), then
# wider batches and other chains
K1_SHAPES = (("RS41", 2), ("DFM", 1), ("RS41", 16), ("DFM", 16),
             ("MTS01", 4), ("M20", 4))
# fsk_scan's phase-2 shapes: the main path's (the two RS41s in one call,
# the DFM alone), then wider batches and the other geometries (M10's odd
# n = 745, MTS01's ndft 512, an FSK4 config)
SCAN_SHAPES = (("RS41", 2), ("DFM", 1), ("RS41", 16), ("M20", 4),
               ("MTS01", 4), ("M10", 2), ("FSK4", 2), ("AFSK", 1),
               ("AFSK", 4), ("WXR301", 1), ("WXRPN9", 1), ("RS92NGP", 1),
               ("MK2LMS", 1))
# the unbuffered mode's phase-2 shapes (the demod CLI runs one channel):
# RS41 (the mask estimator), DFM at 50 kHz and M10's odd n = 745, each
# over the CLI's chunk of CLI_CHUNK demod blocks
UNBUF_SHAPES = (("RS41", 1), ("DFM", 1), ("M10", 1))
CLI_CHUNK = 8
FSK4_CFG = dict(fs=48000, rs=2400, m=4, p=5, nsym=100, est_min=-10000,
                est_max=10000)
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
# phase 9: the L-band capture's center, the unmodulated carriers' level
# (the sondes' is 0.2), and the prescreen's ratios on the card against a
# CPU station's: relative error
LBAND = 1680.0e6
CARRIER_LEVEL = 0.05
RATIO_TOL = 1e-3


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


def path_sondes_for(n_chan: int, fs_wide: int):
    """Phase 8's sondes, as ``sondes_for``, on channels clear of phase 3's:
    an iMet-4 on a channel center, a WXR301 10 kHz off grid, and two
    RS41s 12 kHz either side of one channel center (24 kHz apart, beyond
    ``decoder_spacing_limit``; the second at half the amplitude, see
    ``LEVEL``)."""
    from radiosonde_auto_rx_tpu_torch.ops.channelizer import channel_freqs
    f = channel_freqs(n_chan, fs_wide)
    pair = float(f[9 * n_chan // 10])
    return [("IMET4", None, float(f[3 * n_chan // 10]), 45.46, 9.19),
            ("WXR301", "30112233", float(f[7 * n_chan // 10]) + 10e3, 34.7,
             135.5),
            ("RS41", "R3141592", pair - 12e3, 59.33, 18.07),
            ("RS41", "S2718281", pair + 12e3, 52.52, 13.41)]


# Amplitude of a sonde by serial (else 0.2).  Two equal RS41s 24 kHz
# apart read as one signal wider (RMS) than the PSD width gate's 12 kHz
# limit: with ``wideband_sondes`` on, the station sends their centroid to
# the 96 kHz wide scan and then to the collision path there, where
# neither is found (so does the reference).  With the second 6 dB down
# the pair reads narrower and the scan nominates both
# (tests/test_torch_station_paths.py::test_width_gate_on_an_rs41_pair).
LEVEL = {"S2718281": 0.1}
# How far a task and its telemetry may sit from the sonde's frequency
# (else 2 kHz): a Weathex task starts at the wide scan's PSD centroid of
# its two tones 50 kHz apart, which an imbalance of tone power in a block
# moves by kHz (the demod's mask estimator searches +-55 kHz)
NEAR_HZ = {"WXR301": 5e3}


def want_id(typ: str, serial):
    """The telemetry id a sonde's serial gives (None: an iMet's id is
    synthesized from its power-on time, its frequency and the date)."""
    return {"RS41": serial, "DFM": f"DFM-{serial}",
            "WXR301": f"WXR-{serial}"}.get(typ)


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


def _imet_signal(lat, lon, secs, fs_wide, f_off, rng):
    """An iMet-4: Bell-202 AFSK frames (GPS + ePTU packets) FM-modulated
    onto the carrier at 3 kHz deviation."""
    from radiosonde_auto_rx_tpu_torch.models.imet4 import (
        afsk_modulate, encode_eptu_packet, encode_frame_bits,
        encode_gps_packet)
    frame = encode_frame_bits([encode_gps_packet(lat=lat, lon=lon, alt=2500),
                               encode_eptu_packet()], sync_bits=160)
    n = -(-secs * 1200 // len(frame))
    bits = np.concatenate([rng.integers(0, 2, 150)] + [frame] * n)
    audio = afsk_modulate(bits.astype(np.uint8), fs=fs_wide)
    ph = 2 * np.pi * np.cumsum(3000.0 * audio.astype(np.float64) + f_off) \
        / fs_wide
    return np.exp(1j * ph)


def _wxr_bits(serial, lat, lon, secs):
    """WXR301 frames (ids 0, 1, 2 in turn: id 2 carries the position)
    with short 1010 gaps after a 1010 preamble."""
    from radiosonde_auto_rx_tpu_torch.models.weathex import (
        encode_frame, frame_to_bits)
    gap = np.tile(np.array([1, 0], np.uint8), 30)
    out = [np.tile(np.array([1, 0], np.uint8), 200)]
    while sum(map(len, out)) < secs * 4800:
        k = len(out) // 2
        out += [frame_to_bits(encode_frame(
            frid=k % 3, sn=int(serial), cnt=700 + k // 3, lat=lat, lon=lon,
            alt=6000.0)), gap]
    return np.concatenate(out)


def synth_stream(n_chan: int, fs_wide: int, seconds: int, seed: int = 21,
                 sondes=sondes_for, carriers=None):
    """``seconds`` of one continuous capture with the sondes of
    ``sondes(n_chan, fs_wide)`` keyed up (RS41, DFM, IMET4, WXR301) and,
    with ``carriers``, unmodulated carriers at ``carriers(n_chan,
    fs_wide)`` (CARRIER_LEVEL), as cs16 ``[2, seconds*fs_wide]`` int16
    planes."""
    from radiosonde_auto_rx_tpu_torch.demod.modulate import gfsk_mod
    rng = np.random.default_rng(seed)
    t = seconds * fs_wide
    x = (rng.standard_normal(t) + 1j * rng.standard_normal(t)) * 0.002
    secs = seconds + 1
    for typ, serial, f_off, lat, lon in sondes(n_chan, fs_wide):
        if typ == "RS41":
            bits = _rs41_bits(serial, lat, lon, int(secs * 4800 / 2560) + 1,
                              rng)
            sig = gfsk_mod(bits, fs_wide, 4800, 2, f_off, 4800, bt=0.5)
        elif typ == "DFM":
            bits = _dfm_bits(serial, lat, lon, secs, rng)
            sig = gfsk_mod(bits, fs_wide, 2500, 2, f_off, 5000, bt=0.5)
        elif typ == "IMET4":
            sig = _imet_signal(lat, lon, secs, fs_wide, f_off, rng)
        else:
            sig = gfsk_mod(_wxr_bits(serial, lat, lon, secs), fs_wide, 4800,
                           2, f_off, 50000, bt=1.0)
        if len(sig) < t:
            raise RuntimeError(f"{typ} burst shorter than the capture")
        x += LEVEL.get(serial, 0.2) * sig[:t]
    if carriers is not None:
        n = np.arange(t)
        for f_off in carriers(n_chan, fs_wide):
            x += CARRIER_LEVEL * np.exp(2j * np.pi * (f_off / fs_wide) * n)
    planes = np.stack([x.real, x.imag]) * 32768.0
    return np.clip(np.round(planes), -32768, 32767).astype(np.int16)


def carriers_for(n_chan: int, fs_wide: int):
    """Phase 9's six unmodulated carriers (offsets from the capture
    center): channel centers clear of ``sondes_for``'s channels (and of
    the channel above its off-grid RS41) and of the band edge, spread
    over the capture."""
    from radiosonde_auto_rx_tpu_torch.ops.channelizer import channel_freqs
    f = channel_freqs(n_chan, fs_wide)
    busy = {n_chan // 5, 2 * n_chan // 5, 2 * n_chan // 5 + 1,
            4 * n_chan // 5, n_chan // 2}
    free = [k for k in range(1, n_chan) if k not in busy]
    return [float(f[k]) for k in free[::max(1, len(free) // 6)][:6]]


def split_blocks(stream, fs_wide: int, block_s: int):
    n = block_s * fs_wide
    return [stream[:, i:i + n] for i in range(0, stream.shape[1], n)]


# ---------------------------------------------------------------------- #
# the station

def make_station(device, n_chan: int, fs_wide: int, manual: bool = True,
                 sondes=sondes_for, mesh=None, **config):
    """A port ``Station`` at this geometry (``config`` over STATION_CFG;
    ``mesh``: its mesh, else the station's default), with the RS92
    decoders' test ephemeris (the station never fetches one);
    ``manual``: the sondes start as manual tasks, else the station has
    to find them."""
    from radiosonde_auto_rx_tpu_torch.models.rs92 import make_test_ephemeris
    from radiosonde_auto_rx_tpu_torch.station.station import Station
    st = Station({**STATION_CFG, "capture_rate": fs_wide,
                  "num_channels": n_chan,
                  "rs92_ephemeris": make_test_ephemeris(), **config},
                 center_freq_hz=CENTER, device=device, mesh=mesh)
    if manual:
        for typ, serial, f_off, _, _ in sondes(n_chan, fs_wide):
            st.start_manual_decoder(CENTER + f_off, typ)
    return st


def tasks_of(st):
    """The station's tasks: sorted (type, frequency Hz)."""
    return sorted((v["type"], fz) for fz, v in st.active.items())


def _key(t):
    return (t["type"], t.get("id"), t.get("frame"),
            round(t["lat"], 4), round(t["lon"], 4), round(t["alt"], 1))


def check_telemetry(telems, n_chan: int, fs_wide: int, types,
                    sondes=sondes_for):
    """Every sonde of ``types`` decoded with its serial and a position
    within 1e-4 degree, and nothing else decoded wrong; returns
    {serial: frames decoded}.  An iMet's synthesized id must have its
    form and be one for all its frames."""
    from radiosonde_auto_rx_tpu_torch.station.chains import MODEL_NAME
    seen = {}
    for typ, serial, f_off, lat, lon in sondes(n_chan, fs_wide):
        want = want_id(typ, serial)
        mine = [t for t in telems
                if abs(t["freq_float"] * 1e6 - (CENTER + f_off)) <
                NEAR_HZ.get(typ, 2e3)]
        if not mine and typ in types:
            raise AssertionError(f"{typ} {serial}: no telemetry")
        if want is None:
            ids = {t["id"] for t in mine}
            if len(ids) > 1 or not all(
                    re.fullmatch(r"IMET-[0-9A-F]{8}", i) for i in ids):
                raise AssertionError(f"{typ}: ids {ids}")
            serial = want = ids.pop() if ids else typ
        for t in mine:
            if t["type"] != MODEL_NAME.get(typ, typ) or t["id"] != want:
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
                  manual: bool = True, sondes=sondes_for, setup=None,
                  mesh=None, **config):
    """A station path: for each run (a list of blocks), a new station
    (``make_station``; ``setup(station)`` then, where given), then
    ``process_captures`` per block.  The launch counters are zeroed just
    before and read just after.  Returns ([(station, telemetry, [(tasks
    after the block, block wall ms)])] per run, kernel launches over all
    runs)."""
    import torch
    from radiosonde_auto_rx_tpu_torch import kernels
    cuda = torch.device(device).type == "cuda"
    kernels.reset_launches()
    out = []
    for blocks in runs:
        st = make_station(device, n_chan, fs_wide, manual, sondes, mesh,
                          **config)
        if setup is not None:
            setup(st)
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


def k1_phase(dev):
    """K1 alone through its entry point ``ops.fsk_sf.freq_est_sf`` at every
    shape of K1_SHAPES (counters zeroed just before, read just after; no
    station path launches it, since the scan runs the same stage inside
    its own launch), then each output held against the twin and each
    shape timed beside it.  Returns (the RS41 C=2 entry, launches)."""
    import torch
    from radiosonde_auto_rx_tpu_torch import kernels
    from radiosonde_auto_rx_tpu_torch.demod.fsk import _consts
    from radiosonde_auto_rx_tpu_torch.ops import fsk_sf
    from radiosonde_auto_rx_tpu_torch.tools.profile_station import device_ms
    cases = []
    for seed, (name, c) in enumerate(K1_SHAPES):
        cfg = cfg_of(name)
        g = torch.Generator(device=dev).manual_seed(seed)
        xw = torch.randn(c, 2, cfg.nmem, generator=g, device=dev)
        sf = torch.rand(c, cfg.ndft, generator=g, device=dev)
        k = _consts(cfg, dev)
        cases.append((name, cfg, c, (xw, sf, k.wc, k.ws, k.starts,
                                     k.weights, k.decay)))
    kernels.reset_launches()
    outs = [fsk_sf.freq_est_sf(*args) for *_, args in cases]
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    print(f"phase 2 K1 path (ops.fsk_sf.freq_est_sf at {len(cases)} "
          f"shapes): launches {launches}")
    if launches["freq_est_sf"] != len(cases):
        raise AssertionError("freq_est_sf did not launch its kernel once a "
                             "call")
    entry, worst, shapes = None, 0.0, []
    for (name, cfg, c, args), got in zip(cases, outs):
        want = fsk_sf.freq_est_sf_ref(*args)
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        worst = max(worst, err)
        ms = device_ms(lambda: fsk_sf.freq_est_sf(*args))
        call = device_ms(lambda: fsk_sf.freq_est_sf(*args), ahead=False)
        plain = device_ms(lambda: fsk_sf.freq_est_sf_ref(*args))
        nf, nd = cfg.numffts, cfg.ndft
        # per hop the windowed ndft-point DFT as an FFT (window, FFT), per
        # bin |X| and the weighted hop sum; the EMA
        flops = c * nf * (fft_flops(nd) + 2.0 * nd + 5.0 * nd) + 2.0 * c * nd
        # read once: the window planes, the EMA carry, the window (ndft
        # floats: all of wc/ws that the function needs), the hop starts and
        # weights; written once: the new carry
        nbytes = 4.0 * (c * 2 * cfg.nmem + 2 * c * nd + nd + 2 * nf)
        b_ms, b_by = bound(flops, nbytes)
        print(f"K1 freq_est_sf {name} C={c} nmem={cfg.nmem} ndft={nd} "
              f"hops={nf}: max_abs_err={err:.3e} rel={rel:.3e} "
              f"(tol {K1_TOL}) kernel {ms:.4f} ms ({call:.4f} a call at the "
              f"host's pace), twin {plain:.4f} ms, bound {b_ms:.7f} ms "
              f"({b_by})")
        if not bool(torch.isfinite(got).all()) or rel > K1_TOL:
            raise AssertionError(f"K1 {name} C={c}: disagrees with its twin")
        times = dict(ms=ms, call_ms=call, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None)
        shapes.append(dict(chain=name, channels=c, **times))
        entry = entry or times
    return dict(entry, max_abs_err=worst, shapes=shapes), \
        launches["freq_est_sf"]


def cfg_of(name: str):
    """The demod configuration of a chain of the station's table at the
    rate the station demodulates it (a wideband chain at its own rate;
    "AFSK": the iMet chains' audio demod), or of the FSK4 test
    configuration."""
    from radiosonde_auto_rx_tpu_torch.demod.fsk import FSKConfig
    from radiosonde_auto_rx_tpu_torch.station.chains import CHAIN_TABLE, \
        demod_chain
    if name == "FSK4":
        return FSKConfig(**FSK4_CFG)
    if name == "AFSK":
        name = "IMET4"
    return demod_chain(name, CHAIN_TABLE[name].get("wide_fs", 48000))[0]


def fsk_signal(cfg, channels: int, t_samples: int, seed: int = 0,
               ebno_db: float = 12.0):
    """[C, 2, T] float32 planes of random bits at ``cfg``'s rate: GFSK
    (M = 2) or FSK (M = 4) at the mask's tone spacing (else at the lesser
    of 2 Rs and the search half-width), each channel 300 Hz further off,
    with AWGN at ``ebno_db`` (the port's copy of ``demod/modulate.py``).
    The AFSK configuration gets Bell-202 audio as the station hands it to
    the demod: a real signal (the Q plane zero) with real noise."""
    from radiosonde_auto_rx_tpu_torch.demod.modulate import (
        add_awgn, fsk_mod, gfsk_mod)
    from radiosonde_auto_rx_tpu_torch.models.imet4 import (
        BAUD, afsk_demod_config, afsk_modulate)
    afsk = cfg.fs % BAUD == 0 and cfg == afsk_demod_config(cfg.fs)
    rng = np.random.default_rng(seed)
    spacing = cfg.tone_spacing or min(2 * cfg.rs, cfg.est_max)
    bps = cfg.bits_per_symbol
    rows = []
    for i in range(channels):
        bits = rng.integers(0, 2, (t_samples // cfg.ts + 1) * bps)
        f0 = 300.0 * (i % 8) - 1000.0
        if afsk:
            audio = afsk_modulate(bits.astype(np.uint8), cfg.fs)
            iq = add_awgn(audio[:t_samples].astype(np.complex64), ebno_db,
                          cfg.fs, cfg.rs, bps, rng=rng)
            rows.append(iq.real + 0j)
            continue
        if cfg.m == 4:
            iq = fsk_mod(bits, cfg.fs, cfg.rs, 4, f0 - 1.5 * spacing, spacing)
        else:
            iq = gfsk_mod(bits, cfg.fs, cfg.rs, 2, f0, spacing)
        rows.append(add_awgn(iq[:t_samples], ebno_db, cfg.fs, cfg.rs, bps,
                             rng=rng))
    x = np.stack(rows)
    return np.stack([x.real, x.imag], axis=1).astype(np.float32)


def scan_bound(cfg, c: int, nb: int, span: int | None = None):
    """The scan's least work for ``c`` channels of ``nb`` demod blocks:
    bytes (the input span read once — the buffered scan's rolling buffer
    over ``nb`` blocks, or ``span`` samples, the unbuffered scan's input;
    soft decisions, bits, per-block stats and the state written once)
    and operations (per block and
    channel: the hops' windowed FFTs, |X| and the weighted sum; the
    downconvert of every window sample for every tone, the coarse
    rotation, the integrate-and-dump, the timing line, the resampling
    and the Eb/N0 sums)."""
    m, nd, nf, p = cfg.m, cfg.ndft, cfg.numffts, cfg.p
    nps, ni = cfg.nmem // cfg.tsp, (cfg.nsym + 1) * p
    per_block = (nf * (fft_flops(nd) + 2.0 * nd + 5.0 * nd)
                 + m * cfg.nmem * 8.0 + m * nps * 6.0 + m * ni * 2.0 * p
                 + ni * (4.0 * m + 4.0) + m * cfg.nsym * (4.0 * p + 10.0))
    span = span or (nb - 1) * cfg.n + cfg.nmem + 8 * cfg.ts
    nbits = nb * cfg.nsym * cfg.bits_per_symbol
    nbytes = (4.0 * c * 2 * span + c * nbits * 5.0 + 4.0 * c * nb * (m + 2)
              + 4.0 * 2 * c * (cfg.ndft + 4))
    return bound(c * nb * per_block, nbytes)


def scan_diff(got, want, what: str):
    """The kernel's scan (state, outs) against the twin's: bits, tone
    estimates, ptr and nin equal; soft decisions, spectra and tone
    magnitudes finite and within SCAN_TOL of their peak; timing to 1e-4;
    Eb/N0 within 1e-3 dB + 20 log10(1 + 4e-6 r^2), r = mean/std (the
    float32 variance E[x^2] - E[x]^2 taken in another summation order;
    see tests/test_torch_fsk.py).  Returns the largest soft-decision
    error; raises where they disagree."""
    import torch
    (s_g, o_g), (s_w, o_w) = got, want
    bad = [k for k in ("bits", "f_est") if not torch.equal(o_g[k], o_w[k])]
    bad += [k for k in ("ptr", "nin") if not torch.equal(s_g[k], s_w[k])]
    pairs = [("soft", o_g["soft"], o_w["soft"]), ("sf", s_g["sf"], s_w["sf"])]
    pairs += [(f"probe {k}", o_g[k], o_w[k]) for k in ("sf", "tmag")
              if k in o_w]
    errs = {}
    for k, g, w in pairs:
        errs[k] = float((g - w).abs().max())
        if not bool(g.isfinite().all()) or \
                errs[k] > SCAN_TOL * float(w.abs().max()):
            bad.append(k)
    if "timing" in o_w and \
            float((o_g["timing"] - o_w["timing"]).abs().max()) > 1e-4:
        bad.append("timing")
    r2 = 10 ** ((o_w["ebno_db"].double() + 6.0) / 10.0)
    tol = 1e-3 + 20 * torch.log10(1 + 4e-6 * r2)
    if bool(((o_g["ebno_db"] - o_w["ebno_db"]).abs() > tol).any()):
        bad.append("ebno_db")
    if bad:
        raise AssertionError(f"fsk_scan {what}: disagrees with its twin "
                             f"in {bad} (errors {errs})")
    return errs["soft"]


def _on_cpu(res):
    """A scan's (state, outs) with every tensor copied to the CPU."""
    return tuple({k: v.cpu() for k, v in d.items()} for d in res)


def check_scan(dev, name, cfg, c, seed=0, buffered=True):
    """The scan kernel against its twin on ``c`` channels of 1 s of
    modulated signal with noise: once from the initial state with probe
    outputs, once from the twin's final state (a carried state); against
    the twin run on a CPU copy of the inputs, and (but for
    TWIN_CPU_ONLY) against the twin run on the card.  Then the kernel,
    its call and the twin timed (probe off).  ``buffered=False``: the
    unbuffered mode on the demod CLI's chunk (CLI_CHUNK demod blocks;
    from the carried state the pointer runs past the input, so the
    window starts are clamped)."""
    import torch
    from radiosonde_auto_rx_tpu_torch.demod import fsk
    from radiosonde_auto_rx_tpu_torch.tools.profile_station import (
        device_busy_ms, device_ms)
    cpu = torch.device("cpu")
    t = cfg.fs if buffered else cfg.nmem + CLI_CHUNK * cfg.block_advance_max
    x = torch.from_numpy(fsk_signal(cfg, c, t, seed)).to(dev)
    nb = fsk.fsk_num_blocks_buffered(cfg, t) if buffered \
        else fsk.fsk_num_blocks(cfg, t)
    st0 = fsk.fsk_init_state(cfg, c, dev)
    mode = dict(buffered=buffered)
    want_c = fsk.fsk_scan_ref(cfg, x.cpu(), fsk.fsk_init_state(cfg, c, cpu),
                              nb, probe=True, **mode)
    err = scan_diff(_on_cpu(fsk.fsk_scan(cfg, x, st0, nb, probe=True,
                                         **mode)),
                    want_c, f"{name} C={c} (twin on the CPU)")
    st1 = want_c[0]
    err = max(err, scan_diff(
        _on_cpu(fsk.fsk_scan(cfg, x, {k: v.to(dev) for k, v in st1.items()},
                             nb, **mode)),
        fsk.fsk_scan_ref(cfg, x.cpu(), st1, nb, **mode),
        f"{name} C={c}, carried state (twin on the CPU)"))
    want = fsk.fsk_scan_ref(cfg, x, st0, nb, probe=True, **mode)
    if name in TWIN_CPU_ONLY:
        gap = float((want[1]["soft"].cpu() - want_c[1]["soft"]).abs().max())
        print(f"fsk_scan {name} C={c}: the twin on the card against the twin "
              f"on the CPU: soft max_abs_err={gap:.3e} (peak "
              f"{float(want_c[1]['soft'].abs().max()):.3f}; TWIN_CPU_ONLY)")
    else:
        err = max(err, scan_diff(fsk.fsk_scan(cfg, x, st0, nb, probe=True,
                                              **mode),
                                 want, f"{name} C={c}"))
        st1 = want[0]
        err = max(err, scan_diff(fsk.fsk_scan(cfg, x, st1, nb, **mode),
                                 fsk.fsk_scan_ref(cfg, x, st1, nb, **mode),
                                 f"{name} C={c}, carried state"))
    torch.cuda.synchronize()
    ms = device_ms(lambda: fsk.fsk_scan(cfg, x, st0, nb, **mode))
    call = device_ms(lambda: fsk.fsk_scan(cfg, x, st0, nb, **mode),
                    ahead=False)
    # the twin's thousands of small launches fill the launch queue, so
    # it cannot be queued ahead of the card: its device time is the
    # profiler's sum of its kernels, beside its time at the host's pace
    plain = device_busy_ms(lambda: fsk.fsk_scan_ref(cfg, x, st0, nb,
                                                     **mode))
    plain_call = device_ms(lambda: fsk.fsk_scan_ref(cfg, x, st0, nb, **mode),
                          reps=3, ahead=False)
    b_ms, b_by = scan_bound(cfg, c, nb, None if buffered else t)
    per_block = ms * 1e3 / nb
    print(f"fsk_scan{'' if buffered else ' unbuffered'} {name} C={c} "
          f"blocks={nb} n={cfg.n} ndft={cfg.ndft} "
          f"M={cfg.m}: bits, f_est, ptr, nin equal; soft max_abs_err="
          f"{err:.3e} (tol {SCAN_TOL} of peak; also sf, tmag, Eb/N0; "
          f"initial and carried state; twin on the CPU"
          f"{'' if name in TWIN_CPU_ONLY else ' and on the card'}) kernel {ms:.4f} ms ({call:.4f} a "
          f"call at the host's pace; {per_block:.2f} us per demod block), "
          f"twin {plain:.4f} ms of device time ({plain_call:.4f} a call at "
          f"the host's pace), bound {b_ms:.5f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, call_ms=call, plain_ms=plain,
                plain_call_ms=plain_call, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, us_per_block=per_block)


def check_path_launches(launches, demod_calls: int, path: str):
    """A station path on the card: the scan kernel launched once for each
    demod call that demodulates a block, K1 never on its own, K2 at
    least once."""
    if launches["fsk_scan"] <= 0 or launches["fsk_scan"] != demod_calls:
        raise AssertionError(f"{path} path: {launches['fsk_scan']} scan "
                             f"launches for {demod_calls} demod calls")
    if launches["freq_est_sf"] or launches["fft_abs2"] <= 0:
        raise AssertionError(f"{path} path: launches {launches}")


class DemodCalls:
    """Counts the station's ``fsk_demod_stream`` calls that demodulate
    at least one block (those that launch the scan kernel on a card),
    and the routed experts' ``scan`` calls (one launch each), and the
    host time spent inside them: a wrapper in both callers' modules
    (``parallel/station_step.py``, ``station/station.py``) for the
    duration of a ``with``."""

    def __enter__(self):
        from radiosonde_auto_rx_tpu_torch.demod import fsk
        from radiosonde_auto_rx_tpu_torch.parallel import station_step
        from radiosonde_auto_rx_tpu_torch.station import station
        self.calls, self.host_s = 0, 0.0
        self.by_cfg = {}             # "fs/rs" -> calls
        self.routed = 0              # the experts' scan calls
        self._mods = (station_step, station)
        self._orig = station_step.fsk_demod_stream
        self._scan = station_step.scan

        def scanned(cfg, x, *args, **kw):
            self.calls += 1
            self.routed += 1
            key = f"{cfg.fs}/{cfg.rs}"
            self.by_cfg[key] = self.by_cfg.get(key, 0) + 1
            t0 = time.perf_counter()
            try:
                return self._scan(cfg, x, *args, **kw)
            finally:
                self.host_s += time.perf_counter() - t0
        station_step.scan = scanned

        def counted(cfg, x, *args, **kw):
            if fsk.fsk_num_blocks_buffered(cfg, x.shape[-1]) > 0:
                self.calls += 1
                key = f"{cfg.fs}/{cfg.rs}"
                self.by_cfg[key] = self.by_cfg.get(key, 0) + 1
            t0 = time.perf_counter()
            try:
                return self._orig(cfg, x, *args, **kw)
            finally:
                self.host_s += time.perf_counter() - t0
        for mod in self._mods:
            mod.fsk_demod_stream = counted
        return self

    def __exit__(self, *exc):
        from radiosonde_auto_rx_tpu_torch.parallel import station_step
        for mod in self._mods:
            mod.fsk_demod_stream = self._orig
        station_step.scan = self._scan


def profile_steady(st, blocks, n: int = 4):
    """torch.profiler over ``n`` consecutive steady blocks of a station
    that has run before: per block, the wall (under the profiler), the
    device busy time (every device activity's span), the kernel launches
    (``cudaLaunchKernel`` and its variants) and their host time, and the
    host time inside the demod calls.  Returns a dict."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from radiosonde_auto_rx_tpu_torch.tools.profile_station import \
        device_events
    launch_names = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                    "cuLaunchKernel", "cuLaunchKernelEx")
    walls = []
    with DemodCalls() as dc, profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st.process_captures([blocks[i % len(blocks)]])
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    dev_us = sum(e.time_range.elapsed_us() for e in device_events(prof))
    launch = [e for e in prof.events() if e.name in launch_names and
              e.device_type == DeviceType.CPU]
    return dict(blocks=n, wall_ms=sum(walls) / n,
                device_busy_ms=(dev_us / 1e3 / n) if dev_us else None,
                launches=len(launch) / n,
                launch_host_ms=sum(e.time_range.elapsed_us()
                                   for e in launch) / 1e3 / n,
                demod_calls=dc.calls / n, demod_host_ms=dc.host_s * 1e3 / n)


def check_k2(dev, captures, seed=0):
    import torch
    from radiosonde_auto_rx_tpu_torch.detect.psd import _window_on
    from radiosonde_auto_rx_tpu_torch.ops import fft
    from radiosonde_auto_rx_tpu_torch.tools.profile_station import device_ms
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
    ms = device_ms(lambda: fft.fft_abs2(view, win, True))
    call = device_ms(lambda: fft.fft_abs2(view, win, True), ahead=False)
    plain = device_ms(lambda: fft.fft_abs2_ref(view, win, True))
    # the library call from the same planes and window: complex rows,
    # window, cuFFT, |.|^2, roll
    lib = device_ms(lambda: torch.roll(torch.fft.fft(
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
    from radiosonde_auto_rx_tpu_torch.tools.profile_station import device_ms
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
        ms = device_ms(lambda: fft.fft(x, win, method))
        call = device_ms(lambda: fft.fft(x, win, method), ahead=False)
        plain = device_ms(lambda: fft.fft_ref(x, win))
        # the library call from the same planes and window
        lib = device_ms(lambda: torch.fft.fft(
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


def paths_phase(dev, card):
    """Phase 8: the narrow station's remaining paths on
    ``path_sondes_for``'s capture, by manual tasks and by detection.
    Returns the scan's and K2's launches by drive."""
    import torch
    from radiosonde_auto_rx_tpu_torch import kernels
    sondes = path_sondes_for(N_CHAN, FS_WIDE)
    stream = synth_stream(N_CHAN, FS_WIDE, SECONDS, seed=23,
                          sondes=path_sondes_for)
    runs = [split_blocks(stream, FS_WIDE, 1), split_blocks(stream, FS_WIDE, 2)]
    types = [typ for typ, *_ in sondes]
    want = [(typ, CENTER + f) for typ, _, f, _, _ in sondes]
    # the demod rates of the AFSK audio and of the wide extraction
    afsk, wxr = (f"{c.fs}/{c.rs}" for c in map(cfg_of, ("AFSK", "WXR301")))
    print(f"phase 8 synth: {SECONDS} s of {FS_WIDE} Hz cs16 with "
          f"{[(t, round(f / 1e3, 1)) for t, _, f, _, _ in sondes]} (type, "
          f"kHz from the center), cut into {[len(r) for r in runs]} blocks")
    out = {}
    for manual in (True, False):
        tag = "manual tasks" if manual else "no task"
        with DemodCalls() as calls:
            res, launches = drive_station(dev, runs, N_CHAN, FS_WIDE, manual,
                                          path_sondes_for,
                                          wideband_sondes=True)
        for (st, telems, per_block), need, blocks in zip(
                res, ((), types), runs):
            check_detections(per_block, want)
            seen = check_telemetry(telems, N_CHAN, FS_WIDE, need,
                                   path_sondes_for)
            print(f"phase 8 station, {tag}, {len(blocks)} blocks of "
                  f"{blocks[0].shape[1] // FS_WIDE} s: tasks "
                  f"{per_block[-1][0]}, frames {seen}, stats {st.stats}; "
                  f"block wall ms {[round(ms, 2) for _, ms in per_block]} "
                  f"({card})")
        print(f"phase 8 kernel launches, {tag}: {launches}; demod calls "
              f"{calls.calls} by fs/rs {calls.by_cfg}")
        check_path_launches(launches, calls.calls, f"phase 8 {tag}")
        if not calls.by_cfg.get(afsk) or not calls.by_cfg.get(wxr):
            raise AssertionError(f"phase 8 {tag}: no AFSK ({afsk}) or no "
                                 f"wide ({wxr}) demod call")
        cpu, _ = drive_station(torch.device("cpu"), runs, N_CHAN, FS_WIDE,
                               manual, path_sondes_for, wideband_sondes=True)
        for (_, telems, pb), (_, telems_cpu, pb_cpu) in zip(res, cpu):
            if sorted(map(_key, telems)) != sorted(map(_key, telems_cpu)):
                raise AssertionError(f"phase 8 {tag}: CUDA and CPU stations "
                                     f"decoded different telemetry")
            for (tasks, _), (tasks_cpu, _) in zip(pb, pb_cpu):
                if not same_tasks(tasks, tasks_cpu):
                    raise AssertionError(f"phase 8 {tag}: CUDA and CPU tasks "
                                         f"differ: {tasks} vs {tasks_cpu}")
        print(f"phase 8 reference, {tag}: CPU station had the same tasks "
              f"block by block and decoded the same "
              f"{[len(t) for _, t, _ in cpu]} frames")
        out[tag] = dict(launches=launches, demod_calls=calls.calls)
        if manual:
            # steady 1 s blocks with the four sondes active
            st = res[0][0]
            walls = []
            kernels.reset_launches()
            with DemodCalls() as calls:
                for i in range(8):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    st.process_captures([runs[0][i % len(runs[0])]])
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
            print(f"phase 8 steady 1 s block, four sondes active: median "
                  f"{statistics.median(walls):.2f} ms over {len(walls)} "
                  f"blocks ({card}); launches {dict(kernels.launches)}, "
                  f"demod calls {calls.calls} by fs/rs {calls.by_cfg}")
            check_path_launches(kernels.launches, calls.calls,
                                "phase 8 steady")
    # the detection block on a new station each time (the first 1 s
    # block: scan, confirm, wide scan, collision, decode)
    det_ms = []
    for _ in range(3):
        st = make_station(dev, N_CHAN, FS_WIDE, False, path_sondes_for,
                          wideband_sondes=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st.process_captures([runs[0][0]])
        torch.cuda.synchronize()
        det_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"phase 8 detection block (1 s): {[round(v, 2) for v in det_ms]} "
          f"ms, median {statistics.median(det_ms):.2f} ms ({card})")
    return out


def steady_row(dev, blocks, n: int, **config):
    """``n`` + 1 steady 1 s blocks through a new station with the sondes
    as manual tasks and ``config``: (the block wall ms, the first block
    excluded (it spawns the pool where there is one), the kernel
    launches and the demod calls over all of them)."""
    with DemodCalls() as calls:
        (res,), launches = drive_station(
            dev, [[blocks[i % len(blocks)] for i in range(n + 1)]], N_CHAN,
            FS_WIDE, **config)
    res[0].close()
    return [ms for _, ms in res[2][1:]], launches, calls.calls


def split_rows(dev, runs, fused_results, blocks, groups, card):
    """Phase 6's rows: the inline fused block, (a) the default
    configuration (the frame-plane pool, ``frame_plane_workers`` -1) and
    (b) the split dispatch (``fused_steady_step: false``, inline), timed
    in turns (inline, default, split, split, default, inline; 6 blocks
    each after a first), since the host's pace drifts within a call.
    The split station must decode phase 4's blocks as the fused one did,
    launch the scan once a type group a block and K2 once a block (the
    PSD every block)."""
    with DemodCalls() as calls:
        s_results, s_launches = drive_station(dev, runs, N_CHAN, FS_WIDE,
                                              fused_steady_step=False)
    for (st, telems, _), (_, telems_f, _) in zip(s_results, fused_results):
        if sorted(map(_key, telems)) != sorted(map(_key, telems_f)):
            raise AssertionError("phase 6 (b): the split and the fused "
                                 "stations decoded different telemetry")
        if st.stats.get("fused_channels", 0):
            raise AssertionError("phase 6 (b): the split station served "
                                 "channels from the fused step")
    check_path_launches(s_launches, calls.calls, "phase 6 (b) split")
    configs = {"inline": {}, "default": {"frame_plane_workers": -1},
               "split": {"fused_steady_step": False}}
    walls, n = {}, 6
    for name in ("inline", "default", "split", "split", "default",
                 "inline"):
        ms, launches, n_calls = steady_row(dev, blocks, n, **configs[name])
        walls.setdefault(name, []).extend(ms)
        if name != "split":
            continue
        split_launches = launches
        if launches["fsk_scan"] != groups * (n + 1) or \
                launches["fft_abs2"] != n + 1 or n_calls != groups * (n + 1):
            raise AssertionError(f"phase 6 (b): {launches} over {n + 1} "
                                 f"blocks of {groups} type groups "
                                 f"({n_calls} demod calls)")
    out = {k: statistics.median(v) for k, v in walls.items()}
    out.update(launches=split_launches, blocks=n + 1,
               path_launches=s_launches)
    print(f"phase 6 (b) split dispatch: the same telemetry as the fused "
          f"station on {[len(r) for r in runs]} blocks "
          f"({[len(t) for _, t, _ in s_results]} frames); one scan launch "
          f"a type group and one K2 launch a block ({split_launches} over "
          f"{n + 1} blocks, {groups} type groups)")
    print(f"phase 6 (a)/(b) steady 1 s block with manual tasks, in turns, "
          f"median of {2 * n} blocks each: inline fused "
          f"{out['inline']:.2f} ms, default configuration (pool, "
          f"{os.cpu_count()} cores) {out['default']:.2f} ms, split "
          f"dispatch {out['split']:.2f} ms ({card})")
    return out


# ---------------------------------------------------------------------- #
# phase 9: the sequential station, with the prescreen, and L-band

def lband_stream(fs_wide: int, n_wide: int, seconds: int, seed: int = 31):
    """``seconds`` of a capture centered at LBAND carrying an RS92-NGP
    (``make_calibytes(ngp=True)``, 4800 Bd, 20 kHz tone spacing, as
    ``tests/test_bandplan.py`` builds it) on the center of the second of
    ``n_wide`` wide channels, with ~0.002 RMS noise, as cs16 planes.
    Returns (planes, the sonde's offset from the center)."""
    from radiosonde_auto_rx_tpu_torch.demod.modulate import gfsk_mod
    from radiosonde_auto_rx_tpu_torch.models.rs92 import (
        encode_flight_bits, make_calibytes, make_test_ephemeris)
    from radiosonde_auto_rx_tpu_torch.ops.channelizer import channel_freqs
    rng = np.random.default_rng(seed)
    t = seconds * fs_wide
    raw = encode_flight_bits(
        n_frames=seconds + 2, ephs=make_test_ephemeris(),
        calibytes=make_calibytes(ngp=True, freq_khz=1680000), ngp=True,
        lat=-34.95, lon=138.52, alt=12000.0)
    bits = np.concatenate([np.tile(np.array([1, 0], np.uint8), 300),
                           np.asarray(raw, np.uint8)])
    f_off = float(channel_freqs(n_wide, fs_wide)[1])
    sig = gfsk_mod(bits, fs_wide, 4800, 2, f_off, 20000, bt=0.5)
    if len(sig) < t:
        raise RuntimeError("RS92-NGP burst shorter than the capture")
    x = (rng.standard_normal(t) + 1j * rng.standard_normal(t)) * 0.002
    x += 0.2 * sig[:t]
    planes = np.stack([x.real, x.imag]) * 32768.0
    return np.clip(np.round(planes), -32768, 32767).astype(np.int16), f_off


def mk2lms_channel(seed: int = 5):
    """One 240 kHz channel of an MK2LMS (9616 Bd, 100 kHz tone spacing,
    18 dB Eb/N0), built as ``tests/test_station.py`` builds it: at
    240.4 kHz, resampled 600/601.  [2, T] float32 planes."""
    import torch
    from radiosonde_auto_rx_tpu_torch.demod.modulate import add_awgn, gfsk_mod
    from radiosonde_auto_rx_tpu_torch.models.mk2lms import encode_flight_bits
    from radiosonde_auto_rx_tpu_torch.ops.resample import resample_planes
    rng = np.random.default_rng(seed)
    raw = encode_flight_bits(sid32=7654321, n_frames=4, lat=51.0, lon=7.0,
                             alt=15000.0)
    tx = np.concatenate([np.tile([1, 0], 300), raw,
                         np.tile([1, 0], 300)]).astype(np.uint8)
    iq = add_awgn(gfsk_mod(tx, 240400, 9616, 2, 0.0, 100000, bt=1.0),
                  18.0, 240400, 9616, rng=rng)
    planes = torch.from_numpy(np.stack([iq.real, iq.imag])
                              .astype(np.float32))
    return resample_planes(planes, 240400, 240000).numpy()


def lband_station(device, fs_wide: int, n_wide: int = 0):
    """A port ``Station`` centered at LBAND (the wide profile: 240 kHz
    channels, ``n_wide`` of them, else one per 240 kHz), with the RS92
    decoders' test ephemeris (the station never fetches one)."""
    from radiosonde_auto_rx_tpu_torch.models.rs92 import make_test_ephemeris
    from radiosonde_auto_rx_tpu_torch.station.station import Station
    return Station({**STATION_CFG, "capture_rate": fs_wide,
                    "num_channels": N_CHAN, "num_channels_wide": n_wide,
                    "rs92_ephemeris": make_test_ephemeris()},
                   center_freq_hz=LBAND, device=device)


def _lkey(t):
    return _key(t) + (t.get("subtype"),)


def check_lband(telems, tasks, f_off):
    """The L-band capture's outcome: one RS92NGP task within 2 kHz of
    the sonde's frequency (the task follows the demod's drift estimate),
    its telemetry the RS92-NGP's serial and subtype with a position
    within 5e-4 deg (``tests/test_bandplan.py``'s bound: the position
    comes from GPS pseudoranges)."""
    if len(tasks) != 1 or tasks[0][0] != "RS92NGP" or \
            abs(tasks[0][1] - (LBAND + f_off)) >= 2e3:
        raise AssertionError(f"L-band tasks {tasks}")
    if not telems or any(
            (t["id"], t.get("subtype")) != ("R1234567", "RS92-NGP") or
            abs(t["lat"] + 34.95) > 5e-4 or abs(t["lon"] - 138.52) > 5e-4
            for t in telems):
        raise AssertionError(f"L-band telemetry {[_lkey(t) for t in telems]}")


def record_prescreen(calls):
    """A ``drive_station`` setup that records each call of the station
    detector's prescreen: (input batch, ratios) into ``calls``."""
    def setup(st):
        pre = st.detector.prescreen
        scores = pre.scores

        def recorded(x):
            r = scores(x)
            calls.append((x, r))
            return r
        pre.scores = recorded
    return setup


def seq_phase(dev, card):
    """Phase 9: (a) the narrow station's sequential route with the
    prescreen, (b) the L-band profile.  Returns launches by path."""
    import torch
    from radiosonde_auto_rx_tpu_torch import kernels
    from radiosonde_auto_rx_tpu_torch.detect.prescreen import (MARGIN,
                                                               Prescreen)
    from radiosonde_auto_rx_tpu_torch.tools.profile_station import \
        device_busy_ms
    cpu = torch.device("cpu")
    stream = synth_stream(N_CHAN, FS_WIDE, SECONDS, carriers=carriers_for)
    runs = [split_blocks(stream, FS_WIDE, 1), split_blocks(stream, FS_WIDE, 2)]
    want = [(typ, CENTER + f) for typ, _, f, _, _ in
            sondes_for(N_CHAN, FS_WIDE)]
    print(f"phase 9 synth: phase 3's capture plus carriers at "
          f"{[round(f / 1e3, 1) for f in carriers_for(N_CHAN, FS_WIDE)]} "
          f"kHz from the center, cut into {[len(r) for r in runs]} blocks")
    out = {}
    drives = []
    for d in (dev, cpu):
        screens = []
        with DemodCalls() as calls:
            res, launches = drive_station(d, runs, N_CHAN, FS_WIDE, False,
                                          setup=record_prescreen(screens),
                                          use_mesh=False)
        drives.append((res, launches, calls.calls, screens))
    (res, launches, demod_calls, screens), \
        (cpu_res, _, _, cpu_screens) = drives
    for (st, telems, per_block), types, blocks in zip(
            res, (("RS41",), ("RS41", "DFM")), runs):
        check_detections(per_block, want)
        seen = check_telemetry(telems, N_CHAN, FS_WIDE, types)
        print(f"phase 9 sequential station, no task, {len(blocks)} blocks "
              f"of {blocks[0].shape[1] // FS_WIDE} s: detections "
              f"{st.stats['detections']}, tasks {per_block[-1][0]}, frames "
              f"{seen}; block wall ms "
              f"{[round(ms, 2) for _, ms in per_block]} ({card})")
    print(f"phase 9 kernel launches, sequential: {launches}; demod calls "
          f"{demod_calls}")
    check_path_launches(launches, demod_calls, "phase 9 sequential")
    # the prescreen: once a run, on the first block's nine candidates (the
    # sondes are tasks afterwards), on the card, keeping the sondes only
    if [len(x) for x, _ in screens] != [9, 9] or \
            [len(x) for x, _ in cpu_screens] != [9, 9]:
        raise AssertionError(f"prescreen batches {[len(x) for x, _ in screens]}"
                             f" (card), {[len(x) for x, _ in cpu_screens]} "
                             f"(CPU): expected 9 candidates a run")
    worst = 0.0
    for (x, r), (_, r_c) in zip(screens, cpu_screens):
        if x.device != dev or r.device != dev:
            raise AssertionError("the prescreen did not run on the card")
        keep, keep_c = r.cpu() >= MARGIN, r_c >= MARGIN
        worst = max(worst, float(((r.cpu() - r_c).abs() / r_c.abs()).max()))
        if int(keep.sum()) != 3 or not torch.equal(keep, keep_c):
            raise AssertionError(f"prescreen survivors {keep.tolist()} "
                                 f"(card) vs {keep_c.tolist()} (CPU)")
    print(f"phase 9 prescreen: {len(screens)} calls on the card, 9 rows "
          f"each, 3 kept and 6 carriers rejected (ratios "
          f"{[round(v, 3) for v in screens[0][1].tolist()]}); card vs CPU "
          f"ratios max rel err {worst:.3e} (tol {RATIO_TOL})")
    if worst > RATIO_TOL:
        raise AssertionError("the prescreen's card ratios disagree with "
                             "the CPU's")
    for (_, telems, pb), (_, telems_c, pb_c) in zip(res, cpu_res):
        if sorted(map(_key, telems)) != sorted(map(_key, telems_c)):
            raise AssertionError("phase 9: CUDA and CPU sequential stations "
                                 "decoded different telemetry")
        for (tasks, _), (tasks_c, _) in zip(pb, pb_c):
            if not same_tasks(tasks, tasks_c):
                raise AssertionError(f"phase 9: CUDA and CPU tasks differ: "
                                     f"{tasks} vs {tasks_c}")
    print(f"phase 9 reference: CPU sequential station had the same tasks "
          f"block by block and decoded the same "
          f"{[len(t) for _, t, _ in cpu_res]} frames")
    out["sequential"] = launches
    # device time of the prescreen and, for scale, of the full pass on the
    # same nine rows
    x9 = screens[0][0]
    det = res[0][0].detector
    pre_ms = device_busy_ms(lambda: Prescreen.scores(det.prescreen, x9))
    full_ms = device_busy_ms(lambda: det._detect_full(x9, 1))
    # a sequential 1 s block with the three sondes as tasks (the six
    # carriers go through the full detector, unscreened: 6 < 8)
    st = res[0][0]
    walls = []
    kernels.reset_launches()
    with DemodCalls() as calls:
        for i in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st.process_captures([runs[0][i % len(runs[0])]])
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    check_path_launches(kernels.launches, calls.calls, "phase 9 steady")
    print(f"phase 9 sequential 1 s block, three sondes active: median "
          f"{statistics.median(walls):.2f} ms over {len(walls)} blocks "
          f"({card}); launches {dict(kernels.launches)}, demod calls "
          f"{calls.calls}")
    det_ms = []
    for _ in range(3):
        st = make_station(dev, N_CHAN, FS_WIDE, False, use_mesh=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st.process_captures([runs[0][0]])
        torch.cuda.synchronize()
        det_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"phase 9 detection block with the prescreen (1 s, nine "
          f"candidates): {[round(v, 2) for v in det_ms]} ms, median "
          f"{statistics.median(det_ms):.2f} ms; device time on the 9-row "
          f"candidate batch (profiler sums): the prescreen {pre_ms:.4f} ms, "
          f"the full pass {full_ms:.4f} ms ({card})")

    # (b) L-band: 2.4 MHz at 1680 MHz, ten 240 kHz channels
    lb, f_off = lband_stream(FS_WIDE, 10, SECONDS)
    blocks = split_blocks(lb, FS_WIDE, 2)
    mk = mk2lms_channel()
    got = []
    for d in (dev, cpu):
        kernels.reset_launches()
        with DemodCalls() as calls:
            st = lband_station(d, FS_WIDE)
            telems, walls = [], []
            for blk in blocks:
                t0 = time.perf_counter()
                telems.extend(st.process_captures([blk], [LBAND]))
                if d.type == "cuda":
                    torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            tasks = tasks_of(st)
            mk_t = st.decode_channel(mk, 2, "MK2LMS")
            if d.type == "cuda":
                torch.cuda.synchronize()
        got.append((telems, tasks, mk_t, walls, dict(kernels.launches),
                    calls.calls, calls.by_cfg, st))
    telems, tasks, mk_t, walls, launches, n_calls, by_cfg, st = got[0]
    prof = st.profile()
    check_lband(telems, tasks, f_off)
    if not mk_t or any((t["id"], t.get("subtype")) !=
                       ("LMS6-7654321", "MK2A") or
                       abs(t["lat"] - 51.0) > 1e-4 for t in mk_t):
        raise AssertionError(f"MK2LMS telemetry {[_lkey(t) for t in mk_t]}")
    c_telems, c_tasks, c_mk, *_ = got[1]
    if sorted(map(_lkey, telems)) != sorted(map(_lkey, c_telems)) or \
            tasks != c_tasks or \
            sorted(map(_lkey, mk_t)) != sorted(map(_lkey, c_mk)):
        raise AssertionError("phase 9 L-band: CUDA and CPU stations differ")
    check_path_launches(launches, n_calls, "phase 9 L-band")
    if sorted(by_cfg) != ["240000/4800", "240400/9616"]:
        raise AssertionError(f"phase 9 L-band demod calls {by_cfg}")
    print(f"phase 9 L-band station ({prof.n_chan} x {prof.fs_ch} Hz "
          f"channels at {LBAND / 1e6:.1f} MHz), no task, {len(blocks)} "
          f"blocks of 2 s: detections {st.stats['detections']}, tasks "
          f"{tasks}, RS92-NGP frames {len(telems)}; decode_channel MK2LMS "
          f"frames {len(mk_t)}; CPU station the same; block wall ms "
          f"{[round(ms, 2) for ms in walls]} ({card}); launches {launches}, "
          f"demod calls {n_calls} by fs/rs {by_cfg}")
    out["lband"] = launches
    return out


# ---------------------------------------------------------------------- #
# phase 10: the command lines

# where phase 10 writes its capture, logs and checkpoint (git ignores it)
WORK = Path(__file__).resolve().parent / "build" / "chip_smoke"


def write_cs16(path, planes):
    """int16 [2, T] planes -> an interleaved cs16 file."""
    np.ascontiguousarray(planes.T).astype("<i2").tofile(path)


def log_rows(logdir):
    """{the per-sonde log's name after its wall-clock time: its rows}."""
    return {p.name.split("_", 1)[1]: p.read_text().splitlines()[1:]
            for p in sorted(Path(logdir).glob("*_sonde.log"))}


def _row_key(row):
    """A log row's (serial, frame, lat, lon, alt), as ``_key`` keeps
    them (the log prints lat/lon to 5 decimals, alt to 1)."""
    f = row.split(",")
    return (f[1], int(f[2]), round(float(f[3]), 4), round(float(f[4]), 4),
            round(float(f[5]), 1))


class PoolTickets:
    """Counts the frame-plane tickets resolved by worker processes (a
    wrapper around ``FramePlane.gather`` for the duration of a
    ``with``): ``pooled`` tickets gathered from workers, ``inline``
    gathers of an inline plane."""

    def __enter__(self):
        from radiosonde_auto_rx_tpu_torch.station import frame_plane
        self.pooled, self.inline = 0, 0
        self._cls, self._orig = frame_plane.FramePlane, \
            frame_plane.FramePlane.gather
        orig = self._orig

        def gather(plane, *a, **kw):
            if plane.workers > 0:
                self.pooled += plane._pending
            else:
                self.inline += 1
            return orig(plane, *a, **kw)
        self._cls.gather = gather
        return self

    def __exit__(self, *exc):
        self._cls.gather = self._orig


class HostTime:
    """Host seconds spent inside some functions (each ``(owner, name)``
    wrapped for the duration of a ``with``), by name."""

    def __init__(self, *targets):
        self._targets = targets
        self.seconds = {name: 0.0 for _, name in targets}

    def __enter__(self):
        self._orig = [getattr(owner, name) for owner, name in self._targets]
        for (owner, name), fn in zip(self._targets, self._orig):
            def timed(*a, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.seconds[_name] += time.perf_counter() - t0
            setattr(owner, name, timed)
        return self

    def __exit__(self, *exc):
        for (owner, name), fn in zip(self._targets, self._orig):
            setattr(owner, name, fn)


def compute_pids():
    """PIDs of the processes holding a CUDA context on the host's GPUs,
    one a context, as ``nvidia-smi`` lists them (in another PID
    namespace: only their count means anything here)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return sorted(int(v) for v in out.stdout.split() if v.strip().isdigit())


def maps_cuda_driver(pid) -> bool:
    """Whether process ``pid`` has the CUDA driver library mapped, as
    every process that holds a CUDA context has."""
    with open(f"/proc/{pid}/maps") as f:
        return any("libcuda.so" in line for line in f)


def cli_phase(dev, card):
    """Phase 10: the station's command line and the demod CLI on the card
    (see the module docstring).  Returns its launches and times."""
    import torch
    from radiosonde_auto_rx_tpu_torch import kernels
    from radiosonde_auto_rx_tpu_torch.demod import cli as demod_cli
    from radiosonde_auto_rx_tpu_torch.demod.modulate import (add_awgn,
                                                             gfsk_mod)
    from radiosonde_auto_rx_tpu_torch.models.rs92 import make_test_ephemeris
    from radiosonde_auto_rx_tpu_torch.station import main as cli
    from radiosonde_auto_rx_tpu_torch.station.checkpoint import \
        load_station_state
    from radiosonde_auto_rx_tpu_torch.station.config import default_config
    from radiosonde_auto_rx_tpu_torch.station.frame_plane import FramePlane
    from radiosonde_auto_rx_tpu_torch.station.station import Station
    t_phase = time.perf_counter()
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    out = {}
    # (a) run_station in-process on phase 3's capture as a cs16 file:
    # no task, the pool at the reference's default, a checkpoint, the
    # per-sonde log exporter and the web server on an ephemeral port
    stream = synth_stream(N_CHAN, FS_WIDE, SECONDS)
    cap = WORK / "phase3.cs16"
    write_cs16(cap, stream)
    config = {**default_config(), **STATION_CFG, "frame_plane_workers": -1,
              "capture_rate": FS_WIDE, "num_channels": N_CHAN,
              "rs92_ephemeris": make_test_ephemeris(),
              "sondehub_enabled": False, "aprs_enabled": False,
              "web_port": 0, "web_host": "127.0.0.1"}
    args = cli.parse_args(["--device", str(dev), "--replay", str(cap),
                           "--center",
                           str(CENTER / 1e6), "--log-dir",
                           str(WORK / "log"), "--checkpoint",
                           str(WORK / "station.ckpt")])
    kernels.reset_launches()
    with DemodCalls() as calls, PoolTickets() as tickets:
        t0 = time.perf_counter()
        rc = cli.run_station(args, config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    if rc != cli.EXIT_OK:
        raise AssertionError(f"phase 10 run_station exited {rc}")
    check_path_launches(launches, calls.calls, "phase 10 CLI")
    if tickets.pooled <= 0 or tickets.inline:
        raise AssertionError(f"phase 10: {tickets.pooled} tickets served by "
                             f"workers, {tickets.inline} inline gathers")
    blocks = split_blocks(stream, FS_WIDE, 2)
    (ref,), _ = drive_station(dev, [blocks], N_CHAN, FS_WIDE, manual=False)
    rows = log_rows(WORK / "log")
    got = sorted(_row_key(r) for v in rows.values() for r in v)
    want = sorted(k[1:] for k in map(_key, ref[1]))
    if got != want or not got:
        raise AssertionError(f"phase 10: the CLI's log rows {got} are not "
                             f"drive_station's telemetry {want}")
    seen = check_telemetry(ref[1], N_CHAN, FS_WIDE, ("RS41", "DFM"))
    resumed = make_station(dev, N_CHAN, FS_WIDE, manual=False)
    if not load_station_state(resumed, str(WORK / "station.ckpt")) or \
            sorted(v["type"] for v in resumed.active.values()) != \
            sorted(v["type"] for v in ref[0].active.values()):
        raise AssertionError("phase 10: the checkpoint does not hold the "
                             "station's tasks")
    resumed.close()
    out["cli"] = dict(launches=launches, demod_calls=calls.calls,
                      pooled_tickets=tickets.pooled, wall_s=wall)
    print(f"phase 10 (a) run_station on {SECONDS} s of cs16 ({len(blocks)} "
          f"blocks of 2 s, no task, the pool at -1 on {os.cpu_count()} "
          f"cores, checkpoint, log exporter, web server on port 0): exit "
          f"{rc} in {wall:.2f} s; logs {sorted(rows)} = drive_station's "
          f"telemetry {seen}; {tickets.pooled} tickets served by workers; "
          f"launches {launches}, demod calls {calls.calls} ({card})")
    # the steady 1 s block with the pool and without it, in turns, with
    # the host time in the frame decode: inline, the station's decode
    # calls; pooled, the enqueue of the tickets and the wait for them
    # nvidia-smi's PIDs are another PID namespace's: count the apps
    # (this process's context, before any worker exists) and read the
    # workers' own memory maps
    apps_before = compute_pids()
    if not maps_cuda_driver(os.getpid()):
        raise AssertionError("phase 10: this process does not map the CUDA "
                             "driver, so the workers' maps prove nothing")
    walls, decode_s = {}, {}
    for workers in (0, -1, -1, 0):
        with HostTime((Station, "_decode_frames"), (FramePlane, "decode"),
                      (FramePlane, "gather")) as ht:
            (res,), _ = drive_station(
                dev, [split_blocks(stream, FS_WIDE, 1) * 2], N_CHAN,
                FS_WIDE, frame_plane_workers=workers)
        st = res[0]
        for k, v in ht.seconds.items():
            decode_s.setdefault(workers, {}).setdefault(k, []).append(
                v / len(res[2]))
        if workers:
            out["routes"] = {fz: st.frame_plane._route(fz)
                             for fz in sorted(st.active)}
            procs = [p.pid for p in st.frame_plane._procs]
            apps = compute_pids()
            driver = [p for p in procs if maps_cuda_driver(p)]
            if not procs or driver or len(apps) > len(apps_before):
                raise AssertionError(
                    f"phase 10: pool workers {procs}, of which {driver} map "
                    f"the CUDA driver; compute apps {apps} (before the pool "
                    f"{apps_before})")
        st.close()
        walls.setdefault(workers, []).extend(ms for _, ms in res[2][1:])
    out["block_ms"] = {("pool" if k else "inline"): statistics.median(v)
                       for k, v in walls.items()}
    out["decode_host_ms"] = {
        ("pool" if k else "inline"): {
            name: 1e3 * statistics.mean(v) for name, v in d.items() if any(v)}
        for k, d in decode_s.items()}
    print(f"phase 10 (a) steady 1 s block with manual tasks, median of "
          f"{len(walls[0])} blocks each: inline "
          f"{out['block_ms']['inline']:.2f} ms, pool "
          f"{out['block_ms']['pool']:.2f} ms; host ms a block "
          f"(first block included) in the frame decode "
          f"{json.dumps(out['decode_host_ms'])}; the tasks' workers "
          f"{out['routes']}; pool workers hold "
          f"no CUDA context (none maps the CUDA driver; nvidia-smi compute "
          f"apps {len(apps_before)} before the pool and with it) ({card})")
    # (b) the station as a user starts it, single-frequency, in a child
    cfg_file = WORK / "station.cfg"
    cfg_file.write_text("[filtering]\nsonde_time_threshold = 1000000\n")
    typ, serial, f_off, _, _ = sondes_for(N_CHAN, FS_WIDE)[0]
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "radiosonde_auto_rx_tpu_torch", "-c",
         str(cfg_file), "--replay", str(cap), "--center",
         str(CENTER / 1e6), "-f", f"{(CENTER + f_off) / 1e6:.6f}", "-m",
         typ, "--no-web", "--log-dir", str(WORK / "log_f")],
        capture_output=True, text=True, timeout=300,
        cwd=Path(__file__).resolve().parent)
    if res.returncode != 0:
        raise AssertionError(f"phase 10 (b): exit {res.returncode}\n"
                             f"{res.stderr[-3000:]}")
    rows_f = log_rows(WORK / "log_f")
    if [k.split("_")[0] for k in rows_f] != [serial] or \
            not rows_f[next(iter(rows_f))]:
        raise AssertionError(f"phase 10 (b): logs {rows_f}")
    print(f"phase 10 (b) python -m radiosonde_auto_rx_tpu_torch --replay "
          f"-f -m {typ}: exit 0 in {time.perf_counter() - t0:.2f} s, "
          f"{len(next(iter(rows_f.values())))} rows in {sorted(rows_f)}")
    # (c) the demod CLI on an RS41 stream of test frames, on the card and
    # on the CPU: the same hard bits
    secs = 4
    tx = np.tile(demod_cli.test_frame_bits(), secs * 4800 // 100 + 1)
    iq = add_awgn(gfsk_mod(tx, 48000, 4800, 2, 0.0, 5000), 14.0, 48000,
                  4800, rng=np.random.default_rng(9))[:secs * 48000]
    wire = np.empty(2 * len(iq), np.int16)
    wire[0::2] = np.clip(iq.real * 16384, -32767, 32767)
    wire[1::2] = np.clip(iq.imag * 16384, -32767, 32767)
    argv = ["-p", "5", "--nsym", "300", "-b", "-5000", "-u", "5000",
            "--mask", "5000", "--hardout", "--testframes", "2", "48000",
            "4800", "-", "-"]
    runs = {}
    for device in ("cuda", "cpu"):
        o, e = io.BytesIO(), io.StringIO()
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = demod_cli.run(demod_cli.parse_args(["--device", device] + argv),
                           stdin=io.BytesIO(wire.tobytes()), stdout=o,
                           stderr=e)
        torch.cuda.synchronize()
        runs[device] = (rc, o.getvalue(), e.getvalue(),
                        time.perf_counter() - t0, dict(kernels.launches))
    (rc_g, bits_g, err_g, wall_g, l_g), (rc_c, bits_c, _, wall_c, l_c) = \
        runs["cuda"], runs["cpu"]
    frames = [ln for ln in err_g.splitlines() if "FSK BER" in ln]
    n_chunks = l_g["fsk_scan_unbuffered"]
    if rc_g or rc_c or bits_g != bits_c or not bits_g or not frames or \
            n_chunks <= 0 or l_g["fsk_scan"] != n_chunks or \
            l_g["freq_est_sf"] or any(l_c.values()):
        raise AssertionError(f"phase 10 (c): rc {rc_g}/{rc_c}, bits equal "
                             f"{bits_g == bits_c} ({len(bits_g)}), frames "
                             f"{len(frames)}, launches {l_g} / {l_c}")
    out["demod_cli"] = dict(launches=l_g, seconds=secs, wall_s=wall_g,
                            cpu_wall_s=wall_c, realtime=secs / wall_g)
    print(f"phase 10 (c) demod CLI, RS41 test frames, {secs} s at 48 kHz: "
          f"{len(bits_g)} bits equal on the card and the CPU; "
          f"{len(frames)} test frames, last: {frames[-1]}; {n_chunks} "
          f"unbuffered scan launches ({CLI_CHUNK} demod blocks a call); "
          f"wall {wall_g:.3f} s on the card ({secs / wall_g:.1f}x real "
          f"time), {wall_c:.3f} s on the CPU ({card})")
    print(f"phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 11: the PER gate's off-grid points run on the card (the others
# run in the CPU tests)
OFFGRID_ON_CARD = ("RS41", "DFM", "M10")


# phase 11: the card's received frames against the CPU path's on the same
# IQ, at most this share of a point's frames apart (the frames received by
# one and not the other; a bit decided near zero soft decision at the
# cliff may part the two summation orders)
PER_TWIN_TOL = 0.03


def per_gate_points():
    """Phase 11's PER gate points from ``docs/per_r5.csv``'s recorded
    ``tpu`` rows, as ``tests/test_per_gate.py`` takes them: (type, f_off,
    Eb/N0, frames, seed, recorded PER, limit).  Each type at its gate
    point on the centered rows (100 frames, seed 123, limit
    max(recorded + 0.20, 0.35)), then the +-20 kHz points of
    ``OFFGRID_ON_CARD`` (50 frames, seed 321, max(recorded + 0.25,
    0.45))."""
    import csv
    from radiosonde_auto_rx_tpu_torch.tools.per_harness import CASES
    from radiosonde_auto_rx_tpu_torch.tools.per_offgrid import gate_point
    with open(Path(__file__).resolve().parent / "docs" / "per_r5.csv") as f:
        rows = [r for r in csv.DictReader(f) if r["chain"] == "tpu"]
    centered = [r for r in rows if float(r.get("f_off") or 0.0) == 0.0]
    points = []
    for typ in sorted(CASES):
        e = gate_point(centered, typ)
        rec = next(float(r["per"]) for r in centered
                   if r["type"] == typ and float(r["ebno_db"]) == e)
        points.append((typ, 0.0, e, 100, 123, rec, max(rec + 0.20, 0.35)))
    for r in rows:
        f_off = float(r.get("f_off") or 0.0)
        if f_off and r["type"] in OFFGRID_ON_CARD:
            rec = float(r["per"])
            points.append((r["type"], f_off, float(r["ebno_db"]), 50, 321,
                           rec, max(rec + 0.25, 0.45)))
    return points


def per_frames(typ, ebno, n, seed, f_off, device):
    """``tools.per_harness.run_point`` of one PER point on ``device``,
    and the set of frame identities its decoder returned."""
    from radiosonde_auto_rx_tpu_torch.tools import per_harness
    build, got = per_harness.CASES[typ], set()

    def recording(n_frames, rng, workdir):
        case = build(n_frames, rng, workdir)
        decode = case.decode

        def recorded(bits, soft):
            telems = decode(bits, soft)
            got.update(t.get("frame") for t in telems)
            return telems
        case.decode = recorded
        return case
    per_harness.CASES[typ] = recording
    try:
        row, = per_harness.run_point(typ, ebno, n, seed, f_off=f_off,
                                     device=device)
    finally:
        per_harness.CASES[typ] = build
    return row, got


def tools_phase(dev, card, blocks):
    """Phase 11: the quality tools on the card.  (a) The PER gate: each
    point of ``per_gate_points`` through ``tools.per_harness.run_point``
    on the card, one scan launch a point (counters zeroed just before,
    read just after), each PER within its limit, and the frames it
    received within ``PER_TWIN_TOL`` of the CPU path's on the same IQ;
    (b)
    ``tools.profile_station`` at its geometry, every stage's result on
    the card, the PSD one K2 launch and the demod one scan launch; (c)
    ``utils.probe.trace`` around one steady block: a Chrome trace that
    names the scan kernel; (d) ``run_point("RS41", 18.0, 5)`` with its
    demod's probe outputs fed to ``probe.capture_demod_internals``: the
    spectrum [1, blocks, ndft] with the tones at +-2400 Hz."""
    import torch
    from radiosonde_auto_rx_tpu_torch import kernels
    from radiosonde_auto_rx_tpu_torch.tools import (per_harness,
                                                    profile_station)
    from radiosonde_auto_rx_tpu_torch.utils import probe
    t_phase = time.perf_counter()
    out = dict(per=[])
    points = per_gate_points()
    clock = per_harness._gps_now_plus
    per_harness._gps_now_plus = per_harness.pinned_gps_now_plus
    try:
        for typ, f_off, e, n, seed, rec, limit in points:
            kernels.reset_launches()
            t0 = time.perf_counter()
            row, got = per_frames(typ, e, n, seed, f_off, dev)
            secs = time.perf_counter() - t0
            launches = dict(kernels.launches)
            if launches["fsk_scan"] != 1 or launches["freq_est_sf"]:
                raise AssertionError(f"phase 11 (a) {typ} f_off {f_off}: "
                                     f"launches {launches}")
            # the same point through the plain twin on the CPU
            cpu, want = per_frames(typ, e, n, seed, f_off,
                                   torch.device("cpu"))
            apart = len(got ^ want)
            out["per"].append(dict(
                type=typ, f_off=f_off, ebno_db=e, frames=n, per=row["per"],
                cpu_per=cpu["per"], frames_apart=apart, recorded=rec,
                limit=limit, fsk_scan=launches["fsk_scan"], seconds=secs))
            print(f"phase 11 (a) PER gate {typ:8s} f_off "
                  f"{f_off / 1e3:+5.0f} kHz at {e:4.1f} dB: PER "
                  f"{row['per']:.3f} ({n} frames; the CPU's "
                  f"{cpu['per']:.3f}, {apart} frames apart), recorded "
                  f"{rec:.4f}, limit {limit:.4f}; fsk_scan launches "
                  f"{launches['fsk_scan']}; {secs:.2f} s on the card",
                  flush=True)
            if row["per"] > limit:
                raise AssertionError(f"phase 11 (a) {typ} f_off {f_off}: "
                                     f"PER {row['per']} over {limit}")
            if apart > PER_TWIN_TOL * n:
                raise AssertionError(
                    f"phase 11 (a) {typ} f_off {f_off}: the card received "
                    f"{sorted(got - want, key=str)} and not "
                    f"{sorted(want - got, key=str)} of the CPU path's frames")
    finally:
        per_harness._gps_now_plus = clock
    same = sum(not p["frames_apart"] for p in out["per"])
    print(f"phase 11 (a) {len(points)} PER gate points on the card, each "
          f"within its limit and within {PER_TWIN_TOL} of its frames of "
          f"the CPU path's on the same IQ, {same} of them receiving the "
          f"same frames, in {time.perf_counter() - t_phase:.1f} s ({card})")
    # (b) the per-stage split of the station step at its bench geometry
    print(f"phase 11 (b) profile_station: B {profile_station.B} captures "
          f"of {profile_station.T_WIDE} samples, {profile_station.N_CHAN} "
          f"channels ({card})")
    stages = profile_station.profile(dev)
    for name, st in stages.items():
        if torch.device(st["device"]).type != dev.type:
            raise AssertionError(f"phase 11 (b) {name} ran on {st['device']}")
    psd, demod = stages["welch_psd hop=4*nfft"], \
        stages["fsk_demod(all channels)"]
    if psd["launches"] != {"fft_abs2": 1} or \
            demod["launches"] != {"fsk_scan": 1}:
        raise AssertionError(f"phase 11 (b): PSD launches "
                             f"{psd['launches']}, demod {demod['launches']}")
    out["profile"] = stages
    # (c) a trace around one steady block of a station with tasks
    st = make_station(dev, N_CHAN, FS_WIDE)
    st.process_captures([blocks[0]])
    trace_dir = WORK / "trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    with probe.trace(str(trace_dir)):
        st.process_captures([blocks[1]])
    st.close()
    trace = (trace_dir / "trace.json").read_text()
    if "fsk_scan" not in trace:
        raise AssertionError("phase 11 (c): the trace names no fsk_scan")
    print(f"phase 11 (c) probe.trace around one steady block: "
          f"{trace_dir / 'trace.json'} ({len(trace)} bytes) names the scan "
          f"kernel {trace.count('fsk_scan_kernel')} times")
    # (d) the demod's internals through the probe registry
    orig = per_harness.fsk_demod_stream

    def probed(cfg, x, device, **kw):
        res = orig(cfg, x, device, probe=True, **kw)
        probe.capture_demod_internals(res[2])
        return res
    probe.enable(True)
    probe.reset()
    per_harness.fsk_demod_stream = probed
    kernels.reset_launches()
    try:
        row, = per_harness.run_point("RS41", 18.0, 5, device=dev)
        sf = probe.probe_stream("fsk_sf")
    finally:
        per_harness.fsk_demod_stream = orig
        probe.enable(False)
        probe.reset()
    cfg = per_harness.CASES["RS41"](1, None, None).cfg
    top = (np.argsort(sf[0, -1])[-8:] - cfg.ndft // 2) * cfg.fs / cfg.ndft
    humps = [any(abs(b - f) < 800 for b in top) for f in (-2400, 2400)]
    if sf.ndim != 3 or sf.shape[0] != 1 or sf.shape[2] != cfg.ndft or \
            not all(humps) or row["frames_rx"] != 5 or \
            kernels.launches["fsk_scan"] != 1:
        raise AssertionError(f"phase 11 (d): fsk_sf {sf.shape}, tone bins "
                             f"{top}, {row}, launches {kernels.launches}")
    out["probe_launches"] = kernels.launches["fsk_scan"]
    print(f"phase 11 (d) run_point RS41 18 dB, 5 frames, probed on the "
          f"card: {row['frames_rx']} frames; fsk_sf {list(sf.shape)}, the "
          f"strongest bins of the last block at {sorted(top.tolist())} Hz")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 11 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------- #
# phase 12: the mesh on the card (virtual meshes on one device)

MESH_SEED = 22                   # (b)'s second capture
MESH_WALL_REPS = 5               # (a)'s walls: turns of each station
# (c): the demod pipeline's frames (the RS41 test frame encoder of
# tests/test_pp.py) and microbatch
PP_CFG = dict(fs=48000, rs=4800, m=2, p=5, nsym=50, est_min=-5000,
              est_max=5000, tone_spacing=5000, freq_est_type=1)
PP_T_MB = 12000


class RouteLog:
    """Records, for the duration of a ``with``, every channel that
    ``StationStep.route_demod`` routes, as (expert, the channel's source
    ch-shard, the expert's ch-shard)."""

    def __enter__(self):
        from radiosonde_auto_rx_tpu_torch.parallel.station_step import \
            StationStep
        self.routes, self._orig = [], StationStep.route_demod
        log = self

        def logged(step, channels, expert_ids):
            res = log._orig(step, channels, expert_ids)
            c_l = next(iter(channels.values())).shape[0]
            for (i, j), ids in res["ids"].items():
                if j:
                    continue             # t-shards repeat the routing
                ids, mask = ids.cpu().numpy(), res["mask"][(i, j)].cpu(
                    ).numpy()
                for slot, s in zip(*np.nonzero(mask)):
                    log.routes.append((i * step.e_local + int(slot),
                                       int(ids[slot, s]) // c_l, i))
            return res
        StationStep.route_demod = logged
        return self

    def __exit__(self, *exc):
        from radiosonde_auto_rx_tpu_torch.parallel.station_step import \
            StationStep
        StationStep.route_demod = self._orig


def drive_batches(device, batches, mesh=None, manual=False, **config):
    """A new station (``make_station``; its sondes as manual tasks or
    none) and ``process_captures`` of each batch (a list of blocks; one
    center).  The launch counters are zeroed just before and read just
    after.  Returns ((station, telemetry, [tasks after each batch]),
    kernel launches)."""
    import torch
    from radiosonde_auto_rx_tpu_torch import kernels
    kernels.reset_launches()
    st = make_station(device, N_CHAN, FS_WIDE, manual, mesh=mesh, **config)
    telems, per = [], []
    for batch in batches:
        telems.extend(st.process_captures(list(batch)))
        per.append(tasks_of(st))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return (st, telems, per), dict(kernels.launches)


def same_run(a, b, what: str):
    """Two drives decoded the same telemetry and hold the same tasks
    after every batch."""
    (_, tel_a, per_a), (_, tel_b, per_b) = a, b
    if sorted(map(_key, tel_a)) != sorted(map(_key, tel_b)):
        raise AssertionError(f"{what}: different telemetry")
    if len(per_a) != len(per_b) or not all(
            same_tasks(x, y) for x, y in zip(per_a, per_b)):
        raise AssertionError(f"{what}: different tasks {per_a} vs {per_b}")


def host_waits(fn) -> dict:
    """torch.profiler around ``fn()`` after a warm-up call: the host's
    waits on the device (``cuda*Synchronize`` calls) inside it and the
    device-to-host copies, either of which serializes a real mesh's
    shards."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("host_waits"):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    (span,) = [e.time_range for e in events if e.name == "host_waits"
               and e.device_type == DeviceType.CPU]
    return dict(synchronize=sum(
        "Synchronize" in e.name and
        span.start <= e.time_range.start <= span.end for e in events),
        dtoh=sum("DtoH" in e.name for e in events))


def mesh_phase(dev, card, stream):
    """Phase 12: the station and the module paths on virtual meshes of
    the card (every shard on ``dev``), each held to the CPU port on the
    same mesh.  Returns launches, walls and the route check."""
    import torch
    from radiosonde_auto_rx_tpu_torch import kernels
    from radiosonde_auto_rx_tpu_torch.parallel.mesh import make_mesh
    from radiosonde_auto_rx_tpu_torch.parallel.station_step import \
        EXPERT_TYPES
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    out = {}
    want = [(typ, CENTER + f) for typ, _, f, _, _ in
            sondes_for(N_CHAN, FS_WIDE)]
    blocks = split_blocks(stream, FS_WIDE, 1)

    # (a) (ch, t) = (8, 1): the batch of four 1 s blocks (padded to 8),
    # then the blocks one at a time, no task
    m8 = make_mesh(8, 1, devices=[dev] * 8)
    with RouteLog() as routes, DemodCalls() as calls:
        batch, l_batch = drive_batches(dev, [blocks], m8)
    check_path_launches(l_batch, calls.calls, "phase 12 (a) batch")
    if calls.routed <= 0:
        raise AssertionError("phase 12 (a): no expert demod ran")
    check_detections([(batch[2][-1], 0.0)], want)
    seen = check_telemetry(batch[1], N_CHAN, FS_WIDE, ("RS41",))
    # RS41 (expert 0) lands on shard 0, DFM (expert 2) on shard 1
    landed = {(EXPERT_TYPES[e], dst) for e, _, dst in routes.routes}
    moved = sorted({(EXPERT_TYPES[e], src, dst)
                    for e, src, dst in routes.routes if src != dst})
    if landed != {("RS41", 0), ("DFM", 1)} or not moved:
        raise AssertionError(f"phase 12 (a): routes {routes.routes}")
    cpu_batch, _ = drive_batches(cpu, [blocks],
                                 make_mesh(8, 1, devices=[cpu] * 8))
    same_run(batch, cpu_batch, "phase 12 (a) batch, card vs CPU mesh")
    (seq,), l_seq = drive_station(dev, [blocks], N_CHAN, FS_WIDE,
                                  manual=False, use_mesh=False)
    if not same_tasks(batch[2][-1], seq[2][-1][0]):
        raise AssertionError("phase 12 (a): the batch detected other "
                             "sondes than the use_mesh: false station")
    with DemodCalls() as calls1:
        (one,), l_one = drive_station(dev, [blocks], N_CHAN, FS_WIDE,
                                      manual=False, mesh=m8)
    check_path_launches(l_one, calls1.calls, "phase 12 (a) one at a time")
    same_run((one[0], one[1], [t for t, _ in one[2]]),
             (seq[0], seq[1], [t for t, _ in seq[2]]),
             "phase 12 (a) one at a time, mesh vs use_mesh: false")
    print(f"phase 12 (a) (8, 1) mesh on {dev}: batch of {len(blocks)} 1 s "
          f"blocks: tasks {batch[2][-1]}, frames {seen}, stats "
          f"{batch[0].stats}; routed across shards (type, from, to) "
          f"{moved}; launches {l_batch} for {calls.calls} demod calls "
          f"({calls.routed} expert scans); the same telemetry and tasks "
          f"as the CPU (8, 1) mesh and the tasks of the use_mesh: false "
          f"station")
    print(f"phase 12 (a) blocks one at a time: the telemetry and tasks of "
          f"the card's use_mesh: false station ({len(one[1])} frames); "
          f"launches {l_one} for {calls1.calls} demod calls")
    out["batch_launches"], out["one_launches"] = l_batch, l_one
    out["moved"] = moved

    # (b) (2, 2), mesh_time_shards 2: two 4 s captures, one a batch
    m22 = make_mesh(2, 2, devices=[dev] * 4)
    caps = [[stream], [synth_stream(N_CHAN, FS_WIDE, SECONDS,
                                    seed=MESH_SEED)]]
    with DemodCalls() as calls2:
        tsh, l_tsh = drive_batches(dev, caps, m22, mesh_time_shards=2)
    check_path_launches(l_tsh, calls2.calls, "phase 12 (b)")
    seen2 = check_telemetry(tsh[1], N_CHAN, FS_WIDE, ("RS41", "DFM"))
    cpu_tsh, _ = drive_batches(cpu, caps, make_mesh(2, 2, devices=[cpu] * 4),
                               mesh_time_shards=2)
    same_run(tsh, cpu_tsh, "phase 12 (b), card vs CPU mesh")
    seq2, _ = drive_batches(dev, caps, use_mesh=False)
    same_run(tsh, seq2, "phase 12 (b), mesh vs use_mesh: false")
    halo = tsh[0]._steps[(N_CHAN, FS_WIDE // N_CHAN)].halo_max
    print(f"phase 12 (b) (2, 2) mesh, mesh_time_shards 2, two {SECONDS} s "
          f"captures (seeds 21, {MESH_SEED}): frames {seen2}, tasks "
          f"{tsh[2][-1]}, demod halo {halo} channel samples; launches "
          f"{l_tsh} for {calls2.calls} demod calls; "
          f"the same telemetry and tasks as the CPU (2, 2) mesh and the "
          f"use_mesh: false station")
    out["tshard_launches"] = l_tsh

    # (c) the module paths
    from radiosonde_auto_rx_tpu_torch.demod.fsk import fsk_demod_stream
    from radiosonde_auto_rx_tpu_torch.ops.fir import (
        _conv_valid, design_lowpass)
    from radiosonde_auto_rx_tpu_torch.parallel.pipeline import \
        make_station_step
    from radiosonde_auto_rx_tpu_torch.parallel.pp import make_stage_mesh
    cfg = cfg_of("RS41")
    taps = design_lowpass(0.2, 25)
    T = 2 * 48000
    x = np.zeros((52, 2, T), np.float32)    # 50 channels, 2 zero rows
    x[:N_CHAN] = fsk_signal(cfg, N_CHAN, T, seed=12)
    xd = torch.from_numpy(x).to(dev)
    kernels.reset_launches()
    sstep = make_station_step(cfg, make_mesh(4, 2, devices=[dev] * 8), taps)
    soft, bits = sstep(xd)
    torch.cuda.synchronize()
    l_step = dict(kernels.launches)
    # the unsharded card reference: the zero-state FIR of the whole
    # stream, then each t-shard's demod from its halo (zeros on shard 0)
    K, halo, t_l = len(taps), cfg.nmem + 8 * cfg.ts, T // 2
    y = _conv_valid(torch.cat([torch.zeros((104, K - 1), device=dev),
                               xd.reshape(104, T)], dim=-1),
                    taps).reshape(52, 2, T)
    seg = bits.shape[1] // 2
    for k, part in enumerate((
            torch.cat([torch.zeros((52, 2, halo), device=dev),
                       y[..., :t_l]], dim=-1), y[..., t_l - halo:])):
        _, b_ref, _, _ = fsk_demod_stream(cfg, part.contiguous(), dev)
        if not torch.equal(bits[:N_CHAN, k * seg:(k + 1) * seg],
                           b_ref[:N_CHAN]):
            raise AssertionError(f"phase 12 (c) make_station_step: t-shard "
                                 f"{k}'s bits differ from the unsharded "
                                 f"demod")
    if l_step["fsk_scan"] != 8 or l_step["freq_est_sf"]:
        raise AssertionError(f"phase 12 (c) make_station_step launches "
                             f"{l_step}")
    print(f"phase 12 (c) make_station_step (IF FIR + demod) on a (4, 2) "
          f"mesh, {N_CHAN} RS41 channels of {T} samples: bits equal the "
          f"unsharded card demod on every row and t-shard; launches "
          f"{l_step}")
    M = pp_input()[1]
    pp_out, l_pp = [], None
    for d in (dev, cpu):
        kernels.reset_launches()
        pp_out.append(pp_run(make_stage_mesh(3, devices=[d] * 3)))
        if l_pp is None:
            torch.cuda.synchronize()
            l_pp = dict(kernels.launches)
    (soft_g, bits_g), (soft_c, bits_c) = pp_out
    if not torch.equal(bits_g.cpu(), bits_c):
        raise AssertionError("phase 12 (c) pp demod: card and CPU bits "
                             "differ")
    telems = pp_telemetry(soft_g, bits_g)
    if not telems or telems[0]["id"] != "S0930112":
        raise AssertionError(f"phase 12 (c) pp demod decoded {telems}")
    if l_pp["fsk_scan_unbuffered"] != M or l_pp["freq_est_sf"]:
        raise AssertionError(f"phase 12 (c) pp launches {l_pp}")
    print(f"phase 12 (c) make_pp_demod_pipeline on a 3-stage mesh, {M} "
          f"microbatches of {PP_T_MB}: {len(telems)} RS41 frames decoded, "
          f"bits equal the CPU port's; launches {l_pp}")
    out["station_step_launches"], out["pp_launches"] = l_step, l_pp

    # walls: (a)'s batched block against the default 1x1 station's, in
    # turns, both steady (the three sondes as manual tasks)
    st_mesh = make_station(dev, N_CHAN, FS_WIDE, mesh=m8)
    st_one = make_station(dev, N_CHAN, FS_WIDE)
    walls = {"mesh (8, 1)": [], "default 1x1": []}
    for st in (st_mesh, st_one):
        st.process_captures(blocks)             # warm: tasks, caches
    for _ in range(MESH_WALL_REPS):
        for tag, st in (("mesh (8, 1)", st_mesh), ("default 1x1", st_one)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st.process_captures(blocks)
            torch.cuda.synchronize()
            walls[tag].append((time.perf_counter() - t0) * 1e3 /
                              len(blocks))
    from radiosonde_auto_rx_tpu_torch.tools.profile_station import \
        device_busy_ms
    busy = {tag: device_busy_ms(lambda st=st: st.process_captures(blocks),
                                reps=2) / len(blocks)
            for tag, st in (("mesh (8, 1)", st_mesh),
                            ("default 1x1", st_one))}
    step = st_mesh._steps[(N_CHAN, FS_WIDE // N_CHAN)]
    wide = torch.stack([st_mesh._wide_planes(b) for b in blocks] +
                       [torch.zeros((2, FS_WIDE), device=dev)] * 4)
    chf, _, _ = step.analyze(wide, screen=False)
    exp = np.full(8 * N_CHAN, -1, np.int64)
    for b in range(len(blocks)):
        for typ, _, f, _, _ in sondes_for(N_CHAN, FS_WIDE):
            st_mesh.center_freq = CENTER
            exp[b * N_CHAN + st_mesh.channel_of_freq(CENTER + f)] = \
                EXPERT_TYPES.index(typ)
    exp_imet = exp.copy()
    exp_imet[N_CHAN + 3] = EXPERT_TYPES.index("IMET4")   # a noise row
    syncs = {"route_demod": host_waits(lambda: step.route_demod(chf, exp)),
             "route_demod, an iMet row added": host_waits(
                 lambda: step.route_demod(chf, exp_imet)),
             "make_station_step": host_waits(lambda: sstep(xd))}
    out["walls_ms"] = {k: dict(median=statistics.median(v), all=v)
                       for k, v in walls.items()}
    out["busy_ms"], out["route_syncs"] = busy, syncs
    for tag in walls:
        print(f"phase 12 steady 1 s block in a batch of {len(blocks)}, "
              f"{tag}: median {statistics.median(walls[tag]):.2f} ms "
              f"({[round(v, 2) for v in walls[tag]]}), device busy "
              f"{busy[tag]:.3f} ms a block ({card})")
    for tag, v in syncs.items():
        print(f"phase 12 host waits on the device inside {tag} ((8, 1) "
              f"mesh, {len(blocks)} blocks x 3 sondes; (4, 2) for the "
              f"step): {v['synchronize']}, device-to-host copies "
              f"{v['dtoh']}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 12 took {out['seconds']:.1f} s")
    return out


def check_detections(per_block, types_freqs):
    """After the run, one task per sonde, with its type and within 2 kHz
    (``NEAR_HZ``) of its frequency."""
    tasks = per_block[-1][0]
    for typ, f in types_freqs:
        if not any(t == typ and abs(fz - f) < NEAR_HZ.get(typ, 2e3)
                   for t, fz in tasks):
            raise AssertionError(f"{typ} at {f / 1e6:.4f} MHz not "
                                 f"detected: tasks {tasks}")
    if len(tasks) != len(types_freqs):
        raise AssertionError(f"unexpected tasks {tasks}")


def same_tasks(a, b) -> bool:
    return len(a) == len(b) and all(
        ta == tb and abs(fa - fb) <= 1 for (ta, fa), (tb, fb) in zip(a, b))


# ---------------------------------------------------------------------- #
# phase 13: the reference's accelerator forms of the detector and the
# channelizer, forced by their switches

# the four switches at the reference's TPU choices
TPU_FORMS = {"RSX_CHANNELIZER_DTYPE": "bfloat16",
             "RSX_DETECT_DTYPE": "bfloat16",
             "RSX_DETECT_CORR": "toeplitz", "RSX_DETECT_PEAKS": "blocknorm"}
# the recentered extraction's bf16 planes, card against CPU, of their
# peak: the float32 rotation (cos/sin of the phase tables) rounds
# differently on the card, which can move a bf16 rounding of the rotated
# input by a unit before the 12 rounded branch steps
EXTRACT_BF16_TOL = 2 ** -6
# the detection-block turns and the forms' subprocess; the row counts
# at which the prescreen and the full pass are timed in both forms
FORM_TURNS = 3
SWEEP_ROWS = (4, 16, 64)
SWEEP_REPS = 5
FORMS_TIMEOUT = 420


@contextmanager
def use_forms(tpu: bool):
    """Inside the ``with``, the four switches at the reference's TPU
    choices (``tpu``) or at their defaults (the float32 / FFT / exact
    forms): the environment (read at each call) and the correlator's two
    module globals (read from the environment at import); restored on
    exit."""
    from radiosonde_auto_rx_tpu_torch.detect import correlator
    env = {k: os.environ.get(k) for k in TPU_FORMS}
    glob = (correlator._CORR_METHOD, correlator._PEAKS_METHOD)
    for k, v in TPU_FORMS.items():
        if tpu:
            os.environ[k] = v
        else:
            os.environ.pop(k, None)
    correlator._CORR_METHOD = TPU_FORMS["RSX_DETECT_CORR"] if tpu else "auto"
    correlator._PEAKS_METHOD = TPU_FORMS["RSX_DETECT_PEAKS"] if tpu \
        else "auto"
    try:
        yield
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        correlator._CORR_METHOD, correlator._PEAKS_METHOD = glob


def _bf16_ulp(t):
    """One bfloat16 unit in the last place at each value of tensor t."""
    import torch
    return torch.exp2(torch.floor(torch.log2(
        t.abs().double().clamp(min=1e-30))) - 7)


def _close(what, got, want, tol, errs):
    """Hold ``got`` (a card tensor) to ``want`` (CPU) within ``tol``
    (a tensor of limits or a number); record the largest error."""
    g, w = got.cpu().double(), want.double()
    err = (g - w).abs()
    errs[what] = float(err.max())
    if bool((err > tol).any()):
        raise AssertionError(f"phase 13 (a) {what}: card and CPU differ by "
                             f"{float(err.max()):.3e}")


def _peaks_match(what, got, want, vtol, errs, counts, tie):
    """(val, t_pk, dc, xm) of a peak search on the card against the
    CPU's: positions equal except where ``tie`` (the CPU's best two
    exact |scores| of that row and template are within the tolerance);
    values within ``vtol`` (a tensor of limits or a number) where the
    positions agree; stream means within DET_TOL."""
    import torch
    gv, gi, gd, gm = (t.cpu() for t in got)
    cv, ci, cd, cm = want
    if not torch.equal(gi[~tie], ci[~tie]):
        raise AssertionError(f"phase 13 (a) {what}: peak positions differ "
                             f"where the CPU's best two scores do not tie: "
                             f"{gi[~tie]} vs {ci[~tie]}")
    same = gi == ci
    counts[what] = (int((~tie).sum()), int(same.sum()), same.numel())
    tol = vtol[same] if hasattr(vtol, "shape") else vtol
    _close(what, gv[same], cv[same], tol, errs)
    _close(what + " xm", gm, cm, DET_TOL, errs)


def forms_check(dev, stream):
    """Phase 13 (a): each form on the card against the CPU's run of the
    same form, at the detector's geometry (phase 7's three sondes' rows
    of the first 1 s block, extracted and conditioned on the CPU; the
    class holding RS41 and DFM, 48,000 samples a row).  Tolerances:
    float32 correlation 1e-5 of its peak (float32 sums in another
    order); bf16 values a bf16 unit in the last place (each package
    rounds once from its float32 sum) plus 1e-6 of the peak; peak scores
    DET_TOL in float32 (the normalization's cumsums, see phase 7), plus
    2^-7 of the score on bf16 streams (the peak's correlation is a bf16
    value); peak positions equal except where the CPU's best two exact
    |scores| tie within DET_TOL (plus 2^-7 of the best on bf16 streams),
    as in phase 7; the bf16 channelizer's planes a bf16 unit of each
    value plus 1e-6 of the peak (its branch steps are elementwise
    roundings, the same on both; only the DFT's sum order differs), the
    extraction's EXTRACT_BF16_TOL of the peak."""
    import torch
    from radiosonde_auto_rx_tpu_torch.detect import correlator
    from radiosonde_auto_rx_tpu_torch.detect.scanner import SondeDetector
    from radiosonde_auto_rx_tpu_torch.ops import channelizer
    cpu = torch.device("cpu")
    wide = split_blocks(stream, FS_WIDE, 1)[0].astype(np.float32) / 32768.0
    freqs = [f for _, _, f, _, _ in sondes_for(N_CHAN, FS_WIDE)]
    rows = channelizer.extract_channels(wide, FS_WIDE, freqs, N_CHAN, cpu)
    det = SondeDetector(FS_WIDE // N_CHAN, prescreen=False, device=cpu)
    cls = next(i for i, cl in enumerate(det.classes)
               if {"RS41", "DFM"} <= {s.name for s in cl[2]})
    fm = det._condition(rows - rows.mean(-1, keepdim=True) * 0.98)[cls]
    _, _, _, bank, lens = det.classes[cls]
    errs, counts = {}, {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x, b = fm.to(dt), bank.to(dt)
        xd, bd = x.to(dev), b.to(dev)
        # ties: the CPU's best two exact |scores| within the tolerance
        # (a bf16 stream's scores carry its rounding: 2^-7 of the best)
        corr, xnorm, _ = correlator._correlate(x, b, lens)
        top2 = (corr / xnorm).abs().topk(2, dim=-1).values
        tie = (top2[..., 0] - top2[..., 1]) < (
            DET_TOL if dt == torch.float32 else
            DET_TOL + 2 ** -7 * top2[..., 0])
        want = correlator._corr_toeplitz(x, b)
        got = correlator._corr_toeplitz(xd, bd)
        if got.dtype != dt:
            raise AssertionError("phase 13 (a): the Toeplitz cube's dtype")
        peak = float(want.float().abs().max())
        _close(f"_corr_toeplitz {name}", got, want,
               1e-5 * peak if dt == torch.float32 else
               _bf16_ulp(want) + 1e-6 * peak, errs)
        for rescore in (True, False):
            want = correlator._correlate_peaks_blocknorm(x, b, lens,
                                                         rescore=rescore)
            got = correlator._correlate_peaks_blocknorm(xd, bd, lens,
                                                        rescore=rescore)
            vtol = DET_TOL if dt == torch.float32 else \
                DET_TOL + 2 ** -7 * want[0].abs()
            _peaks_match(f"_correlate_peaks_blocknorm rescore={rescore} "
                         f"{name}", got, want, vtol, errs, counts, tie)
        for peaks in ("exact", "blocknorm"):
            old = correlator._PEAKS_METHOD
            correlator._PEAKS_METHOD = peaks
            try:
                want = correlator._correlate_peaks(x, b, lens)
                got = correlator._correlate_peaks(xd, bd, lens)
            finally:
                correlator._PEAKS_METHOD = old
            vtol = DET_TOL if dt == torch.float32 else \
                DET_TOL + 2 ** -7 * want[0].abs()
            _peaks_match(f"_correlate_peaks {peaks} {name}", got, want,
                         vtol, errs, counts, tie)
    with use_forms(True):
        taps = torch.from_numpy(channelizer.pfb_prototype(N_CHAN))
        want = channelizer._channelize(torch.from_numpy(wide), taps, N_CHAN)
        got = channelizer._channelize(torch.from_numpy(wide).to(dev),
                                      taps.to(dev), N_CHAN)
        if got.dtype != torch.bfloat16:
            raise AssertionError("phase 13 (a): the channelizer's dtype")
        peak = float(want.float().abs().max())
        _close("_channelize bf16", got, want,
               _bf16_ulp(want) + 1e-6 * peak, errs)
        want = channelizer.extract_channels(wide, FS_WIDE, freqs, N_CHAN,
                                            cpu)
        got = channelizer.extract_channels(wide, FS_WIDE, freqs, N_CHAN,
                                           dev)
        peak = float(want.float().abs().max())
        _close("_extract bf16", got, want, EXTRACT_BF16_TOL * peak, errs)
    print(f"phase 13 (a) forms on the card against the CPU (3 rows x "
          f"48,000 samples, {len(lens)} templates; channelizer on 1 s of "
          f"{FS_WIDE} Hz): max errors {json.dumps(errs)}; (pairs that do "
          f"not tie, positions equal, pairs) {json.dumps(counts)}")
    if not all(n for n, _, _ in counts.values()):
        raise AssertionError("phase 13 (a): a position check compared no "
                             "peak")
    return errs


def _detection_block_ms(dev, block) -> float:
    """Wall ms of the block in which a new task-less station scans,
    confirms and decodes (phase 7's detection block)."""
    import torch
    st = make_station(dev, N_CHAN, FS_WIDE, manual=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st.process_captures([block])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def forms_child(out_path, dev=None) -> int:
    """Phase 13 (b), in a process started with the four switches at the
    reference's TPU choices (``TPU_FORMS`` in its environment): phase
    7's task-less drive of phase 3's capture (1 s, then 2 s blocks); the
    detection block timed in turns with the default forms (switched off
    for their turns); ``tools.profile_station``'s channelize, prescreen
    and full-pass stages (the float32 forms' are phase 11's); the
    prescreen and the full pass on SWEEP_ROWS rows in both forms.
    Writes a JSON result.  ``dev``:
    the card (default), or another device for a rehearsal."""
    import torch
    from radiosonde_auto_rx_tpu_torch import kernels
    from radiosonde_auto_rx_tpu_torch.detect import correlator
    from radiosonde_auto_rx_tpu_torch.detect.scanner import stream_dtype
    from radiosonde_auto_rx_tpu_torch.ops.channelizer import _branch_dtype
    from radiosonde_auto_rx_tpu_torch.parallel.station_step import \
        StationStep
    from radiosonde_auto_rx_tpu_torch.tools import profile_station
    if dev is None:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            return 2
        dev = torch.device("cuda", 0)
        kernels.library()
    forms = [correlator._corr_method(), correlator._peaks_method(),
             str(stream_dtype()), str(_branch_dtype())]
    if forms != ["toeplitz", "blocknorm", "torch.bfloat16",
                 "torch.bfloat16"]:
        raise AssertionError(f"phase 13 (b): forms {forms}")
    planes = set()
    analyze = StationStep.analyze

    def recorded(self, *a, **k):
        res = analyze(self, *a, **k)
        planes.add(str(res[0].dtype))
        return res

    StationStep.analyze = recorded
    stream = synth_stream(N_CHAN, FS_WIDE, SECONDS)
    runs = [split_blocks(stream, FS_WIDE, 1), split_blocks(stream, FS_WIDE, 2)]
    want = [(typ, CENTER + f) for typ, _, f, _, _ in
            sondes_for(N_CHAN, FS_WIDE)]
    with DemodCalls() as calls:
        results, launches = drive_station(dev, runs, N_CHAN, FS_WIDE,
                                          manual=False)
    StationStep.analyze = analyze
    check_path_launches(launches, calls.calls, "phase 13 TPU forms")
    out = dict(forms=forms, planes=sorted(planes), launches=launches,
               demod_calls=calls.calls, runs=[])
    for (st, telems, per_block), types in zip(
            results, (("RS41",), ("RS41", "DFM"))):
        check_detections(per_block, want)
        out["runs"].append(dict(
            seen=check_telemetry(telems, N_CHAN, FS_WIDE, types),
            telemetry=sorted(map(_key, telems)),
            tasks=[tasks for tasks, _ in per_block],
            detections=st.stats["detections"]))
    walls = {"float32": [], "tpu": []}
    for _ in range(FORM_TURNS):
        for tag, tpu in (("float32", False), ("tpu", True)):
            with use_forms(tpu):
                walls[tag].append(_detection_block_ms(dev, runs[0][0]))
    out["detect_block_ms"] = walls
    gen = torch.Generator(device=dev).manual_seed(1)
    wide = torch.randn((profile_station.B, 2, profile_station.T_WIDE),
                       generator=gen, device=dev)
    res = {}
    for name, fn in profile_station.stages(dev, wide):
        if name.startswith(("channelize", "det_")):
            profile_station._stage(name, fn, wide.shape[0] * wide.shape[-1],
                                   dev, res)
    out["profile"] = {k: dict(ms=v["ms"], clock=v["clock"])
                      for k, v in res.items()}
    # where the prescreen starts to pay: both detector stages on C rows,
    # the profiler's device busy sum (both stages block the host)
    sweep = {"float32": {}, "tpu": {}}
    keep = (profile_station.CAP, profile_station.DUTY)
    try:
        for rows in SWEEP_ROWS:
            profile_station.CAP = rows
            profile_station.DUTY = (rows + 0.5) / (profile_station.B *
                                                   profile_station.N_CHAN)
            for tag, tpu in (("float32", False), ("tpu", True)):
                with use_forms(tpu):
                    sweep[tag][rows] = [
                        profile_station.device_busy_ms(fn, SWEEP_REPS)
                        for name, fn in profile_station.stages(dev, wide)
                        if name.startswith("det_")]
    finally:
        profile_station.CAP, profile_station.DUTY = keep
    out["sweep"] = sweep
    Path(out_path).write_text(json.dumps(out))
    return 0


def forms_phase(dev, card, stream, d_results, f32_profile=None):
    """Phase 13: (a) ``forms_check``; (b) ``forms_child`` in a
    subprocess with the four switches set, its tasks and telemetry held
    to phase 7's float32 station, its stage times printed beside
    ``f32_profile`` (phase 11's ``profile_station``); (c) ``python -m
    radiosonde_auto_rx_tpu_torch.tools.dcn_probe --device cpu``, and
    on a one-GPU host its default (``cuda``) refused."""
    import torch
    t_phase = time.perf_counter()
    errs = forms_check(dev, stream)
    WORK.mkdir(parents=True, exist_ok=True)
    path = WORK / "forms.json"
    path.unlink(missing_ok=True)
    env = dict(os.environ, **TPU_FORMS)
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--forms", str(path)], env=env,
                         capture_output=True, text=True,
                         timeout=FORMS_TIMEOUT)
    if res.returncode != 0:
        raise AssertionError(f"phase 13 (b): exit {res.returncode}\n"
                             f"{res.stderr[-4000:]}")
    got = json.loads(path.read_text())
    if got["planes"] != ["torch.bfloat16"]:
        raise AssertionError(f"phase 13 (b): channel planes {got['planes']}")
    for run, (_, telems, per_block) in zip(got["runs"], d_results):
        want_t = sorted(map(_key, telems))
        if [tuple(t) for t in run["telemetry"]] != want_t:
            raise AssertionError("phase 13 (b): the TPU forms' station "
                                 "decoded other telemetry than the float32 "
                                 "station")
        for tasks, (tasks_f, _) in zip(run["tasks"], per_block):
            if not same_tasks([tuple(t) for t in tasks], tasks_f):
                raise AssertionError(f"phase 13 (b): tasks {tasks} vs the "
                                     f"float32 station's {tasks_f}")
    walls = got["detect_block_ms"]
    print(f"phase 13 (b) station under {json.dumps(TPU_FORMS)} (a "
          f"subprocess), no task, phase 7's blocks: detections "
          f"{[r['detections'] for r in got['runs']]}, frames "
          f"{[r['seen'] for r in got['runs']]}, the same tasks block by "
          f"block and the same telemetry as phase 7's float32 station; "
          f"channel planes {got['planes']}; launches {got['launches']}, "
          f"demod calls {got['demod_calls']}")
    print(f"phase 13 (b) detection block (1 s, new station) in turns: "
          f"float32 forms median "
          f"{statistics.median(walls['float32']):.2f} ms "
          f"{[round(v, 2) for v in walls['float32']]}, TPU forms median "
          f"{statistics.median(walls['tpu']):.2f} ms "
          f"{[round(v, 2) for v in walls['tpu']]} ({card})")
    for stage, t in got["profile"].items():
        f = (f32_profile or {}).get(stage)
        print(f"phase 13 (b) profile_station {stage}: TPU forms "
              f"{t['ms']:.3f} ms ({t['clock']}), float32 forms (phase 11) "
              + (f"{f['ms']:.3f} ms ({f['clock']})" if f else "not run")
              + f" ({card})")
    for tag, rows in got["sweep"].items():
        print(f"phase 13 (b) {tag} forms, device ms on C rows, prescreen / "
              f"full pass: " + ", ".join(
                  f"C={c}: {p:.3f} / {f:.3f}" for c, (p, f) in rows.items())
              + f" ({card})")
    t0 = time.perf_counter()
    probe_cmd = [sys.executable, "-m",
                 "radiosonde_auto_rx_tpu_torch.tools.dcn_probe"]
    probe = subprocess.run(
        probe_cmd + ["--device", "cpu", "-o", str(WORK / "dcn_probe.json")],
        capture_output=True, text=True, timeout=300,
        cwd=Path(__file__).resolve().parent)
    if probe.returncode != 0:
        raise AssertionError(f"phase 13 (c): dcn_probe exit "
                             f"{probe.returncode}\n{probe.stderr[-4000:]}")
    fit = json.loads((WORK / "dcn_probe.json").read_text())
    print(f"phase 13 (c) tools.dcn_probe --device cpu in "
          f"{time.perf_counter() - t0:.1f} s: {json.dumps(fit)}")
    if torch.cuda.device_count() < 2:
        # the default device is the card; NCCL needs one GPU a process
        short = subprocess.run(probe_cmd, capture_output=True, text=True,
                               timeout=120,
                               cwd=Path(__file__).resolve().parent)
        if short.returncode != 1 or "needs 2 GPUs" not in short.stderr:
            raise AssertionError(f"phase 13 (c): dcn_probe on one GPU "
                                 f"exit {short.returncode}\n"
                                 f"{short.stderr[-2000:]}")
        print(f"phase 13 (c) tools.dcn_probe (default --device cuda) on "
              f"{torch.cuda.device_count()} GPU: exit 1, "
              f"{short.stderr.strip().splitlines()[-1]}")
    got["seconds"] = time.perf_counter() - t_phase
    got["errors"], got["dcn_probe"] = errs, fit
    print(f"phase 13 took {got['seconds']:.1f} s")
    return got


# ---------------------------------------------------------------------- #
# phase 14: the repository's two drivers (the bench and the entry points)

DRIVER_TIMEOUT = 400
# a program's wall ms and its device ms are two timings of the same
# calls: the wall may read below the device time by this share of clock
# noise where the device sets the pace
WALL_SLACK = 0.02
ENTRY_TOL = 1e-4
# the bench's JSON keys (the reference's names, without XLA's
# cost-analysis keys; each program's wall ms, device ms, clock and
# launches a step)
BENCH_PROGRAMS = ("demod", "production", "steady", "steady_noscan",
                  "r3_allch")
BENCH_KEYS = frozenset((
    "station_step_msps_production", "station_step_msps_wideband",
    "bench_schema", "station_step_vs_baseline", "station_step_ms",
    "station_step_model", "station_step_msps_steady",
    "station_step_ms_steady", "station_step_msps_steady_noscan",
    "station_step_ms_steady_noscan", "station_step_ms_steady_duty4",
    "station_step_msps_wideband_r3_allch_model",
    "hbm_sustained_gbps_measured", "detect_duty", "detect_full_pass_cap",
    "station_step_least_bytes_r3", "station_step_hbm_pct_h100_least_bytes",
    "device", "geometry",
    *(f"{p}_{k}" for p in BENCH_PROGRAMS
      for k in ("wall_ms", "device_ms", "clock", "launches"))))


def bench_plan(n_groups: int) -> dict:
    """The port kernels one step of each bench program launches: the
    scan once a type group (``n_groups`` in the station programs; the
    demod program and the r3 model demodulate one), K2 once on a step
    that scans the PSD, nothing else."""
    scans = dict(demod=1, production=n_groups, steady=n_groups,
                 steady_noscan=n_groups, r3_allch=1)
    k2 = dict(demod=0, production=1, steady=1, steady_noscan=0, r3_allch=1)
    return {p: dict(freq_est_sf=0, fft_abs2=k2[p], fft=0, fsk_scan=scans[p],
                    fsk_scan_unbuffered=0) for p in BENCH_PROGRAMS}


def check_bench_line(res, n_groups: int):
    """The bench's JSON line from a card: every key; every number finite
    and positive (no device metric missing); each program's wall ms not
    below its device ms (by more than ``WALL_SLACK``); the launches a
    step as ``bench_plan`` says."""
    if set(res) != {"metric", "value", "unit", "vs_baseline", "extra"} or \
            res["metric"] != "fsk_demod_iq_throughput":
        raise AssertionError(f"bench line: {sorted(res)}")
    ex = res["extra"]
    if set(ex) != BENCH_KEYS:
        raise AssertionError(f"bench keys: missing "
                             f"{sorted(BENCH_KEYS - set(ex))}, extra "
                             f"{sorted(set(ex) - BENCH_KEYS)}")
    nums = {k: v for k, v in ex.items()
            if not isinstance(v, (str, dict))}
    nums.update(value=res["value"], vs_baseline=res["vs_baseline"])
    bad = {k: v for k, v in nums.items()
           if not isinstance(v, (int, float)) or not np.isfinite(v)
           or v <= 0}
    if bad:
        raise AssertionError(f"bench values not finite and positive: {bad}")
    for p, want in bench_plan(n_groups).items():
        wall, dev = ex[f"{p}_wall_ms"], ex[f"{p}_device_ms"]
        if wall < dev * (1 - WALL_SLACK):
            raise AssertionError(f"bench {p}: wall {wall} ms below its "
                                 f"device {dev} ms ({ex[f'{p}_clock']})")
        if ex[f"{p}_launches"] != want:
            raise AssertionError(f"bench {p}: launches "
                                 f"{ex[f'{p}_launches']}, want {want}")


@contextmanager
def scan_shapes(tag: list):
    """Records every buffered ``fsk_scan`` launch in a ``with`` (a
    recorder in both modules that call it: ``demod/fsk.py``'s
    ``fsk_demod_stream`` and ``parallel/pipeline.py``'s ``scan``): yields
    a dict (configuration, channels, samples, demod blocks) -> the names
    that ``tag[0]`` held at its launches."""
    from radiosonde_auto_rx_tpu_torch.demod import fsk
    from radiosonde_auto_rx_tpu_torch.parallel import pipeline
    orig, shapes = fsk.fsk_scan, {}

    def recorded(cfg, x, state, n_blocks, probe=False, buffered=True):
        if buffered:
            key = (cfg, x.shape[0], x.shape[-1], n_blocks)
            shapes.setdefault(key, []).append(tag[0])
        return orig(cfg, x, state, n_blocks, probe, buffered)
    fsk.fsk_scan = pipeline.fsk_scan = recorded
    try:
        yield shapes
    finally:
        fsk.fsk_scan = pipeline.fsk_scan = orig


def check_bench_scans(dev):
    """Phase 14 (f): the scan kernel against its twin, both on the card,
    at every shape the bench's programs give it at the card's geometry
    (``bench.CARD``; recorded from one call of each program): on the
    bench's own input for the headline demod, on ``bench.make_input``'s
    2FSK for the other shapes of the bench's RS41 configuration (the r3
    model's channels, the RS41 group), on ``fsk_signal``'s for the other
    chains (the station programs' Gaussian-noise captures leave the tone
    and bit decisions undefined, so they are not the inputs held here);
    ``scan_diff``'s checks with the probe outputs from the initial state,
    then from the twin's final state.  Returns (largest soft error, a row
    a shape)."""
    import torch
    from radiosonde_auto_rx_tpu_torch import bench
    from radiosonde_auto_rx_tpu_torch.demod import fsk
    geo, cfg = bench.CARD, bench._cfg()
    C, T = geo.demod_channels, geo.demod_samples
    x = bench.make_input(cfg, C, T, dev)
    wide = bench._wide(geo.B, geo.t_wide, dev)
    tag = [None]
    with scan_shapes(tag) as shapes:
        tag[0] = "demod"
        bench.demod_program(cfg, C, dev)(x)
        tag[0] = "production"
        bench.production_program(dev, geo.B, geo.t_wide, geo.n_cand)[0](wide)
        for tag[0], psd in (("steady", True), ("steady_noscan", False)):
            bench.steady_program(dev, geo.B, geo.t_wide, psd)(wide)
        tag[0] = "r3_allch"
        bench.AllChannelModel(dev, geo.B, geo.t_wide_r3).step(
            wide if geo.t_wide_r3 == geo.t_wide
            else bench._wide(geo.B, geo.t_wide_r3, dev))
    del wide
    headline = (cfg, C, T, bench.fsk_num_blocks_buffered(cfg, T))
    if headline not in shapes:
        raise AssertionError(f"phase 14 (f): the headline's scan {headline}"
                             f" not among the recorded {list(shapes)}")
    worst, rows = 0.0, []
    for seed, (key, programs) in enumerate(shapes.items()):
        c_cfg, c, t, nb = key
        if key == headline:
            xs, src = x, "the bench's input"
        elif c_cfg == cfg:
            xs, src = bench.make_input(c_cfg, c, t, dev), "make_input"
        else:
            xs = torch.from_numpy(fsk_signal(c_cfg, c, t, seed)).to(dev)
            src = "fsk_signal"
        what = (f"phase 14 (f) {'/'.join(sorted(set(programs)))} C={c} "
                f"T={t} fs={c_cfg.fs} rs={c_cfg.rs}")
        st0 = fsk.fsk_init_state(c_cfg, c, dev)
        want = fsk.fsk_scan_ref(c_cfg, xs, st0, nb, probe=True)
        err = scan_diff(fsk.fsk_scan(c_cfg, xs, st0, nb, probe=True), want,
                        what)
        st1 = want[0]
        err = max(err, scan_diff(fsk.fsk_scan(c_cfg, xs, st1, nb),
                                 fsk.fsk_scan_ref(c_cfg, xs, st1, nb),
                                 f"{what}, carried state"))
        peak = float(want[1]["soft"].abs().max())
        print(f"{what} blocks={nb} ({src}): bits, f_est, ptr, nin equal; "
              f"soft max_abs_err={err:.3e} (peak {peak:.3f}, tol "
              f"{SCAN_TOL} of peak; also sf, tmag, timing, Eb/N0; initial "
              f"and carried state; twin on the card)")
        worst = max(worst, err)
        rows.append(dict(programs=sorted(set(programs)), channels=c,
                         samples=t, blocks=nb, fs=c_cfg.fs, rs=c_cfg.rs,
                         input=src, max_abs_err=err))
    return worst, rows


def run_driver(*args) -> str:
    """``python -m <args>`` from the repository's root, as a user runs
    it; its standard output (a non-zero exit raises)."""
    res = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                         text=True, timeout=DRIVER_TIMEOUT,
                         cwd=Path(__file__).resolve().parent)
    if res.returncode != 0:
        raise AssertionError(f"phase 14: python -m {' '.join(args)} exited "
                             f"{res.returncode}\n{res.stderr[-4000:]}")
    return res.stdout


def drivers_phase(dev, card):
    """Phase 14: (a) ``python -m radiosonde_auto_rx_tpu_torch.bench`` as
    a child: its one JSON line checked by ``check_bench_line`` and
    printed; (b) its ``--ablate`` table; (c) ``--scaling`` over the
    visible GPUs; (d) ``graft_entry.entry()`` on the card against the
    same step on the CPU (bits equal, soft within ``ENTRY_TOL`` of its
    peak, one unbuffered scan launch); (e) ``graft_entry.
    dryrun_multichip(8)`` over a virtual mesh of the card (counters
    zeroed just before (d) and (e), read just after); (f) the scan
    kernel at the bench programs' shapes (``check_bench_scans``)."""
    import torch
    from radiosonde_auto_rx_tpu_torch import bench, graft_entry, kernels
    t_phase = time.perf_counter()
    lines = run_driver("radiosonde_auto_rx_tpu_torch.bench").splitlines()
    if len(lines) != 1:
        raise AssertionError(f"phase 14 (a): {len(lines)} lines: {lines}")
    res = json.loads(lines[0])
    check_bench_line(res, len(set(bench.ACTIVES)))
    geo = res["extra"]["geometry"]
    cfg = bench._cfg()
    nb = bench.fsk_num_blocks_buffered(cfg, geo["demod_samples"])
    b_ms, b_by = scan_bound(cfg, geo["demod_channels"], nb,
                            geo["demod_samples"])
    print(f"phase 14 (a) python -m radiosonde_auto_rx_tpu_torch.bench "
          f"({card}), every key finite and positive, wall >= device ms, "
          f"launches a step as planned; the headline scan "
          f"({geo['demod_channels']} channels x {nb} demod blocks) bound "
          f"{b_ms:.5f} ms ({b_by}), device "
          f"{res['extra']['demod_device_ms']:.4f} ms:")
    print(lines[0])
    table = run_driver("radiosonde_auto_rx_tpu_torch.bench", "--ablate")
    print(f"phase 14 (b) python -m radiosonde_auto_rx_tpu_torch.bench "
          f"--ablate ({card}):")
    print(table.rstrip())
    out = run_driver("radiosonde_auto_rx_tpu_torch.bench", "--scaling")
    scal = json.loads(out.strip().splitlines()[-1])
    if scal["extra"]["ndev"] != torch.cuda.device_count() or \
            not scal["value"] > 0 or \
            not scal["extra"]["headline"]["msps_1dev"] > 0:
        raise AssertionError(f"phase 14 (c): {scal}")
    print(f"phase 14 (c) python -m radiosonde_auto_rx_tpu_torch.bench "
          f"--scaling over {torch.cuda.device_count()} GPU(s): "
          f"{json.dumps(scal)}")

    fn, args = graft_entry.entry(dev)
    kernels.reset_launches()
    soft, bits = fn(*args)
    torch.cuda.synchronize()
    entry_launches = dict(kernels.launches)
    cfn, cargs = graft_entry.entry(torch.device("cpu"))
    csoft, cbits = cfn(*cargs)
    err = float((soft.cpu() - csoft).abs().max() / csoft.abs().max())
    want = dict(freq_est_sf=0, fft_abs2=0, fft=0, fsk_scan=1,
                fsk_scan_unbuffered=1)
    if entry_launches != want or not torch.equal(bits.cpu(), cbits) or \
            err > ENTRY_TOL:
        raise AssertionError(f"phase 14 (d): launches {entry_launches}, "
                             f"bits equal {torch.equal(bits.cpu(), cbits)}"
                             f", soft {err:.2e} of its peak")
    print(f"phase 14 (d) graft_entry.entry() on the card: soft/bits "
          f"{tuple(soft.shape)}, the CPU step's bits, soft within "
          f"{err:.2e} of its peak, launches {entry_launches}")

    kernels.reset_launches()
    dry = graft_entry.dryrun_multichip(8, [dev] * 8)
    torch.cuda.synchronize()
    dry_launches = dict(kernels.launches)
    # the stage pipeline's 4 microbatches take the unbuffered scan
    if dry_launches["fsk_scan"] <= 0 or dry_launches["fft_abs2"] <= 0 or \
            dry_launches["fsk_scan_unbuffered"] != 4 or \
            dry_launches["freq_est_sf"]:
        raise AssertionError(f"phase 14 (e): launches {dry_launches}")
    print(f"phase 14 (e) graft_entry.dryrun_multichip(8) over a virtual "
          f"mesh of {dev}: launches {dry_launches}")

    scan_err, scan_rows = check_bench_scans(dev)
    seconds = time.perf_counter() - t_phase
    print(f"phase 14 took {seconds:.1f} s")
    return dict(bench=res, scaling=scal, entry_launches=entry_launches,
                dryrun_launches=dry_launches, dryrun_line=dry["line"],
                scan_err=scan_err, scan_shapes=scan_rows, seconds=seconds)


# ---------------------------------------------------------------------- #
# phase 15: the sharded station step across processes (NCCL, one GPU a
# process)

MESH_WORKER_TIMEOUT = 300        # a worker process's limit (s)
MESH_FLOAT_TOL = 1e-6            # a float output, of its peak
MESH_STEP_REPS = 5               # (c): timed steps a rank
# station_fixture's geometry (tests/station_fixture.py), built from the
# port's copies: four 3 s captures at 768 kHz, 16 channels, one sonde a
# capture at (capture, channel); the (4, 2) and (8, 1) meshes
FX_CHAN, FX_FS, FX_T = 16, 768_000, 2_304_000
FX_TS = 1_755_600_000.0          # the RS41 frames' GPS time
FX_SONDES = {"RS41": (0, 5), "M20": (3, 9), "DFM": (1, 4), "M10": (2, 11)}
FX_CANDS = [b * FX_CHAN + c for b, c in FX_SONDES.values()] + \
    [2 * FX_CHAN + 1]
FX_SHARDS = 8
FX_CFG = dict(fs=48000, rs=4800, m=2, p=5, nsym=50, est_min=-5000,
              est_max=5000, tone_spacing=5000, freq_est_type=1)
PROD_B = 8                       # (c): 1 s captures a step
HEADLINE = (512, 4 * 48000)      # (d): channels x samples
HEADLINE_CALLS = 20              # (d): timed calls a trial
HEADLINE_TRIALS = 2


def _taper(sig, n=4096):
    w = 0.5 - 0.5 * np.cos(np.pi * np.arange(n) / n)
    sig[:n] *= w
    sig[-n:] *= w[::-1]
    return sig


def fixture_captures(ts: float = FX_TS):
    """``tests/station_fixture.make_wide_captures(ts)`` from the port's
    copies of the modulator and the frame encoders (the GPU host has no
    JAX): [4, 2, FX_T] float32 planes carrying an RS41 (``T1357911``), an
    M20, a DFM and an M10 on noise, the same draws in the same order."""
    from radiosonde_auto_rx_tpu_torch.demod.modulate import gfsk_mod
    from radiosonde_auto_rx_tpu_torch.models.dfm import encode_flight_bits
    from radiosonde_auto_rx_tpu_torch.models.m10 import (
        encode_frame_m10, encode_frame_m20, frame_to_raw_bits)
    from radiosonde_auto_rx_tpu_torch.models.rs41 import (
        encode_frame, frame_to_bits, make_calibytes)
    from radiosonde_auto_rx_tpu_torch.ops.channelizer import channel_freqs
    rng = np.random.default_rng(7)
    freqs = channel_freqs(FX_CHAN, FX_FS)
    B, T = len(FX_SONDES), FX_T
    wide = (rng.standard_normal((B, T)) + 1j * rng.standard_normal((B, T))
            ).astype(np.complex64) * 0.002
    now = datetime.datetime.fromtimestamp(ts, datetime.timezone.utc)
    week = (now - datetime.datetime(1980, 1, 6, tzinfo=datetime.timezone.utc)
            ).days // 7
    tow_ms = ((((now.weekday() + 1) % 7 * 24 + now.hour) * 3600 +
               now.minute * 60 + now.second) * 1000)
    cal = make_calibytes()
    rs41 = np.concatenate(
        [rng.integers(0, 2, 400)] +
        [frame_to_bits(encode_frame(
            frame_nb=900 + i, sonde_id="T1357911", week=week,
            tow_ms=tow_ms + i * 1000, lat=-34.5, lon=138.6, alt=12000.0,
            calibytes=cal, calfr=i)) for i in range(3)] +
        [rng.integers(0, 2, 400)])
    idle = np.tile(np.array([1, 0], np.uint8), 200)
    m20 = np.concatenate([idle] + [frame_to_raw_bits(encode_frame_m20())
                                   for _ in range(4)] + [idle])
    dfm = np.concatenate([
        rng.integers(0, 2, 500).astype(np.uint8),
        encode_flight_bits(sn=21054321, lat=47.9, lon=16.8, n_cycles=2,
                           time_step=1.0).astype(np.uint8)])
    idle = np.tile(np.concatenate([np.ones(8, np.uint8),
                                   np.zeros(8, np.uint8)]), 40)
    m10 = np.concatenate([idle] + [frame_to_raw_bits(encode_frame_m10(
        lat=48.2, lon=16.4, alt=11000.0)) for _ in range(3)] + [idle])
    for name, bits, rs, shift, bt in (("RS41", rs41, 4800, 4800, 0.5),
                                      ("M20", m20, 9600, 9600, 1.0),
                                      ("DFM", dfm, 2500, 5000, 0.5),
                                      ("M10", m10, 9616, 10000, 1.0)):
        b, c = FX_SONDES[name]
        sig = _taper(gfsk_mod(bits, FX_FS, rs, 2, freqs[c], shift,
                              bt=bt)[:T])
        wide[b, :len(sig)] += sig
    return np.stack([wide.real, wide.imag], axis=1).astype(np.float32)


def fixture_pipeline_input():
    """``make_station_step``'s input in (a): 16 channels of 2-FSK, 24,000
    samples, from seed 0 (the same in every process)."""
    C, T = 16, 24000
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (C, T // 10 + 2))
    sym = np.repeat(bits, 10, axis=1)[:, :T]
    ph = 2 * np.pi * np.cumsum(np.where(sym == 0, -2500.0, 2500.0),
                               axis=1) / 48000
    iq = np.exp(1j * ph) + (rng.standard_normal(ph.shape) +
                            1j * rng.standard_normal(ph.shape)) * 0.05
    return np.stack([iq.real, iq.imag], axis=1).astype(np.float32)


def _host(out: dict) -> dict:
    """{name: {coord: tensor}} -> {name: {coord: host array}}."""
    return {k: {c: v.cpu().numpy() for c, v in d.items()}
            for k, d in out.items()}


def _step_outputs(psd, conf, res) -> dict:
    """The sharded step's outputs by name: the PSD, the confirmation
    streams and peaks, every ``route_demod`` field."""
    return dict(psd=psd, streams=conf["streams"],
                **{f"peak{i}_{j}": p[j] for i, p in enumerate(conf["peaks"])
                   for j in range(4)}, **res)


def fixture_dataflow(wide, station_mesh, pipeline_mesh) -> dict:
    """The JAX worker's two modes (``tests/multiproc_worker.py``) on the
    given meshes: ``StationStep.analyze`` -> ``confirm`` (the four sondes'
    channels and a noise row) -> ``route_demod`` (each sonde to its
    expert) on ``station_mesh`` over the fixture's captures ``wide``, and
    ``make_station_step`` (IF FIR + demod) on ``pipeline_mesh`` over
    ``fixture_pipeline_input``.  Returns {name: {coord: host array}} of
    this process's shards."""
    from radiosonde_auto_rx_tpu_torch.demod.fsk import FSKConfig
    from radiosonde_auto_rx_tpu_torch.ops.fir import design_lowpass
    from radiosonde_auto_rx_tpu_torch.parallel.mesh import shard
    from radiosonde_auto_rx_tpu_torch.parallel.pipeline import \
        make_station_step
    from radiosonde_auto_rx_tpu_torch.parallel.station_step import (
        EXPERT_TYPES, STREAM, StationStep)
    step = StationStep(n_chan=FX_CHAN, capacity=2, conf_capacity=2,
                       mesh=station_mesh)
    chf, psd, ratios = step.analyze(shard(wide, station_mesh, STREAM))
    slots = np.full(step.n_conf_slots, -1, np.int64)
    slots[:len(FX_CANDS)] = FX_CANDS
    conf = step.confirm(chf, slots)
    exp = np.full(wide.shape[0] * FX_CHAN, -1, np.int64)
    for name, (b, c) in FX_SONDES.items():
        exp[b * FX_CHAN + c] = EXPERT_TYPES.index(name)
    res = step.route_demod(chf, exp)
    out = dict(chf=chf, ratios=ratios, **_step_outputs(psd, conf, res))
    _, bits = make_station_step(FSKConfig(**FX_CFG), pipeline_mesh,
                                design_lowpass(0.2, 25))(
        shard(fixture_pipeline_input(), pipeline_mesh, STREAM))
    out["pipeline_bits"] = bits
    return _host(out)


def fixture_rs41(shards: dict) -> list:
    """The routed RS41 slot of (a)'s ``route_demod`` fields (every shard,
    host arrays, assembled on a CPU mesh of the fixture's shape) decoded:
    the telemetry list."""
    import torch
    from radiosonde_auto_rx_tpu_torch.models import get_model
    from radiosonde_auto_rx_tpu_torch.parallel.mesh import make_mesh
    from radiosonde_auto_rx_tpu_torch.parallel.station_step import (
        EXPERT_TYPES, StationStep)
    step = StationStep(n_chan=FX_CHAN, capacity=2, conf_capacity=2,
                       mesh=make_mesh(n_t=2, devices=[torch.device("cpu")] *
                                      FX_SHARDS))
    res = step.gather_routed({k: {c: torch.from_numpy(v)
                                  for c, v in shards[k].items()}
                              for k in ("soft", "bits", "ebno", "fres",
                                        "fcnt", "ids", "mask", "dropped")})
    e = EXPERT_TYPES.index("RS41")
    (s,) = np.flatnonzero(res["ids"][e].numpy() == FX_CANDS[0])
    bits, _ = step.slot_bits(res, e, int(s), FX_T // FX_CHAN)
    return get_model("RS41")().decode_bits(bits, None)


def production_plan(B: int):
    """(c)'s host plan at the bench's production geometry, ``B`` 1 s
    captures: ``bench.ACTIVES``' 10 actives of 5 types on distinct
    channels (their expert ids) and ``bench.N_CAND`` confirmation slots,
    from ``default_rng(3)`` as the bench's programs draw them."""
    from radiosonde_auto_rx_tpu_torch import bench
    from radiosonde_auto_rx_tpu_torch.parallel.station_step import \
        EXPERT_TYPES
    rng = np.random.default_rng(3)
    exp = np.full(B * N_CHAN, -1, np.int64)
    for name, cid in zip(bench.ACTIVES, rng.choice(
            B * N_CHAN, len(bench.ACTIVES), replace=False)):
        exp[cid] = EXPERT_TYPES.index(name)
    return exp, rng.choice(B * N_CHAN, bench.N_CAND, replace=False)


def busy_split_ms(fn, reps: int = 2) -> dict:
    """torch.profiler over ``reps`` calls of ``fn`` after a warm-up: the
    mean device ms a call of the NCCL kernels and of everything else (a
    NCCL kernel's span includes its wait for the peer)."""
    import torch
    from radiosonde_auto_rx_tpu_torch.tools.profile_station import \
        device_events
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {"compute": 0.0, "nccl": 0.0}
    for e in device_events(prof):
        split["nccl" if "nccl" in e.name.lower() else "compute"] += \
            e.time_range.elapsed_us() / 1e3 / reps
    if not split["compute"]:
        raise AssertionError("phase 15: the profiler saw no device time")
    return split


def production_run(mesh, wide, start) -> dict:
    """(c): ``analyze(screen=False)`` -> ``confirm`` on the plan's slots
    (``bench.N_CAND`` over the ch shards) -> ``route_demod`` of the
    actives on ``mesh`` (ch shards only) over the global captures
    ``wide`` (host planes), once with the launch counters zeroed just
    before and read just after, then ``MESH_STEP_REPS`` steps timed, each
    after ``start()`` (the processes start together), and the device
    time of two more.  Returns outputs (host shards), launches, walls
    (ms) and device ms."""
    import torch
    from radiosonde_auto_rx_tpu_torch import bench, kernels
    from radiosonde_auto_rx_tpu_torch.parallel.mesh import CH_AXIS, shard
    from radiosonde_auto_rx_tpu_torch.parallel.station_step import (
        STREAM, StationStep)
    n_sh = mesh.shape[CH_AXIS]
    step = StationStep(n_chan=N_CHAN, capacity=4,
                       conf_capacity=bench.N_CAND // n_sh, mesh=mesh)
    exp, cands = production_plan(wide.shape[0])
    slots = np.asarray(cands, np.int64)
    wl = shard(wide, mesh, STREAM)

    def run():
        chf, psd, _ = step.analyze(wl, screen=False)
        conf = step.confirm(chf, slots)
        return _step_outputs(psd, conf, step.route_demod(chf, exp))

    start()
    kernels.reset_launches()
    out = run()
    launches = dict(kernels.launches)
    walls = []
    for _ in range(MESH_STEP_REPS):
        start()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    start()
    return dict(out=_host(out), launches=launches, walls=walls,
                busy=busy_split_ms(run))


def headline_input(device):
    """(d)'s input: ``bench.make_input`` at ``HEADLINE`` on ``device``
    (seed 0, made there: the same planes on every GPU)."""
    from radiosonde_auto_rx_tpu_torch import bench
    return bench.make_input(bench._cfg(), *HEADLINE, device)


def headline_walls(mesh, x, start) -> list:
    """(d): ``make_station_step`` (the buffered demod, no IF filter) of
    the headline's channels over ``mesh``'s ch shards (this process's of
    ``x``), as ``bench --scaling`` times its sharded demod: one warm call,
    then ``HEADLINE_CALLS`` calls a trial, each ending in a host fetch of
    every local shard's bit sum; each trial after ``start()``.  Returns
    (each trial's seconds, the port kernels the warm call launched)."""
    import torch
    from radiosonde_auto_rx_tpu_torch import bench, kernels
    from radiosonde_auto_rx_tpu_torch.parallel.mesh import shard
    from radiosonde_auto_rx_tpu_torch.parallel.pipeline import \
        make_station_step
    from radiosonde_auto_rx_tpu_torch.parallel.station_step import STREAM
    step = make_station_step(bench._cfg(), mesh)
    xs = shard(x, mesh, STREAM)

    def run():
        _, bits = step(xs)
        return sum(int(b.to(torch.int32).sum()) for b in bits.values())

    kernels.reset_launches()
    run()
    launches = dict(kernels.launches)
    walls = []
    for _ in range(HEADLINE_TRIALS):
        start()
        t0 = time.perf_counter()
        for _ in range(HEADLINE_CALLS):
            run()
        walls.append(time.perf_counter() - t0)
    return walls, launches


def headline_msps(seconds) -> float:
    C, T = HEADLINE
    return C * T * HEADLINE_CALLS / seconds / 1e6


def pp_input():
    """The stage pipeline's input (phase 12 (c), (e)): 2 channels of
    RS41 frames (``S0930112``) at 15 dB as [M, 2, 2, PP_T_MB]
    microbatches, and M."""
    from radiosonde_auto_rx_tpu_torch.demod.modulate import (add_awgn,
                                                             gfsk_mod)
    rng = np.random.default_rng(5)
    tx = np.concatenate([rng.integers(0, 2, 400),
                         _rs41_bits("S0930112", 48.1, 11.6, 2, rng),
                         rng.integers(0, 2, 700)]).astype(np.uint8)
    iq = add_awgn(gfsk_mod(tx, 48000, 4800, 2, 0.0, 4800, bt=0.5), 15.0,
                  48000, 4800, rng=rng)
    planes = np.repeat(np.stack([iq.real, iq.imag]).astype(
        np.float32)[None], 2, axis=0)
    M = planes.shape[-1] // PP_T_MB
    return np.ascontiguousarray(planes[:, :, :M * PP_T_MB].reshape(
        2, 2, M, PP_T_MB).transpose(2, 0, 1, 3)), M


def pp_run(mesh):
    """``make_pp_demod_pipeline`` on the 3-stage ``mesh`` over
    ``pp_input``: (soft, bits) on the last stage's process, else None."""
    import torch
    from radiosonde_auto_rx_tpu_torch.demod.fsk import FSKConfig
    from radiosonde_auto_rx_tpu_torch.ops.fir import design_lowpass
    from radiosonde_auto_rx_tpu_torch.parallel.pp import \
        make_pp_demod_pipeline
    xs, _ = pp_input()
    run = make_pp_demod_pipeline(FSKConfig(**PP_CFG), mesh,
                                 design_lowpass(0.2, 25), channels=2,
                                 t_mb=PP_T_MB)
    return run(torch.from_numpy(xs))


def pp_telemetry(soft, bits) -> list:
    from radiosonde_auto_rx_tpu_torch.models.rs41 import RS41Decoder
    return RS41Decoder().decode_bits(bits[:, 0].reshape(-1).cpu().numpy(),
                                     -soft[:, 0].reshape(-1).cpu().numpy())


def gpus_short(n: int) -> str | None:
    """Why this host cannot hold ``n`` processes of one GPU each, or
    None."""
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found >= n:
        return None
    return (f"the sharded step over NCCL needs {n} GPUs (one a process; "
            f"NCCL refuses two ranks on one GPU), found {found}")


def mesh_worker(out_dir, init: str, nproc: int, rank: int, modes) -> int:
    """``python chip_smoke.py --mesh-worker OUT INIT NPROC RANK MODES``:
    rank ``rank`` of phase 15's ``nproc`` processes.  It joins the group
    at ``init`` (``multihost.initialize``: NCCL on its own GPU) and runs
    each of ``modes`` (comma-separated) on the global meshes, the launch
    counters zeroed just before each and read just after:

    - ``fixture``: ``fixture_dataflow`` on the (4, 2) and (8, 1) meshes,
      ``8 / nproc`` virtual shards a process on its one device, over
      ``OUT/fixture.npy``;
    - ``production``: ``production_run`` on an (nproc, 1) mesh, one
      shard a process, over ``PROD_B`` Gaussian-noise captures;
    - ``headline``: ``headline_walls`` on an (nproc, 1) mesh;
    - ``pp``: ``pp_run`` on a 3-stage mesh of ranks 0-2 (a rank above 2
      holds no stage).

    Then rank 0 counts the GPUs' contexts while every rank still holds
    its own.  Writes ``OUT/rank<r>_of_<nproc>.npz`` (shards) and
    ``.json``.  With fewer GPUs than processes it stops before joining:
    exit 1, the reason on stderr."""
    import torch
    import torch.distributed as dist
    from radiosonde_auto_rx_tpu_torch import bench, kernels
    from radiosonde_auto_rx_tpu_torch.parallel import multihost
    from radiosonde_auto_rx_tpu_torch.parallel.collectives import \
        comm_device
    from radiosonde_auto_rx_tpu_torch.parallel.pp import make_stage_mesh
    out_dir = Path(out_dir)
    short = gpus_short(nproc)
    if short:
        print(f"chip_smoke --mesh-worker: {short}", file=sys.stderr)
        return 1
    multihost.initialize(init, num_processes=nproc, process_id=rank,
                         device="cuda")

    def start():
        torch.cuda.synchronize()
        dist.barrier(device_ids=[torch.cuda.current_device()])

    try:
        dev = comm_device()
        res = dict(rank=rank, device=str(dev), launches={})
        shards = {}
        for mode in modes:
            kernels.reset_launches()
            got = {}
            if mode == "fixture":
                local = [dev] * (FX_SHARDS // nproc)
                got = fixture_dataflow(
                    np.load(out_dir / "fixture.npy"),
                    multihost.global_mesh(n_t=2, local_devices=local),
                    multihost.global_mesh(n_t=1, local_devices=local))
                launches = dict(kernels.launches)
            elif mode == "production":
                prod = production_run(
                    multihost.global_mesh(n_t=1, local_devices=[dev]),
                    bench._wide(PROD_B, FS_WIDE, torch.device("cpu")).numpy(),
                    start)
                got, launches = prod.pop("out"), prod.pop("launches")
                res["production"] = prod
            elif mode == "headline":
                res["headline_s"], launches = headline_walls(
                    multihost.global_mesh(n_t=1, local_devices=[dev]),
                    headline_input(dev), start)
            elif mode == "pp":
                if rank < 3:
                    ys = pp_run(make_stage_mesh(3, devices=[dev] * 3,
                                                ranks=[0, 1, 2]))
                    if ys is not None:
                        got = {"pp_soft": {(0,): ys[0].cpu().numpy()},
                               "pp_bits": {(0,): ys[1].cpu().numpy()}}
                launches = dict(kernels.launches)
            else:
                raise ValueError(f"--mesh-worker: no mode {mode!r}")
            res["launches"][mode] = launches
            shards.update({f"{mode}/{k}|{','.join(map(str, c))}": v
                           for k, d in got.items() for c, v in d.items()})
        start()
        if rank == 0:
            res["contexts"] = len(compute_pids())
        start()
        tag = f"rank{rank}_of_{nproc}"
        np.savez(out_dir / f"{tag}.npz", **shards)
        (out_dir / f"{tag}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()
    return 0


def launch_workers(out_dir, nproc: int, modes):
    """Start ``nproc`` ``--mesh-worker`` processes on a ``file://`` store in
    ``out_dir`` and wait for them (each under ``MESH_WORKER_TIMEOUT``; a
    failure stops all).  Returns (per-rank JSON, per-rank {mode: {name:
    {coord: array}}})."""
    out_dir = Path(out_dir)
    store = out_dir / f"store{nproc}"
    store.unlink(missing_ok=True)
    cmd = [sys.executable, str(Path(__file__).resolve()), "--mesh-worker",
           str(out_dir), f"file://{store}", str(nproc)]
    logs = [out_dir / f"rank{r}_of_{nproc}.log" for r in range(nproc)]
    procs = []
    try:
        for r, log in enumerate(logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    cmd + [str(r), ",".join(modes)], stdout=f,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + MESH_WORKER_TIMEOUT
        while any(p.poll() is None for p in procs) and \
                not any(p.returncode for p in procs) and \
                time.monotonic() < deadline:
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"phase 15: worker {r} of {nproc} exited "
                                 f"{p.returncode}\n"
                                 f"{log.read_text()[-4000:]}")
    infos, shards = [], []
    for r in range(nproc):
        infos.append(json.loads((out_dir / f"rank{r}_of_{nproc}.json"
                                 ).read_text()))
        got = {}
        with np.load(out_dir / f"rank{r}_of_{nproc}.npz") as z:
            for key in z.files:
                name, coord = key.split("|")
                mode, name = name.split("/")
                got.setdefault(mode, {}).setdefault(name, {})[
                    tuple(int(v) for v in coord.split(","))] = z[key]
        shards.append(got)
    return infos, shards


def compare_shards(ranks, ref, what: str, owner) -> float:
    """Every shard of ``ref`` ({name: {coord: array}}) from exactly one
    rank of ``ranks`` (each {name: {coord: array}}), the one ``owner(name,
    coord)`` names: integer and bool arrays equal, float ones within
    ``MESH_FLOAT_TOL`` of their peak.  Returns the largest float
    difference over its peak."""
    worst, seen = 0.0, set()
    for r, got in enumerate(ranks):
        for name, d in got.items():
            for c, v in d.items():
                want = ref[name][c]
                key = f"{what} {name} {c} (rank {r})"
                if owner(name, c) != r or (name, c) in seen:
                    raise AssertionError(f"{key}: not this rank's shard")
                seen.add((name, c))
                if v.shape != want.shape or v.dtype != want.dtype:
                    raise AssertionError(f"{key}: {v.shape} {v.dtype}, want "
                                         f"{want.shape} {want.dtype}")
                if v.dtype.kind != "f":
                    if not np.array_equal(v, want):
                        raise AssertionError(f"{key}: differs")
                    continue
                peak = float(np.abs(want).max()) if want.size else 0.0
                diff = float(np.abs(v - want).max()) if v.size else 0.0
                if diff > MESH_FLOAT_TOL * peak:
                    raise AssertionError(f"{key}: {diff:.3e} of a peak "
                                         f"{peak:.3e}")
                if peak:
                    worst = max(worst, diff / peak)
    missing = {(n, c) for n, d in ref.items() for c in d} - seen
    if missing:
        raise AssertionError(f"{what}: no rank returned {sorted(missing)}")
    return worst


def mesh_procs_phase(dev, card) -> dict:
    """Phase 15: the sharded station step across processes over NCCL,
    one GPU a process (``mesh_worker``), against one process's run of
    the same mesh on ``dev`` (virtual shards).  With fewer than two
    GPUs: the worker's refusal."""
    import torch
    from radiosonde_auto_rx_tpu_torch import kernels
    from radiosonde_auto_rx_tpu_torch.parallel.mesh import make_mesh
    from radiosonde_auto_rx_tpu_torch.parallel.pp import make_stage_mesh
    t_phase = time.perf_counter()
    out_dir = WORK / "mesh"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    n_gpu = torch.cuda.device_count()
    if n_gpu < 2:
        print(f"phase 15: {gpus_short(2)}: (a)-(e) not run on this host")
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--mesh-worker",
             str(out_dir), f"file://{out_dir / 'store'}", "2", "0",
             "fixture,production,headline"], capture_output=True,
            text=True, timeout=MESH_WORKER_TIMEOUT)
        if res.returncode != 1 or f"found {n_gpu}" not in res.stderr or \
                "needs 2 GPUs" not in res.stderr:
            raise AssertionError(f"phase 15: --mesh-worker with 2 processes "
                                 f"on {n_gpu} GPU exit {res.returncode}\n"
                                 f"{res.stderr[-2000:]}")
        print(f"phase 15 --mesh-worker, 2 processes on {n_gpu} GPU: exit 1, "
              f"{res.stderr.strip().splitlines()[-1]}")
        seconds = time.perf_counter() - t_phase
        print(f"phase 15 took {seconds:.1f} s")
        return dict(launches={}, seconds=seconds)

    n = 4 if n_gpu >= 4 else 2
    out = dict(launches={}, n=n)
    wide = fixture_captures()
    np.save(out_dir / "fixture.npy", wide)
    kernels.reset_launches()
    ref_fx = fixture_dataflow(wide, make_mesh(n_t=2, devices=[dev] * 8),
                              make_mesh(n_t=1, devices=[dev] * 8))
    ref_launches = dict(fixture=dict(kernels.launches))
    from radiosonde_auto_rx_tpu_torch.bench import _wide
    prod_wide = _wide(PROD_B, FS_WIDE, torch.device("cpu")).numpy()
    ref_prod = production_run(make_mesh(n, 1, devices=[dev] * n), prod_wide,
                              torch.cuda.synchronize)
    ref_launches["production"] = ref_prod["launches"]
    M = pp_input()[1]
    ref_pp = pp_run(make_stage_mesh(3, devices=[dev] * 3))
    # (d) in turns: one GPU, one process over n GPUs, n processes, then
    # the two again
    x = headline_input(dev)
    singles = {1: make_mesh(1, 1, devices=[dev]),
               n: make_mesh(n, 1, devices=[torch.device("cuda", i)
                                           for i in range(n)])}

    def single_turns(order):
        return {k: headline_msps(min(headline_walls(
            singles[k], x, torch.cuda.synchronize)[0])) for k in order}
    turns = [single_turns((1, n))]
    before = len(compute_pids())
    launched = {}
    if n > 2:
        launched[2] = launch_workers(out_dir, 2, ["fixture"])
    modes = ["fixture", "production", "headline"] + (["pp"] if n >= 3
                                                     else [])
    launched[n] = launch_workers(out_dir, n, modes)
    turns.append(single_turns((n, 1)))
    if n_gpu == 3:
        launched[3] = launch_workers(out_dir, 3, ["pp"])
    for k, (infos, _) in launched.items():
        # each worker holds one context (on its own GPU: the device
        # check below) and no other
        if infos[0]["contexts"] - before != k:
            raise AssertionError(f"phase 15: {k} processes held "
                                 f"{infos[0]['contexts']} CUDA contexts "
                                 f"with this process's {before}")
        for info in infos:
            if info["device"] != f"cuda:{info['rank']}":
                raise AssertionError(f"phase 15: rank {info['rank']} ran on "
                                     f"{info['device']}")
            la = info["launches"]
            if set(la) != {"pp"} and any(
                    sum(m[key] for m in la.values()) <= 0
                    for key in ("fsk_scan", "fft_abs2")):
                raise AssertionError(f"phase 15 ({k} processes) rank "
                                     f"{info['rank']}: launches {la}")
        for mode, want in ref_launches.items():
            if mode in infos[0]["launches"]:
                got = {key: sum(i["launches"][mode][key] for i in infos)
                       for key in want}
                if got != want:
                    raise AssertionError(f"phase 15 ({k} processes) {mode}: "
                                         f"the ranks launched {got}, one "
                                         f"process {want}")
        out["launches"][k] = [info["launches"] for info in infos]
    # (a), (b): every shard against the one-process run
    fx_err = {}
    for k, (infos, ranks) in launched.items():
        if "fixture" not in infos[0]["launches"]:
            continue
        local = FX_SHARDS // k
        fx_err[k] = compare_shards(
            [r["fixture"] for r in ranks], ref_fx, f"phase 15 ({k} "
            f"processes) fixture",
            lambda name, c, local=local: c[0] // (
                local if name == "pipeline_bits" else local // 2))
        assembled = {}
        for r in ranks:
            for name, d in r["fixture"].items():
                assembled.setdefault(name, {}).update(d)
        telems = fixture_rs41(assembled)
        if not telems or telems[-1]["id"] != "T1357911":
            raise AssertionError(f"phase 15 ({k} processes): the routed "
                                 f"RS41 slot decoded {telems}")
        print(f"phase 15 ({'a' if k == 2 else 'b'}) station_fixture's "
              f"dataflow over {k} processes (NCCL, one GPU each, "
              f"{FX_SHARDS // k} virtual shards a process): every shard of "
              f"the (4, 2) analyze/confirm/route_demod and the (8, 1) "
              f"make_station_step as one process's on {dev}: integers and "
              f"masks equal, floats within {fx_err[k]:.3e} of their peak "
              f"(tol {MESH_FLOAT_TOL}); the routed RS41 slot assembled from "
              f"the {k} ranks decodes {telems[-1]['id']}; launches by rank "
              f"{[i['launches']['fixture'] for i in infos]}")
    out["fixture_err"] = fx_err
    # (c) the production geometry, one shard a process
    infos, ranks = launched[n]
    prod_err = compare_shards([r["production"] for r in ranks],
                              ref_prod["out"], f"phase 15 ({n} processes) "
                              f"production", lambda name, c: c[0])
    out["production"] = dict(
        err=prod_err, ranks=[i["production"] for i in infos],
        one_process=dict(walls=ref_prod["walls"], busy=ref_prod["busy"],
                         launches=ref_prod["launches"]))
    print(f"phase 15 (c) production geometry ({PROD_B} x 1 s captures of "
          f"{FS_WIDE} Hz, {N_CHAN} channels; analyze(screen=False), confirm "
          f"on 20 slots, route_demod of bench.ACTIVES) on an ({n}, 1) mesh "
          f"over {n} processes: every shard as one process's ({n}, 1) "
          f"virtual mesh on {dev}, floats within {prod_err:.3e} of their "
          f"peak ({card})")
    for info in infos:
        p = info["production"]
        print(f"phase 15 (c) rank {info['rank']} ({info['device']}): step "
              f"wall median {statistics.median(p['walls']):.3f} ms "
              f"{[round(v, 3) for v in p['walls']]}, device busy "
              f"{p['busy']['compute']:.3f} ms + NCCL kernels "
              f"{p['busy']['nccl']:.3f} ms; launches "
              f"{info['launches']['production']}")
    print(f"phase 15 (c) one process, ({n}, 1) virtual mesh on {dev}: step "
          f"wall median {statistics.median(ref_prod['walls']):.3f} ms "
          f"{[round(v, 3) for v in ref_prod['walls']]}, device busy "
          f"{ref_prod['busy']['compute']:.3f} ms; launches "
          f"{ref_prod['launches']}")
    # (d) the headline over n processes: the slowest rank of each trial
    procs = max(headline_msps(max(t)) for t in zip(
        *[info["headline_s"] for info in infos]))
    for info in infos:
        if info["launches"]["headline"]["fsk_scan"] != 1:
            raise AssertionError(f"phase 15 (d) rank {info['rank']}: "
                                 f"launches {info['launches']['headline']}")
    out["headline_msps"] = dict(
        processes=procs, turns=turns,
        ratio_processes=procs / statistics.mean(t[1] for t in turns),
        ratio_one_process=statistics.mean(t[n] for t in turns) /
        statistics.mean(t[1] for t in turns))
    print(f"phase 15 (d) make_station_step at {HEADLINE[0]} x {HEADLINE[1]}"
          f" (RS41 buffered demod, one scan launch a shard), Msamples/s, "
          f"{HEADLINE_CALLS} calls a trial each ending in a host fetch: "
          f"{n} processes one GPU each {procs:.2f}; in turns one GPU "
          f"{[round(t[1], 2) for t in turns]}, one process over {n} GPUs "
          f"{[round(t[n], 2) for t in turns]} ({card})")
    # (e) the stage pipeline over three processes
    if n_gpu >= 3:
        infos, ranks = launched[n if n >= 3 else 3]
        soft, bits = (ranks[2]["pp"][k][(0,)] for k in ("pp_soft",
                                                        "pp_bits"))
        if not np.array_equal(bits, ref_pp[1].cpu().numpy()) or \
                np.abs(soft - ref_pp[0].cpu().numpy()).max() > \
                MESH_FLOAT_TOL * float(ref_pp[0].abs().max()):
            raise AssertionError("phase 15 (e): the 3-process pipeline's "
                                 "output differs from one process's")
        telems = pp_telemetry(torch.from_numpy(soft), torch.from_numpy(bits))
        l_pp = [i["launches"]["pp"] for i in infos]
        if not telems or telems[0]["id"] != "S0930112" or \
                l_pp[2]["fsk_scan_unbuffered"] != M or \
                any(la["fsk_scan"] for la in l_pp[:2]):
            raise AssertionError(f"phase 15 (e): {telems}, launches {l_pp}")
        print(f"phase 15 (e) make_pp_demod_pipeline over 3 processes (a "
              f"stage a GPU), {M} microbatches: the one-process pipeline's "
              f"output, {len(telems)} RS41 frames decoded; launches by rank "
              f"{l_pp}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 15 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------- #

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from radiosonde_auto_rx_tpu_torch import kernels
    from radiosonde_auto_rx_tpu_torch.bench import card_line
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
    k1, k1_launches = k1_phase(dev)
    scan, shapes = None, []
    for seed, (name, c) in enumerate(SCAN_SHAPES):
        res = check_scan(dev, name, cfg_of(name), c, seed)
        shapes.append(dict(chain=name, channels=c, **{
            k: v for k, v in res.items() if k != "max_abs_err"}))
        scan = scan or res
        scan["max_abs_err"] = max(scan["max_abs_err"], res["max_abs_err"])
    scan = dict(scan, shapes=shapes)
    unbuf, shapes = None, []
    for seed, (name, c) in enumerate(UNBUF_SHAPES):
        res = check_scan(dev, name, cfg_of(name), c, seed, buffered=False)
        shapes.append(dict(chain=name, channels=c, **{
            k: v for k, v in res.items() if k != "max_abs_err"}))
        unbuf = unbuf or res
        unbuf["max_abs_err"] = max(unbuf["max_abs_err"], res["max_abs_err"])
    unbuf = dict(unbuf, shapes=shapes)
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
    with DemodCalls() as calls:
        results, launches = drive_station(dev, runs, N_CHAN, FS_WIDE)
    for (st, telems, _), types, blocks in zip(
            results, (("RS41",), ("RS41", "DFM")), runs):
        seen = check_telemetry(telems, N_CHAN, FS_WIDE, types)
        print(f"phase 4 station, manual tasks, {len(blocks)} blocks of "
              f"{blocks[0].shape[1] // FS_WIDE} s: frames {seen}, "
              f"stats {st.stats}")
        if st.stats.get("fused_channels", 0) <= 0:
            raise AssertionError("the fused steady path served no channel")
    print(f"phase 4 kernel launches on the manual-task path: {launches}; "
          f"demod calls {calls.calls}")
    check_path_launches(launches, calls.calls, "manual-task")
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
    # decode, which synchronizes with the device), then a profile
    times = {True: [], False: []}
    groups = len({v["type"] for v in st.active.values()})
    kernels.reset_launches()
    with DemodCalls() as calls:
        for i in range(12):
            scan_next = (st._steady_tick + 1) % \
                int(st.config["scan_every"]) == 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st.process_captures([blocks[i % len(blocks)]])
            torch.cuda.synchronize()
            times[scan_next].append((time.perf_counter() - t0) * 1e3)
    for scan_blk in (True, False):
        print(f"phase 6 steady block scan={scan_blk}: median "
              f"{statistics.median(times[scan_blk]):.2f} ms over "
              f"{len(times[scan_blk])} blocks ({card})")
    print(f"phase 6 kernel launches over these 12 steady 1 s blocks: "
          f"{dict(kernels.launches)}; demod calls {calls.calls}, type "
          f"groups {groups}; host time in the demod calls "
          f"{calls.host_s * 1e3 / 12:.3f} ms per block")
    check_path_launches(kernels.launches, calls.calls, "steady")
    if kernels.launches["fsk_scan"] != 12 * groups:
        raise AssertionError("a steady block launched the scan other than "
                             "once a type group")
    prof = profile_steady(st, blocks)
    print(f"phase 6 profile of {prof['blocks']} steady 1 s blocks, per "
          f"block: {json.dumps(prof)} ({card})")
    split = split_rows(dev, runs, results, blocks, groups, card)

    # 7. detection: the same captures through a station with no task
    check_detector(dev, stream)
    want = [(typ, CENTER + f) for typ, _, f, _, _ in
            sondes_for(N_CHAN, FS_WIDE)]
    with DemodCalls() as d_calls:
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
    print(f"phase 7 kernel launches on the detection path: {d_launches}; "
          f"demod calls {d_calls.calls}")
    check_path_launches(d_launches, d_calls.calls, "detection")
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

    # 8. the narrow station's remaining paths
    paths = paths_phase(dev, card)

    # 9. the sequential station with the prescreen, and L-band
    seq = seq_phase(dev, card)

    # 10. the command lines: the station's and the demod CLI
    cli = cli_phase(dev, card)

    # 11. the quality tools: the PER gate, profile_station, the probe
    tools = tools_phase(dev, card, runs[0])

    # 12. the mesh: virtual meshes of the card
    mesh = mesh_phase(dev, card, stream)

    # 13. the reference's accelerator forms, forced by their switches
    forms = forms_phase(dev, card, stream, d_results, tools["profile"])

    # 14. the repository's two drivers: the bench and the entry points
    drivers = drivers_phase(dev, card)

    # 15. the sharded station step across processes over NCCL
    procs = mesh_procs_phase(dev, card)

    entries = []
    for name, src, rep, res, n in (
            ("fsk_scan", "radiosonde_auto_rx_tpu_torch/csrc/fsk_scan.cu",
             "radiosonde_auto_rx_tpu/ops/pallas_fsk.py:84 + the demod block "
             "around it, radiosonde_auto_rx_tpu/demod/fsk.py:306 in the "
             "lax.scan of :497", scan, d_launches["fsk_scan"]),
            ("fsk_scan_unbuffered",
             "radiosonde_auto_rx_tpu_torch/csrc/fsk_scan.cu",
             "radiosonde_auto_rx_tpu/ops/pallas_fsk.py:84 + the demod block "
             "around it, radiosonde_auto_rx_tpu/demod/fsk.py:306 in the "
             "lax.scan of :470 (_fsk_demod_scan, :492)", unbuf,
             cli["demod_cli"]["launches"]["fsk_scan_unbuffered"]),
            ("freq_est_sf", "radiosonde_auto_rx_tpu_torch/csrc/fsk_sf.cu",
             "radiosonde_auto_rx_tpu/ops/pallas_fsk.py:84", k1, k1_launches),
            ("fft_abs2", "radiosonde_auto_rx_tpu_torch/csrc/fft_abs2.cu",
             "radiosonde_auto_rx_tpu/ops/pallas_fft.py:162", k2,
             d_launches["fft_abs2"]),
            ("fft", "radiosonde_auto_rx_tpu_torch/csrc/fft_planes.cu",
             "radiosonde_auto_rx_tpu/ops/pallas_fft.py:172", k3,
             k3_launches)):
        entries.append(dict(name=name, route="cuda", source=src,
                            replaces=rep, launches=n, **res))
    by_name = {e["name"]: e for e in entries}
    scan_e, k1_e, k2_e = (by_name[k] for k in ("fsk_scan", "freq_est_sf",
                                               "fft_abs2"))
    scan_e["phase8_launches"] = {
        tag: v["launches"]["fsk_scan"] for tag, v in paths.items()}
    k2_e["phase8_launches"] = {
        tag: v["launches"]["fft_abs2"] for tag, v in paths.items()}
    for e, key in ((scan_e, "fsk_scan"), (k2_e, "fft_abs2")):
        e["phase9_launches"] = {tag: v[key] for tag, v in seq.items()}
        e["phase10_launches"] = cli["cli"]["launches"][key]
    for e, key in ((scan_e, "fsk_scan"), (k2_e, "fft_abs2")):
        e["phase6_split_launches"] = split["launches"][key]
    scan_e["phase11_launches"] = dict(
        per_gate=sum(p["fsk_scan"] for p in tools["per"]),
        profile_station=tools["profile"]["fsk_demod(all channels)"][
            "launches"]["fsk_scan"], probe=tools["probe_launches"])
    k2_e["phase11_launches"] = dict(profile_station=tools["profile"][
        "welch_psd hop=4*nfft"]["launches"]["fft_abs2"])
    for e, key in ((scan_e, "fsk_scan"), (k2_e, "fft_abs2")):
        e["phase12_launches"] = {
            tag: mesh[f"{tag}_launches"][key]
            for tag in ("batch", "one", "tshard", "station_step")}
    for e, key in ((scan_e, "fsk_scan"), (k2_e, "fft_abs2")):
        e["phase13_launches"] = forms["launches"][key]
    by_name["fsk_scan_unbuffered"]["phase12_launches"] = dict(
        pp=mesh["pp_launches"]["fsk_scan_unbuffered"])
    for e, key in ((scan_e, "fsk_scan"), (k2_e, "fft_abs2")):
        e["phase14_launches"] = dict(
            {p: drivers["bench"]["extra"][f"{p}_launches"][key]
             for p in BENCH_PROGRAMS}, dryrun=drivers["dryrun_launches"][key])
    for e, key in ((scan_e, "fsk_scan"), (k2_e, "fft_abs2")):
        # per launch of k processes, per rank: each mode's launches
        e["phase15_launches"] = {
            f"{k}_processes": [{mode: la[key] for mode, la in rank.items()}
                               for rank in ranks]
            for k, ranks in procs["launches"].items()}
    scan_e["max_abs_err"] = max(scan_e["max_abs_err"], drivers["scan_err"])
    scan_e["phase14_shapes"] = drivers["scan_shapes"]
    by_name["fsk_scan_unbuffered"]["phase14_launches"] = dict(
        entry=drivers["entry_launches"]["fsk_scan_unbuffered"],
        dryrun=drivers["dryrun_launches"]["fsk_scan_unbuffered"])
    by_name["fsk_scan_unbuffered"]["path"] = \
        "demod.cli.run (fsk_demod_stream(buffered=False))"
    by_name["fsk_scan_unbuffered"]["demod_cli"] = cli["demod_cli"]
    scan_e["cli_block_ms"] = cli["block_ms"]
    k1_e["path"] = "ops.fsk_sf.freq_est_sf"
    k1_e["station_launches"] = d_launches["freq_est_sf"]
    by_name["fft"]["path"] = "ops.fft.fft"
    print(f"card: {card}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def cli(argv) -> int:
    """The script's command line: no argument runs every phase;
    ``--forms OUT`` is phase 13 (b)'s child, ``--mesh-worker OUT INIT
    NPROC RANK MODES`` a process of phase 15's group."""
    if argv[:1] == ["--forms"]:
        return forms_child(argv[1])
    if argv[:1] == ["--mesh-worker"]:
        out, init, nproc, rank, modes = argv[1:6]
        return mesh_worker(out, init, int(nproc), int(rank),
                           modes.split(","))
    return main()


if __name__ == "__main__":
    sys.exit(cli(sys.argv[1:]))
