"""The sequential entry point and the L-band profile: the port's
``Station`` against the reference ``Station`` with ``use_mesh: false``
(no mesh: ``process_capture`` block by block), both on the CPU.

Narrow cases run at 768 kHz with 16 channels of 48 kHz, on captures made
with ``chip_smoke.synth_stream`` (the port's NumPy modulators and
encoders, seeded; ~0.002 RMS noise), cut into 2 s blocks.  Both stations
process the same blocks and must decode the same telemetry (``_key``:
type, serial, frame, position), hold the same tasks after each block and
count the same detections and frames:

- an RS41, a DFM and an iMet-4, each found by the scan and decoded;
- an RS41 10 kHz off grid (a recentered row) and two RS41s 12 kHz
  either side of one channel center (the second an appended row past
  the channel grid, so ``group_tasks_by_type`` sees ``n_rows`` >
  ``n_chan``);
- three sondes and six unmodulated carriers: nine candidates, so the
  detector's prescreen runs under its own rule (C >= 8) in both, keeps
  the sondes and rejects the carriers;
- two RS41s in two segments of the port's ``BandPlan`` (a copy of the
  reference's, held to it below), hopped A -> B -> A;
- ``captures_dispatch`` under ``use_mesh: false`` takes the sequential
  route (ROADMAP F5) and equals ``process_capture`` block by block.

L-band cases run at 960 kHz with ``num_channels_wide: 4`` (240 kHz
channels) centered at 1680 MHz, on signals built as
``tests/test_bandplan.py`` and ``tests/test_station.py`` build them:
an RS92-NGP found by the scan with the L-band detector, renamed from
RS92 and decoded through ``process_capture``; and ``decode_channel`` on
a 240 kHz RS92-NGP and MK2LMS channel.  Their telemetry is compared with
the subtype too (the RS92-NGP decoder takes ``ngp``).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from radiosonde_auto_rx_tpu.station.bandplan import BandPlan as RefBandPlan
from radiosonde_auto_rx_tpu.station.station import Station as RefStation
from radiosonde_auto_rx_tpu_torch.demod.modulate import add_awgn, gfsk_mod
from radiosonde_auto_rx_tpu_torch.detect.prescreen import MARGIN
from radiosonde_auto_rx_tpu_torch.models import mk2lms, rs92
from radiosonde_auto_rx_tpu_torch.ops.channelizer import channel_freqs
from radiosonde_auto_rx_tpu_torch.ops.resample import resample_planes
from radiosonde_auto_rx_tpu_torch.station.bandplan import BandPlan
from radiosonde_auto_rx_tpu_torch.station.chains import MODEL_NAME
from radiosonde_auto_rx_tpu_torch.station.config import default_config
from radiosonde_auto_rx_tpu_torch.station.station import Station

from test_offgrid import CENTER, FREQS, FS_WIDE, N_CHAN, _cfg, _Col, _key

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
SEQ = dict(use_mesh=False)
EPHS = rs92.make_test_ephemeris()


def _captures(sondes, seed, seconds=4, fs=FS_WIDE, n_chan=N_CHAN):
    stream = cs.synth_stream(n_chan, fs, seconds, seed=seed,
                             sondes=lambda n, f: sondes)
    return [b.astype(np.float32) / 32768.0
            for b in cs.split_blocks(stream, fs, 2)]


def _stations(**cfg):
    cfg = _cfg(**SEQ, **cfg)
    return (RefStation(cfg, exporters=[_Col()], center_freq_hz=CENTER),
            Station(cfg, exporters=[_Col()], center_freq_hz=CENTER,
                    device="cpu"))


def _tasks(st):
    return sorted((v["type"], fz) for fz, v in st.active.items())


def _run(st, caps, centers=None):
    telems, tasks = [], []
    for i, c in enumerate(caps):
        telems.extend(st.process_captures(
            [c], None if centers is None else [centers[i]]))
        tasks.append(_tasks(st))
    return sorted(map(_key, telems)), tasks, st.stats


def _parity(caps, centers=None, **cfg):
    ref, port = _stations(**cfg)
    assert ref.mesh is None
    (t_r, k_r, s_r), (t_p, k_p, s_p) = (_run(st, caps, centers)
                                        for st in (ref, port))
    assert t_p == t_r
    assert k_p == k_r
    for k in ("frames_ok", "frames_filtered", "detections"):
        assert s_p[k] == s_r[k], k
    return t_r, k_r, s_r


SONDES = {
    "RS41": ("RS41", "T1357911", float(FREQS[5]), -34.5, 138.6),
    "DFM": ("DFM", "21054321", float(FREQS[9]), 47.9, 16.8),
    "IMET4": ("IMET4", None, float(FREQS[12]), 45.46, 9.19),
}


@pytest.mark.parametrize("name", ["RS41", "DFM", "IMET4"])
def test_full_cycle_matches_reference(name):
    """Scan -> detect -> demod -> decode in the first block, the task
    re-decoded in the second (JAX ``tests/test_station.py`` full
    cycles)."""
    typ, serial, f, lat, lon = SONDES[name]
    telems, tasks, stats = _parity(_captures([SONDES[name]], seed=3))
    assert telems and {t[0] for t in telems} == \
        {MODEL_NAME.get(typ, typ)}
    assert all(abs(t[3] - lat) < 1e-4 and abs(t[4] - lon) < 1e-4
               for t in telems)
    if serial:
        assert {t[1] for t in telems} == {cs.want_id(typ, serial)}
    assert tasks == [[(typ, int(CENTER + f))]] * 2
    assert stats["detections"] == 1


def test_off_grid_and_appended_rows_match_reference():
    """An RS41 10 kHz off its channel center (recentered) and two RS41s
    12 kHz either side of another channel center (the second one's row
    is appended past the 16 channels)."""
    sondes = [("RS41", "P2468024", float(FREQS[3]) + 10e3, -31.9, 115.9),
              ("RS41", "R3141592", float(FREQS[7]) - 12e3, 59.33, 18.07),
              ("RS41", "S2718281", float(FREQS[7]) + 12e3, 52.52, 13.41)]
    caps = _captures(sondes, seed=9)
    rows = {}
    ref, port = _stations()
    out = []
    for tag, st in (("ref", ref), ("port", port)):
        group = st.group_tasks_by_type
        seen = rows.setdefault(tag, [])

        def counted(tasks, n_rows, group=group, seen=seen):
            seen.append(n_rows)
            return group(tasks, n_rows)
        st.group_tasks_by_type = counted
        out.append(_run(st, caps))
    assert out[1][:2] == out[0][:2]
    assert out[1][2]["detections"] == out[0][2]["detections"] == 3
    assert rows["port"] == rows["ref"] and max(rows["ref"]) > N_CHAN
    assert {t[1] for t in out[0][0]} == {s[1] for s in sondes}
    assert len(out[0][1][-1]) == 3


def test_prescreen_auto_rule_matches_reference():
    """Nine candidates: three sondes and six carriers.  Both detectors
    run their prescreen on the first block's nine candidate rows (and
    not on the second block's six, where the sondes are tasks), reject
    the carriers and find the sondes."""
    caps = _captures(list(SONDES.values()), seed=4)
    t = np.arange(caps[0].shape[-1]) / FS_WIDE
    carriers = [float(FREQS[k]) for k in (1, 3, 7, 11, 14, 15)]
    tone = sum(0.05 * np.exp(2j * np.pi * f * t) for f in carriers)
    for c in caps:
        c += np.stack([tone.real, tone.imag]).astype(np.float32)
    ref, port = _stations()
    seen = {}
    for tag, st in (("ref", ref), ("port", port)):
        pre = st.detector.prescreen
        scores = pre.scores
        seen[tag] = []

        def recorded(x, scores=scores, out=seen[tag]):
            r = scores(x)
            out.append(np.asarray(r))
            return r
        pre.scores = recorded
    (t_r, k_r, s_r), (t_p, k_p, s_p) = (_run(st, caps)
                                        for st in (ref, port))
    assert (t_p, k_p, s_p["detections"]) == (t_r, k_r, s_r["detections"])
    assert [len(r) for r in seen["port"]] == [len(r) for r in
                                              seen["ref"]] == [9]
    keep = [r >= MARGIN for r in (seen["ref"][0], seen["port"][0])]
    np.testing.assert_array_equal(keep[1], keep[0])
    assert keep[0].sum() == 3
    assert [typ for typ, _ in k_r[-1]] == ["DFM", "IMET4", "RS41"]
    assert s_r["detections"] == 3


def test_bandplan_hops_match_reference():
    """Two RS41s 1.2 MHz apart, in two segments of one band plan: each
    decodes in its segment's block, and the first task survives the hop
    to the second segment and back (JAX ``tests/test_bandplan.py``)."""
    cfg = {**default_config(), **_cfg(min_freq=400.0, max_freq=401.2)}
    plan = BandPlan(cfg)
    assert [s.center_hz for s in plan.segments] == \
        [s.center_hz for s in RefBandPlan(cfg).segments]
    assert len(plan.segments) == 2
    caps, centers = [], []
    for i, (freq, serial) in enumerate(((400.2e6, "N1111111"),
                                        (401.0e6, "P2222222"))):
        seg = plan.segment_of(freq)
        off = freq - seg.center_hz
        f = float(FREQS[np.argmin(np.abs(FREQS - off))])
        caps.append(_captures([("RS41", serial, f, -34.5 + i, 138.6)],
                              seed=11 + i)[0])
        centers.append(seg.center_hz)
    caps.append(caps[0])
    centers.append(centers[0])
    telems, tasks, _ = _parity(caps, centers,
                               min_freq=400.0, max_freq=401.2)
    assert {t[1] for t in telems} == {"N1111111", "P2222222"}
    assert len(tasks[1]) == len(tasks[2]) == 2


def test_use_mesh_false_takes_the_sequential_route():
    """``use_mesh: false`` dispatches the sequential route (ROADMAP F5;
    JAX ``station.py:783-785``), whose collect is ``process_capture``
    per block; with the key unset the fused route stays."""
    caps = _captures([SONDES["RS41"]], seed=3)
    a = Station(_cfg(**SEQ), center_freq_hz=CENTER, device="cpu")
    b = Station(_cfg(**SEQ), center_freq_hz=CENTER, device="cpu")
    pending = a.captures_dispatch(caps)
    assert pending[0] == "seq"
    got = sorted(map(_key, a.captures_collect(pending)))
    want = []
    for c in caps:
        want.extend(b.process_capture(c))
    assert got == sorted(map(_key, want)) and got
    assert _tasks(a) == _tasks(b)
    fused = Station(_cfg(), center_freq_hz=CENTER, device="cpu")
    assert fused.captures_dispatch(caps[:1])[0] == "steady"


# ---------------------------------------------------------------------- #
# L-band: 960 kHz, four 240 kHz channels at 1680 MHz

FS_L = 960_000
LBAND = 1680.0e6


def _lband_stations():
    cfg = _cfg(**SEQ, capture_rate=FS_L, num_channels_wide=4,
               rs92_ephemeris=EPHS)
    return (RefStation(cfg, exporters=[_Col()], center_freq_hz=LBAND),
            Station(cfg, exporters=[_Col()], center_freq_hz=LBAND,
                    device="cpu"))


def _lkey(telems):
    return sorted(_key(t) + (t.get("subtype"),) for t in telems)


def _rs92ngp_bits(n_frames):
    cal = rs92.make_calibytes(ngp=True, freq_khz=1680000)
    raw = rs92.encode_flight_bits(n_frames=n_frames, ephs=EPHS,
                                  calibytes=cal, ngp=True, lat=-34.95,
                                  lon=138.52, alt=12000.0)
    idle = np.tile(np.array([1, 0], np.uint8), 300)
    tail = np.tile(np.array([1, 0], np.uint8), 700)
    return np.concatenate([idle, np.asarray(raw, np.uint8), tail])


def test_lband_rs92ngp_process_capture_matches_reference():
    """An RS92-NGP (4800 Bd, ~20 kHz tone spacing) on the second 240 kHz
    channel of a 1680 MHz capture: the scan finds it, the L-band detector
    types it RS92, the station renames it RS92NGP and decodes it."""
    f = float(channel_freqs(4, FS_L)[1])
    rng = np.random.default_rng(4)
    T = 2 * FS_L
    x = (rng.standard_normal(T) + 1j * rng.standard_normal(T)) * 0.002
    sig = gfsk_mod(_rs92ngp_bits(2), FS_L, 4800, 2, f, 20000, bt=0.5)
    x[:min(T, len(sig))] += 0.2 * sig[:T]
    cap = np.stack([x.real, x.imag]).astype(np.float32)
    ref, port = _lband_stations()
    assert port.profile().fs_ch == 240000 and port.profile().wide
    assert port.detector.lband and port.detector.prescreen is None
    out = [(_lkey(st.process_captures([cap])), _tasks(st),
            st.stats["detections"]) for st in (ref, port)]
    assert out[1] == out[0]
    telems, tasks, detections = out[0]
    assert tasks == [("RS92NGP", int(LBAND + f))] and detections == 1
    assert telems and {t[1] for t in telems} == {"R1234567"}
    assert {t[-1] for t in telems} == {"RS92-NGP"}
    assert all(abs(t[3] + 34.95) < 5e-4 for t in telems)


def _mk2lms_channel():
    rng = np.random.default_rng(5)
    raw = mk2lms.encode_flight_bits(sid32=7654321, n_frames=4, lat=51.0,
                                    lon=7.0, alt=15000.0)
    tx = np.concatenate([np.tile([1, 0], 300), raw,
                         np.tile([1, 0], 300)]).astype(np.uint8)
    iq = add_awgn(gfsk_mod(tx, 240400, 9616, 2, 0.0, 100000, bt=1.0),
                  18.0, 240400, 9616, rng=rng)
    planes = torch.from_numpy(np.stack([iq.real, iq.imag])
                              .astype(np.float32))
    return resample_planes(planes, 240400, 240000).numpy()


def _rs92ngp_channel():
    rng = np.random.default_rng(6)
    iq = add_awgn(gfsk_mod(_rs92ngp_bits(2), 240000, 4800, 2, 0.0, 20000,
                           bt=0.5), 18.0, 240000, 4800, rng=rng)
    return np.stack([iq.real, iq.imag]).astype(np.float32)


@pytest.mark.parametrize("name,ci,want", [
    ("MK2LMS", 2, ("LMS6-7654321", "MK2A", 51.0)),
    ("RS92NGP", 1, ("R1234567", "RS92-NGP", -34.95))])
def test_lband_decode_channel_matches_reference(name, ci, want):
    """``decode_channel`` on one 240 kHz channel known to carry ``name``
    (JAX ``tests/test_station.py:300``, ``tests/test_bandplan.py:162``);
    the L-band detectors type the RS92-NGP channel RS92 alike."""
    planes = _mk2lms_channel() if name == "MK2LMS" else _rs92ngp_channel()
    ref, port = _lband_stations()
    out = [_lkey(st.decode_channel(planes, ci, name)) for st in (ref, port)]
    assert out[1] == out[0] and out[0]
    sid, sub, lat = want
    assert {(t[1], t[-1]) for t in out[0]} == {(sid, sub)}
    assert all(abs(t[3] - lat) < 5e-4 for t in out[0])
    if name == "RS92NGP":
        d_r = ref.detector.detect(jnp.asarray(planes)[None])[0]
        d_p = port.detector.detect(torch.from_numpy(planes)[None])[0]
        assert [(d.name, d.position) for d in d_p] == \
            [(d.name, d.position) for d in d_r] and d_r[0].name == "RS92"


def test_bandplan_is_a_copy():
    """The port's ``station/bandplan.py`` is the reference's file (it
    imports only ``dataclasses``)."""
    ours = (ROOT / "radiosonde_auto_rx_tpu_torch/station/bandplan.py")
    theirs = (ROOT / "radiosonde_auto_rx_tpu/station/bandplan.py")
    assert ours.read_text() == theirs.read_text()
