"""The port's frame-plane worker pool (``station/frame_plane.py``, a copy of
the JAX package's, and ``Station._decode_rows``, the station's one decode
fan-out into it, pooled or inline) on the CPU.

Station level, block by block on the same captures (``tests/
test_offgrid.py``'s 768 kHz, 16-channel geometry): the port's station
with a pool of 2 workers, the port's inline station
(``frame_plane_workers`` 0) and the JAX package's pooled station (on a
1-device mesh for the fused route) decode the same telemetry
(``_key``: type, serial, frame, position) and hold the same task keys
after every block.

* A sonde drifting +12 kHz a block with no manual task, on the
  sequential route (``use_mesh: false``, as ``tests/test_offgrid.py``'s
  drift case): every block detects or absorbs it and decodes it through
  ``decode_channels`` → ``_decode_rows``, and the task follows
  the drift, so its decoder state is re-keyed in the worker that owns
  it (``FramePlane.rekey``; the reference's pool drops it where the new
  key hashes to another worker, and the sonde re-locks).
* Manual RS41 and DFM tasks (the DFM 20 kHz off grid), two blocks of the
  fused steady step (``_decode_fused``).
* Manual RS41, DFM, M10 and M20 tasks in one capture, so one gather
  holds four types, with a hand-over after every gather.
* A station whose ``__main__`` cannot be spawned falls back to the
  inline plane at its first decode and keeps that block's DFM state.
The pooled and the inline station keep no decoder in their task state:
``FramePlane`` holds each task's.

Plane level: the inline plane decodes and keeps decoder state, a
decoder's error stays with its ticket (in a worker and inline), a
task's decoder is rebuilt when its type changes, ``drop`` and ``rekey``
reach the worker that owns the task.  The placement table puts a task on the
least-loaded worker by measured cost; ``rekey`` keeps the state with
its owner and ``drop`` frees the entry; a hand-over is exact for every
model of ``models.get_model``'s registry; moves and tasks a worker are
counted.
"""

import os

import jax
import numpy as np
import pytest
import torch

from radiosonde_auto_rx_tpu.parallel.mesh import make_mesh
from radiosonde_auto_rx_tpu.station.station import Station as RefStation
from radiosonde_auto_rx_tpu_torch.demod.modulate import gfsk_mod
from radiosonde_auto_rx_tpu_torch.models import available_models
from radiosonde_auto_rx_tpu_torch.models.dfm import encode_flight_bits
from radiosonde_auto_rx_tpu_torch.models.rs92 import make_test_ephemeris
from radiosonde_auto_rx_tpu_torch.station import frame_plane
from radiosonde_auto_rx_tpu_torch.station.frame_plane import FramePlane
from radiosonde_auto_rx_tpu_torch.station.station import Station
from radiosonde_auto_rx_tpu_torch.tools import per_harness
from radiosonde_auto_rx_tpu_torch.utils import probe

from station_fixture import (dfm_bits, m10_bits, m20_bits, rs41_bits,
                             taper)
from test_offgrid import (CENTER, FREQS, FS_WIDE, RS41_CH, RS41_TS, T_WIDE,
                          _capture, _cfg, _Col, _key)

torch.set_num_threads(1)


def _stations(workers=2, **cfg):
    # the reference's fused route on one device (a mesh given to the
    # reference station takes that route whatever use_mesh says)
    mesh = make_mesh(n_ch=1, n_t=1, devices=jax.devices()[:1]) \
        if cfg.get("use_mesh", True) else None
    return {
        "port_pool": Station(_cfg(frame_plane_workers=workers, **cfg),
                             exporters=[_Col()], center_freq_hz=CENTER,
                             device="cpu"),
        "port_inline": Station(_cfg(frame_plane_workers=0, **cfg),
                               exporters=[_Col()], center_freq_hz=CENTER,
                               device="cpu"),
        "ref_pool": RefStation(_cfg(frame_plane_workers=2, **cfg),
                               exporters=[_Col()], center_freq_hz=CENTER,
                               mesh=mesh),
    }


def _drive(stations, caps):
    """Each station through the captures, block by block: [(telemetry
    keys, task keys)] a block, by mode."""
    out = {m: [] for m in stations}
    try:
        for cap in caps:
            for m, st in stations.items():
                telems = st.process_captures([cap])
                out[m].append((sorted(map(_key, telems)),
                               sorted(st.active)))
    finally:
        for st in stations.values():
            st.close()
    return out


def _drift_capture(i, off):
    rng = np.random.default_rng(31 + i)
    wide = (rng.standard_normal(T_WIDE) + 1j *
            rng.standard_normal(T_WIDE)).astype(np.complex64) * 0.002
    sig = taper(gfsk_mod(rs41_bits(np.random.default_rng(77),
                                   ts=RS41_TS + i),
                         FS_WIDE, 4800, 2, FREQS[RS41_CH] + off, 4800,
                         bt=0.5)[:T_WIDE])
    wide[:len(sig)] += sig
    return np.stack([wide.real, wide.imag]).astype(np.float32)


def test_pooled_station_follows_drift_like_inline_and_reference():
    stations = _stations(use_mesh=False)
    pool = stations["port_pool"]
    assert pool.frame_plane.workers == 2
    rekeys = []
    rekey = pool.frame_plane.rekey
    pool.frame_plane.rekey = lambda a, b: rekeys.append((a, b)) or rekey(a, b)
    caps = [_drift_capture(i, off)
            for i, off in enumerate((14e3, 26e3, 38e3))]
    out = _drive(stations, caps)
    assert out["port_pool"] == out["port_inline"] == out["ref_pool"]
    for telems, tasks in out["port_pool"]:
        assert telems and len(tasks) == 1
    # the task followed the sonde across the channel boundary, and its
    # decoder state moved with it
    assert out["port_pool"][0][1] != out["port_pool"][-1][1]
    assert rekeys and all(a != b for a, b in rekeys)
    # the pooled station keeps no decoder in the main process: its
    # workers hold the task
    assert all("decoder" not in st for st in pool.active.values())
    assert set(pool.frame_plane.owner) == set(pool.active)


def test_pooled_manual_tasks_match_inline_and_reference():
    stations = _stations()
    for st in stations.values():
        st.start_manual_decoder(CENTER + FREQS[5], "RS41")
        st.start_manual_decoder(CENTER + FREQS[4] - 20e3, "DFM")
    caps = [_capture(0.0, -20e3, seed=21 + i) for i in range(2)]
    pool = stations["port_pool"]
    out = _drive(stations, caps)
    assert out["port_pool"] == out["port_inline"] == out["ref_pool"]
    types = {k[0] for telems, _ in out["port_pool"] for k in telems}
    assert types == {"RS41", "DFM"}
    assert all("decoder" not in st for st in pool.active.values())
    assert set(pool.frame_plane.owner) == set(pool.active)
    inline = stations["port_inline"]
    assert all("decoder" not in st for st in inline.active.values())
    assert set(inline.frame_plane._decoders) == set(inline.active)


DFM_F = FREQS[4] - 20e3


def _four_types_capture(i):
    """RS41, DFM, M10 and M20 on channels 5, 4 (20 kHz below its
    center), 11 and 9 of one capture."""
    rng = np.random.default_rng(41 + i)
    wide = (rng.standard_normal(T_WIDE) + 1j *
            rng.standard_normal(T_WIDE)).astype(np.complex64) * 0.002
    bits_rng = np.random.default_rng(77)
    for bits, rs, f, spacing, bt in (
            (rs41_bits(bits_rng, ts=RS41_TS + i), 4800, FREQS[5], 4800, 0.5),
            (dfm_bits(bits_rng, n_cycles=3), 2500, DFM_F, 5000, 0.5),
            (m10_bits(bits_rng), 9616, FREQS[11], 10000, 1.0),
            (m20_bits(bits_rng), 9600, FREQS[9], 9600, 1.0)):
        sig = taper(gfsk_mod(bits, FS_WIDE, rs, 2, f, spacing,
                             bt=bt)[:T_WIDE])
        wide[:len(sig)] += sig
    return np.stack([wide.real, wide.imag]).astype(np.float32)


def test_pooled_types_in_one_gather_match_inline_and_reference(
        monkeypatch):
    """Four types decode in one gather over four workers, and a task is
    handed over after every gather (any move that keeps the larger load
    below twice the busiest's, and no hold): the telemetry is the inline
    plane's and the reference's, block by block."""
    monkeypatch.setattr(frame_plane, "MOVE_MARGIN", -1.0)
    monkeypatch.setattr(frame_plane, "MOVE_HOLD", 1)
    stations = _stations(workers=4)
    for st in stations.values():
        for f, typ in ((FREQS[5], "RS41"), (DFM_F, "DFM"),
                       (FREQS[11], "M10"), (FREQS[9], "M20")):
            st.start_manual_decoder(CENTER + f, typ)
    pool = stations["port_pool"]
    # two blocks: on a third the reference's RS41 follows a 700 Hz
    # drift the port's does not see (F11, as in the split route's test)
    caps = [_four_types_capture(i) for i in range(2)]
    out = _drive(stations, caps)
    assert out["port_pool"] == out["port_inline"] == out["ref_pool"]
    types = {k[0] for telems, _ in out["port_pool"] for k in telems}
    assert types == {"RS41", "DFM", "M10", "M20"}
    assert sum(pool.stats["pool_tasks"]) == len(pool.frame_plane.owner) == 4
    assert pool.stats["pool_moves"] == pool.frame_plane.moves >= 1
    assert sum(pool.stats["pool_decodes"]) == 8


def _dfm_capture(i):
    """Cycles 2i and 2i+1 of a six-cycle DFM flight (one serial half in
    cycle 2, the other in cycle 3) on channel 4, 20 kHz below its
    center: the serial is confirmed in the second block by a decoder
    that kept the first block's half."""
    flight = encode_flight_bits(sn=21054321, lat=47.9, lon=16.8,
                                n_cycles=6, time_step=1.0)
    n = 2 * len(flight) // 6
    rng = np.random.default_rng(51 + i)
    bits = np.concatenate([rng.integers(0, 2, 500),
                           flight[i * n:(i + 1) * n]]).astype(np.uint8)
    wide = (rng.standard_normal(T_WIDE) + 1j *
            rng.standard_normal(T_WIDE)).astype(np.complex64) * 0.002
    sig = taper(gfsk_mod(bits, FS_WIDE, 2500, 2, DFM_F, 5000,
                         bt=0.5)[:T_WIDE])
    wide[:len(sig)] += sig
    return np.stack([wide.real, wide.imag]).astype(np.float32)


def test_spawn_fallback_keeps_the_first_blocks_state(monkeypatch,
                                                      tmp_path):
    """A pooled station whose ``__main__`` cannot be spawned falls back
    to the inline plane at its first decode, and that plane keeps the
    first block's decoder state: a DFM whose serial halves arrive in two
    blocks is confirmed on the second, as on the inline station."""
    import __main__
    monkeypatch.setattr(__main__, "__file__", str(tmp_path / "gone.py"),
                        raising=False)
    stations = {m: Station(_cfg(frame_plane_workers=w), exporters=[_Col()],
                           center_freq_hz=CENTER, device="cpu")
                for m, w in (("fallback", 2), ("inline", 0))}
    for st in stations.values():
        st.start_manual_decoder(CENTER + DFM_F, "DFM")
    fallback = stations["fallback"]
    out = _drive(stations, [_dfm_capture(i) for i in range(3)])
    assert fallback.frame_plane.workers == 0
    assert fallback.frame_plane._procs == []
    assert out["fallback"] == out["inline"]
    assert [bool(telems) for telems, _ in out["inline"]] == \
        [False, True, True]


def test_inline_plane_decodes():
    """workers=0: decode/gather inline, decoder state persists."""
    plane = FramePlane(workers=0)
    bits = encode_flight_bits(n_cycles=3)
    t1 = plane.decode(400_500_000, "DFM", "DFM", {}, bits, None)
    assert plane.gather()[t1], "no telemetry from the inline plane"
    t2 = plane.decode(400_500_000, "DFM", "DFM", {}, bits, None)
    assert plane.gather()[t2]
    plane.rekey(400_500_000, 400_510_000)
    assert list(plane._decoders) == [400_510_000]
    plane.close()


@pytest.mark.parametrize("workers", [0, 2])
def test_pooled_worker_error_isolated(workers):
    """A decoder that raises, in a worker or inline, yields [] for its
    ticket; the other tickets and the plane survive; drop and rekey
    reach the worker that holds the state."""
    plane = FramePlane(workers=workers)
    try:
        bits = encode_flight_bits(n_cycles=3)
        bad = plane.decode(400_000_000, "RS41", "RS41",
                           {"no_such_kwarg": 1},
                           bits, None)
        good = plane.decode(400_010_000, "DFM", "DFM", {}, bits, None)
        res = plane.gather()
        assert res[bad] == []
        assert res[good], "good ticket starved by the bad one"
        plane.drop(400_010_000)
        again = plane.decode(400_010_000, "DFM", "DFM", {}, bits, None)
        assert plane.gather()[again]
        # a rekey moves the state within the worker that owns it,
        # wherever the new key lies; decoding goes on at the new keys
        plane.rekey(400_010_000, 400_010_002)
        plane.rekey(400_010_002, 400_010_003)
        moved = plane.decode(400_010_003, "DFM", "DFM", {}, bits, None)
        assert plane.gather()[moved]
        assert all(p.is_alive() for p in plane._procs)
    finally:
        plane.close()
    assert plane._procs == []


def test_pool_workers_load_no_torch():
    """The pool's spawned workers decode with NumPy alone: none maps
    ``torch`` or the CUDA driver, so none can open a CUDA context beside
    a parent that holds one (``chip_smoke.py`` phase 10 checks the same
    on the card)."""
    plane = FramePlane(workers=2)
    try:
        bits = encode_flight_bits(n_cycles=3)
        tickets = [plane.decode(400_000_000 + 10_000 * i, "DFM", "DFM", {},
                                bits, None) for i in range(2)]
        res = plane.gather()
        assert all(res[t] for t in tickets)
        assert len(plane._procs) == 2
        for p in plane._procs:
            with open(f"/proc/{p.pid}/maps") as f:
                maps = f.read()
            assert "libtorch" not in maps and "libcuda" not in maps, p.pid
        with open(f"/proc/{os.getpid()}/maps") as f:
            assert "libtorch" in f.read()     # the check sees torch here
    finally:
        plane.close()


F = 400_000_000
# the PER harness's frame generator for each registered model
HARNESS = {"DFM": "DFM", "DROPSONDE": "RD94RD41", "IMET": "IMET4",
           "IMET5": "IMET54", "LMS6": "LMS6", "M10": "M10", "M20": "M20",
           "MEISEI": "MEISEI", "MK2LMS": "MK2LMS", "MRZ": "MRZ",
           "MTS01": "MTS01", "RS41": "RS41", "RS92": "RS92",
           "WXR301": "WXR301", "WXRPN9": "WXRPN9"}


def _stream(model):
    """(clean on-air bits of a few frames, the decoder's kwargs)."""
    case = per_harness.CASES[HARNESS[model]](4, np.random.default_rng(5),
                                             None)
    kwargs = {"ephemeris": make_test_ephemeris()} if model == "RS92" \
        else {}
    return np.asarray(case.tx_bits, np.uint8), kwargs


def _halves(plane, fz, model, kwargs, bits, between=None, fz2=None):
    """Decodes ``bits`` in two halves, at ``fz`` and then at ``fz2``
    (default ``fz``); ``between(plane)`` runs after the first half's
    gather."""
    h = len(bits) // 2
    t = plane.decode(fz, model, model, kwargs, bits[:h], None)
    first = plane.gather()[t]
    if between is not None:
        between(plane)
    t = plane.decode(fz if fz2 is None else fz2, model, model, kwargs,
                     bits[h:], None)
    return first, plane.gather()[t]


@pytest.mark.parametrize("workers", [0, 2])
def test_type_change_rebuilds_the_decoder(workers):
    """An iMet task whose subtype changes at one frequency (IMET4 and
    IMET1RS both decode with model IMET) gets a new decoder, pooled and
    inline alike; the same type keeps its decoder.  Each decode asks for
    a decoder built with another ``jsn_freq_khz``, which the telemetry
    shows, so the telemetry names the decoder that ran."""
    case = per_harness.CASES["IMET4"](2, np.random.default_rng(5), None)
    bits = np.asarray(case.tx_bits, np.uint8)
    plane = FramePlane(workers=workers)
    built = []
    try:
        for khz, name in enumerate(("IMET4", "IMET4", "IMET1RS", "IMET1RS",
                                    "IMET4"), 1):
            t = plane.decode(F, name, "IMET", {"jsn_freq_khz": khz}, bits,
                             None)
            telems = plane.gather()[t]
            assert telems
            built.append({x["freq"] for x in telems})
    finally:
        plane.close()
    assert built == [{1}, {1}, {3}, {3}, {5}]


def test_placement_by_measured_cost():
    """A task lands on the least-loaded worker at its first decode: four
    tasks of one model, each measured before the next is placed, spread
    over four workers and stay there when decoded together; with costs
    set, a task goes away from the loaded worker where placement by
    count would put it beside it, and an unmeasured task costs the mean
    of its model's measured tasks, else of all."""
    dfm = encode_flight_bits(n_cycles=2)
    plane = FramePlane(workers=4)
    try:
        for i in range(4):
            plane.decode(F + 10_000 * i, "DFM", "DFM", {}, dfm, None)
            plane.gather()
        want = {F + 10_000 * i: i for i in range(4)}
        assert plane.owner == want
        for _ in range(2):
            for i in range(4):
                plane.decode(F + 10_000 * i, "DFM", "DFM", {}, dfm, None)
            assert all(plane.gather().values())
        assert plane.owner == want and plane.moves == 0
        assert plane.tasks() == [1, 1, 1, 1]
    finally:
        plane.close()
    rs41, _ = _stream("RS41")
    plane = FramePlane(workers=2)
    try:
        plane.decode(F, "RS41", "RS41", {}, rs41, None)
        plane.gather()
        plane.decode(F + 10_000, "DFM", "DFM", {}, dfm, None)
        plane.gather()
        assert plane.owner == {F: 0, F + 10_000: 1}
        plane._cost.update({F: 100.0, F + 10_000: 5.0})
        plane.decode(F + 20_000, "DFM", "DFM", {}, dfm, None)     # costs 5
        assert plane.owner[F + 20_000] == 1
        plane.decode(F + 30_000, "RS41", "RS41", {}, rs41, None)  # costs 100
        assert plane.owner[F + 30_000] == 1
        assert plane._loads()[0] == [100.0, 110.0]
        plane.decode(F + 40_000, "M10", "M10", {}, dfm, None)     # costs 52.5
        assert plane.owner[F + 40_000] == 0
        assert plane._loads()[0] == [152.5, 110.0]
        plane.gather()
    finally:
        plane.close()


def test_rekey_keeps_the_state_with_its_owner():
    """A rekey moves the table entry and the owner re-keys the state in
    place, also 1 Hz away (a key that hashed to the other worker): the
    second half decodes as one decoder's, which a fresh decoder does
    not."""
    bits, kwargs = _stream("MK2LMS")
    plane = FramePlane(workers=2)
    try:
        pooled = _halves(plane, F, "MK2LMS", kwargs, bits,
                         lambda p: p.rekey(F, F + 1), F + 1)
        plane.decode(F + 2, "MK2LMS", "MK2LMS", kwargs,
                     bits[len(bits) // 2:], None)
        fresh = list(plane.gather().values())[0]
        assert plane.owner == {F + 1: 0, F + 2: 1}
    finally:
        plane.close()
    inline = FramePlane(workers=0)
    want = _halves(inline, F, "MK2LMS", kwargs, bits,
                   lambda p: p.rekey(F, F + 1), F + 1)
    assert pooled == want and pooled[1]
    assert fresh != pooled[1]


def test_drop_frees_the_entry():
    """``drop`` reaches the owner and removes the entry and its cost: the
    task decodes afresh where it is placed next."""
    bits, kwargs = _stream("MK2LMS")
    plane = FramePlane(workers=2)
    try:
        first, second = _halves(plane, F, "MK2LMS", kwargs, bits,
                                lambda p: p.drop(F))
        assert plane.owner == {F: 0}
        plane.drop(F)
        assert plane.owner == {} and plane.tasks() == [0, 0]
        assert F not in plane._cost and F not in plane._model
    finally:
        plane.close()
    fresh = FramePlane(workers=0)
    t = fresh.decode(F, "MK2LMS", "MK2LMS", kwargs, bits[len(bits) // 2:],
                     None)
    assert first and second == fresh.gather()[t]


@pytest.fixture(scope="module")
def pair():
    plane = FramePlane(workers=2)
    yield plane
    plane.close()


@pytest.mark.parametrize("model", sorted(HARNESS))
def test_hand_over_is_exact(pair, model):
    """Every registered model: the first half of a stream decodes in one
    worker, the state is handed over, the second half decodes in the
    other; the telemetry is one decoder's over both halves."""
    assert set(HARNESS) == set(available_models())
    bits, kwargs = _stream(model)
    fz = F + 10_000 * sorted(HARNESS).index(model)
    moved = []

    def hand_over(p):
        src = p.owner[fz]
        moved.append((src, list(p.decodes)))
        p._hand_over(fz, 1 - src)

    pooled = _halves(pair, fz, model, kwargs, bits, hand_over)
    (src, before), = moved
    assert pair.owner[fz] == 1 - src
    assert pair.decodes[1 - src] == before[1 - src] + 1
    pair.drop(fz)
    want = _halves(FramePlane(workers=0), fz, model, kwargs, bits)
    assert pooled == want
    assert pooled[0] + pooled[1], "the stream decodes nothing"


def test_pool_counts_moves_and_tasks():
    """A hand-over is counted in ``moves`` and, while spans record, as
    ``pool_moves``; the moved task stays put for MOVE_HOLD gathers and
    decodes in its new worker."""
    dfm = encode_flight_bits(n_cycles=2)
    a, b, c = F, F + 10_000, F + 20_000
    probe.reset_spans()
    probe.enable_spans()
    plane = FramePlane(workers=2)
    try:
        for fz in (a, b, c):             # unmeasured: placed by count
            plane.decode(fz, "DFM", "DFM", {}, dfm, None)
        plane.gather()
        assert plane.owner == {a: 0, b: 1, c: 0} and plane.moves == 0
        plane._cost.update({a: 100.0, b: 1.0, c: 100.0})
        plane.decode(b, "DFM", "DFM", {}, dfm, None)
        plane.gather()                   # [200, ~1]: a moves
        assert plane.owner == {a: 1, b: 1, c: 0}
        assert plane.moves == 1 and plane.tasks() == [1, 2]
        assert probe.counts().get("pool_moves") == 1
        assert plane._hold == {a: frame_plane.MOVE_HOLD}
        before = list(plane.decodes)
        t = plane.decode(a, "DFM", "DFM", {}, dfm, None)
        assert plane.gather()[t]
        assert plane.decodes == [before[0], before[1] + 1]
        assert plane.moves == 1
    finally:
        plane.close()
        probe.enable_spans(False)
        probe.reset_spans()
