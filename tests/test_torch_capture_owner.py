"""Capture ownership: within one cycle (a block from each of several
SDRs, one ``captures_dispatch``), a task is demodulated and its bits
decoded in one capture, its owner (``Station._owner``), on the fused
steady step, the split dispatch (a mesh of two shards) and the
sequential route (``use_mesh: false``).

On seeded generator blocks (``stationbench.generator``) of a small
station (8 channels of 48 kHz, 384 kHz captures, 2 s blocks) at the band
plan's centres of two and of three sources, with a sonde in each overlap
(one nearest the first capture that holds it, one nearest the second):

- every frame of the truth due in a cycle leaves ``captures_collect``
  exactly once and reaches the exporters exactly once, and no frame
  twice; each cycle's ``decode_rows`` is the number of tasks and its
  ``overlap_rows`` the number of overlap tasks; each task is owned by
  the nearest capture; the fused dispatch predicts only owned rows (its
  speculation serves every row it demodulated); a sonde near the
  captures' midpoint, which both nominate and confirm, goes to the
  nearer;
- a hop: the owner's capture leaves the cycle, the task passes to the
  other capture without losing a frame and is recorded there, and stays
  there when the first capture comes back;
- a cycle of one capture decodes what the JAX package's station
  decodes, with the same counts, and counts no overlap.

Against the JAX package, which demodulates an overlap task in every
capture that holds it: the port's telemetry, and its exporters', is the
JAX station's with each duplicate frame once and holds no duplicate;
the tasks are the same; ``detections`` is JAX's with the overlap sonde
counted once; ``frames_ok`` is JAX's less its duplicates.
"""

import collections

import jax
import numpy as np
import pytest
import torch

from radiosonde_auto_rx_tpu.parallel.mesh import make_mesh as jax_mesh
from radiosonde_auto_rx_tpu.station.station import Station as RefStation
from radiosonde_auto_rx_tpu_torch.parallel.mesh import make_mesh
from radiosonde_auto_rx_tpu_torch.station.bandplan import (
    BandPlan, partition_segments)
from radiosonde_auto_rx_tpu_torch.station.station import Station
from stationbench import generator as G, reference

torch.set_num_threads(1)
CPU = torch.device("cpu")
SEED = 3000000019
N_CYCLES = 6
WARM = 2                     # cycles in which the station finds its sondes

STATION = {"capture_rate": 384000, "num_channels": 8, "min_freq": 402.3,
           "max_freq": 402.95, "scan_every": 4, "max_peaks": 10,
           "snr_threshold": 10, "station_lat": 51.0, "station_lon": 7.0,
           "station_alt": 100.0, "frame_plane_workers": 0}


def _sonde(typ, serial, mhz, level, site):
    return {"type": typ, "serial": serial, "freq_mhz": mhz, "level": level,
            "site": site}


RS41 = _sonde("RS41", "T1357911", 402.40, 0.05, [51.9, 4.5, 2000.0, 8.0,
                                                 3.0, 5.0])
DFM = _sonde("DFM", "21054321", 402.85, 0.03, [52.3, 10.4, 6000.0, 6.0,
                                               4.0, 4.5])
# two sources: captures 402.2808-402.6648 and 402.5852-402.9692 MHz; the
# M20 in their overlap lies nearest the first
TWO = (dict(STATION, sdr_quantity=2), [
    RS41, DFM,
    _sonde("M20", "305-3-11234", 402.61, 0.02, [50.8, 4.4, 3000.0, 9.0,
                                                -3.0, 4.8])])
# three sources over 402.3-403.2 MHz (centres 402.4728, 402.75, 403.0272):
# an M20 in the first overlap nearest the second capture, an M10 in the
# second nearest the third, a DFM only the third holds
THREE = (dict(STATION, max_freq=403.2, sdr_quantity=3), [
    RS41,
    _sonde("M20", "305-3-11234", 402.64, 0.02, [50.8, 4.4, 3000.0, 9.0,
                                                -3.0, 4.8]),
    _sonde("M10", "A05-3-24660", 402.90, 0.03, [49.98, 6.1, 9000.0, 10.0,
                                                1.0, 5.0]),
    dict(DFM, freq_mhz=403.10)])
# the two sources with the M20 2 kHz nearer the second capture than the
# first: within ``quantization`` of their midpoint, a peak both captures
# nominate and confirm, which the nearer takes
MIDPOINT = (TWO[0], TWO[1][:2] + [dict(TWO[1][2], freq_mhz=402.627)])
ONE = (dict(STATION, max_freq=402.64), [RS41, TWO[1][2]])
SETS = {"two": TWO, "three": THREE, "midpoint": MIDPOINT, "one": ONE}


class _Collect:
    def __init__(self):
        self.items = []

    def add(self, t):
        self.items.append(t)

    def close(self):
        pass


def _key(t):
    return (t["type"], t.get("id"), t.get("frame"),
            round(t["lat"], 4), round(t["lon"], 4),
            round(t.get("freq_float", 0.0), 4))


class Sky:
    """One set's traffic and cycles: the band plan's centres, a sonde's
    captures, each cycle's float32 planes a capture, and the frames due
    in each block."""

    def __init__(self, name):
        station, emitters = SETS[name]
        parts = partition_segments(BandPlan(station),
                                   station.get("sdr_quantity", 1))
        assert all(len(p) == 1 for p in parts)
        self.centers = [p[0].center_hz for p in parts]
        cfg = {**station, "block_seconds": 2.0,
               "sources": [{"center_mhz": c / 1e6} for c in self.centers]}
        self.station = station
        self.traffic = G.Traffic({"emitters": emitters}, cfg, SEED,
                                 N_CYCLES + 1)
        gen = G.Generator(self.traffic, CPU)
        self.cycles = [list(gen.make(k).numpy().astype(np.float32) /
                            32768.0) for k in range(N_CYCLES + 1)]
        tr = self.traffic
        self.due = collections.defaultdict(set)    # block -> {(id, i)}
        for s, i, *_, blk, a, e in tr.frames_ending_in(0, N_CYCLES + 1):
            if reference.decodable(a, e, blk * tr.block, tr.block, tr.fs,
                                   s.rs):
                self.due[blk].add((s.id, i))
        self.overlap = [s for s in tr.sondes if len(s.sources) > 1]

    def nearest(self, s):
        return min(self.centers, key=lambda c: abs(s.f_hz - c))

    def frames(self, telems):
        """(id, frame) of each telemetry frame; a frame on no sonde's
        air fails."""
        out = []
        for t in telems:
            hit = reference.judge_telemetry(self.traffic, t)
            assert hit is not None, t
            out.append((hit[0].id, hit[1]))
        return out


@pytest.fixture(scope="module")
def skies():
    return {}


def _sky(skies, name):
    if name not in skies:
        skies[name] = Sky(name)
    return skies[name]


def _port(sky, route, col=None):
    conf = dict(sky.station)
    mesh = None
    if route == "sequential":
        conf["use_mesh"] = False
    elif route == "split":
        mesh = make_mesh(2, 1, devices=[CPU] * 2)
    return Station(conf, exporters=[col] if col else [],
                   center_freq_hz=sky.centers[0], device=CPU, mesh=mesh)


def _drive(st, sky, schedule=None):
    """Each cycle's telemetry and the increments of the station's
    counts; ``schedule`` (cycle -> capture indices) leaves sources out."""
    cycles = []
    for k in range(N_CYCLES):
        idx = range(len(sky.centers)) if schedule is None else schedule[k]
        before = dict(st.stats)
        out = st.process_captures([sky.cycles[k][i] for i in idx],
                                  [sky.centers[i] for i in idx])
        cycles.append((out, {n: st.stats.get(n, 0) - before.get(n, 0)
                             for n in ("decode_rows", "overlap_rows",
                                       "spec_predicted", "fused_channels",
                                       "detections", "frames_ok")}))
    return cycles


def _tasks(st):
    return sorted((v["type"], fz) for fz, v in st.active.items())


@pytest.mark.parametrize("route,sky_name", [
    (route, name) for name in ("two", "three")
    for route in ("fused", "split", "sequential")] + [
    ("fused", "midpoint"), ("split", "midpoint")])
def test_each_frame_leaves_once(skies, sky_name, route):
    sky = _sky(skies, sky_name)
    col = _Collect()
    st = _port(sky, route, col)
    cycles = _drive(st, sky)
    got = collections.Counter(f for out, _ in cycles
                              for f in sky.frames(out))
    assert got and max(got.values()) == 1
    assert collections.Counter(sky.frames(col.items)) == got
    for k in range(WARM, N_CYCLES):
        out, n = cycles[k]
        frames = sky.frames(out)
        assert sky.due[k] <= set(frames), (k, sky.due[k] - set(frames))
        assert n["decode_rows"] == len(sky.traffic.sondes) == len(st.active)
        assert n["overlap_rows"] == len(sky.overlap) > 0
        if route == "fused":
            assert n["spec_predicted"] == n["fused_channels"] == \
                len(st.active)
    assert len(st.active) == len(sky.traffic.sondes)
    if sky_name == "midpoint":
        assert cycles[0][1]["detections"] == len(sky.traffic.sondes) + 1
    for s in sky.traffic.sondes:
        (fz,) = [fz for fz in st.active if abs(fz - s.f_hz) < 5e3]
        assert st.active[fz]["center"] == sky.nearest(s)
    st.close()


@pytest.mark.parametrize("route", ["fused", "sequential"])
def test_a_hop_passes_the_task(skies, route):
    """The M20's owner (the first capture) is out of cycles 3-4: the
    second takes the task, decodes every due frame once, keeps it when
    the first comes back."""
    sky = _sky(skies, "two")
    (m20,) = sky.overlap
    c0, c1 = sky.centers
    assert sky.nearest(m20) == c0
    st = _port(sky, route)
    schedule = [(0, 1)] * 3 + [(1,)] * 2 + [(0, 1)] * (N_CYCLES - 5)
    seen = []
    orig = st.process_captures

    def watched(blocks, centers):
        out = orig(blocks, centers)
        fz = [f for f in st.active if abs(f - m20.f_hz) < 5e3]
        seen.append(st.active[fz[0]]["center"] if fz else None)
        return out
    st.process_captures = watched
    cycles = _drive(st, sky, schedule)
    assert seen == [c0] * 3 + [c1] * (N_CYCLES - 3)
    got = collections.Counter(f for out, _ in cycles
                              for f in sky.frames(out))
    assert max(got.values()) == 1
    for k in range(WARM, N_CYCLES):
        want = {f for f in sky.due[k] if f[0] == m20.id}
        assert want and want <= set(sky.frames(cycles[k][0])), k
    # the one-capture cycles count no overlap; both-capture cycles one
    assert [n["overlap_rows"] for _, n in cycles[3:]] == \
        [0, 0] + [1] * (N_CYCLES - 5)
    st.close()


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX station's cycles, by (set, route): the sequential route and
    the fused steady step on a one-device mesh."""
    return {}


def _jax(skies, jax_runs, sky_name, route):
    key = (sky_name, route)
    if key not in jax_runs:
        sky = _sky(skies, sky_name)
        conf = dict(sky.station)
        kw = {}
        if route == "sequential":
            conf["use_mesh"] = False
        else:
            kw["mesh"] = jax_mesh(n_ch=1, n_t=1, devices=jax.devices()[:1])
        col = _Collect()
        ref = RefStation(conf, exporters=[col],
                         center_freq_hz=sky.centers[0], **kw)
        jax_runs[key] = (_drive(ref, sky), col, _tasks(ref))
    return jax_runs[key]


@pytest.mark.parametrize("route", ["fused", "sequential"])
def test_overlap_against_jax(skies, jax_runs, route):
    sky = _sky(skies, "two")
    (m20,) = sky.overlap
    want, want_col, want_tasks = _jax(skies, jax_runs, "two", route)
    col = _Collect()
    st = _port(sky, route, col)
    got = _drive(st, sky)
    dup = 0
    for (out_r, n_r), (out_p, n_p) in zip(want, got):
        keys_r = collections.Counter(map(_key, out_r))
        # the JAX station decodes the M20 in both captures, the port once
        assert {sky.frames([t])[0][0] for t in out_r
                if keys_r[_key(t)] > 1} <= {m20.id}
        assert sorted(map(_key, out_p)) == sorted(keys_r)
        dup += sum(keys_r.values()) - len(keys_r)
        assert n_p["frames_ok"] == n_r["frames_ok"] - (
            sum(keys_r.values()) - len(keys_r))
    assert dup > 0
    assert sorted(map(_key, col.items)) == sorted(set(map(_key,
                                                          want_col.items)))
    assert len(col.items) == len(set(map(_key, col.items)))
    assert _tasks(st) == want_tasks
    # the fused JAX step confirms the M20 in both captures in its first
    # cycle; its sequential route absorbs the second sighting
    twice = 1 if route == "fused" else 0
    assert sum(n["detections"] for _, n in got) == \
        sum(n["detections"] for _, n in want) - twice
    st.close()


@pytest.mark.parametrize("route", ["fused", "sequential"])
def test_one_capture_cycle_equals_jax(skies, jax_runs, route):
    sky = _sky(skies, "one")
    assert len(sky.centers) == 1 and not sky.overlap
    want, want_col, want_tasks = _jax(skies, jax_runs, "one", route)
    col = _Collect()
    st = _port(sky, route, col)
    got = _drive(st, sky)
    for (out_r, n_r), (out_p, n_p) in zip(want, got):
        assert sorted(map(_key, out_p)) == sorted(map(_key, out_r))
        assert n_p["frames_ok"] == n_r["frames_ok"]
        assert n_p["detections"] == n_r["detections"]
        assert n_p["overlap_rows"] == 0
    assert sorted(map(_key, col.items)) == sorted(map(_key, want_col.items))
    assert _tasks(st) == want_tasks
    assert [n["decode_rows"] for _, n in got[WARM:]] == \
        [len(sky.traffic.sondes)] * (N_CYCLES - WARM)
    assert "overlap_rows" not in st.stats
    st.close()
