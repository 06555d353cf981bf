"""The benchmark's own tests, on the CPU (the card's are marked ``cuda``).

Run from the repository root:

    python3 -m pytest -q -p no:cacheprovider stationbench/tests
"""

import datetime
import gc
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stationbench import frames, generator as G, reference, run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

# a small station: 8 channels of 48 kHz, 2 s blocks, an RS41 and an M20
TINY_CONFIG = {
    "name": "tiny", "center_mhz": 402.5, "block_seconds": 2.0,
    "station": {"capture_rate": 384000, "num_channels": 8,
                "min_freq": 402.3, "max_freq": 402.7, "scan_every": 4,
                "max_peaks": 10, "snr_threshold": 10,
                "station_lat": 51.0, "station_lon": 7.0,
                "station_alt": 100.0, "frame_plane_workers": 0},
    "assumed": {}, "reduced": []}
TINY_TRAFFIC = {
    "name": "tiny", "warmup_blocks": 2, "max_realtime_x": 1000,
    "limits": {"chan_err": 1e-4, "psd_err": 1e-3, "wrong_tasks": 0,
               "wrong_frames": 0, "missed_pct": 10},
    "emitters": [
        {"type": "RS41", "serial": "T1357911", "channel": 2, "level": 0.05,
         "site": [51.9, 4.5, 2000.0, 8.0, 3.0, 5.0]},
        {"type": "M20", "serial": "305-3-11234", "channel": -2,
         "level": 0.02, "site": [50.8, 4.4, 3000.0, 9.0, -3.0, 4.8]}]}
# two such sources over 402.3-402.95 MHz, at the band plan's two centres
# (captures 402.2808-402.6648 and 402.5852-402.9692 MHz): an RS41 that
# only the first sees, an M20 in the overlap, a DFM only the second sees
TWO_CONFIG = {
    "name": "tiny2", "block_seconds": 2.0,
    "sources": [{"center_mhz": 402.4728}, {"center_mhz": 402.7772}],
    "station": dict(TINY_CONFIG["station"], max_freq=402.95,
                    sdr_quantity=2),
    "assumed": {}, "reduced": []}
TWO_TRAFFIC = dict(TINY_TRAFFIC, emitters=[
    {"type": "RS41", "serial": "T1357911", "freq_mhz": 402.4, "level": 0.05,
     "site": [51.9, 4.5, 2000.0, 8.0, 3.0, 5.0]},
    {"type": "M20", "serial": "305-3-11234", "freq_mhz": 402.62,
     "level": 0.02, "site": [50.8, 4.4, 3000.0, 9.0, -3.0, 4.8]},
    {"type": "DFM", "serial": "21054321", "freq_mhz": 402.85, "level": 0.03,
     "site": [52.3, 10.4, 6000.0, 6.0, 4.0, 4.5]}])
# the three-RTL-SDR UHF station: 400.05-406 MHz in three 2.4 MS/s
# captures, upstream's station.cfg.example [sdr] sdr_quantity = 3
TRIAL_CONFIG = {
    "name": "uhf400x3_rtl2m4", "block_seconds": 2.0,
    "sources": [{"center_mhz": 401.13}, {"center_mhz": 403.025},
                {"center_mhz": 404.92}],
    "station": {"capture_rate": 2400000, "num_channels": 50,
                "min_freq": 400.05, "max_freq": 406.0, "sdr_quantity": 3}}


def tiny_root(tmp_path, config=TINY_CONFIG, traffic=TINY_TRAFFIC):
    """A checkout-like directory whose BENCHMARK.json holds one tiny
    cell with every metric."""
    (tmp_path / "stationbench" / "traffic").mkdir(parents=True)
    (tmp_path / "stationbench" / "configs").mkdir()
    (tmp_path / "stationbench" / "traffic" / "tiny.json").write_text(
        json.dumps(traffic))
    (tmp_path / "stationbench" / "configs" / "tiny.json").write_text(
        json.dumps(config))
    bench = dict(BENCH)
    bench["configs"] = [{"name": "tiny", "source": "test",
                         "file": "stationbench/configs/tiny.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": "tiny.cell", "config": "tiny",
                           "traffic": "tiny", "chips": 1, "why": "test"}]
    bench["end_to_end"] = [{k: v for k, v in m.items() if k != "workloads"}
                           for m in BENCH["end_to_end"]]
    bench["per_layer"] = [{k: v for k, v in m.items() if k != "workloads"}
                          for m in BENCH["per_layer"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def run_tiny(tmp_path, capsys, trace=0):
    rc = run.main(["--workload", "tiny.cell", "--seed", "3000000019",
                   "--seconds", "1", "--trace", str(trace)],
                  device="cpu", root=tiny_root(tmp_path))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def run_two(tmp_path, config=TWO_CONFIG):
    """The two-source tiny cell's run: the result line, standard error,
    and the run and its window cycles as ``Run.check`` got them."""
    import contextlib
    import io
    seen = {}
    check = run.Run.check

    def keep(self, blocks):
        seen.update(run=self, blocks=blocks)
        return check(self, blocks)
    out, err = io.StringIO(), io.StringIO()
    run.Run.check = keep
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = run.main(["--workload", "tiny.cell", "--seed", "3000000019",
                           "--seconds", "1", "--trace", "0"], device="cpu",
                          root=tiny_root(tmp_path, config, TWO_TRAFFIC))
    finally:
        run.Run.check = check
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().strip().splitlines()[-1]), \
        err.getvalue(), seen


@pytest.fixture(scope="module")
def two_run(tmp_path_factory):
    """One sound run of the two-source cell, shared by the tests that
    read it."""
    return run_two(tmp_path_factory.mktemp("two"))


def missed(err: str) -> dict:
    """Sonde id -> (missed, due) from a run's standard error."""
    return {m[0]: (int(m[1]), int(m[2])) for m in re.findall(
        r"^sonde (\S+): missed (\d+) of (\d+) due", err, re.M)}


def test_every_name_is_found():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        cfg = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
        assert cfg["name"] == w["config"]
        tr = ROOT / "stationbench" / "traffic" / f"{w['traffic']}.json"
        assert json.loads(tr.read_text())["name"] == w["traffic"]
        cell = run.Cell(ROOT, w["name"])
        assert cell.end_to_end and cell.per_layer
    for m in BENCH["per_layer"]:
        mod = __import__(f"stationbench.metrics.{m['name']}",
                         fromlist=["read"])
        assert callable(mod.read)


def test_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


def test_generator_is_deterministic():
    cfg = {**TINY_CONFIG["station"], **TINY_CONFIG}

    def block(seed, k=1):
        tr = G.Traffic(TINY_TRAFFIC, cfg, seed, 3, t0_gps=1.4e9)
        g = G.Generator(tr, torch.device("cpu"))
        out = [g.make(i) for i in range(k + 1)]
        return out[k].numpy()

    a, b = block(2 ** 31 + 11), block(2 ** 31 + 11)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, block(2 ** 31 + 12))


def test_modulation_matches_the_port():
    from radiosonde_auto_rx_tpu_torch.demod.modulate import gfsk_mod
    cfg = {**TINY_CONFIG["station"], **TINY_CONFIG}
    tr = G.Traffic(TINY_TRAFFIC, cfg, 5, 2, t0_gps=1.4e9)
    for s in tr.sondes:
        fs = 96000
        m = G.Modulator(s, fs, torch.device("cpu"))
        n = fs
        got = torch.cat([m.block(0, n // 2), m.block(n // 2, n // 2)])
        want = gfsk_mod(s.syms[:n * s.rs // fs + 64], fs, s.rs, 2, s.f_off,
                        s.spacing, bt=s.bt)[:n] * s.level
        tail = 4000          # the port's burst ends: its Gaussian sees 0
        assert np.max(np.abs(got.numpy()[:n - tail] - want[:n - tail])) < \
            1e-6 * s.level


def test_frames_decode_with_the_port():
    from radiosonde_auto_rx_tpu_torch.models import get_model
    from radiosonde_auto_rx_tpu_torch.models import rs41
    t = 1_400_000_000.0
    wk, sow = frames.gps_week_tow(t)
    want = rs41.frame_to_bits(rs41.encode_frame(
        frame_nb=905, sonde_id="T1357911", week=wk, tow_ms=int(sow * 1000),
        lat=51.2, lon=7.1, alt=1234.0, vH=5.0, vD=90.0, vV=5.0,
        calibytes=rs41.make_calibytes(), calfr=5))
    assert np.array_equal(frames.rs41_frame_bits(
        "T1357911", 5, t, 51.2, 7.1, 1234.0), want)
    for typ, serial in (("DFM", "21054321"), ("M10", "A05-3-24660"),
                        ("M20", "305-3-11234"), ("MTS01", "T7654321")):
        bits = np.concatenate([frames.frame_bits(
            typ, serial, i, t + i, 51.2 + 1e-4 * i, 7.1, 1234.0 + 5 * i)
            for i in range(8)])
        out = get_model(typ)().decode_bits(bits)
        ok = [o for o in out if o["id"] == frames.expected_id(typ, serial)]
        assert len(ok) >= 5, (typ, out)
        check_times(typ, ok, t)


def test_lms6_frames_decode_in_their_slots():
    from radiosonde_auto_rx_tpu_torch.models import get_model
    t = 1_400_000_000.0
    rs = frames.TYPES["MK2LMS"][1]
    bits = []
    for i in range(8):
        b = frames.frame_bits("MK2LMS", "7654321", i, t + i, 51.2 + 1e-4 * i,
                              7.1, 1234.0 + 5 * i)
        bits += [b, frames.SLOT_FILL["MK2LMS"](rs - len(b))]
    out = get_model("MK2LMS")().decode_bits(np.concatenate(bits))
    ok = [o for o in out if o["id"] == "LMS6-7654321"]
    assert len(ok) >= 7, out
    # the frames state the time of day; the station adds the date
    day = frames.gps_datetime(t).date().isoformat()
    for o in ok:
        o["datetime_dt"] = datetime.datetime.fromisoformat(
            f"{day}T{o['datetime'].replace('Z', '+00:00')}")
    check_times("MK2LMS", ok, t)


def check_times(typ, decoded, t):
    """Each decoded frame names the frame of its time, at its place."""
    s = type("S", (), {"type": typ, "truth": [
        (t + i, 51.2 + 1e-4 * i, 7.1, 1234.0 + 5 * i, 0, 0)
        for i in range(8)]})()
    for o in decoded:
        i = reference.frame_of(s, o)
        assert i is not None and abs(o["lat"] - s.truth[i][1]) < 1e-6


def test_reference_channelizer_and_psd_match_the_port():
    from radiosonde_auto_rx_tpu_torch.detect.psd import _welch
    from radiosonde_auto_rx_tpu_torch.ops.channelizer import channelize
    rng = np.random.default_rng(0)
    cs16 = rng.integers(-3000, 3000, (2, 8 * 9000)).astype(np.int16)
    x = reference.planes(cs16)
    got = channelize(torch.from_numpy(cs16.astype(np.float32) / 32768.0),
                     8, "cpu").numpy()
    assert reference.chan_err(got, reference.channelize(x, 8),
                              range(8)) < 1e-5
    psd = _welch(torch.from_numpy(cs16.astype(np.float32)[None] / 32768.0),
                 256, 1024)[0].numpy()
    assert reference.psd_err(psd, reference.welch(x, 256, 1024)) < 1e-4


def test_tiny_run_prints_the_contract_line(tmp_path, capsys):
    out = run_tiny(tmp_path, capsys)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"setup_s", "realtime_x",
                                   "telemetry_ms_p95", "block_ms_p95"}
    assert out["attempted"] > 0


def test_tiny_traced_run_reads_host_layers(tmp_path, capsys):
    out = run_tiny(tmp_path, capsys, trace=1)
    # the device metrics read nothing without a card's trace
    assert set(out["metrics"]) == {"collect_ms", "dispatch_ms"}


def test_a_wrong_answer_fails(tmp_path, capsys, monkeypatch):
    from radiosonde_auto_rx_tpu_torch.station.station import Station
    orig = Station.captures_collect

    def altered(self, pending):
        out = orig(self, pending)
        for t in out:
            t["lat"] += 1e-3
        return out
    monkeypatch.setattr(Station, "captures_collect", altered)
    out = run_tiny(tmp_path, capsys)
    assert out["correct"] is False
    assert out["checks"]["wrong_frames"]["value"] > 0


def test_half_the_telemetry_left_out_fails(tmp_path, capsys, monkeypatch):
    import itertools
    from radiosonde_auto_rx_tpu_torch.station.station import Station
    orig = Station.captures_collect
    turn = itertools.cycle((True, False))

    def half(self, pending):
        return [t for t in orig(self, pending) if next(turn)]
    monkeypatch.setattr(Station, "captures_collect", half)
    out = run_tiny(tmp_path, capsys)
    assert out["correct"] is False
    assert out["checks"]["missed_pct"]["value"] > \
        TINY_TRAFFIC["limits"]["missed_pct"]


def test_a_sonde_left_out_fails(tmp_path, capsys, monkeypatch):
    from radiosonde_auto_rx_tpu_torch.station.station import Station
    orig = Station.captures_collect

    def without_m20(self, pending):
        return [t for t in orig(self, pending)
                if not t["id"].startswith("M20")]
    monkeypatch.setattr(Station, "captures_collect", without_m20)
    out = run_tiny(tmp_path, capsys)
    assert out["correct"] is False
    assert out["checks"]["missed_pct"]["value"] == 100.0


def test_due_frames_lie_inside_one_block():
    fs, block = 48000, 96000
    sym = fs // 4800
    lead = reference.LEAD_SYMBOLS * sym
    tail = (2 * reference.demod_nsym(4800) + 2) * sym
    assert reference.decodable(lead, block - tail, 0, block, fs, 4800)
    assert not reference.decodable(lead - 1, block - tail, 0, block, fs,
                                   4800)
    assert not reference.decodable(lead, block - tail + 1, 0, block, fs,
                                   4800)
    assert reference.decodable(block + lead, 2 * block - tail, block, block,
                               fs, 4800)


def test_frames_grow_past_the_encoded_blocks():
    cfg = {**TINY_CONFIG["station"], **TINY_CONFIG}
    tr = G.Traffic(TINY_TRAFFIC, cfg, 7, 1, t0_gps=1.4e9)
    g = G.Generator(tr, torch.device("cpu"))
    n0 = [len(s.truth) for s in tr.sondes]
    for k in range(4):
        g.make(k)
    for s, n in zip(tr.sondes, n0):
        assert len(s.truth) > n
        # back to back, one GPS second a frame
        assert all(a[5] == b[4] and b[0] - a[0] == 1.0
                   for a, b in zip(s.truth, s.truth[1:]))


def test_half_the_rows_left_out_fails(tmp_path, capsys, monkeypatch):
    import radiosonde_auto_rx_tpu_torch.parallel.station_step as ss
    orig = ss._channelize

    def half(x, h, n):
        y = orig(x, h, n)
        y[..., : n // 2, :, :] = 0
        return y
    monkeypatch.setattr(ss, "_channelize", half)
    out = run_tiny(tmp_path, capsys)
    assert out["correct"] is False
    assert out["checks"]["chan_err"]["value"] > 0.5


@pytest.mark.parametrize("route", ["fused", "sequential"])
def test_two_sources_print_the_contract_line(route, two_run, tmp_path):
    """Each cycle takes a block from each source through one dispatch;
    each source's rows and PSD are judged against its own block, on the
    fused steady step and on the sequential route."""
    out, err, seen = two_run if route == "fused" else run_two(
        tmp_path, dict(TWO_CONFIG, station=dict(TWO_CONFIG["station"],
                                                use_mesh=False)))
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"setup_s", "realtime_x",
                                   "telemetry_ms_p95", "block_ms_p95"}
    r = seen["run"]
    assert len(r.chan_keep) == 2 * run.CHAN_SAMPLES
    assert [len(c) for c in r.psd_keep] == [2] * run.PSD_SAMPLES
    # a scanned cycle counts both captures' Welch windows
    scanned = [b["scanned"] for b in seen["blocks"]]
    assert 2 in scanned and set(scanned) <= {0, 2}, scanned
    assert sorted(t for t, _ in seen["blocks"][-1]["tasks"]) == \
        ["DFM", "M20", "RS41"]


def test_an_overlap_sonde_is_in_both_captures_and_counts_once(two_run):
    cfg = {**TWO_CONFIG["station"], **TWO_CONFIG}
    tr = G.Traffic(TWO_TRAFFIC, cfg, 3, 1, t0_gps=1.4e9)
    assert [s.sources for s in tr.sondes] == [[0], [0, 1], [1]]
    cyc = G.Generator(tr, torch.device("cpu")).make(0).numpy()
    fs = tr.fs
    for i, c in enumerate(tr.centers):
        x = reference.planes(cyc[i])
        spec = np.abs(np.fft.fftshift(np.fft.fft(x))) ** 2
        f = np.fft.fftshift(np.fft.fftfreq(len(x), 1 / fs))
        floor = np.median(spec)
        for s in tr.sondes:
            near = np.abs(f - (s.f_hz - c)) < 5e3
            if abs(s.f_hz - c) <= fs / 2:
                assert spec[near].mean() > 100 * floor, (i, s.id)
            else:
                assert not near.any()
    # the station decodes the overlap sonde's frames from both captures;
    # each due frame counts once, and a second copy is neither a miss nor
    # a wrong frame
    out, err, seen = two_run
    blocks = seen["blocks"]
    copies = {}
    for b in blocks:
        for t in b["telem"]:
            hit = reference.judge_telemetry(seen["run"].traffic, t)
            copies[hit[0].id, hit[1]] = copies.get((hit[0].id, hit[1]), 0) + 1
    m20 = tr.sondes[1].id
    assert max(n for (sid, _), n in copies.items() if sid == m20) == 2
    assert max(n for (sid, _), n in copies.items() if sid != m20) == 1
    r = seen["run"]
    T = r.traffic.block
    due = {(s.id, i) for s, i, *_, blk, a, e in r.traffic.frames_ending_in(
        blocks[0]["k"], blocks[-1]["k"] + 1)
        if reference.decodable(a, e, blk * T, T, r.traffic.fs, s.rs)}
    assert out["attempted"] == len(due)
    assert out["failed"] == 0
    assert missed(err)[m20] == (0, sum(1 for sid, _ in due if sid == m20))


def test_one_sources_telemetry_left_out_fails(tmp_path, monkeypatch):
    """The telemetry of the second capture lost: the sonde that only it
    sees misses every frame; the overlap sonde still counts, from the
    first."""
    from radiosonde_auto_rx_tpu_torch.station.station import Station
    orig = Station.captures_collect
    c0 = TWO_CONFIG["sources"][0]["center_mhz"]
    half = TWO_CONFIG["station"]["capture_rate"] / 2e6

    def first_only(self, pending):
        return [t for t in orig(self, pending)
                if abs(t["freq_float"] - c0) <= half]
    monkeypatch.setattr(Station, "captures_collect", first_only)
    out, err, _ = run_two(tmp_path)
    assert out["correct"] is False
    assert out["checks"]["missed_pct"]["value"] == 100.0
    got = missed(err)
    assert got["DFM-21054321"][0] == got["DFM-21054321"][1] > 0
    assert got["T1357911"][0] == 0 and got["M20-305-3-11234"][0] == 0


def test_one_sources_rows_altered_fails(tmp_path, monkeypatch):
    import radiosonde_auto_rx_tpu_torch.parallel.station_step as ss
    orig = ss._channelize

    def second_scaled(x, h, n):
        y = orig(x, h, n)                   # [B, N, 2, M]
        if y.shape[0] > 1:
            y[1] *= 1.5
        return y
    monkeypatch.setattr(ss, "_channelize", second_scaled)
    out, _, seen = run_two(tmp_path)
    assert out["correct"] is False
    assert out["checks"]["chan_err"]["value"] > 0.3


@pytest.mark.parametrize("cfg", [TWO_CONFIG, TRIAL_CONFIG] + [
    c for c in (json.loads(f.read_text()) for f in sorted(
        (ROOT / "stationbench" / "configs").glob("*.json")))
    if "sources" in c], ids=lambda c: c["name"])
def test_source_centres_are_the_band_plans(cfg):
    """The centres written in a configuration of several sources are the
    program's own partition of its band plan, a segment a source."""
    from radiosonde_auto_rx_tpu_torch.station.bandplan import (
        BandPlan, partition_segments)
    parts = partition_segments(BandPlan(cfg["station"]), len(cfg["sources"]))
    assert [[round(g.center_hz) for g in part] for part in parts] == \
        [[round(src["center_mhz"] * 1e6)] for src in cfg["sources"]]
    run.check_sources(cfg, G.source_centers(cfg))


@pytest.mark.parametrize("change", [
    {"sdr_quantity": 2},                      # three sources, two SDRs
    {"min_freq": 399.0}],                     # a fourth segment: a hop
    ids=["sdr_quantity", "hop"])
def test_sources_the_station_would_not_run_are_refused(change):
    cfg = dict(TRIAL_CONFIG, station=dict(TRIAL_CONFIG["station"], **change))
    with pytest.raises(SystemExit):
        run.check_sources(cfg, G.source_centers(cfg))


def test_an_emitter_no_capture_carries_is_refused():
    cfg = {**TWO_CONFIG["station"], **TWO_CONFIG}
    tr = dict(TWO_TRAFFIC, emitters=TWO_TRAFFIC["emitters"] + [dict(
        TWO_TRAFFIC["emitters"][0], serial="T2468024", freq_mhz=403.2)])
    with pytest.raises(ValueError, match="no source's capture"):
        G.Traffic(tr, cfg, 1, 1, t0_gps=1.4e9)


def test_wrong_tasks_on_absolute_frequencies():
    """A task is wrong when no sonde of its type lies near its absolute
    frequency; with one source that is the rule on offsets from its
    centre."""
    cfg = {**TWO_CONFIG["station"], **TWO_CONFIG}
    tr = G.Traffic(TWO_TRAFFIC, cfg, 1, 1, t0_gps=1.4e9)
    rs41, m20, dfm = tr.sondes
    ok = [("RS41", rs41.f_hz + 4900.0), ("M20", m20.f_hz - 3000.0),
          ("DFM", dfm.f_hz)]
    bad = [("RS41", rs41.f_hz + 5100.0), ("RS41", dfm.f_hz),
           ("M10", m20.f_hz)]
    assert reference.wrong_tasks(tr, ok + bad) == bad
    cfg = {**TINY_CONFIG["station"], **TINY_CONFIG}
    tr = G.Traffic(TINY_TRAFFIC, cfg, 1, 1, t0_gps=1.4e9)
    c = tr.centers[0]
    rel = [(s.type, s.f_off + d) for s in tr.sondes
           for d in (-6e3, -5e3, -4999.0, 0.0, 4999.0, 5e3, 6e3)] + \
        [("DFM", tr.sondes[0].f_off)]
    old = [(t, f) for t, f in rel if not any(
        t == s.type and abs(f - s.f_off) < max(reference.TASK_TOL_HZ,
                                               s.spacing)
        for s in tr.sondes)]
    assert old
    assert reference.wrong_tasks(tr, [(t, c + f) for t, f in rel]) == \
        [(t, c + f) for t, f in old]


def test_psd_roofline_counts_every_scanned_capture():
    from stationbench.metrics import psd_roofline_pct

    class Trace:
        def kernel_s(self, names):
            return 1e-3
    r = type("R", (), {"traffic": type("T", (), {"block": 4_800_000})()})()
    one = psd_roofline_pct.read(r, [{"scanned": 1}, {"scanned": 0}], Trace())
    three = psd_roofline_pct.read(r, [{"scanned": 3}, {"scanned": 0}],
                                  Trace())
    assert three == pytest.approx(3 * one)
    nbytes = (4_800_000 // 8192 * 2048 * 4 + 2048 * 4)
    assert one == pytest.approx(100 * nbytes / 1e-3 / 3.35e12)


# the generator's inputs to the committed cells at seed 0, GPS time
# pinned: SHA-256 of every sonde's truth and symbols, and of cycles 0-2,
# as the generator of one source made them before it took several
GOLDEN = {
    "uhf400.busy10": (
        "db376577c00978bcf85850bdd0ce1ab73b5eb9fc937422c59007a668ed52d2e7",
        ["6f861c02544ed3464a42f311847c11c3fb9e78ee029400e280d08795529576de",
         "a667c1392c7dbf56ac114ea85f10816ffe0035e73d566e038d843f75b81474c0",
         "b8d7b6d7d8b4a8e5bc8cb04ecec262fc65d751cbfa2f476a9f2b46d34e435f39"]),
    "lband1680.rs92_lms6": (
        "9b1277f133d2c974b5cfc4c1e05147de6d7924c1837856dd77bc1053b6cd92ca",
        ["47f325a693ece0597d2beea3c105d018cea2a5bf4832a8b706ea3269ac93d9e2",
         "90f3a30b313c0acf034e8abaa3b4da021bb6b9239234db52ddc0e52f1c0997ed",
         "708570eb71aa44fbcc4fc2e87d64e9c1c2826b2ba48b3be13a0c80caef15c732"]),
}


@pytest.mark.parametrize("cell", sorted(GOLDEN))
def test_one_source_inputs_are_unchanged(cell):
    import hashlib
    w = {x["name"]: x for x in BENCH["workloads"]}[cell]
    configs = {c["name"]: c for c in BENCH["configs"]}
    cfg = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    spec = json.loads((ROOT / "stationbench" / "traffic" /
                       f"{w['traffic']}.json").read_text())
    tr = G.Traffic(spec, {**cfg["station"], **cfg}, 0, 3,
                   t0_gps=1_400_000_000.0)
    h = hashlib.sha256()
    for s in tr.sondes:
        h.update(repr((s.id, s.f_off, s.level, s.rs, s.spacing, s.bt,
                       s.truth)).encode())
        h.update(np.ascontiguousarray(s.syms).tobytes())
    g = G.Generator(tr, torch.device("cpu"))
    blocks = []
    for k in range(3):
        cyc = g.make(k).numpy()
        assert cyc.shape == (1, 2, tr.block)
        blocks.append(hashlib.sha256(cyc[0].tobytes()).hexdigest())
    assert (h.hexdigest(), blocks) == GOLDEN[cell]


FORBID = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in {names}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
"""


def test_imports_no_jax():
    code = FORBID.format(names="{'jax', 'jaxlib', 'flax', "
                               "'radiosonde_auto_rx_tpu'}") + """
import stationbench.run, stationbench.generator, stationbench.trace
import stationbench.reference, stationbench.metrics
import radiosonde_auto_rx_tpu_torch.station.station
"""
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


def test_reference_imports_nothing_of_the_program():
    code = """
import sys
import stationbench.reference, stationbench.frames, stationbench.generator
bad = {m.split('.')[0] for m in sys.modules} & {
    'jax', 'radiosonde_auto_rx_tpu', 'radiosonde_auto_rx_tpu_torch'}
assert not bad, bad
"""
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


def test_stop_children_ends_what_the_run_started():
    """A child process and the resource tracker that a spawn queue starts
    are ended and waited for; what ran before is left alone."""
    import multiprocessing as mp
    import os
    old = subprocess.Popen([sys.executable, "-c",
                            "import time; time.sleep(60)"])
    try:
        before = run.child_pids(os.getpid())
        had = run.tracker_pid() is not None
        new = subprocess.Popen([sys.executable, "-c",
                                "import time; time.sleep(60)"])
        q = mp.get_context("spawn").Queue()
        del q
        gc.collect()
        run.stop_children(before, had, grace=2.0)
        assert new.poll() is not None
        assert old.poll() is None
        assert run.child_pids(os.getpid()) == {old.pid}
        if not had:
            assert run.tracker_pid() is None
    finally:
        old.kill()
        old.wait()


def test_a_run_with_the_pool_leaves_no_process(tmp_path):
    """The tiny cell with the frame-plane pool (two spawned workers) run
    in a process of its own: once ``main`` returns, the process has no
    child left."""
    root = tiny_root(tmp_path)
    conf = dict(TINY_CONFIG, station=dict(TINY_CONFIG["station"],
                                          frame_plane_workers=2))
    (root / "stationbench" / "configs" / "tiny.json").write_text(
        json.dumps(conf))
    code = f"""
import os, sys
from stationbench import run
rc = run.main(["--workload", "tiny.cell", "--seed", "3000000019",
               "--seconds", "1", "--trace", "0"], device="cpu",
              root={str(root)!r})
print("LEFT", sorted(run.child_pids(os.getpid())), rc)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-1] == "LEFT [] 0", lines[-1]
    assert "Traceback" not in res.stderr, res.stderr[-2000:]
    assert json.loads(lines[-2])["correct"] is True


@pytest.mark.cuda
def test_lower_precision_control_fails_on_the_card(tmp_path):
    """The control: the program's own bfloat16 forms of the channelizer
    and detector (``RSX_CHANNELIZER_DTYPE``, ``RSX_DETECT_DTYPE``) at each
    cell's size, three seeds; ``correct`` must come out false."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    env = dict(__import__("os").environ, RSX_CHANNELIZER_DTYPE="bfloat16",
               RSX_DETECT_DTYPE="bfloat16")
    for w in BENCH["workloads"]:
        for seed in (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303):
            res = subprocess.run(
                [sys.executable, "-m", "stationbench.run", "--workload",
                 w["name"], "--seed", str(seed), "--seconds", "5",
                 "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
                text=True, timeout=600)
            assert res.returncode == 0, res.stderr[-2000:]
            out = json.loads(res.stdout.strip().splitlines()[-1])
            print(w["name"], seed, out["checks"])
            assert out["correct"] is False
