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


def tiny_root(tmp_path):
    """A checkout-like directory whose BENCHMARK.json holds one tiny
    cell with every metric."""
    (tmp_path / "stationbench" / "traffic").mkdir(parents=True)
    (tmp_path / "stationbench" / "configs").mkdir()
    (tmp_path / "stationbench" / "traffic" / "tiny.json").write_text(
        json.dumps(TINY_TRAFFIC))
    (tmp_path / "stationbench" / "configs" / "tiny.json").write_text(
        json.dumps(TINY_CONFIG))
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
