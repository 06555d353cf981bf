"""The port's station command line (``python -m radiosonde_auto_rx_tpu_torch``,
``station/main.py``) on the CPU (``--device cpu``).

The cases of ``tests/test_cli.py`` on the port — argument defaults, the
config-gated exporters, a missing source (``EXIT_CONFIG``), a
single-frequency replay, a scan-mode replay with the web server, the web
endpoints and ``--emulate`` — and a missing card: without a CUDA device
and without ``--device cpu`` the station exits ``EXIT_ERROR``.

Then the port against the JAX package's ``main`` on the same cs16
captures (an RS41 with a fixed GPS time, ``RS41_TS``): a single-frequency
replay (``-f``/``-m``) and a scan-mode replay in which the station finds
the sonde itself, both with the frame-plane pool at the reference's
default (``frame_plane_workers`` -1).  Both write the same per-sonde log
rows; only the log file's name carries the wall clock.  The scan-mode
run checks that its frame decodes went out to pool workers.
"""

import datetime
import json
import urllib.request

import numpy as np
import pytest
import torch

from radiosonde_auto_rx_tpu.station import main as ref_cli
from radiosonde_auto_rx_tpu.station.config import \
    default_config as ref_default_config
from radiosonde_auto_rx_tpu_torch.station import frame_plane
from radiosonde_auto_rx_tpu_torch.station import main as cli
from radiosonde_auto_rx_tpu_torch.station.config import default_config

torch.set_num_threads(1)
RS41_TS = 1_755_600_000       # 2025-08-19, the frames' GPS time
CPU = ["--device", "cpu"]


def test_parse_args_defaults():
    args = cli.parse_args([])
    assert args.config is None and args.frequency is None
    assert args.timeout == 0 and not args.verbose
    assert args.device == "cuda" and args.block_seconds == 2.0
    args = cli.parse_args(["-f", "402.5", "-m", "RS41", "-t", "10", "-v",
                           "--device", "cpu"])
    assert args.frequency == 402.5 and args.sonde_type == "RS41"
    assert args.timeout == 10 and args.verbose and args.device == "cpu"


def test_build_exporters_config_gated(tmp_path):
    cfg = default_config()
    cfg["log_directory"] = str(tmp_path)
    cfg["sondehub_enabled"] = False
    exps = cli.build_exporters(cfg)
    assert [type(e).__name__ for e in exps] == ["TelemetryLogger"]
    for e in exps:
        e.close()
    cfg["sondehub_enabled"] = True
    cfg["ozi_enabled"] = True
    exps = cli.build_exporters(cfg)
    names = [type(e).__name__ for e in exps]
    assert "SondehubUploader" in names and "OziUploader" in names
    for e in exps:
        e.close()


def test_missing_source_exits_config():
    assert cli.main(["--no-web"] + CPU) == cli.EXIT_CONFIG


def rs41_capture(path, fs, freq_off_hz, n_frames=3, seed=11):
    """A cs16 capture at ``fs`` with an RS41 (serial C2468101, frames
    700.., GPS time ``RS41_TS``) at ``freq_off_hz``; returns seconds."""
    from radiosonde_auto_rx_tpu_torch.demod.modulate import gfsk_mod
    from radiosonde_auto_rx_tpu_torch.models.rs41 import (
        encode_frame, frame_to_bits, make_calibytes)
    rng = np.random.default_rng(seed)
    now = datetime.datetime.fromtimestamp(RS41_TS, datetime.timezone.utc)
    week = (now - datetime.datetime(1980, 1, 6,
                                    tzinfo=datetime.timezone.utc)).days // 7
    dow = (now.weekday() + 1) % 7
    tow_ms = ((dow * 24 + now.hour) * 3600 + now.minute * 60 +
              now.second) * 1000
    cal = make_calibytes()
    tx = np.concatenate(
        [rng.integers(0, 2, 400)] +
        [frame_to_bits(encode_frame(
            frame_nb=700 + i, sonde_id="C2468101", week=week,
            tow_ms=tow_ms + i * 1000, lat=51.5, lon=-0.12, alt=8000.0,
            calibytes=cal, calfr=i)) for i in range(n_frames)] +
        [rng.integers(0, 2, 400)])
    wide = gfsk_mod(tx, fs, 4800, 2, freq_off_hz, 4800, bt=0.5)
    wide += (rng.standard_normal(len(wide)) +
             1j * rng.standard_normal(len(wide))).astype(np.complex64) * 0.002
    w = np.empty(2 * len(wide), np.int16)
    w[0::2] = np.clip(wide.real * 16000, -32768, 32767).astype(np.int16)
    w[1::2] = np.clip(wide.imag * 16000, -32768, 32767).astype(np.int16)
    path.write_bytes(w.tobytes())
    return len(wide) / fs


def _rows(logdir):
    """{file's serial/type/freq part: its lines} of the per-sonde logs
    (the file name starts with the wall-clock time it was opened at)."""
    out = {}
    for p in sorted(logdir.glob("*_sonde.log")):
        out[p.name.split("_", 1)[1]] = p.read_text().splitlines()
    return out


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The single-frequency replay through both packages' ``main``."""
    d = tmp_path_factory.mktemp("single")
    cap = d / "cap.cs16"
    off = 48000 * 5                # channel 5 of 50 at 2.4 MHz
    secs = rs41_capture(cap, 2_400_000, off)
    # the frames' GPS time is fixed: open the time filter for it
    cfg = d / "station.cfg"
    cfg.write_text("[filtering]\nsonde_time_threshold = 1000000\n")
    argv = ["-c", str(cfg), "--replay", str(cap), "--no-web",
            "--block-seconds", str(secs),
            "-f", str((402.5e6 + off) / 1e6), "-m", "RS41"]
    rc = {"port": cli.main(argv + CPU + ["--log-dir", str(d / "port")]),
          "ref": ref_cli.main(argv + ["--log-dir", str(d / "ref")])}
    return rc, _rows(d / "port"), _rows(d / "ref")


def test_replay_single_frequency_decode(single):
    """Full CLI run: cs16 replay file -> telemetry into the log exporter."""
    rc, port, _ = single
    assert rc["port"] == cli.EXIT_OK
    assert list(port) == ["C2468101_RS41_402.740_sonde.log"]
    lines = port["C2468101_RS41_402.740_sonde.log"]
    assert len(lines) == 4 and all("C2468101" in ln for ln in lines[1:])


def test_single_frequency_rows_match_reference(single):
    rc, port, ref = single
    assert rc["ref"] == ref_cli.EXIT_OK
    assert port == ref


def test_replay_scan_mode_web(tmp_path):
    """Scan mode over noise: runs, serves the web API, exits cleanly."""
    cap = tmp_path / "noise.cs16"
    rng = np.random.default_rng(3)
    raw = (rng.standard_normal(2 * 240_000) * 300).astype(np.int16)
    cap.write_bytes(raw.tobytes())
    args = cli.parse_args(["--replay", str(cap), "--block-seconds", "0.1",
                           "--log-dir", str(tmp_path / "log")] + CPU)
    cfg = default_config()
    cfg["sondehub_enabled"] = False
    cfg["web_port"] = 0
    cfg["web_host"] = "127.0.0.1"
    assert cli.run_station(args, cfg) == cli.EXIT_OK


def test_web_server_endpoints():
    from radiosonde_auto_rx_tpu_torch.web.server import (WebExporter,
                                                         WebServer)
    web = WebServer(station=None, web_exporter=WebExporter(),
                    config={"web_password": "x"}, host="127.0.0.1", port=0)
    web.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{web.port}/get_version") as r:
            v = json.loads(r.read())
        assert "version" in v
    finally:
        web.close()


def test_emulate_mode(tmp_path):
    """--emulate replays a per-sonde log through the exporter chain."""
    from radiosonde_auto_rx_tpu_torch.exporters.logfile import (
        LOG_HEADER, telemetry_to_log_line)
    lines = [LOG_HEADER]
    for i in range(6):
        lines.append(telemetry_to_log_line(dict(
            datetime="2026-08-17T01:02:%02dZ" % i, id="E1239876", frame=i,
            lat=10.0, lon=20.0 + i * 1e-4, alt=5000.0 + 10 * i, vel_v=5.0,
            vel_h=10.0, heading=90.0, temp=-20.0, humidity=50.0,
            pressure=-1, type="RS41", freq_float=402.5, snr=15.0,
            f_error=0, sats=9, batt=2.9)))
    src = tmp_path / "20260817-010203_E1239876_RS41_402.500_sonde.log"
    src.write_text("".join(ln if ln.endswith("\n") else ln + "\n"
                           for ln in lines))
    logdir = tmp_path / "out"
    rc = cli.main(["--emulate", str(src), "--no-web",
                   "--log-dir", str(logdir)])
    assert rc == cli.EXIT_OK
    out = list(logdir.glob("*_sonde.log"))
    assert out and "E1239876" in out[0].read_text()


def test_missing_card_exits_error(tmp_path, monkeypatch, caplog):
    """Without a CUDA device the default ``--device cuda`` stops before
    building a station, names the missing card and exits EXIT_ERROR."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cap = tmp_path / "cap.cs16"
    cap.write_bytes(b"\0" * 4000)
    assert cli.main(["--replay", str(cap), "--no-web"]) == cli.EXIT_ERROR
    assert "no CUDA device" in caplog.text


# the scan-mode replay's geometry: 8 channels of 48 kHz, the RS41 on
# channel 2, 2 s blocks (the default), micro-batch 1 in both packages
SCAN_FS, SCAN_CH = 384_000, 2


def _scan_config(factory, logdir):
    cfg = factory()
    cfg.update(capture_rate=SCAN_FS, num_channels=8, sondehub_enabled=False,
               station_lat=0.0, station_lon=0.0,
               sonde_time_threshold=1e9, mesh_microbatch=1,
               log_directory=str(logdir))
    assert cfg["frame_plane_workers"] == -1
    return cfg


def test_scan_mode_rows_match_reference(tmp_path, monkeypatch):
    """A task-less station replays a capture, finds the RS41 itself and
    writes its rows, pooled, as the JAX package's ``run_station`` does."""
    cap = tmp_path / "cap.cs16"
    rs41_capture(cap, SCAN_FS, SCAN_CH * 48000, n_frames=6, seed=5)
    pooled = []
    gather = frame_plane.FramePlane.gather

    def counting_gather(self, *a, **kw):
        pooled.append((self.workers, self._pending))
        return gather(self, *a, **kw)

    monkeypatch.setattr(frame_plane.FramePlane, "gather", counting_gather)
    argv = ["--replay", str(cap), "--no-web"]
    rc = cli.run_station(cli.parse_args(argv + CPU),
                         _scan_config(default_config, tmp_path / "port"))
    rc_ref = ref_cli.run_station(
        ref_cli.parse_args(argv),
        _scan_config(ref_default_config, tmp_path / "ref"))
    assert rc == rc_ref == cli.EXIT_OK
    port, ref = _rows(tmp_path / "port"), _rows(tmp_path / "ref")
    assert list(port) == ["C2468101_RS41_402.596_sonde.log"]
    assert len(port["C2468101_RS41_402.596_sonde.log"]) > 3
    assert port == ref
    # the decodes went out to worker processes
    assert pooled and all(w > 0 for w, _ in pooled)
    assert sum(n for _, n in pooled) > 0
