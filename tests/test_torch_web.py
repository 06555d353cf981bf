"""The port's web server, log-file analytics, UDP listener and replay
(``web/*``, ``station/udplistener.py``, ``station/emulation.py``: copies
of the JAX package's): the cases of ``tests/test_web.py``, then the
same telemetry through both packages' log exporter and log-file
analytics.  The test telemetry carries a fixed time (``T0``)."""

import datetime
import json
import socket
import time
import urllib.request

import pytest

from radiosonde_auto_rx_tpu_torch.exporters.logfile import TelemetryLogger
from radiosonde_auto_rx_tpu_torch.station.udplistener import UDPListener
from radiosonde_auto_rx_tpu_torch.station.emulation import replay_log_file
from radiosonde_auto_rx_tpu_torch.web import WebExporter, WebServer
from radiosonde_auto_rx_tpu_torch.web.log_files import (
    calculate_skewt_data, list_log_files, log_file_to_kml, read_log_file,
    zip_log_files)


T0 = 1_755_600_000            # 2025-08-19


def _telem(i=0):
    now = datetime.datetime.fromtimestamp(T0, datetime.timezone.utc) + \
        datetime.timedelta(seconds=10 * i)
    return {
        "type": "RS41", "frame": 1000 + i, "id": "S7654321",
        "datetime": now.strftime("%Y-%m-%dT%H:%M:%SZ"), "datetime_dt": now,
        "lat": -34.0 + 0.001 * i, "lon": 138.0, "alt": 5000.0 + 50.0 * i,
        "vel_h": 12.0, "vel_v": 5.0, "heading": 100.0, "temp": -20.0,
        "humidity": 60.0, "pressure": 540.0, "batt": 2.9, "sats": 8,
        "freq": "402.500 MHz", "freq_float": 402.5,
    }


@pytest.fixture
def logdir(tmp_path):
    lg = TelemetryLogger(str(tmp_path), start_thread=False)
    for i in range(20):
        lg.write_telemetry(_telem(i))
    lg.close()
    return tmp_path


def test_log_files_roundtrip(logdir):
    files = list_log_files(str(logdir), quicklook=True)
    assert len(files) == 1
    assert files[0]["serial"] == "S7654321"
    assert files[0]["points"] == 20
    data = read_log_file(files[0]["filename"])
    assert len(data["lat"]) == 20
    assert data["type"] == "RS41"


def test_skewt(logdir):
    files = list_log_files(str(logdir))
    data = read_log_file(files[0]["filename"])
    skewt = calculate_skewt_data(data)
    assert len(skewt) == 20
    assert 500 < skewt[0]["press"] < 600
    assert skewt[0]["dwpt"] is not None
    assert skewt[0]["temp"] == -20.0


def test_kml_and_zip(logdir):
    files = list_log_files(str(logdir))
    kml = log_file_to_kml(files[0]["filename"])
    assert "<LineString>" in kml and "S7654321" in kml
    blob = zip_log_files(str(logdir))
    assert blob[:2] == b"PK"


def test_web_server_routes():
    wex = WebExporter()
    for i in range(3):
        wex.add(_telem(i))
    srv = WebServer(web_exporter=wex, config={"web_password": "secret"})
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        arch = json.load(urllib.request.urlopen(
            base + "/get_telemetry_archive", timeout=5))
        assert "S7654321" in arch
        assert "ascent_rate" in arch["S7654321"]
        ver = json.load(urllib.request.urlopen(base + "/get_version",
                                               timeout=5))
        assert "version" in ver
        cfg = json.load(urllib.request.urlopen(base + "/get_config",
                                               timeout=5))
        assert "web_password" not in cfg
        kml = urllib.request.urlopen(base + "/rs.kml", timeout=5).read()
        assert b"<kml" in kml
        html = urllib.request.urlopen(base + "/", timeout=5).read()
        assert b"radiosonde_auto_rx_tpu_torch" in html
    finally:
        srv.close()


def test_udp_listener():
    received = []
    lst = UDPListener(port=0 or 55999, callback=received.append)
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.sendto(json.dumps({"id": "TEST-1", "lat": 1.0}).encode(),
             ("127.0.0.1", 55999))
    s.close()
    for _ in range(20):
        if received:
            break
        time.sleep(0.1)
    lst.close()
    assert received and received[0]["id"] == "TEST-1"


def test_replay(logdir):
    files = list_log_files(str(logdir))

    class Collect:
        def __init__(self):
            self.items = []

        def add(self, t):
            self.items.append(t)

    c = Collect()
    n = replay_log_file(files[0]["filename"], [c])
    assert n == 20 and len(c.items) == 20
    assert c.items[0]["id"] == "S7654321"


# ---- extended routes + control endpoints ---------------------------------

def _spin_server(tmp_path, station=None, control=False, password="none"):
    from radiosonde_auto_rx_tpu_torch.web.server import WebExporter, WebServer
    cfg = {"log_directory": str(tmp_path), "web_control": control,
           "web_password": password}
    web = WebServer(station=station, web_exporter=WebExporter(),
                    config=cfg, host="127.0.0.1", port=0)
    web.start()
    return web


def _get(port, path):
    import urllib.request
    import urllib.error
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(port, path, data):
    import urllib.request
    import urllib.parse
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=urllib.parse.urlencode(data).encode(), method="POST")
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _make_log(tmp_path, serial="W9988776"):
    from radiosonde_auto_rx_tpu_torch.exporters.logfile import (
        LOG_HEADER, telemetry_to_log_line)
    lines = [LOG_HEADER]
    for i in range(10):
        lines.append(telemetry_to_log_line(dict(
            datetime="2026-08-17T01:02:%02dZ" % i, id=serial, frame=i,
            lat=50.0, lon=10.0 + i * 1e-4, alt=1000.0 + 100 * i,
            vel_v=5.0, vel_h=10.0, heading=45.0, temp=-10.0 - i,
            humidity=60.0, pressure=-1, type="RS41", freq_float=402.5,
            snr=15.0, f_error=0, sats=9, batt=2.9)))
    p = tmp_path / ("20260817-010203_%s_RS41_402.500_sonde.log" % serial)
    p.write_text("".join(ln if ln.endswith("\n") else ln + "\n"
                         for ln in lines))
    return serial


def test_log_detail_and_skewt_routes(tmp_path):
    import json
    serial = _make_log(tmp_path)
    web = _spin_server(tmp_path)
    try:
        code, body = _get(web.port, f"/get_log_detail?serial={serial}"
                          "&decimation=1")
        assert code == 200
        d = json.loads(body)
        assert d["serial"] == serial and len(d["alt"]) == 10
        code, body = _get(web.port, f"/get_skewt_data?serial={serial}")
        assert code == 200
        sk = json.loads(body)
        assert sk and sk[0]["hght"] == 1000.0 and "press" in sk[0]
        code, body = _get(web.port, f"/export_log_file?serial={serial}")
        assert code == 200 and b"<kml" in body
        code, body = _get(web.port, "/download_log_files")
        assert code == 200 and body[:2] == b"PK"
        code, _ = _get(web.port, "/get_skewt_data?serial=NOPE")
        assert code == 404
    finally:
        web.close()


class _StubStation:
    def __init__(self):
        self.scan_enabled = True
        self.calls = []
        self.active = {}
        self.center_freq = 402.5e6
        import numpy as np
        self.freqs = np.zeros(1)

    def start_manual_decoder(self, f, t):
        self.calls.append(("start", f, t))
        return 3

    def stop_decoder(self, f, lockout=0):
        self.calls.append(("stop", f, lockout))
        return 3


def test_control_endpoints(tmp_path):
    st = _StubStation()
    web = _spin_server(tmp_path, station=st, control=True, password="pw1")
    try:
        # wrong password
        code, _ = _post(web.port, "/start_decoder",
                        dict(password="nope", frequency="402500000",
                             type="RS41"))
        assert code == 403
        code, _ = _post(web.port, "/start_decoder",
                        dict(password="pw1", frequency="402500000",
                             type="RS41"))
        assert code == 200 and st.calls[-1][0] == "start"
        code, _ = _post(web.port, "/stop_decoder",
                        dict(password="pw1", frequency="402500000",
                             lockout="5"))
        assert code == 200 and st.calls[-1] == ("stop", 402500000.0, 5.0)
        code, _ = _post(web.port, "/disable_scanner", dict(password="pw1"))
        assert code == 200 and st.scan_enabled is False
        code, _ = _post(web.port, "/enable_scanner", dict(password="pw1"))
        assert code == 200 and st.scan_enabled is True
    finally:
        web.close()


def test_control_disabled_by_default(tmp_path):
    web = _spin_server(tmp_path, station=_StubStation(), control=False)
    try:
        code, _ = _post(web.port, "/enable_scanner", dict(password="x"))
        assert code == 403
    finally:
        web.close()


def test_control_requires_password_set(tmp_path):
    # web_control on but password left at "none": must refuse
    web = _spin_server(tmp_path, station=_StubStation(), control=True,
                      password="none")
    try:
        code, _ = _post(web.port, "/enable_scanner", dict(password="none"))
        assert code == 403
    finally:
        web.close()


def test_log_lines_route(tmp_path):
    import json
    import logging
    from radiosonde_auto_rx_tpu_torch.web.server import (WebExporter, WebHandler,
                                                   WebServer)
    wh = WebHandler(max_lines=10)
    lg = logging.getLogger("weblinetest")
    lg.addHandler(wh)
    lg.setLevel(logging.INFO)
    for i in range(15):
        lg.info("line %d", i)
    web = WebServer(web_exporter=WebExporter(),
                    config={"log_directory": str(tmp_path)},
                    host="127.0.0.1", port=0, log_handler=wh)
    web.start()
    try:
        code, body = _get(web.port, "/get_log_lines?n=5")
        assert code == 200
        lines = json.loads(body)["log_lines"]
        assert len(lines) == 5 and "line 14" in lines[-1]
    finally:
        web.close()
        lg.removeHandler(wh)


def test_index_is_operator_ui(tmp_path):
    """/ serves the full operator UI asset (map + SSE wiring), not the
    fallback status stub."""
    web = _spin_server(tmp_path)
    try:
        code, body = _get(web.port, "/")
        assert code == 200
        page = body.decode()
        assert "EventSource" in page          # live push wiring
        assert 'id="map"' in page             # map canvas
        assert 'id="spectrum"' in page        # scan spectrum canvas
        assert "get_skewt_data" in page       # historical Skew-T view
    finally:
        web.close()


def test_track_history_route(tmp_path):
    wex = WebExporter()
    for i in range(4):
        wex.add(_telem(i))
    web = WebServer(web_exporter=wex,
                    config={"log_directory": str(tmp_path)},
                    host="127.0.0.1", port=0)
    web.start()
    try:
        code, body = _get(web.port, "/get_track_history")
        assert code == 200
        h = json.loads(body)
        assert len(h["S7654321"]) == 4
        lat, lon, alt = h["S7654321"][-1]
        assert abs(lat - (-34.0 + 0.003)) < 1e-6 and alt == 5150.0
    finally:
        web.close()


def test_sse_stream(tmp_path):
    """The /events SSE stream pushes telemetry, log lines and status."""
    import logging
    from radiosonde_auto_rx_tpu_torch.web.server import WebHandler
    wh = WebHandler()
    lg = logging.getLogger("ssetest")
    lg.addHandler(wh)
    lg.setLevel(logging.INFO)
    wex = WebExporter()
    wex.add(_telem(0))
    lg.info("hello from the station")
    web = WebServer(web_exporter=wex,
                    config={"log_directory": str(tmp_path)},
                    host="127.0.0.1", port=0, log_handler=wh)
    web.start()
    try:
        r = urllib.request.urlopen(
            f"http://127.0.0.1:{web.port}/events", timeout=10)
        assert r.headers["Content-Type"].startswith("text/event-stream")
        # pre-connect backlog is NOT replayed over SSE (the page fetches
        # it via /get_log_lines; replay duplicated every line) — only
        # lines logged after the stream opens are pushed.  Log the new
        # line after the server's "hello" event so it is provably past
        # the stream's cursor initialization.
        events = {}
        deadline = time.time() + 10
        logged = False
        while time.time() < deadline and not (
                "telemetry" in events and "log" in events
                and "status" in events):
            line = r.readline().decode().strip()
            if line.startswith("event: "):
                ev = line[7:]
                data = r.readline().decode().strip()
                assert data.startswith("data: ")
                events[ev] = json.loads(data[6:])
                if not logged:
                    lg.info("hello after connect")
                    logged = True
        assert "S7654321" in events["telemetry"]
        assert any("hello after connect" in ln
                   for ln in events["log"]["log_lines"])
        assert not any("hello from the station" in ln
                       for ln in events["log"]["log_lines"])
        assert "version" in events["status"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{web.port}/get_log_lines",
                timeout=10) as lr:
            backlog = json.loads(lr.read())["log_lines"]
        assert any("hello from the station" in ln for ln in backlog)
        r.close()
    finally:
        web.close()
        lg.removeHandler(wh)


def test_station_stats_route(tmp_path):
    import json
    st = _StubStation()
    st.stats = {"frames_ok": 7, "detections": 2}
    st.temporary_blocks = {}
    web = _spin_server(tmp_path, station=st)
    try:
        code, body = _get(web.port, "/get_station_stats")
        assert code == 200
        d = json.loads(body)
        assert d["frames_ok"] == 7 and d["scan_enabled"] is True
        assert "version" in d and d["uptime_s"] >= 0
        code, body = _get(web.port, "/get_task_list")
        assert json.loads(body)["scanner"] == "Scanning"
    finally:
        web.close()


@pytest.mark.parametrize("what", ["log file", "list", "read", "skewt",
                                  "kml"])
def test_log_analytics_match_reference(tmp_path, what):
    """The same telemetry through the JAX package's log exporter and the
    port's: the same file, and the JAX log-file analytics and the port's
    give the same answers on it."""
    from radiosonde_auto_rx_tpu.exporters.logfile import \
        TelemetryLogger as RefLogger
    from radiosonde_auto_rx_tpu.web import log_files as ref_lf
    from radiosonde_auto_rx_tpu_torch.web import log_files as lf
    dirs = {}
    for pkg, logger in (("jax", RefLogger), ("port", TelemetryLogger)):
        dirs[pkg] = tmp_path / pkg
        dirs[pkg].mkdir()
        lg = logger(str(dirs[pkg]), start_thread=False)
        for i in range(20):
            lg.write_telemetry(_telem(i))
        lg.close()
    (ref_file,), (port_file,) = (sorted(d.iterdir()) for d in dirs.values())
    assert ref_file.name == port_file.name
    if what == "log file":
        assert ref_file.read_bytes() == port_file.read_bytes()
    elif what == "list":
        got, want = (
            [{k: v for k, v in f.items() if k != "filename"}
             for f in mod.list_log_files(str(dirs[pkg]), quicklook=True)]
            for mod, pkg in ((lf, "port"), (ref_lf, "jax")))
        assert got == want and len(got) == 1
    elif what == "read":
        assert lf.read_log_file(str(port_file)) == \
            ref_lf.read_log_file(str(ref_file))
    elif what == "skewt":
        assert lf.calculate_skewt_data(lf.read_log_file(str(port_file))) == \
            ref_lf.calculate_skewt_data(ref_lf.read_log_file(str(ref_file)))
    else:
        assert lf.log_file_to_kml(str(port_file)) == \
            ref_lf.log_file_to_kml(str(ref_file))
