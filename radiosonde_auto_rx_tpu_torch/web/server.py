"""Web status server + WebExporter telemetry store.

``WebExporter`` mirrors the reference's telemetry store + GenericTrack
enrichment (reference auto_rx/autorx/web.py WebExporter :739-880);
``WebServer`` serves the reference's JSON/KML routes from a stdlib
ThreadingHTTPServer.
"""

import collections
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse


class WebHandler(logging.Handler):
    """Ring-buffer log handler serving recent records to the web UI
    (reference web.py WebHandler :718-736 bridges log records to the
    browser via SocketIO; here they are polled from /get_log_lines)."""

    def __init__(self, max_lines: int = 500):
        super().__init__()
        self.lines = collections.deque(maxlen=max_lines)
        self.total = 0               # lines ever seen (SSE cursor)
        self.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))

    def emit(self, record):
        try:
            self.lines.append(self.format(record))
            self.total += 1
        except Exception:
            self.handleError(record)

    def tail(self, n: int = 100):
        return list(self.lines)[-n:]

    def since(self, seen: int):
        """(new lines after cursor ``seen``, new cursor)."""
        lines = list(self.lines)
        fresh = min(self.total - seen, len(lines))
        return (lines[-fresh:] if fresh > 0 else []), self.total

from radiosonde_auto_rx_tpu_torch.utils.geometry import GenericTrack
from radiosonde_auto_rx_tpu_torch.utils.serial import short_type_lookup

MAX_AGE_DEFAULT = 120 * 60


class WebExporter:
    """Exporter storing telemetry for the web routes (with derived
    ascent rate / ground speed from a GenericTrack per sonde).

    Keeps a bounded per-sonde position history for the map view and a
    monotonically increasing sequence number so the SSE stream can push
    only what a client has not seen yet (the reference pushes each
    telemetry frame over SocketIO, web.py:739-880)."""

    def __init__(self, max_age_minutes: int = 120, history: int = 600):
        self.max_age = max_age_minutes * 60
        self.telemetry = {}          # id -> latest enriched telemetry
        self.tracks = {}             # id -> GenericTrack
        self.history = {}            # id -> [[lat, lon, alt], ...]
        self.history_max = history
        self.seq = 0                 # bumped on every add()
        self.lock = threading.Lock()

    def add(self, telemetry: dict):
        sid = telemetry["id"]
        with self.lock:
            track = self.tracks.setdefault(sid, GenericTrack())
            state = track.add_telemetry({
                "time": telemetry["datetime_dt"],
                "lat": telemetry["lat"], "lon": telemetry["lon"],
                "alt": telemetry["alt"]})
            t = {k: v for k, v in telemetry.items() if k != "datetime_dt"}
            t["datetime_dt"] = telemetry["datetime_dt"].isoformat()
            if state:
                t["ascent_rate"] = round(state["ascent_rate"], 1)
                t["ground_speed"] = round(state["speed"], 1)
                if state.get("time_to_landing") is not None:
                    t["time_to_landing"] = state["time_to_landing"]
            t["age"] = time.time()
            t["type_name"] = short_type_lookup(telemetry["type"])
            self.seq += 1
            t["seq"] = self.seq
            self.telemetry[sid] = t
            h = self.history.setdefault(sid, [])
            h.append([round(telemetry["lat"], 5),
                      round(telemetry["lon"], 5),
                      round(telemetry["alt"], 1)])
            del h[:-self.history_max]

    def archive(self):
        with self.lock:
            now = time.time()
            for sid in list(self.telemetry):
                if now - self.telemetry[sid]["age"] > self.max_age:
                    del self.telemetry[sid]
                    self.tracks.pop(sid, None)
                    self.history.pop(sid, None)
            return dict(self.telemetry)

    def updates_since(self, seq: int):
        """Telemetry entries newer than ``seq`` (for the SSE push)."""
        with self.lock:
            return {sid: t for sid, t in self.telemetry.items()
                    if t.get("seq", 0) > seq}, self.seq

    def track_history(self):
        with self.lock:
            return {sid: list(h) for sid, h in self.history.items()}

    def close(self):
        pass


def telemetry_to_kml(telemetry_map: dict) -> str:
    """Live positions as a KML document (reference web.py:148-276).

    Serial/type/freq come from over-the-air frames — XML-escape them so a
    crafted transmission cannot inject markup."""
    from xml.sax.saxutils import escape
    placemarks = []
    for sid, t in telemetry_map.items():
        desc = f"{t.get('type_name', t.get('type', ''))} @ {t.get('freq', '')}"
        placemarks.append(f"""
  <Placemark>
    <name>{escape(str(sid))}</name>
    <description>{escape(desc)}</description>
    <Point>
      <altitudeMode>absolute</altitudeMode>
      <coordinates>{t['lon']:.5f},{t['lat']:.5f},{t['alt']:.1f}</coordinates>
    </Point>
  </Placemark>""")
    return ('<?xml version="1.0" encoding="UTF-8"?>\n'
            '<kml xmlns="http://www.opengis.net/kml/2.2"><Document>'
            + "".join(placemarks) + "\n</Document></kml>\n")


def _load_index() -> bytes:
    """The operator UI (web/static/index.html) — falls back to the
    embedded minimal status page if the asset is missing."""
    import os
    path = os.path.join(os.path.dirname(__file__), "static", "index.html")
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return _INDEX_HTML.encode()


_INDEX_HTML = """<!DOCTYPE html>
<html><head><title>radiosonde_auto_rx_tpu_torch</title>
<style>body{font-family:sans-serif;margin:2em}table{border-collapse:collapse}
td,th{border:1px solid #999;padding:4px 8px}</style></head>
<body><h2>radiosonde_auto_rx_tpu_torch</h2>
<div id="tasks"></div><h3>Telemetry</h3><table id="telem"></table>
<script>
async function refresh(){
 const a=await (await fetch('get_telemetry_archive')).json();
 const t=document.getElementById('telem');
 t.replaceChildren();
 const mkrow=(cells,tag)=>{const tr=document.createElement('tr');
  for(const c of cells){const td=document.createElement(tag);
   td.textContent=c==null?'':String(c);tr.appendChild(td);}
  t.appendChild(tr);};
 mkrow(['ID','Type','Freq','Lat','Lon','Alt','Asc m/s'],'th');
 for(const k in a){const d=a[k];
  mkrow([k,d.type,d.freq||'',d.lat,d.lon,d.alt,d.ascent_rate??''],'td');}
 const s=await (await fetch('get_task_list')).json();
 document.getElementById('tasks').textContent=
   'Active channels: '+JSON.stringify(s);
}
refresh();setInterval(refresh,5000);
</script></body></html>
"""


class WebServer:
    """Threaded status server over a Station + WebExporter."""

    def __init__(self, station=None, web_exporter=None, config=None,
                 host="127.0.0.1", port=0, log_handler=None):
        self.station = station
        self.web_exporter = web_exporter or WebExporter()
        self.config = config or {}
        self.log_handler = log_handler
        self._closing = False
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _send(self, data, ctype="application/json", code=200):
                body = data.encode() if isinstance(data, str) else data
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = urlparse(self.path).path
                if path in ("/", "/index.html"):
                    self._send(_load_index(), "text/html")
                elif path == "/events":
                    self._sse()
                elif path == "/get_track_history":
                    self._send(json.dumps(
                        outer.web_exporter.track_history()))
                elif path == "/get_version":
                    from radiosonde_auto_rx_tpu_torch import __version__
                    self._send(json.dumps({"version": __version__}))
                elif path == "/get_telemetry_archive":
                    self._send(json.dumps(outer.web_exporter.archive(),
                                          default=str))
                elif path == "/get_task_list":
                    self._send(json.dumps(outer.task_list()))
                elif path == "/get_config":
                    cfg = {k: v for k, v in outer.config.items()
                           if "password" not in k and "pass" not in k}
                    self._send(json.dumps(cfg, default=str))
                elif path == "/get_scan_data":
                    self._send(json.dumps(outer.scan_data()))
                elif path == "/get_log_list":
                    from radiosonde_auto_rx_tpu_torch.web.log_files import \
                        list_log_files
                    self._send(json.dumps(list_log_files(
                        outer.config.get("log_directory", "./log/"),
                        quicklook=True),
                        default=str))
                elif path in ("/rs.kml", "/rs_feed.kml"):
                    self._send(telemetry_to_kml(outer.web_exporter.archive()),
                               "application/vnd.google-earth.kml+xml")
                elif path == "/get_station_stats":
                    self._send(json.dumps(outer.station_stats()))
                elif path == "/get_log_lines":
                    try:
                        n = int(self._qs().get("n", ["100"])[0])
                    except ValueError:
                        return self._send(
                            json.dumps({"error": "bad n"}), code=400)
                    lines = outer.log_handler.tail(n) \
                        if outer.log_handler else []
                    # seq: SSE cursor covering everything in this
                    # response — pass as /events?log_seen= so no line
                    # between this fetch and the stream connect is lost
                    seq = outer.log_handler.total \
                        if outer.log_handler else 0
                    self._send(json.dumps({"log_lines": lines,
                                           "seq": seq}))
                elif path == "/get_log_detail":
                    try:
                        dec = int(self._qs().get("decimation", ["5"])[0])
                    except ValueError:
                        return self._send(
                            json.dumps({"error": "bad decimation"}),
                            code=400)
                    self._log_route(lambda f: json.dumps(
                        _read_log(f, dec), default=str))
                elif path == "/get_skewt_data":
                    from radiosonde_auto_rx_tpu_torch.web.log_files import \
                        calculate_skewt_data
                    self._log_route(lambda f: json.dumps(
                        calculate_skewt_data(_read_log(f)), default=str))
                elif path == "/export_log_file":
                    from radiosonde_auto_rx_tpu_torch.web.log_files import \
                        log_file_to_kml
                    self._log_route(
                        lambda f: log_file_to_kml(f),
                        ctype="application/vnd.google-earth.kml+xml")
                elif path == "/download_log_files":
                    from radiosonde_auto_rx_tpu_torch.web.log_files import \
                        zip_log_files
                    serials = self._qs().get("serial", None)
                    self._send(zip_log_files(outer._log_dir(), serials),
                               "application/zip")
                else:
                    self._send(json.dumps({"error": "not found"}), code=404)

            # -- control endpoints (reference web.py :445-661) ---------- #

            def do_POST(self):
                path = urlparse(self.path).path
                length = int(self.headers.get("Content-Length", 0) or 0)
                from urllib.parse import parse_qs
                form = {k: v[0] for k, v in
                        parse_qs(self.rfile.read(length).decode()).items()}
                if not outer.config.get("web_control", False):
                    self._send(json.dumps({"error": "control disabled"}),
                               code=403)
                    return
                password = outer.config.get("web_password", "none")
                if password in ("none", "") or \
                        form.get("password") != password:
                    self._send(json.dumps({"error": "auth failed"}),
                               code=403)
                    return
                st = outer.station
                if st is None:
                    self._send(json.dumps({"error": "no station"}), code=503)
                    return
                try:
                    if path == "/start_decoder":
                        ci = st.start_manual_decoder(
                            float(form["frequency"]), form["type"])
                        self._send(json.dumps({"ok": True, "channel": ci}))
                    elif path == "/stop_decoder":
                        ci = st.stop_decoder(
                            float(form["frequency"]),
                            float(form.get("lockout", 0)))
                        self._send(json.dumps({"ok": True, "channel": ci}))
                    elif path == "/enable_scanner":
                        st.scan_enabled = True
                        self._send(json.dumps({"ok": True}))
                    elif path == "/disable_scanner":
                        st.scan_enabled = False
                        self._send(json.dumps({"ok": True}))
                    else:
                        self._send(json.dumps({"error": "not found"}),
                                   code=404)
                except (KeyError, ValueError) as e:
                    self._send(json.dumps({"error": str(e)}), code=400)

            # -- live push (server-sent events) ------------------------- #

            def _sse(self):
                """Live telemetry/scan/log push over one long-lived HTTP
                connection (the reference pushes the same events via
                SocketIO, web.py:85-144,718-880)."""
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()

                def emit(event, data):
                    self.wfile.write(
                        (f"event: {event}\ndata: "
                         f"{json.dumps(data, default=str)}\n\n").encode())
                    self.wfile.flush()

                t_seq = 0
                # log cursor contract: the client passes the seq it got
                # from /get_log_lines so nothing logged between that
                # fetch and this connect is lost.  No ``log_seen``
                # param = live tail only (from now; replaying the whole
                # ring would duplicate the fetched backlog on every
                # reconnect); an EXPLICIT ``log_seen=0`` requests the
                # full ring replay (the pre-r4 behavior, for clients
                # that skip the /get_log_lines handshake).
                now_total = outer.log_handler.total \
                    if outer.log_handler is not None else 0
                try:
                    log_seen = int(self._qs().get(
                        "log_seen", [str(now_total)])[0])
                except ValueError:
                    log_seen = now_total
                log_seen = max(0, min(log_seen, now_total))
                scan_ts = None
                try:
                    emit("hello", {"ok": True})
                    while not outer._closing:
                        telems, t_seq = \
                            outer.web_exporter.updates_since(t_seq)
                        if telems:
                            emit("telemetry", telems)
                        if outer.log_handler is not None:
                            lines, log_seen = \
                                outer.log_handler.since(log_seen)
                            if lines:
                                emit("log", {"log_lines": lines})
                        sd = outer.scan_data().get("latest_scan") or {}
                        ts = sd.get("timestamp") if isinstance(sd, dict) \
                            else None
                        if ts is not None and ts != scan_ts:
                            scan_ts = ts
                            emit("scan", sd)
                        emit("status", outer.station_stats())
                        time.sleep(1.0)
                except (BrokenPipeError, ConnectionResetError, OSError):
                    return

            # -- helpers ------------------------------------------------ #

            def _qs(self):
                from urllib.parse import parse_qs
                return parse_qs(urlparse(self.path).query)

            def _log_route(self, render, ctype="application/json"):
                """Resolve ?serial=X to its log file and render it."""
                serial = self._qs().get("serial", [None])[0]
                f = outer._log_for_serial(serial)
                if f is None:
                    self._send(json.dumps({"error": "unknown serial"}),
                               code=404)
                    return
                self._send(render(f), ctype)

        def _read_log(filename, decimation=1):
            from radiosonde_auto_rx_tpu_torch.web.log_files import read_log_file
            return read_log_file(filename, decimation=decimation)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = None
        self._started = time.time()

    def _log_dir(self):
        return self.config.get("log_directory", "./log/")

    def _log_for_serial(self, serial):
        """Find the log file whose filename carries this serial."""
        if not serial:
            return None
        import glob
        import os
        safe = "".join(c for c in str(serial) if c.isalnum() or c in "-_")
        hits = sorted(glob.glob(os.path.join(self._log_dir(),
                                             f"*_{safe}_*_sonde.log")))
        return hits[-1] if hits else None

    def task_list(self):
        if self.station is None:
            return {}
        tasks = {str(fz): dict(type=st["type"],
                               freq="%.3f MHz" % (fz / 1e6))
                 for fz, st in self.station.active.items()}
        tasks["scanner"] = "Scanning" if getattr(
            self.station, "scan_enabled", True) else "Stopped"
        return tasks

    def station_stats(self):
        from radiosonde_auto_rx_tpu_torch import __version__
        out = {"version": __version__, "uptime_s": round(
            time.time() - self._started, 1)}
        if self.station is not None:
            out.update(self.station.stats)
            out["active_decoders"] = len(self.station.active)
            out["temporary_blocks"] = len(self.station.temporary_blocks)
            out["scan_enabled"] = bool(self.station.scan_enabled)
        return out

    def scan_data(self):
        if self.station is None:
            return {"freq": [], "power": []}
        return {"latest_scan": self.station.scan_results}

    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self):
        self._closing = True
        self._server.shutdown()
        if self._thread:
            self._thread.join(timeout=2)
        self._server.server_close()    # release the listening socket
