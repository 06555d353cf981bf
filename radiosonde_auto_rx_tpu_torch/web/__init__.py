"""Status/telemetry web server (stdlib http.server — no Flask dependency).

Route set mirrors the reference's Flask app (reference
auto_rx/autorx/web.py:85-674): /get_version, /get_task_list, /get_config,
/get_scan_data, /get_telemetry_archive, /get_log_list, /rs.kml plus a
minimal live status page.  The SocketIO push channel becomes plain
polling JSON endpoints.
"""

from radiosonde_auto_rx_tpu_torch.web.server import WebServer, WebExporter
