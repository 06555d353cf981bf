"""Per-sonde CSV telemetry log files.

File naming and the 20-column line format match the reference logger
(reference auto_rx/autorx/logger.py: filename :210-222, columns/format
:52,124-194, file-handle GC :28-31,262) so existing log analysis tooling
keeps working on our output.
"""

import glob
import os
import time
import threading
import queue

LOG_HEADER = ("timestamp,serial,frame,lat,lon,alt,vel_v,vel_h,heading,"
              "temp,humidity,pressure,type,freq_mhz,snr,f_error_hz,sats,"
              "batt_v,burst_timer,aux_data\n")


def telemetry_to_log_line(telemetry: dict) -> str:
    """One CSV line (reference logger.py telemetry_to_string :124-194)."""
    _type = telemetry.get("subtype", telemetry["type"])
    line = "%s,%s,%d,%.5f,%.5f,%.1f,%.1f,%.1f,%.1f,%.1f,%.1f,%.1f,%s,%.3f" % (
        telemetry["datetime"], telemetry["id"], telemetry["frame"],
        telemetry["lat"], telemetry["lon"], telemetry["alt"],
        telemetry.get("vel_v", -9999.0), telemetry.get("vel_h", -9999.0),
        telemetry.get("heading", -9999.0), telemetry.get("temp", -273.0),
        telemetry.get("humidity", -1.0), telemetry.get("pressure", -1),
        _type, telemetry.get("freq_float", 0.0))
    line += ",%.1f" % telemetry["snr"] if "snr" in telemetry else ",-99.0"
    line += ",%d" % int(telemetry["f_error"]) if "f_error" in telemetry \
        else ",0"
    line += ",%d" % telemetry["sats"] if "sats" in telemetry else ",-1"
    line += ",%.1f" % telemetry["batt"] if "batt" in telemetry else ",-1"
    if "bt" in telemetry and telemetry["bt"] not in (-1, 65535):
        line += "," + time.strftime("%H:%M:%S", time.gmtime(telemetry["bt"]))
    else:
        line += ","
    line += "," + telemetry["aux"].strip() if "aux" in telemetry else ","
    return line + "\n"


class TelemetryLogger:
    """Queue-fed CSV logger; one file per sonde
    ``YYYYMMDD-HHMMSS_<id>_<type>_<freq>_sonde.log``."""

    FILE_ACTIVITY_TIMEOUT = 300

    def __init__(self, log_directory="./log/", start_thread=True,
                 save_cal_data=False):
        self.save_cal_data = save_cal_data
        self.log_directory = log_directory
        os.makedirs(log_directory, exist_ok=True)
        self.open_logs = {}          # id -> (file, last_time)
        self.input_queue = queue.Queue()
        self.running = False
        self._thread = None
        if start_thread:
            self.running = True
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def add(self, telemetry: dict):
        self.input_queue.put(telemetry.copy())

    def _loop(self):
        while self.running:
            try:
                t = self.input_queue.get(timeout=0.5)
            except queue.Empty:
                self.cleanup_logs()
                continue
            self.write_telemetry(t)

    def _log_path(self, telemetry):
        # resume an existing file for this serial if present
        # (reference logger.py:210-222)
        existing = glob.glob(os.path.join(
            self.log_directory, f"*_{telemetry['id']}_*_sonde.log"))
        if existing:
            return existing[0]
        _type = telemetry.get("subtype", telemetry["type"])
        freq = telemetry.get("freq", "000.000 MHz").split()[0]
        name = "%s_%s_%s_%s_sonde.log" % (
            time.strftime("%Y%m%d-%H%M%S"), telemetry["id"], _type, freq)
        return os.path.join(self.log_directory, name)

    def write_telemetry(self, telemetry: dict):
        sid = telemetry["id"]
        if sid not in self.open_logs:
            path = self._log_path(telemetry)
            newfile = not os.path.exists(path) or \
                os.path.getsize(path) == 0
            f = open(path, "a")
            if newfile:
                f.write(LOG_HEADER)
            self.open_logs[sid] = [f, time.time()]
        f, _ = self.open_logs[sid]
        f.write(telemetry_to_log_line(telemetry))
        f.flush()
        self.open_logs[sid][1] = time.time()
        # RS41 51x16 calibration subframe -> binary sidecar, once per
        # sonde (reference logger.py log_rs41_subframe :280)
        if self.save_cal_data and "rs41_calconf51x16" in telemetry:
            sub_path = f.name.replace("_sonde.log", "_subframe.bin")
            if not os.path.exists(sub_path):
                with open(sub_path, "wb") as sf:
                    sf.write(bytes.fromhex(telemetry["rs41_calconf51x16"]))

    def cleanup_logs(self):
        now = time.time()
        for sid in list(self.open_logs):
            if now - self.open_logs[sid][1] > self.FILE_ACTIVITY_TIMEOUT:
                self.open_logs[sid][0].close()
                del self.open_logs[sid]

    def close(self):
        self.running = False
        if self._thread:
            self._thread.join(timeout=2)
        # drain remaining
        while not self.input_queue.empty():
            self.write_telemetry(self.input_queue.get())
        for sid in list(self.open_logs):
            self.open_logs[sid][0].close()
        self.open_logs = {}
