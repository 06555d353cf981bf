"""Station configuration: defaults + INI reader.

The key set mirrors the reference's ~120-key defaults dict
(reference auto_rx/autorx/config.py:52-186) so existing ``station.cfg``
files parse.  The SDR keys drive real capture subprocesses:
``sdr_quantity`` + per-source ``[sdr_N]`` sections spawn N concurrent
``BlockSource`` captures pinned to band-plan partitions
(station/main.py run_station), each feeding wideband IQ into the
channelizer.
"""

import configparser


def default_config() -> dict:
    return {
        # logging / exporters
        "per_sonde_log": True,
        "email_enabled": False,
        "email_smtp_server": "localhost",
        "email_smtp_port": 25,
        "email_smtp_authentication": "None",
        "email_smtp_login": "None",
        "email_smtp_password": "None",
        "email_from": "sonde@localhost",
        "email_to": None,
        "email_subject": "<type> Sonde launch detected on <freq>: <id>",
        "email_launch_notifications": True,
        "email_landing_notifications": True,
        "email_encrypted_sonde_notifications": True,
        "email_nearby_landing_subject":
            "Nearby Radiosonde Landing Detected - <id>",
        "email_landing_range_threshold": 50,
        "email_landing_altitude_threshold": 1000,
        # source
        "sdr_type": "WIDEBAND",        # reference: RTLSDR/SpyServer/KA9Q
        "sdr_hostname": "localhost",
        "sdr_port": 5555,
        "sdr_quantity": 1,
        # per-source overrides keyed 1..sdr_quantity ([sdr_N] sections,
        # reference config.py:828+); each entry drives one concurrent
        # BlockSource pinned to its own band-plan segment
        "sdr_settings": {},
        "capture_rate": 2400000,
        "num_channels": 50,
        # wide channels (240 kHz default) used for >1 GHz captures
        # (MK2LMS / RS92-NGP); 0 = capture_rate // 240000
        "num_channels_wide": 0,
        # scanning
        "min_freq": 400.4,
        "max_freq": 404.0,
        # optional second range, e.g. 1676.0/1684.0 for the 1680 MHz band
        # (reference uses a dedicated SDR for 1680, scan.py:488-547; here
        # the band scheduler hops the same capture device through it)
        "min_freq2": 0.0,
        "max_freq2": 0.0,
        # scan-visit cadence while decoding (1 scan block per N)
        "scan_every": 4,
        "rx_timeout": 120,
        "only_scan": [],
        "never_scan": [],
        "always_scan": [],
        "always_decode": [],
        "snr_threshold": 10,
        "min_distance": 1000,
        "max_peaks": 10,
        "quantization": 10000,
        "decoder_spacing_limit": 15000,
        "scan_dwell_time": 20,
        "detect_dwell_time": 5,
        "scan_delay": 10,
        "temporary_block_time": 60,
        # RS92: path to a RINEX-2 GPS nav file (reference decode.py:423-446
        # downloads one via gps.py; here supply a path or leave None to
        # attempt a download on first RS92 detection)
        "rs92_ephemeris": None,
        # station
        "station_lat": 0.0,
        "station_lon": 0.0,
        "station_alt": 0.0,
        "station_code": "SONDE",
        "gpsd_enabled": False,
        "gpsd_host": "localhost",
        "gpsd_port": 2947,
        # filtering
        "max_altitude": 50000,
        "max_radius_km": 1000,
        "min_radius_km": 0,
        "radius_temporary_block": False,
        "sonde_time_threshold": 3,
        "enable_realtime_filter": True,
        "max_velocity": 300,
        "payload_id_valid": 5,
        # aprs
        "aprs_enabled": False,
        "aprs_upload_rate": 30,
        "aprs_user": "N0CALL",
        "aprs_pass": "00000",
        "aprs_server": "radiosondy.info",
        "aprs_port": 14580,
        "aprs_object_id": "<id>",
        "aprs_custom_comment": "Radiosonde Auto-RX <freq>",
        "aprs_position_report": False,
        "station_beacon_enabled": False,
        "station_beacon_rate": 30,
        "station_beacon_comment": "radiosonde_auto_rx SondeGate v<version>",
        "station_beacon_icon": "/r",
        # web
        "web_host": "0.0.0.0",
        "web_port": 5000,
        "web_archive_age": 120,
        "web_control": False,
        "web_password": "none",
        # ozi / payload summary
        "ozi_enabled": False,
        "ozi_update_rate": 5,
        "ozi_host": "<broadcast>",
        "ozi_port": 55681,
        "payload_summary_enabled": False,
        "payload_summary_host": "<broadcast>",
        "payload_summary_port": 55672,
        # rotator
        "enable_rotator": False,
        "rotator_update_rate": 30,
        "rotator_hostname": "127.0.0.1",
        "rotator_port": 4533,
        "rotation_threshold": 5.0,
        "rotator_homing_enabled": False,
        "rotator_homing_delay": 10,
        "rotator_home_azimuth": 0,
        "rotator_home_elevation": 0,
        # sondehub
        "sondehub_enabled": True,
        "sondehub_upload_rate": 30,
        "sondehub_contact_email": "none@none.com",
        # parallel host frame plane: decoder worker processes (0 =
        # decode frames inline; N>0 = affinity-routed pool, the analogue
        # of the reference's process-per-sonde decoders; -1 = auto,
        # min(4, ncpu-1) — the production default: a default-config
        # station gets the pooled channel counts, not the serial plane)
        "frame_plane_workers": -1,
        # fused steady-state device step on single-device meshes: one
        # program per block when the task state is unchanged (round-5;
        # False forces the split analyze/confirm/route dispatch)
        "fused_steady_step": True,
        # misc
        "wideband_sondes": False,
        "close_on_encrypted": True,
        "save_cal_data": False,
        "enable_debug_logging": False,
        "experimental_decoders": {},
    }


_SECTIONS = {
    "logging": ("per_sonde_log",),
    "email": ("email_enabled", "email_smtp_server", "email_smtp_port",
              "email_smtp_authentication", "email_smtp_login",
              "email_smtp_password", "email_from", "email_to",
              "email_subject", "email_launch_notifications",
              "email_landing_notifications",
              "email_encrypted_sonde_notifications",
              "email_nearby_landing_subject",
              "email_landing_range_threshold",
              "email_landing_altitude_threshold"),
    "search_params": ("min_freq", "max_freq", "min_freq2", "max_freq2",
                      "rx_timeout", "snr_threshold", "min_distance",
                      "quantization", "scan_every", "only_scan",
                      "never_scan", "always_scan", "always_decode"),
    "location": ("station_lat", "station_lon", "station_alt",
                 "station_code", "gpsd_enabled", "gpsd_host", "gpsd_port"),
    "filtering": ("max_altitude", "max_radius_km", "min_radius_km",
                  "radius_temporary_block", "sonde_time_threshold",
                  "enable_realtime_filter", "max_velocity",
                  "payload_id_valid"),
    "aprs": ("aprs_enabled", "aprs_upload_rate", "aprs_user", "aprs_pass",
             "aprs_server", "aprs_port", "aprs_object_id",
             "aprs_custom_comment", "aprs_position_report",
             "station_beacon_enabled", "station_beacon_rate",
             "station_beacon_comment", "station_beacon_icon"),
    "web": ("web_host", "web_port", "web_archive_age", "web_control",
            "web_password"),
    "ozi": ("ozi_enabled", "ozi_update_rate", "ozi_host", "ozi_port",
            "payload_summary_enabled", "payload_summary_host",
            "payload_summary_port"),
    "rotator": ("enable_rotator", "rotator_update_rate", "rotator_hostname",
                "rotator_port", "rotation_threshold",
                "rotator_homing_enabled", "rotator_homing_delay",
                "rotator_home_azimuth", "rotator_home_elevation"),
    "sondehub": ("sondehub_enabled", "sondehub_upload_rate",
                 "sondehub_contact_email"),
    "advanced": ("scan_dwell_time", "detect_dwell_time", "scan_delay",
                 "max_peaks", "decoder_spacing_limit",
                 "temporary_block_time", "wideband_sondes",
                 "close_on_encrypted", "save_cal_data",
                 "enable_debug_logging", "capture_rate", "num_channels",
                 "num_channels_wide", "frame_plane_workers",
                 "fused_steady_step"),
}


def _coerce(default, raw: str):
    if isinstance(default, bool):
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(float(raw))
    if isinstance(default, float):
        return float(raw)
    if isinstance(default, list):
        raw = raw.strip()
        if not raw:
            return []
        return [float(v) for v in raw.split(",") if v.strip()]
    return raw


def read_auto_rx_config(filename: str | None = None,
                        no_sdr_test: bool = True) -> dict:
    """Read a station.cfg-style INI into a flat config dict.

    Unknown keys are ignored (version-tolerant, like the reference's
    fallback parsing, config.py:188+).  ``[sdr]`` sets ``sdr_quantity``
    and shared source settings; per-source ``[sdr_N]`` sections
    (N = 1..sdr_quantity, reference config.py:828+) land in
    ``cfg["sdr_settings"]`` and drive one concurrent ``BlockSource``
    each (station/main.py)."""
    cfg = default_config()
    cfg["sdr_settings"] = {}
    if filename is None:
        return cfg
    parser = configparser.RawConfigParser()
    if not parser.read(filename):
        # configparser silently swallows missing/unreadable files — a
        # typo'd -c path must NOT run the station on pure defaults
        # (wrong identity uploading to SondeHub)
        raise FileNotFoundError(
            f"config file {filename!r} missing or unreadable")
    for section, keys in _SECTIONS.items():
        if not parser.has_section(section):
            continue
        for key in keys:
            if parser.has_option(section, key):
                cfg[key] = _coerce(cfg[key], parser.get(section, key))
    if parser.has_section("sdr"):
        for key in ("sdr_type", "sdr_hostname", "sdr_port", "sdr_quantity",
                    "capture_rate", "num_channels"):
            if parser.has_option("sdr", key):
                cfg[key] = _coerce(cfg[key], parser.get("sdr", key))
    # per-SDR sections: any key overrides the shared source settings for
    # that source (most commonly hostname/port for networked SDRs, or a
    # replay path for WIDEBAND sources)
    # typed defaults for per-SDR keys that have no global counterpart —
    # without these, _coerce falls back to raw strings and e.g. a
    # configured gain crashes the capture command builder ('>=' between
    # str and int) while bias="false" reads truthy
    _sdr_key_defaults = {"gain": -1.0, "ppm": 0.0, "bias": False,
                         "rtl_device_idx": "0"}
    for n in range(1, int(cfg.get("sdr_quantity", 1)) + 1):
        sec = f"sdr_{n}"
        st = {}
        if parser.has_section(sec):
            for key in parser.options(sec):
                base = cfg.get(key, _sdr_key_defaults.get(key, ""))
                st[key] = _coerce(base, parser.get(sec, key)) \
                    if not isinstance(base, dict) else parser.get(sec, key)
        cfg["sdr_settings"][n] = st
    return cfg
