"""Command-line station entry point: ``python -m radiosonde_auto_rx_tpu_torch``.

Port of ``radiosonde_auto_rx_tpu/station/main.py`` (the reference's main
loop, auto_rx/auto_rx.py:760-1159): read config, wire exporters, start
the web server, then run the capture loop — every block of wideband IQ
flows through the channelizer/scanner/demod batch pipeline of
``Station`` on one device, double-buffered (``captures_dispatch`` for a
cycle's blocks, then ``captures_collect`` of the previous cycle's), with
frame decoding in the frame-plane worker pool.

The device is chosen here: ``--device`` (default ``cuda``).  A run that
finds no CUDA device and did not ask for ``--device cpu`` exits with
``EXIT_ERROR`` and names the missing card; it never falls back to the
CPU.  The port has no mesh: a cycle drains ``mesh_microbatch`` blocks
(default 1) from each source, what the reference computes on one device.

CLI flags mirror the reference (auto_rx.py:765-815): ``-c`` config file,
``-f`` single-frequency decode (MHz), ``-m`` forced sonde type, ``-t``
timeout in minutes, ``-v`` verbose.  Exit codes follow auto_rx.py:12-19
(0 OK, 2 invalid config, 3 SDR/source failure, 4 restart requested).
"""

import argparse
import logging
import signal
import subprocess
import sys
import time

log = logging.getLogger("main")

EXIT_OK = 0
EXIT_ERROR = 1
EXIT_CONFIG = 2
EXIT_SOURCE = 3
EXIT_RESTART = 4


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="radiosonde_auto_rx_tpu_torch",
        description="radiosonde receiver station on a CUDA device")
    ap.add_argument("-c", "--config", default=None,
                    help="station configuration file (INI)")
    ap.add_argument("-f", "--frequency", type=float, default=None,
                    help="decode a single frequency (MHz), skip scanning")
    ap.add_argument("-m", "--type", dest="sonde_type", default=None,
                    help="force the sonde type for -f (e.g. RS41)")
    ap.add_argument("-t", "--timeout", type=float, default=0,
                    help="stop after this many minutes (0 = run forever)")
    ap.add_argument("-v", "--verbose", action="store_true")
    from radiosonde_auto_rx_tpu_torch import __version__
    ap.add_argument("--version", action="version",
                    version=f"radiosonde_auto_rx_tpu_torch {__version__}")
    ap.add_argument("--replay", default=None,
                    help="replay a wideband IQ capture file instead of an SDR")
    ap.add_argument("--replay-format", default="cs16",
                    choices=("cs16", "cu8", "f32c"))
    ap.add_argument("--center", type=float, default=402.5,
                    help="capture center frequency, MHz")
    ap.add_argument("--block-seconds", type=float, default=2.0,
                    help="wideband samples per processing block")
    ap.add_argument("--no-web", action="store_true",
                    help="disable the status web server")
    ap.add_argument("--log-dir", default="./log/")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="resume task state from PATH and keep it updated")
    ap.add_argument("--emulate", default=None, metavar="SONDE_LOG",
                    help="replay a per-sonde CSV log through the exporters"
                         " (no signal processing; reference emulation.py)")
    ap.add_argument("--emulate-speed", type=float, default=0.0,
                    help="0 = as fast as possible, 1 = real time")
    ap.add_argument("--device", default="cuda",
                    help="torch device the station runs on (default cuda;"
                         " 'cpu' runs the plain PyTorch versions)")
    return ap.parse_args(argv)


def build_exporters(config, web_exporter=None):
    """Construct the exporter set the config enables
    (reference auto_rx.py:948-1104)."""
    exporters = []
    if config.get("per_sonde_log", True):
        from radiosonde_auto_rx_tpu_torch.exporters.logfile import TelemetryLogger
        exporters.append(TelemetryLogger(
            log_directory=config.get("log_directory", "./log/"),
            save_cal_data=config.get("save_cal_data", False)))
    if config.get("sondehub_enabled"):
        from radiosonde_auto_rx_tpu_torch.exporters.sondehub import SondehubUploader
        exporters.append(SondehubUploader(
            upload_rate=config["sondehub_upload_rate"],
            user_callsign=config["station_code"],
            user_position=(config["station_lat"], config["station_lon"],
                           config["station_alt"]),
            contact_email=config["sondehub_contact_email"]))
    if config.get("aprs_enabled"):
        from radiosonde_auto_rx_tpu_torch.exporters.aprs import APRSUploader
        exporters.append(APRSUploader(
            aprs_callsign=config["aprs_user"],
            aprs_passcode=config["aprs_pass"],
            server=config["aprs_server"],
            port=config["aprs_port"],
            object_name_override=config["aprs_object_id"],
            object_comment=config["aprs_custom_comment"],
            upload_rate=config["aprs_upload_rate"],
            callsign_validity_threshold=int(
                config.get("payload_id_valid", 5)),
            position_report=config.get("aprs_position_report", False),
            station_beacon=config.get("station_beacon_enabled", False),
            station_beacon_rate=config.get("station_beacon_rate", 30),
            station_beacon_position=(config["station_lat"],
                                     config["station_lon"],
                                     config["station_alt"]),
            station_beacon_comment=config.get("station_beacon_comment",
                                              "radiosonde_auto_rx "
                                              "SondeGate v<version>"),
            station_beacon_icon=config.get("station_beacon_icon", "/r")))
    if config.get("ozi_enabled") or config.get("payload_summary_enabled"):
        from radiosonde_auto_rx_tpu_torch.exporters.ozimux import OziUploader
        exporters.append(OziUploader(
            ozimux_port=config["ozi_port"] if config.get("ozi_enabled")
            else None,
            payload_summary_port=config["payload_summary_port"]
            if config.get("payload_summary_enabled") else None,
            update_rate=config["ozi_update_rate"],
            station=config["station_code"],
            ozimux_host=config.get("ozi_host", "<broadcast>"),
            payload_summary_host=config.get("payload_summary_host")))
    if config.get("email_enabled"):
        from radiosonde_auto_rx_tpu_torch.exporters.email_notification import \
            EmailNotification
        exporters.append(EmailNotification(
            smtp_server=config["email_smtp_server"],
            smtp_port=config["email_smtp_port"],
            smtp_authentication=config["email_smtp_authentication"],
            smtp_login=config["email_smtp_login"],
            smtp_password=config["email_smtp_password"],
            mail_from=config["email_from"],
            mail_to=config["email_to"],
            mail_subject=config["email_subject"],
            mail_nearby_landing_subject=config.get(
                "email_nearby_landing_subject",
                "Nearby Radiosonde Landing Detected - <id>"),
            launch_notifications=config.get(
                "email_launch_notifications", True),
            landing_notifications=config.get(
                "email_landing_notifications", True),
            encrypted_sonde_notifications=config.get(
                "email_encrypted_sonde_notifications", True),
            landing_range_threshold=config.get(
                "email_landing_range_threshold", 50),
            landing_altitude_threshold=config.get(
                "email_landing_altitude_threshold", 1000),
            station_position=(config["station_lat"], config["station_lon"],
                              config["station_alt"])))
    if config.get("enable_rotator"):
        from radiosonde_auto_rx_tpu_torch.exporters.rotator import Rotator
        exporters.append(Rotator(
            station_position=(config["station_lat"], config["station_lon"],
                              config["station_alt"]),
            rotctld_host=config["rotator_hostname"],
            rotctld_port=config["rotator_port"],
            rotator_update_rate=config["rotator_update_rate"],
            rotator_update_threshold=config["rotation_threshold"],
            rotator_homing_enabled=config["rotator_homing_enabled"],
            rotator_homing_delay=config["rotator_homing_delay"],
            rotator_home_position=(config["rotator_home_azimuth"],
                                   config["rotator_home_elevation"]),
            start_thread=True))
    if web_exporter is not None:
        exporters.append(web_exporter)
    return exporters


class BlockSource:
    """Wideband IQ block reader over a replay file or an SDR capture
    process; yields ``(center_hz, block)`` with block = [2, T] float32
    planes.

    Blocks are double-buffered: a reader thread keeps up to ``prefetch``
    blocks queued so source IO overlaps device compute (the host-side
    async driver SURVEY §2.3 prescribes — the reference gets the same
    overlap for free from its per-task subprocess pipelines,
    reference autorx/decode.py:1602-2002).  Each block is tagged with the
    center frequency it was captured at, so a hop never attributes old
    spectrum to the new center.

    ``retune(center_hz)`` restarts the capture process on a new center
    frequency for band-plan hopping and discards any queued blocks from
    the old center (replay files are fixed-center and ignore retunes,
    like the reference's per-task rtl_fm restarts,
    reference autorx/scan.py:413-656)."""

    def __init__(self, config, args, center_hz: float | None = None,
                 prefetch: int = 2, sdr_settings: dict | None = None,
                 name: str = "sdr"):
        self.config = config
        self.args = args
        # per-source overrides from a [sdr_N] section (reference
        # config.py:828+): type/hostname/port/device index/replay path
        self.settings = {**config, **(sdr_settings or {})}
        self.name = name
        self.center_hz = (args.center * 1e6 if center_hz is None
                          else float(center_hz))
        self.prefetch = max(1, int(prefetch))
        self.proc = None
        self._file = None
        self.src = None
        self._q = None
        self._reader = None
        self._stop_evt = None
        self._open()

    def _open(self):
        from radiosonde_auto_rx_tpu_torch.sources.iq_source import (
            IQStreamSource, open_pumped)
        fs = int(self.config["capture_rate"])
        block = int(fs * self.args.block_seconds)
        # SDR wire formats ship at native width (int16/uint8 planes);
        # the station applies the wire scale on-device — halves (cs16)
        # or quarters (cu8) every host->device block transfer
        raw_fmt = {"cs16": "cs16raw", "cu8": "cu8raw"}
        if self.args.replay:
            self._file = open(self.args.replay, "rb")
            stream = self._file
            fmt = raw_fmt.get(self.args.replay_format,
                              self.args.replay_format)
        else:
            from radiosonde_auto_rx_tpu_torch.sources.sdr_wrappers import \
                get_sdr_iq_cmd
            if self.settings["sdr_type"] == "KA9Q":
                # create/tune the radiod channel BEFORE streaming it:
                # pcmrecord only subscribes to the SSRC; without the
                # `tune` call there is no channel to record (reference
                # ka9q.py:16-81 always sets up first).  On failure the
                # capture EOFs and run_station's retry path handles it.
                from radiosonde_auto_rx_tpu_torch.sources.ka9q import \
                    ka9q_setup_channel
                if not ka9q_setup_channel(
                        self.settings.get("sdr_hostname", ""),
                        self.center_hz, fs):
                    log.error("%s: KA9Q channel setup failed at %.3f MHz",
                              self.name, self.center_hz / 1e6)
            cmd = get_sdr_iq_cmd(
                self.settings["sdr_type"], self.center_hz, fs,
                rtl_device_idx=self.settings.get("rtl_device_idx", "0"),
                ppm=self.settings.get("ppm", 0),
                gain=self.settings.get("gain", -1),
                bias=self.settings.get("bias", False),
                sdr_hostname=self.settings.get("sdr_hostname", ""),
                sdr_port=self.settings.get("sdr_port", 5555)).rstrip("| ")
            log.info("%s capture @ %.3f MHz: %s", self.name,
                     self.center_hz / 1e6, cmd)
            self.proc = subprocess.Popen(cmd, shell=True,
                                         stdout=subprocess.PIPE,
                                         start_new_session=True)
            stream = open_pumped(self.proc.stdout)
            fmt = raw_fmt["cs16"]
        self.src = IQStreamSource(stream, fmt=fmt, block_samples=block)
        self._start_reader()

    def _start_reader(self):
        import queue
        import threading
        self._stop_evt = threading.Event()
        self._q = queue.Queue(maxsize=self.prefetch)

        def pump(src=self.src, center=self.center_hz, q=self._q,
                 stop=self._stop_evt):
            while not stop.is_set():
                try:
                    blk = src.read_block()
                except Exception:
                    blk = None
                while not stop.is_set():
                    try:
                        q.put((center, blk), timeout=0.25)
                        break
                    except queue.Full:
                        continue
                if blk is None:
                    return

        self._reader = threading.Thread(target=pump, daemon=True,
                                        name="block-prefetch")
        self._reader.start()

    def _stop_reader(self):
        if self._stop_evt is not None:
            self._stop_evt.set()
        # closing the capture process/file unblocks a reader stuck in a
        # pipe read; callers do that via _stop() before joining
        if self._reader is not None:
            self._reader.join(timeout=5.0)
            self._reader = None

    def retune(self, center_hz: float):
        if self.args.replay or abs(center_hz - self.center_hz) < 1.0:
            return
        if self._stop_evt is not None:
            self._stop_evt.set()
        self._stop()            # kill capture first: unblocks the reader
        self._stop_reader()
        self.center_hz = float(center_hz)
        self._open()            # fresh queue — old-center blocks dropped

    def read_block(self, stop=None):
        """Next ``(center_hz, block)``; block is None at end of stream.

        ``stop``: optional callable checked between queue polls so a
        SIGINT / deadline can interrupt the wait even while a stalled
        capture process keeps the reader thread alive (a hung USB
        tuner otherwise made Ctrl-C inoperative)."""
        import queue
        while stop is None or not stop():
            try:
                return self._q.get(timeout=0.25)
            except queue.Empty:
                if self._reader is None or not self._reader.is_alive():
                    try:
                        return self._q.get_nowait()
                    except queue.Empty:
                        return (self.center_hz, None)
        return (self.center_hz, None)

    def blocks(self):
        while True:
            _, blk = self.read_block()
            if blk is None:
                return
            yield blk

    def _stop(self):
        if self.proc is not None:
            try:
                import os
                os.killpg(os.getpgid(self.proc.pid), signal.SIGKILL)
            except (OSError, ProcessLookupError):
                pass
            self.proc = None
            # KA9Q holds server-side channel state: release the SSRC or
            # radiod keeps streaming full-rate IQ for every center this
            # source ever tuned (reference releases on teardown,
            # ka9q.py:84-131)
            if self.settings.get("sdr_type") == "KA9Q":
                try:
                    from radiosonde_auto_rx_tpu_torch.sources.sdr_wrappers \
                        import shutdown_sdr
                    shutdown_sdr("KA9Q",
                                 self.settings.get("sdr_hostname", ""),
                                 self.center_hz)
                except Exception:
                    log.exception("KA9Q channel release failed")
        if self._file is not None:
            self._file.close()
            self._file = None

    def close(self):
        if self._stop_evt is not None:
            self._stop_evt.set()
        self._stop()
        self._stop_reader()


def run_station(args, config) -> int:
    from radiosonde_auto_rx_tpu_torch.station.station import Station
    from radiosonde_auto_rx_tpu_torch.web.server import WebExporter, WebServer

    config.setdefault("log_directory", args.log_dir)
    web_exporter = WebExporter(
        max_age_minutes=config.get("web_archive_age", 120))
    exporters = build_exporters(config, web_exporter)
    station = Station(config=config, exporters=exporters,
                      center_freq_hz=args.center * 1e6, device=args.device)
    # mobile-station position from gpsd (reference auto_rx.py wires
    # GPSDAdaptor into every exporter's update_station_position)
    gpsd = None
    if config.get("gpsd_enabled"):
        from radiosonde_auto_rx_tpu_torch.station.gpsd import GPSDAdaptor

        def _gps_update(pos):
            lat, lon, alt = (pos["latitude"], pos["longitude"],
                             pos["altitude"])
            for cfg_d in (config, station.config):
                cfg_d["station_lat"] = lat
                cfg_d["station_lon"] = lon
                cfg_d["station_alt"] = alt
            for e in exporters:
                fn = getattr(e, "update_station_position", None)
                if fn is not None:
                    try:
                        fn(lat, lon, alt)
                    except Exception:
                        log.exception("station position update failed")

        gpsd = GPSDAdaptor(config.get("gpsd_host", "localhost"),
                           int(config.get("gpsd_port", 2947)),
                           callback=_gps_update)
        log.info("gpsd position source enabled (%s:%s)",
                 config.get("gpsd_host", "localhost"),
                 config.get("gpsd_port", 2947))
    web = None
    if not args.no_web:
        from radiosonde_auto_rx_tpu_torch.web.server import WebHandler
        wh = WebHandler()
        logging.getLogger().addHandler(wh)
        web = WebServer(station=station, web_exporter=web_exporter,
                        config=config, host=config.get("web_host", "0.0.0.0"),
                        port=int(config.get("web_port", 5000)),
                        log_handler=wh)
        web.start()
        log.info("web server on port %d", web.port)

    if args.checkpoint:
        from radiosonde_auto_rx_tpu_torch.station.checkpoint import \
            load_station_state
        load_station_state(station, args.checkpoint)

    forced_chan = None
    if args.frequency is not None:
        if not station.in_capture(args.frequency * 1e6):
            log.critical(
                "-f %.3f MHz is outside the capture span (%.3f ± %.3f "
                "MHz) — set --center accordingly", args.frequency,
                station.center_freq / 1e6, station.fs_wide / 2e6)
            station.close()
            if gpsd is not None:
                gpsd.close()
            if web is not None:
                web.close()
            return EXIT_CONFIG
        forced_chan = station.channel_of_freq(args.frequency * 1e6)
        log.info("single-frequency mode: %.3f MHz -> channel %d",
                 args.frequency, forced_chan)

    # band plan: cover min_freq..max_freq (and the optional 1680 MHz
    # range) with sdr_quantity concurrent capture sources, each pinned
    # to its own segment subset (reference allocates whole SDRs per
    # task, auto_rx.py:101-128; [sdr_N] config sections config.py:828+).
    # Segments only time-slice WITHIN a source's subset, so with
    # sources >= segments nothing ever hops.
    plan = None
    n_src = 1
    partitions = [None]
    schedulers = [None]
    if args.frequency is None and not args.replay:
        from radiosonde_auto_rx_tpu_torch.station.bandplan import (
            BandPlan, BandScheduler, partition_segments)
        plan = BandPlan(config)
        n_src = max(1, int(config.get("sdr_quantity", 1)))
        partitions = partition_segments(plan, n_src)
        n_src = len(partitions)
        schedulers = [
            BandScheduler(plan, scan_every=int(config.get("scan_every", 4)),
                          segments=part) if len(part) > 1 else None
            for part in partitions]
        log.info("band plan: %d segments over %d source(s): %s",
                 len(plan.segments), n_src,
                 "; ".join(",".join("%.1f" % (s.center_hz / 1e6)
                                    for s in part) + " MHz"
                           for part in partitions))

    stop = {"flag": False}

    def _sigint(signum, frame):
        stop["flag"] = True

    old_handler = signal.signal(signal.SIGINT, _sigint)
    deadline = time.time() + args.timeout * 60 if args.timeout else None
    sources: list = []
    code = EXIT_OK
    # SDR sources are retried with a reset on unexpected EOF (reference
    # scan.py retries w/ reset_sdr up to 5 consecutive errors :668,905-925);
    # replay files end naturally after one pass.
    # config-driven WIDEBAND sources replay a capture FILE (the
    # hostname key doubles as its path): like --replay, a clean EOF is
    # the end of the data, not an SDR failure to retry — retrying would
    # reopen `cat` at offset 0 and re-upload the same telemetry forever
    sdr_settings = config.get("sdr_settings", {}) or {}

    def _source_max_retries(i):
        # the WIDEBAND no-retry rule must honor per-SDR [sdr_N]
        # overrides: one replay-file source among live SDRs must not
        # loop its file, and a live override under a global WIDEBAND
        # default must still get its retries
        st = {**config, **(sdr_settings.get(i + 1) or {})}
        return 0 if (args.replay or
                     st.get("sdr_type") == "WIDEBAND") else 5

    def _open_source(i):
        part = partitions[i]
        start_hz = (part[0].center_hz if part else args.center * 1e6)
        # prefetch must cover the micro-batch drain: while one source's
        # ``mb`` consecutive blocks are pulled for the mesh cycle, the
        # others keep capturing — a queue shorter than the burst would
        # backpressure the capture pipe and drop samples in hardware
        return BlockSource(config, args, center_hz=start_hz,
                           sdr_settings=sdr_settings.get(i + 1),
                           prefetch=max(2, mb + 1),
                           name=f"sdr_{i + 1}")

    def _process(block):
        if forced_chan is not None:
            from radiosonde_auto_rx_tpu_torch.ops.channelizer import \
                channelize
            ch = channelize(station._wide_planes(block), station.n_chan,
                            station.device, station.pfb_taps)
            if args.sonde_type:
                return station.decode_channel(
                    ch[forced_chan], forced_chan, args.sonde_type)
            dets = station.detector.detect(ch[forced_chan][None])[0]
            return (station.decode_channel(
                ch[forced_chan], forced_chan, dets[0].name,
                dets[0]) if dets else [])
        return station.process_capture(block)

    def _dispatch_batch(batch):
        """Enqueue one cycle's blocks (center, block): the sharded
        device program's analysis starts now, its results are fetched a
        cycle later (double-buffering, Station.captures_dispatch)."""
        if forced_chan is not None:
            return ("forced", batch)
        return station.captures_dispatch([b for _, b in batch],
                                         [c for c, _ in batch])

    def _collect_batch(pending):
        if pending[0] == "forced":
            out = []
            for c, b in pending[1]:
                station.center_freq = c
                out.extend(_process(b))
            return out
        return station.captures_collect(pending)

    # blocks drained per source per cycle: the reference's micro-batch
    # on a one-device mesh (the port has no mesh)
    mb = 1
    if forced_chan is None:
        mb = int(config.get("mesh_microbatch", 0)) or 1

    try:
        n_blocks = 0
        retries = [0] * n_src
        sources = [_open_source(i) for i in range(n_src)]
        ended = [False] * n_src          # replay/EOF sources done
        pending = None                   # in-flight (dispatched batch, n)
        while not stop["flag"] and not (deadline and
                                        time.time() > deadline):
            # every source captures CONCURRENTLY (its own subprocess +
            # prefetch thread); this loop drains ``mb`` block(s) from
            # each in turn, so no source ever loses samples while
            # another's block is on the device, then processes the
            # whole cycle's batch in one call (one sharded device
            # program on a multi-chip mesh)
            progressed = False
            batch = []
            for i in range(n_src):
                if stop["flag"] or sources[i] is None:
                    continue
                sched = schedulers[i]
                if sched is not None:
                    tasked = list(station.active) + \
                        list(station.manual_tasks)
                    seg = sched.next_center(tasked, station.scan_enabled)
                    sources[i].retune(seg.center_hz)
                def _should_stop():
                    return stop["flag"] or bool(
                        deadline and time.time() > deadline)

                got_i = 0
                block_center, block = sources[i].read_block(_should_stop)
                for _ in range(mb - 1):
                    if block is None:
                        break
                    batch.append((block_center, block))
                    got_i += 1
                    block_center, block = \
                        sources[i].read_block(_should_stop)
                if block is None and _should_stop():
                    # interrupted wait (SIGINT/deadline), not an EOF:
                    # never take the SDR-reset/reopen path on shutdown
                    break
                if block is None and got_i:
                    # EOF mid-micro-batch: process what we have; the
                    # next cycle takes the EOF/retry path
                    progressed = True
                    retries[i] = 0
                    continue
                if block is None:
                    # source ended: replay EOF is a clean stop; a live
                    # SDR gets reset + reopened up to max_retries
                    sources[i].close()
                    sources[i] = None
                    ended[i] = True
                    max_retries = _source_max_retries(i)
                    if max_retries:
                        retries[i] += 1
                        if retries[i] > max_retries:
                            log.critical("source %d died %d times — "
                                         "giving up", i + 1, retries[i])
                            for e in exporters:
                                if hasattr(e, "send_notification_email"):
                                    try:
                                        e.send_notification_email(
                                            "SDR source %d failed %d "
                                            "times; station exiting "
                                            "with code %d" % (
                                                i + 1, retries[i],
                                                EXIT_SOURCE))
                                    except Exception:
                                        log.exception(
                                            "failure e-mail failed")
                            code = EXIT_SOURCE
                            stop["flag"] = True
                            break
                        log.warning("source %d ended; resetting and "
                                    "retrying %d/%d", i + 1, retries[i],
                                    max_retries)
                        try:
                            from radiosonde_auto_rx_tpu_torch.sources. \
                                sdr_wrappers import reset_sdr
                            # reset THIS source's device: per-source
                            # [sdr_N] settings carry its device
                            # index/hostname — resetting the defaults
                            # would power-cycle a healthy sibling SDR
                            st_i = {**config,
                                    **(sdr_settings.get(i + 1) or {})}
                            reset_sdr(
                                st_i.get("sdr_type", "RTLSDR"),
                                rtl_device_idx=st_i.get(
                                    "rtl_device_idx", "0"),
                                sdr_hostname=st_i.get("sdr_hostname", ""),
                                sdr_port=st_i.get("sdr_port", 5555))
                        except Exception:
                            log.exception("SDR reset failed")
                        time.sleep(min(2.0 * retries[i], 10.0))
                        sources[i] = _open_source(i)
                        ended[i] = False
                    continue
                progressed = True
                retries[i] = 0
                batch.append((block_center, block))
            # double-buffer: enqueue this cycle's device analysis FIRST,
            # then finish the previous cycle's batch — its host policy /
            # frame decode overlaps the device working on the new blocks
            new_pending = None
            if batch:
                new_pending = (_dispatch_batch(batch), len(batch))
            if pending is not None:
                telems = _collect_batch(pending[0])
                n_blocks += pending[1]
                station.clean_task_list()
                if args.checkpoint:
                    from radiosonde_auto_rx_tpu_torch.station.checkpoint import \
                        save_station_state
                    save_station_state(station, args.checkpoint)
                if telems:
                    log.info("blocks %d (+%d): %d telemetry frames",
                             n_blocks, pending[1], len(telems))
            pending = new_pending
            if pending is None and (all(ended) or (
                    not progressed and all(s is None for s in sources))):
                break
        if pending is not None:          # deadline/SIGINT mid-flight
            telems = _collect_batch(pending[0])
            n_blocks += pending[1]
        log.info("stopped after %d blocks; stats=%s", n_blocks,
                 station.stats)
    except FileNotFoundError as e:
        log.critical("capture source failed: %s", e)
        code = EXIT_SOURCE
    except Exception:
        log.exception("station error")
        code = EXIT_ERROR
    finally:
        signal.signal(signal.SIGINT, old_handler)
        for s in sources:
            if s is not None:
                s.close()
        station.close()
        if gpsd is not None:
            gpsd.close()
        if web is not None:
            web.close()
    return code


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    from radiosonde_auto_rx_tpu_torch.station.config import read_auto_rx_config
    try:
        config = read_auto_rx_config(args.config) if args.config \
            else read_auto_rx_config(None)
    except Exception:
        log.exception("invalid configuration")
        return EXIT_CONFIG
    if config is not None and config.get("enable_debug_logging"):
        logging.getLogger().setLevel(logging.DEBUG)
    if config is None:
        return EXIT_CONFIG
    if args.emulate:
        from radiosonde_auto_rx_tpu_torch.station.emulation import replay_log_file
        from radiosonde_auto_rx_tpu_torch.web.server import WebExporter, WebServer
        config.setdefault("log_directory", args.log_dir)
        wexp = WebExporter()
        exporters = build_exporters(config, wexp)
        web = None
        if not args.no_web:
            from radiosonde_auto_rx_tpu_torch.web.server import WebHandler
            wh = WebHandler()
            logging.getLogger().addHandler(wh)
            web = WebServer(web_exporter=wexp, config=config,
                            host=config.get("web_host", "0.0.0.0"),
                            port=int(config.get("web_port", 5000)),
                            log_handler=wh)
            web.start()
            log.info("web server on port %d", web.port)
        try:
            n = replay_log_file(args.emulate, exporters,
                                speed=args.emulate_speed)
            log.info("replayed %d telemetry frames", n)
        finally:
            for e in exporters:
                try:
                    e.close()
                except Exception:
                    pass
            if web is not None:
                web.close()
        return EXIT_OK
    if args.replay is None and config.get("sdr_type") == "WIDEBAND":
        # WIDEBAND replays a capture file; the hostname key doubles as its
        # path — require one that exists
        import os
        path = str(config.get("sdr_hostname", ""))
        if not os.path.isfile(path):
            log.critical("no source: pass --replay or configure an SDR")
            return EXIT_CONFIG
    import torch
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        log.critical("no CUDA device: the station runs on a CUDA card "
                     "(pass --device cpu to run it on the CPU)")
        return EXIT_ERROR
    return run_station(args, config)


if __name__ == "__main__":
    sys.exit(main())
