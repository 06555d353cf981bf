"""APRS-IS exporter: position/object packet formatting + igate upload.

Packet format matches the reference (reference auto_rx/autorx/aprs.py
telemetry_to_aprs_position :20-165: DDMM.MM coordinates, base-91 added
precision datum, course/speed in knots, altitude in feet); upload is a
plain TCP login to an APRS-IS igate (:415-560) with a synchronized upload
timer (:642).
"""

import socket
import threading
import time

from radiosonde_auto_rx_tpu_torch.utils.serial import strip_sonde_serial


def telemetry_to_aprs_position(sonde_data, object_name="<id>",
                               aprs_comment="Radiosonde", position_report=False):
    """Telemetry dict -> (packet_str, object_name)."""
    if object_name == "<id>":
        _object_name = sonde_data.get("aprsid")
        if _object_name is None:
            return None, None
    else:
        _object_name = object_name
    # APRS object names are a FIXED 9-byte field: shorter ids must be
    # space-padded or every subsequent fixed-position field shifts
    # (reference aprs.py pads with ljust(9))
    _object_name = _object_name[:9].ljust(9)

    if "f_centre" in sonde_data:
        _freq = "%.3f MHz" % (round(sonde_data["f_centre"] / 1e3) / 1e3)
    else:
        _freq = sonde_data.get("freq", "")

    c = aprs_comment
    c = c.replace("<freq>", _freq)
    c = c.replace("<id>", strip_sonde_serial(sonde_data["id"]))
    c = c.replace("<temp>", "%.1fC" % sonde_data.get("temp", -273.0))
    c = c.replace("<pressure>", "%.1fhPa" % sonde_data.get("pressure", -1))
    c = c.replace("<humidity>", "%.1f" % sonde_data.get("humidity", -1) + "%")
    c = c.replace("<batt>", "%.1fV" % sonde_data.get("batt", -1))
    c = c.replace("<vel_v>", "%.1fm/s" % sonde_data.get("vel_v", 0.0))
    c = c.replace("<type>", sonde_data["type"])

    lat = float(sonde_data["lat"])
    lat_minute = abs(lat - int(lat)) * 60.0
    lat_min_str = ("%02.4f" % lat_minute).zfill(7)[:5]
    lat_str = "%02d%s%s" % (abs(int(lat)), lat_min_str,
                            "N" if lat > 0 else "S")
    lon = float(sonde_data["lon"])
    lon_minute = abs(lon - int(lon)) * 60.0
    lon_min_str = ("%02.4f" % lon_minute).zfill(7)[:5]
    lon_str = "%03d%s%s" % (abs(int(lon)), lon_min_str,
                            "W" if lon < 0 else "E")

    # base-91 added precision (aprs.py:108-122)
    lat_prec = chr(int(round(float(("%02.4f" % lat_minute)[-2:]) / 1.10)) + 33)
    lon_prec = chr(int(round(float(("%02.4f" % lon_minute)[-2:]) / 1.10)) + 33)
    datum = "!w%s%s!" % (lat_prec, lon_prec)

    alt_ft = int(float(sonde_data["alt"]) / 0.3048)
    ts = sonde_data["datetime_dt"].strftime("%H%M%S")
    if "heading" in sonde_data and "vel_h" in sonde_data:
        course_speed = "%03d/%03d" % (int(sonde_data["heading"]) % 360,
                                      int(sonde_data["vel_h"] * 1.944))
    else:
        course_speed = "000/000"

    if position_report:
        out = "/%sh%s/%sO%s/A=%06d %s %s" % (
            ts, lat_str, lon_str, course_speed, alt_ft, c, datum)
    else:
        out = ";%s*%sh%s/%sO%s/A=%06d %s %s" % (
            _object_name, ts, lat_str, lon_str, course_speed, alt_ft, c,
            datum)
    return out, _object_name.strip()


def generate_station_object(callsign, lat, lon,
                            comment="radiosonde_auto_rx SondeGate "
                                    "v<version>",
                            icon="/r", position_report=True):
    """Station position beacon packet (reference aprs.py
    generate_station_object :166-258)."""
    from radiosonde_auto_rx_tpu_torch import __version__
    callsign = callsign[:9].ljust(9)
    lat = float(lat)
    lat_minute = abs(lat - int(lat)) * 60.0
    lat_min_str = ("%02.4f" % lat_minute).zfill(7)[:5]
    lat_str = "%02d%s%s" % (abs(int(lat)), lat_min_str,
                            "N" if lat > 0 else "S")
    lon = float(lon)
    lon_minute = abs(lon - int(lon)) * 60.0
    lon_min_str = ("%02.4f" % lon_minute).zfill(7)[:5]
    lon_str = "%03d%s%s" % (abs(int(lon)), lon_min_str,
                            "W" if lon < 0 else "E")
    lat_prec = chr(int(round(float(("%02.4f" % lat_minute)[-2:]) / 1.10))
                   + 33)
    lon_prec = chr(int(round(float(("%02.4f" % lon_minute)[-2:]) / 1.10))
                   + 33)
    datum = "!w%s%s!" % (lat_prec, lon_prec)
    comment = comment.replace("<version>", __version__)
    if position_report:
        # timestamp-less position report (APRS101 p.32), as the reference
        # now emits for radiosondy.info compatibility
        return "!%s%s%s%s%s %s" % (lat_str, icon[0], lon_str, icon[1],
                                   comment, datum)
    ts = time.strftime("%H%M%S", time.gmtime())
    return ";%s*%sh%s%s%s%s%s %s" % (callsign, ts, lat_str, icon[0],
                                     lon_str, icon[1], comment, datum)


class APRSUploader:
    """Queue-fed APRS-IS igate client.

    Matches the reference's connection discipline (reference
    auto_rx/autorx/aprs.py:415-560): ONE persistent TCP connection with
    a single login (plus inbound-traffic filters), re-established after
    ``reconnect_minutes`` or on any send error; uploads retry up to
    ``retries`` times with a reconnect between attempts; the upload
    timer is synchronized to wall-clock multiples of ``upload_rate``
    (reference :642 ``upload_timer``) so packet timestamps across
    stations land in the same slots."""

    def __init__(self, aprs_callsign="N0CALL", aprs_passcode="00000",
                 server="radiosondy.info", port=14580,
                 object_name_override="<id>", object_comment="Radiosonde",
                 position_report=False, upload_rate=30,
                 callsign_validity_threshold=5, start_thread=True,
                 station_beacon=False, station_beacon_rate=30,
                 station_beacon_position=(0.0, 0.0, 0.0),
                 station_beacon_comment="radiosonde_auto_rx SondeGate "
                                        "v<version>",
                 station_beacon_icon="/r",
                 reconnect_minutes=25, retries=5, timeout=10.0):
        self.station_beacon = dict(
            enabled=station_beacon, rate=station_beacon_rate,
            position=station_beacon_position,
            comment=station_beacon_comment, icon=station_beacon_icon)
        self._last_beacon = 0.0
        self.callsign = aprs_callsign
        self.passcode = aprs_passcode
        self.server = server
        self.port = port
        self.object_name_override = object_name_override
        self.object_comment = object_comment
        self.position_report = position_report
        self.upload_rate = upload_rate
        self.callsign_validity_threshold = callsign_validity_threshold
        self.reconnect_minutes = reconnect_minutes
        self.retries = int(retries)
        self.timeout = timeout
        self.observed_payloads = {}
        self.latest = {}
        self._sock = None
        self._lastconnect = 0.0
        self._lock = threading.Lock()
        # synchronized slots: first upload at the next wall-clock
        # multiple of upload_rate (reference aprs.py:642)
        self._next_upload = (time.time() // upload_rate + 1) * upload_rate
        self.running = False
        self._thread = None
        if start_thread:
            self.running = True
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def add(self, telemetry: dict):
        sid = telemetry["id"]
        self.observed_payloads[sid] = self.observed_payloads.get(sid, 0) + 1
        if self.observed_payloads[sid] >= self.callsign_validity_threshold:
            self.latest[sid] = telemetry.copy()

    def _loop(self):
        while self.running:
            time.sleep(0.5)
            now = time.time()
            if now < self._next_upload:
                continue
            # re-align (never drift, never burst after a stall)
            self._next_upload = \
                (now // self.upload_rate + 1) * self.upload_rate
            for sid in list(self.latest):
                # pop BEFORE the (slow, retrying) upload: a frame the
                # decode thread stores meanwhile must survive into the
                # next slot, not be deleted unsent
                telem = self.latest.pop(sid, None)
                if telem is None:
                    continue
                pkt, name = telemetry_to_aprs_position(
                    telem, self.object_name_override, self.object_comment,
                    self.position_report)
                if pkt:
                    # position reports igate under the sonde's own call;
                    # objects are sourced by the station callsign
                    # (reference aprs.py:630-636)
                    self.upload_packet(
                        pkt, source=name if self.position_report else None)
            self.beacon_station_position()

    def update_station_position(self, lat, lon, alt):
        """GPSD hook (reference aprs.py:587-589)."""
        self.station_beacon["position"] = (lat, lon, alt)

    def beacon_station_position(self):
        """Upload the station position beacon on its own cadence
        (reference aprs.py beacon_station_position :560-585)."""
        if not self.station_beacon["enabled"]:
            return
        if time.time() - self._last_beacon < \
                self.station_beacon["rate"] * 60:
            return
        lat, lon = self.station_beacon["position"][:2]
        if lat == 0.0 and lon == 0.0:
            # reference refuses to beacon a 0,0 position; do NOT stamp
            # the rate limiter here — a mobile station waiting for its
            # first gpsd fix should beacon the moment the fix arrives,
            # not a full beacon period later
            return
        self._last_beacon = time.time()
        pkt = generate_station_object(
            self.callsign, lat, lon, self.station_beacon["comment"],
            self.station_beacon["icon"], position_report=True)
        self.upload_packet(pkt)

    # ------------------------------------------------------------------ #
    # igate connection discipline (reference aprs.py:415-560)

    def connect(self) -> bool:
        """Open the persistent APRS-IS connection and log in once."""
        try:
            s = socket.create_connection((self.server, self.port),
                                         timeout=self.timeout)
            s.settimeout(self.timeout)
            from radiosonde_auto_rx_tpu_torch import __version__
            login = "user %s pass %s vers radiosonde_auto_rx_tpu_torch " \
                "%s\r\n" % (self.callsign, self.passcode, __version__)
            s.sendall(login.encode("ascii"))
            # limit inbound bandwidth (the igate otherwise streams us
            # the whole feed; reference sets the same filters)
            s.sendall(b"#filter p/ZZ\r\n")
            s.sendall(b"#filter -t/po\r\n")
            resp = s.recv(1024).decode("ascii", "replace").strip()
            if not resp.startswith("#"):
                raise IOError("invalid APRS-IS response: %r" % resp[:80])
            self._sock = s
            self._lastconnect = time.time()
            return True
        except OSError as e:
            import logging
            logging.getLogger("aprs").warning(
                "APRS-IS connect failed: %s", e)
            self._sock = None
            return False

    def disconnect(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def upload_packet(self, packet: str, source: str | None = None,
                      igate: bool = True) -> bool:
        """Upload one packet over the held connection, retrying with a
        reconnect between attempts (reference aprsis_upload
        :479-545)."""
        src = source or self.callsign
        if igate:
            frame = "%s>APRARX,SONDEGATE,TCPIP,qAR,%s:%s\r\n" % (
                src, self.callsign, packet)
        else:
            frame = "%s>APRS:%s\r\n" % (src, packet)
        with self._lock:
            # periodic reconnect: igates silently drop idle/stale
            # connections (reference aprsis_reconnect, default 25 min)
            if self._sock is not None and \
                    time.time() - self._lastconnect > \
                    self.reconnect_minutes * 60:
                self.disconnect()
            if self._sock is None:
                # connect lazily but BEFORE the first attempt — else a
                # cold start burns attempt 1 on "not connected" (and
                # retries=1 could never deliver a single packet)
                self.connect()
            # drain inbound igate chatter accumulated since the last
            # upload: an unread keepalive stream eventually fills the
            # TCP window on a long-lived connection
            self.flush_rx()
            for attempt in range(self.retries):
                try:
                    if self._sock is None:
                        raise IOError("not connected")
                    self._sock.sendall(frame.encode("ascii"))
                    # a dropped connection accepts one last sendall into
                    # the dead kernel buffer — EOF shows up as
                    # readable-with-empty-recv; verify before declaring
                    # the packet delivered (a rare duplicate on the
                    # race is harmless — igates dedupe)
                    if not self._alive_after_send():
                        raise IOError("connection closed by igate")
                    return True
                except OSError as e:
                    import logging
                    logging.getLogger("aprs").warning(
                        "APRS-IS upload error (attempt %d/%d): %s",
                        attempt + 1, self.retries, e)
                    self.disconnect()
                    if attempt + 1 < self.retries:
                        time.sleep(min(0.25 * 2 ** attempt, 2.0))
                        self.connect()
            return False

    def _alive_after_send(self) -> bool:
        """Post-send liveness: drain any igate chatter; an EOF read
        means the peer closed before/while we sent."""
        import select
        try:
            while True:
                r, _, _ = select.select([self._sock], [], [], 0.05)
                if not r:
                    return True
                if not self._sock.recv(4096):
                    return False
        except OSError:
            return False

    def flush_rx(self):
        """Drain any inbound igate chatter (reference flush_rx)."""
        if self._sock is None:
            return
        try:
            self._sock.setblocking(False)
            try:
                self._sock.recv(32768)
            finally:
                self._sock.setblocking(True)
                self._sock.settimeout(self.timeout)
        except OSError:
            pass

    def close(self):
        self.running = False
        if self._thread:
            self._thread.join(timeout=2)
        self.disconnect()
