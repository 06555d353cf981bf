"""E-mail notifications: sonde launch, nearby landing, encrypted sonde.

Mirrors reference auto_rx/autorx/email_notification.py (:116-363): SMTP
with optional TLS/SSL, one launch notification per new sonde serial, and
nearby-landing notifications driven by per-sonde descent tracking
(ascent-trip + sustained-descent trip counters, :220-300).
"""

import smtplib
import time
from email.mime.text import MIMEText

from radiosonde_auto_rx_tpu_torch.utils.geometry import GenericTrack, position_info
from radiosonde_auto_rx_tpu_torch.utils.serial import strip_sonde_serial


class EmailNotification:
    def __init__(self, smtp_server="localhost", smtp_port=25,
                 smtp_authentication="None", smtp_login="", smtp_password="",
                 mail_from="sonde@localhost", mail_to="user@localhost",
                 mail_subject="<type> Sonde launch detected!",
                 mail_nearby_landing_subject="Nearby Radiosonde Landing "
                                             "Detected - <id>",
                 station_position=None, launch_notifications=True,
                 landing_notifications=True,
                 encrypted_sonde_notifications=True,
                 landing_range_threshold=50,
                 landing_altitude_threshold=1000,
                 landing_descent_trip=10):
        self.smtp_server = smtp_server
        self.smtp_port = smtp_port
        self.smtp_authentication = smtp_authentication
        self.smtp_login = smtp_login
        self.smtp_password = smtp_password
        self.mail_from = mail_from
        self.mail_to = mail_to
        self.mail_subject = mail_subject
        self.mail_nearby_landing_subject = mail_nearby_landing_subject
        self.station_position = station_position
        self.launch_notifications = launch_notifications
        self.landing_notifications = landing_notifications
        self.encrypted_sonde_notifications = encrypted_sonde_notifications
        self.landing_range_threshold = landing_range_threshold
        self.landing_altitude_threshold = landing_altitude_threshold
        self.landing_descent_trip = landing_descent_trip
        self.sent_ids = set()
        # per-sonde descent state (reference email_notification.py
        # :120-130): track + ascent/descent trip flags
        self.sondes = {}

    def fill_template(self, template, telemetry):
        out = template
        out = out.replace("<id>", str(telemetry["id"]))
        out = out.replace("<type>", str(telemetry["type"]))
        out = out.replace("<freq>", str(telemetry.get("freq", "")))
        out = out.replace("<lat>", "%.5f" % telemetry.get("lat", 0.0))
        out = out.replace("<lon>", "%.5f" % telemetry.get("lon", 0.0))
        out = out.replace("<alt>", "%d" % telemetry.get("alt", 0))
        return out

    def add(self, telemetry: dict):
        sid = telemetry["id"]
        if sid not in self.sent_ids:
            if telemetry.get("encrypted") and \
                    self.encrypted_sonde_notifications:
                self.sent_ids.add(sid)
                self.send_notification_email(
                    self.launch_message(telemetry),
                    subject="Encrypted sonde detected!")
            elif self.launch_notifications:
                self.sent_ids.add(sid)
                self.send_notification_email(
                    self.launch_message(telemetry),
                    subject=self.fill_template(self.mail_subject,
                                               telemetry))
        if self.landing_notifications:
            self._check_landing(telemetry)

    def _check_landing(self, telemetry):
        """Nearby-landing detection (reference email_notification.py
        :220-300): the sonde must have been above the altitude threshold
        (ascent trip) and then seen descending below it at <-2 m/s for
        ``landing_descent_trip`` consecutive frames within
        ``landing_range_threshold`` km of the station."""
        sid = telemetry["id"]
        # expire stale sondes (flight < ~4 h; a long-running station
        # would otherwise keep one GenericTrack per serial forever)
        now = time.time()
        for old in [k for k, v in self.sondes.items()
                    if now - v["last_time"] > 6 * 3600]:
            del self.sondes[old]
        st = self.sondes.setdefault(sid, dict(
            track=GenericTrack(), ascent_trip=False,
            descending_trip=0, descent_notified=False,
            last_time=now))
        st["last_time"] = now
        state = st["track"].add_telemetry({
            "time": telemetry["datetime_dt"],
            "lat": telemetry["lat"], "lon": telemetry["lon"],
            "alt": telemetry["alt"]})
        if st["descent_notified"] or not state:
            return
        if telemetry["alt"] > self.landing_altitude_threshold:
            st["ascent_trip"] = True
        if telemetry["alt"] < self.landing_altitude_threshold and \
                state["ascent_rate"] < -2.0:
            st["descending_trip"] += 1
        if st["descending_trip"] <= self.landing_descent_trip or \
                not st["ascent_trip"]:
            return
        st["descent_notified"] = True
        if self.station_position is None:
            return
        rel = position_info(self.station_position,
                            (telemetry["lat"], telemetry["lon"],
                             telemetry["alt"]))
        rng_km = rel["straight_distance"] / 1000.0
        if rng_km >= self.landing_range_threshold:
            return
        msg = "Nearby sonde landing detected:\n\n"
        msg += "Serial:    %s\n" % sid
        msg += "Type:      %s\n" % telemetry["type"]
        msg += "Frequency: %s\n" % telemetry.get("freq", "")
        msg += "Position:  %.5f,%.5f\n" % (telemetry["lat"],
                                           telemetry["lon"])
        msg += "Altitude:  %d m\n" % round(telemetry["alt"])
        msg += "Range:     %.1f km (Threshold: %.1fkm)\n" % (
            rng_km, self.landing_range_threshold)
        msg += "Bearing:   %d degrees True\n\n" % int(rel["bearing"])
        msg += "https://sondehub.org/%s\n" % strip_sonde_serial(sid)
        msg += "https://sondehub.org/card/%s\n" % strip_sonde_serial(sid)
        self.send_notification_email(
            msg, subject=self.fill_template(
                self.mail_nearby_landing_subject, telemetry))

    def launch_message(self, telemetry):
        msg = "Sonde detected:\n"
        msg += "Callsign: %s\n" % telemetry["id"]
        msg += "Type: %s\n" % telemetry["type"]
        msg += "Frequency: %s\n" % telemetry.get("freq", "unknown")
        msg += "Position: %.5f, %.5f, %dm\n" % (
            telemetry.get("lat", 0), telemetry.get("lon", 0),
            telemetry.get("alt", 0))
        if self.station_position:
            info = position_info(self.station_position,
                                 (telemetry["lat"], telemetry["lon"],
                                  telemetry["alt"]))
            msg += "Range: %.1f km, bearing %.0f deg\n" % (
                info["straight_distance"] / 1e3, info["bearing"])
        maps = "https://sondehub.org/%s" % telemetry["id"]
        msg += "SondeHub: %s\n" % maps
        return msg

    def send_notification_email(self, message, subject=None):
        try:
            mime = MIMEText(message, "plain", "UTF-8")
            mime["From"] = self.mail_from
            mime["To"] = self.mail_to
            mime["Subject"] = subject or "radiosonde_auto_rx notification"
            if self.smtp_authentication == "SSL":
                server = smtplib.SMTP_SSL(self.smtp_server, self.smtp_port,
                                          timeout=10)
            else:
                server = smtplib.SMTP(self.smtp_server, self.smtp_port,
                                      timeout=10)
            if self.smtp_authentication == "TLS":
                server.starttls()
            if self.smtp_login:
                server.login(self.smtp_login, self.smtp_password)
            server.sendmail(mime["From"], mime["To"].split(";"),
                            mime.as_string())
            server.quit()
            return True
        except OSError:
            return False

    def close(self):
        pass
