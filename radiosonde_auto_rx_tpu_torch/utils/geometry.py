"""Track geometry: listener/balloon relations and derived motion.

``position_info`` mirrors the reference's spherical-Earth Vincenty math
(reference auto_rx/autorx/utils.py:1007-1090); ``GenericTrack`` mirrors the
derived ascent-rate/heading/speed state (auto_rx/autorx/geometry.py:122-275)
and the simple atmospheric-descent landing estimator (:15-120).
"""

import math
from datetime import datetime, timezone

EARTH_RADIUS = 6371000.0


def position_info(listener, balloon):
    """(lat, lon, alt) x2 -> bearing/elevation/ranges dict (degrees, m)."""
    lat1, lon1, alt1 = listener
    lat2, lon2, alt2 = balloon
    lat1, lon1 = math.radians(lat1), math.radians(lon1)
    lat2, lon2 = math.radians(lat2), math.radians(lon2)

    d_lon = lon2 - lon1
    sa = math.cos(lat2) * math.sin(d_lon)
    sb = math.cos(lat1) * math.sin(lat2) - \
        math.sin(lat1) * math.cos(lat2) * math.cos(d_lon)
    bearing = math.atan2(sa, sb)
    aa = math.hypot(sa, sb)
    ab = math.sin(lat1) * math.sin(lat2) + \
        math.cos(lat1) * math.cos(lat2) * math.cos(d_lon)
    angle_at_centre = math.atan2(aa, ab)
    great_circle = angle_at_centre * EARTH_RADIUS

    ta = EARTH_RADIUS + alt1
    tb = EARTH_RADIUS + alt2
    ea = math.cos(angle_at_centre) * tb - ta
    eb = math.sin(angle_at_centre) * tb
    elevation = math.atan2(ea, eb)
    straight = math.sqrt(ta * ta + tb * tb -
                         2 * ta * tb * math.cos(angle_at_centre))
    if bearing < 0:
        bearing += 2 * math.pi

    return {
        "listener": listener,
        "balloon": balloon,
        "angle_at_centre": math.degrees(angle_at_centre),
        "bearing": math.degrees(bearing),
        "great_circle_distance": great_circle,
        "straight_distance": straight,
        "elevation": math.degrees(elevation),
    }


def _density(alt_m):
    """US Standard Atmosphere density approximation
    (reference geometry.py:15-60)."""
    if alt_m < 11000:
        T = 15.04 - 0.00649 * alt_m
        p = 101.29 * ((T + 273.1) / 288.08) ** 5.256
    elif alt_m < 25000:
        T = -56.46
        p = 22.65 * math.exp(1.73 - 0.000157 * alt_m)
    else:
        T = -131.21 + 0.00299 * alt_m
        p = 2.488 * ((T + 273.1) / 216.6) ** -11.388
    return p / (0.2869 * (T + 273.1))


def seaLevelDescentRate(descent_rate, alt_m):
    """Scale a descent rate at altitude to its sea-level equivalent."""
    rho = _density(alt_m)
    return math.sqrt((rho / 1.225) * descent_rate ** 2)


def time_to_landing(alt_m, descent_rate, ground_asl=0.0, step_s=5):
    """Integrate the descent to ground (reference geometry.py:62-120).

    descent_rate: positive m/s downward at current altitude.
    Returns seconds to landing (int) or None if ascending.
    """
    if descent_rate <= 0 or alt_m <= ground_asl:
        return None
    sl_rate = seaLevelDescentRate(descent_rate, alt_m)
    if sl_rate < 0.2:
        return None
    t = 0
    alt = alt_m
    while alt > ground_asl and t < 4 * 3600:
        rate = math.sqrt(1.225 / _density(alt)) * sl_rate
        alt -= rate * step_s
        t += step_s
    return t


class GenericTrack:
    """Rolling position track with derived ascent rate/heading/speed
    (reference geometry.py:122-275)."""

    def __init__(self, ascent_averaging: int = 6, landing_rate: float = 5.0):
        self.ascent_averaging = ascent_averaging
        self.landing_rate = landing_rate
        self.track_history = []

    def add_telemetry(self, data: dict):
        """data: {time (datetime), lat, lon, alt}; returns state dict."""
        self.track_history.append(
            [data["time"], data["lat"], data["lon"], data["alt"]])
        self.track_history = self.track_history[-200:]
        return self.get_latest_state()

    def get_latest_state(self):
        if not self.track_history:
            return None
        t, lat, lon, alt = self.track_history[-1]
        state = {
            "time": t, "lat": lat, "lon": lon, "alt": alt,
            "ascent_rate": self.ascent_rate(),
            "heading": self.heading(),
            "speed": self.speed(),
        }
        state["is_descending"] = state["ascent_rate"] < 0.0
        if state["is_descending"]:
            state["landing_rate"] = seaLevelDescentRate(
                abs(state["ascent_rate"]), alt)
            state["time_to_landing"] = time_to_landing(
                alt, abs(state["ascent_rate"]))
        return state

    def ascent_rate(self):
        if len(self.track_history) < 2:
            return 0.0
        recent = self.track_history[-self.ascent_averaging:]
        rates = []
        for a, b in zip(recent[:-1], recent[1:]):
            dt = (b[0] - a[0]).total_seconds()
            if dt > 0:
                rates.append((b[3] - a[3]) / dt)
        return sum(rates) / len(rates) if rates else 0.0

    def heading(self):
        if len(self.track_history) < 2:
            return 0.0
        a, b = self.track_history[-2], self.track_history[-1]
        info = position_info((a[1], a[2], a[3]), (b[1], b[2], b[3]))
        return info["bearing"]

    def speed(self):
        if len(self.track_history) < 2:
            return 0.0
        a, b = self.track_history[-2], self.track_history[-1]
        dt = (b[0] - a[0]).total_seconds()
        if dt <= 0:
            return 0.0
        info = position_info((a[1], a[2], a[3]), (b[1], b[2], b[3]))
        return info["great_circle_distance"] / dt
