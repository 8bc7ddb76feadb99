"""EME (moonbounce) support: lunar ephemeris, locators, doppler (port
of linrad_tpu/weak/eme.py, a copy).

A re-design of the reference EME module (``calculate_moon_data``
eme.c:1588, ``locator_to_latlong`` eme.c:76, ``dist_az``, DXDATA
structures globdef.h:849-855).  Implemented from standard truncated
lunar-theory series (Meeus-style main terms; the reference uses an
equivalent trig-series ephemeris): geocentric lunar position to ~0.1
degree, topocentric parallax correction (essential for the Moon: up to
~1 degree), azimuth/elevation for an observer, and two-way EME doppler
from the numerical range rate — the numbers the reference's EME window
shows for self and DX."""

from __future__ import annotations

import math
from dataclasses import dataclass


C_LIGHT = 299_792.458  # km/s
RAD = math.pi / 180.0


# ---------------------------------------------------------------------------
# Maidenhead locators (locator_to_latlong / latlong_to_locator, eme.c)
# ---------------------------------------------------------------------------

def locator_to_latlon(loc: str) -> tuple[float, float]:
    """6-character Maidenhead locator -> (lat, lon) of square centre."""
    loc = loc.strip().upper()
    if len(loc) < 4:
        raise ValueError(f"locator too short: {loc!r}")
    lon = (ord(loc[0]) - ord("A")) * 20.0 - 180.0
    lat = (ord(loc[1]) - ord("A")) * 10.0 - 90.0
    lon += int(loc[2]) * 2.0
    lat += int(loc[3]) * 1.0
    if len(loc) >= 6:
        lon += (ord(loc[4]) - ord("A")) * (2.0 / 24.0) + 1.0 / 24.0
        lat += (ord(loc[5]) - ord("A")) * (1.0 / 24.0) + 0.5 / 24.0
    else:
        lon += 1.0
        lat += 0.5
    return lat, lon


def latlon_to_locator(lat: float, lon: float) -> str:
    lon += 180.0
    lat += 90.0
    a = "%c%c" % (ord("A") + int(lon // 20), ord("A") + int(lat // 10))
    b = "%d%d" % (int((lon % 20) // 2), int(lat % 10))
    c = "%c%c" % (ord("A") + int((lon % 2) * 12),
                  ord("A") + int((lat % 1) * 24))
    return a + b + c


def dist_az(lat1: float, lon1: float, lat2: float, lon2: float
            ) -> tuple[float, float]:
    """Great-circle distance (km) and initial azimuth (deg) — dist_az,
    eme.c."""
    p1, p2 = lat1 * RAD, lat2 * RAD
    dl = (lon2 - lon1) * RAD
    cosd = (math.sin(p1) * math.sin(p2)
            + math.cos(p1) * math.cos(p2) * math.cos(dl))
    d = math.acos(max(-1.0, min(1.0, cosd)))
    az = math.atan2(math.sin(dl) * math.cos(p2),
                    math.cos(p1) * math.sin(p2)
                    - math.sin(p1) * math.cos(p2) * math.cos(dl))
    return d * 6371.2, (az / RAD) % 360.0


# ---------------------------------------------------------------------------
# Lunar ephemeris (truncated series; calculate_moon_data analog)
# ---------------------------------------------------------------------------

def _julian_day(unix_s: float) -> float:
    return unix_s / 86400.0 + 2440587.5


def moon_geocentric(unix_s: float) -> tuple[float, float, float]:
    """Geocentric ecliptic lon/lat (deg) and distance (km) of the Moon.
    Truncated ELP-style main terms, ~0.1 deg / ~50 km accuracy."""
    t = (_julian_day(unix_s) - 2451545.0) / 36525.0
    # mean elements (deg)
    lp = 218.3164477 + 481267.88123421 * t      # mean longitude
    d = 297.8501921 + 445267.1114034 * t        # mean elongation
    m = 357.5291092 + 35999.0502909 * t         # sun mean anomaly
    mp = 134.9633964 + 477198.8675055 * t       # moon mean anomaly
    f = 93.2720950 + 483202.0175233 * t         # argument of latitude
    d, m, mp, f = [x * RAD for x in (d, m, mp, f)]
    lon = (lp
           + 6.288774 * math.sin(mp)
           + 1.274027 * math.sin(2 * d - mp)
           + 0.658314 * math.sin(2 * d)
           + 0.213618 * math.sin(2 * mp)
           - 0.185116 * math.sin(m)
           - 0.114332 * math.sin(2 * f)
           + 0.058793 * math.sin(2 * d - 2 * mp)
           + 0.057066 * math.sin(2 * d - m - mp)
           + 0.053322 * math.sin(2 * d + mp)
           + 0.045758 * math.sin(2 * d - m)
           - 0.040923 * math.sin(m - mp)
           - 0.034720 * math.sin(d)
           - 0.030383 * math.sin(m + mp))
    lat = (5.128122 * math.sin(f)
           + 0.280602 * math.sin(mp + f)
           + 0.277693 * math.sin(mp - f)
           + 0.173237 * math.sin(2 * d - f)
           + 0.055413 * math.sin(2 * d - mp + f)
           + 0.046271 * math.sin(2 * d - mp - f))
    dist = (385000.56
            - 20905.355 * math.cos(mp)
            - 3699.111 * math.cos(2 * d - mp)
            - 2955.968 * math.cos(2 * d)
            - 569.925 * math.cos(2 * mp)
            + 48.888 * math.cos(m)
            - 3.149 * math.cos(2 * f))
    return lon % 360.0, lat, dist


def _gmst_deg(unix_s: float) -> float:
    jd = _julian_day(unix_s)
    t = (jd - 2451545.0) / 36525.0
    g = (280.46061837 + 360.98564736629 * (jd - 2451545.0)
         + 0.000387933 * t * t)
    return g % 360.0


@dataclass
class MoonData:
    azimuth: float        # deg
    elevation: float      # deg
    distance_km: float    # topocentric
    ra_deg: float
    dec_deg: float
    doppler_hz: float     # two-way self-echo doppler at freq_hz


def moon_topocentric(unix_s: float, lat: float, lon: float
                     ) -> tuple[float, float, float]:
    """Topocentric az/el (deg) + distance (km) for an observer."""
    elon, elat, dist = moon_geocentric(unix_s)
    eps = 23.4392911 * RAD
    lam, beta = elon * RAD, elat * RAD
    ra = math.atan2(math.sin(lam) * math.cos(eps)
                    - math.tan(beta) * math.sin(eps), math.cos(lam))
    dec = math.asin(math.sin(beta) * math.cos(eps)
                    + math.cos(beta) * math.sin(eps) * math.sin(lam))
    lst = (_gmst_deg(unix_s) + lon) * RAD
    ha = lst - ra
    phi = lat * RAD
    # geocentric alt/az
    sin_alt = (math.sin(phi) * math.sin(dec)
               + math.cos(phi) * math.cos(dec) * math.cos(ha))
    alt = math.asin(max(-1.0, min(1.0, sin_alt)))
    az = math.atan2(math.sin(ha),
                    math.cos(ha) * math.sin(phi)
                    - math.tan(dec) * math.cos(phi))
    az = (az / RAD + 180.0) % 360.0
    # topocentric parallax correction in elevation + range
    r_earth = 6378.14
    par = math.asin(r_earth / dist)
    alt_topo = alt - par * math.cos(alt)
    dist_topo = math.sqrt(dist * dist + r_earth * r_earth
                          - 2 * dist * r_earth * math.sin(alt))
    return az, alt_topo / RAD, dist_topo


def moon_data(unix_s: float, lat: float, lon: float,
              freq_hz: float = 144_100_000.0) -> MoonData:
    """Full self-echo moon data (calculate_moon_data, eme.c:1588)."""
    az, el, dist = moon_topocentric(unix_s, lat, lon)
    dt = 30.0
    _, _, d2 = moon_topocentric(unix_s + dt, lat, lon)
    range_rate = (d2 - dist) / dt  # km/s
    dop = -2.0 * range_rate / C_LIGHT * freq_hz
    elon, elat, _ = moon_geocentric(unix_s)
    eps = 23.4392911 * RAD
    lam, beta = elon * RAD, elat * RAD
    ra = math.atan2(math.sin(lam) * math.cos(eps)
                    - math.tan(beta) * math.sin(eps), math.cos(lam))
    dec = math.asin(math.sin(beta) * math.cos(eps)
                    + math.cos(beta) * math.sin(eps) * math.sin(lam))
    return MoonData(azimuth=az, elevation=el, distance_km=dist,
                    ra_deg=(ra / RAD) % 360.0, dec_deg=dec / RAD,
                    doppler_hz=dop)


def mutual_doppler(unix_s: float, lat1: float, lon1: float, lat2: float,
                   lon2: float, freq_hz: float) -> float:
    """DX-path EME doppler: sum of the one-way rates at both ends."""
    dt = 30.0
    _, _, da1 = moon_topocentric(unix_s, lat1, lon1)
    _, _, db1 = moon_topocentric(unix_s + dt, lat1, lon1)
    _, _, da2 = moon_topocentric(unix_s, lat2, lon2)
    _, _, db2 = moon_topocentric(unix_s + dt, lat2, lon2)
    rate = (db1 - da1) / dt + (db2 - da2) / dt
    return -rate / C_LIGHT * freq_hz


# ---------------------------------------------------------------------------
# DX callsign database (DXDATA globdef.h:849-855, read_eme_database
# eme.c:996, wildcard call search eme.c:262-309).  The reference stores
# packed fixed-width records; here it is a plain text file
# "CALL LOCATOR" or "CALL LAT LON", one station per line.


@dataclass
class DxStation:
    call: str
    lat: float
    lon: float

    @property
    def locator(self) -> str:
        return latlon_to_locator(self.lat, self.lon)


class DxDatabase:
    """Callsign database feeding the EME displays.

    ``match`` reproduces the reference's search semantics: ``?`` is a
    single-character wildcard and a query shorter than a call matches
    as a prefix (eme.c:262-309 suggested_calls loop)."""

    def __init__(self, stations: list[DxStation] | None = None):
        self.stations = list(stations or [])

    @classmethod
    def load(cls, path: str) -> "DxDatabase":
        stations = []
        with open(path) as f:
            for line in f:
                parts = line.split("#", 1)[0].split()
                if not parts:
                    continue
                call = parts[0].upper()
                if len(parts) == 2:      # CALL LOCATOR
                    lat, lon = locator_to_latlon(parts[1])
                elif len(parts) >= 3:    # CALL LAT LON
                    lat, lon = float(parts[1]), float(parts[2])
                else:
                    continue
                stations.append(DxStation(call, lat, lon))
        return cls(stations)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for s in self.stations:
                f.write(f"{s.call} {s.lat:.4f} {s.lon:.4f}\n")

    def add(self, call: str, locator: str | None = None,
            lat: float | None = None, lon: float | None = None) -> None:
        if locator is not None:
            lat, lon = locator_to_latlon(locator)
        self.stations.append(DxStation(call.upper(), float(lat),
                                       float(lon)))

    def match(self, query: str) -> list[DxStation]:
        """All stations matching the (possibly wildcarded) query."""
        q = query.upper()
        out = []
        for s in self.stations:
            if len(q) > len(s.call):
                continue
            if all(qc == "?" or qc == cc for qc, cc in zip(q, s.call)):
                out.append(s)
        return out

    def lookup(self, call: str) -> DxStation:
        for s in self.stations:
            if s.call == call.upper():
                return s
        raise KeyError(call)

    def report(self, call: str, unix_s: float, own_lat: float,
               own_lon: float, freq_hz: float = 144_100_000.0) -> dict:
        """Mutual EME geometry for one DX station (the self/DX moon
        position display, eme.c)."""
        dx = self.lookup(call)
        own = moon_data(unix_s, own_lat, own_lon, freq_hz)
        theirs = moon_data(unix_s, dx.lat, dx.lon, freq_hz)
        km, az = dist_az(own_lat, own_lon, dx.lat, dx.lon)
        return {
            "call": dx.call,
            "locator": dx.locator,
            "distance_km": km,
            "azimuth_deg": az,
            "own_moon": own,
            "dx_moon": theirs,
            "mutual_doppler_hz": mutual_doppler(
                unix_s, own_lat, own_lon, dx.lat, dx.lon, freq_hz),
            "window_open": own.elevation > 0.0
                           and theirs.elevation > 0.0,
        }
