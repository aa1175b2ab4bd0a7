"""Date/time utilities: Gregorian <-> Julian day, leap years, calendar
decomposition, local sidereal time.

Parity: core/include/tsd/temps.hpp:21-385, core/src/temps.cc:66-597
(DateHeure / Duree / Calendrier / HeureComposite; astronomy-grade sidereal
time).

Copied from ``libtsd_tpu/utils/timedate.py`` (host numpy; the port keeps its
own copy so that it imports nothing of the JAX package).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = [
    "year_is_valid", "year_month_valid",
    "is_leap_year", "days_in_month", "gregorian_to_jd", "jd_to_gregorian",
    "mjd", "j2000", "day_of_week", "sidereal_time", "local_sidereal_time",
    "Calendar", "TimeOfDay", "DateTime", "Duration", "HourComposite",
    "datetime_add", "datetime_diff",
]


def year_is_valid(y: int) -> bool:
    """Calendar-supported year range (parity: année_est_valide,
    temps.cc:394-397)."""
    return 1 <= y <= 9999


def year_month_valid(y: int, m: int) -> bool:
    """Parity: année_mois_valide, temps.cc:190-195."""
    return year_is_valid(y) and 1 <= m <= 12


def is_leap_year(y: int) -> bool:
    """Parity: est_bissextile, temps.cc (invalid years -> False)."""
    if not year_is_valid(y):
        return False
    return (y % 4 == 0 and y % 100 != 0) or (y % 400 == 0)


def days_in_month(y: int, m: int) -> int:
    d = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31][m - 1]
    if m == 2 and is_leap_year(y):
        return 29
    return d


def gregorian_to_jd(y: int, m: int, d: float) -> float:
    """Calendar date -> Julian day (parity: temps.cc Gregorian->JD,
    standard Fliegel-Van Flandern form).  Dates before the Gregorian
    reform (1582-10-15) are interpreted in the JULIAN calendar (b = 0),
    matching :func:`jd_to_gregorian`'s decoder branch — without this the
    encoder/decoder pair did not roundtrip for pre-1582 dates."""
    julian = (y, m, d) < (1582, 10, 15)
    if m <= 2:
        y -= 1
        m += 12
    if julian:
        b = 0
    else:
        a = y // 100
        b = 2 - a + a // 4
    return (np.floor(365.25 * (y + 4716)) + np.floor(30.6001 * (m + 1))
            + d + b - 1524.5)


def jd_to_gregorian(jd: float) -> Tuple[int, int, float]:
    """Julian day -> (year, month, day-with-fraction)."""
    z = np.floor(jd + 0.5)
    f = (jd + 0.5) - z
    if z < 2299161:
        a = z
    else:
        alpha = np.floor((z - 1867216.25) / 36524.25)
        a = z + 1 + alpha - np.floor(alpha / 4)
    b = a + 1524
    c = np.floor((b - 122.1) / 365.25)
    d0 = np.floor(365.25 * c)
    e = np.floor((b - d0) / 30.6001)
    day = b - d0 - np.floor(30.6001 * e) + f
    month = int(e - 1 if e < 14 else e - 13)
    year = int(c - 4716 if month > 2 else c - 4715)
    return year, month, float(day)


def mjd(y: int, m: int, d: float) -> float:
    """Modified Julian day."""
    return gregorian_to_jd(y, m, d) - 2400000.5


def j2000(y: int, m: int, d: float) -> float:
    """Days since the REFERENCE's "J2000" epoch — which is actually JD
    2415020.0 = 1899-12-31 12:00 UT (the classical 1900 January 0.5
    astronomy epoch), NOT the year-2000 epoch.

    REFERENCE DEFECT reproduced on purpose: DateHeure::J2000()
    (temps.cc:348-351) returns ``nb_jours_Julien() - 2415020.0`` while its
    own docstring (temps.hpp:226) claims days since J2000-at-midnight
    (JD 2451544.5); the two epochs differ by exactly 36524.5 days.  The
    golden diff against the built binary (tests/test_golden_ref3.py)
    pins the code behavior, not the docstring.
    """
    return gregorian_to_jd(y, m, d) - 2415020.0


def day_of_week(y: int, m: int, d: int) -> int:
    """0 = Monday .. 6 = Sunday."""
    jd = gregorian_to_jd(y, m, d)
    return int((jd + 0.5) % 7)  # JD 0 was a Monday at noon


def sidereal_time(jd: float) -> float:
    """Greenwich mean sidereal time in radians (parity: temps_sidéral,
    temps.cc — Meeus formula)."""
    T = (jd - 2451545.0) / 36525.0
    theta = (280.46061837 + 360.98564736629 * (jd - 2451545.0)
             + 0.000387933 * T * T - T ** 3 / 38710000.0)
    return np.deg2rad(theta % 360.0)


def local_sidereal_time(jd: float, longitude_deg: float) -> float:
    """Local sidereal time in radians (parity: temps_sidéral_local)."""
    return (sidereal_time(jd) + np.deg2rad(longitude_deg)) % (2 * np.pi)


@dataclasses.dataclass(frozen=True)
class Calendar:
    """Parity: Calendrier, temps.hpp."""
    year: int
    month: int
    day: int

    def to_jd(self) -> float:
        return gregorian_to_jd(self.year, self.month, self.day)


@dataclasses.dataclass(frozen=True)
class TimeOfDay:
    """Parity: HeureComposite."""
    hour: int = 0
    minute: int = 0
    second: float = 0.0

    @property
    def day_fraction(self) -> float:
        return (self.hour + self.minute / 60 + self.second / 3600) / 24


@dataclasses.dataclass(frozen=True)
class DateTime:
    """Parity: DateHeure (microsecond-grade epoch arithmetic via JD)."""
    cal: Calendar
    tod: TimeOfDay = TimeOfDay()

    @property
    def jd(self) -> float:
        return self.cal.to_jd() + self.tod.day_fraction

    def sidereal(self, longitude_deg: float = 0.0) -> float:
        return local_sidereal_time(self.jd, longitude_deg)

    @classmethod
    def from_jd(cls, jd: float) -> "DateTime":
        y, m, d = jd_to_gregorian(jd)
        di = int(d)
        frac = d - di
        h = int(frac * 24)
        mi = int((frac * 24 - h) * 60)
        s = ((frac * 24 - h) * 60 - mi) * 60
        return cls(Calendar(y, m, di), TimeOfDay(h, mi, s))


@dataclasses.dataclass(frozen=True, order=True)
class Duration:
    """Time span with integer microsecond resolution (parity: Durée,
    core/src/temps.cc:51-145 — same tic-count design, arithmetic and
    unit accessors)."""
    tics: int = 0      # microseconds

    # --- constructors (parity: Durée::microsecondes..jours) -------------
    @staticmethod
    def microseconds(n: float) -> "Duration":
        return Duration(int(round(n)))

    @staticmethod
    def milliseconds(n: float) -> "Duration":
        return Duration(int(round(n * 1e3)))

    @staticmethod
    def seconds(n: float) -> "Duration":
        return Duration(int(round(n * 1e6)))

    @staticmethod
    def minutes(n: float) -> "Duration":
        return Duration(int(round(n * 60e6)))

    @staticmethod
    def hours(n: float) -> "Duration":
        return Duration(int(round(n * 3600e6)))

    @staticmethod
    def days(n: float) -> "Duration":
        return Duration(int(round(n * 86400e6)))

    # --- accessors (parity: nb_jours..nb_microsecondes) -----------------
    @property
    def total_days(self) -> float:
        return self.tics / 86400e6

    @property
    def total_hours(self) -> float:
        return self.tics / 3600e6

    @property
    def total_minutes(self) -> float:
        return self.tics / 60e6

    @property
    def total_seconds(self) -> float:
        return self.tics / 1e6

    @property
    def total_milliseconds(self) -> float:
        return self.tics / 1e3

    # --- algebra (parity: operator+/-/*) --------------------------------
    def __add__(self, o: "Duration") -> "Duration":
        return Duration(self.tics + o.tics)

    def __sub__(self, o: "Duration") -> "Duration":
        return Duration(self.tics - o.tics)

    def __mul__(self, k: float) -> "Duration":
        return Duration(int(round(k * self.tics)))

    __rmul__ = __mul__

    def __neg__(self) -> "Duration":
        return Duration(-self.tics)

    def __str__(self) -> str:
        # parity: operator<< unit selection, temps.cc:97-114
        a = abs(self.tics)
        if a > 2 * 86400e6:
            return f"{self.total_days:.3f} days"
        if a >= 3600e6:
            return f"{self.total_hours:.3f} h"
        if a >= 60e6:
            return f"{self.total_minutes:.3f} min"
        if a >= 1e6:
            return f"{self.total_seconds:.3f} s"
        if a >= 1e3:
            return f"{self.total_milliseconds:.3f} ms"
        return f"{self.tics} us"


@dataclasses.dataclass(frozen=True)
class HourComposite:
    """Clock time h/m/s/ms/us (parity: HeureComposite, temps.cc:253-331)."""
    hour: int = 0
    minutes: int = 0
    seconds: int = 0
    ms: int = 0
    us: int = 0

    @staticmethod
    def parse(s: str) -> "HourComposite":
        """'hh:mm:ss[.mmm]' (parity: HeureComposite(cstring),
        temps.cc:263-277)."""
        parts = s.strip().split(":")
        h, m = int(parts[0]), int(parts[1]) if len(parts) > 1 else 0
        sec, ms = 0, 0
        if len(parts) > 2:
            if "." in parts[2]:
                a, b = parts[2].split(".")
                sec = int(a)
                ms = int(round(float("0." + b) * 1000))
                if ms == 1000:
                    # '.9995' rounds up: carry through sec/min/hour
                    # (ms=1000 would fail is_valid and print as
                    # 'ss.1000')
                    sec, ms = sec + 1, 0
                    if sec == 60:
                        sec, m = 0, m + 1
                    if m == 60:
                        m, h = 0, h + 1
            else:
                sec = int(parts[2])
        return HourComposite(h, m, sec, ms)

    def is_valid(self) -> bool:
        """Parity: vérifie_validité, temps.cc:279-287."""
        return (0 <= self.hour < 24 and 0 <= self.minutes < 60
                and 0 <= self.seconds < 60 and 0 <= self.ms < 1000
                and 0 <= self.us < 1000)

    def to_duration(self) -> Duration:
        """Parity: Durée(HeureComposite), temps.cc:146-151."""
        return (Duration.hours(self.hour) + Duration.minutes(self.minutes)
                + Duration.seconds(self.seconds)
                + Duration.milliseconds(self.ms)
                + Duration.microseconds(self.us))

    @staticmethod
    def from_duration(d: Duration) -> "HourComposite":
        t = d.tics % (86400 * 10 ** 6)
        h, t = divmod(t, 3600 * 10 ** 6)
        m, t = divmod(t, 60 * 10 ** 6)
        s, t = divmod(t, 10 ** 6)
        ms, us = divmod(t, 1000)
        return HourComposite(int(h), int(m), int(s), int(ms), int(us))

    def __str__(self) -> str:
        return (f"{self.hour:02d}:{self.minutes:02d}:{self.seconds:02d}"
                f".{self.ms:03d}")


_US_PER_DAY = 86400 * 10 ** 6


def _tod_us(tod: "TimeOfDay") -> int:
    return ((tod.hour * 3600 + tod.minute * 60) * 10 ** 6
            + int(round(tod.second * 1e6)))


def datetime_add(dt: "DateTime", d: Duration) -> "DateTime":
    """DateTime + Duration with EXACT integer-microsecond arithmetic
    (parity: operator+ on DateHeure, temps.cc:333+).

    The time-of-day rides integer microseconds and only WHOLE days go
    through Julian-day arithmetic (date-only JDs are exactly
    representable): the old route through the float64 jd lost ~47 us of
    resolution near modern dates (eps(2.46e6 days) ~ 47 us), silently
    dropping sub-quantum Durations despite Duration's integer-tic
    design."""
    total = _tod_us(dt.tod) + d.tics
    days, rem = divmod(total, _US_PER_DAY)
    if days:
        y, m, dd = jd_to_gregorian(dt.cal.to_jd() + days)
        cal = Calendar(y, m, int(dd))
    else:
        cal = dt.cal
    h, rem2 = divmod(rem, 3600 * 10 ** 6)
    mi, us = divmod(rem2, 60 * 10 ** 6)
    return DateTime(cal, TimeOfDay(int(h), int(mi), us / 1e6))


def datetime_diff(a: "DateTime", b: "DateTime") -> Duration:
    """DateTime - DateTime -> Duration, exact to the microsecond: whole
    days from the (exact) date-only JD difference, the rest from the
    integer time-of-day microseconds."""
    djd = int(round(a.cal.to_jd() - b.cal.to_jd()))
    return Duration(djd * _US_PER_DAY + _tod_us(a.tod) - _tod_us(b.tod))
