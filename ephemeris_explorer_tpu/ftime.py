"""Time scalars: TAI epochs and durations.

Rebuild of the reference's ``ftime`` crate
(``ftime/src/epoch.rs``, ``duration.rs``): an ``Epoch`` is a
plain f64 count of TAI seconds since 1958-01-01T00:00:00 and a ``Duration`` is
a plain f64 count of seconds.  Parse/format are byte-compatible with the
reference ("YYYY-MM-DD HH:MM:SS[.mmm]" epochs, "1 y 2 d 3 h 4 m 5 s 6 ms"
durations) so scene JSON round-trips identically.

These are host-side scalars (pure Python); on-device time is carried as plain
f64/f32 seconds.  Civil-date conversion uses Howard Hinnant's public-domain
``days_from_civil`` / ``civil_from_days`` algorithms, as the reference does
(``epoch.rs:263-290``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

SEC_PER_NANO = 1e-9
SEC_PER_MICRO = 1e-6
SEC_PER_MILLI = 1e-3
SEC_PER_MIN = 60.0
SEC_PER_HOUR = 3600.0
SEC_PER_DAY = 86400.0
SEC_PER_YEAR = 365.25 * SEC_PER_DAY  # Julian year
MS_PER_SEC = 1000.0

# Days between 1958-01-01 (TAI epoch) and 1970-01-01 (Unix epoch).
_DAYS_1958_TO_1970 = 4383

# Julian date of the TAI epoch 1958-01-01T00:00:00
# (reference: solar_system_json/src/main.rs:79).
JD_TAI_EPOCH = 2436204.5

_UNIT_TO_MS: dict[str, int] = {}
for _names, _ms in [
    (("y", "yr", "yrs", "year", "years"), int(SEC_PER_YEAR * 1000)),
    (("d", "day", "days"), 86_400_000),
    (("h", "hr", "hrs", "hour", "hours"), 3_600_000),
    (("m", "min", "mins", "minute", "minutes"), 60_000),
    (("s", "sec", "secs", "second", "seconds"), 1_000),
    (("ms", "msec", "msecs", "millisecond", "milliseconds"), 1),
]:
    for _n in _names:
        _UNIT_TO_MS[_n] = _ms


def days_from_civil(y: int, m: int, d: int) -> int:
    """Days since 1970-01-01 in the proleptic Gregorian calendar."""
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    mp = m - 3 if m > 2 else m + 9
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146_097 + doe - 719_468


def civil_from_days(z: int) -> tuple[int, int, int]:
    """Inverse of :func:`days_from_civil`."""
    z += 719_468
    era = (z if z >= 0 else z - 146_096) // 146_097
    doe = z - era * 146_097
    yoe = (doe - doe // 1460 + doe // 36_524 - doe // 146_096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + 3 if mp < 10 else mp - 9
    return (y + (m <= 2), m, d)


class DurationParseError(ValueError):
    pass


class EpochParseError(ValueError):
    pass


@dataclass(frozen=True, slots=True, order=True)
class Duration:
    """An f64 number of seconds (reference: ftime/src/duration.rs:7)."""

    seconds: float

    # ---- constructors -------------------------------------------------
    @staticmethod
    def from_seconds(s: float) -> "Duration":
        return Duration(float(s))

    @staticmethod
    def from_nanoseconds(v: float) -> "Duration":
        return Duration(v * SEC_PER_NANO)

    @staticmethod
    def from_microseconds(v: float) -> "Duration":
        return Duration(v * SEC_PER_MICRO)

    @staticmethod
    def from_milliseconds(v: float) -> "Duration":
        return Duration(v * SEC_PER_MILLI)

    @staticmethod
    def from_minutes(v: float) -> "Duration":
        return Duration(v * SEC_PER_MIN)

    @staticmethod
    def from_hours(v: float) -> "Duration":
        return Duration(v * SEC_PER_HOUR)

    @staticmethod
    def from_days(v: float) -> "Duration":
        return Duration(v * SEC_PER_DAY)

    @staticmethod
    def from_years(v: float) -> "Duration":
        return Duration(v * SEC_PER_YEAR)

    # ---- accessors ----------------------------------------------------
    def as_seconds(self) -> float:
        return self.seconds

    def as_days(self) -> float:
        return self.seconds / SEC_PER_DAY

    def __abs__(self) -> "Duration":
        return Duration(abs(self.seconds))

    def is_positive(self) -> bool:
        # matches Rust is_sign_positive (0.0 is positive, -0.0 negative)
        import math

        return not math.copysign(1.0, self.seconds) < 0

    def is_negative(self) -> bool:
        return not self.is_positive()

    # ---- arithmetic ---------------------------------------------------
    def __add__(self, o: "Duration") -> "Duration":
        return Duration(self.seconds + o.seconds)

    def __sub__(self, o: "Duration") -> "Duration":
        return Duration(self.seconds - o.seconds)

    def __mul__(self, k: float) -> "Duration":
        return Duration(self.seconds * k)

    __rmul__ = __mul__

    def __truediv__(self, k):
        if isinstance(k, Duration):
            return self.seconds / k.seconds
        return Duration(self.seconds / k)

    def __neg__(self) -> "Duration":
        return Duration(-self.seconds)

    def scaled(self, k: float) -> "Duration":
        return Duration(self.seconds * k)

    def floor(self, to: "Duration") -> "Duration":
        import math

        return Duration(math.floor(self.seconds / to.seconds) * to.seconds)

    def round(self, to: "Duration") -> "Duration":
        # Rust f64::round rounds half away from zero.
        import math

        q = self.seconds / to.seconds
        return Duration(math.floor(q + 0.5) * to.seconds if q >= 0 else math.ceil(q - 0.5) * to.seconds)

    # ---- parse / format (reference: duration.rs:217-345) --------------
    @staticmethod
    def parse(s: str) -> "Duration":
        s = s.strip()
        if not s:
            raise DurationParseError("empty duration string")
        sign = 1.0
        if s.startswith("+"):
            s = s[1:].lstrip()
        elif s.startswith("-"):
            sign = -1.0
            s = s[1:].lstrip()

        parts = s.split()
        total_ms = 0
        # pairs of (number, unit); trailing odd element ignored (as in reference zip)
        for num, unit in zip(parts[0::2], parts[1::2]):
            if not re.fullmatch(r"\d+", num):
                raise DurationParseError(f"invalid number: {num}")
            u = unit.strip().lower().replace("μ", "µ")
            if u not in _UNIT_TO_MS:
                raise DurationParseError(f"unknown unit: {unit}")
            total_ms += int(num) * _UNIT_TO_MS[u]
        return Duration(sign * total_ms * 1e-3)

    def __str__(self) -> str:
        sign = "-" if self.is_negative() else ""
        t = abs(self.seconds)
        secs_int = int(t)  # trunc
        ms = int(round((t - secs_int) * 1e3))
        if ms == 1000:
            ms = 0
            secs_int += 1
        y, secs_int = divmod(secs_int, 31_557_600)
        d, secs_int = divmod(secs_int, 86_400)
        h, secs_int = divmod(secs_int, 3_600)
        m, s = divmod(secs_int, 60)
        parts = []
        if y:
            parts.append(f"{y} y")
        if d:
            parts.append(f"{d} d")
        if h:
            parts.append(f"{h} h")
        if m:
            parts.append(f"{m} m")
        if s:
            parts.append(f"{s} s")
        if ms:
            parts.append(f"{ms} ms")
        if not parts:
            parts.append("0 s")
        return sign + " ".join(parts)


Duration.ZERO = Duration(0.0)
Duration.MIN = Duration(-1.7976931348623157e308)
Duration.MAX = Duration(1.7976931348623157e308)


@dataclass(frozen=True, slots=True, order=True)
class Epoch:
    """TAI epoch: f64 seconds since 1958-01-01T00:00:00 (ftime/src/epoch.rs:4)."""

    offset: float  # seconds

    @staticmethod
    def from_offset_seconds(s: float) -> "Epoch":
        return Epoch(float(s))

    @staticmethod
    def from_datetime(
        year: int, month: int, day: int, hour: int, minute: int, second: int, millis: int = 0
    ) -> "Epoch":
        if not (1 <= month <= 12) or hour > 23 or minute > 59 or second > 59 or millis > 999:
            raise EpochParseError("date or time component out of range")
        z = days_from_civil(year, month, day)
        if civil_from_days(z) != (year, month, day):
            raise EpochParseError("invalid date")
        days_since_1958 = z - days_from_civil(1958, 1, 1)
        sod = hour * 3600 + minute * 60 + second
        return Epoch(float(days_since_1958 * 86400 + sod) + millis / MS_PER_SEC)

    def as_offset_seconds(self) -> float:
        return self.offset

    def as_offset(self) -> Duration:
        return Duration(self.offset)

    @staticmethod
    def from_jd(jd: float) -> "Epoch":
        return Epoch((jd - JD_TAI_EPOCH) * SEC_PER_DAY)

    def to_jd(self) -> float:
        return JD_TAI_EPOCH + self.offset / SEC_PER_DAY

    # ---- arithmetic ---------------------------------------------------
    def __add__(self, d: Duration) -> "Epoch":
        return Epoch(self.offset + d.seconds)

    def __sub__(self, o):
        if isinstance(o, Epoch):
            return Duration(self.offset - o.offset)
        return Epoch(self.offset - o.seconds)

    def floor(self, to: Duration) -> "Epoch":
        return Epoch(Duration(self.offset).floor(to).seconds)

    def round(self, to: Duration) -> "Epoch":
        return Epoch(Duration(self.offset).round(to).seconds)

    # ---- parse / format (reference: epoch.rs:155-249) ------------------
    @staticmethod
    def parse(s: str) -> "Epoch":
        if " " not in s:
            raise EpochParseError("missing space between date and time")
        date_str, time_str = s.split(" ", 1)
        dparts = date_str.split("-", 2)
        if len(dparts) != 3:
            raise EpochParseError("bad date format")
        try:
            year, month, day = (int(p) for p in dparts)
        except ValueError as e:
            raise EpochParseError(f"invalid number: {e}") from None
        if "." in time_str:
            hms_str, frac = time_str.split(".", 1)
        else:
            hms_str, frac = time_str, None
        tparts = hms_str.split(":", 2)
        if len(tparts) != 3:
            raise EpochParseError("bad time format")
        try:
            hour, minute, second = (int(p) for p in tparts)
        except ValueError as e:
            raise EpochParseError(f"invalid number: {e}") from None
        if frac is not None:
            if not frac or not frac.isdigit():
                raise EpochParseError("invalid number")
            digits = frac[: min(len(frac), 3)]
            millis = int(digits) * 10 ** (3 - len(digits))
        else:
            millis = 0
        return Epoch.from_datetime(year, month, day, hour, minute, second, millis)

    def __str__(self) -> str:
        import math

        secs = math.floor(self.offset)
        millis = int(round((self.offset - secs) * MS_PER_SEC))
        if millis == 1000:
            secs += 1
            millis = 0
        days_since_1958, sod = divmod(secs, 86400)
        year, month, day = civil_from_days(days_since_1958 - _DAYS_1958_TO_1970)
        hour = sod // 3600
        minute = (sod % 3600) // 60
        second = sod % 60
        return f"{year:04}-{month:02}-{day:02} {hour:02}:{minute:02}:{second:02}.{millis:03}"


Epoch.ZERO = Epoch(0.0)
Epoch.MIN = Epoch(-1.7976931348623157e308)
Epoch.MAX = Epoch(1.7976931348623157e308)
