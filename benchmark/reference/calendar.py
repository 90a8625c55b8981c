"""Model calendar (``source/ice_calendar.F90:218-489``).

Port of :mod:`cice4_tpu.calendar`, line for line: it tracks the step
index, elapsed time, date, day of year and the output flags, on the
host.  A test holds it equal to the JAX package's over a year of steps.
"""

from __future__ import annotations

import dataclasses

daycal_365 = [0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304, 334, 365]
daycal_366 = [0, 31, 60, 91, 121, 152, 182, 213, 244, 274, 305, 335, 366]


def is_leap(year: int) -> bool:
    return year % 4 == 0 and (year % 100 != 0 or year % 400 == 0)


@dataclasses.dataclass
class Calendar:
    """Mutable model clock."""

    dt: float
    year_init: int = 1997
    days_per_year: int = 365        # 365 | 360 | "leap" handled via flag
    use_leap_years: bool = False
    istep: int = 0
    time: float = 0.0               # elapsed seconds since init

    # derived, updated by advance()
    year: int = 0
    month: int = 1
    mday: int = 1
    yday: float = 1.0               # day of year (1-based, fractional ok)
    sec: float = 0.0                # seconds into the day
    new_day: bool = True
    new_month: bool = True
    new_year: bool = True

    def __post_init__(self):
        self.year = self.year_init
        self._recompute(first=True)

    def _days_in_year(self, year):
        if self.use_leap_years and is_leap(year):
            return 366
        return self.days_per_year

    def _recompute(self, first=False):
        prev = (self.year, self.month, self.mday)
        days_total = self.time / 86400.0
        year = self.year_init
        while days_total >= self._days_in_year(year):
            days_total -= self._days_in_year(year)
            year += 1
        self.year = year
        day_of_year = int(days_total)            # 0-based
        self.sec = (days_total - day_of_year) * 86400.0
        self.yday = day_of_year + 1 + self.sec / 86400.0
        cal = daycal_366 if (self.use_leap_years and is_leap(year)) \
            else daycal_365
        month = 1
        while month < 12 and day_of_year >= cal[month]:
            month += 1
        self.month = month
        self.mday = day_of_year - cal[month - 1] + 1
        now = (self.year, self.month, self.mday)
        self.new_day = first or now != prev
        self.new_month = first or now[:2] != prev[:2]
        self.new_year = first or now[0] != prev[0]

    def advance(self):
        """Advance one step (``calendar(ttime)``)."""
        self.istep += 1
        self.time += self.dt
        self._recompute()

    @property
    def idate(self) -> int:
        return self.year * 10000 + self.month * 100 + self.mday

    def write_flag(self, freq: str, freq_n: int = 1) -> bool:
        """Output-frequency flags (`histfreq`/`dumpfreq` codes
        y/m/d/h/1, ``ice_calendar.F90:300-386``)."""
        if freq in ("x", "n"):
            return False
        if freq == "1":
            return self.istep % max(freq_n, 1) == 0
        if freq == "h":
            steps = max(int(round(freq_n * 3600.0 / self.dt)), 1)
            return self.istep % steps == 0
        if freq == "d":
            return self.new_day and (int(self.yday) - 1) % max(freq_n, 1) == 0
        if freq == "m":
            return self.new_month
        if freq == "y":
            return self.new_year
        raise ValueError(f"unknown frequency code {freq!r}")
