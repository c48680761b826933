"""CDC MMWR epidemiological weeks, implemented from the MMWR definition.

Port of ``dynode_tpu/utils/epiweek.py`` (a copy: the port imports nothing
of the JAX package), in place of the ``epiweeks`` package. MMWR weeks start on
Sunday; week 1 of a year is the first week containing at least four days of
January -- equivalently, the Sunday-started week containing the first
Wednesday of January.
"""

import datetime
from typing import Union


def _week_start(d: datetime.date) -> datetime.date:
    """The Sunday on or before d."""
    return d - datetime.timedelta(days=(d.weekday() + 1) % 7)


def _first_wednesday(year: int) -> datetime.date:
    jan1 = datetime.date(year, 1, 1)
    return jan1 + datetime.timedelta(days=(2 - jan1.weekday()) % 7)


class EpiWeek:
    """An MMWR (CDC) epidemiological week: (year, week) with Sunday start."""

    def __init__(self, year: int, week: int):
        self.year = int(year)
        self.week = int(week)

    @classmethod
    def fromdate(cls, d: datetime.date) -> "EpiWeek":
        """The epiweek containing calendar date ``d``."""
        start = _week_start(d)
        anchor = start + datetime.timedelta(days=3)  # the week's Wednesday
        year = anchor.year
        week = (anchor - _first_wednesday(year)).days // 7 + 1
        return cls(year, week)

    def startdate(self) -> datetime.date:
        """Sunday beginning this epiweek."""
        return _week_start(_first_wednesday(self.year)) + datetime.timedelta(
            weeks=self.week - 1
        )

    def enddate(self) -> datetime.date:
        """Saturday ending this epiweek."""
        return self.startdate() + datetime.timedelta(days=6)

    def __eq__(self, other) -> bool:
        if isinstance(other, EpiWeek):
            return self.year == other.year and self.week == other.week
        return NotImplemented

    def __lt__(self, other: "EpiWeek") -> bool:
        return (self.year, self.week) < (other.year, other.week)

    def __hash__(self):
        return hash((self.year, self.week))

    def __repr__(self):
        return f"EpiWeek(year={self.year}, week={self.week})"

    def __add__(self, weeks: Union[int, "EpiWeek"]) -> "EpiWeek":
        if isinstance(weeks, int):
            return EpiWeek.fromdate(self.startdate() + datetime.timedelta(weeks=weeks))
        return NotImplemented


#: alias matching the ``epiweeks.Week`` name of existing call sites
Week = EpiWeek

__all__ = ["EpiWeek", "Week"]
