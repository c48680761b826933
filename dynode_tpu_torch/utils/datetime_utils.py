"""Sim-day <-> calendar-date <-> epiweek conversions.

Port of ``dynode_tpu/utils/datetime_utils.py``, with the MMWR epiweeks of
:mod:`.epiweek`.
"""

import datetime

from .epiweek import EpiWeek


def sim_day_to_date(sim_day: int, init_date: datetime.date) -> datetime.date:
    """Calendar date of integer ``sim_day`` (day 0 == ``init_date``)."""
    return init_date + datetime.timedelta(days=sim_day)


def date_to_sim_day(date: datetime.date, init_date: datetime.date) -> int:
    """Days elapsed from ``init_date`` to ``date`` (negative if earlier)."""
    return (date - init_date).days


def sim_day_to_epiweek(sim_day: int, init_date: datetime.date) -> EpiWeek:
    """CDC MMWR epiweek containing ``sim_day``."""
    return EpiWeek.fromdate(sim_day_to_date(sim_day, init_date))


def date_to_epi_week(date: datetime.date) -> EpiWeek:
    """CDC MMWR epiweek containing ``date``."""
    return EpiWeek.fromdate(date)


__all__ = [
    "sim_day_to_date",
    "date_to_sim_day",
    "sim_day_to_epiweek",
    "date_to_epi_week",
]
