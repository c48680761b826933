"""Sim-day <-> calendar-date conversions.

Port of ``dynode_tpu/utils/datetime_utils.py:12,17``; the epiweek
conversions come with the rest of the utilities.
"""

import datetime


def sim_day_to_date(sim_day: int, init_date: datetime.date) -> datetime.date:
    """Calendar date of integer ``sim_day`` (day 0 == ``init_date``)."""
    return init_date + datetime.timedelta(days=sim_day)


def date_to_sim_day(date: datetime.date, init_date: datetime.date) -> int:
    """Days elapsed from ``init_date`` to ``date`` (negative if earlier)."""
    return (date - init_date).days


__all__ = ["sim_day_to_date", "date_to_sim_day"]
